// The lane-ELL core in row quanta for Hopper (sm_90a): lane_rows, the
// core kernel of cuda-hybrid and of the row-sharded hybrid on their
// default core_layout="rows".
//
// Replaces, in the JAX package:
//   spmv_scpa_tpu/ops/lane_ell.py `_lane_ell_kernel` (body :188, launched
//   by the pallas_call at :1323), and the same body launched per row
//   shard by spmv_scpa_tpu/parallel/distributed.py (:480, pallas_call at
//   :510). csrc/lane_ell.cu keeps the lanes-layout ports of both
//   (lane_ell_spmv, lane_ell_sharded), which core_layout="lanes" runs.
//
// Function (ops/lane_rows.py): the core's entries in quanta of Q slots of
// one row, vals[s] at column col(s); row r owns quanta qptr[r] ..
// qptr[r + 1] - 1. idx holds a 16-bit word per slot at the slot's own
// position: in a block of 2048 slots whose columns span less than 2^16,
// col(s) = ctab[b][0] + word; in a 32-bit block (ctab[b][0] = -1) the word
// is the column's low half and its high half sits at idx[ctab[b][1] + the
// slot's place in the block]. y[r] is pell_rows' sum: each quantum's
// products as a pairwise tree, a segmented scan within the block, a
// crossing row's block sums left to right. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), so the plain PyTorch version equals
// this bit for bit. A column outside x reads 0.0.
//
// What bounds it: bytes. A slot is 4 bytes of value and 2 or 4 of index,
// read once; x is read through L2. The TPU layout pays every 128-row
// group the global plane count (one long row sets the depth of 128 rows)
// and keeps x in VMEM through strip codes, a staged padded x, hot strips
// and ext panels that gathers build on every call. Here the core's
// entries are padded only to a multiple of Q per row, and each slot reads
// x at its own column: no staging, no ext gathers.
//
// Design: pell_rows' block pass (pell_rows.cuh) as it stands, with a new
// load stage. 256 threads a block, 8 slots a thread, slot j of thread t at
// block slot j * 256 + t: the block's table entry, all eight values and
// all eight low words in flight together (__ldcs, evict-first, so that x
// keeps L1 and L2), then a 16-bit block adds its base while a 32-bit block
// loads its eight high halves (the branch is uniform across the block),
// then the eight gathers of x. A first layout stored every block's
// indices behind a start read from the table, so no index load could
// issue before the table's arrived: one more dependent load per block
// (PERF.md §6). The block pass writes the rows that end in the
// block to y and leaves a crossing row's block sums in a carry array; a
// second launch adds those in block order and writes 0 to rows with no
// entries. Deterministic: no atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "pell_rows.cuh"

namespace {

using namespace rowpass;

// Blocks an SM: the register cap this asks for (40) keeps six blocks of
// 256 threads on an SM without spilling; at the compiler's own choice (63
// registers) four fit, too few to hide the latency of the table, the
// words and the gathers (PERF.md §6).
constexpr int kMinBlocks = 6;

// Pass 1: block b takes quanta b * QB .. b * QB + QB - 1.
template <int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lane_rows_kernel(const float* __restrict__ vals,
                 const uint16_t* __restrict__ idx,
                 const int* __restrict__ ctab, const int* __restrict__ qptr,
                 const int* __restrict__ blk_lo, const float* __restrict__ x,
                 float* __restrict__ carry, float* __restrict__ y,
                 int64_t n_slots, int m, int n) {
  __shared__ Smem<float, Q> sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int q0 = b * Smem<float, Q>::QB;
  const int64_t s0 = static_cast<int64_t>(b) * kBlockSlots;
  const int64_t left = n_slots - s0;       // slots of this block

  // the block's table entry, the values and the low words: all in flight
  const int base = __ldg(ctab + 2 * b);
  const int start = __ldg(ctab + 2 * b + 1);
  float v[kSlots];
  int c[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int k = j * kThreads + tid;
    v[j] = k < left ? __ldcs(vals + s0 + k) : 0.0f;
    c[j] = k < left ? static_cast<int>(__ldcs(idx + s0 + k)) : -1;
  }
  if (base >= 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (c[j] >= 0) c[j] += base;
  } else {
    const uint16_t* high = idx + start;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = j * kThreads + tid;
      if (k < left)
        c[j] |= static_cast<int>(static_cast<unsigned>(__ldcs(high + k))
                                 << 16);
    }
  }
  const int lo = __ldg(blk_lo + b);
  const int hi = min(__ldg(blk_lo + b + 1), m);
  const int r0 = first_row(lo);
  int a0 = 0, e0 = 0;
  if (r0 < hi) {
    a0 = __ldg(qptr + r0);
    e0 = __ldg(qptr + r0 + 1);
  }
  for (int i = tid; i < Smem<float, Q>::QB; i += kThreads) sm.head[i] = 0;
  float xv[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    xv[j] = static_cast<unsigned>(c[j]) < static_cast<unsigned>(n)
                ? __ldg(x + c[j]) : 0.0f;
  __syncthreads();
  mark_heads(sm, qptr, q0, lo, hi, r0, a0);
  quantum_sums(sm, v, xv);
  __syncthreads();
  finish_block(sm, qptr, carry, y, b, hi, r0, a0, e0);
}

}  // namespace

// vals (n_slots / quantum, quantum) f32; idx int16 storage of the slots'
// low words, then the 32-bit blocks' high halves; ctab (nb, 2) i32; qptr
// (m + 1,) i32; blk_lo (nb + 1,) i32; x (n,) f32; carry (2 * nb,) f32
// scratch; y (m,) f32.
extern "C" int lane_rows(const void* vals, const void* idx, const void* ctab,
                         const void* qptr, const void* blk_lo, const void* x,
                         void* carry, void* y, int nb, int64_t n_slots, int m,
                         int n, int quantum, void* stream) {
  const float* v = static_cast<const float*>(vals);
  const uint16_t* ix = static_cast<const uint16_t*>(idx);
  const int* ct = static_cast<const int*>(ctab);
  const int* qp = static_cast<const int*>(qptr);
  const int* bl = static_cast<const int*>(blk_lo);
  const float* xx = static_cast<const float*>(x);
  float* cr = static_cast<float*>(carry);
  float* yy = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    switch (quantum) {
      case 2: lane_rows_kernel<2><<<nb, kThreads, 0, st>>>(v, ix, ct, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 4: lane_rows_kernel<4><<<nb, kThreads, 0, st>>>(v, ix, ct, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 8: lane_rows_kernel<8><<<nb, kThreads, 0, st>>>(v, ix, ct, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 16: lane_rows_kernel<16><<<nb, kThreads, 0, st>>>(v, ix, ct, qp, bl, xx, cr, yy, n_slots, m, n); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_finish(qp, cr, yy, m, quantum, st);
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

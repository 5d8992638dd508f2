// PELL over row quanta for Hopper (sm_90a): pell_rows (f32) and
// pell_rows_fp64 (f64), the default kernels of cuda-pell, cuda-pell-fp64,
// the hybrid's no-locality escape and its compact big tail.
//
// Replaces, in spmv_scpa_tpu/ops/pallas_kernels.py:
//   pell_rows      -> _fused_kernel (body :419, called at :718; PELL's
//                     default fused scheme);
//   pell_rows_fp64 -> _fused_kernel_df64 (body :761, called at :966; the
//                     fp64 grade).
// csrc/pell.cu keeps the tile-layout ports of both (pell_fused,
// pell_fused_fp64), which layout="tiles" and the row-sharded PELL run.
//
// Function (ops/pell_rows.py): quantum q holds Q consecutive entries of one
// row, vals[q * Q + k] at column cols[q * Q + k] (a column outside x reads
// 0.0); row r owns quanta qptr[r] .. qptr[r + 1] - 1. y[r] is the sum of
// its products: each quantum's slots as a pairwise tree; within a block of
// QB = 2048 / Q quanta a segmented Hillis-Steele scan over 32-quantum
// chunks, then over the chunks' totals; across blocks the block-local sums
// of a row added left to right. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn): no contraction into FMA,
// so the plain PyTorch version equals this bit for bit.
//
// What bounds it: bytes. A slot is 8 bytes at f32 and 12 at f64 (value and
// int32 column) and every slot is read once; x is read through L2. The TPU
// kernel's format cuts rows into 128-column panels and pads each 8-row
// block to its longest row, so that x stays in VMEM and the gather stays
// within 128 lanes: on a power-law matrix 80-95% of its slots are padding.
// Here a row is padded only to a multiple of Q (fill 0.75-0.98 on the
// port's scattered matrices), and every block takes the same 2048 slots
// however its rows fall, so a 15,000-entry row is spread over several
// blocks and no warp walks it alone.
//
// Design (the block pass and the second pass: pell_rows.cuh). 256 threads
// a block, 8 slots a thread. Slot j of thread t is block slot j * 256 + t,
// so each warp load reads 32 consecutive values
// (128 B at f32) and 32 consecutive columns, and each gather of x reads the
// columns of 32 consecutive slots: a row's sorted columns then share cache
// lines within one gather, which the hot low columns of a power-law matrix
// do (the gathers of x through L1, not the streamed bytes, are what this
// kernel spends most of its time on). A thread issues its 16 streamed loads
// at once with __ldcs (evict-first, so that x keeps L1 and L2), and the row
// bounds of its first row of the block with them; then gathers x with
// __ldg. A quantum is Q neighbouring lanes: xor shuffles over 1, 2, .. Q/2
// lanes sum it as the pairwise tree. The block's quantum sums go to shared
// memory (at most 8 KB), a warp scans each 32-quantum chunk with shuffles,
// warp 0 scans the chunk totals, and one thread per row of the block reads
// its row's value at its last quantum: a row inside the block is written to
// y, a row that crosses a block boundary leaves its block-local sum in a
// carry array (two slots a block: the row that came in, the row that goes
// on). A second launch, a thread per row, adds each crossing row's carries
// in block order and writes 0 to the rows with no entries. Deterministic:
// no atomics anywhere.
//
// Tried and not kept: 16-byte loads of 4 neighbouring slots a lane (each
// gather then spans 128 slots), and a persistent block fed by a ring of 1-D
// TMA bulk copies (cp.async.bulk with an mbarrier); bench/rows_study.py
// times both against this kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "pell_rows.cuh"

namespace {

using namespace rowpass;

// Pass 1: block b takes quanta b * QB .. b * QB + QB - 1.
template <class T, int Q>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
            const int* __restrict__ qptr, const int* __restrict__ blk_lo,
            const T* __restrict__ x, T* __restrict__ carry,
            T* __restrict__ y, int64_t n_slots, int m, int n) {
  __shared__ Smem<T, Q> sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int q0 = b * Smem<T, Q>::QB;
  const int64_t s0 = static_cast<int64_t>(b) * kBlockSlots;

  // the slots: all loads in flight together, with the bounds of this
  // thread's first row of the block
  T v[kSlots];
  int c[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int64_t s = s0 + j * kThreads + tid;
    const bool in = s < n_slots;
    v[j] = in ? __ldcs(vals + s) : T(0);
    c[j] = in ? __ldcs(cols + s) : -1;
  }
  const int lo = __ldg(blk_lo + b);
  const int hi = min(__ldg(blk_lo + b + 1), m);
  const int r0 = first_row(lo);
  int a0 = 0, e0 = 0;
  if (r0 < hi) {
    a0 = __ldg(qptr + r0);
    e0 = __ldg(qptr + r0 + 1);
  }
  for (int i = tid; i < Smem<T, Q>::QB; i += kThreads) sm.head[i] = 0;
  T xv[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    xv[j] = static_cast<unsigned>(c[j]) < static_cast<unsigned>(n)
                ? __ldg(x + c[j]) : T(0);
  __syncthreads();
  mark_heads(sm, qptr, q0, lo, hi, r0, a0);
  quantum_sums(sm, v, xv);
  __syncthreads();
  finish_block(sm, qptr, carry, y, b, hi, r0, a0, e0);
}

// Both passes in value type T (see pell_rows below).
template <class T>
int rows_call(const void* vals, const void* cols, const void* qptr,
              const void* blk_lo, const void* x, void* carry, void* y,
              int nb, int64_t n_slots, int m, int n, int quantum,
              cudaStream_t st) {
  const T* v = static_cast<const T*>(vals);
  const int* c = static_cast<const int*>(cols);
  const int* qp = static_cast<const int*>(qptr);
  const int* bl = static_cast<const int*>(blk_lo);
  const T* xx = static_cast<const T*>(x);
  T* cr = static_cast<T*>(carry);
  T* yy = static_cast<T*>(y);
  if (nb > 0) {
    switch (quantum) {
      case 2: rows_kernel<T, 2><<<nb, kThreads, 0, st>>>(v, c, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 4: rows_kernel<T, 4><<<nb, kThreads, 0, st>>>(v, c, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 8: rows_kernel<T, 8><<<nb, kThreads, 0, st>>>(v, c, qp, bl, xx, cr, yy, n_slots, m, n); break;
      case 16: rows_kernel<T, 16><<<nb, kThreads, 0, st>>>(v, c, qp, bl, xx, cr, yy, n_slots, m, n); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_finish(qp, cr, yy, m, quantum, st);
}

}  // namespace

// vals and cols (n_slots / quantum, quantum) f32 and i32; qptr (m + 1,)
// i32; blk_lo (nb + 1,) i32; x (n,) f32; carry (2 * nb,) f32 scratch;
// y (m,) f32.
extern "C" int pell_rows(const void* vals, const void* cols,
                         const void* qptr, const void* blk_lo, const void* x,
                         void* carry, void* y, int nb, int64_t n_slots,
                         int m, int n, int quantum, void* stream) {
  return rows_call<float>(vals, cols, qptr, blk_lo, x, carry, y, nb, n_slots,
                          m, n, quantum, static_cast<cudaStream_t>(stream));
}

// pell_rows in double: vals, x, carry and y are f64.
extern "C" int pell_rows_fp64(const void* vals, const void* cols,
                              const void* qptr, const void* blk_lo,
                              const void* x, void* carry, void* y, int nb,
                              int64_t n_slots, int m, int n, int quantum,
                              void* stream) {
  return rows_call<double>(vals, cols, qptr, blk_lo, x, carry, y, nb,
                           n_slots, m, n, quantum,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

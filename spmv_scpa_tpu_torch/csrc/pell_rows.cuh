// The block pass that row-layout PELL kernels share (csrc/pell_rows.cu,
// and the design study bench/rows_study.cu that times alternatives to it):
// from a block's quantum sums to y and the carries, and the second pass.
//
// A block of kThreads threads takes kBlockSlots slots, QB = kBlockSlots / Q
// quanta. Its kernel writes each quantum's sum (the pairwise tree over its
// slots) to Smem::val and sets Smem::head at the first quantum of every row
// that starts in the block, then calls finish_block after a __syncthreads:
// a segmented inclusive Hillis-Steele scan within each 32-quantum chunk
// (one warp a chunk, step d adds the value d lanes back while that stays in
// the chunk and the row), the same scan over the chunks' last values (warp
// 0), and a thread per row of the block reading its row's value at its last
// quantum in the block, with the scanned total of the chunk before added
// where the row started before its chunk. A row inside the block goes to
// y; a row that crosses a block boundary leaves its block-local sum in
// carry[2 b] (the row that came in) or carry[2 b + 1] (the row that goes
// on). finish_kernel, a thread per row, adds a crossing row's carries in
// block order and writes 0 to the rows with no entries. Every product and
// sum is rounded on its own (no FMA): ops/pell_rows.py's plain version
// follows the same order, and equals these kernels bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rowpass {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;                           // slots a thread
constexpr int kBlockSlots = kThreads * kSlots;      // 2048
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <class T, int Q>
struct Smem {
  static constexpr int QB = kBlockSlots / Q;
  static constexpr int kChunks = QB / 32;
  T val[QB];
  unsigned char head[QB];
  unsigned mask[kChunks];
  T tot[kChunks];
};

// The block's rows are r0, r0 + kThreads, .. below hi, with r0 =
// max(lo - 1, 0) + threadIdx.x: lo - 1 may come into the block, lo .. hi - 1
// start in it. (a0, e0) are qptr[r0] and qptr[r0 + 1], loaded early.
__device__ __forceinline__ int first_row(int lo) {
  return max(lo - 1, 0) + static_cast<int>(threadIdx.x);
}

// Mark the first quantum of each row that starts in block [q0, q0 + QB).
template <class T, int Q>
__device__ __forceinline__ void mark_heads(Smem<T, Q>& sm,
                                           const int* __restrict__ qptr,
                                           int q0, int lo, int hi, int r0,
                                           int a0) {
  for (int r = r0; r < hi; r += kThreads) {
    const int a = r == r0 ? a0 : __ldg(qptr + r);
    if (r >= lo) sm.head[a - q0] = 1;
  }
}

// The quantum sums of slots j * kThreads + threadIdx.x (j < kSlots) of the
// block, each from its product p[j]: a quantum is Q neighbouring lanes.
template <class T, int Q>
__device__ __forceinline__ void quantum_sums(Smem<T, Q>& sm,
                                             const T (&v)[kSlots],
                                             const T (&xv)[kSlots]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    T p = mul_rn(v[j], xv[j]);
#pragma unroll
    for (int off = 1; off < Q; off <<= 1)
      p = add_rn(p, __shfl_xor_sync(kFull, p, off));
    if ((tid & 31) % Q == 0) sm.val[(j * kThreads + tid) / Q] = p;
  }
}

template <class T, int Q>
__device__ __forceinline__ void finish_block(
    Smem<T, Q>& sm, const int* __restrict__ qptr, T* __restrict__ carry,
    T* __restrict__ y, int b, int hi, int r0, int a0, int e0) {
  constexpr int QB = Smem<T, Q>::QB;
  constexpr int kChunks = Smem<T, Q>::kChunks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = b * QB;

  // segmented inclusive scan within each 32-quantum chunk
  for (int ch = warp; ch < kChunks; ch += kWarps) {
    const int i = ch * 32 + lane;
    T val = sm.val[i];
    const unsigned mask = __ballot_sync(kFull, sm.head[i]);
    const unsigned upto = mask & (kFull >> (31 - lane));
    const int lim = upto ? 31 - __clz(upto) : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = __shfl_up_sync(kFull, val, d);
      if (lane - d >= lim) val = add_rn(up, val);
    }
    sm.val[i] = val;
    if (lane == 0) sm.mask[ch] = mask;
  }
  __syncthreads();

  // the same scan over the chunks' totals
  if (warp == 0) {
    T t = lane < kChunks ? sm.val[lane * 32 + 31] : T(0);
    int seen = lane < kChunks ? sm.mask[lane] != 0 : 1;
#pragma unroll
    for (int d = 1; d < kChunks; d <<= 1) {
      const T up = __shfl_up_sync(kFull, t, d);
      const int seen_up = __shfl_up_sync(kFull, seen, d);
      if (lane >= d && !seen) t = add_rn(up, t);
      if (lane >= d) seen |= seen_up;
    }
    if (lane < kChunks) sm.tot[lane] = t;
  }
  __syncthreads();

  // each row of the block: its sum up to its last quantum in the block
  const int q_end = q0 + QB;
  for (int r = r0; r < hi; r += kThreads) {
    const int a = r == r0 ? a0 : __ldg(qptr + r);
    const int e = r == r0 ? e0 : __ldg(qptr + r + 1);
    if (a == e || e <= q0) continue;       // no entries (the second pass),
                                           // or ended before the block
    const int last = min(e, q_end) - 1 - q0;
    const int ch = last >> 5;
    T val = sm.val[last];
    if (ch > 0 && (sm.mask[ch] & (kFull >> (31 - (last & 31)))) == 0)
      val = add_rn(sm.tot[ch - 1], val);
    if (a >= q0 && e <= q_end)
      y[r] = val;
    else if (a < q0)
      carry[2 * b] = val;                  // the row that came in
    else
      carry[2 * b + 1] = val;              // the row that goes on
  }
}

// Pass 2, a thread per row: crossing rows' carries in block order, and 0
// for rows without entries.
template <class T>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const int* __restrict__ qptr, const T* __restrict__ carry,
              T* __restrict__ y, int m, int qb) {
  const int r = blockIdx.x * kFinishThreads + threadIdx.x;
  if (r >= m) return;
  const int a = __ldg(qptr + r);
  const int e = __ldg(qptr + r + 1);
  if (a == e) {
    y[r] = T(0);
    return;
  }
  const int bs = a / qb;
  const int be = (e - 1) / qb;
  if (bs == be) return;
  T acc = carry[2 * bs + 1];
#pragma unroll 8
  for (int k = bs + 1; k <= be; ++k) acc = add_rn(acc, carry[2 * k]);
  y[r] = acc;
}

template <class T>
int launch_finish(const int* qptr, const T* carry, T* y, int m, int quantum,
                  cudaStream_t st) {
  if (m > 0) {
    const unsigned blocks =
        static_cast<unsigned>((m + kFinishThreads - 1) / kFinishThreads);
    finish_kernel<T><<<blocks, kFinishThreads, 0, st>>>(
        qptr, carry, y, m, kBlockSlots / quantum);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rowpass

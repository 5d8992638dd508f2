// The two passes that turn per-quantum 8-row partials into y without
// atomics, shared by segsum.cu (partials in device memory) and pell.cu
// (the fused kernel, partials in shared memory).
//
// Rows of y are grouped into windows of h 8-row blocks. Step s adds into
// the W windows base[s] .. base[s] + W - 1, that is into nrel = W * h cells
// of 8 rows. Its quanta are listed by cell: order[ptr[s * nrel + k] ..
// ptr[s * nrel + k + 1]) holds, in ascending order, the global ids of the
// quanta that land in cell k (the host builds this index once per matrix,
// ops/segsum_kernel.py:segment_lists).
//   pass 1: tiles[(s * nrel + k) * 8 + r] = the sum of row r of those
//           quanta's partials, one warp per cell: the list is dealt
//           round-robin to the 32 lanes, each lane adds its share in
//           list order, and the lanes combine by xor shuffles (lane l
//           with l ^ 16, then l ^ 8, ..., l ^ 1), so a row block with
//           thousands of quanta costs a few dozen steps per lane, not a
//           chain of thousands of dependent loads;
//   pass 2: y[(w * h + k) * 8 + r] = sum over the steps whose windows hold
//           w, in step order, of their tile's cell ((w - base[s]) * h + k,
//           r). When base is non-decreasing a thread finds those steps by
//           binary search; any other order scans every step.
// Every sum has a fixed order, so the result is deterministic and equals
// the plain PyTorch version (the same lanes and tree over a cell's quanta,
// then index_add_ over steps, run on the CPU) bit for bit. Every element
// of y is written, so a window no step visits is 0. Both passes are
// templates on the value type: float for the f32 paths, double for the
// fp64 fused PELL kernel (pell.cu), with the same order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace segpass {

constexpr int kRows = 8;
constexpr int kPassThreads = 256;
constexpr int kCellLanes = 32;
constexpr int kCellUnroll = 4;

// A sum rounded on its own (no contraction into an FMA).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Pass 1 for one cell, by one warp: acc[r] = the cell's sum of row r
// (every lane ends with it). load(q, v) reads quantum q's 8 rows into v.
template <class T, class Load>
__device__ __forceinline__ void warp_cell_sum(const int* __restrict__ order,
                                              int lo, int hi, Load load,
                                              T (&acc)[kRows]) {
  const int lane = threadIdx.x & (kCellLanes - 1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);
  int i = lo + lane;
  // kCellUnroll quanta a lane at once, so that their loads are in flight
  // together; the adds stay in list order
  for (; i + (kCellUnroll - 1) * kCellLanes < hi; i += kCellUnroll * kCellLanes) {
    T v[kCellUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kCellUnroll; ++u) load(__ldg(order + i + u * kCellLanes), v[u]);
#pragma unroll
    for (int u = 0; u < kCellUnroll; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = add_rn(acc[r], v[u][r]);
  }
  for (; i < hi; i += kCellLanes) {
    T v[kRows];
    load(__ldg(order + i), v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = add_rn(acc[r], v[r]);
  }
#pragma unroll
  for (int off = kCellLanes / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[r] = add_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], off));
}

// First step s in [0, steps) with base[s] >= w (base non-decreasing).
__device__ __forceinline__ int first_step_at_least(const int* __restrict__ base,
                                                   int steps, int w) {
  int lo = 0, hi = steps;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(base + mid) < w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class T>
__global__ void __launch_bounds__(kPassThreads)
window_pass(const T* __restrict__ tiles, const int* __restrict__ base,
            T* __restrict__ y, int steps, int h, int W, int64_t n_y) {
  int unsorted = 0;
  for (int s = threadIdx.x; s + 1 < steps; s += kPassThreads)
    unsorted |= __ldg(base + s) > __ldg(base + s + 1);
  unsorted = __syncthreads_or(unsorted);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (e >= n_y) return;
  const int64_t per_win = static_cast<int64_t>(h) * kRows;
  const int w = static_cast<int>(e / per_win);
  const int64_t cell = e - w * per_win;
  T acc = T(0);
  int lo = 0, hi = steps;
  if (!unsorted) {
    lo = first_step_at_least(base, steps, w - W + 1);
    hi = first_step_at_least(base, steps, w + 1);
  }
  for (int s = lo; s < hi; ++s) {
    const int d = w - __ldg(base + s);
    if (d >= 0 && d < W)
      acc = add_rn(acc, tiles[(static_cast<int64_t>(s) * W + d) * per_win + cell]);
  }
  y[e] = acc;
}

// Launches pass 2 over y (num_windows * h * 8 values); returns the launch's
// cudaGetLastError().
template <class T>
inline int launch_window_pass(const T* tiles, const int* base, T* y,
                              int steps, int h, int W, int num_windows,
                              cudaStream_t st) {
  const int64_t n_y = static_cast<int64_t>(num_windows) * h * kRows;
  if (n_y > 0) {
    const int64_t blocks = (n_y + kPassThreads - 1) / kPassThreads;
    window_pass<T><<<static_cast<unsigned>(blocks), kPassThreads, 0, st>>>(
        tiles, base, y, steps, h, W, n_y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segpass

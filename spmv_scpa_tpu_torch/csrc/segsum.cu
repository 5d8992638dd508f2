// Windowed segment-sum for Hopper (sm_90a).
//
// Replaces: spmv_scpa_tpu/ops/segsum_kernel.py, make_window_segsum (the
// chips tail's per-row reduction, chips_tail.py:840).
//
// Function. The partials (steps * rows_per_step, 128) f32 hold, for quantum
// q = t * 128 + j of a step (tile t, lane j), an 8-vector in rows
// t * 8 .. t * 8 + 7 of the step's block, column j. The quantum adds its
// 8-vector into row rbl[q] of the step's window:
//     y[win[s] * h + rbl[q], r] += part[s * rows_per_step + t * 8 + r, j]
// y is (num_windows * h, 8). A quantum whose rbl is outside [0, h) adds
// nothing (h marks padding); every window's rows are written, visited or
// not.
//
// What bounds it on this card: bytes (each partial read once, y written
// once) and, at the chips tail's shapes (tens of steps, one window of
// h = 256), launch latency.
//
// Design. The TPU kernel reduces each step with a one-hot (h, g) matmul on
// the MXU in three bf16 passes, carrying the window's sum in its output
// block across the sequential grid. Blocks here run in no order, and the
// path has one window, so the parallelism comes from inside it:
//   pass 1, one block per step: the step's rbl and its partials go to
//     shared memory in coalesced loads; each thread owns output rows k and
//     adds, in quantum order, the 8 partials of every quantum with
//     rbl == k, reading shared memory only (a heavy row's quanta all fall
//     to one thread, so its chain of adds must not wait on device memory);
//     the step's (h, 8) tile goes to a scratch buffer;
//   pass 2, one thread per y element: the sum over the window's steps in
//     step order. When win is non-decreasing, as the chips plans keep it
//     (and the TPU kernel's carried accumulator needs), a thread finds its
//     window's step range by binary search and reads only those steps, so
//     the work is steps * h * 8 whatever the number of windows; each block
//     first checks the order, and for any other order every thread scans
//     all steps.
// No atomics: the order of every sum is fixed, so the result is
// deterministic and equals the plain PyTorch version (index_add_ over
// quanta, then over steps, on the CPU) bit for bit. rbl need not be
// sorted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
step_tiles(const float* __restrict__ part, const int* __restrict__ rbl,
           float* __restrict__ tiles, int rows_per_step, int h) {
  extern __shared__ int smem[];
  const int step = blockIdx.x;
  const int g = rows_per_step / kRows * kLanes;  // quanta per step
  int* s_rbl = smem;
  float* s_part = reinterpret_cast<float*>(smem + g);  // rows_per_step*128
  for (int q = threadIdx.x; q < g; q += kThreads)
    s_rbl[q] = __ldg(rbl + static_cast<int64_t>(step) * g + q);
  const float* blk = part + static_cast<int64_t>(step) * rows_per_step * kLanes;
  for (int i = threadIdx.x; i < rows_per_step * kLanes; i += kThreads)
    s_part[i] = __ldg(blk + i);
  __syncthreads();
  for (int k = threadIdx.x; k < h; k += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int q = 0; q < g; ++q) {
      if (s_rbl[q] != k) continue;
      const float* src = s_part + (q / kLanes) * kRows * kLanes + (q % kLanes);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = __fadd_rn(acc[r], src[r * kLanes]);
    }
    float* dst = tiles + (static_cast<int64_t>(step) * h + k) * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = acc[r];
  }
}

// First step s in [0, steps) with win[s] >= w (win non-decreasing).
__device__ int first_step_of(const int* __restrict__ win, int steps, int w) {
  int lo = 0, hi = steps;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(win + mid) < w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
window_sums(const float* __restrict__ tiles, const int* __restrict__ win,
            float* __restrict__ y, int steps, int h, int64_t n_y) {
  int unsorted = 0;
  for (int s = threadIdx.x; s + 1 < steps; s += kThreads)
    unsorted |= __ldg(win + s) > __ldg(win + s + 1);
  unsorted = __syncthreads_or(unsorted);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_y) return;
  const int64_t per_win = static_cast<int64_t>(h) * kRows;
  const int w = static_cast<int>(e / per_win);
  const int64_t cell = e - w * per_win;
  float acc = 0.0f;
  if (unsorted) {
    for (int s = 0; s < steps; ++s)
      if (__ldg(win + s) == w)
        acc = __fadd_rn(acc, tiles[s * per_win + cell]);
  } else {
    const int end = first_step_of(win, steps, w + 1);
    for (int s = first_step_of(win, steps, w); s < end; ++s)
      acc = __fadd_rn(acc, tiles[s * per_win + cell]);
  }
  y[e] = acc;
}

}  // namespace

// part (steps * rows_per_step, 128) f32; rbl (steps * g,) i32 with
// g = rows_per_step / 8 * 128; win (steps,) i32; tiles (steps * h * 8,) f32
// scratch; y (num_windows * h, 8) f32. Shared memory per step block:
// g * 4 + rows_per_step * 512 bytes (the wrapper keeps it within 48 KB).
extern "C" int window_segsum(const void* part, const void* rbl,
                             const void* win, void* tiles, void* y,
                             int steps, int rows_per_step, int h,
                             int num_windows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = rows_per_step / kRows * kLanes;
  if (steps > 0 && h > 0) {
    const size_t smem = g * sizeof(int)
                        + static_cast<size_t>(rows_per_step) * kLanes * sizeof(float);
    step_tiles<<<steps, kThreads, smem, st>>>(
        static_cast<const float*>(part), static_cast<const int*>(rbl),
        static_cast<float*>(tiles), rows_per_step, h);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int64_t n_y = static_cast<int64_t>(num_windows) * h * kRows;
  if (n_y > 0) {
    const int64_t blocks = (n_y + kThreads - 1) / kThreads;
    window_sums<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(win),
        static_cast<float*>(y), steps, h, n_y);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Segment-sums for Hopper (sm_90a): per-quantum 8-row partials into y.
//
// Replaces: spmv_scpa_tpu/ops/segsum_kernel.py, make_span_segsum (PELL's
// span scheme) and make_window_segsum (the chips tail, PELL's window-pure
// scheme and BCSR), the latter being the case W = 1.
//
// Function. The partials (steps * rows_per_step, nq) f32 hold, for quantum
// Q = t * nq + j (tile t, column j), an 8-vector in rows t * 8 .. t * 8 + 7,
// column j. Step s adds each of its quanta into a cell of the W windows
// base[s] .. base[s] + W - 1 of y (num_windows * h, 8), or nowhere; which
// cell is given by the index order/ptr (segsum_pass.cuh), which the host
// builds once from the reference's row-block ids.
//
// What bounds it on this card: bytes (each partial of a listed quantum read
// once, y written once); a row block that takes most of a step's quanta
// costs its warp one pass over them.
//
// Design. The TPU kernels build a one-hot (W * h, g) matrix per step from
// the row-block ids and reduce with it on the MXU in bf16 passes, carrying
// each window's sum across the sequential grid in staggered outputs with
// visit masks. Here, pass 1 gives each (step, cell) one warp, which adds
// its listed quanta from device memory (work proportional to the quanta,
// not to cells times quanta, and no shared memory bound on the step
// size); pass 2 sums each window's steps in step order (segsum_pass.cuh).
// No atomics, no masks: deterministic, and every window is written.

#include <cstdint>
#include <cuda_runtime.h>

#include "segsum_pass.cuh"

namespace {

constexpr int kRows = segpass::kRows;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / segpass::kCellLanes;

// Pass 1, one warp per (step, cell).
__global__ void __launch_bounds__(kThreads)
cell_sums(const float* __restrict__ part, const int* __restrict__ order,
          const int* __restrict__ ptr, float* __restrict__ tiles, int nq,
          int64_t n_cells) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (c >= n_cells) return;
  float acc[kRows];
  segpass::warp_cell_sum(order, __ldg(ptr + c), __ldg(ptr + c + 1),
                         [&](int q, float (&v)[kRows]) {
                           const int t = q / nq;
                           const float* p = part + static_cast<int64_t>(t) * kRows * nq + (q - t * nq);
#pragma unroll
                           for (int r = 0; r < kRows; ++r) v[r] = __ldg(p + r * nq);
                         },
                         acc);
  if ((threadIdx.x & 31) == 0) {
    float4* dst = reinterpret_cast<float4*>(tiles + c * kRows);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

}  // namespace

// part (steps * rows_per_step, nq) f32; order (listed quanta,) i32 and ptr
// (steps * W * h + 1,) i32 from segment_lists; base (steps,) i32; tiles
// (steps * W * h * 8,) f32 scratch; y (num_windows * h, 8) f32.
extern "C" int span_segsum(const void* part, const void* order,
                           const void* ptr, const void* base, void* tiles,
                           void* y, int steps, int nq, int h, int W,
                           int num_windows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_cells = static_cast<int64_t>(steps) * W * h;
  if (n_cells > 0) {
    const int64_t blocks = (n_cells + kWarps - 1) / kWarps;
    cell_sums<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(part), static_cast<const int*>(order),
        static_cast<const int*>(ptr), static_cast<float*>(tiles), nq, n_cells);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return segpass::launch_window_pass(
      static_cast<const float*>(tiles), static_cast<const int*>(base),
      static_cast<float*>(y), steps, h, W, num_windows, st);
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

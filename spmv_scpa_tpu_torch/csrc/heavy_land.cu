// The heavy-row landing for Hopper (sm_90a): the chips tail's per-heavy-row
// sums added into y by a direct scatter.
//
// Replaces, in the landing role (spmv_scpa_tpu/ops/chips_tail.py, the
// "zero-scatter panel merge" make_merge_apply / make_merge_apply_windowed
// at :987-1064, called from ops/lane_ell.py:1479 and :1573 and
// parallel/distributed.py:576-582):
//   heavy_land <- make_ranked_gather (ops/ext_gather.py:121) or
//                 make_resident_window_gather (:167) run over every row of
//                 y, with the zeroed, padded copy of the sums they read and
//                 the add of their whole output into y
// The ext route of the lanes core and the chips tail's x side on
// chips_x="hot" keep those gathers (csrc/ext_gather.cu).
//
// Function, for every k < n:
//     y[land[k]] = y[land[k]] + ys[k]     0 <= land[k] < n_y
//     nothing                             land[k] == -1 (a rank that is no
//                                         heavy row: window padding, a
//                                         padded shard plan's pad rank)
// One f32 add rounded once (__fadd_rn): bit-equal to the plain version,
// y[idx] = y[idx] + ys[sel] in PyTorch. land is an int32 map built once on
// the host (ops/chips_tail.py:land_map), which checks that it names every
// row at most once: no two threads touch one element of y, so no atomics
// are needed and the result is deterministic. A row outside y is skipped,
// so the kernel never writes outside y.
//
// What bounds it on this card: bytes, and at the main path's sizes (a few
// thousand heavy rows) the launch. Per heavy row a 4-byte entry of land, a
// 4-byte sum and a 4-byte read-modify-write of y: 16 B; per rank that is no
// heavy row, its 4-byte entry of land.
//
// Design. A TPU has no cheap scatter, so the reference merges the sums
// into y as a gather over all G_out * 128 >= m rows of y (12 B a row: two
// index planes and the output) from a zeroed, padded copy of the sums, and
// adds the whole result into y: four launches and about 24 B a row of y to
// add NH sums. Hopper stores to any address: one thread per rank k reads
// land[k] and ys[k] (coalesced in k, streaming loads: read once) and
// updates its one row of y. Nothing is read or written for the other rows
// of y, and the core's y is updated in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
land_kernel(const float* __restrict__ ys, const int* __restrict__ land,
            float* __restrict__ y, int64_t n, int64_t n_y) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n) return;
  const int r = __ldcs(land + k);
  if (r < 0 || r >= n_y) return;
  y[r] = __fadd_rn(y[r], __ldcs(ys + k));
}

}  // namespace

// ys (n,) f32; land (n,) i32, each row of y at most once; y (n_y,) f32,
// updated in place.
extern "C" int heavy_land(const void* ys, const void* land, void* y,
                          int64_t n, int64_t n_y, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    land_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ys), static_cast<const int*>(land),
        static_cast<float*>(y), n, n_y);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

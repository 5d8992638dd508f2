// Lane-ELL core SpMV for Hopper (sm_90a).
//
// Replaces: spmv_scpa_tpu/ops/lane_ell.py, `_lane_ell_kernel` (launched by
// the pallas_call in `prepare_lane_ell_hybrid`).
//
// What bounds it on this card: bytes. Every call streams the slot planes
// once (4 B of f32 value plus 1 B (int8) or 2 B (int16) of index per slot:
// 168.5 MB for the 22.6M-nnz flagship) and does one multiply-add per slot,
// far below the arithmetic the card could do on those bytes. The padded x
// (1.5 MB on the flagship) is re-read by every plane, but it stays resident
// in the 50 MB L2, so device-memory traffic is the plane stream.
//
// What the design does about it: one thread per row over the col-major
// slot planes (the coalesced HLL layout of the reference study's k1
// kernel, cuda_hll.cu:49-72). A block of 128 threads is one 128-row group,
// so for every plane the block reads 512 contiguous bytes of values and
// 128 or 256 contiguous bytes of indices. The TPU kernel's per-plane strip
// select chain (needed there because its lane gather reaches only 128
// lanes) is dropped: each slot decodes to one absolute index into the
// padded x and reads it through L2. Products and sums are rounded
// separately (no FMA contraction) in ascending plane order, so the result
// equals the plain PyTorch version bit for bit. The ext strip is a template
// branch: a matrix without ext panels runs the instantiation that has no
// ext compare at all, the same code as before ext existed.
//
// Layout (all row-major with 128 lanes):
//   vals  (steps*QT*chunk, 128) f32;  group g = step*chunk + c, plane q
//         sits at row (step*QT + q)*chunk + c; idx8/idx16 likewise with
//         n8 / n16 = QT - n8 planes in place of QT.
//   idx8  plane q < n8: bit 7 picks tabs[q][0] or tabs[q][1], bits 0-6
//         are the lane within the strip.
//   idx16 plane q >= n8: strip = code >> 7; a strip >= nw is dynamic slot
//         j = strip - nw, whose strip is dynw[step*TD + tabs[q][0] + j].
//   strip s < S reads xpad row g + s (the sliding local window); strip
//   ext_w (>= S, or -1 when the matrix has no ext panels) reads lane
//   `code & 127` of the group's own ext panel, ext row g (the TPU kernel's
//   step-aligned ext block, lane_ell.py:251-253); any other strip s >= S
//   is a hot strip and reads xpad row P_pad + s - S.
// Padding slots hold value 0 and decode to a valid x address.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

template <bool kExt>
__global__ void __launch_bounds__(kLanes)
lane_ell_kernel(const float* __restrict__ xpad,
                const float* __restrict__ vals,
                const uint8_t* __restrict__ idx8,
                const int16_t* __restrict__ idx16,
                const int* __restrict__ tabs,
                const int* __restrict__ dynw,
                const float* __restrict__ ext,
                float* __restrict__ y,
                int QT, int n8, int chunk, int S, int nw, int TD,
                int P_pad, int ext_w) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int step = g / chunk;
  const int c = g - step * chunk;
  const int n16 = QT - n8;
  float acc = 0.0f;
  for (int q = 0; q < QT; ++q) {
    const int64_t vrow = (static_cast<int64_t>(step) * QT + q) * chunk + c;
    const float v = __ldg(vals + vrow * kLanes + lane);
    int code, strip;
    if (q < n8) {
      const int64_t r = (static_cast<int64_t>(step) * n8 + q) * chunk + c;
      code = __ldg(idx8 + r * kLanes + lane);          // unsigned byte
      strip = __ldg(tabs + 2 * q + (code >> 7));
    } else {
      const int64_t r =
          (static_cast<int64_t>(step) * n16 + (q - n8)) * chunk + c;
      code = static_cast<int>(__ldg(idx16 + r * kLanes + lane));
      strip = code >> 7;
      if (strip >= nw)
        strip = __ldg(dynw + static_cast<int64_t>(step) * TD
                      + __ldg(tabs + 2 * q) + (strip - nw));
    }
    const int xl = code & (kLanes - 1);
    float xv;
    if (kExt && strip == ext_w) {
      xv = __ldg(ext + static_cast<int64_t>(g) * kLanes + xl);
    } else {
      const int64_t xrow = strip < S ? static_cast<int64_t>(g) + strip
                                     : static_cast<int64_t>(P_pad) + strip - S;
      xv = __ldg(xpad + xrow * kLanes + xl);
    }
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  y[static_cast<int64_t>(g) * kLanes + lane] = acc;
}

}  // namespace

extern "C" int lane_ell_spmv(const void* xpad, const void* vals,
                             const void* idx8, const void* idx16,
                             const void* tabs, const void* dynw,
                             const void* ext, void* y, int G_pad, int QT,
                             int n8, int chunk, int S, int nw, int TD,
                             int P_pad, int ext_w, void* stream) {
  if (G_pad > 0) {
    auto kernel = ext_w >= 0 ? lane_ell_kernel<true> : lane_ell_kernel<false>;
    kernel<<<G_pad, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xpad), static_cast<const float*>(vals),
        static_cast<const uint8_t*>(idx8),
        static_cast<const int16_t*>(idx16), static_cast<const int*>(tabs),
        static_cast<const int*>(dynw), static_cast<const float*>(ext),
        static_cast<float*>(y), QT, n8, chunk, S, nw, TD, P_pad, ext_w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

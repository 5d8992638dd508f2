// Lane-ELL core SpMV for Hopper (sm_90a), in f32 and at fp64 grade.
//
// Replaces: spmv_scpa_tpu/ops/lane_ell.py, `_lane_ell_kernel` (launched by
// the pallas_call in `prepare_lane_ell_hybrid`) with lane_ell_spmv, the
// same body launched per row shard by the pallas_call of
// spmv_scpa_tpu/parallel/distributed.py:prepare_row_sharded_hybrid (:510)
// with lane_ell_sharded, and `_lane_ell_kernel_df64` (launched at :484 by
// `prepare_lane_ell_df64`) with lane_ell_fp64, below the f32 kernels.
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

// Row shards. The row-sharded hybrid packs each row shard on its own,
// pads the shards' planes to one QT and unions their strip sets, so one
// program serves them all; the TPU runs it once per shard under shard_map.
// Here one launch runs every shard that lives on the card: blockIdx.y is
// the shard, whose planes, ext panels and output sit at shard * their
// stride. Shard d's window of x starts r0[d] elements into the shared
// padded x ([zeros(loc_w) | x | zeros(P_pad*128)]); r0 is the shard's
// first global row, an element offset that is no multiple of 128, so x is
// read by scalar __ldg only (no vector load could be aligned). As
// jax.lax.dynamic_slice does, the start is clamped so that the window of
// P_pad*128 elements lies inside xpad. A shard's core has no dynamic and no
// hot strips: a strip below S is local, strip S (when the shards have ext
// panels) is the group's ext panel. Padding slots (planes above a shard's
// own QT) hold value 0 and index 0: strip 0 (or the plane's first union
// strip for int8), lane 0, a valid address. What bounds it: the same
// plane bytes as lane_ell_spmv, per shard; the design is the same thread
// per row, ascending planes, products and sums rounded separately.
template <bool kExt>
__global__ void __launch_bounds__(kLanes)
lane_ell_sharded_kernel(const float* __restrict__ xpad,
                        const int* __restrict__ r0,
                        const float* __restrict__ vals,
                        const uint8_t* __restrict__ idx8,
                        const int16_t* __restrict__ idx16,
                        const int* __restrict__ tabs,
                        const float* __restrict__ ext,
                        float* __restrict__ y, int64_t xlen, int G_pad,
                        int QT, int n8, int chunk, int S, int P_pad) {
  const int g = blockIdx.x;
  const int64_t d = blockIdx.y;
  const int lane = threadIdx.x;
  const int step = g / chunk;
  const int c = g - step * chunk;
  const int n16 = QT - n8;
  const int64_t last = xlen - static_cast<int64_t>(P_pad) * kLanes;
  int64_t base = __ldg(r0 + d);
  base = base < 0 ? 0 : (base > last ? last : base);
  const float* xs = xpad + base;
  vals += d * G_pad * QT * kLanes;
  idx8 += d * G_pad * n8 * kLanes;
  idx16 += d * G_pad * n16 * kLanes;
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
    }
    const int xl = code & (kLanes - 1);
    float xv;
    if (kExt && strip == S) {
      xv = __ldg(ext + (d * G_pad + g) * kLanes + xl);
    } else {
      xv = __ldg(xs + (static_cast<int64_t>(g) + strip) * kLanes + xl);
    }
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  y[(d * G_pad + g) * kLanes + lane] = acc;
}

// fp64 grade. The TPU has no fp64: its kernel splits each value and x into
// f32 hi/lo pairs, forms Dekker products and accumulates them as 8 planes of
// signed 7-bit digits on a power-of-two scale, which the host adds up in
// float64. Hopper computes in double, so this kernel computes the same y
// directly: one thread per row, the slots in plane order, each product and
// sum rounded separately (__dmul_rn / __dadd_rn: nvcc cannot contract them
// into an FMA that would round otherwise than the plain PyTorch version).
// There is no strip select: the fp64 plan keeps every entry inside the
// group's window, so the int16 code is the offset into the window, and the
// slot reads xpad[g * 128 + code]. What bounds it: bytes, 10 per slot (f64
// value, int16 offset), the padded x pair of the TPU becomes one f64 x read
// through L2.
//   vals (steps*Q*chunk, 128) f64, idx the same in int16; group g = step *
//   chunk + c, plane q at row (step*Q + q)*chunk + c; xpad (P_pad*128,) f64;
//   y (G_pad*128,) f64. Padding slots hold value 0 and offset 0.
__global__ void __launch_bounds__(kLanes)
lane_ell_fp64_kernel(const double* __restrict__ xpad,
                     const double* __restrict__ vals,
                     const int16_t* __restrict__ idx,
                     double* __restrict__ y, int Q, int chunk) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int step = g / chunk;
  const int c = g - step * chunk;
  const double* xw = xpad + static_cast<int64_t>(g) * kLanes;
  double acc = 0.0;
  for (int q = 0; q < Q; ++q) {
    const int64_t r = (static_cast<int64_t>(step) * Q + q) * chunk + c;
    const double v = __ldg(vals + r * kLanes + lane);
    const int code = __ldg(idx + r * kLanes + lane);
    acc = __dadd_rn(acc, __dmul_rn(v, __ldg(xw + code)));
  }
  y[static_cast<int64_t>(g) * kLanes + lane] = acc;
}

}  // namespace

extern "C" int lane_ell_fp64(const void* xpad, const void* vals,
                             const void* idx, void* y, int G_pad, int Q,
                             int chunk, void* stream) {
  if (G_pad > 0) {
    lane_ell_fp64_kernel<<<G_pad, kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(xpad), static_cast<const double*>(vals),
        static_cast<const int16_t*>(idx), static_cast<double*>(y), Q, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

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

extern "C" int lane_ell_sharded(const void* xpad, const void* r0,
                                const void* vals, const void* idx8,
                                const void* idx16, const void* tabs,
                                const void* ext, void* y, int64_t xlen,
                                int n_sh, int G_pad, int QT, int n8,
                                int chunk, int S, int P_pad, int ext_w,
                                void* stream) {
  if (G_pad > 0 && n_sh > 0) {
    auto kernel = ext_w >= 0 ? lane_ell_sharded_kernel<true>
                             : lane_ell_sharded_kernel<false>;
    kernel<<<dim3(G_pad, n_sh), kLanes, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xpad), static_cast<const int*>(r0),
        static_cast<const float*>(vals), static_cast<const uint8_t*>(idx8),
        static_cast<const int16_t*>(idx16), static_cast<const int*>(tabs),
        static_cast<const float*>(ext), static_cast<float*>(y), xlen, G_pad,
        QT, n8, chunk, S, P_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

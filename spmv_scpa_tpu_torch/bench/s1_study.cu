// The flat slot table's S1 kernel, for bench/s1_study.py only: the same
// products as xpose_s1_slots (csrc/xpose.cu) from a table of 12 B an
// entry (a 4-byte mid position, x column and value, each its own array,
// sorted by position, padded to a multiple of four with position -1),
// four entries a thread through 16-byte streaming loads. Against the
// committed 8 B table it shows what the chunk headers save and cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
flat_kernel(const float* __restrict__ x, int64_t n, const int4* __restrict__ pos,
            const int4* __restrict__ col, const float4* __restrict__ val,
            int64_t n4, float* __restrict__ mid, int64_t n_mid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 p = __ldcs(pos + i);
  const int4 c = __ldcs(col + i);
  const float4 v = __ldcs(val + i);
  const int ps[4] = {p.x, p.y, p.z, p.w};
  const int cs[4] = {c.x, c.y, c.z, c.w};
  const float vs[4] = {v.x, v.y, v.z, v.w};
  float r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = 0.0f;
    if (vs[j] != 0.0f && cs[j] >= 0 && cs[j] < n) r[j] = __fmul_rn(__ldg(x + cs[j]), vs[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ps[j] >= 0 && ps[j] < n_mid) mid[ps[j]] = r[j];
}

}  // namespace

extern "C" int s1_flat(const void* x, int64_t n, const void* pos,
                       const void* col, const void* val, int64_t n4,
                       void* mid, int64_t n_mid, void* stream) {
  if (n4 > 0) {
    const int64_t blocks = (n4 + kThreads - 1) / kThreads;
    flat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<const int4*>(pos),
        static_cast<const int4*>(col), static_cast<const float4*>(val), n4,
        static_cast<float*>(mid), n_mid);
  }
  return static_cast<int>(cudaGetLastError());
}

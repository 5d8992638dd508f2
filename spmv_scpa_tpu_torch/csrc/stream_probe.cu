// Device-memory read-stream probe for Hopper (sm_90a).
//
// Replaces: spmv_scpa_tpu/bench/roofline.py, `kern` inside
// `measure_stream_bw` (the Pallas kernel that streams f32 (chunk*8, 128)
// blocks and reduces them to one (8, 128) tile).
//
// What bounds it on this card: bytes. It reads every byte of the buffer
// once and does one add per element; the measured rate is the bandwidth
// that both roofline fractions of the SpMV divide by. The buffer must be
// far larger than the 50 MB L2 (the caller uses 512 MB), or repeated
// reads hit in L2 and overstate the bandwidth.
//
// What the design does about it: a grid-stride loop of 16-byte (float4)
// loads, neighbouring threads on neighbouring addresses, four blocks per
// SM. Each loop trip issues kUnroll independent loads into as many
// accumulators, so enough bytes are in flight to cover device-memory
// latency (a single accumulator, or more blocks with more end-of-kernel
// atomics, measured slower on the H100). The float4 stride of the loop is
// a multiple of 256, so every thread always lands on the same four
// positions of the (8, 128) = 1024-float tile; at the end each thread adds
// its four sums into the zeroed output with atomics (one pass, no second
// launch). Atomics add in a varying order: the sums are exact, and so
// order-free, when the buffer holds small integers, as the probe's buffer
// of ones does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;          // floats in one (8, 128) tile
constexpr int kThreads = kTile / 4;     // one float4 position per thread
constexpr int kUnroll = 8;              // independent loads per loop trip

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__global__ void __launch_bounds__(kThreads)
stream_reduce_kernel(const float4* __restrict__ buf, int64_t n4,
                     float* __restrict__ out) {
  const int t = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float4 acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(buf + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(acc[u], v[u]);
  }
  for (; i < n4; i += stride) add4(acc[0], __ldg(buf + i));
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) add4(acc[0], acc[u]);
  atomicAdd(out + 4 * t + 0, acc[0].x);
  atomicAdd(out + 4 * t + 1, acc[0].y);
  atomicAdd(out + 4 * t + 2, acc[0].z);
  atomicAdd(out + 4 * t + 3, acc[0].w);
}

}  // namespace

// buf: n floats (n a multiple of 1024, 16-byte aligned); out: 1024 floats,
// zeroed by the caller, receives the (8, 128) sum.
extern "C" int stream_reduce(const void* buf, int64_t n, int nblocks,
                             void* out, void* stream) {
  stream_reduce_kernel<<<nblocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n / 4, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

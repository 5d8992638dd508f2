// Device-memory read-stream probe for Hopper (sm_90a).
//
// Replaces: spmv_scpa_tpu/bench/roofline.py, `kern` inside
// `measure_stream_bw` (the Pallas kernel that streams f32 (chunk*8, 128)
// blocks and reduces them to one (8, 128) tile). Two entry points compute
// that function: stream_reduce, the probe, and stream_reduce_strided, the
// first port's grid-stride design, kept for the A/B.
//
// What bounds it on this card: bytes. It reads every byte of the buffer
// once and does one add per element; the measured rate is the bandwidth
// that both roofline fractions of the SpMV divide by, so a probe slower
// than the memory makes every fraction too generous. The buffer must be
// far larger than the 50 MB L2 (the caller uses 512 MB), or repeated
// reads hit in L2 and overstate the bandwidth.
//
// Design of stream_reduce: each block owns one contiguous span of whole
// (8, 128) tiles, one 256-thread block an SM, so the card reads 132 long
// runs of DRAM pages at a time. One thread keeps kStages TMA bulk copies
// (cp.async.bulk) of kChunk floats in flight into a ring of shared-memory
// stages, each completing on its mbarrier; all threads add a stage from
// shared memory in 16-byte reads, then the producer refills it. A chunk
// is whole tiles and the block 256 threads, so thread t always adds the
// four tile positions 4 t .. 4 t + 3. The block adds each position into
// the zeroed output with one atomic: at most one atomic per position per
// block, and no second launch. Chosen on the card with
// bench/probe_study.py (NVIDIA H100 80GB HBM3, 700.00 W): one block an SM
// reads at about 3.03 TB/s, two blocks an SM (twice the spans) at about
// 2.95, whichever way they read; at one block an SM the ring of bulk
// copies was 0.1-0.3% faster than 16-byte loads with an L2 prefetch hint
// (ld.global.nc.L1::no_allocate.L2::256B), which bench/probe_study.cu
// keeps with the other shapes tried.
//
// stream_reduce_strided: a grid-stride loop of 16-byte loads, four
// 256-thread blocks an SM, kUnroll loads a trip a grid's stride apart
// (2.16 MB on an H100), then four atomics a thread (528 x 1,024 onto the
// same 1,024 floats).
//
// Atomics add in a varying order: the sums are exact, and so order-free,
// when the buffer holds small integers, as the probe's buffer of ones does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;          // floats in one (8, 128) tile
constexpr int kTile4 = kTile / 4;       // float4 positions in a tile
constexpr int kUnroll = 8;              // strided: loads per loop trip
constexpr int kThreads = kTile4;        // stream_reduce: one float4 each
constexpr int kStages = 4;              // bulk copies in flight a block
constexpr int kChunk = 8 * kTile;       // floats a bulk copy (32 KB)
constexpr int kChunk4 = kChunk / 4;

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes from src into dst, completing on bar (expected bytes set first).
__device__ __forceinline__ void bulk_load(float4* dst, const float4* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Block b reads float4s [b * span4, min((b + 1) * span4, n4)), span4 a
// multiple of kTile4, in chunks of kChunk4; chunk c into stage c % kStages.
__global__ void __launch_bounds__(kThreads, 1)
stream_reduce_kernel(const float4* __restrict__ buf, int64_t n4,
                     int64_t span4, float* __restrict__ out) {
  extern __shared__ __align__(128) float4 stage[];     // kStages * kChunk4
  __shared__ __align__(8) uint64_t bar[kStages];
  const int t = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span4;
  const int64_t hi = min(lo + span4, n4);
  const int64_t nc = hi > lo ? (hi - lo + kChunk4 - 1) / kChunk4 : 0;
  auto issue = [&](int64_t c) {
    const int64_t a = lo + c * kChunk4;
    const int64_t b = min(a + kChunk4, hi);
    bulk_load(stage + (c % kStages) * kChunk4, buf + a,
              static_cast<unsigned>((b - a) * 16), bar + c % kStages);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0)
    for (int64_t c = 0; c < kStages && c < nc; ++c) issue(c);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t c = 0; c < nc; ++c) {
    const int s = static_cast<int>(c % kStages);
    mbar_wait(bar + s, static_cast<unsigned>((c / kStages) & 1));
    const int n = static_cast<int>(min(lo + (c + 1) * kChunk4, hi) - (lo + c * kChunk4));
    const float4* st = stage + s * kChunk4;
#pragma unroll 8
    for (int j = t; j < n; j += kThreads) add4(acc, st[j]);
    // the stage is read: refill it. The fence orders the reads (generic
    // proxy) before the bulk copy's writes (async proxy).
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (t == 0 && c + kStages < nc) issue(c + kStages);
  }
  atomicAdd(out + 4 * t + 0, acc.x);
  atomicAdd(out + 4 * t + 1, acc.y);
  atomicAdd(out + 4 * t + 2, acc.z);
  atomicAdd(out + 4 * t + 3, acc.w);
}

__global__ void __launch_bounds__(kTile4)
strided_kernel(const float4* __restrict__ buf, int64_t n4,
               float* __restrict__ out) {
  const int t = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile4;
  float4 acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t i = static_cast<int64_t>(blockIdx.x) * kTile4 + t;
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
// zeroed by the caller, receives the (8, 128) sum. nblocks: the grid (one
// an SM), each block a contiguous span of whole tiles.
extern "C" int stream_reduce(const void* buf, int64_t n, int nblocks,
                             void* out, void* stream) {
  const int64_t tiles = n / kTile;
  if (tiles > 0 && nblocks > 0) {
    const size_t smem = static_cast<size_t>(kStages) * kChunk * sizeof(float);
    const int err = static_cast<int>(cudaFuncSetAttribute(
        stream_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err != 0) return err;
    const int64_t span = (tiles + nblocks - 1) / nblocks;
    const int64_t grid = (tiles + span - 1) / span;
    stream_reduce_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(buf), n / 4, span * kTile4,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function, grid-stride (nblocks: four an SM).
extern "C" int stream_reduce_strided(const void* buf, int64_t n, int nblocks,
                                     void* out, void* stream) {
  if (n > 0 && nblocks > 0) {
    strided_kernel<<<nblocks, kTile4, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(buf), n / 4, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

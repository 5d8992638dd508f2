// Design study of the stream probe (csrc/stream_probe.cu) on Hopper: the
// same function, the (8, 128) sum of a buffer of whole tiles, read two
// ways, each block owning one contiguous span of tiles and adding each
// tile position into the zeroed output with one atomic.
//
//   ldg<T, U>   T threads a block, U 16-byte loads a thread in flight, each
//               ld.global.nc.L1::no_allocate.L2::256B;
//   ring<S, C>  one producer thread keeps S TMA bulk copies (cp.async.bulk,
//               C floats each) in flight into a ring of shared-memory
//               stages, completing on mbarriers; 256 threads add each
//               stage from shared memory, then the producer refills it
//               (csrc's probe is ring<4, 8192> at one block an SM).
//
// bench/probe_study.py builds this file and times every design against
// the probe, the grid-stride kernel and torch's sum on one 512 MB buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;
constexpr int kTile4 = kTile / 4;
constexpr int kRingThreads = 256;

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// Threads t, t + 256, ... hold tile positions 4 (t % 256) .. +3: add them
// in order and put each position into out with one atomic.
template <int T>
__device__ __forceinline__ void finish(float4 acc, float4* part, float* out) {
  const int t = threadIdx.x;
  part[t] = acc;
  __syncthreads();
  if (t < kTile4) {
#pragma unroll
    for (int j = 1; j < T / kTile4; ++j) add4(acc, part[t + j * kTile4]);
    atomicAdd(out + 4 * t + 0, acc.x);
    atomicAdd(out + 4 * t + 1, acc.y);
    atomicAdd(out + 4 * t + 2, acc.z);
    atomicAdd(out + 4 * t + 3, acc.w);
  }
}

template <int T, int U>
__global__ void __launch_bounds__(T)
ldg_kernel(const float4* __restrict__ buf, int64_t n4, int64_t span4,
           float* __restrict__ out) {
  __shared__ float4 part[T];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span4;
  const int64_t hi = min(lo + span4, n4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t i = lo + threadIdx.x;
  for (; i + (U - 1) * T < hi; i += U * T) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load_stream(buf + i + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u) add4(acc, v[u]);
  }
  for (; i < hi; i += T) add4(acc, load_stream(buf + i));
  finish<T>(acc, part, out);
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

// Block b's span: float4s [b * span4, min((b + 1) * span4, n4)), in
// chunks of C floats (whole tiles), chunk c into stage c % S.
template <int S, int C>
__global__ void __launch_bounds__(kRingThreads)
ring_kernel(const float4* __restrict__ buf, int64_t n4, int64_t span4,
            float* __restrict__ out) {
  constexpr int C4 = C / 4;
  extern __shared__ __align__(128) float4 stage[];     // S * C4
  __shared__ __align__(8) uint64_t bar[S];
  __shared__ float4 part[kRingThreads];
  const int t = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span4;
  const int64_t hi = min(lo + span4, n4);
  const int64_t nc = hi > lo ? (hi - lo + C4 - 1) / C4 : 0;
  auto issue = [&](int64_t c) {
    const int64_t a = lo + c * C4;
    const int64_t b = min(a + C4, hi);
    bulk_load(stage + (c % S) * C4, buf + a,
              static_cast<unsigned>((b - a) * 16), bar + c % S);
  };
  if (t == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0)
    for (int64_t c = 0; c < S && c < nc; ++c) issue(c);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t c = 0; c < nc; ++c) {
    const int s = static_cast<int>(c % S);
    mbar_wait(bar + s, static_cast<unsigned>((c / S) & 1));
    const int n = static_cast<int>(min(lo + (c + 1) * C4, hi) - (lo + c * C4));
    const float4* st = stage + s * C4;
#pragma unroll 8
    for (int j = t; j < n; j += kRingThreads) add4(acc, st[j]);
    // the stage is read: refill it. The fence orders the reads (generic
    // proxy) before the bulk copy's writes (async proxy).
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (t == 0 && c + S < nc) issue(c + S);
  }
  finish<kRingThreads>(acc, part, out);
}

template <class K>
int launch(K kernel, int threads, size_t smem, const void* buf, int64_t n,
           int nblocks, void* out, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int64_t tiles = n / kTile;
  const int64_t span = (tiles + nblocks - 1) / nblocks;
  const int64_t grid = (tiles + span - 1) / span;
  kernel<<<static_cast<unsigned>(grid), threads, smem, st>>>(
      static_cast<const float4*>(buf), n / 4, span * kTile4,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// design: 0 ldg<512, 8>, 1 ldg<1024, 8>, 2 ldg<1024, 4>, 3 ldg<512, 16>,
// 4 ring<6, 8192>, 5 ring<8, 4096>, 6 ring<3, 8192>. buf: n floats of
// whole tiles; out: 1024 zeroed floats; nblocks: the grid before rounding
// to whole spans.
extern "C" int probe_study(int design, const void* buf, int64_t n,
                           int nblocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < kTile || nblocks < 1) return 0;
  switch (design) {
    case 0: return launch(ldg_kernel<512, 8>, 512, 0, buf, n, nblocks, out, st);
    case 1: return launch(ldg_kernel<1024, 8>, 1024, 0, buf, n, nblocks, out, st);
    case 2: return launch(ldg_kernel<1024, 4>, 1024, 0, buf, n, nblocks, out, st);
    case 3: return launch(ldg_kernel<512, 16>, 512, 0, buf, n, nblocks, out, st);
    case 4: return launch(ring_kernel<6, 8192>, kRingThreads, 6 * 8192 * 4, buf, n,
                          nblocks, out, st);
    case 5: return launch(ring_kernel<8, 4096>, kRingThreads, 8 * 4096 * 4, buf, n,
                          nblocks, out, st);
    case 6: return launch(ring_kernel<3, 8192>, kRingThreads, 3 * 8192 * 4, buf, n,
                          nblocks, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* probe_study_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

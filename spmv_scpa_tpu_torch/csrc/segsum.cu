// Segment-sums for Hopper (sm_90a): per-quantum 8-row partials into y.
//
// Replaces: spmv_scpa_tpu/ops/segsum_kernel.py, make_span_segsum (:120,
// PELL's span scheme) and make_window_segsum (:259, the chips tail,
// PELL's window-pure scheme and BCSR). Both reach this one entry point:
// the host turns either kind of row-block id into a destination row
// block per quantum, and the kernel only reads the destinations' lists.
//
// Function. The partials (steps * rows_per_step, nq) f32 hold, for quantum
// Q = t * nq + j (tile t, column j), an 8-vector in rows t * 8 .. t * 8 + 7,
// column j. Every live quantum adds its 8-vector into its destination row
// block of y (n_dest, 8); a row block that no quantum reaches is 0.
//
// What bounds it on this card: bytes. The live quanta's partials are read
// once (32 B each), with one 4-byte id each from the index, and y is
// written once (32 B a row block, with 12 B of chunk and warp tables).
// With nq > 1 a quantum's 8 rows lie nq floats apart, so each of them
// costs a 32-byte sector of L2 traffic: on PELL's span scheme (nq 16) the
// kernel moves about 8x the bytes it uses, and that, not its index,
// bounds it.
//
// Design. The TPU kernels build a one-hot (W * h, g) matrix per step and
// reduce with it on the MXU, carrying each window's sum across the
// sequential grid. Here the host indexes the live quanta by destination,
// once per matrix (ops/segsum_kernel.py:dest_tables): each destination's
// quanta in ascending order, cut into chunks of at most C = 512 quanta
// (segsum_kernel.CHUNK; chosen on the card from 64-2048 with
// bench/segsum_chunk.py: C 256 and below add a hub pass on the chips
// tails, C 1024 and above lengthen the longest warp). A chunk's quanta are
// dealt round-robin to 32 lanes, each lane adds its share in list order
// (its ids loaded together, then its partials four quanta at a time), and
// the lanes combine by xor shuffles (segsum_pass.cuh:warp_tree). So the
// work grows with the live quanta plus the destinations, never with steps
// times cells, and only y is written. Warps and hubs: aligned runs of 2, 4
// or 8 chunks of at most 16, 8 or 4 quanta share a warp, 16, 8 or 4 lanes
// each (segsum_kernel.warp_groups, a host table), so the many row blocks
// of a few quanta, or none, do not each cost a warp's round trip; any
// other chunk takes a warp of its own. A hub, a row block of more than C
// quanta, gets several chunks: their warps write one scratch row each, and
// a second launch over the hubs alone adds each hub's chunk sums in chunk
// order. Where no destination has a second chunk the call is one launch.
// No atomics: deterministic, and bit-equal to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "segsum_pass.cuh"

namespace {

constexpr int kRows = segpass::kRows;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / segpass::kCellLanes;
constexpr int kPrefetch = 16;   // a lane's ids loaded together
constexpr int kUnroll = 4;      // a lane's quanta whose partials load together

// Warp w sums chunks warp[w] .. warp[w + 1] - 1, each into y (the only
// chunk of its destination) or into scratch row c (a chunk of a hub). One
// chunk: the whole warp walks it. k > 1 chunks: each gets 32/k lanes (16,
// 8 or 4) and holds no more quanta than that, one a lane, so the tree over
// its lanes adds what the whole warp's would (the other lanes hold +0).
__global__ void __launch_bounds__(kThreads)
chunk_sums(const float* __restrict__ part, const int* __restrict__ order,
           const int* __restrict__ chunk, const int* __restrict__ dest,
           const int* __restrict__ warp, float* __restrict__ scratch,
           float* __restrict__ y, int nq, int n_warps) {
  const int w = blockIdx.x * kWarps + threadIdx.x / segpass::kCellLanes;
  if (w >= n_warps) return;
  const int lane = threadIdx.x & (segpass::kCellLanes - 1);
  const int c0 = __ldg(warp + w);
  const int k = __ldg(warp + w + 1) - c0;
  // dense tiles (nq 1): a quantum's 8 rows are 32 contiguous bytes
  const bool vec = nq == 1 && (reinterpret_cast<uintptr_t>(part) & 15) == 0;
  auto load = [&](int q, float (&v)[kRows]) {
    if (vec) {
      const float4* p = reinterpret_cast<const float4*>(part) + 2 * static_cast<int64_t>(q);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      return;
    }
    const int t = q / nq;
    const float* p = part + static_cast<int64_t>(t) * kRows * nq + (q - t * nq);
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = __ldg(p + r * nq);
  };
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const int lanes = k == 1 ? 32 : k == 2 ? 16 : k <= 4 ? 8 : 4;
  const int grp = lane / lanes;
  const int c = c0 + grp;
  if (k == 1) {
    // the chunk dealt round-robin to the lanes, each adding its share in
    // list order: a lane's ids load together, kPrefetch at a time, then
    // its partials kUnroll quanta at a time
    const int lo = __ldg(chunk + c), hi = __ldg(chunk + c + 1);
    for (int first = lo + lane; first < hi; first += kPrefetch * 32) {
      int q[kPrefetch];
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j)
        q[j] = first + 32 * j < hi ? __ldg(order + first + 32 * j) : -1;
#pragma unroll
      for (int j = 0; j < kPrefetch; j += kUnroll) {
        float v[kUnroll][kRows];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q[j + u] >= 0) load(q[j + u], v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q[j + u] >= 0)
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = segpass::add_rn(acc[r], v[u][r]);
      }
    }
    // a row block no quantum reaches: the lanes' tree would add zeros
    if (lo < hi) segpass::warp_tree(acc);
  } else {
    const int sub = lane & (lanes - 1);
    if (grp < k) {
      const int i = __ldg(chunk + c) + sub;
      if (i < __ldg(chunk + c + 1)) {
        float v[kRows];
        load(__ldg(order + i), v);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = segpass::add_rn(acc[r], v[r]);
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = segpass::add_rn(acc[r], __shfl_xor_sync(0xffffffffu, acc[r], off));
  }
  if ((lane & (lanes - 1)) == 0 && grp < k) {
    const int d = __ldg(dest + c);
    float* out = d >= 0 ? y + static_cast<int64_t>(d) * kRows
                        : scratch + static_cast<int64_t>(c) * kRows;
    float4* dst = reinterpret_cast<float4*>(out);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// One thread per (hub, row): the hub's chunk sums added in chunk order.
// hub[2k], hub[2k + 1]: hub k's first chunk and its number of chunks.
__global__ void __launch_bounds__(kThreads)
hub_sums(const float* __restrict__ scratch, const int* __restrict__ dest,
         const int* __restrict__ hub, float* __restrict__ y, int n_hubs) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_hubs * kRows) return;
  const int k = e / kRows, r = e - k * kRows;
  const int first = __ldg(hub + 2 * k);
  const int n = __ldg(hub + 2 * k + 1);
  const float* s = scratch + static_cast<int64_t>(first) * kRows + r;
  float acc = __ldg(s);
#pragma unroll 8
  for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, __ldg(s + static_cast<int64_t>(i) * kRows));
  y[static_cast<int64_t>(-1 - __ldg(dest + first)) * kRows + r] = acc;
}

}  // namespace

// part (steps * rows_per_step, nq) f32; order, chunk (n_chunks + 1,), dest
// (n_chunks,), warp (n_warps + 1,) and hub (n_hubs, 2) i32 from
// segsum_kernel.dest_tables; scratch (n_chunks, 8) f32 when n_hubs > 0; y
// (n_dest, 8) f32, every row of which some chunk's dest names.
extern "C" int dest_segsum(const void* part, const void* order,
                           const void* chunk, const void* dest,
                           const void* warp, const void* hub, void* scratch,
                           void* y, int nq, int n_warps, int n_hubs,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_warps > 0) {
    const unsigned blocks = static_cast<unsigned>((n_warps + kWarps - 1) / kWarps);
    chunk_sums<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(part), static_cast<const int*>(order),
        static_cast<const int*>(chunk), static_cast<const int*>(dest),
        static_cast<const int*>(warp), static_cast<float*>(scratch),
        static_cast<float*>(y), nq, n_warps);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n_hubs > 0) {
    const unsigned blocks = static_cast<unsigned>((n_hubs * kRows + kThreads - 1) / kThreads);
    hub_sums<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(scratch), static_cast<const int*>(dest),
        static_cast<const int*>(hub), static_cast<float*>(y), n_hubs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// PELL for Hopper (sm_90a): the tile kernel, the fused kernel and the
// row-sort un-permute.
//
// Replaces, in spmv_scpa_tpu/ops/pallas_kernels.py:
//   pell_tiles     -> _tile_kernel (called at :356; PELL's span and pure
//                     schemes, and BCSR with dense tiles);
//   pell_fused     -> _fused_kernel (called at :718; PELL's default scheme);
//   pell_unpermute -> _make_unpermute's kernel (called at :1534).
//
// Function. Tile t is 8 rows of 128 slots: values vals[t * 8 + r, l] and,
// for PELL, an index idx[t * 8 + r, l] (int8 when the superpanel is one
// panel, else int16) giving the slot's column (pan[t] * pw * 128 + idx);
// a dense BCSR tile reads column pan[t] * 128 + l. The 128 slots of a row
// form nq = 128 / quantum quanta; quantum j of tile t feeds one 8-row block.
//   partial(t, r, j) = the f32 sum over the quantum's slots of
//                      vals * x[column], as a pairwise tree: adjacent
//                      slots first, then adjacent pairs, and so on;
// a column at or past n reads 0.0. pell_tiles writes the partials
// (T * 8, nq); pell_fused adds them straight into y through the
// segment-sum's passes (segsum_pass.cuh). pell_unpermute undoes the
// row sort: y[b, i] = y'[(b / 128) * 128 + bsrc[b, i], i].
//
// What bounds it on this card: bytes. Each slot is 5 or 6 bytes (f32 value
// and index), 4 for BCSR; x is read through L2. The TPU kernels keep x in
// VMEM, gather within 128 lanes with a per-strip select chain, reduce the
// quanta with a one-hot bf16 matmul and carry windows across the
// sequential grid in staggered outputs; none of that has a role here.
//
// Design. One warp per tile row: lane k loads slots 4k .. 4k + 3 as one
// float4 (512 coalesced bytes per row) and their indices as one char4 or
// short4, gathers x, multiplies, adds its four products pairwise and
// finishes each quantum with xor shuffles inside the quantum's lanes; the
// plain PyTorch version sums in the same tree, so the two agree bit for
// bit. Products and sums are rounded separately (__fmul_rn, __fadd_rn: no
// contraction into FMA). A warp takes kUnroll rows at once so that its
// loads are in flight together. The fused kernel runs one block per grid
// step of `chunk` tiles: the step's partials go to shared memory, then
// one warp per cell adds its listed quanta into a per-step tile in the
// segment-sum's fixed order (segsum_pass.cuh), and the window pass sums
// each window's steps in step order. Deterministic: no atomics anywhere.

#include <cstdint>
#include <cuda_runtime.h>

#include "segsum_pass.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRows = segpass::kRows;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;

enum Kind { kDense = 0, kIdx8 = 1, kIdx16 = 2 };

// Rows row0 .. row0 + kUnroll - 1 (those below n_rows) of the tile stream,
// one warp: calls emit(row, j, partial) for every quantum j of each row.
template <int K, class Emit>
__device__ __forceinline__ void warp_rows(
    const float* __restrict__ vals, const void* __restrict__ idx,
    const int* __restrict__ pan, const float* __restrict__ x,
    int64_t row0, int64_t n_rows, int pw, int n, int quantum, Emit emit) {
  const int lane = threadIdx.x & 31;
  float4 v[kUnroll];
  int col[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t row = row0 + u;
    if (row < n_rows) {
      v[u] = __ldg(reinterpret_cast<const float4*>(vals + row * kLanes) + lane);
      const int cb = __ldg(pan + row / kRows) * pw * kLanes;
      if (K == kDense) {
        col[u][0] = cb + 4 * lane;
        col[u][1] = cb + 4 * lane + 1;
        col[u][2] = cb + 4 * lane + 2;
        col[u][3] = cb + 4 * lane + 3;
      } else if (K == kIdx8) {
        const char4 i = __ldg(reinterpret_cast<const char4*>(idx) + row * 32 + lane);
        col[u][0] = cb + i.x;
        col[u][1] = cb + i.y;
        col[u][2] = cb + i.z;
        col[u][3] = cb + i.w;
      } else {
        const short4 i = __ldg(reinterpret_cast<const short4*>(idx) + row * 32 + lane);
        col[u][0] = cb + i.x;
        col[u][1] = cb + i.y;
        col[u][2] = cb + i.z;
        col[u][3] = cb + i.w;
      }
    } else {
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      col[u][0] = col[u][1] = col[u][2] = col[u][3] = n;
    }
  }
  float xv[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      xv[u][k] = (col[u][k] >= 0 && col[u][k] < n) ? __ldg(x + col[u][k]) : 0.0f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t row = row0 + u;
    if (row >= n_rows) break;          // uniform across the warp
    const float p0 = __fmul_rn(v[u].x, xv[u][0]);
    const float p1 = __fmul_rn(v[u].y, xv[u][1]);
    const float p2 = __fmul_rn(v[u].z, xv[u][2]);
    const float p3 = __fmul_rn(v[u].w, xv[u][3]);
    if (quantum == 1) {
      emit(row, 4 * lane, p0);
      emit(row, 4 * lane + 1, p1);
      emit(row, 4 * lane + 2, p2);
      emit(row, 4 * lane + 3, p3);
    } else if (quantum == 2) {
      emit(row, 2 * lane, __fadd_rn(p0, p1));
      emit(row, 2 * lane + 1, __fadd_rn(p2, p3));
    } else {
      float s = __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3));
      for (int off = 1; 4 * off < quantum; off <<= 1)
        s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
      if ((4 * lane) % quantum == 0) emit(row, 4 * lane / quantum, s);
    }
  }
}

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

template <int K>
__global__ void __launch_bounds__(kTileThreads)
tiles_kernel(const float* __restrict__ vals, const void* __restrict__ idx,
             const int* __restrict__ pan, const float* __restrict__ x,
             float* __restrict__ part, int64_t n_rows, int pw, int n,
             int quantum, int nq) {
  const int warp = threadIdx.x / 32;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kTileWarps + warp) * kUnroll;
  if (row0 >= n_rows) return;
  warp_rows<K>(vals, idx, pan, x, row0, n_rows, pw, n, quantum,
               [&](int64_t row, int j, float p) { part[row * nq + j] = p; });
}

constexpr int kFusedThreads = 512;
constexpr int kFusedWarps = kFusedThreads / 32;

// One block per step of `chunk` tiles. Shared memory: the step's partials,
// quantum-major (chunk * nq * 8 floats).
template <int K>
__global__ void __launch_bounds__(kFusedThreads)
fused_steps(const float* __restrict__ vals, const void* __restrict__ idx,
            const int* __restrict__ pan, const float* __restrict__ x,
            const int* __restrict__ order, const int* __restrict__ ptr,
            float* __restrict__ tiles, int chunk, int pw, int n, int quantum,
            int nq, int nrel) {
  extern __shared__ float s_part[];
  const int64_t s = blockIdx.x;
  const int64_t first_row = s * chunk * kRows;
  const int64_t end_row = first_row + static_cast<int64_t>(chunk) * kRows;
  const int warp = threadIdx.x / 32;
  for (int64_t row0 = first_row + warp * kUnroll; row0 < end_row;
       row0 += kFusedWarps * kUnroll) {
    warp_rows<K>(vals, idx, pan, x, row0, end_row, pw, n, quantum,
                 [&](int64_t row, int j, float p) {
                   const int64_t local = row - first_row;  // tile*8 + r
                   s_part[((local / kRows) * nq + j) * kRows + (local % kRows)] = p;
                 });
  }
  __syncthreads();
  const int g = chunk * nq;                       // quanta per step
  const int first_q = static_cast<int>(s) * g;
  for (int k = warp; k < nrel; k += kFusedWarps) {
    const int64_t c = s * nrel + k;
    float acc[kRows];
    segpass::warp_cell_sum(order, __ldg(ptr + c), __ldg(ptr + c + 1),
                           [&](int q, float (&v)[kRows]) {
                             const float4* p = reinterpret_cast<const float4*>(
                                 s_part + static_cast<int64_t>(q - first_q) * kRows);
                             const float4 a = p[0], b = p[1];
                             v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
                             v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
                           },
                           acc);
    if ((threadIdx.x & 31) == 0) {
      float4* dst = reinterpret_cast<float4*>(tiles + c * kRows);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

template <int K>
int launch_fused(const float* vals, const void* idx, const int* pan,
                 const float* x, const int* order, const int* ptr,
                 float* tiles, int steps, int chunk, int pw, int n,
                 int quantum, int nq, int nrel, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(chunk) * nq * kRows * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        fused_steps<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err != 0) return err;
  }
  fused_steps<K><<<steps, kFusedThreads, smem, st>>>(
      vals, idx, pan, x, order, ptr, tiles, chunk, pw, n, quantum, nq, nrel);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kPermThreads = 256;

__global__ void __launch_bounds__(kPermThreads)
unpermute(const float* __restrict__ yp, const int* __restrict__ bsrc,
          float* __restrict__ y, int64_t n_el, int sort_win) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPermThreads + threadIdx.x;
  if (e >= n_el) return;
  const int64_t b = e / kRows;
  const int i = static_cast<int>(e - b * kRows);
  const int64_t src = (b / sort_win) * sort_win + __ldg(bsrc + e);
  y[e] = __ldg(yp + src * kRows + i);
}

}  // namespace

// vals (n_rows, 128) f32; idx (n_rows, 128) int8 (kind 1), int16 (kind 2)
// or unused (kind 0); pan (n_rows / 8,) i32; x (n,) f32; part (n_rows, nq).
extern "C" int pell_tiles(const void* vals, const void* idx, const void* pan,
                          const void* x, void* part, int64_t n_rows, int kind,
                          int pw, int n, int quantum, int nq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  const int64_t rows_per_block = static_cast<int64_t>(kTileWarps) * kUnroll;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block);
  const float* v = static_cast<const float*>(vals);
  const int* p = static_cast<const int*>(pan);
  const float* xx = static_cast<const float*>(x);
  float* out = static_cast<float*>(part);
  if (kind == kDense)
    tiles_kernel<kDense><<<blocks, kTileThreads, 0, st>>>(v, idx, p, xx, out, n_rows, pw, n, quantum, nq);
  else if (kind == kIdx8)
    tiles_kernel<kIdx8><<<blocks, kTileThreads, 0, st>>>(v, idx, p, xx, out, n_rows, pw, n, quantum, nq);
  else
    tiles_kernel<kIdx16><<<blocks, kTileThreads, 0, st>>>(v, idx, p, xx, out, n_rows, pw, n, quantum, nq);
  return static_cast<int>(cudaGetLastError());
}

// As pell_tiles over steps * chunk tiles, then into y (num_windows * h, 8)
// through order/ptr and base (steps,) (segsum_pass.cuh); tiles is
// (steps * W * h * 8,) f32 scratch.
extern "C" int pell_fused(const void* vals, const void* idx, const void* pan,
                          const void* x, const void* order, const void* ptr,
                          const void* base, void* tiles, void* y, int steps,
                          int chunk, int kind, int pw, int n, int quantum,
                          int nq, int h, int W, int num_windows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrel = W * h;
  if (steps > 0) {
    const float* v = static_cast<const float*>(vals);
    const int* p = static_cast<const int*>(pan);
    const float* xx = static_cast<const float*>(x);
    const int* o = static_cast<const int*>(order);
    const int* pt = static_cast<const int*>(ptr);
    float* tl = static_cast<float*>(tiles);
    int err;
    if (kind == kDense)
      err = launch_fused<kDense>(v, idx, p, xx, o, pt, tl, steps, chunk, pw, n, quantum, nq, nrel, st);
    else if (kind == kIdx8)
      err = launch_fused<kIdx8>(v, idx, p, xx, o, pt, tl, steps, chunk, pw, n, quantum, nq, nrel, st);
    else
      err = launch_fused<kIdx16>(v, idx, p, xx, o, pt, tl, steps, chunk, pw, n, quantum, nq, nrel, st);
    if (err != 0) return err;
  }
  return segpass::launch_window_pass(static_cast<const float*>(tiles),
                                     static_cast<const int*>(base),
                                     static_cast<float*>(y), steps, h, W,
                                     num_windows, st);
}

// yp and y (n_el / 8, 8) f32; bsrc (n_el / 8, 8) i32, window-local blocks.
extern "C" int pell_unpermute(const void* yp, const void* bsrc, void* y,
                              int64_t n_el, int sort_win, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_el > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_el + kPermThreads - 1) / kPermThreads);
    unpermute<<<blocks, kPermThreads, 0, st>>>(
        static_cast<const float*>(yp), static_cast<const int*>(bsrc),
        static_cast<float*>(y), n_el, sort_win);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

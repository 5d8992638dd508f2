// BCSR over bitmap tiles for Hopper (sm_90a): the SpMV `bcsr_bits` and the
// SpMM `bcsr_bits_spmm`, over one layout
// (spmv_scpa_tpu_torch/ops/bcsr_bits.py).
//
// Replaces:
//   bcsr_bits       spmv_scpa_tpu/ops/pallas_kernels.py, `_tile_kernel` (:64,
//                   called at :356 through `prepare_bcsr`, :1805) on dense
//                   tiles, with the window segment-sum after it;
//   bcsr_bits_spmm  spmv_scpa_tpu/ops/pallas_kernels.py, `_spmm_kernel`
//                   (:1076, called at :1201 by `make_bcsr_spmm`).
//
// Layout. Tile t covers rows 8b .. 8b + 7 (b its block row) and columns
// pan[t] * 128 .. + 127; the tiles of block row b are t in [rowptr[b],
// rowptr[b + 1]), in column order. bits[t][r] is row r's 128-bit occupancy
// mask as 4 words (word w: lanes 32w .. 32w + 31, bit lane % 32); the stored
// slots' values are vals[vptr[t] ..], in (row, lane) order within the tile.
// A column at or past n reads x (or a row of X) as 0.
//
// Function and order of the sums (each product and sum rounded separately,
// __fmul_rn / __fadd_rn, no atomics; the plain PyTorch versions add in the
// same order, so they equal the kernels bit for bit):
//   bcsr_bits: lane l of a block row's warp owns lanes l, 32 + l, 64 + l and
//     96 + l (bit l of each mask word) of each row and keeps one sum per row
//     across all the block row's tiles, adding its stored slots' products
//     tile by tile, word by word; the 32 lanes' sums of a row are then added
//     as a halving tree (l with l + 16, then l + 8, 4, 2, 1), as a
//     reduce-scatter: 9 shuffles for the 8 rows.
//   bcsr_bits_spmm: Y[i, c] adds the products of row i's stored slots in
//     (tile, lane) order, that is in column order, one after another.
// An absent slot adds nothing: y differs from the dense tiles' y only in
// the order of the sums, and where x holds inf or NaN at an absent slot's
// column (a dense tile multiplies it by 0).
//
// What bounds them on this card: bytes. A dense tile is 4 KB; at the
// flagship's fill of 0.16 a bitmap tile is about 0.8 KB (128 B of masks,
// 4 B a stored value, 8 B of pan and vptr), 5.2x fewer bytes than the dense
// tiles (whose own bound sat above cuSPARSE's time). The SpMV's bound is
// these bytes, the distinct x elements and y; the SpMM's adds the distinct
// rows of X and Y, and its 2 * stored * cols flops stay below the bytes'
// time at 64 columns. The TPU kernels carried sums across a sequential grid
// (partials in device memory, window padding, a one-hot reduction); here a
// warp owns its block row's outputs and walks its tiles, so one launch
// writes y, x is read in place, and nothing crosses blocks.
//
// Design, SpMV. A warp walks 4 block rows (kBpw), whose tiles and values
// are contiguous, in stages of up to 4 tiles whose values fit 1024 floats.
// A stage's mask words and values are copied into shared memory by cp.async,
// two stages deep: the next stage's copies are in flight while this one is
// summed, so the warp waits on device memory about once per stage, not
// twice per tile (mask, then values). Lane l owns lanes l, 32 + l, 64 + l
// and 96 + l of each row. For each word q that some row of a tile uses (a
// branch the whole warp takes alike; a stencil's tile uses one to three of
// four) it loads x at its column once, only where a row stores a slot
// there, and reuses it across the 8 rows; it finds its value in row r by a
// popcount of the word below its bit and reads it from shared memory
// unconditionally, taking the product by a select (no divergent branch).
// So a warp's x load is one 128-byte run, and a lane takes 8 slot steps
// for each word a tile uses. Measured against this on the card: lane l
// owning the 4 adjacent lanes 4l .. 4l + 3 (32 slot steps a tile whatever
// the fill), one warp a block row with the masks and values read straight
// from device memory (two dependent waits a tile), and branches around the
// value reads were each slower.
//
// Design, SpMM. Each lane owns CPL columns of X and Y (2, or 1 when
// cols = 1); a group of G lanes (a power of two, at most 32) covers G * CPL
// columns of one block row, G the least that covers cols (32 past 64
// columns, which then take several column groups); a warp serves 32 / G
// block rows at one column group. So at 64 columns a warp serves one block
// row and a lane 2 columns; at 8 columns a warp serves 8 block rows, 4 lanes
// each. Per tile the group ORs the 8 rows' masks; for each set lane k of the
// OR, in ascending order, it loads X's row pan * 128 + k once (one 256-byte
// run at 64 columns) and adds v * x into the sum of each row r that stores
// lane k, v read at row r's cursor (the same address across the group). So
// X is read once per distinct (tile, column) pair, not once per slot, and
// the MACs are the stored slots' alone. f32 on the CUDA cores: a tensor-core
// MMA on f32 inputs would run in TF32.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kWords = 4;
constexpr int kWarps = 4;                 // warps a SpMV block
constexpr int kSpmmWarps = 8;             // warps a SpMM block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBpw = 4;                   // block rows a SpMV warp walks
constexpr int kChunk = 4;                 // tiles a SpMV stage holds
constexpr int kVbuf = 1024;               // values a stage holds (a tile's
                                          // most)

// The 32 mask words of tile t: w[r][q] is row r's word q.
__device__ __forceinline__ void load_bits(const uint4* __restrict__ bits,
                                          int64_t t,
                                          uint32_t (&w)[kRows][kWords]) {
  const uint4* p = bits + t * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint4 q = __ldg(p + r);
    w[r][0] = q.x;
    w[r][1] = q.y;
    w[r][2] = q.z;
    w[r][3] = q.w;
  }
}

__device__ __forceinline__ int row_popc(const uint32_t (&w)[kWords]) {
  return __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
}

// The 8 rows' sums of block row b, held as a sum per (row, lane): the
// halving tree over the lanes as a reduce-scatter (at each of the first three
// steps a lane keeps half its rows and adds its partner's), then one lane of
// each four writes its row.
__device__ __forceinline__ void write_rows(const float (&acc)[kRows],
                                           int lane, float* __restrict__ y,
                                           int64_t b, int m) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float s4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h4 ? acc[i] : acc[i + 4];
    const float keep = h4 ? acc[i + 4] : acc[i];
    s4[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 16));
  }
  float s2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h3 ? s4[i] : s4[i + 2];
    const float keep = h3 ? s4[i + 2] : s4[i];
    s2[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 8));
  }
  float s = __fadd_rn(h2 ? s2[1] : s2[0],
                      __shfl_xor_sync(kFull, h2 ? s2[0] : s2[1], 4));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
  const int64_t i = b * kRows + ((lane >> 2) & 7);
  if ((lane & 3) == 0 && i < m) y[i] = s;
}

// One stage of a SpMV warp's walk: up to kChunk consecutive tiles whose
// values fit kVbuf (a tile alone always does).
struct Chunk {
  int tc, nt, vp0, cnt;
};

__global__ void __launch_bounds__(kWarps * 32)
bcsr_bits_kernel(const uint32_t* __restrict__ bits,
                 const float* __restrict__ vals,
                 const int* __restrict__ vptr, const int* __restrict__ pan,
                 const int* __restrict__ rowptr, const float* __restrict__ x,
                 float* __restrict__ y, int mb, int m, int n) {
  __shared__ __align__(16) uint32_t s_bits[kWarps][2][kChunk * 32];
  // one float past kVbuf (padded to 16 bytes): a lane whose bit is clear
  // may read index cnt
  __shared__ __align__(16) float s_vals[kWarps][2][kVbuf + 4];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kWarps + wid)
                     * kBpw;
  if (b0 >= mb) return;                   // the whole warp
  const int nb = static_cast<int>(min(static_cast<int64_t>(kBpw), mb - b0));
  const uint32_t mine = 1u << lane;       // the lane's bit in a mask word
  const uint32_t below = mine - 1u;
  // Lane l holds rowptr[b0 + l], and vptr and pan of the meta window's
  // tile mw + l: the walk reads them by shuffles.
  const int rp = lane <= nb ? __ldg(rowptr + b0 + lane) : 0;
  const int t1 = __shfl_sync(kFull, rp, nb);
  int cb = 0;                             // the block row being summed
  int te = __shfl_sync(kFull, rp, 1);     // its end
  int mw = __shfl_sync(kFull, rp, 0) - 32;
  int mvp = 0, mpan = 0;
  // The next chunk from tile tc, reloading the window when it runs out.
  auto plan = [&](int tc) {
    if (tc - mw + kChunk > 31) {
      mw = tc;
      mvp = mw + lane <= t1 ? __ldg(vptr + mw + lane) : 0;
      mpan = mw + lane < t1 ? __ldg(pan + mw + lane) : 0;
    }
    const int rel = tc - mw;
    const int vp0 = __shfl_sync(kFull, mvp, rel);
    const int li = lane - rel;
    const int nt = __popc(__ballot_sync(
        kFull, li >= 1 && li <= kChunk && tc + li <= t1
               && mvp - vp0 <= kVbuf));
    return Chunk{tc, nt, vp0, __shfl_sync(kFull, mvp, rel + nt) - vp0};
  };
  // Copy a chunk's mask words and values into stage buffer `st` (cp.async:
  // no registers held, nothing waits until the stage is needed).
  auto issue = [&](const Chunk& c, int st) {
    const int i = lane >> 3, r = lane & 7;
    if (i < c.nt)
      __pipeline_memcpy_async(
          &s_bits[wid][st][(i * kRows + r) * kWords],
          bits + (static_cast<int64_t>(c.tc + i) * kRows + r) * kWords, 16);
#pragma unroll
    for (int j = 0; j < kVbuf / 32; ++j)
      if (32 * j + lane < c.cnt)
        __pipeline_memcpy_async(&s_vals[wid][st][32 * j + lane],
                                vals + c.vp0 + 32 * j + lane, 4);
    __pipeline_commit();
  };
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  Chunk cur = plan(__shfl_sync(kFull, rp, 0));
  if (cur.tc < t1) issue(cur, 0);
  for (int st = 0; cur.tc < t1; st ^= 1) {
    // This chunk's tiles' pan and first value (lane i holds tile i's),
    // taken before the window moves.
    const int cpan = __shfl_sync(kFull, mpan, cur.tc - mw + lane % kChunk);
    const int cvs = __shfl_sync(kFull, mvp, cur.tc - mw + lane % kChunk)
                    - cur.vp0;
    const Chunk next = plan(cur.tc + cur.nt);
    if (next.tc < t1) issue(next, st ^ 1);
    else __pipeline_commit();             // an empty group keeps the count
    __pipeline_wait_prior(1);             // this chunk's copies have landed
    __syncwarp();
    const uint4* sb = reinterpret_cast<const uint4*>(s_bits[wid][st]);
    const float* sv = s_vals[wid][st];
    for (int i = 0; i < cur.nt; ++i) {
      const int t = cur.tc + i;
      while (t >= te) {                   // block rows that end before t
        write_rows(acc, lane, y, b0 + cb, m);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        ++cb;
        te = __shfl_sync(kFull, rp, cb + 1);
      }
      uint32_t w[kRows][kWords];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint4 q4 = sb[i * kRows + r];
        w[r][0] = q4.x;
        w[r][1] = q4.y;
        w[r][2] = q4.z;
        w[r][3] = q4.w;
      }
      // x at the lane's column of each word some row uses, all 4 loads
      // issued before the first sum waits on one
      const int64_t col0 =
          static_cast<int64_t>(__shfl_sync(kFull, cpan, i)) * kLanes + lane;
      uint32_t any[kWords];
      float xv[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        any[q] = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) any[q] |= w[r][q];
        const int64_t c = col0 + 32 * q;
        xv[q] = (any[q] & mine) && c < n ? __ldg(x + c) : 0.0f;
      }
      int start[kRows];                   // row r's next value in sv
      int run = __shfl_sync(kFull, cvs, i);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        start[r] = run;
        run += row_popc(w[r]);
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        if (any[q]) {                     // the same branch across the warp
          // no branch: every lane reads (a lane whose bit is clear reads
          // a value it drops), and the sum takes the product by a select
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float v =
                sv[start[r] + __popc(w[r][q] & below)];
            acc[r] = w[r][q] & mine ? __fadd_rn(acc[r], __fmul_rn(v, xv[q]))
                                    : acc[r];
            start[r] += __popc(w[r][q]);
          }
        }
      }
    }
    __syncwarp();                         // before this stage is refilled
    cur = next;
  }
  while (cb < nb) {                       // the rest, empty ones as 0
    write_rows(acc, lane, y, b0 + cb, m);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    ++cb;
  }
}

// X's row xr at the lane's CPL columns, 0.0 past n or cols.
template <int CPL>
__device__ __forceinline__ void load_x(const float* __restrict__ X,
                                       int64_t xr, int n, int cols, int c0,
                                       float (&xv)[CPL]) {
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    xv[c] = xr < n && c0 + c < cols ? __ldg(X + xr * cols + c0 + c) : 0.0f;
}

template <int G, int CPL>
__global__ void __launch_bounds__(kSpmmWarps * 32)
bcsr_bits_spmm_kernel(const uint4* __restrict__ bits,
                      const float* __restrict__ vals,
                      const int* __restrict__ vptr,
                      const int* __restrict__ pan,
                      const int* __restrict__ rowptr,
                      const float* __restrict__ X, float* __restrict__ Y,
                      int mb, int m, int n, int cols, int ncg) {
  constexpr int kPerWarp = 32 / G;        // block rows a warp serves
  const int lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kSpmmWarps
                     + (threadIdx.x >> 5);
  const int cg = static_cast<int>(gw % ncg);
  const int64_t b = gw / ncg * kPerWarp + lane / G;
  if (b >= mb) return;                    // no warp-wide step follows
  const int c0 = cg * G * CPL + (lane % G) * CPL;
  float acc[kRows][CPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.0f;
  const int t0 = __ldg(rowptr + b), t1 = __ldg(rowptr + b + 1);
  for (int t = t0; t < t1; ++t) {
    uint32_t w[kRows][kWords];
    load_bits(bits, t, w);
    int pos[kRows];                       // each row's next value
    int run = __ldg(vptr + t);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pos[r] = run;
      run += row_popc(w[r]);
    }
    const int64_t xrow0 = static_cast<int64_t>(__ldg(pan + t)) * kLanes;
#pragma unroll
    for (int qw = 0; qw < kWords; ++qw) {
      uint32_t u = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) u |= w[r][qw];
      while (u) {
        const int kb = __ffs(u) - 1;
        u &= u - 1u;
        float xv[CPL];
        load_x<CPL>(X, xrow0 + 32 * qw + kb, n, cols, c0, xv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if ((w[r][qw] >> kb) & 1u) {
            const float v = __ldg(vals + pos[r]);
            ++pos[r];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(v, xv[c]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = b * kRows + r;
    if (i >= m) break;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (c0 + c < cols) Y[i * cols + c0 + c] = acc[r][c];
  }
}

template <int G, int CPL>
void launch_spmm(const void* bits, const void* vals, const void* vptr,
                 const void* pan, const void* rowptr, const void* X, void* Y,
                 int mb, int m, int n, int cols, cudaStream_t stream) {
  const int ncg = (cols + G * CPL - 1) / (G * CPL);
  const int64_t warps = (static_cast<int64_t>(mb) + 32 / G - 1) / (32 / G)
                        * ncg;
  const int64_t blocks = (warps + kSpmmWarps - 1) / kSpmmWarps;
  bcsr_bits_spmm_kernel<G, CPL><<<static_cast<unsigned>(blocks),
                                  kSpmmWarps * 32, 0, stream>>>(
      static_cast<const uint4*>(bits), static_cast<const float*>(vals),
      static_cast<const int*>(vptr), static_cast<const int*>(pan),
      static_cast<const int*>(rowptr), static_cast<const float*>(X),
      static_cast<float*>(Y), mb, m, n, cols, ncg);
}

}  // namespace

// bits (T, 8, 4) i32, 16-byte aligned; vals (S,) f32; vptr (T + 1,) i32;
// pan (T,) i32; rowptr (ceil(m / 8) + 1,) i32; x (n,) f32; y (m,) f32.
extern "C" int bcsr_bits(const void* bits, const void* vals, const void* vptr,
                         const void* pan, const void* rowptr, const void* x,
                         void* y, int m, int n, void* stream) {
  const int mb = (m + kRows - 1) / kRows;
  if (mb > 0) {
    const int warps = (mb + kBpw - 1) / kBpw;
    bcsr_bits_kernel<<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<const float*>(vals),
        static_cast<const int*>(vptr), static_cast<const int*>(pan),
        static_cast<const int*>(rowptr), static_cast<const float*>(x),
        static_cast<float*>(y), mb, m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same arrays; X (n, cols) f32 row-major; Y (m, cols) f32.
extern "C" int bcsr_bits_spmm(const void* bits, const void* vals,
                              const void* vptr, const void* pan,
                              const void* rowptr, const void* X, void* Y,
                              int m, int n, int cols, void* stream) {
  const int mb = (m + kRows - 1) / kRows;
  if (mb > 0 && cols > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cpl = cols == 1 ? 1 : 2;
    int g = 1;
    while (g < 32 && g * cpl < cols) g *= 2;
    const auto launch = cpl == 1 ? launch_spmm<1, 1>
                        : g == 1   ? launch_spmm<1, 2>
                        : g == 2   ? launch_spmm<2, 2>
                        : g == 4   ? launch_spmm<4, 2>
                        : g == 8   ? launch_spmm<8, 2>
                        : g == 16  ? launch_spmm<16, 2>
                                   : launch_spmm<32, 2>;
    launch(bits, vals, vptr, pan, rowptr, X, Y, mb, m, n, cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

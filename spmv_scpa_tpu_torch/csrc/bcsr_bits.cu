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
// Design, the walk (both kernels). A warp walks kBpw block rows, whose
// tiles and values are contiguous, in stages of up to 4 tiles whose values
// fit 1024 floats. A stage's mask words and values are copied into shared
// memory by cp.async (the values 16 bytes a copy), two stages deep: the next
// stage's copies are in flight while this one is summed, so the warp waits
// on device memory about once per stage, not twice per tile (mask, then
// values).
//
// Design, SpMV. Lane l owns lanes l, 32 + l, 64 + l and 96 + l of each row.
// For each word q that some row of a tile uses (a branch the whole warp
// takes alike; a stencil's tile uses one to three of four) it loads x at its
// column once, only where a row stores a slot there, and reuses it across
// the 8 rows; it finds its value in row r by a popcount of the word below
// its bit and reads it from shared memory unconditionally, taking the
// product by a select (no divergent branch). So a warp's x load is one
// 128-byte run, and a lane takes 8 slot steps for each word a tile uses.
// Measured against this on the card: lane l owning the 4 adjacent lanes
// 4l .. 4l + 3 (32 slot steps a tile whatever the fill), one warp a block
// row with the masks and values read straight from device memory (two
// dependent waits a tile), and branches around the value reads were each
// slower.
//
// Design, SpMM to 32 columns ("warp_rows"). A warp's 32 lanes all serve one
// block row at a time: lane l owns row l / 4 and CPL columns, (l % 4) * CPL
// .. + CPL - 1 (CPL 1, 2, 4 or 8, the least that covers cols with 4 lanes).
// Per tile the warp first decodes the stage's masks as the SpMV reads them
// (lane l takes bit l of each word some row uses, no branch) into one byte
// per stored slot, its lane, at the slot's place in the stage. Then each
// lane walks its row's slots in order, kSteps a pass: the pass's lanes and
// values come from shared memory, its X rows as one float2 or float4 a lane
// (scalars where cols or the pointers do not allow vectors), all loaded
// before the first multiply-add waits on one. The only divergence left is
// between the 8 rows' counts in a tile, which in a band differ by little.
// Y's row is written once, when the walk leaves its block row.
//
// Design, SpMM past 32 columns ("lane_groups"). A warp serves one block row
// and a lane 2 columns of a 64-column group (several groups past 64). Per
// tile the warp ORs the 8 rows' masks (read from device memory); for each
// set lane k of the OR, in ascending order, it loads X's row pan * 128 + k
// once (one 256-byte run) and adds v * x into the sum of each row r that
// stores lane k, v read from device memory at row r's cursor. So X is read
// once per distinct (tile, column) pair and the MACs are the stored slots'
// alone; at 64 columns an ablation found no single part dominant.
//
// The cut, and what warp_rows replaced. Below 64 columns lane_groups used to
// take groups of G < 32 lanes (the least power of two that covers cols at 2
// columns a lane, 1 at one column), so that at 8 columns a warp served 8
// unrelated block rows with 4 lanes each and ran the union of their 8
// control flows, and its divergent scalar value loads were 39% of its time.
// Those mappings are gone; their times, device ms on the flagship stand-in
// (22,588,601 entries; H100 80GB HBM3, 700 W; bench/bits_study.py while it
// still built them, warp_rows / the old lane groups): 1 column
// 0.1249 / 0.2055, 2: 0.1272 / 0.2330, 4: 0.1314 / 0.2166, 8: 0.1425 /
// 0.3098, 16: 0.1669 / 0.4040, 32: 0.2920 / 0.5341; at 48, warp_rows in two
// column groups of 32 took 1.2289 against lane_groups' 0.7247 (its scalar
// loads and the walk done twice), hence the cut at 32. Before the decode,
// lanes that found their slots by walking their own row's mask bits (each
// of a row's 4 lanes repeating the walk) took 0.2899 at 8 columns.
// Both designs: f32 on the CUDA cores, each Y[i, c] summed by one thread in
// (tile, lane) order (a tensor-core MMA on f32 inputs would run in TF32).

#include <cstdint>
#include <type_traits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kWords = 4;
constexpr int kWarps = 4;                 // warps a block (SpMV, warp_rows)
constexpr int kSpmmWarps = 8;             // warps a lane_groups block
constexpr int kGroupCpl = 2;              // columns a lane_groups lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBpw = 4;                   // block rows a warp walks
constexpr int kChunk = 4;                 // tiles a stage holds
constexpr int kVbuf = 1024;               // values a stage holds (a tile's
                                          // most)
constexpr int kVpad = 16;                 // stage entries past kVbuf: the
                                          // copies start up to 3 early, and
                                          // reads run past a row's end
constexpr int kSteps = 8;                 // slots a warp_rows lane takes a
                                          // pass
constexpr int kRowsCols = 32;             // the most columns of warp_rows:
                                          // 4 lanes a row, 8 columns a lane

// The designs of the SpMM, as bcsr_bits_spmm_design names them.
enum SpmmDesign { kLaneGroups = 0, kWarpRows = 1 };

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

// One stage of a warp's walk: up to kChunk consecutive tiles whose values
// fit kVbuf (a tile alone always does).
struct Chunk {
  int tc, nt, vp0, cnt;
};

// The first value a chunk's stage copies: vp0 moved down to a 16-byte
// boundary of vals (entry e of the stage holds value stage_first + e).
__device__ __forceinline__ int stage_first(const float* vals, int vp0) {
  return vp0 - static_cast<int>(
      (reinterpret_cast<uintptr_t>(vals + vp0) >> 2) & 3);
}

// 16 bytes into shared memory by cp.async (L2 only): the first `bytes` from
// src, 16-byte aligned, the rest zeros.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// A warp's walk (Design, the walk) over the tiles of block rows b0 .. b0 +
// nb - 1 (nb at most 31), staged in s_bits / s_vals. For each tile in
// order, tile(masks, sv, vs, pan) sums it: masks[r] is row r's 4 mask
// words, sv[vs ..] its values, both in shared memory, pan its column panel.
// done(cb) ends block row cb, each in order, empty ones too. The whole warp
// calls it, and tile and done with it.
template <class Tile, class Done>
__device__ __forceinline__ void walk_tiles(
    const uint32_t* __restrict__ bits, const float* __restrict__ vals,
    const int* __restrict__ vptr, const int* __restrict__ pan,
    const int* __restrict__ rowptr, int64_t b0, int nb,
    uint32_t (&s_bits)[2][kChunk * 32], float (&s_vals)[2][kVbuf + kVpad],
    Tile&& tile, Done&& done) {
  const int lane = threadIdx.x & 31;
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
  // no registers held, nothing waits until the stage is needed). The values
  // go 16 bytes a copy from stage_first, the last copy zero-filled past the
  // chunk; a copy that would start before vals[0] (vals not 16-byte
  // aligned) goes a value at a time.
  auto issue = [&](const Chunk& c, int st) {
    const int i = lane >> 3, r = lane & 7;
    if (i < c.nt)
      __pipeline_memcpy_async(
          &s_bits[st][(i * kRows + r) * kWords],
          bits + (static_cast<int64_t>(c.tc + i) * kRows + r) * kWords, 16);
    const int a = stage_first(vals, c.vp0), e = c.vp0 + c.cnt;
    for (int j = a + 4 * lane; j < e; j += 128) {
      if (j >= 0) {
        copy16(&s_vals[st][j - a], vals + j, 4 * min(4, e - j));
      } else {
        for (int k = -j; k < 4 && j + k < e; ++k)
          __pipeline_memcpy_async(&s_vals[st][j - a + k], vals + j + k, 4);
      }
    }
    __pipeline_commit();
  };
  Chunk cur = plan(__shfl_sync(kFull, rp, 0));
  if (cur.tc < t1) issue(cur, 0);
  for (int st = 0; cur.tc < t1; st ^= 1) {
    // This chunk's tiles' pan and first value (lane i holds tile i's),
    // taken before the window moves.
    const int cpan = __shfl_sync(kFull, mpan, cur.tc - mw + lane % kChunk);
    const int cvs = __shfl_sync(kFull, mvp, cur.tc - mw + lane % kChunk)
                    - stage_first(vals, cur.vp0);
    const Chunk next = plan(cur.tc + cur.nt);
    if (next.tc < t1) issue(next, st ^ 1);
    else __pipeline_commit();             // an empty group keeps the count
    __pipeline_wait_prior(1);             // this chunk's copies have landed
    __syncwarp();
    const uint4* sb = reinterpret_cast<const uint4*>(s_bits[st]);
    for (int i = 0; i < cur.nt; ++i) {
      const int t = cur.tc + i;
      while (t >= te) {                   // block rows that end before t
        done(cb);
        ++cb;
        te = __shfl_sync(kFull, rp, cb + 1);
      }
      tile(sb + i * kRows, s_vals[st], __shfl_sync(kFull, cvs, i),
           __shfl_sync(kFull, cpan, i));
    }
    __syncwarp();                         // before this stage is refilled
    cur = next;
  }
  for (; cb < nb; ++cb) done(cb);         // the rest, empty ones as 0
}

__global__ void __launch_bounds__(kWarps * 32)
bcsr_bits_kernel(const uint32_t* __restrict__ bits,
                 const float* __restrict__ vals,
                 const int* __restrict__ vptr, const int* __restrict__ pan,
                 const int* __restrict__ rowptr, const float* __restrict__ x,
                 float* __restrict__ y, int mb, int m, int n) {
  __shared__ __align__(16) uint32_t s_bits[kWarps][2][kChunk * 32];
  // a lane whose bit is clear may read one entry past its tile's values
  __shared__ __align__(16) float s_vals[kWarps][2][kVbuf + kVpad];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kWarps + wid)
                     * kBpw;
  if (b0 >= mb) return;                   // the whole warp
  const int nb = static_cast<int>(min(static_cast<int64_t>(kBpw), mb - b0));
  const uint32_t mine = 1u << lane;       // the lane's bit in a mask word
  const uint32_t below = mine - 1u;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  auto tile = [&](const uint4* sb, const float* sv, int vs, int p) {
    uint32_t w[kRows][kWords];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint4 q4 = sb[r];
      w[r][0] = q4.x;
      w[r][1] = q4.y;
      w[r][2] = q4.z;
      w[r][3] = q4.w;
    }
    // x at the lane's column of each word some row uses, all 4 loads
    // issued before the first sum waits on one
    const int64_t col0 = static_cast<int64_t>(p) * kLanes + lane;
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
    int start[kRows];                     // row r's next value in sv
    int run = vs;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      start[r] = run;
      run += row_popc(w[r]);
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      if (any[q]) {                       // the same branch across the warp
        // no branch: every lane reads (a lane whose bit is clear reads a
        // value it drops), and the sum takes the product by a select
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
  };
  auto done = [&](int cb) {
    write_rows(acc, lane, y, b0 + cb, m);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  };
  walk_tiles(bits, vals, vptr, pan, rowptr, b0, nb, s_bits[wid], s_vals[wid],
             tile, done);
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

// The lane_groups design (Design, SpMM past 32 columns): warp gw serves
// block row gw / ncg and column group gw % ncg.
__global__ void __launch_bounds__(kSpmmWarps * 32)
bcsr_bits_spmm_kernel(const uint4* __restrict__ bits,
                      const float* __restrict__ vals,
                      const int* __restrict__ vptr,
                      const int* __restrict__ pan,
                      const int* __restrict__ rowptr,
                      const float* __restrict__ X, float* __restrict__ Y,
                      int mb, int m, int n, int cols, int ncg) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kSpmmWarps
                     + (threadIdx.x >> 5);
  const int64_t b = gw / ncg;
  if (b >= mb) return;                    // no warp-wide step follows
  const int c0 = static_cast<int>(gw % ncg) * 32 * kGroupCpl
                 + lane * kGroupCpl;
  float acc[kRows][kGroupCpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kGroupCpl; ++c) acc[r][c] = 0.0f;
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
        float xv[kGroupCpl];
        load_x<kGroupCpl>(X, xrow0 + 32 * qw + kb, n, cols, c0, xv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if ((w[r][qw] >> kb) & 1u) {
            const float v = __ldg(vals + pos[r]);
            ++pos[r];
#pragma unroll
            for (int c = 0; c < kGroupCpl; ++c)
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
    for (int c = 0; c < kGroupCpl; ++c)
      if (c0 + c < cols) Y[i * cols + c0 + c] = acc[r][c];
  }
}

void launch_spmm(const void* bits, const void* vals, const void* vptr,
                 const void* pan, const void* rowptr, const void* X, void* Y,
                 int mb, int m, int n, int cols, cudaStream_t stream) {
  const int ncg = (cols + 32 * kGroupCpl - 1) / (32 * kGroupCpl);
  const int64_t warps = static_cast<int64_t>(mb) * ncg;
  const int64_t blocks = (warps + kSpmmWarps - 1) / kSpmmWarps;
  bcsr_bits_spmm_kernel<<<static_cast<unsigned>(blocks), kSpmmWarps * 32, 0,
                          stream>>>(
      static_cast<const uint4*>(bits), static_cast<const float*>(vals),
      static_cast<const int*>(vptr), static_cast<const int*>(pan),
      static_cast<const int*>(rowptr), static_cast<const float*>(X),
      static_cast<float*>(Y), mb, m, n, cols, ncg);
}

// Row k of xt (a tile's X rows at the lane's CPL columns, as bytes; stride
// a row's bytes), 0.0 where !ok or past cols; a predicated load, no branch.
// VEC: every lane's CPL columns lie within cols, and X's rows are aligned
// for vectors of min(CPL, 4) floats.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_xrow(const char* __restrict__ xt,
                                          uint32_t stride, int k, bool ok,
                                          int cols, int c0,
                                          float (&xv)[CPL]) {
  const float* p = reinterpret_cast<const float*>(
      xt + static_cast<uint32_t>(k) * stride);  // k < 256: no overflow
  if constexpr (VEC && CPL % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CPL; c += 4) {
      const float4 q = ok ? __ldg(reinterpret_cast<const float4*>(p + c))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xv[c] = q.x;
      xv[c + 1] = q.y;
      xv[c + 2] = q.z;
      xv[c + 3] = q.w;
    }
  } else if constexpr (VEC && CPL == 2) {
    const float2 q = ok ? __ldg(reinterpret_cast<const float2*>(p))
                        : make_float2(0.0f, 0.0f);
    xv[0] = q.x;
    xv[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      xv[c] = ok && (VEC || c0 + c < cols) ? __ldg(p + c) : 0.0f;
  }
}

// Y's row i at the lane's CPL columns c0 .. (within cols); VEC as load_xrow.
template <int CPL, bool VEC>
__device__ __forceinline__ void store_yrow(float* __restrict__ Y, int64_t i,
                                           int cols, int c0,
                                           const float (&acc)[CPL]) {
  float* p = Y + i * cols + c0;
  if constexpr (VEC && CPL % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CPL; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else if constexpr (VEC && CPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (VEC || c0 + c < cols) p[c] = acc[c];
  }
}

// The warp_rows design (Design, SpMM to 32 columns): each warp walks kBpw
// consecutive block rows.
template <int CPL, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
bcsr_bits_spmm_rows_kernel(const uint32_t* __restrict__ bits,
                           const float* __restrict__ vals,
                           const int* __restrict__ vptr,
                           const int* __restrict__ pan,
                           const int* __restrict__ rowptr,
                           const float* __restrict__ X,
                           float* __restrict__ Y, int mb, int m, int n,
                           int cols) {
  __shared__ __align__(16) uint32_t s_bits[kWarps][2][kChunk * 32];
  // the last pass of a row may read kSteps - 1 entries past its last slot,
  // and drops what it read there
  __shared__ __align__(16) float s_vals[kWarps][2][kVbuf + kVpad];
  __shared__ __align__(16) uint8_t s_col[kWarps][kVbuf + kVpad];  // lanes
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kWarps + wid)
                     * kBpw;
  if (b0 >= mb) return;                   // the whole warp
  const int nb = static_cast<int>(min(static_cast<int64_t>(kBpw), mb - b0));
  const uint32_t mine = 1u << lane;       // the lane's bit in a mask word
  const uint32_t below = mine - 1u;
  const int r = lane >> 2;                // the lane's row of a block row
  const int c0 = (lane & 3) * CPL;        // and its first column
  const char* xl = reinterpret_cast<const char*>(X + c0);
  const uint32_t stride = static_cast<uint32_t>(cols) * sizeof(float);
  uint8_t* col = s_col[wid];
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  auto tile = [&](const uint4* masks, const float* sv, int vs, int p) {
    uint32_t w[kRows][kWords];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const uint4 q4 = masks[rr];
      w[rr][0] = q4.x;
      w[rr][1] = q4.y;
      w[rr][2] = q4.z;
      w[rr][3] = q4.w;
    }
    int start[kRows];                     // row rr's next slot in sv
    int run = vs, i = 0, end = 0;         // the lane's row's slots
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      start[rr] = run;
      i = rr == r ? run : i;
      run += row_popc(w[rr]);
      end = rr == r ? run : end;
    }
    // Each stored slot's lane into col[] at the slot's place in sv, as the
    // SpMV finds its values: lane l takes bit l of each word some row uses.
    // No branch: a lane whose bit is clear stores into the last entry,
    // past any that a pass reads.
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      uint32_t any = 0;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) any |= w[rr][q];
      if (any) {                          // the same branch across the warp
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int at = start[rr] + __popc(w[rr][q] & below);
          col[w[rr][q] & mine ? at : kVbuf + kVpad - 1] = 32 * q + lane;
          start[rr] += __popc(w[rr][q]);
        }
      }
    }
    __syncwarp();
    // The lane's row's slots in order, kSteps a pass, each pass's loads
    // issued before its first multiply-add: whole passes, then one pass
    // (last) that takes the rest by a select. X's rows past n read 0.0,
    // tested only in a panel that reaches past n (edge).
    const int x0 = p * kLanes;
    const char* xt = xl + static_cast<uint64_t>(x0) * stride;
    asm("" : "+l"(xt));  // one base a tile, not xl added again at each load
    const int lim = n - x0;               // lanes of the panel within X
    auto pass = [&](auto last_tag, auto edge_tag) {
      constexpr bool last = decltype(last_tag)::value;
      constexpr bool edge = decltype(edge_tag)::value;
      float a[kSteps], xv[kSteps][CPL];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int k = col[i + u];
        a[u] = sv[i + u];
        load_xrow<CPL, VEC>(xt, stride, k, (!last || i + u < end)
                            && (!edge || k < lim), cols, c0, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float sum = __fadd_rn(acc[c], __fmul_rn(a[u], xv[u][c]));
          acc[c] = !last || i + u < end ? sum : acc[c];
        }
    };
    auto slots = [&](auto edge) {
      for (; i + kSteps <= end; i += kSteps) pass(std::false_type{}, edge);
      if (i < end) pass(std::true_type{}, edge);
    };
    if (lim < kLanes) slots(std::true_type{});  // the same across the warp
    else slots(std::false_type{});
  };
  auto done = [&](int cb) {
    const int64_t i = (b0 + cb) * kRows + r;
    if (i < m && c0 < cols) store_yrow<CPL, VEC>(Y, i, cols, c0, acc);
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  };
  walk_tiles(bits, vals, vptr, pan, rowptr, b0, nb, s_bits[wid], s_vals[wid],
             tile, done);
}

// The warp_rows launch at cols columns (at most kRowsCols): CPL the least
// of 1, 2, 4, 8 that covers cols with 4 lanes, and vector loads and stores
// where every lane's columns lie within cols and X and Y are aligned for
// them.
template <int CPL>
void launch_spmm_rows(const void* bits, const void* vals, const void* vptr,
                      const void* pan, const void* rowptr, const void* X,
                      void* Y, int mb, int m, int n, int cols,
                      cudaStream_t stream) {
  constexpr int kVec = CPL < 4 ? CPL : 4;  // floats a vector
  const bool vec = cols % (4 * CPL) == 0
      && (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y))
             % (4 * kVec) == 0;
  const auto kernel = vec ? bcsr_bits_spmm_rows_kernel<CPL, true>
                          : bcsr_bits_spmm_rows_kernel<CPL, false>;
  const int warps = (mb + kBpw - 1) / kBpw;
  kernel<<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(bits), static_cast<const float*>(vals),
      static_cast<const int*>(vptr), static_cast<const int*>(pan),
      static_cast<const int*>(rowptr), static_cast<const float*>(X),
      static_cast<float*>(Y), mb, m, n, cols);
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

// The SpMM's design at cols columns (a SpmmDesign): warp_rows up to
// kRowsCols columns, lane_groups past them (Design, SpMM).
extern "C" int bcsr_bits_spmm_design(int cols) {
  return cols <= kRowsCols ? kWarpRows : kLaneGroups;
}

// The same arrays; X (n, cols) f32 row-major; Y (m, cols) f32.
extern "C" int bcsr_bits_spmm(const void* bits, const void* vals,
                              const void* vptr, const void* pan,
                              const void* rowptr, const void* X, void* Y,
                              int m, int n, int cols, void* stream) {
  const int mb = (m + kRows - 1) / kRows;
  if (mb > 0 && cols > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto launch =
        bcsr_bits_spmm_design(cols) == kLaneGroups ? launch_spmm
        : cols <= 4                                 ? launch_spmm_rows<1>
        : cols <= 8                                 ? launch_spmm_rows<2>
        : cols <= 16                                ? launch_spmm_rows<4>
                                                    : launch_spmm_rows<8>;
    launch(bits, vals, vptr, pan, rowptr, X, Y, mb, m, n, cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

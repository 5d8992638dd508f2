// XPOSE, the static-routed transpose SpMV of the scattered regime, for
// Hopper (sm_90a): stage S1 (two designs) and stage S3 (two designs).
//
// Replaces, in spmv_scpa_tpu/ops/xpose.py:
//   xpose_s1_slots <- _mirror_kernel (called at :198), _s1_kernel (called
//                    at :219) and the S2 transpose (jnp.swapaxes at :312),
//                    as products over a host table that reads x in place
//   xpose_mirror  <- _mirror_kernel, carried over; kept for the A/B
//   xpose_s1      <- _s1_kernel with the S2 transpose folded into its
//                    stores, carried over; kept for the A/B
//   xpose_s3_rows <- _s3_kernel     (called at :253), the strided
//                    un-blocking of y (:316-317) and the virtual rows'
//                    scatter-add (:319-323), as row sums over a host table
//   xpose_s3      <- the same, carried over block by block (prefix sums
//                    and routing planes); kept for the A/B
//
// Function, from the host plan's uint8 routing planes (ops/xpose_plan.py;
// simulate_xpose there is the spec). x is read as windows of 128 x 128:
// normal window w < NW0 is x[(w * 128 + r) * 128 + c] (0 past n), mirror
// window NW0 + v is row v * 128 + r of the mirror table xm.
//   mirror: xm[v * 128 + s, l] = x window msw[v * 4 + sel[v, s]], row
//           sub[v, s], lane l;
//   S1:     per step s, with xw its window,
//             slab[r, c] = xw[r, gidx[s * 128 + r, c]] * asv[s * 128 + r, c]
//           (lane 127 is the reserved zero), then for every out-block k < B2
//             mid[k, s, c2] = slab[r2[rt, c1], c1],  c1 = r3[rt, c2],
//           rt = s * B2 + k (the plan's r2/r3 with its K1p padding dropped);
//   S3:     per out-block b,
//             fin[f, l] = mid[b, sub[b * 128 + f, c], c],  c = r3b[b * 128 + f, l]
//           psum = inclusive prefix of each row of fin; cpre = exclusive
//           prefix over rows of psum[:, 127]; psg = psum + cpre; then two
//           passes st[q, lq] = psg[f, rpre[f, r]] with r = r3y[q, lq] and
//           f = ys[q, r] (0 where r >= 128), and
//             y_all[b + (q * 128 + lq) * B2] = st1 - st2   (q < 64, row < m2).
//   S1 slots: mid.flat[pos] = x[col] * val per entry of the host table
//           (ops/xpose.py:s1_slots_table resolves the S1 planes, the mirror
//           folded away, once per plan, for exactly the slots S3's row
//           table reads): chunk c holds entries of one step s = head[c][0]
//           with source windows src = head[c][4..7]; an entry's code is
//           (k * 128 + c2) << 16 | off, pos = (k * J1 + s) * 128 + c2, col =
//           src[off >> 14] * 16384 + (off & 16383); val 0.0 writes 0.0 and
//           reads no x, code 0xFFFF << 16 is padding and writes nothing.
//   S3 rows: y[r] = sum of mid[pos[k]] over rowptr[r] <= k < rowptr[r + 1]
//           (ops/xpose.py:s3_rows_table turns the planes, once per plan,
//           into each real row's product slots, its virtual rows' folded
//           in, ascending; and the list of rows past kShortRow slots,
//           longest first). A row of at most kShortRow slots adds them in
//           order from 0.0; a longer one is dealt round-robin to 32 lanes,
//           each adding its share in order from 0.0, and the lanes combine
//           by the halving tree (xor shuffles 16, 8, 4, 2, 1).
// Any index outside its range (a lane or row >= 128, a step >= J1, a
// source window past x) reads 0.0, so no plane can read out of bounds.
//
// What bounds them on this card: bytes. Per call S1's input: the planes
// (gidx and asv, the used rows of r2/r3; about 13 B per product on
// webbase1m's stand-in) for xpose_s1, or the slot table (8 B an entry and
// 32 B a chunk of 1024; 12 B an entry as a flat position, column, value
// table) for xpose_s1_slots; the product array written by S1 (whole, or
// only the slots S3 reads) and read by S3, x and y, and S3's own input:
// the eight planes (128 KB an out-block, about 95 B per product on
// amazon262k's far part) for xpose_s3, or the slot table (a 4-byte
// position per product and a 4-byte pointer per row) and the occupied
// product slots for xpose_s3_rows (and its long-row list, 4 B a row past
// 32 slots). No arithmetic worth counting.
//
// Design. The TPU needs transpose/lane-gather/transpose chains and batches
// of 8 steps because Mosaic has no per-element gather; here a thread reads
// plane[r][c] directly. S1 slots: every route of the slab design depends
// on the plan alone, so the host resolves them once into "mid slot <- (x
// column, value)" and the kernel is a stream over that table: no slab, no
// mirror table, no barrier, and only the slots S3 reads are written (about
// half of mid on these matrices). A block of 256 threads takes one chunk,
// a thread four entries a pass through 16-byte streaming loads (__ldcs)
// of codes and values, its four x gathers (__ldg; x, at most a few MB
// here, stays in the 50 MB L2) in flight together, then four stores: no
// atomics, each slot written once. The host stores each warp's 128
// entries interleaved (lane l holds entries l, l + 32, l + 64, l + 96), so
// each of the four stores covers 32 consecutive entries, a few sectors of
// mid, where four consecutive entries a lane would scatter every store
// over all the warp's sectors. The grid is the table's chunks, not
// the steps, so a small plan fills the card too. A chunk header costs 32
// B for 1024 entries; its step and source windows are what keep an entry
// at 8 B. Mirror: one thread per output element. S1: one
// 512-thread block per step builds the (128, 128) slab in shared memory
// (64 KB, above the 48 KB default: the launch raises the limit), then its
// threads emit mid[k, s, :] for every k, 512 coalesced bytes per k, which
// is S3's layout, so no transpose pass runs. S3: one 512-thread block per
// out-block; a warp per row of fin gathers it from mid and scans it in
// registers with the Hillis-Steele steps d = 1, 2, ..., 64 (shuffles for
// d < 32), psum goes to shared memory, one warp scans the row totals the
// same way, and the extraction reads psg from shared memory. S3 rows: the
// prefix trick is how a TPU, which has no scatter, sums rows; its routing
// depends on the plan alone, so the host resolves it once and the kernel
// reads only the occupied products, the table and y. Its warps are
// assigned by slot count, not by position. A power-law matrix puts half
// its slots in rows past kShortRow (the webbase-1M benchmark matrix: 8,433
// such rows hold 50.6% of its 3,106,075 slots, the longest 2,878), and a
// warp of 32 consecutive rows that met one ran it as a serial whole-warp
// pass while its other lanes waited: a quarter of the warps carried half
// the work. So the grid's first blocks give each row past kShortRow a warp
// of its own, from a host list ordered longest first (ties by row), so
// that no block waits behind a hub row that starts last; the remaining
// blocks are the 32-row warps, a lane each, writing y coalesced, a lane
// whose row is long writing nothing. One launch, no atomics, each y
// written once. A lane walks its row (or its share of a long row) with
// kDepth positions, then kDepth products, in flight (16 by measurement:
// 4, 8 or 32 in either walk gained at most 2% on that matrix and lost up
// to 11%). The planner refuses a row of more than
// 16k entries, so a long row's walk is at most 512 slots a lane. Which
// warp sums a row does not change its order of adds: a short row in table
// order by one lane, a long one round-robin over 32 lanes and the halving
// tree. A position is a 32-bit flat index into mid (B2 * J1 * 128 <
// 2^31): a 16-bit offset within the row's out-block would save 2 B a
// product but not fit a row whose virtual rows lie in other out-blocks.
// All adds are plain f32 adds in the order the plain PyTorch version
// repeats (p[l] + p[l - d] per step; the rows' fixed orders above),
// products and sums rounded separately, so all five kernels equal their
// plain versions bit for bit. No tensor cores: an f32 MMA would run in
// TF32.
// Deterministic: no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWin = kLanes * kLanes;     // elements of one window
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMirThreads = 256;
constexpr int kS1Threads = 512;
constexpr int kS3Threads = 512;
constexpr int kS3Warps = kS3Threads / 32;
constexpr int kStageRows = 64;             // y staging rows per out-block
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kShortRow = 32;              // longest row a single lane sums
constexpr int kDepth = 16;                 // a lane's loads in flight
constexpr int kSlotThreads = 256;
constexpr unsigned kNoSlot = 0xFFFFu;      // an entry's (k, c2): padding

// Four entries of the slot table: the products, 0.0 where the value is
// 0.0 or the column lies outside x (no x read), then the stores, padding
// and positions outside mid skipped.
__device__ __forceinline__ void slot_quad(const float* __restrict__ x, int64_t n,
                                          uint4 c, float4 v, int64_t s,
                                          int4 src, float* __restrict__ mid,
                                          int64_t n_mid, int J1) {
  const unsigned cs[4] = {c.x, c.y, c.z, c.w};
  const float vs[4] = {v.x, v.y, v.z, v.w};
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned off = cs[j] & 0xFFFFu;
    const unsigned q = off >> 14;
    const int w = q == 0 ? src.x : q == 1 ? src.y : q == 2 ? src.z : src.w;
    const int64_t col = static_cast<int64_t>(w) * kWin + (off & (kWin - 1));
    p[j] = 0.0f;
    if (vs[j] != 0.0f && col >= 0 && col < n) p[j] = __fmul_rn(__ldg(x + col), vs[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned kc2 = cs[j] >> 16;
    if (kc2 == kNoSlot) continue;
    const int64_t pos = (static_cast<int64_t>(kc2 >> 7) * J1 + s) * kLanes + (kc2 & (kLanes - 1));
    if (pos >= 0 && pos < n_mid) mid[pos] = p[j];
  }
}

// Block b takes chunk b of the table: its header (step, -, -, -, four
// source windows), then its entries four a thread a pass.
__global__ void __launch_bounds__(kSlotThreads)
s1_slots_kernel(const float* __restrict__ x, int64_t n, const int4* __restrict__ head,
                const uint4* __restrict__ code, const float4* __restrict__ val,
                int chunk4, float* __restrict__ mid, int64_t n_mid, int J1) {
  const int64_t b = blockIdx.x;
  const int64_t s = __ldg(head + 2 * b).x;
  const int4 src = __ldg(head + 2 * b + 1);
  for (int e = threadIdx.x; e < chunk4; e += kSlotThreads) {
    const int64_t i = b * chunk4 + e;
    slot_quad(x, n, __ldcs(code + i), __ldcs(val + i), s, src, mid, n_mid, J1);
  }
}

__global__ void __launch_bounds__(kMirThreads)
mirror_kernel(const float* __restrict__ x, int64_t n,
              const int* __restrict__ msw, const uint8_t* __restrict__ sel,
              const uint8_t* __restrict__ sub, float* __restrict__ out,
              int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kMirThreads + threadIdx.x;
  if (e >= n_out) return;
  const int64_t vs = e / kLanes;          // mirror window * 128 + sublane
  const int l = static_cast<int>(e - vs * kLanes);
  const int q = __ldg(sel + vs);
  const int r = __ldg(sub + vs);
  float v = 0.0f;
  if (q < 4 && r < kLanes) {
    const int64_t src = (static_cast<int64_t>(__ldg(msw + (vs / kLanes) * 4 + q)) *
                         kLanes + r) * kLanes + l;
    if (src >= 0 && src < n) v = __ldg(x + src);
  }
  out[e] = v;
}

__global__ void __launch_bounds__(kS1Threads)
s1_kernel(const float* __restrict__ x, int64_t n, const float* __restrict__ xm,
          int nwm, int nw0, const int* __restrict__ win,
          const uint8_t* __restrict__ gidx, const float* __restrict__ asv,
          const uint8_t* __restrict__ r2, const uint8_t* __restrict__ r3,
          float* __restrict__ mid, int J1, int B2) {
  extern __shared__ float slab[];          // (128, 128)
  const int s = blockIdx.x;
  const int w = __ldg(win + s);
  const int64_t p0 = static_cast<int64_t>(s) * kWin;
  for (int e = threadIdx.x; e < kWin; e += kS1Threads) {
    const int r = e / kLanes;
    const int c = e - r * kLanes;
    const int g = __ldg(gidx + p0 + e);
    float xv = 0.0f;
    if (g < kLanes) {
      if (w >= 0 && w < nw0) {
        const int64_t col = (static_cast<int64_t>(w) * kLanes + r) * kLanes + g;
        if (col < n) xv = __ldg(x + col);
      } else if (w >= nw0 && w < nw0 + nwm) {
        xv = __ldg(xm + (static_cast<int64_t>(w - nw0) * kLanes + r) * kLanes + g);
      }
    }
    slab[e] = c == kLanes - 1 ? 0.0f : __fmul_rn(xv, __ldg(asv + p0 + e));
  }
  __syncthreads();
  const int n_el = B2 * kLanes;
  for (int e = threadIdx.x; e < n_el; e += kS1Threads) {
    const int k = e / kLanes;
    const int c2 = e - k * kLanes;
    const int64_t rt = (static_cast<int64_t>(s) * B2 + k) * kLanes;
    const int c1 = __ldg(r3 + rt + c2);
    float v = 0.0f;
    if (c1 < kLanes) {
      const int r = __ldg(r2 + rt + c1);
      if (r < kLanes) v = slab[r * kLanes + c1];
    }
    mid[(static_cast<int64_t>(k) * J1 + s) * kLanes + c2] = v;
  }
}

// Inclusive Hillis-Steele scan of one row of 128 held by a warp, element
// j * 32 + lane in v[j]: per step d, p[l] += p[l - d] for l >= d, from the
// values before the step.
__device__ __forceinline__ void warp_scan128(float (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float up[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) up[j] = __shfl_sync(kFull, v[j], (lane - d) & 31);
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      if (lane >= d)
        v[j] = __fadd_rn(v[j], up[j]);
      else if (j > 0)
        v[j] = __fadd_rn(v[j], up[j - 1]);
    }
  }
#pragma unroll
  for (int dj = 1; dj < 4; dj <<= 1) {     // d = 32, 64
#pragma unroll
    for (int j = 3; j >= dj; --j) v[j] = __fadd_rn(v[j], v[j - dj]);
  }
}

// One extraction pass of block b: st[q, lq] for element e = q * 128 + lq.
__device__ __forceinline__ float extract(const float* __restrict__ psg,
                                         const uint8_t* __restrict__ rpre,
                                         const uint8_t* __restrict__ ys,
                                         const uint8_t* __restrict__ r3y,
                                         int64_t blk0, int e) {
  const int q = e / kLanes;
  const int r = __ldg(r3y + blk0 + e);
  if (r >= kLanes) return 0.0f;
  const int f = __ldg(ys + blk0 + q * kLanes + r);
  if (f >= kLanes) return 0.0f;
  const int c = __ldg(rpre + blk0 + f * kLanes + r);
  return c < kLanes ? psg[f * kLanes + c] : 0.0f;
}

__global__ void __launch_bounds__(kS3Threads)
s3_kernel(const float* __restrict__ mid, const uint8_t* __restrict__ planes,
          int64_t plane_el, float* __restrict__ y_all, int J1, int B2,
          int64_t m2) {
  extern __shared__ float smem[];
  float* psg = smem;                       // (128, 128)
  float* carry = smem + kWin;              // (128,) inclusive row-total scan
  const uint8_t* sub = planes;
  const uint8_t* r3b = planes + plane_el;
  const int b = blockIdx.x;
  const int64_t blk0 = static_cast<int64_t>(b) * kWin;
  const float* midb = mid + static_cast<int64_t>(b) * J1 * kLanes;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  for (int f = warp; f < kLanes; f += kS3Warps) {
    const int64_t row = blk0 + f * kLanes;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = __ldg(r3b + row + j * 32 + lane);
      v[j] = 0.0f;
      if (c < kLanes) {
        const int s = __ldg(sub + row + c);
        if (s < J1) v[j] = __ldg(midb + static_cast<int64_t>(s) * kLanes + c);
      }
    }
    warp_scan128(v);
#pragma unroll
    for (int j = 0; j < 4; ++j) psg[f * kLanes + j * 32 + lane] = v[j];
    if (lane == 31) carry[f] = v[3];
  }
  __syncthreads();
  if (warp == 0) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = carry[j * 32 + lane];
    warp_scan128(v);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) carry[j * 32 + lane] = v[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kWin; e += kS3Threads) {
    const int f = e / kLanes;
    psg[e] = __fadd_rn(psg[e], f > 0 ? carry[f - 1] : 0.0f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kStageRows * kLanes; e += kS3Threads) {
    const int64_t row = b + static_cast<int64_t>(e) * B2;
    if (row >= m2) continue;
    const float st1 = extract(psg, planes + 2 * plane_el, planes + 3 * plane_el,
                              planes + 4 * plane_el, blk0, e);
    const float st2 = extract(psg, planes + 5 * plane_el, planes + 6 * plane_el,
                              planes + 7 * plane_el, blk0, e);
    y_all[row] = __fsub_rn(st1, st2);
  }
}

// One product slot: mid[pos[k]], 0.0 for a position outside mid.
__device__ __forceinline__ float slot_value(const float* __restrict__ mid,
                                            int64_t n_mid, int p) {
  return p >= 0 && p < n_mid ? __ldg(mid + p) : 0.0f;
}

// Lane's share of slots lo + lane0, lo + lane0 + step, ... < hi, added in
// order from 0.0, kDepth positions then kDepth products in flight.
__device__ __forceinline__ float strided_sum(const float* __restrict__ mid,
                                             int64_t n_mid,
                                             const int* __restrict__ pos,
                                             int first, int hi, int step) {
  float acc = 0.0f;
  for (int k0 = first; k0 < hi; k0 += kDepth * step) {
    int p[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u)
      p[u] = k0 + u * step < hi ? __ldg(pos + k0 + u * step) : -1;
    float v[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) v[u] = slot_value(mid, n_mid, p[u]);
#pragma unroll
    for (int u = 0; u < kDepth; ++u)
      if (k0 + u * step < hi) acc = __fadd_rn(acc, v[u]);
  }
  return acc;
}

// Two kinds of warp in one grid. The first long_blocks blocks give warp
// i the long row long_rows[i] (more than kShortRow slots; the host lists
// them longest first): its 32 lanes take the row's slots round-robin and
// combine by the halving tree. Every later warp w owns rows 32 w .. 32 w
// + 31, lane l row 32 w + l, and sums it alone where it has at most
// kShortRow slots; a longer row is its own warp's. A listed row outside
// y, or of at most kShortRow slots, is skipped. Row pointers are clamped
// into [0, n_pos], an end below its start to the start.
__global__ void __launch_bounds__(kRowThreads)
s3_rows_kernel(const float* __restrict__ mid, int64_t n_mid,
               const int* __restrict__ rowptr, const int* __restrict__ pos,
               int n_pos, const int* __restrict__ long_rows, int n_long,
               int long_blocks, float* __restrict__ y, int m) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int i = blockIdx.x * kRowWarps + threadIdx.x / 32;
    if (i >= n_long) return;                 // the whole warp: no row
    const int r = __ldg(long_rows + i);
    if (r < 0 || r >= m) return;
    const int lo = min(max(__ldg(rowptr + r), 0), n_pos);
    const int hi = min(max(__ldg(rowptr + r + 1), lo), n_pos);
    if (hi - lo <= kShortRow) return;        // its lane sums it
    float part = strided_sum(mid, n_mid, pos, lo + lane, hi, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
    if (lane == 0) y[r] = part;
    return;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x - long_blocks) * kRowThreads +
                    threadIdx.x;
  if (r >= m) return;
  const int lo = min(max(__ldg(rowptr + r), 0), n_pos);
  const int hi = min(max(__ldg(rowptr + r + 1), lo), n_pos);
  if (hi - lo <= kShortRow) y[r] = strided_sum(mid, n_mid, pos, lo, hi, 1);
}

template <class K>
int raise_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// x (n,) f32; msw (nwm * 4,) i32; sel, sub (nwm, 128) u8;
// out (nwm * 128, 128) f32.
extern "C" int xpose_mirror(const void* x, int64_t n, const void* msw,
                            const void* sel, const void* sub, void* out,
                            int nwm, void* stream) {
  const int64_t n_out = static_cast<int64_t>(nwm) * kWin;
  if (n_out > 0) {
    const int64_t blocks = (n_out + kMirThreads - 1) / kMirThreads;
    mirror_kernel<<<static_cast<unsigned>(blocks), kMirThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<const int*>(msw),
        static_cast<const uint8_t*>(sel), static_cast<const uint8_t*>(sub),
        static_cast<float*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n,) f32; xm (nwm * 128, 128) f32; win (J1,) i32; gidx (J1 * 128, 128)
// u8; asv (J1 * 128, 128) f32; r2, r3 (J1 * B2, 128) u8;
// mid (B2, J1, 128) f32.
extern "C" int xpose_s1(const void* x, int64_t n, const void* xm, int nwm,
                        int nw0, const void* win, const void* gidx,
                        const void* asv, const void* r2, const void* r3,
                        void* mid, int J1, int B2, void* stream) {
  if (J1 > 0 && B2 > 0) {
    const size_t smem = kWin * sizeof(float);
    const int err = raise_smem(s1_kernel, smem);
    if (err != 0) return err;
    s1_kernel<<<J1, kS1Threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<const float*>(xm), nwm,
        nw0, static_cast<const int*>(win), static_cast<const uint8_t*>(gidx),
        static_cast<const float*>(asv), static_cast<const uint8_t*>(r2),
        static_cast<const uint8_t*>(r3), static_cast<float*>(mid), J1, B2);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n,) f32; head (C, 8) i32; code (C, chunk) i32 (bit patterns);
// val (C, chunk) f32, chunk a multiple of 4, all 16-byte aligned;
// mid (B2, J1, 128) f32 of n_mid elements.
extern "C" int xpose_s1_slots(const void* x, int64_t n, const void* head,
                              const void* code, const void* val, int C,
                              int chunk, void* mid, int64_t n_mid, int J1,
                              void* stream) {
  if (C > 0 && chunk > 0) {
    s1_slots_kernel<<<C, kSlotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<const int4*>(head),
        static_cast<const uint4*>(code), static_cast<const float4*>(val),
        chunk / 4, static_cast<float*>(mid), n_mid, J1);
  }
  return static_cast<int>(cudaGetLastError());
}

// mid (B2, J1, 128) f32; planes (8, B2 * 128, 128) u8 in the order sub,
// r3b, rpre1, ys1, r3y1, rpre2, ys2, r3y2; y_all (m2,) f32, m2 <= B2 * 8192.
extern "C" int xpose_s3(const void* mid, const void* planes, void* y_all,
                        int J1, int B2, int64_t m2, void* stream) {
  if (B2 > 0) {
    const size_t smem = (kWin + kLanes) * sizeof(float);
    const int err = raise_smem(s3_kernel, smem);
    if (err != 0) return err;
    s3_kernel<<<B2, kS3Threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mid), static_cast<const uint8_t*>(planes),
        static_cast<int64_t>(B2) * kWin, static_cast<float*>(y_all), J1, B2, m2);
  }
  return static_cast<int>(cudaGetLastError());
}

// mid (B2, J1, 128) f32, n_mid elements; rowptr (m + 1,) i32; pos (n_pos,)
// i32 flat indices into mid; long_rows (n_long,) i32, every row of more
// than kShortRow slots, longest first; y (m,) f32.
extern "C" int xpose_s3_rows(const void* mid, int64_t n_mid, const void* rowptr,
                             const void* pos, int n_pos, const void* long_rows,
                             int n_long, void* y, int m, void* stream) {
  if (m > 0) {
    const int64_t long_blocks = (static_cast<int64_t>(n_long) + kRowWarps - 1) / kRowWarps;
    const int64_t blocks =
        long_blocks + (static_cast<int64_t>(m) + kRowThreads - 1) / kRowThreads;
    s3_rows_kernel<<<static_cast<unsigned>(blocks), kRowThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mid), n_mid, static_cast<const int*>(rowptr),
        static_cast<const int*>(pos), n_pos, static_cast<const int*>(long_rows),
        n_long, static_cast<int>(long_blocks), static_cast<float*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

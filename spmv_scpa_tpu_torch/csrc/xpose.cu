// XPOSE, the static-routed transpose SpMV of the scattered regime, for
// Hopper (sm_90a): the mirror build, stage S1 and stage S3 (two designs).
//
// Replaces, in spmv_scpa_tpu/ops/xpose.py:
//   xpose_mirror  <- _mirror_kernel (called at :198)
//   xpose_s1      <- _s1_kernel     (called at :219), with the S2 transpose
//                    (jnp.swapaxes at :312) folded into its stores
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
//   S3 rows: y[r] = sum of mid[pos[k]] over rowptr[r] <= k < rowptr[r + 1]
//           (ops/xpose.py:s3_rows_table turns the planes, once per plan,
//           into each real row's product slots, its virtual rows' folded
//           in, ascending). A row of at most kShortRow slots adds them in
//           order from 0.0; a longer one is dealt round-robin to 32 lanes,
//           each adding its share in order from 0.0, and the lanes combine
//           by the halving tree (xor shuffles 16, 8, 4, 2, 1).
// Any index outside its range (a lane or row >= 128, a step >= J1, a
// source window past x) reads 0.0, so no plane can read out of bounds.
//
// What bounds them on this card: bytes. Per call the planes (gidx and asv,
// the used rows of r2/r3), the product array written by S1 and read by
// S3, x and y, and S3's own input: the eight planes (128 KB an out-block,
// about 95 B per product on amazon262k's far part) for xpose_s3, or the
// slot table (a 4-byte position per product and a 4-byte pointer per row)
// and the occupied product slots for xpose_s3_rows. No arithmetic worth
// counting.
//
// Design. The TPU needs transpose/lane-gather/transpose chains and batches
// of 8 steps because Mosaic has no per-element gather; here a thread reads
// plane[r][c] directly. Mirror: one thread per output element. S1: one
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
// reads only the occupied products, the table and y. A warp owns 32
// consecutive rows, one a lane, so y is written coalesced with no atomics
// and no second launch: each lane walks its row of at most kShortRow slots
// with kDepth positions, then kDepth products, in flight; then the warp
// takes its longer rows one at a time (ballot), all lanes on one row. The
// planner refuses a row of more than 16k entries, so a warp's longest walk
// is 512 slots a lane (the webbase-1M stand-in's longest row: 1,894). A
// position is a 32-bit flat index into mid (B2 * J1 * 128 < 2^23): a
// 16-bit offset within the row's out-block would save 2 B a product but
// not fit a row whose virtual rows lie in other out-blocks. All adds are
// plain f32 adds in the order the plain PyTorch version repeats
// (p[l] + p[l - d] per step; the rows' fixed orders above), products and
// sums rounded separately, so all four kernels equal their plain versions
// bit for bit. No tensor cores: an f32 MMA would run in TF32.
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
constexpr int kShortRow = 32;              // longest row a single lane sums
constexpr int kDepth = 16;                 // a lane's loads in flight

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

// Warp w owns rows 32 w .. 32 w + 31, lane l row 32 w + l. Row pointers
// are clamped into [0, n_pos], an end below its start to the start.
__global__ void __launch_bounds__(kRowThreads)
s3_rows_kernel(const float* __restrict__ mid, int64_t n_mid,
               const int* __restrict__ rowptr, const int* __restrict__ pos,
               int n_pos, float* __restrict__ y, int m) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (r - lane >= m) return;                 // the whole warp is past y
  int lo = 0, hi = 0;
  if (r < m) {
    lo = min(max(__ldg(rowptr + r), 0), n_pos);
    hi = min(max(__ldg(rowptr + r + 1), lo), n_pos);
  }
  float acc = 0.0f;
  if (hi - lo <= kShortRow) acc = strided_sum(mid, n_mid, pos, lo, hi, 1);
  unsigned long_rows = __ballot_sync(kFull, hi - lo > kShortRow);
  while (long_rows) {
    const int owner = __ffs(long_rows) - 1;
    long_rows &= long_rows - 1;
    const int llo = __shfl_sync(kFull, lo, owner);
    const int lhi = __shfl_sync(kFull, hi, owner);
    float part = strided_sum(mid, n_mid, pos, llo + lane, lhi, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
    if (lane == owner) acc = part;
  }
  if (r < m) y[r] = acc;
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
// i32 flat indices into mid; y (m,) f32.
extern "C" int xpose_s3_rows(const void* mid, int64_t n_mid, const void* rowptr,
                             const void* pos, int n_pos, void* y, int m,
                             void* stream) {
  if (m > 0) {
    const int64_t blocks = (static_cast<int64_t>(m) + kRowThreads - 1) / kRowThreads;
    s3_rows_kernel<<<static_cast<unsigned>(blocks), kRowThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mid), n_mid, static_cast<const int*>(rowptr),
        static_cast<const int*>(pos), n_pos, static_cast<float*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

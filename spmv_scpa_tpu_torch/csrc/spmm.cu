// BCSR SpMM for Hopper (sm_90a): Y = A @ X with A in dense (8, 128) tiles.
//
// Replaces: spmv_scpa_tpu/ops/pallas_kernels.py, `_spmm_kernel` (called at
// :1201 by `make_bcsr_spmm`, the `pallas-bcsr-spmm` strategy).
//
// Function. Tile t holds rows 8 * b .. 8 * b + 7 (b its block row) and
// columns pan[t] * 128 .. + 127 of A as vals[t * 8 + r, k]; the tiles of
// block row b are t in [rowptr[b], rowptr[b + 1]), in column order. X is
// row-major (n, cols) f32, and a column of A at or past n reads X as 0. Y
// (m, cols) f32:
//   Y[i, c] = sum over the tiles t of block row i / 8, in order, of the
//             tile's partial: the 128 products vals[t * 8 + i % 8, k] *
//             X[pan[t] * 128 + k, c] summed as a pairwise tree (adjacent
//             lanes, then adjacent pairs, ...),
// each product and sum rounded separately (__fmul_rn / __fadd_rn), so the
// plain PyTorch version, which adds in the same order, equals it bit for bit.
//
// Arithmetic: f32 on the CUDA cores. The TPU kernel asks its MXU for
// Precision.HIGHEST; a tensor-core MMA on f32 inputs would run in TF32
// (about three decimal digits), so none is used here.
//
// What bounds it on this card: bytes, at 8 and at 64 columns. Each tile is
// 4 KB of values read once (565 MB for the 22.6M-nnz flagship at fill
// 0.16); the function needs only 2 * nnz * cols flops. This design does
// the MACs of every slot, the stored zeros' too, so at 64 columns its own
// 2 * 1024 * 64 flops a tile outweigh the tile's bytes. X's panels are read through
// L1/L2. The TPU kernel's one-hot window reduction and staggered outputs
// carry sums across its sequential grid; here threads own elements of Y
// and walk their block row's tiles, so nothing is carried between blocks
// and nothing is atomic.
//
// Design. One thread per (block row b, column c) computes the 8 elements
// Y[8b .. 8b + 7, c]: the tile's 8 rows share each X value, so one X load
// and its address feed 8 products (loads and address arithmetic, not
// MACs, limit a thread that owns one element). Consecutive threads take
// consecutive columns:
// at cols >= 32 a warp reads the same tile row (broadcast) and 32
// consecutive X values; at cols 8 a warp covers four block rows. Each row
// of the tile is read four values at a time (float4), and each row's tree
// is built as a binary counter over its 32 groups of four (five pending
// partial sums a row, in registers once the loops are unrolled).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 8;
constexpr int kThreads = 256;
constexpr int kLevels = 5;    // 32 groups of four lanes: a tree 5 deep

__global__ void __launch_bounds__(kThreads)
bcsr_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ pan,
                 const int* __restrict__ rowptr, const float* __restrict__ X,
                 float* __restrict__ Y, int64_t n_el, int m, int n,
                 int cols) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_el) return;
  const int64_t b = e / cols;
  const int c = static_cast<int>(e - b * cols);
  const int t0 = __ldg(rowptr + b), t1 = __ldg(rowptr + b + 1);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const float4* v = reinterpret_cast<const float4*>(
        vals + static_cast<int64_t>(t) * kRows * kLanes);
    const int64_t col0 = static_cast<int64_t>(__ldg(pan + t)) * kLanes;
    float pending[kRows][kLevels];  // [r][l]: the sum of 4 * 2^l products
#pragma unroll
    for (int k4 = 0; k4 < kLanes / 4; ++k4) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = col0 + 4 * k4 + j;
        xv[j] = col < n ? __ldg(X + col * cols + c) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = __ldg(v + r * (kLanes / 4) + k4);
        float s = __fadd_rn(__fadd_rn(__fmul_rn(a.x, xv[0]), __fmul_rn(a.y, xv[1])),
                            __fadd_rn(__fmul_rn(a.z, xv[2]), __fmul_rn(a.w, xv[3])));
        int l = 0;
#pragma unroll
        for (; l < kLevels && ((k4 >> l) & 1); ++l) s = __fadd_rn(pending[r][l], s);
        if (l < kLevels) pending[r][l] = s; else acc[r] = __fadd_rn(acc[r], s);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = b * kRows + r;
    if (i < m) Y[i * cols + c] = acc[r];
  }
}

}  // namespace

// vals (T * 8, 128) f32; pan (T,) i32; rowptr (ceil(m / 8) + 1,) i32;
// X (n, cols) f32; Y (m, cols) f32.
extern "C" int bcsr_spmm(const void* vals, const void* pan, const void* rowptr,
                         const void* X, void* Y, int m, int n, int cols,
                         void* stream) {
  const int64_t n_el = static_cast<int64_t>((m + kRows - 1) / kRows) * cols;
  if (n_el > 0) {
    const int64_t blocks = (n_el + kThreads - 1) / kThreads;
    bcsr_spmm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(pan),
        static_cast<const int*>(rowptr), static_cast<const float*>(X),
        static_cast<float*>(Y), n_el, m, n, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The three lane gathers of the ext route and the chips tail, for Hopper
// (sm_90a).
//
// Replaces, in spmv_scpa_tpu/ops/ext_gather.py:
//   sorted_gather  <- make_sorted_gather (stage 1: the compact hot region)
//   ranked_gather  <- make_ranked_gather (stage 2, resident hot region;
//                     also the ranked heavy-row merge of the chips tail)
//   window_gather  <- make_resident_window_gather (stage 2, a window of the
//                     hot region per output row; also the windowed merge)
//
// Every one computes, per output element e = r * 128 + j,
//     out[e] = src[row(r, p[e]) * 128 + l[e]]      p[e] in [0, P)
//     out[e] = 0                                    otherwise
// with row = base[r / 8] * R + p (sorted, P = R), row = p (ranked, P = H)
// or row = base8[r] * 8 + p (window, P = R_h). The zero for an index
// outside [0, P) is the TPU kernel's rule: its one-hot sublane mask
// (_mask_gather) matches no row there, and the windowed merge points
// unset lanes at p = R_h to read an exact 0 (chips_tail.py:970). A lane
// outside [0, 128) or a row outside the source also reads 0, so no
// index can read out of bounds.
//
// What bounds them on this card: bytes, and at the shapes of the main
// path launch latency. Each output element costs two int32 index reads
// and one f32 write (12 B, coalesced) plus one 4 B source read; the
// source (at most a few MB) stays in the 50 MB L2. No arithmetic.
//
// What the design does: the TPU needed a lane gather plus a one-hot
// sublane reduction over the whole (R, H or R_h)-row block because
// Mosaic's gather reaches only 128 lanes. Here each output element is one
// thread doing one indexed read through the read-only path: 256 threads
// per block, consecutive threads on consecutive elements, so the index
// reads and the output write are coalesced. The result moves values
// without arithmetic, so it equals the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

enum Mode { kSorted = 0, kRanked = 1, kWindow = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ src, const int* __restrict__ base,
              const int* __restrict__ p, const int* __restrict__ l,
              float* __restrict__ out, int64_t n_out, int P, int R,
              int64_t src_rows) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  const int64_t r = e / kLanes;
  const int pi = __ldg(p + e);
  const int li = __ldg(l + e);
  int64_t row = pi;
  if (kMode == kSorted)
    row += static_cast<int64_t>(__ldg(base + r / 8)) * R;
  else if (kMode == kWindow)
    row += static_cast<int64_t>(__ldg(base + r)) * 8;
  const bool ok = pi >= 0 && pi < P && li >= 0 && li < kLanes && row >= 0 &&
                  row < src_rows;
  out[e] = ok ? __ldg(src + row * kLanes + li) : 0.0f;
}

template <int kMode>
int launch(const void* src, const void* base, const void* p, const void* l,
           void* out, int rows_out, int P, int R, int64_t src_rows,
           void* stream) {
  const int64_t n_out = static_cast<int64_t>(rows_out) * kLanes;
  if (n_out > 0) {
    const int64_t blocks = (n_out + kThreads - 1) / kThreads;
    gather_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const int*>(base),
        static_cast<const int*>(p), static_cast<const int*>(l),
        static_cast<float*>(out), n_out, P, R, src_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x1 (x1_rows, 128) f32; base (rows_out / 8,) i32; p, l, out (rows_out, 128).
extern "C" int sorted_gather(const void* x1, const void* base, const void* p,
                             const void* l, void* out, int rows_out, int R,
                             int64_t x1_rows, void* stream) {
  return launch<kSorted>(x1, base, p, l, out, rows_out, R, R, x1_rows, stream);
}

// hot (H, 128) f32; p, l, out (rows_out, 128).
extern "C" int ranked_gather(const void* hot, const void* p, const void* l,
                             void* out, int rows_out, int H, void* stream) {
  return launch<kRanked>(hot, nullptr, p, l, out, rows_out, H, 0, H, stream);
}

// hot (H_pad, 128) f32; base8 (rows_out,) i32; p, l, out (rows_out, 128).
extern "C" int window_gather(const void* hot, const void* base8,
                             const void* p, const void* l, void* out,
                             int rows_out, int R_h, int64_t H_pad,
                             void* stream) {
  return launch<kWindow>(hot, base8, p, l, out, rows_out, R_h, 0, H_pad,
                         stream);
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

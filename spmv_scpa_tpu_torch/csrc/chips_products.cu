// The chips tail's x side, for Hopper (sm_90a): one product per chip slot
// over a host-built slot table that reads x in place.
//
// Replaces, on the chips tail's path (spmv_scpa_tpu/ops/chips_tail.py,
// its device pipeline at :807-839):
//   chips_products <- make_sorted_gather (stage 1, ops/ext_gather.py:79,
//                     called at :98), make_ranked_gather (stage 2, :121,
//                     called at :140), make_resident_window_gather (a
//                     split plan's windowed stage 2, :167, called at :188),
//                     the zero-padded copy of x they read and the multiply
//                     vals * xg (chips_tail.py:839)
// The ext route of the lanes core and the landing's panel merge keep the
// three gathers (csrc/ext_gather.cu).
//
// Function, per slot e of the table (ops/chips_slots.py:slots_table
// resolves the plan's stage-1 and stage-2 tables into one x column per
// chip slot, once per plan):
//     prod[e] = vals[e] * x[cols[e]]      0 <= cols[e] < n
//     prod[e] = +0.0, no x read           otherwise (column -1: a slot the
//                                         old pipeline read as 0.0, or one
//                                         that holds no entry)
// One f32 product rounded once (__fmul_rn), as the reference's multiply:
// bit-equal to the plain version.
//
// What bounds it on this card: bytes, and at the main path's shapes the
// launch. Per slot a 4-byte column and a 4-byte value read and a 4-byte
// product written (12 B), plus the distinct x elements the columns name;
// x (1-4 MB on these paths) stays in the 50 MB L2. One multiply per slot.
//
// Design. The TPU staged x in VMEM through two gathers because its
// kernels could not read x at arbitrary columns; here the routes of both
// stages depend on the plan alone, so the host folds them into the table
// and the kernel is a stream over it: a thread takes four consecutive
// slots, its column and value as one 16-byte streaming load each
// (__ldcs: read once), its four x gathers through the read-only path
// (__ldg) in flight together, its four products as one 16-byte store
// (kept in L2 for the segment-sum that reads them next). No shared
// memory, no TMA (every input byte is read once, and TMA serves no
// indexed gather), no atomics. One launch covers every stream of a plan
// and, on the row-sharded hybrid, every shard of a device: their tables
// are concatenated on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float product(int c, float v,
                                         const float* __restrict__ x,
                                         int64_t n) {
  return (c >= 0 && c < n) ? __fmul_rn(v, __ldg(x + c)) : 0.0f;
}

// Thread i takes slots 4i .. 4i + 3.
__global__ void __launch_bounds__(kThreads)
products_kernel(const int4* __restrict__ cols, const float4* __restrict__ vals,
                const float* __restrict__ x, int64_t n,
                float4* __restrict__ out, int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 c = __ldcs(cols + i);
  const float4 v = __ldcs(vals + i);
  float4 p;
  p.x = product(c.x, v.x, x, n);
  p.y = product(c.y, v.y, x, n);
  p.z = product(c.z, v.z, x, n);
  p.w = product(c.w, v.w, x, n);
  out[i] = p;
}

}  // namespace

// cols (4 n4,) i32, vals and out (4 n4,) f32, 16-byte aligned; x (n,) f32.
extern "C" int chips_products(const void* cols, const void* vals,
                              const void* x, int64_t n, void* out, int64_t n4,
                              void* stream) {
  if (n4 > 0) {
    const int64_t blocks = (n4 + kThreads - 1) / kThreads;
    products_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(cols), static_cast<const float4*>(vals),
        static_cast<const float*>(x), n, static_cast<float4*>(out), n4);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

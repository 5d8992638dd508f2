// Two designs of the row-layout PELL kernel that csrc/pell_rows.cu does not
// use, kept to be timed against it (bench/rows_study.py). Both compute what
// pell_rows computes, in the same order, with the same block pass
// (csrc/pell_rows.cuh), so their y equals its bit for bit.
//
//   groups16: a lane loads 4 neighbouring slots as one 16-byte value load
//             and one 16-byte column load (__ldcs), twice; a warp's gather
//             then reads the columns of slots 4 apart, spanning 128 slots.
//   ring<S>:  a persistent grid (as many blocks as fit on the card), each
//             block walking the blocks of slots b, b + grid, ...; one thread
//             keeps S of them in flight as 1-D TMA bulk copies
//             (cp.async.bulk into a ring of S shared-memory stages,
//             completion on an mbarrier), and the block reads its slots
//             from the stage as pell_rows reads them from device memory.
//             Takes vals and cols padded to whole blocks of slots.

#include <cstdint>
#include <cuda_runtime.h>

#include "../csrc/pell_rows.cuh"

namespace {

using namespace rowpass;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <class T, int Q>
__global__ void __launch_bounds__(kThreads, 1)
groups16(const T* __restrict__ vals, const int* __restrict__ cols,
         const int* __restrict__ qptr, const int* __restrict__ blk_lo,
         const T* __restrict__ x, T* __restrict__ carry, T* __restrict__ y,
         int64_t n_slots, int m, int n) {
  __shared__ Smem<T, Q> sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int q0 = b * Smem<T, Q>::QB;
  const int64_t s0 = static_cast<int64_t>(b) * kBlockSlots;
  T v[kSlots];
  int c[kSlots];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int64_t s = s0 + g * kThreads * 4 + tid * 4;
    if (s + 4 <= n_slots) {
      load4(vals + s, v + 4 * g);
      const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + s));
      c[4 * g] = cc.x; c[4 * g + 1] = cc.y; c[4 * g + 2] = cc.z; c[4 * g + 3] = cc.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = s + k < n_slots;
        v[4 * g + k] = in ? vals[s + k] : T(0);
        c[4 * g + k] = in ? cols[s + k] : -1;
      }
    }
  }
  const int lo = __ldg(blk_lo + b);
  const int hi = min(__ldg(blk_lo + b + 1), m);
  const int r0 = first_row(lo);
  int a0 = 0, e0 = 0;
  if (r0 < hi) {
    a0 = __ldg(qptr + r0);
    e0 = __ldg(qptr + r0 + 1);
  }
  for (int i = tid; i < Smem<T, Q>::QB; i += kThreads) sm.head[i] = 0;
  T xv[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    xv[j] = static_cast<unsigned>(c[j]) < static_cast<unsigned>(n) ? __ldg(x + c[j]) : T(0);
  __syncthreads();
  mark_heads(sm, qptr, q0, lo, hi, r0, a0);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int ls = g * kThreads * 4 + tid * 4;
    const T p0 = mul_rn(v[4 * g], xv[4 * g]), p1 = mul_rn(v[4 * g + 1], xv[4 * g + 1]);
    const T p2 = mul_rn(v[4 * g + 2], xv[4 * g + 2]), p3 = mul_rn(v[4 * g + 3], xv[4 * g + 3]);
    if (Q == 2) {
      sm.val[ls / 2] = add_rn(p0, p1);
      sm.val[ls / 2 + 1] = add_rn(p2, p3);
    } else {
      T s = add_rn(add_rn(p0, p1), add_rn(p2, p3));
#pragma unroll
      for (int off = 1; 4 * off < Q; off <<= 1) s = add_rn(s, __shfl_xor_sync(kFull, s, off));
      if (ls % Q == 0) sm.val[ls / Q] = s;
    }
  }
  __syncthreads();
  finish_block(sm, qptr, carry, y, b, hi, r0, a0, e0);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
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
// Block t of slots into stage s, completing on bar[s].
template <class T>
__device__ __forceinline__ void issue(const T* vals, const int* cols, T* st_vals,
                                      int* st_cols, uint64_t* bar, int t, int s) {
  const unsigned vb = kBlockSlots * sizeof(T), cb = kBlockSlots * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar + s)), "r"(vb + cb) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(st_vals + s * kBlockSlots)), "l"(vals + static_cast<int64_t>(t) * kBlockSlots),
                  "r"(vb), "r"(smem_addr(bar + s)) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(st_cols + s * kBlockSlots)), "l"(cols + static_cast<int64_t>(t) * kBlockSlots),
                  "r"(cb), "r"(smem_addr(bar + s)) : "memory");
}

template <class T, int Q, int S>
__global__ void __launch_bounds__(kThreads, 1)
ring(const T* __restrict__ vals, const int* __restrict__ cols,
     const int* __restrict__ qptr, const int* __restrict__ blk_lo,
     const T* __restrict__ x, T* __restrict__ carry, T* __restrict__ y,
     int nb, int m, int n) {
  extern __shared__ __align__(128) unsigned char dsm[];
  T* st_vals = reinterpret_cast<T*>(dsm);
  int* st_cols = reinterpret_cast<int*>(dsm + S * kBlockSlots * sizeof(T));
  __shared__ __align__(8) uint64_t bar[S];
  __shared__ Smem<T, Q> sm;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S; ++s)
      if (blockIdx.x + s * gridDim.x < nb) issue(vals, cols, st_vals, st_cols, bar, blockIdx.x + s * gridDim.x, s);
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % S;
    const int q0 = b * Smem<T, Q>::QB;
    const int lo = __ldg(blk_lo + b);
    const int hi = min(__ldg(blk_lo + b + 1), m);
    const int r0 = first_row(lo);
    int a0 = 0, e0 = 0;
    if (r0 < hi) {
      a0 = __ldg(qptr + r0);
      e0 = __ldg(qptr + r0 + 1);
    }
    for (int i = tid; i < Smem<T, Q>::QB; i += kThreads) sm.head[i] = 0;
    mbar_wait(bar + s, (it / S) & 1);
    T v[kSlots];
    T xv[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      v[j] = st_vals[s * kBlockSlots + j * kThreads + tid];
      const int c = st_cols[s * kBlockSlots + j * kThreads + tid];
      xv[j] = static_cast<unsigned>(c) < static_cast<unsigned>(n) ? __ldg(x + c) : T(0);
    }
    // the stage is read: refill it. The fence orders the reads (generic
    // proxy) before the bulk copy's writes (async proxy); without it the
    // copy overwrote slots still being read.
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid == 0 && b + S * gridDim.x < nb)
      issue(vals, cols, st_vals, st_cols, bar, b + S * gridDim.x, s);
    mark_heads(sm, qptr, q0, lo, hi, r0, a0);
    quantum_sums(sm, v, xv);
    __syncthreads();
    finish_block(sm, qptr, carry, y, b, hi, r0, a0, e0);
    __syncthreads();                       // before the next block's writes
  }
}

template <class T, int Q, int S>
int launch_ring(const T* v, const int* c, const int* qp, const int* bl, const T* xx, T* cr,
                T* yy, int nb, int m, int n, cudaStream_t st) {
  const int smem = S * kBlockSlots * static_cast<int>(sizeof(T) + 4);
  int err = static_cast<int>(cudaFuncSetAttribute(
      ring<T, Q, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring<T, Q, S>, kThreads, smem);
  ring<T, Q, S><<<min(nb, nsm * max(per_sm, 1)), kThreads, smem, st>>>(v, c, qp, bl, xx, cr, yy, nb, m, n);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int Q>
int launch(int design, const T* v, const int* c, const int* qp, const int* bl, const T* xx,
           T* cr, T* yy, int nb, int64_t n_slots, int m, int n, cudaStream_t st) {
  if (design == 0) {
    groups16<T, Q><<<nb, kThreads, 0, st>>>(v, c, qp, bl, xx, cr, yy, n_slots, m, n);
    return static_cast<int>(cudaGetLastError());
  }
  return design == 1 ? launch_ring<T, Q, 2>(v, c, qp, bl, xx, cr, yy, nb, m, n, st)
                     : launch_ring<T, Q, 4>(v, c, qp, bl, xx, cr, yy, nb, m, n, st);
}

template <class T>
int study(int design, const void* vals, const void* cols, const void* qptr, const void* blk_lo,
          const void* x, void* carry, void* y, int nb, int64_t n_slots, int m, int n,
          int quantum, cudaStream_t st) {
  const T* v = static_cast<const T*>(vals);
  const int* c = static_cast<const int*>(cols);
  const int* qp = static_cast<const int*>(qptr);
  const int* bl = static_cast<const int*>(blk_lo);
  const T* xx = static_cast<const T*>(x);
  T* cr = static_cast<T*>(carry);
  T* yy = static_cast<T*>(y);
  if (nb > 0) {
    int err;
    switch (quantum) {
      case 2: err = launch<T, 2>(design, v, c, qp, bl, xx, cr, yy, nb, n_slots, m, n, st); break;
      case 4: err = launch<T, 4>(design, v, c, qp, bl, xx, cr, yy, nb, n_slots, m, n, st); break;
      case 8: err = launch<T, 8>(design, v, c, qp, bl, xx, cr, yy, nb, n_slots, m, n, st); break;
      case 16: err = launch<T, 16>(design, v, c, qp, bl, xx, cr, yy, nb, n_slots, m, n, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return launch_finish(qp, cr, yy, m, quantum, st);
}

}  // namespace

// design 0: groups16; 1: ring<2>; 2: ring<4> (vals and cols padded to
// nb * 2048 slots for the rings). Arguments as csrc/pell_rows.cu's.
extern "C" int rows_study(int design, const void* vals, const void* cols,
                          const void* qptr, const void* blk_lo, const void* x,
                          void* carry, void* y, int nb, int64_t n_slots, int m,
                          int n, int quantum, int fp64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp64 ? study<double>(design, vals, cols, qptr, blk_lo, x, carry, y, nb, n_slots, m, n, quantum, st)
              : study<float>(design, vals, cols, qptr, blk_lo, x, carry, y, nb, n_slots, m, n, quantum, st);
}

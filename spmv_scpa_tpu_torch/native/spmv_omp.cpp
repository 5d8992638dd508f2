// Host-parallel OpenMP SpMV kernels — the native CPU backend.
//
// Re-implements the reference's OpenMP strategy family
// (src/csr.c:218-339, src/hll.c:178-211) as a ctypes-loadable shared
// library: the framework's Python layer owns formats and orchestration;
// this file owns only the OpenMP hot loops.
//
//  * spmv_csr_serial      — golden row loop      (csr.c:201-216)
//  * spmv_csr_omp_guided  — schedule(guided)     (csr.c:278-298)
//  * spmv_csr_omp_nnz     — static nnz-balanced spans; the caller
//                           passes the per-thread row bounds computed
//                           by the Python partitioner
//                           (formats/csr.py:partition_rows_by_nnz,
//                           itself the csr.c:218-276 planner)
//  * spmv_ell_omp         — ELL-slice blocks, one slice per task
//                           (hll.c:178-211; slice-major col layout)
//
// All arrays are caller-allocated NumPy buffers (int64 irp for >2^31
// nnz safety — the reference's int overflow risk at csr.c:153 is fixed
// on the Python side too).
//
// A copy of the JAX package's native/spmv_omp.cpp (comments aside),
// built on first use by spmv_scpa_tpu_torch/_kernels.py:build_native
// with the flags of the JAX package's native/Makefile (so both builds
// compute the same bits) and loaded by
// spmv_scpa_tpu_torch/ops/native_omp.py.

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static void omp_set_num_threads(int) {}
#endif

extern "C" {

void spmv_csr_serial(int64_t m, const int64_t *irp, const int32_t *ja,
                     const double *as, const double *x, double *y) {
    for (int64_t r = 0; r < m; ++r) {
        double acc = 0.0;
        for (int64_t k = irp[r]; k < irp[r + 1]; ++k)
            acc += as[k] * x[ja[k]];
        y[r] = acc;
    }
}

void spmv_csr_omp_guided(int64_t m, const int64_t *irp, const int32_t *ja,
                         const double *as, const double *x, double *y,
                         int nthreads) {
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(guided)
    for (int64_t r = 0; r < m; ++r) {
        double acc = 0.0;
        for (int64_t k = irp[r]; k < irp[r + 1]; ++k)
            acc += as[k] * x[ja[k]];
        y[r] = acc;
    }
}

// bounds: (nparts+1,) row spans from the nnz-balanced planner; each
// OpenMP thread owns span t (csr.c:305-339 semantics).
void spmv_csr_omp_nnz(int64_t m, const int64_t *irp, const int32_t *ja,
                      const double *as, const double *x, double *y,
                      const int64_t *bounds, int nparts) {
    (void)m;
    omp_set_num_threads(nparts);
#pragma omp parallel for schedule(static, 1)
    for (int t = 0; t < nparts; ++t) {
        for (int64_t r = bounds[t]; r < bounds[t + 1]; ++r) {
            double acc = 0.0;
            for (int64_t k = irp[r]; k < irp[r + 1]; ++k)
                acc += as[k] * x[ja[k]];
            y[r] = acc;
        }
    }
}

// ELL slices (the HLL analog): num_slices blocks of slice_h rows, each
// padded to its own width[s]; ja/as are col-major within a slice
// (lane-contiguous, hll.c:84-85) with offsets[s] giving the slice
// start. Padding slots carry ja = last-valid-column and as = 0.0 (the
// dummy-read trick, cuda_hll.cu:176-195) so the loop is branch-free.
void spmv_ell_omp(int64_t m, int64_t slice_h, int64_t num_slices,
                  const int64_t *offsets, const int32_t *widths,
                  const int32_t *ja, const double *as, const double *x,
                  double *y, int nthreads) {
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(guided)
    for (int64_t s = 0; s < num_slices; ++s) {
        int64_t r0 = s * slice_h;
        int64_t rows = (r0 + slice_h <= m) ? slice_h : (m - r0);
        int64_t off = offsets[s];
        int32_t w = widths[s];
        for (int64_t i = 0; i < rows; ++i) {
            double acc = 0.0;
            for (int32_t j = 0; j < w; ++j) {
                int64_t idx = off + (int64_t)j * rows + i;
                acc += as[idx] * x[ja[idx]];
            }
            y[r0 + i] = acc;
        }
    }
}

int omp_max_threads() { return omp_get_max_threads(); }

}  // extern "C"

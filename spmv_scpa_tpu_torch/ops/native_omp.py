"""ctypes bindings to the native OpenMP SpMV kernels (counterpart of
``spmv_scpa_tpu/ops/native_omp.py``): the host-parallel backend.

The reference study's OpenMP strategy family (csr.c:218-339,
hll.c:178-211) as real C++/OpenMP code (``native/spmv_omp.cpp``, the
JAX package's source copied), swept over thread counts by the runner
(main.c:177-180). Built by g++ on first use into ``_build/``
(``_kernels.build_native``), with the JAX package's flags, so both
packages' kernels compute the same bits. A host with few cores runs and
logs the sweep; it cannot show a speedup.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import CSR, partition_rows_by_nnz

_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_kernels.build_native("spmv_omp")))
    except _kernels.BUILD_ERRORS:
        return None
    lib.spmv_csr_serial.argtypes = [ctypes.c_int64, _I64P, _I32P, _F64P,
                                    _F64P, _F64P]
    lib.spmv_csr_omp_guided.argtypes = lib.spmv_csr_serial.argtypes + [
        ctypes.c_int]
    lib.spmv_csr_omp_nnz.argtypes = lib.spmv_csr_serial.argtypes + [
        _I64P, ctypes.c_int]
    lib.spmv_ell_omp.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I64P, _I32P,
        _I32P, _F64P, _F64P, _F64P, ctypes.c_int]
    lib.omp_max_threads.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def max_threads() -> int:
    lib = _load()
    return int(lib.omp_max_threads()) if lib else 1


def _x(x, n: int) -> np.ndarray:
    """x as the contiguous float64 (n,) buffer the kernels read."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.shape != (n,):
        raise ValueError(f"native OpenMP SpMV: x has shape {x.shape}, "
                         f"expected ({n},)")
    return x


def _csr_bufs(A: CSR):
    irp = np.ascontiguousarray(A.irp, dtype=np.int64)
    ja = np.ascontiguousarray(A.ja, dtype=np.int32)
    as_ = np.ascontiguousarray(A.as_, dtype=np.float64)
    return irp, ja, as_


def make_csr_serial(A: CSR):
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)

    def fn(x):
        x = _x(x, A.n)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_serial(A.m, irp.ctypes.data_as(_I64P),
                            ja.ctypes.data_as(_I32P),
                            as_.ctypes.data_as(_F64P),
                            x.ctypes.data_as(_F64P),
                            y.ctypes.data_as(_F64P))
        return y

    return fn


def make_csr_omp_guided(A: CSR, nthreads: int = 0):
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)

    def fn(x):
        x = _x(x, A.n)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_omp_guided(A.m, irp.ctypes.data_as(_I64P),
                                ja.ctypes.data_as(_I32P),
                                as_.ctypes.data_as(_F64P),
                                x.ctypes.data_as(_F64P),
                                y.ctypes.data_as(_F64P), nthreads)
        return y

    return fn


def make_csr_omp_nnz(A: CSR, nthreads: int):
    """Static nnz-balanced spans (csr.c:218-276 planner + 305-339
    kernel); the Python partitioner plans, C++ executes."""
    lib = _load()
    irp, ja, as_ = _csr_bufs(A)
    bounds = np.ascontiguousarray(
        partition_rows_by_nnz(A.irp, max(nthreads, 1)), dtype=np.int64)
    nparts = bounds.shape[0] - 1

    def fn(x):
        x = _x(x, A.n)
        y = np.empty(A.m, dtype=np.float64)
        lib.spmv_csr_omp_nnz(A.m, irp.ctypes.data_as(_I64P),
                             ja.ctypes.data_as(_I32P),
                             as_.ctypes.data_as(_F64P),
                             x.ctypes.data_as(_F64P),
                             y.ctypes.data_as(_F64P),
                             bounds.ctypes.data_as(_I64P), nparts)
        return y

    return fn


def make_ell_omp(E, nthreads: int = 0):
    """ELL-slice OpenMP kernel (hll.c:178-211); ``E`` is a
    ``formats.ell.EllSlices``, col-major layout with pad_mode='last'
    (branch-free dummy reads, cuda_hll.cu:176-195)."""
    if not (E.col_major and E.pad_mode == "last"):
        raise ValueError("spmv_ell_omp needs col-major 'last'-padded "
                         "slices")
    lib = _load()
    offsets = np.ascontiguousarray(E.offs, dtype=np.int64)
    widths = np.ascontiguousarray(E.max_nz, dtype=np.int32)
    ja = np.ascontiguousarray(E.ja_flat, dtype=np.int32)
    as_ = np.ascontiguousarray(E.as_flat, dtype=np.float64)

    def fn(x):
        x = _x(x, E.n)
        y = np.zeros(E.m, dtype=np.float64)
        lib.spmv_ell_omp(E.m, E.slice_h, E.num_slices,
                         offsets.ctypes.data_as(_I64P),
                         widths.ctypes.data_as(_I32P),
                         ja.ctypes.data_as(_I32P),
                         as_.ctypes.data_as(_F64P),
                         x.ctypes.data_as(_F64P),
                         y.ctypes.data_as(_F64P), nthreads)
        return y

    return fn

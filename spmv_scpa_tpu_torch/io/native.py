"""ctypes binding to the native C++ Matrix Market payload parser
(counterpart of ``spmv_scpa_tpu/io/native.py``).

Python keeps all format semantics (``mmio.py`` parses and validates the
header); the C++ library (``native/mtx_parser.cpp``, the JAX package's
source copied) only runs the entry loop, the part the reference study
spends its wall-clock on (two fscanf passes, csr.c:68-146). It is built
by g++ on first use into ``_build/`` (``_kernels.build_native``); when
g++ or the build fails, :func:`available` is False and ``load_csr``'s
auto mode reads with the NumPy parser.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.errors import MatrixFormatError
from spmv_scpa_tpu_torch.io import mmio

# Files parsed by read_mtx in this process.
PARSES = 0

_lib = None
_tried = False


def _load():
    """Load (building on first use) the parser library; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_kernels.build_native("mtx_parser")))
    except _kernels.BUILD_ERRORS:
        return None
    lib.mtx_parse_entries.restype = ctypes.c_int64
    lib.mtx_parse_entries.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_mtx(path) -> mmio.COOMatrix:
    """Native-accelerated equivalent of ``mmio.read``. Raises if the
    native library is unavailable (callers fall back to ``mmio.read``)."""
    global PARSES
    lib = _load()
    if lib is None:
        raise RuntimeError("native mtx parser not available")

    with open(path, "rb") as f:
        text = f.read()
    banner, nrows, ncols, nnz, payload = mmio._split_header(text)

    if banner.format != "coordinate":
        raise MatrixFormatError(
            "dense 'array' Matrix Market files are not supported "
            "(reference accepts only sparse input, csr.c:48-52)")
    if banner.field == "complex":
        raise MatrixFormatError(
            "complex matrices are not supported "
            "(reference accepts real/pattern only, csr.c:48-52)")

    k = 2 if banner.field == "pattern" else 3
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz if k == 3 else 0, dtype=np.float64)
    got = lib.mtx_parse_entries(
        payload, len(payload), k, nnz,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if k == 3 else None)
    PARSES += 1
    if got < 0:
        raise MatrixFormatError(
            f"trailing tokens after {nnz} entries in {path}")
    if got != nnz:
        raise MatrixFormatError(
            f"file truncated/malformed: parsed {got}/{nnz} entries "
            f"in {path}")
    return mmio.COOMatrix(banner, nrows, ncols, rows - 1, cols - 1,
                          vals if k == 3 else None)

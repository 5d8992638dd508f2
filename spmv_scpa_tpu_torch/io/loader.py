"""Matrix loading: ``.mtx`` file -> CSR with the reference study's
semantics (counterpart of ``spmv_scpa_tpu/io/loader.py``, copied):

* symmetric matrices are expanded to both triangles, diagonal entries
  not duplicated (csr.c:91-94, 141-145);
* pattern matrices get value 1.0 (csr.c:70-75);
* out-of-bounds coordinates are an error (csr.c:84-87);
* sparse real/pattern/integer input only (csr.c:48-52);
* the name is the basename without ``.mtx`` (csr.c:18-30).

The native C++ parser (``io/native.py``) reads the file where its
library builds, else the NumPy parser (``io/mmio.py``); both give the
same arrays.
"""

from __future__ import annotations

import os

import numpy as np

from spmv_scpa_tpu_torch.errors import (MatrixBoundsError, MatrixFormatError,
                                       SpmvError)
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.io import mmio, native


def extract_matrix_name(path: str) -> str:
    """Basename minus a trailing ``.mtx`` (csr.c:18-30)."""
    base = os.path.basename(str(path))
    if base.endswith(".mtx"):
        base = base[: -len(".mtx")]
    return base


def load_csr(path, name: str | None = None,
             use_native: bool | None = None) -> CSR:
    """Load a Matrix Market file into CSR with the reference study's
    expansion semantics. ``use_native`` selects the C++ parser: None
    tries it and falls back to NumPy, True raises where it fails."""
    coo = None
    if use_native is not False:
        try:
            coo = native.read_mtx(path)
        except (RuntimeError, OSError, SpmvError):
            if use_native:  # explicitly requested
                raise
    if coo is None:
        coo = mmio.read(path)
    banner = coo.banner
    if banner.symmetry in ("skew-symmetric", "hermitian"):
        raise MatrixFormatError(
            f"unsupported symmetry {banner.symmetry!r} "
            "(reference accepts general/symmetric, csr.c:48-52)")

    row, col = coo.row, coo.col
    if row.size:
        if row.min() < 0 or col.min() < 0 or \
           row.max() >= coo.nrows or col.max() >= coo.ncols:
            raise MatrixBoundsError(
                f"entry out of bounds for {coo.nrows}x{coo.ncols} matrix "
                "(reference: csr.c:84-87)")

    val = np.ones(row.shape[0], dtype=np.float64) if coo.val is None \
        else coo.val

    if banner.is_symmetric:
        off = row != col
        row = np.concatenate([row, col[off]])
        col = np.concatenate([col, coo.row[off]])
        val = np.concatenate([val, val[off]])

    return CSR.from_coo(name or extract_matrix_name(path),
                        coo.nrows, coo.ncols, row, col, val)

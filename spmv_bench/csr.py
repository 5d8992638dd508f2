"""The benchmark's own CSR arrays: a frozen copy of the port's
``CSR.from_coo`` construction (``spmv_scpa_tpu_torch/formats/csr.py``),
so that a later change to the port cannot move the matrices the
benchmark measures. Imports nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Matrix:
    """A sparse matrix as CSR arrays: ``irp`` (m + 1,) row pointers,
    ``ja`` (nnz,) column indices sorted within each row, ``vals`` (nnz,)
    float64."""

    name: str
    m: int
    n: int
    irp: np.ndarray
    ja: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.ja.shape[0])


def from_coo(name: str, m: int, n: int, row, col, val) -> Matrix:
    """CSR from 0-based COO triples, sorted by (row, col), duplicates
    kept; int32 indices unless nnz or the shape needs int64."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float64)
    key = row * n + col
    if not np.all(key[1:] >= key[:-1]):
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
    irp = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=m), out=irp[1:])
    small = val.shape[0] < 2**31 and n < 2**31 and m < 2**31
    idx = np.int32 if small else np.int64
    return Matrix(name, m, n, irp.astype(idx), col.astype(idx),
                  np.ascontiguousarray(val))

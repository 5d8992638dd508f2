"""Compressed Sparse Row format, host side (counterpart of
``spmv_scpa_tpu/formats/csr.py``, whose ``CSR`` this copies).

The reference study's ``sparse_csr`` struct (``include/csr.h:7-13``:
``{name, M, N, NZ, IRP[M+1], JA[NZ], AS[NZ]}``) as NumPy arrays. Every
packer of the port reads it on the host and ships padded derivatives to
the card.

``BC`` is the lane width of every panel format of the port: 128 rows
(or columns) per panel, the width the packed arrays keep so that they
equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

BC = 128


@dataclass
class CSR:
    """CSR matrix, host-side. Indices int32 unless nnz or the shape
    demands int64."""

    name: str
    m: int
    n: int
    irp: np.ndarray  # (m+1,) row pointers
    ja: np.ndarray   # (nnz,) column indices
    as_: np.ndarray  # (nnz,) values, float64 on host
    # Whether (ja) is sorted within each row. The loader guarantees it.
    sorted_cols: bool = field(default=True)

    @property
    def nnz(self) -> int:
        return int(self.ja.shape[0])

    def __post_init__(self):
        self.irp = np.ascontiguousarray(self.irp)
        self.ja = np.ascontiguousarray(self.ja)
        self.as_ = np.ascontiguousarray(self.as_, dtype=np.float64)
        if self.irp.shape != (self.m + 1,):
            raise ValueError(f"CSR {self.name}: irp has shape "
                             f"{self.irp.shape}, expected ({self.m + 1},)")
        if self.irp[0] != 0 or self.irp[-1] != self.ja.shape[0]:
            raise ValueError(f"CSR {self.name}: irp must run from 0 to nnz")

    @classmethod
    def from_coo(cls, name: str, m: int, n: int, row, col, val,
                 sum_duplicates: bool = False) -> "CSR":
        """Build CSR from 0-based COO triples, sorted by (row, col).
        Duplicates are kept unless ``sum_duplicates``, as the reference
        study keeps them (csr.c:68-146)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        if sum_duplicates and row.size:
            key_same = (row[1:] == row[:-1]) & (col[1:] == col[:-1])
            if key_same.any():
                seg = np.concatenate([[0], np.cumsum(~key_same)])
                nseg = int(seg[-1]) + 1
                out_val = np.zeros(nseg, dtype=np.float64)
                np.add.at(out_val, seg, val)
                first = np.concatenate([[True], ~key_same])
                row, col, val = row[first], col[first], out_val
        irp = np.zeros(m + 1, dtype=np.int64)
        np.add.at(irp, row + 1, 1)
        np.cumsum(irp, out=irp)
        small = val.shape[0] < 2**31 and n < 2**31 and m < 2**31
        idx_dtype = np.int32 if small else np.int64
        return cls(name=name, m=m, n=n, irp=irp.astype(idx_dtype),
                   ja=col.astype(idx_dtype), as_=val)

    @classmethod
    def from_dense(cls, name: str, dense: np.ndarray) -> "CSR":
        dense = np.asarray(dense, dtype=np.float64)
        row, col = np.nonzero(dense)
        return cls.from_coo(name, dense.shape[0], dense.shape[1],
                            row, col, dense[row, col])

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float64)
        rows = np.repeat(np.arange(self.m), np.diff(self.irp))
        np.add.at(out, (rows, self.ja), self.as_)
        return out

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.irp)

    def row_ids(self) -> np.ndarray:
        """Per-nonzero row index (the segment ids for segment-sum SpMV)."""
        return np.repeat(np.arange(self.m, dtype=self.ja.dtype),
                         np.diff(self.irp))

    def slice_rows(self, r0: int, r1: int, name: str | None = None) -> "CSR":
        """Extract the row block [r0, r1) as its own CSR (columns keep
        global ids): the shard extraction step for distributed SpMV."""
        lo, hi = int(self.irp[r0]), int(self.irp[r1])
        irp = (self.irp[r0:r1 + 1] - lo).astype(self.irp.dtype)
        return CSR(name=name or f"{self.name}[{r0}:{r1}]",
                   m=r1 - r0, n=self.n,
                   irp=irp, ja=self.ja[lo:hi], as_=self.as_[lo:hi].copy())

    def with_name(self, name: str) -> "CSR":
        return replace(self, name=name)


def partition_rows_by_nnz(irp: np.ndarray, num_parts: int) -> np.ndarray:
    """nnz-balanced contiguous row partition (the reference study's OpenMP
    planner ``partition_csr_rows``, csr.c:218-276): ``num_parts``
    contiguous spans of about ``nnz/num_parts`` nonzeros each. Where rows
    run out, the trailing spans are empty, so the result always has
    ``num_parts + 1`` boundaries: ``bounds[0] == 0``, ``bounds[-1] == m``,
    non-decreasing."""
    irp = np.asarray(irp, dtype=np.int64)
    m = irp.shape[0] - 1
    total = int(irp[-1])
    if num_parts <= 0:
        raise ValueError("num_parts must be positive")
    # each target's first row whose cumulative nnz reaches it
    targets = (np.arange(1, num_parts, dtype=np.float64) * total / num_parts)
    cut = np.searchsorted(irp[1:], targets, side="left") + 1
    bounds = np.concatenate([[0], cut, [m]]).astype(np.int64)
    return np.maximum.accumulate(bounds)

"""BCSR, block-compressed sparse rows of dense (8, 128) tiles, host
side (counterpart of ``spmv_scpa_tpu/formats/bcsr.py``, whose ``BCSR``
and ``csr_to_bcsr`` this copies; the tests hold the copy equal to it).

Only nonempty tiles are stored, with no per-nonzero index: ``cuda-bcsr``
streams 4 bytes per slot, which pays where tiles are well filled
(banded and FEM matrices).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu_torch.formats.csr import CSR


@dataclass
class BCSR:
    """Block CSR over (br x bc) tiles, row-block ordered.

    ``vals[t]`` is the dense tile; ``col_panel[t]`` its column-panel
    index (tile covers columns ``[col_panel[t]*bc, ...+bc)``);
    ``rowptr`` is a CSR index over block-rows: tiles of block-row ``i``
    are ``t in [rowptr[i], rowptr[i+1])``.
    """

    name: str
    m: int
    n: int
    nnz: int                # true nonzeros
    br: int
    bc: int
    vals: np.ndarray        # (T, br, bc) float (host: float64)
    col_panel: np.ndarray   # (T,) int32
    rowptr: np.ndarray      # (num_block_rows+1,) int32

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_block_rows(self) -> int:
        return int(self.rowptr.shape[0] - 1)

    @property
    def fill(self) -> float:
        return self.nnz / max(self.num_tiles * self.br * self.bc, 1)

    @property
    def padded_bytes(self) -> int:
        """HBM bytes streamed per SpMV for the tile values (f32)."""
        return self.num_tiles * self.br * self.bc * 4

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float64)
        for i in range(self.num_block_rows):
            r0 = i * self.br
            rh = min(self.br, self.m - r0)
            for t in range(int(self.rowptr[i]), int(self.rowptr[i + 1])):
                c0 = int(self.col_panel[t]) * self.bc
                cw = min(self.bc, self.n - c0)
                out[r0:r0 + rh, c0:c0 + cw] += self.vals[t, :rh, :cw]
        return out


def csr_to_bcsr(A: CSR, br: int = 8, bc: int = 128) -> BCSR:
    """Convert CSR to BCSR, keeping only nonempty tiles. Vectorized:
    one pass assigning each nonzero to its (block-row, panel) tile and
    a scatter into the dense tile stack. Duplicate coordinates
    accumulate (+=), consistent with CSR.to_dense."""
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    bi = rows // br
    pj = cols // bc
    key = bi * ((A.n + bc - 1) // bc) + pj
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, tile_of = np.unique(key_s, return_inverse=True)
    T = uniq.shape[0]
    vals = np.zeros((T, br, bc), dtype=np.float64)
    ri = (rows[order] % br).astype(np.int64)
    ci = (cols[order] % bc).astype(np.int64)
    np.add.at(vals, (tile_of, ri, ci), A.as_[order])
    npanels = (A.n + bc - 1) // bc
    tile_bi = (uniq // npanels).astype(np.int64)
    tile_pj = (uniq % npanels).astype(np.int32)
    nbr = (A.m + br - 1) // br
    rowptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(rowptr, tile_bi + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    return BCSR(name=A.name, m=A.m, n=A.n, nnz=A.nnz, br=br, bc=bc,
                vals=vals, col_panel=tile_pj,
                rowptr=rowptr.astype(np.int32))

"""ELLPACK slices — the TPU-native analog of the reference's HLL
("hacked ELLPACK") format, host side (counterpart of
``spmv_scpa_tpu/formats/ell.py``, whose ``EllSlices``, ``UniformEll``
and ``csr_to_ell`` this copies; the tests hold the copy equal to it).
The port's ``torch-ell-*`` baselines and ``oracle-ell`` read it.

Reference design (``include/hll.h:10-48``, ``src/hll.c:19-106``): the
matrix is cut into row blocks of ``HACK_SIZE = 32`` rows; each block is
an independent ELLPACK padded to that block's max row length, with
row-major (``JA[i*max_NZ+j]``, hll.c:87-88) or column-major
(``JA[j*blk_rows+i]``, hll.c:84-85) intra-block layout. Padding is
``JA = -1, AS = 0.0`` (hll.c:73-76); the CUDA uploader rewrites padding
columns to the row's last valid column so padded slots do in-bounds
dummy reads (cuda_hll.cu:172-195).

TPU re-design decisions:

* slice height defaults to 32 like the reference, but any multiple of 8
  (the f32 sublane count) works; the column-major layout puts the row
  index in the trailing (lane) dimension — the reference study found
  the coalesced column-major layout ~6.5x faster on GPU
  (SURVEY.md section 6) and the same lane-contiguity argument holds on
  the TPU VPU.
* the host format is a true HLL: per-slice max row length, blocks
  concatenated flat with per-slice offsets (SELL-C-style). Device
  consumers either take the flat layout (Pallas, via scalar prefetch)
  or a **uniform** padded ELL view (XLA, static shapes).
* padding mode ``"last"`` replicates the reference's in-bounds dummy
  read trick (cuda_hll.cu:176-195); ``"neg1"`` replicates the host
  format (hll.c:73-76). Default ``"last"`` — on TPU a padded slot
  gathers a real x entry and multiplies by 0.0, no masking needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu_torch.formats.csr import CSR

HACK_SIZE = 32  # reference default (hll.h:10)


@dataclass
class EllSlices:
    """HLL-analog: per-slice-padded ELLPACK blocks, flat-concatenated.

    For slice ``s`` covering rows ``[s*slice_h, min((s+1)*slice_h, m))``
    the block occupies ``ja_flat[offs[s]:offs[s+1]]`` reshaped to
    ``(rows_s, max_nz[s])`` (row-major) or ``(max_nz[s], rows_s)``
    (column-major), exactly the reference's two layouts.
    """

    name: str
    m: int
    n: int
    nnz: int                 # true nonzeros (excluding padding)
    slice_h: int
    col_major: bool
    pad_mode: str            # "last" | "neg1"
    max_nz: np.ndarray       # (num_slices,) per-slice max row length
    offs: np.ndarray         # (num_slices+1,) flat offsets (elements)
    ja_flat: np.ndarray      # (padded_total,) int32 column indices
    as_flat: np.ndarray      # (padded_total,) float64 values

    @property
    def num_slices(self) -> int:
        return int(self.max_nz.shape[0])

    @property
    def padded_nnz(self) -> int:
        return int(self.ja_flat.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of padded slots holding a real nonzero."""
        return self.nnz / max(self.padded_nnz, 1)

    def slice_rows(self, s: int) -> int:
        return min((s + 1) * self.slice_h, self.m) - s * self.slice_h

    def block(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        """Return (ja, as) of slice ``s`` shaped (rows, max_nz) row-major
        or (max_nz, rows) col-major — the ellpack_block view
        (hll.h:13-18)."""
        rows = self.slice_rows(s)
        k = int(self.max_nz[s])
        lo, hi = int(self.offs[s]), int(self.offs[s + 1])
        shape = (k, rows) if self.col_major else (rows, k)
        return (self.ja_flat[lo:hi].reshape(shape),
                self.as_flat[lo:hi].reshape(shape))

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float64)
        for s in range(self.num_slices):
            ja, as_ = self.block(s)
            if self.col_major:
                ja, as_ = ja.T, as_.T
            rows = np.arange(s * self.slice_h, s * self.slice_h + ja.shape[0])
            valid = as_ != 0.0
            if self.pad_mode == "neg1":
                valid = ja >= 0
            r = np.repeat(rows, ja.shape[1]).reshape(ja.shape)
            np.add.at(out, (r[valid], np.maximum(ja[valid], 0)), as_[valid])
        return out

    # ---- uniform padded view (XLA static shapes) -----------------------

    def to_uniform(self, lane_pad: int = 1) -> "UniformEll":
        """Pad every slice to the global max row length (rounded up to a
        multiple of ``lane_pad``) yielding dense (num_slices, ·, ·)
        arrays with static shape — the XLA-friendly ELL view."""
        k = int(self.max_nz.max(initial=0))
        k = max(1, -(-k // lane_pad) * lane_pad)
        ns, sh = self.num_slices, self.slice_h
        ja = np.zeros((ns, sh, k), dtype=np.int32)
        as_ = np.zeros((ns, sh, k), dtype=np.float64)
        for s in range(ns):
            bja, bas = self.block(s)
            if self.col_major:
                bja, bas = bja.T, bas.T
            rows, bk = bja.shape
            ja[s, :rows, :bk] = bja
            as_[s, :rows, :bk] = bas
            if self.pad_mode == "last" and bk:
                # extend the in-bounds dummy-read column into new padding
                ja[s, :rows, bk:] = bja[:, -1:]
        if self.pad_mode == "neg1":
            ja = np.maximum(ja, 0)  # uniform view always uses safe indices
        if self.col_major:
            ja = np.ascontiguousarray(ja.transpose(0, 2, 1))
            as_ = np.ascontiguousarray(as_.transpose(0, 2, 1))
        return UniformEll(name=self.name, m=self.m, n=self.n, nnz=self.nnz,
                          slice_h=sh, k=k, col_major=self.col_major,
                          ja=ja, as_=as_)


@dataclass
class UniformEll:
    """Statically-shaped ELL: one global pad width ``k``.

    Row-major: arrays (num_slices, slice_h, k); col-major:
    (num_slices, k, slice_h). All padded JA entries are safe (in-bounds)
    indices whose AS is 0.0.
    """

    name: str
    m: int
    n: int
    nnz: int
    slice_h: int
    k: int
    col_major: bool
    ja: np.ndarray
    as_: np.ndarray

    @property
    def num_slices(self) -> int:
        return int(self.ja.shape[0])


def csr_to_ell(A: CSR, slice_h: int = HACK_SIZE, col_major: bool = True,
               pad_mode: str = "last") -> EllSlices:
    """CSR → HLL-analog converter (reference: ``csr_to_hll``,
    hll.c:19-95), vectorized.

    Per slice of ``slice_h`` rows: pad each row to the slice's max row
    length. ``pad_mode="last"`` pads JA with the row's last valid column
    (cuda_hll.cu:176-195; empty rows use column 0) and AS with 0.0;
    ``pad_mode="neg1"`` pads JA with -1 (hll.c:73-76).
    """
    if pad_mode not in ("last", "neg1"):
        raise ValueError(f"bad pad_mode {pad_mode!r}")
    m = A.m
    num_slices = max(1, -(-m // slice_h))
    lens = A.row_lengths()
    max_nz = np.zeros(num_slices, dtype=np.int64)
    sizes = np.zeros(num_slices, dtype=np.int64)
    ja_parts: list[np.ndarray] = []
    as_parts: list[np.ndarray] = []
    for s in range(num_slices):
        r0, r1 = s * slice_h, min((s + 1) * slice_h, m)
        rows = r1 - r0
        k = int(lens[r0:r1].max(initial=0))
        k = max(k, 1)  # reference allocates max_NZ>=row lens; keep >=1 slot
        max_nz[s] = k
        sizes[s] = rows * k
        bja = np.zeros((rows, k), dtype=np.int32)
        bas = np.zeros((rows, k), dtype=np.float64)
        if pad_mode == "neg1":
            bja[:] = -1
        lo, hi = int(A.irp[r0]), int(A.irp[r1])
        rl = lens[r0:r1]
        # scatter row-by-row data into the padded block (vectorized)
        flat_rows = np.repeat(np.arange(rows), rl)
        within = np.arange(hi - lo) - np.repeat(A.irp[r0:r1] - lo, rl)
        bja[flat_rows, within] = A.ja[lo:hi]
        bas[flat_rows, within] = A.as_[lo:hi]
        if pad_mode == "last":
            # rows with fewer than k entries: replicate last valid column
            last_col = np.zeros(rows, dtype=np.int32)
            nz_rows = rl > 0
            bja_nz = bja[nz_rows]
            last_col[nz_rows] = bja_nz[np.arange(bja_nz.shape[0]),
                                       rl[nz_rows] - 1]
            pad_mask = np.arange(k)[None, :] >= rl[:, None]
            bja[pad_mask] = np.broadcast_to(last_col[:, None], (rows, k))[pad_mask]
        if col_major:
            bja = np.ascontiguousarray(bja.T)
            bas = np.ascontiguousarray(bas.T)
        ja_parts.append(bja.reshape(-1))
        as_parts.append(bas.reshape(-1))
    offs = np.zeros(num_slices + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    return EllSlices(name=A.name, m=m, n=A.n, nnz=A.nnz, slice_h=slice_h,
                     col_major=col_major, pad_mode=pad_mode,
                     max_nz=max_nz, offs=offs,
                     ja_flat=np.concatenate(ja_parts) if ja_parts else np.empty(0, np.int32),
                     as_flat=np.concatenate(as_parts) if as_parts else np.empty(0, np.float64))

"""PELL and BCSR on PyTorch and CUDA (counterpart of
``spmv_scpa_tpu/ops/pallas_kernels.py``: ``prepare_pell``,
``prepare_bcsr``, and ``_make_fused_spmv`` and ``_make_tile_spmv``,
which bind their kernels).

A PELL matrix is a stream of (8, 128) slot tiles (``formats/panel_ell.py``)
whose 128 lanes form quanta, each quantum feeding one 8-row block of y.
Three schemes, as in the reference:

* ``fused`` (the default): one kernel per call, :func:`pell_fused`,
  computes each quantum's partial and adds it into y; the partials
  never reach device memory. A grid step of ``chunk`` tiles may touch
  up to ``span_max`` windows of ``window_h`` row blocks.
* ``span``: :func:`pell_tiles` writes the partials (T*8, nq) and
  :func:`segsum_kernel.span_segsum` adds them into y; an epilogue step
  of ``chunk * epilogue_sub`` tiles may touch several windows.
* ``pure``: tiles padded so that every step stays in one window;
  :func:`pell_tiles`, then :func:`segsum_kernel.window_segsum`.

``row_sort`` (scattered matrices) first permutes rows within each
1024-row window, lane by lane, so that rows of similar length share an
8-row block; :func:`unpermute` undoes it on y. ``cuda-bcsr`` on
``layout="tiles"`` runs the tile kernel on dense (8, 128) tiles (no lane
index) with the window segment-sum. ``cuda-pell-fp64`` (the reference's
``prepare_pell_df64``) packs one panel per tile without the row sort
(:func:`plan_pell_fp64`) and runs :func:`pell_fused_fp64`, the fused
kernel in float64.

Layouts. ``prepare_pell`` and ``prepare_pell_fp64`` take ``layout``:
``"tiles"`` is all of the above, the reference's arrays; ``"auto"``
(the default) packs row quanta without panels (``ops/pell_rows.py``,
the kernels ``pell_rows`` and ``pell_rows_fp64``), which Hopper streams
at a fraction of the tiles' bytes, for the fused scheme and the fp64
grade, and the tiles for ``scheme="span"`` and ``"pure"``. The row
layout keeps the fp64 grade's refusals (the 2^24 row and x-pair
budgets), records the tile geometry knobs it has no use for in
``meta["tile_knobs"]``, and reads ``quantum`` as its row quantum (2,
4, 8 or 16). ``prepare_bcsr`` takes ``layout`` too: ``"auto"`` packs
the same tiles as bitmaps of their stored slots (``ops/bcsr_bits.py``,
the kernel ``bcsr_bits``), keeping the dense tiles' refusal and
recording ``chunk`` and ``window_h`` in ``meta["tile_knobs"]``;
``"tiles"`` is the reference's.

The host parts are JAX-free copies of the reference's and keep its
TPU-tuned choices (quantum, window, chunk, superpanel width and the
span bound), so the packed arrays and tables equal the reference's; the
parity tests compare them exactly. The reference's TPU-only arithmetic
knobs (bf16 split passes, MXU orientation, index width, panel dedup,
ablations) are accepted, recorded in ``meta["tpu_knobs"]`` when set,
and change nothing: the port computes in f32. Each kernel's wrapper
launches ``csrc/pell.cu`` (or ``csrc/segsum.cu``) on a CUDA tensor and
runs its plain PyTorch version on a CPU tensor.

Three branches of the reference's ``prepare_pell`` act on the columns:

* an x past ``x_vmem_budget`` (n above about 3.15M at the 12 MB
  default): on the tiles, the reference's column stripes
  (:func:`plan_striped`), one fused plan a stripe over the stripe's
  active row blocks, each stripe one :func:`pell_fused` launch on the
  view ``x[c0:c1]``, its y part added into y by a slice-add; the row
  layout reads x in place through ``__ldg`` at any n and needs none;
* ``split_shift`` (:func:`_dual_grid_remap`) and ``hot_cols``
  (:func:`_hot_column_remap`): host remaps that move column runs that
  straddle a panel and the most frequent columns into panels appended
  past n; on the tiles x is extended at each call (zeros to the panel
  multiple, then ``x[64:n]`` or ``x[hot_idx]``) and the kernels run on
  the extended column space. Both exist to pack (8-row block, panel)
  buckets, which the row layout does not have: it accepts both knobs,
  records them in ``meta["tile_knobs"]`` and computes the same y
  without them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.formats.bcsr import csr_to_bcsr
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.formats.panel_ell import (BR, DEFAULT_QUANTUM,
                                                   DEFAULT_WINDOW_H,
                                                   csr_to_pell)
from spmv_scpa_tpu_torch.ops import bcsr_bits
from spmv_scpa_tpu_torch.ops import pell_rows as prows
from spmv_scpa_tpu_torch.ops import segsum_kernel
from spmv_scpa_tpu_torch.ops.registry import (FP64_RTOL, Prepared,
                                              record_calls)
from spmv_scpa_tpu_torch.utils.platform import resolve_device

DEFAULT_CHUNK = 64           # tiles per grid step
X_VMEM_BUDGET = 12 << 20     # the reference's resident-x bound, for parity
SORT_WIN = 128   # 8-row blocks per row-sort window (1024 rows)
SMEM_MAX = 232_448           # shared memory a block may take on an H100

# The reference's TPU-only knobs of prepare_pell and their defaults.
TPU_KNOBS = {"precision_passes": 2, "epilogue_passes": 2,
             "epilogue_ncat": False, "idx_dtype": None, "dedup_max": 0,
             "wide": None, "diag": ""}
# The tile layout's geometry knobs, which the row layout has no use for.
TILE_KNOBS = ("chunk", "window_h", "epilogue_sub", "span_max", "row_sort",
              "panel_w", "g_max")
LAYOUTS = ("auto", "tiles")

# Launches of each CUDA kernel by its wrapper in this process.
LAUNCHES = {"pell_fused": 0, "pell_tiles": 0, "unpermute": 0,
            "pell_fused_fp64": 0}


# ---------------------------------------------------------------------------
# Host parts (copies of the reference's)
# ---------------------------------------------------------------------------

def _pad_tiles(arr: np.ndarray, t_pad: int, fill=0):
    if arr.shape[0] == t_pad:
        return arr
    pad = [(0, t_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def _window_pad_tiles(vals, panel, rowblk, window_h: int, chunk: int,
                      min_chunk: int | None = None,
                      num_win: int | None = None):
    """Insert dummy tiles so each row-block window's tile count is a
    multiple of ``chunk`` (tiles in row-block order, as BCSR's are);
    ``chunk`` shrinks by powers of two toward ``min_chunk`` while the
    padding wastes more than ~10%. Every window, empty ones included,
    gets at least one chunk of sentinel tiles. Returns (vals, panel,
    window, rbl, chunk)."""
    T = vals.shape[0]
    if rowblk.ndim == 1:
        rowblk = rowblk[:, None]
    nq = rowblk.shape[1]
    win_of = rowblk[:, 0] // window_h
    if num_win is None:
        num_win = int(win_of.max(initial=0)) + 1
    counts = np.zeros(num_win, dtype=np.int64)
    np.add.at(counts, win_of, 1)
    min_chunk = min_chunk or chunk
    while chunk > min_chunk:
        waste = int((-(-counts // chunk) * chunk - counts).sum())
        if waste <= 0.1 * max(T, 1):
            break
        chunk //= 2
    chunk = max(chunk, min_chunk)
    counts_pad = np.maximum(-(-counts // chunk) * chunk, chunk)
    base = np.zeros(num_win, dtype=np.int64)
    np.cumsum(counts_pad[:-1], out=base[1:])
    t_new = int(counts_pad.sum())
    within = np.arange(T) - (np.cumsum(counts) - counts)[win_of]
    pos = base[win_of] + within
    out_vals = np.zeros((t_new,) + vals.shape[1:], dtype=vals.dtype)
    out_panel = np.zeros(t_new, dtype=np.int32)
    out_rbl = np.full((t_new, nq), window_h, dtype=np.int32)
    out_vals[pos] = vals
    out_panel[pos] = panel
    out_rbl[pos] = rowblk - (win_of * window_h)[:, None]
    window = np.repeat(np.arange(num_win, dtype=np.int32), counts_pad)
    return out_vals, out_panel, window, out_rbl, chunk


def _span_of(window: np.ndarray, group: int) -> int:
    """Max number of windows any ``group``-tile step touches."""
    T = window.shape[0]
    if T == 0:
        return 1
    t_pad = -(-T // group) * group
    w = np.pad(window, (0, t_pad - T),
               constant_values=int(window.max(initial=0)))
    base = w[::group].astype(np.int64)
    return int((w.reshape(-1, group)[:, -1] - base).max(initial=0)) + 1


def auto_pell_params(A: CSR, *, quantum: int | str = "auto",
                     window_h: int | str = "auto",
                     panel_w: int | str = "auto",
                     row_sort: bool | str = "auto",
                     g_max: int | None = None,
                     chunk: int | str = "auto") -> dict:
    """The PELL tuning axes from (8-row block, 128-col panel) bucket
    statistics, with the reference's TPU-measured thresholds: dense
    buckets (>= 8 nnz each) keep quantum 16, one panel and windows of 48
    blocks; thin ones take quantum 8, superpanels of 4 panels, the row
    sort and chunk 256. Explicit values pass through."""
    avg_bucket = None
    if A.nnz and (quantum == "auto" or panel_w == "auto"
                  or row_sort == "auto" or window_h == "auto"
                  or g_max is None):
        npan1 = max(1, -(-A.n // BC))
        bkey = ((A.row_ids().astype(np.int64) // BR) * npan1
                + A.ja // BC)
        nb = np.unique(bkey).shape[0]
        avg_bucket = A.nnz / max(nb, 1)
    if quantum == "auto":
        quantum = (DEFAULT_QUANTUM if avg_bucket is None
                   or avg_bucket >= 8 else 8)
    if panel_w == "auto":
        panel_w = (1 if avg_bucket is None
                   or avg_bucket >= 2 * quantum else 4)
    if g_max is None:
        g_max = (4096 if avg_bucket is not None and avg_bucket < 8
                 else 2048)
    if window_h == "auto":
        window_h = (48 if avg_bucket is not None and avg_bucket >= 8
                    else DEFAULT_WINDOW_H)
    if row_sort == "auto":
        row_sort = (avg_bucket is not None
                    and avg_bucket < 1.6 * max(quantum, 8))
    if chunk == "auto":
        chunk = (256 if avg_bucket is not None and avg_bucket < 8
                 else 2 * DEFAULT_CHUNK)
    chunk = min(chunk, max(8, g_max // (BC // quantum)))
    return dict(quantum=quantum, window_h=window_h, panel_w=panel_w,
                row_sort=row_sort, g_max=g_max, chunk=chunk,
                avg_bucket=avg_bucket)


def _rank_sort_sigma(A: CSR):
    """Per-lane rank sort for scattered matrices: within each 1024-row
    window, the rows of lane i (row % 8 == i) are sorted by (ceil-log2
    length, median column) and block j takes the j-th of each lane, so
    blocks gather rows of similar length. A row keeps its lane, so the
    inverse is a per-lane block permutation (:func:`unpermute`).
    Returns (sigma, bsrc): sigma[old_row] = new_row, and bsrc[b, i] the
    window-local source block of destination (b, i)."""
    m = A.m
    mb_pad = -(-max(m, 1) // (SORT_WIN * BR)) * SORT_WIN
    m_pad = mb_pad * BR
    lens = np.zeros(m_pad, np.int64)
    lens[:m] = np.diff(A.irp)
    lenclass = np.zeros(m_pad, np.int64)
    nz = lens > 0
    lenclass[nz] = np.ceil(np.log2(lens[nz] + 1)).astype(np.int64)
    med = np.zeros(m_pad, np.int64)
    mid = np.minimum(A.irp[:-1] + np.maximum(lens[:m] // 2, 0),
                     np.maximum(A.irp[1:] - 1, A.irp[:-1]))
    if A.nnz:
        med[:m] = np.where(lens[:m] > 0,
                           A.ja[np.minimum(mid, A.nnz - 1)], 0)
    key = -lenclass * (1 << 34) + med
    k3 = key.reshape(-1, SORT_WIN, BR)            # (nwin, 128, 8)
    order = np.argsort(k3, axis=1, kind="stable")  # old block of rank j
    nwin = k3.shape[0]
    w_ix = np.arange(nwin)[:, None, None]
    i_ix = np.arange(BR)[None, None, :]
    old_rows = (w_ix * SORT_WIN + order) * BR + i_ix
    new_rows = (w_ix * SORT_WIN
                + np.arange(SORT_WIN)[None, :, None]) * BR + i_ix
    sigma = np.empty(m_pad, np.int64)
    sigma[old_rows.reshape(-1)] = new_rows.reshape(-1)
    bsrc = np.empty((nwin, SORT_WIN, BR), np.int32)
    j_ix = np.broadcast_to(np.arange(SORT_WIN)[None, :, None],
                           order.shape)
    np.put_along_axis(bsrc, order, j_ix.astype(np.int32), axis=1)
    return sigma[:m], bsrc.reshape(nwin * SORT_WIN, BR)


def _dual_grid_remap(A: CSR):
    """Relabel contiguous column runs that straddle a 128-column panel
    boundary into a second, 64-column-shifted panel grid appended past
    ``ceil(n/128)*128``, for a run group that fits one shifted panel
    whole (the reference's ``_dual_grid_remap``, pallas_kernels.py:1247).
    Runs are grouped by (8-row block, diagonal-normalised 64-column
    bucket of their start) and a group moves as one. At run time x is
    extended by its own copy ``x[64:n]``. Returns (remapped CSR, width
    of the shifted region, 0 when nothing moves)."""
    if A.n <= 64 or A.nnz == 0:
        return A, 0
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    brk = np.ones(A.nnz, dtype=bool)
    brk[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1] + 1)
    run_id = np.cumsum(brk) - 1
    nruns = int(run_id[-1]) + 1
    c0 = np.full(nruns, np.iinfo(np.int64).max)
    c1 = np.zeros(nruns, dtype=np.int64)
    np.minimum.at(c0, run_id, cols)
    np.maximum.at(c1, run_id, cols)
    r_row = np.zeros(nruns, dtype=np.int64)
    np.maximum.at(r_row, run_id, rows)
    gkey = (r_row // BR) * (2 * (A.n // 64 + 2)) \
        + (c0 - (r_row % BR)) // 64 + 1
    guniq, g_of = np.unique(gkey, return_inverse=True)
    ng = guniq.shape[0]
    gmin = np.full(ng, np.iinfo(np.int64).max)
    gmax = np.zeros(ng, dtype=np.int64)
    np.minimum.at(gmin, g_of, c0)
    np.maximum.at(gmax, g_of, c1)
    g_crosses = (gmin // BC) != (gmax // BC)
    g_fits = (gmin >= 64) & (((gmin - 64) // BC) == ((gmax - 64) // BC))
    move = (g_crosses & g_fits)[g_of]
    if not move.any():
        return A, 0
    n_pad = -(-A.n // BC) * BC
    sel = move[run_id]
    new_cols = cols.copy()
    new_cols[sel] = n_pad + (cols[sel] - 64)
    extra = A.n - 64
    A2 = CSR.from_coo(A.name, A.m, n_pad + extra, rows, new_cols, A.as_)
    return A2, extra


def _hot_column_remap(A: CSR, hot_cols: int, quantum: int):
    """Relabel the ``hot_cols`` most frequent columns (rounded down to a
    panel multiple, and trimmed to those of at least ``2 * quantum``
    entries) into virtual panels appended past ``ceil(n/128)*128`` (the
    reference's ``_hot_column_remap``, pallas_kernels.py:1309): a hub
    column otherwise puts one entry into thousands of (row block, panel)
    buckets, each padded to a quantum. At run time x is extended by
    ``x[hot_idx]``. Returns (remapped CSR, its n, hot_idx int32 or
    None)."""
    counts = np.zeros(A.n, dtype=np.int64)
    np.add.at(counts, A.ja, 1)
    k = min(hot_cols, A.n)
    k = max((k // BC) * BC, 0)
    if k == 0:
        return A, A.n, None
    hot_idx = np.argpartition(counts, -k)[-k:]
    hot_idx = hot_idx[np.argsort(-counts[hot_idx], kind="stable")]
    if counts[hot_idx[-1]] < 2 * quantum:
        keep = counts[hot_idx] >= 2 * quantum
        k = max((int(keep.sum()) // BC) * BC, 0)
        if k == 0:
            return A, A.n, None
        hot_idx = hot_idx[:k]
    n_pad = -(-A.n // BC) * BC
    col_map = np.arange(A.n, dtype=np.int64)
    col_map[hot_idx] = n_pad + np.arange(k)
    A2 = CSR.from_coo(A.name, A.m, n_pad + k, A.row_ids(),
                      col_map[A.ja], A.as_)
    return A2, n_pad + k, hot_idx.astype(np.int32)


# ---------------------------------------------------------------------------
# Host tables of _make_fused_spmv and _make_tile_spmv
# ---------------------------------------------------------------------------

@dataclass
class PellPlan:
    """One packed PELL or BCSR matrix, host side: the kernels' arrays and
    the segment-sum's tables, with the reference's values.

    ``kind`` is "fused" (:func:`pell_fused`) or "tiles" (:func:`pell_tiles`
    and then the segment-sum ``seg``, "span" or "window"). ``rbl`` is what
    the reference ships: (steps_pad, chunk*nq) global row blocks for the
    fused kernel, flat per-quantum global (span) or window-local (window)
    row blocks for the tiles; ``base`` the fused or span steps' first
    windows, or the window segment-sum's window per step. ``dtype`` is
    the grade: float64 for :func:`plan_pell_fp64`'s plans, which run
    :func:`pell_fused_fp64`."""

    kind: str
    m: int                   # rows of the packed matrix (row-sorted: padded)
    n: int
    m_orig: int
    quantum: int
    panel_w: int
    chunk: int
    vals: np.ndarray         # (T*8, 128) f32 (f64 at the fp64 grade)
    idx: np.ndarray | None   # (T*8, 128) int8 / int16, None for BCSR
    pan2: np.ndarray         # (steps_pad, chunk) int32
    rbl: np.ndarray
    base: np.ndarray         # int32
    span: int
    seg: str
    rows_per_step: int       # partial rows per segment-sum step
    h: int
    num_win: int
    bsrc: np.ndarray | None  # (mb_pad, 8) int32 when row-sorted
    meta: dict
    hbm_bytes: int
    dtype: torch.dtype = torch.float32
    # how x (n_orig,) grows into the packed column space before the
    # kernels read it, in order: (n before, None for the split grid's
    # x[64:n] or the hot columns' int32 ids) (:func:`extend_x`)
    extend: tuple = ()

    @property
    def steps(self) -> int:
        return self.vals.shape[0] // (self.chunk * BR)


@dataclass
class StripedPlan:
    """The reference's column stripes on the tiles: ``parts`` is one
    (fused :class:`PellPlan`, first column, end column, first row, rows
    kept) a stripe that holds entries; the stripe's plan covers its
    active row blocks only, y rows ``row0 .. row0 + keep``."""

    m: int
    n: int
    parts: list
    meta: dict
    hbm_bytes: int
    dtype: torch.dtype = torch.float32


def fused_tables(*, m: int, n: int, vals, lcol, panel, rbl, window,
                 window_h: int, chunk: int, panel_w: int = 1,
                 force_span: int | None = None,
                 force_tiles: int | None = None) -> dict:
    """The host part of the reference's ``_make_fused_spmv`` (the
    chunk_align=1 packing: window non-decreasing, no per-window padding):
    tiles padded to a chunk multiple, each step's first window ``base``,
    the span ``W``, and ``pan2``/``rbl2`` padded to 8-step blocks. The
    superpanel column stays one index (``lcol``, below 128*panel_w).
    ``force_tiles`` and ``force_span`` pin the padded tile count and the
    span to values shared by several row shards, so that their tables
    have one shape (``parallel/distributed.py``)."""
    if rbl.ndim == 1:
        rbl = rbl[:, None]
    nq = rbl.shape[1]
    if panel_w != 1 and lcol is None:
        raise ValueError(f"panel_w={panel_w} requires a gathered (lcol) "
                         "packing")
    T = vals.shape[0]
    t_pad = -(-T // chunk) * chunk
    if force_tiles is not None:
        if force_tiles < t_pad or force_tiles % chunk:
            raise ValueError(f"pell: force_tiles {force_tiles} is below "
                             f"{t_pad} tiles or not a multiple of {chunk}")
        t_pad = force_tiles
    if t_pad != T:
        vals = _pad_tiles(vals, t_pad)
        if lcol is not None:
            lcol = _pad_tiles(lcol, t_pad)
        panel = _pad_tiles(panel, t_pad)
        rbl = _pad_tiles(rbl, t_pad, fill=window_h)
        window = _pad_tiles(window, t_pad,
                            fill=int(window.max(initial=0)))
        T = t_pad
    p_rows = max(1, -(-(-(-n // BC)) // panel_w) * panel_w)
    if p_rows * BC * 4 > X_VMEM_BUDGET:
        raise ValueError(f"pell: x ({p_rows * BC * 4} B) exceeds the "
                         f"budget {X_VMEM_BUDGET} B")
    steps = T // chunk
    steps_pad = -(-steps // 8) * 8
    g = chunk * nq
    base = window[::chunk].astype(np.int64)
    W = int((window.reshape(-1, chunk)[:, -1] - base).max(initial=0)) + 1
    if force_span is not None:
        if force_span < W:
            raise ValueError(f"pell: force_span {force_span} is below the "
                             f"span {W}")
        W = force_span
    rbl_glob = window[:, None].astype(np.int64) * window_h + rbl
    rbl2 = np.zeros((steps_pad, g), np.int32)
    rbl2[:steps] = rbl_glob.reshape(steps, g)
    pan2 = np.zeros((steps_pad, chunk), np.int32)
    pan2[:steps] = panel.reshape(steps, chunk)
    mb = (m + BR - 1) // BR
    return dict(vals=vals, lcol=lcol, base=base.astype(np.int32), W=W,
                rbl2=rbl2, pan2=pan2, steps=steps,
                num_win=max(1, -(-mb // window_h)))


def tile_tables(*, m: int, n: int, vals, lcol, panel, rbl, window,
                window_h: int, chunk: int, scheme: str,
                epilogue_sub: int = 8) -> dict:
    """The host part of the reference's ``_make_tile_spmv``: for
    ``"span"`` one global pad to a multiple of ``chunk * epilogue_sub``
    tiles, each epilogue step's first window ``base``, the span and
    global row blocks; for ``"pure"`` the window of each step (the
    epilogue's step taking ``sub`` kernel steps while they stay in one
    window) and window-local row blocks. ``pan2`` as the fused one's."""
    if rbl.ndim == 1:
        rbl = rbl[:, None]
    nq = rbl.shape[1]
    mb = (m + BR - 1) // BR
    num_win = max(1, -(-mb // window_h))
    if scheme == "span":
        group = chunk * epilogue_sub
        T = vals.shape[0]
        t_pad = -(-T // group) * group
        if t_pad != T:
            vals = _pad_tiles(vals, t_pad)
            if lcol is not None:
                lcol = _pad_tiles(lcol, t_pad)
            panel = _pad_tiles(panel, t_pad)
            rbl = _pad_tiles(rbl, t_pad, fill=window_h)
            window = _pad_tiles(window, t_pad,
                                fill=int(window.max(initial=0)))
    T = vals.shape[0]
    if T % chunk:
        raise AssertionError(f"pell: {T} tiles are not a multiple of the "
                             f"chunk {chunk}")
    if scheme == "pure" and int(window.max(initial=0)) + 1 != num_win:
        raise AssertionError("pell: window ids must cover every window")
    p_rows = max(1, -(-n // BC))
    if p_rows * BC * 4 > X_VMEM_BUDGET:
        raise ValueError(f"pell: x ({p_rows * BC * 4} B) exceeds the "
                         f"budget {X_VMEM_BUDGET} B")
    if scheme == "span":
        base = window[::group].astype(np.int64)
        span = int((window.reshape(-1, group)[:, -1] - base).max(
            initial=0)) + 1
        rbl_ship = window[:, None].astype(np.int64) * window_h + rbl
        rows_per_step = group * BR
    else:
        win_of_step = window[::chunk]
        if not (window.reshape(-1, chunk) == win_of_step[:, None]).all():
            raise AssertionError("pell: steps not window-pure")
        rbl_ship = rbl
        sub = epilogue_sub
        while sub > 1 and (
                len(win_of_step) % sub != 0
                or not (win_of_step.reshape(-1, sub)
                        == win_of_step.reshape(-1, sub)[:, :1]).all()):
            sub //= 2
        base = win_of_step[::sub]
        span = 1
        rows_per_step = sub * chunk * BR
    steps = T // chunk
    steps_pad = -(-steps // 8) * 8
    pan2 = np.zeros((steps_pad, chunk), np.int32)
    pan2[:steps] = panel.reshape(steps, chunk)
    return dict(vals=vals, lcol=lcol, base=base.astype(np.int32),
                span=span, rbl=rbl_ship.reshape(-1).astype(np.int32),
                pan2=pan2, rows_per_step=rows_per_step, num_win=num_win)


def _idx_plane(lcol, T: int, panel_w: int):
    """The kernels' index plane: the column within the superpanel, int8
    for one panel, int16 for wider superpanels (the same 1 or 2 bytes
    per slot as the reference's lcol and strip planes)."""
    if lcol is None:
        return None
    return lcol.reshape(T * BR, BC).astype(np.int8 if panel_w == 1
                                           else np.int16)


@trace.span("pack.plan", fn="plan_pell")
def plan_pell(A: CSR, chunk: int | str = "auto",
              quantum: int | str = "auto", window_h: int | str = "auto",
              epilogue_sub: int = 4, hot_cols: int = 0,
              split_shift: bool = False, scheme: str = "auto",
              span_max: int = 8, x_vmem_budget: int = X_VMEM_BUDGET,
              row_sort: bool | str = "auto", panel_w: int | str = "auto",
              g_max: int | None = None,
              **knobs) -> PellPlan | StripedPlan:
    """Pack ``A`` as the reference's ``prepare_pell`` does (its knobs
    and defaults): resolve the tuning axes; an x past ``x_vmem_budget``
    goes to the column stripes (:func:`plan_striped`, which ignores the
    row sort and both remaps, as the reference does); else row-sort,
    apply ``split_shift`` (while x and its shifted copy stay under
    ``X_VMEM_BUDGET``) and then ``hot_cols``, choose the scheme (fused
    while some window size keeps every step within ``span_max`` windows,
    else pure), pack and build the scheme's tables."""
    if scheme not in ("auto", "fused", "span", "pure"):
        raise ValueError(f"pell: unknown scheme {scheme!r}")
    tpu = {k: knobs[k] for k in TPU_KNOBS
           if k in knobs and knobs[k] != TPU_KNOBS[k]}
    auto = auto_pell_params(A, quantum=quantum, window_h=window_h,
                            panel_w=panel_w, row_sort=row_sort,
                            g_max=g_max, chunk=chunk)
    quantum, window_h = auto["quantum"], auto["window_h"]
    panel_w, row_sort = auto["panel_w"], auto["row_sort"]
    if x_past_budget(A.n, x_vmem_budget):
        return plan_striped(A, x_vmem_budget, auto["chunk"], quantum,
                            window_h, span_max, tpu)
    m_orig = A.m
    bsrc = None
    if row_sort:
        sigma, bsrc = _rank_sort_sigma(A)
        A = CSR.from_coo(A.name, bsrc.shape[0] * BR, A.n,
                         sigma[A.row_ids()], A.ja, A.as_)
    # each remap appends a region past ceil(n/128)*128; the later one
    # sees the extended space
    extend = []
    if split_shift and 2 * 4 * (A.n + BC) < X_VMEM_BUDGET:
        n_before = A.n
        A, extra = _dual_grid_remap(A)
        if extra:
            extend.append((n_before, None))
    if hot_cols:
        n_before = A.n
        A, _, hot_idx = _hot_column_remap(A, hot_cols, quantum)
        if hot_idx is not None:
            extend.append((n_before, hot_idx))
    n_hot = 0 if not extend or extend[-1][1] is None \
        else int(extend[-1][1].shape[0])
    chunk = auto["chunk"]

    P = None
    use_scheme = scheme
    use_wh = window_h
    if scheme == "span" and panel_w != 1:
        panel_w = 1          # the tile kernel's scheme packs one panel
    if scheme in ("auto", "fused", "span"):
        # escalate window_h (coarser windows, smaller span) before
        # giving up the superpanels
        span = span_max + 1
        for wh_try in (window_h, 2 * window_h, 4 * window_h):
            P = csr_to_pell(A, quantum=quantum, window_h=wh_try,
                            chunk_align=1, min_chunk_align=1,
                            panel_w=panel_w)
            group = chunk if scheme != "span" else chunk * epilogue_sub
            span = _span_of(P.window, group)
            if span <= span_max:
                use_scheme = ("fused" if scheme in ("auto", "fused")
                              else "span")
                use_wh = wh_try
                break
        if span > span_max:
            if scheme != "auto":
                raise ValueError(
                    f"cuda-pell: a grid step would span {span} > "
                    f"{span_max} windows; use scheme='pure', a larger "
                    "window_h, or raise span_max")
            use_scheme, P, panel_w = "pure", None, 1
    if P is None:
        panel_w = 1
        P = csr_to_pell(A, quantum=quantum, window_h=window_h,
                        chunk_align=chunk * epilogue_sub,
                        min_chunk_align=chunk)
    vals = P.vals.astype(np.float32)
    if use_scheme == "fused":
        t = fused_tables(m=A.m, n=A.n, vals=vals, lcol=P.lcol,
                         panel=P.panel, rbl=P.rbl, window=P.window,
                         window_h=use_wh, chunk=chunk, panel_w=P.panel_w)
        kind, seg, span_used, rps, base, rbl = (
            "fused", "span", t["W"], chunk * BR, t["base"], t["rbl2"])
    else:
        t = tile_tables(m=A.m, n=A.n, vals=vals, lcol=P.lcol,
                        panel=P.panel, rbl=P.rbl, window=P.window,
                        window_h=use_wh, chunk=chunk, scheme=use_scheme,
                        epilogue_sub=epilogue_sub)
        kind, seg, span_used, rps, base, rbl = (
            "tiles", "span" if use_scheme == "span" else "window",
            t["span"], t["rows_per_step"], t["base"], t["rbl"])
    T = t["vals"].shape[0]
    idx_bytes = 1 if P.panel_w == 1 else 2
    meta = {"num_blocks": P.num_tiles, "fill": P.fill, "chunk": chunk,
            "quantum": quantum, "window_h": use_wh, "hot_cols": n_hot,
            "panel_w": P.panel_w, "scheme": use_scheme,
            "row_sort": bsrc is not None,
            "split_shift": bool(extend and extend[0][1] is None)}
    if tpu:
        meta["tpu_knobs"] = tpu
    return PellPlan(
        kind=kind, m=A.m, n=A.n, m_orig=m_orig, quantum=quantum,
        panel_w=P.panel_w, chunk=chunk,
        vals=t["vals"].reshape(T * BR, BC),
        idx=_idx_plane(t["lcol"], T, P.panel_w), pan2=t["pan2"], rbl=rbl,
        base=base, span=span_used, seg=seg, rows_per_step=rps, h=use_wh,
        num_win=t["num_win"], bsrc=bsrc, meta=meta,
        hbm_bytes=P.num_tiles * BR * BC * (4 + idx_bytes),
        extend=tuple(extend))


def x_past_budget(n: int, x_vmem_budget: int) -> bool:
    """Whether an f32 x of ``n`` exceeds ``x_vmem_budget`` at the
    reference's padded width (panels rounded up to a multiple of 8, the
    widest superpanel: an n at the boundary stripes, never raises)."""
    p_rows_pad = -(-(-(-n // BC)) // 8) * 8
    return p_rows_pad * BC * 4 > x_vmem_budget


def stripe_width(x_vmem_budget: int) -> int:
    """Columns a stripe: half the budget of f32, a panel multiple."""
    return max(BC, x_vmem_budget // 2 // 4 // BC * BC)


@trace.span("pack.plan", fn="plan_striped")
def plan_striped(A: CSR, x_vmem_budget: int, chunk: int, quantum: int,
                 window_h, span_max: int, tpu: dict) -> StripedPlan:
    """The reference's ``_prepare_pell_striped`` (pallas_kernels.py:
    1341-1446): columns in stripes of :func:`stripe_width`; each stripe
    that holds entries becomes a fused plan over its active row-block
    range only, its window height escalated (1, 2, 4, 8, 16 times
    ``window_h``, then the whole range) until a step of ``chunk`` tiles
    spans at most ``span_max`` windows; one panel a tile, no row sort."""
    ws = stripe_width(x_vmem_budget)
    rows = A.row_ids()
    wh0 = window_h if isinstance(window_h, int) else DEFAULT_WINDOW_H
    parts, wh_used_all = [], []
    num_tiles = nnz_seen = 0
    for s in range(-(-A.n // ws)):
        c0, c1 = s * ws, min((s + 1) * ws, A.n)
        sel = (A.ja >= c0) & (A.ja < c1)
        if not sel.any():
            continue
        rsel = rows[sel]
        rb0 = int(rsel.min()) // BR
        rb1 = int(rsel.max()) // BR + 1
        m_loc = (rb1 - rb0) * BR
        S = CSR.from_coo(f"{A.name}[c{c0}:{c1}]", m_loc, c1 - c0,
                         rsel - rb0 * BR, A.ja[sel] - c0, A.as_[sel])
        nnz_seen += S.nnz
        mb_loc = rb1 - rb0
        for mult in (1, 2, 4, 8, 16, 0):
            wh = mb_loc if mult == 0 else min(wh0 * mult, mb_loc)
            P = csr_to_pell(S, quantum=quantum, window_h=wh, chunk_align=1,
                            min_chunk_align=1)
            if _span_of(P.window, chunk) <= span_max or wh >= mb_loc:
                break
        t = fused_tables(m=m_loc, n=S.n, vals=P.vals.astype(np.float32),
                         lcol=P.lcol, panel=P.panel, rbl=P.rbl,
                         window=P.window, window_h=wh, chunk=chunk)
        T = t["vals"].shape[0]
        plan = PellPlan(
            kind="fused", m=m_loc, n=S.n, m_orig=m_loc, quantum=quantum,
            panel_w=1, chunk=chunk, vals=t["vals"].reshape(T * BR, BC),
            idx=_idx_plane(t["lcol"], T, 1), pan2=t["pan2"], rbl=t["rbl2"],
            base=t["base"], span=t["W"], seg="span",
            rows_per_step=chunk * BR, h=wh, num_win=t["num_win"], bsrc=None,
            meta={}, hbm_bytes=P.num_tiles * BR * BC * 5)
        num_tiles += P.num_tiles
        wh_used_all.append(wh)
        parts.append((plan, c0, c1, rb0 * BR, min(m_loc, A.m - rb0 * BR)))
    if nnz_seen != A.nnz:
        raise AssertionError(f"pell stripes: {nnz_seen} of {A.nnz} entries")
    meta = {"num_blocks": num_tiles,
            "fill": A.nnz / max(num_tiles * BR * BC, 1),
            "stripes": len(parts), "scheme": "fused", "chunk": chunk,
            "quantum": quantum, "window_h": max(wh_used_all, default=wh0),
            "hot_cols": 0}
    if tpu:
        meta["tpu_knobs"] = tpu
    return StripedPlan(m=A.m, n=A.n, parts=parts, meta=meta,
                       hbm_bytes=num_tiles * BR * BC * 5)


def fp64_refusals(A: CSR, quantum: int) -> None:
    """The reference's refusals of the fp64 grade, kept for parity, each
    a ``ValueError``: a row too long for its digit planes' 2^24 integer
    budget at the reference's ``quantum``, and an x pair past
    ``X_VMEM_BUDGET``. Native fp64 has neither limit."""
    # the reference's digit sums per output row must stay < 2^24 (f32
    # integer exactness)
    max_row = int(np.diff(A.irp).max(initial=0))
    if (max_row + quantum) * 130 * 2 >= 1 << 24:
        raise ValueError(
            f"cuda-pell-fp64: max row length {max_row} overflows the 2^24 "
            "exact-integer budget of the reference's digit planes; use "
            "torch-ell-fp64")
    x_bytes = 2 * max(1, -(-A.n // BC)) * BC * 4
    if x_bytes > X_VMEM_BUDGET:
        # the reference's hi/lo x pair resident in VMEM (checked before
        # packing: it depends on n alone)
        raise ValueError(
            f"cuda-pell-fp64: x pair ({x_bytes} B) exceeds the budget "
            f"{X_VMEM_BUDGET} B; use torch-ell-fp64 for this matrix")


@trace.span("pack.plan", fn="plan_pell_fp64")
def plan_pell_fp64(A: CSR, chunk: int = DEFAULT_CHUNK,
                   quantum: int | str = "auto",
                   window_h: int | str = "auto", span_max: int = 8,
                   **_) -> PellPlan:
    """Pack ``A`` as the reference's ``prepare_pell_df64`` does
    (pallas_kernels.py:1025-1059, with the table part of
    ``_make_fused_spmv_df64``, :882-933): the tuning axes at one panel
    and no row sort, the fused scheme with the ``window_h`` escalation,
    the values kept in float64. The TPU's refusals stay for parity, each
    a ``ValueError`` (:func:`fp64_refusals`). A chunk whose float64
    partials would not fit a block's shared memory is refused too, before
    any packing."""
    auto = auto_pell_params(A, quantum=quantum, window_h=window_h,
                            panel_w=1, row_sort=False, chunk=chunk)
    quantum, wh0, chunk = auto["quantum"], auto["window_h"], auto["chunk"]
    smem = fused_smem(chunk, BC // quantum, 8)
    if smem > SMEM_MAX:
        raise ValueError(
            f"cuda-pell-fp64: a step's partials ({smem} B at chunk {chunk}, "
            f"quantum {quantum}) exceed the shared memory of a block "
            f"({SMEM_MAX} B); use a smaller chunk")
    fp64_refusals(A, quantum)
    P = None
    for wh_try in (wh0, 2 * wh0, 4 * wh0):
        P = csr_to_pell(A, quantum=quantum, window_h=wh_try,
                        chunk_align=1, min_chunk_align=1)
        if _span_of(P.window, chunk) <= span_max:
            break
    wh_used = P.window_h
    t = fused_tables(m=A.m, n=A.n, vals=np.asarray(P.vals, np.float64),
                     lcol=P.lcol, panel=P.panel, rbl=P.rbl, window=P.window,
                     window_h=wh_used, chunk=chunk)
    T = t["vals"].shape[0]
    return PellPlan(
        kind="fused", m=A.m, n=A.n, m_orig=A.m, quantum=quantum, panel_w=1,
        chunk=chunk, vals=t["vals"].reshape(T * BR, BC),
        idx=_idx_plane(t["lcol"], T, 1), pan2=t["pan2"], rbl=t["rbl2"],
        base=t["base"], span=t["W"], seg="span", rows_per_step=chunk * BR,
        h=wh_used, num_win=t["num_win"], bsrc=None,
        meta={"num_blocks": P.num_tiles, "fill": P.fill, "chunk": chunk,
              "quantum": quantum, "window_h": wh_used, "rtol": FP64_RTOL},
        hbm_bytes=P.num_tiles * BR * BC * 9, dtype=torch.float64)


@trace.span("pack.plan", fn="plan_rows")
def plan_rows(A: CSR, dtype=torch.float32, quantum: int | str = "auto",
              scheme: str = "auto", x_vmem_budget: int = X_VMEM_BUDGET,
              hot_cols: int = 0, split_shift: bool = False,
              **knobs) -> prows.RowsPlan:
    """Pack ``A`` in the row layout (:func:`pell_rows.plan_pell_rows`)
    for ``cuda-pell`` (float32) or ``cuda-pell-fp64`` (float64), with the
    fp64 grade's refusals and the reference's knobs recorded in meta.

    An f32 x past ``x_vmem_budget`` needs no stripes: the row kernel
    reads x in place at any n, so the plan is one ``pell_rows`` launch a
    call and its meta says ``stripes: 0``. ``hot_cols`` and
    ``split_shift`` pack (8-row block, panel) buckets, which row quanta
    do not have: they are recorded in ``meta["tile_knobs"]``, the meta
    says ``hot_cols: 0`` and ``split_shift: False``, and y is the same."""
    if scheme not in ("auto", "fused"):
        raise ValueError(f"pell: scheme {scheme!r} runs on the tile layout; "
                         "use layout='tiles'")
    if dtype == torch.float64:
        fp64_refusals(A, auto_pell_params(A, quantum=quantum)["quantum"])
    plan = prows.plan_pell_rows(A, dtype,
                                None if quantum == "auto" else quantum)
    tile = {k: knobs[k] for k in TILE_KNOBS if k in knobs}
    remaps = {k: v for k, v in (("hot_cols", hot_cols),
                                ("split_shift", split_shift)) if v}
    tpu = {k: knobs[k] for k in TPU_KNOBS
           if k in knobs and knobs[k] != TPU_KNOBS[k]}
    if tile or remaps:
        plan.meta["tile_knobs"] = {**tile, **remaps}
    if remaps:
        plan.meta.update(hot_cols=0, split_shift=False)
    if dtype == torch.float32 and x_past_budget(A.n, x_vmem_budget):
        plan.meta["stripes"] = 0
    if tpu:
        plan.meta["tpu_knobs"] = tpu
    if dtype == torch.float64:
        plan.meta["rtol"] = FP64_RTOL
    return plan


@trace.span("pack.plan", fn="plan_bcsr")
def plan_bcsr(A: CSR, chunk: int = DEFAULT_CHUNK,
              window_h: int = DEFAULT_WINDOW_H,
              max_padded_bytes: int = 2 << 30, **_) -> PellPlan:
    """Pack ``A`` as the reference's ``prepare_bcsr`` does: dense (8, 128)
    tiles in row-block order, each window padded to a chunk multiple,
    for the tile kernel and the window segment-sum. Refuses (ValueError)
    a matrix whose dense tiles would exceed ``max_padded_bytes``."""
    est_tiles = np.unique(
        (A.row_ids().astype(np.int64) // BR) * ((A.n + BC - 1) // BC)
        + A.ja // BC).shape[0]
    bcsr_bits.refuse_dense_tiles(est_tiles, max_padded_bytes)
    B = csr_to_bcsr(A, br=BR, bc=BC)
    rowblk = np.repeat(np.arange(B.num_block_rows, dtype=np.int32),
                       np.diff(B.rowptr))
    vals, panel, window, rbl, _ = _window_pad_tiles(
        B.vals.astype(np.float32), B.col_panel, rowblk, window_h,
        chunk * 4, min_chunk=chunk,
        num_win=max(1, -(-B.num_block_rows // window_h)))
    t = tile_tables(m=A.m, n=A.n, vals=vals, lcol=None, panel=panel,
                    rbl=rbl, window=window, window_h=window_h, chunk=chunk,
                    scheme="pure", epilogue_sub=4)
    T = t["vals"].shape[0]
    return PellPlan(
        kind="tiles", m=A.m, n=A.n, m_orig=A.m, quantum=BC, panel_w=1,
        chunk=chunk, vals=t["vals"].reshape(T * BR, BC), idx=None,
        pan2=t["pan2"], rbl=t["rbl"], base=t["base"], span=1, seg="window",
        rows_per_step=t["rows_per_step"], h=window_h, num_win=t["num_win"],
        bsrc=None,
        meta={"num_blocks": B.num_tiles, "fill": B.fill, "chunk": chunk,
              "window_h": window_h},
        hbm_bytes=T * BR * BC * 4)


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedCfg:
    """Static geometry of :func:`pell_fused`: lanes per quantum, panels
    per superpanel, tiles per step, window height in row blocks, windows
    a step may touch, and windows of y."""

    quantum: int
    panel_w: int
    chunk: int
    h: int
    span: int
    num_windows: int

    @property
    def nq(self) -> int:
        return BC // self.quantum


def _check_tiles(what, vals, idx, pan, x, quantum: int, panel_w: int,
                 dtype=torch.float32):
    if quantum <= 0 or BC % quantum:
        raise ValueError(f"{what}: quantum {quantum} does not divide {BC}")
    if vals.dtype != dtype or vals.dim() != 2 \
            or vals.shape[1] != BC or vals.shape[0] % BR:
        raise ValueError(f"{what}: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected {dtype} (T*8, 128)")
    T = vals.shape[0] // BR
    if idx is not None:
        want = torch.int8 if panel_w == 1 else torch.int16
        if idx.dtype != want or idx.shape != vals.shape:
            raise ValueError(f"{what}: idx is {idx.dtype} "
                             f"{tuple(idx.shape)}, expected {want} "
                             f"{tuple(vals.shape)} for panel_w={panel_w}")
    elif panel_w != 1:
        raise ValueError(f"{what}: dense tiles take panel_w=1")
    if pan.dtype != torch.int32 or pan.dim() != 1 or pan.numel() < T:
        raise ValueError(f"{what}: pan is {pan.dtype} {tuple(pan.shape)}, "
                         f"expected int32 with >= {T} entries")
    if x.dtype != dtype or x.dim() != 1:
        raise ValueError(f"{what}: x is {x.dtype} {tuple(x.shape)}, "
                         f"expected {dtype} (n,)")
    for name, t in (("vals", vals), ("idx", idx), ("pan", pan), ("x", x)):
        if t is None:
            continue
        if t.device != vals.device:
            raise ValueError(f"{what}: {name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {vals.device}")
    return T


def _kind(idx) -> int:
    """The kernel's index kind: 0 dense, 1 int8, 2 int16."""
    return 0 if idx is None else 1 if idx.dtype == torch.int8 else 2


@trace.launch("pell_tiles")
def pell_tiles(vals, idx, pan, x, quantum: int,
               panel_w: int = 1) -> torch.Tensor:
    """Per-quantum partials (T*8, 128 // quantum) f32 of the tile stream:
    ``part[t*8 + r, j]`` sums ``vals * x[col]`` over the slots of quantum
    j in row r of tile t, with ``col = pan[t]*panel_w*128 + idx`` (or
    ``pan[t]*128 + lane`` for dense tiles, ``idx`` None); a column at or
    past ``x.numel()`` reads 0.0. CUDA tensors launch ``csrc/pell.cu``;
    CPU tensors run :func:`pell_tiles_plain`."""
    T = _check_tiles("pell_tiles", vals, idx, pan, x, quantum, panel_w)
    if vals.device.type == "cpu":
        return pell_tiles_plain(vals, idx, pan, x, quantum, panel_w)
    lib = _kernels.load("pell")
    part = torch.empty((T * BR, BC // quantum), dtype=torch.float32,
                       device=vals.device)
    err = lib.pell_tiles(vals.data_ptr(),
                         0 if idx is None else idx.data_ptr(),
                         pan.data_ptr(), x.data_ptr(), part.data_ptr(),
                         T * BR, _kind(idx), panel_w, x.numel(), quantum,
                         BC // quantum, _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, "pell_tiles")
    LAUNCHES["pell_tiles"] += 1
    return part


def pell_tiles_plain(vals, idx, pan, x, quantum: int,
                     panel_w: int = 1) -> torch.Tensor:
    """The tile kernel's arithmetic in PyTorch ops: gather, multiply,
    then the same pairwise tree per quantum (adjacent slots, then
    adjacent pairs, ...), each product and sum rounded separately."""
    R = vals.shape[0]
    dev = vals.device
    cb = pan[:R // BR].to(torch.int64).repeat_interleave(BR)[:, None] \
        * (panel_w * BC)
    col = cb + (torch.arange(BC, device=dev) if idx is None
                else idx.to(torch.int64))
    n = x.numel()
    ok = (col >= 0) & (col < n)
    xg = torch.where(ok, x[col.clamp(0, max(n - 1, 0))], 0.0) if n \
        else torch.zeros_like(vals)
    p = (vals * xg).view(R, BC // quantum, quantum)
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p.reshape(R, BC // quantum).contiguous()


def fused_smem(chunk: int, nq: int, itemsize: int) -> int:
    """Bytes of shared memory the fused kernel's block takes: one
    step's per-quantum partials."""
    return chunk * nq * BR * itemsize


def _fused(what, dtype, vals, idx, pan, x, rbl, base, cfg: FusedCfg,
           lists) -> torch.Tensor:
    """Check a fused call's arguments, then run the plain version on CPU
    tensors or launch the fused kernel of ``dtype`` (entry point
    ``what`` of ``csrc/pell.cu``) on CUDA tensors."""
    T = _check_tiles(what, vals, idx, pan, x, cfg.quantum, cfg.panel_w,
                     dtype)
    if T % cfg.chunk:
        raise ValueError(f"{what}: {T} tiles are not a multiple of the "
                         f"chunk {cfg.chunk}")
    if min(cfg.h, cfg.span, cfg.num_windows, cfg.chunk) <= 0:
        raise ValueError(f"{what}: {cfg} has a size that is not positive")
    steps = T // cfg.chunk
    segsum_kernel.check_tables(what, vals.device, steps, cfg.chunk * cfg.nq,
                               rbl, base, cfg.span, cfg.h, lists)
    if vals.device.type == "cpu":
        return pell_fused_plain(vals, idx, pan, x, rbl, base, cfg, lists)
    smem = fused_smem(cfg.chunk, cfg.nq, vals.element_size())
    if smem > SMEM_MAX:
        raise ValueError(f"{what}: a step's partials ({smem} B) exceed the "
                         f"shared memory of a block ({SMEM_MAX} B); use a "
                         "smaller chunk")
    order, ptr = lists
    lib = _kernels.load("pell")
    tiles = torch.empty(steps * cfg.span * cfg.h * BR, dtype=dtype,
                        device=vals.device)
    y = torch.empty((cfg.num_windows * cfg.h, BR), dtype=dtype,
                    device=vals.device)
    err = getattr(lib, what)(
        vals.data_ptr(), 0 if idx is None else idx.data_ptr(),
        pan.data_ptr(), x.data_ptr(), order.data_ptr(), ptr.data_ptr(),
        base.data_ptr(), tiles.data_ptr(), y.data_ptr(), steps, cfg.chunk,
        _kind(idx), cfg.panel_w, x.numel(), cfg.quantum, cfg.nq, cfg.h,
        cfg.span, cfg.num_windows, _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, what)
    LAUNCHES[what] += 1
    return y


@trace.launch("pell_fused")
def pell_fused(vals, idx, pan, x, rbl, base, cfg: FusedCfg,
               lists) -> torch.Tensor:
    """y (num_windows*h, 8) f32 of the tile stream in one pass: each
    quantum's partial (as :func:`pell_tiles`) added into global row
    block ``rbl`` if that lies in the windows ``base[s] .. base[s] +
    span - 1`` of its step (``chunk`` tiles), as
    :func:`segsum_kernel.span_segsum` adds them (in its own order: the
    fused kernels keep the two-pass tree, ``step_tree_plain``).
    ``lists``: ``segsum_kernel.device_lists`` of ``rbl``. CUDA tensors
    launch ``csrc/pell.cu``; CPU tensors run :func:`pell_fused_plain`."""
    return _fused("pell_fused", torch.float32, vals, idx, pan, x, rbl, base,
                  cfg, lists)


@trace.launch("pell_fused_fp64")
def pell_fused_fp64(vals, idx, pan, x, rbl, base, cfg: FusedCfg,
                    lists) -> torch.Tensor:
    """:func:`pell_fused` in float64: vals and x float64, y (num_windows*h,
    8) float64, the same slot tree and cell and window orders. A chunk
    whose partials (chunk*nq*8 doubles) exceed a block's shared memory
    raises ``ValueError``. CPU tensors run :func:`pell_fused_plain`."""
    return _fused("pell_fused_fp64", torch.float64, vals, idx, pan, x, rbl,
                  base, cfg, lists)


def pell_fused_plain(vals, idx, pan, x, rbl, base, cfg: FusedCfg,
                     lists=None) -> torch.Tensor:
    """:func:`pell_fused` and :func:`pell_fused_fp64` in PyTorch ops: the
    tile kernel's partials, then the span segment-sum's sums, in their
    orders, in the dtype of ``vals``."""
    part = pell_tiles_plain(vals, idx, pan, x, cfg.quantum, cfg.panel_w)
    return segsum_kernel.step_tree_plain(part, rbl, base, cfg.num_windows,
                                         cfg.h, cfg.span, cfg.chunk * BR)


def _check_unpermute(yp, bsrc):
    if yp.dtype != torch.float32 or yp.dim() != 2 or yp.shape[1] != BR \
            or yp.shape[0] % SORT_WIN:
        raise ValueError(f"unpermute: y' is {yp.dtype} {tuple(yp.shape)}, "
                         f"expected float32 (k*{SORT_WIN}, {BR})")
    if bsrc.dtype != torch.int32 or bsrc.shape != yp.shape:
        raise ValueError(f"unpermute: bsrc is {bsrc.dtype} "
                         f"{tuple(bsrc.shape)}, expected int32 "
                         f"{tuple(yp.shape)}")
    if bsrc.device != yp.device:
        raise ValueError(f"unpermute: bsrc is on {bsrc.device}, y' on "
                         f"{yp.device}")
    if not (yp.is_contiguous() and bsrc.is_contiguous()):
        raise ValueError("unpermute: y' and bsrc must be contiguous")
    if yp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unpermute: unsupported device {yp.device}")


@trace.launch("unpermute")
def unpermute(yp, bsrc) -> torch.Tensor:
    """Undo the row sort: ``y[b, i] = yp[(b // 128) * 128 + bsrc[b, i],
    i]`` for (mb_pad, 8) f32 ``yp`` and window-local int32 ``bsrc``. CUDA
    tensors launch ``csrc/pell.cu``; CPU tensors run
    :func:`unpermute_plain`."""
    _check_unpermute(yp, bsrc)
    if yp.device.type == "cpu":
        return unpermute_plain(yp, bsrc)
    lib = _kernels.load("pell")
    y = torch.empty_like(yp)
    err = lib.pell_unpermute(yp.data_ptr(), bsrc.data_ptr(), y.data_ptr(),
                             yp.numel(), SORT_WIN,
                             _kernels.stream_handle(yp.device))
    _kernels.check(lib, err, "unpermute")
    LAUNCHES["unpermute"] += 1
    return y


def unpermute_plain(yp, bsrc) -> torch.Tensor:
    """:func:`unpermute` as one ``gather``."""
    blk = torch.arange(yp.shape[0], device=yp.device) // SORT_WIN * SORT_WIN
    return yp.gather(0, blk[:, None] + bsrc.to(torch.int64))


class PellKernels(NamedTuple):
    """The functions a PELL or BCSR call runs, by name."""

    pell_fused: Callable
    pell_tiles: Callable
    span_segsum: Callable
    window_segsum: Callable
    unpermute: Callable
    pell_rows: Callable
    bcsr_bits: Callable


KERNELS = PellKernels(pell_fused, pell_tiles, segsum_kernel.span_segsum,
                      segsum_kernel.window_segsum, unpermute, prows.pell_rows,
                      bcsr_bits.bcsr_bits)
PLAIN = PellKernels(pell_fused_plain, pell_tiles_plain,
                    segsum_kernel.span_segsum_plain,
                    segsum_kernel.window_segsum_plain, unpermute_plain,
                    prows.pell_rows_plain, bcsr_bits.bcsr_bits_plain)


class PellFp64Kernels(NamedTuple):
    """The functions a ``cuda-pell-fp64`` call runs, by name."""

    pell_fused_fp64: Callable
    pell_rows_fp64: Callable


FP64_KERNELS = PellFp64Kernels(pell_fused_fp64, prows.pell_rows_fp64)
FP64_PLAIN = PellFp64Kernels(pell_fused_plain, prows.pell_rows_plain)


# ---------------------------------------------------------------------------
# The strategies
# ---------------------------------------------------------------------------

@trace.span("pack.upload", fn="pell.bind_plan")
def bind_plan(plan: PellPlan, dev) -> Callable:
    """The plan's arrays on ``dev``, and ``run(xf, ops) -> y (m_orig,)``
    for x (on ``dev``, in ``plan.dtype``) through the kernels in ``ops``:
    :class:`PellKernels`' fields, or :class:`PellFp64Kernels`' for a
    float64 plan."""
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    extend = extend_x(plan.extend, dev)
    vals = put(plan.vals, plan.dtype)
    idx = None if plan.idx is None else torch.as_tensor(
        np.ascontiguousarray(plan.idx), device=dev)
    pan = put(plan.pan2.reshape(-1), torch.int32)
    base = put(plan.base, torch.int32)
    h, span = plan.h, plan.span
    # the fused kernel's rbl2 is padded to 8-step blocks
    rbl_np = plan.rbl[:plan.steps] if plan.kind == "fused" else plan.rbl
    rbl = put(rbl_np.reshape(-1), torch.int32)
    # the fused kernel's index by (step, cell); the segment-sum's by
    # destination
    if plan.kind == "fused":
        index = segsum_kernel.device_lists(
            segsum_kernel.span_rel(rbl_np, plan.base, h), span * h, dev)
    elif plan.seg == "span":
        index = segsum_kernel.span_tables(rbl_np, plan.base, plan.num_win, h,
                                          span, dev)
    else:
        index = segsum_kernel.window_tables(rbl_np, plan.base, plan.num_win,
                                            h, dev)
    cfg = FusedCfg(plan.quantum, plan.panel_w, plan.chunk, h, span,
                   plan.num_win)
    bsrc = None if plan.bsrc is None else put(plan.bsrc, torch.int32)
    mbp8 = 0 if plan.bsrc is None else plan.bsrc.size

    def run(xf, ops):
        xf = extend(xf)
        if plan.kind == "fused":
            fused = (ops.pell_fused_fp64 if plan.dtype == torch.float64
                     else ops.pell_fused)
            y = fused(vals, idx, pan, xf, rbl, base, cfg, index)
        else:
            part = ops.pell_tiles(vals, idx, pan, xf, plan.quantum,
                                  plan.panel_w)
            if plan.seg == "span":
                y = ops.span_segsum(part, rbl, base, plan.num_win, h, span,
                                    plan.rows_per_step, index)
            else:
                y = ops.window_segsum(part, rbl, base, plan.num_win, h,
                                      plan.rows_per_step, index)
        y = y.view(-1)
        if bsrc is not None:
            y = ops.unpermute(y[:mbp8].view(-1, BR), bsrc).view(-1)
        return y[:plan.m_orig]

    return run


def extend_x(extend, dev) -> Callable:
    """``f(xf)``: x grown into a remapped plan's column space, as the
    reference's call does (pallas_kernels.py:1756-1771): for each entry
    of ``extend`` in order, zeros up to the panel multiple of the width
    before it, then ``x[64:n_before]`` (the split grid) or ``x[hot_idx]``
    (the hot columns)."""
    steps = [(nb, -(-nb // BC) * BC, None if hot is None else
              torch.as_tensor(hot, dtype=torch.int64, device=dev))
             for nb, hot in extend]

    def f(xf):
        for nb, n_pad, hot in steps:
            xf = torch.cat([xf, xf.new_zeros(n_pad - nb),
                            xf[64:nb] if hot is None else xf[hot]])
        return xf

    return f


def bind_striped(plan: StripedPlan, dev) -> Callable:
    """``run(xf, ops) -> y (m,)`` of a striped plan: each stripe's fused
    call on the view ``x[c0:c1]``, its rows added into ``y[row0:row0 +
    keep]`` (the reference adds the stripes' y outside any kernel,
    pallas_kernels.py:1421-1430)."""
    parts = [(bind_plan(p, dev), c0, c1, row0, keep)
             for p, c0, c1, row0, keep in plan.parts]

    def run(xf, ops):
        y = torch.zeros(plan.m, dtype=plan.dtype, device=dev)
        for part, c0, c1, row0, keep in parts:
            y[row0:row0 + keep] += part(xf[c0:c1], ops)[:keep]
        return y

    return run


def _prepared(name: str, ref: str, A: CSR, plan, dev, kernels=KERNELS,
              plain=PLAIN):
    """Bind ``plan`` (a :class:`PellPlan`, a :class:`StripedPlan`, a
    row-layout :class:`pell_rows.RowsPlan` or a
    :class:`bcsr_bits.BitsPlan`) on ``dev`` as strategy ``name``."""
    bind = (prows.bind_plan if isinstance(plan, prows.RowsPlan)
            else bcsr_bits.bind_plan if isinstance(plan, bcsr_bits.BitsPlan)
            else bind_striped if isinstance(plan, StripedPlan)
            else bind_plan)
    run = bind(plan, dev)
    n = A.n

    def call(x, ops):
        xf = torch.as_tensor(x, dtype=plan.dtype, device=dev)
        if xf.shape != (n,):
            raise ValueError(f"{name}: x has shape {tuple(xf.shape)}, "
                             f"expected ({n},)")
        return run(xf, ops)

    return Prepared(name, A.name, lambda x: call(x, kernels), device=dev,
                    nnz=A.nnz, ref=ref, hbm_bytes=int(plan.hbm_bytes),
                    meta=plan.meta, plain=lambda x: call(x, plain),
                    kernel_calls=lambda xf: record_calls(
                        lambda ops: call(xf, ops), plain), run=call)


def use_layout(layout: str, scheme: str = "auto") -> str:
    """``"rows"`` or ``"tiles"``: what a ``layout`` knob (module
    docstring) packs for PELL ``scheme``."""
    if layout not in LAYOUTS:
        raise ValueError(f"pell: unknown layout {layout!r}; one of "
                         f"{LAYOUTS}")
    return ("tiles" if layout == "tiles" or scheme in ("span", "pure")
            else "rows")


def prepare_pell(A: CSR, device="cuda", layout: str = "auto",
                 **knobs) -> Prepared:
    """``cuda-pell``: pack ``A`` in ``layout`` (:func:`plan_rows`, or
    :func:`plan_pell` with the reference's knobs) and bind ``fn(x) -> y``
    on ``device`` (the card by default; ``"cpu"`` runs the plain
    versions)."""
    dev = resolve_device(device)
    if use_layout(layout, knobs.get("scheme", "auto")) == "rows":
        plan = plan_rows(A, torch.float32, **knobs)
    else:
        plan = plan_pell(A, **knobs)
    return _prepared("cuda-pell", "pallas-pell", A, plan, dev)


def prepare_pell_fp64(A: CSR, device="cuda", layout: str = "auto",
                      **knobs) -> Prepared:
    """``cuda-pell-fp64``: pack ``A`` in ``layout`` (:func:`plan_rows`,
    or :func:`plan_pell_fp64`) and bind ``fn(x) -> y`` (float64 in,
    float64 out) on ``device``."""
    dev = resolve_device(device)
    if use_layout(layout) == "rows":
        plan = plan_rows(A, torch.float64, **knobs)
    else:
        plan = plan_pell_fp64(A, **knobs)
    return _prepared("cuda-pell-fp64", "pallas-pell-df64", A, plan, dev,
                     FP64_KERNELS, FP64_PLAIN)


def prepare_bcsr(A: CSR, device="cuda", layout: str = "auto",
                 max_padded_bytes: int = 2 << 30, **knobs) -> Prepared:
    """``cuda-bcsr``: pack ``A`` in ``layout`` (the bitmap tiles,
    :func:`bcsr_bits.plan_bcsr_bits`, for ``"auto"``; :func:`plan_bcsr`
    for ``"tiles"``), both refusing a matrix whose dense tiles would
    exceed ``max_padded_bytes``, and bind it on ``device``."""
    if layout not in LAYOUTS:
        raise ValueError(f"bcsr: unknown layout {layout!r}; one of "
                         f"{LAYOUTS}")
    dev = resolve_device(device)
    if layout == "tiles":
        plan = plan_bcsr(A, max_padded_bytes=max_padded_bytes, **knobs)
    else:
        plan = bcsr_bits.plan_bcsr_bits(A, max_padded_bytes)
        tile = {k: knobs[k] for k in ("chunk", "window_h") if k in knobs}
        if tile:
            plan.meta["tile_knobs"] = tile
    return _prepared("cuda-bcsr", "pallas-bcsr", A, plan, dev)

"""PELL, panel-local ELLPACK, host side (counterpart of
``spmv_scpa_tpu/formats/panel_ell.py``, whose ``PanelEll`` and
``csr_to_pell`` this copies; the tests hold the copy equal to it).

Nonzeros are bucketed by (8-row block, 128-column panel) and packed
into (8, 128) slot tiles: ``vals[t]`` (values, padding 0.0),
``lcol[t]`` (the column within the tile's superpanel of ``panel_w``
panels, padding 0) and ``panel[t]`` (the superpanel the tile reads).
The 128 lanes of a tile are cut into ``nq = 128 // quantum`` quanta,
each serving its own 8-row block (``rowblk[t, s]``), so a bucket pads
to a multiple of ``quantum`` slots rather than to 128 (the reference
study's HLL block padding, hll.c:38-60, one level down). Tiles come out
grouped by windows of ``window_h`` row blocks (``window``, ``rbl``),
the order the port's segment-sums and fused kernel read them in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu_torch.formats.csr import BC, CSR

BR = 8      # rows per bucket
DEFAULT_QUANTUM = 16


@dataclass
class PanelEll:
    name: str
    m: int
    n: int
    nnz: int
    quantum: int
    vals: np.ndarray     # (T, 8, 128) float64 host / cast on device
    lcol: np.ndarray     # (T, 8, 128) int32, values in [0, 128*panel_w)
    panel: np.ndarray    # (T,) int32 — superpanel id (panel_w x panels)
    rowblk: np.ndarray   # (T, nq) int32; mb = dump block for padding
    # Window grouping for the scatter-free epilogue
    # (ops/segsum_kernel.py): window w covers 8-row blocks
    # [w*window_h, (w+1)*window_h); tiles are window-grouped and padded
    # so every ``chunk_align`` consecutive tiles share a window.
    window_h: int = 0
    chunk_align: int = 1
    window: np.ndarray | None = None   # (T,) int32, non-decreasing
    rbl: np.ndarray | None = None      # (T, nq) int32 window-local;
                                       # window_h == padding sentinel
    # Superpanel width: a tile's x reach is ``panel_w`` consecutive
    # 128-col panels (kernel gathers per 128-strip and selects by
    # lcol // 128). Widens (row-block, panel) buckets ``panel_w``-fold
    # — the fill unlock for scattered short rows (webbase archetype:
    # an (8-row, 128-col) bucket holds ~0.6 entries; at panel_w=8 it
    # holds ~5, cutting the 8-slot-per-bucket quantum waste).
    panel_w: int = 1

    @property
    def num_windows(self) -> int:
        return -(-self.num_row_blocks // max(self.window_h, 1))

    @property
    def nq(self) -> int:
        return BC // self.quantum

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_row_blocks(self) -> int:
        return (self.m + BR - 1) // BR

    @property
    def num_panels(self) -> int:
        return -(-self.n // (BC * self.panel_w))

    @property
    def fill(self) -> float:
        return self.nnz / max(self.num_tiles * BR * BC, 1)

    @property
    def hbm_bytes(self) -> int:
        """Matrix bytes streamed per SpMV (f32 vals + i32 lcol)."""
        return self.num_tiles * BR * BC * 8

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float64)
        q = self.quantum
        for t in range(self.num_tiles):
            c0 = int(self.panel[t]) * BC * self.panel_w
            for lane in range(BC):
                rb = int(self.rowblk[t, lane // q])
                if rb >= self.num_row_blocks:
                    continue
                for i in range(min(BR, self.m - rb * BR)):
                    v = self.vals[t, i, lane]
                    if v != 0.0:
                        col = c0 + int(self.lcol[t, i, lane])
                        out[rb * BR + i, min(col, self.n - 1)] += v
        return out


DEFAULT_WINDOW_H = 128   # 8-row blocks per epilogue window (1024 rows)
DEFAULT_CHUNK_ALIGN = 16  # tiles-per-grid-step alignment within windows


def csr_to_pell(A: CSR, quantum: int = DEFAULT_QUANTUM,
                window_h: int = DEFAULT_WINDOW_H,
                chunk_align: int = DEFAULT_CHUNK_ALIGN,
                min_chunk_align: int = 1, panel_w: int = 1) -> PanelEll:
    """Convert CSR → PELL (vectorized single pass).

    Spiritual port of ``csr_to_hll`` (hll.c:19-95): instead of padding
    each 32-row block to its max row length, each (8-row, 128-col
    panel) bucket is padded to a multiple of ``quantum`` slots; buckets
    sharing a (window, panel) group pack into tiles
    quantum-by-quantum, straddling tile boundaries freely — metadata is
    per quantum, not per bucket.

    Tiles come out grouped by row-block *window* (``window_h`` 8-row
    blocks each) and each window's tile count is padded to a multiple
    of ``chunk_align`` — so both the SpMV kernel's grid steps and the
    windowed segment-sum epilogue see window-pure steps
    (ops/segsum_kernel.py).
    """
    if BC % quantum != 0:
        raise ValueError(f"quantum must divide {BC}")
    if panel_w not in (1, 2, 4, 8):
        raise ValueError("panel_w must be 1, 2, 4, or 8")
    spw = BC * panel_w   # superpanel width in columns
    nq = BC // quantum
    mb = (A.m + BR - 1) // BR
    num_win = max(1, -(-mb // window_h))
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    nnz = rows.shape[0]
    if nnz == 0:
        # every window still needs >= chunk_align (sentinel) tiles so
        # the epilogue visits and zero-initializes every output block
        t0 = chunk_align * num_win
        return PanelEll(A.name, A.m, A.n, 0, quantum,
                        np.zeros((t0, BR, BC)),
                        np.zeros((t0, BR, BC), np.int32),
                        np.zeros(t0, np.int32),
                        np.full((t0, nq), mb, np.int32),
                        window_h=window_h, chunk_align=chunk_align,
                        window=np.repeat(
                            np.arange(num_win, dtype=np.int32),
                            chunk_align),
                        rbl=np.full((t0, nq), window_h, np.int32),
                        panel_w=panel_w)

    pn = cols // spw
    rb = rows // BR
    npan = -(-A.n // spw)

    # --- per-(row, panel) run slots (CSR order => runs contiguous) ---
    idx = np.arange(nnz, dtype=np.int64)
    run_start = np.ones(nnz, dtype=bool)
    run_start[1:] = (rows[1:] != rows[:-1]) | (pn[1:] != pn[:-1])
    s = idx - np.maximum.accumulate(np.where(run_start, idx, -1))

    # --- buckets: (rowblock, panel); groups: (window, panel) ---
    bkey = rb * npan + pn
    b_uniq, bucket_of = np.unique(bkey, return_inverse=True)
    nb = b_uniq.shape[0]
    b_rb = (b_uniq // npan).astype(np.int64)
    b_pn = (b_uniq % npan).astype(np.int64)
    b_win = b_rb // window_h
    b_maxc = np.zeros(nb, dtype=np.int64)
    np.maximum.at(b_maxc, bucket_of, s + 1)
    b_quanta = -(-b_maxc // quantum)

    # --- pack buckets in (window, panel, rowblock) order ---
    order = np.lexsort((b_rb, b_pn, b_win))
    q_end = np.cumsum(b_quanta[order])
    gkey_sorted = (b_win * npan + b_pn)[order]
    g_change = np.ones(nb, dtype=bool)
    g_change[1:] = gkey_sorted[1:] != gkey_sorted[:-1]
    group_start_qend = np.where(g_change, q_end - b_quanta[order], 0)
    group_base = np.maximum.accumulate(
        np.where(g_change, group_start_qend, -1))
    g0_sorted = (q_end - b_quanta[order]) - group_base   # within-group

    # per-group totals → tiles per group
    grp_win = b_win[order][g_change]
    grp_pn = b_pn[order][g_change]
    grp_total = np.diff(np.concatenate(
        [q_end[g_change] - b_quanta[order][g_change], [q_end[-1]]]))
    grp_tiles = -(-grp_total // nq)
    ng = grp_tiles.shape[0]

    # tiles per window (+ padding to chunk_align multiples). The
    # requested alignment is a maximum: shrink (by powers of two, not
    # below 1) until window-padding waste stays under ~10% — epilogue
    # block size trades against fill.
    win_tiles = np.zeros(num_win, dtype=np.int64)
    np.add.at(win_tiles, grp_win, grp_tiles)
    total_t = max(int(win_tiles.sum()), 1)
    while chunk_align > min_chunk_align:
        waste = int((-(-win_tiles // chunk_align) * chunk_align
                     - win_tiles).sum())
        if waste <= 0.1 * total_t:
            break
        chunk_align //= 2
    chunk_align = max(chunk_align, min_chunk_align)
    # Every window — including EMPTY ones — gets at least one
    # chunk_align-sized block of sentinel tiles: the windowed epilogue
    # zero-initializes an output block only when a grid step visits it,
    # so an unvisited window would return uninitialized VMEM garbage.
    win_tiles_pad = np.maximum(
        -(-np.maximum(win_tiles, 0) // chunk_align) * chunk_align,
        chunk_align)
    win_base = np.zeros(num_win, dtype=np.int64)
    np.cumsum(win_tiles_pad[:-1], out=win_base[1:])
    T = int(win_tiles_pad.sum())

    # group tile bases: window base + cumsum of group tiles within window
    grp_cum = np.cumsum(grp_tiles) - grp_tiles
    win_first_cum = np.zeros(num_win, dtype=np.int64)
    first_of_win = np.ones(ng, dtype=bool)
    first_of_win[1:] = grp_win[1:] != grp_win[:-1]
    win_first_cum[grp_win[first_of_win]] = grp_cum[first_of_win]
    grp_tile_base = win_base[grp_win] + (grp_cum - win_first_cum[grp_win])

    # map arrays back to original bucket indexing
    g0 = np.empty(nb, dtype=np.int64)
    g0[order] = g0_sorted
    grp_of_sorted = np.cumsum(g_change) - 1
    grp_of = np.empty(nb, dtype=np.int64)
    grp_of[order] = grp_of_sorted
    b_tile_base = grp_tile_base[grp_of]

    # --- per-nonzero placement ---
    G = g0[bucket_of] + s // quantum                # within-group quantum
    tile = b_tile_base[bucket_of] + G // nq
    lane = (G % nq) * quantum + s % quantum
    ri = rows % BR

    out_vals = np.zeros((T, BR, BC), dtype=np.float64)
    out_lcol = np.zeros((T, BR, BC), dtype=np.int32)
    out_vals[tile, ri, lane] = A.as_
    out_lcol[tile, ri, lane] = (cols % spw).astype(np.int32)

    # --- per-quantum rowblk metadata (global + window-local) ---
    rowblk = np.full((T, nq), mb, dtype=np.int32)
    rbl = np.full((T, nq), window_h, dtype=np.int32)
    reps = b_quanta                                  # quanta per bucket
    bq_bucket = np.repeat(np.arange(nb), reps)
    intra = np.arange(reps.sum()) - np.repeat(
        np.cumsum(reps) - reps, reps)
    Gq = g0[bq_bucket] + intra
    tq = b_tile_base[bq_bucket] + Gq // nq
    rowblk[tq, Gq % nq] = b_rb[bq_bucket]
    rbl[tq, Gq % nq] = (b_rb - b_win * window_h)[bq_bucket]

    # --- per-tile panel + window ---
    panel = np.zeros(T, dtype=np.int32)
    panel[np.repeat(grp_tile_base, grp_tiles)
          + (np.arange(int(grp_tiles.sum()))
             - np.repeat(np.cumsum(grp_tiles) - grp_tiles, grp_tiles))] = \
        np.repeat(grp_pn, grp_tiles).astype(np.int32)
    window = np.repeat(np.arange(num_win, dtype=np.int32), win_tiles_pad)

    return PanelEll(A.name, A.m, A.n, nnz, quantum,
                    vals=out_vals, lcol=out_lcol,
                    panel=panel, rowblk=rowblk,
                    window_h=window_h, chunk_align=int(chunk_align),
                    window=window, rbl=rbl, panel_w=panel_w)

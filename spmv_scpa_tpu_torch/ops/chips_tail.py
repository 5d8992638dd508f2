"""The chips tail on PyTorch and CUDA, single-plan route (counterpart of
``spmv_scpa_tpu/ops/chips_tail.py``).

Entries the lane-ELL core cannot hold (rows longer than its Q slot
planes, demotion leftovers) become dense 128-lane "chips", reduced per
row (the CSR-vector shape of the reference study's block-per-row CUDA
kernel, cuda_csr.cu:96-140):

1. stage 1 (:func:`ext_gather.sorted_gather`): the tail's sorted unique
   columns become a compact hot region (H, 128);
2. stage 2 (:func:`ext_gather.ranked_gather`): every tail entry reads its
   x value from the hot region into the chip layout;
3. ``prod = vals * xg``, a PyTorch multiply as in the reference (an XLA
   elementwise op outside its kernels, chips_tail.py:839);
4. :func:`segsum_kernel.window_segsum` reduces the chips to one sum per
   heavy row (8 heavy rows per block, quantum (tile, lane) holding one
   rank of a block's 8 rows);
5. the landing (:func:`make_landing`) adds the per-row sums into y: a
   windowed or ranked panel merge through the gathers, or ``index_add_``
   on the unique heavy rows when the merge tables exceed their budget.

The device functions take ``ops``, the kernels to run by name
(``lane_ell.KERNELS``, or ``lane_ell.PLAIN`` for the plain versions).
The host planner is a JAX-free copy of the reference's. The split plan
(``plan_chips_split``, used when the tail's unique columns exceed the
resident budgets) is not ported yet: where the reference would plan one,
:func:`plan_chips` returns None for a tail that the hybrid sends to its
big-tail branch anyway (the reference drops a split plan past
``BIG_TAIL`` entries), and raises ``NotImplementedError`` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import ext_gather, segsum_kernel

# resident stage-2 hot cap, in rows of 128 lanes (= ext_gather.H_MAX)
H_CAP = ext_gather.H_MAX
# stage-2 work budget of the reference's cost model (H * 128 * 3 ops
# per chip row), kept for parity
VPU_BUDGET = 2e8
# default stage-1 window reach (panels); adaptive per unique spacing
R_PANELS = 512
# hot cap of the windowed gather (the windowed merge's region)
H_WIN_CAP = 16384
# local/far diagonal split distance of the split plan (its feasibility
# proxy in the hybrid's packer uses it)
W_LOC = 4096
# windowed-merge reach (rows of the padded per-row sums): heavy ranks
# are contiguous per 128-row output group, so a group's slots span <= 2
# rows, +8 for the 8-row base alignment
MERGE_R_H = 16

_TODO_SPLIT = ("ROADMAP queue 1 #7 (split chips plan: plan_chips_split, "
               "_prepare_stream)")

def _adaptive_r(uniq: np.ndarray, cap: int = R_PANELS) -> int:
    """Stage-1 window reach: smallest power-of-two panel count whose
    windows hold 1024 consecutive uniques."""
    if uniq.size <= 8 * BC:
        span = int(uniq[-1] // BC - uniq[0] // BC) + 1 if uniq.size \
            else 1
    else:
        s = uniq[8 * BC - 1:] // BC - uniq[:-(8 * BC) + 1] // BC
        span = int(s.max()) + 1
    r = 8
    while r < span and r < cap:
        r *= 2
    return r


def _window_pack(blk_w: np.ndarray, num_windows: int, h: int,
                 qps: int):
    """Assign quanta (block-major) to a window-grouped padded stream;
    every window gets >= 1 step. Returns (new_q, rbl_src, win_of_step,
    n_q_pad)."""
    q_blk = np.repeat(np.arange(blk_w.size), blk_w)
    q_win = q_blk // h
    n_q = q_blk.size
    new_q = np.full(n_q, -1, np.int64)
    win_of_step_l: list[int] = []
    cur = 0
    for w in range(num_windows):
        qi = np.flatnonzero(q_win == w)
        new_q[qi] = cur + np.arange(qi.size)
        n_steps_w = max(1, -(-qi.size // qps))
        win_of_step_l.extend([w] * n_steps_w)
        cur += n_steps_w * qps
    rbl_src = (q_blk - q_win * h).astype(np.int32)
    return new_q, rbl_src, np.asarray(win_of_step_l, np.int64), cur


def _heavy_index(rows: np.ndarray, by_len_only: bool):
    hr, first, cnt = np.unique(rows, return_index=True,
                               return_counts=True)
    NH = int(hr.size)
    if by_len_only:
        order = np.argsort(-cnt, kind="stable")
    else:       # (ceil-log2 length, row id): similar length AND nearby
        lg = np.ceil(np.log2(np.maximum(cnt, 1))).astype(np.int64)
        order = np.argsort((lg << 44) + hr, kind="stable")
    hpos_of_row = np.empty(NH, np.int64)
    hpos_of_row[order] = np.arange(NH)
    e_row_i = np.searchsorted(hr, rows)
    e_hpos = hpos_of_row[e_row_i]
    return hr[order], hpos_of_row, e_row_i, e_hpos, first, cnt, NH


class ChipsPlan:
    __slots__ = ("n_e", "H", "n_groups", "R", "n1p_blocks", "base",
                 "p1", "l1", "E8", "p2", "l2", "vals", "rbl",
                 "win_of_step", "num_windows", "h", "rows_per_step",
                 "heavy_ids", "NH")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def plan_chips(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               m: int, n: int, h: int = 256, rows_per_step: int = 8,
               big_tail: bool = False):
    """Plan the chips tail for ``(rows, cols, vals)`` entries (CSR
    order): the single resident pipeline when the dedup'd columns fit
    the budgets. Where the reference would fall back to the split plan,
    this returns None when ``big_tail`` (the caller drops a split plan
    for its big-tail branch, as the reference does past ``BIG_TAIL``
    entries, and a split planner that gives up leads there too) and
    raises ``NotImplementedError`` otherwise. None for no entries."""
    n_e = int(rows.size)
    if n_e == 0:
        return None
    uniq = np.unique(cols)
    e8_est = -(-n_e // BC) + 2 * (-(-int(np.unique(rows).size) // 8))
    Hs_est = -(-uniq.size // BC) + 8   # + group-split padding slack
    if (Hs_est <= H_CAP
            and e8_est * Hs_est * BC * 3 <= VPU_BUDGET):
        p = _plan_single(rows, cols, vals, m, n, h, rows_per_step)
        if p is not None:
            return p
    if big_tail:
        return None
    raise NotImplementedError(
        f"chips tail: {n_e} entries over {uniq.size} unique columns need "
        f"the split plan: {_TODO_SPLIT}")


def _plan_single(rows, cols, vals, m, n, h, rows_per_step,
                 r_cap: int | None = None):
    n_e = int(rows.size)
    uniq, inv = np.unique(cols, return_inverse=True)
    r1 = r_cap if r_cap is not None else _adaptive_r(uniq)
    base, p1, l1, pos, Hs, n_groups, n1p_blocks = \
        ext_gather.pack_sorted_uniques(uniq, n, r1)
    if Hs > H_CAP:
        return None

    hr_sorted, hpos_of_row, e_row_i, e_hpos, first, cnt, NH = \
        _heavy_index(rows, by_len_only=True)
    blk = e_hpos // 8
    sub = e_hpos % 8
    cnt_sorted = np.zeros(NH, np.int64)
    cnt_sorted[hpos_of_row] = cnt
    blk_w = np.zeros(-(-NH // 8), np.int64)
    np.maximum.at(blk_w, np.arange(NH) // 8, cnt_sorted)
    num_windows = max(1, -(-int(blk_w.size) // h))
    qps = (rows_per_step // 8) * BC
    new_q, rbl_src, win_of_step, n_q_pad = _window_pack(
        blk_w, num_windows, h, qps)
    blk_q0 = np.concatenate([[0], np.cumsum(blk_w)])
    rank = np.arange(n_e) - first[e_row_i]
    q_of_e = new_q[blk_q0[blk] + rank]
    steps = n_q_pad // qps
    E8 = steps * rows_per_step
    if E8 * Hs * BC * 3 > VPU_BUDGET:
        return None

    tile = q_of_e // BC
    lane = q_of_e % BC
    erow = tile * 8 + sub
    vals_a = np.zeros((E8, BC), np.float32)
    p2 = np.zeros((E8, BC), np.int32)
    l2 = np.zeros((E8, BC), np.int32)
    vals_a[erow, lane] = vals
    hotpos = pos[inv]
    p2[erow, lane] = (hotpos // BC).astype(np.int32)
    l2[erow, lane] = (hotpos % BC).astype(np.int32)
    rbl = np.full(n_q_pad, h, np.int32)
    rbl[new_q] = rbl_src

    return ChipsPlan(
        n_e=n_e, H=Hs, n_groups=n_groups, R=r1,
        n1p_blocks=n1p_blocks, base=base,
        p1=p1, l1=l1, E8=E8, p2=p2, l2=l2, vals=vals_a, rbl=rbl,
        win_of_step=win_of_step, num_windows=num_windows, h=h,
        rows_per_step=rows_per_step, heavy_ids=hr_sorted, NH=NH)


def _put(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def prepare_chips(plan: ChipsPlan, n: int, device):
    """Device pipeline of a single plan: returns ``(contrib, hbm)``,
    where ``contrib(xf, ops) -> ys`` (NH,) f32 gives the
    per-heavy-row sums in ``plan.heavy_ids`` order for x (f32, on
    ``device``)."""
    base = _put(plan.base, torch.int32, device)
    p1 = _put(plan.p1, torch.int32, device)
    l1 = _put(plan.l1, torch.int32, device)
    p2 = _put(plan.p2, torch.int32, device)
    l2 = _put(plan.l2, torch.int32, device)
    vals = _put(plan.vals, torch.float32, device)
    rbl = _put(plan.rbl, torch.int32, device)
    win = _put(plan.win_of_step, torch.int32, device)
    lists = segsum_kernel.device_lists(segsum_kernel.window_rel(
        plan.rbl, plan.win_of_step.size), plan.h, device)
    n1 = plan.n1p_blocks * plan.R * BC
    NH = plan.NH

    def contrib(xf, ops):
        x1 = torch.zeros(n1, dtype=torch.float32, device=xf.device)
        x1[:n] = xf
        hot = ops.sorted_gather(base, x1.view(-1, BC), p1, l1, plan.R)
        xg = ops.ranked_gather(hot, p2, l2)
        ys = ops.window_segsum(vals * xg, rbl, win, plan.num_windows,
                               plan.h, plan.rows_per_step, lists)
        return ys.view(-1)[:NH]

    hbm = (plan.E8 * BC * (4 + 4 + 4 + 4)        # vals, p2, l2, xg
           + plan.n_groups * plan.R * BC * 4    # stage-1 windows
           + plan.NH * 4)
    return contrib, int(hbm)


# ---------------------------------------------------------------------------
# The heavy-row landing
# ---------------------------------------------------------------------------

def _merge_h8(NH: int) -> int:
    """Height of the padded per-row sums for the panel merge: more than
    NH/128 rows (slot NH is the guaranteed-zero pad entry), a multiple
    of 8."""
    return -(-(NH // BC + 1) // 8) * 8


def merge_tables(heavy_ids: np.ndarray, m: int, G_pad: int,
                 budget: float = 6e8):
    """Host (p2, l2) tables of the ranked panel merge, or None when NH
    exceeds the budgets. Each 128-row output group's lane points at its
    heavy row's slot in the padded sums; unset lanes point at slot NH,
    which holds 0."""
    NH = int(heavy_ids.size)
    if NH and int(heavy_ids.max()) >= min(m, G_pad * BC):
        raise ValueError("heavy_ids must index rows (< m <= G_pad*128)")
    H8 = _merge_h8(NH)
    G_out = -(-G_pad // 8) * 8
    if H8 > H_CAP or G_out * H8 * BC * 3 > budget:
        return None
    p2 = np.full((G_out, BC), NH // BC, np.int32)
    l2 = np.full((G_out, BC), NH % BC, np.int32)
    grp = (heavy_ids // BC).astype(np.int64)
    lane = (heavy_ids % BC).astype(np.int64)
    k = np.arange(NH, dtype=np.int64)
    p2[grp, lane] = (k // BC).astype(np.int32)
    l2[grp, lane] = (k % BC).astype(np.int32)
    return p2, l2


def merge_tables_windowed(heavy_ids: np.ndarray, m: int, G_pad: int,
                          r_h: int = MERGE_R_H):
    """Windowed variant of :func:`merge_tables`: per-output-row window
    bases, O(r_h) per output row. Needs ascending heavy ids (ranks are
    then contiguous per group); out-of-window lanes (p == r_h) gather 0.
    Returns (base8, p2, l2, H8) or None."""
    NH = int(heavy_ids.size)
    if NH and int(heavy_ids.max()) >= min(m, G_pad * BC):
        raise ValueError("heavy_ids must index rows (< m <= G_pad*128)")
    if NH and np.any(np.diff(heavy_ids) <= 0):
        return None
    H8 = max(_merge_h8(NH), r_h)
    if H8 > H_WIN_CAP:
        return None
    G_out = -(-G_pad // 8) * 8
    k = np.arange(NH, dtype=np.int64)
    grp = (heavy_ids // BC).astype(np.int64)
    lane = (heavy_ids % BC).astype(np.int64)
    k_lo = np.searchsorted(heavy_ids, np.arange(G_out) * BC)
    base8 = np.clip(k_lo // BC // 8, 0, (H8 - r_h) // 8).astype(
        np.int32)
    p2 = np.full((G_out, BC), r_h, np.int32)   # out-of-window => 0
    l2 = np.zeros((G_out, BC), np.int32)
    p2[grp, lane] = (k // BC - base8[grp].astype(np.int64) * 8) \
        .astype(np.int32)
    l2[grp, lane] = (k % BC).astype(np.int32)
    if NH and not ((0 <= p2[grp, lane]).all()
                   and (p2[grp, lane] < r_h).all()):
        raise AssertionError("merge window overflow")
    return base8, p2, l2, H8


def merge_hbm(NH: int, G_pad: int) -> int:
    """Bytes the panel merge streams per call: p2/l2/out lanes (12 B
    each) + the padded per-row sums."""
    G_out = -(-G_pad // 8) * 8
    return G_out * BC * 12 + _merge_h8(NH) * BC * 4


def make_merge_apply(NH: int, m: int, use_merge: bool):
    """``apply(y, ys, *tables, ops=ops) -> y'`` adding the
    per-heavy-row sums ``ys`` (NH,) into y (m,). ``use_merge``: the
    ranked panel merge, tables = (p2, l2) from :func:`merge_tables`;
    else the scalar fallback, ``index_add_`` on the unique heavy rows,
    tables = (hid,)."""
    if use_merge:
        H8 = _merge_h8(NH)

        def apply(y, ys, p2, l2, ops):
            ysp = torch.zeros(H8 * BC, dtype=torch.float32, device=y.device)
            ysp[:NH] = ys
            return y + ops.ranked_gather(
                ysp.view(H8, BC), p2, l2).view(-1)[:m]
    else:
        def apply(y, ys, hid, ops):
            return y.index_add_(0, hid, ys)
    return apply


def make_merge_apply_windowed(NH: int, m: int, H8: int,
                              r_h: int = MERGE_R_H):
    """``apply(y, ys, base8, p2, l2, ops=ops) -> y'`` for the
    windowed merge tables, O(r_h) per output row."""

    def apply(y, ys, base8, p2, l2, ops):
        ysp = torch.zeros(H8 * BC, dtype=torch.float32, device=y.device)
        ysp[:NH] = ys
        return y + ops.window_gather(
            base8, ysp.view(H8, BC), p2, l2, r_h).view(-1)[:m]

    return apply


def landing_tables(heavy_ids: np.ndarray, m: int, G_pad: int,
                   budget: float = 6e8):
    """The landing's host decision: ``("windowed", (base8, p2, l2,
    H8))``, ``("ranked", (p2, l2))`` or ``("scatter", None)``."""
    tw = merge_tables_windowed(heavy_ids, m, G_pad)
    if tw is not None:
        return "windowed", tw
    t = merge_tables(heavy_ids, m, G_pad, budget)
    return ("ranked", t) if t is not None else ("scatter", None)


def make_landing(heavy_ids: np.ndarray, m: int, G_pad: int, device,
                 budget: float = 6e8, tables: tuple | None = None):
    """The heavy-row landing, composed: returns ``(land, use_merge,
    extra_hbm)`` with ``land(y, ys, ops) -> y'`` adding the
    per-heavy-row sums into a dense y. Prefers the windowed panel merge,
    then the ranked one, and falls back to ``index_add_`` on the unique
    heavy rows when the tables exceed the budgets. ``tables`` passes
    :func:`landing_tables`' result when the caller already has it."""
    NH = int(heavy_ids.size)
    kind, t = tables if tables is not None else landing_tables(
        heavy_ids, m, G_pad, budget)
    if kind == "windowed":
        base8, p2, l2, H8 = t
        apply = make_merge_apply_windowed(NH, m, H8)
        tabs = (_put(base8, torch.int32, device),
                _put(p2, torch.int32, device), _put(l2, torch.int32, device))
    elif kind == "ranked":
        apply = make_merge_apply(NH, m, True)
        tabs = (_put(t[0], torch.int32, device),
                _put(t[1], torch.int32, device))
    else:
        apply = make_merge_apply(NH, m, False)
        tabs = (_put(heavy_ids, torch.int64, device),)
    use_merge = kind != "scatter"
    extra = merge_hbm(NH, G_pad) if use_merge else 0

    def land(y, ys, ops):
        return apply(y, ys, *tabs, ops=ops)

    return land, use_merge, extra

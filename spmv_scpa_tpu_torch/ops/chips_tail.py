"""The chips tail on PyTorch and CUDA (counterpart of
``spmv_scpa_tpu/ops/chips_tail.py``).

Entries the lane-ELL core cannot hold (rows longer than its Q slot
planes, demotion leftovers) become dense 128-lane "chips", reduced per
row (the CSR-vector shape of the reference study's block-per-row CUDA
kernel, cuda_csr.cu:96-140). The planners (:func:`plan_chips`,
:func:`plan_chips_split`) are JAX-free copies of the reference's and
produce its arrays. A call runs three kernels:

1. :func:`chips_slots.chips_products` forms ``vals * x[col]`` for every
   chip slot of every stream of a plan (of every shard of a card, on the
   row-sharded hybrid) in one launch, reading x in place. The reference
   stages x for a TPU in two gathers (stage 1,
   :func:`ext_gather.sorted_gather`, packs the tail's unique columns into
   a compact hot region; stage 2, :func:`ext_gather.ranked_gather` or
   :func:`ext_gather.window_gather`, reads each slot's value from it) and
   multiplies; every route of those stages depends on the plan alone, so
   :func:`chips_slots.slots_table` resolves them on the host into one x
   column per slot. The plans record which slots hold an entry
   (``live``), and a slot without one reads no x.
2. :func:`segsum_kernel.window_segsum` reduces the products to one sum
   per heavy row (8 heavy rows per block, quantum (tile, lane) holding
   one rank of a block's 8 rows), one launch over every stream of every
   plan (:func:`bind_sums`: one table whose windows stack the plans'
   heavy-row spaces).
3. :func:`heavy_land` (``csrc/heavy_land.cu``) adds each heavy row's sum
   into its row of y in place, through an int32 map built on the host
   (:func:`land_map`). The reference lands the sums by a panel merge
   through its gathers, or ``index_add_`` past the merge's budget; the
   meta records its choice (``panel_merge``, :func:`merge_kind`), and no
   merge table is built.

**Split mode** (:func:`plan_chips_split`), when the tail's unique
columns exceed the single plan's budgets: entries split by diagonal
distance. *Local* entries ride a windowed stage 2 over x itself
(``windowed-x``) or, past the windowed gather's cap, over a dedup'd hot
region (``windowed``); *far* entries, and local ones past the window's
reach, ride the resident stage 2, split by column popularity into a
``far`` and a ``cold`` stream when one resident stream would not fit.
The streams share one heavy-row space, and the one segment-sum adds a
heavy row's quanta of all of them.

For the row-sharded hybrid (``parallel/distributed.py``),
:func:`pad_resident_plan` and :func:`pad_split_plan` pad per-shard plans
to shared shapes, every padded slot adding exactly zero.

The device functions take ``ops``, the kernels to run by name
(:data:`KERNELS`, ``lane_ell.KERNELS``, or a ``PLAIN`` for the plain
versions). ``cuda-chips`` (:func:`prepare_chips_strategy`) runs a whole
matrix as chips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import chips_slots, ext_gather, segsum_kernel
from spmv_scpa_tpu_torch.ops.registry import Prepared, record_calls
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# resident stage-2 hot cap, in rows of 128 lanes (= ext_gather.H_MAX)
H_CAP = ext_gather.H_MAX
# stage-2 work budget of the reference's cost model (H * 128 * 3 ops
# per chip row), kept for parity
VPU_BUDGET = 2e8
# the same budget per stream of a split plan
SPLIT_VPU_BUDGET = 1.2e9
# default stage-1 window reach (panels); adaptive per unique spacing
R_PANELS = 512
# windowed stage-2 reach (rows of the hot region), and the hot cap of
# the windowed gather (the split plan's local stream; the reference's
# windowed merge, :func:`merge_kind`)
R_HOT = 128
H_WIN_CAP = 16384
# local/far diagonal split distance of the split plan (its feasibility
# proxy in the hybrid's packer uses it)
W_LOC = 4096

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


def _subset_ranks(sel: np.ndarray, e_row_i: np.ndarray, NH: int):
    """Rank of each selected entry among its row's selected entries
    (entries row-grouped in input order)."""
    excl = np.cumsum(sel) - sel
    start = np.full(NH, np.iinfo(np.int64).max, np.int64)
    if sel.any():
        np.minimum.at(start, e_row_i[sel], excl[sel])
    return excl - start[e_row_i]


class ChipsPlan:
    __slots__ = ("n_e", "H", "n_groups", "R", "n1p_blocks", "base",
                 "p1", "l1", "E8", "p2", "l2", "vals", "rbl",
                 "win_of_step", "num_windows", "h", "rows_per_step",
                 "heavy_ids", "NH", "live", "n_real")

    def __init__(self, **kw):
        kw.setdefault("n_real", kw["NH"])
        for k, v in kw.items():
            setattr(self, k, v)


class _Stream:
    """One gather + segment-sum stream of a split plan. ``kind``:
    ``"windowed-x"`` (windowed stage 2 over x itself, no stage 1),
    ``"windowed"`` (stage 1, then the windowed stage 2) or
    ``"resident"`` (stage 1, then the resident stage 2)."""
    __slots__ = ("kind", "base1", "p1", "l1", "n1p_blocks", "r1", "H",
                 "E8", "p2", "l2", "vals", "rbl", "win_of_step",
                 "base8", "H_pad", "r_hot", "n_entries", "live")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class SplitChipsPlan:
    __slots__ = ("n_e", "h", "rows_per_step", "num_windows",
                 "heavy_ids", "NH", "loc", "far", "cold", "pop_k", "n_real")

    def __init__(self, **kw):
        kw.setdefault("cold", None)
        kw.setdefault("pop_k", None)
        kw.setdefault("n_real", kw["NH"])
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def streams(self):
        return tuple(s for s in (self.loc, self.far, self.cold)
                     if s is not None)


def _placeholder_stream(kind_key: str, *, n: int, h: int,
                        rows_per_step: int, num_windows: int,
                        r_hot: int | None, r_far: int | None):
    """A zero-entry stream of well-formed minimal shapes, for a shard
    that lacks a stream the shards' shared set demands: every window gets
    one step and every slot holds value 0. :func:`pad_split_plan` then
    pads it to the shared shapes like any stream."""
    qps = (rows_per_step // 8) * BC
    blk_w = np.zeros(1, np.int64)
    _, _, wos, n_q_pad = _window_pack(blk_w, num_windows, h, qps)
    steps = n_q_pad // qps
    E8 = steps * rows_per_step
    vals_a = np.zeros((E8, BC), np.float32)
    p2 = np.zeros((E8, BC), np.int32)
    l2 = np.zeros((E8, BC), np.int32)
    rbl = np.full(n_q_pad, h, np.int32)
    live = np.zeros((E8, BC), bool)
    if kind_key == "loc":
        rh = r_hot if r_hot else 16
        return _Stream(kind="windowed-x", base1=None, p1=None, l1=None,
                       n1p_blocks=0, r1=0, H=-(-n // BC), E8=E8,
                       p2=p2, l2=l2, vals=vals_a, rbl=rbl,
                       win_of_step=wos,
                       base8=np.zeros(E8, np.int32),
                       H_pad=-(-n // BC) + rh, r_hot=rh, n_entries=0,
                       live=live)
    r1 = r_far if r_far else R_PANELS
    n_panels = -(-n // BC)
    return _Stream(kind="resident",
                   base1=np.zeros(1, np.int32),
                   p1=np.zeros((8, BC), np.int32),
                   l1=np.zeros((8, BC), np.int32),
                   n1p_blocks=max(-(-n_panels // r1), 1), r1=r1,
                   H=8, E8=E8, p2=p2, l2=l2, vals=vals_a, rbl=rbl,
                   win_of_step=wos, base8=None, H_pad=8, r_hot=0,
                   n_entries=0, live=live)


@trace.span("pack.plan", fn="plan_chips")
def plan_chips(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               m: int, n: int, h: int = 256, rows_per_step: int = 8,
               big_tail: bool = False):
    """Plan the chips tail for ``(rows, cols, vals)`` entries (CSR
    order): the single resident pipeline when the dedup'd columns fit
    the budgets, else the split plan (:func:`plan_chips_split`). With
    ``big_tail`` the split plan is not tried and None comes back instead:
    the hybrid drops a split plan past ``BIG_TAIL`` entries for its
    big-tail branch (reference lane_ell.py:1459-1471), so planning one
    there would be wasted. None when neither plan fits, or for no
    entries."""
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
    return plan_chips_split(rows, cols, vals, m, n, h, rows_per_step)


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
    live = np.zeros((E8, BC), bool)
    live[erow, lane] = True
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
        rows_per_step=rows_per_step, heavy_ids=hr_sorted, NH=NH, live=live)


def pad_resident_plan(plan: ChipsPlan, *, n_groups: int,
                      n1p_blocks: int, steps: int, num_windows: int,
                      NH: int, heavy_pad_pool: np.ndarray) -> ChipsPlan:
    """Pad a single plan to shapes shared by several row shards (all
    planned with one ``R``, ``h`` and ``rows_per_step``); every padded
    slot adds exactly zero:

    * extra stage-1 groups gather into hot rows no ``p2`` names;
    * extra chip rows hold value 0;
    * extra steps first give every window this shard lacks one step
      (the segment-sum writes every window it is given), then repeat the
      last window, so ``win_of_step`` stays non-decreasing;
    * extra heavy slots take ids from ``heavy_pad_pool`` (rows with no
      tail entries on this shard: their sums are 0); ``n_real`` keeps
      the number of real ranks, and the landing (:func:`land_map`) adds
      nothing for the others.
    """
    h, rps = plan.h, plan.rows_per_step
    qps = (rps // 8) * BC
    pad_g = n_groups - plan.n_groups
    if not (pad_g >= 0 and steps * rps >= plan.E8 >= 0):
        raise AssertionError((pad_g, steps, plan.E8))
    base = np.concatenate([plan.base, np.zeros(pad_g, np.int32)])
    p1 = np.concatenate(
        [plan.p1, np.zeros((pad_g * 8, BC), np.int32)])
    l1 = np.concatenate(
        [plan.l1, np.zeros((pad_g * 8, BC), np.int32)])
    wos = list(plan.win_of_step)
    wos.extend(range(plan.num_windows, num_windows))
    if len(wos) > steps:
        raise AssertionError((len(wos), steps))
    wos.extend([num_windows - 1] * (steps - len(wos)))
    pad_e = steps * rps - plan.E8
    vals = np.concatenate(
        [plan.vals, np.zeros((pad_e, BC), np.float32)])
    p2 = np.concatenate([plan.p2, np.zeros((pad_e, BC), np.int32)])
    l2 = np.concatenate([plan.l2, np.zeros((pad_e, BC), np.int32)])
    live = np.concatenate([plan.live, np.zeros((pad_e, BC), bool)])
    rbl = np.concatenate(
        [plan.rbl,
         np.full(steps * qps - plan.rbl.size, h, np.int32)])
    pad_n = NH - plan.NH
    if not (pad_n >= 0 and heavy_pad_pool.size >= pad_n):
        raise AssertionError((pad_n, heavy_pad_pool.size))
    heavy = np.concatenate(
        [plan.heavy_ids,
         heavy_pad_pool[:pad_n].astype(plan.heavy_ids.dtype)])
    return ChipsPlan(
        n_e=plan.n_e, H=n_groups * 8, n_groups=n_groups, R=plan.R,
        n1p_blocks=n1p_blocks, base=base, p1=p1, l1=l1,
        E8=steps * rps, p2=p2, l2=l2, vals=vals, rbl=rbl,
        win_of_step=np.asarray(wos, np.int64),
        num_windows=num_windows, h=h, rows_per_step=rps,
        heavy_ids=heavy, NH=NH, live=live, n_real=plan.n_real)


def split_shape_template(plans: list) -> dict:
    """The shapes shared by several shards' split plans, all planned with
    the same forced decisions (``r_hot``, ``r_far``, ``r_cold``,
    ``x_direct``, ``force_streams``): the padding targets of
    :func:`pad_split_plan`."""
    tpl = {"NH": max(p.NH for p in plans),
           "num_windows": max(p.num_windows for p in plans)}
    for k in ("loc", "far", "cold"):
        ss = [getattr(p, k) for p in plans]
        if any(s is None for s in ss):
            if not all(s is None for s in ss):
                raise AssertionError(f"stream '{k}' present on some shards "
                                     "only")
            continue
        ent = {"steps": max(s.E8 // p.rows_per_step
                            + (tpl["num_windows"] - p.num_windows)
                            for s, p in zip(ss, plans)),
               "H_pad": max(s.H_pad for s in ss)}
        if len({s.kind for s in ss}) != 1:
            raise AssertionError(f"mixed '{k}' kinds")
        if ss[0].kind != "windowed-x":          # has stage-1 tables
            ent["n_groups"] = max(s.p1.shape[0] // 8 for s in ss)
            ent["n1p_blocks"] = max(s.n1p_blocks for s in ss)
            if len({s.r1 for s in ss}) != 1:
                raise AssertionError("unforced r1")
        if ss[0].kind in ("windowed", "windowed-x") \
                and len({s.r_hot for s in ss}) != 1:
            raise AssertionError("unforced r_hot")
        tpl[k] = ent
    return tpl


def pad_split_plan(plan: SplitChipsPlan, tpl: dict,
                   heavy_pad_pool: np.ndarray) -> SplitChipsPlan:
    """Pad one shard's split plan to the template's shapes
    (:func:`pad_resident_plan`'s zero-adding padding, per stream)."""
    h, rps = plan.h, plan.rows_per_step
    qps = (rps // 8) * BC
    nw = tpl["num_windows"]

    def pad_stream(s: _Stream, ent: dict) -> _Stream:
        steps = ent["steps"]
        wos = list(s.win_of_step)
        wos.extend(range(plan.num_windows, nw))
        if len(wos) > steps:
            raise AssertionError((len(wos), steps))
        wos.extend([nw - 1] * (steps - len(wos)))
        pad_e = steps * rps - s.E8
        if pad_e < 0:
            raise AssertionError(pad_e)
        vals = np.concatenate(
            [s.vals, np.zeros((pad_e, BC), np.float32)])
        p2 = np.concatenate([s.p2, np.zeros((pad_e, BC), np.int32)])
        l2 = np.concatenate([s.l2, np.zeros((pad_e, BC), np.int32)])
        rbl = np.concatenate(
            [s.rbl, np.full(steps * qps - s.rbl.size, h, np.int32)])
        kw = dict(kind=s.kind, n1p_blocks=s.n1p_blocks, r1=s.r1,
                  H=s.H, E8=steps * rps, p2=p2, l2=l2, vals=vals,
                  rbl=rbl, win_of_step=np.asarray(wos, np.int64),
                  H_pad=ent["H_pad"], r_hot=s.r_hot,
                  n_entries=s.n_entries, base1=s.base1, p1=s.p1,
                  l1=s.l1, base8=s.base8,
                  live=np.concatenate([s.live,
                                       np.zeros((pad_e, BC), bool)]))
        if s.base8 is not None:             # windowed / windowed-x
            kw["base8"] = np.concatenate(
                [s.base8, np.zeros(pad_e, np.int32)])
        if s.kind != "windowed-x":          # has stage-1 tables
            pad_g = ent["n_groups"] - s.p1.shape[0] // 8
            if pad_g < 0:
                raise AssertionError(pad_g)
            kw["base1"] = np.concatenate(
                [s.base1, np.zeros(pad_g, np.int32)])
            kw["p1"] = np.concatenate(
                [s.p1, np.zeros((pad_g * 8, BC), np.int32)])
            kw["l1"] = np.concatenate(
                [s.l1, np.zeros((pad_g * 8, BC), np.int32)])
            kw["n1p_blocks"] = ent["n1p_blocks"]
            kw["H"] = ent["n_groups"] * 8
            if s.kind == "resident":
                kw["H_pad"] = ent["n_groups"] * 8
        return _Stream(**kw)

    pad_n = tpl["NH"] - plan.NH
    if not (pad_n >= 0 and heavy_pad_pool.size >= pad_n):
        raise AssertionError((pad_n, heavy_pad_pool.size))
    heavy = np.concatenate(
        [plan.heavy_ids,
         heavy_pad_pool[:pad_n].astype(plan.heavy_ids.dtype)])
    out = {k: (pad_stream(getattr(plan, k), tpl[k])
               if getattr(plan, k) is not None else None)
           for k in ("loc", "far", "cold")}
    return SplitChipsPlan(n_e=plan.n_e, h=h, rows_per_step=rps,
                          num_windows=nw, heavy_ids=heavy,
                          NH=tpl["NH"], n_real=plan.n_real, **out)


@trace.span("pack.plan", fn="plan_chips_split")
def plan_chips_split(rows, cols, vals, m, n, h: int = 256,
                     rows_per_step: int = 8, w_loc: int = W_LOC,
                     r_hot: int | None = None,
                     x_direct: bool | None = None,
                     r_far: int | None = None,
                     r_cold: int | None = None,
                     pop_k: int | None = None,
                     force_streams: tuple | None = None):
    """The local/far split plan (module docstring). Returns None when the
    far side exceeds the resident budgets. ``x_direct`` overrides the
    choice between the direct-x and the dedup'd local stream.

    The other keywords force decisions to values shared by several row
    shards: ``r_far``/``r_cold`` pin the far and cold stage-1 reach,
    ``pop_k`` the popularity cutoff (0: no split), and ``force_streams``
    (a subset of {"loc", "far", "cold"}) the set of streams: a shard
    lacking one gets a zero-entry placeholder, and one needing a stream
    outside the set gets None."""
    n_e = int(rows.size)
    if n_e == 0:
        return None
    hr_sorted, hpos_of_row, e_row_i, e_hpos, first, cnt, NH = \
        _heavy_index(rows, by_len_only=False)
    blk = e_hpos // 8
    sub = e_hpos % 8
    nblocks = -(-NH // 8)
    num_windows = max(1, -(-nblocks // h))
    qps = (rows_per_step // 8) * BC

    loc = np.abs(cols - rows) <= w_loc

    def _cnt_per_hpos(sel):
        c = np.zeros(NH, np.int64)
        if sel.any():
            np.add.at(c, e_hpos[sel], 1)
        return c

    def _blk_w(cnt_h):
        bw = np.zeros(nblocks, np.int64)
        np.maximum.at(bw, np.arange(NH) // 8, cnt_h)
        return bw

    # ---- the local stream (windowed stage 2) ---------------------------
    # Its gather source: x itself (windowed-x: no stage 1, no dedup) while
    # x fits the windowed gather's cap, else the dedup'd hot region.
    stream_l = None
    migrate = np.zeros(n_e, bool)
    if x_direct is None:
        x_direct = -(-n // BC) + (r_hot or 512) <= H_WIN_CAP
    if loc.any():
        if x_direct:
            base1 = p1 = l1 = None
            ngl, n1pb, r1l, Hl = 0, 0, 0, -(-n // BC)
        else:
            uniq_l = np.unique(cols[loc])
            r1l = _adaptive_r(uniq_l)
            base1, p1, l1, posu, Hl, ngl, n1pb = \
                ext_gather.pack_sorted_uniques(uniq_l, n, r1l)
            if Hl + (r_hot or 512) > H_WIN_CAP:
                return None
        blk_wl = _blk_w(_cnt_per_hpos(loc))
        # dedup'd positions: every block's quanta rounded up to whole
        # tiles (a tile stays in one block); direct-x: no rounding (the
        # heavy rows' (length, id) order keeps a tile's rows near)
        if not x_direct:
            blk_wl = np.where(blk_wl > 0, -(-blk_wl // BC) * BC, 0)
        new_q, rbl_src, wos, n_q_pad = _window_pack(
            blk_wl, num_windows, h, qps)
        blk_q0 = np.concatenate([[0], np.cumsum(blk_wl)])
        rank_l = _subset_ranks(loc, e_row_i, NH)
        li = np.flatnonzero(loc)
        q_of_e = new_q[blk_q0[blk[li]] + rank_l[li]]
        steps = n_q_pad // qps
        E8 = steps * rows_per_step
        tile = q_of_e // BC
        lane = q_of_e % BC
        erow = tile * 8 + sub[li]
        if x_direct:
            pos_e = cols[li]              # x positions directly
        else:
            pos_e = posu[np.searchsorted(uniq_l, cols[li])]
        psub = pos_e // BC
        # per table row window base (8-row units); entries past the
        # reach migrate to the far stream, their slots left as padding
        tmin = np.full(E8, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(tmin, erow, psub)
        base8 = np.where(tmin == np.iinfo(np.int64).max, 0,
                         tmin // 8).astype(np.int32)
        off = psub - base8[erow].astype(np.int64) * 8
        if r_hot is None:
            # reach covering ~97% of the entries, a multiple of 8
            tgt = int(np.percentile(off, 97)) + 1 if off.size else 1
            r_hot = int(min(max(-(-tgt // 8) * 8, 16), 512))
        if E8 * r_hot * BC * 3 > SPLIT_VPU_BUDGET:
            return None
        fits = off < r_hot
        migrate[li[~fits]] = True
        ef, lf, oi = erow[fits], lane[fits], li[fits]
        vals_a = np.zeros((E8, BC), np.float32)
        p2 = np.zeros((E8, BC), np.int32)
        l2 = np.zeros((E8, BC), np.int32)
        vals_a[ef, lf] = vals[oi]
        live = np.zeros((E8, BC), bool)
        live[ef, lf] = True
        p2[ef, lf] = off[fits].astype(np.int32)
        l2[ef, lf] = (pos_e[fits] % BC).astype(np.int32)
        rbl = np.full(n_q_pad, h, np.int32)
        rbl[new_q] = rbl_src
        H_pad = int(base8.max(initial=0)) * 8 + r_hot
        stream_l = _Stream(kind="windowed-x" if x_direct else
                           "windowed", base1=base1, p1=p1, l1=l1,
                           n1p_blocks=n1pb, r1=r1l, H=Hl, E8=E8,
                           p2=p2, l2=l2, vals=vals_a, rbl=rbl,
                           win_of_step=wos, base8=base8, H_pad=H_pad,
                           r_hot=r_hot, n_entries=int(fits.sum()),
                           live=live)

    # ---- the far stream(s) (resident stage 2) --------------------------
    def _resident_stream(sel, r_cap=None):
        """One resident stream for the entries in ``sel``; None when
        their dedup'd columns exceed the budgets."""
        uniq_f = np.unique(cols[sel])
        if -(-uniq_f.size // BC) > H_CAP:
            return None
        r1f = r_cap if r_cap is not None else _adaptive_r(uniq_f)
        base1, p1, l1, posu, Hf, ngf, n1pb = ext_gather.pack_sorted_uniques(
            uniq_f, n, r1f)
        if Hf > H_CAP:
            return None
        blk_wf = _blk_w(_cnt_per_hpos(sel))
        new_q, rbl_src, wos, n_q_pad = _window_pack(
            blk_wf, num_windows, h, qps)
        blk_q0 = np.concatenate([[0], np.cumsum(blk_wf)])
        rank_f = _subset_ranks(sel, e_row_i, NH)
        fi = np.flatnonzero(sel)
        q_of_e = new_q[blk_q0[blk[fi]] + rank_f[fi]]
        steps = n_q_pad // qps
        E8 = steps * rows_per_step
        if E8 * Hf * BC * 3 > SPLIT_VPU_BUDGET:
            return None
        tile = q_of_e // BC
        lane = q_of_e % BC
        erow = tile * 8 + sub[fi]
        pos_e = posu[np.searchsorted(uniq_f, cols[fi])]
        vals_a = np.zeros((E8, BC), np.float32)
        p2 = np.zeros((E8, BC), np.int32)
        l2 = np.zeros((E8, BC), np.int32)
        vals_a[erow, lane] = vals[fi]
        live = np.zeros((E8, BC), bool)
        live[erow, lane] = True
        p2[erow, lane] = (pos_e // BC).astype(np.int32)
        l2[erow, lane] = (pos_e % BC).astype(np.int32)
        rbl = np.full(n_q_pad, h, np.int32)
        rbl[new_q] = rbl_src
        return _Stream(kind="resident", base1=base1, p1=p1, l1=l1,
                       n1p_blocks=n1pb, r1=r1f, H=Hf, E8=E8,
                       p2=p2, l2=l2, vals=vals_a, rbl=rbl,
                       win_of_step=wos, base8=None, H_pad=Hf,
                       r_hot=0, n_entries=int(sel.sum()), live=live)

    far = (~loc) | migrate
    stream_f = stream_c = None
    used_k = 0 if pop_k is None else pop_k
    if far.any():
        erank = None
        if pop_k is None or pop_k > 0:
            # popularity ranks: a few popular columns carry most far
            # entries, while the once-referenced ones set the dedup'd
            # height; a hot stream of the popular columns and a cold
            # one of the rest can each fit where one stream does not
            uf, inv_f = np.unique(cols[far], return_inverse=True)
            cnt_f = np.bincount(inv_f)
            pop = np.argsort(-cnt_f, kind="stable")   # unique ids
            rank_of_u = np.empty(uf.size, np.int64)
            rank_of_u[pop] = np.arange(uf.size)
            erank = np.zeros(n_e, np.int64)
            erank[far] = rank_of_u[inv_f]             # popularity rank
        if pop_k is not None:                # forced decision (shards)
            if pop_k == 0:
                stream_f = _resident_stream(far, r_far)
                if stream_f is None:
                    return None
            else:
                hot_sel = far & (erank < pop_k)
                cold_sel = far & (erank >= pop_k)
                if hot_sel.any():
                    stream_f = _resident_stream(hot_sel, r_far)
                    if stream_f is None:
                        return None
                if cold_sel.any():
                    stream_c = _resident_stream(cold_sel, r_cold)
                    if stream_c is None:
                        return None
        else:
            stream_f = _resident_stream(far, r_far)
            if stream_f is None:
                # the smallest hot set that fits wins
                for K in (256, 1024, 4096, 16384, 65536, H_CAP * BC):
                    if K >= uf.size:
                        break            # no split left to try
                    hot_sel = far & (erank < K)
                    cold_sel = far & (erank >= K)
                    s_h = (_resident_stream(hot_sel, r_far)
                           if hot_sel.any() else None)
                    s_c = _resident_stream(cold_sel, r_cold)
                    if s_h is not None and s_c is not None:
                        stream_f, stream_c, used_k = s_h, s_c, K
                        break
                if stream_f is None:
                    return None

    if stream_l is None and stream_f is None and stream_c is None:
        return None
    plan = SplitChipsPlan(n_e=n_e, h=h, rows_per_step=rows_per_step,
                          num_windows=num_windows,
                          heavy_ids=hr_sorted, NH=NH,
                          loc=stream_l, far=stream_f, cold=stream_c,
                          pop_k=used_k)
    if force_streams is not None:
        have = {k for k, s in (("loc", stream_l), ("far", stream_f),
                               ("cold", stream_c)) if s is not None}
        want = set(force_streams)
        if have - want:
            return None          # a stream the shared set lacks
        for k in want - have:
            s = _placeholder_stream(
                k, n=n, h=h, rows_per_step=rows_per_step,
                num_windows=num_windows, r_hot=r_hot,
                r_far=r_far if k == "far" else r_cold)
            setattr(plan, k, s)
    return plan


def _put(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def bind_slots(plans: list, n: int, device):
    """``(products(xf, ops) -> prod, hbm)``: the slot tables of ``plans``
    (one plan, or a card's shards) concatenated into one, one
    ``chips_products`` launch for all of them; ``hbm`` 12 B a slot
    (column, value, product)."""
    cols = np.concatenate([chips_slots.slots_table(p, n) for p in plans])
    vals = np.concatenate([chips_slots.slot_vals(p) for p in plans])
    t_cols = _put(cols, torch.int32, device)
    t_vals = _put(vals, torch.float32, device)

    def products(xf, ops):
        return ops.chips_products(t_cols, t_vals, xf)
    return products, int(cols.size * 12)


def bind_sums(plans: list, n: int, device):
    """Every heavy row's sum of ``plans`` (one plan, or a card's shards)
    from one window segment-sum launch: the plans' chip rows stacked in
    slot order (their products from :func:`bind_slots`), the quanta of
    every stream of plan j in one table whose windows follow plan j - 1's,
    so that one destination holds the quanta of all of a heavy row's
    streams, in ascending order (loc, far, cold). Returns ``(sums(xf, ops)
    -> ys, ranks, hbm)``: ys (L,) f32 with plan j's heavy rank k at
    ``ranks[j] + k``; ``hbm`` the products' bytes and the sums'."""
    h, rps = plans[0].h, plans[0].rows_per_step
    if any(p.h != h or p.rows_per_step != rps for p in plans):
        raise ValueError("bind_sums: plans of different h or rows_per_step "
                         "cannot share one segment-sum")
    rbl, win, ranks, w0 = [], [], [], 0
    for p in plans:
        for s in chips_slots.slot_parts(p):
            rbl.append(np.asarray(s.rbl, np.int32))
            win.append(np.asarray(s.win_of_step, np.int64) + w0)
        ranks.append(w0 * h * 8)
        w0 += p.num_windows
    rbl, win = np.concatenate(rbl), np.concatenate(win)
    t_rbl, t_win = _put(rbl, torch.int32, device), _put(win, torch.int32,
                                                        device)
    tables = segsum_kernel.window_tables(rbl, win, w0, h, device)
    L = ranks[-1] + plans[-1].NH
    products, hbm = bind_slots(plans, n, device)

    def sums(xf, ops):
        return ops.window_segsum(products(xf, ops), t_rbl, t_win, w0, h, rps,
                                 tables).view(-1)[:L]
    return sums, ranks, int(hbm + sum(p.NH for p in plans) * 4)


def split_plan_host_args(plan: SplitChipsPlan) -> list:
    """The split plan's arrays in the order the reference device-puts
    them (its ``split_plan_host_args``): the heavy ids, then per stream
    its stage-1 tables (not for ``windowed-x``), p2, l2, vals, rbl, the
    window bases (windowed kinds) and the step windows. The parity tests
    compare them with the reference's, shard by shard."""
    out = [np.asarray(plan.heavy_ids, np.int32)]
    for s in plan.streams:
        if s.kind != "windowed-x":
            out += [np.asarray(s.base1, np.int32),
                    np.asarray(s.p1, np.int32),
                    np.asarray(s.l1, np.int32)]
        out += [np.asarray(s.p2, np.int32),
                np.asarray(s.l2, np.int32),
                np.asarray(s.vals, np.float32),
                np.asarray(s.rbl, np.int32)]
        if s.kind in ("windowed", "windowed-x"):
            out.append(np.asarray(s.base8, np.int32))
        out.append(np.asarray(s.win_of_step, np.int32))
    return out


def chips_meta(plan, panel_merge: bool) -> dict:
    """What the hybrid's and ``cuda-chips``' meta say of a chips plan
    (the reference's keys; ``panel_merge``: :func:`merge_kind`'s
    verdict)."""
    if isinstance(plan, SplitChipsPlan):
        return {"heavy_rows": plan.NH, "split": True,
                "panel_merge": panel_merge, "windows": plan.num_windows,
                "loc_entries": plan.loc.n_entries if plan.loc else 0,
                "far_entries": plan.far.n_entries if plan.far else 0,
                "cold_entries": plan.cold.n_entries if plan.cold else 0,
                "hot_h": tuple(s.H_pad for s in plan.streams)}
    return {"heavy_rows": plan.NH, "hot_h": plan.H, "split": False,
            "panel_merge": panel_merge, "gather_groups": plan.n_groups,
            "tile_rows": plan.E8, "windows": plan.num_windows}


# ---------------------------------------------------------------------------
# The heavy-row landing
# ---------------------------------------------------------------------------

def merge_kind(heavy_ids: np.ndarray, m: int, G_pad: int,
               budget: float = 6e8, windowed: bool = True) -> str:
    """How the reference lands the sums of ``heavy_ids`` into a y of
    ``G_pad`` 128-row groups (the choice of its landing step, which the
    meta's ``panel_merge`` records; the port lands them by
    :func:`heavy_land` and builds none of its tables): ``"windowed"``
    when the ids ascend and the padded sums fit the windowed gather's cap
    (``H_WIN_CAP`` rows), else ``"ranked"`` when they fit the resident
    cap (``H_CAP``) and ``budget`` of gather work (3 ops a lane of every
    padded row for each output group), else ``"scatter"``.
    ``windowed=False`` asks the row-sharded reference, whose shards try
    the ranked merge alone. Raises ValueError unless the ids index rows
    below ``min(m, G_pad * 128)``."""
    NH = int(heavy_ids.size)
    if NH and int(heavy_ids.max()) >= min(m, G_pad * BC):
        raise ValueError("heavy_ids must index rows (< m <= G_pad*128)")
    # rows of the padded sums: past NH/128 (slot NH holds a zero), in 8s
    h8 = -(-(NH // BC + 1) // 8) * 8
    if windowed and h8 <= H_WIN_CAP and not (
            NH and np.any(np.diff(heavy_ids) <= 0)):
        return "windowed"
    if h8 <= H_CAP and -(-G_pad // 8) * 8 * h8 * BC * 3 <= budget:
        return "ranked"
    return "scatter"


# ---- heavy_land -------------------------------------------------------------

# Launches of ``heavy_land``'s CUDA kernel by its wrapper in this process.
LAUNCHES = {"heavy_land": 0}


def land_map(plans: list, ranks, size: int, row0) -> np.ndarray:
    """The landing's map of the sums of :func:`bind_sums`
    (int64, (size,)): position ``ranks[j] + k`` holds ``row0[j] +
    heavy_ids_j[k]`` for each real heavy rank k of plan j (k <
    ``n_real``), -1 elsewhere: window padding, and a padded shard plan's
    pad ranks, which add into no row."""
    land = np.full(size, -1, np.int64)
    for p, r, o in zip(plans, ranks, row0):
        k = int(p.n_real)
        land[r:r + k] = o + np.asarray(p.heavy_ids[:k], np.int64)
    return land


def check_land(land, n_rows: int) -> None:
    """Raise ValueError unless every entry of ``land`` is -1 or a row in
    [0, n_rows) and no row appears twice (the kernel adds without
    atomics)."""
    land = np.asarray(land, np.int64)
    if land.size and (int(land.min()) < -1 or int(land.max()) >= n_rows):
        raise ValueError(f"heavy_land: land holds rows in [{land.min()}, "
                         f"{land.max()}], outside y's {n_rows} (or -1)")
    live = land[land >= 0]
    if np.unique(live).size != live.size:
        raise ValueError("heavy_land: land names a row of y more than once")


@trace.span("pack.upload", fn="bind_land")
def bind_land(land, n_rows: int, device) -> torch.Tensor:
    """``land`` checked (:func:`check_land`) as an int32 tensor on
    ``device``."""
    check_land(land, n_rows)
    return _put(land, torch.int32, device)


def land_hbm(land) -> int:
    """Bytes one ``heavy_land`` call moves: 4 B an entry of ``land``, and
    per heavy row its sum read and its row of y read and written (16 B a
    heavy row in all)."""
    land = np.asarray(land)
    return int(land.size * 4 + int((land >= 0).sum()) * 12)


def _check_land_args(y, ys, land) -> None:
    if y.dtype != torch.float32 or ys.dtype != torch.float32 \
            or ys.dim() != 1:
        raise ValueError(f"heavy_land: y is {y.dtype}, ys {ys.dtype} "
                         f"{tuple(ys.shape)}, expected float32 and (n,)")
    if land.dtype != torch.int32 or land.shape != ys.shape:
        raise ValueError(f"heavy_land: land is {land.dtype} "
                         f"{tuple(land.shape)}, expected int32 "
                         f"{tuple(ys.shape)}")
    for name, t in (("ys", ys), ("land", land)):
        if t.device != y.device:
            raise ValueError(f"heavy_land: {name} is on {t.device}, y on "
                             f"{y.device}")
    for name, t in (("y", y), ("ys", ys), ("land", land)):
        if not t.is_contiguous():
            raise ValueError(f"heavy_land: {name} is not contiguous")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"heavy_land: unsupported device {y.device}")


@trace.launch("heavy_land")
def heavy_land(y, ys, land) -> torch.Tensor:
    """``y[land[k]] += ys[k]`` in place for every k with ``land[k] >=
    0``, y (any shape, contiguous) indexed flat; returns y. ``land``
    names each row at most once (:func:`bind_land` checks that on the
    host, once per matrix; on a CPU tensor it is checked here). CUDA
    tensors launch ``csrc/heavy_land.cu``; CPU tensors run
    :func:`heavy_land_plain`."""
    _check_land_args(y, ys, land)
    if y.device.type == "cpu":
        check_land(land.numpy(), y.numel())
        return heavy_land_plain(y, ys, land)
    lib = _kernels.load("heavy_land")
    err = lib.heavy_land(ys.data_ptr(), land.data_ptr(), y.data_ptr(),
                         land.numel(), y.numel(),
                         _kernels.stream_handle(y.device))
    _kernels.check(lib, err, "heavy_land")
    LAUNCHES["heavy_land"] += 1
    return y


def heavy_land_plain(y, ys, land) -> torch.Tensor:
    """:func:`heavy_land` in PyTorch ops: ``y[idx] = y[idx] + ys[sel]``,
    one f32 add a heavy row, in place."""
    sel = torch.nonzero(land >= 0).flatten()
    idx = land[sel].long()
    flat = y.view(-1)
    flat[idx] = flat[idx] + ys[sel]
    return y


@trace.span("pack.upload", fn="land_chips")
def land_chips(plan, n: int, m: int, device):
    """One chips plan landed into y (m,): ``(add(y, xf, ops) -> y,
    hbm)`` with ``add`` one segment-sum over all the plan's streams
    (:func:`bind_sums`) and one ``heavy_land`` into y in place; ``hbm``
    the tail's bytes, the landing's 16 B a heavy row among them."""
    sums, ranks, hbm = bind_sums([plan], n, device)
    land = land_map([plan], ranks, plan.NH, [0])
    t_land = bind_land(land, m, device)

    def add(y, xf, ops):
        return ops.heavy_land(y, sums(xf, ops), t_land)
    return add, hbm + land_hbm(land)


# ---------------------------------------------------------------------------
# The strategy
# ---------------------------------------------------------------------------

class ChipsKernels(NamedTuple):
    """The functions a chips call runs, by name."""

    window_segsum: Callable
    chips_products: Callable
    heavy_land: Callable


KERNELS = ChipsKernels(segsum_kernel.window_segsum,
                       chips_slots.chips_products, heavy_land)
PLAIN = ChipsKernels(segsum_kernel.window_segsum_plain,
                     chips_slots.chips_products_plain, heavy_land_plain)


def prepare_chips_strategy(A: CSR, device="cuda", **_) -> Prepared:
    """``cuda-chips`` (the reference's ``pallas-chips``,
    ``prepare_chips_strategy``): the whole matrix as chips, every row
    reduced cooperatively (the reference study's block-per-row CSR
    kernel), through the single plan or the split plan, landed into a
    zero y (:func:`land_chips`). The meta has the reference's keys
    (``panel_merge`` what the reference picks, :func:`merge_kind`).
    Refuses (ValueError) a matrix neither plan fits."""
    dev = resolve_device(device)
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    plan = plan_chips(rows, cols, A.as_.astype(np.float32), A.m, A.n)
    if plan is None:
        raise ValueError(
            "cuda-chips: matrix exceeds the resident-hot/VPU budget "
            f"(uniq cols or {A.nnz} entries too large)")
    m, n = A.m, A.n
    add, hbm = land_chips(plan, n, m, dev)

    def call(x, ops):
        xf = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if xf.shape != (n,):
            raise ValueError(f"cuda-chips: x has shape {tuple(xf.shape)}, "
                             f"expected ({n},)")
        return add(torch.zeros(m, dtype=torch.float32, device=dev), xf, ops)

    merge = merge_kind(plan.heavy_ids, m, -(-m // BC))
    meta = {"chunk": plan.rows_per_step,
            **chips_meta(plan, merge != "scatter")}
    return Prepared("cuda-chips", A.name, lambda x: call(x, KERNELS),
                    device=dev, nnz=A.nnz, ref="pallas-chips",
                    hbm_bytes=hbm, meta=meta,
                    plain=lambda x: call(x, PLAIN),
                    kernel_calls=lambda xf: record_calls(
                        lambda ops: call(xf, ops), PLAIN), run=call)

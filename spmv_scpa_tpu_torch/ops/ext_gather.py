"""The ext gather route on PyTorch and CUDA (counterpart of
``spmv_scpa_tpu/ops/ext_gather.py``).

Out-of-window entries of the lane-ELL hybrid read x through per-group
"ext panels": 128 lanes per 128-row group holding exactly that group's
unique out-of-window x values, built in two gather stages:

* **stage 1** (:func:`sorted_gather`): the globally sorted unique
  out-columns, packed <= 8*128 per R-panel-aligned x window, become a
  compact "hot region" (H, 128);
* **stage 2** gathers each group's panel from the hot region, either
  over all of it (:func:`ranked_gather`) or through a per-group window
  of ``r_hot`` rows (:func:`window_gather`).

The host planner (:func:`plan_ext`, :func:`build_group_tables`,
:func:`build_base8`) is a JAX-free copy of the reference's, so its
tables equal the reference's; the parity tests compare them exactly.
Each gather's wrapper launches ``csrc/ext_gather.cu`` on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor. An index outside
its range gathers 0.0, as the TPU kernels' one-hot mask does.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.formats.csr import BC

# stage-1 window reach, in 128-col panels (windows are R-panel aligned)
R_PANELS = 512
# resident stage-2 hot-region cap (sublanes of 128 lanes)
H_MAX = 1024
# windowed stage-2: considered once the hot region exceeds H_WIN_MIN
# rows; H_WIN_CAP caps the hot region of the windowed kernel
H_WIN_MIN = 64
H_WIN_CAP = 16384

# Launches of each CUDA kernel by its wrapper in this process.
LAUNCHES = {"sorted_gather": 0, "ranked_gather": 0, "window_gather": 0}


class ExtPlan:
    """Host-side plan: stage tables + per-entry ext lane assignment."""

    __slots__ = ("n_groups", "H", "R", "n1p_blocks", "base", "p1",
                 "l1", "pair_grp", "pair_lane", "pair_key", "pair_pos",
                 "ext_lane", "covered", "n_out",
                 "windowed", "r_hot", "base8", "H_pad")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def pack_sorted_uniques(uniq: np.ndarray, n: int, r_cap: int):
    """Stage-1 packing (the reference's ``plan_ext`` packing loop and
    ``chips_tail._pack_sorted_uniques``): sorted unique columns in groups
    of <= 8*128 sharing one ``r_cap``-panel-aligned x window. Returns
    (base, p1, l1, pos, H, n_groups, n1p_blocks): the stage-1 tables,
    each unique's hot slot ``pos`` and the hot region's height."""
    region = uniq // (r_cap * BC)
    reg_u, reg_start = np.unique(region, return_index=True)
    reg_end = np.r_[reg_start[1:], uniq.size]
    base_l: list[int] = []
    pos = np.empty(uniq.size, np.int64)
    cursor = 0
    for r0, s, e in zip(reg_u, reg_start, reg_end):
        for a in range(s, e, 8 * BC):
            sel = np.arange(a, min(a + 8 * BC, e))
            base_l.append(int(r0))
            pos[sel] = cursor * BC + (sel - a)
            cursor += 8
    n_groups = len(base_l)
    n_panels = -(-n // BC)
    n1p_blocks = max(-(-n_panels // r_cap), int(max(base_l)) + 1)
    p1 = np.zeros((n_groups * 8, BC), np.int32)
    l1 = np.zeros((n_groups * 8, BC), np.int32)
    srow, slane = pos // BC, pos % BC
    p1[srow, slane] = (uniq // BC
                       - np.asarray(base_l, np.int64)[srow // 8] * r_cap)
    l1[srow, slane] = uniq % BC
    return (np.asarray(base_l, np.int32), p1, l1, pos, cursor, n_groups,
            n1p_blocks)


def plan_ext(rows: np.ndarray, cols: np.ndarray, out_mask: np.ndarray,
             m: int, n: int, r_cap: int = R_PANELS,
             allow_windowed: bool = True) -> ExtPlan | None:
    """Plan the two gather stages for the entries flagged in
    ``out_mask`` (reference: ``ext_gather.plan_ext``).

    Per 128-row group, the group's unique out-columns (at most 128, the
    most-referenced kept) each get one lane of the group's ext panel.
    Returns None when there is nothing to plan or the hot region would
    exceed its cap. ``allow_windowed=False`` keeps stage 2 resident.
    """
    oi = np.flatnonzero(out_mask)
    if not oi.size:
        return None
    grp = rows[oi] // BC
    oc = cols[oi]
    key = grp * np.int64(n) + oc
    pk, cnt = np.unique(key, return_counts=True)    # sorted (grp, col)
    pg = (pk // n).astype(np.int64)
    pc = (pk % n).astype(np.int64)

    # per-group cap: keep the 128 most-referenced pairs
    order = np.lexsort((-cnt, pg))
    pgo = pg[order]
    newg = np.r_[True, pgo[1:] != pgo[:-1]]
    first = np.flatnonzero(newg)
    gid = np.cumsum(newg) - 1
    rank = np.arange(pgo.size) - first[gid]
    lane_of_pair = np.full(pk.size, -1, np.int64)
    kept = rank < BC
    lane_of_pair[order[kept]] = rank[kept]

    uniq = np.unique(pc[lane_of_pair >= 0])
    if not uniq.size:
        return None

    base, p1, l1, pos, H, n_groups, n1p_blocks = pack_sorted_uniques(
        uniq, n, r_cap)
    if H > H_WIN_CAP:
        return None

    # per-pair hot-region position (only kept pairs are looked up)
    kept_i = lane_of_pair >= 0
    pair_pos = np.full(pk.size, 0, np.int64)
    pair_pos[kept_i] = pos[np.searchsorted(uniq, pc[kept_i])]

    # ---- windowed stage-2 planning ----------------------------------
    # Hot positions follow the sorted column order, so a group whose
    # out-columns are localized touches a narrow band of the hot region:
    # a per-group window base turns the O(H) stage 2 into O(r_hot).
    # Pairs past the p97 entry-weighted reach drop back to the tail.
    windowed = False
    r_hot = 0
    base8 = np.zeros(0, np.int32)
    H_pad = H
    if allow_windowed and H > H_WIN_MIN and kept_i.any():
        kidx = np.flatnonzero(kept_i)
        kg = pg[kidx]
        kpos = pair_pos[kidx] // BC
        n_grp = int(kg.max()) + 1
        gmin = np.full(n_grp, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(gmin, kg, kpos)
        b8 = np.where(gmin == np.iinfo(np.int64).max, 0, gmin // 8)
        off = kpos - b8[kg] * 8
        w = cnt[kidx].astype(np.float64)   # entry-weighted reach
        o_ord = np.argsort(off, kind="stable")
        cw = np.cumsum(w[o_ord])
        tgt = int(off[o_ord[min(int(np.searchsorted(cw, 0.97 * cw[-1])),
                                off.size - 1)]]) + 1
        rh = 32
        while rh < tgt and rh < 512:
            rh *= 2
        if 2 * rh <= H:
            lane_of_pair[kidx[off >= rh]] = -1
            kept_i = lane_of_pair >= 0
            windowed = True
            r_hot = rh
            base8 = b8.astype(np.int32)
            H_pad = int(b8.max(initial=0)) * 8 + rh
    if not windowed and H > H_MAX:
        return None

    # per-entry ext lane (-1 = dropped by the per-group cap or the reach)
    ent_pair = np.searchsorted(pk, key)
    ext_lane = np.full(rows.size, -1, np.int64)
    ext_lane[oi] = lane_of_pair[ent_pair]
    covered = float(np.mean(lane_of_pair[ent_pair] >= 0))

    return ExtPlan(n_groups=n_groups, H=H, R=r_cap,
                   n1p_blocks=n1p_blocks, base=base, p1=p1, l1=l1,
                   pair_grp=pg[kept_i], pair_lane=lane_of_pair[kept_i],
                   pair_key=pk, pair_pos=pair_pos[kept_i],
                   ext_lane=ext_lane, covered=covered, n_out=oi.size,
                   windowed=windowed, r_hot=r_hot, base8=base8,
                   H_pad=H_pad)


def build_group_tables(plan: ExtPlan, G_pad: int):
    """Stage-2 p2/l2 (G_pad, BC) from the plan's kept pairs. In windowed
    mode p2 is window-relative (in [0, r_hot) for set lanes; unset
    lanes may go negative and gather 0, and the core never reads them)."""
    p2 = np.zeros((G_pad, BC), np.int32)
    l2 = np.zeros((G_pad, BC), np.int32)
    p2[plan.pair_grp, plan.pair_lane] = plan.pair_pos // BC
    l2[plan.pair_grp, plan.pair_lane] = plan.pair_pos % BC
    if plan.windowed:
        p2 -= build_base8(plan, G_pad)[:, None].astype(np.int32) * 8
    return p2, l2


def build_base8(plan: ExtPlan, G_pad: int):
    """Per-group window bases padded to (G_pad,) (8-row units)."""
    b = np.zeros(G_pad, np.int32)
    b[:plan.base8.size] = plan.base8
    return b


# ---------------------------------------------------------------------------
# The three gathers: wrappers and plain versions
# ---------------------------------------------------------------------------

def _check(what: str, src, tables: dict, rows_out: int):
    """Device, dtype, shape and contiguity of a gather's arguments."""
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != BC:
        raise ValueError(f"{what}: source is {src.dtype} "
                         f"{tuple(src.shape)}, expected float32 (rows, {BC})")
    for name, (t, shape) in tables.items():
        if t.device != src.device:
            raise ValueError(f"{what}: {name} is on {t.device}, source on "
                             f"{src.device}")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected int32 {shape}")
    for name, t in (("source", src),) + tuple(
            (k, v[0]) for k, v in tables.items()):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {src.device}")
    if rows_out * BC >= 2**31:
        raise ValueError(f"{what}: {rows_out} output rows exceed the "
                         "kernel's int32 element count")


def _gather_plain(src, row, p, l, P):
    """out = src[row, l] where 0 <= p < P, l and row in range; else 0."""
    ok = (p >= 0) & (p < P) & (l >= 0) & (l < BC) & (row >= 0) \
        & (row < src.shape[0])
    flat = torch.where(ok, row * BC + l, torch.zeros_like(row))
    return torch.where(ok, src.reshape(-1)[flat],
                       torch.zeros((), dtype=src.dtype, device=src.device))


def _launch(what: str, fn_args: tuple, out):
    lib = _kernels.load("ext_gather")
    err = getattr(lib, what)(*fn_args, _kernels.stream_handle(out.device))
    _kernels.check(lib, err, what)
    LAUNCHES[what] += 1
    return out


@trace.launch("sorted_gather")
def sorted_gather(base, x1, p1, l1, R: int) -> torch.Tensor:
    """Stage 1 (replaces ``make_sorted_gather``): ``out[r, j] =
    x1[base[r // 8] * R + p1[r, j], l1[r, j]]`` for ``p1`` in [0, R),
    else 0. ``x1`` (n1p_blocks * R, 128) f32 is x zero-padded; ``base``
    (n_groups,) and ``p1``/``l1`` (n_groups * 8, 128) int32."""
    rows = p1.shape[0]
    _check("sorted_gather", x1, {"base": (base, (rows // 8,)),
                                 "p1": (p1, (rows, BC)),
                                 "l1": (l1, (rows, BC))}, rows)
    if rows % 8:
        raise ValueError(f"sorted_gather: {rows} output rows are not whole "
                         "groups of 8")
    if x1.device.type == "cpu":
        return sorted_gather_plain(base, x1, p1, l1, R)
    out = torch.empty((rows, BC), dtype=torch.float32, device=x1.device)
    return _launch("sorted_gather", (
        x1.data_ptr(), base.data_ptr(), p1.data_ptr(), l1.data_ptr(),
        out.data_ptr(), rows, R, x1.shape[0]), out)


def sorted_gather_plain(base, x1, p1, l1, R: int) -> torch.Tensor:
    rbase = base.to(torch.int64).repeat_interleave(8)[:, None] * R
    p = p1.to(torch.int64)
    return _gather_plain(x1, rbase + p, p, l1.to(torch.int64), R)


@trace.launch("ranked_gather")
def ranked_gather(hot, p2, l2) -> torch.Tensor:
    """Stage 2, resident (replaces ``make_ranked_gather``):
    ``out[r, j] = hot[p2[r, j], l2[r, j]]`` for ``p2`` in [0, H), else 0.
    ``hot`` (H, 128) f32; ``p2``/``l2`` (G, 128) int32."""
    rows = p2.shape[0]
    _check("ranked_gather", hot, {"p2": (p2, (rows, BC)),
                                  "l2": (l2, (rows, BC))}, rows)
    if hot.device.type == "cpu":
        return ranked_gather_plain(hot, p2, l2)
    out = torch.empty((rows, BC), dtype=torch.float32, device=hot.device)
    return _launch("ranked_gather", (
        hot.data_ptr(), p2.data_ptr(), l2.data_ptr(), out.data_ptr(), rows,
        hot.shape[0]), out)


def ranked_gather_plain(hot, p2, l2) -> torch.Tensor:
    p = p2.to(torch.int64)
    return _gather_plain(hot, p, p, l2.to(torch.int64), hot.shape[0])


@trace.launch("window_gather")
def window_gather(base8, hot, p, l, R_h: int) -> torch.Tensor:
    """Stage 2, windowed (replaces ``make_resident_window_gather``):
    ``out[r, j] = hot[base8[r] * 8 + p[r, j], l[r, j]]`` for ``p`` in
    [0, R_h), else 0. ``hot`` (H_pad, 128) f32; ``base8`` (G,) and
    ``p``/``l`` (G, 128) int32."""
    rows = p.shape[0]
    _check("window_gather", hot, {"base8": (base8, (rows,)),
                                  "p": (p, (rows, BC)),
                                  "l": (l, (rows, BC))}, rows)
    if hot.device.type == "cpu":
        return window_gather_plain(base8, hot, p, l, R_h)
    out = torch.empty((rows, BC), dtype=torch.float32, device=hot.device)
    return _launch("window_gather", (
        hot.data_ptr(), base8.data_ptr(), p.data_ptr(), l.data_ptr(),
        out.data_ptr(), rows, R_h, hot.shape[0]), out)


def window_gather_plain(base8, hot, p, l, R_h: int) -> torch.Tensor:
    pp = p.to(torch.int64)
    row = base8.to(torch.int64)[:, None] * 8 + pp
    return _gather_plain(hot, row, pp, l.to(torch.int64), R_h)

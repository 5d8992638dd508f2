"""Lane-ELL hybrid on PyTorch and CUDA: the packer's slot planes, and
the core on either of two layouts, each with a hand-written kernel.

Counterpart of ``spmv_scpa_tpu/ops/lane_ell.py:prepare_lane_ell_hybrid``
(read that module's docstring for the format). Three parts:

* ``pack_lane_ell`` — the host packer, a JAX-free copy of the
  reference's (slot planes, strip demotion and relocation, overflow and
  dynamic catch-all planes, the idx8 split). It keeps the TPU-tuned
  cost models as they are, so it produces the same arrays; the parity
  tests compare them exactly. It also records which of A's entries the
  core keeps (``LanePlan.core``), for the rows core.
* ``lane_ell_spmv`` — the wrapper of the CUDA kernel
  (``csrc/lane_ell.cu``), with ``lane_ell_spmv_plain`` beside it: the
  same function in PyTorch ops. A CPU tensor goes to the plain version,
  a CUDA tensor to the kernel.
* ``prepare_lane_ell_hybrid`` — runs the core on its ``core_layout``:
  ``"rows"`` (the default), the recorded entries in row quanta
  (``ops/lane_rows.py``, kernel ``lane_rows``) reading x in place, or
  ``"lanes"``, the planes through ``lane_ell_spmv`` with x staged (the
  ``loc_w`` left pad, the hot columns, and the ext panels through the
  two gather stages of ``ops/ext_gather.py``); then it adds the tail,
  the same on both layouts: the chips tail (``ops/chips_tail.py``: the
  slot products, one segment-sum and ``heavy_land`` into the core's y)
  for 2048 entries or more, else the compact tail with ``index_add_``,
  or, past ``tail_xla_max`` entries, the big-tail branch: the port's
  strategy for ``tail_strategy`` (PELL by default; any of
  :data:`COMPACT_TAILS`, the reference's names) over the tail's rows
  renumbered 0..NH-1, run inside the call with the kernels of this
  call's ``ops`` (``Prepared.run``), landed by ``chips_tail.heavy_land``,
  or under ``tail_strategy="pallas-hybrid"`` (``"auto"`` when the tail
  has locality) a second hybrid over the tail, y summed on the device.
  A matrix whose widest diagonal window covers under 40% of its entries
  goes to ``cuda-pell`` whole (the no-locality escape). ``pell_layout``
  is the PELL layout of the escape and of a compact PELL tail
  (``ops/pell.py``): ``"auto"``, the row quanta of ``ops/pell_rows.py``,
  or ``"tiles"``, the reference's; a compact BCSR tail takes it too (the
  bitmap tiles, or the dense).

``pack_lane_ell(..., x_off=r0, core_only=True)`` packs one row shard
for ``parallel/distributed.py``: the window frame shifts by the shard's
first global row, and the packer stops at the host arrays that the
row-sharded hybrid stacks across shards (:class:`CoreBuild`).
:func:`lane_ell_sharded` is the core kernel in that form: the shards'
stacked planes in one launch, each shard reading x from its own offset
into one shared padded x.

A big tail through any other ``tail_strategy`` is refused with
``ValueError`` at prepare time, its message saying what the reference
does with that name (:data:`REFUSED_TAILS`; an fp64 grade's tail cannot
land in the f32 core's y: the reference fails at its first call).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import (chips_slots, chips_tail, ext_gather,
                                     lane_rows, pell, xpose)
from spmv_scpa_tpu_torch.ops.registry import (Prepared, by_ref,
                                              get_strategy, record_calls)
from spmv_scpa_tpu_torch.utils.platform import resolve_device

X_VMEM_BUDGET = 10 << 20     # same budget as the fused PELL kernel
# bytes-equivalent cost of one extra per-plane strip pass
# (gather+cmp+select over the (chunk, BC) block each step),
# calibrated from the flagship's measured 31% select share at ~1
# extra pass/plane: 88 planes * 6 B * 0.31 / ~80 passes ~= 2 B
SEL_B = 2.0
_LOC_CHOICES = (128, 256, 512, 1024, 2048, 4096)
_HOT_CHOICES = (128, 256, 512, 1024, 2048, 4096, 8192)
# slot-count candidates for the byte-cost model: fine (8-step) past 8
# so near-uniform row lengths land exactly (the stencil flagship has
# 72-nnz rows; a 64->80->96 grid forced Q=80 = 8 always-empty planes
# streamed per step — ~8% of the core's HBM bytes for nothing)
_Q_CHOICES = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88,
              96, 104, 112, 120, 128)

# a split chips plan past this many tail entries goes to the big-tail
# branch (the reference's TPU-measured cut, kept for parity)
BIG_TAIL = 131072

# Entries :func:`strip_pairs` reads at a time (8 MiB of int64).
PAIR_SLICE = 1 << 20

# The reference's fp64-grade strategies: none can take a big tail.
FP64_GRADES = ("pallas-pell-df64", "pallas-hybrid-df64", "xla-ell-df64")

# The reference's strategies whose compact big-tail branch runs
# (lane_ell.py:1563-1590; each of its twenty tried on the CPU on
# amazon_csr(m=20000, avg_nnz=4.7, seed=4) with ext=False,
# diag="nochips", tail_xla_max=1000); "pallas-hybrid" recurses instead.
COMPACT_TAILS = ("pallas-pell", "pallas-xpose", "pallas-bcsr",
                 "pallas-chips", "pallas-nearfar", "xla-csr-segsum",
                 "xla-ell-rm", "xla-ell-cm", "xla-dense")
# What the reference does with each other name (the fp64 grades:
# FP64_GRADES).
_HOST = ("prepares the tail and fails at its first call with TypeError "
         "('NoneType' object is not callable): a host strategy has no "
         "device program to run inside the hybrid's")
_SPMM = ("prepares the tail and fails at its first call with {}: an "
         "SpMM-only strategy takes X (n, cols), not the tail's x")
REFUSED_TAILS = {
    **dict.fromkeys(("oracle-csr", "oracle-ell", "omp-csr-guided",
                     "omp-csr-nnz", "omp-ell"), _HOST),
    "pallas-bcsr-spmm": _SPMM.format(
        "ValueError (incompatible shapes for broadcasting)"),
    "xla-csr-segsum-spmm": _SPMM.format("TypeError (a reshape)"),
}

# Launches of the CUDA kernels by ``lane_ell_spmv`` and by
# ``lane_ell_sharded`` in this process.
KERNEL_LAUNCHES = 0
SHARDED_LAUNCHES = 0


def x_fits(x_bytes: int) -> bool:
    """Whether a resident x of ``x_bytes`` fits :data:`X_VMEM_BUDGET`,
    the reference's TPU VMEM bound, kept for parity until ROADMAP #5
    re-derives it on the card: :func:`pack_lane_ell` refuses a padded x
    past it, and ``registry.pick_auto``'s quick test asks it first."""
    return x_bytes <= X_VMEM_BUDGET


def idx8_partition(sets: list, chunk: int):
    """Plane partition for the int8 idx stream.

    Orders planes so <=2-strip ones lead. ``n8`` is rounded down so
    the int8 block height (n8*chunk) is 32-aligned (kept from the TPU's
    int8 sublane tiling, for parity). ``second`` maps each int8 plane
    to its set's second strip (-1 when single-strip) for the positional
    bit-7 encoding. Returns (order, reordered_sets, n8, second).
    """
    QT = len(sets)

    def _i8ok(s):
        # dynamic slots (negative members) use nw+j codes that don't
        # fit the 1-bit positional encoding — int16 always
        return len(s) <= 2 and all(w >= 0 for w in s)

    order = sorted(range(QT), key=lambda q: not _i8ok(sets[q]))
    sets2 = [sets[q] for q in order]
    n8 = sum(_i8ok(s) for s in sets2)
    step8 = 32 // math.gcd(chunk, 32)
    n8 = (n8 // step8) * step8
    second = np.array([s[1] if len(s) == 2 else -1
                       for s in sets2[:n8]], np.int64)
    return order, sets2, n8, second


def idx8_encode(enc: np.ndarray, second_b: np.ndarray) -> np.ndarray:
    """Absolute (strip<<7 | lane) int codes -> positional int8 codes:
    bit 7 = (strip == the plane's second strip), bits 0-6 = lane.
    ``second_b`` must broadcast against ``enc``."""
    enc = enc.astype(np.int64)
    pos = (enc >> 7) == second_b
    return (np.where(pos, 128 + (enc & 127), enc & 127)
            .astype(np.uint8).view(np.int8))


def strip_pairs(q: np.ndarray, w: np.ndarray, nw: int, n_q: int,
                where: np.ndarray | None = None):
    """The distinct (plane, strip) pairs of the entries on planes ``q``
    and strips ``w`` (those where ``where`` is true, if given), as keys
    ``q * nw + w`` in ascending order, and the entries each pair holds:
    a 1-D ``np.unique(q * nw + w, return_counts=True)``, counted in a
    dense table of ``n_q * nw`` cells instead of sorted. It reads the
    entries in slices of :data:`PAIR_SLICE`, so no temporary is as long
    as a packer's arrays. A plane outside ``[0, n_q)`` or a strip
    outside ``[0, nw)`` raises ``ValueError``."""
    cnt = np.zeros(n_q * nw, np.int64)
    for i in range(0, q.size, PAIR_SLICE):
        qs, ws = q[i:i + PAIR_SLICE], w[i:i + PAIR_SLICE]
        if where is not None:
            keep = where[i:i + PAIR_SLICE]
            qs, ws = qs[keep], ws[keep]
        if qs.size and (qs.min() < 0 or qs.max() >= n_q
                        or ws.min() < 0 or ws.max() >= nw):
            raise ValueError(
                f"strip_pairs: planes {qs.min()}..{qs.max()}, strips "
                f"{ws.min()}..{ws.max()} outside {n_q} planes of {nw} "
                "strips")
        key = qs * nw
        key += ws
        cnt += np.bincount(key, minlength=cnt.size)
    keys = np.flatnonzero(cnt)
    return keys, cnt[keys]


def _slot_index(r: np.ndarray, q: np.ndarray, nq: int, chunk: int):
    """Flat index, into a ``(steps * nq * chunk, BC)`` plane array, of
    row ``r``'s slot on plane ``q``: array row ``(step * nq + q) * chunk
    + c`` and lane ``l`` for ``r = (step * chunk + c) * BC + l``. Built in
    place on one new array (a packer's arrays hold every entry)."""
    flat = r // (chunk * BC)
    flat *= nq - 1
    flat += q
    flat *= chunk * BC
    flat += r
    return flat


def _auto_loc_w(rows: np.ndarray, cols: np.ndarray) -> int:
    d = np.abs(cols - rows)
    cov = {w: float(np.mean(d <= w)) for w in _LOC_CHOICES}
    best = cov[_LOC_CHOICES[-1]]
    for w in _LOC_CHOICES:
        if cov[w] >= best - 0.02:
            return w
    return _LOC_CHOICES[-1]


def _auto_hot_k(out_cols: np.ndarray, nnz: int) -> int:
    if out_cols.size == 0:
        return 0
    _, cnt = np.unique(out_cols, return_counts=True)
    top = np.sort(cnt)[::-1]
    csum = np.cumsum(top)

    def cov(k):
        return float(csum[min(k, top.size) - 1])

    if cov(_HOT_CHOICES[-1]) < 0.05 * nnz:
        return 0                 # hubs don't carry enough to pay strips
    for k in _HOT_CHOICES:
        if cov(k) >= 0.9 * cov(_HOT_CHOICES[-1]):
            return k
    return _HOT_CHOICES[-1]


@dataclass(frozen=True)
class LaneCfg:
    """Static geometry of one packed matrix, as the kernel needs it."""

    QT: int        # slot planes in all (Q primary + Qo overflow)
    n8: int        # leading planes whose index is int8
    chunk: int     # 128-row groups per step
    steps: int
    S: int         # local strips per group window
    nw: int        # static strips: S local + hot (+ 1 ext)
    TD: int        # dynamic slots per step (all dynamic planes)
    P_pad: int     # padded-x rows before the hot panels
    ext_w: int = -1  # strip id of the per-group ext panel, -1: none

    @property
    def G_pad(self) -> int:
        return self.steps * self.chunk

    @property
    def Hs(self) -> int:
        """Hot strips (the static strips past the local ones and the
        ext strip)."""
        return self.nw - self.S - (self.ext_w >= 0)


@dataclass
class LanePlan:
    """Host packing result: plane arrays, strip tables, tail triplets."""

    cfg: LaneCfg
    vals_a: np.ndarray      # (steps*QT*chunk, BC) f32
    idx8_a: np.ndarray      # (steps*n8*chunk, BC) int8, positional codes
    idx_a: np.ndarray       # (steps*n16*chunk, BC) int16, strip<<7|lane
    used: tuple             # per-plane static strip sets (dyn: -1..-K)
    hot_idx: np.ndarray     # (Hs*BC,) int64 hot columns, zero-padded
    dynw_a: np.ndarray      # (steps*TD,) int32 per-step dynamic strips
    dyn_off: dict           # dynamic plane -> its first slot in a step
    Q: int
    Qo: int
    loc_w: int
    n_local: int
    m: int
    trows: np.ndarray       # tail triplets (row, col, value)
    tcols: np.ndarray
    tvals: np.ndarray
    meta: dict
    ext: ext_gather.ExtPlan | None = None   # the ext gather plan
    ext_p2: np.ndarray | None = None        # its stage-2 tables
    ext_l2: np.ndarray | None = None
    ext_b8: np.ndarray | None = None        # windowed stage-2 bases
    chips: chips_tail.ChipsPlan | None = None   # the chips tail's plan
    big_tail: str | None = None   # the big-tail route: "pallas-hybrid"
                                  # or "pallas-pell"
    core: np.ndarray | None = None  # the core's entries: indices into A's,
                                    # each row's in plane order

    @property
    def QT(self) -> int:
        return self.cfg.QT

    @property
    def n8(self) -> int:
        return self.cfg.n8

    @property
    def slot_bytes(self) -> int:
        """Bytes one slot of every plane costs: f32 value + int8/int16."""
        return 4 * self.QT + self.n8 + 2 * (self.QT - self.n8)

    def plane_tabs(self) -> np.ndarray:
        return plane_tabs(self.used, self.n8, self.dyn_off)


def plane_tabs(used, n8: int, dyn_off=None) -> np.ndarray:
    """(QT, 2) int32 decode table of the kernels: for an int8 plane the
    strips that bit 7 = 0 / 1 select; for an int16 plane its first
    dynamic slot in a step (0 when it has none)."""
    tabs = np.zeros((len(used), 2), np.int32)
    for q, u in enumerate(used):
        if q < n8:
            if u:
                tabs[q] = (u[0], u[-1])
        elif dyn_off:
            tabs[q, 0] = dyn_off.get(q, 0)
    return tabs


@dataclass
class CoreBuild:
    """One row shard's core, packed (``pack_lane_ell(...,
    core_only=True)``; the reference's ``_CoreBuild``): what the
    row-sharded hybrid pads and stacks across shards. Static strip sets
    only, no hot strips, absolute int16 indices; the ext tables (stage 1
    and the resident stage 2's ``p2``/``l2`` over ``G_pad`` groups) when
    the shard has ext panels (``ext_ng > 0``)."""

    vals_a: np.ndarray      # (steps*QT*chunk, BC) f32
    idx_a: np.ndarray       # (steps*QT*chunk, BC) int16, strip<<7|lane
    used: tuple             # per-plane static strip sets
    Q: int
    Qo: int
    QT: int
    S: int
    chunk: int
    steps: int
    G_pad: int
    P_pad: int
    loc_w: int
    n_local: int
    m: int
    trows: np.ndarray       # tail triplets (shard-local row, column, value)
    tcols: np.ndarray
    tvals: np.ndarray
    n_demoted: int
    n_reloc: int
    ext_ng: int = 0         # stage-1 groups, 0: no ext panels
    ext_n1p: int = 0
    ext_base: np.ndarray | None = None
    ext_p1: np.ndarray | None = None
    ext_l1: np.ndarray | None = None
    ext_p2: np.ndarray | None = None
    ext_l2: np.ndarray | None = None
    ext_cov: float = 0.0
    ext_n_out: int = 0
    core: np.ndarray | None = None  # the core's entries (indices into the
                                    # shard's), each row's in plane order


@trace.span("pack.plan", fn="pack_lane_ell")
def pack_lane_ell(A: CSR, chunk: int | None = None,
                  loc_w: int | str = "auto",
                  slots: int | str = "auto",
                  hot_k: int | str = "auto",
                  tail_strategy: str = "pallas-pell",
                  ext: bool | str = "auto",
                  ext_windowed: bool = True,
                  idx8: bool = False,
                  strip_cov: float | None = 0.985,
                  dyn_strips: bool | str = False,
                  dyn_k: int = 4,
                  ov_max: int = 8, ov_budget: int = 64,
                  aug: bool = True, undrop_min: int = 512,
                  ded_bytes: int = 32 << 20,
                  ded_max: int = 4, max_strips: int = 4,
                  tail_xla_max: int = 32768,
                  depth: int = 0, max_depth: int = 2,
                  diag: str = "", x_off: int = 0,
                  core_only: bool = False, **_) -> LanePlan | CoreBuild:
    """Pack ``A`` into lane-ELL slot planes (reference:
    ``spmv_scpa_tpu/ops/lane_ell.py:prepare_lane_ell_hybrid``, its host
    part). The knobs and their defaults are the reference's.

    ``x_off`` shifts the diagonal window by a global column offset: row
    ``i`` of a row shard is global row ``x_off + i``, so its window sits
    around column ``x_off + i``. ``core_only`` packs a shard for
    ``parallel/distributed.py``: no dynamic strips, no idx8 split (the
    row-sharded hybrid encodes int8 over the shards' union strip sets),
    and the packer returns a :class:`CoreBuild` before any tail is planned. It
    requires ``hot_k=0`` and a non-windowed ext, as the reference
    asserts."""
    trace.stage("window")
    m, n = A.m, A.n
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    nnz = A.nnz

    cols_w = cols - x_off        # window-relative column frame
    if loc_w == "auto":
        loc_w = _auto_loc_w(rows, cols_w) if nnz else 128
    if loc_w % BC:
        raise ValueError("loc_w must be a multiple of 128")
    PL = loc_w // BC
    S = 1 + 2 * PL               # local strips per group window

    grp = rows // BC
    off = cols_w - grp * BC + loc_w        # window-relative position
    is_local = (off >= 0) & (off < S * BC)

    out_cols = cols[~is_local]

    trace.stage("ext_route")
    # ---- ext gather route (ops/ext_gather.py): out-of-window entries
    # read x from per-group ext panels built by two gather stages; the
    # gate keeps the reference's TPU-measured cost model for parity.
    eplan = None
    if nnz and out_cols.size and ext in ("auto", True):
        eplan = ext_gather.plan_ext(rows, cols, ~is_local, m, n,
                                    allow_windowed=ext_windowed)
        if eplan is not None and ext == "auto":
            G_est0 = max(1, -(-m // BC))
            h_eff = eplan.r_hot if eplan.windowed else eplan.H
            vpu_ops = G_est0 * h_eff * BC * 3      # stage-2 dominates
            if (eplan.covered < 0.5 or eplan.n_out < 2048
                    or eplan.n_out < 0.005 * nnz
                    or vpu_ops * 0.74 > eplan.n_out * 500):
                eplan = None
    use_ext = eplan is not None
    if use_ext:
        hot_k = 0                # ext supersedes the top-k hot region

    trace.stage("hot_cols")
    if hot_k == "auto":
        hot_k = _auto_hot_k(out_cols, nnz) if nnz else 0
    Hs = hot_k // BC
    hot_idx = np.zeros(Hs * BC, np.int64)
    hot_rank = np.full(nnz, -1, np.int64)
    if hot_k:
        uniq, cnt = np.unique(out_cols, return_counts=True)
        topk = uniq[np.argsort(cnt)[::-1][:hot_k]]
        hot_idx[:topk.size] = np.sort(topk)
        lookup = np.full(n, -1, np.int64)
        lookup[hot_idx[:topk.size]] = np.arange(topk.size)
        hot_rank = lookup[cols]
        hot_rank[is_local] = -1

    eligible = is_local | (hot_rank >= 0)
    if use_ext:
        eligible |= eplan.ext_lane >= 0

    trace.stage("row_rank")
    # per-row rank among eligible entries (CSR order = column order)
    if nnz:
        excl = np.cumsum(eligible) - eligible
        start_excl = np.full(m, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(start_excl, rows, excl)
        sl = excl - start_excl[rows]
    else:
        sl = np.zeros(0, np.int64)

    trace.stage("slots")
    G_est = max(1, -(-m // BC))
    # Chips-tail feasibility probe at the smallest realistic Q (spill
    # sets shrink with Q, so this bounds every candidate): single
    # resident pipeline, else the local/far split proxy.
    cheap_tail = False
    if nnz:
        probe0 = ~(eligible & (sl < 8))
        if int(np.sum(probe0)):
            pu0 = np.unique(cols[probe0]).size
            e80 = -(-int(np.sum(probe0)) // (8 * BC)) * 8
            if (-(-pu0 // BC) <= chips_tail.H_CAP
                    and e80 * (-(-pu0 // BC)) * BC * 3
                    <= chips_tail.VPU_BUDGET):
                cheap_tail = True
            else:
                pf0 = probe0 & (np.abs(cols_w - rows) > chips_tail.W_LOC)
                fu0 = np.unique(cols[pf0]).size if pf0.any() else 0
                cheap_tail = -(-fu0 // BC) <= chips_tail.H_CAP
    if slots == "auto":
        # Minimize estimated bytes: each slot plane streams G*BC*(4+2)
        # bytes regardless of fill, while every spilled or ineligible
        # entry runs a tail at ~TAIL_BPN effective bytes/nnz (the
        # reference's TPU-measured costs, kept for parity).
        TAIL_BPN = 100 if cheap_tail else 2000
        SCAT_B = 8000 if TAIL_BPN < 2000 else 0
        rl_elig = np.bincount(rows[eligible], minlength=m) if nnz \
            else np.zeros(1)
        best_cost, Q = None, _Q_CHOICES[-1]
        for cand in _Q_CHOICES:
            spill = int(np.sum(eligible & (sl >= cand))) + \
                int(np.sum(~eligible))
            n_heavy = int(np.sum(rl_elig > cand))
            cost = (G_est * BC * 6 * cand + TAIL_BPN * spill
                    + SCAT_B * n_heavy)
            if best_cost is None or cost < best_cost:
                best_cost, Q = cost, cand
    else:
        Q = int(slots)
    if chunk is None:
        chunk = max(8, min(256, (2048 // Q) // 8 * 8))
    take0 = eligible & (sl < Q)

    trace.stage("demotion")
    # ---- strip demotion + relocation --------------------------------
    # Each primary plane keeps only its dominant strips (cumulative
    # coverage >= strip_cov); a demoted entry RELOCATES to another
    # plane that kept its strip, leftovers go to overflow planes.
    enc_all = np.where(is_local, off, S * BC + hot_rank)
    if use_ext:                  # ext strip sits after the hot strips
        enc_all = np.where(is_local, enc_all,
                           (S + Hs) * BC + eplan.ext_lane)
    strip_all = enc_all // BC
    plane = np.where(take0, sl, -1)           # final plane per entry
    nw = S + Hs + (1 if use_ext else 0)
    ext_w = (S + Hs) if use_ext else -1
    n_demoted = n_reloc = 0
    unpl = np.empty(0, np.int64)
    # ---- per-step DYNAMIC strip slots --------------------------------
    # Encoded as NEGATIVE members of used[q] (slot j = -(j+1)); entry
    # idx codes are nw + j (int16 planes only; dyn planes skip idx8).
    G_tot = max(1, -(-m // BC))
    G_pad = -(-G_tot // chunk) * chunk
    steps = G_pad // chunk
    dyn_k_of: dict[int, int] = {}        # plane -> dyn slot count
    dyn_keep: dict[int, np.ndarray] = {}  # plane -> (steps, S) kept
    dyn_pos: dict[int, np.ndarray] = {}   # plane -> (steps, S) slot j
    dyn_tab: dict[int, np.ndarray] = {}   # plane -> (steps, K) strips
    dyn_on = dyn_strips if dyn_strips != "auto" else not core_only
    if nnz and strip_cov is not None and Q > 0:
        pair, cnt = strip_pairs(sl, strip_all, nw, Q, where=take0)
        keep = np.zeros((Q, nw), bool)
        ti = np.flatnonzero(take0)
        step_all = grp // chunk
        for q in range(Q):
            msk = (pair // nw) == q
            if not msk.any():
                continue
            ws, cs = pair[msk] % nw, cnt[msk]
            n_loc = int(np.sum(ws < S))
            if dyn_on and n_loc > max_strips:
                # dynamic plane: ext/hot strips stay static members;
                # local strips ride per-step slots
                keep[q, ws[ws >= S]] = True
                ei = ti[sl[ti] == q]
                li = ei[strip_all[ei] < S]
                hist = np.zeros((steps, S), np.int64)
                np.add.at(hist, (step_all[li], strip_all[li]), 1)
                K = int(min(dyn_k, max(1, int((hist > 0).sum(
                    axis=1).max(initial=1)))))
                # top-K strips per step; ties broken by strip id
                part = np.argpartition(-hist, K - 1, axis=1)[:, :K]
                kept = np.zeros((steps, S), bool)
                np.put_along_axis(kept, part, True, axis=1)
                kept &= hist > 0
                # never keep a zero-count slot; stable slot order by
                # strip id so the table is deterministic
                pos = np.full((steps, S), -1, np.int64)
                srt = np.sort(np.where(kept, np.arange(S)[None, :],
                                       S), axis=1)[:, :K]
                for j in range(K):
                    sj = srt[:, j]
                    ok = sj < S
                    pos[np.flatnonzero(ok), sj[ok]] = j
                dyn_k_of[q] = K
                dyn_keep[q] = kept
                dyn_pos[q] = pos
                dyn_tab[q] = np.where(srt < S, srt, 0).astype(np.int32)
                continue
            order = np.argsort(cs)                    # ascending
            cum = np.cumsum(cs[order])
            ndrop = int(np.searchsorted(
                cum, (1 - strip_cov) * cum[-1], side="right"))
            # hard cap: keep at most max_strips and let relocation +
            # dedicated overflow planes absorb the rest
            ndrop = max(ndrop, len(ws) - max_strips)
            ndrop = min(ndrop, len(ws) - 1)
            keep[q, ws[order[ndrop:]]] = True
        nat = np.zeros(nnz, bool)
        nat[ti] = keep[sl[ti], strip_all[ti]]
        for q, kept in dyn_keep.items():
            ei = ti[sl[ti] == q]
            li = ei[strip_all[ei] < S]
            nat[li] = kept[step_all[li], strip_all[li]]
        unpl = np.flatnonzero(take0 & ~nat)
        n_demoted = int(unpl.size)
        plane[unpl] = -1
        if unpl.size:
            base_keys = np.sort(rows[nat] * (Q + 1) + sl[nat])
            extra_keys = np.empty(0, np.int64)

            def _in_sorted(keys, arr):
                if not arr.size:
                    return np.zeros(keys.shape, bool)
                p = np.minimum(np.searchsorted(arr, keys), arr.size - 1)
                return arr[p] == keys

            # per-strip keeper-plane lists, tried round-robin (spread
            # by row so same-strip entries of one row hit distinct
            # planes in the same pass); dynamic planes accept only
            # their STATIC members
            def _reloc(unpl, extra_keys):
                kp = [np.flatnonzero(keep[:, w]) for w in range(nw)]
                kp_size = np.array([p.size for p in kp])
                kp_len = np.maximum(kp_size, 1)
                kp_tab = np.zeros((nw, int(kp_len.max(initial=1))),
                                  np.int64)
                for w, p in enumerate(kp):
                    if p.size:
                        kp_tab[w, :p.size] = p
                n_pass = int(min(kp_len.max(initial=1), 24))
                for t in range(n_pass):
                    if not unpl.size:
                        break
                    w_u = strip_all[unpl]
                    slot = (rows[unpl] + t) % kp_len[w_u]
                    q2 = kp_tab[w_u, slot]
                    oki = np.flatnonzero(kp_size[w_u] > 0)
                    if not oki.size:
                        break
                    key = rows[unpl[oki]] * (Q + 1) + q2[oki]
                    free = ~(_in_sorted(key, base_keys)
                             | _in_sorted(key, extra_keys))
                    oki, key = oki[free], key[free]
                    if not oki.size:
                        continue
                    _, first = np.unique(key, return_index=True)
                    oki, key = oki[first], key[first]
                    plane[unpl[oki]] = q2[oki]
                    extra_keys = np.sort(np.concatenate([extra_keys,
                                                         key]))
                    unpl = np.delete(unpl, oki)
                return unpl, extra_keys

            unpl, extra_keys = _reloc(unpl, extra_keys)

            # ---- relocation-target augmentation ---------------------
            # Add a starved strip to high-free-capacity planes while
            # >= 1024 leftovers could route to each added keeper.
            if aug and unpl.size > 2048:
                occ = np.bincount(plane[plane >= 0], minlength=Q)[:Q]
                free_q = m - occ
                w_left = strip_all[unpl]
                mass = np.bincount(w_left, minlength=nw)
                added = 0
                for w in np.argsort(-mass):
                    if mass[w] < 2048:
                        continue
                    # a row with k same-strip leftovers needs k
                    # DISTINCT keeper planes with a free slot in that
                    # row — size the augmentation by the per-(row)
                    # rank tiers
                    lw = unpl[w_left == w]
                    rk = np.bincount(
                        np.unique(rows[lw], return_inverse=True)[1])
                    tier_sz = np.bincount(
                        np.concatenate([np.arange(k) for k in rk]))
                    n_add = int(np.sum(tier_sz >= 1024))
                    # int8-aware target order: prefer planes already at
                    # >= 3 strips, then 1-strip planes, then 2-strip
                    n_aug = keep[:Q].sum(axis=1)
                    cand = sorted(
                        (q for q in range(Q)
                         if not keep[q, w] and q not in dyn_k_of
                         and free_q[q] >= 1024),
                        key=lambda q: (0 if n_aug[q] >= 3 else
                                       1 if n_aug[q] <= 1 else 2,
                                       -free_q[q]))
                    for q in cand[:n_add]:
                        if added >= 24:
                            break
                        keep[q, w] = True
                        added += 1
                if added:
                    unpl, extra_keys = _reloc(unpl, extra_keys)

            # ---- post-relocation undrop -----------------------------
            # Return a leftover GROUP to its native (plane, strip) when
            # the group has >= undrop_min entries or the pass already
            # exists, and its native slot wasn't taken by a relocation.
            if unpl.size and undrop_min:
                gkey = sl[unpl] * np.int64(nw) + strip_all[unpl]
                skey = rows[unpl] * (Q + 1) + sl[unpl]
                taken = _in_sorted(skey, extra_keys)
                u_g, inv_g, c_g = np.unique(
                    gkey, return_inverse=True, return_counts=True)
                present = strip_pairs(plane, strip_all, nw, Q,
                                      where=plane >= 0)[0]
                free_pass = _in_sorted(gkey, present)
                back = ((c_g[inv_g] >= undrop_min) | free_pass) & ~taken
                plane[unpl[back]] = sl[unpl[back]]
                unpl = unpl[~back]
        n_reloc = n_demoted - int(unpl.size)

    # Leftovers whose row is ALREADY heavy (rank-spilled past Q) ride
    # the tail, which holds the row regardless.
    if unpl.size and cheap_tail:
        rl_all = np.bincount(rows[eligible], minlength=m)
        already_heavy = rl_all[rows[unpl]] > Q
        unpl = unpl[~already_heavy]

    # Overflow planes for unrelocatable leftovers, in two tiers:
    # (a) strip-wise DEDICATED planes — single-strip, sized to each
    #     strip's max per-(row,strip) count;
    # (b) a few catch-all planes (full decode) for the remainder.
    next_q = Q
    G_tot0 = max(1, -(-m // BC))
    ov_budget = min(ov_budget,
                    max(0, int(ded_bytes // (G_tot0 * BC * 6))))
    # a TINY residue rides the compact tail instead of spawning
    # near-empty dedicated/catch-all planes
    if aug and unpl.size <= 384:
        unpl = np.empty(0, np.int64)
    if unpl.size:
        w_u = strip_all[unpl]
        key = w_u * np.int64(m + 1) + rows[unpl]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        newgrp = np.r_[True, ks[1:] != ks[:-1]]
        first = np.flatnonzero(newgrp)
        gid = np.cumsum(newgrp) - 1
        rank = np.arange(ks.size) - first[gid]
        rank_u = np.empty(unpl.size, np.int64)
        rank_u[order] = rank
        strip_mass = np.bincount(w_u, minlength=nw)
        placed_mask = np.zeros(unpl.size, bool)
        for w in np.argsort(-strip_mass):
            if strip_mass[w] == 0 or next_q - Q >= ov_budget:
                break
            mw = w_u == w
            k_w = min(int(rank_u[mw].max()) + 1, ded_max,
                      Q + ov_budget - next_q)
            hit = mw & (rank_u < k_w)
            plane[unpl[hit]] = next_q + rank_u[hit]
            placed_mask |= hit
            next_q += k_w
        unpl = unpl[~placed_mask]
    catch0 = next_q
    if unpl.size:
        rem = np.zeros(nnz, bool)
        rem[unpl] = True
        excl2 = np.cumsum(rem) - rem
        start2 = np.full(m, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(start2, rows, excl2)
        sl2 = excl2 - start2[rows]
        ov = rem & (sl2 < ov_max)
        plane[ov] = next_q + sl2[ov]
        if ov.any():
            next_q += int(sl2[ov].max()) + 1
    trace.stage("dyn_strips")
    # Catch-all planes get per-step DYNAMIC local strips instead of the
    # full strip decode; the per-step top-dyn_k keeps most entries and
    # the rest join the tail.
    if next_q > catch0 and not core_only and nnz:
        step_all2 = grp // chunk
        for qc in range(catch0, next_q):
            ei = np.flatnonzero(plane == qc)
            li = ei[strip_all[ei] < S]
            if not li.size:
                continue
            hist = np.zeros((steps, S), np.int64)
            np.add.at(hist, (step_all2[li], strip_all[li]), 1)
            n_strips_q = int(np.unique(strip_all[li]).size)
            if n_strips_q <= max_strips:
                continue                   # static set already short
            K = int(min(dyn_k, max(1, int((hist > 0).sum(
                axis=1).max(initial=1)))))
            part = np.argpartition(-hist, K - 1, axis=1)[:, :K]
            kept = np.zeros((steps, S), bool)
            np.put_along_axis(kept, part, True, axis=1)
            kept &= hist > 0
            pos = np.full((steps, S), -1, np.int64)
            srt = np.sort(np.where(kept, np.arange(S)[None, :], S),
                          axis=1)[:, :K]
            for j in range(K):
                sj = srt[:, j]
                ok = sj < S
                pos[np.flatnonzero(ok), sj[ok]] = j
            drop = li[~kept[step_all2[li], strip_all[li]]]
            plane[drop] = -1
            dyn_k_of[qc] = K
            dyn_keep[qc] = kept
            dyn_pos[qc] = pos
            dyn_tab[qc] = np.where(srt < S, srt, 0).astype(np.int32)
    Qo = next_q - Q
    take = plane >= 0
    QT = Q + Qo

    trace.stage("demotion_cost")
    # ---- cost-aware demotion acceptance ------------------------------
    # Demotion trades streamed plane bytes (each plane: 6 B/lane/step)
    # for select passes (~SEL_B bytes-equivalent each); compare both
    # packings and keep the cheaper.
    if n_demoted and nnz:
        def _strip_ops(pl_arr, msk):
            return strip_pairs(pl_arr, strip_all, nw, QT, where=msk)[0].size
        if dyn_k_of:
            # dynamic planes run exactly K select passes per step;
            # count their static (hot) members from entries as usual
            dv = np.zeros(QT, bool)
            dv[list(dyn_k_of)] = True
            in_dyn = (plane >= 0) & dv[np.clip(plane, 0, QT - 1)]
            stat = take & (~in_dyn | (strip_all >= S))
            ops_d = _strip_ops(plane, stat) + sum(dyn_k_of.values())
        else:
            ops_d = _strip_ops(plane, take)
        plane_n = np.where(take0, sl, -1)
        ops_n = _strip_ops(plane_n, take0)
        n_tail_d = int(np.sum(take0 & ~take))   # demotion leftovers
        tb = 100 if cheap_tail else 2000
        cost_d = (QT * 6 + max(ops_d - QT, 0) * SEL_B) * G_pad * BC \
            + n_tail_d * tb
        cost_n = (Q * 6 + max(ops_n - Q, 0) * SEL_B) * G_pad * BC
        if cost_n < cost_d:
            plane = plane_n
            take = plane >= 0
            Qo, QT = 0, Q
            n_demoted = n_reloc = 0
            dyn_k_of, dyn_keep = {}, {}
            dyn_pos, dyn_tab = {}, {}

    # overflow-plane occupancy BEFORE the idx8 remap permutes ids
    n_ov_nnz = int(np.sum(plane >= Q)) if nnz else 0

    trace.stage("plane_major")
    # ---- pack plane-major arrays ------------------------------------
    sets: list[tuple] = [() for _ in range(QT)]
    pairs = np.empty(0, np.int64)
    if nnz:
        tq = plane[take]
        enc = enc_all[take]
        pw = enc // BC                # absolute strip id
        # dynamic planes list their local strips as negative SLOT
        # members (-1.. -K), not as static strips
        if dyn_k_of:
            dvec = np.zeros(QT, bool)
            dvec[list(dyn_k_of)] = True
            stat = ~(dvec[tq] & (pw < S))
        else:
            stat = None
        pairs = strip_pairs(tq, pw, nw, QT, where=stat)[0]
        acc_sets: list[list] = [[] for _ in range(QT)]
        for key in pairs.tolist():
            acc_sets[key // nw].append(key % nw)
        for q, K in dyn_k_of.items():
            acc_sets[q][:0] = range(-K, 0)
        sets = [tuple(u) for u in acc_sets]
    trace.note(pairs=int(pairs.size), table=QT * nw)
    n8 = 0
    second8 = np.zeros(0, np.int64)
    if idx8 and not core_only and nnz:
        order, sets, n8, second8 = idx8_partition(sets, chunk)
        remap = np.zeros(QT, np.int64)
        for newq, oldq in enumerate(order):
            remap[oldq] = newq
        tq = remap[tq]
        dyn_k_of = {int(remap[q]): K for q, K in dyn_k_of.items()}
        dyn_pos = {int(remap[q]): v for q, v in dyn_pos.items()}
        dyn_tab = {int(remap[q]): v for q, v in dyn_tab.items()}
    used_t = tuple(sets)
    # the core's entries, recorded once: each row's in plane order (the
    # rows core's layout, ops/lane_rows.py, takes them from here)
    core = np.flatnonzero(take) if nnz else np.zeros(0, np.int64)
    n16 = QT - n8

    vals_a = np.zeros((steps * QT * chunk, BC), np.float32)
    idx_a = np.zeros((steps * n16 * chunk, BC), np.int16)
    idx8_a = np.zeros((steps * n8 * chunk, BC), np.int8)
    if nnz:
        r = rows[core]
        key = r * np.int64(QT)
        key += tq
        core = core[np.argsort(key, kind="stable")]
        if dyn_k_of:
            st_t = r // (chunk * BC)
            for q, posq in dyn_pos.items():
                mloc = (tq == q) & (pw < S)
                if not mloc.any():
                    continue
                j = posq[st_t[mloc], pw[mloc]]
                if (j < 0).any():
                    raise AssertionError("dyn slot missing for kept entry")
                enc[mloc] = (nw + j) * BC + enc[mloc] % BC
        flat = _slot_index(r, tq, QT, chunk)
        vals_a.reshape(-1)[flat] = A.as_[take]
        if n8:
            m8 = tq < n8
            idx8_a.reshape(-1)[_slot_index(r[m8], tq[m8], n8, chunk)] = \
                idx8_encode(enc[m8], second8[tq[m8]])
            m16 = ~m8
            flat = _slot_index(r[m16], tq[m16] - n8, n16, chunk)
            enc = enc[m16]
        # (without int8 planes the int16 ones are the value planes)
        idx_a.reshape(-1)[flat] = enc.astype(np.int16)

    # resident x: loc_w left pad + local span + window slack, then hot
    P_pad = G_pad + S            # window read for the last step fits
    x_bytes = (P_pad + Hs) * BC * 4
    if not x_fits(x_bytes):
        raise ValueError(
            f"lane-ELL hybrid: resident x ({x_bytes} B) exceeds the "
            f"budget {X_VMEM_BUDGET} B")
    n_local = min(n - x_off, P_pad * BC - loc_w)

    if core_only:
        # the shard's host arrays; its ext tables index its own groups
        # and shapes pad to the shards' shared ones in the row-sharded
        # hybrid
        if Hs:
            raise AssertionError("core_only requires hot_k=0")
        if use_ext and ext_windowed:
            raise AssertionError("core_only ext requires ext_windowed=False")
        if dyn_k_of:
            raise AssertionError(
                "core_only (distributed) runs static strip sets only")
        tm = ~take if nnz else np.zeros(0, bool)
        extb = {}
        if use_ext:
            p2_a, l2_a = ext_gather.build_group_tables(eplan, G_pad)
            extb = dict(ext_ng=eplan.n_groups, ext_n1p=eplan.n1p_blocks,
                        ext_base=eplan.base, ext_p1=eplan.p1,
                        ext_l1=eplan.l1, ext_p2=p2_a, ext_l2=l2_a,
                        ext_cov=eplan.covered, ext_n_out=eplan.n_out)
        return CoreBuild(
            vals_a=vals_a, idx_a=idx_a, used=used_t, Q=Q, Qo=Qo, QT=QT,
            S=S, chunk=chunk, steps=steps, G_pad=G_pad, P_pad=P_pad,
            loc_w=loc_w, n_local=n_local, m=m, trows=rows[tm],
            tcols=cols[tm], tvals=A.as_[tm], n_demoted=n_demoted,
            n_reloc=n_reloc, core=core, **extb)

    # per-step dynamic strip table, flattened
    dyn_off: dict[int, int] = {}
    TD = 0
    for q in sorted(dyn_k_of):
        dyn_off[q] = TD
        TD += dyn_k_of[q]
    dynw_a = np.zeros((steps, TD), np.int32)
    for q, tab in dyn_tab.items():
        dynw_a[:, dyn_off[q]:dyn_off[q] + dyn_k_of[q]] = tab

    trace.stage("ext_stage2")
    # ---- ext stage-2 tables --------------------------------------------
    ext_p2 = ext_l2 = ext_b8 = None
    if use_ext:
        # the reference's windowed stage-2 needs 8-row output steps; it
        # falls back to the resident one when G_pad isn't 8-aligned
        if eplan.windowed and G_pad % 8:
            eplan.windowed = False    # tables revert to absolute p2
        G2t = G_pad if eplan.windowed else -(-G_pad // 8) * 8
        ext_p2, ext_l2 = ext_gather.build_group_tables(eplan, G2t)
        if eplan.windowed:
            ext_b8 = ext_gather.build_base8(eplan, G_pad)

    trace.stage("tail")
    # ---- tail: chips, else compact -----------------------------------
    tail_nnz = int(np.sum(~take)) if nnz else 0
    if "notail" in diag:        # diag-only: results invalid, core cost
        tail_nnz = 0
    tm = ~take if tail_nnz else np.zeros(nnz, bool)
    cplan = chips_meta = big = None
    if tail_nnz >= 2048 and "nochips" not in diag:
        # past BIG_TAIL entries the reference drops a split plan for the
        # big-tail branch ("forcechips" keeps it), so none is planned
        cplan = chips_tail.plan_chips(
            rows[tm], cols[tm], A.as_[tm], m, n,
            big_tail=tail_nnz > BIG_TAIL and "forcechips" not in diag)
    if cplan is not None:
        chips_meta = chips_tail.chips_meta(
            cplan, chips_tail.merge_kind(cplan.heavy_ids, m, G_pad)
            != "scatter")
    elif tail_nnz > tail_xla_max:
        # big tails: a second hybrid when the tail keeps diagonal or hub
        # locality ("auto"), else PELL (or XPOSE when asked for) over
        # the tail's rows compacted
        big = tail_strategy
        if big == "auto":
            d = np.abs(cols[tm] - rows[tm])
            local = float(np.mean(d <= 4096))
            big = ("pallas-hybrid" if depth < max_depth and local >= 0.4
                   else "pallas-pell")
        if big in FP64_GRADES:
            raise ValueError(
                f"lane-ELL hybrid: tail_strategy {big!r} computes at fp64 "
                f"grade, and a {tail_nnz}-entry fp64 tail cannot land in "
                "the f32 core's y (the reference accepts it at prepare "
                "time and fails at its first call, lane_ell.py:1569-1581: "
                "its compact branch feeds the f32 x to a strategy that "
                "takes the hi/lo x pair); use an f32 tail_strategy, or "
                "cuda-hybrid-fp64 / cuda-pell-fp64 for the whole matrix")
        if big != "pallas-hybrid":
            compact_strategy(big)

    meta = {"loc_w": loc_w, "slots": Q, "ov_slots": Qo,
            "hot_k": hot_k, "idx8_planes": n8,
            "ext": use_ext,
            "ext_h": eplan.H if use_ext else 0,
            "ext_windowed": bool(use_ext and eplan.windowed),
            "ext_r_hot": eplan.r_hot if use_ext else 0,
            "ext_groups": eplan.n_groups if use_ext else 0,
            "ext_cov": round(eplan.covered, 4) if use_ext else None,
            "strips": S, "hot_strips": Hs, "chunk": chunk,
            "steps": steps,
            "strip_ops": sum(len(u) for u in used_t),
            "dyn_planes": len(dyn_k_of),
            "dyn_k": max(dyn_k_of.values(), default=0),
            "demoted": n_demoted, "relocated": n_reloc,
            "ov_nnz": n_ov_nnz,
            "fill": float(np.sum(take)) / max(G_pad * QT * BC, 1),
            "tail_nnz": tail_nnz,
            "tail_kind": (None if not tail_nnz else
                          "chips" if cplan is not None else
                          "torch-compact" if big is None else
                          f"hybrid-r{depth + 1}" if big == "pallas-hybrid"
                          else f"compact-{compact_strategy(big)}"),
            "tail_meta": chips_meta,
            "tail_frac": tail_nnz / max(nnz, 1)}
    cfg = LaneCfg(QT=QT, n8=n8, chunk=chunk, steps=steps, S=S, nw=nw,
                  TD=TD, P_pad=P_pad, ext_w=ext_w)
    return LanePlan(
        cfg=cfg, vals_a=vals_a, idx8_a=idx8_a, idx_a=idx_a, used=used_t,
        hot_idx=hot_idx, dynw_a=dynw_a.reshape(-1), dyn_off=dyn_off,
        Q=Q, Qo=Qo, loc_w=loc_w, n_local=n_local, m=m,
        trows=rows[tm], tcols=cols[tm], tvals=A.as_[tm], meta=meta,
        ext=eplan, ext_p2=ext_p2, ext_l2=ext_l2, ext_b8=ext_b8,
        chips=cplan, big_tail=big, core=core)


# ---------------------------------------------------------------------------
# The core kernel and its plain version
# ---------------------------------------------------------------------------

def _check_tensors(what: str, device, want: dict) -> None:
    """Raise ValueError unless each ``name: (tensor, dtype, shape)`` of
    ``want`` is a contiguous tensor of that dtype and shape on
    ``device`` (the device of xpad)."""
    for name, (t, dtype, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, xpad on "
                             f"{device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_args(xpad, vals, idx8, idx16, plane_tabs, dynw, ext,
                cfg: LaneCfg):
    _check_tensors("lane_ell_spmv", xpad.device, {
        "xpad": (xpad, torch.float32, ((cfg.P_pad + cfg.Hs) * BC,)),
        "vals": (vals, torch.float32, (cfg.steps * cfg.QT * cfg.chunk, BC)),
        "idx8": (idx8, torch.int8, (cfg.steps * cfg.n8 * cfg.chunk, BC)),
        "idx16": (idx16, torch.int16,
                  (cfg.steps * (cfg.QT - cfg.n8) * cfg.chunk, BC)),
        "plane_tabs": (plane_tabs, torch.int32, (cfg.QT, 2)),
        "dynw": (dynw, torch.int32, (cfg.steps * cfg.TD,)),
        "ext": (ext, torch.float32,
                (cfg.G_pad if cfg.ext_w >= 0 else 0, BC)),
    })


@trace.launch("lane_ell_spmv")
def lane_ell_spmv(xpad, vals, idx8, idx16, plane_tabs, dynw, ext,
                  cfg: LaneCfg) -> torch.Tensor:
    """Core lane-ELL SpMV: ``y`` of shape (G_pad*128,) f32 (row
    ``g*128 + l``). ``ext`` holds the per-group ext panels (G_pad, 128),
    or no rows when ``cfg.ext_w < 0``. CUDA tensors launch
    ``csrc/lane_ell.cu`` on the current stream; CPU tensors run
    :func:`lane_ell_spmv_plain`."""
    global KERNEL_LAUNCHES
    _check_args(xpad, vals, idx8, idx16, plane_tabs, dynw, ext, cfg)
    if xpad.device.type == "cpu":
        return lane_ell_spmv_plain(xpad, vals, idx8, idx16, plane_tabs,
                                   dynw, ext, cfg)
    if xpad.device.type != "cuda":
        raise ValueError(f"lane_ell_spmv: unsupported device {xpad.device}")
    lib = _kernels.load("lane_ell")
    y = torch.empty(cfg.G_pad * BC, dtype=torch.float32, device=xpad.device)
    err = lib.lane_ell_spmv(
        xpad.data_ptr(), vals.data_ptr(), idx8.data_ptr(),
        idx16.data_ptr(), plane_tabs.data_ptr(), dynw.data_ptr(),
        ext.data_ptr(), y.data_ptr(), cfg.G_pad, cfg.QT, cfg.n8, cfg.chunk,
        cfg.S, cfg.nw, cfg.TD, cfg.P_pad, cfg.ext_w,
        _kernels.stream_handle(xpad.device))
    _kernels.check(lib, err, "lane_ell_spmv")
    KERNEL_LAUNCHES += 1
    return y


def lane_ell_spmv_plain(xpad, vals, idx8, idx16, plane_tabs, dynw, ext,
                        cfg: LaneCfg) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: per plane in ascending
    order, decode each slot to an absolute padded-x index (or a lane of
    the group's ext panel), gather, multiply and add in f32 (product and
    sum rounded separately, as the kernel does)."""
    QT, n8, chunk, steps, S, nw = (cfg.QT, cfg.n8, cfg.chunk, cfg.steps,
                                   cfg.S, cfg.nw)
    dev = xpad.device
    v4 = vals.view(steps, QT, chunk, BC)
    i8 = idx8.view(steps, n8, chunk, BC)
    i16 = idx16.view(steps, QT - n8, chunk, BC)
    tabs = plane_tabs.to(torch.int64)
    g = torch.arange(cfg.G_pad, device=dev).view(steps, chunk, 1)
    step_of = torch.arange(steps, device=dev).view(steps, 1, 1)
    ext_f = ext.reshape(-1)
    acc = torch.zeros(steps, chunk, BC, dtype=torch.float32, device=dev)
    for q in range(QT):
        if q < n8:
            code = i8[:, q].to(torch.int64) & 255
            strip = torch.where((code >> 7) == 1, tabs[q, 1], tabs[q, 0])
        else:
            code = i16[:, q - n8].to(torch.int64)
            strip = code >> 7
            if cfg.TD:
                slot = (step_of * cfg.TD + tabs[q, 0]
                        + (strip - nw).clamp(min=0))
                strip = torch.where(
                    strip >= nw,
                    dynw[slot.clamp(max=dynw.numel() - 1)].to(torch.int64),
                    strip)
        lane = code & 127
        xrow = torch.where(strip < S, g + strip, cfg.P_pad + strip - S)
        if cfg.ext_w >= 0:
            is_ext = strip == cfg.ext_w
            xv = torch.where(is_ext, ext_f[g * BC + lane],
                             xpad[torch.where(is_ext, 0, xrow) * BC + lane])
        else:
            xv = xpad[xrow * BC + lane]
        acc = acc + v4[:, q] * xv
    return acc.reshape(-1)


def _check_sharded(xpad, r0, vals, idx8, idx16, plane_tabs, ext,
                   cfg: LaneCfg) -> int:
    if cfg.TD or cfg.Hs:
        raise ValueError("lane_ell_sharded: a row shard's core has no "
                         f"dynamic or hot strips (TD {cfg.TD}, Hs {cfg.Hs})")
    if r0.dim() != 1 or r0.numel() < 1:
        raise ValueError(f"lane_ell_sharded: r0 is {tuple(r0.shape)}, "
                         "expected (n_sh,) with n_sh >= 1")
    n_sh = r0.numel()
    if xpad.dtype != torch.float32 or xpad.dim() != 1 \
            or xpad.numel() < cfg.P_pad * BC:
        raise ValueError(f"lane_ell_sharded: xpad is {xpad.dtype} "
                         f"{tuple(xpad.shape)}, expected float32 with at "
                         f"least {cfg.P_pad * BC} elements")
    if not xpad.is_contiguous():
        raise ValueError("lane_ell_sharded: xpad is not contiguous")
    rows = cfg.steps * cfg.chunk
    _check_tensors("lane_ell_sharded", xpad.device, {
        "r0": (r0, torch.int32, (n_sh,)),
        "vals": (vals, torch.float32, (n_sh, rows * cfg.QT, BC)),
        "idx8": (idx8, torch.int8, (n_sh, rows * cfg.n8, BC)),
        "idx16": (idx16, torch.int16, (n_sh, rows * (cfg.QT - cfg.n8), BC)),
        "plane_tabs": (plane_tabs, torch.int32, (cfg.QT, 2)),
        "ext": (ext, torch.float32,
                (n_sh, cfg.G_pad if cfg.ext_w >= 0 else 0, BC)),
    })
    if xpad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_ell_sharded: unsupported device "
                         f"{xpad.device}")
    return n_sh


@trace.launch("lane_ell_sharded")
def lane_ell_sharded(xpad, r0, vals, idx8, idx16, plane_tabs, ext,
                     cfg: LaneCfg) -> torch.Tensor:
    """The core of ``n_sh`` row shards in one launch: ``y`` (n_sh,
    G_pad*128) f32, row ``g*128 + l`` of shard d. Shard d's planes are
    ``vals[d]``, ``idx8[d]``, ``idx16[d]`` (stacked, padded to the shared
    ``cfg.QT``; int8 codes positional over the union strip sets of
    ``plane_tabs``), its ext panels ``ext[d]`` (no rows without ext), and
    its x window the ``P_pad*128`` elements of ``xpad`` from ``r0[d]``,
    clamped to lie in ``xpad`` as ``dynamic_slice`` clamps. CUDA tensors
    launch ``csrc/lane_ell.cu``; CPU tensors run
    :func:`lane_ell_sharded_plain`."""
    global SHARDED_LAUNCHES
    n_sh = _check_sharded(xpad, r0, vals, idx8, idx16, plane_tabs, ext, cfg)
    if xpad.device.type == "cpu":
        return lane_ell_sharded_plain(xpad, r0, vals, idx8, idx16,
                                      plane_tabs, ext, cfg)
    lib = _kernels.load("lane_ell")
    y = torch.empty((n_sh, cfg.G_pad * BC), dtype=torch.float32,
                    device=xpad.device)
    err = lib.lane_ell_sharded(
        xpad.data_ptr(), r0.data_ptr(), vals.data_ptr(), idx8.data_ptr(),
        idx16.data_ptr(), plane_tabs.data_ptr(), ext.data_ptr(), y.data_ptr(),
        xpad.numel(), n_sh, cfg.G_pad, cfg.QT, cfg.n8, cfg.chunk, cfg.S,
        cfg.P_pad, cfg.ext_w, _kernels.stream_handle(xpad.device))
    _kernels.check(lib, err, "lane_ell_sharded")
    SHARDED_LAUNCHES += 1
    return y


def lane_ell_sharded_plain(xpad, r0, vals, idx8, idx16, plane_tabs, ext,
                           cfg: LaneCfg) -> torch.Tensor:
    """:func:`lane_ell_sharded` in PyTorch ops: each shard's window of
    ``xpad`` through :func:`lane_ell_spmv_plain`."""
    xw = cfg.P_pad * BC
    base = r0.to(torch.int64).clamp(0, xpad.numel() - xw).tolist()
    dynw = torch.zeros(0, dtype=torch.int32, device=xpad.device)
    return torch.stack([
        lane_ell_spmv_plain(xpad[b:b + xw], vals[d], idx8[d], idx16[d],
                            plane_tabs, dynw, ext[d], cfg)
        for d, b in enumerate(base)])


# The functions one hybrid call runs: the core (``lane_rows`` on the
# rows layout, ``lane_ell_spmv`` on the lanes layout), the three gathers
# of the lanes core's ext route, the chips tail's slot products, the
# landing ``heavy_land``, the PELL family's (:class:`pell.PellKernels`,
# the window segment-sum among them) for the chips tail, the no-locality
# escape and the compact big tail, and XPOSE's
# (:class:`xpose.XposeKernels`) for the compact XPOSE big tail.
HybridKernels = NamedTuple("HybridKernels", [
    (name, Callable) for name in ("lane_ell_spmv", "lane_rows",
                                  "sorted_gather", "ranked_gather",
                                  "window_gather", "chips_products",
                                  "heavy_land")
    + pell.PellKernels._fields + xpose.XposeKernels._fields])

KERNELS = HybridKernels(lane_ell_spmv, lane_rows.lane_rows,
                        ext_gather.sorted_gather, ext_gather.ranked_gather,
                        ext_gather.window_gather, chips_slots.chips_products,
                        chips_tail.heavy_land, *pell.KERNELS, *xpose.KERNELS)
PLAIN = HybridKernels(lane_ell_spmv_plain, lane_rows.lane_rows_plain,
                      ext_gather.sorted_gather_plain,
                      ext_gather.ranked_gather_plain,
                      ext_gather.window_gather_plain,
                      chips_slots.chips_products_plain,
                      chips_tail.heavy_land_plain, *pell.PLAIN, *xpose.PLAIN)

# The core's layouts: row quanta (ops/lane_rows.py, the default) and the
# reference's slot planes.
CORE_LAYOUTS = ("rows", "lanes")


def check_layouts(layouts) -> None:
    """Raise ValueError for a layout of ``layouts`` not in
    ``CORE_LAYOUTS``."""
    for layout in layouts:
        if layout not in CORE_LAYOUTS:
            raise ValueError(f"core_layout {layout!r} is not one of "
                             f"{CORE_LAYOUTS}")


# ---------------------------------------------------------------------------
# The strategy
# ---------------------------------------------------------------------------

@trace.span("pack.plan", fn="no_locality")
def no_locality(A: CSR, loc_w="auto", ext="auto",
                tail_strategy="pallas-pell", depth: int = 0,
                core_only: bool = False, x_off: int = 0, **_):
    """The reference's no-locality escape (lane_ell.py:618-634): with
    the default ``loc_w``, ``ext`` and ``tail_strategy`` at depth 0, a
    matrix whose widest diagonal window (4096 columns) covers under 40%
    of its entries goes to PELL whole. Returns that coverage when the
    escape applies, else None."""
    if not (loc_w == "auto" and depth == 0 and not core_only and A.nnz
            and ext == "auto" and tail_strategy == "pallas-pell"):
        return None
    d = np.abs(A.ja.astype(np.int64) - x_off - A.row_ids())
    d_cov = float(np.mean(d <= _LOC_CHOICES[-1]))
    return d_cov if d_cov < 0.4 else None


def prepare_lane_ell_hybrid(A: CSR, device="cuda", pell_layout="auto",
                            core_layout="rows", xpose_s3="rows",
                            xpose_s1="auto", **knobs):
    """Pack ``A`` (:func:`pack_lane_ell`, same knobs as the reference)
    and bind ``fn(x) -> y`` on ``device``: run the core, add the tail
    (chips tail and landing, the compact ``index_add_``, or the big-tail
    branch). ``core_layout``: ``"rows"`` (the default: the core's
    entries in row quanta read x in place, ``ops/lane_rows.py``, kernel
    ``lane_rows``) or ``"lanes"`` (the reference's slot planes, kernel
    ``lane_ell_spmv``, with x staged: the ``loc_w`` left pad, the hot
    columns and the ext panels). The meta is the packer's, the same on
    both; ``hbm_bytes`` counts the layout's own arrays. A matrix without
    diagonal locality returns ``cuda-pell``'s Prepared instead, its meta
    marked ``delegated``. ``pell_layout``: the layout of that escape and
    of a compact PELL tail; ``xpose_s3`` and ``xpose_s1``: the S3 and S1
    designs of a compact XPOSE tail (``xpose.S3_DESIGNS``,
    ``xpose.S1_DESIGNS``). ``device`` defaults to the card and raises
    without one; ``"cpu"`` runs the plain versions."""
    return prepare_hybrid_layouts(A, (core_layout,), device, pell_layout,
                                  xpose_s3, xpose_s1, **knobs)[core_layout]


def prepare_hybrid_layouts(A: CSR, layouts=CORE_LAYOUTS, device="cuda",
                           pell_layout="auto", xpose_s3="rows",
                           xpose_s1="auto", **knobs) -> dict:
    """:func:`prepare_lane_ell_hybrid` on each core layout of
    ``layouts`` from one pack: ``{layout: Prepared}``, the tail bound
    once and shared."""
    check_layouts(layouts)
    xpose.resolve_s1(xpose_s1, xpose_s3)
    dev = resolve_device(device)
    pell.use_layout(pell_layout)
    d_cov = no_locality(A, **knobs)
    if d_cov is not None:
        prep = pell.prepare_pell(A, device=dev, layout=pell_layout)
        prep.meta.setdefault("tail_kind", "cuda-pell")
        prep.meta["delegated"] = "cuda-pell"
        prep.meta["d_cov"] = round(d_cov, 4)
        return dict.fromkeys(layouts, prep)
    plan, bound = _bind(A, dev, pell_layout, layouts, (xpose_s3, xpose_s1),
                        **knobs)
    out = {}
    for key in layouts:
        run, stage, hbm = bound[key]
        out[key] = Prepared(
            "cuda-hybrid", A.name, functools.partial(run, ops=KERNELS),
            device=dev, nnz=A.nnz, ref="pallas-hybrid", hbm_bytes=int(hbm),
            meta=dict(plan.meta),
            plain=functools.partial(run, ops=PLAIN),
            kernel_inputs=stage,
            kernel_calls=functools.partial(_record, run), run=run)
    return out


def _record(run, xf):
    return record_calls(lambda ops: run(xf, ops), PLAIN)


def compact_strategy(big: str) -> str:
    """The port's strategy for a big tail through the reference's
    ``tail_strategy`` ``big`` (one of :data:`COMPACT_TAILS`, mapped
    through ``ref``); a ValueError for any other name, saying what the
    reference does with it."""
    if big in COMPACT_TAILS:
        return by_ref(big).name
    why = REFUSED_TAILS.get(big, "raises KeyError at prepare: it is not "
                                 "one of its strategies")
    raise ValueError(
        f"lane-ELL hybrid: tail_strategy {big!r} cannot take a compact big "
        f"tail: the reference {why}; use one of {COMPACT_TAILS}, "
        "'pallas-hybrid' or 'auto'")


@trace.span("pack.plan", fn="compact_tail")
def compact_tail(A: CSR, plan: LanePlan):
    """The big tail of ``plan`` as its own matrix over the tail's rows
    renumbered 0..NH-1: (that CSR, the tail's row ids in ``A``)."""
    R = np.unique(plan.trows)
    tail = CSR.from_coo(A.name + "_tail", int(R.size), A.n,
                        np.searchsorted(R, plan.trows), plan.tcols,
                        plan.tvals)
    return tail, R


@trace.span("pack.layout", fn="rows_plan")
def rows_plan(A: CSR, plan: LanePlan | CoreBuild) -> lane_rows.CorePlan:
    """The core that ``pack_lane_ell`` recorded, in row quanta."""
    c = plan.core
    return lane_rows.plan_core(plan.m, A.n, A.row_ids()[c], A.ja[c],
                               A.as_[c].astype(np.float32))


@trace.span("pack.upload")
def _put(a, dtype, dev):
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    trace.note(bytes=t.nbytes)
    return t


def _rows_core(A: CSR, plan: LanePlan, dev):
    """The rows core: (``core(xf, ops) -> y (m,)``, ``stage(xf)`` its
    kernel's arguments, the layout's bytes)."""
    cp = rows_plan(A, plan)
    tabs = lane_rows.bind(cp, dev)

    def stage(xf, ops=KERNELS):
        return (*tabs, xf)

    def core(xf, ops):
        return ops.lane_rows(*tabs, xf)

    return core, stage, cp.hbm_bytes


def _lanes_core(A: CSR, plan: LanePlan, dev):
    """The lanes core: (``core(xf, ops) -> y (m,)``, ``stage(xf, ops)``
    its kernel's arguments with x staged, the planes' bytes)."""
    cfg = plan.cfg
    vals = _put(plan.vals_a, torch.float32, dev)
    idx8 = _put(plan.idx8_a, torch.int8, dev)
    idx16 = _put(plan.idx_a, torch.int16, dev)
    tabs = _put(plan.plane_tabs(), torch.int32, dev)
    dynw = _put(plan.dynw_a, torch.int32, dev)
    hot = _put(plan.hot_idx, torch.int64, dev)
    loc_w, n_local, m, n = plan.loc_w, plan.n_local, plan.m, A.n
    no_ext = torch.zeros((0, BC), dtype=torch.float32, device=dev)
    ep = plan.ext
    if ep is not None:
        e_base = _put(ep.base, torch.int32, dev)
        e_p1, e_l1 = _put(ep.p1, torch.int32, dev), _put(ep.l1, torch.int32,
                                                          dev)
        e_p2, e_l2 = (_put(plan.ext_p2, torch.int32, dev),
                      _put(plan.ext_l2, torch.int32, dev))
        e_b8 = _put(plan.ext_b8, torch.int32, dev) if ep.windowed else None
        n1 = ep.n1p_blocks * ep.R * BC

    def ext_panels(xf, ops):
        """Stage 1 into the hot region, stage 2 into (G_pad, 128)."""
        x1 = torch.zeros(n1, dtype=torch.float32, device=dev)
        x1[:n] = xf
        hot1 = ops.sorted_gather(e_base, x1.view(-1, BC), e_p1, e_l1, ep.R)
        if not ep.windowed:
            return ops.ranked_gather(hot1, e_p2, e_l2)[:cfg.G_pad]
        if hot1.shape[0] < ep.H_pad:
            hot1 = torch.cat([hot1, torch.zeros(
                (ep.H_pad - hot1.shape[0], BC), dtype=torch.float32,
                device=dev)])
        return ops.window_gather(e_b8, hot1[:ep.H_pad].contiguous(), e_p2,
                                 e_l2, ep.r_hot)

    def stage(xf, ops=KERNELS):
        """x (f32 on ``dev``) -> the core's arguments: the padded x is
        the loc_w left pad, x, window slack, then the hot columns; the
        ext panels come from the gathers in ``ops``."""
        xpad = torch.zeros((cfg.P_pad + cfg.Hs) * BC, dtype=torch.float32,
                           device=dev)
        xpad[loc_w:loc_w + n_local] = xf[:n_local]
        if cfg.Hs:
            xpad[cfg.P_pad * BC:] = xf[hot]
        ext = no_ext if ep is None else ext_panels(xf, ops)
        return xpad, vals, idx8, idx16, tabs, dynw, ext, cfg

    def core(xf, ops):
        return ops.lane_ell_spmv(*stage(xf, ops))[:m]

    return core, stage, cfg.steps * cfg.chunk * BC * plan.slot_bytes


def _bind_tail(A: CSR, plan: LanePlan, dev, pell_layout, layouts, xdesign,
               knobs):
    """The tail of ``plan``, bound once for every core layout: returns
    (``add(y, xf, ops, layout) -> y'``, {layout: its bytes}). Fills the
    plan's meta for a big tail. ``xdesign``: (S3, S1) design of a compact
    XPOSE tail. The chips tail's sums and a compact tail's rows land in
    the core's y in place (``chips_tail.heavy_land``)."""
    m, n = plan.m, A.n
    if plan.chips is not None:
        add, hbm = chips_tail.land_chips(plan.chips, n, m, dev)
        return ((lambda y, xf, ops, layout: add(y, xf, ops)),
                dict.fromkeys(layouts, hbm))
    if plan.big_tail == "pallas-hybrid":
        # the tail as a second hybrid over all m rows (the reference
        # passes on only the depth and tail_xla_max), on the same layouts
        tail = CSR.from_coo(A.name + "_tail", m, n, plan.trows, plan.tcols,
                            plan.tvals)
        sub, subs = _bind(
            tail, dev, pell_layout, layouts, xdesign,
            depth=knobs.get("depth", 0) + 1,
            max_depth=knobs.get("max_depth", 2),
            tail_xla_max=knobs.get("tail_xla_max", 32768))
        plan.meta["tail_meta"] = sub.meta
        return ((lambda y, xf, ops, layout: y + subs[layout][0](xf, ops)),
                {layout: subs[layout][2] for layout in layouts})
    if plan.big_tail is not None:
        # the port's strategy for the reference's over the tail's NH rows
        # renumbered 0..NH-1, run inside the call with its kernels taken
        # from ops, its rows landed like the chips tail's per-row sums;
        # a layout that is not the reference's names itself in tail_kind
        tail, R = compact_tail(A, plan)
        name = compact_strategy(plan.big_tail)
        s3, s1 = xdesign
        kw = {"cuda-pell": {"layout": pell_layout},
              "cuda-bcsr": {"layout": pell_layout},
              "cuda-xpose": {"s3": s3, "s1": s1},
              "cuda-nearfar": {"s3": s3, "s1": s1, "pell_layout": pell_layout},
              }.get(name, {})
        sub = get_strategy(name).prepare(tail, device=dev, **kw)
        sub_run = sub.run or (lambda xf, ops: sub.fn(xf))
        t_hbm = sub.hbm_bytes
        plan.meta["tail_meta"] = sub.meta
        plan.meta["tail_kind"] = f"compact-{name}" + (
            f"-{sub.meta['layout']}" if "layout" in sub.meta else "")
        t_land = chips_tail.bind_land(R, m, dev)
        return ((lambda y, xf, ops, layout:
                 ops.heavy_land(y, sub_run(xf, ops), t_land)),
                dict.fromkeys(layouts, chips_tail.land_hbm(R) + t_hbm))
    if plan.trows.size:
        trows = _put(plan.trows, torch.int64, dev)
        tcols = _put(plan.tcols, torch.int64, dev)
        tvals = _put(plan.tvals, torch.float32, dev)
        return ((lambda y, xf, ops, layout:
                 y.index_add_(0, trows, tvals * xf[tcols])),
                dict.fromkeys(layouts, plan.trows.size * 12))
    return (lambda y, xf, ops, layout: y), dict.fromkeys(layouts, 0)


def _bind(A: CSR, dev, pell_layout="auto", layouts=("rows",),
          xdesign=("rows", "auto"), **knobs):
    """Pack ``A`` once and bind it on ``dev`` for each core layout of
    ``layouts``: returns (plan, {layout: (run, stage, hbm_bytes)}) with
    ``run(x, ops) -> y`` (m,) and ``stage(xf)`` the core kernel's
    arguments. The tail is bound once; ``xdesign`` is the (S3, S1) design
    of a compact XPOSE tail."""
    plan = pack_lane_ell(A, **knobs)
    n = A.n
    cores = [c for c in CORE_LAYOUTS if c in layouts]
    add_tail, tail_hbm = _bind_tail(A, plan, dev, pell_layout, cores,
                                    xdesign, knobs)
    out = {}
    for layout in cores:
        core, stage, core_hbm = (_rows_core if layout == "rows"
                                 else _lanes_core)(A, plan, dev)

        def run(x, ops, core=core, layout=layout):
            xf = torch.as_tensor(x, dtype=torch.float32, device=dev)
            if xf.shape != (n,):
                raise ValueError(f"cuda-hybrid: x has shape "
                                 f"{tuple(xf.shape)}, expected ({n},)")
            return add_tail(core(xf, ops), xf, ops, layout)

        out[layout] = (run, stage, core_hbm + tail_hbm[layout])
    return plan, out

"""Host planner for XPOSE — the scattered-regime SpMV pipeline (the
port's copy of ``spmv_scpa_tpu/ops/xpose_plan.py``, unchanged below this
paragraph but for three additions, so that its plans equal the
reference's array for array; ``tests/test_torch_xpose.py`` holds them
equal). The port's kernels (``ops/xpose.py``, ``csrc/xpose.cu``) execute
the same planes on Hopper. The TPU-sized bounds stay for parity:
``X_EXT_BUDGET`` (VMEM residency of the x window table),
``J1_MAX``/``B2_MAX`` (the uint8 planes), ``MIR_TJ`` and ``KEEP_MIN``
(fill targets of the TPU's step cost); ROADMAP queue 1 #5 re-derives
them on the card. The additions:

* ``plan_xpose(A, seed, j1_max)``: the step cap, ``J1_MAX`` (the
  reference's, read when the plan is made) where ``j1_max`` is None;
* the mid-row (step) plane ``sub`` in the narrowest unsigned type that
  holds every step (:func:`step_dtype`): uint8, the reference's, up to
  256 steps, so every plan inside the reference's envelope is its plan;
  uint16 past it, up to ``HOPPER_J1_MAX``. The reference's ``J1_MAX`` of
  254 is that uint8 index, which the port's Hopper designs (an int32
  step in each slot-table chunk, 32-bit flat positions into mid) do not
  have;
* ``trace.stage`` sections (``colorings``, ``s1_planes``, ``s3_index``,
  ``y_routes``), recorded where a span is open (``xpose.plan_or_raise``).

Reference analog: the irregular-matrix CUDA results the reference gets
from its texture-cached CSR kernels (``cuda_csr.cu:145-178`` k4 +
``cuda_hll.cu:49-72`` k1) on webbase-1M/amazon0302-class matrices.
A GPU hides scattered ``x[JA[j]]`` reads behind per-thread caches; a
TPU has no per-lane HBM gather at all, so XPOSE restructures the whole
product as a static-routed transpose (measured primitives:
docs/PERF_LOG.md round 4, scripts/tpu_probe_r4c*.py):

  S1 (Pallas)  x-window lane-gather slabs -> multiply -> per-step
               static route (TLG = transpose/lane-gather/transpose)
               into fixed one-tile-row runs grouped by out-block.
  S2 (XLA)     major-dim transpose (J1, K1, 128) -> (K1, J1, 128):
               the all-to-all between column order and row order,
               at copy bandwidth (block-granular, minor dim intact).
  S3 (Pallas)  per out-block: windowed TLG + lane route to the exact
               dense row-major slot -> MXU prefix-sum (values @
               upper-tri) + cross-tile-row carry (two more MXU ops)
               -> global block prefix psG -> y[row] = psG[end(row)] -
               psG[end(prev row)] gathered by one stacked TLG pass.

Everything data-dependent is precomputed here as uint8 routing planes;
the kernels execute a fixed gather/matmul schedule. The two routing
steps are 127-color bipartite edge colorings (Koenig: Delta-colorable;
greedy + Kempe-chain completion below). Lane 127 of every slab and
every mid row is reserved zero so empty slots route to hard zeros.

The planner rejects (returns None) shapes outside the v1 envelope —
callers fall back to the hybrid/PELL paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu_torch import trace

BC = 128
CCAP = 127                  # colors per side; lane 127 reserved zero
BLK_CAP = BC * CCAP         # final slots per out-block (16256)
ROWS_PER_BLK = 64 * BC      # y staging (64, 128) per block
J1_MAX = 254                # mid-row index must fit uint8
HOPPER_J1_MAX = 1 << 16     # the port's cap: steps fit uint16, and mid
                            # (B2_MAX * 2^16 * 128 slots) stays under 2^31
B2_MAX = 248                # S1 out-route windows <= 2
MIR_TJ = 3                  # target S1 steps per mirror window: hot
                            # ranges get ceil(cnt / (120*MIR_TJ))
                            # replica sublanes (then L-balanced)
SPLIT_CAP = 112             # a (row, window) pair holding more than
                            # this splits into virtual rows (one
                            # (step, block) tile row caps at 127)
HEAVY = 56                  # (row, window) chunks at least this big
                            # are virtualized + round-robin-balanced
                            # across blocks (cell-skew control)
KEEP_MIN = 11000            # normal windows with fewer residual
                            # entries fold into the mirror stream
                            # (~0.7 of one step's 15748 capacity)
MIR_MAX = 512               # mirror windows cap
X_EXT_BUDGET = 64 << 20     # x_ext f32 cap. Since the round-4 step
                            # batching, x_ext sits WHOLE in VMEM as the
                            # (NWin, 128, 128) window table, so this is
                            # the de-facto VMEM residency bound for all
                            # three kernels (ops/xpose.py X_VMEM_CAP is
                            # derived from it), not just an HBM/build
                            # bound.


@dataclass
class XposePlan:
    m: int
    n: int
    nnz: int
    NR: int                 # x ranges (multiple of 128)
    NWm: int                # mirror windows (may be 0)
    msw: np.ndarray         # (max(NWm,1)*4,) int32 SOURCE windows per
                            # mirror window (up to 4; repeats pad) —
                            # built with one TLG per source + select
    mir_sel: np.ndarray     # (max(NWm,1), 128) u8 source slot (0..3)
                            # per mirror-window sublane
    mir_sub: np.ndarray     # (max(NWm,1), 128) u8 source range (mod
                            # 128) per mirror-window sublane
    m2: int                 # rows incl. virtual (split) rows
    v_row: np.ndarray       # (n_virt,) int32 original row per virtual
    J1: int                 # S1 steps (multiple of 8)
    B2: int                 # out-blocks
    K1p: int                # ceil(B2/8)*8 — prod tile-rows per step
    W1: int                 # ceil(B2/128) — S1 out TLG windows
    W3: int                 # ceil(J1/128) — S3 mid TLG windows
    win_of_step: np.ndarray  # (J1,) int32 window index into x_ext
    # S1 planes
    gidx: np.ndarray        # (J1*128, 128) u8  in-window x lane
    asv: np.ndarray         # (J1*128, 128) f32 A values at slab slots
    r2: np.ndarray          # (J1*W1*128, 128) u8  TLG: slab row per (t,c1)
    r3: np.ndarray          # (J1*W1*128, 128) u8  lane: c1 per (t, c2)
    # S3 planes
    sub: np.ndarray         # (B2*128, 128) u8  mid row per (f, c2)
                            # (u16 past 256 steps: step_dtype)
    r3b: np.ndarray         # (B2*128, 128) u8  c2 per (f, l)
    # y extraction: two 3-stage routed gathers over psG
    # (end pass minus prev pass; each: lane rpre, TLG ys, lane r3y
    #  with 255 = gather-nothing sentinel)
    rpre1: np.ndarray       # (B2*128, 128) u8
    ys1: np.ndarray         # (B2*128, 128) u8
    r3y1: np.ndarray        # (B2*128, 128) u8
    rpre2: np.ndarray       # (B2*128, 128) u8
    ys2: np.ndarray         # (B2*128, 128) u8
    r3y2: np.ndarray        # (B2*128, 128) u8

    @property
    def plan_bytes(self) -> int:
        return sum(a.nbytes for a in (
            self.gidx, self.asv, self.r2, self.r3, self.sub, self.r3b,
            self.rpre1, self.ys1, self.r3y1, self.rpre2, self.ys2,
            self.r3y2))


# ---------------------------------------------------------------------------
# Bipartite edge coloring: vectorized greedy + Kempe-chain completion
# ---------------------------------------------------------------------------

_U1 = np.uint64(1)
_U64ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _first_bit(p0, p1):
    """Index of the lowest set bit of the 128-bit words (p1:p0).
    Exact: an isolated bit is a power of two <= 2**63, which float64
    represents exactly."""
    l0 = p0 & (~p0 + _U1)
    l1 = p1 & (~p1 + _U1)
    i0 = np.log2(np.maximum(l0, _U1).astype(np.float64)).astype(np.int64)
    i1 = np.log2(np.maximum(l1, _U1).astype(np.float64)).astype(np.int64)
    return np.where(p0 != 0, i0, 64 + i1)


def _greedy_color(a, b, ncolors, rounds=96, seed=0):
    """Vectorized greedy edge coloring over 128-bit free-color
    bitmasks (two uint64 words per node — the boolean (todo, ncolors)
    gather arrays of the first version moved ~150MB per round on the
    amazon archetype: 47 s of a 57 s plan). Returns colors (-1 =
    stuck) plus boolean free masks for the Kempe completion."""
    if ncolors > 128:
        raise ValueError("ncolors > 128 unsupported")
    N = a.size
    na, nb = int(a.max()) + 1, int(b.max()) + 1
    full0 = _U64ONES if ncolors >= 64 else np.uint64((1 << ncolors) - 1)
    full1 = (np.uint64((1 << (ncolors - 64)) - 1) if ncolors > 64
             else np.uint64(0))
    fa0 = np.full(na, full0, np.uint64)
    fa1 = np.full(na, full1, np.uint64)
    fb0 = np.full(nb, full0, np.uint64)
    fb1 = np.full(nb, full1, np.uint64)
    color = np.full(N, -1, np.int64)
    rng = np.random.default_rng(seed)
    todo = np.arange(N)
    for _ in range(rounds):
        if not todo.size:
            break
        at, bt = a[todo], b[todo]
        m0 = fa0[at] & fb0[bt]
        m1 = fa1[at] & fb1[bt]
        has = (m0 | m1) != 0
        cand = todo[has]
        at, m0, m1 = at[has], m0[has], m1[has]
        bt = bt[has]
        # propose the first free color >= a random r (cyclic), so
        # proposals spread instead of clustering at color 0
        r = rng.integers(0, ncolors, cand.size).astype(np.uint64)
        s = r & np.uint64(63)
        big = r >= np.uint64(64)
        low = (_U1 << s) - _U1                        # bits < s
        h0 = np.where(big, np.uint64(0), m0 & ~low)
        h1 = np.where(big, m1 & ~low, m1)
        use = (h0 | h1) != 0
        p0 = np.where(use, h0, m0)
        p1 = np.where(use, h1, m1)
        prop = _first_bit(p0, p1)
        ka = at * ncolors + prop
        kb = bt * ncolors + prop
        _, ia = np.unique(ka, return_index=True)
        ok = np.zeros(cand.size, bool)
        ok[ia] = True
        _, ib = np.unique(kb, return_index=True)
        ok2 = np.zeros(cand.size, bool)
        ok2[ib] = True
        win = ok & ok2
        w, wc = cand[win], prop[win]
        color[w] = wc
        wl = win & (prop < 64)
        wh = win & ~wl
        for sel, faw, fbw in ((wl, fa0, fb0), (wh, fa1, fb1)):
            if sel.any():
                bit = ~(_U1 << (prop[sel].astype(np.uint64)
                                & np.uint64(63)))
                np.bitwise_and.at(faw, at[sel], bit)
                np.bitwise_and.at(fbw, bt[sel], bit)
        todo = np.flatnonzero(color < 0)
    # boolean views for the Kempe completion
    bits = np.arange(ncolors, dtype=np.uint64)
    b0, b1 = bits[bits < 64], bits[bits >= 64] - np.uint64(64)
    fa = np.concatenate(
        [(fa0[:, None] >> b0[None, :]) & _U1,
         (fa1[:, None] >> b1[None, :]) & _U1], axis=1).astype(bool)
    fb = np.concatenate(
        [(fb0[:, None] >> b0[None, :]) & _U1,
         (fb1[:, None] >> b1[None, :]) & _U1], axis=1).astype(bool)
    return color, fa, fb


def edge_color(a, b, ncolors, seed=0):
    """Exact bipartite edge coloring with ``ncolors`` >= max degree.

    Greedy rounds color ~98-99%; the rest completes with Kempe chains
    (Koenig's theorem construction): for a stuck edge (a0, b0) take a
    color ca free at a0 and cb free at b0; the (ca, cb)-alternating
    chain from b0 can never reach a0, so flipping it frees ca at b0.
    Raises ValueError if a degree exceeds ncolors.
    """
    color, fa, fb = _greedy_color(a, b, ncolors, seed=seed)
    stuck = np.flatnonzero(color < 0)
    if not stuck.size:
        return color
    na, nb = fa.shape[0], fb.shape[0]
    # adjacency: edge id per (node, color), -1 when free
    adj_a = np.full((na, ncolors), -1, np.int64)
    adj_b = np.full((nb, ncolors), -1, np.int64)
    done = color >= 0
    adj_a[a[done], color[done]] = np.flatnonzero(done)
    adj_b[b[done], color[done]] = np.flatnonzero(done)

    for e in stuck:
        a0, b0 = int(a[e]), int(b[e])
        ca_free = np.flatnonzero(fa[a0])
        cb_free = np.flatnonzero(fb[b0])
        if not ca_free.size or not cb_free.size:
            raise ValueError("degree exceeds color budget")
        ca = int(ca_free[0])
        if fb[b0, ca]:
            cb = ca
        else:
            cb = int(cb_free[0])
            # walk the (ca, cb) chain from b0 and flip it
            chain = []
            u, col, side = b0, ca, "b"
            while True:
                e1 = int(adj_b[u, col]) if side == "b" \
                    else int(adj_a[u, col])
                if e1 < 0:
                    break
                chain.append(e1)
                if side == "b":
                    u, side = int(a[e1]), "a"
                else:
                    u, side = int(b[e1]), "b"
                col = cb if col == ca else ca
            for e1 in chain:
                c_old = int(color[e1])
                c_new = cb if c_old == ca else ca
                color[e1] = c_new
                adj_a[a[e1], c_old] = -1
                adj_b[b[e1], c_old] = -1
            for e1 in chain:
                adj_a[a[e1], color[e1]] = e1
                adj_b[b[e1], color[e1]] = e1
            fa_rows = a[chain] if chain else []
            # recompute freeness lazily for touched nodes
            for u2 in set(int(v) for v in fa_rows):
                fa[u2, ca] = adj_a[u2, ca] < 0
                fa[u2, cb] = adj_a[u2, cb] < 0
            for e1 in chain:
                v2 = int(b[e1])
                fb[v2, ca] = adj_b[v2, ca] < 0
                fb[v2, cb] = adj_b[v2, cb] < 0
        color[e] = ca
        adj_a[a0, ca] = e
        adj_b[b0, ca] = e
        fa[a0, ca] = False
        fb[b0, ca] = False
    return color


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

def _pick_b2(row_len, m, nnz, peak_step_demand, heavy_tot=0):
    """Choose the out-block count for STRIDED blocks (block b = rows
    congruent b mod B2). Striding spreads any row-locality uniformly
    across blocks — the fix that admits banded matrices (contiguous
    blocks concentrated a diagonal band into single (window, block)
    cells and blew the step count).

    Each (step, block) pair emits one 128-lane tile row, so a step
    absorbs at most B2*127 entries; B2 must cover the peak per-step
    demand (max_w e_w / jw_e) or the block cap — not the slot count —
    sets J1 (amazon at the feasibility-minimum B2=66: J1=200 vs 104).
    Returns the smallest feasible B2 >= that target, or None."""
    lo = max(-(-m // ROWS_PER_BLK), -(-nnz // BLK_CAP), 1,
             min(-(-peak_step_demand // 120), BC + 8))
    b2 = lo
    while b2 <= B2_MAX:
        cnt = np.bincount(np.repeat(np.arange(m) % b2, row_len),
                          minlength=b2)
        if cnt.max() + -(-heavy_tot // b2) <= BLK_CAP:
            return b2
        # grow proportionally to the overflow
        b2 = max(b2 + 1, int(b2 * cnt.max() / BLK_CAP * 1.02))
    return None


REJECT_REASON = None        # set by plan_xpose on each None return
PLAN_DEBUG = {}             # step-term diagnostics from the last plan


def quick_envelope_ok(A) -> bool:
    """Cheap (O(m)) necessary-condition check of the v1 planning
    envelope, for ``pick_auto`` routing — a True here does NOT
    guarantee ``plan_xpose`` succeeds (concentrated (window, block)
    cells can still reject mid-plan; callers keep the hybrid/PELL
    fallback), but a False is definitive. Bounds mirror the planner's
    own constants so they cannot drift apart:

    * total entries must fit J1_MAX steps of CCAP*BC slots;
    * no row may exceed what SPLIT_CAP virtualization can absorb
      (one virtual row per (group, chunk): a 16k-entry row splits
      into ~143 virtual rows — past that B2 assignment degrades);
    * m2 rows must fit B2_MAX out-blocks of 64*BC staging rows.
    """
    if A.nnz == 0 or A.m == 0:
        return False
    if A.nnz > J1_MAX * CCAP * BC:          # ~4.1M entries
        return False
    max_row = int(np.diff(A.irp).max(initial=0))
    if max_row > 16_384:
        return False
    if A.m > B2_MAX * ROWS_PER_BLK:         # 248 * 8192 ~ 2.03M rows
        return False
    return True


def _reject(why):
    global REJECT_REASON
    REJECT_REASON = why
    return None


def step_dtype(J1: int):
    """The narrowest unsigned type of the ``sub`` plane that holds every
    step of a plan of ``J1`` (padded) steps: uint8 up to 256, else
    uint16 (up to ``HOPPER_J1_MAX``)."""
    if J1 <= 1 << 8:
        return np.uint8
    if J1 <= 1 << 16:
        return np.uint16
    raise ValueError(f"step_dtype: J1={J1} steps past 2^16")


def plan_xpose(A, seed: int = 0, j1_max: int | None = None):
    """Build an XposePlan for CSR ``A`` or return None if out of the
    v1 envelope (callers fall back to hybrid/PELL). ``j1_max`` caps the
    steps (None: ``J1_MAX``, the reference's; at most
    ``HOPPER_J1_MAX``)."""
    if j1_max is None:
        j1_max = J1_MAX
    if j1_max > HOPPER_J1_MAX:
        raise ValueError(f"plan_xpose: j1_max={j1_max} is past "
                         f"HOPPER_J1_MAX={HOPPER_J1_MAX}")
    m, n, nnz = A.m, A.n, A.nnz
    if nnz == 0 or m == 0:
        return _reject("empty")
    irp = A.irp.astype(np.int64)
    ec = A.ja.astype(np.int64)
    ev = A.as_.astype(np.float32)
    er = np.repeat(np.arange(m, dtype=np.int64), np.diff(irp))
    row_len = np.diff(irp)

    # x_ext layout: x padded to NR*128 and reshaped (NR, 128) — range
    # r = columns [r*128, (r+1)*128). Window w = ranges [w*128,
    # (w+1)*128) as sublanes (pure reshape, no device transpose).
    # Popular ranges (col clusters and single hub columns alike) are
    # REPLICATED across sublanes of extra mirror windows so their
    # per-(step, sublane) capacity scales with popularity — without
    # this, one 9.7k-entry range forces ~80 near-empty steps (measured
    # on the webbase archetype). Replica runs are sized per range
    # (ceil(cnt / (127*MIR_TJ)) sublanes), grouped by SOURCE window
    # and cut into 128-sublane mirror windows, so each mirror window
    # builds with one TLG from its source window and runs ~MIR_TJ
    # well-filled steps (the 32-sublane-quarter scheme needed a step
    # per window for webbase's 1.5k modestly-hot ranges: J1 ~ 470).
    NR = (-(-n // BC) + BC - 1) // BC * BC            # ranges, mult 128
    NW0 = NR // BC                                    # normal windows
    rng_of = ec // BC
    gid = (ec % BC).astype(np.int64)
    cnt_r = np.bincount(rng_of, minlength=NR)

    # a range is hot when it sticks out above what its window's total
    # entry count already requires in steps — mirroring it then buys
    # fill; an absolute threshold misfires on uniformly-dense windows
    # (amazon averages ~490/range: all ranges tripped a fixed cutoff)
    e_w0 = np.bincount(rng_of // BC, minlength=NR // BC)
    # a stripe holds ~120 entries/step, so anything above 120*jw
    # would FORCE extra steps on its whole window; mirror it instead.
    # Iterate to fixpoint: mirroring the hub mass out SHRINKS the
    # residual window load, lowering the bar for the next tier (the
    # webbase hub window starts at jw=23 -> thresh 2760, stranding
    # 1-2.8k ranges that then cost 24 stripe-bound steps).
    e_res = e_w0.astype(np.int64).copy()
    hot_mask = np.zeros(NR, bool)
    for _ in range(6):
        jw_res = np.maximum(-(-e_res // (CCAP * 124)), 1)
        th = 120 * jw_res[np.arange(NR) // BC]
        new_hot = ~hot_mask & (cnt_r > th)
        if not new_hot.any():
            break
        hot_mask |= new_hot
        e_res -= np.bincount(np.flatnonzero(new_hot) // BC,
                             weights=cnt_r[new_hot],
                             minlength=NR // BC).astype(np.int64)
    # under-full normal windows fold ENTIRELY into the mirror stream:
    # a window left with 5k entries still costs a full step at fill
    # 0.3, while mirrors pack globally at ~0.9 (webbase: 62 normal
    # windows held 522k entries in 69 steps before this)
    fold = (e_res > 0) & (e_res < KEEP_MIN)
    if fold.any():
        hot_mask |= fold[np.arange(NR) // BC] & (cnt_r > 0)
    hot = np.flatnonzero(hot_mask)                    # window-sorted
    # GLOBAL L-balance: smallest per-sublane load L whose replica
    # counts fit the minimal slot budget rounded up to whole windows
    # (per-source rounding wasted ~76 half-empty window-steps on
    # webbase). Mirror windows mix up to 4 source windows — built
    # with one TLG per source + sublane select.
    nsub = -(-cnt_r[hot] // (120 * MIR_TJ))           # minimal sublanes
    if hot.size:
        cnts = cnt_r[hot]
        slots = -(-int(nsub.sum()) // BC) * BC
        lo_l, hi_l = 1, 120 * MIR_TJ
        while lo_l < hi_l:                            # smallest feasible L
            mid = (lo_l + hi_l) // 2
            if int((-(-cnts // mid)).sum()) <= slots:
                hi_l = mid
            else:
                lo_l = mid + 1
        nsub = -(-cnts // lo_l)
    MSRC = 4
    sw_of_hot = hot // BC
    run0 = np.zeros(NR, np.int64)                     # run start/range
    sub_src = []                                      # source range/sub
    off = 0
    cur_sources: set = set()
    last_src = 0
    for w in np.unique(sw_of_hot):
        sel = sw_of_hot == w
        if (off % BC and int(w) not in cur_sources
                and len(cur_sources) >= MSRC):
            pad = (-off) % BC                         # close the window
            sub_src.append(np.full(pad, last_src * BC, np.int64))
            off += pad
            cur_sources = set()
        ns = nsub[sel]
        run0[hot[sel]] = off + np.r_[0, np.cumsum(ns)[:-1]]
        run = np.repeat(hot[sel], ns)
        start = off
        off += run.size
        sub_src.append(run)
        last_src = int(w)
        if off % BC == 0:
            cur_sources = set()
        elif off // BC > start // BC:
            cur_sources = {int(w)}
        else:
            cur_sources.add(int(w))
    if off % BC:
        pad = (-off) % BC
        sub_src.append(np.full(pad, last_src * BC, np.int64))
        off += pad
    sub_src = (np.concatenate(sub_src) if sub_src
               else np.zeros(0, np.int64))
    NWm = off // BC
    if NWm > MIR_MAX or (NR + NWm * BC) * BC * 4 > X_EXT_BUDGET:
        return _reject("mirror/x_ext budget")
    msw = np.zeros(max(NWm, 1) * MSRC, np.int32)
    mir_sel = np.zeros((max(NWm, 1), BC), np.uint8)
    mir_sub = np.zeros((max(NWm, 1), BC), np.uint8)
    if NWm:
        ssw = (sub_src // BC).reshape(NWm, BC)
        mir_sub[:NWm] = (sub_src % BC).reshape(NWm, BC).astype(np.uint8)
        for wme in range(NWm):
            srcs = np.unique(ssw[wme])
            if srcs.size > MSRC:
                return _reject("mirror sources > 4")
            msw[wme * MSRC:(wme + 1) * MSRC] = srcs[
                np.minimum(np.arange(MSRC), srcs.size - 1)]
            mir_sel[wme] = np.searchsorted(srcs, ssw[wme]).astype(
                np.uint8)
    hot_pos = np.full(NR, -1, np.int64)
    hot_pos[hot] = np.arange(hot.size)

    is_mir = hot_pos[rng_of] >= 0
    # mirrored entries: round-robin over the range's replica sublanes
    order_m = np.argsort(rng_of[is_mir], kind="stable")
    mi = np.flatnonzero(is_mir)[order_m]
    rm = rng_of[mi]
    first = np.r_[True, rm[1:] != rm[:-1]]
    sidx = np.flatnonzero(first)
    rank_m = np.arange(mi.size) - sidx[np.cumsum(first) - 1]
    gsub = run0[rm] + rank_m % nsub[hot_pos[rm]]      # global sublane
    stripe = np.empty(nnz, np.int64)
    wwin = np.empty(nnz, np.int64)
    stripe[mi] = gsub % BC
    wwin[mi] = NW0 + gsub // BC
    nm = ~is_mir
    stripe[nm] = rng_of[nm] % BC
    wwin[nm] = rng_of[nm] // BC

    # heavy (row, WINDOW) chunks become VIRTUAL rows, assigned to
    # out-blocks round-robin per window: a row's entries clustered in
    # one window overflow that (window, block) cell (one 128-lane
    # tile row per step is the hard cap; under blk = row % B2 this
    # skew made the blk-term dominate 115 webbase windows for 145
    # excess steps — webbase carries 33% of its mass in such chunks).
    # Virtual rows have their own y staging slot, so any row->block
    # map is legal; their sums scatter-add back at the end.
    NWt = NW0 + NWm
    key_rw = er * NWt + wwin
    order_rw = np.argsort(key_rw, kind="stable")
    krs = key_rw[order_rw]
    first_rw = np.r_[True, krs[1:] != krs[:-1]]
    sidx_rw = np.flatnonzero(first_rw)
    gi = np.empty(nnz, np.int64)                     # group id/entry
    gi[order_rw] = np.cumsum(first_rw) - 1
    rank_rw = np.empty(nnz, np.int64)
    rank_rw[order_rw] = np.arange(nnz) - sidx_rw[np.cumsum(first_rw) - 1]
    g_mass = np.bincount(gi)
    chunk = rank_rw // SPLIT_CAP
    virt = (chunk > 0) | (g_mass[gi] >= HEAVY)

    # out-block count: light rows stride (row % B2); heavy mass is
    # spread near-perfectly by the round-robin below
    e_w_all = np.bincount(wwin, minlength=NWt)
    jw_all = np.maximum(-(-e_w_all // (CCAP * 124)), 1)
    peak = int((-(-e_w_all // jw_all)).max())
    light_len = np.bincount(er[~virt], minlength=m)
    heavy_tot = int(virt.sum())
    B2 = _pick_b2(light_len, m, nnz, peak, heavy_tot)
    if B2 is None:
        return _reject("B2 infeasible")

    for _ in range(6):
        if virt.any():
            # one virtual row per (group, chunk)
            mult = int(chunk.max()) + 1
            vkey = key_rw[virt] * mult + chunk[virt]
            uv, inv = np.unique(vkey, return_inverse=True)
            V = uv.size
            v_win = (uv // mult % NWt).astype(np.int64)
            v_real = (uv // mult // NWt).astype(np.int64)
            v_mass = np.bincount(inv, minlength=V)
            # one GLOBAL round-robin over blocks, windows in order and
            # biggest chunks first within each: consecutive chunks of
            # one window spread across blocks (cell balance) AND the
            # global sequence balances per-block totals (a per-window
            # restart piled 1.9x the estimate into one webbase block,
            # overflowing BLK_CAP)
            order_v = np.lexsort((-v_mass, v_win))
            vblk = np.empty(V, np.int64)
            vblk[order_v] = np.arange(V) % B2
            # virtual row ids live above m, strided-consistent with
            # their block: id = first id >= m congruent to blk
            # (mod B2), then one stride per assigned chunk
            order_b2 = np.argsort(vblk, kind="stable")
            vb = vblk[order_b2]
            fb = np.r_[True, vb[1:] != vb[:-1]]
            sb2 = np.flatnonzero(fb)
            rib = np.arange(V) - sb2[np.cumsum(fb) - 1]
            vid = np.empty(V, np.int64)
            vid[order_b2] = m + (vb - m) % B2 + rib * B2
            m2 = int(vid.max()) + 1
            v_row = np.zeros(m2 - m, np.int32)       # 0 adds 0.0 for
            v_row[vid - m] = v_real                  # unused slots
            er2 = er.copy()
            er2[virt] = vid[inv]
        else:
            er2, v_row, m2 = er, np.zeros(0, np.int32), m
        blk = (er2 % B2).astype(np.int64)
        tot_b = np.bincount(blk, minlength=B2)
        if (tot_b.max() <= BLK_CAP
                and -(-m2 // B2) <= ROWS_PER_BLK):
            break
        grow = max(tot_b.max() / BLK_CAP,
                   -(-m2 // B2) / ROWS_PER_BLK)
        B2 = int(B2 * grow * 1.02) + 1
        if B2 > B2_MAX:
            return _reject("B2 infeasible (post-assign)")
    else:
        return _reject("B2 infeasible (post-assign)")

    # strided out-blocks (block = row mod B2) + dense block-local
    # row-major final slots (lane 127 skipped), entries ordered by
    # (block, block-local row ri, original position).
    ri2 = er2 // B2
    order_b = np.lexsort((np.arange(nnz), ri2, blk))
    fslot = np.empty(nnz, np.int64)
    bsorted = blk[order_b]
    start = np.r_[True, bsorted[1:] != bsorted[:-1]]
    sidx = np.flatnonzero(start)
    fslot[order_b] = (np.arange(nnz)
                      - sidx[np.cumsum(start) - 1])
    f = fslot // CCAP
    l_fin = fslot % CCAP

    # ---- S1 step assignment ------------------------------------------
    NW = NW0 + NWm
    e_w = np.bincount(wwin, minlength=NW)
    cnt_ws = np.bincount(wwin * BC + stripe,
                         minlength=NW * BC).reshape(NW, BC)
    cnt_wb = np.bincount(wwin * B2 + blk,
                         minlength=NW * B2).reshape(NW, B2)
    t_e = -(-e_w // (CCAP * 124))
    t_s = -(-cnt_ws.max(axis=1) // 120)
    t_b = -(-cnt_wb.max(axis=1) // 120)
    j_of_w = np.maximum.reduce([t_e, t_s, t_b,
                                (e_w > 0).astype(np.int64)])
    PLAN_DEBUG.update(t_e=t_e, t_s=t_s, t_b=t_b, e_w=e_w, B2=B2,
                      NW0=NW0, NWm=NWm, cnt_ws=cnt_ws, cnt_wb=cnt_wb)
    # rank within (window, stripe) -> round-robin over the window's
    # steps balances both the stripe and (statistically) the block cap
    key = wwin * BC + stripe
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    sidx = np.flatnonzero(first)
    ro = np.empty(nnz, np.int64)
    ro[order] = np.arange(nnz) - sidx[np.cumsum(first) - 1]
    step_of = ro % np.maximum(j_of_w[wwin], 1)
    base_w = np.r_[0, np.cumsum(j_of_w)]
    step_of += base_w[wwin]
    J1 = int(base_w[-1])
    if J1 > j1_max:
        return _reject(f"J1={J1}>{j1_max}")

    # repair per-(step, block) overflow (> CCAP) by moving entries to
    # sibling steps of the same window with slack in both dims
    for _ in range(3):
        sb = step_of * B2 + blk
        cnt_sb = np.bincount(sb, minlength=J1 * B2)
        cnt_ss = np.bincount(step_of * BC + stripe, minlength=J1 * BC)
        over = np.flatnonzero(cnt_sb > CCAP)
        if not over.size:
            break
        for cell in over:
            s0, b0 = divmod(int(cell), B2)
            w = int(wwin[np.flatnonzero(sb == cell)[0]])
            members = np.flatnonzero(sb == cell)
            excess = members[CCAP:]
            sibs = [s for s in range(int(base_w[w]),
                                     int(base_w[w] + j_of_w[w]))
                    if s != s0]
            for e in excess:
                moved = False
                for s in sibs:
                    if (cnt_sb[s * B2 + b0] < CCAP and
                            cnt_ss[s * BC + stripe[e]] < CCAP):
                        cnt_sb[s * B2 + b0] += 1
                        cnt_ss[s * BC + stripe[e]] += 1
                        cnt_sb[cell] -= 1
                        cnt_ss[s0 * BC + stripe[e]] -= 1
                        step_of[e] = s
                        sb[e] = s * B2 + b0
                        moved = True
                        break
                if not moved:
                    return _reject("repair stuck")
    else:
        sb = step_of * B2 + blk
        if np.bincount(sb, minlength=J1 * B2).max() > CCAP:
            return _reject("(step,blk) overflow")
    if np.bincount(step_of * BC + stripe,
                   minlength=J1 * BC).max() > CCAP:
        return _reject("(step,stripe) overflow")

    # ---- the two edge colorings --------------------------------------
    trace.stage("colorings")
    c1 = edge_color(step_of * BC + stripe, step_of * B2 + blk, CCAP,
                    seed=seed)
    c2 = edge_color(blk * (J1 + 8) + step_of, blk * BC + f, CCAP,
                    seed=seed + 1)

    # ---- emit planes ---------------------------------------------------
    J1p = -(-J1 // 8) * 8
    K1p = -(-B2 // 8) * 8
    W1 = -(-B2 // BC)
    W3 = -(-J1p // BC)

    trace.stage("s1_planes")
    gidx = np.zeros((J1p * BC, BC), np.uint8)
    asv = np.zeros((J1p * BC, BC), np.float32)
    rs = step_of * BC + stripe
    gidx[rs, c1] = gid.astype(np.uint8)
    asv[rs, c1] = ev

    r2 = np.zeros((J1p * W1 * BC, BC), np.uint8)
    r3 = np.full((J1p * W1 * BC, BC), CCAP, np.uint8)
    w1 = blk // BC
    t_loc = blk % BC
    rt = (step_of * W1 + w1) * BC + t_loc
    r2[rt, c1] = stripe.astype(np.uint8)
    r3[rt, c2] = c1.astype(np.uint8)

    sdt = step_dtype(J1p)
    trace.stage("s3_index", J1=J1p, bits=8 * np.dtype(sdt).itemsize)
    sub = np.zeros((B2 * BC, BC), sdt)
    r3b = np.full((B2 * BC, BC), CCAP, np.uint8)
    rf = blk * BC + f
    sub[rf, c2] = step_of.astype(sdt)
    r3b[rf, l_fin] = c2.astype(np.uint8)

    # ---- y extraction planes -------------------------------------------
    trace.stage("y_routes")
    # y[r] = psG[end(r)] - psG[end(prev non-empty r in block)]; empty
    # rows gather nothing on either pass (0 - 0). Each pass is a
    # 3-stage routed gather over psG:
    #   h[f, c] = psG[f, rpre[f, c]]       (lane: value -> its color)
    #   t[q, c] = h[ys[q, c], c]           (TLG: tile-row -> staging q)
    #   st[q, lq] = t[q, r3y[q, lq]]       (lane: color -> staging lane)
    # Colors come from a per-pass bipartite edge coloring (value
    # tile-row x staging row, 128 colors; Delta_src <= 127 ends per
    # tile-row, Delta_dst <= 128 lanes per staging row).
    e_sorted = er2[order_b]
    is_last = np.r_[e_sorted[1:] != e_sorted[:-1], True]
    last_pos = order_b[is_last]            # last entry per row2,
    rows2 = e_sorted[is_last]              # in (block, ri) order
    f_end = f[last_pos]
    l_end = l_fin[last_pos]
    rb = rows2 % B2
    ri = rows2 // B2
    q, lq = ri // BC, ri % BC
    same_blk = np.r_[False, rb[1:] == rb[:-1]]
    pi = np.flatnonzero(same_blk)          # rows with an in-block prev

    def _route_pass(val_f, val_l, dst_q, dst_lq, dst_blk, seed2):
        rpre = np.zeros((B2 * BC, BC), np.uint8)
        ys = np.zeros((B2 * BC, BC), np.uint8)
        r3y = np.full((B2 * BC, BC), 255, np.uint8)
        if val_f.size == 0:
            return rpre, ys, r3y
        c = edge_color(dst_blk * BC + val_f, dst_blk * 64 + dst_q, BC,
                       seed=seed2)
        rpre[dst_blk * BC + val_f, c] = val_l.astype(np.uint8)
        ys[dst_blk * BC + dst_q, c] = val_f.astype(np.uint8)
        r3y[dst_blk * BC + dst_q, dst_lq] = c.astype(np.uint8)
        return rpre, ys, r3y

    rpre1, ys1, r3y1 = _route_pass(f_end, l_end, q, lq, rb, seed + 2)
    rpre2, ys2, r3y2 = _route_pass(
        f_end[pi - 1], l_end[pi - 1], q[pi], lq[pi], rb[pi], seed + 3)

    win_of_step = np.zeros(J1p, np.int32)
    for w in range(NW):
        win_of_step[base_w[w]:base_w[w] + j_of_w[w]] = w

    return XposePlan(
        m=m, n=n, nnz=nnz, NR=NR, NWm=NWm, msw=msw, mir_sel=mir_sel,
        mir_sub=mir_sub, m2=m2, v_row=v_row,
        J1=J1p, B2=B2, K1p=K1p, W1=W1, W3=W3,
        win_of_step=win_of_step, gidx=gidx, asv=asv, r2=r2, r3=r3,
        sub=sub, r3b=r3b, rpre1=rpre1, ys1=ys1, r3y1=r3y1,
        rpre2=rpre2, ys2=ys2, r3y2=r3y2)


# ---------------------------------------------------------------------------
# NumPy executor (the plan's semantics, used by tests and as the spec
# for the Pallas kernels)
# ---------------------------------------------------------------------------

def simulate_xpose(plan: XposePlan, x: np.ndarray) -> np.ndarray:
    p = plan
    xp = np.zeros(p.NR * BC, np.float64)
    xp[:p.n] = x
    xr = xp.reshape(p.NR, BC)
    parts = [xr]
    for w in range(p.NWm):
        sw = p.msw[w * 4 + p.mir_sel[w].astype(np.int64)]
        parts.append(xr[sw * BC + p.mir_sub[w].astype(np.int64)])
    x_ext = np.concatenate(parts, axis=0)

    prod = np.zeros((p.J1, p.K1p, BC), np.float64)
    for s in range(p.J1):
        w0 = int(p.win_of_step[s]) * BC
        xw = x_ext[w0:w0 + BC, :]
        g = np.take_along_axis(
            xw, p.gidx[s * BC:(s + 1) * BC].astype(np.int64), axis=1)
        slab = g * p.asv[s * BC:(s + 1) * BC].astype(np.float64)
        slab[:, CCAP] = 0.0
        for w1 in range(p.W1):
            r2w = p.r2[(s * p.W1 + w1) * BC:(s * p.W1 + w1 + 1) * BC]
            r3w = p.r3[(s * p.W1 + w1) * BC:(s * p.W1 + w1 + 1) * BC]
            t2 = np.take_along_axis(slab, r2w.astype(np.int64), axis=0)
            out = np.take_along_axis(t2, r3w.astype(np.int64), axis=1)
            hi = min(p.K1p, (w1 + 1) * BC)
            prod[s, w1 * BC:hi] = out[:hi - w1 * BC]

    mid = np.swapaxes(prod, 0, 1)                     # (K1p, J1, 128)
    y = np.zeros(p.m2, np.float64)
    for b in range(p.B2):
        v = mid[b]                                    # (J1, 128)
        s32 = p.sub[b * BC:(b + 1) * BC].astype(np.int64)
        t2 = np.take_along_axis(v, s32, axis=0)
        fin = np.take_along_axis(
            t2, p.r3b[b * BC:(b + 1) * BC].astype(np.int64), axis=1)
        psum = np.cumsum(fin, axis=1)
        carry = psum[:, CCAP]
        cpre = np.r_[0.0, np.cumsum(carry)[:-1]]
        psg = psum + cpre[:, None]

        def _pass(rpre, ys, r3y):
            h = np.take_along_axis(
                psg, rpre[b * BC:(b + 1) * BC].astype(np.int64), axis=1)
            t = np.take_along_axis(
                h, ys[b * BC:(b + 1) * BC].astype(np.int64), axis=0)
            r3 = r3y[b * BC:(b + 1) * BC].astype(np.int64)
            g = np.take_along_axis(t, np.minimum(r3, BC - 1), axis=1)
            return np.where(r3 < BC, g, 0.0)

        e_st = _pass(p.rpre1, p.ys1, p.r3y1)
        p_st = _pass(p.rpre2, p.ys2, p.r3y2)
        stage = (e_st[:64] - p_st[:64]).reshape(-1)
        rows = b + np.arange(stage.size) * p.B2
        keep = rows < p.m2
        y[rows[keep]] = stage[keep]
    yr = y[:p.m].copy()
    np.add.at(yr, p.v_row, y[p.m:])
    return yr

"""The port's chips tail, single-plan route
(spmv_scpa_tpu_torch/ops/chips_tail.py and ops/segsum_kernel.py),
against the JAX package's: the planner's arrays exactly, the landing the
meta records (``merge_kind``) as the reference's ``make_landing``
chooses it; the per-row sums and the windowed segment-sum against the
Pallas pipeline run in interpret mode.

Tolerances: plans and the landing's kind, exact. The segment-sum and the
per-row sums: rel-L2 <= 1e-6, because ``make_window_segsum`` reduces
with a one-hot matmul on b split into three bf16 terms (24 bits of b,
f32-grade, summed in another order) while the port adds the f32
partials in quantum order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops.segsum_kernel import make_window_segsum

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import chips_tail as ct
from spmv_scpa_tpu_torch.ops import lane_ell, segsum_kernel

REL_L2 = 1e-6
PLAN_FIELDS = ("n_e", "H", "n_groups", "R", "n1p_blocks", "base", "p1", "l1",
               "E8", "p2", "l2", "vals", "rbl", "win_of_step", "num_windows",
               "h", "rows_per_step", "heavy_ids", "NH")


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-300))


def _random_tail(seed, m=90_000, n=60_000, n_rows=700, max_len=60):
    """CSR-ordered tail entries: rows of 1..max_len entries, columns
    clustered near the diagonal with some scattered."""
    rng = np.random.default_rng(seed)
    hr = np.sort(rng.choice(m, n_rows, replace=False))
    lens = rng.integers(1, max_len, n_rows)
    rows = np.repeat(hr, lens).astype(np.int64)
    near = (rows * n // m + rng.integers(-2000, 2000, rows.size)) % n
    far = rng.integers(0, n, rows.size)
    cols = np.where(rng.random(rows.size) < 0.8, near, far)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], rng.standard_normal(rows.size), m, n


def _amazon60k_tail():
    make, kw = cases.SMALL_CASES["amazon60k"]
    A = make()
    plan = lane_ell.pack_lane_ell(A, **kw)
    return plan.trows, plan.tcols, plan.tvals, A.m, A.n


TAILS = {"random0": lambda: _random_tail(0),
         "random1": lambda: _random_tail(1, n_rows=3000, max_len=12),
         "amazon60k": _amazon60k_tail}


@pytest.fixture(scope="module", params=sorted(TAILS))
def tail(request):
    return request.param, TAILS[request.param]()


def test_plan_chips_matches_jax(tail):
    _, (rows, cols, vals, m, n) = tail
    mine = ct.plan_chips(rows, cols, vals, m, n)
    want = jax_ct.plan_chips(rows, cols, vals, m, n)
    assert isinstance(want, jax_ct.ChipsPlan)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(want, f),
                                      err_msg=f)


def test_per_row_sums_match_jax(tail):
    """The slot products and the one segment-sum (``bind_sums``) against
    the reference's gathers and segment-sum."""
    _, (rows, cols, vals, m, n) = tail
    plan = ct.plan_chips(rows, cols, vals, m, n)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    sums, (r0,), _ = ct.bind_sums([plan], n, torch.device("cpu"))
    raw, args, _ = jax_ct.prepare_chips(jax_ct.plan_chips(
        rows, cols, vals, m, n), n, jnp.float32, True)
    ys_jax, hid = raw(jnp.asarray(x), *args)
    ys = sums(torch.as_tensor(x), lane_ell.KERNELS).numpy()
    assert r0 == 0 and ys.shape == (plan.NH,)
    np.testing.assert_array_equal(np.asarray(hid), plan.heavy_ids)
    assert _rel_l2(ys, np.asarray(ys_jax)) <= REL_L2
    want = np.zeros(m)
    np.add.at(want, rows, vals * x[cols].astype(np.float64))
    assert _rel_l2(ys, want[plan.heavy_ids]) <= REL_L2


def test_split_plan_raises_not_implemented():
    """Heavy rows of scattered columns exceed the single plan's budgets:
    the port plans the split the reference plans (its streams equal), and
    no plan for no entries."""
    rng = np.random.default_rng(12)
    m = n = 150_000
    rows = np.repeat(np.sort(rng.choice(m, 16, replace=False)), 8000)
    cols = rng.integers(0, n, rows.size)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order].astype(np.int64), cols[order].astype(np.int64)
    vals = rng.standard_normal(rows.size)
    want = jax_ct.plan_chips(rows, cols, vals, m, n)
    got = ct.plan_chips(rows, cols, vals, m, n)
    assert isinstance(want, jax_ct.SplitChipsPlan)
    assert isinstance(got, ct.SplitChipsPlan)
    np.testing.assert_array_equal(got.heavy_ids, want.heavy_ids)
    assert [s.kind for s in got.streams] == [s.kind for s in want.streams]
    for s, t in zip(want.streams, got.streams):
        for f in ("p2", "l2", "vals", "rbl", "win_of_step"):
            np.testing.assert_array_equal(getattr(s, f), getattr(t, f))
    assert ct.plan_chips(rows[:0], cols[:0], vals[:0], m, n) is None


def test_constants_match_jax():
    for c in ("H_CAP", "VPU_BUDGET", "R_PANELS", "H_WIN_CAP", "W_LOC",
              "SPLIT_VPU_BUDGET", "R_HOT"):
        assert getattr(ct, c) == getattr(jax_ct, c), c


# ---- the landing the meta records ---------------------------------------------

def _ids(rng, m, k, ascending):
    ids = rng.choice(m, k, replace=False)
    return np.sort(ids) if ascending else rng.permutation(ids)


# name -> (m, heavy ids, merge budget, the kind)
MERGE_CASES = {
    # ascending heavy ids: the windowed merge
    "windowed": (50_000, lambda rng, m: _ids(rng, m, 900, True), 6e8,
                 "windowed"),
    # ids ordered by row length, as the chips plan orders them: the
    # windowed tables refuse them, the ranked merge
    "ranked": (50_000, lambda rng, m: _ids(rng, m, 900, False), 6e8,
               "ranked"),
    # the ranked tables over budget: index_add_ on the unique rows
    "scatter": (50_000, lambda rng, m: _ids(rng, m, 900, False), 0.0,
                "scatter"),
    # unsorted ids past the resident cap (H_CAP rows of padded sums)
    "unsorted-past-the-cap": (400_000,
                              lambda rng, m: _ids(rng, m, 140_000, False),
                              6e8, "scatter"),
    # ascending ids past the windowed cap (H_WIN_CAP rows)
    "ascending-past-the-cap": (2_300_000,
                               lambda rng, m: np.arange(2_100_000),
                               6e8, "scatter"),
    # no heavy row
    "empty": (1000, lambda rng, m: np.zeros(0, np.int64), 6e8, "windowed"),
}


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_panel_merge_record_matches_the_reference(name):
    """``merge_kind`` (no tables built) against the reference's tables:
    the windowed merge where ``merge_tables_windowed`` builds them, else
    the ranked one where ``merge_tables`` does, else the scatter; and, on
    ``windowed=False`` (the row-sharded reference), the ranked tables
    alone. ``panel_merge`` is what ``make_landing`` reports."""
    m, make_ids, budget, kind = MERGE_CASES[name]
    G_pad = -(-m // BC)
    hid = make_ids(np.random.default_rng(len(name)), m).astype(np.int64)
    tw = jax_ct.merge_tables_windowed(hid, m, G_pad)
    tr = jax_ct.merge_tables(hid, m, G_pad, budget)
    want = ("windowed" if tw is not None else
            "ranked" if tr is not None else "scatter")
    assert ct.merge_kind(hid, m, G_pad, budget) == want == kind
    assert (ct.merge_kind(hid, m, G_pad, budget, windowed=False)
            == ("ranked" if tr is not None else "scatter"))
    if hid.size <= 1000:
        _, _, use_merge, _ = jax_ct.make_landing(hid, m, G_pad, jnp.float32,
                                                 True, budget)
        assert use_merge == (kind != "scatter")
    with pytest.raises(ValueError, match="heavy_ids"):
        ct.merge_kind(np.append(hid, m), m, G_pad, budget)


# ---- the windowed segment-sum --------------------------------------------------

SEGSUM_CASES = {
    # the chips tail's shape: one window of h = 256, 8 rows a step
    "chips": dict(h=256, rows_per_step=8, win=[0] * 12, num_windows=1),
    # three windows, the middle one unvisited, 16 rows a step
    "unvisited": dict(h=64, rows_per_step=16, win=[0, 0, 2, 2, 2],
                      num_windows=3),
    # steps of one window spread, windows out of order
    "unsorted-win": dict(h=32, rows_per_step=8, win=[1, 0, 1, 0],
                         num_windows=2),
}


@pytest.mark.parametrize("name", sorted(SEGSUM_CASES))
def test_window_segsum_matches_pallas(name):
    c = SEGSUM_CASES[name]
    h, rps, nw = c["h"], c["rows_per_step"], c["num_windows"]
    win = np.asarray(c["win"], np.int64)
    steps = win.size
    g = rps // 8 * BC
    rng = np.random.default_rng(steps)
    part = rng.standard_normal((steps * rps, BC)).astype(np.float32)
    rbl = rng.integers(0, h + 1, steps * g).astype(np.int32)  # h = padding
    rbl[::5] = h
    tables = segsum_kernel.window_tables(rbl, win, nw, h, "cpu")
    y = segsum_kernel.window_segsum(
        torch.as_tensor(part), torch.as_tensor(rbl),
        torch.as_tensor(win.astype(np.int32)), nw, h, rps, tables).numpy()
    # the sums by hand, in float64
    want = np.zeros((nw * h, 8))
    q = np.arange(steps * g)
    s, t, j = q // g, (q % g) // BC, q % BC
    ok = rbl < h
    for r in range(8):
        np.add.at(want[:, r], (win[s] * h + rbl)[ok],
                  part[s * rps + t * 8 + r, j][ok])
    assert _rel_l2(y, want) <= REL_L2
    visited = np.zeros(nw * h, bool)
    for w in np.unique(win):
        visited[w * h:(w + 1) * h] = True
    assert (y[~visited] == 0).all()
    if np.all(np.diff(win) >= 0):      # the Pallas kernel's contract
        fn, (win_d,) = make_window_segsum(
            win_of_step=win, num_windows=nw, h=h, rows_per_step=rps, nq=BC,
            total_tile_rows=steps * rps, interpret=True)
        yj = np.asarray(fn(jnp.asarray(part), jnp.asarray(rbl), win_d))
        assert _rel_l2(y[visited], yj[visited]) <= REL_L2


def test_window_segsum_rejects_bad_arguments():
    part = torch.zeros(16, BC)
    rbl = torch.zeros(2 * BC, dtype=torch.int32)
    win = torch.zeros(2, dtype=torch.int32)
    tables = segsum_kernel.window_tables(rbl, win, 1, 8, "cpu")
    segsum_kernel.window_segsum(part, rbl, win, 1, 8, 8, tables)
    with pytest.raises(ValueError, match="rows_per_step"):
        segsum_kernel.window_segsum(part, rbl, win, 1, 8, 12, tables)
    with pytest.raises(ValueError, match="rbl"):
        segsum_kernel.window_segsum(part, rbl[:-1], win, 1, 8, 8, tables)
    with pytest.raises(ValueError, match="partials"):
        segsum_kernel.window_segsum(part.double(), rbl, win, 1, 8, 8, tables)
    with pytest.raises(ValueError, match="chunk"):
        segsum_kernel.window_segsum(part, rbl, win, 1, 8, 8,
                                    tables._replace(chunk=tables.chunk[:-1]))
    with pytest.raises(ValueError, match="do not fit"):
        segsum_kernel.window_segsum(part, rbl, win, 2, 8, 8, tables)
    before = segsum_kernel.KERNEL_LAUNCHES
    segsum_kernel.window_segsum(part, rbl, win, 1, 8, 8, tables)
    assert segsum_kernel.KERNEL_LAUNCHES == before      # CPU: plain

"""The port's chips tail, single-plan route
(spmv_scpa_tpu_torch/ops/chips_tail.py and ops/segsum_kernel.py),
against the JAX package's: the planner's arrays and the landing's merge
tables exactly; the landing, the per-row sums and the windowed
segment-sum against the Pallas pipeline run in interpret mode.

Tolerances: tables and plans, exact. The landing adds gathered sums
(exact moves) to y in f32 as JAX does: exact. The segment-sum and the
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
    _, (rows, cols, vals, m, n) = tail
    plan = ct.plan_chips(rows, cols, vals, m, n)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    # the reference's pipeline (its bytes): the two gather stages
    contrib, hbm = ct.prepare_chips(plan, n, torch.device("cpu"), "hot")
    raw, args, jhbm = jax_ct.prepare_chips(jax_ct.plan_chips(
        rows, cols, vals, m, n), n, jnp.float32, True)
    ys_jax, hid = raw(jnp.asarray(x), *args)
    ys = contrib(torch.as_tensor(x), lane_ell.KERNELS).numpy()
    assert hbm == jhbm
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
              "MERGE_R_H", "SPLIT_VPU_BUDGET", "R_HOT"):
        assert getattr(ct, c) == getattr(jax_ct, c), c


# ---- the landing -------------------------------------------------------------

LANDINGS = {
    # ascending heavy ids: the windowed merge
    "windowed": (lambda rng, m: np.sort(rng.choice(m, 900, replace=False)),
                 6e8),
    # ids ordered by row length, as the chips plan orders them: ranked
    "ranked": (lambda rng, m: rng.permutation(
        rng.choice(m, 900, replace=False)), 6e8),
    # the ranked tables over budget: index_add_ on the unique rows
    "scatter": (lambda rng, m: rng.permutation(
        rng.choice(m, 900, replace=False)), 0.0),
}


@pytest.mark.parametrize("kind", sorted(LANDINGS))
def test_landing_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    m = 50_000
    G_pad = -(-m // BC)
    make_ids, budget = LANDINGS[kind]
    hid = make_ids(rng, m).astype(np.int64)
    tables = ct.landing_tables(hid, m, G_pad, budget)
    assert tables[0] == kind
    tw = jax_ct.merge_tables_windowed(hid, m, G_pad)
    tr = jax_ct.merge_tables(hid, m, G_pad, budget)
    want_tabs = tw if kind == "windowed" else tr
    for got, exp in zip(tables[1] or (), want_tabs or ()):
        np.testing.assert_array_equal(got, exp)
    assert (ct.merge_tables_windowed(hid, m, G_pad) is None) == (tw is None)
    assert (ct.merge_tables(hid, m, G_pad, budget) is None) == (tr is None)

    y = rng.standard_normal(m).astype(np.float32)
    ys = rng.standard_normal(hid.size).astype(np.float32)
    land, use_merge, extra = ct.make_landing(hid, m, G_pad,
                                             torch.device("cpu"), budget)
    jland, margs, jmerge, jextra = jax_ct.make_landing(
        hid, m, G_pad, jnp.float32, True, budget)
    assert (use_merge, extra) == (jmerge, jextra)
    got = land(torch.as_tensor(y.copy()), torch.as_tensor(ys),
               lane_ell.KERNELS).numpy()
    want = np.asarray(jland(jnp.asarray(y), jnp.asarray(ys),
                            jnp.asarray(hid, jnp.int32), *margs))
    np.testing.assert_array_equal(got, want)
    expect = y.astype(np.float64)
    expect[hid] += ys
    np.testing.assert_allclose(got, expect, rtol=1e-6)


def test_merge_tables_refuse_bad_heavy_ids():
    with pytest.raises(ValueError, match="heavy_ids"):
        ct.merge_tables(np.array([5, 300]), 200, 2)
    with pytest.raises(ValueError, match="heavy_ids"):
        ct.merge_tables_windowed(np.array([5, 300]), 200, 2)


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

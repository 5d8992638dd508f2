"""The chips tail's split plan and its shard padding
(spmv_scpa_tpu_torch/ops/chips_tail.py: ``plan_chips_split``,
``split_shape_template``, ``pad_split_plan``, ``pad_resident_plan``), the
split plan's device pipeline, ``cuda-chips`` and the hybrid's split
tails, against the JAX package's.

Cases: the split-plan cases of tests/test_round3_mechanisms.py:126-250
and tests/test_lane_ell.py:214-257, the shard-padding cases of
tests/test_chips_tail.py, the ``pallas-chips`` matrices of
tests/test_lane_ell.py, and ``bench/cases.py``'s ``heavy_scatter``
(a 128,000-entry tail past the single plan's budgets) through
``cuda-hybrid``.

Tolerances: plans, padded plans and host arguments, exact. Per-row sums
and y (the port's plain versions) against the JAX package's (Pallas in
interpret mode): rel-L2 <= 1e-6, because ``make_window_segsum`` reduces
with a one-hot matmul on b split into three bf16 terms (24 bits of b,
f32-grade, another order) while the port adds the f32 partials in
quantum order. Per-row sums against the fp64 sums of the same f32
values and x: rel-L2 <= 1e-5, the f32 rounding of sums of up to 900
terms (the mega-row). y against ``spmv_oracle``: ``validate_result``
defaults.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.parallel.distributed import \
    _plan_sharded_chips as jax_plan_sharded

from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import chips_tail as ct
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import get_strategy
from spmv_scpa_tpu_torch.parallel.distributed import _plan_sharded_chips
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

REL_L2 = 1e-6
EXACT_REL_L2 = 1e-5
STREAM_FIELDS = ("kind", "base1", "p1", "l1", "n1p_blocks", "r1", "H", "E8",
                 "p2", "l2", "vals", "rbl", "win_of_step", "base8", "H_pad",
                 "r_hot", "n_entries")
SPLIT_FIELDS = ("n_e", "h", "rows_per_step", "num_windows", "heavy_ids",
                "NH", "pop_k")
CHIPS_FIELDS = ("n_e", "H", "n_groups", "R", "n1p_blocks", "base", "p1",
                "l1", "E8", "p2", "l2", "vals", "rbl", "win_of_step",
                "num_windows", "h", "rows_per_step", "heavy_ids", "NH")


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _same(want, got, fields, what):
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")
        else:
            assert a == b, (what, f, a, b)


def assert_same_plan(want, got):
    """A split plan (or a single plan) equal to the reference's, field by
    field and stream by stream."""
    if isinstance(want, jax_ct.ChipsPlan):
        assert isinstance(got, ct.ChipsPlan)
        _same(want, got, CHIPS_FIELDS, "plan")
        return
    assert isinstance(got, ct.SplitChipsPlan)
    _same(want, got, SPLIT_FIELDS, "plan")
    for k in ("loc", "far", "cold"):
        s, t = getattr(want, k), getattr(got, k)
        assert (s is None) == (t is None), k
        if s is not None:
            _same(s, t, STREAM_FIELDS, k)


def _sums(plan, rows, cols, vals, m, n, x):
    """The plan's per-row sums through the port's plain pipeline (the
    slot products and one segment-sum), landed into (m,), and the fp64
    sums of the same f32 values and x."""
    sums, _, _ = ct.bind_sums([plan], n, torch.device("cpu"))
    ys = sums(torch.as_tensor(x, dtype=torch.float32), ct.PLAIN)
    got = np.zeros(m)
    np.add.at(got, plan.heavy_ids, ys.double().numpy())
    want = np.zeros(m)
    np.add.at(want, rows, np.asarray(vals, np.float32).astype(np.float64)
              * x.astype(np.float32)[cols])
    return got, want


# ---- the split-plan cases ---------------------------------------------------

def _band_and_hubs():
    """tests/test_round3_mechanisms.py:126-141: heavy rows with a diagonal
    band (local) and a few hub columns (far)."""
    rng = np.random.default_rng(5)
    m = n = 40_000
    rows_l, cols_l = [], []
    for r in range(0, m, 37):
        k = int(rng.integers(20, 90))
        band = rng.integers(max(0, r - 3000), min(n, r + 3000), k)
        hubs = rng.integers(0, n, 4)
        c = np.unique(np.concatenate([band, hubs]))
        rows_l.extend([r] * c.size)
        cols_l.extend(c.tolist())
    rows = np.asarray(rows_l, np.int64)
    cols = np.asarray(cols_l, np.int64)
    return rows, cols, rng.standard_normal(rows.size).astype(np.float32), m, n


def _popular_and_cold():
    """tests/test_round3_mechanisms.py:167-185: a pool of popular hub
    columns beside once-referenced scatter."""
    rng = np.random.default_rng(7)
    m = n = 30_000
    pool = rng.choice(n, 1000, replace=False)
    rows_l, cols_l = [], []
    for r in range(0, m, 11):
        k = int(rng.integers(2, 6))
        band = rng.integers(max(0, r - 1000), min(n, r + 1000), k)
        hub = np.where(rng.random(4) < 0.75,
                       pool[rng.integers(0, pool.size, 4)],
                       rng.integers(0, n, 4))
        c = np.unique(np.concatenate([band, hub]))
        rows_l.extend([r] * c.size)
        cols_l.extend(c.tolist())
    rows = np.asarray(rows_l, np.int64)
    cols = np.asarray(cols_l, np.int64)
    return rows, cols, rng.standard_normal(rows.size).astype(np.float32), m, n


def _matrix_tail(m):
    """A whole webbase stand-in as one tail (tests/test_lane_ell.py)."""
    A = synth.webbase_csr(m=m)
    return (A.row_ids().astype(np.int64), A.ja.astype(np.int64),
            A.as_.astype(np.float32), A.m, A.n)


# name -> (entries, plan_chips_split keywords)
SPLIT_CASES = {
    "direct-x": (_band_and_hubs, {"x_direct": True}),
    "dedup": (_band_and_hubs, {"x_direct": False}),
    "webbase30k": (lambda: _matrix_tail(30000), {}),
    "migration-r16": (lambda: _matrix_tail(20000), {"r_hot": 16}),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_plan_matches_the_reference(name):
    make, kw = SPLIT_CASES[name]
    rows, cols, vals, m, n = make()
    want = jax_ct.plan_chips_split(rows, cols, vals, m, n, **kw)
    got = ct.plan_chips_split(rows, cols, vals, m, n, **kw)
    assert want is not None and want.loc is not None
    assert_same_plan(want, got)
    if name == "migration-r16":
        assert got.far.n_entries > int(np.sum(np.abs(cols - rows) > 4096))
    ys, exact = _sums(got, rows, cols, vals, m, n, make_x(n))
    assert _rel_l2(ys, exact) <= EXACT_REL_L2


def test_split_plan_popularity_cold_stream(monkeypatch):
    """The far stream's dedup'd columns past the resident cap (a lowered
    ``H_CAP``) split by column popularity into far and cold."""
    rows, cols, vals, m, n = _popular_and_cold()
    far_uniq = np.unique(cols[np.abs(cols - rows) > ct.W_LOC])
    cap = max(8, -(-int(far_uniq.size) // 128) - 3)
    monkeypatch.setattr(jax_ct, "H_CAP", cap)
    monkeypatch.setattr(ct, "H_CAP", cap)
    want = jax_ct.plan_chips_split(rows, cols, vals, m, n, r_hot=512)
    got = ct.plan_chips_split(rows, cols, vals, m, n, r_hot=512)
    assert want.cold is not None and got.far.kind == got.cold.kind == \
        "resident"
    assert_same_plan(want, got)
    ys, exact = _sums(got, rows, cols, vals, m, n, make_x(n))
    assert _rel_l2(ys, exact) <= EXACT_REL_L2


def test_split_plan_sums_match_jax():
    """The split plan's per-row sums (the slot products of every stream
    and one segment-sum) against the reference's (its Pallas gathers and
    segment-sums in interpret mode)."""
    rows, cols, vals, m, n = _band_and_hubs()
    x = make_x(n)
    jplan = jax_ct.plan_chips_split(rows, cols, vals, m, n)
    raw, args, _ = jax_ct.prepare_chips(jplan, n, jnp.float32, True)
    ys_jax, hid = raw(jnp.asarray(x, jnp.float32), *args)
    plan = ct.plan_chips_split(rows, cols, vals, m, n)
    sums, _, _ = ct.bind_sums([plan], n, torch.device("cpu"))
    ys = sums(torch.as_tensor(x, dtype=torch.float32), ct.PLAIN)
    np.testing.assert_array_equal(np.asarray(hid), plan.heavy_ids)
    assert _rel_l2(ys.numpy(), np.asarray(ys_jax, np.float64)) <= REL_L2


def test_split_plans_pad_to_one_template():
    """tests/test_round3_mechanisms.py:214-263: two shard-like entry sets
    (hub and cold entries on one, band only on the other) planned with
    forced decisions, padded to one template; every shard's host
    arguments equal the reference's, have one shape, and keep its sums."""
    rng = np.random.default_rng(11)
    n = 40_000
    shards = []
    for hub_frac, m_rows in ((0.3, 20_000), (0.0, 12_000)):
        rows_l, cols_l = [], []
        pool = rng.integers(0, n, 300)
        for r in range(0, m_rows, 17):
            k = int(rng.integers(3, 40))
            c = rng.integers(max(0, r - 2000), min(n, r + 2000), k)
            if hub_frac and rng.random() < 0.8:
                c = np.concatenate([c, pool[rng.integers(0, pool.size, 3)],
                                    rng.integers(0, n, 2)])
            c = np.unique(c)
            rows_l.extend([r] * c.size)
            cols_l.extend(c.tolist())
        rows = np.asarray(rows_l, np.int64)
        cols = np.asarray(cols_l, np.int64)
        shards.append((rows, cols,
                       rng.standard_normal(rows.size).astype(np.float32),
                       m_rows))
    force = dict(x_direct=True, r_hot=64, r_far=512, r_cold=512, pop_k=128,
                 force_streams=("loc", "far", "cold"))
    jplans = [jax_ct.plan_chips_split(r, c, v, m, n, **force)
              for r, c, v, m in shards]
    plans = [ct.plan_chips_split(r, c, v, m, n, **force)
             for r, c, v, m in shards]
    for want, got in zip(jplans, plans):
        assert_same_plan(want, got)
    tpl = ct.split_shape_template(plans)
    assert tpl == jax_ct.split_shape_template(jplans)
    x = make_x(n)
    shapes = None
    for jp, p, (rows, cols, vals, m_rows) in zip(jplans, plans, shards):
        pool = np.setdiff1d(np.arange(m_rows, dtype=np.int64), p.heavy_ids)
        want = jax_ct.pad_split_plan(jp, tpl, pool)
        got = ct.pad_split_plan(p, tpl, pool)
        assert_same_plan(want, got)
        host = ct.split_plan_host_args(got)
        jhost = jax_ct.split_plan_host_args(want, jnp.float32)
        for a, b in zip(jhost, host, strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        if shapes is None:
            shapes = [a.shape for a in host]
        assert [a.shape for a in host] == shapes
        ys, exact = _sums(got, rows, cols, vals, m_rows, n, x)
        assert _rel_l2(ys, exact) <= EXACT_REL_L2


class _Core:
    def __init__(self, rows, cols, vals):
        self.trows = np.asarray(rows, np.int64)
        self.tcols = np.asarray(cols, np.int64)
        self.tvals = np.asarray(vals, np.float64)


def _adversarial(seed):
    """tests/test_chips_tail.py:45-70: many short heavy rows over several
    windows, one mega-row, and a shard with no tail."""
    rng = np.random.default_rng(seed)
    n, h_rows = 60_000, 90_000
    rows_a = np.sort(np.repeat(np.arange(3000, dtype=np.int64) * 7 % h_rows,
                               2), kind="stable")
    cols_a = rng.integers(0, n, rows_a.size)
    vals_a = rng.standard_normal(rows_a.size)
    rows_b = np.concatenate([np.zeros(900, np.int64),
                             np.full(3, 17, np.int64)])
    cols_b = np.concatenate([np.sort(rng.choice(2000, 900, False)),
                             np.array([5, 80, 600])]).astype(np.int64)
    vals_b = rng.standard_normal(rows_b.size)
    return ([(rows_a, cols_a, vals_a), (rows_b, cols_b, vals_b), ([], [], [])],
            h_rows, n)


def _spread_reach():
    """tests/test_chips_tail.py:85-100: shards whose adaptive stage-1
    reaches differ, re-planned at the largest."""
    rng = np.random.default_rng(3)
    n = 500_000
    a = (np.repeat([3, 9], 50),
         np.concatenate([np.sort(rng.choice(900, 50, False)),
                         np.sort(rng.choice(900, 50, False))]),
         rng.standard_normal(100))
    b = (np.repeat([1, 2, 5], 40),
         np.concatenate([np.sort(rng.choice(n, 40, False))
                         for _ in range(3)]),
         rng.standard_normal(120))
    return [a, b], 4096, n


@pytest.mark.parametrize("make", [lambda: _adversarial(0),
                                  lambda: _adversarial(1), _spread_reach],
                         ids=["adversarial0", "adversarial1", "spread-reach"])
def test_resident_plans_pad_like_the_reference(make):
    tails, h_rows, n = make()
    jplans = jax_plan_sharded([_Core(*t) for t in tails], h_rows, n)
    plans = _plan_sharded_chips([_Core(*t) for t in tails], h_rows, n)
    assert jplans is not None and len(plans) == len(jplans)
    x = make_x(n)
    for jp, p, (rows, cols, vals) in zip(jplans, plans, tails):
        assert_same_plan(jp, p)
        if len(rows):
            ys, exact = _sums(p, np.asarray(rows), np.asarray(cols), vals,
                              h_rows, n, x)
            assert _rel_l2(ys, exact) <= EXACT_REL_L2


# ---- the hybrid's split tail -----------------------------------------------

def test_plan_chips_falls_back_to_the_split_plan():
    """``plan_chips`` plans the split where the single plan does not fit,
    as the reference's does."""
    A = cases.heavy_scatter()
    plan = lane_ell.pack_lane_ell(A, diag="nochips")
    args = (plan.trows, plan.tcols, plan.tvals, A.m, A.n)
    want = jax_ct.plan_chips(*args)
    assert isinstance(want, jax_ct.SplitChipsPlan)
    assert_same_plan(want, ct.plan_chips(*args))


def test_heavy_scatter_takes_the_split_plan():
    """``heavy_scatter`` through ``cuda-hybrid``: a 128,000-entry tail
    whose single plan does not fit rides the split plan (a direct-x local
    stream and a far resident one), which the reference lands by its
    panel merge; meta as the reference's, y against the JAX hybrid's and
    the oracle; both streams' slot products in one ``chips_products``
    call and one segment-sum (tests/test_torch_chips_slots.py,
    tests/test_torch_landing.py)."""
    A = cases.heavy_scatter()
    jA = JaxCSR(A.name, A.m, A.n, A.irp, A.ja, A.as_)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu")
    jprep = jax_hybrid(jA, interpret=True)
    assert prep.meta["tail_kind"] == jprep.meta["tail_kind"] == "chips"
    assert prep.meta == jprep.meta
    assert prep.meta["tail_meta"]["split"]
    x = make_x(A.n)
    y = prep.fn(x).double().numpy()
    assert _rel_l2(y, np.asarray(jprep.fn(x), np.float64)) <= REL_L2
    validate_result(spmv_oracle(A, x), y, what="heavy_scatter, split tail")
    names = [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))]
    assert names == ["lane_rows", "chips_products", "window_segsum",
                     "heavy_land"]


# ---- cuda-chips ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cases.CHIPS_CASES))
def test_cuda_chips_matches_pallas_chips(name):
    make = cases.CHIPS_CASES[name]
    A = make(synth)
    prep = get_strategy("cuda-chips").prepare(A, device="cpu")
    jprep = jax_ct.prepare_chips_strategy(make(jax_synth), interpret=True)
    assert prep.meta == jprep.meta
    assert prep.ref == "pallas-chips"
    assert prep.meta["split"] == (name == "webbase30k-split")
    x = make_x(A.n)
    y = prep.fn(x).double().numpy()
    assert _rel_l2(y, np.asarray(jprep.fn(x), np.float64)) <= REL_L2
    validate_result(spmv_oracle(A, x), y, what=f"cuda-chips on {name}")


def test_cuda_chips_refuses_what_no_plan_fits(monkeypatch):
    monkeypatch.setattr(ct, "plan_chips", lambda *a, **k: None)
    with pytest.raises(ValueError, match="cuda-chips"):
        get_strategy("cuda-chips").prepare(synth.diag_csr(300),
                                           device="cpu")

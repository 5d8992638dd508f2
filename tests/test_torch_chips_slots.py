"""The chips tail's slot products (spmv_scpa_tpu_torch/ops/chips_slots.py):
the host slot table against the reference's two gather stages it
replaces, the plain products, and ``cuda-hybrid``, ``cuda-chips`` and the
row-sharded hybrid against the JAX package's y.

Cases: single plans (a synthetic tail, ``amazon60k``'s tail), every
split-stream kind (``windowed-x``, the dedup'd ``windowed``, ``resident``
far and cold, and entries migrated past the window's reach), shard
plans padded by ``pad_resident_plan`` and ``pad_split_plan``, and the
small matrices of tests/test_torch_chips_split.py and
tests/test_torch_distributed.py.

Tolerances: the products over the slot table against ``vals`` times
the values the two stages gather (``sorted_gather_plain`` then
``ranked_gather_plain`` or ``window_gather_plain``): equal
(``torch.equal``; a 0.0 may differ in sign where the stages multiply a
padding value by an x). y against the JAX package's (Pallas in
interpret mode): rel-L2 <= 1e-6, as tests/test_torch_chips_split.py
states (the reference's segment-sum is a one-hot matmul on b split into
three bf16 terms). Against ``spmv_oracle``: ``validate_result``
defaults.
"""

import jax
import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.parallel import distributed as JD

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import chips_slots as cs
from spmv_scpa_tpu_torch.ops import chips_tail as ct
from spmv_scpa_tpu_torch.ops import ext_gather as eg
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.parallel import distributed as D
from spmv_scpa_tpu_torch.parallel.distributed import _plan_sharded_chips
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-6


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---- the host table against the two gather stages ---------------------------

def _hot(base, p1, l1, R, n1p_blocks, n, x):
    """Stage 1 (``sorted_gather_plain``) over x zero-padded, as the
    reference runs it."""
    x1 = torch.zeros(n1p_blocks * R * BC)
    x1[:n] = x
    return eg.sorted_gather_plain(_t(base), x1.view(-1, BC), _t(p1), _t(l1),
                                  R)


def _stage_products(part, n, x):
    """``vals *`` the values the two gather stages read for each slot of a
    single plan or one stream of a split plan."""
    if not hasattr(part, "kind"):                   # a single plan
        hot = _hot(part.base, part.p1, part.l1, part.R, part.n1p_blocks, n,
                   x)
        xg = eg.ranked_gather_plain(hot, _t(part.p2), _t(part.l2))
    elif part.kind == "windowed-x":
        nx = min(n, part.H_pad * BC)
        xp = torch.zeros(part.H_pad * BC)
        xp[:nx] = x[:nx]
        xg = eg.window_gather_plain(_t(part.base8), xp.view(-1, BC),
                                    _t(part.p2), _t(part.l2), part.r_hot)
    else:
        hot = _hot(part.base1, part.p1, part.l1, part.r1, part.n1p_blocks, n,
                   x)
        if part.kind == "resident":
            xg = eg.ranked_gather_plain(hot, _t(part.p2), _t(part.l2))
        else:                                       # pad or cut to H_pad
            hot = torch.cat([hot, hot.new_zeros(
                (max(part.H_pad - hot.shape[0], 0), BC))])[:part.H_pad]
            xg = eg.window_gather_plain(_t(part.base8), hot, _t(part.p2),
                                        _t(part.l2), part.r_hot)
    return _t(part.vals) * xg


def _check_table(plan, n, seed=0):
    """The products over the slot table equal the two stages', part
    by part, and a slot without an entry reads column -1."""
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                        dtype=torch.float32)
    cols = cs.slots_table(plan, n)
    vals = cs.slot_vals(plan)
    assert cols.dtype == np.int32 and cols.shape == vals.shape
    got = cs.chips_products_plain(_t(cols), _t(vals), x)
    parts = plan.streams if isinstance(plan, ct.SplitChipsPlan) else [plan]
    want = torch.cat([_stage_products(p, n, x) for p in parts])
    assert torch.equal(got, want)
    live = np.concatenate([p.live for p in parts])
    assert (cols[~live] == -1).all()
    assert ((cols[live] >= 0) & (cols[live] < n)).all()
    assert sum(p.E8 for p in parts) == cols.shape[0]
    return plan


def _random_tail(seed, m=90_000, n=60_000, n_rows=700, max_len=60):
    """CSR-ordered tail entries near the diagonal, some scattered (as
    tests/test_torch_chips_tail.py draws them)."""
    rng = np.random.default_rng(seed)
    hr = np.sort(rng.choice(m, n_rows, replace=False))
    lens = rng.integers(1, max_len, n_rows)
    rows = np.repeat(hr, lens).astype(np.int64)
    near = (rows * n // m + rng.integers(-2000, 2000, rows.size)) % n
    far = rng.integers(0, n, rows.size)
    cols = np.where(rng.random(rows.size) < 0.8, near, far)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], rng.standard_normal(rows.size), m, n


def _band_and_hubs(seed=5, m=40_000):
    """Heavy rows of a diagonal band (local) and a few hub columns (far),
    as tests/test_torch_chips_split.py draws them."""
    rng = np.random.default_rng(seed)
    n = m
    rows_l, cols_l = [], []
    for r in range(0, m, 37):
        k = int(rng.integers(20, 90))
        band = rng.integers(max(0, r - 3000), min(n, r + 3000), k)
        c = np.unique(np.concatenate([band, rng.integers(0, n, 4)]))
        rows_l.extend([r] * c.size)
        cols_l.extend(c.tolist())
    rows = np.asarray(rows_l, np.int64)
    cols = np.asarray(cols_l, np.int64)
    return rows, cols, rng.standard_normal(rows.size).astype(np.float32), m, n


def _webbase_tail(m=20000):
    A = synth.webbase_csr(m=m)
    return (A.row_ids().astype(np.int64), A.ja.astype(np.int64),
            A.as_.astype(np.float32), A.m, A.n)


def _amazon60k_tail():
    make, kw = cases.SMALL_CASES["amazon60k"]
    A = make()
    plan = lane_ell.pack_lane_ell(A, **kw)
    return plan.trows, plan.tcols, plan.tvals, A.m, A.n


@pytest.mark.parametrize("make", [lambda: _random_tail(0),
                                  lambda: _random_tail(1, n_rows=3000,
                                                       max_len=12),
                                  _amazon60k_tail],
                         ids=["random0", "random1", "amazon60k"])
def test_single_plan_table_equals_the_two_stages(make):
    rows, cols, vals, m, n = make()
    plan = ct.plan_chips(rows, cols, vals, m, n)
    assert isinstance(plan, ct.ChipsPlan)
    _check_table(plan, n)


SPLIT_CASES = {
    # a windowed-x local stream and a resident far one
    "windowed-x": (_band_and_hubs, {"x_direct": True}),
    # the dedup'd windowed local stream (stage 1, then the windowed gather)
    "windowed": (_band_and_hubs, {"x_direct": False}),
    # a narrow reach: local entries migrate to the far stream, their
    # slots left as padding
    "migration-r16": (_webbase_tail, {"r_hot": 16}),
    # far and cold resident streams (forced popularity cutoff)
    "far-cold": (_band_and_hubs, {"pop_k": 64}),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_stream_tables_equal_the_two_stages(name):
    make, kw = SPLIT_CASES[name]
    rows, cols, vals, m, n = make()
    plan = ct.plan_chips_split(rows, cols, vals, m, n, **kw)
    kinds = [s.kind for s in plan.streams]
    want = {"windowed-x": ["windowed-x", "resident"],
            "windowed": ["windowed", "resident"],
            "migration-r16": None,
            "far-cold": ["windowed-x", "resident", "resident"]}[name]
    assert want is None or kinds == want
    _check_table(plan, n)
    for s in plan.streams:             # each stream alone, too
        x = torch.ones(n)
        assert torch.equal(
            cs.chips_products_plain(_t(cs.slots_table(s, n)),
                                    _t(cs.slot_vals(s)), x),
            _stage_products(s, n, x))


def test_padded_resident_plans_read_no_x_at_padding():
    """Shard plans padded to shared shapes (a mega-row shard, a shard of
    short rows, a shard without a tail): every padded slot reads column
    -1."""
    rng = np.random.default_rng(0)
    n, h_rows = 60_000, 90_000

    class Core:
        def __init__(self, rows, cols, vals):
            self.trows = np.asarray(rows, np.int64)
            self.tcols = np.asarray(cols, np.int64)
            self.tvals = np.asarray(vals, np.float64)

    rows_a = np.sort(np.repeat(np.arange(3000, dtype=np.int64) * 7, 2))
    rows_b = np.zeros(900, np.int64)
    cores = [Core(rows_a, rng.integers(0, n, rows_a.size),
                  rng.standard_normal(rows_a.size)),
             Core(rows_b, np.sort(rng.choice(2000, 900, False)),
                  rng.standard_normal(900)), Core([], [], [])]
    plans = _plan_sharded_chips(cores, h_rows, n)
    assert all(isinstance(p, ct.ChipsPlan) for p in plans)
    for p in plans:
        _check_table(p, n)
    assert len({p.E8 for p in plans}) == 1
    assert (cs.slots_table(plans[2], n) == -1).sum() \
        >= plans[2].E8 * BC - 1                   # the dummy entry only


def test_padded_split_plans_read_no_x_at_padding():
    """Two shards' split plans with forced decisions padded to one
    template (placeholder streams among them): equal to the two stages,
    padding at column -1."""
    rng = np.random.default_rng(11)
    n = 40_000
    shards = []
    for hub, m_rows in ((True, 20_000), (False, 12_000)):
        rows_l, cols_l = [], []
        for r in range(0, m_rows, 17):
            c = rng.integers(max(0, r - 2000), min(n, r + 2000),
                             int(rng.integers(3, 40)))
            if hub:
                c = np.concatenate([c, rng.integers(0, n, 3)])
            c = np.unique(c)
            rows_l.extend([r] * c.size)
            cols_l.extend(c.tolist())
        rows = np.asarray(rows_l, np.int64)
        shards.append((rows, np.asarray(cols_l, np.int64),
                       rng.standard_normal(rows.size).astype(np.float32),
                       m_rows))
    force = dict(x_direct=True, r_hot=64, r_far=512, r_cold=512, pop_k=128,
                 force_streams=("loc", "far", "cold"))
    plans = [ct.plan_chips_split(r, c, v, m, n, **force)
             for r, c, v, m in shards]
    tpl = ct.split_shape_template(plans)
    for p, (_, _, _, m_rows) in zip(plans, shards):
        pool = np.setdiff1d(np.arange(m_rows, dtype=np.int64), p.heavy_ids)
        padded = ct.pad_split_plan(p, tpl, pool)
        _check_table(padded, n)
        assert sum(s.live.sum() for s in padded.streams) == sum(
            s.n_entries for s in p.streams)


def test_explicit_zero_keeps_its_column_and_nonfinite_x_stays_out():
    """A real entry of value 0.0 keeps its column (0 * inf is NaN, as the
    two stages give); x non-finite only at columns no entry names
    leaves every product finite, where the two stages' padding read
    it."""
    rng = np.random.default_rng(2)
    n = 4000
    rows_l, cols_l = [], []
    for r in range(0, n, 40):           # columns in [100, n - 100)
        c = np.unique(np.clip(r + rng.integers(-900, 900, 40), 100,
                              n - 101))
        rows_l.extend([r] * c.size)
        cols_l.extend(c.tolist())
    rows = np.asarray(rows_l, np.int64)
    cols = np.asarray(cols_l, np.int64)
    vals = rng.standard_normal(cols.size)
    vals[5] = 0.0
    for plan in (ct.plan_chips(rows, cols, vals, n, n),
                 ct.plan_chips_split(rows, cols, vals, n, n)):
        _check_nonfinite(plan, n, int(cols[5]))


def _check_nonfinite(plan, n, col5):
    table = cs.slots_table(plan, n)
    x = torch.ones(n)
    x[:100], x[-100:] = float("inf"), float("nan")
    prod = cs.chips_products_plain(_t(table), _t(cs.slot_vals(plan)), x)
    assert bool(torch.isfinite(prod).all())
    x[col5] = float("inf")
    prod = cs.chips_products_plain(_t(table), _t(cs.slot_vals(plan)), x)
    assert int(torch.isnan(prod).sum()) == 1


# ---- the plain products and the wrapper on the CPU ---------------------------

def test_chips_products_plain_reads_nothing_outside_x():
    cols = torch.tensor([[0, -1, 5, 6] + [1] * (BC - 4)], dtype=torch.int32)
    vals = torch.full((1, BC), -2.0)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, float("nan")])
    before = dict(cs.LAUNCHES)
    out = cs.chips_products(cols, vals, x)                 # CPU: plain
    assert cs.LAUNCHES == before
    assert float(out[0, 0]) == -2.0 and bool(torch.isnan(out[0, 2]))
    for j in (1, 3):                  # column -1 and a column past x
        assert float(out[0, j]) == 0.0 and not bool(out[0, j].signbit())
    assert bool((out[0, 4:] == -4.0).all())
    empty = cs.chips_products_plain(cols, vals, torch.zeros(0))
    assert bool((empty == 0).all())


def test_chips_products_refuses_bad_arguments():
    cols = torch.zeros((2, BC), dtype=torch.int32)
    vals = torch.zeros((2, BC))
    x = torch.zeros(10)
    for bad, what in (((cols.long(), vals, x), "cols"),
                      ((cols, vals.double(), x), "vals"),
                      ((cols[:1], vals, x), "cols"),
                      ((cols, vals[:, :64], x), "vals"),
                      ((cols, vals, x.view(2, 5)), "x is"),
                      ((cols.t().contiguous().t(), vals, x),
                       "not contiguous")):
        with pytest.raises(ValueError, match=what):
            cs.chips_products(*bad)


def test_bind_slots_concatenates_the_plans():
    """Several plans' tables in one launch: each plan's rows of the
    products equal its own, the two gather stages' products."""
    plans = [ct.plan_chips(*_random_tail(s, n_rows=300))
             for s in (3, 4)]
    n = 60_000
    x = torch.as_tensor(make_x(n), dtype=torch.float32)
    products, hbm = ct.bind_slots(plans, n, "cpu")
    prod = products(x, ct.PLAIN)
    assert prod.shape[0] == sum(p.E8 for p in plans)
    assert hbm == prod.numel() * 12
    r0 = 0
    for p in plans:
        assert torch.equal(prod[r0:r0 + p.E8], _stage_products(p, n, x))
        r0 += p.E8


# ---- the strategies -----------------------------------------------------------

def _routes(prep, n):
    return [k for k, _ in prep.kernel_calls(
        torch.as_tensor(make_x(n), dtype=torch.float32))]


@pytest.mark.parametrize("name", ["amazon60k", "heavy-scatter"])
def test_cuda_hybrid_matches_jax(name):
    """``cuda-hybrid``'s chips tail (single plan on amazon60k, the split
    plan on heavy_scatter): its x side one ``chips_products`` call with no
    stage-1 gather, y against the JAX hybrid's."""
    if name == "amazon60k":
        make, kw = cases.SMALL_CASES[name]
        A = make()
        jA = jax_synth.amazon_csr(m=60000, seed=6)
    else:
        A, kw = cases.heavy_scatter(), {}
        jA = JaxCSR(A.name, A.m, A.n, A.irp, A.ja, A.as_)
    slots = lane_ell.prepare_lane_ell_hybrid(A, device="cpu", **kw)
    assert slots.meta["tail_kind"] == "chips"
    x = make_x(A.n)
    y = slots.fn(x)
    assert _routes(slots, A.n) == ["lane_rows", "chips_products",
                                   "window_segsum", "heavy_land"]
    y_jax = np.asarray(jax_hybrid(jA, interpret=True, **kw).fn(x))
    assert _rel_l2(y.numpy(), y_jax) <= VS_JAX_REL_L2
    validate_result(spmv_oracle(A, x), y.double().numpy(), what=name)


@pytest.mark.parametrize("name", sorted(cases.CHIPS_CASES))
def test_cuda_chips_matches_jax(name):
    """``cuda-chips`` lands into a zeroed y: its three kernels once each,
    y against the JAX package's ``pallas-chips`` and the oracle."""
    make = cases.CHIPS_CASES[name]
    A = make(synth)
    slots = get_strategy("cuda-chips").prepare(A, device="cpu")
    x = make_x(A.n)
    y = slots.fn(x)
    assert _routes(slots, A.n) == ["chips_products", "window_segsum",
                                   "heavy_land"]
    jprep = jax_ct.prepare_chips_strategy(make(jax_synth), interpret=True)
    assert _rel_l2(y.numpy(), np.asarray(jprep.fn(x))) <= VS_JAX_REL_L2
    validate_result(spmv_oracle(A, x), y.double().numpy(), what=name)


@pytest.mark.parametrize("name", ["amazon5000", "webbase30k-split"])
def test_cuda_chips_keeps_y_finite_with_nonfinite_x_off_its_columns(name):
    """Columns 0 and n-1 dropped from A, x = inf and NaN there: y on the
    slot products is finite and agrees with the oracle (the gather
    stages' padding read them)."""
    B = cases.CHIPS_CASES[name](synth)
    keep = (B.ja != 0) & (B.ja != B.n - 1)
    A = CSR.from_coo(B.name, B.m, B.n, B.row_ids()[keep], B.ja[keep],
                     B.as_[keep])
    x = make_x(A.n)
    x[0], x[-1] = np.inf, np.nan
    y = get_strategy("cuda-chips").prepare(A, device="cpu").fn(x)
    assert bool(torch.isfinite(y).all())
    validate_result(spmv_oracle(A, x), y.double().numpy(), what=name)


# name -> (matrix maker, shards, knobs): chips routes of
# tests/test_torch_distributed.py
DIST_CHIPS = {
    "dryrun-chips": (lambda mod: cases.DIST_CASES["hybrid-chips"][1](4, mod),
                     4, {"tail_kind": "chips"}),
    "dryrun-chips-split": (
        lambda mod: cases.DIST_CASES["hybrid-chips-split"][1](4, mod), 4,
        {"tail_kind": "chips-split"}),
    "amazon40k-idx8": (lambda mod: mod.amazon_csr(m=40_000, seed=11), 4,
                       {"idx8": True}),
}


@pytest.mark.parametrize("name", sorted(DIST_CHIPS))
def test_row_sharded_matches_jax(name):
    """The row-sharded hybrid's chips tails: one ``chips_products`` call a
    call for the card's shards and no gather; y against the JAX
    package's."""
    make, k, kw = DIST_CHIPS[name]
    A = make(synth)
    slots = D.prepare_row_sharded_hybrid(A, mesh=["cpu"] * k, **kw)
    assert slots.meta["tail_kind"].startswith("chips")
    x = make_x(A.n)
    y = slots.fn(x)
    routes = _routes(slots, A.n)
    assert routes.count("chips_products") == 1 and \
        "sorted_gather" not in routes
    jd = JD.prepare_row_sharded_hybrid(
        make(jax_synth), mesh=JD.make_mesh(devices=jax.devices("cpu")[:k]),
        interpret=True, **kw)
    assert _rel_l2(y.numpy(), np.asarray(jd.fn(x))) <= VS_JAX_REL_L2
    validate_result(spmv_oracle(A, x), y.double().numpy(), what=name)


def test_layout_bytes_counts_the_slot_products():
    """``bench/layout_bytes.py``'s chips counts: 12 B a chip slot for the
    slot products, above 16 B a slot (and the stage-1 tables and the
    staged x) for the two gather stages; entries are the live slots."""
    from spmv_scpa_tpu_torch.bench import layout_bytes
    rows, cols, vals, m, n = _random_tail(3, n_rows=300)
    plan = ct.plan_chips(rows, cols, vals, m, n)
    b = layout_bytes.chips_bytes([plan], n)
    assert b["slots"] == plan.E8 * BC and b["entries"] == rows.size
    assert b["slot_bytes"] == 12 * b["slots"]
    assert b["hot_bytes"] == (16 * b["slots"] + plan.p1.size * 8
                              + plan.n1p_blocks * plan.R * BC * 4)

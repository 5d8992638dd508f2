"""The heavy-row landing's two designs (spmv_scpa_tpu_torch/ops/
chips_tail.py, knob ``landing``) on the CPU: ``"direct"`` (one window
segment-sum over every stream of every shard of a card, ``bind_sums``,
then ``heavy_land``, a direct scatter into y through a host map) and
``"merge"`` (the reference's segment-sum per stream and panel merge).

* ``heavy_land``'s plain version against the JAX package's
  ``make_landing`` on its three kinds (windowed, ranked, scatter): exact.
  Both add one f32 sum into each heavy row of y, and y holds no -0.0.
* ``cuda-hybrid`` (a chips tail, ``heavy_scatter``'s split plan, a
  compact-PELL and an XPOSE big tail), ``cuda-chips`` and the row-sharded
  hybrid at 2 and 4 CPU shards, on both designs, against the JAX
  package's strategy (Pallas in interpret mode): rel-L2 <= 1e-6 for the
  chips tails (the reference's segment-sum reduces with a one-hot matmul
  on three bf16 terms of the partials, f32-grade, in another order), the
  bounds of tests/test_torch_big_tail.py for the compact tails (1e-4
  PELL, whose reference kernel keeps 16 bits of each operand; 1e-5
  XPOSE); against ``spmv_oracle`` by ``validate_result``. The two designs
  against each other: exact where a heavy row's quanta come from one
  stream (a single plan, a compact tail: the same sums land), rel-L2 <=
  1e-6 on split plans (the one segment-sum adds a row's loc, far and cold
  quanta in one order, the merge adds the streams' sums).
* The one-table segment-sum against the per-stream sums (the same
  tolerances); its tables walked as ``csrc/segsum.cu`` walks them:
  tests/test_torch_segsum.py.
* The land map on padded shard plans: every row once, pad ranks -1.
* ``heavy_land``'s refusals, and ``chip_smoke.py``'s bound and
  ``index_add_`` yardstick of it.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.parallel import distributed as JD

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import chips_tail as ct
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.parallel import distributed as D
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

CHIPS_VS_JAX = 1e-6
PELL_VS_JAX = 1e-4
XPOSE_VS_JAX = 1e-5
SPLIT_DIRECT_VS_MERGE = 1e-6
CPU = torch.device("cpu")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _names(prep, x):
    return [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))]


# ---- heavy_land against the reference's landing -----------------------------

# test_torch_chips_tail.py's LANDINGS: the heavy ids and the merge budget
LANDINGS = {
    "windowed": (lambda rng, m: np.sort(rng.choice(m, 900, replace=False)),
                 6e8),
    "ranked": (lambda rng, m: rng.permutation(
        rng.choice(m, 900, replace=False)), 6e8),
    "scatter": (lambda rng, m: rng.permutation(
        rng.choice(m, 900, replace=False)), 0.0),
}


@pytest.mark.parametrize("kind", sorted(LANDINGS))
def test_direct_plain_matches_jax_landing(kind):
    rng = np.random.default_rng(len(kind))
    m = 50_000
    G_pad = -(-m // BC)
    make_ids, budget = LANDINGS[kind]
    hid = make_ids(rng, m).astype(np.int64)
    assert ct.landing_tables(hid, m, G_pad, budget)[0] == kind
    y = rng.standard_normal(m).astype(np.float32)
    ys = rng.standard_normal(hid.size).astype(np.float32)
    jland, margs, _, _ = jax_ct.make_landing(hid, m, G_pad, jnp.float32,
                                             True, budget)
    want = np.asarray(jland(jnp.asarray(y), jnp.asarray(ys),
                            jnp.asarray(hid, jnp.int32), *margs))
    land = ct.bind_land(hid, m, CPU)
    yt = torch.as_tensor(y.copy())
    got = ct.heavy_land_plain(yt, torch.as_tensor(ys), land)
    assert got is yt                                  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ct.heavy_land(torch.as_tensor(y.copy()), torch.as_tensor(ys),
                      land).numpy(), want)


# ---- cuda-hybrid on both landings -------------------------------------------

# name -> (matrix on either package's testing module, knobs, the tail the
# pack takes, y against the JAX hybrid's)
HYBRID_CASES = {
    "amazon20k-chips": (lambda s: s.amazon_csr(m=20000, seed=4), {},
                        "chips", CHIPS_VS_JAX),
    "heavy-scatter-split": (None, {}, "chips", CHIPS_VS_JAX),
    "compact-pell": (lambda s: s.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
                     {"ext": False, "diag": "nochips", "tail_xla_max": 1000},
                     "compact-cuda-pell-rows", PELL_VS_JAX),
    "xpose-tail": (lambda s: cases.make(cases.XPOSE_TAIL[0], s),
                   cases.XPOSE_TAIL[1], "compact-cuda-xpose", XPOSE_VS_JAX),
}


def _matrix(make, module):
    if make is not None:
        return make(module)
    A = cases.heavy_scatter()
    if module is synth:
        return A
    return module.CSR(A.name, A.m, A.n, A.irp, A.ja, A.as_)


@functools.cache
def _hybrid(name):
    """Both designs from one pack ({landing: Prepared}), x, the oracle's
    and the JAX hybrid's y."""
    make, kw, _, _ = HYBRID_CASES[name]
    A = _matrix(make, synth)
    preps = lane_ell.prepare_hybrid_layouts(
        A, (("rows", "slots", "direct"), ("rows", "slots", "merge")),
        device="cpu", **kw)
    x = make_x(A.n)
    jprep = jax_hybrid(_matrix(make, jax_synth), interpret=True, **kw)
    return ({ld: preps["rows", "slots", ld] for ld in ct.LANDINGS}, A, x,
            spmv_oracle(A, x), np.asarray(jprep.fn(x), np.float64))


@pytest.mark.parametrize("landing", ct.LANDINGS)
@pytest.mark.parametrize("name", sorted(HYBRID_CASES))
def test_hybrid_landings_match_jax_and_the_oracle(name, landing):
    preps, A, x, gold, y_jax = _hybrid(name)
    _, _, tail_kind, tol = HYBRID_CASES[name]
    prep = preps[landing]
    assert prep.meta["tail_kind"] == tail_kind
    assert prep.meta["landing"] == landing
    y = to_numpy(prep.fn(x))
    assert _rel_l2(y, y_jax) <= tol
    validate_result(gold, y, what=f"{name}, landing={landing}")
    names = _names(prep, x)
    if landing == "direct":
        assert names[-1] == "heavy_land"
        assert not {"ranked_gather", "window_gather"} & set(names)
        if tail_kind == "chips":
            assert names.count("window_segsum") == 1
    else:
        assert "heavy_land" not in names


@pytest.mark.parametrize("name", sorted(HYBRID_CASES))
def test_hybrid_direct_against_merge(name):
    """The same sums land on both designs: exact, but on a split plan,
    whose one segment-sum adds a heavy row's streams in another order."""
    preps, A, x, *_ = _hybrid(name)
    y_d, y_m = (to_numpy(preps[ld].fn(x)) for ld in ("direct", "merge"))
    split = preps["direct"].meta["tail_kind"] == "chips" and \
        preps["direct"].meta["tail_meta"]["split"]
    assert split == (name == "heavy-scatter-split")
    if split:
        assert 0 < _rel_l2(y_d, y_m) <= SPLIT_DIRECT_VS_MERGE
    else:
        np.testing.assert_array_equal(y_d, y_m)
    # the direct landing's bytes: 16 B a heavy row, not the merge's 12 B
    # a row of y
    assert preps["direct"].hbm_bytes < preps["merge"].hbm_bytes


# ---- cuda-chips -------------------------------------------------------------

CHIPS = ("amazon5000", "megarow", "webbase30k-split")


@functools.cache
def _chips_jax(name):
    make = cases.CHIPS_CASES[name]
    x = make_x(make().n)
    jprep = jax_ct.prepare_chips_strategy(make(jax_synth), interpret=True)
    return x, np.asarray(jprep.fn(x), np.float64)


@pytest.mark.parametrize("landing", ct.LANDINGS)
@pytest.mark.parametrize("name", CHIPS)
def test_cuda_chips_landings_match_jax(name, landing):
    """``cuda-chips`` lands into a zeroed y on both designs: against the
    JAX package's ``pallas-chips``, the oracle and each other."""
    A = cases.CHIPS_CASES[name]()
    x, y_jax = _chips_jax(name)
    prep = get_strategy("cuda-chips").prepare(A, device="cpu",
                                              landing=landing)
    other = get_strategy("cuda-chips").prepare(
        A, device="cpu", landing=({"direct", "merge"} - {landing}).pop())
    assert prep.meta["landing"] == landing
    assert prep.meta["panel_merge"] == other.meta["panel_merge"]
    y = to_numpy(prep.fn(x))
    assert _rel_l2(y, y_jax) <= CHIPS_VS_JAX
    validate_result(spmv_oracle(A, x), y, what=f"cuda-chips {name}")
    y_o = to_numpy(other.fn(x))
    if prep.meta["split"]:
        assert _rel_l2(y, y_o) <= SPLIT_DIRECT_VS_MERGE
    else:
        np.testing.assert_array_equal(y, y_o)
    names = _names(prep, x)
    assert ("heavy_land" in names) == (landing == "direct")
    if landing == "direct":
        assert names == ["chips_products", "window_segsum", "heavy_land"]


# ---- the row-sharded hybrid -------------------------------------------------

# name -> (matrix, knobs): chips tails of single plans and of split plans
DIST = {
    "amazon6k-chips": (lambda s: s.amazon_csr(m=6000, seed=30),
                       {"tail_kind": "chips"}),
    "webbase12k-split": (lambda s: s.webbase_csr(m=12000, seed=5),
                         {"tail_kind": "chips-split"}),
}
DESIGNS = tuple((layout, "slots", ld) for layout in lane_ell.CORE_LAYOUTS
                for ld in ct.LANDINGS)


@functools.cache
def _dist(name, k):
    make, kw = DIST[name]
    A = make(synth)
    preps = D.row_sharded_hybrid_layouts(A, DESIGNS, mesh=["cpu"] * k, **kw)
    x = make_x(A.n)
    jd = JD.prepare_row_sharded_hybrid(
        make(jax_synth), mesh=JD.make_mesh(devices=jax.devices("cpu")[:k]),
        interpret=True, **kw)
    return preps, A, x, spmv_oracle(A, x), np.asarray(jd.fn(x), np.float64)


@pytest.mark.parametrize("landing", ct.LANDINGS)
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", sorted(DIST))
def test_row_shards_landings_match_jax(name, k, landing):
    """On both core layouts (the direct landing's map by the core's
    width): against the JAX row-sharded hybrid, the oracle and the other
    design; on ``"direct"`` one segment-sum and one ``heavy_land`` for
    all the shards of the card."""
    preps, A, x, gold, y_jax = _dist(name, k)
    for layout in lane_ell.CORE_LAYOUTS:
        prep = preps[layout, "slots", landing]
        assert prep.meta["landing"] == landing
        assert prep.meta["tail_kind"] == DIST[name][1]["tail_kind"]
        y = to_numpy(prep.fn(x))
        assert _rel_l2(y, y_jax) <= CHIPS_VS_JAX, layout
        validate_result(gold, y, what=f"{name} on {k} shards, {layout}")
        other = to_numpy(preps[layout, "slots",
                               ({"direct", "merge"} - {landing}).pop()].fn(x))
        if DIST[name][1]["tail_kind"] == "chips-split":
            assert _rel_l2(y, other) <= SPLIT_DIRECT_VS_MERGE
        else:
            np.testing.assert_array_equal(y, other)
        names = _names(prep, x)
        if landing == "direct":
            assert names.count("window_segsum") == 1
            assert names.count("heavy_land") == 1
            assert "ranked_gather" not in names[names.index(
                "chips_products"):]
        else:
            assert names.count("window_segsum") >= k


# ---- the one-table segment-sum ----------------------------------------------

def _split_plans(k):
    """webbase12k's padded split plans on k shards, and x."""
    make, _ = DIST["webbase12k-split"]
    A = make(synth)
    bounds, h_rows, _, _, cores = D.pack_shards(A, k)
    return D._plan_sharded_chips(cores, h_rows, A.n, split_only=True), A.n


def _one_table_case(name):
    if name == "split-4-shards":
        plans, n = _split_plans(4)
    elif name == "megarow":
        A = cases.CHIPS_CASES["megarow"]()
        plans, n = [ct.plan_chips(A.row_ids().astype(np.int64),
                                  A.ja.astype(np.int64), A.as_, A.m,
                                  A.n)], A.n
    else:
        A = cases.heavy_scatter()
        plan = lane_ell.pack_lane_ell(A)
        plans, n = [plan.chips], A.n
    return plans, n


@pytest.mark.parametrize("name", ["heavy-scatter", "megarow",
                                  "split-4-shards"])
def test_one_table_sums_against_the_per_stream_sums(name):
    """``bind_sums`` (one segment-sum over every stream of every plan)
    against each plan's streams summed apart (``_slot_sums``): exact for a
    plan of one stream, rel-L2 <= 1e-6 otherwise."""
    plans, n = _one_table_case(name)
    xf = torch.as_tensor(make_x(n), dtype=torch.float32)
    sums, ranks, _ = ct.bind_sums(plans, n, CPU)
    ys = sums(xf, ct.PLAIN)
    products, per_plan, _ = ct.bind_slots(plans, n, CPU)
    prod = products(xf, ct.PLAIN)
    for p, r, one in zip(plans, ranks, per_plan):
        want = one(prod, ct.PLAIN)[:p.n_real]
        got = ys[r:r + p.n_real]
        if len(p.streams if hasattr(p, "streams") else [p]) == 1:
            assert torch.equal(got, want)
        else:
            assert _rel_l2(got, want) <= SPLIT_DIRECT_VS_MERGE
    if name == "megarow":
        assert plans[0].NH == 1            # one row past CHUNK quanta: a hub


# ---- the land map -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["chips", "chips-split"])
def test_land_map_names_each_row_once_and_skips_pad_ranks(kind):
    """Padded shard plans: rank k of shard j lands in row j * W +
    heavy_ids[k] for its real ranks, and the pad ranks (rows of the pad
    pool, whose sums are 0) and the window padding map to -1."""
    make, _ = DIST["amazon6k-chips" if kind == "chips" else
                   "webbase12k-split"]
    A = make(synth)
    _, h_rows, _, _, cores = D.pack_shards(A, 4)
    plans = D._plan_sharded_chips(cores, h_rows, A.n,
                                  split_only=(kind == "chips-split"))
    assert any(p.n_real < p.NH for p in plans)          # some pad ranks
    sums, ranks, _ = ct.bind_sums(plans, A.n, CPU)
    size = ranks[-1] + plans[-1].NH
    for W in (h_rows, 2 * h_rows + 5):
        land = ct.land_map(plans, ranks, size, [j * W for j in range(4)])
        ct.check_land(land, 4 * W)
        live = land[land >= 0]
        assert live.size == sum(p.n_real for p in plans)
        assert np.unique(live).size == live.size
        for j, (p, r) in enumerate(zip(plans, ranks)):
            np.testing.assert_array_equal(
                land[r:r + p.n_real], j * W + p.heavy_ids[:p.n_real])
            assert (land[r + p.n_real:r + p.NH] == -1).all()
    # the pad ranks' sums are 0: the merge may add them, the map skips them
    ys = sums(torch.as_tensor(make_x(A.n), dtype=torch.float32), ct.PLAIN)
    for p, r in zip(plans, ranks):
        assert (ys[r + p.n_real:r + p.NH] == 0).all()


# ---- heavy_land's refusals and chip_smoke's numbers -------------------------

def test_heavy_land_refuses_bad_arguments():
    y = torch.zeros(100)
    ys = torch.ones(4)
    land = torch.tensor([3, -1, 7, 99], dtype=torch.int32)
    ct.heavy_land(y, ys, land)
    assert y[[3, 7, 99]].tolist() == [1.0, 1.0, 1.0] and y.sum() == 3
    for bad, what in (((y, ys, torch.tensor([3, 5, 3, -1],
                                            dtype=torch.int32)),
                       "more than once"),
                      ((y, ys, torch.tensor([3, 100, 1, 2],
                                            dtype=torch.int32)),
                       "outside"),
                      ((y, ys, torch.tensor([3, -2, 1, 2],
                                            dtype=torch.int32)),
                       "outside"),
                      ((y, ys, land.long()), "land is"),
                      ((y, ys.double(), land), "float32"),
                      ((y.double(), ys, land), "float32"),
                      ((y, ys[:3], land), "land is"),
                      ((y.view(10, 10).t(), ys, land), "y is not contiguous")):
        with pytest.raises(ValueError, match=what):
            ct.heavy_land(*bad)
    with pytest.raises(ValueError, match="more than once"):
        ct.bind_land(np.array([1, 1]), 10, CPU)
    with pytest.raises(ValueError, match="outside"):
        ct.bind_land(np.array([1, 10]), 10, CPU)
    with pytest.raises(ValueError, match="landing"):
        get_strategy("cuda-chips").prepare(cases.CHIPS_CASES["megarow"](),
                                           device="cpu", landing="scatter")
    with pytest.raises(ValueError, match="landing"):
        lane_ell.prepare_lane_ell_hybrid(synth.diag_csr(8), device="cpu",
                                         landing="gather")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_landing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_heavy_land_bound_and_yardstick():
    """chip_smoke's bound of a ``heavy_land`` call charges 4 B an entry
    of land and 12 B a heavy row (its sum, its row of y read and
    written), never all of y; its ``index_add_`` yardstick adds the same
    sums into the same rows."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.standard_normal(5000).astype(np.float32))
    land_np = np.full(700, -1, np.int64)
    land_np[:600] = rng.choice(5000, 600, replace=False)
    rng.shuffle(land_np)
    land = ct.bind_land(land_np, y.numel(), CPU)
    ys = torch.as_tensor(rng.standard_normal(700).astype(np.float32))
    args = (y, ys, land)
    out = cs.PLAIN["heavy_land"](*cs.fresh("heavy_land", args))
    ms, by = cs.bound("heavy_land", args, out)
    assert by == "bytes"
    assert ms == pytest.approx((700 * 4 + 600 * 12) / cs.HBM_BYTES_PER_S
                               * 1e3, rel=1e-12)
    assert torch.equal(cs.library("heavy_land", args, None, None)(), out)
    assert not torch.equal(y, out)                   # the replay's own y

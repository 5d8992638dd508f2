"""The hybrid's PELL delegations (spmv_scpa_tpu_torch/ops/lane_ell.py):
the no-locality escape to ``cuda-pell``, and the big-tail branch as
compact PELL, compact XPOSE or as a second hybrid, against the JAX package's
``prepare_lane_ell_hybrid`` run in interpret mode on the CPU; and the
webbase-1M stand-in at 200k rows through the port alone.

Tolerances: meta (with the port's names for the tail routes, below) and
bytes, exact; the port's y (plain versions) against JAX, rel-L2 <= 1e-4
(the TPU's PELL kernels reduce in bf16 split passes; 1e-5 for the XPOSE
tail, f32 on both sides), and against ``spmv_oracle``, rel-L2 <= 1e-6
and ``validate_result``.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops import lane_ell as jax_lane_ell
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_prepare

from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import chips_tail, lane_ell, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-4
VS_JAX_XPOSE_REL_L2 = 1e-5
VS_ORACLE_REL_L2 = 1e-6

# the reference's names of the tail routes and strategies -> the port's
PORT_NAMES = {"xla-compact": "torch-compact", "pallas-pell": "cuda-pell",
              "compact-pallas-pell": "compact-cuda-pell"}


def _port_meta(meta, landing=None):
    """The JAX meta with the reference's route names mapped to the
    port's (hybrid-rN keeps its name), nested tail meta included, and
    the port's ``landing`` beside them where given (a hybrid's own meta:
    a call delegated to PELL lands nothing)."""
    out = dict(meta)
    if landing is not None and "delegated" not in out:
        out["landing"] = landing
    for key in ("tail_kind", "delegated"):
        if out.get(key) in PORT_NAMES:
            out[key] = PORT_NAMES[out[key]]
    if isinstance(out.get("tail_meta"), dict):
        out["tail_meta"] = _port_meta(out["tail_meta"])
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _amazon20k(s):
    return s.amazon_csr(m=20000, avg_nnz=4.7, seed=4)


# name -> (generator call on either package's testing module, knobs)
ROUTES = {
    # the smallest size of the reference's escape matrix
    # (powerlaw_csr(30_000, ...)) whose diagonal coverage stays < 0.4;
    # its test is tests/test_torch_pell_escape.py, run apart because
    # the JAX side's interpret-mode compile takes most of its time
    "escape": (lambda s: s.powerlaw_csr(17000, 17000, avg_nnz=8, seed=5),
               {}),
    # a 3,091-entry tail past tail_xla_max, no chips
    "compact-pell": (_amazon20k, {"ext": False, "diag": "nochips",
                                  "tail_xla_max": 1000}),
    "recursion": (_amazon20k, {"ext": False, "diag": "nochips",
                               "tail_xla_max": 1000,
                               "tail_strategy": "auto"}),
}


@functools.cache
def _route(name):
    """The port on the tile layout and the reference's landing
    (``landing="merge"``), bound on both core layouts from one pack: (A,
    x, the lanes core's Prepared, whose PELL meta and bytes are the
    reference's, the JAX Prepared, the lanes y, the JAX y, the rows
    core's Prepared). The PELL row layout: tests/test_torch_pell_rows.py;
    the rows core: tests/test_torch_lane_rows.py."""
    make, kw = ROUTES[name]
    A = make(synth)
    x = make_x(A.n)
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu",
                                            pell_layout="tiles",
                                            landing="merge", **kw)
    prep = preps["lanes"]
    jprep = jax_prepare(make(jax_synth), interpret=True, **kw)
    return A, x, prep, jprep, to_numpy(prep.fn(x)), \
        np.asarray(jprep.fn(x), dtype=np.float64), preps["rows"]


def check_route(name):
    A, x, prep, jprep, y, y_jax, rows = _route(name)
    assert prep.meta == _port_meta(jprep.meta, "merge") == rows.meta
    assert prep.hbm_bytes == jprep.hbm_bytes
    assert PORT_NAMES.get(jprep.strategy, "cuda-hybrid") == prep.strategy
    gold = spmv_oracle(A, x)
    for layout, yl in (("lanes", y), ("rows", to_numpy(rows.fn(x)))):
        assert _rel_l2(yl, y_jax) <= VS_JAX_REL_L2, layout
        assert _rel_l2(yl, gold) <= VS_ORACLE_REL_L2, layout
        validate_result(gold, yl, what=f"port hybrid (plain, {layout}), "
                        f"{name}")


def kernel_route(name, layout="lanes"):
    route = _route(name)
    prep = route[2] if layout == "lanes" else route[6]
    return [k for k, _ in prep.kernel_calls(make_x(route[0].n))]


@pytest.mark.parametrize("name", ["compact-pell", "recursion"])
def test_route_matches_jax(name):
    check_route(name)


@pytest.mark.parametrize("layout, core", [("lanes", "lane_ell_spmv"),
                                          ("rows", "lane_rows")])
def test_big_tail_routes_take_their_branches(layout, core):
    meta = {name: _route(name)[2].meta
            for name in ("compact-pell", "recursion")}
    assert meta["compact-pell"]["tail_kind"] == "compact-cuda-pell"
    assert meta["compact-pell"]["tail_meta"]["scheme"] == "fused"
    assert meta["recursion"]["tail_kind"] == "hybrid-r1"
    assert meta["recursion"]["tail_meta"]["tail_kind"] is not None
    compact = kernel_route("compact-pell", layout)
    assert compact[0] == core and "pell_fused" in compact
    assert kernel_route("recursion", layout).count(core) == 2


def test_webbase200k_big_tail_runs_compact_pell():
    """The webbase-1M stand-in at 200k rows (the reference pins this
    route, tests/test_round3_mechanisms.py:56-63): its tail passes
    BIG_TAIL, the single chips plan does not fit, so the tail runs as
    compact PELL, on the row layout by default."""
    A = synth.webbase_csr(m=200_000, seed=7)
    x = make_x(A.n)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu")
    m = prep.meta
    assert m["tail_kind"] == "compact-cuda-pell-rows", m["tail_kind"]
    assert m["tail_nnz"] > lane_ell.BIG_TAIL
    y = to_numpy(prep.fn(x))
    gold = spmv_oracle(A, x)
    assert _rel_l2(y, gold) <= VS_ORACLE_REL_L2
    validate_result(gold, y, what="port hybrid (plain) on webbase200k")


@functools.cache
def _xpose_tail(s3):
    spec, kw = cases.XPOSE_TAIL
    A = cases.make(spec)
    x = make_x(A.n)
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", xpose_s3=s3,
                                            landing="merge", **kw)
    return A, x, preps, _jax_xpose_tail()


@functools.cache
def _jax_xpose_tail():
    spec, kw = cases.XPOSE_TAIL
    return jax_prepare(cases.make(spec, jax_synth), interpret=True, **kw)


@pytest.mark.parametrize("s3", ["rows", "prefix"])
def test_xpose_tail_matches_jax(s3):
    """``tail_strategy="pallas-xpose"``: the 3,091-entry tail runs as
    ``cuda-xpose`` over its rows compacted and lands through the merge,
    as the reference's ``compact-pallas-xpose`` does, on both S3 designs
    (``xpose_s3``; S1 on ``"auto"``: the slot table on the row sums, the
    slab on the prefix S3). The hybrid's meta equals the reference's but
    for the
    tail's own (the port's XPOSE meta and bytes count its layout) and the
    route's name; y within the XPOSE bound of tests/test_torch_xpose.py
    (both tails are f32)."""
    A, x, preps, jprep = _xpose_tail(s3)
    y_jax = np.asarray(jprep.fn(x), dtype=np.float64)
    gold = spmv_oracle(A, x)
    s3_kernels = (["xpose_s1_slots", "xpose_s3_rows"] if s3 == "rows"
                  else ["xpose_mirror", "xpose_s1", "xpose_s3"])
    for layout, core in (("lanes", "lane_ell_spmv"), ("rows", "lane_rows")):
        prep = preps[layout]
        m, jm = dict(prep.meta), dict(jprep.meta)
        assert (m.pop("tail_kind"), jm.pop("tail_kind")) == (
            "compact-cuda-xpose", "compact-pallas-xpose")
        tail, jtail = m.pop("tail_meta"), jm.pop("tail_meta")
        assert m == {**jm, "landing": "merge"}
        for k in ("J1", "B2", "W1", "W3", "NWm", "fill"):
            assert tail[k] == jtail[k], k
        assert tail["s3"] == s3
        assert tail["s1"] == ("slots" if s3 == "rows" else "slab")
        y = to_numpy(prep.fn(x))
        assert _rel_l2(y, y_jax) <= VS_JAX_XPOSE_REL_L2, layout
        assert _rel_l2(y, gold) <= VS_ORACLE_REL_L2, layout
        validate_result(gold, y, what=f"port hybrid (plain, {layout}), "
                        "XPOSE tail")
        assert [k for k, _ in prep.kernel_calls(
            torch.as_tensor(x, dtype=torch.float32))] == [
                core, *s3_kernels, "window_gather"]


def test_xpose_tail_refusal_is_a_value_error(monkeypatch):
    """A tail the XPOSE planner refuses surfaces its ValueError, as the
    reference's prepare does, so "auto" can fall back."""
    monkeypatch.setattr(xpose_plan, "J1_MAX", 0)
    spec, kw = cases.XPOSE_TAIL
    with pytest.raises(ValueError, match="planning envelope"):
        lane_ell.prepare_lane_ell_hybrid(cases.make(spec), device="cpu",
                                         **kw)


def test_big_tail_constant_matches_jax():
    assert lane_ell.BIG_TAIL == jax_lane_ell.BIG_TAIL


def test_plan_chips_gives_up_only_for_big_tails():
    """Where the reference plans a split, plan_chips returns None when
    the caller routes the tail to the big-tail branch, and plans the same
    split otherwise."""
    rng = np.random.default_rng(12)
    m = n = 150_000
    rows = np.repeat(np.sort(rng.choice(m, 16, replace=False)), 8000)
    cols = rng.integers(0, n, rows.size)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order].astype(np.int64), cols[order].astype(np.int64)
    vals = rng.standard_normal(rows.size)
    want = jax_ct.plan_chips(rows, cols, vals, m, n)
    assert isinstance(want, jax_ct.SplitChipsPlan)
    assert chips_tail.plan_chips(rows, cols, vals, m, n,
                                 big_tail=True) is None
    got = chips_tail.plan_chips(rows, cols, vals, m, n)
    assert isinstance(got, chips_tail.SplitChipsPlan)
    np.testing.assert_array_equal(got.heavy_ids, want.heavy_ids)
    for k in ("loc", "far", "cold"):
        s, t = getattr(want, k), getattr(got, k)
        assert (s is None) == (t is None), k
        if s is not None:
            for f in ("kind", "p2", "l2", "vals", "rbl", "H_pad", "E8"):
                np.testing.assert_array_equal(getattr(s, f), getattr(t, f))


def test_forcechips_keeps_raising():
    """``diag="forcechips"`` keeps the split plan of webbase200k's
    184,079-entry tail past ``BIG_TAIL``: the same meta as the reference,
    y against the JAX hybrid's and the oracle (on the reference's
    landing, whose meta this pins)."""
    A = synth.webbase_csr(m=200_000, seed=7)
    jA = jax_synth.webbase_csr(m=200_000, seed=7)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu", diag="forcechips",
                                            landing="merge")
    jprep = jax_prepare(jA, interpret=True, diag="forcechips")
    assert prep.meta["tail_nnz"] > lane_ell.BIG_TAIL
    assert prep.meta["tail_meta"]["split"]
    assert _port_meta(jprep.meta, "merge") == prep.meta
    x = make_x(A.n)
    y = to_numpy(prep.fn(x))
    assert _rel_l2(y, np.asarray(jprep.fn(x), np.float64)) <= 1e-6
    validate_result(spmv_oracle(A, x), y, what="webbase200k forcechips")

"""The port's XPOSE (spmv_scpa_tpu_torch/ops/xpose_plan.py, ops/xpose.py)
against the JAX package's planner, its NumPy executor ``simulate_xpose``
(the kernels' spec, tests/test_xpose.py) and its Pallas pipeline run in
interpret mode on the CPU. Each side draws its matrix with its own
generator from the same seed (``bench.cases.XPOSE_CASES``). The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_cuda.py.

Tolerances:
* the plans (every array and scalar), rejection reasons, edge colorings
  and envelope checks against JAX: exact (the planner is a copy);
* the mirror and S1 plain versions against a NumPy recomputation of the
  stage from the JAX plan's planes: exact (they move values and take one
  f32 product per slot, as the NumPy recomputation in f32 does);
* S3's y, and the whole call's, against ``simulate_xpose`` (fp64) and
  against the JAX pipeline: rel-L2 <= 1e-5. On ``s3="prefix"`` both
  sides take f32 block prefix sums of up to 16,256 slots and difference
  them per row, in different orders. Measured on the CPU: 2.7e-7 to
  1.0e-6 against ``simulate_xpose`` (the most on webbase200k), 3.5e-7 to
  4.4e-7 against the JAX pipeline (rand-1k 3.8e-7); the row sums
  (``s3="rows"``, the default) add each row's own products, 5.2e-8 to
  7.7e-8 against ``simulate_xpose``;
* against ``spmv_oracle``: ``validate_result``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import xpose_plan as jax_xp
from spmv_scpa_tpu.ops.xpose import prepare_xpose as jax_prepare_xpose

from spmv_scpa_tpu_torch import get_strategy, spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import xpose, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_SIM_REL_L2 = 1e-5
VS_JAX_REL_L2 = 1e-5

CASES = sorted(cases.XPOSE_CASES)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.cache
def _case(name):
    """(port matrix, port plan, JAX matrix, JAX plan) of a case."""
    spec = cases.XPOSE_CASES[name]
    A, Aj = cases.make(spec), cases.make(spec, jax_synth)
    return A, xpose_plan.plan_xpose(A), Aj, jax_xp.plan_xpose(Aj)


# ---- the planner --------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plan_matches_jax(name):
    _, plan, _, want = _case(name)
    assert plan is not None and want is not None
    for f in dataclasses.fields(want):
        a, b = getattr(plan, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert plan.plan_bytes == want.plan_bytes


def test_cases_cover_the_plan_shapes():
    """Mirror windows everywhere, virtual rows, and one plan with two S1
    output windows (W1 = 2)."""
    plans = {name: _case(name)[1] for name in CASES}
    assert all(p.NWm >= 1 for p in plans.values())
    assert plans["webbase30k"].m2 > plans["webbase30k"].m
    assert plans["webbase200k"].W1 == 2
    assert {p.W1 for n, p in plans.items() if n != "webbase200k"} == {1}


@pytest.mark.parametrize("knob, value, name", [
    ("J1_MAX", 4, "rand-8k"), ("B2_MAX", 50, "rand-8k"),
    ("X_EXT_BUDGET", 1 << 17, "webbase30k"), (None, None, "empty")])
def test_rejections_match_jax(monkeypatch, knob, value, name):
    """The planner refuses where the reference does, with its reason."""
    if knob:
        monkeypatch.setattr(xpose_plan, knob, value)
        monkeypatch.setattr(jax_xp, knob, value)
        spec = cases.XPOSE_CASES[name]
        A, Aj = cases.make(spec), cases.make(spec, jax_synth)
    else:
        none = (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
        A, Aj = CSR.from_coo("e", 50, 50, *none), \
            JaxCSR.from_coo("e", 50, 50, *none)
    assert xpose_plan.plan_xpose(A) is None
    assert jax_xp.plan_xpose(Aj) is None
    assert xpose_plan.REJECT_REASON == jax_xp.REJECT_REASON
    with pytest.raises(ValueError, match="planning envelope"):
        xpose.prepare_xpose(A, device="cpu")


def test_the_reference_nnz_cap_rejects():
    """tests/test_xpose.py:75-87's >4M-entry banded matrix: the planner
    runs until its step count passes J1_MAX (about 4 s)."""
    A = synth.banded_csr(640_000, row_nnz=7, bandwidth=64, seed=9)
    assert not xpose_plan.quick_envelope_ok(A)
    assert xpose_plan.plan_xpose(A) is None
    Aj = jax_synth.banded_csr(640_000, row_nnz=7, bandwidth=64, seed=9)
    assert jax_xp.plan_xpose(Aj) is None
    assert xpose_plan.REJECT_REASON == jax_xp.REJECT_REASON


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_color_matches_jax(seed):
    """The random bipartite graph of tests/test_xpose.py:28-38."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, 5000)
    b = rng.integers(0, 60, 5000)
    deg = int(max(np.bincount(a).max(), np.bincount(b).max()))
    c = xpose_plan.edge_color(a, b, deg, seed=seed)
    np.testing.assert_array_equal(c, jax_xp.edge_color(a, b, deg,
                                                       seed=seed))
    assert (c >= 0).all()
    assert np.unique(a * 1000000 + c).size == c.size
    assert np.unique(b * 1000000 + c).size == c.size


@pytest.mark.parametrize("name", CASES)
def test_quick_envelope_ok_matches_jax(name):
    A, _, Aj, _ = _case(name)
    assert xpose_plan.quick_envelope_ok(A) is True
    assert jax_xp.quick_envelope_ok(Aj) is True
    for k in ("BC", "CCAP", "BLK_CAP", "ROWS_PER_BLK", "J1_MAX", "B2_MAX",
              "MIR_TJ", "SPLIT_CAP", "HEAVY", "KEEP_MIN", "MIR_MAX",
              "X_EXT_BUDGET"):
        assert getattr(xpose_plan, k) == getattr(jax_xp, k), k


# ---- each kernel's plain version against the stage it replaces ----------------

def _np_x_ext(p, x):
    """simulate_xpose's x_ext, in f32 (its lines 752-759)."""
    xp = np.zeros(p.NR * BC, np.float32)
    xp[:p.n] = x
    xr = xp.reshape(p.NR, BC)
    parts = [xr]
    for w in range(p.NWm):
        sw = p.msw[w * 4 + p.mir_sel[w].astype(np.int64)]
        parts.append(xr[sw * BC + p.mir_sub[w].astype(np.int64)])
    return np.concatenate(parts, axis=0)


def _np_mid(p, x_ext):
    """simulate_xpose's S1 and S2 in f32 (its lines 761-777): mid (K1p,
    J1, 128)."""
    prod = np.zeros((p.J1, p.K1p, BC), np.float32)
    for s in range(p.J1):
        w0 = int(p.win_of_step[s]) * BC
        xw = x_ext[w0:w0 + BC, :]
        g = np.take_along_axis(
            xw, p.gidx[s * BC:(s + 1) * BC].astype(np.int64), axis=1)
        slab = g * p.asv[s * BC:(s + 1) * BC]
        slab[:, xpose_plan.CCAP] = 0.0
        for w1 in range(p.W1):
            rows = slice((s * p.W1 + w1) * BC, (s * p.W1 + w1 + 1) * BC)
            t2 = np.take_along_axis(slab, p.r2[rows].astype(np.int64), 0)
            out = np.take_along_axis(t2, p.r3[rows].astype(np.int64), 1)
            hi = min(p.K1p, (w1 + 1) * BC)
            prod[s, w1 * BC:hi] = out[:hi - w1 * BC]
    return np.swapaxes(prod, 0, 1)


def _np_y(p, mid):
    """simulate_xpose's S3 and the virtual-row sums in fp64 (its lines
    778-807), from a given mid."""
    y = np.zeros(p.m2, np.float64)
    for b in range(p.B2):
        v = mid[b].astype(np.float64)
        s32 = p.sub[b * BC:(b + 1) * BC].astype(np.int64)
        t2 = np.take_along_axis(v, s32, axis=0)
        fin = np.take_along_axis(
            t2, p.r3b[b * BC:(b + 1) * BC].astype(np.int64), axis=1)
        psum = np.cumsum(fin, axis=1)
        cpre = np.r_[0.0, np.cumsum(psum[:, xpose_plan.CCAP])[:-1]]
        psg = psum + cpre[:, None]

        def _pass(rpre, ys, r3y):
            h = np.take_along_axis(
                psg, rpre[b * BC:(b + 1) * BC].astype(np.int64), axis=1)
            t = np.take_along_axis(
                h, ys[b * BC:(b + 1) * BC].astype(np.int64), axis=0)
            r3 = r3y[b * BC:(b + 1) * BC].astype(np.int64)
            g = np.take_along_axis(t, np.minimum(r3, BC - 1), axis=1)
            return np.where(r3 < BC, g, 0.0)

        st = (_pass(p.rpre1, p.ys1, p.r3y1)
              - _pass(p.rpre2, p.ys2, p.r3y2))[:64].reshape(-1)
        rows = b + np.arange(st.size) * p.B2
        keep = rows < p.m2
        y[rows[keep]] = st[keep]
    yr = y[:p.m].copy()
    np.add.at(yr, p.v_row, y[p.m:])
    return yr


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


@functools.cache
def _stages(name):
    """(x f32, the port's mirror and mid, NumPy's x_ext and mid)."""
    A, plan, _, want = _case(name)
    x = make_x(A.n).astype(np.float32)
    xf = _t(x)
    xm = xpose.xpose_mirror(xf, _t(plan.msw[:plan.NWm * 4]),
                            _t(plan.mir_sel[:plan.NWm]),
                            _t(plan.mir_sub[:plan.NWm]))
    mid = xpose.xpose_s1(
        xf, xm, _t(plan.win_of_step), _t(plan.gidx), _t(plan.asv),
        _t(xpose.compact_routes(plan, plan.r2)),
        _t(xpose.compact_routes(plan, plan.r3)), plan.NR // BC, plan.B2)
    x_ext = _np_x_ext(want, x)
    return x, xm, mid, x_ext, _np_mid(want, x_ext)


@pytest.mark.parametrize("name", CASES)
def test_mirror_plain_matches_the_stage(name):
    _, plan, _, _ = _case(name)
    _, xm, _, x_ext, _ = _stages(name)
    assert xm.shape == (plan.NWm * BC, BC)
    np.testing.assert_array_equal(xm.numpy(), x_ext[plan.NR:])


@pytest.mark.parametrize("name", CASES)
def test_s1_plain_matches_the_stage(name):
    """S1 with S2 folded in: mid equals the stage's products moved to
    (k, s, :), out-blocks past B2 (all zero there) dropped."""
    _, plan, _, _ = _case(name)
    _, _, mid, _, want = _stages(name)
    assert mid.shape == (plan.B2, plan.J1, BC)
    np.testing.assert_array_equal(mid.numpy(), want[:plan.B2])
    assert not want[plan.B2:].any()
    assert not mid[:, :, xpose_plan.CCAP].any()


@pytest.mark.parametrize("name", CASES)
def test_s3_plain_matches_simulate(name):
    """S3 (with the virtual-row sums) against simulate_xpose's S3 on the
    same products, and the three stages against simulate_xpose itself."""
    _, plan, _, want = _case(name)
    x, _, mid, _, _ = _stages(name)
    y_all = xpose.xpose_s3(mid, _t(xpose.s3_planes(plan)), plan.m2)
    assert y_all.shape == (plan.m2,)
    y = y_all[:plan.m].clone()
    y.index_add_(0, _t(plan.v_row, torch.int64), y_all[plan.m:])
    y = y.double().numpy()
    assert _rel_l2(y, _np_y(want, mid.numpy())) <= VS_SIM_REL_L2
    assert _rel_l2(y, jax_xp.simulate_xpose(want, x.astype(np.float64))) \
        <= VS_SIM_REL_L2


def test_s3_scan_follows_the_kernels_steps():
    """The plain prefix is the kernel's Hillis-Steele steps: on values
    where the order matters it differs from a sequential sum, and it
    equals the same steps written out in NumPy."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((2, BC, BC)) * 10.0 ** rng.integers(
        -3, 4, (2, BC, BC))).astype(np.float32)
    got = xpose._scan(torch.as_tensor(v)).numpy()
    p = v.copy()
    d = 1
    while d < BC:
        q = p.copy()
        q[..., d:] = p[..., d:] + p[..., :-d]
        p, d = q, 2 * d
    np.testing.assert_array_equal(got, p)
    assert not np.array_equal(got, np.cumsum(v, axis=-1, dtype=np.float32))


# ---- argument checks of the wrappers ------------------------------------------

def test_wrappers_refuse_bad_arguments():
    _, plan, _, _ = _case("rand-1k")
    x = torch.zeros(plan.n)
    msw, sel, sub = (_t(plan.msw[:plan.NWm * 4]), _t(plan.mir_sel[:1]),
                     _t(plan.mir_sub[:1]))
    with pytest.raises(ValueError, match="x is"):
        xpose.xpose_mirror(x.double(), msw, sel, sub)
    with pytest.raises(ValueError, match="mir_sel is"):
        xpose.xpose_mirror(x, msw, sel.to(torch.int32), sub)
    with pytest.raises(ValueError, match="msw is"):
        xpose.xpose_mirror(x, msw[:2], sel, sub)
    args = [x, torch.zeros(0, BC), _t(plan.win_of_step), _t(plan.gidx),
            _t(plan.asv), _t(xpose.compact_routes(plan, plan.r2)),
            _t(xpose.compact_routes(plan, plan.r3)), plan.NR // BC, plan.B2]
    bad = list(args)
    bad[5] = _t(plan.r2)                    # the plan's padded rows
    with pytest.raises(ValueError, match="r2 is"):
        xpose.xpose_s1(*bad)
    bad = list(args)
    bad[4] = bad[4].t()
    with pytest.raises(ValueError, match="asv is"):
        xpose.xpose_s1(*bad)
    with pytest.raises(ValueError, match="do not cover x"):
        xpose.xpose_s1(*args[:7], 0, plan.B2)
    mid = xpose.xpose_s1(*args)
    planes = _t(xpose.s3_planes(plan))
    with pytest.raises(ValueError, match="planes is"):
        xpose.xpose_s3(mid, planes[:7], plan.m2)
    with pytest.raises(ValueError, match="do not fit"):
        xpose.xpose_s3(mid, planes, plan.B2 * 64 * BC + 1)
    with pytest.raises(ValueError, match="mid is"):
        xpose.xpose_s3(mid.double(), planes, plan.m2)


# ---- the slice as a whole ------------------------------------------------------

# the default S1 design ("auto"): the slot table on the row sums, the
# slab on the prefix S3
S3_CALLS = {"rows": ["xpose_s1_slots", "xpose_s3_rows"],
            "prefix": ["xpose_mirror", "xpose_s1", "xpose_s3"]}


@pytest.mark.parametrize("s3", xpose.S3_DESIGNS)
@pytest.mark.parametrize("name", CASES)
def test_cuda_xpose_matches_simulate_and_oracle(name, s3):
    A, plan, _, want = _case(name)
    x = make_x(A.n)
    prep = get_strategy("cuda-xpose").prepare(A, device="cpu", s3=s3)
    assert (prep.strategy, prep.ref) == ("cuda-xpose", "pallas-xpose")
    y = to_numpy(prep.fn(x))
    assert y.shape == (A.m,)
    assert _rel_l2(y, jax_xp.simulate_xpose(want, x)) <= VS_SIM_REL_L2
    validate_result(spmv_oracle(A, x), y, what=f"cuda-xpose on {name}")
    assert [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))] == S3_CALLS[s3]
    m = prep.meta
    assert m["s3"] == s3
    assert m["s1"] == ("slots" if s3 == "rows" else "slab")
    assert (m["J1"], m["B2"], m["W1"], m["W3"], m["NWm"]) == (
        plan.J1, plan.B2, plan.W1, plan.W3, plan.NWm)
    assert m["tpu_knobs"]["K1p"] == plan.K1p


@functools.cache
def _jax_interpret(name):
    A, _, Aj, _ = _case(name)
    x = make_x(A.n)
    jprep = jax_prepare_xpose(Aj, interpret=True)
    return x, jprep, np.asarray(jprep.fn(x), dtype=np.float64)


def _check_against_jax(name, s3="rows"):
    A, _, _, _ = _case(name)
    x, jprep, y_jax = _jax_interpret(name)
    prep = xpose.prepare_xpose(A, device="cpu", s3=s3)
    y = to_numpy(prep.fn(x))
    assert _rel_l2(y, y_jax) <= VS_JAX_REL_L2
    validate_result(spmv_oracle(A, x), y, what=f"cuda-xpose on {name}")
    for k in ("J1", "B2", "W1", "W3", "NWm", "fill"):
        assert prep.meta[k] == jprep.meta[k], k


@pytest.mark.parametrize("s3", xpose.S3_DESIGNS)
def test_cuda_xpose_matches_the_jax_pipeline(s3):
    """rand-1k against the JAX package's Pallas pipeline in interpret
    mode (about 7 s on the CPU, once for both designs)."""
    _check_against_jax("rand-1k", s3)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["banded-2k", "rand-8k"])
def test_cuda_xpose_matches_the_jax_pipeline_slow(name):
    """The other two matrices of tests/test_xpose.py's _cases()."""
    _check_against_jax(name)


def test_auto_picks_cuda_xpose_and_matches_the_direct_call():
    A = cases.make(cases.XPOSE_CASES["webbase30k"])
    x = make_x(A.n)
    y = spmv(A, x, device="cpu")
    np.testing.assert_array_equal(y, spmv(A, x, "cuda-xpose", device="cpu"))
    validate_result(spmv_oracle(A, x), y, what="auto on webbase30k")


@pytest.mark.parametrize("s3", xpose.S3_DESIGNS)
def test_hbm_bytes_counts_the_port_layout(s3):
    """S1 on the slab: planes (S1's used route rows only), the product
    array written, the mirror table twice, x, and S3's input and y: on
    "prefix" the product array read whole, the eight planes and y with
    its virtual rows, below the plan's padded planes plus the reference's
    S2 and staging traffic; on "rows" the table (a pointer a row, a
    position a product), the occupied products and y. (S1 on the slot
    table: tests/test_torch_xpose_s1.py.)"""
    _, plan, _, _ = _case("webbase200k")
    got = xpose.hbm_bytes(plan, s3, "slab")
    used_routes = 2 * plan.J1 * plan.B2 * BC
    assert used_routes < plan.r2.nbytes + plan.r3.nbytes
    shared = (plan.gidx.nbytes + plan.asv.nbytes + used_routes
              + plan.NWm * (16 + 2 * BC) + 2 * plan.NWm * BC * BC * 4
              + plan.B2 * plan.J1 * BC * 4 + 4 * plan.n)
    if s3 == "prefix":
        assert got == (shared + plan.B2 * plan.J1 * BC * 4
                       + xpose.s3_planes(plan).nbytes + 4 * plan.m2)
    else:
        rowptr, pos = xpose.s3_rows_table(plan)
        assert got == shared + rowptr.nbytes + 2 * pos.nbytes + 4 * plan.m
        assert got < xpose.hbm_bytes(plan, "prefix", "slab")

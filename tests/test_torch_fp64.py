"""The port's fp64 grade (spmv_scpa_tpu_torch/ops/lane_ell_fp64.py,
``cuda-hybrid-fp64``; ops/pell.py's ``plan_pell_fp64`` and
``pell_fused_fp64``, ``cuda-pell-fp64``; ops/torch_ops.py's
``make_ell_fp64``, ``torch-ell-fp64``) against the JAX package's
``pallas-hybrid-df64``, ``pallas-pell-df64`` (run in interpret mode on
the CPU, as tests/test_lane_ell.py and tests/test_kernels.py run them)
and ``xla-ell-df64``, and against the fp64 oracle. Each side builds its
matrix with its own generator from the same seed. The CUDA kernels
themselves are held against their plain versions in
tests/test_torch_cuda.py.

Tolerances:
* host plans against JAX: exact. The port's float64 value plane ``v``
  gives the reference's ``vh == v.astype(f32)`` and ``vl == (v -
  vh).astype(f32)`` bit for bit; ``lcol`` is compared by value (the
  reference keeps it int32 in interpret mode, int8 on the TPU);
* y against ``spmv_oracle`` (fp64): relative L2 <= 1e-9, computed
  directly (``validate_result``'s absolute gate, 0.1 at ||y|| >= 1,
  would pass an f32-grade y), and against the JAX y: <= 1e-11. The port
  adds each row's products in float64; the JAX digit planes are exact to
  about 2^-56 of their scale, so both sit near 1e-16 on these cases.
"""

import functools
import types

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_df64 as jax_df64
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import get_strategy, spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import lane_ell_fp64, pell, segsum_kernel
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_ORACLE = 1e-9
VS_JAX = 1e-11


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def _wide(s):
    """tests/test_lane_ell.py:315-332: values spanning 12 decades."""
    A = s.banded_csr(3000, row_nnz=24, bandwidth=256, seed=5)
    rng = np.random.default_rng(5)
    return type(A)(A.name + "_wide", A.m, A.n, A.irp, A.ja,
                   A.as_ * 10.0 ** rng.uniform(-6, 6, A.nnz))


# name -> matrix drawn by either package's generators (``s``); the
# stencil, banded and wide-exponent matrices of tests/test_lane_ell.py and
# the four archetypes of tests/test_kernels.py:299-302
MATRICES = {
    "stencil2k": lambda s: s.stencil_csr(2000, points=6, run_len=8,
                                         bandwidth=300, seed=6),
    "banded-runs": lambda s: s.banded_csr(512, row_nnz=12, bandwidth=96,
                                          runs=3, seed=7),
    "wide": _wide,
    "tiny": lambda s: s.banded_csr(16, row_nnz=3, bandwidth=4, seed=8),
    "diag": lambda s: s.diag_csr(37),
    "banded512": lambda s: s.banded_csr(512, row_nnz=9, bandwidth=64,
                                        seed=3),
    "powerlaw400": lambda s: s.powerlaw_csr(400, 400, seed=4),
    "random": lambda s: s.random_csr(200, 300, density=0.02, seed=3),
}


def _pair(name):
    """(port CSR, JAX CSR) of one case, the same draws."""
    A, Aj = MATRICES[name](synth), MATRICES[name](jax_synth)
    np.testing.assert_array_equal(A.ja, Aj.ja)
    np.testing.assert_array_equal(A.as_, Aj.as_)
    return A, Aj


def _empty_pair():
    z = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    return (CSR.from_coo("empty", 64, 64, *z),
            JaxCSR.from_coo("empty", 64, 64, *z))


def _split(v):
    """The reference's host split of float64 values into f32 hi/lo."""
    vh = v.astype(np.float32)
    return vh, (v - vh.astype(np.float64)).astype(np.float32)


def _closure_value(fn, fname: str, var: str, seen=None):
    """The value of free variable ``var`` of the nested function named
    ``fname`` reachable from ``fn`` through closures, ``functools.partial``
    and ``__wrapped__`` (the reference keeps the lane-ELL plane strip
    sets only in its kernel's closure)."""
    seen = set() if seen is None else seen
    if id(fn) in seen:
        return None
    seen.add(id(fn))
    if isinstance(fn, functools.partial):
        inner = [fn.func, *fn.args, *fn.keywords.values()]
    elif isinstance(fn, types.FunctionType):
        code = fn.__code__
        if code.co_name == fname and var in code.co_freevars:
            return fn.__closure__[code.co_freevars.index(var)].cell_contents
        inner = []
        for cell in fn.__closure__ or ():
            try:
                inner.append(cell.cell_contents)
            except ValueError:
                continue
    else:
        inner = [getattr(fn, "__wrapped__", None)]
    for obj in inner:
        if callable(obj):
            found = _closure_value(obj, fname, var, seen)
            if found is not None:
                return found
    return None


# ---- the lane-ELL fp64 plan ------------------------------------------------

HYBRID_CASES = ["stencil2k", "banded-runs", "wide", "tiny", "diag",
                "powerlaw400"]


@pytest.mark.parametrize("name", HYBRID_CASES + ["empty"])
def test_hybrid_plan_matches_jax(name):
    A, Aj = _empty_pair() if name == "empty" else _pair(name)
    plan = lane_ell_fp64.pack_lane_ell_fp64(A)
    jprep = jax_df64(Aj, interpret=True)
    vh, vl, idx = (np.asarray(a) for a in jprep.args)
    want_h, want_l = _split(plan.vals)
    assert plan.vals.dtype == np.float64
    np.testing.assert_array_equal(want_h, vh)
    np.testing.assert_array_equal(want_l, vl)
    assert plan.idx.dtype == idx.dtype == np.int16
    np.testing.assert_array_equal(plan.idx, idx)
    used = _closure_value(jprep.raw, "kernel", "used")
    assert used is not None and plan.used == used
    want = {k: v for k, v in jprep.meta.items() if k != "planes"}
    assert plan.meta == {**want, "rtol": VS_ORACLE}
    prep = lane_ell_fp64.prepare_lane_ell_fp64(A, device="cpu")
    cfg = plan.cfg
    assert prep.hbm_bytes == plan.vals.size * 10 + 8 * cfg.P_pad * BC \
        + 8 * A.m
    assert prep.ref == "pallas-hybrid-df64" == jprep.strategy


def test_hybrid_value_plane_keeps_the_original_fp64_values():
    """The device plane is the original value at each slot, never vh +
    vl (which loses bits past the 48 the pair carries)."""
    A = MATRICES["wide"](synth)
    plan = lane_ell_fp64.pack_lane_ell_fp64(A)
    live = plan.vals != 0
    assert np.array_equal(np.sort(plan.vals[live]), np.sort(A.as_))
    vh, vl = _split(plan.vals)
    assert not np.array_equal(vh.astype(np.float64) + vl, plan.vals)


def test_hybrid_refusals_match_jax(monkeypatch):
    """Out of the window (tests/test_lane_ell.py:345-351), a mega row
    (:354-360), and the reference's resident x-pair budget."""
    A, Aj = (synth.powerlaw_csr(4000, 4000, seed=7),
             jax_synth.powerlaw_csr(4000, 4000, seed=7))
    for prep, M in ((lane_ell_fp64.pack_lane_ell_fp64, A),
                    (functools.partial(jax_df64, interpret=True), Aj)):
        with pytest.raises(ValueError, match="pell-df64"):
            prep(M, loc_w=128)
    coo = (np.zeros(200, np.int64), np.arange(200, dtype=np.int64),
           np.ones(200))
    with pytest.raises(ValueError, match="128 slot"):
        lane_ell_fp64.pack_lane_ell_fp64(CSR.from_coo("mega", 256, 256,
                                                      *coo))
    with pytest.raises(ValueError, match="128 slot"):
        jax_df64(JaxCSR.from_coo("mega", 256, 256, *coo), interpret=True)
    monkeypatch.setattr(lane_ell_fp64, "X_VMEM_BUDGET", 4096)
    with pytest.raises(ValueError, match="x pair"):
        lane_ell_fp64.prepare_lane_ell_fp64(MATRICES["tiny"](synth),
                                            device="cpu")


def test_hybrid_empty_and_tiny():
    """tests/test_lane_ell.py:363-375."""
    A, _ = _empty_pair()
    y = get_strategy("cuda-hybrid-fp64").prepare(A, device="cpu").fn(
        make_x(A.n))
    assert y.dtype == torch.float64 and bool((y == 0).all())
    B = MATRICES["tiny"](synth)
    x = make_x(B.n)
    assert _rel(spmv(B, x, "cuda-hybrid-fp64", device="cpu"),
                spmv_oracle(B, x)) <= VS_ORACLE


def _jax_vs_port(name, jax_name, port_name):
    A, Aj = _pair(name)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    y = spmv(A, x, port_name, device="cpu")
    y_jax = np.asarray(jax_strategy(jax_name).prepare(Aj, interpret=True)
                       .fn(x), np.float64)
    assert _rel(y, gold) <= VS_ORACLE
    assert _rel(y_jax, gold) <= VS_ORACLE
    assert _rel(y, y_jax) <= VS_JAX
    validate_result(gold, y, rtol=VS_ORACLE, abs_l2=0.0,
                    what=f"{port_name} on {name}")


@pytest.mark.parametrize("name", [
    "tiny", pytest.param("stencil2k", marks=pytest.mark.slow),
    pytest.param("wide", marks=pytest.mark.slow)])
def test_hybrid_y_matches_jax_and_oracle(name):
    _jax_vs_port(name, "pallas-hybrid-df64", "cuda-hybrid-fp64")


def test_hybrid_wide_exponents_need_fp64():
    """Where f32 misses the gate by orders of magnitude, the fp64 grade
    meets it (tests/test_lane_ell.py:315-332)."""
    A = MATRICES["wide"](synth)
    rng = np.random.default_rng(5)
    rng.uniform(-6, 6, A.nnz)                  # the values' draw
    x = make_x(A.n) * 10.0 ** rng.uniform(-3, 3, A.n)
    gold = spmv_oracle(A, x)
    rel64 = _rel(spmv(A, x, "cuda-hybrid-fp64", device="cpu"), gold)
    rel32 = _rel(spmv(A, x, "cuda-hybrid", device="cpu"), gold)
    assert rel64 <= VS_ORACLE and rel32 > 10 * rel64


def test_lane_ell_fp64_wrapper_on_cpu_tensors():
    A = MATRICES["stencil2k"](synth)
    prep = lane_ell_fp64.prepare_lane_ell_fp64(A, device="cpu")
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float64)
    (name, args), = prep.kernel_calls(xd)
    assert name == "lane_ell_fp64"
    before = lane_ell_fp64.KERNEL_LAUNCHES
    y = lane_ell_fp64.lane_ell_fp64(*args)
    assert lane_ell_fp64.KERNEL_LAUNCHES == before
    assert y.dtype == torch.float64 and y.shape == (args[-1].G_pad * BC,)
    assert torch.equal(y, lane_ell_fp64.lane_ell_fp64_plain(*args))
    assert torch.equal(y[:A.m], prep.fn(xd))
    xpad, vals, idx, cfg = args
    for bad, what in (((xpad.float(), vals, idx, cfg), "xpad"),
                      ((xpad, vals[:-1], idx, cfg), "vals"),
                      ((xpad, vals, idx.int(), cfg), "idx"),
                      ((xpad, vals.t().contiguous().t(), idx, cfg),
                       "contiguous")):
        with pytest.raises(ValueError, match=what):
            lane_ell_fp64.lane_ell_fp64(*bad)
    with pytest.raises(ValueError, match="x has shape"):
        prep.fn(np.ones(A.n + 1))


# ---- the fused PELL fp64 plan ----------------------------------------------

PELL_CASES = ["diag", "banded512", "powerlaw400", "random", "stencil2k",
              "wide", "tiny"]


@pytest.mark.parametrize("name", PELL_CASES + ["empty"])
def test_pell_plan_matches_jax(name):
    A, Aj = _empty_pair() if name == "empty" else _pair(name)
    plan = pell.plan_pell_fp64(A)
    jprep = jax_strategy("pallas-pell-df64").prepare(Aj, interpret=True)
    base, pan2, rbl2, mask, vh, vl, lcol = (np.asarray(a)
                                            for a in jprep.args)
    np.testing.assert_array_equal(plan.base, base)
    np.testing.assert_array_equal(plan.pan2, pan2)
    np.testing.assert_array_equal(plan.rbl, rbl2)
    assert plan.span == mask.shape[0]
    np.testing.assert_array_equal(
        segsum_kernel.make_visit_masks(plan.base, plan.num_win, plan.span,
                                       plan.h), mask[:, :, 0])
    want_h, want_l = _split(plan.vals)
    assert plan.vals.dtype == np.float64
    np.testing.assert_array_equal(want_h, vh)
    np.testing.assert_array_equal(want_l, vl)
    np.testing.assert_array_equal(plan.idx.astype(np.int32), lcol)
    assert plan.idx.dtype == np.int8 and plan.kind == "fused"
    want = {k: v for k, v in jprep.meta.items() if k != "planes"}
    prep = pell.prepare_pell_fp64(A, device="cpu", layout="tiles")
    assert prep.meta == want
    assert prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == "pallas-pell-df64" == jprep.strategy


def test_pell_refusals_match_jax():
    """The reference's 2^24 digit-sum guard on the longest row and its
    x-pair budget, each a ValueError on both sides."""
    jprep = functools.partial(jax_strategy("pallas-pell-df64").prepare,
                              interpret=True)
    # one row of 69,000 entries: (69,000 + quantum) * 130 * 2 >= 2^24
    long_row = (8, 70_000, np.zeros(69_000, np.int64), np.arange(69_000),
                np.ones(69_000))
    with pytest.raises(ValueError, match="2\\^24"):
        pell.prepare_pell_fp64(CSR.from_coo("long", *long_row),
                               device="cpu", layout="tiles")
    with pytest.raises(ValueError, match="2\\^24"):
        jprep(JaxCSR.from_coo("long", *long_row))
    # 1.6M columns: the hi/lo x pair takes 12.8 MB > X_VMEM_BUDGET
    wide = (64, 1_600_000, np.arange(64), np.arange(64) * 25_000,
            np.ones(64))
    with pytest.raises(ValueError, match="x pair"):
        pell.prepare_pell_fp64(CSR.from_coo("w", *wide), device="cpu",
                               layout="tiles")
    with pytest.raises(ValueError, match="x pair"):
        jprep(JaxCSR.from_coo("w", *wide))


def test_pell_plan_refuses_a_step_past_shared_memory(monkeypatch):
    """chunk 256 at quantum 8: a step's float64 partials take 256 KB,
    past the 227 KB of an H100 block; the plan refuses before packing,
    and the largest chunk that fits plans as the reference's."""
    W = synth.webbase_csr(6000, seed=7)
    assert pell.auto_pell_params(W, quantum=8, panel_w=1, row_sort=False,
                                 chunk=256)["chunk"] == 256
    with monkeypatch.context() as mp:
        mp.setattr(pell, "csr_to_pell", None)            # never reached
        with pytest.raises(ValueError, match="shared memory"):
            pell.plan_pell_fp64(W, chunk=256, quantum=8)
    A, Aj = _pair("banded512")
    assert pell.fused_smem(256, 16, 8) > pell.SMEM_MAX \
        >= pell.fused_smem(128, 16, 8) == pell.fused_smem(256, 16, 4)
    plan = pell.plan_pell_fp64(A, chunk=128, quantum=8)
    jprep = jax_strategy("pallas-pell-df64").prepare(Aj, chunk=128,
                                                     quantum=8,
                                                     interpret=True)
    np.testing.assert_array_equal(plan.rbl, np.asarray(jprep.args[2]))
    assert plan.dtype == torch.float64 and plan.chunk == 128


@pytest.mark.parametrize("name", [
    "diag", "powerlaw400",
    pytest.param("banded512", marks=pytest.mark.slow),
    pytest.param("random", marks=pytest.mark.slow),
    pytest.param("wide", marks=pytest.mark.slow)])
def test_pell_y_matches_jax_and_oracle(name):
    _jax_vs_port(name, "pallas-pell-df64", "cuda-pell-fp64")


def test_pell_fp64_wrapper_on_cpu_tensors():
    A = MATRICES["powerlaw400"](synth)
    prep = pell.prepare_pell_fp64(A, device="cpu", layout="tiles")
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float64)
    (name, args), = prep.kernel_calls(xd)
    assert name == "pell_fused_fp64"
    before = dict(pell.LAUNCHES)
    y = pell.pell_fused_fp64(*args)
    assert pell.LAUNCHES == before and y.dtype == torch.float64
    assert torch.equal(y, pell.pell_fused_plain(*args))
    vals, idx, pan, x, rbl, base, cfg, lists = args
    with pytest.raises(ValueError, match="vals"):
        pell.pell_fused_fp64(vals.float(), idx, pan, x, rbl, base, cfg,
                             lists)
    with pytest.raises(ValueError, match="x is torch.float32"):
        pell.pell_fused_fp64(vals, idx, pan, x.float(), rbl, base, cfg,
                             lists)
    with pytest.raises(ValueError, match="vals"):    # the f32 kernel's
        pell.pell_fused(vals, idx, pan, x, rbl, base, cfg, lists)
    # the f32 and fp64 plain versions share one order: on values exact in
    # f32 they agree
    v32 = vals.float().round()
    assert torch.equal(pell.pell_fused_plain(v32, idx, pan, x.float().round(),
                                             rbl, base, cfg),
                       pell.pell_fused_plain(v32.double(), idx, pan,
                                             x.round(), rbl, base,
                                             cfg).float())


# ---- the strategies on the zoo, and the ELL fp64 baseline ------------------

ZOO_SIZE = 7        # tests/conftest.py: matrices()


@pytest.mark.parametrize("index", range(ZOO_SIZE))
@pytest.mark.parametrize("strategy", ["cuda-hybrid-fp64", "cuda-pell-fp64",
                                      "torch-ell-fp64"])
def test_fp64_strategies_match_oracle_on_zoo(matrices, strategy, index):
    Aj = matrices[index]
    A = CSR(Aj.name, Aj.m, Aj.n, Aj.irp, Aj.ja, Aj.as_)
    x = make_x(A.n)
    prep = get_strategy(strategy).prepare(A, device="cpu")
    y = prep.fn(x)
    assert y.dtype == torch.float64 and y.shape == (A.m,)
    assert prep.meta["rtol"] == VS_ORACLE
    validate_result(spmv_oracle(A, x), to_numpy(y), rtol=VS_ORACLE,
                    abs_l2=0.0, what=f"{strategy} on {A.name}")


def test_ell_fp64_matches_jax_df64():
    """tests/test_kernels.py:209-220's case through ``xla-ell-df64`` and
    ``torch-ell-fp64``: y, meta and bytes."""
    A = synth.banded_csr(300, row_nnz=13, bandwidth=64, runs=3, seed=21)
    Aj = jax_synth.banded_csr(300, row_nnz=13, bandwidth=64, runs=3,
                              seed=21)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    prep = get_strategy("torch-ell-fp64").prepare(A, device="cpu")
    jprep = jax_strategy("xla-ell-df64").prepare(Aj)
    y, y_jax = to_numpy(prep.fn(x)), np.asarray(jprep.fn(x), np.float64)
    assert _rel(y, gold) <= VS_ORACLE and _rel(y, y_jax) <= VS_JAX
    assert prep.meta == jprep.meta and prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == jprep.strategy == "xla-ell-df64"


def test_ell_fp64_refuses_explosive_padding():
    A = synth.powerlaw_csr(4000, 4000, seed=5)
    with pytest.raises(ValueError, match="df64 path unavailable"):
        get_strategy("torch-ell-fp64").prepare(A, device="cpu",
                                               max_padded=1 << 16)
    with pytest.raises(ValueError, match="df64 path unavailable"):
        jax_strategy("xla-ell-df64").prepare(
            jax_synth.powerlaw_csr(4000, 4000, seed=5), max_padded=1 << 16)


@pytest.mark.parametrize("name", sorted(cases.FP64_CASES))
def test_fp64_cases_on_cpu(name):
    """``bench/cases.py``'s small fp64 cases, which ``chip_smoke.py``
    runs on the card: the plain versions against the oracle."""
    make, strategy, kw = cases.FP64_CASES[name]
    A = make()
    x = make_x(A.n)
    y = spmv(A, x, strategy, device="cpu", **kw)
    assert _rel(y, spmv_oracle(A, x)) <= VS_ORACLE

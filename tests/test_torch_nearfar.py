"""The port's near/far composition (spmv_scpa_tpu_torch/ops/nearfar.py,
``cuda-nearfar``) against the JAX package's ``ops/nearfar.py``: the split
and the window choice exactly, the delegation decisions, and y against
the port's own two parts and ``spmv_oracle``. Each side draws its matrix
with its own generator from the same seed.

Tolerances: the split, the window and the decisions, exact; y against
``cuda-hybrid(A_near) + cuda-xpose(A_far)`` (the same plain versions
added in the same order), exact; against ``spmv_oracle``,
``validate_result``; against the JAX pipeline in interpret mode (slow),
rel-L2 <= 1e-5, the XPOSE bound of tests/test_torch_xpose.py.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import nearfar as jax_nf

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops import lane_ell, nearfar, xpose, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-5

# name -> (generator, arguments): tests/test_nearfar.py's matrices
MATRICES = {
    "amazon6k": ("amazon_csr", dict(m=6000, seed=11)),
    "amazon6k-1": ("amazon_csr", dict(m=6000, seed=1)),
    "banded4k": ("banded_csr", dict(m=4000, row_nnz=9, bandwidth=64,
                                    seed=2)),
    "random30k": ("random_csr", dict(m=30000, density=0.0005, seed=4)),
    "amazon24k": ("amazon_csr", dict(m=24000, seed=6)),
}

# the JAX package's delegation names -> the port's
PORT_NAMES = {"pallas-hybrid": "cuda-hybrid", "pallas-xpose": "cuda-xpose"}


def _pair(name):
    spec = MATRICES[name]
    return cases.make(spec), cases.make(spec, jax_synth)


def _same_csr(a, b):
    assert (a.m, a.n, a.nnz) == (b.m, b.n, b.nnz)
    for f in ("irp", "ja", "as_"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("W", nearfar.W_CANDS)
@pytest.mark.parametrize("name", ["amazon6k", "random30k"])
def test_split_matches_jax(name, W):
    A, Aj = _pair(name)
    for mine, want in zip(nearfar.split_by_window(A, W),
                          jax_nf.split_by_window(Aj, W)):
        _same_csr(mine, want)
    near, far = nearfar.split_by_window(A, W)
    assert near.nnz + far.nnz == A.nnz
    assert (np.abs(far.ja.astype(np.int64) - far.row_ids()) > W).all()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_choose_window_matches_jax(name):
    A, Aj = _pair(name)
    assert nearfar.choose_window(A) == jax_nf.choose_window(Aj)
    assert (nearfar.W_CANDS, nearfar.FAR_MIN, nearfar.NEAR_FRAC_MIN) == (
        jax_nf.W_CANDS, jax_nf.FAR_MIN, jax_nf.NEAR_FRAC_MIN)


def test_choose_window_on_an_empty_matrix_is_quiet():
    """The reference takes an empty mean there (ROADMAP queue 3)."""
    none = (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert nearfar.choose_window(CSR.from_coo("e", 9, 9, *none)) is None
    with pytest.warns(RuntimeWarning):
        jax_nf.choose_window(JaxCSR.from_coo("e", 9, 9, *none))


@functools.cache
def _prepared(name):
    A, _ = _pair(name)
    return A, nearfar.prepare_nearfar(A, device="cpu")


@pytest.mark.parametrize("name", ["banded4k", "random30k", "amazon24k"])
def test_delegation_decisions_match_jax(name):
    """tests/test_nearfar.py:42-51's decisions (a pure band goes to the
    hybrid whole, pure scatter to XPOSE whole) and the split of the
    amazon archetype, decided as the JAX package decides them."""
    A, Aj = _pair(name)
    prep = _prepared(name)[1]
    assert (prep.strategy, prep.ref) == ("cuda-nearfar", "pallas-nearfar")
    W = jax_nf.choose_window(Aj)
    if W is None:
        want = "pallas-xpose"
    else:
        _, far = jax_nf.split_by_window(Aj, W)
        want = "pallas-hybrid" if far.nnz < jax_nf.FAR_MIN else None
    assert prep.meta.get("delegated") == PORT_NAMES.get(want)
    expect = {"banded4k": "cuda-hybrid", "random30k": "cuda-xpose",
              "amazon24k": None}[name]
    assert prep.meta.get("delegated") == expect
    if expect is None:
        assert prep.meta["W"] == W and prep.meta["far_nnz"] >= nearfar.FAR_MIN


@pytest.mark.parametrize("name", ["banded4k", "random30k", "amazon24k"])
def test_nearfar_matches_the_oracle(name):
    A, prep = _prepared(name)
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), to_numpy(prep.fn(x)),
                    what=f"cuda-nearfar on {name}")


@pytest.mark.parametrize("s3, s3_kernel", [
    ("rows", ["xpose_s1_slots", "xpose_s3_rows"]),
    ("prefix", ["xpose_mirror", "xpose_s1", "xpose_s3"])])
@pytest.mark.parametrize("layout, core", [("lanes", "lane_ell_spmv"),
                                          ("rows", "lane_rows")])
def test_nearfar_is_the_sum_of_its_parts(layout, core, s3, s3_kernel):
    """amazon24k: y is cuda-hybrid on the band plus cuda-xpose on the
    rest, and the call runs the core and the XPOSE kernels of the design
    (the hybrid's ``core_layout`` and XPOSE's ``s3`` pass through; S1 on
    ``"auto"``: the slot table on the row sums, the slab on the prefix
    S3)."""
    A, _ = _pair("amazon24k")
    prep = nearfar.prepare_nearfar(A, device="cpu", core_layout=layout,
                                   s3=s3)
    x = make_x(A.n)
    near, far = nearfar.split_by_window(A, prep.meta["W"])
    want = (lane_ell.prepare_lane_ell_hybrid(near, device="cpu",
                                             core_layout=layout).fn(x)
            + xpose.prepare_xpose(far, device="cpu", s3=s3).fn(x))
    assert torch.equal(prep.fn(x), want)
    assert torch.equal(prep.plain(x), want)
    names = [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))]
    assert names[0] == core
    assert names[-len(s3_kernel):] == s3_kernel
    assert prep.meta["far"]["s3"] == s3
    assert prep.meta["far"]["s1"] == ("slots" if s3 == "rows" else "slab")
    assert prep.meta["near"]["tail_kind"] != "compact-cuda-xpose"
    assert prep.meta["far"]["B2"] == xpose_plan.plan_xpose(far).B2


def test_delegation_keeps_the_delegates_own_decision(monkeypatch):
    """Pure scatter that the XPOSE planner refuses goes to the hybrid,
    which itself escapes to PELL: ``delegated`` says cuda-hybrid, the
    hybrid's own ``delegated`` (cuda-pell) stays under
    ``delegate_delegated``, and the refusal under ``reject_reason``."""
    monkeypatch.setattr(xpose_plan, "J1_MAX", 30)
    A = cases.random30k()
    prep = get_strategy("cuda-nearfar").prepare(A, device="cpu")
    m = prep.meta
    assert (m["delegated"], m["why"]) == ("cuda-hybrid", "pure scatter")
    assert m["delegate_delegated"] == "cuda-pell"
    assert "J1=" in m["reject_reason"]
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), to_numpy(prep.fn(x)),
                    what="cuda-nearfar delegated to the PELL escape")


@pytest.mark.slow
def test_nearfar_matches_the_jax_pipeline():
    """amazon24k against the JAX package's pallas-nearfar in interpret
    mode (tests/test_nearfar.py:54-61)."""
    A, prep = _prepared("amazon24k")
    _, Aj = _pair("amazon24k")
    x = make_x(A.n)
    y_jax = np.asarray(jax_nf.prepare_nearfar(Aj, interpret=True).fn(x),
                       dtype=np.float64)
    y = to_numpy(prep.fn(x))
    assert np.linalg.norm(y - y_jax) <= VS_JAX_REL_L2 * np.linalg.norm(y_jax)

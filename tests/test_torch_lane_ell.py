"""The port's lane-ELL hybrid (spmv_scpa_tpu_torch/ops/lane_ell.py)
against the JAX package's ``prepare_lane_ell_hybrid``, run in interpret
mode on the CPU as tests/test_lane_ell.py runs it. The CUDA kernel
itself is held against its plain version in tests/test_torch_cuda.py.

Tolerances:
* packed arrays and meta against JAX: exact equality (the packer is a
  copy and keeps the reference's cost models);
* the port's plain y against the JAX hybrid's y: rel-L2 <= 1e-6 — both
  sum the planes in the same order in f32; the slack covers XLA's
  possible mul-add contraction and the tail's summation order;
* everything against ``spmv_oracle``: ``validate_result`` defaults.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as synth
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_prepare
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x

from spmv_scpa_tpu_torch import spmv
from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES as CASES
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.registry import pick_auto, to_numpy

PLAIN_VS_JAX_REL_L2 = 1e-6


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, kw = CASES[request.param]
    A = make()
    x = make_x(A.n)
    jprep = jax_prepare(A, interpret=True, **kw)
    y_jax = np.asarray(jprep.fn(x), dtype=np.float64)
    return request.param, A, kw, x, jprep, y_jax


def _jax_arrays(jprep, plan):
    """The JAX Prepared's args by role. The idx streams are mapped by
    n8/n16: idx16 is absent when n8 == QT (lane_ell.py:1270-1274)."""
    args = [np.asarray(a) for a in jprep.args]
    out = {"vals": args[0]}
    i = 1
    if plan.n8:
        out["idx8"] = args[i]
        i += 1
    if plan.QT - plan.n8 or not plan.n8:
        out["idx16"] = args[i]
        i += 1
    out["hot"] = args[i]
    i += 1
    if plan.cfg.TD:
        out["dynw"] = args[i]
        i += 1
    if plan.trows.size:
        out["seg"], out["tc"], out["tv"], out["ridx"] = args[i:i + 4]
        i += 4
    assert i == len(args)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_plan_arrays_match_jax(case):
    name, A, kw, _, jprep, _ = case
    plan = lane_ell.pack_lane_ell(A, **kw)
    ja = _jax_arrays(jprep, plan)
    np.testing.assert_array_equal(plan.vals_a, ja["vals"])
    if plan.n8:
        np.testing.assert_array_equal(plan.idx8_a, ja["idx8"])
    else:
        assert plan.idx8_a.size == 0
    if "idx16" in ja:
        np.testing.assert_array_equal(plan.idx_a, ja["idx16"])
    else:
        assert plan.idx_a.size == 0
    np.testing.assert_array_equal(plan.hot_idx, ja["hot"])
    if plan.cfg.TD:
        np.testing.assert_array_equal(plan.dynw_a, ja["dynw"])
    else:
        assert plan.dynw_a.size == 0
    if plan.trows.size:
        np.testing.assert_array_equal(plan.tcols, ja["tc"])
        np.testing.assert_array_equal(plan.tvals.astype(np.float32),
                                      ja["tv"])
        np.testing.assert_array_equal(plan.trows, ja["ridx"][ja["seg"]])


def test_plan_meta_matches_jax(case):
    name, A, kw, _, jprep, _ = case
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu", **kw)
    want = dict(jprep.meta)
    if want["tail_kind"] == "xla-compact":
        want["tail_kind"] = "torch-compact"
    assert prep.meta == want
    assert prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == "pallas-hybrid"


def test_plain_y_matches_jax_and_oracle(case):
    name, A, kw, x, _, y_jax = case
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu", **kw)
    before = lane_ell.KERNEL_LAUNCHES
    y = to_numpy(prep.fn(x))
    assert lane_ell.KERNEL_LAUNCHES == before      # CPU: plain version
    assert _rel_l2(y, y_jax) <= PLAIN_VS_JAX_REL_L2
    gold = spmv_oracle(A, x)
    validate_result(gold, y, what=f"port cuda-hybrid (plain) on {name}")
    validate_result(gold, y_jax, what=f"pallas-hybrid on {name}")


def test_plane_tabs_decode_the_strip_sets(case):
    _, A, kw, *_ = case
    plan = lane_ell.pack_lane_ell(A, **kw)
    tabs = plan.plane_tabs()
    assert tabs.shape == (plan.QT, 2) and tabs.dtype == np.int32
    for q, u in enumerate(plan.used):
        if q < plan.n8:
            assert len(u) <= 2 and all(w >= 0 for w in u)
            if u:
                assert (tabs[q, 0], tabs[q, 1]) == (u[0], u[-1])
        else:
            assert tabs[q, 0] == plan.dyn_off.get(q, 0)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    A = CASES["amazon20k"][0]()
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu",
                                            **CASES["amazon20k"][1])
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    args = prep.kernel_inputs(xf)
    before = lane_ell.KERNEL_LAUNCHES
    y = lane_ell.lane_ell_spmv(*args)
    assert lane_ell.KERNEL_LAUNCHES == before
    assert torch.equal(y, lane_ell.lane_ell_spmv_plain(*args))
    assert y.shape == (args[-1].G_pad * 128,)


def test_wrapper_rejects_wrong_dtype_and_shape():
    A = CASES["banded512"][0]()
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu")
    xpad, vals, idx8, idx16, tabs, dynw, cfg = prep.kernel_inputs(
        torch.zeros(A.n))
    with pytest.raises(ValueError, match="vals"):
        lane_ell.lane_ell_spmv(xpad, vals.double(), idx8, idx16, tabs,
                               dynw, cfg)
    with pytest.raises(ValueError, match="xpad"):
        lane_ell.lane_ell_spmv(xpad[:-1], vals, idx8, idx16, tabs, dynw,
                               cfg)
    with pytest.raises(ValueError, match="contiguous"):
        lane_ell.lane_ell_spmv(xpad, vals.t().contiguous().t(), idx8,
                               idx16, tabs, dynw, cfg)
    with pytest.raises(ValueError, match="x has shape"):
        prep.fn(np.ones(A.n + 1))


@pytest.mark.parametrize("A_make, kw, what", [
    (lambda: synth.powerlaw_csr(20000, seed=4), {}, "PELL"),
    (lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
     {"ext": True}, "ext"),
    (lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4), {}, "ext"),
    (lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
     {"ext": False}, "chips"),
    (lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
     {"ext": False, "diag": "nochips", "tail_xla_max": 1000}, "big tails"),
    (lambda: synth.banded_csr(512, row_nnz=12, bandwidth=96, seed=7),
     {"core_only": True}, "distributed"),
    (lambda: synth.banded_csr(512, row_nnz=12, bandwidth=96, seed=7),
     {"x_off": 128}, "distributed"),
], ids=["no-locality", "ext-forced", "ext-auto", "chips", "big-tail",
        "core-only", "x-off"])
def test_missing_branches_raise_not_implemented(A_make, kw, what):
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        lane_ell.prepare_lane_ell_hybrid(A_make(), device="cpu", **kw)
    assert what in str(err.value)


def test_auto_does_not_swallow_not_implemented():
    A = synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4)
    assert pick_auto(A) == "cuda-hybrid"
    with pytest.raises(NotImplementedError):
        spmv(A, make_x(A.n), "auto", device="cpu")


def test_resident_x_refusal_stays_a_value_error(monkeypatch):
    monkeypatch.setattr(lane_ell, "X_VMEM_BUDGET", 1024)
    with pytest.raises(ValueError, match="resident x"):
        lane_ell.prepare_lane_ell_hybrid(CASES["banded512"][0](),
                                         device="cpu")


def test_prepare_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this pins the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lane_ell.prepare_lane_ell_hybrid(CASES["banded512"][0]())

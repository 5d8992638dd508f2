"""The port's registry (spmv_scpa_tpu_torch/ops/registry.py): baselines
against the fp64 oracle on the conftest zoo, ``pick_auto`` against the
JAX package's TPU choice, ``auto`` through the hybrid's ext route and
chips tail, and the port's import boundary (neither ``jax`` nor any
module of ``spmv_scpa_tpu``). Each package gets its matrices from its
own generators."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import registry as jax_registry
from spmv_scpa_tpu.utils import platform as jax_platform

import spmv_scpa_tpu_torch
from spmv_scpa_tpu_torch import get_strategy, list_strategies, spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import lane_ell, registry, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import pick_auto
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "spmv_scpa_tpu_torch"

# The port's strategy for each strategy the JAX pick_auto can return.
PORT_OF = {"pallas-hybrid": "cuda-hybrid", "xla-dense": "torch-dense",
           "pallas-pell": "cuda-pell", "pallas-xpose": "cuda-xpose"}

BASELINES = ("torch-csr-segsum", "torch-dense", "oracle-csr",
             "torch-ell-rm", "torch-ell-cm", "oracle-ell")
ZOO_SIZE = 7        # tests/conftest.py: matrices()


@pytest.mark.parametrize("index", range(ZOO_SIZE))
@pytest.mark.parametrize("strategy", BASELINES)
def test_baselines_match_oracle_on_zoo(matrices, strategy, index):
    Aj = matrices[index]           # the JAX package's CSR: copy it over
    A = CSR(Aj.name, Aj.m, Aj.n, Aj.irp, Aj.ja, Aj.as_)
    x = make_x(A.n)
    y = spmv(A, x, strategy, device="cpu")
    assert y.shape == (A.m,) and y.dtype == np.float64
    validate_result(spmv_oracle(A, x), y, what=f"{strategy} on {A.name}")


# name -> (generator, arguments), drawn by each package's own copy
AUTO_MATRICES = {
    "tiny": ("tiny_fixture_csr", {}),
    "banded2k": ("banded_csr", dict(m=2000, row_nnz=16, seed=1)),
    "stencil4k": ("stencil_csr", dict(m=4000, points=6, run_len=8,
                                      bandwidth=300, seed=2)),
    "amazon20k": ("amazon_csr", dict(m=20000, avg_nnz=4.7, seed=4)),
    "webbase20k": ("webbase_csr", dict(m=20000, seed=5)),
    "powerlaw20k": ("powerlaw_csr", dict(m=20000, seed=4)),
    "random3k": ("random_csr", dict(m=3000, density=0.002, seed=3)),
    # the scattered short-row regime of the JAX package's XPOSE branch
    "random30k": ("random_csr", dict(m=30000, density=0.0005, seed=3)),
    "webbase30k": ("webbase_csr", dict(m=30000, seed=7)),
    # n past the hybrid's resident-x bound
    "wide": ("banded_csr", dict(m=1000, n=3_000_000, row_nnz=4,
                                bandwidth=8, seed=3)),
}


@pytest.mark.parametrize("name", sorted(AUTO_MATRICES))
def test_pick_auto_maps_the_jax_tpu_choice(monkeypatch, name):
    fn, kw = AUTO_MATRICES[name]
    monkeypatch.setattr(jax_platform, "is_tpu", lambda: True)
    want = jax_registry.pick_auto(getattr(jax_synth, fn)(**kw))
    assert pick_auto(getattr(synth, fn)(**kw)) == PORT_OF[want], want


def test_strategies_and_refs():
    names = list_strategies()
    assert names == sorted(["cuda-bcsr", "cuda-hybrid", "cuda-pell",
                            "cuda-xpose", "cuda-nearfar", "oracle-csr",
                            "torch-csr-segsum", "torch-dense",
                            "cuda-hybrid-fp64", "cuda-pell-fp64",
                            "cuda-bcsr-spmm", "torch-csr-segsum-spmm",
                            "torch-ell-rm", "torch-ell-cm",
                            "torch-ell-fp64", "oracle-ell", "cuda-chips",
                            "omp-csr-guided", "omp-csr-nnz", "omp-ell"])
    jax_names = set(jax_registry.list_strategies())
    for name in names:
        spec = get_strategy(name)
        assert spec.ref in jax_names
        # SpMM support as the reference's strategy declares it
        jspec = jax_registry.get_strategy(spec.ref)
        assert spec.spmm_only == jspec.spmm_only
        if spec.spmm_only:
            assert spec.spmm and jspec.spmm
        # a 2-D x wherever the reference's strategy declares one (the
        # port's uniform ELL takes it too)
        assert spec.spmm >= jspec.spmm
    assert get_strategy("cuda-hybrid").ref == "pallas-hybrid"
    assert get_strategy("cuda-pell").ref == "pallas-pell"
    assert get_strategy("cuda-bcsr").ref == "pallas-bcsr"
    assert get_strategy("cuda-xpose").ref == "pallas-xpose"
    assert get_strategy("cuda-nearfar").ref == "pallas-nearfar"
    assert get_strategy("cuda-hybrid-fp64").ref == "pallas-hybrid-df64"
    assert get_strategy("cuda-pell-fp64").ref == "pallas-pell-df64"
    assert get_strategy("cuda-bcsr-spmm").ref == "pallas-bcsr-spmm"
    assert get_strategy("torch-ell-fp64").ref == "xla-ell-df64"
    assert get_strategy("cuda-chips").ref == "pallas-chips"
    assert list_strategies(backend="cuda") == [
        "cuda-bcsr", "cuda-bcsr-spmm", "cuda-chips", "cuda-hybrid",
        "cuda-hybrid-fp64", "cuda-nearfar", "cuda-pell", "cuda-pell-fp64",
        "cuda-xpose"]
    assert list_strategies(fmt="XPOSE") == ["cuda-nearfar", "cuda-xpose"]
    assert list_strategies(backend="host") == [
        "omp-csr-guided", "omp-csr-nnz", "omp-ell", "oracle-csr",
        "oracle-ell"]
    # each strategy logs the reference's format (the CSV format column)
    for name in names:
        assert get_strategy(name).fmt == \
            jax_registry.get_strategy(get_strategy(name).ref).fmt, name
    with pytest.raises(KeyError, match="unknown strategy"):
        get_strategy("pallas-pell")


def test_spmv_auto_on_cpu_matches_oracle():
    for A in (synth.banded_csr(2000, row_nnz=16, seed=1),
              synth.tiny_fixture_csr()):
        x = make_x(A.n)
        validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                        what=f"auto on {A.name}")


def test_spmv_auto_takes_the_ext_route_and_chips_tail():
    """The amazon0302 archetype at 60k rows goes to ``cuda-hybrid``,
    whose plan takes the ext panels and the chips tail."""
    A = synth.amazon_csr(m=60000, seed=6)
    x = make_x(A.n)
    assert pick_auto(A) == "cuda-hybrid"
    meta = lane_ell.prepare_lane_ell_hybrid(A, device="cpu").meta
    assert meta["ext"] and meta["tail_kind"] == "chips"
    y = spmv(A, x, device="cpu")
    validate_result(spmv_oracle(A, x), y, what="auto on amazon60k")
    np.testing.assert_array_equal(y, spmv(A, x, "cuda-hybrid",
                                          device="cpu"))


@pytest.mark.parametrize("name", ["random30k", "webbase30k"])
def test_pick_auto_sends_the_scattered_regime_to_cuda_xpose(monkeypatch,
                                                            name):
    """Where the JAX package's TPU branch picks ``pallas-xpose``, the
    port picks ``cuda-xpose``, and ``spmv``'s auto route runs it."""
    fn, kw = AUTO_MATRICES[name]
    monkeypatch.setattr(jax_platform, "is_tpu", lambda: True)
    assert jax_registry.pick_auto(getattr(jax_synth, fn)(**kw)) \
        == "pallas-xpose"
    A = getattr(synth, fn)(**kw)
    assert pick_auto(A) == "cuda-xpose"
    x = make_x(A.n)
    y = spmv(A, x, device="cpu")
    np.testing.assert_array_equal(y, spmv(A, x, "cuda-xpose", device="cpu"))
    validate_result(spmv_oracle(A, x), y, what=f"auto on {name}")


def test_auto_falls_back_when_xpose_refuses_mid_plan(monkeypatch):
    """quick_envelope_ok passes but the planner refuses (its step cap
    lowered to 30, which still admits the 449,892 entries): ``cuda-xpose``
    raises ValueError and "auto" falls back to the hybrid (here its
    no-locality escape to PELL)."""
    monkeypatch.setattr(xpose_plan, "J1_MAX", 30)
    A = cases.random30k()
    assert pick_auto(A) == "cuda-xpose"
    x = make_x(A.n)
    with pytest.raises(ValueError, match="J1=.*>30"):
        spmv(A, x, "cuda-xpose", device="cpu")
    validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                    what="auto fallback from cuda-xpose")


def test_auto_falls_back_on_a_refusal(monkeypatch):
    """A ValueError mid-plan sends "auto" down the fallback chain."""
    monkeypatch.setattr(lane_ell, "X_VMEM_BUDGET", 1024)
    A = synth.banded_csr(2000, row_nnz=16, seed=1)
    assert pick_auto(A) == "cuda-hybrid"
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                    what="auto fallback")
    with pytest.raises(ValueError):
        spmv(A, x, "cuda-hybrid", device="cpu")


@pytest.mark.parametrize("index", range(ZOO_SIZE))
@pytest.mark.parametrize("strategy", ["cuda-pell", "cuda-bcsr"])
def test_pell_family_matches_oracle_on_zoo(matrices, strategy, index):
    """The two PELL-family strategies, their plain versions on the CPU,
    on every matrix of the zoo."""
    Aj = matrices[index]
    A = CSR(Aj.name, Aj.m, Aj.n, Aj.irp, Aj.ja, Aj.as_)
    x = make_x(A.n)
    y = spmv(A, x, strategy, device="cpu")
    assert y.shape == (A.m,)
    validate_result(spmv_oracle(A, x), y, what=f"{strategy} on {A.name}")


def test_pick_auto_sends_scattered_matrices_to_cuda_pell(monkeypatch):
    """``pallas-pell`` is ported: where the JAX package on a TPU picks
    it (here a scattered matrix with a row past XPOSE's envelope),
    pick_auto picks ``cuda-pell``. No strategy of the JAX pick_auto has a
    stand-in any more: ``pallas-xpose`` maps to ``cuda-xpose``."""
    from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
    assert not hasattr(registry, "AUTO_STAND_INS")
    assert set(PORT_OF.values()) <= set(list_strategies())
    rng = np.random.default_rng(8)
    m, n = 3000, 40000
    rows = np.concatenate([rng.integers(0, m, 30000),
                           np.full(17000, 7)])
    cols = np.concatenate([rng.integers(0, n, 30000),
                           rng.choice(n, 17000, replace=False)])
    coo = (rows, cols, rng.standard_normal(rows.size))
    monkeypatch.setattr(jax_platform, "is_tpu", lambda: True)
    assert jax_registry.pick_auto(JaxCSR.from_coo("s", m, n, *coo)) \
        == "pallas-pell"
    A = CSR.from_coo("s", m, n, *coo)
    assert pick_auto(A) == "cuda-pell"
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                    what="auto on a scattered matrix")


@pytest.mark.parametrize("strategy", ["cuda-hybrid", "torch-csr-segsum",
                                      "torch-dense", "cuda-pell",
                                      "cuda-bcsr", "cuda-xpose",
                                      "cuda-nearfar", "cuda-hybrid-fp64",
                                      "cuda-pell-fp64", "cuda-bcsr-spmm",
                                      "torch-csr-segsum-spmm",
                                      "torch-ell-rm", "torch-ell-cm",
                                      "torch-ell-fp64"])
def test_prepare_refuses_cuda_without_a_card(strategy):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this pins the CPU-only refusal")
    A = synth.banded_csr(512, row_nnz=12, bandwidth=96, seed=7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_strategy(strategy).prepare(A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmv(A, make_x(A.n), strategy)


def test_port_runs_without_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "import spmv_scpa_tpu_torch as P\n"
        "from spmv_scpa_tpu_torch import testing as synth\n"
        "from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle\n"
        "from spmv_scpa_tpu_torch.utils.validation import validate_result\n"
        "from spmv_scpa_tpu_torch.utils.vector import make_x\n"
        "import spmv_scpa_tpu_torch.bench.roofline\n"
        "A = synth.banded_csr(512, row_nnz=12, bandwidth=96, runs=3, seed=7)\n"
        "x = make_x(A.n)\n"
        "for s in P.list_strategies():\n"
        "    validate_result(spmv_oracle(A, x), P.spmv(A, x, s, device='cpu'))\n"
        "print(any(m.split('.')[0] in ('jax', 'spmv_scpa_tpu')\n"
        "          for m in sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _imports(path: Path):
    """Each imported module; ``from pkg import mod`` counts as pkg.mod."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_only_allowed_modules():
    """The port and chip_smoke.py import only their own modules, the
    standard library, numpy and torch."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    seen = set()
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spmv_scpa_tpu"), \
                f"{path} imports {mod}"
            seen.add(top)
    assert {"spmv_scpa_tpu_torch", "numpy", "torch"} <= seen
    assert not seen - {"spmv_scpa_tpu_torch", "numpy", "torch",
                       "__future__"} - set(sys.stdlib_module_names)


def test_public_api():
    assert set(spmv_scpa_tpu_torch.__all__) == {
        "load_csr", "spmv", "get_strategy", "list_strategies"}


def test_pick_auto_never_picks_the_new_strategies():
    """The reference's auto route never picks its fp64 grades, ELL
    baselines or SpMM; neither does the port's."""
    picked = {pick_auto(getattr(synth, fn)(**kw))
              for fn, kw in AUTO_MATRICES.values()}
    assert picked <= {"cuda-hybrid", "cuda-xpose", "cuda-pell",
                      "torch-dense"}

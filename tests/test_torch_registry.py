"""The port's registry (spmv_scpa_tpu_torch/ops/registry.py): baselines
against the fp64 oracle on the conftest zoo, ``pick_auto`` against the
JAX package's TPU choice, and the port's import boundary (no ``jax``;
from ``spmv_scpa_tpu`` only its JAX-free host modules)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as synth
from spmv_scpa_tpu.ops import registry as jax_registry
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.utils import platform as jax_platform
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x

import spmv_scpa_tpu_torch
from spmv_scpa_tpu_torch import get_strategy, list_strategies, spmv
from spmv_scpa_tpu_torch.ops.registry import AUTO_STAND_INS, pick_auto

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "spmv_scpa_tpu_torch"

# The reference's modules that import no jax (checked by the
# subprocess test below), and so the only ones the port may import.
ALLOWED_REFERENCE_MODULES = {
    "spmv_scpa_tpu.formats.csr", "spmv_scpa_tpu.formats.panel_ell",
    "spmv_scpa_tpu.testing", "spmv_scpa_tpu.ops.oracle",
    "spmv_scpa_tpu.utils.validation", "spmv_scpa_tpu.utils.vector",
    "spmv_scpa_tpu.errors", "spmv_scpa_tpu.io.loader",
    "spmv_scpa_tpu.io.mmio", "spmv_scpa_tpu.bench.timing",
}

# The port's strategy for each strategy the JAX pick_auto can return.
PORT_OF = {"pallas-hybrid": "cuda-hybrid", "xla-dense": "torch-dense",
           **AUTO_STAND_INS}

BASELINES = ("torch-csr-segsum", "torch-dense", "oracle-csr")
ZOO_SIZE = 7        # tests/conftest.py: matrices()


@pytest.mark.parametrize("index", range(ZOO_SIZE))
@pytest.mark.parametrize("strategy", BASELINES)
def test_baselines_match_oracle_on_zoo(matrices, strategy, index):
    A = matrices[index]
    x = make_x(A.n)
    y = spmv(A, x, strategy, device="cpu")
    assert y.shape == (A.m,) and y.dtype == np.float64
    validate_result(spmv_oracle(A, x), y, what=f"{strategy} on {A.name}")


AUTO_MATRICES = {
    "tiny": synth.tiny_fixture_csr,
    "banded2k": lambda: synth.banded_csr(2000, row_nnz=16, seed=1),
    "stencil4k": lambda: synth.stencil_csr(4000, points=6, run_len=8,
                                           bandwidth=300, seed=2),
    "amazon20k": lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
    "webbase20k": lambda: synth.webbase_csr(m=20000, seed=5),
    "powerlaw20k": lambda: synth.powerlaw_csr(20000, seed=4),
    "random3k": lambda: synth.random_csr(3000, density=0.002, seed=3),
    # n past the hybrid's resident-x bound
    "wide": lambda: synth.banded_csr(1000, 3_000_000, row_nnz=4,
                                     bandwidth=8, seed=3),
}


@pytest.mark.parametrize("name", sorted(AUTO_MATRICES))
def test_pick_auto_maps_the_jax_tpu_choice(monkeypatch, name):
    A = AUTO_MATRICES[name]()
    monkeypatch.setattr(jax_platform, "is_tpu", lambda: True)
    want = jax_registry.pick_auto(A)
    assert pick_auto(A) == PORT_OF[want], want


def test_strategies_and_refs():
    names = list_strategies()
    assert names == sorted(["cuda-hybrid", "oracle-csr",
                            "torch-csr-segsum", "torch-dense"])
    jax_names = set(jax_registry.list_strategies())
    for name in names:
        spec = get_strategy(name)
        assert spec.ref in jax_names
    assert get_strategy("cuda-hybrid").ref == "pallas-hybrid"
    assert list_strategies(backend="cuda") == ["cuda-hybrid"]
    with pytest.raises(KeyError, match="unknown strategy"):
        get_strategy("pallas-pell")


def test_spmv_auto_on_cpu_matches_oracle():
    for A in (synth.banded_csr(2000, row_nnz=16, seed=1),
              synth.tiny_fixture_csr()):
        x = make_x(A.n)
        validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                        what=f"auto on {A.name}")


def test_auto_falls_back_on_a_refusal(monkeypatch):
    """A ValueError mid-plan sends "auto" down the fallback chain."""
    from spmv_scpa_tpu_torch.ops import lane_ell
    monkeypatch.setattr(lane_ell, "X_VMEM_BUDGET", 1024)
    A = synth.banded_csr(2000, row_nnz=16, seed=1)
    assert pick_auto(A) == "cuda-hybrid"
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), spmv(A, x, device="cpu"),
                    what="auto fallback")
    with pytest.raises(ValueError):
        spmv(A, x, "cuda-hybrid", device="cpu")


@pytest.mark.parametrize("strategy", ["cuda-hybrid", "torch-csr-segsum",
                                      "torch-dense"])
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
        "from spmv_scpa_tpu import testing as synth\n"
        "from spmv_scpa_tpu.ops.oracle import spmv_oracle\n"
        "from spmv_scpa_tpu.utils.validation import validate_result\n"
        "from spmv_scpa_tpu.utils.vector import make_x\n"
        "import spmv_scpa_tpu_torch.bench.roofline\n"
        "A = synth.banded_csr(512, row_nnz=12, bandwidth=96, runs=3, seed=7)\n"
        "x = make_x(A.n)\n"
        "for s in P.list_strategies():\n"
        "    validate_result(spmv_oracle(A, x), P.spmv(A, x, s, device='cpu'))\n"
        "print('jax' in sys.modules)\n")
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
            if node.module in ("spmv_scpa_tpu", "jax"):
                yield from (f"{node.module}.{a.name}" for a in node.names)
            else:
                yield node.module


def test_port_imports_only_allowed_modules():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    seen = set()
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top != "jax", f"{path} imports {mod}"
            if top == "spmv_scpa_tpu":
                assert mod in ALLOWED_REFERENCE_MODULES, \
                    f"{path} imports {mod}"
                seen.add(mod)
    assert "spmv_scpa_tpu.formats.csr" in seen


def test_public_api():
    assert set(spmv_scpa_tpu_torch.__all__) == {
        "load_csr", "spmv", "get_strategy", "list_strategies"}

"""The port's script harness (spmv_scpa_tpu_torch/scripts/: the batch
driver ``results``, the row-shard sweep ``scaling`` and the plotter
``plots``) against the JAX package's ``scripts/results.py``,
``scripts/scaling.py`` and ``scripts/plots.py`` on the same inputs, all
on the CPU: the port's with ``--device cpu`` (the kernels' plain
versions on the host clock), the JAX ones with Pallas in interpret mode
as its tests run it.

Parity: the CSVs of both are equal in every column but the times
(``duration_ms``, ``gflops``); ``--compare``'s table names the same matrices
and, through each strategy's ``ref``, the same strategies, each row
validated against the oracle; the plotter writes the reference's figure
files from the same CSVs.
"""

import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import logger
from spmv_scpa_tpu_torch.cli import parse_synth_spec
from spmv_scpa_tpu_torch.io import mmio
from spmv_scpa_tpu_torch.ops.registry import pick_auto
from spmv_scpa_tpu_torch.scripts import plots, results, scaling

ROOT = Path(__file__).resolve().parents[1]
SPECS = ["synth:banded:m=96,row_nnz=5,bandwidth=16",
         "synth:stencil:m=512,points=3,run_len=4,bandwidth=64,seed=2"]
PORT_B = "torch-csr-segsum,cuda-hybrid"
JAX_B = "xla-csr-segsum,pallas-hybrid"
TIMES = ("duration_ms", "gflops")
SWEEP = "synth:banded:m=200,row_nnz=9,bandwidth=40,seed=2"


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch, **attrs):
    mod = _jax_script(name)
    for k, v in attrs.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(sys, "argv", [f"scripts/{name}.py", *argv])
    return mod.main()


def _write_mtx(d):
    A = synth.banded_csr(150, 120, row_nnz=6, bandwidth=24, seed=9)
    d.mkdir()
    mmio.write(str(d / "band150.mtx"), A.m, A.n, A.row_ids(), A.ja, A.as_)


def _same_rows(a, b, kind):
    rows_a, rows_b = _csv(a / f"{kind}.csv"), _csv(b / f"{kind}.csv")
    assert (a / f"{kind}.csv").read_text().splitlines()[0] == \
        (b / f"{kind}.csv").read_text().splitlines()[0]
    assert len(rows_a) == len(rows_b), kind
    for ra, rb in zip(rows_a, rows_b):
        assert {k: v for k, v in ra.items() if k not in TIMES} == \
            {k: v for k, v in rb.items() if k not in TIMES}, kind
        assert all(float(ra[k]) > 0 for k in TIMES)
    return rows_a


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """``results`` on both packages: two synth specs and a directory of
    one ``.mtx``, ``-i 2``, ``-d``-validated; returns (port out, JAX
    out)."""
    base = tmp_path_factory.mktemp("results")
    for side in ("port", "jax"):
        _write_mtx(base / f"mtx_{side}")
    argv = ["--synth-suite", "-i", "2", "--debug", "--chunks", "64"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(results, "SYNTH_SUITE", SPECS)
        rc = results.main(["-d", str(base / "mtx_port"), "-o",
                           str(base / "port"), "--bench", PORT_B,
                           "--device", "cpu", *argv])
        jrc = _run_jax("results", ["-d", str(base / "mtx_jax"), "-o",
                                   str(base / "jax"), "--bench", JAX_B,
                                   *argv], mp, SYNTH_SUITE=SPECS)
    assert (rc, jrc) == (0, 0)
    return base / "port", base / "jax"


@pytest.mark.parametrize("kind", ["serial", "omp", "cuda"])
def test_results_writes_the_jax_harness_csvs(batch, kind):
    rows = _same_rows(*batch, kind)
    if kind == "omp":              # no --host-parallel: the header only
        assert rows == []
        return
    # three matrices, two iterations each
    assert len({r["matrix"] for r in rows}) == 3
    assert len(rows) == 12         # two rows a run
    if kind == "cuda":
        assert [r["kernel"] for r in rows] == ["0", "11"] * 6


def test_results_compare_table_matches_the_jax_one(tmp_path, monkeypatch):
    port = ["auto", "cuda-hybrid", "torch-csr-segsum"]
    refs = ["pallas-hybrid", "xla-csr-segsum"]
    rc, table = results.compare(SPECS, port, str(tmp_path / "port"), "cpu")
    assert rc == 0
    assert table == (tmp_path / "port" / "compare.md").read_text().strip()
    _run_jax("results", ["--compare", "-o", str(tmp_path / "jax"), "--bench",
                         ",".join(refs)], monkeypatch, SYNTH_SUITE=SPECS)
    rows = [r.split(" | ") for r in table.splitlines()[2:]]
    jrows = [r.split(" | ") for r in (tmp_path / "jax" / "compare.md")
             .read_text().splitlines()[2:]]
    auto = [r for r in rows if r[1].startswith("auto->")]
    assert [r[1] for r in auto] == [
        f"auto->{pick_auto(parse_synth_spec(s))}" for s in SPECS]
    named = [r for r in rows if r not in auto]
    assert [(r[0], get_strategy(r[1]).ref) for r in named] == \
        [(r[0], r[1]) for r in jrows]
    for r in rows:                  # every cell validated, none refused
        assert float(r[4].rstrip(" |")) <= 1e-6


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``scaling`` at 1 and 2 shards: the port's with every variant (each
    call validated inside), the JAX one's with the segment-sum shards
    (its PELL and hybrid shards run Pallas in interpret mode, the
    slowest part of this file; the port's against the JAX package's:
    tests/test_torch_distributed.py)."""
    base = tmp_path_factory.mktemp("scaling")
    argv = ["-m", SWEEP, "--devices", "1,2"]
    rc = scaling.main(["-o", str(base / "port"), "--device", "cpu", *argv,
                       "--pell", "--hybrid"])
    with pytest.MonkeyPatch.context() as mp:
        jrc = _run_jax("scaling", ["-o", str(base / "jax"), *argv], mp)
    assert (rc, jrc) == (0, 0)
    return base / "port", base / "jax"


@pytest.mark.parametrize("kind", ["serial", "omp"])
def test_scaling_writes_the_jax_harness_csvs(sweep, kind):
    port, jax = sweep
    if kind == "serial":
        _same_rows(port, jax, kind)
        return
    rows = _csv(port / "omp.csv")
    assert [(r["bench"], r["num_threads"], r["num_blocks"]) for r in rows] \
        == [(b, k, k) for b in ("mesh_rowshard", "mesh_rowshard_pell",
                                "mesh_rowshard_hybrid") for k in ("1", "2")]
    # the variant both ran: equal rows but for the times
    mine = port / "mesh"
    mine.mkdir()
    with open(port / "omp.csv") as f:
        lines = f.read().splitlines()
    (mine / "omp.csv").write_text("\n".join(
        [lines[0]] + [ln for ln in lines[1:]
                      if ",mesh_rowshard," in ln]) + "\n")
    assert len(_same_rows(mine, jax, kind)) == 2


def test_plots_renders_the_reference_figures(batch, sweep, tmp_path,
                                             monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    port, _ = batch
    for kind in ("serial", "omp"):
        rows = (sweep[0] / f"{kind}.csv").read_text().splitlines()[1:]
        with open(port / f"{kind}.csv", "a") as f:
            f.write("\n".join(rows) + "\n")
    assert plots.main(["-r", str(port), "-o", str(tmp_path / "port")]) == 0
    _run_jax("plots", ["-r", str(port), "-o", str(tmp_path / "jax")],
             monkeypatch)
    mine = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert mine == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {"serial_gflops.png", "device_best_by_format.png",
            "omp_mesh_rowshard_hybrid_speedup_by_bin.png"} <= set(mine)
    assert all((tmp_path / "port" / n).stat().st_size > 0 for n in mine)
    # the legends name the JAX strategies the CSVs' ids stand for
    assert plots.ID_TO_NAME[int(logger.STRATEGY_IDS["cuda-hybrid"])] == \
        "pallas-hybrid"
    assert np.isinf(plots.NNZ_BINS[-1])


def test_scripts_run_as_modules(tmp_path):
    """``python -m spmv_scpa_tpu_torch.scripts.<name> --help`` for each."""
    import subprocess
    for name in ("results", "scaling", "plots"):
        out = subprocess.run(
            [sys.executable, "-m", f"spmv_scpa_tpu_torch.scripts.{name}",
             "--help"], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stderr
        assert f"spmv_scpa_tpu_torch.scripts.{name}" in out.stdout

"""The port's host harness against the JAX package's: the CLI
(``spmv_scpa_tpu_torch/cli.py``), the runner (``bench/runner.py``), the
CSV logger (``bench/logger.py``) and the timing dispatch
(``bench/timing.py``), all on the CPU (``--device cpu``: the kernels'
plain versions, timed on the host clock).

Parity: the port's CLI and the JAX one run the same synthetic specs
with ``-d`` and ``--chunks 64``, the port's strategies against the ones
they are held to (``ref``), Pallas in interpret mode as the JAX tests
run it. Their CSVs are equal in every column but ``duration_ms`` and
``gflops`` (times), except for ``cuda-pell`` (kernel id 5): its plan on
the card is the row layout, which ignores ``chunk`` (``tunable=False``,
one cell, logged at chunk 0 where the JAX sweep logs 64) and has no
tiles (``num_blocks`` empty where the JAX PELL counts its tiles). Each
result's y is within rel-L2 1e-6 of the JAX one (two f32 sums of the
same products in different orders), but PELL's: the TPU's PELL kernels
reduce in bf16 split passes, 3.8e-6 from the oracle on these specs, so
the port's PELL is held to the JAX y at 1e-4, as in
tests/test_torch_pell*.py. Every port y is within rel-L2 1e-6 of the
fp64 oracle (the golden).
"""

import csv
import dataclasses
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import cli as jax_cli
from spmv_scpa_tpu import errors as jax_errors
from spmv_scpa_tpu.bench import logger as jax_logger
from spmv_scpa_tpu.bench import runner as jax_runner

from spmv_scpa_tpu_torch import cli, errors, get_strategy, list_strategies
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import logger, runner, timing
from spmv_scpa_tpu_torch.io import loader, mmio, native
from spmv_scpa_tpu_torch.ops import native_omp, registry
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.vector import make_x

ROOT = Path(__file__).resolve().parents[1]
VS_JAX_REL_L2 = 1e-6
PELL_VS_JAX_REL_L2 = 1e-4
VS_ORACLE_REL_L2 = 1e-6
FP64_RTOL = 1e-9

BANDED = "synth:banded:m=96,row_nnz=5,bandwidth=16"
AMAZON = "synth:amazon:m=6000,seed=30"          # its hybrid has a chips tail
PORT_B = "torch-csr-segsum,cuda-hybrid,cuda-pell"
JAX_B = "xla-csr-segsum,pallas-hybrid,pallas-pell"
# cuda.csv columns that may differ: times everywhere; chunk and
# num_blocks on cuda-pell's row layout (module docstring)
TIMES = ("duration_ms", "gflops")
UNTUNED = {str(logger.STRATEGY_IDS["cuda-pell"]): ("warps_per_block",
                                                  "num_blocks")}

# synth specs at small sizes, one per archetype
SPECS = [
    "synth:banded:m=64,row_nnz=4,bandwidth=16",
    "synth:banded:m=300,n=200,row_nnz=7,bandwidth=64,seed=2,runs=2",
    "synth:stencil:m=512,points=3,run_len=4,bandwidth=64,seed=2",
    "synth:random:m=100,n=80,density=0.05,seed=3",
    "synth:powerlaw:m=200,n=150,seed=4",
    "synth:webbase:m=2000,seed=5",
    "synth:amazon:m=2000,avg_nnz=4.7,seed=6",
]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """spec -> (port CliRun, port out dir, JAX results, JAX out dir)."""
    out = {}
    for spec in (BANDED, AMAZON):
        base = tmp_path_factory.mktemp("parity")
        mine = cli.run(["-m", spec, "-o", str(base / "port"), "-d", "-b",
                        PORT_B, "--chunks", "64", "--device", "cpu"])
        theirs = []
        real = jax_runner.run_benchmarks

        def capture(A, cfg):
            theirs.extend(real(A, cfg))
            return theirs

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_runner, "run_benchmarks", capture)
            rc = jax_cli.main(["-m", spec, "-o", str(base / "jax"), "-d",
                               "-b", JAX_B, "--chunks", "64"])
        assert (mine.code, rc) == (0, 0)
        out[spec] = (mine, base / "port", theirs, base / "jax")
    return out


@pytest.mark.parametrize("spec", [BANDED, AMAZON])
def test_cli_writes_the_jax_clis_csvs(parity, spec):
    _, mine, _, theirs = parity[spec]
    for kind in ("serial", "omp", "cuda"):
        a, b = mine / f"{kind}.csv", theirs / f"{kind}.csv"
        assert a.read_text().splitlines()[0] == \
            b.read_text().splitlines()[0] == jax_logger._HEADERS[kind]
        rows_a, rows_b = _csv(a), _csv(b)
        assert len(rows_a) == len(rows_b), kind
        for ra, rb in zip(rows_a, rows_b):
            skip = TIMES + (UNTUNED.get(ra["kernel"], ())
                            if kind == "cuda" else ())
            assert {k: v for k, v in ra.items() if k not in skip} == \
                {k: v for k, v in rb.items() if k not in skip}
            for k in TIMES:
                assert float(ra[k]) > 0
    cuda = _csv(mine / "cuda.csv")
    assert [r["kernel"] for r in cuda] == ["0", "11", "5"]
    assert [r["warps_per_block"] for r in cuda] == ["0", "64", "0"]


@pytest.mark.parametrize("spec", [BANDED, AMAZON])
def test_cli_results_match_the_jax_ones(parity, spec):
    mine, _, theirs, _ = parity[spec]
    assert len(mine.results) == len(theirs) == 5
    refs = {"oracle-csr": "oracle-csr", "oracle-ell": "oracle-ell"}
    refs.update((n, get_strategy(n).ref) for n in PORT_B.split(","))
    gold = mine.results[0].bench.data
    for a, b in zip(mine.results, theirs):
        assert refs[a.strategy] == b.strategy
        assert a.rel_err is not None and b.rel_err is not None
        ya, yb = np.asarray(a.bench.data), np.asarray(b.bench.data)
        assert ya.shape == yb.shape
        tol = PELL_VS_JAX_REL_L2 if a.fmt == "PELL" else VS_JAX_REL_L2
        assert np.linalg.norm(ya - yb) <= tol * np.linalg.norm(yb)
        assert np.linalg.norm(ya - gold) <= \
            VS_ORACLE_REL_L2 * np.linalg.norm(gold)
    hybrid = next(r for r in mine.results if r.strategy == "cuda-hybrid")
    if spec == AMAZON:
        assert hybrid.meta["tail_kind"] == "chips"
    assert mine.cfg.skipped == []


def test_plots_read_the_ports_csvs(tmp_path):
    """``scripts/plots.py`` (imported as tests/test_harness.py imports
    it) plots the port's three CSVs, the omp rows too."""
    out = tmp_path / "res"
    for spec in (BANDED, "synth:banded:m=300,row_nnz=9,bandwidth=40"):
        assert cli.main(["-m", spec, "-o", str(out), "-b",
                         "torch-csr-segsum,cuda-hybrid,cuda-bcsr",
                         "--chunks", "32,64", "--host-parallel",
                         "--device", "cpu"]) == 0
    sys.path.insert(0, str(ROOT / "scripts"))
    plots = importlib.import_module("plots")
    plot_out = tmp_path / "plots"
    plot_out.mkdir()
    serial = plots._read(str(out / "serial.csv"))
    dev = plots._read(str(out / "cuda.csv"))
    omp = plots._read(str(out / "omp.csv"))
    assert len(dev) == 2 * 4 and len(omp) == 2 * 18
    assert set(dev["format"]) == {"CSR", "LELL", "BCSR"}
    plots.plot_serial(serial, str(plot_out))
    plots.plot_device(dev, str(plot_out))
    plots.plot_device_per_bin(dev, str(plot_out))
    plots.plot_omp(omp, serial, str(plot_out))
    plots.plot_omp_scaling(omp, serial, str(plot_out))
    pngs = [f for f in os.listdir(plot_out) if f.endswith(".png")]
    assert len(pngs) >= 5, pngs


# ---- the logger --------------------------------------------------------------

def test_logger_writes_the_jax_loggers_bytes(tmp_path):
    calls = [
        ("log_serial", dict(matrix="m", fmt="CSR", rows=4, cols=5, nnz=6,
                            num_blocks=None, duration_ms=0.123456789,
                            gflops=1.5)),
        ("log_serial", dict(matrix="m", fmt="HLL", rows=4, cols=5, nnz=6,
                            num_blocks=3, duration_ms=2.0, gflops=1e-7)),
        ("log_omp", dict(matrix="m", fmt="HLL", bench="omp_ell", rows=4,
                         cols=5, nnz=6, num_blocks=1, num_threads=8,
                         duration_ms=0.5, gflops=3.25)),
        ("log_device", dict(matrix="m", fmt="PELL", kernel=5, chunk=64,
                            rows=4, cols=5, nnz=6, num_blocks=None,
                            duration_ms=0.0419, gflops=594.44)),
        ("log_device", dict(matrix="m", fmt="CSR", kernel="nope", chunk=0,
                            rows=4, cols=5, nnz=6, num_blocks=7,
                            duration_ms=1.0, gflops=2.0)),
    ]
    for mod, d in ((logger, tmp_path / "port"), (jax_logger, tmp_path / "jax")):
        for _ in range(2):                    # append: one header each
            with mod.CsvLogger(str(d)) as log:
                for name, kw in calls:
                    getattr(log, name)(**kw)
    for kind in ("serial", "omp", "cuda"):
        assert (tmp_path / "port" / f"{kind}.csv").read_bytes() == \
            (tmp_path / "jax" / f"{kind}.csv").read_bytes()
    assert logger._HEADERS == jax_logger._HEADERS


def test_strategy_ids_are_the_jax_ids_through_ref():
    assert logger.REF_IDS == jax_logger.STRATEGY_IDS
    device = [n for n in list_strategies()
              if get_strategy(n).backend in ("torch", "cuda")]
    assert sorted(n for n in logger.STRATEGY_IDS
                  if n != "distributed-rowshard") == sorted(device)
    for name in device:
        assert logger.STRATEGY_IDS[name] == \
            jax_logger.STRATEGY_IDS[get_strategy(name).ref]
    assert logger.STRATEGY_IDS["distributed-rowshard"] == 9


# ---- synth specs, exit codes, strategy listing --------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_parse_synth_spec_equals_the_jax_one(spec):
    a, b = cli.parse_synth_spec(spec), jax_cli.parse_synth_spec(spec)
    assert (a.name, a.m, a.n, a.nnz) == (b.name, b.m, b.n, b.nnz)
    for field in ("irp", "ja", "as_"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_every_archetype_is_covered():
    assert sorted(synth.ARCHETYPES) == sorted(
        importlib.import_module("spmv_scpa_tpu.testing").ARCHETYPES)
    assert {s.split(":")[1] for s in SPECS} == set(synth.ARCHETYPES)


@pytest.mark.parametrize("spec", ["synth:nope:m=4", "synth", "banded:m=4",
                                  "synth:banded:m=abc"])
def test_bad_synth_specs_are_config_errors(spec):
    with pytest.raises(errors.ConfigError) as mine:
        cli.parse_synth_spec(spec)
    with pytest.raises(jax_errors.ConfigError) as theirs:
        jax_cli.parse_synth_spec(spec)
    assert str(mine.value) == str(theirs.value)
    assert mine.value.code == theirs.value.code


def test_exit_codes_equal_the_jax_ones(tmp_path):
    out = str(tmp_path / "r")
    for argv in ([], ["-m", BANDED], ["-o", out],
                 ["-m", "synth:nope:m=4", "-o", out],
                 ["-m", str(tmp_path / "missing.mtx"), "-o", out],
                 ["-m", str(tmp_path / "missing.mtx"), "-o", out,
                  "--no-cache"]):
        mine = cli.main(argv + ["--device", "cpu"])
        assert mine == jax_cli.main(argv), argv
        assert mine != 0
    assert cli.main([]) == 2
    assert cli.main(["-m", "synth:nope:m=4", "-o", out]) == \
        errors.ConfigError.code
    assert cli.main(["-m", str(tmp_path / "missing.mtx"), "-o", out]) == 1


def _lying(monkeypatch, reg, name):
    spec = reg.get_strategy(name)
    orig = spec.prepare

    def lying_prepare(A, **kw):
        prep = orig(A, **kw)
        good = prep.fn
        prep.fn = lambda x: good(x) + 1e6
        if hasattr(prep, "raw") and prep.raw is not None:
            raw = prep.raw
            prep.raw = lambda x, *a: raw(x, *a) + 1e6
        return prep

    monkeypatch.setitem(reg._REGISTRY, name,
                        dataclasses.replace(spec, prepare=lying_prepare))


def test_validation_failure_aborts_as_in_the_jax_cli(tmp_path, monkeypatch):
    from spmv_scpa_tpu.ops import registry as jax_registry
    _lying(monkeypatch, registry, "torch-csr-segsum")
    _lying(monkeypatch, jax_registry, "xla-csr-segsum")
    mine = cli.main(["-m", BANDED, "-o", str(tmp_path / "p"), "-b",
                     "torch-csr-segsum", "-d", "--device", "cpu"])
    theirs = jax_cli.main(["-m", BANDED, "-o", str(tmp_path / "j"), "-b",
                           "xla-csr-segsum", "-d"])
    assert mine == theirs == errors.ValidationError.code != 0
    # without -d nothing is validated: the row is logged
    assert cli.main(["-m", BANDED, "-o", str(tmp_path / "p2"), "-b",
                     "torch-csr-segsum", "--device", "cpu"]) == 0


def test_list_strategies_names_each_ref(capsys):
    assert cli.main(["--list-strategies"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(list_strategies()) == 20
    for line, name in zip(lines, list_strategies()):
        assert line.split()[0] == name
        assert line.split()[-1] == f"ref={get_strategy(name).ref}"


def test_print_result(capsys, tmp_path):
    assert cli.main(["-m", BANDED, "-o", str(tmp_path / "r"), "-b",
                     "torch-csr-segsum", "--print-result", "3",
                     "--device", "cpu"]) == 0
    assert "y[:3] =" in capsys.readouterr().out


# ---- the .mtx path: native parser, cache, append ------------------------------

def test_cli_parses_natively_then_reads_the_cache(tmp_path, monkeypatch):
    A = synth.amazon_csr(m=3000, seed=6)
    path = tmp_path / "amazon3k.mtx"
    mmio.write(path, A.m, A.n, A.row_ids(), A.ja, A.as_)
    out = tmp_path / "r"
    args = ["-m", str(path), "-o", str(out), "-d", "-b", "torch-csr-segsum",
            "--device", "cpu"]
    parses = {"n": 0}
    real = loader.load_csr

    def counting(p, **kw):
        parses["n"] += 1
        return real(p, **kw)

    monkeypatch.setattr(loader, "load_csr", counting)
    before = native.PARSES
    first = cli.run(args)
    assert first.code == 0 and parses["n"] == 1
    assert native.PARSES == before + 1             # the C++ parser read it
    assert (tmp_path / ".spmv_cache").is_dir()
    second = cli.run(args)
    assert second.code == 0 and parses["n"] == 1   # the cache: no parse
    assert native.PARSES == before + 1
    np.testing.assert_array_equal(first.results[-1].bench.data,
                                  second.results[-1].bench.data)
    for kind, rows in (("serial", 2), ("cuda", 1), ("omp", 0)):
        lines = (out / f"{kind}.csv").read_text().splitlines()
        assert lines[0] == logger._HEADERS[kind]
        assert lines.count(lines[0]) == 1 and len(lines) == 1 + 2 * rows
    assert cli.main(args + ["--no-cache"]) == 0
    assert parses["n"] == 2


# ---- the runner ----------------------------------------------------------------

def _cfg(tmp_path, **kw):
    return runner.RunConfig(out_dir=str(tmp_path / "r"), debug=True,
                            device="cpu", **kw)


def test_runner_fp64_rows_take_float64_and_the_tight_gate(tmp_path):
    A = synth.stencil_csr(2000, points=4, run_len=6, bandwidth=200, seed=3)
    cfg = _cfg(tmp_path, strategies=["cuda-hybrid-fp64", "cuda-pell-fp64",
                                     "torch-ell-fp64"], chunks=(64,))
    results = runner.run_benchmarks(A, cfg)
    rows = {r.strategy: r for r in results[2:]}
    assert sorted(rows) == sorted(cfg.strategies) and not cfg.skipped
    for r in rows.values():
        assert r.rel_err <= FP64_RTOL
        assert r.meta["rtol"] == FP64_RTOL
    # an f32 y fails that gate, which the 0.1 absolute gate alone passes
    y32 = results[0].bench.data.astype(np.float32)
    with pytest.raises(errors.ValidationError):
        runner._check(cfg, results[0].bench.data, y32, "f32", FP64_RTOL)
    assert runner._check(cfg, results[0].bench.data, y32, "f32") < 1e-6


def test_runner_row_sharded_spmm_and_host_parallel_rows(tmp_path):
    A = synth.banded_csr(400, row_nnz=9, bandwidth=40, seed=1)
    cfg = _cfg(tmp_path, strategies=["torch-csr-segsum"], distributed=True,
               spmm_cols=(3, 8), host_parallel=True, omp_threads=(1, 2))
    results = runner.run_benchmarks(A, cfg)
    names = [(r.strategy, r.fmt, r.chunk) for r in results]
    assert names[2:8] == [(f"{b}@{nt}", f, None) for nt in (1, 2)
                          for b, f in (("omp_csr_guided", "CSR"),
                                       ("omp_csr_nnz", "CSR"),
                                       ("omp_ell", "HLL"))]
    assert names[8:] == [
        ("torch-csr-segsum", "CSR", None),
        ("distributed-rowshard", "HYBRID", 1),
        ("distributed-rowshard", "PELL", 1),
        ("cuda-bcsr-spmm", "BCSR", 3), ("torch-csr-segsum-spmm", "CSR", 3),
        ("cuda-bcsr-spmm", "BCSR", 8), ("torch-csr-segsum-spmm", "CSR", 8)]
    assert all(r.rel_err is not None for r in results)
    assert results[-1].bench.data.shape == (A.m, 8)
    cuda = _csv(Path(cfg.out_dir) / "cuda.csv")
    assert [(r["kernel"], r["warps_per_block"]) for r in cuda] == [
        ("0", "0"), ("9", "1"), ("9", "1"), ("7", "3"), ("8", "3"),
        ("7", "8"), ("8", "8")]
    omp = _csv(Path(cfg.out_dir) / "omp.csv")
    assert [r["num_threads"] for r in omp] == ["1"] * 3 + ["2"] * 3


def test_runner_host_parallel_falls_back_to_torch(tmp_path, monkeypatch,
                                                 caplog):
    monkeypatch.setattr(native_omp, "available", lambda: False)
    A = synth.banded_csr(400, row_nnz=9, bandwidth=40, seed=1)
    cfg = _cfg(tmp_path, strategies=["torch-csr-segsum"], host_parallel=True)
    results = runner.run_benchmarks(A, cfg)
    assert [r.strategy for r in results[2:4]] == ["torch-csr-segsum@cpu",
                                                  "torch-ell-cm@cpu"]
    omp = _csv(Path(cfg.out_dir) / "omp.csv")
    assert [(r["bench"], r["num_threads"]) for r in omp] == [
        ("torch_guided", str(torch.get_num_threads())),
        ("torch_ell", str(torch.get_num_threads()))]
    assert "native OpenMP library unavailable" in caplog.text


@pytest.mark.parametrize("exc", [ValueError, NotImplementedError])
def test_runner_logs_a_refusal_as_a_skipped_cell(tmp_path, monkeypatch, exc):
    def refuse(A, **kw):
        raise exc("no room (ROADMAP queue 1 #8)")

    spec = registry.get_strategy("cuda-hybrid")
    monkeypatch.setitem(registry._REGISTRY, "cuda-hybrid",
                        dataclasses.replace(spec, prepare=refuse))
    A = synth.banded_csr(200, row_nnz=5, bandwidth=16)
    cfg = _cfg(tmp_path, strategies=["cuda-hybrid", "torch-csr-segsum"],
               chunks=(32, 64))
    results = runner.run_benchmarks(A, cfg)
    assert [r.strategy for r in results[2:]] == ["torch-csr-segsum"]
    assert [(n, c) for n, c, _ in cfg.skipped] == [("cuda-hybrid", 32),
                                                   ("cuda-hybrid", 64)]
    assert all(f"({exc.__name__}): no room" in why
               for *_, why in cfg.skipped)


@pytest.mark.parametrize("where", ["prepare", "call"])
def test_runner_lets_any_other_error_through(tmp_path, monkeypatch, where):
    spec = registry.get_strategy("cuda-hybrid")
    orig = spec.prepare

    def broken(A, **kw):
        if where == "prepare":
            raise RuntimeError("nvcc failed to build csrc/lane_rows.cu")
        prep = orig(A, **kw)

        def fn(x):
            raise RuntimeError("lane_rows: CUDA error 700")
        prep.fn = fn
        return prep

    monkeypatch.setitem(registry._REGISTRY, "cuda-hybrid",
                        dataclasses.replace(spec, prepare=broken))
    A = synth.banded_csr(200, row_nnz=5, bandwidth=16)
    cfg = _cfg(tmp_path, strategies=["cuda-hybrid"], chunks=(64,))
    with pytest.raises(RuntimeError):
        runner.run_benchmarks(A, cfg)
    assert cfg.skipped == []
    with pytest.raises(RuntimeError):
        cli.main(["-m", BANDED, "-o", str(tmp_path / "c"), "-b",
                  "cuda-hybrid", "--device", "cpu"])


def test_runner_sweeps_only_the_tunable_strategies(tmp_path):
    A = synth.banded_csr(2000, row_nnz=9, bandwidth=64, seed=1)
    cfg = _cfg(tmp_path, strategies=["cuda-hybrid", "cuda-bcsr",
                                     "torch-ell-cm"], chunks=(32, 64))
    results = runner.run_benchmarks(A, cfg)
    assert [(r.strategy, r.chunk) for r in results[2:]] == [
        ("cuda-hybrid", 32), ("cuda-hybrid", 64), ("cuda-bcsr", None),
        ("torch-ell-cm", None)]


# ---- timing -------------------------------------------------------------------

def test_time_prepared_refuses_a_cpu_prepared_unless_asked(monkeypatch):
    A = synth.banded_csr(256, row_nnz=5, bandwidth=16)
    x = make_x(A.n)
    prep = get_strategy("torch-csr-segsum").prepare(A, device="cpu")
    with pytest.raises(RuntimeError, match="on the card"):
        timing.time_prepared(prep, x)
    r = timing.time_prepared(prep, x, device="cpu")
    np.testing.assert_array_equal(r.data, to_numpy(prep.fn(x)))
    assert r.data.dtype == np.float64 and 1 <= r.reps <= 10
    assert r.gflops == timing.compute_gflops(A.nnz, r.duration_ms)
    # a host strategy is timed on the host clock wherever it is asked
    for name in ("oracle-csr", "omp-csr-guided"):
        host = get_strategy(name).prepare(A)
        assert timing.time_prepared(host, x).data.shape == (A.m,)


def test_time_host_fn_matches_the_jax_ones_accounting():
    from spmv_scpa_tpu.bench import timing as jax_timing
    calls = []

    def fn(x):
        calls.append(1)
        return np.outer(x, np.ones(3))

    mine = timing.time_host_fn(fn, np.ones(5), nnz=100, reps=4)
    theirs = jax_timing.time_host_fn(fn, np.ones(5), nnz=100, reps=4)
    assert (mine.reps, theirs.reps, len(calls)) == (4, 4, 10)
    np.testing.assert_array_equal(mine.data, theirs.data)
    assert mine.gflops == timing.compute_gflops(100, mine.duration_ms, 3)


def test_time_device_fn_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.time_device_fn(lambda x: x, torch.ones(4), nnz=4)


# ---- tunable --------------------------------------------------------------------

# a matrix each strategy accepts
TUNE_MATRIX = {
    "cuda-xpose": lambda: synth.random_csr(3000, 3000, density=0.001,
                                           seed=3),
}


@pytest.mark.parametrize("name", [
    n for n in list_strategies(backend="cuda")
    if not get_strategy(n).tunable])
def test_untunable_strategies_ignore_chunk(name):
    """A strategy with ``tunable=False`` packs the same plan at chunk 32
    and 256: equal ``hbm_bytes``, meta (the recorded knobs aside) and
    every kernel call's arrays."""
    A = TUNE_MATRIX.get(name, lambda: synth.banded_csr(
        2000, row_nnz=9, bandwidth=64, seed=1))()
    spec = get_strategy(name)
    kw = {"cols": 8} if spec.spmm_only else {}
    a = spec.prepare(A, device="cpu", chunk=32, **kw)
    b = spec.prepare(A, device="cpu", chunk=256, **kw)
    assert a.hbm_bytes == b.hbm_bytes > 0

    def meta(p):
        return {k: v for k, v in p.meta.items()
                if k not in ("tile_knobs", "tpu_knobs")}

    assert repr(meta(a)) == repr(meta(b))
    dtype = torch.float64 if a.meta.get("rtol") else torch.float32
    x = make_x(A.n, cols=kw.get("cols"))
    xd = torch.as_tensor(x, dtype=dtype)
    calls_a, calls_b = a.kernel_calls(xd), b.kernel_calls(xd)
    assert [c[0] for c in calls_a] == [c[0] for c in calls_b]
    assert calls_a
    for (_, args_a), (_, args_b) in zip(calls_a, calls_b):
        for u, v in zip(args_a, args_b):
            if isinstance(u, torch.Tensor):
                assert torch.equal(u, v)
            else:
                assert repr(u) == repr(v)
    assert torch.equal(a.fn(xd), b.fn(xd))


def test_the_tunable_strategies_plan_by_chunk():
    """The lane-ELL packs (the hybrid, its fp64 grade, near/far's band)
    change with chunk: a sweep over it logs distinct plans."""
    A = synth.amazon_csr(m=6000, seed=30)
    tunable = [n for n in list_strategies(backend="cuda")
               if get_strategy(n).tunable]
    assert tunable == ["cuda-hybrid", "cuda-hybrid-fp64", "cuda-nearfar"]
    for name in ("cuda-hybrid", "cuda-nearfar"):
        spec = get_strategy(name)
        a = spec.prepare(A, device="cpu", chunk=32)
        b = spec.prepare(A, device="cpu", chunk=256)
        assert (a.meta["chunk"], b.meta["chunk"]) == (32, 256)
        assert a.hbm_bytes != b.hbm_bytes
    B = synth.banded_csr(2000, row_nnz=9, bandwidth=64, seed=1)
    spec = get_strategy("cuda-hybrid-fp64")
    a = spec.prepare(B, device="cpu", chunk=32)
    b = spec.prepare(B, device="cpu", chunk=256)
    assert (a.meta["chunk"], a.meta["steps"]) != (b.meta["chunk"],
                                                  b.meta["steps"])

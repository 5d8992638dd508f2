"""A run's contract on the CPU: what it loads, how it refuses, what its
last line holds; and one run on the card where there is one."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from spmv_bench.run import execute
from spmv_bench.spec import ROOT, load_cell
from spmv_bench.tests.small import copy_bench

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("BENCH_RUN", None)
    return env


def test_a_run_loads_no_jax(tmp_path):
    """In a fresh interpreter a whole run (on the CPU, small) loads no
    module whose top-level name is jax, jaxlib, flax or spmv_scpa_tpu,
    compared whole: the port's own name begins with the last."""
    root = copy_bench(tmp_path)
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from spmv_bench import run\n"
        "from spmv_bench.spec import load_cell\n"
        "from spmv_bench.control import readings\n"
        f"cell = load_cell('flagship.spmv', Path({str(root)!r}))\n"
        "out = run.execute(cell, 3, 0.3, True, device='cpu',"
        " log=lambda _: None)\n"
        "readings(cell, 3, 'cpu')\n"
        "assert out['correct'], out\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'spmv_scpa_tpu_torch' in tops\n"
        "print(run.forbidden_loaded())\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=_env())
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from spmv_bench import run
    monkeypatch.setitem(sys.modules, "spmv_scpa_tpu_torch_x", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "spmv_scpa_tpu.ops", sys)
    assert run.forbidden_loaded() == ["spmv_scpa_tpu"]


def _cli(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "spmv_bench.run", "--workload",
         "flagship.spmv", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600, env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    done = _cli(ROOT, _env(CUDA_VISIBLE_DEVICES=""))
    assert done.returncode != 0
    assert done.stdout == ""
    assert "CUDA device" in done.stderr


def test_a_run_with_only_the_benchmarks_files_fails(tmp_path):
    shutil.copytree(ROOT / "spmv_bench", tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = _env(PYTHONPATH="")
    done = _cli(tmp_path, env)
    assert done.returncode != 0
    assert done.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(tmp_path, trace):
    root = copy_bench(tmp_path)
    out = execute(load_cell("flagship.spmv", root), 2**31 + 5, 0.3, trace,
                  device="cpu", log=lambda _: None)
    line = json.loads(json.dumps(out))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    # off the card no device number is written: the line holds the
    # cell's metrics that the host reads, in the cell's order, the ones
    # the cell was committed with first
    names = list(line["metrics"])
    if trace:
        assert names[:2] == ["pack_s", "port_kernel_calls"]
        assert set(names[2:]) >= {"pack_plan_s", "pack_layout_s",
                                  "pack_upload_s"}
        assert not set(names) & {"host_enqueue_ms", "device_ms",
                                 "kernel_roofline", "device_idle_share",
                                 "kernel_load_s", "call_host_ms"}
    else:
        assert names == ["setup_s"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    done = subprocess.run(
        [sys.executable, "-m", "spmv_bench.run", "--workload",
         "flagship.spmm8", "--seed", "2147483777", "--seconds", "10",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900, env=_env())
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(line["metrics"]) == {"gflops", "call_p95_ms", "setup_s"}
    assert done.stderr.strip().splitlines()[-1].startswith("check ")


def test_the_windows_number_their_calls_on():
    """The tail's window goes on from the rate's: call i takes X i mod
    the number of X and is call i for the sample, in both windows; only
    the tail's window records spans."""
    from spmv_bench import timing
    from spmv_bench.harness import Sample
    xs = [torch.full((3,), float(k)) for k in range(3)]
    seen = []

    def fn(x):
        seen.append(int(x[0]))
        return x.clone()

    sample = Sample(5, k=10**6)
    a, _, spans_a, _ = timing.closed_loop(fn, xs, 0.02, None, sample,
                                          sync=lambda: None)
    pairs = timing.make_pairs(0, timing.HostEvent)
    b, _, spans_b, _ = timing.closed_loop(fn, xs, 0.02, pairs, sample,
                                          first=a, sync=lambda: None)
    assert a > 0 and b > 0 and spans_a.size == 0 and spans_b.size == b
    assert seen == [i % 3 for i in range(a + b)]
    assert [i for i, _ in sample.kept] == list(range(a + b))
    assert all(int(y[0]) == i % 3 for i, y in sample.kept)

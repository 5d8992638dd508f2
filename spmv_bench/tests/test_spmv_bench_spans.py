"""The metrics read from the port's spans (``spmv_bench/spans.py``) on
the CPU copy of the benchmark: the pack's three parts in a traced run,
within the benchmark's own clock around ``prepare``; no call or kernel
load number off the card."""

import pytest

from spmv_bench.run import execute
from spmv_bench.spec import load_cell
from spmv_bench.tests.small import copy_bench

PARTS = ("pack_plan_s", "pack_layout_s", "pack_upload_s")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["flagship.spmv", "flagship.spmm8"])
def test_a_traced_run_splits_the_pack(root, cell):
    out = execute(load_cell(cell, root), 2**31 + 11, 0.3, True,
                  device="cpu", log=lambda _: None)
    metrics = out["metrics"]
    assert set(PARTS) <= set(metrics)
    for name in PARTS:
        assert metrics[name]["unit"] == "s" and metrics[name]["value"] > 0
    parts = sum(metrics[name]["value"] for name in PARTS)
    pack = metrics["pack_s"]["value"]
    assert 0.9 * pack <= parts <= pack
    # off the card: no call spans measured, and no kernel was loaded
    assert "call_host_ms" not in metrics
    assert "kernel_load_s" not in metrics


def test_an_untraced_run_reads_no_span(root):
    out = execute(load_cell("flagship.spmv", root), 2**31 + 12, 0.3, False,
                  device="cpu", log=lambda _: None)
    assert set(out["metrics"]) == {"setup_s"}


def test_the_kernel_load_reader_reads_none_without_a_load(root):
    from types import SimpleNamespace

    from spmv_scpa_tpu_torch import trace

    cell = load_cell("flagship.spmv", root)
    trace.reset()
    run = SimpleNamespace(t0=0.0, setup_s=1e9)
    assert cell.module("metrics", "kernel_load_s").read(run) is None
    with trace.span("kernels.load", name="lane_rows", built=False):
        pass
    assert cell.module("metrics", "kernel_load_s").read(run) > 0
    trace.reset()


def test_the_float64_pack_reads_its_upload_alone(root):
    """cuda-hybrid-fp64's pack records its upload as a span of its own;
    its plan and layout are one span, so neither part is read there."""
    out = execute(load_cell("flagship-fp64.spmv", root), 2**31 + 13, 0.3,
                  True, device="cpu", log=lambda _: None)
    metrics = out["metrics"]
    assert out["correct"] is True
    upload = metrics["pack_upload_s"]["value"]
    assert 0 < upload <= metrics["pack_s"]["value"]
    assert not set(metrics) & {"pack_plan_s", "pack_layout_s",
                               "call_host_ms", "kernel_load_s"}

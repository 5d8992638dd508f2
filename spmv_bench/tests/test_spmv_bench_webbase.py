"""The cell ``webbase1m.spmv``: the configuration ``webbase1m`` (SuiteSparse
Williams/webbase-1M at its source's size), the traffic ``spmv-xpose``,
its limits, the eleven per-layer metrics the cells share, and the four
metrics of ``cuda-xpose``'s stages (``xpose_roofline.py``). At sizes the
CPU holds, on a copy whose configuration has fewer rows."""

import inspect
import json

import numpy as np
import pytest
import torch

from spmv_bench import reference, roofline, xpose_roofline
from spmv_bench.control import readings
from spmv_bench.generators import amazon
from spmv_bench.harness import inputs
from spmv_bench.run import execute
from spmv_bench.spec import ROOT, load_cell
from spmv_bench.tests.small import copy_bench
from spmv_bench.tests.test_spmv_bench_spec import FIRST, SPANS
from spmv_scpa_tpu_torch import testing

H100 = "NVIDIA H100 80GB HBM3"
CELL = "webbase1m.spmv"
METRICS = ["xpose_s1_ms", "xpose_s3_ms", "xpose_s1_roofline",
           "xpose_s3_roofline"]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("bench"),
                      rows={"webbase1m": 30000})


# ---- what is committed -------------------------------------------------------

def test_the_configuration_is_webbase1m_at_its_source_size():
    cfg = load_cell(CELL).config
    entry = next(c for c in BENCH["configs"] if c["name"] == "webbase1m")
    assert entry["source"] == cfg["source"] == \
        "https://sparse.tamu.edu/Williams/webbase-1M"
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["rows"] == cfg["cols"] == cfg["source_rows"] == \
        cfg["args"]["m"] == 1_000_005
    assert cfg["source_nnz"] == 3_105_536
    assert abs(cfg["nnz"] / cfg["source_nnz"] - 1) < 2e-3
    assert cfg["dtype"] == "float32"
    assert cfg["value_bytes"] == 4 * cfg["nnz"]
    assert round(cfg["value_bytes"] / cfg["l2_bytes"], 2) == 0.24


def test_every_other_argument_is_webbase_csrs():
    """The generator's arguments are the port's ``webbase_csr`` defaults
    but the rows, the draws a row, the seed and the name."""
    args = load_cell(CELL).config["args"]
    defaults = {k: p.default for k, p in inspect.signature(
        testing.webbase_csr).parameters.items()}
    assert set(args) == set(defaults)
    for k in set(defaults) - {"m", "avg_nnz", "seed", "name"}:
        assert args[k] == defaults[k], k


def test_the_frozen_generator_builds_the_ports_webbase():
    kw = {**load_cell(CELL).config["args"], "m": 20000, "name": "w"}
    a, b = amazon.build(**kw), testing.webbase_csr(**kw)
    for x, y in ((a.irp, b.irp), (a.ja, b.ja), (a.vals, b.as_)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_the_cell_names_cuda_xpose_and_its_metrics():
    cell = load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic == {**cell.traffic, "cols": 1, "vectors": 4,
                            "strategy": "cuda-xpose", "knobs": {}}
    assert [m["name"] for m in cell.end_to_end] == [
        "gflops", "call_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == FIRST + SPANS + METRICS
    assert set(cell.checks["limits"]) == {"row_err", "rel_l2"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)
    # the other cells do not report the new metrics
    for other in ("flagship.spmv", "flagship.spmm8", "flagship-fp64.spmv"):
        assert not set(METRICS) & {m["name"] for m in
                                   load_cell(other).per_layer}


# ---- the bounds, worked by hand ----------------------------------------------

def test_the_stage_bounds_worked_by_hand():
    """At the card host's 3,106,075 entries and 1,000,005 rows: S1 reads
    12,424,300 B of values and 4,000,020 B of x and writes 12,424,300 B
    of products, 28,848,620 B, 0.0086115 ms at 3.35 TB/s; S3 reads the
    products and writes 4,000,020 B of y, 16,424,320 B, 0.0049028 ms;
    the call's own bound (``roofline.py``) 20,424,340 B, 0.0060968 ms."""
    nnz, m = 3_106_075, 1_000_005
    assert xpose_roofline.stage_bytes("s1", nnz, m, m) == 28_848_620
    assert xpose_roofline.stage_bytes("s3", nnz, m, m) == 16_424_320
    assert xpose_roofline.bound_ms(H100, "s1", nnz, m, m) == \
        pytest.approx(28_848_620 / 3.35e9, rel=1e-15)
    assert xpose_roofline.bound_ms(H100, "s3", nnz, m, m) == \
        pytest.approx(16_424_320 / 3.35e9, rel=1e-15)
    assert round(xpose_roofline.bound_ms(H100, "s1", nnz, m, m), 7) == \
        0.0086115
    assert round(xpose_roofline.bound_ms(H100, "s3", nnz, m, m), 7) == \
        0.0049028
    assert round(roofline.bound_ms(H100, nnz, m, m, 1), 7) == 0.0060968
    # one operation an entry: bytes bound both stages
    assert nnz / 67e9 < xpose_roofline.bound_ms(H100, "s3", nnz, m, m)
    assert xpose_roofline.bound_ms("another card", "s1", nnz, m, m) is None
    with pytest.raises(ValueError, match="no XPOSE stage"):
        xpose_roofline.stage_bytes("s2", nnz, m, m)


class _Run:
    """What the stage readers read of a ``harness.Run``."""

    kind = H100

    def __init__(self, prof, device_ms=0.09, nnz=3_106_075, m=1_000_005):
        self._prof, self._ms = prof, device_ms
        self.mat = type("M", (), {"nnz": nnz, "m": m, "n": m})()

    def profile(self):
        return self._prof

    def device_ms(self):
        return self._ms


def _window(whole=True, ops=(("s1_slots_kernel", 0.009),
                             ("s3_rows_kernel", 0.018),
                             ("Memset (Device)", 0.003))):
    return {"busy_s": 0.03, "window_s": 0.032, "whole": whole,
            "breakdown": {"device_ops": [list(o) for o in ops],
                          "idle_gaps": []}}


def test_a_stage_reads_its_kernels_share_of_the_call():
    run = _Run(_window())
    assert xpose_roofline.stage_ms(run, "s1") == pytest.approx(0.027)
    assert xpose_roofline.stage_ms(run, "s3") == pytest.approx(0.054)
    s1 = xpose_roofline.bound_ms(H100, "s1", 3_106_075, 1_000_005,
                                 1_000_005)
    assert xpose_roofline.stage_roofline(run, "s1") == \
        pytest.approx(100 * s1 / 0.027)
    assert 0 < xpose_roofline.stage_roofline(run, "s3") < 100


@pytest.mark.parametrize("prof, ms", [
    (None, 0.09),                                    # off the card
    (_window(whole=False), 0.09),                    # events lost
    (_window(ops=(("lane_rows_kernel<2>", 0.03),)), 0.09),  # no XPOSE
    (_window(), None)])
def test_a_stage_reads_none_where_there_is_nothing_to_read(prof, ms):
    run = _Run(prof, ms)
    for stage in ("s1", "s3"):
        assert xpose_roofline.stage_ms(run, stage) is None
        assert xpose_roofline.stage_roofline(run, stage) is None


# ---- the cell on the CPU, at 30,000 rows -------------------------------------

def test_the_cell_runs_and_is_correct_on_a_small_copy(root):
    cell = load_cell(CELL, root)
    assert cell.config["rows"] == 30000
    out = execute(cell, 2**31 + 11, 0.3, True, device="cpu",
                  log=lambda _: None)
    assert out["correct"] is True and out["attempted"] > 0
    for c in out["checks"].values():
        assert c["value"] < c["limit"] / 10
    # off the card the device readers find nothing; the pack's spans
    # and counters are the host's
    metrics = out["metrics"]
    assert set(metrics) == {"pack_s", "port_kernel_calls", "pack_plan_s",
                            "pack_layout_s", "pack_upload_s"}
    for name in ("pack_s", "pack_plan_s", "pack_layout_s", "pack_upload_s"):
        assert metrics[name]["value"] > 0
    parts = sum(metrics[name]["value"] for name in
                ("pack_plan_s", "pack_layout_s", "pack_upload_s"))
    assert parts <= metrics["pack_s"]["value"]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_control_fails_the_cell(root, seed):
    cell = load_cell(CELL, root)
    limits = cell.checks["limits"]
    got = readings(cell, seed, "cpu")
    assert all(got[k] > limits[k] for k in limits), (got, limits)


def test_the_control_in_the_programs_place_is_not_correct(root):
    cell = load_cell(CELL, root)
    mat, _ = inputs(cell, 5)

    def control(_fn):
        return lambda x: reference.control_product(mat, x).reshape(-1)

    out = execute(cell, 5, 0.3, False, device="cpu", fault=control,
                  log=lambda _: None)
    assert out["correct"] is False and out["failed"] > 0


def test_one_wrong_row_is_not_correct(root):
    """One row's y off by about a tenth of a typical row's |A||x|."""
    def altered(fn):
        def call(x):
            y = fn(x).clone()
            y[y.shape[0] // 3] += 0.3
            return y
        return call

    out = execute(load_cell(CELL, root), 11, 0.3, False, device="cpu",
                  fault=altered, log=lambda _: None)
    assert out["correct"] is False and out["failed"] > 0


def test_the_small_copy_runs_the_slot_table_designs(root):
    """The run's strategy is the traffic's, on the designs that run past
    254 steps, and its y is the reference's."""
    from spmv_scpa_tpu_torch.formats.csr import CSR
    from spmv_scpa_tpu_torch.ops.registry import get_strategy
    cell = load_cell(CELL, root)
    mat, xs = inputs(cell, 7)
    A = CSR(name="w", m=mat.m, n=mat.n, irp=mat.irp, ja=mat.ja,
            as_=mat.vals)
    prep = get_strategy(cell.traffic["strategy"]).prepare(
        A, device="cpu", **cell.traffic["knobs"])
    assert (prep.meta["s3"], prep.meta["s1"]) == ("rows", "slots")
    Y, S = reference.product(mat, torch.from_numpy(xs[0]))
    got = reference.compare(prep.fn(torch.from_numpy(xs[0])), Y, S)
    assert got["rel_l2"] < 1e-6

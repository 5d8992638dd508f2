"""Cells, configurations, traffic mixes and metrics are found by name:
adding one is adding files and entries."""

import json

import pytest

from spmv_bench.run import execute
from spmv_bench.spec import ROOT, load_cell
from spmv_bench.tests.small import copy_bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# The per-layer metrics each cell was committed with, in their order; a
# later entry in BENCHMARK.json may follow them.
FIRST = ["pack_s", "host_enqueue_ms", "port_kernel_calls", "device_ms",
         "kernel_roofline", "device_idle_share"]
SPANS = ["pack_plan_s", "pack_layout_s", "pack_upload_s", "kernel_load_s",
         "call_host_ms"]
PER_LAYER = {
    "flagship.spmv": FIRST + SPANS,
    "flagship.spmm8": FIRST + SPANS,
    # the fp64 pack records no pack.layout span, and its one pack.plan
    # span covers the whole pack
    "flagship-fp64.spmv": FIRST + ["pack_upload_s", "kernel_load_s",
                                   "call_host_ms"],
    "webbase1m.spmv": FIRST + SPANS,
}
CELLS = tuple(PER_LAYER)


@pytest.mark.parametrize("name", CELLS)
def test_every_piece_of_a_cell_is_a_file(name):
    cell = load_cell(name)
    assert cell.chips == 1
    assert (ROOT / "spmv_bench" / "generators"
            / f"{cell.config['generator']}.py").is_file()
    assert set(cell.checks["limits"]) == {"row_err", "rel_l2"}
    assert [m["name"] for m in cell.end_to_end] == [
        "gflops", "call_p95_ms", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names[:len(PER_LAYER[name])] == PER_LAYER[name]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)


def test_benchmark_names_the_files_it_needs():
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] == \
            cfg["name"]
    for wl in BENCH["workloads"]:
        assert (ROOT / "spmv_bench" / "traffic"
                / f"{wl['traffic']}.json").is_file()


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration with its own generator, a traffic mix, a cell with
    its limits and a per-layer metric, added as new files and entries in
    a copy: the harness finds and runs them, and no file changes."""
    root = copy_bench(tmp_path)
    sb = root / "spmv_bench"
    before = {p: p.read_bytes() for p in sb.rglob("*") if p.is_file()}
    (sb / "generators" / "diagonal.py").write_text(
        "import numpy as np\n"
        "from spmv_bench.csr import from_coo\n"
        "def build(m):\n"
        "    i = np.arange(m)\n"
        "    return from_coo('diag', m, m, np.r_[i, i[1:]], "
        "np.r_[i, i[:-1]], np.ones(2 * m - 1))\n")
    (sb / "configs" / "diag.json").write_text(json.dumps(
        {"name": "diag", "generator": "diagonal", "args": {"m": 3000},
         "rows": 3000, "cols": 3000, "nnz": 5999}))
    (sb / "traffic" / "spmm2.json").write_text(json.dumps(
        {"cols": 2, "vectors": 3, "strategy": "torch-csr-segsum",
         "knobs": {}}))
    (sb / "checks" / "diag.spmm2.json").write_text(json.dumps(
        {"limits": {"row_err": 1e-5, "rel_l2": 1e-5}}))
    (sb / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return run.calls\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "diag", "source": "https://x",
                             "file": "spmv_bench/configs/diag.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "diag.spmm2", "config": "diag",
                               "traffic": "spmm2", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "call_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("diag.spmm2", root)
    assert cell.traffic["cols"] == 2 and cell.config["generator"] == \
        "diagonal"
    assert [m["name"] for m in cell.per_layer] == ["calls_seen"]
    # the metric without a list goes to every cell reporting call_p95_ms
    assert "calls_seen" in [m["name"] for m in
                            load_cell("flagship.spmv", root).per_layer]
    out = execute(cell, 7, 0.2, True, device="cpu", log=lambda _: None)
    assert out["correct"] is True
    assert out["metrics"]["calls_seen"]["value"] == out["attempted"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_matrix_other_than_the_configurations_is_refused(tmp_path):
    """The generator's matrix has to have the rows, columns and entries
    the configuration states, or the cell measures another matrix."""
    import dataclasses

    from spmv_bench.harness import inputs
    root = copy_bench(tmp_path)
    cell = load_cell("flagship.spmv", root)
    mat, xs = inputs(cell, 3)
    assert mat.nnz == cell.config["nnz"] and xs.shape == (4, mat.n)
    for key, off in (("nnz", 1), ("rows", -1), ("cols", 1)):
        other = dataclasses.replace(
            cell, config={**cell.config, key: cell.config[key] + off})
        with pytest.raises(ValueError, match="configuration states"):
            inputs(other, 3)


@pytest.mark.parametrize("name, itemsize", [("flagship.spmv", 4),
                                            ("flagship-fp64.spmv", 8)])
def test_the_committed_configuration_states_its_matrix(name, itemsize):
    cfg = load_cell(name).config
    assert (cfg["rows"], cfg["cols"]) == (cfg["source_rows"],) * 2
    assert cfg["value_bytes"] == itemsize * cfg["nnz"]
    assert cfg["reduced"] == [] == next(
        c for c in BENCH["configs"] if c["name"] == cfg["name"])["reduced"]
    # within a tenth of a percent of the source's entries
    assert abs(cfg["nnz"] / cfg["source_nnz"] - 1) < 1e-3


def test_the_float64_configuration_is_the_flagships_structure():
    """flagship-fp64 differs from flagship in its precision alone."""
    f32 = load_cell("flagship.spmv").config
    f64 = load_cell("flagship-fp64.spmv").config
    assert (f32["dtype"], f64["dtype"]) == ("float32", "float64")
    for key in ("source", "generator", "args", "rows", "cols", "nnz",
                "source_rows", "source_nnz", "l2_bytes"):
        assert f64[key] == f32[key], key
    # values 4.2x the card's L2, so no call is served from it
    assert round(f64["value_bytes"] / f64["l2_bytes"], 1) == 4.2

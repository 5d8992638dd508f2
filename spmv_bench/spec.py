"""What a cell is made of, found by name from ``BENCHMARK.json``.

A workload entry names a configuration and a traffic mix. The
configuration's file is the one its ``configs`` entry gives. Of its keys
the harness reads ``name``, ``generator`` and ``args`` (the structure),
``rows``, ``cols`` and ``nnz`` (what the generator has to build) and
``dtype`` (``float32``, the default, or ``float64``), which sets the
type A's values and X are drawn in, the bytes and the rate of the bound
(``roofline.bound_ms``) and the control (``reference.control_product``);
the other keys document the deployment. The rest lies beside it by
name: ``generators/<generator>.py`` (named in the
configuration's file), ``traffic/<traffic>.json``, ``checks/<cell>.json``
(the limits of the numbers that decide ``correct``) and one reader
``metrics/<metric>.py`` a metric. A cell reports the end-to-end metrics
whose ``workloads`` list names it (all of them where there is no list)
and the per-layer metrics likewise, where a per-layer metric without a
list goes to every cell that reports the end-to-end metric it moves.
Adding a cell, configuration, traffic mix or metric is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list      # BENCHMARK.json entries
    per_layer: list
    root: Path

    def module(self, kind: str, name: str):
        """``spmv_bench/<kind>/<name>.py`` under this cell's root."""
        return load_module(self.root / "spmv_bench" / kind / f"{name}.py")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"spmv_bench._{path.parent.name}_{path.stem}".replace(".", "_"),
        path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        known = [w["name"] for w in bench["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {known}") from None
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = _read(root / entry["file"])
    traffic = _read(root / "spmv_bench" / "traffic" / f"{wl['traffic']}.json")
    checks = _read(root / "spmv_bench" / "checks" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(wl["chips"]), config, traffic, checks, e2e, layer,
                root)

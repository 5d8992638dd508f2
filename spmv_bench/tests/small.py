"""A copy of the benchmark at sizes the CPU tests can hold: the
configurations' generators at fewer rows, with the shape and count of
entries each configuration states set to what the generator builds
there; everything else as committed."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from spmv_bench.spec import ROOT, load_module

SMALL_ROWS = {"flagship": 1500, "flagship-fp64": 1500}


def copy_bench(dest: Path, rows=SMALL_ROWS) -> Path:
    shutil.copytree(ROOT / "spmv_bench", dest / "spmv_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, m in rows.items():
        path = dest / "spmv_bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["args"]["m"] = m
        gen = load_module(dest / "spmv_bench" / "generators"
                          / f"{cfg['generator']}.py")
        mat = gen.build(**cfg["args"])
        cfg.update(rows=mat.m, cols=mat.n, nnz=mat.nnz)
        path.write_text(json.dumps(cfg))
    return dest

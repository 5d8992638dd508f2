"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m spmv_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted`` (calls in both windows),
``failed`` (judged calls that failed), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown`` where the profiler's window
saw every launch, and last ``checks``: each number compared beside its
limit, which are also the last lines of standard error. The run exits
with another code than 0, and prints no result, without a card (or
with fewer than the cell asks for), or when ``jax``, ``jaxlib``,
``flax`` or the JAX package was loaded by the time the window closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout (the port's
# own nvcc and g++ libraries live in spmv_scpa_tpu_torch/_build/).
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

# Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_scpa_tpu")


def forbidden_loaded() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m spmv_bench.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(run, judged: dict, metrics: dict, trace: bool) -> dict:
    device = {"platform": "gpu" if run.on_card else "cpu",
              "kind": run.kind, "count": run.cell.chips,
              "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": judged["correct"], "attempted": run.calls,
           "failed": judged["failed"], "metrics": metrics, "device": device}
    if trace:
        prof = run.profile()
        if prof is not None:
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
            if "breakdown" in prof:
                out["breakdown"] = prof["breakdown"]
    # a non-finite reading (a y with NaN or infinity) as its name, so the
    # line stays JSON
    out["checks"] = {k: {n: v if math.isfinite(v) else str(v)
                         for n, v in c.items()}
                     for k, c in judged["checks"].items()}
    return out


def execute(cell, seed, seconds, trace, device="cuda", fault=None,
            t0=None, log=print):
    """Set-up, window, readers and judgement of one run; the result's
    dict. ``log`` takes the lines that go to standard error."""
    import numpy as np

    from spmv_bench.harness import Run
    run = Run(cell, seed, seconds, device=device, t0=t0)
    run.setup(fault=fault)
    log(f"[{cell.name}] seed {seed} | {run.strategy} | nnz {run.mat.nnz} "
        f"m {run.mat.m} n {run.mat.n} cols {run.cols} | hbm_bytes "
        f"{run.prep.hbm_bytes} | pack {run.pack_s:.3f} s | set-up "
        f"{run.setup_s:.3f} s")
    run.window()
    q = np.percentile(run.spans_ms, [0, 50, 95, 100]) \
        if run.spans_ms.size else []
    log(f"[{cell.name}] windows: rate {run.rate_calls} calls in "
        f"{run.rate_wall_s:.4f} s, tail {run.calls - run.rate_calls} calls "
        f"in {run.tail_wall_s:.4f} s, {run.launches} port launches, peak "
        f"{run.memory_peak} B | tail's spans ms min, median, p95, max: "
        f"{', '.join(f'{v:.4f}' for v in q)}")
    metrics = run.read_metrics(cell.per_layer if trace else cell.end_to_end)
    if trace and run.profile() is not None:
        log(f"[{cell.name}] {run.profile()['line']}")
    run.release()
    return result(run, run.judge(), metrics, trace)


def main(argv=None) -> int:
    args = parse(argv)
    from spmv_bench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s), found "
              f"{found}; no result", file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    out = execute(cell, args.seed, args.seconds, bool(args.trace), t0=T0,
                  log=log)
    bad = forbidden_loaded()
    if bad:
        log(f"modules loaded that the benchmark may not load: {bad}; "
            "no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

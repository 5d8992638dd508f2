"""Batch benchmark driver (counterpart of ``scripts/results.py``; the
reference study's scripts/results.py:5-40).

Iterates matrices (``*.mtx`` files in a directory, and/or the synthetic
suite ``SYNTH_SUITE``) and runs the port's CLI (``spmv_scpa_tpu_torch.cli``)
on each, ``-i`` times; the CSV rows of every run accumulate in one
results directory (the logger appends), and ``plots`` takes the medians.
Runs are in process by default; ``--subprocess`` runs each in its own
``python -m spmv_scpa_tpu_torch.cli``, as the reference study does.
``--compare`` times one validated cell per strategy and matrix instead
and prints a markdown table (``auto`` as a strategy times what
``pick_auto`` routes to, labelled ``auto->name``). ``--device``: where
the strategies run, ``cuda`` (the card, the default) or ``cpu`` (the
kernels' plain versions, timed on the host clock).

Run: ``python -m spmv_scpa_tpu_torch.scripts.results -o res/ -i 3``.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

# The synthetic stand-ins for the reference study's 30-matrix SuiteSparse
# suite: the same structural archetypes, without a download.
SYNTH_SUITE = [
    "synth:banded:m=4000,row_nnz=9,bandwidth=48,runs=3,seed=1",       # olm1000-ish
    "synth:banded:m=62000,row_nnz=64,bandwidth=300,runs=8,seed=2",    # cant-ish
    "synth:stencil:m=377000,points=6,run_len=12,bandwidth=500,seed=3",  # ML_Laplace-ish
    "synth:random:m=30000,n=30000,density=0.0005,seed=4",             # mac_econ-ish
    "synth:powerlaw:m=100000,n=100000,avg_nnz=8,seed=5",              # no-locality stress
    "synth:webbase:m=1000000,seed=7",                                 # webbase-1M stand-in
    "synth:amazon:m=262000,seed=6",                                   # amazon0302 stand-in
]

COMPARE_STRATEGIES = ["auto", "cuda-hybrid", "cuda-pell", "cuda-xpose",
                      "cuda-nearfar", "cuda-chips", "torch-csr-segsum"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load(spec: str):
    """A matrix spec (``synth:...`` or a ``.mtx`` path, through the
    layout cache) -> CSR."""
    from spmv_scpa_tpu_torch.cli import parse_synth_spec
    from spmv_scpa_tpu_torch.io.cache import load_csr_cached

    return (parse_synth_spec(spec) if spec.startswith("synth:")
            else load_csr_cached(spec))


def compare(specs: list[str], strategies: list[str], out: str | None,
            device: str = "cuda") -> tuple[int, str]:
    """One validated cell per strategy per matrix, as a markdown table:
    (1 if any cell failed otherwise than by a refusal else 0, the
    table). A refusal (``ValueError``) is a row of its own; any other
    error is counted and named. The table is printed and, with ``out``,
    appended to ``out/compare.md``."""
    from spmv_scpa_tpu_torch.bench.timing import time_prepared
    from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
    from spmv_scpa_tpu_torch.ops.registry import get_strategy, pick_auto
    from spmv_scpa_tpu_torch.utils.validation import validate_result
    from spmv_scpa_tpu_torch.utils.vector import make_x

    lines = ["| matrix | strategy | ms | GF/s | rel_err |",
             "|---|---|---|---|---|"]
    failures = 0
    for spec in specs:
        A = load(spec)
        x = make_x(A.n)
        gold = spmv_oracle(A, x)
        print(f"=== {A.name} ({A.m}x{A.n}, nnz={A.nnz}) ===", flush=True)
        for name in strategies:
            label = name
            try:
                if name == "auto":
                    name = pick_auto(A)
                    label = f"auto->{name}"
                prep = get_strategy(name).prepare(A, device=device)
                r = time_prepared(prep, x, device=device)
                rel = validate_result(gold, r.data, what=label)
            except ValueError as e:
                print(f"  {label:24s} refused: {e}", flush=True)
                lines.append(f"| {A.name} | {label} | — | — | refused |")
                continue
            except Exception as e:
                failures += 1
                print(f"  {label:24s} FAILED: {type(e).__name__}: {e}",
                      flush=True)
                lines.append(f"| {A.name} | {label} | — | — | "
                             f"{type(e).__name__} |")
                continue
            print(f"  {label:24s} {r.duration_ms:10.4f} ms "
                  f"{r.gflops:8.2f} GF/s", flush=True)
            lines.append(f"| {A.name} | {label} | {r.duration_ms:.4f} "
                         f"| {r.gflops:.2f} | {rel:.2e} |")
    table = "\n".join(lines)
    print(table)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "compare.md"), "a") as f:
            f.write(table + "\n")
    return (1 if failures else 0), table


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m spmv_scpa_tpu_torch.scripts.results",
        description="batch driver of the port's CLI over a matrix suite")
    ap.add_argument("-d", "--matrices-dir", default=None,
                    help="directory of .mtx files")
    ap.add_argument("--synth-suite", action="store_true",
                    help="run the built-in synthetic archetype suite")
    ap.add_argument("--compare", action="store_true",
                    help="one validated cell per strategy per matrix, as "
                         "a markdown table")
    ap.add_argument("-o", "--out", required=True, help="results dir")
    ap.add_argument("-i", "--iterations", type=int, default=3)
    ap.add_argument("--debug", action="store_true",
                    help="validate against the golden each run")
    ap.add_argument("--bench", default=None,
                    help="strategy filter (the port's names)")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each CLI call in its own process "
                         "(the reference study's semantics)")
    ap.add_argument("--host-parallel", action="store_true",
                    help="also run the native OpenMP thread sweep")
    ap.add_argument("--distributed", action="store_true",
                    help="also benchmark the row-sharded path")
    ap.add_argument("--spmm-cols", default="0",
                    help="comma list of SpMM widths (forwarded to the "
                         "CLI; 0 disables)")
    ap.add_argument("--chunks", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    specs: list[str] = []
    if args.matrices_dir:
        specs += sorted(glob.glob(os.path.join(args.matrices_dir, "*.mtx")))
    if args.synth_suite or not specs:
        specs += SYNTH_SUITE

    if args.compare:
        strategies = (args.bench.split(",") if args.bench
                      else COMPARE_STRATEGIES)
        return compare(specs, strategies, args.out, args.device)[0]

    from spmv_scpa_tpu_torch.cli import main as cli_main

    failures = 0
    for spec in specs:
        for it in range(args.iterations):
            print(f"=== {spec} (iter {it + 1}/{args.iterations}) ===",
                  flush=True)
            argv = ["-m", spec, "-o", args.out, "--device", args.device]
            if args.debug:
                argv.append("-d")
            if args.bench:
                argv += ["-b", args.bench]
            if args.host_parallel:
                argv.append("--host-parallel")
            if args.distributed:
                argv.append("--distributed")
            if args.spmm_cols and args.spmm_cols != "0":
                argv += ["--spmm-cols", str(args.spmm_cols)]
            if args.chunks:
                argv += ["--chunks", args.chunks]
            if args.subprocess:
                rc = subprocess.run(
                    [sys.executable, "-m", "spmv_scpa_tpu_torch.cli", *argv],
                    cwd=ROOT).returncode
            else:
                rc = cli_main(argv)
            if rc != 0:
                failures += 1
                print(f"!!! run failed rc={rc}: {spec}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

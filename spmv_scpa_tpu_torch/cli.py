"""Command-line interface, the reference study's binary (counterpart of
``spmv_scpa_tpu/cli.py``): ``python -m spmv_scpa_tpu_torch.cli -m X.mtx
-o res/ -d`` writes ``serial.csv``, ``omp.csv`` and ``cuda.csv`` under
``res/``.

The reference's flags (main.c:35-64): ``-m/--matrix`` (path, required),
``-o/--out`` (results dir, required), ``-d/--debug`` (validate against
the serial golden), ``-b/--bench`` (dead in the reference, a strategy
filter here), ``-h/--help``. The JAX package's extensions, with the same
meaning: ``-m synth:<archetype>:k=v,...`` (a synthetic matrix,
``testing.ARCHETYPES``), ``--chunks`` (the tuning sweep),
``--spmm-cols``, ``--distributed``, ``--host-parallel``, ``--no-cache``,
``--print-result``, ``--list-strategies``, ``--seed``, and the TPU knobs
``--quantum``, ``--window-h``, ``--precision-passes`` and ``--idx8``,
which pass through to ``prepare`` (the port's strategies record what
they do not use in ``meta["tpu_knobs"]`` / ``meta["tile_knobs"]``). The
port's own: ``--device`` (``cuda``, the default, or ``cpu`` for the
kernels' plain versions timed on the host clock).

Exit codes are errno-style, as the reference's ERR_PTR convention
(err.h:10-12): 2 for a usage error, an ``SpmvError``'s code, 1 for a
file that cannot be read. Any other exception (a kernel build, a CUDA
error) propagates, and Python exits non-zero.
"""

from __future__ import annotations

import argparse
import logging
import sys
from dataclasses import dataclass, field

import numpy as np

from spmv_scpa_tpu_torch.errors import ConfigError, SpmvError


def parse_synth_spec(spec: str):
    """``synth:banded:m=1000,row_nnz=32,seed=1`` -> CSR."""
    from spmv_scpa_tpu_torch import testing as synth

    parts = spec.split(":")
    if len(parts) < 2 or parts[0] != "synth":
        raise ConfigError(f"bad synth spec {spec!r}")
    archetype = parts[1]
    if archetype not in synth.ARCHETYPES:
        raise ConfigError(
            f"unknown archetype {archetype!r}; have {sorted(synth.ARCHETYPES)}")
    kwargs = {}
    if len(parts) > 2 and parts[2]:
        for kv in parts[2].split(","):
            k, _, v = kv.partition("=")
            try:
                kwargs[k] = int(v)
            except ValueError:
                try:
                    kwargs[k] = float(v)   # handles 1e-3 etc.
                except ValueError:
                    raise ConfigError(
                        f"bad numeric value {v!r} in synth spec {spec!r}"
                    ) from None
    A = synth.ARCHETYPES[archetype](**kwargs)
    return A.with_name(f"{archetype}_" + "_".join(
        f"{k}{v}" for k, v in sorted(kwargs.items())))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spmv_scpa_tpu_torch",
        description="SpMV benchmark suite on an NVIDIA card "
                    "(CSR/HLL/LELL/BCSR/PELL/XPOSE x torch/CUDA strategies)")
    p.add_argument("-m", "--matrix",
                   help=".mtx path or synth:<archetype>:k=v,...")
    p.add_argument("-o", "--out", help="results directory (CSV logs)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="validate every result against the serial golden")
    p.add_argument("-b", "--bench", default=None,
                   help="comma-separated strategy filter "
                        "(dead flag in the reference, live here)")
    p.add_argument("--chunks", default="32,64,128,256",
                   help="chunk sweep of the tunable strategies")
    p.add_argument("--quantum", type=int, default=None,
                   help="PELL slot quantum (8/16/32/64/128)")
    p.add_argument("--window-h", type=int, default=None,
                   help="epilogue window height in 8-row blocks")
    p.add_argument("--precision-passes", type=int, default=None,
                   help="the TPU's bf16 passes for an f32 reduction (2 or "
                        "3; recorded, Hopper adds in f32)")
    p.add_argument("--idx8", action="store_true",
                   help="int8 index planes on <=2-strip hybrid planes "
                        "(slot bytes 6 -> 5; ops/lane_ell.py)")
    p.add_argument("--spmm-cols", default="0",
                   help="also benchmark multi-vector SpMM at these "
                        "widths (comma list, e.g. 8,32,64; 0 = off)")
    p.add_argument("--seed", type=int, default=42, help="x vector seed")
    p.add_argument("--distributed", action="store_true",
                   help="also benchmark the row-sharded path over "
                        "this host's cards (strategy id 9)")
    p.add_argument("--host-parallel", action="store_true",
                   help="also run the native C++/OpenMP kernels swept "
                        "over thread counts -> omp.csv (without g++: "
                        "torch on the CPU, one row each)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the .npz preprocessed-layout cache "
                        "(the reference re-parses the .mtx every run, "
                        "csr.c:31-171; we cache by default)")
    p.add_argument("--print-result", type=int, default=0, metavar="N",
                   help="print the first N entries of each result "
                        "vector (reference: print_result_vector)")
    p.add_argument("--device", default="cuda",
                   help="where the strategies run: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--list-strategies", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


@dataclass
class CliRun:
    """What one CLI run did: its exit code, its ``RunConfig`` (with the
    skipped cells) and its ``RowResult``s, once the benchmarks ran."""

    code: int
    cfg: object = None
    results: list = field(default_factory=list)


def main(argv=None) -> int:
    return run(argv).code


def run(argv=None) -> CliRun:
    """:func:`main`, returning the run's config and results too."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    from spmv_scpa_tpu_torch.ops.registry import get_strategy, list_strategies

    if args.list_strategies:
        for name in list_strategies():
            s = get_strategy(name)
            print(f"{name:22s} fmt={s.fmt:5s} backend={s.backend:6s} "
                  f"ref={s.ref}")
        return CliRun(0)

    if not args.matrix or not args.out:
        print("error: -m/--matrix and -o/--out are required "
              "(see --help)", file=sys.stderr)
        return CliRun(2)

    try:
        if args.matrix.startswith("synth:"):
            A = parse_synth_spec(args.matrix)
        elif args.no_cache:
            from spmv_scpa_tpu_torch.io.loader import load_csr
            A = load_csr(args.matrix)
        else:
            # the default-on .npz layout cache: a repeat sweep skips the
            # parse (the reference re-parses every run, csr.c:31-171)
            from spmv_scpa_tpu_torch.io.cache import load_csr_cached
            A = load_csr_cached(args.matrix)
    except SpmvError as e:
        print(f"error loading matrix: {e}", file=sys.stderr)
        return CliRun(e.code)
    except OSError as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return CliRun(1)

    print(f"[{A.name}] {A.m} x {A.n}, nnz={A.nnz}")

    from spmv_scpa_tpu_torch.bench.runner import RunConfig, run_benchmarks

    params = {}
    if args.quantum:
        params["quantum"] = args.quantum
    if args.window_h:
        params["window_h"] = args.window_h
    if args.precision_passes:
        params["precision_passes"] = args.precision_passes
    if args.idx8:
        params["idx8"] = True
    cfg = RunConfig(
        out_dir=args.out,
        debug=args.debug,
        strategies=args.bench.split(",") if args.bench else None,
        chunks=tuple(int(c) for c in args.chunks.split(",")),
        seed=args.seed,
        host_parallel=args.host_parallel,
        params=params,
        spmm_cols=tuple(c for c in
                        (int(s) for s in str(args.spmm_cols).split(","))
                        if c > 0),
        distributed=args.distributed,
        device=args.device,
    )
    try:
        results = run_benchmarks(A, cfg)
    except SpmvError as e:
        print(f"benchmark failed: {e}", file=sys.stderr)
        return CliRun(e.code, cfg)

    for r in results:
        err = "" if r.rel_err is None else f"  rel_err={r.rel_err:.2e}"
        chunk = "" if r.chunk is None else f" chunk={r.chunk}"
        print(f"  {r.strategy:18s}{chunk:10s} {r.bench.duration_ms:10.4f} ms"
              f" {r.bench.gflops:9.3f} GFLOPS{err}")
        if args.print_result and r.bench.data is not None:
            head = np.array2string(
                np.asarray(r.bench.data).ravel()[:args.print_result],
                precision=6, max_line_width=100)
            print(f"    y[:{args.print_result}] = {head}")
    if cfg.skipped:
        print(f"WARNING: {len(cfg.skipped)} strategy x chunk cell(s) "
              "produced no row:", file=sys.stderr)
        for name, chunk, why in cfg.skipped:
            print(f"  {name} (chunk={chunk}): {why}", file=sys.stderr)
    print(f"CSV logs appended under {cfg.out_dir}/")
    return CliRun(0, cfg, results)


if __name__ == "__main__":
    sys.exit(main())

"""Parallel-scaling sweep (counterpart of ``scripts/scaling.py``): the
reference study's OpenMP thread sweep (src/main.c:177-180) on the
port's axis, row shards of the row-sharded SpMV
(``parallel/distributed.py``), swept over 1, 2, 4 and 8 shards.

A mesh of k shards is ``make_mesh(devices=[device] * k)``: on one card
the k shards all run on it (one launch a card each for the hybrid's core
and the PELL), so this sweeps the shard wrapper's cost, not copies
between cards; ``--device cpu`` runs the shards' plain versions. The
variants, under the reference's bench names: ``mesh_rowshard`` (the
gather-multiply-``index_add_`` shards), with ``--pell``
``mesh_rowshard_pell`` (the row-sharded PELL, ``window_h=64`` as the
reference asks) and with ``--hybrid`` ``mesh_rowshard_hybrid`` (the
row-sharded lane-ELL hybrid). Each call is validated against the fp64
oracle; a refusal (``ValueError`` at prepare) skips its cell, named on
stderr, and any other error stops the sweep.

Rows go to ``omp.csv`` (``bench/logger.py``) with ``num_threads`` and
``num_blocks`` = the shard count; ``serial.csv`` gets the oracle's row,
so that ``plots`` can draw speedup against parallelism per nnz bin.

Run: ``python -m spmv_scpa_tpu_torch.scripts.scaling -o res/ --pell
--hybrid``.
"""

from __future__ import annotations

import argparse
import sys

DEVICE_COUNTS = (1, 2, 4, 8)

SUITE = [
    ("synth:banded:m=4000,row_nnz=9,bandwidth=48,runs=3,seed=1", {}),
    ("synth:banded:m=62000,row_nnz=64,bandwidth=300,runs=8,seed=2", {}),
    ("synth:random:m=30000,n=30000,density=0.0005,seed=4", {}),
    ("synth:powerlaw:m=100000,n=100000,avg_nnz=8,seed=5", {}),
    ("synth:stencil:m=120000,points=6,run_len=12,bandwidth=500,seed=3", {}),
]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m spmv_scpa_tpu_torch.scripts.scaling",
        description="row-shard scaling sweep of the port's row-sharded "
                    "SpMV")
    ap.add_argument("-o", "--out", required=True, help="results dir")
    ap.add_argument("--devices", default=None,
                    help="comma list of shard counts (default 1,2,4,8)")
    ap.add_argument("--pell", action="store_true",
                    help="also sweep the row-sharded PELL")
    ap.add_argument("--hybrid", action="store_true",
                    help="also sweep the row-sharded lane-ELL hybrid")
    ap.add_argument("-m", "--matrix", default=None,
                    help="single matrix spec (synth:... or .mtx path) "
                         "instead of the built-in suite")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    counts = (tuple(int(c) for c in args.devices.split(","))
              if args.devices else DEVICE_COUNTS)

    from spmv_scpa_tpu_torch.bench.logger import CsvLogger
    from spmv_scpa_tpu_torch.bench.timing import time_host_fn, time_prepared
    from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
    from spmv_scpa_tpu_torch.ops.registry import get_strategy
    from spmv_scpa_tpu_torch.parallel.distributed import (
        make_mesh, prepare_row_sharded, prepare_row_sharded_hybrid,
        prepare_row_sharded_pell)
    from spmv_scpa_tpu_torch.scripts.results import load
    from spmv_scpa_tpu_torch.utils.platform import resolve_device
    from spmv_scpa_tpu_torch.utils.validation import validate_result
    from spmv_scpa_tpu_torch.utils.vector import make_x

    dev = resolve_device(args.device)
    suite = [(args.matrix, {})] if args.matrix else SUITE
    with CsvLogger(args.out) as logger:
        for spec, _ in suite:
            A = load(spec)
            x = make_x(A.n)
            gold = spmv_oracle(A, x)
            print(f"=== {A.name} nnz={A.nnz} ===", flush=True)

            prep = get_strategy("oracle-csr").prepare(A)
            r = time_host_fn(prep.fn, x, nnz=A.nnz)
            logger.log_serial(matrix=A.name, fmt="CSR", rows=A.m,
                              cols=A.n, nnz=A.nnz, num_blocks=None,
                              duration_ms=r.duration_ms, gflops=r.gflops)

            variants = [("mesh_rowshard", prepare_row_sharded, {})]
            if args.pell:
                variants.append(("mesh_rowshard_pell",
                                 prepare_row_sharded_pell,
                                 {"window_h": 64}))
            if args.hybrid:
                variants.append(("mesh_rowshard_hybrid",
                                 prepare_row_sharded_hybrid, {}))
            for bench_name, prepare, kw in variants:
                for nd in counts:
                    mesh = make_mesh(devices=[dev] * nd)
                    try:
                        dist = prepare(A, mesh=mesh, **kw)
                    except ValueError as e:
                        print(f"!!! {bench_name} shards={nd} refused: {e}",
                              file=sys.stderr)
                        continue
                    r = time_prepared(dist, x, device=dev)
                    validate_result(gold, r.data,
                                    what=f"{bench_name} shards={nd}")
                    logger.log_omp(matrix=A.name, fmt="CSR",
                                   bench=bench_name, rows=A.m, cols=A.n,
                                   nnz=A.nnz, num_blocks=nd,
                                   num_threads=nd,
                                   duration_ms=r.duration_ms,
                                   gflops=r.gflops)
                    print(f"  {bench_name:20s} shards={nd}: "
                          f"{r.duration_ms:9.3f} ms {r.gflops:7.3f} "
                          "GFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark orchestration, the reference study's ``main.c`` (counterpart
of ``spmv_scpa_tpu/bench/runner.py``).

The reference's fixed order (main.c:361-379): serial CSR, the golden
(main.c:140-146), then serial HLL, then the host-parallel strategies
(the native OpenMP kernels over a thread sweep, main.c:177-180), then
the device strategies (the port's ``torch`` and ``cuda`` backends, the
JAX package's ``xla`` and ``pallas``), the tunable ones swept over
``chunk`` (the warps_per_block sweep, main.c:265-269), then the
row-sharded path and the SpMM. With ``debug`` every result is validated
against the golden (utils.c:39-60) and a failure aborts the run
(main.c:161-168); every row is appended to the CSV logs.

A refusal is a skipped cell: a strategy whose ``prepare`` raises
``ValueError`` (a budget or a layout it cannot hold) or
``NotImplementedError`` (a branch a strategy does not have; no strategy
of the port raises it) gets no row, and its reason goes into
``RunConfig.skipped``. Any other exception, from a ``prepare`` or a call
(a kernel build, a CUDA error, a wrapper's check), propagates: a fault
never becomes a quiet skipped row, and nothing is retried.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import torch

from spmv_scpa_tpu_torch import trace
from spmv_scpa_tpu_torch.bench.logger import CsvLogger
from spmv_scpa_tpu_torch.bench.timing import (BenchResult, time_host_fn,
                                              time_prepared)
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops.registry import get_strategy, list_strategies
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import DEFAULT_SEED, make_x

log = logging.getLogger("spmv_scpa_tpu_torch.bench")

# Device-strategy tuning sweep (the warps_per_block analog, main.c:265-269).
DEFAULT_CHUNKS = (32, 64, 128, 256)

# What a prepare raises to refuse a cell.
REFUSALS = (ValueError, NotImplementedError)


@dataclass
class RunConfig:
    out_dir: str
    debug: bool = False
    strategies: list[str] | None = None   # None = all registered device
    chunks: tuple = DEFAULT_CHUNKS
    seed: int = DEFAULT_SEED
    host_parallel: bool = False           # also run native OpenMP (omp rows)
    # thread sweep for the OpenMP rows, the reference's (main.c:177-180);
    # it runs whatever the core count
    omp_threads: tuple = (2, 4, 8, 16, 32, 40)
    skip_serial_hll: bool = False
    # extra keywords for the tunable strategies' prepare (quantum,
    # window_h, ...: the reference's hardcoded sweeps, main.c:177-180 and
    # 265-269, as flags); the port's strategies record the TPU-only ones
    params: dict = field(default_factory=dict)
    # multi-vector SpMM widths (BASELINE.json config 3); 0/() = SpMV
    # only; an int benches one width, a tuple sweeps
    spmm_cols: int | tuple = 0
    # also benchmark the row-sharded path (config 5) on this host's
    # cards, logged under strategy id 9
    distributed: bool = False
    # where the device strategies run: "cuda" (the card) or "cpu" (their
    # plain versions, timed on the host clock)
    device: str = "cuda"
    # filled by run_benchmarks: (strategy, chunk, reason) for every cell
    # that produced no row
    skipped: list = field(default_factory=list)


@dataclass
class RowResult:
    strategy: str
    fmt: str
    chunk: int | None
    bench: BenchResult
    rel_err: float | None = None
    meta: dict = field(default_factory=dict)


def _fmt_blocks(prep):
    nb = prep.meta.get("num_blocks")
    return None if nb is None else int(nb)


def _log_setup() -> None:
    """The newest prepare's set-up spans at INFO, as a tree: each span's
    name, attributes, seconds and self seconds."""
    if not log.isEnabledFor(logging.INFO):
        return
    recorded = trace.spans()
    roots = trace.roots("prepare", recorded)
    if not roots:
        return
    for depth, s in trace.tree(roots[-1], recorded):
        log.info("set-up %s%s%s %.3f s (self %.3f s)", "  " * depth,
                 s.name, f" {s.attrs}" if s.attrs else "", s.seconds,
                 trace.self_s(s, recorded))


def _refused(cfg, name, chunk, err) -> None:
    reason = f"refused ({type(err).__name__}): {err}"
    log.warning("%s (chunk=%s) skipped: %s", name, chunk, reason)
    cfg.skipped.append((name, chunk, reason))


def run_benchmarks(A: CSR, cfg: RunConfig) -> list[RowResult]:
    os.makedirs(cfg.out_dir, exist_ok=True)
    results: list[RowResult] = []
    x = make_x(A.n, seed=cfg.seed)

    with CsvLogger(cfg.out_dir) as logger:
        # --- serial golden (main.c:126-146) ---
        prep = get_strategy("oracle-csr").prepare(A)
        _log_setup()
        r = time_host_fn(prep.fn, x, nnz=A.nnz)
        golden = r.data
        logger.log_serial(matrix=A.name, fmt="CSR", rows=A.m, cols=A.n,
                          nnz=A.nnz, num_blocks=None,
                          duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult("oracle-csr", "CSR", None, r, 0.0))
        log.info("serial CSR: %.3f ms (%.3f GFLOPS)", r.duration_ms, r.gflops)

        # --- serial HLL (main.c:150-171) ---
        if not cfg.skip_serial_hll:
            prep = get_strategy("oracle-ell").prepare(A)
            _log_setup()
            r = time_host_fn(prep.fn, x, nnz=A.nnz)
            rel = _check(cfg, golden, r.data, "oracle-ell")
            logger.log_serial(matrix=A.name, fmt="HLL", rows=A.m, cols=A.n,
                              nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                              duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult("oracle-ell", "HLL", None, r, rel))

        # --- host-parallel rows (the OpenMP family, main.c:177-180) ---
        if cfg.host_parallel:
            _run_host_parallel(A, x, golden, cfg, logger, results)

        # --- device strategies (the CUDA family, main.c:255-359) ---
        names = cfg.strategies or list_strategies(backend="torch") + \
            list_strategies(backend="cuda")
        for name in names:
            spec = get_strategy(name)
            if spec.backend == "host":
                continue
            if spec.spmm and name.endswith("-spmm"):
                continue  # multi-vector strategies run in _run_spmm
            # torch strategies and the cuda ones whose plan ignores chunk
            # get one cell: identical rows would be re-packs, nothing more
            chunks = (cfg.chunks if spec.backend == "cuda"
                      and spec.tunable else (0,))
            seen_eff = set()   # effective chunks already logged
            for chunk in chunks:
                kw = dict(cfg.params) if chunk else {}
                if chunk:
                    kw["chunk"] = chunk
                try:
                    prep = spec.prepare(A, device=cfg.device, **kw)
                except REFUSALS as e:
                    _refused(cfg, name, chunk, e)
                    continue
                _log_setup()
                # the fp64 grade states its gate (meta rtol): x and y
                # float64, the absolute gate off
                fp64 = prep.meta.get("rtol")
                r = time_prepared(prep, x, device=cfg.device,
                                  dtype=torch.float64 if fp64
                                  else torch.float32)
                # a plan may cap the requested chunk: log the effective
                # one and drop duplicate cells
                eff = prep.meta.get("chunk", chunk) or chunk
                if eff in seen_eff:
                    log.info("%-16s chunk=%-3s capped to %s (dup row "
                             "dropped)", name, chunk, eff)
                    continue
                seen_eff.add(eff)
                rel = _check(cfg, golden, r.data, f"{name} chunk={eff}",
                             rtol=fp64)
                logger.log_device(matrix=A.name, fmt=spec.fmt, kernel=name,
                                  chunk=eff, rows=A.m, cols=A.n,
                                  nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                                  duration_ms=r.duration_ms,
                                  gflops=r.gflops)
                results.append(RowResult(name, spec.fmt, eff or None, r,
                                         rel, dict(prep.meta)))
                log.info("%-16s chunk=%-3s %10.4f ms %8.2f GFLOPS",
                         name, eff or "-", r.duration_ms, r.gflops)

        # --- row-sharded SpMV (BASELINE config 5) on this host's cards,
        # under its own strategy id (bench/logger.py) ---
        if cfg.distributed:
            _run_distributed(A, x, golden, cfg, logger, results)

        # --- multi-vector SpMM (config 3; no reference analog) ---
        if cfg.spmm_cols:
            _run_spmm(A, cfg, logger, results)
    if cfg.skipped:
        log.warning("%d strategy x chunk cell(s) skipped: %s",
                    len(cfg.skipped),
                    "; ".join(f"{n}(chunk={c}): {why}"
                              for n, c, why in cfg.skipped))
    return results


def _run_spmm(A, cfg, logger, results):
    """The SpMM over the ``cols`` axis. The golden is always computed and
    every row validated (the reference validates its whole sweep in -d
    mode, main.c:282-293). On the card each row also gets its share of
    the card's roofline, over the stream probe's measured bandwidth
    (``bench/roofline.py``): the kernel streams the matrix once for
    2*nnz*cols flops, so GFLOP/s alone overstates how close it runs to
    the card's limit."""
    from spmv_scpa_tpu_torch.bench import roofline as RL
    from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle

    cols_list = (cfg.spmm_cols if isinstance(cfg.spmm_cols, (tuple, list))
                 else (cfg.spmm_cols,))
    bw = None
    for cols in cols_list:
        X = make_x(A.n, cols=cols, seed=cfg.seed)
        golden = spmm_oracle(A, X)
        for name in ("cuda-bcsr-spmm", "torch-csr-segsum-spmm"):
            spec = get_strategy(name)
            try:
                prep = spec.prepare(A, device=cfg.device, cols=cols)
            except REFUSALS as e:
                _refused(cfg, name, cols, e)
                continue
            _log_setup()
            r = time_prepared(prep, X, device=cfg.device)
            rel = validate_result(golden, r.data,
                                  what=f"{name} cols={cols}")
            logger.log_device(matrix=A.name, fmt=spec.fmt, kernel=name,
                              chunk=cols, rows=A.m, cols=A.n,
                              nnz=A.nnz, num_blocks=_fmt_blocks(prep),
                              duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult(name, spec.fmt, cols, r, rel,
                                     dict(prep.meta)))
            if prep.device.type != "cuda":
                log.info("%-20s cols=%-3d %10.4f ms %8.2f GFLOPS (%s)",
                         name, cols, r.duration_ms, r.gflops, prep.device)
                continue
            if bw is None:
                bw = RL.measure_stream_bw(prep.device)
            rep = RL.roofline(prep, r.duration_ms, r.gflops,
                              x_bytes=A.n * cols * 4,
                              y_bytes=A.m * cols * 4, bw=bw)
            log.info("%-20s cols=%-3d %10.4f ms %8.2f GFLOPS "
                     "(%.2f of the roofline at the measured %.1f GB/s)",
                     name, cols, r.duration_ms, r.gflops, rep.fraction, bw)


def _run_distributed(A, x, golden, cfg, logger, results):
    """Row-sharded SpMV rows (strategy id 9, chunk = the mesh's device
    count): the mesh is every card of this host (``make_mesh()``), or one
    CPU device where the run asks for the CPU. Two local kernels, the
    lane-ELL hybrid and PELL, each validated and logged like any
    strategy."""
    from spmv_scpa_tpu_torch.parallel.distributed import (
        make_mesh, prepare_row_sharded_hybrid, prepare_row_sharded_pell)

    mesh = (make_mesh() if torch.device(cfg.device).type == "cuda"
            else make_mesh(devices=[cfg.device]))
    for fmt, prep_fn in (("HYBRID", prepare_row_sharded_hybrid),
                         ("PELL", prepare_row_sharded_pell)):
        what = f"distributed-rowshard[{fmt}]"
        try:
            dist = prep_fn(A, mesh=mesh)
        except REFUSALS as e:
            _refused(cfg, what, len(mesh), e)
            continue
        _log_setup()
        r = time_prepared(dist, x, device=cfg.device)
        rel = _check(cfg, golden, r.data, what)
        logger.log_device(matrix=A.name, fmt=fmt,
                          kernel="distributed-rowshard", chunk=len(mesh),
                          rows=A.m, cols=A.n, nnz=A.nnz, num_blocks=None,
                          duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult("distributed-rowshard", fmt, len(mesh), r,
                                 rel, dict(dist.meta)))
        log.info("%s devices=%d %10.4f ms %8.2f GFLOPS", what, len(mesh),
                 r.duration_ms, r.gflops)


def _run_host_parallel(A, x, golden, cfg, logger, results):
    """Native C++/OpenMP rows -> omp.csv: the reference's OpenMP
    benchmarks (csr.c:278-339, hll.c:178-211) swept over thread counts
    (main.c:177-180). Without the native library (no g++), the torch
    strategies on the CPU stand in (:func:`_run_host_parallel_torch`)."""
    from spmv_scpa_tpu_torch.formats.ell import csr_to_ell
    from spmv_scpa_tpu_torch.ops import native_omp

    if not native_omp.available():
        _run_host_parallel_torch(A, x, golden, cfg, logger, results)
        return

    E = csr_to_ell(A, slice_h=32, col_major=True, pad_mode="last")
    for nt in cfg.omp_threads:
        variants = (
            ("omp_csr_guided", "CSR", None,
             lambda: native_omp.make_csr_omp_guided(A, nt)),
            ("omp_csr_nnz", "CSR", None,
             lambda: native_omp.make_csr_omp_nnz(A, nt)),
            ("omp_ell", "HLL", E.num_slices,
             lambda: native_omp.make_ell_omp(E, nt)))
        for bench_name, fmt, nblocks, make in variants:
            r = time_host_fn(make(), x, nnz=A.nnz)
            rel = _check(cfg, golden, r.data, f"{bench_name} nt={nt}")
            logger.log_omp(matrix=A.name, fmt=fmt, bench=bench_name,
                           rows=A.m, cols=A.n, nnz=A.nnz,
                           num_blocks=nblocks, num_threads=nt,
                           duration_ms=r.duration_ms, gflops=r.gflops)
            results.append(RowResult(f"{bench_name}@{nt}", fmt, None,
                                     r, rel))
            log.info("%-16s nt=%-3d %10.4f ms %8.2f GFLOPS",
                     bench_name, nt, r.duration_ms, r.gflops)


def _run_host_parallel_torch(A, x, golden, cfg, logger, results):
    """The fallback without the native library: ``torch-csr-segsum`` and
    ``torch-ell-cm`` on the CPU, one row each at PyTorch's thread count,
    under the bench names ``torch_guided`` and ``torch_ell``."""
    log.warning("native OpenMP library unavailable: the host-parallel rows "
                "are torch-csr-segsum (torch_guided) and torch-ell-cm "
                "(torch_ell) on the CPU")
    nthreads = torch.get_num_threads()
    for name, fmt, bench_name in (
            ("torch-csr-segsum", "CSR", "torch_guided"),
            ("torch-ell-cm", "HLL", "torch_ell")):
        try:
            prep = get_strategy(name).prepare(A, device="cpu")
        except REFUSALS as e:
            _refused(cfg, f"host {name}", nthreads, e)
            continue
        _log_setup()
        r = time_prepared(prep, x, device="cpu")
        rel = _check(cfg, golden, r.data, f"host {name}")
        logger.log_omp(matrix=A.name, fmt=fmt, bench=bench_name,
                       rows=A.m, cols=A.n, nnz=A.nnz,
                       num_blocks=_fmt_blocks(prep), num_threads=nthreads,
                       duration_ms=r.duration_ms, gflops=r.gflops)
        results.append(RowResult(name + "@cpu", fmt, None, r, rel))


def _check(cfg, golden, got, what, rtol=None) -> float | None:
    """``validate_result`` in debug mode. A strategy that states its own
    ``rtol`` is the fp64 grade: held to it with the absolute gate off
    (the reference's 0.1 absolute gate would pass an f32 y)."""
    if not cfg.debug:
        return None
    kw = {"rtol": rtol, "abs_l2": 0.0} if rtol else {}
    return validate_result(golden, got, what=what, **kw)

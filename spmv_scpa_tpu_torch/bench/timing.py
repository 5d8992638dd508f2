"""Kernel timing on the card (counterpart of
``spmv_scpa_tpu/bench/timing.py``).

The reference study times the bare launch with a cudaEvent pair
(cuda_csr.cu:224-226) and takes the median of 10 iterations
(BASELINE.md). Here every rep is bracketed by its own pair of
``torch.cuda.Event``s on the current stream, with no synchronisation
between reps, after a warm-up; the result is the median.

:func:`time_cuda` times a call as its caller sees it: when the host
takes longer to enqueue a rep than the device takes to run it, the
device waits inside the pair and the host's time enters. That is the
time of a call (``time_prepared``). :func:`time_device` times the
device's work alone: it holds the stream with a spin kernel until the
host has enqueued every rep, so each pair spans work that was all
queued when the device reached it; a kernel of a few microseconds is
timed as such, not as its wrapper's Python (:func:`time_device_fn`
wraps it in a ``BenchResult``). There is no CPU fallback for a device
time: a time is a device measurement or it is not taken.

The host strategies (the serial oracles, the native OpenMP kernels)
are timed on the host clock, as the reference times its serial path
(:func:`time_host_fn`, the median of up to 10 calls); so is a strategy
prepared on the CPU, but only where the caller asks for the CPU.

``BenchResult``, ``compute_gflops`` (GFLOP/s = 2*nnz/t, utils.h:70-75)
and ``time_host_fn`` are copies of the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_scpa_tpu_torch.ops.registry import list_strategies, to_numpy
from spmv_scpa_tpu_torch.utils.platform import cuda_device

MIN_REPS = 10

# Spin cycles that first hold the stream in time_device (about 8 ms on
# an H100); doubled until the hold outlasts the host's enqueue.
HOLD_CYCLES = 1 << 24
MAX_HOLD_CYCLES = 1 << 30

__all__ = ["BenchResult", "compute_gflops", "time_cuda", "time_device",
           "time_device_fn", "time_host_fn", "time_prepared"]


@dataclass
class BenchResult:
    """Analog of the reference study's ``bench`` struct (utils.h:32-36)."""

    duration_ms: float
    gflops: float
    data: np.ndarray | None = None        # result vector y
    reps: int = 1
    all_ms: list = field(default_factory=list)


def compute_gflops(nnz: int, duration_ms: float, ncols: int = 1) -> float:
    """2*nnz flops per matvec column (utils.h:70-75)."""
    if duration_ms <= 0:
        return 0.0
    return 2.0 * nnz * ncols / (duration_ms * 1e6)


def time_cuda(fn, *args, reps: int = 20, warmup: int = 3) -> list[float]:
    """Milliseconds of each of ``reps`` calls ``fn(*args)`` on the
    current CUDA stream, measured with CUDA events."""
    if reps < MIN_REPS:
        raise ValueError(f"reps must be >= {MIN_REPS} (median of k)")
    cuda_device()
    for _ in range(warmup):
        fn(*args)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in ev]


def time_device(fn, *args, reps: int = 20, warmup: int = 3) -> list[float]:
    """Milliseconds of each of ``reps`` calls ``fn(*args)`` on the
    device alone: the stream is held by ``torch.cuda._sleep`` while the
    host enqueues every rep, and the hold is doubled and the reps taken
    again until the device had not reached the last rep when the host
    was done."""
    if reps < MIN_REPS:
        raise ValueError(f"reps must be >= {MIN_REPS} (median of k)")
    cuda_device()
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    while True:
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        for start, end in ev:
            start.record()
            fn(*args)
            end.record()
        held = not ev[-1][0].query()
        torch.cuda.synchronize()
        if held:
            return [start.elapsed_time(end) for start, end in ev]
        if cycles >= MAX_HOLD_CYCLES:
            raise RuntimeError("time_device: the host could not enqueue "
                               f"{reps} reps within the longest hold")
        cycles *= 2


def time_host_fn(fn, x, *, nnz: int, reps: int = 10,
                 max_time_s: float = 5.0) -> BenchResult:
    """Time a host kernel directly: the median of ``reps`` calls on the
    host clock, stopping early past ``max_time_s`` (the serial path,
    bench_csr_serial, csr.c:342-353)."""
    y = fn(x)
    times = []
    elapsed = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        y = fn(x)
        dt = time.perf_counter() - t0
        times.append(dt * 1e3)
        elapsed += dt
        if elapsed > max_time_s:
            break
    ms = float(np.median(times))
    ncols = 1 if np.ndim(y) <= 1 else np.shape(y)[-1]
    return BenchResult(ms, compute_gflops(nnz, ms, ncols),
                       data=to_numpy(y), reps=len(times), all_ms=times)


def time_device_fn(fn, x, *, nnz: int, ncols: int = 1, reps: int = 20,
                   warmup: int = 3) -> BenchResult:
    """The median device time of ``fn(x)`` alone (:func:`time_device`),
    x already on the card, and y from one more call."""
    times = time_device(fn, x, reps=reps, warmup=warmup)
    ms = float(np.median(times))
    return BenchResult(ms, compute_gflops(nnz, ms, ncols),
                       data=to_numpy(fn(x)), reps=reps, all_ms=times)


def time_prepared(prep, x, *, reps: int = 20, warmup: int = 3,
                  dtype=torch.float32, device="cuda") -> BenchResult:
    """Time ``prep.fn(x)`` where it runs; x in ``dtype`` (float64 for the
    fp64 grade). On the card: the median device time of the whole call
    with x already there (x staging, kernels and tail; :func:`time_cuda`).
    A host strategy (``backend="host"``) runs on the host clock
    (:func:`time_host_fn`); so does a strategy prepared on the CPU, only
    when ``device`` asks for the CPU. A 2-D x (an SpMM's X) counts its
    columns in the GFLOP/s."""
    if prep.device.type != "cuda":
        if prep.strategy in list_strategies(backend="host"):
            return time_host_fn(prep.fn, x, nnz=prep.nnz)
        if torch.device(device).type != "cpu":
            raise RuntimeError(
                f"time_prepared: {prep.strategy} runs on {prep.device}; "
                "device timing needs a strategy prepared on the card "
                "(device='cpu' times it on the host clock)")
        return time_host_fn(prep.fn, torch.as_tensor(x, dtype=dtype),
                            nnz=prep.nnz)
    xd = torch.as_tensor(x, dtype=dtype, device=prep.device)
    times = time_cuda(prep.fn, xd, reps=reps, warmup=warmup)
    ms = float(np.median(times))
    ncols = xd.shape[1] if xd.dim() == 2 else 1
    return BenchResult(ms, compute_gflops(prep.nnz, ms, ncols),
                       data=to_numpy(prep.fn(xd)), reps=reps,
                       all_ms=times)

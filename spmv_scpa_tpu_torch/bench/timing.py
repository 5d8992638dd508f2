"""Kernel timing on the card (counterpart of
``spmv_scpa_tpu/bench/timing.py``).

The reference study times the bare launch with a cudaEvent pair
(cuda_csr.cu:224-226) and takes the median of 10 iterations
(BASELINE.md). Here every rep is bracketed by its own pair of
``torch.cuda.Event``s on the current stream, with no synchronisation
between reps, after a warm-up; the result is the median. A single
kernel call between two events is timed on the device clock, so host
launch cost does not enter it. There is no CPU fallback: a time is a
device measurement or it is not taken.

``BenchResult`` and ``compute_gflops`` (GFLOP/s = 2*nnz/t,
utils.h:70-75) are the JAX package's, imported.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu.bench.timing import BenchResult, compute_gflops

from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.platform import cuda_device

MIN_REPS = 10

__all__ = ["BenchResult", "compute_gflops", "time_cuda", "time_prepared"]


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


def time_prepared(prep, x, *, reps: int = 20,
                  warmup: int = 3) -> BenchResult:
    """Median device time of ``prep.fn(x)`` with x already on the card
    (the whole call: x staging, kernels and tail)."""
    if prep.device.type != "cuda":
        raise RuntimeError(
            f"time_prepared: {prep.strategy} runs on {prep.device}; device "
            "timing needs a strategy prepared on the card")
    xd = torch.as_tensor(x, dtype=torch.float32, device=prep.device)
    times = time_cuda(prep.fn, xd, reps=reps, warmup=warmup)
    ms = float(np.median(times))
    return BenchResult(ms, compute_gflops(prep.nnz, ms),
                       data=to_numpy(prep.fn(xd)), reps=reps,
                       all_ms=times)

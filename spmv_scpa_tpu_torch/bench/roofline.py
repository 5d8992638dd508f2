"""Device-memory roofline accounting (counterpart of
``spmv_scpa_tpu/bench/roofline.py``).

An SpMV kernel is bandwidth-bound, so its speed-of-light time is
``bytes_streamed / BW_stream``. ``BW_stream`` is measured by the
stream-probe kernel (``csrc/stream_probe.cu``), never assumed: without
a card :func:`measure_stream_bw` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.bench.timing import time_cuda
from spmv_scpa_tpu_torch.utils.platform import resolve_device

TILE = 8 * 128               # floats in the (8, 128) result tile
# Probe buffer: ten times the H100's 50 MB L2, so repeated reps stream
# from device memory and not from L2.
PROBE_BYTES = 512 << 20

# Launches of each CUDA kernel by its wrapper in this process.
KERNEL_LAUNCHES = 0          # stream_reduce
STRIDED_LAUNCHES = 0         # stream_reduce_strided


def _launch(entry: str, buf: torch.Tensor, blocks_per_sm: int):
    """Check ``buf``; on the CPU return :func:`stream_reduce_plain`, on the
    card launch ``csrc/stream_probe.cu``'s ``entry`` with
    ``blocks_per_sm`` blocks an SM (None: launched nothing)."""
    if buf.dtype != torch.float32 or buf.dim() != 1 \
            or buf.numel() % TILE or not buf.is_contiguous():
        raise ValueError(f"{entry}: buf must be a contiguous 1-D f32 "
                         f"tensor of whole (8, 128) tiles, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if buf.device.type == "cpu":
        return stream_reduce_plain(buf)
    if buf.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {buf.device}")
    if buf.data_ptr() % 16:
        raise ValueError(f"{entry}: buf must be 16-byte aligned")
    lib = _kernels.load("stream_probe")
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    nblocks = max(1, min(blocks_per_sm * sms, buf.numel() // TILE))
    out = torch.zeros(8, 128, dtype=torch.float32, device=buf.device)
    err = getattr(lib, entry)(buf.data_ptr(), buf.numel(), nblocks,
                              out.data_ptr(),
                              _kernels.stream_handle(buf.device))
    _kernels.check(lib, err, entry)
    return out


@trace.launch("stream_reduce")
def stream_reduce(buf: torch.Tensor) -> torch.Tensor:
    """Sum of ``buf`` viewed as (-1, 8, 128) tiles: an (8, 128) f32
    tile. CUDA tensors launch ``csrc/stream_probe.cu``'s probe (a
    contiguous span of tiles a block, one block an SM); CPU tensors run
    :func:`stream_reduce_plain`."""
    global KERNEL_LAUNCHES
    out = _launch("stream_reduce", buf, 1)
    if buf.device.type == "cuda":
        KERNEL_LAUNCHES += 1
    return out


@trace.launch("stream_reduce_strided")
def stream_reduce_strided(buf: torch.Tensor) -> torch.Tensor:
    """:func:`stream_reduce` by the first port's grid-stride kernel, kept
    for the A/B against the probe."""
    global STRIDED_LAUNCHES
    out = _launch("stream_reduce_strided", buf, 4)
    if buf.device.type == "cuda":
        STRIDED_LAUNCHES += 1
    return out


def stream_reduce_plain(buf: torch.Tensor) -> torch.Tensor:
    return buf.view(-1, 8, 128).sum(0)


def measure_stream_bw(device="cuda", nbytes: int = PROBE_BYTES,
                      reps: int = 20, reduce=stream_reduce) -> float:
    """Read-stream bandwidth of the card in GB/s: the median time of
    ``reduce`` (:func:`stream_reduce`, or :func:`stream_reduce_strided`
    for the A/B) over a buffer of ones of ``nbytes``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_stream_bw: a bandwidth is measured on "
                           f"the card, not on {dev}")
    buf = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
    ms = float(np.median(time_cuda(reduce, buf, reps=reps)))
    return buf.numel() * 4 / (ms * 1e-3) / 1e9


@dataclass
class RooflineReport:
    stream_bw_gbs: float
    bytes_streamed: int
    t_min_ms: float
    t_measured_ms: float
    fraction: float
    gflops: float
    gflops_at_roofline: float
    fraction_ideal: float = 0.0   # vs the format-free 6 B/nnz minimum


def roofline(prep, duration_ms: float, gflops: float, x_bytes: int = 0,
             y_bytes: int = 0, bw: float | None = None) -> RooflineReport:
    """Roofline report for a measured Prepared strategy run.

    ``fraction`` is against the kernel's ACTUAL streamed bytes
    (``prep.hbm_bytes``); ``fraction_ideal`` against the format-free
    minimum (6 B/nnz: f32 value + int16 index, plus one x and y pass).
    ``bw`` (GB/s) defaults to :func:`measure_stream_bw` on the
    strategy's device.
    """
    if bw is None:
        bw = measure_stream_bw(prep.device)
    total = prep.hbm_bytes + x_bytes + y_bytes
    t_min_ms = total / (bw * 1e9) * 1e3
    frac = t_min_ms / duration_ms if duration_ms > 0 else 0.0
    ideal = getattr(prep, "nnz", 0) * 6 + x_bytes + y_bytes
    t_ideal_ms = ideal / (bw * 1e9) * 1e3
    return RooflineReport(
        stream_bw_gbs=bw, bytes_streamed=total, t_min_ms=t_min_ms,
        t_measured_ms=duration_ms, fraction=frac, gflops=gflops,
        gflops_at_roofline=gflops / frac if frac > 0 else 0.0,
        fraction_ideal=(t_ideal_ms / duration_ms
                        if duration_ms > 0 else 0.0))

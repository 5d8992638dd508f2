"""Windowed segment-sum on PyTorch and CUDA (counterpart of
``spmv_scpa_tpu/ops/segsum_kernel.py:make_window_segsum``).

Rows of y are grouped into windows of ``h`` 8-row blocks. The partials
(steps * rows_per_step, 128) arrive window-grouped: every step belongs
to one window (``win_of_step``; the chips plans keep it non-decreasing,
as the TPU kernel needs, and then each window reads only its own steps;
this one takes any order, at the cost of every window scanning every
step). Quantum
q = t * 128 + j of a step (tile t, lane j) carries the 8-vector in rows
t*8 .. t*8+7, column j, of the step's block and adds it into row
``rbl[q]`` of its window; ``rbl == h`` marks padding. The product
``vals * xg`` that makes the chips tail's partials stays a PyTorch
multiply before the call, as it is an XLA op outside the TPU kernel.
:func:`window_segsum` launches ``csrc/segsum.cu`` on a CUDA tensor and
runs :func:`window_segsum_plain` on a CPU tensor; both sum in the same
fixed order (quanta within a step, then steps), so they agree bit for
bit.
"""

from __future__ import annotations

import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC

BR = 8          # rows of a partial tile, and columns of y
_SMEM_MAX = 48 << 10      # shared memory a step block may take unasked

# Launches of the CUDA kernel by :func:`window_segsum` in this process.
KERNEL_LAUNCHES = 0


def _check(part, rbl, win, num_windows: int, h: int, rows_per_step: int):
    if rows_per_step <= 0 or rows_per_step % BR:
        raise ValueError(f"window_segsum: rows_per_step {rows_per_step} is "
                         f"not a positive multiple of {BR}")
    if h <= 0 or num_windows <= 0:
        raise ValueError(f"window_segsum: h {h} and num_windows "
                         f"{num_windows} must be positive")
    if part.dtype != torch.float32 or part.dim() != 2 \
            or part.shape[1] != BC or part.shape[0] % rows_per_step:
        raise ValueError(f"window_segsum: partials are {part.dtype} "
                         f"{tuple(part.shape)}, expected float32 "
                         f"(steps*{rows_per_step}, {BC})")
    steps = part.shape[0] // rows_per_step
    g = rows_per_step // BR * BC
    for name, t, shape in (("rbl", rbl, (steps * g,)),
                           ("win_of_step", win, (steps,))):
        if t.device != part.device:
            raise ValueError(f"window_segsum: {name} is on {t.device}, "
                             f"partials on {part.device}")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"window_segsum: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected int32 {shape}")
    for name, t in (("partials", part), ("rbl", rbl), ("win_of_step", win)):
        if not t.is_contiguous():
            raise ValueError(f"window_segsum: {name} is not contiguous")
    if part.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_segsum: unsupported device {part.device}")
    if g * 4 + rows_per_step * BC * 4 > _SMEM_MAX:
        raise ValueError(f"window_segsum: {rows_per_step} rows per step "
                         "exceed the step kernel's shared memory")
    return steps


def window_segsum(part, rbl, win, num_windows: int, h: int,
                  rows_per_step: int) -> torch.Tensor:
    """y (num_windows * h, 8) f32 with
    ``y[win[s]*h + rbl[q], r] += part[s*rows_per_step + (q//128)*8 + r,
    q % 128]`` over the quanta q of each step s; ``rbl`` outside
    [0, h) adds nothing, and every window's rows are written.
    ``win`` values must lie in [0, num_windows)."""
    global KERNEL_LAUNCHES
    steps = _check(part, rbl, win, num_windows, h, rows_per_step)
    if part.device.type == "cpu":
        return window_segsum_plain(part, rbl, win, num_windows, h,
                                   rows_per_step)
    lib = _kernels.load("segsum")
    tiles = torch.empty(steps * h * BR, dtype=torch.float32,
                        device=part.device)
    y = torch.empty((num_windows * h, BR), dtype=torch.float32,
                    device=part.device)
    err = lib.window_segsum(part.data_ptr(), rbl.data_ptr(), win.data_ptr(),
                            tiles.data_ptr(), y.data_ptr(), steps,
                            rows_per_step, h, num_windows,
                            _kernels.stream_handle(part.device))
    _kernels.check(lib, err, "window_segsum")
    KERNEL_LAUNCHES += 1
    return y


def window_segsum_plain(part, rbl, win, num_windows: int, h: int,
                        rows_per_step: int) -> torch.Tensor:
    """The kernel's sums in PyTorch ops: per step an (h, 8) tile by
    ``index_add_`` over its quanta in order, then per window the sum of
    its steps' tiles in step order."""
    dev = part.device
    steps = part.shape[0] // rows_per_step
    tiles_per_step = rows_per_step // BR
    # quantum-major 8-vectors: (steps * tiles * 128, 8)
    qv = part.view(steps * tiles_per_step, BR, BC).transpose(1, 2) \
        .reshape(-1, BR)
    g = tiles_per_step * BC
    r = rbl.to(torch.int64)
    ok = (r >= 0) & (r < h)
    step_of = torch.arange(steps * g, device=dev) // g
    tiles = torch.zeros((steps * h, BR), dtype=torch.float32, device=dev)
    tiles.index_add_(0, (step_of * h + r)[ok], qv[ok])
    y = torch.zeros((num_windows, h * BR), dtype=torch.float32, device=dev)
    y.index_add_(0, win.to(torch.int64), tiles.view(steps, h * BR))
    return y.view(num_windows * h, BR)

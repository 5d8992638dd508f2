"""Segment-sums on PyTorch and CUDA: per-quantum 8-row partials into y
(counterparts of ``spmv_scpa_tpu/ops/segsum_kernel.py``:
``make_window_segsum`` and ``make_span_segsum``).

Rows of y are grouped into windows of ``h`` 8-row blocks. The partials
(steps * rows_per_step, nq) arrive in steps; quantum ``q = t * nq + j``
(tile t, column j) carries the 8-vector in rows t*8 .. t*8+7, column j,
and adds it into one row block of y:

* :func:`window_segsum`: every step belongs to one window ``win[s]``
  and ``rbl`` holds window-local row blocks; one outside [0, h) (``h``
  marks padding) adds nothing. The chips tail, PELL's window-pure scheme
  and BCSR use it.
* :func:`span_segsum`: step s adds into the ``span`` windows
  ``base[s] .. base[s] + span - 1`` and ``rbl`` holds global row blocks;
  one outside those windows adds nothing. PELL's span scheme uses it.

Both launch ``csrc/segsum.cu`` on a CUDA tensor, which reads the quanta
through an index of ``rbl`` by (step, cell) that :func:`segment_lists`
builds on the host once per matrix (``lists``); on a CPU tensor they run
the plain version, which reads ``rbl`` itself. Both sum in the same
fixed order: a cell's quanta, in ascending order, dealt round-robin to
32 lanes that each add their share in order, the lanes then combined
pairwise (lane l with l + 16, then l + 8, ...; :func:`cell_sums`), and
then a window's steps in step order. So the kernel equals the plain
version run on the CPU bit for bit; the plain version on the card adds
the steps with ``index_add_``'s atomics, in a varying order. The
product that makes the chips tail's partials stays a PyTorch multiply
before the call, as it is an XLA op outside the TPU kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC

BR = 8          # rows of a partial tile, and columns of y
LANES = 32      # lanes that share a cell's quanta (one warp)

# Launches of the CUDA kernel by :func:`window_segsum` and by
# :func:`span_segsum` in this process.
KERNEL_LAUNCHES = 0
SPAN_LAUNCHES = 0


def segment_lists(rel: np.ndarray, nrel: int):
    """The kernel's index of the quanta by (step, cell): ``rel`` (steps,
    g) is each quantum's cell in its step's ``nrel`` cells (a value
    outside [0, nrel) adds nothing). Returns ``(order, ptr)`` int32:
    ``order[ptr[s * nrel + k]:ptr[s * nrel + k + 1]]`` are the global
    ids ``s * g + q`` of the quanta of cell k of step s, ascending."""
    rel = np.asarray(rel, np.int64)
    steps, g = rel.shape
    live = (rel >= 0) & (rel < nrel)
    key = (np.arange(steps, dtype=np.int64)[:, None] * nrel + rel)[live]
    ids = np.flatnonzero(live.reshape(-1))
    order = ids[np.argsort(key, kind="stable")].astype(np.int32)
    ptr = np.zeros(steps * nrel + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=steps * nrel), out=ptr[1:])
    return order, ptr.astype(np.int32)


def window_rel(rbl: np.ndarray, steps: int) -> np.ndarray:
    """Cells of :func:`window_segsum`'s quanta: the window-local row
    block, (steps, g)."""
    return np.asarray(rbl, np.int64).reshape(steps, -1)


def span_rel(rbl: np.ndarray, base: np.ndarray, h: int) -> np.ndarray:
    """Cells of :func:`span_segsum`'s quanta: the global row block less
    the step's first row block, (steps, g)."""
    base = np.asarray(base, np.int64)
    return (np.asarray(rbl, np.int64).reshape(base.size, -1)
            - base[:, None] * h)


def device_lists(rel: np.ndarray, nrel: int, device):
    """:func:`segment_lists` as int32 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in segment_lists(rel, nrel))


def check_tables(what, device, steps: int, g: int, rbl, base,
                 span: int, h: int, lists):
    """Raise ValueError unless ``rbl`` (steps*g,), ``base`` (steps,) and
    ``lists`` (order, ptr (steps*span*h + 1,)) are contiguous int32
    tensors on ``device``. The plain versions, which run on the CPU,
    read ``rbl`` itself and take ``lists`` None."""
    want = [("rbl", rbl, (steps * g,)), ("base", base, (steps,))]
    if lists is None and device.type != "cpu":
        raise ValueError(f"{what}: the kernel needs lists (device_lists "
                         "of rbl, built once per matrix)")
    if lists is not None:
        order, ptr = lists
        want += [("order", order, (order.numel(),)),
                 ("ptr", ptr, (steps * span * h + 1,))]
    for name, t, shape in want:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected int32 {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check(what, part, rbl, base, num_windows: int, h: int, span: int,
           rows_per_step: int, lists):
    if rows_per_step <= 0 or rows_per_step % BR:
        raise ValueError(f"{what}: rows_per_step {rows_per_step} is not a "
                         f"positive multiple of {BR}")
    if h <= 0 or num_windows <= 0 or span <= 0:
        raise ValueError(f"{what}: h {h}, num_windows {num_windows} and "
                         f"span {span} must be positive")
    if part.dtype != torch.float32 or part.dim() != 2 \
            or BC % max(part.shape[1], 1) or part.shape[0] % rows_per_step:
        raise ValueError(f"{what}: partials are {part.dtype} "
                         f"{tuple(part.shape)}, expected float32 "
                         f"(steps*{rows_per_step}, nq) with nq dividing {BC}")
    if not part.is_contiguous():
        raise ValueError(f"{what}: partials are not contiguous")
    if part.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {part.device}")
    steps = part.shape[0] // rows_per_step
    check_tables(what, part.device, steps,
                 rows_per_step // BR * part.shape[1], rbl, base, span, h,
                 lists)
    return steps


def _launch(part, base, lists, num_windows, h, span, steps):
    order, ptr = lists
    lib = _kernels.load("segsum")
    tiles = torch.empty(steps * span * h * BR, dtype=torch.float32,
                        device=part.device)
    y = torch.empty((num_windows * h, BR), dtype=torch.float32,
                    device=part.device)
    err = lib.span_segsum(part.data_ptr(), order.data_ptr(), ptr.data_ptr(),
                          base.data_ptr(), tiles.data_ptr(), y.data_ptr(),
                          steps, part.shape[1], h, span, num_windows,
                          _kernels.stream_handle(part.device))
    _kernels.check(lib, err, "span_segsum")
    return y


def window_segsum(part, rbl, win, num_windows: int, h: int,
                  rows_per_step: int, lists) -> torch.Tensor:
    """y (num_windows * h, 8) f32 with ``y[win[s]*h + rbl[q], r] +=
    part[s*rows_per_step + (q//nq)*8 + r, q % nq]`` over the quanta q of
    each step s (q counted within the step); ``rbl`` outside [0, h) adds
    nothing, and every window's rows are written. ``win`` values must lie
    in [0, num_windows). ``lists``: ``device_lists(window_rel(rbl,
    steps), h)``, built once per matrix."""
    global KERNEL_LAUNCHES
    steps = _check("window_segsum", part, rbl, win, num_windows, h, 1,
                   rows_per_step, lists)
    if part.device.type == "cpu":
        return window_segsum_plain(part, rbl, win, num_windows, h,
                                   rows_per_step, lists)
    y = _launch(part, win, lists, num_windows, h, 1, steps)
    KERNEL_LAUNCHES += 1
    return y


def span_segsum(part, rbl, base, num_windows: int, h: int, span: int,
                rows_per_step: int, lists) -> torch.Tensor:
    """y (num_windows * h, 8) f32 with ``y[rbl[q], r] += part[...]`` (as
    :func:`window_segsum`) for the quanta of step s whose global row
    block ``rbl[q]`` lies in windows ``base[s] .. base[s] + span - 1``;
    rows past ``num_windows * h`` are dropped, and every window's rows
    are written. ``lists``: ``device_lists(span_rel(rbl, base, h), span
    * h)``."""
    global SPAN_LAUNCHES
    steps = _check("span_segsum", part, rbl, base, num_windows, h, span,
                   rows_per_step, lists)
    if part.device.type == "cpu":
        return span_segsum_plain(part, rbl, base, num_windows, h, span,
                                 rows_per_step, lists)
    y = _launch(part, base, lists, num_windows, h, span, steps)
    SPAN_LAUNCHES += 1
    return y


def cell_sums(qv, cell, n_cells: int) -> torch.Tensor:
    """(n_cells, 8): each cell's sum of the 8-vectors ``qv`` of the quanta
    with that ``cell`` (-1: none), in the kernels' order: the cell's
    quanta in ascending order dealt round-robin to 32 lanes, each lane
    adding its share in order, then lane l + w added into lane l for w =
    16, 8, 4, 2, 1."""
    dev = qv.device
    live = cell >= 0
    c, v = cell[live], qv[live]
    srt = torch.argsort(c, stable=True)
    c, v = c[srt], v[srt]
    count = torch.bincount(c, minlength=n_cells)
    pos = torch.arange(c.numel(), device=dev) - (torch.cumsum(count, 0)
                                                 - count)[c]
    lane, rnd = pos % LANES, pos // LANES
    by_rnd = torch.argsort(rnd, stable=True)
    per_rnd = torch.bincount(rnd, minlength=1).tolist()
    acc = torch.zeros((n_cells, LANES, BR), dtype=torch.float32, device=dev)
    lo = 0
    for k in per_rnd:                  # one lane slot per cell per round
        i = by_rnd[lo:lo + k]
        lo += k
        acc[c[i], lane[i]] = acc[c[i], lane[i]] + v[i]
    w = LANES
    while w > 1:
        w //= 2
        acc = acc[:, :w] + acc[:, w:2 * w]
    return acc[:, 0]


def _plain(part, rel, base, num_windows, h, span, rows_per_step):
    """Both segment-sums in PyTorch ops: per step an (span*h, 8) tile of
    its cells' sums (:func:`cell_sums`), then per window the sum of the
    tiles of the steps that cover it, in step order."""
    dev = part.device
    nq = part.shape[1]
    steps = part.shape[0] // rows_per_step
    tiles_per_step = rows_per_step // BR
    g = tiles_per_step * nq
    nrel = span * h
    # quantum-major 8-vectors: (steps * g, 8)
    qv = part.view(steps * tiles_per_step, BR, nq).transpose(1, 2) \
        .reshape(-1, BR)
    ok = (rel >= 0) & (rel < nrel)
    step_of = torch.arange(steps * g, device=dev) // g
    tiles = cell_sums(qv, torch.where(ok, step_of * nrel + rel, -1),
                      steps * nrel)
    dest = (base.to(torch.int64)[:, None]
            + torch.arange(span, device=dev)).reshape(-1)
    y = torch.zeros((num_windows + span - 1, h * BR), dtype=torch.float32,
                    device=dev)
    y.index_add_(0, dest, tiles.view(steps * span, h * BR))
    return y[:num_windows].reshape(num_windows * h, BR)


def window_segsum_plain(part, rbl, win, num_windows: int, h: int,
                        rows_per_step: int, lists=None) -> torch.Tensor:
    """:func:`window_segsum` in PyTorch ops (``lists`` unused)."""
    return _plain(part, rbl.to(torch.int64), win, num_windows, h, 1,
                  rows_per_step)


def span_segsum_plain(part, rbl, base, num_windows: int, h: int, span: int,
                      rows_per_step: int, lists=None) -> torch.Tensor:
    """:func:`span_segsum` in PyTorch ops (``lists`` unused)."""
    g = rows_per_step // BR * part.shape[1]
    step_of = torch.arange(rbl.numel(), device=part.device) // g
    rel = rbl.to(torch.int64) - base.to(torch.int64)[step_of] * h
    return _plain(part, rel, base, num_windows, h, span, rows_per_step)

"""The chips tail's x side as one kernel: products over a host slot table
that reads x in place (``csrc/chips_products.cu``), the default of the
chips tail (``chips_x="slots"``).

The reference's chips tail stages x for a TPU, which must hold what it
gathers in VMEM: stage 1 (:func:`ext_gather.sorted_gather`) packs the
tail's unique columns of a zero-padded copy of x into a compact hot
region, stage 2 (:func:`ext_gather.ranked_gather`, or
:func:`ext_gather.window_gather` for a split plan's windowed streams)
gathers each chip slot's value from it, and a multiply forms the
products (``chips_x="hot"`` keeps that pipeline). On Hopper x is read in
place through the 50 MB L2, and every route of the two stages depends
on the plan alone: :func:`slots_table` resolves it once on the host into
one int32 x column per chip slot, and one launch of
:func:`chips_products` forms ``vals * x[col]`` for every slot of every
stream of a plan (of every shard of a device, on the row-sharded
hybrid). The segment-sums and the landing stay as they are.

Column -1 marks a slot that reads no x and whose product is +0.0:
* every slot the old pipeline read as 0.0: a stage-1 or stage-2 index
  outside its gather's range, a column past x in the zero-padded copy,
  a windowed index past the hot region cut to its reach, a ``windowed-x``
  column past ``nx``;
* every slot that holds no entry: the plans' own padding and the slots
  that ``pad_resident_plan`` / ``pad_split_plan`` add (the plans'
  ``live`` masks).
A real entry keeps its column even when its value is 0.0. So for finite
x the products equal the old pipeline's (a 0.0 where it had a 0.0 of
either sign), and a non-finite x at a column no entry names never
reaches y.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC

# Launches of the CUDA kernel by its wrapper in this process.
LAUNCHES = {"chips_products": 0}


# ---------------------------------------------------------------------------
# The host table
# ---------------------------------------------------------------------------

def _hot_cols(base, p1, l1, R: int, n1p_blocks: int, n: int) -> np.ndarray:
    """The x column of every element of stage 1's hot region (rows, 128),
    -1 where :func:`ext_gather.sorted_gather` reads 0.0 (an index out of
    range) or reads the zero padding of x past ``n``."""
    p = np.asarray(p1, np.int64)
    lane = np.asarray(l1, np.int64)
    row = np.repeat(np.asarray(base, np.int64), 8)[:, None] * R + p
    col = row * BC + lane
    ok = ((p >= 0) & (p < R) & (lane >= 0) & (lane < BC) & (row >= 0)
          & (row < n1p_blocks * R) & (col < n))
    return np.where(ok, col, -1)


def _through(src: np.ndarray, row, lane, ok) -> np.ndarray:
    """``src[row, lane]`` where ``ok``, else -1."""
    out = np.full(row.shape, -1, np.int64)
    out[ok] = src[row[ok], lane[ok]]
    return out


def _window(base8, p2, l2, r_hot: int, rows: int):
    """(row, lane, ok) of a windowed stage 2 over ``rows`` source rows:
    ``row = base8 * 8 + p2`` for ``p2`` in [0, r_hot)."""
    p = np.asarray(p2, np.int64)
    lane = np.asarray(l2, np.int64)
    row = np.asarray(base8, np.int64)[:, None] * 8 + p
    ok = ((p >= 0) & (p < r_hot) & (lane >= 0) & (lane < BC) & (row >= 0)
          & (row < rows))
    return row, lane, ok


def _resident(hot: np.ndarray, p2, l2) -> np.ndarray:
    """The column each slot of a resident stage 2 reads from ``hot``."""
    p = np.asarray(p2, np.int64)
    lane = np.asarray(l2, np.int64)
    ok = (p >= 0) & (p < hot.shape[0]) & (lane >= 0) & (lane < BC)
    return _through(hot, p, lane, ok)


def _stream_cols(s, n: int) -> np.ndarray:
    """The x column of each slot of one split-plan stream (module
    docstring), before the live mask."""
    if s.kind == "windowed-x":
        # the windowed gather over x zero-padded (or cut) to H_pad rows
        nx = min(n, s.H_pad * BC)
        row, lane, ok = _window(s.base8, s.p2, s.l2, s.r_hot, s.H_pad)
        col = row * BC + lane
        return np.where(ok & (col < nx), col, -1)
    hot = _hot_cols(s.base1, s.p1, s.l1, s.r1, s.n1p_blocks, n)
    if s.kind == "resident":
        return _resident(hot, s.p2, s.l2)
    # stage 1, padded or cut to the reach H_pad: rows past stage 1's
    # output read the zero padding
    row, lane, ok = _window(s.base8, s.p2, s.l2, s.r_hot, s.H_pad)
    return _through(hot, row, lane, ok & (row < hot.shape[0]))


def slot_parts(plan):
    """What holds the chip slots of ``plan``: a single plan or a stream
    itself, or a split plan's streams in stream order."""
    if hasattr(plan, "streams"):
        return list(plan.streams)
    return [plan]


def slots_table(plan, n: int) -> np.ndarray:
    """One int32 x column for each chip slot of ``plan`` (a single plan,
    a split plan's stream or a whole split plan, its streams' tables
    concatenated in stream order), for x of ``n`` elements: the column
    the old pipeline's gathers read, or -1 where they read 0.0 or the
    slot holds no entry (module docstring)."""
    out = []
    for s in slot_parts(plan):
        if hasattr(s, "kind"):
            col = _stream_cols(s, n)
        else:                       # a single plan: resident stage 2
            col = _resident(_hot_cols(s.base, s.p1, s.l1, s.R,
                                      s.n1p_blocks, n), s.p2, s.l2)
        out.append(np.where(s.live, col, -1).astype(np.int32))
    return out[0] if len(out) == 1 else np.concatenate(out)


def slot_vals(plan) -> np.ndarray:
    """The chip slots' values in :func:`slots_table`'s order, f32."""
    parts = [np.asarray(s.vals, np.float32) for s in slot_parts(plan)]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def slot_rows(plan) -> list:
    """The chip rows (of 128 slots) of each part of ``plan`` in
    :func:`slots_table`'s order: one for a single plan or a stream, one
    per stream of a split plan."""
    return [s.E8 for s in slot_parts(plan)]


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _check(cols, vals, x) -> None:
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[1] != BC:
        raise ValueError(f"chips_products: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected float32 (E, {BC})")
    if cols.dtype != torch.int32 or cols.shape != vals.shape:
        raise ValueError(f"chips_products: cols are {cols.dtype} "
                         f"{tuple(cols.shape)}, expected int32 "
                         f"{tuple(vals.shape)}")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"chips_products: x is {x.dtype} "
                         f"{tuple(x.shape)}, expected float32 (n,)")
    for name, t in (("cols", cols), ("vals", vals), ("x", x)):
        if t.device != vals.device:
            raise ValueError(f"chips_products: {name} is on {t.device}, "
                             f"vals on {vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"chips_products: {name} is not contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chips_products: unsupported device {vals.device}")
    if vals.device.type == "cuda" and (cols.data_ptr() % 16
                                       or vals.data_ptr() % 16):
        raise ValueError("chips_products: cols and vals must start on a "
                         "16-byte boundary (the kernel's vector loads)")


def chips_products(cols, vals, x) -> torch.Tensor:
    """prod (E, 128) f32: ``vals * x[cols]`` at every slot whose column
    lies in x, +0.0 with no x read elsewhere (column -1). CUDA tensors
    launch ``csrc/chips_products.cu``; CPU tensors run
    :func:`chips_products_plain`."""
    _check(cols, vals, x)
    if vals.device.type == "cpu":
        return chips_products_plain(cols, vals, x)
    out = torch.empty_like(vals)
    lib = _kernels.load("chips_products")
    err = lib.chips_products(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                             x.numel(), out.data_ptr(), vals.numel() // 4,
                             _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, "chips_products")
    LAUNCHES["chips_products"] += 1
    return out


def chips_products_plain(cols, vals, x) -> torch.Tensor:
    """:func:`chips_products` in PyTorch ops: the same f32 product per
    slot, 0.0 where the column lies outside x."""
    n = x.numel()
    ok = (cols >= 0) & (cols < n)
    if n == 0:
        return torch.zeros_like(vals)
    xg = x[cols.long().clamp(0, n - 1)]
    return torch.where(ok, vals * xg,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))

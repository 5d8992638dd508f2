"""BCSR SpMM on PyTorch and CUDA (``cuda-bcsr-spmm``, counterpart of
``spmv_scpa_tpu/ops/pallas_kernels.py:make_bcsr_spmm`` and
``prepare_bcsr_spmm``, the ``pallas-bcsr-spmm`` strategy): Y (m, cols) =
A @ X over (8, 128) tiles, the multi-vector case of BASELINE.json's
config 3. Two layouts (knob ``layout``): ``"auto"`` (the default) packs
the tiles as bitmaps of their stored slots (``ops/bcsr_bits.py``, the
kernel ``bcsr_bits_spmm``), ``"tiles"`` the reference's dense tiles
below; both keep the reference's X budget.

* :func:`plan_bcsr_spmm` — the host part of ``make_bcsr_spmm``
  (pallas_kernels.py:1132-1180) that the CUDA path needs, copied
  JAX-free: the BCSR tiles, their column panels and the block rows'
  tile ranges. The X budget refusal (``p_rows*128*cols*4 >
  X_VMEM_BUDGET``) is kept for parity, as a ``ValueError`` raised before
  any tile is built (ROADMAP queue 1 #5 lifts it).
* :func:`spmm_tables` — the rest of that host part: the padding to
  ``t_pad`` and the TPU kernel's window tables (``window``, ``base``,
  ``W``, the visit masks, ``pan2`` and the combined ``rbl2``), which the
  parity tests hold equal to the reference's. The TPU needs them to
  carry sums across its sequential grid; the CUDA kernel does not.
* :func:`bcsr_spmm` — the wrapper of the CUDA kernel (``csrc/spmm.cu``),
  which walks each block row's tiles in order through ``rowptr`` (the
  window tables are the TPU's way to carry sums across its sequential
  grid; on Hopper one thread owns a block row's 8 elements of a column
  of Y), with
  :func:`bcsr_spmm_plain` beside it.
* :func:`prepare_bcsr_spmm` — binds either layout's plan: ``fn(X)``
  takes X (n, cols) and returns Y (m, cols) f32 on the device. It is
  ``spmm_only``: ``registry.spmv`` drives it with a 1-D x in column 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.bcsr import csr_to_bcsr
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.formats.panel_ell import BR
from spmv_scpa_tpu_torch.ops import bcsr_bits
from spmv_scpa_tpu_torch.ops.pell import (DEFAULT_CHUNK, LAYOUTS,
                                         X_VMEM_BUDGET, _pad_tiles)
from spmv_scpa_tpu_torch.ops.registry import Prepared, record_calls
from spmv_scpa_tpu_torch.ops.segsum_kernel import make_visit_masks
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# Launches of the CUDA kernel by ``bcsr_spmm`` in this process.
KERNEL_LAUNCHES = 0


@dataclass
class SpmmPlan:
    """One matrix packed for ``cuda-bcsr-spmm``: the kernel's arrays."""

    m: int
    n: int
    cols: int
    chunk: int
    vals: np.ndarray        # (T*8, 128) float64, tiles in block-row order
    pan: np.ndarray         # (T,) int32 column panel of each tile
    rowptr: np.ndarray      # (mb + 1,) int32 tiles of each block row
    meta: dict
    hbm_bytes: int

    @property
    def num_tiles(self) -> int:
        return self.pan.size


def refuse_x(A: CSR, cols: int) -> None:
    """The reference's X budget: ValueError for an X (n, cols) past
    ``X_VMEM_BUDGET``, before any tile is built."""
    p_rows = max(1, -(-A.n // BC))
    x_bytes = p_rows * BC * cols * 4
    if x_bytes > X_VMEM_BUDGET:
        raise ValueError(
            f"bcsr-spmm: X ({x_bytes} B) exceeds VMEM budget; reduce cols"
            " or matrix size")


def plan_bcsr_spmm(A: CSR, cols: int = 8, chunk: int = DEFAULT_CHUNK,
                   **_) -> SpmmPlan:
    """Pack ``A`` as the reference's ``make_bcsr_spmm`` does (its knobs
    and defaults; ``chunk`` enters its meta only)."""
    refuse_x(A, cols)
    B = csr_to_bcsr(A, br=BR, bc=BC)
    return SpmmPlan(
        m=A.m, n=A.n, cols=cols, chunk=chunk,
        vals=B.vals.reshape(B.num_tiles * BR, BC),
        pan=B.col_panel.astype(np.int32), rowptr=B.rowptr.astype(np.int32),
        meta={"num_blocks": B.num_tiles, "fill": B.fill, "chunk": chunk,
              "cols": cols},
        hbm_bytes=B.padded_bytes)


def spmm_tables(plan: SpmmPlan, window_h: int = 32) -> dict:
    """The reference's padded tiles and window tables of ``plan``
    (``make_bcsr_spmm``'s ``window``, ``base``, ``W``, visit ``masks``,
    ``pan2``, ``rbl2`` and ``vals``), for holding the plan against the
    reference: the CUDA kernel walks ``rowptr`` instead."""
    chunk, T = plan.chunk, plan.num_tiles
    mb = plan.rowptr.size - 1
    rowblk = np.repeat(np.arange(mb, dtype=np.int32), np.diff(plan.rowptr))
    t_pad = max(chunk, -(-T // chunk) * chunk)
    h = window_h
    num_win = max(1, -(-mb // h))
    steps = t_pad // chunk
    steps_pad = -(-steps // 8) * 8
    rowblk_p = _pad_tiles(rowblk, t_pad, fill=mb)
    window = np.minimum(rowblk_p // h, num_win - 1)
    base = window[::chunk].astype(np.int64)
    W = int((window.reshape(-1, chunk)[:, -1] - base).max(initial=0)) + 1
    pan2 = np.zeros((steps_pad, chunk), np.int32)
    pan2[:steps] = _pad_tiles(plan.pan, t_pad).reshape(steps, chunk)
    # combined (global block)*8 + sublane index per source row
    wglob = (np.repeat(rowblk_p, BR).astype(np.int64) * BR
             + np.tile(np.arange(BR), t_pad))
    rbl2 = np.zeros((steps_pad, chunk * BR), np.int32)
    rbl2[:steps] = wglob.reshape(steps, chunk * BR)
    vals = _pad_tiles(plan.vals.reshape(T, BR, BC), t_pad)
    return {"window": window, "base": base, "W": W,
            "masks": make_visit_masks(base, num_win, W, h * BR),
            "pan2": pan2, "rbl2": rbl2, "vals": vals.reshape(t_pad * BR, BC)}


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _check_args(vals, pan, rowptr, X, m: int):
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[1] != BC or vals.shape[0] % BR:
        raise ValueError(f"bcsr_spmm: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected float32 (T*8, 128)")
    T = vals.shape[0] // BR
    mb = -(-m // BR)
    if pan.dtype != torch.int32 or pan.dim() != 1 or pan.numel() < T:
        raise ValueError(f"bcsr_spmm: pan is {pan.dtype} {tuple(pan.shape)},"
                         f" expected int32 with >= {T} entries")
    if rowptr.dtype != torch.int32 or tuple(rowptr.shape) != (mb + 1,):
        raise ValueError(f"bcsr_spmm: rowptr is {rowptr.dtype} "
                         f"{tuple(rowptr.shape)}, expected int32 ({mb + 1},)")
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"bcsr_spmm: X is {X.dtype} {tuple(X.shape)}, "
                         "expected float32 (n, cols)")
    for name, t in (("pan", pan), ("rowptr", rowptr), ("X", X),
                    ("vals", vals)):
        if t.device != vals.device:
            raise ValueError(f"bcsr_spmm: {name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"bcsr_spmm: {name} is not contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bcsr_spmm: unsupported device {vals.device}")


def bcsr_spmm(vals, pan, rowptr, X, m: int) -> torch.Tensor:
    """Y (m, cols) f32: ``Y[i, c]`` sums, over the tiles t of block row
    i // 8 (``rowptr[b] .. rowptr[b + 1]``) in order, each tile's partial:
    the products ``vals[t*8 + i % 8, k] * X[pan[t]*128 + k, c]`` over the
    128 lanes k as a pairwise tree (adjacent lanes, then adjacent pairs,
    ...); a row of X at or past ``X.shape[0]`` reads 0.0. CUDA tensors
    launch ``csrc/spmm.cu``; CPU tensors run :func:`bcsr_spmm_plain`."""
    global KERNEL_LAUNCHES
    _check_args(vals, pan, rowptr, X, m)
    if vals.device.type == "cpu":
        return bcsr_spmm_plain(vals, pan, rowptr, X, m)
    lib = _kernels.load("spmm")
    Y = torch.empty((m, X.shape[1]), dtype=torch.float32, device=vals.device)
    err = lib.bcsr_spmm(vals.data_ptr(), pan.data_ptr(), rowptr.data_ptr(),
                        X.data_ptr(), Y.data_ptr(), m, X.shape[0], X.shape[1],
                        _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, "bcsr_spmm")
    KERNEL_LAUNCHES += 1
    return Y


def bcsr_spmm_plain(vals, pan, rowptr, X, m: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: every block row at once,
    its j-th tile (a zero tile past its last): the products, the same
    pairwise tree over the lanes, then the tile's partial added to the
    row's sum, each product and sum rounded separately. Adding a zero
    tile's partial (0.0 or -0.0) leaves every sum as it is: it starts at
    +0.0 and never becomes -0.0."""
    dev = vals.device
    n, cols = X.shape
    mb = rowptr.numel() - 1
    T = vals.shape[0] // BR
    start = rowptr[:-1].to(torch.int64)
    count = rowptr[1:].to(torch.int64) - start
    tiles = vals.view(T, BR, BC)
    Xz = torch.cat([X, X.new_zeros((1, cols))])     # row n reads 0.0
    acc = torch.zeros((mb, BR, cols), dtype=torch.float32, device=dev)
    lanes = torch.arange(BC, device=dev)
    for j in range(int(count.max()) if mb and T else 0):
        live = count > j
        t = torch.where(live, start + j, 0)
        vj = tiles[t] * live.view(mb, 1, 1)          # (mb, 8, 128)
        col = pan[t].to(torch.int64)[:, None] * BC + lanes   # (mb, 128)
        xj = Xz[torch.where(col < n, col, n)]        # (mb, 128, cols)
        p = vj[:, :, :, None] * xj[:, None]           # (mb, 8, 128, cols)
        while p.shape[2] > 1:
            p = p[:, :, 0::2] + p[:, :, 1::2]
        acc = acc + p[:, :, 0]
    return acc.view(mb * BR, cols)[:m]


class SpmmKernels(NamedTuple):
    """The functions a ``cuda-bcsr-spmm`` call runs, by name."""

    bcsr_spmm: Callable
    bcsr_bits_spmm: Callable


KERNELS = SpmmKernels(bcsr_spmm, bcsr_bits.bcsr_bits_spmm)
PLAIN = SpmmKernels(bcsr_spmm_plain, bcsr_bits.bcsr_bits_spmm_plain)


# ---------------------------------------------------------------------------
# The strategy
# ---------------------------------------------------------------------------

def prepare_bcsr_spmm(A: CSR, cols: int = 8, device="cuda",
                      layout: str = "auto", **knobs) -> Prepared:
    """``cuda-bcsr-spmm``: pack ``A`` in ``layout`` (the bitmap tiles,
    :func:`bcsr_bits.plan_bcsr_bits`, for ``"auto"``, with ``cols`` in
    meta and ``chunk`` under ``tile_knobs`` when given;
    :func:`plan_bcsr_spmm` for ``"tiles"``), both behind the reference's
    X budget, and bind ``fn(X[n, cols]) -> Y[m, cols]`` on ``device``."""
    if layout not in LAYOUTS:
        raise ValueError(f"cuda-bcsr-spmm: unknown layout {layout!r}; one "
                         f"of {LAYOUTS}")
    dev = resolve_device(device)
    m, n = A.m, A.n
    if layout == "tiles":
        plan = plan_bcsr_spmm(A, cols=cols, **knobs)
        vals = torch.as_tensor(plan.vals, dtype=torch.float32, device=dev)
        pan = torch.as_tensor(plan.pan, device=dev)
        rowptr = torch.as_tensor(plan.rowptr, device=dev)

        def kernel(Xf, ops):
            return ops.bcsr_spmm(vals, pan, rowptr, Xf, m)
    else:
        refuse_x(A, cols)
        plan = bcsr_bits.plan_bcsr_bits(A)
        plan.meta["cols"] = cols
        if "chunk" in knobs:
            plan.meta["tile_knobs"] = {"chunk": knobs["chunk"]}
        kernel = bcsr_bits.bind_plan(plan, dev, spmm=True)

    def run(X, ops):
        Xf = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if Xf.shape != (n, cols):
            raise ValueError(f"cuda-bcsr-spmm: X has shape "
                             f"{tuple(Xf.shape)}, expected ({n}, {cols})")
        return kernel(Xf.contiguous(), ops)

    return Prepared(
        "cuda-bcsr-spmm", A.name, lambda X: run(X, KERNELS), device=dev,
        nnz=A.nnz, ref="pallas-bcsr-spmm", hbm_bytes=int(plan.hbm_bytes),
        meta=plan.meta, plain=lambda X: run(X, PLAIN),
        kernel_calls=lambda Xd: record_calls(lambda ops: run(Xd, ops),
                                             PLAIN))

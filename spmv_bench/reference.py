"""The plain reference that decides ``correct``, and its control.

:func:`product` works ``Y = A @ X`` out again in float64 from the
benchmark's own CSR arrays (``csr.Matrix``), with plain PyTorch gathers
and ``index_add_`` in blocks of entries, together with ``S = |A| @ |X|``,
the scale of each answer's rounding. :func:`compare` reads two numbers
from a y the program produced:

* ``row_err``: the widest gap ``|y - Y| / S`` over every row (and
  column): a float32 sum of k products lies within about ``k`` units of
  2**-24 of ``S``, whatever cancels, so one wrong row shows however small
  its y;
* ``rel_l2``: ``||y - Y|| / ||Y||`` over the whole y.

A non-finite y reads infinity. :func:`control_product` is the control,
the step below the configuration's ``dtype`` that would tempt a later
change:

* for float32, the same product with A's values and X rounded to TF32
  (10 mantissa bits, what a tensor-core float32 product reads) and
  summed in float32;
* for float64, the same product with A's values rounded to float32 (the
  value bytes halved) and X and the sums in float64.

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

# Entries a block of the product handles at a time.
BLOCK = 1 << 22


def row_ids(irp: np.ndarray, device) -> torch.Tensor:
    lens = torch.as_tensor(np.diff(np.asarray(irp, dtype=np.int64)),
                           device=device)
    return torch.repeat_interleave(
        torch.arange(lens.numel(), device=device), lens)


def _as_2d(X: torch.Tensor) -> torch.Tensor:
    return X if X.dim() == 2 else X[:, None]


def _product(mat, vals: torch.Tensor, X: torch.Tensor, scale: bool):
    """``A @ X`` (and ``|A| @ |X|`` where ``scale``) from ``vals`` in
    the order of ``mat``'s entries and a 2-D ``X``, in their dtype."""
    dev = X.device
    rows = row_ids(mat.irp, dev)
    ja = torch.as_tensor(np.asarray(mat.ja, dtype=np.int64), device=dev)
    Y = torch.zeros((mat.m, X.shape[1]), dtype=X.dtype, device=dev)
    S = torch.zeros_like(Y) if scale else None
    for s in range(0, mat.nnz, BLOCK):
        p = vals[s:s + BLOCK, None] * X[ja[s:s + BLOCK]]
        Y.index_add_(0, rows[s:s + BLOCK], p)
        if scale:
            S.index_add_(0, rows[s:s + BLOCK], p.abs())
    return Y, S


def product(mat, X: torch.Tensor):
    """``(Y, S)``: ``A @ X`` and ``|A| @ |X|`` in float64, each (m, cols),
    on X's device; X is (n,) or (n, cols)."""
    X = _as_2d(X).to(torch.float64)
    vals = torch.as_tensor(mat.vals, device=X.device).to(torch.float64)
    return _product(mat, vals, X, True)


def control_product(mat, X: torch.Tensor, dtype=np.float32) -> torch.Tensor:
    """The control of a configuration whose ``dtype`` is float32 or
    float64. float32: ``A @ X`` from TF32-rounded A and X, summed in
    float32 (each product of two TF32 numbers is exact in float32).
    float64: ``A @ X`` from A's values rounded to float32, with X and
    the sums in float64."""
    name = np.dtype(dtype).name
    vals = torch.as_tensor(mat.vals, device=X.device)
    if name == "float32":
        X = tf32(_as_2d(X).to(torch.float32))
        vals = tf32(vals.to(torch.float32))
    elif name == "float64":
        X = _as_2d(X).to(torch.float64)
        vals = vals.to(torch.float32).to(torch.float64)
    else:
        raise ValueError(f"no control for dtype {name!r}")
    return _product(mat, vals, X, False)[0]


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at 10 mantissa bits (TF32)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def compare(y: torch.Tensor, Y: torch.Tensor, S: torch.Tensor) -> dict:
    """``{"row_err": ..., "rel_l2": ...}`` of the program's ``y`` against
    the reference ``(Y, S)`` of :func:`product`."""
    y = _as_2d(y).to(device=Y.device, dtype=torch.float64)
    if y.shape != Y.shape:
        return {"row_err": float("inf"), "rel_l2": float("inf")}
    d = torch.nan_to_num((y - Y).abs(), nan=float("inf"))
    inf = torch.full_like(d, float("inf"))
    gap = torch.where(S > 0, d / S, torch.where(d > 0, inf,
                                                torch.zeros_like(d)))
    norm = float(torch.linalg.vector_norm(Y))
    diff = float(torch.linalg.vector_norm(d))
    rel = diff / norm if norm > 0 else (0.0 if diff == 0 else float("inf"))
    return {"row_err": float(gap.max()) if gap.numel() else 0.0,
            "rel_l2": rel}

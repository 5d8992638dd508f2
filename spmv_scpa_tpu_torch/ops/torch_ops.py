"""Plain PyTorch SpMV and SpMM baselines (counterpart of
``spmv_scpa_tpu/ops/xla.py``): the always-correct paths the hybrid is
measured against, and the auto route for tiny matrices. They are XLA
code in the reference, so plain PyTorch is their port.

Each ``make_*`` puts the matrix on ``device`` once and returns
``fn(x) -> y`` on ``device`` (f32, or f64 for :func:`make_ell_fp64`);
x may be a numpy array or a tensor. :func:`make_csr_segsum` and
:func:`make_ell_uniform` also take X (n, c) to Y (m, c), the SpMM forms
of the reference's ``make_csr_segsum_spmm`` and ``make_ell_uniform_spmm``.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.formats.ell import UniformEll


def make_csr_segsum(A: CSR, device: torch.device):
    """``A @ x`` as gather ``x[JA]`` times values, summed per row with
    ``index_add_`` (the reference's thread-per-row CSR, cuda_csr.cu:19-31,
    as a flat nnz stream); X (n, c) gives Y (m, c)."""
    ja = torch.as_tensor(A.ja, dtype=torch.int64, device=device)
    vals = torch.as_tensor(A.as_, dtype=torch.float32, device=device)
    rows = torch.as_tensor(A.row_ids(), dtype=torch.int64, device=device)
    m = A.m

    def fn(x):
        xf = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = torch.zeros((m,) + tuple(xf.shape[1:]), dtype=torch.float32,
                        device=device)
        v = vals if xf.dim() == 1 else vals[:, None]
        return y.index_add_(0, rows, v * xf[ja])

    return fn


def make_csr_segsum_spmm(A: CSR, device: torch.device):
    """SpMM-only variant: ``fn(X[n, c]) -> Y[m, c]``; a 1-D x raises."""
    fn = make_csr_segsum(A, device)

    def spmm(X):
        if np.ndim(X) != 2:
            raise ValueError(f"torch-csr-segsum-spmm: X has shape "
                             f"{tuple(np.shape(X))}, expected (n, cols)")
        return fn(X)

    return spmm


def _put_ell(E: UniformEll, device, dtype):
    # int32 column indices, as the reference ships them (its hbm_bytes)
    return (torch.as_tensor(E.ja, dtype=torch.int32, device=device),
            torch.as_tensor(E.as_, dtype=dtype, device=device))


def make_ell_uniform(E: UniformEll, device: torch.device):
    """``fn(x) -> y`` over the statically padded ELL arrays, either
    layout; the reduction runs over the slot axis (axis 2 row-major,
    axis 1 col-major — hll.c:84-88). X (n, c) gives Y (m, c)."""
    ja, as_ = _put_ell(E, device, torch.float32)
    m = E.m
    slot_axis = 1 if E.col_major else 2

    def fn(x):
        xf = torch.as_tensor(x, dtype=torch.float32, device=device)
        if xf.dim() == 1:
            return (as_ * xf[ja]).sum(dim=slot_axis).reshape(-1)[:m]
        Y = (as_[..., None] * xf[ja]).sum(dim=slot_axis)
        return Y.reshape(-1, xf.shape[1])[:m]

    return fn


def make_dense(A: CSR, device: torch.device):
    """Materialize A densely and matmul — only for tiny matrices, where
    every sparse path is launch-bound."""
    Ad = torch.as_tensor(A.to_dense(), dtype=torch.float32, device=device)

    def fn(x):
        return Ad @ torch.as_tensor(x, dtype=torch.float32, device=device)

    return fn


def serial_ell(E, x: np.ndarray) -> np.ndarray:
    """Host fp64 HLL-analog serial SpMV (reference: hll_spmv_serial,
    hll.c:127-150): per-slice padded gather-multiply in NumPy."""
    x = np.asarray(x, dtype=np.float64)
    y = np.zeros(E.m, dtype=np.float64)
    for s in range(E.num_slices):
        ja, as_ = E.block(s)
        if E.col_major:
            ja, as_ = ja.T, as_.T
        safe = np.maximum(ja, 0)
        vals = as_ * x[safe]
        if E.pad_mode == "neg1":
            vals = np.where(ja >= 0, vals, 0.0)
        r0 = s * E.slice_h
        y[r0:r0 + ja.shape[0]] = vals.sum(axis=1)
    return y


def make_ell_fp64(E: UniformEll, device: torch.device):
    """fp64 SpMV over the uniform ELL arrays: the counterpart of the
    reference's ``make_ell_df64`` (xla.py:155-209), which carries values
    and x as f32 hi/lo pairs through a compensated slot loop because the
    TPU has no fp64. Here values and x are ``torch.float64`` and the slot
    loop adds each slot's product in the same order (slot 0 first), with
    no pairs. ``fn(x)`` takes x as float64 and returns y (m,) float64 on
    ``device``."""
    slot_axis = 1 if E.col_major else 2
    ja = torch.as_tensor(np.ascontiguousarray(np.moveaxis(E.ja, slot_axis, 0)),
                         dtype=torch.int32, device=device)
    as_ = torch.as_tensor(
        np.ascontiguousarray(np.moveaxis(E.as_, slot_axis, 0)),
        dtype=torch.float64, device=device)
    m = E.m

    def fn(x):
        xd = torch.as_tensor(x, dtype=torch.float64, device=device)
        y = torch.zeros(ja.shape[1:], dtype=torch.float64, device=device)
        for k in range(ja.shape[0]):
            y = y + as_[k] * xd[ja[k]]
        return y.reshape(-1)[:m]

    return fn

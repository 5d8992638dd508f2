"""Plain PyTorch SpMV baselines (counterpart of
``spmv_scpa_tpu/ops/xla.py``): the always-correct paths the hybrid is
measured against, and the auto route for tiny matrices.

Each ``make_*`` puts the matrix on ``device`` once and returns
``fn(x) -> y`` (f32 on ``device``); x may be a numpy array or a tensor.
"""

from __future__ import annotations

import torch

from spmv_scpa_tpu_torch.formats.csr import CSR


def make_csr_segsum(A: CSR, device: torch.device):
    """``A @ x`` as gather ``x[JA]`` times values, summed per row with
    ``index_add_`` (the reference's thread-per-row CSR, cuda_csr.cu:19-31,
    as a flat nnz stream)."""
    ja = torch.as_tensor(A.ja, dtype=torch.int64, device=device)
    vals = torch.as_tensor(A.as_, dtype=torch.float32, device=device)
    rows = torch.as_tensor(A.row_ids(), dtype=torch.int64, device=device)
    m = A.m

    def fn(x):
        xf = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = torch.zeros(m, dtype=torch.float32, device=device)
        return y.index_add_(0, rows, vals * xf[ja])

    return fn


def make_dense(A: CSR, device: torch.device):
    """Materialize A densely and matmul — only for tiny matrices, where
    every sparse path is launch-bound."""
    Ad = torch.as_tensor(A.to_dense(), dtype=torch.float32, device=device)

    def fn(x):
        return Ad @ torch.as_tensor(x, dtype=torch.float32, device=device)

    return fn

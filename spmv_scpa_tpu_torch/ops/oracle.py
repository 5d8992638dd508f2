"""The fp64 host oracle (counterpart of ``spmv_scpa_tpu/ops/oracle.py``,
copied): the reference study's serial CSR kernel in float64
(``csr_spmv_serial``, src/csr.c:201-216) in NumPy, independent of the
device code it validates, and its multi-column form for SpMM.
"""

from __future__ import annotations

import numpy as np

from spmv_scpa_tpu_torch.formats.csr import CSR


def spmv_oracle(A: CSR, x: np.ndarray) -> np.ndarray:
    """y = A @ x in float64 (csr.c:205-212)."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape[0] != A.n:
        raise ValueError(f"x has length {x.shape[0]}, expected {A.n}")
    prod = A.as_ * x[A.ja]
    y = np.zeros(A.m, dtype=np.float64)
    np.add.at(y, A.row_ids(), prod)
    return y


def spmm_oracle(A: CSR, X: np.ndarray) -> np.ndarray:
    """Y = A @ X for multi-column X (the SpMM extension; no reference
    analog — the reference is single-vector only)."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        return spmv_oracle(A, X)
    if X.shape[0] != A.n:
        raise ValueError(f"X has {X.shape[0]} rows, expected {A.n}")
    prod = A.as_[:, None] * X[A.ja]
    Y = np.zeros((A.m, X.shape[1]), dtype=np.float64)
    np.add.at(Y, A.row_ids(), prod)
    return Y

"""Result validation against the fp64 oracle (counterpart of
``spmv_scpa_tpu/utils/validation.py``, copied).

The reference study checks the absolute L2 norm of (expected - got)
against epsilon = 1e-1 (``validation_vec_result``, src/utils.c:39-60);
that gate is kept for results of norm >= 1, beside a relative one.
"""

from __future__ import annotations

import numpy as np

from spmv_scpa_tpu_torch.errors import ValidationError

# Reference epsilon (utils.c:53).
EPSILON_ABS_L2 = 1e-1
# Relative tolerance for f32 device kernels vs the fp64 oracle: each of
# the ~row_nnz f32 multiply-adds contributes ~2^-24 relative error.
DEFAULT_RTOL = 1e-4


def l2_error(expected: np.ndarray, got: np.ndarray) -> float:
    expected = np.asarray(expected, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    return float(np.linalg.norm(expected - got))


def validate_result(expected, got, *, rtol: float = DEFAULT_RTOL,
                    abs_l2: float = EPSILON_ABS_L2,
                    what: str = "result") -> float:
    """Raise :class:`ValidationError` unless ``got`` matches
    ``expected``; return the relative L2 error. Accepts the relative-L2
    criterion, or the absolute-L2 gate when ``||expected|| >= 1``."""
    expected = np.asarray(expected, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    if expected.shape != got.shape:
        raise ValidationError(
            f"{what}: shape mismatch {got.shape} vs {expected.shape} "
            "(reference: utils.c:44-47)")
    err = l2_error(expected, got)
    scale = float(np.linalg.norm(expected))
    rel = err / scale if scale > 0 else err
    if (err <= abs_l2 and scale >= 1.0) or rel <= rtol:
        return rel
    raise ValidationError(
        f"{what}: L2 error {err:.3e} (rel {rel:.3e}) exceeds "
        f"abs {abs_l2:g} / rel {rtol:g} (reference eps: utils.c:53)")

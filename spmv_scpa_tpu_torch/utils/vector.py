"""Dense vector helpers (counterpart of ``spmv_scpa_tpu/utils/vector.py``,
copied). The reference study fills x with unseeded ``rand()/RAND_MAX``,
deterministic because the seed is never set (vector.c:36-41); here the
seed is explicit.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 42


def make_x(n: int, cols: int | None = None, seed: int = DEFAULT_SEED,
           dtype=np.float64) -> np.ndarray:
    """Uniform [0,1) vector (or (n, cols) matrix), fixed seed."""
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    return rng.random(shape, dtype=np.float64).astype(dtype)

"""Stencil/FEM archetype (ML_Laplace-type), a frozen copy of
``spmv_scpa_tpu_torch.testing.stencil_csr``: every row has the same
``points`` contiguous runs of ``run_len`` columns at fixed offsets from
the diagonal, jittered only between 8-row blocks. Integer and normal
draws only, so every numpy version gives the same matrix.
"""

from __future__ import annotations

import numpy as np

from spmv_bench.csr import Matrix, from_coo


def build(m: int, n: int | None = None, points: int = 6, run_len: int = 12,
          bandwidth: int = 500, seed: int = 0,
          name: str = "synth_stencil") -> Matrix:
    n = n or m
    rng = np.random.default_rng(seed)
    base_off = np.sort(rng.integers(-bandwidth // 2, bandwidth // 2,
                                    size=points))
    nblocks = -(-m // 8)
    jitter = rng.integers(-8, 9, size=(nblocks, points))
    off = base_off[None, :] + jitter
    rows = np.repeat(np.arange(m), points * run_len)
    centers = np.arange(m, dtype=np.int64)
    starts = off[np.arange(m) // 8]
    cols = (centers[:, None, None] + starts[:, :, None]
            + np.arange(run_len)[None, None, :]).reshape(-1)
    cols = np.clip(cols, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return from_coo(name, m, n, rows[first], cols[first], vals[first])

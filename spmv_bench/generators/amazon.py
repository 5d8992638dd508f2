"""amazon0302-style co-purchase graph stand-in, a frozen copy of
``spmv_scpa_tpu_torch.testing.amazon_csr`` (the webbase copying-model
generator with tight locality, thin-tailed out-degree and small shared
pools). Its zipf and geometric draws depend on numpy's version: the
matrix is the same wherever numpy is the same.
"""

from __future__ import annotations

import numpy as np

from spmv_bench.csr import Matrix, from_coo


def build(m: int = 262_000, avg_nnz: float = 4.7, local_frac: float = 0.9,
          locality: int = 300, alpha: float = 3.0, copy_frac: float = 0.5,
          site_mean: int = 32, pool_k: int = 8, seed: int = 0,
          name: str = "synth_amazon") -> Matrix:
    n = m
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(alpha, size=m), 50_000)
    total_target = int(m * avg_nnz)
    lens = np.maximum(1, (lens * (total_target / lens.sum())).astype(
        np.int64))
    total = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    local = rng.integers(-locality, locality + 1, size=total)
    hub = (rng.zipf(1.3, size=total) - 1) % n
    use_local = rng.random(total) < local_frac
    cols = np.where(use_local, np.clip(rows + local, 0, n - 1), hub)
    if copy_frac > 0.0:
        nsites = max(1, int(2.2 * m / site_mean))
        sizes = rng.geometric(1.0 / site_mean, size=nsites)
        site_of = np.repeat(np.arange(nsites), sizes)[:m].astype(np.int64)
        if site_of.shape[0] < m:
            site_of = np.concatenate(
                [site_of, np.full(m - site_of.shape[0], nsites - 1,
                                  np.int64)])
        site_start = np.full(nsites, m - 1, np.int64)
        np.minimum.at(site_start, site_of, np.arange(m))
        pool_loc = rng.integers(0, 3 * site_mean, size=(nsites, pool_k))
        pool = np.clip(site_start[:, None] + pool_loc, 0, n - 1)
        pool_hub = (rng.zipf(1.3, size=(nsites, pool_k)) - 1) % n
        is_hub = rng.random((nsites, pool_k)) < 0.25
        pool = np.where(is_hub, pool_hub, pool)
        pick = rng.integers(0, pool_k, size=total)
        copied = pool[site_of[rows], pick]
        cols = np.where(rng.random(total) < copy_frac, copied, cols)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(first.shape[0])
    return from_coo(name, m, n, rows[first], cols[first], vals)

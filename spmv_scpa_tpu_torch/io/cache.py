"""Preprocessed-layout cache (counterpart of
``spmv_scpa_tpu/io/cache.py``, copied).

The reference study re-parses the ``.mtx`` file on every run
(csr.c:31-171). The CSR is cached as ``.npz`` under a content
fingerprint instead, so repeat benchmark sweeps skip the parse. The
fingerprint, ``CACHE_VERSION`` and the ``.npz`` keys are the JAX
package's: each package reads the other's cache file.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from spmv_scpa_tpu_torch.formats.csr import CSR

CACHE_VERSION = 1


def _fingerprint(path: str) -> str:
    """Cheap content fingerprint: size + mtime + head/tail bytes."""
    st = os.stat(path)
    h = hashlib.sha256(f"{st.st_size}:{st.st_mtime_ns}:{CACHE_VERSION}"
                       .encode())
    with open(path, "rb") as f:
        h.update(f.read(4096))
        if st.st_size > 4096:
            f.seek(-min(4096, st.st_size - 4096), os.SEEK_END)
            h.update(f.read(4096))
    return h.hexdigest()[:16]


def cache_path(path: str, cache_dir: str | None = None) -> str:
    d = cache_dir or os.path.join(os.path.dirname(os.path.abspath(path)),
                                  ".spmv_cache")
    return os.path.join(d, f"{os.path.basename(path)}.{_fingerprint(path)}.npz")


def load_csr_cached(path: str, cache_dir: str | None = None,
                    **load_kw) -> CSR:
    """``load_csr`` with a transparent ``.npz`` layout cache."""
    from spmv_scpa_tpu_torch.io.loader import load_csr

    cp = cache_path(path, cache_dir)
    if os.path.exists(cp):
        z = np.load(cp)
        return CSR(name=str(z["name"]), m=int(z["m"]), n=int(z["n"]),
                   irp=z["irp"], ja=z["ja"], as_=z["as_"])
    A = load_csr(path, **load_kw)
    os.makedirs(os.path.dirname(cp), exist_ok=True)
    tmp = cp + ".tmp"
    np.savez_compressed(tmp, name=A.name, m=A.m, n=A.n,
                        irp=A.irp, ja=A.ja, as_=A.as_)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, cp)
    return A

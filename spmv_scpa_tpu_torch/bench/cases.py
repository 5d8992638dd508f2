"""The matrices the port is checked and measured on.

``SMALL_CASES`` are the small parity matrices with their packing
knobs; between them they reach every branch of the core kernel and each
kernel of the ext route and the chips tail. ``flagship`` is the main
path's full-size input: the ML_Laplace stand-in of ``bench.py``
(22,588,601 nnz, the size of the SuiteSparse ML_Laplace the reference
study benchmarks) with bench.py's knobs. ``amazon262k`` is the
amazon0302 stand-in of ``scripts/results.py`` (262,000 rows, about 1M
nnz; amazon0302 has 262,111 rows and 1.23M nnz), which takes the ext
route (resident stage 2) and the chips tail with default knobs.
``ext_windowed1m`` is the windowed ext construction at webbase-1M's row
count (1,000,000 rows, 5M nnz), the full-size input of the windowed
stage 2. ``powerlaw100k`` (the synthetic suite's no-locality stress
case, ``scripts/results.py``) takes the hybrid's no-locality escape to
``cuda-pell``; ``webbase1m`` (the webbase-1M stand-in of the reference
study's matrix) leaves the hybrid a big tail that runs as compact PELL.
``PELL_CASES`` are the small PELL-family cases. ``XPOSE_CASES`` are the
small ``cuda-xpose`` cases: the JAX package's XPOSE test matrices
(``tests/test_xpose.py:_cases``), webbase and amazon stand-ins with
mirror windows and virtual rows, and ``webbase200k``, whose plan routes
S1 through two output windows (W1 = 2). ``random30k``
(``random_csr(30000, density=0.0005, seed=3)``, the mac_econ-like
uniform scatter) and ``webbase1m`` are what ``pick_auto`` sends to
``cuda-xpose`` at full size. ``FP64_CASES`` and ``SPMM_CASES`` are the
small cases of the fp64 grade (``cuda-hybrid-fp64``, ``cuda-pell-fp64``)
and of ``cuda-bcsr-spmm``; ``stencil48k`` is the 64-column SpMM input
(the flagship's X at 64 columns, 96.5 MB, is past the reference's X
budget).
"""

from __future__ import annotations

import numpy as np

from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.formats.csr import CSR


def _stencil4k():
    return synth.stencil_csr(4000, points=6, run_len=8, bandwidth=300,
                             seed=2)


def ext_windowed(m: int) -> CSR:
    """Four near-diagonal entries per row plus one at diagonal + 8000
    (tests/test_lane_ell.py:258-277): the out-of-window columns form a
    narrow band per row group, so the ext planner takes the windowed
    stage 2. Integer and normal draws only, so every numpy version gives
    the same matrix."""
    rng = np.random.default_rng(9)
    n = m
    r_loc = np.repeat(np.arange(m, dtype=np.int64), 4)
    c_loc = (r_loc + rng.integers(-30, 30, r_loc.size)) % n
    r_out = np.arange(m, dtype=np.int64)
    c_out = (r_out + 8000 + rng.integers(0, 64, m)) % n
    rows = np.concatenate([r_loc, r_out])
    cols = np.concatenate([c_loc, c_out])
    vals = rng.standard_normal(rows.size)
    return CSR.from_coo("ext_windowed", m, n, rows, cols, vals)


def ext_windowed40k() -> CSR:
    return ext_windowed(40_000)


def ext_windowed1m() -> CSR:
    return ext_windowed(1_000_000)


# name -> (matrix factory, prepare knobs)
SMALL_CASES = {
    # __graft_entry__.entry()'s matrix: a 28-entry compact tail
    "banded512": (lambda: synth.banded_csr(512, row_nnz=12, bandwidth=96,
                                           runs=3, seed=7), {}),
    # strip demotion and relocation engage
    "stencil4k": (_stencil4k, {"slots": 80, "chunk": 24}),
    # bench.py's config: int8 index planes
    "stencil4k-idx8": (_stencil4k, {"slots": 80, "chunk": 24, "idx8": True,
                                    "undrop_min": 2048}),
    # per-step dynamic strips on primary planes
    "stencil4k-dyn": (_stencil4k, {"slots": 80, "chunk": 24,
                                   "dyn_strips": True, "max_strips": 2}),
    # hot strips, dynamic catch-all planes and a compact tail (the
    # dynamic planes depend on numpy's generators: not every numpy
    # version gives this matrix catch-all planes)
    "amazon20k": (lambda: synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
                  {"ext": False, "diag": "nochips"}),
    # default knobs: ext panels with the resident stage 2, and a chips
    # tail with the ranked heavy-row merge
    "amazon60k": (lambda: synth.amazon_csr(m=60000, seed=6), {}),
    # ext panels with the windowed stage 2, compact tail
    "ext-windowed40k": (ext_windowed40k, {}),
}

FLAGSHIP_KNOBS = {"idx8": True, "undrop_min": 2048}


def flagship():
    return synth.stencil_csr(377_000, points=6, run_len=12, bandwidth=500,
                             seed=3, name="ml_laplace_like")


def amazon262k():
    return synth.amazon_csr(m=262_000, seed=6)


def powerlaw100k():
    return synth.powerlaw_csr(100_000, 100_000, avg_nnz=8, seed=5)


def webbase1m():
    return synth.webbase_csr(1_000_000, seed=7)


def empty_windows() -> CSR:
    """Entries in rows 1100-1199 and 5900-5949 of 6000 only: with windows
    of 128 (or 16) row blocks, leading, interior and trailing windows
    are empty (tests/test_kernels.py:58-99)."""
    rows = np.concatenate([np.arange(1100, 1200), np.arange(5900, 5950)])
    cols = (rows * 7) % 512
    vals = np.linspace(1.0, 2.0, rows.shape[0])
    return CSR.from_coo("empty_windows", 6000, 512, rows, cols, vals)


def _powerlaw1500():
    return synth.powerlaw_csr(1500, avg_nnz=20, seed=0)


# name -> (matrix factory, strategy, prepare knobs). Between them they
# run the fused scheme with and without the row sort and with int8 and
# int16 indices, the span and pure schemes, empty windows, and BCSR's
# dense tiles: all four PELL-family kernels and the window segment-sum.
PELL_CASES = {
    "pell-pl3000": (lambda: synth.powerlaw_csr(3000, 2000, seed=31),
                    "cuda-pell", {"chunk": 8, "quantum": 8,
                                  "row_sort": True}),
    "pell-pl4000": (lambda: synth.powerlaw_csr(4000, 4000, seed=5),
                    "cuda-pell", {}),
    "pell-span1500": (_powerlaw1500, "cuda-pell", {"scheme": "span"}),
    "pell-pure1500": (_powerlaw1500, "cuda-pell", {"scheme": "pure"}),
    "pell-banded2000": (lambda: synth.banded_csr(2000, row_nnz=11,
                                                 bandwidth=48, seed=5),
                        "cuda-pell", {}),
    "pell-empty-windows": (empty_windows, "cuda-pell", {"scheme": "pure"}),
    "pell-empty-fused": (empty_windows, "cuda-pell", {"row_sort": False}),
    "bcsr-banded200": (lambda: synth.banded_csr(200, row_nnz=11,
                                                bandwidth=48, seed=5),
                       "cuda-bcsr", {"chunk": 4}),
}


def random30k() -> CSR:
    return synth.random_csr(30000, density=0.0005, seed=3)


def make(spec, module=synth) -> CSR:
    """The matrix of a ``(generator name, arguments)`` spec, drawn by
    ``module`` (the port's ``testing`` by default; the parity tests pass
    the JAX package's to draw the same matrix there)."""
    fn, kw = spec
    return getattr(module, fn)(**kw)


# name -> (generator of testing.py, arguments)
XPOSE_CASES = {
    "rand-1k": ("random_csr", dict(m=1000, density=0.004, seed=1)),
    "banded-2k": ("banded_csr", dict(m=2000, row_nnz=9, bandwidth=64,
                                     seed=2)),
    "rand-8k": ("random_csr", dict(m=8000, density=0.0008, seed=3)),
    "webbase30k": ("webbase_csr", dict(m=30000, seed=7)),
    "amazon8k": ("amazon_csr", dict(m=8000, seed=6)),
    "webbase200k": ("webbase_csr", dict(m=200_000, seed=7)),
}

# The hybrid with a big tail through XPOSE: the amazon20k small case's
# 3,091-entry tail past tail_xla_max, planned by XPOSE.
XPOSE_TAIL = (("amazon_csr", dict(m=20000, avg_nnz=4.7, seed=4)),
              {"ext": False, "diag": "nochips", "tail_xla_max": 1000,
               "tail_strategy": "pallas-xpose"})


def wide_exponents() -> CSR:
    """The banded matrix of tests/test_lane_ell.py:315-332 with values
    spanning 12 decades, where f32 misses the fp64 gate."""
    A = synth.banded_csr(3000, row_nnz=24, bandwidth=256, seed=5)
    rng = np.random.default_rng(5)
    return CSR(A.name + "_wide", A.m, A.n, A.irp, A.ja,
               A.as_ * 10.0 ** rng.uniform(-6, 6, A.nnz))


# name -> (matrix factory, strategy, prepare knobs): the fp64 grade's two
# kernels on the banded, stencil and scattered archetypes
FP64_CASES = {
    "fp64-hybrid-stencil2k": (
        lambda: synth.stencil_csr(2000, points=6, run_len=8, bandwidth=300,
                                  seed=6), "cuda-hybrid-fp64", {}),
    "fp64-hybrid-wide": (wide_exponents, "cuda-hybrid-fp64", {}),
    "fp64-pell-banded512": (
        lambda: synth.banded_csr(512, row_nnz=9, bandwidth=64, seed=3),
        "cuda-pell-fp64", {}),
    "fp64-pell-powerlaw4k": (lambda: synth.powerlaw_csr(4000, 4000, seed=5),
                             "cuda-pell-fp64", {}),
}

# name -> (matrix factory, prepare knobs) of cuda-bcsr-spmm
SPMM_CASES = {
    # tests/test_kernels.py:223-229
    "spmm-banded200x300": (
        lambda: synth.banded_csr(200, 300, row_nnz=11, bandwidth=48, runs=3,
                                 seed=5), {"cols": 8, "chunk": 4}),
    "spmm-stencil4k-c1": (_stencil4k, {"cols": 1}),
    "spmm-stencil4k-c64": (_stencil4k, {"cols": 64}),
}


def stencil48k() -> CSR:
    """The flagship's stencil at 48,000 rows: the 64-column SpMM input
    (2,866,208 nnz, X 12.3 MB)."""
    return synth.stencil_csr(48_000, points=6, run_len=12, bandwidth=500,
                             seed=3, name="stencil48k")

"""The matrices the port is checked and measured on.

``SMALL_CASES`` are the small parity matrices with their packing
knobs; between them they reach every branch of the core kernel.
``flagship`` is the main path's full-size input: the ML_Laplace
stand-in of ``bench.py`` (22,588,601 nnz, the size of the SuiteSparse
ML_Laplace the reference study benchmarks) with bench.py's knobs.
"""

from __future__ import annotations

from spmv_scpa_tpu import testing as synth


def _stencil4k():
    return synth.stencil_csr(4000, points=6, run_len=8, bandwidth=300,
                             seed=2)


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
}

FLAGSHIP_KNOBS = {"idx8": True, "undrop_min": 2048}


def flagship():
    return synth.stencil_csr(377_000, points=6, run_len=12, bandwidth=500,
                             seed=3, name="ml_laplace_like")

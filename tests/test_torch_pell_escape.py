"""The hybrid's no-locality escape: a powerlaw matrix whose widest
diagonal window covers under 40% of its entries goes to ``cuda-pell``
whole, as the JAX package's goes to ``pallas-pell``
(spmv_scpa_tpu/ops/lane_ell.py:618-634). The checks and tolerances are
tests/test_torch_big_tail.py's: meta exact with the port's names, y
within rel-L2 1e-4 of JAX (run in interpret mode) and 1e-6 of the
oracle.
"""

from test_torch_big_tail import _route, check_route, kernel_route


def test_escape_matches_jax():
    check_route("escape")


def test_escape_takes_fused_pell_with_the_row_sort():
    meta = _route("escape")[2].meta
    assert meta["delegated"] == "cuda-pell" and meta["d_cov"] < 0.4
    assert meta["scheme"] == "fused" and meta["row_sort"]
    assert kernel_route("escape") == ["pell_fused", "unpermute"]

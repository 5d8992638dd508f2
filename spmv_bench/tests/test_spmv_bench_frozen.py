"""The yardstick's frozen pieces against what they were copied from, and
against arithmetic done by hand."""

import numpy as np
import pytest
import torch

from spmv_bench import reference, roofline
from spmv_bench.csr import from_coo
from spmv_bench.generators import amazon, stencil
from spmv_scpa_tpu_torch import testing


@pytest.mark.parametrize("frozen, original, kw", [
    (stencil.build, testing.stencil_csr,
     dict(m=3000, points=6, run_len=12, bandwidth=500, seed=3)),
    (stencil.build, testing.stencil_csr,
     dict(m=2001, points=4, run_len=5, bandwidth=60, seed=11)),
    (amazon.build, testing.amazon_csr, dict(m=20000, seed=6)),
    (amazon.build, testing.amazon_csr, dict(m=8000, seed=4)),
])
def test_generators_equal_the_ports(frozen, original, kw):
    a, b = frozen(**kw), original(**kw)
    assert (a.m, a.n) == (b.m, b.n)
    for x, y in ((a.irp, b.irp), (a.ja, b.ja), (a.vals, b.as_)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_from_coo_sorts_and_keeps_duplicates():
    rows, cols = [2, 0, 2, 0, 2], [1, 3, 0, 3, 1]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    a = from_coo("t", 3, 4, rows, cols, vals)
    np.testing.assert_array_equal(a.irp, [0, 2, 2, 5])
    np.testing.assert_array_equal(a.ja, [3, 3, 0, 1, 1])
    np.testing.assert_array_equal(a.vals, [2.0, 4.0, 3.0, 1.0, 5.0])


@pytest.mark.parametrize("cols", [1, 3])
def test_reference_equals_a_dense_product(cols):
    rng = np.random.default_rng(5)
    m, n, nnz = 70, 50, 400
    a = from_coo("t", m, n, rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                 rng.standard_normal(nnz))
    dense = np.zeros((m, n))
    np.add.at(dense, (np.repeat(np.arange(m), np.diff(a.irp)), a.ja),
              a.vals)
    X = rng.standard_normal((n, cols) if cols > 1 else n).astype(np.float32)
    Y, S = reference.product(a, torch.from_numpy(X))
    want = dense @ X.astype(np.float64)
    np.testing.assert_allclose(Y.numpy(), want.reshape(m, -1), rtol=1e-12,
                               atol=1e-12)
    # S sums each stored entry's |a x| (duplicates apart, as they are
    # summed)
    rows = np.repeat(np.arange(m), np.diff(a.irp))
    s = np.zeros((m, cols))
    np.add.at(s, rows, np.abs(a.vals[:, None]
                              * X.astype(np.float64).reshape(n, -1)[a.ja]))
    np.testing.assert_allclose(S.numpy(), s, rtol=1e-12, atol=1e-12)
    got = reference.compare(torch.from_numpy(want.astype(np.float32)), Y, S)
    assert got["row_err"] < 1e-7 and got["rel_l2"] < 1e-7


def test_compare_reads_wrong_and_non_finite_answers():
    Y = torch.tensor([[1.0], [2.0], [0.0]], dtype=torch.float64)
    S = torch.tensor([[2.0], [2.0], [0.0]], dtype=torch.float64)
    assert reference.compare(Y.float(), Y, S) == {"row_err": 0.0,
                                                  "rel_l2": 0.0}
    got = reference.compare(torch.tensor([1.0, 3.0, 0.0]), Y, S)
    assert got["row_err"] == pytest.approx(0.5)
    assert got["rel_l2"] == pytest.approx(1 / 5 ** 0.5)
    # an empty row must read exactly 0
    assert reference.compare(torch.tensor([1.0, 2.0, 1e-30]), Y,
                             S)["row_err"] == float("inf")
    nan = reference.compare(torch.tensor([float("nan"), 2.0, 0.0]), Y, S)
    assert nan["row_err"] == float("inf") and nan["rel_l2"] == float("inf")
    assert reference.compare(torch.zeros(2), Y, S)["row_err"] == \
        float("inf")


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11 + 2 ** -20), 3.0e-3],
                     dtype=torch.float32)
    want = [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    got = reference.tf32(x)
    assert got[:4].tolist() == want
    r = got[4].item()
    assert abs(r - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert (torch.tensor([r]).view(torch.int32) & 0x1FFF).item() == 0


@pytest.mark.parametrize("nnz, m, spmv, spmm8", [
    # the flagship stand-in before its rows and entries were set to the
    # source's
    (22_588_601, 377_000, (93_370_404, 0.02787), (114_482_404, 0.03417)),
    # the flagship configuration
    (27_564_310, 377_002, (113_273_256, 0.03381), (134_385_368, 0.04012)),
])
def test_bound_worked_by_hand(nnz, m, spmv, spmm8):
    kind = "NVIDIA H100 80GB HBM3"
    for cols, (nbytes, ms) in ((1, spmv), (8, spmm8)):
        assert roofline.call_bytes(nnz, m, m, cols) == nbytes
        assert roofline.bound_ms(kind, nnz, m, m, cols) == pytest.approx(
            nbytes / 3.35e9)
        assert round(roofline.bound_ms(kind, nnz, m, m, cols), 5) == ms
        # operations never bound these calls: 2*nnz*cols / 67 TFLOP/s
        assert 2 * nnz * cols / 67e9 < ms
    assert roofline.bound_ms("another card", nnz, m, m, 1) is None

"""A configuration's ``dtype`` decides what the harness draws, the bound
it divides by and the control it is held against: float32 (or no
``dtype``) as before, bit for bit; float64 with doubles of its own, 8-byte
values, X and Y against the float64 rate, and A's values at float32 as
its control."""

import dataclasses

import numpy as np
import pytest
import torch

from spmv_bench import reference, roofline
from spmv_bench.csr import from_coo
from spmv_bench.harness import inputs, value_dtype
from spmv_bench.spec import load_cell
from spmv_bench.tests.small import copy_bench

H100 = "NVIDIA H100 80GB HBM3"
SEEDS = (2**31 + 7, 19)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("bench"))


def draw_float32(seed, nnz, n, cols, vectors):
    """The harness's draw as it was before configurations chose their
    dtype, pinned: every float32 cell's values and X."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    vals = rng.standard_normal(nnz, dtype=np.float32)
    shape = (vectors, n) if cols == 1 else (vectors, n, cols)
    xs = rng.standard_normal(shape, dtype=np.float32)
    return vals, xs


@pytest.mark.parametrize("name", ["flagship.spmv", "flagship.spmm8"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", None])
def test_float32_draws_are_the_pinned_ones(root, name, seed, dtype):
    cell = load_cell(name, root)
    config = {k: v for k, v in cell.config.items() if k != "dtype"}
    if dtype is not None:
        config["dtype"] = dtype
    mat, xs = inputs(dataclasses.replace(cell, config=config), seed)
    vals, want = draw_float32(seed, mat.nnz, mat.n, cell.traffic["cols"],
                              cell.traffic["vectors"])
    assert mat.vals.dtype == np.float64 and xs.dtype == np.float32
    assert mat.vals.tobytes() == vals.astype(np.float64).tobytes()
    assert xs.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_draws_doubles_of_their_own(root, seed):
    cell = load_cell("flagship-fp64.spmv", root)
    assert cell.config["dtype"] == "float64"
    mat, xs = inputs(cell, seed)
    assert mat.vals.dtype == np.float64 and xs.dtype == np.float64
    assert xs.shape == (cell.traffic["vectors"], mat.n)
    for a in (mat.vals, xs.ravel()):
        widened = a.astype(np.float32).astype(np.float64)
        assert np.mean(widened != a) > 0.99
    # the same seed gives the same draws; another seed others
    again, xs2 = inputs(cell, seed)
    assert again.vals.tobytes() == mat.vals.tobytes()
    assert xs2.tobytes() == xs.tobytes()
    assert not np.array_equal(inputs(cell, seed + 1)[1], xs)
    # one matrix structure under both dtypes
    f32, _ = inputs(load_cell("flagship.spmv", root), seed)
    assert np.array_equal(f32.irp, mat.irp) and np.array_equal(f32.ja,
                                                               mat.ja)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int8", "f64"])
def test_another_dtype_is_refused(root, dtype):
    cell = load_cell("flagship.spmv", root)
    other = dataclasses.replace(cell, config={**cell.config, "dtype": dtype})
    with pytest.raises(ValueError, match="dtype"):
        inputs(other, 3)
    with pytest.raises(ValueError, match="dtype"):
        value_dtype(other.config)


@pytest.mark.parametrize("nnz, m, cols", [
    (27_564_310, 377_002, 1), (27_564_310, 377_002, 8),
    (22_588_601, 377_000, 1), (102_672, 1500, 1)])
def test_the_float32_bound_is_the_one_before(nnz, m, cols):
    """Bit for bit what the bound read before it followed the dtype:
    4-byte values, X and Y against the float32 rate."""
    before = 1e3 * max(4 * (nnz + (m + m) * cols) / 3.35e12,
                       2 * nnz * cols / 67e12)
    for dtype in (np.float32, "float32"):
        assert roofline.bound_ms(H100, nnz, m, m, cols, dtype) == before
    assert roofline.bound_ms(H100, nnz, m, m, cols) == before
    assert roofline.call_bytes(nnz, m, m, cols) == \
        4 * (nnz + 2 * m * cols)


def test_the_float64_bound_worked_by_hand():
    """flagship-fp64.spmv: 8 B a value, an x entry and a y entry,
    8 * (27,564,310 + 2 * 377,002) = 226,546,512 B at 3.35 TB/s is
    0.06763 ms; its 55,128,620 operations at the float64 rate of
    34 TFLOP/s take 0.00162 ms."""
    nnz, m = 27_564_310, 377_002
    assert roofline.call_bytes(nnz, m, m, 1, 8) == 226_546_512
    ms = roofline.bound_ms(H100, nnz, m, m, 1, np.float64)
    assert ms == pytest.approx(226_546_512 / 3.35e9, rel=1e-15)
    assert round(ms, 5) == 0.06763
    assert 2 * nnz / 34e9 == pytest.approx(0.00162143)
    # 64 columns: the bytes still bound it, at 8 B an element
    ms64 = roofline.bound_ms(H100, nnz, m, m, 64, "float64")
    assert ms64 == pytest.approx(8 * (nnz + 2 * m * 64) / 3.35e9)
    # a million entries in one row times 100 columns: 2e8 operations
    # bound the call, at the float64 rate (34 TFLOP/s) and the float32
    # one (67) each, over 8.0016 and 4.0008 MB of bytes
    assert roofline.bound_ms(H100, 10**6, 1, 1, 100, np.float64) == \
        pytest.approx(2e8 / 34e9)
    assert roofline.bound_ms(H100, 10**6, 1, 1, 100, np.float32) == \
        pytest.approx(2e8 / 67e9)
    assert roofline.bound_ms("another card", nnz, m, m, 1,
                             np.float64) is None


def test_the_float64_control_rounds_the_values_alone():
    """A's values at float32, X and the sums in float64: a value of
    1 + 2**-30 reads as 1, an x of 1 + 2**-40 is kept."""
    a = from_coo("t", 2, 2, [0, 0, 1], [0, 1, 1],
                 [1 + 2 ** -30, 3.0, -(1 + 2 ** -12)])
    x = torch.tensor([1 + 2 ** -40, 2 ** -35], dtype=torch.float64)
    y = reference.control_product(a, x, np.float64)[:, 0]
    assert y.dtype == torch.float64
    assert y.tolist() == [1 + 2 ** -40 + 3 * 2 ** -35,
                          -(1 + 2 ** -12) * 2 ** -35]
    Y, _ = reference.product(a, x)
    assert Y[0, 0].item() == (1 + 2 ** -30) * (1 + 2 ** -40) + 3 * 2 ** -35
    # the float32 control is the TF32 one, as before
    assert reference.control_product(a, x.float()).dtype == torch.float32
    with pytest.raises(ValueError, match="no control"):
        reference.control_product(a, x, np.float16)

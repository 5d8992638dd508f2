"""What decides ``correct`` has to fail what it must: the control (the
reference a precision below the configuration's, put in the program's
place: TF32 for float32, float32 values for float64) and each fault this
system's cells can have, planted under the timed path of a whole run.
At sizes the CPU holds; ``python3 -m spmv_bench.control`` reads the
control at the cells' own sizes on the card."""

import numpy as np
import pytest
import torch

from spmv_bench import reference
from spmv_bench.control import readings
from spmv_bench.harness import inputs, value_dtype
from spmv_bench.run import execute
from spmv_bench.spec import load_cell
from spmv_bench.tests.small import copy_bench

CELLS = ("flagship.spmv", "flagship.spmm8", "flagship-fp64.spmv")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 77])
def test_the_control_fails_every_cell(root, name, seed):
    cell = load_cell(name, root)
    limits = cell.checks["limits"]
    got = readings(cell, seed, "cpu")
    assert all(got[k] > limits[k] for k in limits), (got, limits)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(root, name):
    cell = load_cell(name, root)
    mat, _ = inputs(cell, 5)
    dtype = value_dtype(cell.config)

    def control(_fn):
        return lambda x: reference.control_product(mat, x, dtype).reshape(
            x.shape[0] if x.dim() == 1 else mat.m, *x.shape[1:])

    out = execute(cell, 5, 0.3, False, device="cpu", fault=control,
                  log=lambda _: None)
    assert out["correct"] is False and out["failed"] > 0


def stale(fn):
    """A call that returns the previous call's y: its state unchanged."""
    prev = []

    def call(x):
        y = fn(x)
        out = prev[0] if prev else y
        prev[:] = [y]
        return out
    return call


def half(fn):
    """Half of the rows left out."""
    def call(x):
        y = fn(x).clone()
        y[y.shape[0] // 2:] = 0
        return y
    return call


def altered(fn):
    """One answer altered where it is produced: one row's y off by 1.0,
    about a tenth of a typical row's |A||x|."""
    def call(x):
        y = fn(x).clone()
        y[y.shape[0] // 3] += 1.0
        return y
    return call


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [stale, half, altered])
def test_a_fault_under_the_timed_path_is_not_correct(root, name, fault):
    cell = load_cell(name, root)
    out = execute(cell, 11, 1.0, False, device="cpu", fault=fault,
                  log=lambda _: None)
    assert out["attempted"] >= 2
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(root, name):
    out = execute(load_cell(name, root), 11, 0.3, False, device="cpu",
                  log=lambda _: None)
    assert out["correct"] is True
    for c in out["checks"].values():
        assert c["value"] < c["limit"] / 10


def test_the_control_reads_what_a_program_in_tf32_would():
    """The control equals a float32 product of TF32-rounded inputs."""
    from spmv_bench.csr import from_coo
    a = from_coo("t", 3, 3, [0, 0, 1, 2], [0, 2, 1, 0],
                 [1 + 2 ** -12, 1.0, 3.0, -1.0])
    x = torch.tensor([1.0, 1 + 2 ** -12, 2 ** -14], dtype=torch.float32)
    y = reference.control_product(a, x)[:, 0]
    assert y.tolist() == [1.0 + 2 ** -14, 3.0, -1.0]


def float32_values(cell, seed):
    """The port's own strategy prepared on A's values rounded to float32
    (the value bytes halved, X and the sums still float64): the shortcut
    a float64 cell's limits have to catch."""
    from spmv_scpa_tpu_torch.formats.csr import CSR
    from spmv_scpa_tpu_torch.ops.registry import get_strategy

    mat, _ = inputs(cell, seed)
    A = CSR(name="f32 values", m=mat.m, n=mat.n, irp=mat.irp, ja=mat.ja,
            as_=mat.vals.astype(np.float32).astype(np.float64))
    prep = get_strategy(cell.traffic["strategy"]).prepare(A, device="cpu")
    return lambda _fn: prep.fn


def float32_y(fn):
    """y rounded to float32 where it is produced."""
    return lambda x: fn(x).to(torch.float32).to(torch.float64)


@pytest.mark.parametrize("seed", [13, 2**31 + 17])
@pytest.mark.parametrize("fault", ["values", "y"])
def test_float32_in_a_float64_cell_is_not_correct(root, seed, fault):
    """The float64 cell's limits fail a program that keeps A's values,
    or its y, at float32, by both numbers, as the control does."""
    cell = load_cell("flagship-fp64.spmv", root)
    planted = float32_values(cell, seed) if fault == "values" else float32_y
    out = execute(cell, seed, 0.3, False, device="cpu", fault=planted,
                  log=lambda _: None)
    assert out["correct"] is False and out["failed"] > 0
    for c in out["checks"].values():
        assert c["value"] > 100 * c["limit"]
    control = readings(cell, seed, "cpu")
    for k, c in out["checks"].items():
        assert control[k] > 100 * c["limit"]

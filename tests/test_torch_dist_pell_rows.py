"""The row-sharded PELL on row quanta (``prepare_row_sharded_pell``'s
default ``layout="rows"``, spmv_scpa_tpu_torch/parallel/distributed.py):
against the JAX package's ``prepare_row_sharded_pell`` (its fused
kernel in interpret mode, as tests/test_distributed.py runs it) and the
oracle, its per-device plans against ``pell_rows.plan_pell_rows`` of the
stacked shards, and its launches.

Tolerances: the plans, exact. y against the JAX y: rel-L2 <= 1e-5
(``VS_JAX_PELL_REL_L2`` of tests/test_torch_distributed.py: the
reference's fused kernel reduces with two bf16 split passes, 16 bits of
each operand, while the port adds f32 products in its row tree). y
against ``spmv_oracle``: ``validate_result`` defaults.
"""

import jax
import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.parallel import distributed as JD

from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops import pell_rows
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.parallel import distributed as D
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_PELL_REL_L2 = 1e-5


def _three_rows(module):
    """3 rows over 8 shards: most shards hold no row."""
    cls = JaxCSR if module is jax_synth else CSR
    return cls.from_coo("three", 3, 8, [0, 0, 1, 2, 2, 2], [0, 5, 2, 1, 3, 7],
                        [1.0, -2.0, 3.0, 0.5, 4.0, -1.5])


# name -> (matrix of a testing module, shard counts, the JAX knobs)
MATRICES = {
    "banded400": (lambda mod: mod.banded_csr(400, row_nnz=9, bandwidth=60,
                                             runs=3, seed=8), (1, 2, 4),
                  {"window_h": 128}),
    "powerlaw1200": (lambda mod: mod.powerlaw_csr(1200, 1200, seed=21),
                     (1, 2, 4), {}),
    "three-rows": (_three_rows, (8,), {}),
}
CASES = [(name, k) for name, (_, ks, _) in sorted(MATRICES.items())
         for k in ks]


@pytest.mark.parametrize("name, k", CASES)
def test_rows_match_jax_and_the_oracle(name, k):
    make, _, kw = MATRICES[name]
    A = make(synth)
    prep = D.prepare_row_sharded_pell(A, mesh=["cpu"] * k, **kw)
    assert prep.meta["layout"] == "rows"
    jd = JD.prepare_row_sharded_pell(
        make(jax_synth), mesh=JD.make_mesh(devices=jax.devices("cpu")[:k]),
        interpret=True, **kw)
    x = make_x(A.n)
    y = prep.fn(x)
    assert y.dtype == torch.float32 and y.shape == (A.m,)
    y = y.double().numpy()
    y_jax = np.asarray(jd.fn(x), np.float64)
    assert np.linalg.norm(y - y_jax) <= \
        VS_JAX_PELL_REL_L2 * np.linalg.norm(y_jax)
    validate_result(spmv_oracle(A, x), y, what=f"{name} on {k} shards")


def _stacked(A, k):
    """A's row shards (``plan_row_shards``) stacked by hand: shard j's
    rows at ``j * h_rows``, empty rows after them."""
    bounds, h_rows = D.plan_row_shards(A, k)
    rows = A.row_ids().astype(np.int64)
    shard = np.searchsorted(bounds, rows, side="right") - 1
    local = rows - bounds[shard] + shard * h_rows
    return CSR.from_coo(A.name, k * h_rows, A.n, local, A.ja, A.as_), h_rows


@pytest.mark.parametrize("k", [1, 3, 8])
def test_one_device_plan_is_plan_pell_rows_of_the_stacked_shards(k):
    """All shards on one device: one plan, ``plan_pell_rows`` of the
    stacked shards array for array at the whole matrix's quantum, and one
    ``pell_rows`` call a call."""
    A = synth.powerlaw_csr(1200, 1200, seed=21)
    prep = D.prepare_row_sharded_pell(A, mesh=["cpu"] * k)
    S, h_rows = _stacked(A, k)
    Q = pell_rows.pick_quantum(np.diff(A.irp).astype(np.int64), 4)
    plan = pell_rows.plan_pell_rows(S, torch.float32, Q)
    for want, got in zip((plan.vals, plan.cols, plan.qptr, plan.blk_lo),
                         prep.args, strict=True):
        np.testing.assert_array_equal(want, got)
    assert prep.hbm_bytes == plan.hbm_bytes
    assert prep.meta == {"layout": "rows", "quantum": Q,
                         "quanta": plan.meta["quanta"],
                         "blocks": plan.meta["blocks"],
                         "fill": A.nnz / (plan.meta["quanta"] * Q),
                         "h_rows": h_rows}
    calls = prep.kernel_calls(torch.as_tensor(make_x(A.n),
                                              dtype=torch.float32))
    assert [name for name, _ in calls] == ["pell_rows"]
    before = dict(pell_rows.LAUNCHES)
    prep.fn(make_x(A.n))                      # CPU: the plain version
    assert pell_rows.LAUNCHES == before


def test_devices_each_get_one_plan():
    """Two distinct devices (the CPU under two names): a plan and a
    ``pell_rows`` call each, the shards of each stacked on their own."""
    A = synth.banded_csr(900, row_nnz=9, bandwidth=60, seed=3)
    mesh = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    prep = D.prepare_row_sharded_pell(A, mesh=mesh)
    groups = D._device_groups(prep.mesh)
    assert len(groups) == 2 and len(prep.args) == 8
    calls = prep.kernel_calls(torch.as_tensor(make_x(A.n),
                                              dtype=torch.float32))
    assert [name for name, _ in calls] == ["pell_rows"] * 2
    validate_result(spmv_oracle(A, make_x(A.n)),
                    prep.fn(make_x(A.n)).double().numpy(), what="two plans")


def test_quantum_and_tile_knobs():
    """Q comes from the whole matrix's rows unless given; the tile
    knobs, recorded, act on nothing; an unknown layout is refused."""
    A = synth.powerlaw_csr(1200, 1200, seed=21)
    auto = D.prepare_row_sharded_pell(A, mesh=["cpu"] * 2)
    q8 = D.prepare_row_sharded_pell(A, mesh=["cpu"] * 2, quantum=8,
                                    window_h=64, row_sort=True)
    assert auto.meta["quantum"] == pell_rows.pick_quantum(
        np.diff(A.irp).astype(np.int64), 4) and "tile_knobs" not in auto.meta
    assert q8.meta["quantum"] == 8 and q8.args[0].shape[1] == 8
    assert q8.meta["tile_knobs"] == {"window_h": 64, "row_sort": True}
    x = make_x(A.n)
    np.testing.assert_allclose(q8.fn(x).numpy(), auto.fn(x).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        D.prepare_row_sharded_pell(A, mesh=["cpu"], layout="planes")


def test_tiles_layout_keeps_the_fused_kernels():
    """``layout="tiles"``: the reference's fused PELL and the
    un-permute (its arrays: tests/test_torch_distributed.py)."""
    A = synth.powerlaw_csr(1200, 1200, seed=21)
    prep = D.prepare_row_sharded_pell(A, mesh=["cpu"] * 4, layout="tiles")
    assert prep.meta["row_sort"] and "layout" not in prep.meta
    calls = prep.kernel_calls(torch.as_tensor(make_x(A.n),
                                              dtype=torch.float32))
    assert {name for name, _ in calls} == {"pell_fused", "unpermute"}
    x = make_x(A.n)
    rows = D.prepare_row_sharded_pell(A, mesh=["cpu"] * 4)
    np.testing.assert_allclose(prep.fn(x).numpy(), rows.fn(x).numpy(),
                               rtol=1e-5, atol=1e-5)

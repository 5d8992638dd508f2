"""XPOSE's stage S3 as row sums (spmv_scpa_tpu_torch/ops/xpose.py:
``s3_rows_table``, ``xpose_s3_rows``), and the two stream-probe entry
points, on the CPU. The kernels themselves are held against their plain
versions on the card in tests/test_torch_cuda.py.

Tolerances:
* the slot table against ``chip_smoke.s3_slots``' mapping of the prefix
  design's planes, with the virtual rows folded into their rows: exact
  (the same products in the same rows);
* the plain version against a NumPy loop in the kernel's order: exact;
* y against ``simulate_xpose`` (fp64) and against the prefix design:
  rel-L2 <= 1e-5, the bound of tests/test_torch_xpose.py (the row sums
  add each row's f32 products; measured 5.2e-8 to 7.7e-8 against
  ``simulate_xpose``);
* the probes' plain version: exact on sums of small integers.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from spmv_scpa_tpu.ops import xpose_plan as jax_xp

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch.bench import cases, roofline
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import lane_ell, nearfar, xpose, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_SIM_REL_L2 = 1e-5
CASES = sorted(cases.XPOSE_CASES)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _case(name):
    """(matrix, plan, both designs' Prepared from that plan, x)."""
    A = cases.make(cases.XPOSE_CASES[name])
    preps = xpose.prepare_xpose_designs(A, device="cpu")
    return A, xpose_plan.plan_xpose(A), preps, make_x(A.n)


def _call(prep, name, x):
    (args,) = [a for k, a in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32)) if k == name]
    return args


# ---- the table ------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_table_is_s3_slots_with_virtual_rows_folded(name):
    """Every (row, product) pair of the table is one of the prefix
    design's occupied slots in the row its extraction gives it, virtual
    rows moved onto their real rows; rows ascending, positions ascending
    within a row."""
    A, plan, preps, x = _case(name)
    rowptr, pos = xpose.s3_rows_table(plan)
    assert rowptr.dtype == pos.dtype == np.int32
    assert rowptr.shape == (plan.m + 1,) and rowptr[0] == 0
    assert rowptr[-1] == pos.size == A.nnz
    assert (np.diff(rowptr) >= 0).all()
    row = np.repeat(np.arange(plan.m), np.diff(rowptr))
    assert (np.diff(pos)[row[1:] == row[:-1]] > 0).all()
    src, dest = _chip_smoke().s3_slots(_call(preps["prefix"], "xpose_s3", x))
    fold = np.r_[np.arange(plan.m), plan.v_row].astype(np.int64)
    assert sorted(zip(row.tolist(), pos.tolist())) == sorted(
        zip(fold[dest.numpy()].tolist(), src.tolist()))


def test_cases_cover_the_table_shapes():
    """Virtual rows folded in, rows with no products, and rows past one
    lane's SHORT_ROW (the warp's tree) among the cases."""
    lens = {n: np.diff(xpose.s3_rows_table(_case(n)[1])[0]) for n in CASES}
    assert _case("webbase30k")[1].m2 > _case("webbase30k")[1].m
    assert any((v == 0).any() for v in lens.values())
    assert any((v > xpose.SHORT_ROW).any() for v in lens.values())


# ---- the plain version -------------------------------------------------------

def _loop(mid, rowptr, pos):
    """The kernel's order in a NumPy loop: pointers clamped, a position
    outside mid 0.0, a row of at most SHORT_ROW products added in order
    from 0.0, a longer one dealt to 32 lanes and halved."""
    m = mid.reshape(-1)
    S = pos.size
    y = np.zeros(rowptr.size - 1, np.float32)
    for r in range(y.size):
        lo = min(max(rowptr[r], 0), S)
        hi = min(max(rowptr[r + 1], lo), S)
        v = [m[p] if 0 <= p < m.size else np.float32(0) for p in pos[lo:hi]]
        if hi - lo <= xpose.SHORT_ROW:
            a = np.float32(0)
            for t in v:
                a = np.float32(a + t)
            y[r] = a
            continue
        lanes = np.zeros(32, np.float32)
        for k, t in enumerate(v):
            lanes[k % 32] = np.float32(lanes[k % 32] + t)
        while lanes.size > 1:
            lanes = lanes[:lanes.size // 2] + lanes[lanes.size // 2:]
        y[r] = lanes[0]
    return y


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_plain_follows_the_kernels_order(seed):
    """Random rows of 0 to 3,000 products (long rows past the warp's 32
    lanes), values over several decades so the order shows, some pointers
    past the table or below their start, some positions outside mid."""
    rng = np.random.default_rng(seed)
    mid = (rng.standard_normal((5, 9, BC))
           * 10.0 ** rng.integers(-3, 4, (5, 9, BC))).astype(np.float32)
    lens = rng.choice([0, 1, 3, 17, 32, 33, 64, 500, 3000], 400,
                      p=[.2, .2, .2, .1, .1, .05, .05, .05, .05])
    rowptr = np.r_[0, np.cumsum(lens)]
    S = int(rowptr[-1])
    bad = rng.random(rowptr.size) < 0.02
    rowptr[bad] = rng.integers(-50, S + 5000, int(bad.sum()))
    pos = rng.integers(-100, mid.size + 100, S)
    got = xpose.xpose_s3_rows(torch.as_tensor(mid),
                              torch.as_tensor(rowptr, dtype=torch.int32),
                              torch.as_tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), _loop(mid, rowptr, pos))


@pytest.mark.parametrize("name", CASES)
def test_rows_plain_matches_simulate(name):
    """S3 as row sums on S1's products against simulate_xpose, and
    against the prefix design on the same products."""
    A, plan, preps, x = _case(name)
    mid, rowptr, pos = _call(preps["rows"], "xpose_s3_rows", x)
    y = xpose.xpose_s3_rows_plain(mid, rowptr, pos)
    assert y.shape == (A.m,) and y.dtype == torch.float32
    want = jax_xp.simulate_xpose(plan, x.astype(np.float64))
    assert _rel_l2(y.double().numpy(), want) <= VS_SIM_REL_L2
    y_prefix = to_numpy(preps["prefix"].fn(x))
    assert _rel_l2(y.double().numpy(), y_prefix) <= VS_SIM_REL_L2


@pytest.mark.parametrize("name", ["rand-1k", "webbase30k"])
def test_designs_share_one_plan(name):
    """prepare_xpose_designs binds both designs from one plan: the meta
    differs only in ``s3``, the row sums move fewer bytes, and
    prepare_xpose's default is the row sums."""
    A, plan, preps, x = _case(name)
    rows, prefix = preps["rows"].meta, preps["prefix"].meta
    assert {k: v for k, v in rows.items() if k != "s3"} == \
        {k: v for k, v in prefix.items() if k != "s3"}
    assert (rows["s3"], prefix["s3"]) == ("rows", "prefix")
    assert preps["rows"].hbm_bytes < preps["prefix"].hbm_bytes
    assert preps["rows"].hbm_bytes == xpose.hbm_bytes(plan, "rows")
    assert xpose.prepare_xpose(A, device="cpu").meta["s3"] == "rows"
    validate_result(spmv_oracle(A, x), to_numpy(preps["rows"].fn(x)),
                    what=f"cuda-xpose (rows) on {name}")


def test_bad_design_names_raise():
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    with pytest.raises(ValueError, match="s3 'scan'"):
        xpose.prepare_xpose(A, device="cpu", s3="scan")
    with pytest.raises(ValueError, match="s3 'scan'"):
        nearfar.prepare_nearfar(A, device="cpu", s3="scan")
    spec, kw = cases.XPOSE_TAIL
    with pytest.raises(ValueError, match="s3 'scan'"):
        lane_ell.prepare_lane_ell_hybrid(cases.make(spec), device="cpu",
                                         xpose_s3="scan", **kw)


def test_rows_wrapper_refuses_bad_tables():
    mid = torch.zeros((2, 8, BC))
    rowptr = torch.zeros(11, dtype=torch.int32)
    pos = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="rowptr is"):
        xpose.xpose_s3_rows(mid, rowptr.long(), pos)
    with pytest.raises(ValueError, match="pos is"):
        xpose.xpose_s3_rows(mid, rowptr, pos.to(torch.int16))
    with pytest.raises(ValueError, match="must be 1-D"):
        xpose.xpose_s3_rows(mid, rowptr, pos.view(5, 1))
    with pytest.raises(ValueError, match="must be 1-D"):
        xpose.xpose_s3_rows(mid, rowptr[:0], pos)
    with pytest.raises(ValueError, match="mid is"):
        xpose.xpose_s3_rows(mid.view(16, BC), rowptr, pos)
    with pytest.raises(ValueError, match="not contiguous"):
        xpose.xpose_s3_rows(mid, rowptr[::2], pos)
    before = dict(xpose.LAUNCHES)
    y = xpose.xpose_s3_rows(mid, rowptr, pos)
    assert y.shape == (10,) and not y.any()
    assert xpose.LAUNCHES == before              # the CPU: plain version


def test_registry_default_runs_the_row_sums():
    A = cases.make(cases.XPOSE_CASES["webbase30k"])
    prep = get_strategy("cuda-xpose").prepare(A, device="cpu")
    assert [k for k, _ in prep.kernel_calls(
        torch.zeros(A.n))][-1] == "xpose_s3_rows"


# ---- the stream probe's two entry points ---------------------------------------

@pytest.mark.parametrize("entry", ["stream_reduce", "stream_reduce_strided"])
def test_probe_entries_run_the_plain_version_on_the_cpu(entry):
    """Either entry point, given a CPU tensor, returns the plain sum and
    launches nothing; a buffer of ones of an odd number of tiles sums
    exactly."""
    fn = getattr(roofline, entry)
    before = (roofline.KERNEL_LAUNCHES, roofline.STRIDED_LAUNCHES)
    out = fn(torch.ones(1003 * roofline.TILE))
    assert (roofline.KERNEL_LAUNCHES, roofline.STRIDED_LAUNCHES) == before
    assert torch.equal(out, torch.full((8, 128), 1003.0))
    rng = np.random.default_rng(2)
    buf = torch.as_tensor(rng.integers(-8, 9, 7 * roofline.TILE),
                          dtype=torch.float32)
    want = buf.numpy().reshape(7, 8, 128).sum(0)
    np.testing.assert_array_equal(fn(buf).numpy(), want)
    np.testing.assert_array_equal(roofline.stream_reduce_plain(buf).numpy(),
                                  want)


@pytest.mark.parametrize("bad", [
    torch.ones(1000), torch.ones(2048, dtype=torch.float64),
    torch.ones(2, 1024), torch.ones(4096)[::2]])
def test_strided_probe_rejects_bad_buffers(bad):
    with pytest.raises(ValueError, match="stream_reduce_strided"):
        roofline.stream_reduce_strided(bad)

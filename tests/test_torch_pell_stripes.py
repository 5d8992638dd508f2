"""PELL's column branches (spmv_scpa_tpu_torch/ops/pell.py): the column
stripes of an x past ``x_vmem_budget``, the hot-column remap
(``hot_cols``) and the dual panel grid (``split_shift``), on the tile
layout against the JAX package's ``pallas-pell`` (run in interpret mode
on the CPU, as tests/test_kernels.py runs it), and on the row layout,
which needs none of them. Each side builds its matrix with its own
generator from the same seed. The remaps' own arrays are held against
the originals in tests/test_torch_hostcopies.py.

Tolerances:
* the striped plan's arrays (per stripe), the remapped plan's arrays,
  meta and bytes against JAX: exact;
* y (the plain versions) against the JAX y: f32 rel-L2 <= 1e-5 (the
  reference's fused kernel adds in bf16 split passes, 3.1e-6 to 3.7e-6
  from the oracle on these matrices; the port in f32);
* y against ``spmv_oracle``: ``validate_result`` and rel-L2 <= 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import pell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import pick_auto, to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-5
VS_ORACLE_REL_L2 = 1e-6


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _empty_stripe(s, C):
    """Columns in the first and third 1,024-column stripes only."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 1500, 6000)
    cols = np.where(rows % 2 == 0, rng.integers(0, 1024, rows.size),
                    rng.integers(2048, 2900, rows.size))
    return C.from_coo("empty_stripe", 1500, 2900, rows, cols,
                      rng.standard_normal(rows.size))


def _case(spec, kw):
    return (lambda s, C: cases.make(spec, s)), kw


# name -> (matrix from either package's generator, knobs of both prepares);
# bench/cases.py's COLUMN_CASES, which chip_smoke.py runs on the card,
# and three more
CASES = {
    **{name: _case(*v) for name, v in cases.COLUMN_CASES.items()},
    "empty-stripe": (_empty_stripe, {"x_vmem_budget": 8192, "chunk": 4}),
    # the reference's own hot-column test (tests/test_kernels.py:231-244):
    # every candidate column is trimmed, hot_cols comes back 0
    "hot-powerlaw500": _case(("powerlaw_csr", dict(m=500, n=500, seed=17)),
                             {"hot_cols": 128, "chunk": 4, "quantum": 8}),
    # both remaps in turn on the row-sorted packing
    "split-hot-powerlaw4000": _case(
        ("powerlaw_csr", dict(m=4000, n=4000, avg_nnz=20, seed=17)),
        {"split_shift": True, "hot_cols": 256, "chunk": 4, "quantum": 8}),
}


@functools.cache
def _run(name):
    """One case on both sides: the port's matrix, tile plan, tile and row
    Prepareds on the CPU, the JAX Prepared, x, and the three y."""
    make, kw = CASES[name]
    A, A_jax = make(synth, CSR), make(jax_synth, JaxCSR)
    np.testing.assert_array_equal(A.ja, A_jax.ja)
    np.testing.assert_array_equal(A.as_, A_jax.as_)
    plan = pell.plan_pell(A, **kw)
    tiles = pell.prepare_pell(A, device="cpu", layout="tiles", **kw)
    rows = pell.prepare_pell(A, device="cpu", **kw)
    jprep = jax_strategy("pallas-pell").prepare(A_jax, interpret=True, **kw)
    x = make_x(A.n)
    return (A, plan, tiles, rows, jprep, x, to_numpy(tiles.fn(x)),
            to_numpy(rows.fn(x)), np.asarray(jprep.fn(x), np.float64))


def _fused_arrays(plan, args):
    """A fused plan's arrays beside the reference's ``_make_fused_spmv``
    args (base, pan2, rbl, mask, vals, lcol[, strip]), which are popped."""
    base, pan2, rbl, mask, vals, lcol = (np.asarray(args.pop(0))
                                         for _ in range(6))
    if plan.panel_w > 1:
        lcol = lcol + BC * np.asarray(args.pop(0))
    np.testing.assert_array_equal(plan.base, base)
    np.testing.assert_array_equal(plan.pan2, pan2)
    np.testing.assert_array_equal(plan.rbl.reshape(rbl.shape), rbl)
    np.testing.assert_array_equal(plan.vals, vals)
    np.testing.assert_array_equal(plan.idx, lcol)
    assert mask.shape[0] == plan.span


STRIPED = ["stripes3", "empty-stripe", "boundary"]
REMAPPED = ["hot-powerlaw500", "hot-powerlaw2000", "split-runs",
            "split-hot-powerlaw4000"]


@pytest.mark.parametrize("name", STRIPED)
def test_stripe_arrays_meta_and_bytes_match_jax(name):
    A, plan, tiles, _, jprep, *_ = _run(name)
    assert isinstance(plan, pell.StripedPlan)
    args = list(jprep.args)
    for part, c0, c1, row0, keep in plan.parts:
        assert part.kind == "fused" and part.panel_w == 1
        assert c1 - c0 == part.n and row0 % 8 == 0
        _fused_arrays(part, args)
    assert not args
    assert tiles.meta == jprep.meta
    assert tiles.hbm_bytes == jprep.hbm_bytes
    assert tiles.meta["stripes"] == len(plan.parts) >= 2


def test_stripe_width_and_the_empty_stripe():
    _, plan, *_ = _run("stripes3")
    assert pell.stripe_width(8192) == 1024
    assert [(c0, c1) for _, c0, c1, *_ in plan.parts] == [
        (0, 1024), (1024, 2048), (2048, 3000)]
    _, plan, *_ = _run("empty-stripe")
    assert [(c0, c1) for _, c0, c1, *_ in plan.parts] == [
        (0, 1024), (2048, 2900)]
    assert pell.x_past_budget(2100, 10_000)
    assert not pell.x_past_budget(2048, 8192)


@pytest.mark.parametrize("name", STRIPED + REMAPPED)
@pytest.mark.parametrize("layout", ["tiles", "rows"])
def test_y_matches_jax_and_oracle(name, layout):
    A, plan, tiles, rows, jprep, x, y_tiles, y_rows, y_jax = _run(name)
    y = y_tiles if layout == "tiles" else y_rows
    gold = spmv_oracle(A, x)
    assert y.shape == (A.m,)
    assert _rel(y, y_jax) <= VS_JAX_REL_L2
    assert _rel(y, gold) <= VS_ORACLE_REL_L2
    validate_result(gold, y, what=f"cuda-pell ({layout}) on {name}")
    validate_result(gold, y_jax, what=f"pallas-pell on {name}")


@pytest.mark.parametrize("name", STRIPED)
def test_each_stripe_is_one_fused_call_on_a_view_of_x(name):
    A, plan, tiles, rows, *_, x = _run(name)[:6]
    xf = torch.as_tensor(x, dtype=torch.float32)
    calls = tiles.kernel_calls(xf)
    assert [k for k, _ in calls] == ["pell_fused"] * len(plan.parts)
    for (_, args), (_, c0, c1, *_) in zip(calls, plan.parts):
        xs = args[3]
        assert xs.numel() == c1 - c0 and xs.is_contiguous()
        assert torch.equal(xs, xf[c0:c1])
    # the row layout reads x in place: one call, no stripe
    assert [k for k, _ in rows.kernel_calls(xf)] == ["pell_rows"]
    assert rows.meta["stripes"] == 0


@pytest.mark.parametrize("name", REMAPPED)
def test_remapped_plan_arrays_meta_and_bytes_match_jax(name):
    A, plan, tiles, _, jprep, *_ = _run(name)
    args = list(jprep.args)
    if plan.bsrc is not None:
        np.testing.assert_array_equal(plan.bsrc, np.asarray(args.pop(0)))
    for _, hot in plan.extend:
        if hot is not None:
            np.testing.assert_array_equal(hot, np.asarray(args.pop(0)))
    _fused_arrays(plan, args)
    assert not args
    assert tiles.meta == jprep.meta
    assert tiles.hbm_bytes == jprep.hbm_bytes
    # what each case exercises: the trim, the hot panels, the shifted
    # grid, both in turn
    want = {"hot-powerlaw500": (0, False), "hot-powerlaw2000": (256, False),
            "split-runs": (0, True), "split-hot-powerlaw4000": (256, True)}
    assert (tiles.meta["hot_cols"], tiles.meta["split_shift"]) == want[name]
    assert plan.n == A.n if want[name] == (0, False) else plan.n > A.n


def test_hot_columns_keep_the_fill():
    """The reference's check (tests/test_kernels.py:241-243): the remap
    loses at most 10% of the fill of the same packing without it."""
    for name in ("hot-powerlaw500", "hot-powerlaw2000"):
        A, _, tiles, *_ = _run(name)
        kw = {k: v for k, v in CASES[name][1].items() if k != "hot_cols"}
        base = pell.prepare_pell(A, device="cpu", layout="tiles", **kw)
        assert tiles.meta["fill"] >= base.meta["fill"] * 0.9


@pytest.mark.parametrize("name", REMAPPED)
def test_the_row_layout_records_the_remaps_and_leaves_y(name):
    """Row quanta have no (row block, panel) buckets to pack: the knobs
    are recorded, nothing is applied, y is bit for bit the row layout's
    without them."""
    A, _, _, rows, *_, x = _run(name)[:6]
    kw = CASES[name][1]
    asked = {k: kw[k] for k in ("hot_cols", "split_shift") if k in kw}
    assert rows.meta["tile_knobs"] == {"chunk": kw["chunk"], **asked}
    assert (rows.meta["hot_cols"], rows.meta["split_shift"]) == (0, False)
    plain = pell.prepare_pell(A, device="cpu", **{
        k: v for k, v in kw.items() if k not in asked})
    assert np.array_equal(to_numpy(rows.fn(x)), to_numpy(plain.fn(x)))


def test_spmv_auto_serves_an_x_past_the_budget_on_both_layouts():
    """A matrix whose x is past the hybrid's resident bound and whose
    20,000-entry row is outside XPOSE's envelope goes to ``cuda-pell``;
    at a lowered ``x_vmem_budget`` (the CPU's stand-in for n above 3.15M)
    it is served on the rows (one call, x in place) and on the tiles (one
    fused call a stripe)."""
    B = synth.banded_csr(1000, 3_000_000, row_nnz=4, bandwidth=8, seed=3)
    rng = np.random.default_rng(3)
    A = CSR.from_coo("wide_hub", B.m, B.n,
                     np.concatenate([B.row_ids(), np.zeros(20_000, int)]),
                     np.concatenate([B.ja, rng.choice(B.n, 20_000,
                                                      replace=False)]),
                     np.concatenate([B.as_, rng.standard_normal(20_000)]))
    assert pick_auto(A) == "cuda-pell"
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    for kw in ({}, {"layout": "tiles"}):
        y = spmv(A, x, device="cpu", x_vmem_budget=1 << 20, **kw)
        assert _rel(y, gold) <= VS_ORACLE_REL_L2
        validate_result(gold, y, what=f"spmv auto {kw}")
    prep = pell.prepare_pell(A, device="cpu", layout="tiles",
                             x_vmem_budget=1 << 20)
    assert prep.meta["stripes"] == len(prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))) > 1

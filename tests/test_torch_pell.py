"""The port's PELL family (spmv_scpa_tpu_torch/ops/pell.py, the span
segment-sum of ops/segsum_kernel.py) against the JAX package's
``pallas-pell`` and ``pallas-bcsr``, run in interpret mode on the CPU
as tests/test_kernels.py runs them. Each side builds its matrix with its
own generator from the same seed. The CUDA kernels themselves are held
against their plain versions in tests/test_torch_cuda.py.

``cuda-pell`` and ``cuda-bcsr`` run here on ``layout="tiles"``, the
layout whose arrays are the reference's; their default layouts are held
against the same JAX strategies in tests/test_torch_pell_rows.py (row
quanta) and tests/test_torch_bcsr_bits.py (bitmap tiles).

Tolerances:
* host parts (tuning axes, the row sort, packed arrays, the fused and
  tile paths' tables, meta and bytes) against JAX: exact;
* the port's y (plain versions) against the JAX y: rel-L2 <= 1e-4. The
  TPU kernels reduce in bf16 split passes (two by default in the MACs,
  two in the epilogue, two in the un-permute: about 1e-5 relative),
  while the port keeps every product and sum in f32;
* the port's y against ``spmv_oracle`` (fp64): rel-L2 <= 1e-6, and
  ``validate_result``.

The fused scheme's cases run here, the tile kernel's (span, pure, BCSR)
in tests/test_torch_pell_tiles.py, with the kernel-level comparisons.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import pallas_kernels as jpk
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import get_strategy, spmv
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import pell, segsum_kernel
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-4
VS_ORACLE_REL_L2 = 1e-6


def _jax_empty_windows():
    rows = np.concatenate([np.arange(1100, 1200), np.arange(5900, 5950)])
    return JaxCSR.from_coo("empty_windows", 6000, 512, rows,
                           (rows * 7) % 512,
                           np.linspace(1.0, 2.0, rows.shape[0]))


def _jax_powerlaw1500():
    return jax_synth.powerlaw_csr(1500, avg_nnz=20, seed=0)


def _jax_banded200():
    return jax_synth.banded_csr(200, row_nnz=11, bandwidth=48, seed=5)


# each PELL case's matrix built by the JAX package's generator
JAX_CASES = {
    "pell-pl3000": lambda: jax_synth.powerlaw_csr(3000, 2000, seed=31),
    "pell-pl4000": lambda: jax_synth.powerlaw_csr(4000, 4000, seed=5),
    "pell-span1500": _jax_powerlaw1500,
    "pell-pure1500": _jax_powerlaw1500,
    "pell-banded2000": lambda: jax_synth.banded_csr(2000, row_nnz=11,
                                                    bandwidth=48, seed=5),
    "pell-empty-windows": _jax_empty_windows,
    "pell-empty-fused": _jax_empty_windows,
    "bcsr-banded200": _jax_banded200,
}
# the BCSR chunk sweep of tests/test_kernels.py:31-42
BCSR_CHUNKS = {f"bcsr-chunk{c}": c for c in (1, 4, 16)}
REF = {"cuda-pell": "pallas-pell", "cuda-bcsr": "pallas-bcsr"}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_jax_cases_cover_the_pell_cases():
    assert set(JAX_CASES) == set(cases.PELL_CASES)


def _case_spec(name):
    if name in BCSR_CHUNKS:
        make, _, _ = cases.PELL_CASES["bcsr-banded200"]
        return make, "cuda-bcsr", {"chunk": BCSR_CHUNKS[name]}, \
            _jax_banded200
    make, strategy, kw = cases.PELL_CASES[name]
    return make, strategy, kw, JAX_CASES[name]


@functools.cache
def _run(name):
    """One case on both sides, built once for the module: the port's
    matrix, plan and CPU Prepared, the JAX Prepared, x and both y."""
    make, strategy, kw, jmake = _case_spec(name)
    A = make()
    A_jax = jmake()
    np.testing.assert_array_equal(A.ja, A_jax.ja)
    np.testing.assert_array_equal(A.as_, A_jax.as_)
    planner = pell.plan_pell if strategy == "cuda-pell" else pell.plan_bcsr
    plan = planner(A, **kw)
    # the reference's arrays: both strategies on the tile layout
    prep = get_strategy(strategy).prepare(A, device="cpu", layout="tiles",
                                          **kw)
    jprep = jax_strategy(REF[strategy]).prepare(A_jax, interpret=True, **kw)
    x = make_x(A.n)
    return (A, plan, prep, jprep, x, to_numpy(prep.fn(x)),
            np.asarray(jprep.fn(x), dtype=np.float64))


# the fused scheme's cases here; the tile kernel's (span, pure, BCSR) in
# tests/test_torch_pell_tiles.py
FUSED_CASES = ["pell-banded2000", "pell-empty-fused", "pell-pl3000",
               "pell-pl4000"]
TILE_CASES = ["bcsr-banded200", "pell-empty-windows", "pell-pure1500",
              "pell-span1500", *sorted(BCSR_CHUNKS)]


def test_the_two_files_cover_every_case():
    assert sorted(FUSED_CASES + TILE_CASES) == \
        sorted([*cases.PELL_CASES, *BCSR_CHUNKS])


@pytest.fixture(scope="module", params=FUSED_CASES)
def case(request):
    return (request.param, *_run(request.param))


def _jax_tables(plan, jprep):
    """The JAX Prepared's args by role (pallas_kernels.py:1729-1802):
    the un-permute's bsrc first when row-sorted, then ``_make_fused_spmv``'s
    (base, pan, rbl, mask, vals, lcol[, strip]) or ``_make_tile_spmv``'s
    (pan, rbl, vals[, lcol], then base and mask for the span segment-sum
    or the window per step)."""
    args = [np.asarray(a) for a in jprep.args]
    out = {}
    if plan.bsrc is not None:
        out["bsrc"] = args.pop(0)
    if plan.kind == "fused":
        for k in ("base", "pan2", "rbl", "mask", "vals"):
            out[k] = args.pop(0)
    else:
        for k in ("pan2", "rbl", "vals"):
            out[k] = args.pop(0)
    if plan.idx is not None:
        out["lcol"] = args.pop(0)
        if plan.kind == "fused" and plan.panel_w > 1:
            out["lcol"] = out["lcol"] + BC * args.pop(0)
    if plan.kind == "tiles":
        out["base"] = args.pop(0)
        if plan.seg == "span":
            out["mask"] = args.pop(0)
    assert not args
    return out


def check_plan_arrays(case):
    name, A, plan, prep, jprep, *_ = case
    want = _jax_tables(plan, jprep)
    np.testing.assert_array_equal(plan.vals, want["vals"])
    np.testing.assert_array_equal(plan.pan2, want["pan2"])
    np.testing.assert_array_equal(plan.base, want["base"])
    np.testing.assert_array_equal(
        plan.rbl.reshape(want["rbl"].shape), want["rbl"])
    if plan.idx is None:
        assert "lcol" not in want
    else:
        np.testing.assert_array_equal(plan.idx, want["lcol"])
        assert plan.idx.dtype == (np.int8 if plan.panel_w == 1
                                  else np.int16)
    if plan.bsrc is None:
        assert "bsrc" not in want
    else:
        np.testing.assert_array_equal(plan.bsrc, want["bsrc"])
    if "mask" in want:                  # the span W of the TPU's outputs
        assert want["mask"].shape[0] == plan.span


def check_meta_and_bytes(case):
    name, A, plan, prep, jprep, *_ = case
    assert prep.meta == jprep.meta
    assert prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == jprep.strategy


def check_plain_y(case):
    name, A, plan, prep, jprep, x, y, y_jax = case
    gold = spmv_oracle(A, x)
    assert y.shape == (A.m,)
    assert _rel_l2(y, y_jax) <= VS_JAX_REL_L2
    assert _rel_l2(y, gold) <= VS_ORACLE_REL_L2
    validate_result(gold, y, what=f"port {prep.strategy} (plain) on {name}")
    validate_result(gold, y_jax, what=f"{jprep.strategy} on {name}")
    if name.startswith("pell-empty"):   # empty windows come back 0
        assert np.all(y[:1100] == 0.0) and np.all(y[1200:5900] == 0.0)
        assert np.all(y[5950:] == 0.0)


def test_plan_arrays_match_jax(case):
    check_plan_arrays(case)
    assert case[2].kind == "fused"


def test_meta_and_bytes_match_jax(case):
    check_meta_and_bytes(case)


def test_plain_y_matches_jax_and_oracle(case):
    check_plain_y(case)


# ---- host parts ----------------------------------------------------------

PARAM_MATRICES = {
    "powerlaw": lambda s: s.powerlaw_csr(3000, 2000, seed=31),
    "banded": lambda s: s.banded_csr(1500, row_nnz=5, bandwidth=40, seed=4),
    "webbase": lambda s: s.webbase_csr(20000, seed=5),
    "amazon": lambda s: s.amazon_csr(m=3000, seed=6),
}


@pytest.mark.parametrize("name", sorted(PARAM_MATRICES))
def test_auto_params_and_row_sort_match_jax(name):
    from spmv_scpa_tpu_torch import testing as synth
    A = PARAM_MATRICES[name](synth)
    A_jax = PARAM_MATRICES[name](jax_synth)
    for kw in ({}, {"quantum": 32, "chunk": 64}, {"g_max": 512},
               {"panel_w": 2, "row_sort": False, "window_h": 64}):
        assert pell.auto_pell_params(A, **kw) == \
            jpk.auto_pell_params(A_jax, **kw), kw
    sigma, bsrc = pell._rank_sort_sigma(A)
    j_sigma, j_bsrc = jpk._rank_sort_sigma(A_jax)
    np.testing.assert_array_equal(sigma, j_sigma)
    np.testing.assert_array_equal(bsrc, j_bsrc)
    assert pell.SORT_WIN == jpk.SORT_WIN
    assert pell.DEFAULT_CHUNK == jpk.DEFAULT_CHUNK
    assert pell.X_VMEM_BUDGET == jpk.X_VMEM_BUDGET


def test_window_pad_and_span_match_jax():
    rng = np.random.default_rng(3)
    rowblk = np.sort(rng.integers(0, 700, 900)).astype(np.int32)
    vals = rng.standard_normal((900, 2, 3))
    panel = rng.integers(0, 9, 900).astype(np.int32)
    for chunk, min_chunk in ((64, 16), (16, None), (8, 1)):
        got = pell._window_pad_tiles(vals, panel, rowblk, 128, chunk,
                                     min_chunk=min_chunk, num_win=6)
        want = jpk._window_pad_tiles(vals, panel, rowblk, 128, chunk,
                                     min_chunk=min_chunk, num_win=6)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    window = np.repeat(np.arange(7), rng.integers(1, 40, 7))
    for group in (1, 8, 33, 256):
        assert pell._span_of(window, group) == jpk._span_of(window, group)


def test_segment_lists_index_each_cell_in_order():
    rel = np.array([[2, -1, 0, 2, 5], [1, 1, 0, 3, 2]])
    order, ptr = segsum_kernel.segment_lists(rel, 4)
    assert order.dtype == np.int32 and ptr.dtype == np.int32
    cells = [order[ptr[c]:ptr[c + 1]].tolist() for c in range(8)]
    assert cells == [[2], [], [0, 3], [], [7], [5, 6], [9], [8]]


def test_tile_partials_sum_each_quantum_pairwise():
    """Partials of a tile whose slots are powers of two: the sums are
    exact, so every quantum size gives the same totals per row."""
    rng = np.random.default_rng(6)
    T, n = 3, 300
    vals = torch.as_tensor(2.0 ** rng.integers(-4, 4, (T * 8, BC)),
                           dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, BC, (T * 8, BC)), dtype=torch.int8)
    pan = torch.tensor([0, 2, 1], dtype=torch.int32)
    x = torch.ones(n)
    for q in (1, 2, 4, 8, 32, 128):
        part = pell.pell_tiles(vals, idx, pan, x, q)
        assert part.shape == (T * 8, BC // q)
        col = pan.long().repeat_interleave(8)[:, None] * BC + idx.long()
        want = (vals * (col < n)).view(T * 8, BC // q, q).sum(-1)
        assert torch.equal(part, want)


def test_wrappers_run_plain_versions_for_cpu_tensors():
    A, plan, prep, *_ = _run("pell-pl3000")
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    before = dict(pell.LAUNCHES), segsum_kernel.SPAN_LAUNCHES
    calls = prep.kernel_calls(xf)
    assert [k for k, _ in calls] == ["pell_fused", "unpermute"]
    for kname, args in calls:
        out = getattr(pell.KERNELS, kname)(*args)
        assert torch.equal(out, getattr(pell.PLAIN, kname)(*args))
    assert (dict(pell.LAUNCHES), segsum_kernel.SPAN_LAUNCHES) == before


def test_wrappers_reject_wrong_arguments():
    A, plan, prep, *_ = _run("pell-pl3000")
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    (_, fused), (_, unperm) = prep.kernel_calls(xf)
    vals, idx, pan, x, rbl, base, cfg, lists = fused
    with pytest.raises(ValueError, match="vals"):
        pell.pell_fused(vals.double(), idx, pan, x, rbl, base, cfg, lists)
    with pytest.raises(ValueError, match="idx"):
        pell.pell_fused(vals, idx.to(torch.int8), pan, x, rbl, base, cfg,
                        lists)
    with pytest.raises(ValueError, match="rbl"):
        pell.pell_fused(vals, idx, pan, x, rbl[:-1], base, cfg, lists)
    with pytest.raises(ValueError, match="ptr"):
        pell.pell_fused(vals, idx, pan, x, rbl, base, cfg,
                        (lists[0], lists[1][:-1]))
    with pytest.raises(ValueError, match="quantum"):
        pell.pell_tiles(vals, idx, pan, x, 3, cfg.panel_w)
    with pytest.raises(ValueError, match="bsrc"):
        pell.unpermute(unperm[0], unperm[1][:-1])
    with pytest.raises(ValueError, match="x has shape"):
        prep.fn(np.ones(A.n + 1))


@pytest.mark.parametrize("kw, what", [
    ({"hot_cols": 128}, "hot_cols"), ({"split_shift": True}, "split_shift"),
    ({"x_vmem_budget": 1024}, "column stripes")])
def test_unported_options_raise_not_implemented(kw, what):
    """The three options that raised ``NotImplementedError`` before the
    port had them (``what``), now held against ``pallas-pell`` with the
    same option on the same matrix: on the tiles the meta and bytes
    exactly (128 hot columns trim to none on this band, the shifted grid
    applies, 1,024 B of x make 16 stripes of 128 columns) and y within
    f32 rel-L2 1e-5; the row layout's y the same way. Both sides at
    chunk 4, which keeps the reference's interpret-mode steps short."""
    kw = {**kw, "chunk": 4}
    A = cases.PELL_CASES["pell-banded2000"][0]()
    jprep = jax_strategy("pallas-pell").prepare(
        JAX_CASES["pell-banded2000"](), interpret=True, **kw)
    tiles = pell.prepare_pell(A, device="cpu", layout="tiles", **kw)
    assert tiles.meta == jprep.meta and tiles.hbm_bytes == jprep.hbm_bytes
    x = make_x(A.n)
    y_jax = np.asarray(jprep.fn(x), np.float64)
    for prep in (tiles, pell.prepare_pell(A, device="cpu", **kw)):
        y = to_numpy(prep.fn(x))
        assert _rel_l2(y, y_jax) <= 1e-5
        validate_result(spmv_oracle(A, x), y, what=f"cuda-pell, {what}")
    assert tiles.meta.get("stripes", 0) == (16 if "x_vmem_budget" in kw
                                            else 0)


def test_tpu_knobs_are_recorded_and_change_nothing():
    A = cases.PELL_CASES["pell-banded2000"][0]()
    x = make_x(A.n)
    base = pell.prepare_pell(A, device="cpu")
    knobs = {"precision_passes": 3, "epilogue_passes": 1, "wide": True,
             "diag": "nomac", "dedup_max": 8, "epilogue_ncat": True}
    prep = pell.prepare_pell(A, device="cpu", **knobs)
    assert prep.meta.pop("tpu_knobs") == knobs
    assert prep.meta == base.meta
    assert torch.equal(prep.fn(x), base.fn(x))


def test_bcsr_refuses_scattered_matrices():
    A = CSR.from_coo("s", 4096, 1 << 20, np.arange(4096),
                     np.arange(4096) * 256, np.ones(4096))
    with pytest.raises(ValueError, match="too scattered"):
        spmv(A, make_x(A.n), "cuda-bcsr", device="cpu",
             max_padded_bytes=1 << 20)

"""The bitmap BCSR layout (spmv_scpa_tpu_torch/ops/bcsr_bits.py), the
default of ``cuda-bcsr`` and ``cuda-bcsr-spmm``, against the JAX
package's ``pallas-bcsr`` and ``pallas-bcsr-spmm`` (interpret mode on the
CPU) and the oracle, with the kernels' plain versions. The kernels
themselves are held against those in tests/test_torch_cuda.py.

Tolerances:
* the plan decoded back to dense tiles against ``csr_to_bcsr``'s f32
  tiles: exact (and pan and rowptr equal);
* ``cuda-bcsr`` y against the JAX y: rel-L2 <= 1e-4 (the TPU kernel's
  bf16 split passes; tests/test_torch_pell.py's ``VS_JAX_REL_L2``), and
  against ``spmv_oracle``: rel-L2 <= 1e-6;
* ``cuda-bcsr-spmm`` Y against the JAX Y: rel-L2 <= 1e-5
  (``VS_JAX_SPMM``), and ``validate_result`` against ``spmm_oracle``;
* each plain version against a numpy loop in the kernel's order: exact.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.bcsr import csr_to_bcsr
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import bcsr_bits, pell, spmm
from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle, spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-4
VS_ORACLE_REL_L2 = 1e-6
VS_JAX_SPMM = 1e-5
ZOO_SIZE = 7        # tests/conftest.py: matrices()

# the bitmap layout's small cases, the PELL family's BCSR case and its
# matrix with empty windows of row blocks
CASES = {**{name: make for name, make in cases.BITS_CASES.items()},
         **{name: cases.PELL_CASES[name][0]
            for name in ("bcsr-banded200", "pell-empty-windows")}}


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def _jax(A):
    return JaxCSR(A.name, A.m, A.n, A.irp, A.ja, A.as_)


def _port(Aj):
    return CSR(Aj.name, Aj.m, Aj.n, Aj.irp, Aj.ja, Aj.as_)


def _args(A):
    plan = bcsr_bits.plan_bcsr_bits(A)
    return plan, tuple(torch.as_tensor(a) for a in (
        plan.bits, plan.vals, plan.vptr, plan.pan, plan.rowptr))


def check_decodes_to_bcsr(A):
    plan, (bits, vals, vptr, _, _) = _args(A)
    B = csr_to_bcsr(A)
    mask, tiles = bcsr_bits.decode(bits, vals, vptr)
    np.testing.assert_array_equal(tiles.numpy(), B.vals.astype(np.float32))
    np.testing.assert_array_equal(plan.pan, B.col_panel)
    np.testing.assert_array_equal(plan.rowptr, B.rowptr)
    # the mask is structural: one slot per distinct coordinate of A
    coords = np.unique(A.row_ids().astype(np.int64) * A.n + A.ja)
    assert int(mask.sum()) == coords.size == plan.vals.size
    np.testing.assert_array_equal(plan.vptr[1:] - plan.vptr[:-1],
                                  mask.view(B.num_tiles, -1).sum(1).numpy())
    assert plan.hbm_bytes == sum(a.nbytes for a in (
        plan.bits, plan.vals, plan.vptr, plan.pan, plan.rowptr))
    assert plan.meta == {"layout": "bits", "num_blocks": B.num_tiles,
                         "stored": coords.size,
                         "block_rows": B.num_block_rows, "fill": B.fill}


# ---- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_decodes_to_csr_to_bcsr_tiles(name):
    check_decodes_to_bcsr(CASES[name]())


@pytest.mark.parametrize("index", range(ZOO_SIZE))
def test_plan_decodes_on_zoo(matrices, index):
    check_decodes_to_bcsr(_port(matrices[index]))


@pytest.mark.parametrize("name", sorted(cases.PELL_CASES))
def test_plan_decodes_on_the_pell_cases(name):
    check_decodes_to_bcsr(cases.PELL_CASES[name][0]())


def test_plan_keeps_explicit_zeros_and_sums_duplicates():
    """An explicit zero keeps its bit; duplicates are one slot holding
    their float64 sum rounded once (a pair summing to 0.0 keeps its bit
    with value 0.0)."""
    A = cases.dup_zeros()
    plan, (bits, vals, vptr, _, _) = _args(A)
    mask, tiles = bcsr_bits.decode(bits, vals, vptr)
    rows = A.row_ids().astype(np.int64)
    key = rows * A.n + A.ja
    keys, counts = np.unique(key, return_counts=True)
    once = np.isin(key, keys[counts == 1])
    zero = np.flatnonzero((A.as_ == 0.0) & once)
    assert zero.size
    r, c = rows[zero], A.ja[zero]
    t = np.array([plan.rowptr[b] + np.flatnonzero(
        plan.pan[plan.rowptr[b]:plan.rowptr[b + 1]] == cc // BC)[0]
                  for b, cc in zip(r // 8, c)])
    assert bool(mask[t, r % 8, c % BC].all())
    assert bool((tiles[t, r % 8, c % BC] == 0.0).all())
    b = 500 // 8
    t500 = plan.rowptr[b] + np.flatnonzero(
        plan.pan[plan.rowptr[b]:plan.rowptr[b + 1]] == 700 // BC)[0]
    assert bool(mask[t500, 500 % 8, 700 % BC])
    assert float(tiles[t500, 500 % 8, 700 % BC]) == 0.0
    assert plan.vals.size < A.nnz


def test_plan_of_an_empty_matrix():
    A = CSR.from_coo("empty", 21, 300, [], [], [])
    plan, args = _args(A)
    assert plan.num_tiles == 0 and plan.vals.size == 0
    assert plan.rowptr.tolist() == [0, 0, 0, 0]
    y = bcsr_bits.bcsr_bits(*args, torch.ones(300), A.m)
    Y = bcsr_bits.bcsr_bits_spmm(*args, torch.ones(300, 3), A.m)
    assert torch.equal(y, torch.zeros(21))
    assert torch.equal(Y, torch.zeros(21, 3))


def test_bcsr_refuses_scattered_matrices_on_both_layouts():
    A = CSR.from_coo("s", 4096, 1 << 20, np.arange(4096),
                     np.arange(4096) * 256, np.ones(4096))
    for layout in ("auto", "tiles"):
        with pytest.raises(ValueError, match="too scattered"):
            pell.prepare_bcsr(A, device="cpu", layout=layout,
                              max_padded_bytes=1 << 20)
    with pytest.raises(ValueError, match="unknown layout"):
        pell.prepare_bcsr(A, device="cpu", layout="bits")


def test_spmm_x_budget_refuses_before_packing(monkeypatch):
    """The flagship's n at 64 columns on the bitmap layout: refused
    before any tile is built, as on the dense tiles."""
    n = 377_000
    A = CSR.from_coo("flag_n", n, n, np.arange(4), np.arange(4), np.ones(4))
    monkeypatch.setattr(bcsr_bits, "plan_bcsr_bits", None)    # never reached
    with pytest.raises(ValueError, match="exceeds VMEM budget"):
        spmm.prepare_bcsr_spmm(A, cols=64, device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        spmm.prepare_bcsr_spmm(A, cols=1, device="cpu", layout="bits")


def test_tile_knobs_are_recorded():
    A = CASES["bcsr-banded200"]()
    prep = pell.prepare_bcsr(A, device="cpu", chunk=4, window_h=16)
    assert prep.meta["layout"] == "bits"
    assert prep.meta["tile_knobs"] == {"chunk": 4, "window_h": 16}
    prep = spmm.prepare_bcsr_spmm(A, cols=8, chunk=4, device="cpu")
    assert prep.meta["tile_knobs"] == {"chunk": 4}
    assert prep.meta["cols"] == 8
    assert "tile_knobs" not in pell.prepare_bcsr(A, device="cpu").meta


# ---- the strategies against the JAX package and the oracle ------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_bcsr_matches_jax_and_oracle(name):
    A = CASES[name]()
    x = make_x(A.n)
    prep = get_strategy("cuda-bcsr").prepare(A, device="cpu")
    assert prep.meta["layout"] == "bits" and prep.ref == "pallas-bcsr"
    assert [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))] == ["bcsr_bits"]
    y = to_numpy(prep.fn(x))
    y_jax = np.asarray(jax_strategy("pallas-bcsr").prepare(
        _jax(A), interpret=True).fn(x), np.float64)
    gold = spmv_oracle(A, x)
    assert y.shape == (A.m,)
    assert _rel(y, y_jax) <= VS_JAX_REL_L2
    assert _rel(y, gold) <= VS_ORACLE_REL_L2
    validate_result(gold, y, what=f"cuda-bcsr (bits) on {name}")


@pytest.mark.parametrize("index", range(ZOO_SIZE))
def test_cuda_bcsr_matches_oracle_on_zoo(matrices, index):
    A = _port(matrices[index])
    x = make_x(A.n)
    y = to_numpy(get_strategy("cuda-bcsr").prepare(A, device="cpu").fn(x))
    assert _rel(y, spmv_oracle(A, x)) <= VS_ORACLE_REL_L2


@pytest.mark.parametrize("cols", [1, 8, 64])
@pytest.mark.parametrize("name", ["bits-banded200x300", "bits-dup-zeros"])
def test_cuda_bcsr_spmm_matches_jax_and_oracle(name, cols):
    A = CASES[name]()
    X = make_x(A.n, cols=cols)
    prep = spmm.prepare_bcsr_spmm(A, cols=cols, device="cpu")
    assert prep.meta["layout"] == "bits" and prep.meta["cols"] == cols
    Y = to_numpy(prep.fn(X))
    Y_jax = np.asarray(jax_strategy("pallas-bcsr-spmm").prepare(
        _jax(A), cols=cols, interpret=True).fn(X), np.float64)
    assert Y.shape == (A.m, cols)
    assert _rel(Y, Y_jax) <= VS_JAX_SPMM
    validate_result(spmm_oracle(A, X), Y, what=f"cuda-bcsr-spmm on {name}")


@pytest.mark.parametrize("index", range(ZOO_SIZE))
@pytest.mark.parametrize("cols", [1, 3, 64])
def test_cuda_bcsr_spmm_matches_oracle_on_zoo(matrices, index, cols):
    A = _port(matrices[index])
    X = make_x(A.n, cols=cols)
    Y = get_strategy("cuda-bcsr-spmm").prepare(A, cols=cols,
                                               device="cpu").fn(X)
    validate_result(spmm_oracle(A, X), to_numpy(Y),
                    what=f"cuda-bcsr-spmm cols {cols} on {A.name}")


# ---- the tile layout is unchanged -------------------------------------------

def test_tiles_layout_runs_the_dense_tiles():
    """``layout="tiles"`` binds ``plan_bcsr``'s arrays and runs the tile
    kernel and the window segment-sum (SpMV), or ``bcsr_spmm`` (SpMM),
    with the reference's meta and bytes."""
    A = CASES["bcsr-banded200"]()
    x = make_x(A.n)
    xd = torch.as_tensor(x, dtype=torch.float32)
    prep = pell.prepare_bcsr(A, device="cpu", layout="tiles", chunk=4)
    assert [k for k, _ in prep.kernel_calls(xd)] == ["pell_tiles",
                                                     "window_segsum"]
    want = pell._prepared("cuda-bcsr", "pallas-bcsr", A,
                          pell.plan_bcsr(A, chunk=4), torch.device("cpu"))
    assert torch.equal(prep.fn(x), want.fn(x))
    assert prep.meta == want.meta and prep.hbm_bytes == want.hbm_bytes
    X = make_x(A.n, cols=8)
    sp = spmm.prepare_bcsr_spmm(A, cols=8, device="cpu", layout="tiles")
    (name, args), = sp.kernel_calls(torch.as_tensor(X, dtype=torch.float32))
    assert name == "bcsr_spmm"
    assert torch.equal(sp.fn(X), spmm.bcsr_spmm_plain(*args))


def test_absent_slots_add_nothing():
    """x holding inf at a column that no stored slot names: the dense
    tiles multiply it by their zeros (NaN in y), the bitmap tiles never
    read it."""
    A = cases.dup_zeros()
    x = make_x(A.n)
    free = np.setdiff1d(np.arange(128, 1500), A.ja)
    used_panels = set((A.ja // BC).tolist())
    free = [c for c in free if c // BC in used_panels][0]
    x[free] = np.inf
    y = to_numpy(pell.prepare_bcsr(A, device="cpu").fn(x))
    assert np.isfinite(y).all()
    y_tiles = to_numpy(pell.prepare_bcsr(A, device="cpu",
                                         layout="tiles").fn(x))
    assert not np.isfinite(y_tiles).all()


# ---- the plain versions' order of the sums ----------------------------------

def _hand_case():
    """Two block rows, three tiles; values spanning 12 decades so that
    another order of the sums rounds differently."""
    rng = np.random.default_rng(3)
    rows, cols = np.nonzero(rng.random((13, 390)) < 0.3)
    vals = rng.standard_normal(rows.size) * 10.0 ** rng.integers(
        -6, 7, rows.size)
    return CSR.from_coo("hand", 13, 390, rows, cols, vals)


def test_bcsr_bits_plain_adds_in_the_kernels_order():
    """Lane l of block row b: a sum per row over the tiles in order, then
    the words in order, of the stored slot at lane 32q + l; then the
    halving tree over the 32 lanes (a numpy loop, f32 throughout)."""
    A = _hand_case()
    plan, args = _args(A)
    x = (np.random.default_rng(4).standard_normal(A.n)
         * 10.0 ** np.random.default_rng(5).integers(-6, 7, A.n)) \
        .astype(np.float32)
    y = bcsr_bits.bcsr_bits(*args, torch.as_tensor(x), A.m).numpy()
    mask, tiles = (t.numpy() for t in bcsr_bits.decode(*args[:3]))
    f32 = np.float32
    want = np.zeros(A.m, np.float32)
    for b in range(plan.rowptr.size - 1):
        lanes = np.zeros((8, 32), np.float32)
        for t in range(plan.rowptr[b], plan.rowptr[b + 1]):
            for q in range(4):
                for l in range(32):
                    k = 32 * q + l
                    col = plan.pan[t] * BC + k
                    for r in range(8):
                        if mask[t, r, k]:
                            lanes[r, l] = f32(lanes[r, l] + f32(
                                tiles[t, r, k] * x[col]))
        w = 32
        while w > 1:
            w //= 2
            lanes = lanes[:, :w] + lanes[:, w:2 * w]
        for r in range(8):
            if 8 * b + r < A.m:
                want[8 * b + r] = lanes[r, 0]
    np.testing.assert_array_equal(y, want)
    csr_order = np.array([np.float32(0)] * A.m)
    for i in range(A.m):
        s = f32(0)
        for j in range(A.irp[i], A.irp[i + 1]):
            s = f32(s + f32(f32(A.as_[j]) * x[A.ja[j]]))
        csr_order[i] = s
    assert not np.array_equal(y, csr_order)


def test_bcsr_bits_spmm_plain_adds_in_the_kernels_order():
    """Y[i, c]: the row's stored slots in column order, one after
    another (a numpy loop, f32 throughout); the reverse order differs."""
    A = _hand_case()
    plan, args = _args(A)
    rng = np.random.default_rng(6)
    X = (rng.standard_normal((A.n, 3))
         * 10.0 ** rng.integers(-6, 7, (A.n, 1))).astype(np.float32)
    Y = bcsr_bits.bcsr_bits_spmm(*args, torch.as_tensor(X), A.m).numpy()
    f32 = np.float32
    v32 = A.as_.astype(np.float32)
    for i in range(A.m):
        for c in range(3):
            s = f32(0)
            for j in range(A.irp[i], A.irp[i + 1]):     # no duplicates here
                s = f32(s + f32(v32[j] * X[A.ja[j], c]))
            assert Y[i, c] == s, (i, c)
    backwards = np.zeros_like(Y)
    for i in range(A.m):
        for j in reversed(range(A.irp[i], A.irp[i + 1])):
            backwards[i] = (backwards[i] + v32[j] * X[A.ja[j]]).astype(f32)
    assert not np.array_equal(Y, backwards)


# ---- the byte count of bench/layout_bytes.py --------------------------------

def test_layout_bytes_counts_both_bcsr_layouts(capsys):
    """``bench/layout_bytes.py``'s BCSR lines: the dense tiles at 4 KB a
    tile against the bitmap tiles' arrays (stencil4k here; the flagship
    and stencil48k on the card machine's host)."""
    from spmv_scpa_tpu_torch.bench import layout_bytes
    A = CASES["bits-stencil4k"]()
    b = layout_bytes.bcsr_bytes(A)
    T = csr_to_bcsr(A).num_tiles
    assert b["dense"] == T * 4096
    assert b["vals"] == A.nnz * 4 and b["masks"] == T * 128
    assert b["pan_vptr"] == 4 * (2 * T + 1)
    assert b["rowptr"] == 4 * (-(-A.m // 8) + 1)
    assert b["bits"] == b["vals"] + b["masks"] + b["pan_vptr"] + b["rowptr"]
    assert b["dense"] > 5 * b["bits"]
    layout_bytes.report_bcsr("stencil4k", A)
    out = capsys.readouterr().out
    assert f"dense tiles {T * 4096} B" in out and "B/nnz" in out


def test_bits_study_ablations_match_the_source():
    """``bench/bits_study.py`` takes parts out of ``csrc/bcsr_bits.cu`` by
    text substitution: each text it replaces is in the source."""
    from spmv_scpa_tpu_torch import _kernels
    from spmv_scpa_tpu_torch.bench import bits_study
    src = (_kernels.CSRC_DIR / "bcsr_bits.cu").read_text()
    for name, subs in {**bits_study.SPMV, **bits_study.SPMM}.items():
        for old, _ in subs:
            assert src.count(old) == 1, name


# ---- the wrappers -----------------------------------------------------------

def test_wrappers_on_cpu_run_the_plain_versions_and_refuse_bad_arguments():
    A = CASES["bits-banded200x300"]()
    _, (bits, vals, vptr, pan, rowptr) = _args(A)
    x = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    X = torch.as_tensor(make_x(A.n, cols=8), dtype=torch.float32)
    before = dict(bcsr_bits.LAUNCHES)
    ok = (bits, vals, vptr, pan, rowptr)
    assert torch.equal(bcsr_bits.bcsr_bits(*ok, x, A.m),
                       bcsr_bits.bcsr_bits_plain(*ok, x, A.m))
    assert torch.equal(bcsr_bits.bcsr_bits_spmm(*ok, X, A.m),
                       bcsr_bits.bcsr_bits_spmm_plain(*ok, X, A.m))
    assert bcsr_bits.LAUNCHES == before
    for bad, what in (((bits.long(), vals, vptr, pan, rowptr), "bits"),
                      ((bits.view(-1, 4, 8), vals, vptr, pan, rowptr),
                       "bits"),
                      ((bits, vals.double(), vptr, pan, rowptr), "vals"),
                      ((bits, vals[:, None], vptr, pan, rowptr), "vals"),
                      ((bits, vals, vptr[:-1], pan, rowptr), "vptr"),
                      ((bits, vals, vptr.long(), pan, rowptr), "vptr"),
                      ((bits, vals, vptr, pan[:-1], rowptr), "pan"),
                      ((bits, vals, vptr, pan, rowptr[:-1]), "rowptr"),
                      ((bits, vals[::2], vptr, pan, rowptr),
                       "not contiguous"),
                      ((bits.to("meta"), vals.to("meta"), vptr.to("meta"),
                        pan.to("meta"), rowptr.to("meta")), "is on")):
        with pytest.raises(ValueError, match=what):
            bcsr_bits.bcsr_bits(*bad, x, A.m)
    with pytest.raises(ValueError, match="x is torch.float64"):
        bcsr_bits.bcsr_bits(*ok, x.double(), A.m)
    with pytest.raises(ValueError, match="dimension"):
        bcsr_bits.bcsr_bits(*ok, X, A.m)
    with pytest.raises(ValueError, match="dimension"):
        bcsr_bits.bcsr_bits_spmm(*ok, x, A.m)
    with pytest.raises(ValueError, match="not contiguous"):
        bcsr_bits.bcsr_bits_spmm(*ok, X.t().contiguous().t(), A.m)
    meta = tuple(t.to("meta") for t in (*ok, x))
    with pytest.raises(ValueError, match="unsupported device"):
        bcsr_bits.bcsr_bits(*meta, A.m)

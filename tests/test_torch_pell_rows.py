"""PELL over row quanta (spmv_scpa_tpu_torch/ops/pell_rows.py, the
default layout of ``cuda-pell``, ``cuda-pell-fp64``, the hybrid's
no-locality escape and its compact PELL tail) on the CPU: the planner's
invariants, the plain version's summation tree, and y against the JAX
package's ``pallas-pell``, ``pallas-pell-df64`` and hybrid (run in
interpret mode, as tests/test_torch_pell.py and tests/test_torch_fp64.py
run them) and against ``spmv_oracle``. The CUDA kernels are held against
the plain version in tests/test_torch_cuda.py.

Tolerances:
* the planner: exact (every entry once, in CSR order);
* the plain version against a loop over the same tree: bit-equal;
* f32 y: ``validate_result`` against the oracle (rel-L2 <= 1e-4) and
  rel-L2 <= 1e-4 against the JAX y (the TPU's PELL kernels reduce in
  bf16 split passes); the port alone against the oracle at rel-L2
  <= 1e-6 (every product and sum in f32);
* fp64 y: rel-L2 <= 1e-9 against the oracle, the absolute gate off
  (``validate_result``'s 0.1 would pass an f32 y), and <= 1e-11 against
  the JAX y (its digit planes are exact to about 2^-56).
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops import lane_ell, pell, pell_rows
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX = 1e-4
VS_ORACLE = 1e-6
FP64_VS_ORACLE = 1e-9
FP64_VS_JAX = 1e-11


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _carry(s, C):
    """Rows that cross blocks at every quantum: a 7,000-entry row (four
    blocks at Q=2, one at Q=16), empty first, middle and last rows, runs
    of one-entry rows across a boundary."""
    rng = np.random.default_rng(17)
    lens = np.array([0, 3, 7000, 0, 1, 1, 1, 2500, 0, 0, 40, 1, 0] * 3
                    + [900, 0])
    rows = np.repeat(np.arange(lens.size), lens)
    cols = rng.integers(0, 5000, rows.size)
    return C.from_coo("carry", lens.size, 5000, rows, cols,
                      rng.standard_normal(rows.size))


def _first_last(s, C):
    """Entries in the first and last rows only, the last one long."""
    rows = np.concatenate([np.zeros(5, np.int64), np.full(3000, 99)])
    cols = np.arange(rows.size) % 700
    return C.from_coo("first_last", 100, 700, rows, cols,
                      np.linspace(-1.0, 2.0, rows.size))


def _no_entries(s, C):
    return C.from_coo("no_entries", 40, 30, [], [], [])


# name -> matrix drawn by either package (``s``: its testing module, ``C``
# its CSR class)
MATRICES = {
    "powerlaw3000": lambda s, C: s.powerlaw_csr(3000, 2000, seed=31),
    "banded2000": lambda s, C: s.banded_csr(2000, row_nnz=11, bandwidth=48,
                                            seed=5),
    "webbase20k": lambda s, C: s.webbase_csr(20000, seed=5),
    "carry": _carry,
    "first_last": _first_last,
    "no_entries": _no_entries,
}


def _matrix(name, pkg=synth):
    return MATRICES[name](pkg, CSR if pkg is synth else JaxCSR)


# ---- the planner -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantum", [None, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_holds_every_entry_once_in_row_order(name, quantum, dtype):
    A = _matrix(name)
    plan = pell_rows.plan_pell_rows(A, dtype, quantum)
    Q = plan.quantum
    lens = np.diff(A.irp)
    assert plan.vals.dtype == (np.float32 if dtype == torch.float32
                               else np.float64)
    assert plan.cols.dtype == plan.qptr.dtype == plan.blk_lo.dtype \
        == np.int32
    assert plan.qptr.shape == (A.m + 1,) and plan.qptr[0] == 0
    assert np.all(np.diff(plan.qptr) == -(-lens // Q))    # contiguous
    NQ = int(plan.qptr[-1])
    assert plan.vals.shape == plan.cols.shape == (NQ, Q)
    vals, cols = plan.vals.reshape(-1), plan.cols.reshape(-1)
    # slot of entry k of row r: the row's first slot plus k
    row = np.repeat(np.arange(A.m), lens)
    slot = plan.qptr[row].astype(np.int64) * Q \
        + np.arange(A.nnz) - A.irp[row]
    np.testing.assert_array_equal(cols[slot], A.ja)
    np.testing.assert_array_equal(vals[slot], A.as_.astype(vals.dtype))
    pad = np.ones(NQ * Q, bool)
    pad[slot] = False
    assert pad.sum() == NQ * Q - A.nnz
    slot_row = np.repeat(np.arange(A.m), np.diff(plan.qptr) * Q)
    assert np.all(vals[pad] == 0)
    np.testing.assert_array_equal(cols[pad],
                                  A.ja[A.irp[slot_row[pad] + 1] - 1])
    assert np.all((cols >= 0) & (cols < max(A.n, 1)))
    QB = pell_rows.BLOCK_SLOTS // Q
    nb = -(-NQ // QB)
    np.testing.assert_array_equal(
        plan.blk_lo, np.searchsorted(plan.qptr, np.arange(nb + 1) * QB))
    assert plan.meta == {"layout": "rows", "quantum": Q, "quanta": NQ,
                         "blocks": nb, "fill": A.nnz / max(NQ * Q, 1)}
    assert plan.hbm_bytes == sum(a.nbytes for a in (
        plan.vals, plan.cols, plan.qptr, plan.blk_lo))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_quantum_rule_takes_the_fewest_bytes(name, itemsize):
    lens = np.diff(_matrix(name).irp)
    cost = {}
    for q in (2, 4, 8, 16):
        quanta = int(sum(-(-int(k) // q) for k in lens))
        cost[q] = quanta * q * (itemsize + 4) + quanta * 4
    best = min(cost.values())
    want = max(q for q, c in cost.items() if c == best)
    assert pell_rows.pick_quantum(lens, itemsize) == want


def test_quantum_rule_follows_the_row_lengths():
    """Rows of 2 take Q=2, rows of 16 take Q=16, and an explicit
    quantum wins; a size the kernels do not take is refused."""
    assert pell_rows.pick_quantum(np.full(100, 2), 4) == 2
    assert pell_rows.pick_quantum(np.full(100, 16), 4) == 16
    assert pell_rows.pick_quantum(np.full(100, 8), 8) == 8
    A = _matrix("banded2000")
    assert pell_rows.plan_pell_rows(A, quantum=16).quantum == 16
    with pytest.raises(ValueError, match="quantum 32"):
        pell_rows.plan_pell_rows(A, quantum=32)


# ---- the plain version's tree -----------------------------------------------

def _loop_sum(plan, x):
    """The kernels' sum written out as loops over numpy scalars of the
    plan's dtype: the pairwise tree per quantum, the chunk scans and the
    scan of chunk totals per block, the carries in block order."""
    dt = plan.vals.dtype.type
    Q = plan.quantum
    QB = pell_rows.BLOCK_SLOTS // Q
    C = QB // 32
    NQ = plan.vals.shape[0]
    x = np.asarray(x, plan.vals.dtype)

    def tree(p):
        while len(p) > 1:
            p = [dt(p[i] + p[i + 1]) for i in range(0, len(p), 2)]
        return p[0]

    part = []
    for q in range(NQ):
        part.append(tree([dt(plan.vals[q, k] * (x[plan.cols[q, k]]
                                                if 0 <= plan.cols[q, k]
                                                < x.size else dt(0)))
                          for k in range(Q)]))
    nb = -(-NQ // QB)
    head = np.zeros(nb * QB, bool)
    for a in plan.qptr[:-1]:
        if a < nb * QB:
            head[a] = True
    fin = [dt(0)] * (nb * QB)
    for b in range(nb):
        v = [part[i] if i < NQ else dt(0) for i in range(b * QB,
                                                         b * QB + QB)]
        h = head[b * QB:b * QB + QB]
        lim, hl = [], []
        for i in range(QB):         # the last head at or before i in its chunk
            cur = -1 if i % 32 == 0 else hl[-1]
            hl.append(i % 32 if h[i] else cur)
            lim.append(max(hl[-1], 0))
        d = 1
        while d < 32:
            v = [dt(v[i - d] + v[i]) if i % 32 - d >= lim[i] else v[i]
                 for i in range(QB)]
            d *= 2
        tot = [v[c * 32 + 31] for c in range(C)]
        seen = [bool(h[c * 32:c * 32 + 32].any()) for c in range(C)]
        d = 1
        while d < C:
            tot, seen = ([dt(tot[c - d] + tot[c]) if c >= d and not seen[c]
                          else tot[c] for c in range(C)],
                         [seen[c] or (c >= d and seen[c - d])
                          for c in range(C)])
            d *= 2
        for i in range(QB):
            c = i // 32
            fin[b * QB + i] = (dt(tot[c - 1] + v[i]) if c and hl[i] < 0
                               else v[i])
    y = np.zeros(plan.m, plan.vals.dtype)
    for r in range(plan.m):
        a, e = int(plan.qptr[r]), int(plan.qptr[r + 1])
        if a == e:
            continue
        acc = fin[min(e, a // QB * QB + QB) - 1]
        for blk in range(a // QB + 1, (e - 1) // QB + 1):
            acc = dt(acc + fin[min(e, blk * QB + QB) - 1])
        y[r] = acc
    return part, fin, y


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantum", [2, 16])
@pytest.mark.parametrize("name", ["carry", "first_last", "powerlaw3000"])
def test_plain_tree_equals_a_loop(name, quantum, dtype):
    """The plain version's quantum sums, block sums and y are those of
    the loop, bit for bit, on random values (where order shows)."""
    A = _matrix(name)
    plan = pell_rows.plan_pell_rows(A, dtype, quantum)
    x = make_x(A.n)
    part, fin, y = _loop_sum(plan, x)
    t = [torch.as_tensor(a) for a in (plan.vals, plan.cols, plan.qptr,
                                       plan.blk_lo)]
    xt = torch.as_tensor(x, dtype=dtype)
    got_part = pell_rows.quantum_sums(t[0], t[1], xt)
    np.testing.assert_array_equal(got_part.numpy(), np.array(part))
    got_fin = pell_rows.block_sums(got_part, t[2], plan.quantum)
    np.testing.assert_array_equal(got_fin.numpy(), np.array(fin))
    np.testing.assert_array_equal(pell_rows.pell_rows_plain(*t, xt).numpy(),
                                  y)


@pytest.mark.parametrize("name", ["carry", "first_last", "no_entries",
                                  "webbase20k"])
def test_carry_cases_match_the_oracle(name):
    """Rows across three or more blocks, empty rows at both ends and
    inside, and nnz == 0: y against the oracle at both grades, empty
    rows exactly 0."""
    A = _matrix(name)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    empty = np.diff(A.irp) == 0
    for dtype, tol in ((torch.float32, VS_ORACLE),
                       (torch.float64, FP64_VS_ORACLE)):
        for q in (2, 4, 8, 16):
            plan = pell_rows.plan_pell_rows(A, dtype, q)
            y = pell_rows.pell_rows_plain(
                *[torch.as_tensor(a) for a in (plan.vals, plan.cols,
                                               plan.qptr, plan.blk_lo)],
                torch.as_tensor(x, dtype=dtype)).double().numpy()
            assert y.shape == (A.m,)
            assert np.all(y[empty] == 0.0)
            assert _rel(y, gold) <= tol, (q, dtype)
    if name == "carry":
        plan = pell_rows.plan_pell_rows(A, quantum=2)
        QB = pell_rows.BLOCK_SLOTS // 2
        spans = (plan.qptr[1:] - 1) // QB - plan.qptr[:-1] // QB
        assert spans.max() >= 3


# ---- the strategies against JAX and the oracle ----------------------------

@functools.cache
def _jax_y(name, strategy, jax_name):
    A = _matrix(name)
    x = make_x(A.n)
    prep = get_strategy(strategy).prepare(A, device="cpu")
    jprep = jax_strategy(jax_name).prepare(_matrix(name, jax_synth),
                                           interpret=True)
    return (A, x, prep, to_numpy(prep.fn(x)),
            np.asarray(jprep.fn(x), np.float64))


@pytest.mark.parametrize("name", ["powerlaw3000", "banded2000", "carry"])
def test_cuda_pell_rows_matches_jax_and_oracle(name):
    A, x, prep, y, y_jax = _jax_y(name, "cuda-pell", "pallas-pell")
    assert prep.meta["layout"] == "rows"
    assert [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))] == ["pell_rows"]
    gold = spmv_oracle(A, x)
    validate_result(gold, y, what=f"cuda-pell (rows, plain) on {name}")
    assert _rel(y, gold) <= VS_ORACLE
    assert _rel(y, y_jax) <= VS_JAX


@pytest.mark.parametrize("name", ["powerlaw3000", "carry"])
def test_cuda_pell_fp64_rows_matches_jax_and_oracle(name):
    A, x, prep, y, y_jax = _jax_y(name, "cuda-pell-fp64", "pallas-pell-df64")
    assert prep.meta["layout"] == "rows" and prep.meta["rtol"] == 1e-9
    assert y.dtype == np.float64
    gold = spmv_oracle(A, x)
    assert _rel(y, gold) <= FP64_VS_ORACLE
    assert _rel(y, y_jax) <= FP64_VS_JAX
    validate_result(gold, y, rtol=FP64_VS_ORACLE, abs_l2=0.0,
                    what=f"cuda-pell-fp64 (rows, plain) on {name}")


@pytest.mark.parametrize("name", sorted(cases.PELL_CASES))
def test_small_pell_cases_take_their_layout(name):
    """The fused cases take the row layout by default, the span and pure
    schemes and BCSR the tiles; y against the oracle."""
    make, strategy, kw = cases.PELL_CASES[name]
    A = make()
    x = make_x(A.n)
    prep = get_strategy(strategy).prepare(A, device="cpu", **kw)
    rows = strategy == "cuda-pell" and kw.get("scheme") not in ("span",
                                                                 "pure")
    assert (prep.meta.get("layout") == "rows") == rows
    kernels = [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))]
    assert (kernels == ["pell_rows"]) == rows
    validate_result(spmv_oracle(A, x), to_numpy(prep.fn(x)),
                    what=f"{strategy} on {name}")


def test_layout_knob():
    A = _matrix("powerlaw3000")
    tiles = pell.prepare_pell(A, device="cpu", layout="tiles")
    assert tiles.meta["scheme"] == "fused" and "layout" not in tiles.meta
    rows = pell.prepare_pell(A, device="cpu", chunk=64, quantum=4,
                             window_h=32)
    assert rows.meta["quantum"] == 4
    assert rows.meta["tile_knobs"] == {"chunk": 64, "window_h": 32}
    assert rows.hbm_bytes < tiles.hbm_bytes
    span = pell.prepare_pell(A, device="cpu", scheme="span")
    assert span.meta["scheme"] == "span" and "layout" not in span.meta
    with pytest.raises(ValueError, match="tile layout"):
        pell.plan_rows(A, scheme="span")
    with pytest.raises(ValueError, match="unknown layout"):
        pell.prepare_pell(A, device="cpu", layout="panels")
    with pytest.raises(ValueError, match="unknown layout"):
        lane_ell.prepare_lane_ell_hybrid(A, device="cpu",
                                         pell_layout="panels")
    with pytest.raises(ValueError, match="quantum 32"):
        pell.prepare_pell_fp64(A, device="cpu", quantum=32)


def test_fp64_rows_keep_the_reference_refusals():
    """The 2^24 row budget and the x-pair budget refuse on the row layout
    as on the reference; the tiles' shared-memory refusal does not
    apply."""
    jprep = functools.partial(jax_strategy("pallas-pell-df64").prepare,
                              interpret=True)
    long_row = (8, 70_000, np.zeros(69_000, np.int64), np.arange(69_000),
                np.ones(69_000))
    for prep, C in ((pell.prepare_pell_fp64, CSR), (jprep, JaxCSR)):
        with pytest.raises(ValueError, match="2\\^24"):
            prep(C.from_coo("long", *long_row), **(
                {"device": "cpu"} if C is CSR else {}))
    wide = (64, 1_600_000, np.arange(64), np.arange(64) * 25_000,
            np.ones(64))
    with pytest.raises(ValueError, match="x pair"):
        pell.prepare_pell_fp64(CSR.from_coo("w", *wide), device="cpu")
    W = synth.webbase_csr(6000, seed=7)
    prep = pell.prepare_pell_fp64(W, device="cpu", chunk=256, quantum=8)
    x = make_x(W.n)
    assert _rel(to_numpy(prep.fn(x)), spmv_oracle(W, x)) <= FP64_VS_ORACLE


def test_f32_rows_keep_the_unported_options():
    A = _matrix("banded2000")
    for kw, what in (({"hot_cols": 128}, "hot_cols"),
                     ({"split_shift": True}, "split_shift"),
                     ({"x_vmem_budget": 1024}, "column stripes")):
        with pytest.raises(NotImplementedError, match=what):
            pell.prepare_pell(A, device="cpu", **kw)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    A = _matrix("carry")
    prep = pell.prepare_pell(A, device="cpu")
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    (name, args), = prep.kernel_calls(xf)
    before = dict(pell_rows.LAUNCHES)
    y = pell_rows.pell_rows(*args)
    assert pell_rows.LAUNCHES == before
    assert torch.equal(y, pell_rows.pell_rows_plain(*args))
    vals, cols, qptr, blk_lo, x = args
    for bad, what in (((vals.double(), cols, qptr, blk_lo, x), "vals"),
                      ((vals, cols.long(), qptr, blk_lo, x), "cols"),
                      ((vals, cols[:-1], qptr, blk_lo, x), "cols"),
                      ((vals, cols, qptr.long(), blk_lo, x), "qptr"),
                      ((vals, cols, qptr, blk_lo[:-1], x), "blk_lo"),
                      ((vals, cols, qptr, blk_lo, x.double()), "x is"),
                      ((vals.t().contiguous().t(), cols, qptr, blk_lo, x),
                       "contiguous")):
        with pytest.raises(ValueError, match=what):
            pell_rows.pell_rows(*bad)
    with pytest.raises(ValueError, match="vals"):
        pell_rows.pell_rows_fp64(vals, cols, qptr, blk_lo, x.double())


# ---- the hybrid's escape and compact tail ------------------------------------

@functools.cache
def _tail_route():
    """tests/test_torch_big_tail.py's compact-PELL route (a 3,091-entry
    tail past tail_xla_max, no chips) on the default row layout, landed
    as the reference lands it (``landing="merge"``; the direct landing:
    tests/test_torch_landing.py), beside the JAX hybrid, on both core
    layouts ({layout: Prepared}, one pack)."""
    kw = {"ext": False, "diag": "nochips", "tail_xla_max": 1000}
    A = synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4)
    x = make_x(A.n)
    prep = lane_ell.prepare_hybrid_layouts(A, device="cpu", landing="merge",
                                           **kw)
    jprep = jax_hybrid(jax_synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
                       interpret=True, **kw)
    return A, x, prep, jprep


def test_row_layout_big_tail_matches_jax():
    """The hybrid's meta equals the reference's but for the tail's own
    and the route's name; y within 1e-4 of the JAX hybrid, on both core
    layouts."""
    A, x, preps, jprep = _tail_route()
    y_jax = np.asarray(jprep.fn(x), np.float64)
    gold = spmv_oracle(A, x)
    for layout, core in (("lanes", "lane_ell_spmv"), ("rows", "lane_rows")):
        prep = preps[layout]
        m, jm = dict(prep.meta), dict(jprep.meta)
        assert (m.pop("tail_kind"), jm.pop("tail_kind")) == (
            "compact-cuda-pell-rows", "compact-pallas-pell")
        tail = m.pop("tail_meta")
        jm.pop("tail_meta")
        assert m == {**jm, "landing": "merge"}
        assert tail["layout"] == "rows" and tail["fill"] > 0.5
        assert [k for k, _ in prep.kernel_calls(
            torch.as_tensor(x, dtype=torch.float32))] == [
                core, "pell_rows", "window_gather"]
        y = to_numpy(prep.fn(x))
        assert _rel(y, y_jax) <= VS_JAX, layout
        assert _rel(y, gold) <= VS_ORACLE, layout
        validate_result(gold, y, what=f"port hybrid (plain, {layout}), "
                        "row-layout tail")


def test_escape_takes_the_row_layout():
    """The no-locality escape (tests/test_torch_big_tail.py's matrix)
    goes to cuda-pell on the row layout: one pell_rows call, no
    un-permute; y against the oracle."""
    A = synth.powerlaw_csr(17000, 17000, avg_nnz=8, seed=5)
    x = make_x(A.n)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu")
    m = prep.meta
    assert m["delegated"] == "cuda-pell" and m["d_cov"] < 0.4
    assert m["layout"] == "rows" and m["tail_kind"] == "cuda-pell"
    assert [k for k, _ in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32))] == ["pell_rows"]
    y = to_numpy(prep.fn(x))
    gold = spmv_oracle(A, x)
    assert _rel(y, gold) <= VS_ORACLE
    validate_result(gold, y, what="escape on the row layout")

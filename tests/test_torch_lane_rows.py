"""The lane-ELL core in row quanta (spmv_scpa_tpu_torch/ops/lane_rows.py,
the default ``core_layout="rows"`` of ``cuda-hybrid`` and of
``prepare_row_sharded_hybrid``) on the CPU: the entries the packer
records for the core, the compact index, the plain version's summation
tree, and y against the lanes layout and ``spmv_oracle``, on small
matrices; in the ``slow`` tier, both layouts against the JAX hybrid's y
(its Pallas kernels in interpret mode), single card and at 1, 2 and 4
shards. The tier-1 run holds both single-card layouts to the JAX y in
tests/test_torch_lane_ell.py and the rows layout at 4 shards in
tests/test_torch_distributed.py, where the reference already runs. The
CUDA kernel is held against the plain version in tests/test_torch_cuda.py.

Tolerances:
* the recorded entries, the decoded planes and the compact index:
  exact;
* the plain version against a numpy loop over ``pell_rows``' tree:
  bit-equal;
* the rows y against the lanes y of the same pack: rel-L2 <= 1e-6 and,
  per row, |dy| <= 1e-5 * (|A||x|)_row (both sum each row's f32
  products, in two orders); against ``spmv_oracle``:
  ``validate_result`` defaults;
* either layout against the JAX y: rel-L2 <= 1e-6 (and per row the
  bound above on the single card), as tests/test_torch_lane_ell.py and
  tests/test_torch_distributed.py hold the port to it.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_distributed import _jax_mesh
from test_torch_lane_ell import JAX_CASES
from test_torch_pell_rows import _loop_sum, _matrix

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.parallel import distributed as JD

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import (chips_tail, ext_gather, lane_ell,
                                     lane_rows, pell_rows)
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.parallel import distributed as D
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

ROWS_VS_LANES_REL_L2 = 1e-6
ROWS_VS_LANES_ROW = 1e-5
VS_JAX_REL_L2 = 1e-6

HYBRID_DIST = sorted(name for name, (fn, _, _) in cases.DIST_CASES.items()
                     if fn == "prepare_row_sharded_hybrid")
PACK_KNOBS = ("loc_w", "slots", "chunk", "strip_cov", "ext")


@functools.cache
def _small(name):
    make, kw = cases.SMALL_CASES[name]
    A = make()
    return A, kw, lane_ell.pack_lane_ell(A, **kw)


@functools.cache
def _shards(name, k):
    """(A, the shard bounds, loc_w, the shards' CSRs, their CoreBuilds)
    of a DIST_CASES hybrid route at k shards."""
    _, make, kw = cases.DIST_CASES[name]
    A = make(k)
    bounds, _, loc_w, shards, cores = D.pack_shards(
        A, k, **{key: v for key, v in kw.items() if key in PACK_KNOBS})
    return A, bounds, loc_w, shards, cores


def _entries(A, idx):
    return A.row_ids()[idx], A.ja[idx], A.as_[idx]


def _sorted_triplets(rows, cols, vals):
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    order = np.lexsort((np.asarray(vals), cols, rows))
    return rows[order], cols[order], np.asarray(vals)[order]


def _chips_values(cp):
    """The nonzero values a chips plan (single or split) holds."""
    parts = [s.vals for s in cp.streams] if isinstance(
        cp, chips_tail.SplitChipsPlan) else [cp.vals]
    v = np.concatenate([np.asarray(p, np.float32).reshape(-1)
                        for p in parts])
    return np.sort(v[v != 0])


def _check_split(A, plan):
    """The core's recorded entries and the tail's triplets are A's
    entries, each once; the chips plan holds the tail's values."""
    core = np.asarray(plan.core)
    assert core.size == np.unique(core).size
    rows, cols, vals = _entries(A, core)
    got = _sorted_triplets(np.concatenate([rows, plan.trows]),
                           np.concatenate([cols, plan.tcols]),
                           np.concatenate([vals, plan.tvals]))
    want = _sorted_triplets(A.row_ids(), A.ja, A.as_)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # each row's entries in plane order: grouped by row, rows ascending
    assert np.all(np.diff(rows) >= 0)
    cp = getattr(plan, "chips", None)
    if cp is not None:
        tv = np.asarray(plan.tvals, np.float32)
        np.testing.assert_array_equal(_chips_values(cp), np.sort(tv[tv != 0]))


@pytest.mark.parametrize("name", sorted(cases.SMALL_CASES))
def test_core_tail_and_chips_make_up_the_matrix(name):
    A, _, plan = _small(name)
    _check_split(A, plan)
    assert plan.core.size + plan.trows.size == A.nnz


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", HYBRID_DIST)
def test_shard_cores_and_tails_make_up_each_shard(name, k):
    A, _, _, shards, cores = _shards(name, k)
    assert sum(S.nnz for S in shards) == A.nnz
    for S, core in zip(shards, cores):
        _check_split(S, core)


# ---- the planes decoded back to x columns ------------------------------------

def _ext_cols(g, lane, p2, l2, base1, p1, l1, R, base8=None):
    """The x column an ext panel lane reads: stage 2 (the group's table,
    windowed from ``base8`` when given) to a hot position, stage 1 to x."""
    hrow = p2[g, lane].astype(np.int64)
    if base8 is not None:
        hrow = hrow + base8[g].astype(np.int64) * 8
    hl = l2[g, lane].astype(np.int64)
    hrow = np.clip(hrow, 0, p1.shape[0] - 1)
    return ((base1[hrow // 8].astype(np.int64) * R
             + p1[hrow, hl].astype(np.int64)) * BC
            + l1[hrow, hl].astype(np.int64))


def _decode(plan, x_base=0):
    """Every slot of the planes as (value, x column), each (rows, QT) in
    plane order: a local strip s reads ``x_base + (g + s) * 128 + lane -
    loc_w``, a hot strip ``hot_idx[(s - S) * 128 + lane]``, the ext
    strip its group's panel lane through the ext plan's stage-2 and
    stage-1 tables; a dynamic slot takes its step's strip first."""
    lane_plan = isinstance(plan, lane_ell.LanePlan)
    if lane_plan:
        cfg = plan.cfg
        QT, n8, chunk, steps, S = cfg.QT, cfg.n8, cfg.chunk, cfg.steps, cfg.S
        nw, TD, ext_w, Hs = cfg.nw, cfg.TD, cfg.ext_w, cfg.Hs
        tabs = plan.plane_tabs()
    else:
        QT, n8, chunk, steps, S = plan.QT, 0, plan.chunk, plan.steps, plan.S
        ext_w = S if plan.ext_ng else -1
        nw, TD, Hs = S + (ext_w >= 0), 0, 0
    G = steps * chunk
    v = plan.vals_a.reshape(steps, QT, chunk, BC)
    i8 = plan.idx8_a.reshape(steps, n8, chunk, BC).astype(np.int64) & 255 \
        if n8 else None
    i16 = plan.idx_a.reshape(steps, QT - n8, chunk, BC).astype(np.int64)
    g = np.arange(G).reshape(steps, 1, chunk, 1)
    step = np.arange(steps).reshape(steps, 1, 1, 1)
    q = np.arange(QT).reshape(1, QT, 1, 1)
    code = np.zeros((steps, QT, chunk, BC), np.int64)
    code[:, n8:] = i16
    strip = code >> 7
    if n8:
        code[:, :n8] = i8
        strip[:, :n8] = np.where(i8 >> 7 == 1, tabs[:n8, 1][:, None, None],
                                 tabs[:n8, 0][:, None, None])
    if TD:
        dyn = (strip >= nw) & (q >= n8)
        slot = step * TD + tabs[:, 0][None, :, None, None] + strip - nw
        strip = np.where(dyn, plan.dynw_a[np.clip(slot, 0, TD * steps - 1)],
                         strip)
    lane = code & 127
    col = np.full(code.shape, -1, np.int64)
    loc = strip < S
    col[loc] = (x_base + ((g + strip) * BC + lane - plan.loc_w))[loc]
    hot = (strip >= S) & (strip < S + Hs)
    if hot.any():
        col[hot] = plan.hot_idx[(strip[hot] - S) * BC + lane[hot]]
    ext = strip == ext_w
    if ext.any():
        gg = np.broadcast_to(g, code.shape)[ext]
        if lane_plan:
            ep = plan.ext
            col[ext] = _ext_cols(gg, lane[ext], plan.ext_p2, plan.ext_l2,
                                 ep.base, ep.p1, ep.l1, ep.R,
                                 plan.ext_b8 if ep.windowed else None)
        else:
            col[ext] = _ext_cols(gg, lane[ext], plan.ext_p2, plan.ext_l2,
                                 plan.ext_base, plan.ext_p1, plan.ext_l1,
                                 ext_gather.R_PANELS)

    def per_row(a):
        return a.transpose(0, 2, 3, 1).reshape(G * BC, QT)
    return per_row(v), per_row(col)


def _check_planes(A, plan, vals, cols):
    """The slots with a value, row by row in plane order, are the
    recorded entries in their order (the cases hold no explicit zeros,
    so the nonzero slots are the real ones)."""
    assert np.all(A.as_ != 0)
    r, q = np.nonzero(vals)
    rows, ecols, evals = _entries(A, plan.core)
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(cols[r, q], ecols)
    np.testing.assert_array_equal(vals[r, q], evals.astype(np.float32))


@pytest.mark.parametrize("name", sorted(cases.SMALL_CASES))
def test_planes_decode_to_the_recorded_entries(name):
    A, _, plan = _small(name)
    vals, cols = _decode(plan)
    _check_planes(A, plan, vals, cols)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", HYBRID_DIST)
def test_shard_planes_decode_to_the_recorded_entries(name, k):
    """A shard's local strips read x from its window base as the kernel
    clamps it into the shared padded x (``loc_w + n + P_pad * 128``
    elements), as ``jax.lax.dynamic_slice`` does."""
    A, bounds, loc_w, shards, cores = _shards(name, k)
    xlen = loc_w + A.n + cores[0].P_pad * BC
    for d, (S, core) in enumerate(zip(shards, cores)):
        base = min(max(int(bounds[d]), 0), xlen - core.P_pad * BC)
        vals, cols = _decode(core, base)
        _check_planes(S, core, vals, cols)


# ---- the compact index --------------------------------------------------------

def _mixed(seed=3):
    """Rows of near-diagonal columns (16-bit blocks) followed by rows of
    columns spread over 300,000 (32-bit blocks), with long rows that
    cross blocks in both, and empty rows."""
    rng = np.random.default_rng(seed)
    n = 300_000
    lens = np.concatenate([rng.integers(0, 12, 800), [3000, 0, 5],
                           rng.integers(0, 12, 800), [2600], [0] * 3])
    m = lens.size
    rows = np.repeat(np.arange(m), lens)
    near = (rows * 37 + rng.integers(0, 900, rows.size)) % n
    far = rng.integers(0, n, rows.size)
    cols = np.where(rows < 803, near, far)
    return CSR.from_coo("mixed", m, n, rows, cols,
                        rng.standard_normal(rows.size))


def _core_of(A, quantum=None):
    """A's entries, in CSR order, as a rows core."""
    return lane_rows.plan_core(A.m, A.n, A.row_ids(), A.ja,
                               A.as_.astype(np.float32), quantum)


@pytest.mark.parametrize("quantum", [2, 4, 8, 16])
def test_index_decodes_to_the_columns_on_both_widths(quantum):
    A = _mixed()
    plan = _core_of(A, quantum)
    wide = plan.ctab[:, 0] < 0
    assert wide.any() and (~wide).any()
    # a low word a slot, then each 32-bit block's high halves
    assert plan.idx.size == plan.vals.size + sum(
        min(pell_rows.BLOCK_SLOTS, plan.vals.size - b * pell_rows.BLOCK_SLOTS)
        for b in np.flatnonzero(wide))
    ref = pell_rows.plan_pell_rows(A, quantum=quantum)
    cols = lane_rows.decode_cols(torch.as_tensor(plan.idx),
                                 torch.as_tensor(plan.ctab),
                                 plan.vals.size).numpy()
    # the same slots as pell_rows' layout of A: entries, and padding at
    # the row's last column (in range, in the block's span)
    np.testing.assert_array_equal(cols, ref.cols.reshape(-1))
    np.testing.assert_array_equal(plan.vals, ref.vals)
    np.testing.assert_array_equal(plan.qptr, ref.qptr)
    np.testing.assert_array_equal(plan.blk_lo, ref.blk_lo)
    assert np.all((cols >= 0) & (cols < A.n))
    blk = np.arange(cols.size) // pell_rows.BLOCK_SLOTS
    span = np.zeros(plan.ctab.shape[0], np.int64)
    np.maximum.at(span, blk, cols)
    lo = np.full(span.size, A.n, np.int64)
    np.minimum.at(lo, blk, cols)
    np.testing.assert_array_equal(wide, span - lo >= lane_rows.SPAN16)
    np.testing.assert_array_equal(plan.ctab[~wide, 0], lo[~wide])
    assert plan.meta["wide_blocks"] == int(wide.sum())


def test_quantum_rule_counts_the_index():
    """The rule takes the fewest bytes of the whole layout, and the
    plan's bytes are those its arrays hold."""
    for A in (_mixed(), _matrix("powerlaw3000"), _matrix("carry")):
        rows, lens = A.row_ids(), np.diff(A.irp).astype(np.int64)
        cost = {q: lane_rows.layout_bytes(rows, A.ja.astype(np.int64), lens,
                                          q) for q in pell_rows.QUANTA}
        plan = _core_of(A)
        assert cost[plan.quantum] == min(cost.values())
        assert plan.hbm_bytes == sum(a.nbytes for a in plan.arrays()) \
            == cost[plan.quantum]


def test_plan_refuses_ungrouped_entries():
    with pytest.raises(ValueError, match="grouped by row"):
        lane_rows.plan_core(4, 10, [1, 0], [2, 3], [1.0, 1.0])


@pytest.mark.parametrize("quantum", [2, 16])
@pytest.mark.parametrize("name", ["carry", "mixed"])
def test_plain_tree_equals_a_loop(name, quantum):
    """The plain version over the compact index: the numpy loop over
    ``pell_rows``' tree (tests/test_torch_pell_rows.py) on the same
    slots, bit for bit, on rows that cross blocks."""
    A = _mixed() if name == "mixed" else _matrix("carry")
    plan = _core_of(A, quantum)
    x = make_x(A.n)
    ref = SimpleNamespace(
        vals=plan.vals, quantum=quantum, qptr=plan.qptr, m=A.m,
        cols=pell_rows.plan_pell_rows(A, quantum=quantum).cols)
    _, _, y = _loop_sum(ref, x)
    t = lane_rows.bind(plan, "cpu")
    got = lane_rows.lane_rows_plain(*t, torch.as_tensor(x, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), y)
    assert np.diff(plan.qptr).max() * quantum > pell_rows.BLOCK_SLOTS


def test_wrapper_runs_the_plain_version_and_checks_its_arguments():
    A = _mixed()
    t = lane_rows.bind(_core_of(A), "cpu")
    x = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    before = dict(lane_rows.LAUNCHES)
    y = lane_rows.lane_rows(*t, x)
    assert lane_rows.LAUNCHES == before
    assert torch.equal(y, lane_rows.lane_rows_plain(*t, x))
    vals, idx, ctab, qptr, blk_lo = t
    for bad, what in (((vals.double(), idx, ctab, qptr, blk_lo, x), "vals"),
                      ((vals, idx.int(), ctab, qptr, blk_lo, x), "idx"),
                      ((vals, idx[:10], ctab, qptr, blk_lo, x), "idx"),
                      ((vals, idx, ctab[:-1], qptr, blk_lo, x), "ctab"),
                      ((vals, idx, ctab, qptr.long(), blk_lo, x), "qptr"),
                      ((vals, idx, ctab, qptr, blk_lo[:-1], x), "blk_lo"),
                      ((vals, idx, ctab, qptr, blk_lo, x.double()), "x is"),
                      ((vals.t().contiguous().t(), idx, ctab, qptr, blk_lo,
                        x), "contiguous")):
        with pytest.raises(ValueError, match=what):
            lane_rows.lane_rows(*bad)


# ---- the hybrid on the rows core ----------------------------------------------

def _check_layouts(A, y_rows, y_lanes, what):
    absA = CSR(A.name, A.m, A.n, A.irp, A.ja, np.abs(A.as_))
    x = make_x(A.n)
    assert np.linalg.norm(y_rows - y_lanes) <= \
        ROWS_VS_LANES_REL_L2 * np.linalg.norm(y_lanes)
    assert np.all(np.abs(y_rows - y_lanes)
                  <= ROWS_VS_LANES_ROW * spmv_oracle(absA, np.abs(x)))
    validate_result(spmv_oracle(A, x), y_rows, what=what)


@pytest.mark.parametrize("name", sorted(cases.SMALL_CASES))
def test_hybrid_rows_core_matches_lanes_and_oracle(name):
    A, kw, plan = _small(name)
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw)
    x = make_x(A.n)
    _check_layouts(A, to_numpy(preps["rows"].fn(x)),
                   to_numpy(preps["lanes"].fn(x)), f"rows core on {name}")
    rows = preps["rows"]
    core = lane_ell.rows_plan(A, plan)
    assert rows.hbm_bytes - core.hbm_bytes == \
        preps["lanes"].hbm_bytes - plan.cfg.steps * plan.cfg.chunk * BC \
        * plan.slot_bytes                      # the same tail
    assert rows.meta == preps["lanes"].meta


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", HYBRID_DIST)
def test_row_sharded_rows_core_matches_lanes_and_oracle(name, k):
    _, make, kw = cases.DIST_CASES[name]
    A = make(k)
    if k < 4 and name.startswith("hybrid-chips"):
        kw = {**kw, "tail_kind": "auto"}     # no tail to force on 1-2 shards
    preps = D.row_sharded_hybrid_layouts(A, mesh=D.make_mesh(
        devices=["cpu"] * k), **kw)
    x = make_x(A.n)
    _check_layouts(A, to_numpy(preps["rows"].fn(x)),
                   to_numpy(preps["lanes"].fn(x)), f"{name}, {k} shards")
    assert preps["rows"].meta == preps["lanes"].meta
    for layout, core in (("rows", "lane_rows"),
                         ("lanes", "lane_ell_sharded")):
        names = [c for c, _ in preps[layout].kernel_calls(x)]
        assert names.count(core) == 1, (layout, names)


def test_rows_core_runs_no_ext_gather():
    """The rows core reads x in place: amazon60k's call runs
    ``lane_rows`` and the chips tail, not the core's ext route (whose
    stage-2 gather over all groups the lanes call runs first)."""
    A, kw, _ = _small("amazon60k")
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw)
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    rows = [k for k, _ in preps["rows"].kernel_calls(xf)]
    lanes = [k for k, _ in preps["lanes"].kernel_calls(xf)]
    assert rows[0] == "lane_rows" and "lane_ell_spmv" not in rows
    assert lanes[:3] == ["sorted_gather", "ranked_gather", "lane_ell_spmv"]
    assert lanes[3:] == rows[1:]              # the same tail
    assert not {"sorted_gather", "ranked_gather", "window_gather"} & set(rows)


def test_landing_takes_the_rows_core_y():
    """The chips tail (whose sums the reference would land by a panel
    merge over G_pad groups) lands into the core's y, (m,) on the rows
    layout and (G_pad * 128,) on the lanes one, and the landed y agree."""
    A, kw, plan = _small("amazon60k")
    assert plan.chips is not None and chips_tail.merge_kind(
        plan.chips.heavy_ids, A.m, plan.cfg.G_pad) == "ranked"
    assert plan.meta["tail_meta"]["panel_merge"]
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw)
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    for layout, core in (("rows", "lane_rows"), ("lanes", "lane_ell_spmv")):
        calls = preps[layout].kernel_calls(xf)
        y = getattr(lane_ell.PLAIN, core)(*[a for k, a in calls
                                            if k == core][0])
        assert y.shape[0] == (A.m if layout == "rows"
                              else plan.cfg.G_pad * BC)
    _check_layouts(A, to_numpy(preps["rows"].fn(xf)),
                   to_numpy(preps["lanes"].fn(xf)), "amazon60k landing")


def test_core_layout_is_checked():
    A, kw, _ = _small("banded512")
    with pytest.raises(ValueError, match="core_layout"):
        lane_ell.prepare_lane_ell_hybrid(A, device="cpu", core_layout="cols")
    with pytest.raises(ValueError, match="core_layout"):
        D.prepare_row_sharded_hybrid(A, mesh=["cpu"], core_layout="cols")


# ---- against the JAX hybrid (slow: the reference in interpret mode) -----------

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(cases.SMALL_CASES))
def test_hybrid_layouts_match_jax(name):
    A, kw, _ = _small(name)
    x = make_x(A.n)
    y_jax = np.asarray(jax_hybrid(JAX_CASES[name](), interpret=True,
                                  **kw).fn(x), np.float64)
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw)
    for layout, prep in preps.items():
        _check_layouts(A, to_numpy(prep.fn(x)), y_jax,
                       f"{layout} core on {name} against JAX")


@pytest.mark.slow
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", HYBRID_DIST)
def test_row_sharded_layouts_match_jax(name, k):
    _, make, kw = cases.DIST_CASES[name]
    if k < 4 and name.startswith("hybrid-chips"):
        kw = {**kw, "tail_kind": "auto"}     # no tail to force on 1-2 shards
    A = make(k)
    x = make_x(A.n)
    y_jax = np.asarray(JD.prepare_row_sharded_hybrid(
        make(k, jax_synth), mesh=_jax_mesh(k), interpret=True, **kw).fn(x),
        np.float64)
    preps = D.row_sharded_hybrid_layouts(A, mesh=["cpu"] * k, **kw)
    for layout, prep in preps.items():
        y = to_numpy(prep.fn(x))
        assert np.linalg.norm(y - y_jax) <= \
            VS_JAX_REL_L2 * np.linalg.norm(y_jax), (layout, k)
        validate_result(spmv_oracle(A, x), y, what=f"{name}, {k} shards, "
                        f"{layout} against JAX")

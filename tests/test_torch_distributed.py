"""The port's row-sharded SpMV (spmv_scpa_tpu_torch/parallel/distributed.py)
against the JAX package's (spmv_scpa_tpu/parallel/distributed.py), on
meshes of ``["cpu"] * k`` against the conftest's virtual JAX CPU devices.

Cases: the JAX package's own (tests/test_distributed.py, at their sizes
and shard counts) and the six routes of
``__graft_entry__.dryrun_multichip`` at its sizes for 2, 4 and 8 shards
(``bench/cases.py``'s ``DIST_CASES``; at 2 shards the two chips routes
are refused by both packages). Each side draws its matrix with its own
generator from the same seed.

Tolerances:
* the stacked host arrays (the reference's ``out.args``: planes, int8
  codes over the union strip sets, r0, ext tables, padded chips or split
  plans, merge tables, segment-sum tails, PELL tables on
  ``layout="tiles"``) and the meta: exact;
* the union strip sets: exact, read from the reference kernel's closure;
* the port's y (plain versions on the CPU, the default rows core and
  the PELL's default row layout) against the JAX y, once per route at 4
  shards (the Pallas kernels in interpret mode): rel-L2 <= 1e-6, except
  the PELL route, <= 1e-5: the reference's fused
  kernel reduces with two bf16 split passes (``precision_passes=2``, 16
  bits of each operand), 3.6e-6 from the fp64 oracle on this case, where
  the port's f32 sums are 6e-8 from it;
* every y against ``spmv_oracle``: ``validate_result`` defaults.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops import chips_tail as jax_ct
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_hybrid
from spmv_scpa_tpu.parallel import distributed as JD

from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops import chips_tail, lane_ell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.segsum_kernel import make_visit_masks
from spmv_scpa_tpu_torch.parallel import distributed as D
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-6
VS_JAX_PELL_REL_L2 = 1e-5

HYBRID = "prepare_row_sharded_hybrid"
PELL = "prepare_row_sharded_pell"
SEGSUM = "prepare_row_sharded"


def _jax_mesh(k):
    return JD.make_mesh(devices=jax.devices("cpu")[:k])


def _mesh(k):
    return D.make_mesh(devices=["cpu"] * k)


def _build(prep_fn, make, k, port_kw=None, **kw):
    """Both packages' prepared SpMV of ``make(module)`` on k shards;
    ``port_kw``: knobs of the port's alone."""
    jkw = dict(kw) if prep_fn == SEGSUM else {**kw, "interpret": True}
    jd = getattr(JD, prep_fn)(make(jax_synth), mesh=_jax_mesh(k), **jkw)
    A = make(synth)
    return jd, getattr(D, prep_fn)(A, mesh=_mesh(k), **kw,
                                   **(port_kw or {})), A


# the port's knobs of the parity tests that hold its arrays to the
# reference's: the PELL on the reference's tiles (its default is the row
# layout: tests/test_torch_dist_pell_rows.py)
PARITY = {PELL: {"layout": "tiles"}}


def _closure_value(fn, fname: str, var: str, seen=None):
    """Free variable ``var`` of the nested function ``fname`` reachable
    from ``fn`` through closures, ``functools.partial`` and
    ``__wrapped__`` (the reference keeps the union strip sets only in its
    kernel's closure, behind ``shard_map``)."""
    seen = set() if seen is None else seen
    if id(fn) in seen:
        return None
    seen.add(id(fn))
    inner = [getattr(fn, "__wrapped__", None)]
    if isinstance(fn, functools.partial):
        inner += [fn.func, *fn.args, *fn.keywords.values()]
    elif isinstance(fn, types.FunctionType):
        code = fn.__code__
        if code.co_name == fname and var in code.co_freevars:
            return fn.__closure__[code.co_freevars.index(var)].cell_contents
        for cell in fn.__closure__ or ():
            try:
                inner.append(cell.cell_contents)
            except ValueError:
                continue
    for obj in inner:
        if callable(obj):
            found = _closure_value(obj, fname, var, seen)
            if found is not None:
                return found
    return None


def assert_same_arrays(prep_fn, jd, pd):
    """The shards' stacked host arrays equal the reference's, and the
    meta (the hybrid's, without the port's per-shard ``tail_meta``,
    ``strip_sets`` and ``landing``)."""
    ja = [np.asarray(a) for a in jd.args]
    pa = list(pd.args)
    if prep_fn == PELL:
        # the reference ships the visit masks and, for superpanels, the
        # index split into strip and lane; the port one index
        base, pan, rbl, mask, vals, *rest = ja
        for want, got in zip((base, pan, rbl, vals), pa[:4]):
            np.testing.assert_array_equal(want, got)
        pa = pa[4:]
        if pa and pa[0].dtype in (np.int8, np.int16):
            lcol = rest.pop(0).astype(np.int64)
            if pd.meta["panel_w"] > 1:
                lcol += rest.pop(0).astype(np.int64) * 128
            np.testing.assert_array_equal(lcol, pa.pop(0))
        for want, got in zip(rest, pa, strict=True):
            np.testing.assert_array_equal(want, got)
        W, h = pd.meta["span"], pd.meta["window_h"]
        for d in range(base.shape[0]):
            vis = make_visit_masks(base[d], mask[d].size // (W * h), W, h)
            np.testing.assert_array_equal(vis, mask[d].reshape(vis.shape))
        return
    assert len(ja) == len(pa)
    for i, (want, got) in enumerate(zip(ja, pa)):
        assert want.dtype == got.dtype, i
        np.testing.assert_array_equal(want, got, err_msg=str(i))
    if prep_fn == HYBRID:
        meta = {k: v for k, v in pd.meta.items()
                if k not in ("tail_meta", "strip_sets", "landing")}
        assert meta == jd.meta
        used = _closure_value(jd.raw, "kernel", "used")
        assert used is not None and used == pd.meta["strip_sets"]


def _validate(A, pd, what):
    x = make_x(A.n)
    y = pd.fn(x)
    assert y.dtype == torch.float32 and y.shape == (A.m,)
    return validate_result(spmv_oracle(A, x), y.double().numpy(), what=what)


# ---- bench/cases.py's DIST_CASES: the dryrun routes ------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(cases.DIST_CASES))
def test_dryrun_routes_pack_like_the_reference(name, k):
    prep_fn, make, kw = cases.DIST_CASES[name]
    def mk(module):
        return make(k, module)
    if k == 2 and name.startswith("hybrid-chips"):
        # two shards of the dryrun's scattered matrix have no tail: both
        # packages refuse the forced chips routes
        with pytest.raises(ValueError, match="forced"):
            getattr(JD, prep_fn)(mk(jax_synth), mesh=_jax_mesh(k),
                                 interpret=True, **kw)
        with pytest.raises(ValueError, match="forced"):
            getattr(D, prep_fn)(mk(synth), mesh=_mesh(k), **kw)
        return
    jd, pd, A = _build(prep_fn, mk, k, PARITY.get(prep_fn), **kw)
    assert_same_arrays(prep_fn, jd, pd)
    _validate(A, pd, f"{name} on {k} shards")
    if name == "hybrid-chips-split":
        assert pd.meta["tail_kind"] == "chips-split"


@pytest.mark.parametrize("name", sorted(cases.DIST_CASES))
def test_dryrun_route_y_matches_jax(name):
    """The port's y (plain versions) against the JAX package's (Pallas in
    interpret mode), 4 shards."""
    prep_fn, make, kw = cases.DIST_CASES[name]
    jd, pd, A = _build(prep_fn, lambda module: make(4, module), 4, **kw)
    x = make_x(A.n)
    y = pd.fn(x).double().numpy()
    y_jax = np.asarray(jd.fn(x), dtype=np.float64)
    tol = VS_JAX_PELL_REL_L2 if prep_fn == PELL else VS_JAX_REL_L2
    assert np.linalg.norm(y - y_jax) <= tol * np.linalg.norm(y_jax)
    validate_result(spmv_oracle(A, x), y, what=f"{name}, 4 shards")


# ---- the JAX package's distributed cases -----------------------------------

def _gen(fn, **kw):
    return lambda module: getattr(module, fn)(**kw)


# name -> (prep_fn, matrix, shard counts, knobs): tests/test_distributed.py
REF_CASES = {
    "segsum-banded500": (SEGSUM, _gen("banded_csr", m=500, row_nnz=9,
                                      bandwidth=60, seed=6), (1, 2, 8), {}),
    "segsum-powerlaw600": (SEGSUM, _gen("powerlaw_csr", m=600, n=600,
                                        seed=12), (8,), {}),
    "segsum-diag5": (SEGSUM, _gen("diag_csr", m=5), (8,), {}),
    "pell-banded400": (PELL, _gen("banded_csr", m=400, row_nnz=9,
                                  bandwidth=60, runs=3, seed=8), (4,),
                       {"window_h": 128}),
    "pell-multiwin2048": (PELL, _gen("banded_csr", m=2048, row_nnz=9,
                                     bandwidth=60, runs=3, seed=9), (4,),
                          {"window_h": 8}),
    "pell-rowsort1200": (PELL, _gen("powerlaw_csr", m=1200, n=1200, seed=21),
                         (4,), {}),
    "pell-mesh1-banded512": (PELL, _gen("banded_csr", m=512, row_nnz=9,
                                        bandwidth=60, seed=13), (1,), {}),
    "hybrid-banded1200": (HYBRID, _gen("banded_csr", m=1200, row_nnz=11,
                                       bandwidth=90, seed=21), (1, 3, 8), {}),
    "hybrid-powerlaw900": (HYBRID, _gen("powerlaw_csr", m=900, n=900,
                                        seed=22), (4,), {}),
    "hybrid-diag5": (HYBRID, _gen("diag_csr", m=5), (8,), {}),
    "hybrid-webbase20k-chips": (HYBRID, _gen("webbase_csr", m=20000,
                                             seed=5), (8,), {}),
    "hybrid-amazon6k-chips": (HYBRID, _gen("amazon_csr", m=6000, seed=30),
                              (4,), {"tail_kind": "chips"}),
    "hybrid-amazon8k-xla": (HYBRID, _gen("amazon_csr", m=8000, seed=30),
                            (8,), {"tail_kind": "xla"}),
    "hybrid-amazon40k-ext": (HYBRID, _gen("amazon_csr", m=40_000, seed=11),
                             (1, 4), {}),
    "hybrid-amazon40k-noext": (HYBRID, _gen("amazon_csr", m=40_000,
                                            seed=11), (4,), {"ext": False}),
    "hybrid-banded6000-idx8": (HYBRID, _gen("banded_csr", m=6000, row_nnz=12,
                                            bandwidth=100, seed=2), (1, 4),
                               {"idx8": True}),
    "hybrid-amazon40k-idx8": (HYBRID, _gen("amazon_csr", m=40_000, seed=11),
                              (1, 4), {"idx8": True}),
    "hybrid-webbase20k-split": (HYBRID, _gen("webbase_csr", m=20000, seed=5),
                                (1, 4), {"tail_kind": "chips-split"}),
}


@pytest.mark.parametrize("name, k", [(name, k) for name, (_, _, ks, _)
                                     in sorted(REF_CASES.items())
                                     for k in ks])
def test_reference_cases_pack_like_the_reference(name, k):
    prep_fn, make, _, kw = REF_CASES[name]
    jd, pd, A = _build(prep_fn, make, k, PARITY.get(prep_fn), **kw)
    assert_same_arrays(prep_fn, jd, pd)
    _validate(A, pd, f"{name} on {k} shards")
    if prep_fn == HYBRID and "tail_kind" in kw:
        assert pd.meta["tail_kind"] == kw["tail_kind"]


# the kernels a call with ext panels and chips tails runs, by core layout:
# the rows core reads x in place, the ext gathers only build the lanes
# core's panels (the chips tails on chips_x="hot" gather on both; the
# slot products: tests/test_torch_chips_slots.py)
EXT_ROUTE = {"lanes": {"lane_ell_sharded", "sorted_gather", "ranked_gather",
                       "window_segsum"},
             "rows": {"lane_rows", "sorted_gather", "ranked_gather",
                      "window_segsum"}}


@pytest.mark.parametrize("layout", sorted(EXT_ROUTE))
def test_ext_panels_absorb_the_out_of_window_entries(layout):
    """The per-shard ext panels carry most out-of-window entries: the
    tail at 4 shards is under a quarter of the tail without them."""
    make = REF_CASES["hybrid-amazon40k-ext"][1]
    A = make(synth)
    on = D.prepare_row_sharded_hybrid(A, mesh=_mesh(4), core_layout=layout,
                                      chips_x="hot")
    off = D.prepare_row_sharded_hybrid(A, mesh=_mesh(4), ext=False,
                                       core_layout=layout, chips_x="hot")
    assert on.meta["ext"] and on.meta["ext_n_out"] > 0 and not off.meta["ext"]
    assert on.meta["tail_nnz"] < 0.25 * off.meta["tail_nnz"]
    calls = on.kernel_calls(torch.zeros(A.n))
    assert EXT_ROUTE[layout] <= {k for k, _ in calls}
    core = {"lanes": "lane_ell_sharded", "rows": "lane_rows"}[layout]
    assert [k for k, _ in calls].count(core) == 1


def test_ext_mixed_shards():
    """One purely banded shard (no ext plan: zero tables) beside a
    scattered one: the banded shard never selects its ext panel."""
    def make(module):
        B = module.banded_csr(8000, row_nnz=8, bandwidth=64, seed=31)
        S = module.amazon_csr(8000, seed=32)
        rows = np.concatenate([B.row_ids(), S.row_ids() + B.m])
        cols = np.concatenate([B.ja, S.ja % B.n])
        vals = np.concatenate([B.as_, S.as_])
        cls = JaxCSR if module is jax_synth else CSR
        return cls.from_coo("mixed", B.m + S.m, B.n, rows, cols, vals)
    jd, pd, A = _build(HYBRID, make, 2)
    assert_same_arrays(HYBRID, jd, pd)
    assert pd.meta["ext"]
    _validate(A, pd, "mixed ext shards")


def test_chips_scatter_fallback(monkeypatch):
    """Merge tables over budget on every shard: the heavy rows land by
    ``index_add_`` (the reference's scatter), heavy ids as shard data."""
    monkeypatch.setattr(jax_ct, "merge_tables", lambda *a, **k: None)
    monkeypatch.setattr(chips_tail, "merge_tables", lambda *a, **k: None)
    jd, pd, A = _build(HYBRID, _gen("amazon_csr", m=6000, seed=30), 4,
                       tail_kind="chips")
    assert_same_arrays(HYBRID, jd, pd)
    assert pd.meta["tail_kind"] == "chips" and not pd.meta["panel_merge"]
    _validate(A, pd, "chips scatter fallback")


@pytest.mark.parametrize("k", [1, 4])
def test_split_plans_when_single_plans_do_not_fit(k, monkeypatch):
    """Shard tails whose single plans do not fit ride unified split plans
    (forced by a single planner that fits nothing)."""
    monkeypatch.setattr(jax_ct, "_plan_single", lambda *a, **kw: None)
    monkeypatch.setattr(chips_tail, "_plan_single", lambda *a, **kw: None)
    jd, pd, A = _build(HYBRID, _gen("webbase_csr", m=20000, seed=5), k)
    assert_same_arrays(HYBRID, jd, pd)
    assert pd.meta["tail_kind"] == "chips-split"
    _validate(A, pd, f"split chips on {k} shards")


def test_forced_chips_without_a_tail_is_refused():
    A = synth.diag_csr(600)
    with pytest.raises(ValueError, match="tail_kind='chips'"):
        D.prepare_row_sharded_hybrid(A, mesh=_mesh(2), tail_kind="chips")


def test_shard_planner_matches_and_balances():
    for make, k in ((_gen("random_csr", m=100, n=100, density=0.05,
                          seed=2), 4),
                    (_gen("powerlaw_csr", m=600, n=600, seed=12), 8)):
        bounds, h = D.plan_row_shards(make(synth), k)
        jb, jh = JD.plan_row_shards(make(jax_synth), k)
        np.testing.assert_array_equal(bounds, jb)
        assert h == jh and bounds[0] == 0 and h >= max(np.diff(bounds))
    A = synth.powerlaw_csr(600, 600, seed=12)
    dist = D.prepare_row_sharded(A, mesh=_mesh(8))
    assert dist.shard_nnz.max() <= 2 * A.nnz / 8 + A.row_lengths().max()


# ---- the packer's row-shard mode -------------------------------------------

@pytest.mark.parametrize("kw", [
    {"x_off": 0},
    {"x_off": 640, "ext": "auto"},
], ids=["core-only", "x-off"])
def test_core_only_packs_like_the_reference(kw):
    """``pack_lane_ell(..., core_only=True)`` returns the reference's
    ``_CoreBuild`` arrays (a shard of the amazon archetype: ext panels,
    demotion, a tail)."""
    A = synth.amazon_csr(m=20000, seed=11).slice_rows(640, 12_160)
    jA = JaxCSR(A.name, A.m, A.n, A.irp, A.ja, A.as_)
    knobs = dict(chunk=24, loc_w=512, hot_k=0, ext_windowed=False,
                 core_only=True, **kw)
    core = lane_ell.pack_lane_ell(A, **knobs)
    jcore = jax_hybrid(jA, interpret=True, **knobs)
    for f in ("vals_a", "idx_a", "trows", "tcols", "tvals", "ext_base",
              "ext_p1", "ext_l1", "ext_p2", "ext_l2"):
        want, got = getattr(jcore, f), getattr(core, f)
        if want is None:
            assert got is None, f
        else:
            np.testing.assert_array_equal(want, got, err_msg=f)
    for f in ("used", "Q", "Qo", "QT", "S", "chunk", "steps", "G_pad",
              "P_pad", "loc_w", "n_local", "m", "n_demoted", "n_reloc",
              "ext_ng", "ext_n1p", "ext_cov", "ext_n_out"):
        assert getattr(jcore, f) == getattr(core, f), f
    assert core.ext_ng > 0 and core.trows.size > 0


def test_core_only_refuses_what_the_reference_asserts():
    A = synth.banded_csr(512, row_nnz=12, bandwidth=96, seed=7)
    with pytest.raises(AssertionError, match="hot_k=0"):
        lane_ell.pack_lane_ell(A, hot_k=128, core_only=True)
    with pytest.raises(AssertionError, match="ext_windowed=False"):
        lane_ell.pack_lane_ell(cases.ext_windowed40k(), hot_k=0,
                               core_only=True)


# ---- the mesh --------------------------------------------------------------

def test_make_mesh_takes_repeated_devices_and_never_falls_back():
    assert D.make_mesh(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        pytest.skip("a card is present; this pins the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.prepare_row_sharded_hybrid(synth.diag_csr(300), n_shards=2)


@pytest.mark.parametrize("layout", ["lanes", "rows"])
def test_shards_of_one_device_share_one_core_launch(layout):
    """Every shard on one device: one core call. On the lanes layout
    ``lane_ell_sharded`` with the stacked planes of all shards; on the
    rows layout ``lane_rows`` over the shards' rows, shard j's at
    ``j * h_rows``."""
    A = synth.banded_csr(1200, row_nnz=11, bandwidth=90, seed=21)
    pd = D.prepare_row_sharded_hybrid(A, mesh=_mesh(3), core_layout=layout)
    calls = pd.kernel_calls(torch.as_tensor(make_x(A.n),
                                            dtype=torch.float32))
    if layout == "rows":
        assert [k for k, _ in calls] == ["lane_rows"]
        qptr, x = calls[0][1][3], calls[0][1][5]
        h_rows = max(int(np.diff(pd.bounds).max()), 128)
        assert qptr.numel() == 3 * h_rows + 1 and x.numel() == A.n
        return
    assert [k for k, _ in calls] == ["lane_ell_sharded"]
    xpad, r0, vals = calls[0][1][:3]
    cfg = calls[0][1][-1]
    assert vals.shape[0] == 3
    np.testing.assert_array_equal(r0.numpy(), pd.bounds[:-1])
    assert xpad.numel() == pd.meta["loc_w"] + A.n + cfg.P_pad * 128


def test_sharded_wrapper_checks_its_arguments():
    A = synth.banded_csr(1200, row_nnz=11, bandwidth=90, seed=21)
    pd = D.prepare_row_sharded_hybrid(A, mesh=_mesh(2), core_layout="lanes")
    (name, args), = pd.kernel_calls(torch.zeros(A.n))
    xpad, r0, vals, idx8, idx16, tabs, ext, cfg = args
    fn = lane_ell.lane_ell_sharded
    assert torch.equal(fn(*args), lane_ell.lane_ell_sharded_plain(*args))
    with pytest.raises(ValueError, match="vals"):
        fn(xpad, r0, vals.double(), idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="r0"):
        fn(xpad, r0.long(), vals, idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="xpad"):
        fn(xpad[:10], r0, vals, idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="ext"):
        fn(xpad, r0, vals, idx8, idx16, tabs,
           torch.zeros(2, cfg.G_pad, 128), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fn(xpad, r0, vals.transpose(1, 2).contiguous().transpose(1, 2),
           idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="x has shape"):
        pd.fn(np.ones(A.n + 1))

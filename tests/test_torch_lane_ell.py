"""The port's lane-ELL hybrid (spmv_scpa_tpu_torch/ops/lane_ell.py)
against the JAX package's ``prepare_lane_ell_hybrid``, run in interpret
mode on the CPU as tests/test_lane_ell.py runs it. Each side builds its
matrix with its own generator from the same seed. The CUDA kernels
themselves are held against their plain versions in
tests/test_torch_cuda.py.

The cases are ``bench/cases.py``'s small cases: the core's branches,
and ``amazon60k`` (ext panels with the resident stage 2, a chips tail
that the reference lands through its ranked merge) and
``ext-windowed40k`` (the windowed stage 2). Each case is packed once and bound on both core layouts:
``"rows"`` (the default, ``ops/lane_rows.py``) and ``"lanes"`` (the
reference's planes, whose meta and bytes are the reference's; the rows
layout's own tests: tests/test_torch_lane_rows.py).

Tolerances:
* packed arrays, gather tables and meta against JAX: exact equality
  (the packer and planners are copies and keep the reference's cost
  models);
* the port's plain y against the JAX hybrid's y, on both layouts:
  rel-L2 <= 1e-6 and, per row, |dy| <= 1e-5 * (|A||x|)_row. The lanes
  core sums the planes in the same order in f32 and the gathers move
  values exactly; the slack covers XLA's possible mul-add contraction,
  the compact tail's summation order, and the chips tail's segment-sum,
  which JAX runs as a one-hot matmul with b split in three bf16 terms
  (f32-grade: the three terms carry 24 bits of b) while the port adds
  the f32 partials; the rows core reassociates each row's f32 sum (a
  tree over quanta), within the same slack;
* everything against ``spmv_oracle``: ``validate_result`` defaults.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_prepare

from spmv_scpa_tpu_torch import spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES as CASES
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import chips_tail, lane_ell, lane_rows
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import pick_auto, to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x
from test_torch_fp64 import _closure_value

PLAIN_VS_JAX_REL_L2 = 1e-6
PLAIN_VS_JAX_ROW = 1e-5


def _jax_ext_windowed40k():
    """The JAX side of ``bench.cases.ext_windowed40k``: the same draws,
    built with the JAX package's CSR."""
    rng = np.random.default_rng(9)
    m = n = 40000
    r_loc = np.repeat(np.arange(m, dtype=np.int64), 4)
    c_loc = (r_loc + rng.integers(-30, 30, r_loc.size)) % n
    r_out = np.arange(m, dtype=np.int64)
    c_out = (r_out + 8000 + rng.integers(0, 64, m)) % n
    rows = np.concatenate([r_loc, r_out])
    cols = np.concatenate([c_loc, c_out])
    vals = rng.standard_normal(rows.size)
    return JaxCSR.from_coo("ext_windowed", m, n, rows, cols, vals)


def _jax_stencil4k():
    return jax_synth.stencil_csr(4000, points=6, run_len=8, bandwidth=300,
                                 seed=2)


# each small case's matrix built by the JAX package's generator
JAX_CASES = {
    "banded512": lambda: jax_synth.banded_csr(512, row_nnz=12, bandwidth=96,
                                              runs=3, seed=7),
    "stencil4k": _jax_stencil4k,
    "stencil4k-idx8": _jax_stencil4k,
    "stencil4k-dyn": _jax_stencil4k,
    "amazon20k": lambda: jax_synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4),
    "amazon60k": lambda: jax_synth.amazon_csr(m=60000, seed=6),
    "ext-windowed40k": _jax_ext_windowed40k,
}


def test_jax_cases_cover_the_small_cases():
    assert set(JAX_CASES) == set(CASES)


@functools.cache
def _port(name):
    """One small case's matrix, knobs, packed plan and CPU-bound
    ``cuda-hybrid`` on each core layout ({layout: Prepared}, one pack),
    built once for the whole module (the tests do not mutate them). The
    chips tail's slot products: tests/test_torch_chips_slots.py; its
    landing: tests/test_torch_landing.py."""
    make, kw = CASES[name]
    A = make()
    return (A, kw, lane_ell.pack_lane_ell(A, **kw),
            lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    A, kw, plan, prep = _port(request.param)
    A_jax = JAX_CASES[request.param]()
    np.testing.assert_array_equal(A.ja, A_jax.ja)
    np.testing.assert_array_equal(A.as_, A_jax.as_)
    x = make_x(A.n)
    jprep = jax_prepare(A_jax, interpret=True, **kw)
    y_jax = np.asarray(jprep.fn(x), dtype=np.float64)
    return request.param, A, kw, x, jprep, y_jax, plan, prep


def _jax_arrays(jprep, plan):
    """The JAX Prepared's args by role (lane_ell.py:1398-1528): the core's
    (vals, idx streams, hot, ext tables, dynamic strips), then the
    tail's (chips pipeline and its merge tables, or the compact tail). The
    idx streams are mapped by n8/n16: idx16 is absent when n8 == QT
    (lane_ell.py:1270-1274)."""
    args = [np.asarray(a) for a in jprep.args]
    out = {"vals": args[0]}
    i = 1

    def take(*names):
        nonlocal i
        for name in names:
            out[name] = args[i]
            i += 1

    if plan.n8:
        take("idx8")
    if plan.QT - plan.n8 or not plan.n8:
        take("idx16")
    take("hot")
    if plan.ext is not None:
        take("e_base", "e_p1", "e_l1", "e_p2", "e_l2")
        if plan.ext.windowed:
            take("e_b8")
    if plan.cfg.TD:
        take("dynw")
    if plan.chips is not None:
        take("c_base", "c_p1", "c_l1", "c_p2", "c_l2", "c_vals", "c_rbl",
             "c_hid", "c_win")
        kind = chips_tail.merge_kind(plan.chips.heavy_ids, plan.m,
                                     plan.cfg.G_pad)
        take(*{"windowed": ("m_b8", "m_p2", "m_l2"),
               "ranked": ("m_p2", "m_l2"), "scatter": ()}[kind])
    elif plan.trows.size:
        take("seg", "tc", "tv", "ridx")
    assert i == len(args)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_plan_arrays_match_jax(case):
    name, A, kw, _, jprep, _, plan, _ = case
    ja = _jax_arrays(jprep, plan)
    np.testing.assert_array_equal(plan.vals_a, ja["vals"])
    if plan.n8:
        np.testing.assert_array_equal(plan.idx8_a, ja["idx8"])
    else:
        assert plan.idx8_a.size == 0
    if "idx16" in ja:
        np.testing.assert_array_equal(plan.idx_a, ja["idx16"])
    else:
        assert plan.idx_a.size == 0
    np.testing.assert_array_equal(plan.hot_idx, ja["hot"])
    if plan.cfg.TD:
        np.testing.assert_array_equal(plan.dynw_a, ja["dynw"])
    else:
        assert plan.dynw_a.size == 0
    ep = plan.ext
    if ep is not None:
        for mine, key in ((ep.base, "e_base"), (ep.p1, "e_p1"),
                          (ep.l1, "e_l1"), (plan.ext_p2, "e_p2"),
                          (plan.ext_l2, "e_l2")):
            np.testing.assert_array_equal(mine, ja[key], err_msg=key)
        if ep.windowed:
            np.testing.assert_array_equal(plan.ext_b8, ja["e_b8"])
        assert plan.cfg.ext_w == plan.cfg.S + plan.cfg.Hs
    else:
        assert plan.cfg.ext_w == -1
    cp = plan.chips
    if cp is not None:
        for mine, key in ((cp.base, "c_base"), (cp.p1, "c_p1"),
                          (cp.l1, "c_l1"), (cp.p2, "c_p2"), (cp.l2, "c_l2"),
                          (cp.vals, "c_vals"), (cp.rbl, "c_rbl"),
                          (cp.heavy_ids, "c_hid"),
                          (cp.win_of_step, "c_win")):
            np.testing.assert_array_equal(mine, ja[key], err_msg=key)
    elif plan.trows.size:
        np.testing.assert_array_equal(plan.tcols, ja["tc"])
        np.testing.assert_array_equal(plan.tvals.astype(np.float32),
                                      ja["tv"])
        np.testing.assert_array_equal(plan.trows, ja["ridx"][ja["seg"]])


def test_plan_meta_matches_jax(case):
    """The lanes layout's meta is the reference's, and its bytes but
    where a chips tail runs the slot products and ``heavy_land`` in place
    of the reference's gathers and merge; the rows layout keeps the
    packer's meta (its bytes: test_torch_lane_rows)."""
    name, A, kw, _, jprep, _, plan, preps = case
    prep = preps["lanes"]
    want = dict(jprep.meta)
    if want["tail_kind"] == "xla-compact":
        want["tail_kind"] = "torch-compact"
    assert prep.meta == want
    if plan.chips is None:
        assert prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == "pallas-hybrid"
    assert preps["rows"].meta == want and preps["rows"].ref == prep.ref


def test_plain_y_matches_jax_and_oracle(case):
    name, A, kw, x, _, y_jax, _, preps = case
    absA = CSR(A.name, A.m, A.n, A.irp, A.ja, np.abs(A.as_))
    gold = spmv_oracle(A, x)
    for layout, prep in preps.items():
        before = (lane_ell.KERNEL_LAUNCHES, dict(lane_rows.LAUNCHES))
        y = to_numpy(prep.fn(x))
        # CPU: plain versions
        assert (lane_ell.KERNEL_LAUNCHES, lane_rows.LAUNCHES) == before
        assert _rel_l2(y, y_jax) <= PLAIN_VS_JAX_REL_L2, layout
        assert np.all(np.abs(y - y_jax)
                      <= PLAIN_VS_JAX_ROW * spmv_oracle(absA, np.abs(x)))
        validate_result(gold, y, what=f"port cuda-hybrid (plain, "
                        f"{layout}) on {name}")
    validate_result(gold, y_jax, what=f"pallas-hybrid on {name}")


def test_plane_tabs_decode_the_strip_sets(case):
    plan = case[6]
    tabs = plan.plane_tabs()
    assert tabs.shape == (plan.QT, 2) and tabs.dtype == np.int32
    for q, u in enumerate(plan.used):
        if q < plan.n8:
            assert len(u) <= 2 and all(w >= 0 for w in u)
            if u:
                assert (tabs[q, 0], tabs[q, 1]) == (u[0], u[-1])
        else:
            assert tabs[q, 0] == plan.dyn_off.get(q, 0)


def test_plan_strip_sets_match_jax(case):
    """The packer's per-plane strip sets (dynamic slots as -1..-K) are
    the reference kernel's ``used``, which it keeps only in the kernel's
    closure."""
    jprep, plan = case[4], case[6]
    used = _closure_value(jprep.raw, "kernel", "used")
    assert used is not None and plan.used == used


PAIRS_S = 5


def _pairs_input(kind):
    """(planes, strips, nw, planes in the table) of one strip_pairs case."""
    rng = np.random.default_rng(11)
    S, Hs = PAIRS_S, 3
    nw = S + Hs + 1                      # local, hot and the ext strip
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), nw, 4
    if kind == "one-plane":
        return np.zeros(500, np.int64), rng.integers(0, S, 500), nw, 1
    q = rng.integers(0, 40, 20000)
    w = rng.integers(0, nw, 20000)
    w[:3] = nw - 1                       # the ext strip, and hot ones
    if kind == "hot-and-ext":
        return q, w, nw, 40
    if kind == "dyn-local-excluded":
        # a dynamic plane's local entries are left out by a mask, and a
        # left-out strip may lie outside the table
        w[np.flatnonzero(np.isin(q, [3, 17]) & (w < S))[:5]] = nw + 5
        return q, w, nw, 40
    if kind == "strip-past-nw":
        w[7] = nw
        return q, w, nw, 40
    if kind == "plane-past-table":
        q[7] = 40
        return q, w, nw, 40
    assert kind == "negative-plane"
    q[7] = -1
    return q, w, nw, 40


OUT_OF_TABLE = ("strip-past-nw", "plane-past-table", "negative-plane")


@pytest.mark.parametrize("slice_", [lane_ell.PAIR_SLICE, 777])
@pytest.mark.parametrize("kind", ["empty", "one-plane", "hot-and-ext",
                                  "dyn-local-excluded", *OUT_OF_TABLE])
def test_strip_pairs_is_the_sorted_unique(kind, slice_, monkeypatch):
    """The dense table gives the 2-D unique's pairs in its order, and the
    1-D unique's keys and counts, read in one slice or in many; a key
    outside the table raises rather than wrapping onto another plane's
    strip."""
    monkeypatch.setattr(lane_ell, "PAIR_SLICE", slice_)
    q, w, nw, n_q = _pairs_input(kind)
    if kind in OUT_OF_TABLE:
        with pytest.raises(ValueError, match="outside"):
            lane_ell.strip_pairs(q, w, nw, n_q)
        return
    where = None
    if kind == "dyn-local-excluded":
        where = ~(np.isin(q, [3, 17]) & (w < PAIRS_S)) & (w < nw)
        keys, cnt = lane_ell.strip_pairs(q, w, nw, n_q, where=where)
        q, w = q[where], w[where]
    else:
        keys, cnt = lane_ell.strip_pairs(q, w, nw, n_q)
    want = np.unique(np.stack([q, w]), axis=1)
    np.testing.assert_array_equal(np.stack([keys // nw, keys % nw]), want)
    want_k, want_c = np.unique(q * nw + w, return_counts=True)
    assert keys.dtype == want_k.dtype and cnt.dtype == want_c.dtype
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(cnt, want_c)
    if kind == "dyn-local-excluded":
        assert all(k % nw >= PAIRS_S for k in keys if k // nw in (3, 17))


# the kernels one call of each case runs, in order, on each core layout:
# the rows core reads x in place, without the ext route's gathers
KERNEL_ROUTES = {
    "lanes": {
        "amazon60k": ["sorted_gather", "ranked_gather", "lane_ell_spmv",
                      "chips_products", "window_segsum", "heavy_land"],
        "ext-windowed40k": ["sorted_gather", "window_gather",
                            "lane_ell_spmv"],
        "banded512": ["lane_ell_spmv"],
    },
    "rows": {
        "amazon60k": ["lane_rows", "chips_products", "window_segsum",
                      "heavy_land"],
        "ext-windowed40k": ["lane_rows"],
        "banded512": ["lane_rows"],
    },
}
CORE_KERNEL = {"lanes": "lane_ell_spmv", "rows": "lane_rows"}


@pytest.mark.parametrize("layout", sorted(KERNEL_ROUTES))
@pytest.mark.parametrize("name", sorted(KERNEL_ROUTES["lanes"]))
def test_kernel_calls_follow_the_route(name, layout):
    A, _, _, preps = _port(name)
    prep = preps[layout]
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    calls = prep.kernel_calls(xf)
    assert [c[0] for c in calls] == KERNEL_ROUTES[layout][name]
    ops = lane_ell.KERNELS
    for kname, args in calls:           # each call replays alone
        out = getattr(ops, kname)(*args)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
    kernel = getattr(ops, CORE_KERNEL[layout])
    core = [a for k, a in calls if k == CORE_KERNEL[layout]][0]
    assert torch.equal(kernel(*core), kernel(*prep.kernel_inputs(xf)))


def test_ext_strip_reads_the_group_panel():
    """A slot whose strip is ``ext_w`` reads lane ``code & 127`` of its
    group's ext panel, whatever lies in the padded x."""
    A, _, _, preps = _port("ext-windowed40k")
    prep = preps["lanes"]
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    xpad, vals, idx8, idx16, tabs, dynw, ext, cfg = prep.kernel_inputs(xf)
    assert cfg.ext_w >= 0 and ext.shape == (cfg.G_pad, BC)
    y = lane_ell.lane_ell_spmv(xpad, vals, idx8, idx16, tabs, dynw, ext, cfg)
    y0 = lane_ell.lane_ell_spmv(xpad, vals, idx8, idx16, tabs, dynw,
                                torch.zeros_like(ext), cfg)
    y_noise = lane_ell.lane_ell_spmv(xpad, vals, idx8, idx16, tabs, dynw,
                                     ext + 1.0, cfg)
    assert not torch.equal(y, y0)       # the panels carry the ext entries
    # a unit shift of every panel adds each row's ext values' sum
    code = idx16.view(cfg.steps, -1, cfg.chunk, BC).to(torch.int64)
    is_ext = (code >> 7) == cfg.ext_w
    v = vals.view(cfg.steps, cfg.QT, cfg.chunk, BC)[:, cfg.n8:]
    shift = (v * is_ext).sum(1).reshape(-1)
    torch.testing.assert_close(y_noise - y, shift, rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    A, _, _, preps = _port("amazon20k")
    prep = preps["lanes"]
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    args = prep.kernel_inputs(xf)
    before = lane_ell.KERNEL_LAUNCHES
    y = lane_ell.lane_ell_spmv(*args)
    assert lane_ell.KERNEL_LAUNCHES == before
    assert torch.equal(y, lane_ell.lane_ell_spmv_plain(*args))
    assert y.shape == (args[-1].G_pad * 128,)


def test_wrapper_rejects_wrong_dtype_and_shape():
    A, _, _, preps = _port("banded512")
    prep = preps["lanes"]
    xpad, vals, idx8, idx16, tabs, dynw, ext, cfg = prep.kernel_inputs(
        torch.zeros(A.n))
    with pytest.raises(ValueError, match="vals"):
        lane_ell.lane_ell_spmv(xpad, vals.double(), idx8, idx16, tabs,
                               dynw, ext, cfg)
    with pytest.raises(ValueError, match="xpad"):
        lane_ell.lane_ell_spmv(xpad[:-1], vals, idx8, idx16, tabs, dynw,
                               ext, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        lane_ell.lane_ell_spmv(xpad, vals.t().contiguous().t(), idx8,
                               idx16, tabs, dynw, ext, cfg)
    with pytest.raises(ValueError, match="ext"):
        lane_ell.lane_ell_spmv(xpad, vals, idx8, idx16, tabs, dynw,
                               torch.zeros(cfg.G_pad, BC), cfg)
    with pytest.raises(ValueError, match="x has shape"):
        prep.fn(np.ones(A.n + 1))


# a big tail through BCSR, a strategy that serves big tails since the
# port took every name the reference's compact branch runs
BIG_TAIL_BCSR = {"ext": False, "diag": "nochips", "tail_xla_max": 1000,
                 "tail_strategy": "pallas-bcsr"}


@pytest.mark.parametrize("make, kw, what", [
    # the escape to PELL with an x past its resident bound: the row
    # layout reads x in place, the tiles take the reference's stripes
    (lambda s: s.random_csr(2000, 3_200_000, density=1e-6, seed=4), {},
     "PELL column stripes"),
    (lambda s: s.amazon_csr(m=20000, avg_nnz=4.7, seed=4), BIG_TAIL_BCSR,
     "big tails"),
], ids=["no-locality", "big-tail"])
def test_missing_branches_raise_not_implemented(make, kw, what):
    """The two branches that raised ``NotImplementedError`` before the
    port had them (``what``), now held against the JAX hybrid on the
    same inputs: the no-locality escape of a 3.2M-column matrix to
    ``cuda-pell`` (the reference stripes its columns: 3 stripes), and a
    3,091-entry big tail through ``pallas-bcsr``. y within rel-L2 1e-5
    of the JAX y (its fused PELL adds in bf16 split passes) and
    ``validate_result`` of the oracle, on the default layouts and on the
    reference's (``pell_layout="tiles"``: the stripes, the dense
    tiles)."""
    A, A_jax = make(synth), make(jax_synth)
    np.testing.assert_array_equal(A.ja, A_jax.ja)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    jprep = jax_prepare(A_jax, interpret=True, **kw)
    y_jax = np.asarray(jprep.fn(x), np.float64)
    for layout in ("auto", "tiles"):
        prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu",
                                                pell_layout=layout, **kw)
        y = to_numpy(prep.fn(x))
        assert np.linalg.norm(y - y_jax) <= 1e-5 * np.linalg.norm(y_jax)
        validate_result(gold, y, what=f"{what} ({layout})")
        if what == "big tails":
            assert prep.meta["tail_kind"] == (
                "compact-cuda-bcsr" if layout == "tiles"
                else "compact-cuda-bcsr-bits")
            assert jprep.meta["tail_kind"] == "compact-pallas-bcsr"
        elif layout == "tiles":
            assert prep.meta["delegated"] == "cuda-pell"
            for k in ("stripes", "num_blocks", "fill", "window_h"):
                assert prep.meta[k] == jprep.meta[k], k
            assert prep.meta["stripes"] == 3
        else:
            assert (prep.meta["layout"], prep.meta["stripes"]) == ("rows", 0)


@pytest.mark.parametrize("tail", ["pallas-pell-df64", "pallas-hybrid-df64",
                                  "xla-ell-df64"])
def test_fp64_big_tail_is_refused_at_prepare(tail):
    """An fp64-grade big tail cannot land in the f32 core's y: a
    ValueError at prepare time (the reference prepares it and fails at
    its first call with a TypeError, lane_ell.py:1569-1581). A tail
    under ``tail_xla_max`` never reaches the big-tail branch."""
    A = synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4)
    kw = {"ext": False, "diag": "nochips", "tail_strategy": tail}
    with pytest.raises(ValueError, match="fp64 tail cannot land"):
        lane_ell.prepare_lane_ell_hybrid(A, device="cpu", tail_xla_max=1000,
                                         **kw)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device="cpu", **kw)
    assert prep.meta["tail_kind"] == "torch-compact"


def test_auto_does_not_swallow_not_implemented():
    """Where ``spmv``'s auto route raised ``NotImplementedError`` (a big
    tail through ``pallas-bcsr``), it now answers: the hybrid with a
    compact BCSR tail, y equal to the strategy's named call and within
    ``validate_result`` of the oracle."""
    A = synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4)
    assert pick_auto(A) == "cuda-hybrid"
    x = make_x(A.n)
    y = spmv(A, x, "auto", device="cpu", **BIG_TAIL_BCSR)
    validate_result(spmv_oracle(A, x), y, what="spmv auto, BCSR tail")
    np.testing.assert_array_equal(
        y, spmv(A, x, "cuda-hybrid", device="cpu", **BIG_TAIL_BCSR))


def test_resident_x_refusal_stays_a_value_error(monkeypatch):
    monkeypatch.setattr(lane_ell, "X_VMEM_BUDGET", 1024)
    with pytest.raises(ValueError, match="resident x"):
        lane_ell.prepare_lane_ell_hybrid(CASES["banded512"][0](),
                                         device="cpu")


def test_prepare_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this pins the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lane_ell.prepare_lane_ell_hybrid(CASES["banded512"][0]())

"""The port's ext gather route (spmv_scpa_tpu_torch/ops/ext_gather.py)
against the JAX package's (spmv_scpa_tpu/ops/ext_gather.py): the host
planner's plan and tables, exactly, on the hybrid's small ext cases and
on the constructions of tests/test_ext_gather.py; and each gather's
plain version against the Pallas kernel it replaces, run in interpret
mode, exactly, out-of-range indices included. The gathers move values
without arithmetic, so exact equality is the tolerance. The CUDA
kernels are held against these plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import ext_gather as jax_eg

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import ext_gather as eg

PLAN_FIELDS = ("n_groups", "H", "R", "n1p_blocks", "base", "p1", "l1",
               "pair_grp", "pair_lane", "pair_key", "pair_pos", "ext_lane",
               "covered", "n_out", "windowed", "r_hot", "base8", "H_pad")


def _out_of_window(A, loc_w):
    """(rows, cols, out_mask) as the hybrid's packer hands them to the
    planner for a diagonal window of ``loc_w``."""
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    S = 1 + 2 * (loc_w // BC)
    off = cols - (rows // BC) * BC + loc_w
    return rows, cols, ~((off >= 0) & (off < S * BC))


def _covers_and_caps():
    rng = np.random.default_rng(2)
    m = n = 2000
    rows = np.sort(rng.integers(0, m, 5000))
    cols = rng.integers(0, n, 5000)
    return rows, cols, np.ones(5000, bool), m, n


def _windowed():
    rng = np.random.default_rng(3)
    m = n = 40000
    rows = np.arange(m, dtype=np.int64)
    cols = (rows + 8000 + rng.integers(0, 64, m)) % n
    return rows, cols, np.ones(m, bool), m, n


def _amazon60k():
    A = cases.SMALL_CASES["amazon60k"][0]()
    A_jax = jax_synth.amazon_csr(m=60000, seed=6)
    np.testing.assert_array_equal(A.ja, A_jax.ja)
    return (*_out_of_window(A, 512), A.m, A.n)


def _ext_windowed40k():
    A = cases.ext_windowed40k()
    return (*_out_of_window(A, 128), A.m, A.n)


PLANNER_CASES = {"covers-and-caps": _covers_and_caps, "windowed": _windowed,
                 "amazon60k": _amazon60k,
                 "ext-windowed40k": _ext_windowed40k}


@pytest.fixture(scope="module", params=sorted(PLANNER_CASES))
def planner_case(request):
    return request.param, PLANNER_CASES[request.param]()


@pytest.mark.parametrize("allow_windowed", [True, False])
def test_plan_ext_matches_jax(planner_case, allow_windowed):
    name, (rows, cols, mask, m, n) = planner_case
    mine = eg.plan_ext(rows, cols, mask, m, n, allow_windowed=allow_windowed)
    want = jax_eg.plan_ext(rows, cols, mask, m, n,
                           allow_windowed=allow_windowed)
    assert (mine is None) == (want is None)
    if want is None:
        return
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(want, f),
                                      err_msg=f)
    if name in ("windowed", "ext-windowed40k") and allow_windowed:
        assert mine.windowed
    G_pad = -(-(int(rows.max()) // BC + 1) // 8) * 8
    for got, exp in zip(eg.build_group_tables(mine, G_pad),
                        jax_eg.build_group_tables(want, G_pad)):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(eg.build_base8(mine, G_pad),
                                  jax_eg.build_base8(want, G_pad))


def test_plan_ext_empty_and_constants():
    empty = np.zeros(0, np.int64)
    assert eg.plan_ext(empty, empty, np.zeros(0, bool), 10, 10) is None
    for c in ("R_PANELS", "H_MAX", "H_WIN_MIN", "H_WIN_CAP"):
        assert getattr(eg, c) == getattr(jax_eg, c), c


def test_the_two_stages_reproduce_x(planner_case):
    """Through the plain gathers, each kept entry's (group, lane) slot of
    the ext panels holds x at the entry's column."""
    _, (rows, cols, mask, m, n) = planner_case
    plan = eg.plan_ext(rows, cols, mask, m, n)
    G_pad = -(-(int(rows.max()) // BC + 1) // 8) * 8
    p2, l2 = eg.build_group_tables(plan, G_pad)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    x1 = torch.zeros(plan.n1p_blocks * plan.R * BC)
    x1[:n] = torch.as_tensor(x)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32)   # noqa: E731
    hot = eg.sorted_gather(t(plan.base), x1.view(-1, BC), t(plan.p1),
                           t(plan.l1), plan.R)
    if plan.windowed:
        hp = torch.zeros(plan.H_pad, BC)
        k = min(plan.H_pad, hot.shape[0])
        hp[:k] = hot[:k]
        ext = eg.window_gather(t(eg.build_base8(plan, G_pad)), hp, t(p2),
                               t(l2), plan.r_hot)
    else:
        ext = eg.ranked_gather(hot, t(p2), t(l2))
    ki = np.flatnonzero(plan.ext_lane >= 0)
    got = ext.numpy()[rows[ki] // BC, plan.ext_lane[ki]]
    np.testing.assert_array_equal(got, x[cols[ki]])


# ---- the gathers against the Pallas kernels (interpret mode) ---------------

def _tables(rng, rows, P):
    """p, l (rows, 128) int32 with p out of range in row 0: -1, P and
    P + 5 (the windowed merge points unset lanes at p = R_h)."""
    p = rng.integers(0, P, (rows, BC)).astype(np.int32)
    l = rng.integers(0, BC, (rows, BC)).astype(np.int32)
    p[0, :3] = (-1, P, P + 5)
    return p, l


def _t(a):
    return torch.as_tensor(a)


def test_sorted_gather_matches_pallas():
    rng = np.random.default_rng(0)
    R, n_groups, n1p = 8, 3, 4
    x1 = rng.standard_normal((n1p * R, BC)).astype(np.float32)
    base = np.array([0, 3, 2], np.int32)
    p1, l1 = _tables(rng, n_groups * 8, R)
    call = jax_eg.make_sorted_gather(n_groups, n1p, R, jnp.float32,
                                     interpret=True)
    want = np.asarray(call(jnp.asarray(base), jnp.asarray(x1),
                           jnp.asarray(p1), jnp.asarray(l1)))
    got = eg.sorted_gather_plain(_t(base), _t(x1), _t(p1), _t(l1), R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :3] == 0).all()


def test_ranked_gather_matches_pallas():
    rng = np.random.default_rng(1)
    H, G = 40, 24
    hot = rng.standard_normal((H, BC)).astype(np.float32)
    p2, l2 = _tables(rng, G, H)
    call = jax_eg.make_ranked_gather(H, G, jnp.float32, interpret=True)
    want = np.asarray(call(jnp.asarray(hot), jnp.asarray(p2),
                           jnp.asarray(l2)))
    got = eg.ranked_gather_plain(_t(hot), _t(p2), _t(l2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :3] == 0).all()


def test_window_gather_matches_pallas():
    rng = np.random.default_rng(2)
    G, R_h, H_pad = 32, 16, 64
    hot = rng.standard_normal((H_pad, BC)).astype(np.float32)
    base8 = rng.integers(0, (H_pad - R_h) // 8 + 1, G).astype(np.int32)
    p, l = _tables(rng, G, R_h)
    call = jax_eg.make_resident_window_gather(G // 8, R_h, H_pad,
                                              jnp.float32, interpret=True)
    want = np.asarray(call(jnp.asarray(base8), jnp.asarray(hot),
                           jnp.asarray(p), jnp.asarray(l)))
    got = eg.window_gather_plain(_t(base8), _t(hot), _t(p), _t(l), R_h)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :3] == 0).all()


def test_gathers_zero_out_of_range_lanes_and_rows():
    """Beyond the TPU's rule (p outside its range gathers 0): a lane
    outside [0, 128) or a row past the source also gathers 0, so no
    index reads out of bounds."""
    hot = torch.arange(16 * BC, dtype=torch.float32).view(16, BC) + 1
    p = torch.zeros(8, BC, dtype=torch.int32)
    l = torch.zeros(8, BC, dtype=torch.int32)
    l[0, :2] = torch.tensor([-1, BC])
    out = eg.ranked_gather(hot, p, l)
    assert (out[0, :2] == 0).all() and (out[0, 2:] == 1).all()
    base8 = torch.full((8,), 2, dtype=torch.int32)      # rows 16.. : none
    assert (eg.window_gather(base8, hot, p, l, 8) == 0).all()


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(4)
    hot = _t(rng.standard_normal((16, BC)).astype(np.float32))
    p, l = (_t(a) for a in _tables(rng, 8, 16))
    before = dict(eg.LAUNCHES)
    out = eg.ranked_gather(hot, p, l)
    assert eg.LAUNCHES == before
    assert torch.equal(out, eg.ranked_gather_plain(hot, p, l))


@pytest.mark.parametrize("bad, match", [
    (lambda h, p, l: (h.double(), p, l), "source"),
    (lambda h, p, l: (h, p.long(), l), "p2"),
    (lambda h, p, l: (h, p, l[:4]), "l2"),
    (lambda h, p, l: (h.t().contiguous().t(), p, l), "contiguous"),
    (lambda h, p, l: (h[:, :64], p, l), "source"),
])
def test_wrappers_reject_bad_arguments(bad, match):
    hot = torch.zeros(16, BC)
    p = torch.zeros(8, BC, dtype=torch.int32)
    l = torch.zeros(8, BC, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        eg.ranked_gather(*bad(hot, p, l))


def test_sorted_gather_wants_whole_groups():
    x1 = torch.zeros(8, BC)
    p = torch.zeros(12, BC, dtype=torch.int32)
    with pytest.raises(ValueError):
        eg.sorted_gather(torch.zeros(1, dtype=torch.int32), x1, p, p, 8)

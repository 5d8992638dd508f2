"""XPOSE's stage S1 over a host slot table (spmv_scpa_tpu_torch/ops/
xpose.py: ``s1_slots_table``, ``xpose_s1_slots``) on the CPU, against an
independent NumPy loop over the plan's planes, the slab design it
replaces (``xpose_mirror`` + ``xpose_s1``), the JAX package's pipeline
in interpret mode and the oracle. The kernel itself is held against its
plain version on the card in tests/test_torch_cuda.py.

Tolerances:
* the table against the NumPy loop: exact (the same columns and values);
* the slot design's products against the slab design's at every slot S3
  reads: bit for bit (one f32 product each), and 0.0 at every slot whose
  product is 0.0;
* y on the slot table against y on the slab (both S3 as row sums):
  ``torch.equal``; against the JAX pipeline and ``simulate_xpose``:
  rel-L2 <= 1e-5, the bound of tests/test_torch_xpose.py; against
  ``spmv_oracle``: ``validate_result``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import xpose_plan as jax_xp
from spmv_scpa_tpu.ops.xpose import prepare_xpose as jax_prepare_xpose

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import lane_ell, nearfar, xpose, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_REF_REL_L2 = 1e-5
CASES = sorted(cases.XPOSE_CASES)
DESIGNS = ("rows", ("rows", "slab"))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.cache
def _case(name):
    """(matrix, plan, the slot and slab designs from that plan, x)."""
    A = cases.make(cases.XPOSE_CASES[name])
    preps = xpose.prepare_xpose_designs(A, DESIGNS, device="cpu")
    return A, xpose_plan.plan_xpose(A), preps, make_x(A.n)


def _call(prep, name, x):
    (args,) = [a for k, a in prep.kernel_calls(
        torch.as_tensor(x, dtype=torch.float32)) if k == name]
    return args


def _loop(plan):
    """Each product slot of mid that can hold a nonzero, by a loop over
    steps and out-blocks in the slab design's terms: {flat mid position:
    (x column, value)}."""
    nw0 = plan.NR // BC
    r2 = xpose.compact_routes(plan, plan.r2).astype(np.int64)
    r3 = xpose.compact_routes(plan, plan.r3).astype(np.int64)
    lane = np.arange(BC)
    out = {}
    for s in range(plan.J1):
        w = int(plan.win_of_step[s])
        g = plan.gidx[s * BC:(s + 1) * BC].astype(np.int64)
        a = plan.asv[s * BC:(s + 1) * BC]
        if 0 <= w < nw0:                       # x rows (w*128 + r)
            base = (w * BC + lane)[:, None] * BC
            row_ok = np.ones(BC, bool)
        elif nw0 <= w < nw0 + plan.NWm:        # mirror window v
            v = w - nw0
            sel = plan.mir_sel[v].astype(np.int64)
            sub = plan.mir_sub[v].astype(np.int64)
            src = plan.msw[v * 4 + np.minimum(sel, 3)].astype(np.int64)
            base = (src * BC + sub)[:, None] * BC
            row_ok = (sel < 4) & (sub < BC)
        else:
            continue
        col = base + g                          # (r, c) of the slab
        ok = (row_ok[:, None] & (g < BC) & (a != 0) & (col >= 0)
              & (col < plan.n))
        ok[:, xpose_plan.CCAP:] = False
        for k in range(plan.B2):
            c1 = r3[s * plan.B2 + k]
            for c2 in np.flatnonzero(c1 < xpose_plan.CCAP):
                r = r2[s * plan.B2 + k, c1[c2]]
                if r < BC and ok[r, c1[c2]]:
                    out[(k * plan.J1 + s) * BC + c2] = (
                        int(col[r, c1[c2]]), float(a[r, c1[c2]]))
    return out


# ---- the table --------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_table_matches_a_numpy_loop(name):
    """The table lists each slot S3 reads once; its nonzero entries are
    the loop's, column and value; every other entry is 0.0 and reads no
    x; chunks hold one step each, entries by step and then mid position
    (each warp's 128 interleaved: lane l loads l, l + 32, l + 64, l + 96),
    padding only at the end of a step's last chunk."""
    A, plan, _, _ = _case(name)
    pos3 = xpose.s3_rows_table(plan)[1]
    head, code, val = xpose.s1_slots_table(plan, pos3)
    assert head.dtype == code.dtype == np.int32 and val.dtype == np.float32
    assert code.shape == val.shape == (head.shape[0], xpose.SLOT_CHUNK)
    pos, col, live = (t.numpy() for t in xpose.decode_slots(
        torch.as_tensor(head), torch.as_tensor(code), plan.J1))
    assert sorted(pos[live].tolist()) == sorted(pos3.tolist())
    want = _loop(plan)
    v = val[live]
    got = {int(p): (int(c), float(a)) for p, c, a in
           zip(pos[live][v != 0], col[live][v != 0], v[v != 0])}
    assert got == want
    assert not val[~live].any()
    step = np.repeat(head[:, 0], xpose.SLOT_CHUNK).reshape(code.shape)
    s_of = (pos // BC) % plan.J1
    assert (s_of[live] == step[live]).all()
    assert (np.diff(head[:, 0]) >= 0).all()
    # in the order before the interleave of each warp's 128 entries
    at = xpose.slot_order(np.arange(code.size)).reshape(code.shape)
    pos, live, step = (a.reshape(-1)[at] for a in (pos, live, step))
    order = step * (plan.B2 * plan.J1 * BC) + pos
    assert (np.diff(order[live]) > 0).all()
    pad = ~live
    assert (pad[:, :-1] <= pad[:, 1:]).all()             # trailing only
    last = np.r_[head[1:, 0] != head[:-1, 0], True]
    assert not pad[~last].any()


def test_cases_cover_the_table_shapes():
    """Mirror steps, several chunks to a step, and padded entries among
    the cases; the padding is under a chunk a step."""
    seen = {"mirror": False, "chunks": False}
    for name in CASES:
        _, plan, _, _ = _case(name)
        head, code, _ = xpose.s1_slots_table(plan)
        nw0 = plan.NR // BC
        seen["mirror"] |= bool((plan.win_of_step >= nw0).any())
        seen["chunks"] |= bool((np.bincount(head[:, 0]) > 1).any())
        pad = int((((code.view(np.uint32) >> 16) == xpose.NO_SLOT)).sum())
        assert 0 < pad < plan.J1 * xpose.SLOT_CHUNK
    assert all(seen.values()), seen


def test_planner_check_raises_on_a_doctored_plan():
    """A plan whose S3 planes drop one occupied slot (its final lane set
    to 255) loses that product from y on either design: s1_slots_table
    refuses it, naming the slot; so does a position outside mid."""
    _, plan, _, _ = _case("rand-1k")
    r3b = plan.r3b.copy()
    f, l = np.argwhere(r3b.reshape(-1, BC) < xpose_plan.CCAP)[0]
    r3b.reshape(-1, BC)[f, l] = 255
    bad = dataclasses.replace(plan, r3b=r3b)
    with pytest.raises(ValueError, match="never reads"):
        xpose.s1_slots_table(bad)
    with pytest.raises(ValueError, match="never reads"):
        xpose.host_tables(bad)
    with pytest.raises(ValueError, match="outside mid"):
        xpose.s1_slots_table(plan, [plan.B2 * plan.J1 * BC])


# ---- the plain version against the slab design ------------------------------

@pytest.mark.parametrize("name", CASES)
def test_slots_plain_equals_the_slab_at_every_slot_s3_reads(name):
    """``xpose_s1_slots_plain`` against ``xpose_s1_plain`` (after the
    mirror) on the same x: bit for bit at every position of S3's table,
    0.0 at every entry whose product is 0.0; the slab's mid holds nothing
    anywhere else."""
    A, plan, preps, x = _case(name)
    args = _call(preps["rows"], "xpose_s1_slots", x)
    slab = dict(preps["rows", "slab"].kernel_calls(
        torch.as_tensor(x, dtype=torch.float32)))
    xm = xpose.xpose_mirror_plain(*slab["xpose_mirror"])
    mid_slab = xpose.xpose_s1_plain(args[0], xm,
                                    *slab["xpose_s1"][2:]).reshape(-1)
    mid = xpose.xpose_s1_slots(*args).reshape(-1)
    assert mid.shape == mid_slab.shape == (plan.B2 * plan.J1 * BC,)
    pos3 = torch.as_tensor(xpose.s3_rows_table(plan)[1], dtype=torch.int64)
    assert torch.equal(mid[pos3], mid_slab[pos3])
    pos, _, live = xpose.decode_slots(*args[1:3], plan.J1)
    zero = live & (args[3] == 0)
    assert not mid[pos[zero]].any()
    rest = torch.ones(mid.numel(), dtype=torch.bool)
    rest[pos3] = False
    assert not mid_slab[rest].any() and not mid[rest].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_slots_plain_reads_zero_out_of_range(seed):
    """A random table (steps and windows out of range, columns below 0 or
    past x, zero values, padding, positions outside mid): the plain
    version's rule entry by entry, in a NumPy loop."""
    rng = np.random.default_rng(seed)
    n, B2, J1, C, chunk = 40_000, 3, 5, 4, 64
    x = rng.standard_normal(n).astype(np.float32)
    head = np.zeros((C, 8), np.int64)
    head[:, 0] = rng.integers(-1, J1 + 2, C)
    head[:, 4:] = rng.integers(-1, 4, (C, 4))
    kc2 = rng.integers(0, B2 * BC + 40, C * chunk)
    kc2[rng.random(kc2.size) < 0.1] = xpose.NO_SLOT
    off = rng.integers(0, 1 << 16, kc2.size)
    val = rng.standard_normal(kc2.size).astype(np.float32)
    val[rng.random(val.size) < 0.2] = 0.0
    # one entry a position of mid, as the host builds them
    pos = (((kc2 >> 7) * J1 + head[np.arange(kc2.size) // chunk, 0]) * BC
           + (kc2 & (BC - 1)))
    live = np.flatnonzero(kc2 != xpose.NO_SLOT)
    _, first = np.unique(pos[live], return_index=True)
    kc2[np.setdiff1d(live, live[first])] = xpose.NO_SLOT
    code = (kc2 << 16 | off).astype(np.uint32).view(np.int32)
    want = np.zeros(B2 * J1 * BC, np.float32)
    for i in range(kc2.size):
        s = head[i // chunk, 0]
        p = ((kc2[i] >> 7) * J1 + s) * BC + (kc2[i] & (BC - 1))
        if kc2[i] == xpose.NO_SLOT or not 0 <= p < want.size:
            continue
        c = head[i // chunk, 4 + (off[i] >> 14)] * BC * BC + (off[i] & 16383)
        want[p] = x[c] * val[i] if val[i] != 0 and 0 <= c < n else 0.0
    got = xpose.xpose_s1_slots(
        torch.as_tensor(x), torch.as_tensor(head, dtype=torch.int32),
        torch.as_tensor(code.reshape(C, chunk)),
        torch.as_tensor(val.reshape(C, chunk)), B2, J1)
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


# ---- y, the slice as a whole ---------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_slots_y_equals_the_slab_y_and_the_references(name):
    """``cuda-xpose`` on the slot table (the default) is ``torch.equal``
    to it on the slab, both with S3 as row sums, and within the f32 bound
    of ``simulate_xpose`` and the oracle."""
    A, plan, preps, x = _case(name)
    y = preps["rows"].fn(x)
    assert torch.equal(y, preps["rows", "slab"].fn(x))
    assert (preps["rows"].meta["s1"], preps["rows", "slab"].meta["s1"]) == \
        ("slots", "slab")
    assert _rel_l2(to_numpy(y), jax_xp.simulate_xpose(plan, x)) \
        <= VS_REF_REL_L2
    validate_result(spmv_oracle(A, x), to_numpy(y),
                    what=f"cuda-xpose (slots) on {name}")


def test_slots_y_matches_the_jax_pipeline():
    """rand-1k against the JAX package's Pallas pipeline in interpret
    mode (``prepare_xpose(..., interpret=True)``, about 7 s)."""
    spec = cases.XPOSE_CASES["rand-1k"]
    A, Aj = cases.make(spec), cases.make(spec, jax_synth)
    x = make_x(A.n)
    y_jax = np.asarray(jax_prepare_xpose(Aj, interpret=True).fn(x),
                       dtype=np.float64)
    prep = xpose.prepare_xpose(A, device="cpu")
    assert prep.meta["s1"] == "slots"
    y = to_numpy(prep.fn(x))
    assert _rel_l2(y, y_jax) <= VS_REF_REL_L2
    validate_result(spmv_oracle(A, x), y, what="cuda-xpose (slots)")


@pytest.mark.parametrize("name", ["rand-1k", "amazon8k", "webbase30k"])
def test_nonfinite_x_at_unread_columns_keeps_y_finite(name):
    """Columns 0 and n-1 dropped from A, x[0] = inf and x[n-1] = NaN: the
    default design reads neither, so y is finite and passes the
    oracle."""
    A0 = cases.make(cases.XPOSE_CASES[name])
    keep = (A0.ja != 0) & (A0.ja != A0.n - 1)
    A = CSR.from_coo(name, A0.m, A0.n, A0.row_ids()[keep], A0.ja[keep],
                     A0.as_[keep])
    x = make_x(A.n)
    x[0], x[-1] = np.inf, np.nan
    prep = get_strategy("cuda-xpose").prepare(A, device="cpu")
    y = to_numpy(prep.fn(x))
    assert np.isfinite(y).all()
    validate_result(spmv_oracle(A, x), y, what=f"cuda-xpose on {name}")


# ---- the switch, the bytes and the wrapper -------------------------------------

def test_slots_with_the_prefix_s3_raises():
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    with pytest.raises(ValueError, match="s1='slots' with s3='prefix'"):
        xpose.prepare_xpose(A, device="cpu", s3="prefix", s1="slots")
    with pytest.raises(ValueError, match="s1='slots' with s3='prefix'"):
        nearfar.prepare_nearfar(A, device="cpu", s3="prefix", s1="slots")
    spec, kw = cases.XPOSE_TAIL
    with pytest.raises(ValueError, match="s1='slots' with s3='prefix'"):
        lane_ell.prepare_lane_ell_hybrid(cases.make(spec), device="cpu",
                                         xpose_s3="prefix",
                                         xpose_s1="slots", **kw)
    with pytest.raises(ValueError, match="s1 'scan'"):
        xpose.prepare_xpose(A, device="cpu", s1="scan")
    assert xpose.resolve_s1("auto", "prefix") == "slab"
    assert xpose.resolve_s1("slab", "rows") == "slab"


def test_hbm_bytes_counts_the_slot_table():
    """On the slot table: its bytes (8 B an entry, 32 B a chunk), the
    slots it writes and x, then S3's row sums; less than the slab's
    planes, mirror and whole product array."""
    _, plan, preps, _ = _case("webbase200k")
    rowptr, pos = xpose.s3_rows_table(plan)
    head, code, val = xpose.s1_slots_table(plan, pos)
    got = xpose.hbm_bytes(plan, "rows", "slots")
    assert got == (head.nbytes + code.nbytes + val.nbytes + 4 * pos.size
                   + 4 * plan.n + rowptr.nbytes + 2 * pos.nbytes
                   + 4 * plan.m)
    assert head.nbytes + code.nbytes + val.nbytes < 8.2 * code.size
    assert got == preps["rows"].hbm_bytes == xpose.hbm_bytes(plan)
    assert got < xpose.hbm_bytes(plan, "rows", "slab") \
        == preps["rows", "slab"].hbm_bytes


def test_designs_from_one_plan_share_its_tables():
    """prepare_xpose_designs keys each design as given and builds S3's
    row table once for both S1 designs; the slot design's calls are the
    slot kernel and the row sums."""
    A, _, preps, x = _case("webbase30k")
    assert set(preps) == {"rows", ("rows", "slab")}
    xf = torch.as_tensor(x, dtype=torch.float32)
    calls = {d: dict(p.kernel_calls(xf)) for d, p in preps.items()}
    assert list(calls["rows"]) == ["xpose_s1_slots", "xpose_s3_rows"]
    assert list(calls["rows", "slab"]) == ["xpose_mirror", "xpose_s1",
                                           "xpose_s3_rows"]
    for a, b in zip(calls["rows"]["xpose_s3_rows"][1:],
                    calls["rows", "slab"]["xpose_s3_rows"][1:]):
        assert torch.equal(a, b)
    assert xpose.prepare_xpose(A, device="cpu", s1="slab").meta["s1"] == \
        "slab"


def test_slots_wrapper_refuses_bad_tables():
    _, plan, _, _ = _case("rand-1k")
    head, code, val = (torch.as_tensor(a) for a in
                       xpose.s1_slots_table(plan))
    x = torch.zeros(plan.n)
    ok = (x, head, code, val, plan.B2, plan.J1)
    for i, bad, what in ((1, head.long(), "head is"),
                         (2, code.view(-1), "multiple of 4"),
                         (2, code[:, :-2].contiguous(), "multiple of 4"),
                         (3, val.double(), "val is"),
                         (3, val[:-1], "val is"),
                         (3, val.t().contiguous().t(), "not contiguous"),
                         (0, x.double(), "x is"),
                         (5, 0, "J1=0"),
                         (4, 1 << 22, "under 2\\^31")):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError, match=what):
            xpose.xpose_s1_slots(*args)
    before = dict(xpose.LAUNCHES)
    mid = xpose.xpose_s1_slots(*ok)
    assert mid.shape == (plan.B2, plan.J1, BC)
    assert xpose.LAUNCHES == before              # the CPU: plain version

"""XPOSE past the reference's 254 steps (``cuda-xpose``'s plan,
``ops/xpose.py``; the widened step plane, ``ops/xpose_plan.py``).

The reference caps a plan at ``J1_MAX`` = 254 steps because the TPU's
mid-row (step) index is uint8. The port's slot-table designs carry an
int32 step a chunk and 32-bit positions into mid, so ``cuda-xpose``
plans up to ``HOPPER_J1_MAX`` steps (the Hopper envelope) with a uint16
step plane past 256; ``plan_xpose``'s default cap stays the reference's,
with its refusal.

Tolerances:
* plans and tables inside the reference's envelope: exact (the Hopper
  envelope's plan is the reference's there);
* y of the plain versions against ``spmv_oracle`` (float64) on values
  and x that are exact in float32: per row, ``|y - Y| <= gamma_k *
  (|A||x|)_row`` with ``gamma_k = k u / (1 - k u)``, ``u = 2^-24`` and
  ``k`` the row's entries: the standard bound of a float32 sum of ``k``
  rounded float32 products in any order (the row sums add each row's
  products, split into lanes and a halving tree, all f32 operations);
  a wrong or dropped product reads far past it.
"""

import functools
import re

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops import xpose_plan as jax_xp

from spmv_scpa_tpu_torch import trace
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import xpose, xpose_plan
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle

WEBBASE_NNZ = 3_105_536          # SuiteSparse Williams/webbase-1M
U = 2.0 ** -24


def _f32_exact(A: CSR, seed: int):
    """``A`` with standard normal values exact in float32, and such an x."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(A.nnz).astype(np.float32).astype(np.float64)
    x = rng.standard_normal(A.n).astype(np.float32)
    return CSR(A.name, A.m, A.n, A.irp, A.ja, vals), x


@functools.cache
def _webbase1m():
    """webbase-1M at its source's size (values exact in float32), an x,
    its Hopper plan, and S3's table."""
    A, x = _f32_exact(cases.make(cases.WEBBASE1M), 5)
    plan = xpose.plan_or_raise(A)
    return A, x, plan, xpose.s3_rows_table(plan)


def _within_f32_rounding(A: CSR, x, y):
    """Each row of ``y`` within the float32 bound of the module's
    docstring of the float64 product."""
    want = spmv_oracle(A, x)
    k = np.diff(A.irp).astype(np.float64)
    scale = np.zeros(A.m)
    np.add.at(scale, A.row_ids(), np.abs(A.as_ * x.astype(np.float64)[A.ja]))
    gamma = k * U / (1 - k * U)
    err = np.abs(np.asarray(y, np.float64) - want)
    assert (err <= gamma * scale).all(), float((err / np.maximum(
        gamma * scale, 1e-300)).max())


def _plain_y(plan, x, s3="rows", s1="auto"):
    run, _ = xpose.bind_plan(plan, torch.device("cpu"), s3, s1)
    return run(torch.as_tensor(x, dtype=torch.float32), xpose.PLAIN).numpy()


# ---- (a) webbase-1M at its source's size ------------------------------------

def test_hopper_envelope_plans_webbase1m_past_the_cap():
    """Near 3.1M entries the plan passes 254 steps, its step plane is
    uint16, every product slot is one that S3's table reads (the slot
    table's check, which caught the uint8 wrap, passes), one slot an
    entry, and some at step 256 or above; y within float32 rounding."""
    A, x, plan, (rowptr, pos) = _webbase1m()
    assert A.m == A.n == 1_000_005
    assert abs(A.nnz / WEBBASE_NNZ - 1) < 0.01
    assert xpose_plan.J1_MAX < 256 < plan.J1 <= xpose_plan.HOPPER_J1_MAX
    assert plan.sub.dtype == np.uint16
    assert plan.B2 * plan.J1 * BC < 2 ** 31
    assert pos.size == rowptr[-1] == A.nnz
    head, _, _ = xpose.s1_slots_table(plan, pos)
    assert int(head[:, 0].max()) >= 256
    steps = pos.astype(np.int64) // BC % plan.J1
    assert (steps >= 256).sum() > 1000
    _within_f32_rounding(A, x, _plain_y(plan, x))


def test_webbase1m_tables_pass_the_check_that_caught_the_wrap():
    """The same plan with its steps wrapped to 8 bits, as the reference's
    uint8 plane would hold them: S3's table then reads other slots, and
    the slot table's check refuses the plan instead of dropping entries
    from y."""
    _, _, plan, _ = _webbase1m()
    wrapped = xpose_plan.XposePlan(**{**vars(plan),
                                      "sub": plan.sub.astype(np.uint8)})
    with pytest.raises(ValueError, match="never reads"):
        xpose.s1_slots_table(wrapped)


# ---- (b) past a lowered cap: the Hopper envelope's y ------------------------

@pytest.mark.parametrize("name", ["rand-8k", "webbase30k"])
def test_hopper_envelope_y_past_a_lowered_cap(monkeypatch, name):
    """With the reference's cap lowered to 4 steps the Hopper envelope
    still plans, and the plain versions' y is within float32 rounding of
    the float64 product on seeded values exact in float32."""
    monkeypatch.setattr(xpose_plan, "J1_MAX", 4)
    A, x = _f32_exact(cases.make(cases.XPOSE_CASES[name]), 11)
    prep = xpose.prepare_xpose(A, device="cpu")
    assert prep.meta["J1"] > 4
    assert (prep.meta["s3"], prep.meta["s1"]) == ("rows", "slots")
    _within_f32_rounding(A, x, prep.fn(torch.as_tensor(x)).numpy())


# ---- (c) the reference's cap keeps the reference's refusal ------------------

@pytest.mark.parametrize("name", ["rand-8k", "webbase30k"])
def test_the_reference_cap_refuses_past_a_lowered_cap(monkeypatch, name):
    """``plan_xpose`` at its default cap (``J1_MAX``, lowered to 4)
    refuses with the reference's reason, and ``prepare_xpose`` with the
    same reason where its own cap is lowered to 4 too."""
    monkeypatch.setattr(xpose_plan, "J1_MAX", 4)
    monkeypatch.setattr(jax_xp, "J1_MAX", 4)
    spec = cases.XPOSE_CASES[name]
    assert xpose_plan.plan_xpose(cases.make(spec)) is None
    reason = xpose_plan.REJECT_REASON
    assert jax_xp.plan_xpose(cases.make(spec, jax_synth)) is None
    assert reason == jax_xp.REJECT_REASON
    monkeypatch.setattr(xpose_plan, "HOPPER_J1_MAX", 4)
    with pytest.raises(ValueError, match=r"planning envelope .*J1=\d+>4\)"):
        xpose.prepare_xpose(cases.make(spec), device="cpu")
    assert xpose_plan.REJECT_REASON == reason


def test_the_reference_cap_refuses_webbase1m_as_the_reference():
    """At the source's size the reference planner refuses the matrix on
    its step count, and ``plan_xpose`` at its default cap with its
    reason."""
    A = cases.make(cases.WEBBASE1M)
    assert xpose_plan.plan_xpose(A) is None
    reason = xpose_plan.REJECT_REASON
    assert re.fullmatch(r"J1=\d+>254", reason), reason
    assert jax_xp.plan_xpose(cases.make(cases.WEBBASE1M, jax_synth)) is None
    assert reason == jax_xp.REJECT_REASON


# ---- (d) the TPU-shaped designs refuse past the cap, by name ----------------

@pytest.mark.parametrize("s3, s1, named", [
    ("prefix", "auto", "s3='prefix'"), ("prefix", "slab", "s3='prefix'"),
    ("rows", "slab", "s1='slab'")])
def test_tpu_designs_refuse_a_plan_past_the_cap(s3, s1, named):
    _, _, plan, rows = _webbase1m()
    for build in (lambda: xpose.check_designs(plan, s3, s1),
                  lambda: xpose.host_tables(plan, s3, s1, {"rows": rows}),
                  lambda: xpose.bind_plan(plan, "cpu", s3, s1,
                                          {"rows": rows})):
        with pytest.raises(ValueError, match=f"{named}.*J1={plan.J1} steps"):
            build()


# ---- inside the reference's envelope nothing changes ------------------------

@pytest.mark.parametrize("name", ["rand-1k", "amazon8k", "webbase30k"])
def test_hopper_plan_is_the_reference_plan_inside_its_envelope(name):
    """Below 254 steps both caps give one plan, array for array
    (uint8 steps), and the same slot tables."""
    A = cases.make(cases.XPOSE_CASES[name])
    ref = xpose_plan.plan_xpose(A)
    wide = xpose_plan.plan_xpose(A, j1_max=xpose_plan.HOPPER_J1_MAX)
    assert ref.J1 <= 256 and wide.sub.dtype == np.uint8
    for k, v in vars(ref).items():
        w = getattr(wide, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        else:
            assert v == w, k
    for a, b in zip(xpose.s1_slots_table(ref), xpose.s1_slots_table(wide)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("J1, dtype", [(8, np.uint8), (256, np.uint8),
                                       (264, np.uint16),
                                       (1 << 16, np.uint16)])
def test_step_dtype_is_the_narrowest_that_holds_the_steps(J1, dtype):
    assert xpose_plan.step_dtype(J1) is dtype
    assert np.iinfo(dtype).max >= J1 - 1


def test_steps_past_the_port_cap_are_refused():
    with pytest.raises(ValueError, match="past 2"):
        xpose_plan.step_dtype((1 << 16) + 8)
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    with pytest.raises(ValueError, match="HOPPER_J1_MAX"):
        xpose_plan.plan_xpose(A, j1_max=xpose_plan.HOPPER_J1_MAX + 1)


# ---- the plan's spans -------------------------------------------------------

def test_the_plan_span_notes_its_shape_and_the_s3_index_stage():
    """``pack.plan`` notes J1, B2, m2, NWm and the step cap; the widened
    S3 index has its own stage under it, with the steps and the bits."""
    A = cases.make(cases.XPOSE_CASES["webbase30k"])
    trace.take()
    prep = xpose.prepare_xpose(A, device="cpu")
    spans = trace.spans()
    root, = [s for s in spans if s.name == "pack.plan"]
    assert root.attrs == {"fn": "plan_or_raise", "J1": prep.meta["J1"],
                          "B2": prep.meta["B2"],
                          "m2": A.m + prep.meta["virtual_rows"],
                          "NWm": prep.meta["NWm"],
                          "j1_max": xpose_plan.HOPPER_J1_MAX}
    kids = {s.name: s for s in spans if s.parent is not None}
    stage = kids["s3_index"]
    assert stage.attrs == {"J1": prep.meta["J1"], "bits": 8}
    assert stage.parent == kids["plan_xpose"].id
    assert {"colorings", "s1_planes", "y_routes"} <= set(kids)


# ---- the slot-table designs' checks -----------------------------------------

@functools.cache
def _rand1k_tables():
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    plan = xpose.plan_or_raise(A)
    tables = xpose.host_tables(plan)
    head, code, val = (torch.as_tensor(a) for a in tables["slots"])
    rowptr, pos = (torch.as_tensor(a) for a in tables["rows"])
    return A, plan, head, code, val, rowptr, pos


@pytest.mark.parametrize("bad, match", [
    ("chunk", "multiple of 4"), ("J1", r"2\^31"), ("val", "val is"),
    ("rowptr", "rowptr is"), ("pos", "must be 1-D")])
def test_the_slot_wrappers_refuse_a_bad_table(bad, match):
    """The checks that the slot-table designs' wrappers make each call,
    and that ``bind_plan`` makes once for their call on the card, refuse
    a table of the wrong shape or type (the launches themselves need the
    card: tests/test_torch_cuda.py)."""
    A, plan, head, code, val, rowptr, pos = _rand1k_tables()
    B2, J1 = plan.B2, plan.J1
    x = torch.zeros(A.n, dtype=torch.float32)
    mid = torch.zeros((B2, J1, BC), dtype=torch.float32)
    calls = {
        "chunk": lambda: xpose.xpose_s1_slots(x, head, code[:, :6],
                                              val[:, :6], B2, J1),
        "J1": lambda: xpose.xpose_s1_slots(x, head, code, val, B2, 1 << 20),
        "val": lambda: xpose.xpose_s1_slots(x, head, code, val.double(),
                                            B2, J1),
        "rowptr": lambda: xpose.xpose_s3_rows(mid, rowptr.long(), pos),
        "pos": lambda: xpose.xpose_s3_rows(mid, rowptr, pos.view(-1, 1))}
    with pytest.raises(ValueError, match=match):
        calls[bad]()

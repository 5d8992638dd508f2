"""The port's spans (spmv_scpa_tpu_torch/trace.py) on the CPU: how spans
nest and share a call's identifier, self time, the bounded buffer, the
cost rule of call spans (off and no profiler: nothing recorded, no
profiler operation entered), the profiler's view of the spans (host
operations, not user annotations, around the call's own operations),
the set-up spans of a prepare, and the kernel libraries' load span.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.registry import get_strategy

PACK = ("pack.plan", "pack.layout", "pack.upload")


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    trace.disable()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def stencil():
    return synth.stencil_csr(m=3000, points=6, run_len=8, bandwidth=300,
                             seed=2)


def _by_name(recorded):
    return {s.name: s for s in recorded}


@pytest.mark.parametrize("calls_on", [False, True])
def test_spans_nest_under_their_parent_and_share_the_call(calls_on):
    """Set-up spans and stages nest by the thread's stack whether call
    spans are on or not; call spans, where on, carry the id of the
    ``call`` that caused them, and a set-up span inside a call takes the
    call's id too."""
    @trace.launch("k")
    def kernel():
        with trace.span("kernels.load", name="k"):
            pass

    @trace.call_span("call")
    def call():
        kernel()

    with trace.span("prepare", strategy="s"):
        trace.stage("a")
        with trace.span("inner"):
            pass
        trace.stage("b")
    if calls_on:
        trace.enable()
    call()
    trace.disable()
    got = _by_name(trace.spans())
    root, a, b, inner = (got[k] for k in ("prepare", "a", "b", "inner"))
    assert root.parent is None and root.attrs == {"strategy": "s"}
    assert a.parent == b.parent == root.id and inner.parent == a.id
    assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert b.end_ns <= root.end_ns
    load = got["kernels.load"]
    if calls_on:
        c, k = got["call"], got["launch.k"]
        assert c.parent is None and c.call == c.id
        assert k.parent == c.id and k.call == c.id
        assert load.parent == k.id and load.call == c.id
    else:
        assert "call" not in got and "launch.k" not in got
        assert load.parent is None and load.call is None


def test_a_span_left_open_ends_with_its_parent_even_on_an_exception():
    @trace.span("outer")
    def outer():
        trace.stage("s")
        raise ValueError("refused")

    with pytest.raises(ValueError):
        outer()
    got = _by_name(trace.spans())
    assert got["s"].parent == got["outer"].id
    assert got["s"].end_ns <= got["outer"].end_ns
    with trace.span("after") as s:
        pass
    assert s.parent is None


def test_self_time_is_the_duration_less_the_children():
    with trace.span("p"):
        with trace.span("c1"):
            sum(range(20000))
        sum(range(20000))
        with trace.span("c2"):
            sum(range(20000))
    got = _by_name(trace.spans())
    p, c1, c2 = got["p"], got["c1"], got["c2"]
    want = p.seconds - c1.seconds - c2.seconds
    assert trace.self_s(p) == pytest.approx(want, abs=1e-9)
    assert 0 < trace.self_s(p) < p.seconds
    assert trace.self_s(c1) == pytest.approx(c1.seconds, abs=1e-9)


@pytest.mark.parametrize("capacity,made", [(8, 5), (8, 8), (8, 20)])
def test_the_buffer_keeps_the_newest_and_counts_the_dropped(capacity, made):
    trace.reset(capacity)
    for i in range(made):
        with trace.span(f"s{i}"):
            pass
    kept = [s.name for s in trace.spans()]
    assert kept == [f"s{i}" for i in range(max(0, made - capacity), made)]
    assert trace.dropped() == max(0, made - capacity)
    assert [s.name for s in trace.take()] == kept
    assert trace.spans() == []


class _Counting:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1

    def __exit__(self, *exc):
        pass


def test_a_call_off_records_nothing_and_enters_no_profiler_operation(
        monkeypatch, stencil):
    prep = get_strategy("cuda-hybrid").prepare(stencil, device="cpu")
    x = torch.ones(stencil.n)
    monkeypatch.setattr(trace, "_RecordFunctionFast", _Counting)
    _Counting.entered = 0
    trace.take()
    prep.fn(x)
    assert trace.spans() == [] and _Counting.entered == 0
    # on: the spans are recorded, and still no profiler operation
    trace.enable()
    prep.fn(x)
    trace.disable()
    assert [s.name for s in trace.spans()] == ["launch.lane_rows", "call"]
    assert _Counting.entered == 0


@pytest.mark.parametrize("strategy,cols,launch", [
    ("cuda-hybrid", 1, "launch.lane_rows"),
    ("cuda-bcsr-spmm", 8, "launch.bcsr_bits_spmm")])
def test_spans_in_the_profiler_are_host_operations_around_the_call(
        stencil, strategy, cols, launch):
    """Inside a profiler window, with call spans off, ``call`` and the
    launch enter the trace as host operations (no user annotation: on a
    CUDA trace those are mirrored onto the device's timeline), the launch
    inside the call and the call's own operations inside the launch."""
    kw = {"cols": cols} if cols > 1 else {}
    prep = get_strategy(strategy).prepare(stencil, device="cpu", **kw)
    x = torch.ones((stencil.n, cols) if cols > 1 else stencil.n)
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prep.fn(x)
    assert trace.spans() == []
    events = prof.events()
    by = {}
    for ev in events:
        by.setdefault(ev.name, []).append(ev)
    (c,), (k,) = by["call"], by[launch]
    for ev in (c, k):
        assert ev.device_type == torch.autograd.DeviceType.CPU
        assert not ev.is_user_annotation
    assert c.time_range.start <= k.time_range.start
    assert k.time_range.end <= c.time_range.end
    inside = [ev for ev in events if ev.name.startswith("aten::")
              and k.time_range.start <= ev.time_range.start
              and ev.time_range.end <= k.time_range.end]
    assert inside


@pytest.mark.parametrize("strategy,kw", [("cuda-hybrid", {}),
                                         ("cuda-bcsr-spmm", {"cols": 8})])
def test_a_prepare_is_one_root_its_pack_spans_cover(stencil, strategy, kw):
    get_strategy(strategy).prepare(stencil, device="cpu", **kw)
    recorded = trace.spans()
    (root,) = trace.roots("prepare", recorded)
    assert root.attrs == {"strategy": strategy, "m": stencil.m,
                          "n": stencil.n, "nnz": stencil.nnz,
                          "cols": kw.get("cols", 1)}
    parts = {name: trace.outermost(root, name, recorded) for name in PACK}
    assert all(parts.values()), parts
    covered = sum(s.seconds for v in parts.values() for s in v)
    assert 0.9 * root.seconds <= covered <= root.seconds
    names = [s.name for _, s in trace.tree(root, recorded)]
    assert names[0] == "prepare" and len(names) == len(set(
        s.id for _, s in trace.tree(root, recorded)))
    if strategy == "cuda-hybrid":
        assert {"plane_major", "plan_core", "pick_quantum"} <= set(names)
        (upload,) = parts["pack.upload"]
        assert upload.attrs["bytes"] > 0


@pytest.mark.parametrize("name", ["banded512", "stencil4k-idx8",
                                  "stencil4k-dyn", "amazon20k",
                                  "ext-windowed40k"])
def test_plane_major_notes_its_pair_table(name):
    """``pack_lane_ell``'s ``plane_major`` stage carries the distinct
    (plane, strip) pairs it found and the size of the table it counted
    them in: every static member of the plan's strip sets is one pair."""
    make, kw = SMALL_CASES[name]
    plan = lane_ell.pack_lane_ell(make(), **kw)
    (stage,) = [s for s in trace.spans() if s.name == "plane_major"]
    assert stage.attrs == {
        "pairs": sum(w >= 0 for u in plan.used for w in u),
        "table": plan.QT * plan.cfg.nw}
    assert stage.attrs["pairs"] <= stage.attrs["table"]


def test_a_hybrids_compact_tail_is_a_nested_prepare():
    """A big tail prepares its own strategy: a ``prepare`` child of the
    hybrid's root, whose pack spans are counted once."""
    A = synth.amazon_csr(m=20000, avg_nnz=4.7, seed=4)
    prep = get_strategy("cuda-hybrid").prepare(
        A, device="cpu", ext=False, diag="nochips", tail_xla_max=1000)
    assert prep.meta["tail_kind"].startswith("compact-")
    recorded = trace.spans()
    (root,) = trace.roots("prepare", recorded)
    nested = [s for s in recorded if s.name == "prepare" and s is not root]
    assert len(nested) == 1 and nested[0].parent == root.id
    total = sum(s.seconds for name in PACK
                for s in trace.outermost(root, name, recorded))
    assert total <= root.seconds


class _FakeLib:
    def __getattr__(self, name):
        f = type("F", (), {})()
        setattr(self, name, f)
        return f


def test_a_library_is_a_load_span_once(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "_LOADED", {})
    monkeypatch.setattr(_kernels, "build", lambda name: tmp_path / name)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: _FakeLib())
    first = _kernels.load("lane_rows")
    (s,) = trace.take()
    assert (s.name, s.attrs["name"]) == ("kernels.load", "lane_rows")
    assert isinstance(s.attrs["built"], bool)
    assert _kernels.load("lane_rows") is first
    assert trace.spans() == []


def test_no_span_of_a_call_is_left_open(stencil):
    prep = get_strategy("cuda-hybrid").prepare(stencil, device="cpu")
    trace.take()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            prep.fn(np.ones(stencil.n, np.float32))
    trace.disable()
    recorded = trace.spans()
    assert len(recorded) == 6
    assert len({s.call for s in recorded}) == 3
    assert trace._stack() == []

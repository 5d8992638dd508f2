"""Spans of the port: where its set-up and its calls spend their time.

A span is a named interval of the host's clock (``time.perf_counter_ns``)
with attributes, its own id, the id of the span it ran inside (a stack
per thread) and, inside a call, the id of the ``call`` span that caused
it, so that the spans of one call share an identifier. Spans are kept in
memory in a bounded buffer, the oldest dropped and counted when it is
full; nothing is written anywhere. :func:`spans` reads the buffer,
:func:`take` drains it.

Two classes of span:

* **set-up spans** (:class:`span`, :func:`stage`) are always recorded:
  ``prepare`` and the pack under it (``pack.plan``, ``pack.layout``,
  ``pack.upload`` and their sections), ``pick_auto``, ``kernels.load``
  and ``kernels.build``. A prepare makes a few dozen of them against
  seconds of work;
* **call spans** (:func:`call_span`, :func:`launch`) are recorded only
  between :func:`enable` and :func:`disable`: ``call`` around every
  ``Prepared.fn`` and ``launch.<kernel>`` around each kernel wrapper
  that counts its launches. Off, a call span costs one flag test and one
  C call.

Whenever a ``torch.profiler`` is recording, every span also enters it as
a plain host operation (``_RecordFunctionFast``, a ``cpu_op`` in the
trace), so that it lies on the profiler's timeline beside the device's
kernels: a device idle gap that begins inside the port then carries the
port's span name. A user annotation (``record_function``) is not used:
on a CUDA trace the profiler mirrors those onto the device's timeline as
device events, which would count as kernels.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from dataclasses import dataclass

import torch

# Spans the buffer holds before it drops the oldest.
CAPACITY = 1 << 16

# The profiler's host operation, None where this torch lacks it (spans
# then stay out of the profiler's trace).
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)
_profiling = torch._C._autograd._profiler_enabled


@dataclass(slots=True, eq=False)
class Span:
    name: str
    attrs: dict
    id: int
    parent: int | None       # the enclosing recorded span
    call: int | None         # the enclosing recorded ``call`` span
    start_ns: int
    end_ns: int = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass(slots=True, eq=False)
class _Frame:
    span: Span
    keep: bool               # goes to the buffer when it ends
    anchor: int | None       # id a child records as its parent
    call: int | None
    rf: object = None        # the profiler's host operation, if entered
    stage: bool = False


_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_calls_on = False


def enable() -> None:
    """Record call spans from now on."""
    global _calls_on
    _calls_on = True


def disable() -> None:
    """Stop recording call spans (set-up spans stay on)."""
    global _calls_on
    _calls_on = False


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    with _lock:
        return list(_buf)


def take() -> list[Span]:
    """The recorded spans, and the buffer emptied."""
    with _lock:
        out = list(_buf)
        _buf.clear()
        return out


def dropped() -> int:
    """Spans dropped from the full buffer since the last :func:`reset`."""
    return _dropped


def reset(capacity: int = CAPACITY) -> None:
    """Empty the buffer, zero the dropped count, bound the buffer at
    ``capacity`` spans."""
    global _buf, _dropped
    with _lock:
        _buf = collections.deque(maxlen=capacity)
        _dropped = 0


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _push(name: str, attrs: dict, keep: bool) -> _Frame:
    st = _stack()
    top = st[-1] if st else None
    sid = next(_ids)
    anchor = top.anchor if top else None
    call = top.call if top else None
    if keep:
        if name == "call" and call is None:
            call = sid
        sp = Span(name, attrs, sid, anchor, call, 0)
        anchor = sid
    else:
        sp = Span(name, attrs, sid, None, None, 0)
    fr = _Frame(sp, keep, anchor, call)
    if _RecordFunctionFast is not None and _profiling():
        fr.rf = _RecordFunctionFast(name)
        fr.rf.__enter__()
    st.append(fr)
    sp.start_ns = time.perf_counter_ns()
    return fr


def _close(fr: _Frame) -> None:
    global _dropped
    fr.span.end_ns = time.perf_counter_ns()
    if fr.rf is not None:
        fr.rf.__exit__(None, None, None)
    if fr.keep:
        with _lock:
            if len(_buf) == _buf.maxlen:
                _dropped += 1
            _buf.append(fr.span)


def _pop(fr: _Frame) -> None:
    """End ``fr`` and every frame opened above it and left open (its
    stages)."""
    st = _stack()
    if st and st[-1] is fr:
        _close(st.pop())
        return
    if not any(f is fr for f in st):
        return
    while st:
        top = st.pop()
        _close(top)
        if top is fr:
            return


class span:
    """A set-up span: ``with span(name, **attrs):`` or ``@span(name,
    **attrs)``. Always recorded."""

    def __init__(self, name: str, /, **attrs):
        self.name = name
        self.attrs = attrs
        self._fr = None

    def __enter__(self) -> Span:
        self._fr = _push(self.name, dict(self.attrs), True)
        return self._fr.span

    def __exit__(self, *exc) -> None:
        _pop(self._fr)

    def __call__(self, f):
        name, attrs = self.name, self.attrs

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            fr = _push(name, dict(attrs), True)
            try:
                return f(*args, **kwargs)
            finally:
                _pop(fr)
        return wrapper


def stage(name: str, /, **attrs) -> None:
    """End the innermost open span's current stage, if it has one, and
    open stage ``name`` as its child: a section of a long function, which
    ends at the next :func:`stage` or with the span it lies in. Nothing
    where no span is open."""
    st = _stack()
    if not st:
        return
    if st[-1].stage:
        _close(st.pop())
    _push(name, attrs, True).stage = True


def note(**attrs) -> None:
    """Add ``attrs`` to the innermost open span, and to no other span that
    shares its attributes (a call span's)."""
    st = _stack()
    if st:
        sp = st[-1].span
        sp.attrs = {**sp.attrs, **attrs}


def call_span(name: str, /, **attrs):
    """Decorator: a call span ``name`` around ``f``, recorded between
    :func:`enable` and :func:`disable`, and entered into a recording
    profiler. Its spans share one ``attrs`` dict, until :func:`note`
    gives one its own."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not (_calls_on or _profiling()):
                return f(*args, **kwargs)
            fr = _push(name, attrs, _calls_on)
            try:
                return f(*args, **kwargs)
            finally:
                _pop(fr)
        return wrapper
    return deco


def launch(kernel: str):
    """Decorator of a kernel wrapper: the call span ``launch.<kernel>``
    over its checks, its allocations and the launch."""
    return call_span(f"launch.{kernel}")


# ---- reading the spans -----------------------------------------------------

def roots(name: str, recorded=None, since_ns: int = 0) -> list[Span]:
    """The spans named ``name`` with no recorded parent that began at or
    after ``since_ns``, in the order they began."""
    recorded = spans() if recorded is None else recorded
    return sorted((s for s in recorded if s.name == name
                   and s.parent is None and s.start_ns >= since_ns),
                  key=lambda s: s.start_ns)


def _children(recorded) -> dict:
    kids = collections.defaultdict(list)
    for s in recorded:
        kids[s.parent].append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


def tree(root: Span, recorded=None) -> list[tuple[int, Span]]:
    """``root`` and every span under it, as (depth, span) in the order
    they began, each after its parent."""
    kids = _children(spans() if recorded is None else recorded)
    out = []
    todo = [(0, root)]
    while todo:
        depth, s = todo.pop()
        out.append((depth, s))
        todo.extend((depth + 1, c) for c in reversed(kids.get(s.id, ())))
    return out


def outermost(root: Span, name: str, recorded=None) -> list[Span]:
    """The spans named ``name`` under ``root`` that lie in no other span
    of that name under it (a nested strategy's spans are not counted
    twice)."""
    kids = _children(spans() if recorded is None else recorded)
    out = []
    todo = [root]
    while todo:
        s = todo.pop()
        for c in kids.get(s.id, ()):
            if c.name == name:
                out.append(c)
            else:
                todo.append(c)
    return out


def self_s(s: Span, recorded=None) -> float:
    """``s``'s seconds less the part of them its children cover."""
    recorded = spans() if recorded is None else recorded
    covered = 0
    end = s.start_ns
    for c in sorted((c for c in recorded if c.parent == s.id),
                    key=lambda c: c.start_ns):
        a, b = max(c.start_ns, end), min(c.end_ns, s.end_ns)
        if b > a:
            covered += b - a
            end = b
    return s.seconds - covered * 1e-9

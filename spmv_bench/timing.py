"""Timing methods of the benchmark, frozen copies of the port's so that
a later change to the port cannot move the yardstick:

* :func:`closed_loop` is a timed window: calls back to back on one
  stream with no synchronisation between calls; in the tail's window
  each call is bracketed by its own pair of CUDA events
  (``bench/timing.py:time_cuda``'s method), made before the window and
  read after it, so that its host does no more a call than record two
  events; the rate's window records nothing, since each event costs the
  device time of its own;
* :func:`time_device` is ``bench/timing.py:time_device``'s method: the
  device's time of a call alone, the stream held by a spin kernel until
  the host has enqueued every rep, with one event pair a block of calls
  in place of one a call, so that it times the calls the rate's window
  makes;
* :func:`host_enqueue_ms` is ``chip_smoke.py:host_vs_device``'s host
  clock over calls back to back, repeated in blocks until the host clock
  spans a quarter of a second.

:class:`HostEvent` stands in for ``torch.cuda.Event`` where the window
is driven on the CPU by the tests; no device number is taken from it.
Imports nothing of the port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# Event pairs made for the window, at least and at most: its calls at
# the warm-up's rate, with room, so that no span is read inside it.
PAIRS = (4096, 1 << 20)

# Spin cycles that first hold the stream in time_device (about 8 ms on
# an H100); doubled until the hold outlasts the host's enqueue.
HOLD_CYCLES = 1 << 24
MAX_HOLD_CYCLES = 1 << 30


class HostEvent:
    """An event of the host clock with ``torch.cuda.Event``'s methods."""

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def make_pairs(count: int, event=None) -> list:
    """``count`` pairs of timing events, made before the window."""
    event = event or torch.cuda.Event
    lo, hi = PAIRS
    return [(event(enable_timing=True), event(enable_timing=True))
            for _ in range(min(hi, max(lo, count)))]


def closed_loop(fn, xs, seconds: float, pairs, sample, first: int = 0,
                stream=None, sync=None):
    """Call ``fn(xs[i % len(xs)])`` back to back for ``seconds`` on the
    host clock, for ``i`` from ``first`` on. With ``pairs`` None nothing
    else is recorded (the rate's window); otherwise each call lies
    between the two events of a pair of ``pairs`` recorded on ``stream``
    (the tail's window), and where the window outlasts ``pairs`` they are
    reused as a ring, each read when its slot comes round.
    ``sample.next`` is the next call whose output ``sample.take(i, y)``
    sees (it returns the one after; the window leaves the next of all in
    ``sample.next`` for a window that follows). Returns ``(calls, wall_s, spans_ms,
    last_y)``: the wall time runs from the first call's issue to the
    return of the closing synchronisation, the spans are each call's
    event-pair milliseconds in call order (empty without pairs)."""
    sync = sync or torch.cuda.synchronize
    nx = len(xs)
    npairs = len(pairs) if pairs else 0
    spans = []
    nxt = sample.next
    i = first
    j = 0
    k = first % nx
    wrapped = False
    y = None
    clock = time.perf_counter
    t0 = clock()
    stop = t0 + seconds
    if not npairs:
        while True:
            y = fn(xs[k])
            if i == nxt:
                nxt = sample.take(i, y)
            i += 1
            k += 1
            if k == nx:
                k = 0
            if clock() >= stop:
                break
    else:
        while True:
            start, end = pairs[j]
            if wrapped:
                end.synchronize()
                spans.append(start.elapsed_time(end))
            start.record(stream)
            y = fn(xs[k])
            end.record(stream)
            if i == nxt:
                nxt = sample.take(i, y)
            i += 1
            j += 1
            if j == npairs:
                j, wrapped = 0, True
            k += 1
            if k == nx:
                k = 0
            if clock() >= stop:
                break
    sync()
    wall_s = clock() - t0
    sample.next = nxt
    calls = i - first
    for c in range(max(0, calls - npairs), calls if npairs else 0):
        start, end = pairs[c % npairs]
        spans.append(start.elapsed_time(end))
    return calls, wall_s, np.asarray(spans, dtype=np.float64), y


def time_device(fn, x, reps: int = 20, per: int = 10,
                warmup: int = 3) -> list[float]:
    """Milliseconds a call ``fn(x)`` takes on the device alone, for each of
    ``reps`` blocks of ``per`` calls back to back: the stream is held by
    ``torch.cuda._sleep`` while the host enqueues every block, one pair of
    events a block (an event costs the device time of its own, so none
    lies between the calls of a block), and the hold is doubled and the
    blocks taken again until the device had not reached the last block
    when the host was done."""
    for _ in range(warmup):
        fn(x)
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    while True:
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        for start, end in ev:
            start.record()
            for _ in range(per):
                fn(x)
            end.record()
        held = not ev[-1][0].query()
        torch.cuda.synchronize()
        if held:
            return [start.elapsed_time(end) / per for start, end in ev]
        if cycles >= MAX_HOLD_CYCLES:
            raise RuntimeError("time_device: the host could not enqueue "
                               f"{reps} blocks within the longest hold")
        cycles *= 2


def host_enqueue_ms(fn, xs, calls: int = 200, min_s: float = 0.25,
                    max_blocks: int = 100) -> float:
    """Host milliseconds a call to enqueue ``fn``: blocks of ``calls``
    calls back to back on the host clock, a synchronisation between
    blocks (so a block starts on an idle device and no full launch queue
    holds the host back), until the blocks' host time reaches ``min_s``
    or ``max_blocks`` blocks ran."""
    nx = len(xs)
    host_s = 0.0
    done = 0
    for _ in range(max_blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(calls):
            fn(xs[k % nx])
        host_s += time.perf_counter() - t0
        done += calls
        if host_s >= min_s:
            break
    torch.cuda.synchronize()
    return host_s * 1e3 / done

"""What the metrics of the port's own spans read
(``spmv_scpa_tpu_torch/trace.py``): set-up spans, always recorded, and
call spans, recorded between ``trace.enable()`` and ``trace.disable()``.
Every function returns None where the program records no such span (a
program without the tracing module among them)."""

from __future__ import annotations

import statistics
import time


def _trace():
    try:
        from spmv_scpa_tpu_torch import trace
    except ImportError:
        return None
    return trace


def pack_seconds(run, name: str):
    """Seconds of the outermost spans ``name`` under the run's
    ``prepare`` root (the last one begun since the run's clock started),
    summed."""
    trace = _trace()
    if trace is None:
        return None
    recorded = trace.spans()
    roots = trace.roots("prepare", recorded, since_ns=int(run.t0 * 1e9))
    if not roots:
        return None
    return sum(s.seconds for s in trace.outermost(roots[-1], name, recorded))


def before_window_seconds(run, name: str):
    """Seconds of every span ``name`` of the process begun before the
    run's window, summed."""
    trace = _trace()
    if trace is None:
        return None
    window_ns = int((run.t0 + run.setup_s) * 1e9)
    found = [s.seconds for s in trace.spans()
             if s.name == name and s.start_ns < window_ns]
    return sum(found) if found else None


def median_call_ms(run, measure):
    """The median ``call`` span in milliseconds over ``measure()``, run
    with call spans on."""
    trace = _trace()
    if trace is None:
        return None
    since = time.perf_counter_ns()
    trace.enable()
    try:
        measure()
    finally:
        trace.disable()
    calls = [s.seconds for s in trace.spans()
             if s.name == "call" and s.start_ns >= since]
    return statistics.median(calls) * 1e3 if calls else None

"""The profiler window of a ``--trace 1`` run.

One ``torch.profiler`` window of calls back to back gives the device's
busy seconds (the union of its operations' intervals) against the
window's wall seconds, and the breakdown: device time by operation, and
the device's idle gaps by what the host was doing when each began. The
profiler can lose kernel events (the port's PERF.md: 2-10% on some
paths), so a window is trusted whole only when its device kernel events
equal the host's kernel launches and cover the port's launch counters
over the same calls (``chip_smoke.device_busy``'s check, copied); a
window that fails it is taken again, up to three times, and a breakdown
and the idle share are given only from a whole one (``busy_s`` and
``window_s`` are printed from the last try whatever it found). Imports
nothing of the port.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

TOP = 10
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")


def short_name(name: str) -> str:
    """A kernel's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile_window(fn, xs, calls: int, launches, tries: int = 3) -> dict:
    """Profile ``calls`` calls back to back (``launches()`` reads the
    port's launch counters). Returns ``busy_s``, ``window_s``, ``whole``
    (the window saw every launch), ``line`` (what the check found) and,
    from a whole window, ``breakdown``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nx = len(xs)
    for k in range(1, tries + 1):
        torch.cuda.synchronize()
        before = launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                fn(xs[i % nx])
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        launched = launches() - before
        events = prof.events()
        dev = [ev for ev in events if ev.device_type == DeviceType.CUDA]
        kernels = [ev for ev in dev
                   if not ev.name.startswith(("Memcpy", "Memset"))]
        ours = sum(1 for ev in kernels if "at::" not in ev.name)
        host = sum(1 for ev in events if ev.name in LAUNCH_CALLS)
        whole = ours >= launched and len(kernels) == host
        if whole:
            break
    busy = _union((ev.time_range.start, ev.time_range.end) for ev in dev)
    out = {"busy_s": sum(b - a for a, b in busy) * 1e-6,
           "window_s": window_s, "whole": whole,
           "line": (f"profiler window {k} of {tries}, {calls} calls, "
                    f"{'whole' if whole else 'NOT whole: no idle share'}: "
                    f"{ours} port kernel events for {launched} launches, "
                    f"{len(kernels)} kernel events for {host} launch "
                    "calls")}
    if whole:
        out["breakdown"] = {"device_ops": _device_ops(dev),
                            "idle_gaps": _idle_gaps(busy, events)}
    return out


def _device_ops(dev) -> list:
    by = defaultdict(float)
    for ev in dev:
        by[short_name(ev.name)] += ev.time_range.elapsed_us() * 1e-6
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:TOP]


def _idle_gaps(busy, events) -> list:
    """The device's idle seconds between its operations, summed by the
    innermost host operation running when each gap began ("host" where
    none was: the caller's Python)."""
    from torch.autograd import DeviceType
    cpu = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                 for ev in events if ev.device_type == DeviceType.CPU)
    starts = [c[0] for c in cpu]
    by = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        j = bisect.bisect_right(starts, a) - 1
        label = "host"
        for back in range(j, max(j - 200, -1), -1):
            if cpu[back][1] >= a:
                label = cpu[back][2]
                break
        by[re.sub(r"\s+", " ", label)[:120]] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:TOP]

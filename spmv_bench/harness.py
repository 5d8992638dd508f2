"""One run of one cell: set-up, the timed window, the readers, the
judgement.

Set-up builds the configuration's matrix structure (its generator's own
seed fixes it), draws A's values and the X vectors from ``--seed``,
hands the port a ``CSR`` of those arrays, prepares the traffic's
strategy (``auto`` is ``registry.pick_auto``), and warms up the cell's
own shapes. The measured time is two windows of ``Prepared.fn`` back
to back (:func:`timing.closed_loop`), half of it each: the rate's
window records nothing but the calls (``gflops``), the tail's brackets
every call with a pair of events (``call_p95_ms``), since an event costs
the device time of its own. Both keep a sample of their outputs drawn
from the seed, and the run then judges every kept output against the
plain reference (``reference.py``), once the program's state is freed.

:class:`Run` is what a metric's reader (``metrics/<name>.py``,
``read(run) -> float | None``) reads: the windows' calls, wall times,
spans and launch counts, the set-up and pack seconds, and measurements
taken on demand after the window (:meth:`Run.device_ms`,
:meth:`Run.host_enqueue_ms`, :meth:`Run.profile`). On the CPU (the
tests) the window runs on the host clock and every device measurement
reads None.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time

import numpy as np
import torch

from spmv_bench import reference, roofline, timing
from spmv_bench import trace as tracing

# Outputs of the window kept for the judgement: a uniform sample of the
# window's calls (reservoir sampling from the seed), and the last call.
SAMPLE = 16
WARMUP_ROUNDS = 3
# Seconds of the window's loop run in set-up.
CALIBRATE_S = 0.25
# The profiler window's length: about this many seconds of calls, within
# these counts.
PROFILE_S = 0.3
PROFILE_CALLS = (50, 4000)


def port_launches() -> int:
    """The port's launch counters, summed: every ``LAUNCHES`` table and
    ``*_LAUNCHES`` count of a loaded ``spmv_scpa_tpu_torch`` module."""
    total = 0
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != "spmv_scpa_tpu_torch":
            continue
        for attr, val in vars(mod).items():
            if attr == "LAUNCHES" and isinstance(val, dict):
                total += sum(val.values())
            elif attr.endswith("_LAUNCHES") and isinstance(val, int):
                total += val
    return total


# A configuration's ``dtype`` -> the numpy type A's values and X are
# drawn in; a configuration without the key is float32.
DTYPES = {"float32": np.float32, "float64": np.float64}


def value_dtype(config: dict):
    """The numpy type of the configuration's ``dtype`` (float32 where it
    has none); another dtype is refused."""
    name = config.get("dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"{config.get('name')}: dtype {name!r} is not one "
                         f"of {sorted(DTYPES)}")
    return DTYPES[name]


def draw(seed: int, nnz: int, n: int, cols: int, vectors: int, dtype):
    """A's values and the X vectors, standard normal in ``dtype``, from
    ``seed``: float64 draws are doubles of their own, not float32
    widened."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    vals = rng.standard_normal(nnz, dtype=dtype)
    shape = (vectors, n) if cols == 1 else (vectors, n, cols)
    xs = rng.standard_normal(shape, dtype=dtype)
    return vals, xs


def inputs(cell, seed: int):
    """The cell's matrix (values drawn from ``seed``) and its X vectors
    as host arrays, both in the configuration's ``dtype``
    (:func:`value_dtype`; the matrix keeps its values as float64). A
    matrix whose shape or count of entries differs from the
    configuration's is refused: the cell would measure another matrix
    than its source."""
    cfg, tr = cell.config, cell.traffic
    dtype = value_dtype(cfg)
    mat = cell.module("generators", cfg["generator"]).build(**cfg["args"])
    got = {"rows": mat.m, "cols": mat.n, "nnz": mat.nnz}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"{cfg['name']}: the generator built {got}, the "
                         f"configuration states {want}")
    vals, xs = draw(seed, mat.nnz, mat.n, tr["cols"], tr["vectors"], dtype)
    mat.vals = vals.astype(np.float64, copy=False)
    return mat, xs


class Sample:
    """A uniform sample of ``k`` of the window's outputs, drawn from the
    seed without knowing the window's length (reservoir sampling,
    Li's algorithm L: the window only compares its call's index with
    ``next``). Each kept y is copied on the stream at once, so a later
    call that reuses its buffer cannot change it."""

    def __init__(self, seed: int, k: int = SAMPLE):
        self.rng = random.Random(seed)
        self.k = k
        self.kept: list = []
        self.next = 0
        self.w = 1.0

    def _u(self) -> float:
        u = self.rng.random()
        while u == 0.0:
            u = self.rng.random()
        return u

    def take(self, i: int, y) -> int:
        """Keep call ``i``'s ``y``; the index of the next call to keep."""
        if i < self.k:
            self.kept.append((i, y.clone()))
            if i + 1 < self.k:
                return i + 1
        else:
            self.kept[self.rng.randrange(self.k)] = (i, y.clone())
        self.w *= math.exp(math.log(self._u()) / self.k)
        return i + 1 + int(math.log(self._u()) / math.log1p(-self.w))


class Run:
    def __init__(self, cell, seed: int, seconds: float,
                 device: str = "cuda", t0: float | None = None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.device = torch.device(device)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.on_card = self.device.type == "cuda"
        self._memo: dict = {}

    # ---- set-up ----------------------------------------------------------

    def setup(self, fault=None) -> None:
        """Everything before the window. ``fault(fn) -> fn`` breaks the
        timed path underneath (the tests)."""
        from spmv_scpa_tpu_torch.formats.csr import CSR
        from spmv_scpa_tpu_torch.ops.registry import get_strategy, pick_auto

        tr = self.cell.traffic
        self.mat, xs = inputs(self.cell, self.seed)
        mat = self.mat
        self.cols = tr["cols"]
        A = CSR(name=self.cell.config["name"], m=mat.m, n=mat.n,
                irp=mat.irp, ja=mat.ja, as_=mat.vals)
        self.strategy = (pick_auto(A) if tr["strategy"] == "auto"
                         else tr["strategy"])
        knobs = dict(tr.get("knobs", {}))
        if self.cols > 1:
            knobs["cols"] = self.cols
        t = time.perf_counter()
        self.prep = get_strategy(self.strategy).prepare(
            A, device=self.device, **knobs)
        self.pack_s = time.perf_counter() - t
        del A
        self.xs = [torch.from_numpy(x).to(self.device) for x in xs]
        self.fn = self.prep.fn if fault is None else fault(self.prep.fn)
        self.stream = torch.cuda.current_stream(self.device) \
            if self.on_card else None
        self._warm()
        self.setup_s = time.perf_counter() - self.t0

    def _event(self):
        return torch.cuda.Event if self.on_card else timing.HostEvent

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def _warm(self) -> None:
        """Every shape of the windows: each X through the call, the event
        pair, the span's read and the sample's copy; then the tail's
        window's own loop for a moment, whose rate sizes its event
        pairs."""
        ev = self._event()
        for _ in range(WARMUP_ROUNDS):
            for x in self.xs:
                a, b = ev(enable_timing=True), ev(enable_timing=True)
                a.record()
                y = self.fn(x)
                b.record()
                y.clone()
                b.synchronize()
                a.elapsed_time(b)
        self._sync()
        calls, wall_s, _, _ = timing.closed_loop(
            self.fn, self.xs, CALIBRATE_S, timing.make_pairs(0, ev),
            Sample(self.seed), stream=self.stream, sync=self._sync)
        self.pairs = timing.make_pairs(
            int(calls / wall_s * self.seconds / 2 * 1.25) + 1024, ev)

    # ---- the windows -------------------------------------------------------

    def window(self) -> None:
        """The rate's window, then the tail's, each half of
        ``seconds``; the calls are numbered on across both, for the
        sample and for the X each call takes."""
        self.sample = Sample(self.seed)
        half = self.seconds / 2
        before = port_launches()
        self.rate_calls, self.rate_wall_s, _, _ = timing.closed_loop(
            self.fn, self.xs, half, None, self.sample,
            stream=self.stream, sync=self._sync)
        tail_calls, self.tail_wall_s, self.spans_ms, y = timing.closed_loop(
            self.fn, self.xs, half, self.pairs, self.sample,
            first=self.rate_calls, stream=self.stream, sync=self._sync)
        self.launches = port_launches() - before
        self.calls = self.rate_calls + tail_calls
        self.wall_s = self.rate_wall_s + self.tail_wall_s
        i = self.calls - 1
        if all(k != i for k, _ in self.sample.kept):
            self.sample.kept.append((i, y.clone()))
        self.pairs = None
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.on_card else 0)

    # ---- measurements after the window, for the readers ------------------

    @property
    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.on_card \
            else "cpu"

    def device_ms(self):
        """The median device time of one call alone (None on the CPU)."""
        if not self.on_card:
            return None
        if "device_ms" not in self._memo:
            self._memo["device_ms"] = float(np.median(
                timing.time_device(self.fn, self.xs[0])))
        return self._memo["device_ms"]

    def host_enqueue_ms(self):
        if not self.on_card:
            return None
        if "host_ms" not in self._memo:
            self._memo["host_ms"] = timing.host_enqueue_ms(self.fn, self.xs)
        return self._memo["host_ms"]

    def bound_ms(self):
        if not self.on_card:
            return None
        m = self.mat
        return roofline.bound_ms(self.kind, m.nnz, m.m, m.n, self.cols,
                                 value_dtype(self.cell.config))

    def profile(self):
        """The profiler window (``trace.profile_window``), None on the
        CPU."""
        if not self.on_card:
            return None
        if "profile" not in self._memo:
            per_call = self.rate_wall_s / max(self.rate_calls, 1)
            lo, hi = PROFILE_CALLS
            calls = int(min(hi, max(lo, PROFILE_S / max(per_call, 1e-9))))
            self._memo["profile"] = tracing.profile_window(
                self.fn, self.xs, calls, port_launches)
        return self._memo["profile"]

    def read_metrics(self, entries) -> dict:
        out = {}
        for m in entries:
            value = self.cell.module("metrics", m["name"]).read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    # ---- the judgement ---------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.prep = self.fn = None
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        """Every kept output against the reference of its X: the widest
        reading of each number, its limit, and the calls that failed."""
        limits = self.cell.checks["limits"]
        refs = {}
        worst = {k: 0.0 for k in limits}
        failed = 0
        for i, y in sorted(self.sample.kept, key=lambda iy: iy[0]):
            j = i % len(self.xs)
            if j not in refs:
                refs[j] = reference.product(self.mat, self.xs[j])
            got = reference.compare(y, *refs[j])
            bad = False
            for k in limits:
                worst[k] = max(worst[k], got[k])
                bad |= not got[k] <= limits[k]
            failed += bad
        self.sample.kept.clear()
        return {"failed": failed, "correct": bool(refs) and failed == 0,
                "checks": {k: {"value": worst[k], "limit": limits[k]}
                           for k in limits}}

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_scpa_tpu_torch``) on one
NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each printing lines of its own numbers; any failure raises and
the script exits non-zero:

1. device: the card (nvidia-smi name and power limit), torch, nvcc;
2. build: nvcc builds every kernel from ``spmv_scpa_tpu_torch/csrc``,
   one process per source, all started together;
3. small cases: every matrix of ``bench/cases.py``'s ``SMALL_CASES``
   through ``cuda-hybrid`` on the card, the call against its plain
   version and the oracle, and each kernel call of the path replayed
   against its plain version; between them the cases must launch all
   five kernels of the hybrid;
4. stream probe against its plain version (exact: sums of ones);
5. main path 1, the ML_Laplace stand-in (22.6M nnz), through
   ``get_strategy("cuda-hybrid")``: validated, timed, given a roofline
   figure; the core kernel and the probe must launch;
6. main path 2, ``amazon262k`` (the amazon0302 stand-in, 1M nnz),
   default knobs: the ext route with the resident stage 2 and the chips
   tail; validated, timed, each kernel alone at this matrix's shapes,
   host enqueue against device time over 200 back-to-back calls, a
   profiler window; the core, both stage-1/2 gathers and the
   segment-sum must launch;
7. main path 3, ``ext_windowed1m`` (1M rows, 5M nnz), default knobs:
   the windowed stage 2; the windowed gather must launch.

Each main path sets the launch counts to 0 just before it and reads
them just after; replays that hold a kernel against its plain version
come after the read. Then one JSON line of per-kernel numbers, the card
line, and the contract line ``{"ok": true, "device": {...}}`` last.
Without a card it prints no result and exits 2.

Tolerances: the whole call against its plain call, rel-L2 <= 1e-6 and
per row |dy| <= 1e-5 * (|A||x|)_row: the core and the gathers are
bit-equal to their plain versions, while the plain segment-sum and the
compact tail's ``index_add_`` add with atomics in a varying order on the
card. Each kernel call replayed alone: the core and the gathers
bit-equal to their plain versions; the segment-sum bit-equal to its
plain version run on the CPU (the same fixed order) and within rel-L2
1e-6 of the plain version on the card. Against ``spmv_oracle``:
``validate_result`` (rel 1e-4).

``bound_ms`` is the least time for the same work on an H100 SXM: the
bytes of every input read once and every output written once over
3.35 TB/s, or the f32 operations over 67 TFLOP/s, whichever is larger
(all six kernels are bound by bytes). Where the data decides what is
read, only that counts: a gather's distinct in-range source elements,
the segment-sum's partials that are not padding. Kernel and library times are
device times (``bench.timing.time_device``: the host's enqueue does not
enter them); a plain version and a whole call are timed as their caller
sees them (event pairs, ``time_cuda``/``time_prepared``). ``library_ms``
times one PyTorch
call computing the same function: a cuSPARSE CSR product for the core,
``sum`` for the probe, flat indexing for a gather, ``index_add_`` for
the segment-sum. The port never calls these yardsticks.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, get_strategy
from spmv_scpa_tpu_torch.bench import cases, roofline as roof
from spmv_scpa_tpu_torch.bench.timing import (time_cuda, time_device,
                                              time_prepared)
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import ext_gather, lane_ell, segsum_kernel
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

TWIN_REL_L2 = 1e-6
TWIN_ROW_REL = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores

HYBRID_KERNELS = ("lane_ell_spmv", "sorted_gather", "ranked_gather",
                  "window_gather", "window_segsum")
SOURCES = {
    "lane_ell_spmv": ("spmv_scpa_tpu_torch/csrc/lane_ell.cu",
                      "spmv_scpa_tpu/ops/lane_ell.py:188"),
    "stream_reduce": ("spmv_scpa_tpu_torch/csrc/stream_probe.cu",
                      "spmv_scpa_tpu/bench/roofline.py:60"),
    "sorted_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:79"),
    "ranked_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:121"),
    "window_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:167"),
    "window_segsum": ("spmv_scpa_tpu_torch/csrc/segsum.cu",
                      "spmv_scpa_tpu/ops/segsum_kernel.py:259"),
}


# ---- launch counts -----------------------------------------------------------

def counts() -> dict:
    return {"lane_ell_spmv": lane_ell.KERNEL_LAUNCHES,
            "stream_reduce": roof.KERNEL_LAUNCHES,
            **ext_gather.LAUNCHES,
            "window_segsum": segsum_kernel.KERNEL_LAUNCHES}


def reset_counts() -> None:
    lane_ell.KERNEL_LAUNCHES = 0
    roof.KERNEL_LAUNCHES = 0
    segsum_kernel.KERNEL_LAUNCHES = 0
    for k in ext_gather.LAUNCHES:
        ext_gather.LAUNCHES[k] = 0


def require(launched: dict, names, what: str) -> None:
    missing = [k for k in names if launched.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} "
                             f"(counts {launched})")


# ---- checks and timing ---------------------------------------------------------

def twin_check(A, x, yk, yt, what):
    """Kernel y against plain y within the stated tolerances."""
    yk = yk.double().cpu().numpy()
    yt = yt.double().cpu().numpy()
    d = np.abs(yk - yt)
    rel_l2 = float(np.linalg.norm(d) / max(np.linalg.norm(yt), 1e-300))
    absA = CSR(A.name, A.m, A.n, A.irp, A.ja, np.abs(A.as_))
    scale = spmv_oracle(absA, np.abs(x))
    row_rel = float(np.max(d / np.maximum(scale, 1e-300), initial=0.0))
    if not (rel_l2 <= TWIN_REL_L2 and row_rel <= TWIN_ROW_REL):
        raise AssertionError(
            f"{what}: kernel vs plain rel-L2 {rel_l2:.3e} (<= "
            f"{TWIN_REL_L2:g}), row rel {row_rel:.3e} (<= {TWIN_ROW_REL:g})")
    return rel_l2, row_rel, float(d.max(initial=0.0))


def median_ms(fn, *args):
    """Median device time of ``fn(*args)`` alone (no host time)."""
    return float(np.median(time_device(fn, *args, reps=20)))


def call_ms(fn, *args):
    """Median time of ``fn(*args)`` as its caller sees it (event pairs;
    the host's enqueue enters when it is the slower side). A plain
    version launches up to a thousand kernels a call, more than the
    device's launch queue holds, so it cannot be timed device-only."""
    return float(np.median(time_cuda(fn, *args, reps=20)))


def check_call(name, args, what):
    """Replay one kernel call of the path: the kernel against its plain
    version on the same inputs. Returns max |kernel - plain|."""
    out = getattr(lane_ell.KERNELS, name)(*args)
    plain = getattr(lane_ell.PLAIN, name)(*args)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    if name == "window_segsum":
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        exact = torch.equal(out.cpu(), lane_ell.PLAIN.window_segsum(*cpu))
        rel = float((out - plain).norm() / max(float(plain.norm()), 1e-30))
        ok = exact and rel <= TWIN_REL_L2
    else:
        ok = torch.equal(out, plain)
    if not ok:
        raise AssertionError(f"{what}: {name} disagrees with its plain "
                             f"version (max |d| {err:.3e})")
    return err


def tensor_bytes(args) -> int:
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def gather_flat(name, args):
    """(src, flat, ok) of one gather call: each output element's flat
    index into ``src`` and whether it reads the source at all (an index
    out of range gives 0.0)."""
    if name == "sorted_gather":
        base, src, p, l, P = args
        row = base.long().repeat_interleave(8)[:, None] * P + p.long()
    elif name == "ranked_gather":
        src, p, l = args
        P = src.shape[0]
        row = p.long()
    else:
        base8, src, p, l, P = args
        row = base8.long()[:, None] * 8 + p.long()
    ok = (p >= 0) & (p < P) & (l >= 0) & (l < BC) & (row < src.shape[0])
    return src, row * BC + l.long(), ok


def bound(name, args, out) -> tuple:
    """(bound_ms, bound_by) of one call: the bytes this call's data needs
    (inputs read once, the output written once) over the card's memory
    rate; operations over its f32 rate. A gather reads its index tables
    whole but only the distinct source elements its in-range indices
    name; the segment-sum reads rbl and win whole but only the partials
    of quanta that are not padding."""
    nbytes = tensor_bytes(args) + out.numel() * out.element_size()
    ops = 0
    if name == "lane_ell_spmv":
        cfg = args[-1]
        ops = 2 * cfg.steps * cfg.QT * cfg.chunk * BC
    elif name == "window_segsum":
        part, rbl, h = args[0], args[1], args[4]
        live = int(((rbl >= 0) & (rbl < h)).sum())
        ops = live * 8
        nbytes += live * 8 * part.element_size() - tensor_bytes((part,))
    elif name == "stream_reduce":
        ops = args[0].numel()
    elif name in ("sorted_gather", "ranked_gather", "window_gather"):
        src, flat, ok = gather_flat(name, args)
        nbytes += (torch.unique(flat[ok]).numel() * src.element_size()
                   - tensor_bytes((src,)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_library(name, args):
    """One flat-index read for the same gather: ``src[flat]`` over the
    source with one 0.0 appended, out-of-range elements pointed at it."""
    src, flat, ok = gather_flat(name, args)
    flat = torch.where(ok, flat, src.numel())
    srcz = torch.cat([src.reshape(-1), src.new_zeros(1)])
    return lambda: srcz[flat]


def segsum_library(args):
    """``index_add_`` of the quantum-major partials into y, padding
    quanta pointed at one extra row."""
    part, rbl, win, nw, h, rps = args
    steps = part.shape[0] // rps
    q = part.view(-1, 8, BC).transpose(1, 2).reshape(-1, 8).contiguous()
    g = rps // 8 * BC
    step_of = torch.arange(steps * g, device=part.device) // g
    r = rbl.long()
    dest = torch.where(r < h, win.long()[step_of] * h + r, nw * h)
    return lambda: torch.zeros(nw * h + 1, 8, device=part.device) \
        .index_add_(0, dest, q)


def kernel_table(prep, xd, what):
    """Each kernel of one call, replayed alone at the call's shapes:
    per kernel name the summed ms, plain ms, library ms, bound ms and
    the largest |kernel - plain|."""
    rows = {}
    for name, args in prep.kernel_calls(xd):
        err = check_call(name, args, what)
        fn = getattr(lane_ell.KERNELS, name)
        plainfn = getattr(lane_ell.PLAIN, name)
        out = fn(*args)
        b_ms, b_by = bound(name, args, out)
        lib = (segsum_library(args) if name == "window_segsum"
               else gather_library(name, args) if name != "lane_ell_spmv"
               else None)
        r = rows.setdefault(name, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                   "library_ms": None, "bound_ms": 0.0,
                                   "bound_by": b_by, "max_abs_err": 0.0})
        r["calls"] += 1
        r["ms"] += median_ms(fn, *args)
        r["plain_ms"] += call_ms(plainfn, *args)
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + median_ms(lib)
        r["bound_ms"] += b_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return rows


def host_vs_device(fn, xd, calls=200):
    """Per-call host enqueue time and device time of ``calls`` calls
    back to back (the device clock spans the first enqueue to the last
    kernel's end)."""
    fn(xd)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(xd)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    torch.cuda.synchronize()
    return host_ms, start.elapsed_time(end) / calls


def device_busy(fn, xd, calls=50):
    """Device time per call by kernel (or copy) name, the device's busy
    time per call, and its idle share, from a torch.profiler window of
    ``calls`` calls. Only device-side events count: a CPU op's device
    time is its kernels', which are listed on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(xd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(xd)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {ev.key: ev.self_device_time_total / 1e3 / calls
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0}
    busy = sum(by_name.values())
    return by_name, busy, 1.0 - busy * calls / wall_ms


def phase_line(rows):
    out = []
    for k, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        out.append(f"{k} x{r['calls']} {r['ms']:.4f} ms (plain "
                   f"{r['plain_ms']:.4f}, library {lib}, bound "
                   f"{r['bound_ms']:.4f}, max|d| {r['max_abs_err']:.1e})")
    return " | ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    dev = cuda_device()
    hybrid = get_strategy("cuda-hybrid")

    # 1. device
    card = card_label()
    nvcc = subprocess.run([_kernels.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {release[-1].strip()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    for name in _kernels.SIGNATURES:
        _kernels.load(name)
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs)}", flush=True)

    # 3. the small cases: call against plain call and oracle, each
    # kernel call replayed against its plain version
    small_launches = dict.fromkeys(HYBRID_KERNELS, 0)
    for name, (make, kw) in cases.SMALL_CASES.items():
        A = make()
        prep = hybrid.prepare(A, device=dev, **kw)
        x = make_x(A.n)
        xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
        before = counts()
        yk = prep.fn(xd)
        torch.cuda.synchronize()
        after = counts()
        for k in HYBRID_KERNELS:
            small_launches[k] += after[k] - before[k]
        yt = prep.plain(xd)
        rel_l2, row_rel, dmax = twin_check(A, x, yk, yt, name)
        rel_o = validate_result(spmv_oracle(A, x), to_numpy(yk),
                                what=f"cuda-hybrid on {name}")
        calls = prep.kernel_calls(xd)
        errs = [check_call(k, a, name) for k, a in calls]
        m = prep.meta
        print(f"[small] {name}: nnz {A.nnz} QT {m['slots'] + m['ov_slots']}"
              f" idx8 {m['idx8_planes']} hot {m['hot_strips']} dyn "
              f"{m['dyn_planes']} ext {m['ext']} (windowed "
              f"{m['ext_windowed']}) tail {m['tail_nnz']} {m['tail_kind']} "
              f"| vs plain rel-L2 {rel_l2:.3e} row {row_rel:.3e} max|d| "
              f"{dmax:.3e} | vs oracle rel {rel_o:.3e} | kernels "
              f"{[k for k, _ in calls]} each vs plain max|d| "
              f"{max(errs):.1e}", flush=True)
    require(small_launches, HYBRID_KERNELS, "small cases")
    print(f"[small] launches across the cases: {small_launches}",
          flush=True)

    # 4. stream probe against its plain version
    buf = torch.ones(roof.PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    ok_, ot_ = roof.stream_reduce(buf), roof.stream_reduce_plain(buf)
    want = float(buf.numel() // roof.TILE)
    if not (torch.equal(ok_, ot_) and bool((ok_ == want).all())):
        raise AssertionError("stream probe disagrees with its plain "
                             "version")
    probe = {"max_abs_err": float((ok_ - ot_).abs().max()),
             "ms": median_ms(roof.stream_reduce, buf),
             "plain_ms": call_ms(roof.stream_reduce_plain, buf),
             "library_ms": median_ms(lambda b: b.sum(), buf)}
    probe["bound_ms"], probe["bound_by"] = bound("stream_reduce", (buf,),
                                                 ok_)
    print(f"[probe] {roof.PROBE_BYTES} B: exact match ({want:.0f} per "
          f"position) | kernel {probe['ms']:.4f} ms = "
          f"{roof.PROBE_BYTES / probe['ms'] / 1e6:.1f} GB/s | plain "
          f"{probe['plain_ms']:.4f} ms | sum {probe['library_ms']:.4f} ms | "
          f"bound {probe['bound_ms']:.4f} ms | {card}", flush=True)
    del buf

    # 5. main path 1: the flagship
    A = cases.flagship()
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    t0 = time.perf_counter()
    prep = hybrid.prepare(A, device="cuda", **cases.FLAGSHIP_KNOBS)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what="cuda-hybrid on the flagship")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what="cuda-hybrid timed run")
    rep = roof.roofline(prep, r.duration_ms, r.gflops, x_bytes=A.n * 4,
                        y_bytes=A.m * 4)
    flag_counts = counts()
    require(flag_counts, ("lane_ell_spmv", "stream_reduce"), "flagship")

    m = prep.meta
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd),
                                    "flagship")
    flag = kernel_table(prep, xd, "flagship")["lane_ell_spmv"]
    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(A.irp, dtype=torch.int64, device=dev),
        torch.as_tensor(A.ja, dtype=torch.int64, device=dev),
        torch.as_tensor(A.as_, dtype=torch.float32, device=dev),
        size=(A.m, A.n))
    x2 = xd.view(-1, 1)
    flag["library_ms"] = median_ms(lambda: Acsr.matmul(x2))
    del Acsr
    print(f"[flagship] nnz {A.nnz} pack {pack_s:.1f} s | loc_w "
          f"{m['loc_w']} Q {m['slots']}+{m['ov_slots']} idx8 "
          f"{m['idx8_planes']} chunk {m['chunk']} steps {m['steps']} tail "
          f"{m['tail_nnz']} fill {m['fill']:.3f} hbm_bytes {prep.hbm_bytes}"
          f" | vs oracle rel {rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} "
          f"row {row_rel:.3e} core max|d| {flag['max_abs_err']:.3e}",
          flush=True)
    print(f"[flagship] call {r.duration_ms:.4f} ms = {r.gflops:.2f} "
          f"GFLOP/s | kernel {flag['ms']:.4f} ms = "
          f"{2 * A.nnz / flag['ms'] / 1e6:.2f} GFLOP/s | plain "
          f"{flag['plain_ms']:.4f} ms | bound {flag['bound_ms']:.4f} ms | "
          f"cuSPARSE CSR {flag['library_ms']:.4f} ms | stream "
          f"{rep.stream_bw_gbs:.1f} GB/s vs_roofline {rep.fraction:.4f} "
          f"vs_ideal_roofline {rep.fraction_ideal:.4f} | launches "
          f"{flag_counts} | {card}", flush=True)
    del prep, xd

    # 6. main path 2: amazon262k, the ext route and the chips tail
    A = cases.amazon262k()
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    t0 = time.perf_counter()
    prep = hybrid.prepare(A)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what="cuda-hybrid on amazon262k")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what="cuda-hybrid timed run, amazon262k")
    amz_counts = counts()
    m = prep.meta
    if not (m["ext"] and m["tail_kind"] == "chips"):
        raise AssertionError(f"amazon262k: ext {m['ext']}, tail "
                             f"{m['tail_kind']}: the stand-in did not take "
                             "the ext route and the chips tail")
    require(amz_counts, ("lane_ell_spmv", "sorted_gather", "ranked_gather",
                         "window_segsum"), "amazon262k")
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd),
                                    "amazon262k")
    amz = kernel_table(prep, xd, "amazon262k")
    host_ms, dev_ms = host_vs_device(prep.fn, xd)
    by_name, busy_ms, idle = device_busy(prep.fn, xd)
    print(f"[amazon262k] nnz {A.nnz} pack {pack_s:.2f} s | loc_w "
          f"{m['loc_w']} Q {m['slots']}+{m['ov_slots']} chunk {m['chunk']} "
          f"steps {m['steps']} | ext {m['ext']} ext_h {m['ext_h']} "
          f"ext_windowed {m['ext_windowed']} ext_groups {m['ext_groups']} "
          f"ext_cov {m['ext_cov']} | tail_nnz {m['tail_nnz']} tail_kind "
          f"{m['tail_kind']} chips {m['tail_meta']} | hbm_bytes "
          f"{prep.hbm_bytes} | vs oracle rel {rel_o:.3e} | vs plain rel-L2 "
          f"{rel_l2:.3e} row {row_rel:.3e}", flush=True)
    print(f"[amazon262k] call {r.duration_ms:.4f} ms = {r.gflops:.2f} "
          f"GFLOP/s (median of {r.reps}) | 200 calls back to back: host "
          f"enqueue {host_ms:.4f} ms/call, device {dev_ms:.4f} ms/call | "
          f"profiler, 50 calls: device busy {busy_ms:.4f} ms/call, idle "
          f"share {idle:.3f} | launches {amz_counts} | {card}", flush=True)
    print(f"[amazon262k] kernels alone: {phase_line(amz)}",
          flush=True)
    print("[amazon262k] device ms/call by name: " + ", ".join(
        f"{k[:60]} {v:.4f}" for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:12]), flush=True)
    del prep, xd

    # 7. main path 3: the windowed stage 2 at full size
    A = cases.ext_windowed1m()
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    t0 = time.perf_counter()
    prep = hybrid.prepare(A)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what="cuda-hybrid on ext_windowed1m")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what="cuda-hybrid timed run, windowed")
    win_counts = counts()
    m = prep.meta
    if not m["ext_windowed"]:
        raise AssertionError("ext_windowed1m: the windowed stage 2 was not "
                             "taken")
    require(win_counts, ("lane_ell_spmv", "sorted_gather", "window_gather"),
            "ext_windowed1m")
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd),
                                    "ext_windowed1m")
    win = kernel_table(prep, xd, "ext_windowed1m")
    host_ms, dev_ms = host_vs_device(prep.fn, xd)
    print(f"[ext_windowed1m] nnz {A.nnz} pack {pack_s:.2f} s | ext_h "
          f"{m['ext_h']} r_hot {m['ext_r_hot']} ext_groups "
          f"{m['ext_groups']} ext_cov {m['ext_cov']} tail {m['tail_nnz']} "
          f"{m['tail_kind']} | hbm_bytes {prep.hbm_bytes} | vs oracle rel "
          f"{rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} row {row_rel:.3e} | "
          f"call {r.duration_ms:.4f} ms = {r.gflops:.2f} GFLOP/s | 200 "
          f"calls: host {host_ms:.4f} ms/call, device {dev_ms:.4f} ms/call"
          f" | launches {win_counts} | {card}", flush=True)
    print(f"[ext_windowed1m] kernels alone: {phase_line(win)}", flush=True)

    # the kernels line: each kernel timed on the main path that runs it
    measured = {"lane_ell_spmv": (flag, flag_counts),
                "stream_reduce": (probe, flag_counts),
                "sorted_gather": (amz["sorted_gather"], amz_counts),
                "ranked_gather": (amz["ranked_gather"], amz_counts),
                "window_segsum": (amz["window_segsum"], amz_counts),
                "window_gather": (win["window_gather"], win_counts)}
    line = []
    for name in ("lane_ell_spmv", "stream_reduce", "sorted_gather",
                 "ranked_gather", "window_gather", "window_segsum"):
        row, launched = measured[name]
        src, replaces = SOURCES[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

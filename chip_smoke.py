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
   the windowed stage 2; the windowed gather must launch;
8. small PELL cases: every matrix of ``bench/cases.py``'s
   ``PELL_CASES`` through ``cuda-pell`` or ``cuda-bcsr``, checked as the
   small hybrid cases are; between them they must launch the fused
   kernel, the tile kernel, both segment-sums and the un-permute;
9. main path 4, ``powerlaw100k`` (100k rows, about 11M nnz) through
   ``cuda-hybrid`` at default knobs: the no-locality escape to
   ``cuda-pell`` (fused, row-sorted); validated, timed, each kernel
   alone, host against device over 200 calls; the fused kernel and the
   un-permute must launch;
10. main path 5, ``webbase1m`` (the webbase-1M stand-in) through
   ``cuda-hybrid`` at default knobs: the core and a tail past
   ``BIG_TAIL`` run as compact PELL; the same measurements; the core,
   the fused kernel and the un-permute must launch;
11. ``powerlaw100k`` through ``cuda-pell`` with ``scheme="span"``: the
   tile kernel and the span segment-sum at full size;
12. the flagship through ``cuda-bcsr``: the tile kernel on dense tiles
   and the window segment-sum at full size.

Each path sets the launch counts to 0 just before it and reads them
just after; replays that hold a kernel against its plain version come
after the read. Each prints its packing time. Then one JSON line of the
ten kernels' numbers, the card line, and the contract line ``{"ok":
true, "device": {...}}`` last. Without a card it prints no result and
exits 2.

Tolerances: the whole call against its plain call, rel-L2 <= 1e-6 and
per row |dy| <= 1e-5 * (|A||x|)_row: the core, the gathers, the tile
kernel and the un-permute are bit-equal to their plain versions, while
the plain segment-sums, the plain fused kernel and the compact tail's
``index_add_`` add with atomics in a varying order on the card. Each
kernel call replayed alone: the core, the gathers, the tile kernel and
the un-permute bit-equal to their plain versions; the segment-sums and
the fused kernel bit-equal to their plain versions run on the CPU (the
same fixed order) and within rel-L2 1e-6 of the plain versions on the
card. Against ``spmv_oracle``: ``validate_result`` (rel 1e-4).

``bound_ms`` is the least time for the same work on an H100 SXM: the
bytes of every input read once and every output written once over
3.35 TB/s, or the f32 operations over 67 TFLOP/s, whichever is larger
(all ten kernels are bound by bytes). Where the data decides what is
read, only that counts: a gather's distinct in-range source elements,
the segment-sums' partials that land in y, the distinct x elements the
tile and fused kernels read. Kernel and library times are
device times (``bench.timing.time_device``: the host's enqueue does not
enter them); a plain version and a whole call are timed as their caller
sees them (event pairs, ``time_cuda``/``time_prepared``). ``library_ms``
times one PyTorch
call computing the same function: a cuSPARSE CSR product for the core
(of the whole matrix), for the fused kernel (of the matrix its tiles
hold) and for the tile kernel (of a matrix with one row per tile row
and quantum, whose product is the partials), ``sum`` for the probe,
flat indexing for a gather and the un-permute, ``index_add_`` for the
segment-sums. The port never calls these yardsticks.
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
from spmv_scpa_tpu_torch.ops import ext_gather, lane_ell, pell, segsum_kernel
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
PELL_KERNELS = ("pell_fused", "pell_tiles", "span_segsum", "window_segsum",
                "unpermute")
# kernels whose plain versions add with index_add_ (atomics on the card):
# held bit-equal to the plain version run on the CPU
ORDERED = ("window_segsum", "span_segsum", "pell_fused")
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
    "pell_fused": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                   "spmv_scpa_tpu/ops/pallas_kernels.py:419"),
    "pell_tiles": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                   "spmv_scpa_tpu/ops/pallas_kernels.py:64"),
    "span_segsum": ("spmv_scpa_tpu_torch/csrc/segsum.cu",
                    "spmv_scpa_tpu/ops/segsum_kernel.py:120"),
    "unpermute": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                  "spmv_scpa_tpu/ops/pallas_kernels.py:1518"),
}
LINE_ORDER = ("lane_ell_spmv", "stream_reduce", "sorted_gather",
              "ranked_gather", "window_gather", "window_segsum",
              "pell_fused", "pell_tiles", "span_segsum", "unpermute")


# ---- launch counts -----------------------------------------------------------

def counts() -> dict:
    return {"lane_ell_spmv": lane_ell.KERNEL_LAUNCHES,
            "stream_reduce": roof.KERNEL_LAUNCHES,
            **ext_gather.LAUNCHES,
            "window_segsum": segsum_kernel.KERNEL_LAUNCHES,
            **pell.LAUNCHES,
            "span_segsum": segsum_kernel.SPAN_LAUNCHES}


def reset_counts() -> None:
    lane_ell.KERNEL_LAUNCHES = 0
    roof.KERNEL_LAUNCHES = 0
    segsum_kernel.KERNEL_LAUNCHES = 0
    segsum_kernel.SPAN_LAUNCHES = 0
    for table in (ext_gather.LAUNCHES, pell.LAUNCHES):
        for k in table:
            table[k] = 0


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


def to_cpu(args):
    return [a.cpu() if isinstance(a, torch.Tensor) else
            tuple(t.cpu() for t in a) if isinstance(a, tuple) else a
            for a in args]


def check_call(name, args, what):
    """Replay one kernel call of the path: the kernel against its plain
    version on the same inputs. Returns max |kernel - plain|."""
    out = getattr(lane_ell.KERNELS, name)(*args)
    plain = getattr(lane_ell.PLAIN, name)(*args)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    if name in ORDERED:
        exact = torch.equal(out.cpu(),
                            getattr(lane_ell.PLAIN, name)(*to_cpu(args)))
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


def slot_cols(name, args):
    """Each slot's x column in a tile or fused kernel call (vals, idx,
    pan, x, ...), and whether it lies in x."""
    vals, idx, pan, x = args[:4]
    pw = args[6].panel_w if name == "pell_fused" else args[5]
    rows = vals.shape[0]
    col = (pan[:rows // 8].long().repeat_interleave(8)[:, None] * (pw * BC)
           + (torch.arange(BC, device=vals.device) if idx is None
              else idx.long()))
    return col, (col >= 0) & (col < x.numel())


def segsum_rows(name, args):
    """(quantum-major 8-vectors, destination row block or -1) of a
    segment-sum call: the quanta that add nothing point at -1."""
    part, rbl, base, nw, h = args[:5]
    span, rps = (args[5], args[6]) if name == "span_segsum" else (1, args[5])
    nq = part.shape[1]
    g = rps // 8 * nq
    q = part.view(-1, 8, nq).transpose(1, 2).reshape(-1, 8)
    step_base = base.long().repeat_interleave(g) * h
    r = rbl.long()
    if name == "span_segsum":
        ok = (r >= step_base) & (r < step_base + span * h) & (r < nw * h)
        dest = r
    else:
        ok = (r >= 0) & (r < h)
        dest = step_base + r
    return q, torch.where(ok, dest, -1)


def bound(name, args, out) -> tuple:
    """(bound_ms, bound_by) of one call: the bytes this call's data needs
    (inputs read once, the output written once) over the card's memory
    rate; operations over its f32 rate. A gather reads its index tables
    whole but only the distinct source elements its in-range indices
    name; a segment-sum reads rbl and its step table whole but only the
    partials of quanta that land in y; the tile and fused kernels read
    every slot (value and index), a panel id per tile, and only the
    distinct x elements their slots name (the fused one also its row
    blocks and step table)."""
    nbytes = tensor_bytes(args) + out.numel() * out.element_size()
    ops = 0
    if name in ("pell_tiles", "pell_fused"):
        vals, idx = args[:2]
        col, ok = slot_cols(name, args)
        nbytes = (tensor_bytes((vals, idx)) + vals.shape[0] // 8 * 4
                  + torch.unique(col[ok]).numel() * 4
                  + out.numel() * out.element_size())
        if name == "pell_fused":
            nbytes += tensor_bytes(args[4:6])
        ops = 2 * vals.numel()
    elif name == "span_segsum":
        _, dest = segsum_rows(name, args)
        live = int((dest >= 0).sum())
        nbytes = (tensor_bytes(args[1:3]) + live * 8 * 4
                  + out.numel() * out.element_size())
        ops = live * 8
    elif name == "lane_ell_spmv":
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


def segsum_library(name, args):
    """``index_add_`` of the quantum-major partials into y, the quanta
    that add nothing pointed at one extra row."""
    q, dest = segsum_rows(name, args)
    q = q.contiguous()
    rows = args[3] * args[4]
    dest = torch.where(dest >= 0, dest, rows)
    return lambda: torch.zeros(rows + 1, 8, device=q.device) \
        .index_add_(0, dest, q)


def unpermute_library(args):
    """One flat-index read for the un-permute."""
    yp, bsrc = args
    b = torch.arange(yp.shape[0], device=yp.device)
    flat = ((b // pell.SORT_WIN * pell.SORT_WIN)[:, None] + bsrc.long()) \
        * 8 + torch.arange(8, device=yp.device)
    return lambda: yp.view(-1)[flat]


def fused_library(args):
    """A cuSPARSE CSR product of the matrix the fused kernel's tiles hold
    (in its row order: row block rbl, row r of the tile)."""
    vals, idx, pan, x, rbl, base, cfg, _ = args
    col, _ = slot_cols("pell_fused", args)
    T = vals.shape[0] // 8
    row = (rbl.long().view(T, 1, cfg.nq, 1) * 8
           + torch.arange(8, device=vals.device).view(1, 8, 1, 1)) \
        .expand(T, 8, cfg.nq, cfg.quantum).reshape(-1, BC)
    nz = vals != 0
    A = torch.sparse_coo_tensor(
        torch.stack([row[nz], col[nz]]), vals[nz],
        (cfg.num_windows * cfg.h * 8, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def tiles_library(args):
    """A cuSPARSE CSR product that forms the tile kernel's partials: one
    row per (tile row, quantum), ``(t*8 + r) * nq + j``, holding the
    slots of quantum j in row r of tile t (dense tiles: nq = 1)."""
    vals, _, _, x, quantum = args[:5]
    col, ok = slot_cols("pell_tiles", args)
    R, nq = vals.shape[0], BC // quantum
    row = torch.arange(R * nq, device=vals.device).view(R, nq, 1) \
        .expand(R, nq, quantum).reshape(R, BC)
    nz = (vals != 0) & ok
    A = torch.sparse_coo_tensor(
        torch.stack([row[nz], col[nz]]), vals[nz],
        (R * nq, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def matrix_library(A, xd):
    """A cuSPARSE CSR product of the whole matrix."""
    dev = xd.device
    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(A.irp, dtype=torch.int64, device=dev),
        torch.as_tensor(A.ja, dtype=torch.int64, device=dev),
        torch.as_tensor(A.as_, dtype=torch.float32, device=dev),
        size=(A.m, A.n))
    x2 = xd.view(-1, 1)
    return lambda: Acsr.matmul(x2)


def library(name, args, A, xd):
    """The PyTorch yardstick of one kernel call, or None."""
    if name in ("window_segsum", "span_segsum"):
        return segsum_library(name, args)
    if name in ("sorted_gather", "ranked_gather", "window_gather"):
        return gather_library(name, args)
    if name == "unpermute":
        return unpermute_library(args)
    if name == "pell_fused":
        return fused_library(args)
    if name == "pell_tiles":
        return tiles_library(args)
    if name == "lane_ell_spmv" and A is not None:
        return matrix_library(A, xd)
    return None          # the core without its whole matrix


def kernel_table(prep, xd, what, A=None):
    """Each kernel of one call, replayed alone at the call's shapes:
    per kernel name the summed ms, plain ms, library ms, bound ms and
    the largest |kernel - plain|. ``A``: the whole matrix, whose cuSPARSE
    product is the core's yardstick."""
    rows = {}
    for name, args in prep.kernel_calls(xd):
        err = check_call(name, args, what)
        fn = getattr(lane_ell.KERNELS, name)
        plainfn = getattr(lane_ell.PLAIN, name)
        out = fn(*args)
        b_ms, b_by = bound(name, args, out)
        lib = library(name, args, A, xd)
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


def pell_path(name, A, strategy, knobs, dev, card, kernels, branch,
              branch_what, timing=True):
    """One full-size path of the PELL family: the launch counts set to 0,
    ``A`` prepared (packing timed), the call validated against the
    oracle and timed, the counts read; then the branch ``branch(meta)``
    and the ``kernels`` that must have launched are checked, the call
    held against its plain call and each kernel replayed alone.
    ``timing`` adds host enqueue against device time over 200 calls.
    Returns (the kernel table, the counts)."""
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    t0 = time.perf_counter()
    prep = get_strategy(strategy).prepare(A, device=dev, **knobs)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what=f"{strategy} on {name}")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what=f"{strategy} timed run, {name}")
    launched = counts()
    m = prep.meta
    if not branch(m):
        raise AssertionError(f"{name}: {prep.strategy} did not take "
                             f"{branch_what} (meta {m})")
    require(launched, kernels, name)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd), name)
    table = kernel_table(prep, xd, name, A=A)
    tail = m.get("tail_meta") if isinstance(m.get("tail_meta"), dict) \
        else {}
    pm = tail if "scheme" in tail else m
    print(f"[{name}] nnz {A.nnz} pack {pack_s:.2f} s | {prep.strategy} "
          f"delegated {m.get('delegated')} d_cov {m.get('d_cov')} | "
          f"tail_nnz {m.get('tail_nnz')} tail_kind {m.get('tail_kind')} | "
          f"PELL scheme {pm.get('scheme', 'bcsr')} quantum "
          f"{pm.get('quantum', BC)} panel_w {pm.get('panel_w', 1)} "
          f"row_sort {pm.get('row_sort', False)} chunk {pm.get('chunk')} "
          f"window_h {pm.get('window_h')} tiles {pm.get('num_blocks')} "
          f"fill {pm.get('fill', 0.0):.4f} | hbm_bytes {prep.hbm_bytes} | "
          f"vs oracle rel {rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} row "
          f"{row_rel:.3e}", flush=True)
    hd = ""
    if timing:
        host_ms, dev_ms = host_vs_device(prep.fn, xd)
        hd = (f" | 200 calls back to back: host enqueue {host_ms:.4f} "
              f"ms/call, device {dev_ms:.4f} ms/call")
    print(f"[{name}] call {r.duration_ms:.4f} ms = {r.gflops:.2f} GFLOP/s "
          f"(median of {r.reps}){hd} | launches {launched} | {card}",
          flush=True)
    print(f"[{name}] kernels alone: {phase_line(table)}", flush=True)
    return table, launched


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
    flag = kernel_table(prep, xd, "flagship", A=A)["lane_ell_spmv"]
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
    flagship_A = A

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
    amz = kernel_table(prep, xd, "amazon262k", A=A)
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
    win = kernel_table(prep, xd, "ext_windowed1m", A=A)
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
    del prep, xd

    # 8. the small PELL cases
    pell_launches = dict.fromkeys(PELL_KERNELS, 0)
    for name, (make, strategy, kw) in cases.PELL_CASES.items():
        A = make()
        prep = get_strategy(strategy).prepare(A, device=dev, **kw)
        x = make_x(A.n)
        xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
        before = counts()
        yk = prep.fn(xd)
        torch.cuda.synchronize()
        after = counts()
        for k in PELL_KERNELS:
            pell_launches[k] += after[k] - before[k]
        rel_l2, row_rel, dmax = twin_check(A, x, yk, prep.plain(xd), name)
        rel_o = validate_result(spmv_oracle(A, x), to_numpy(yk),
                                what=f"{strategy} on {name}")
        calls = prep.kernel_calls(xd)
        errs = [check_call(k, a, name) for k, a in calls]
        m = prep.meta
        print(f"[small-pell] {name}: {strategy} nnz {A.nnz} scheme "
              f"{m.get('scheme', 'bcsr')} quantum {m.get('quantum', BC)} "
              f"panel_w {m.get('panel_w', 1)} row_sort "
              f"{m.get('row_sort', False)} tiles {m['num_blocks']} fill "
              f"{m['fill']:.3f} | vs plain rel-L2 {rel_l2:.3e} row "
              f"{row_rel:.3e} max|d| {dmax:.3e} | vs oracle rel {rel_o:.3e}"
              f" | kernels {[k for k, _ in calls]} each vs plain max|d| "
              f"{max(errs):.1e}", flush=True)
    require(pell_launches, PELL_KERNELS, "small PELL cases")
    print(f"[small-pell] launches across the cases: {pell_launches}",
          flush=True)

    # 9-12. the PELL family at full size: two main paths through the
    # hybrid, then the span scheme and BCSR
    pw, pw_counts = pell_path(
        "powerlaw100k", cases.powerlaw100k(), "cuda-hybrid", {}, dev, card,
        ("pell_fused", "unpermute"),
        lambda m: (m.get("delegated") == "cuda-pell"
                   and m["scheme"] == "fused" and m["row_sort"]),
        "the no-locality escape to cuda-pell (fused, row-sorted)")
    wb, wb_counts = pell_path(
        "webbase1m", cases.webbase1m(), "cuda-hybrid", {}, dev, card,
        ("lane_ell_spmv", "pell_fused", "unpermute"),
        lambda m: (m["tail_kind"] == "compact-cuda-pell"
                   and m["tail_nnz"] > lane_ell.BIG_TAIL),
        "a compact-PELL tail past BIG_TAIL")
    sp, sp_counts = pell_path(
        "powerlaw100k-span", cases.powerlaw100k(), "cuda-pell",
        {"scheme": "span"}, dev, card, ("pell_tiles", "span_segsum"),
        lambda m: m["scheme"] == "span", "the span scheme", timing=False)
    bc, bc_counts = pell_path(
        "flagship-bcsr", flagship_A, "cuda-bcsr", {}, dev, card,
        ("pell_tiles", "window_segsum"), lambda m: True, "dense tiles",
        timing=False)

    # the kernels line: each kernel timed on the path that runs it
    measured = {"lane_ell_spmv": (flag, flag_counts),
                "stream_reduce": (probe, flag_counts),
                "sorted_gather": (amz["sorted_gather"], amz_counts),
                "ranked_gather": (amz["ranked_gather"], amz_counts),
                "window_segsum": (amz["window_segsum"], amz_counts),
                "window_gather": (win["window_gather"], win_counts),
                "pell_fused": (pw["pell_fused"], pw_counts),
                "unpermute": (pw["unpermute"], pw_counts),
                "pell_tiles": (sp["pell_tiles"], sp_counts),
                "span_segsum": (sp["span_segsum"], sp_counts)}
    line = []
    for name in LINE_ORDER:
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

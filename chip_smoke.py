#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_scpa_tpu_torch``) on one
NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each printing one line of its own numbers; any failure raises
and the script exits non-zero:

1. device: the card (nvidia-smi name and power limit), torch, nvcc;
2. build: nvcc builds both kernels from ``spmv_scpa_tpu_torch/csrc``;
3. kernel against its plain version, on the card, for the small
   matrices of ``bench/cases.py`` packed by the port, and each against
   the fp64 oracle;
4. stream probe against its plain version (exact: sums of ones);
5. the main path at full size: the ML_Laplace stand-in (22.6M nnz)
   through ``get_strategy("cuda-hybrid")``, validated, timed and
   given a roofline figure, with the kernels' launch counts.

Then one JSON line of per-kernel numbers, the card line, and the
contract line ``{"ok": true, "device": {...}}`` last. Without a card
it prints no result and exits 2.

Tolerances: kernel y against plain y, rel-L2 <= 1e-6 and per row
|dy| <= 1e-5 * (|A||x|)_row. The kernel rounds products and sums as
the plain version does, so its core output is expected bit-equal; the
slack covers the compact tail's ``index_add_``, whose atomics add in a
varying order. Against ``spmv_oracle``: ``validate_result`` (rel 1e-4).
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x
from spmv_scpa_tpu_torch import _kernels, get_strategy
from spmv_scpa_tpu_torch.bench import cases, roofline as roof
from spmv_scpa_tpu_torch.bench.timing import time_cuda, time_prepared
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device

TWIN_REL_L2 = 1e-6
TWIN_ROW_REL = 1e-5


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
    return float(np.median(time_cuda(fn, *args, reps=20)))


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

    # 3. kernel against plain version, small shapes
    for name, (make, kw) in cases.SMALL_CASES.items():
        A = make()
        before = lane_ell.KERNEL_LAUNCHES
        prep = hybrid.prepare(A, device=dev, **kw)
        x = make_x(A.n)
        xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
        yk, yt = prep.fn(xd), prep.plain(xd)
        torch.cuda.synchronize()
        rel_l2, row_rel, dmax = twin_check(A, x, yk, yt, name)
        rel_o = validate_result(spmv_oracle(A, x), to_numpy(yk),
                                what=f"cuda-hybrid on {name}")
        launched = lane_ell.KERNEL_LAUNCHES - before
        if launched < 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        m = prep.meta
        print(f"[small] {name}: nnz {A.nnz} QT {m['slots'] + m['ov_slots']}"
              f" idx8 {m['idx8_planes']} hot {m['hot_strips']} dyn "
              f"{m['dyn_planes']} tail {m['tail_nnz']} | vs plain rel-L2 "
              f"{rel_l2:.3e} row {row_rel:.3e} max|d| {dmax:.3e} | vs "
              f"oracle rel {rel_o:.3e} | launches +{launched}", flush=True)

    # 4. stream probe against its plain version
    buf = torch.ones(roof.PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    ok_, ot_ = roof.stream_reduce(buf), roof.stream_reduce_plain(buf)
    want = float(buf.numel() // roof.TILE)
    if not (torch.equal(ok_, ot_) and bool((ok_ == want).all())):
        raise AssertionError("stream probe disagrees with its plain "
                             "version")
    probe_err = float((ok_ - ot_).abs().max())
    probe_ms = median_ms(roof.stream_reduce, buf)
    probe_plain_ms = median_ms(roof.stream_reduce_plain, buf)
    print(f"[probe] {roof.PROBE_BYTES} B: exact match ({want:.0f} per "
          f"position) | kernel {probe_ms:.4f} ms = "
          f"{roof.PROBE_BYTES / probe_ms / 1e6:.1f} GB/s | plain "
          f"{probe_plain_ms:.4f} ms | {card}", flush=True)
    del buf

    # 5. the main path at full size
    A = cases.flagship()
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    lane_ell.KERNEL_LAUNCHES = 0
    roof.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    prep = hybrid.prepare(A, device="cuda", **cases.FLAGSHIP_KNOBS)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what="cuda-hybrid on the flagship")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what="cuda-hybrid timed run")
    rep = roof.roofline(prep, r.duration_ms, r.gflops, x_bytes=A.n * 4,
                        y_bytes=A.m * 4)
    launches = {"lane_ell": lane_ell.KERNEL_LAUNCHES,
                "stream_probe": roof.KERNEL_LAUNCHES}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")

    m = prep.meta
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd),
                                    "flagship")
    args = prep.kernel_inputs(xd)
    core_err = float((lane_ell.lane_ell_spmv(*args)
                      - lane_ell.lane_ell_spmv_plain(*args)).abs().max())
    kern_ms = median_ms(lane_ell.lane_ell_spmv, *args)
    plain_ms = median_ms(lane_ell.lane_ell_spmv_plain, *args)
    print(f"[flagship] nnz {A.nnz} pack {pack_s:.1f} s | loc_w "
          f"{m['loc_w']} Q {m['slots']}+{m['ov_slots']} idx8 "
          f"{m['idx8_planes']} chunk {m['chunk']} steps {m['steps']} tail "
          f"{m['tail_nnz']} fill {m['fill']:.3f} hbm_bytes {prep.hbm_bytes}"
          f" | vs oracle rel {rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} "
          f"row {row_rel:.3e} core max|d| {core_err:.3e}", flush=True)
    print(f"[flagship] call {r.duration_ms:.4f} ms = {r.gflops:.2f} "
          f"GFLOP/s | kernel {kern_ms:.4f} ms = "
          f"{2 * A.nnz / kern_ms / 1e6:.2f} GFLOP/s | plain {plain_ms:.4f} "
          f"ms | stream {rep.stream_bw_gbs:.1f} GB/s vs_roofline "
          f"{rep.fraction:.4f} vs_ideal_roofline {rep.fraction_ideal:.4f} "
          f"| launches {launches} | {card}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "lane_ell_spmv", "route": "cuda",
         "source": "spmv_scpa_tpu_torch/csrc/lane_ell.cu",
         "replaces": "spmv_scpa_tpu/ops/lane_ell.py:188",
         "launches": launches["lane_ell"], "max_abs_err": core_err,
         "ms": kern_ms, "plain_ms": plain_ms},
        {"name": "stream_reduce", "route": "cuda",
         "source": "spmv_scpa_tpu_torch/csrc/stream_probe.cu",
         "replaces": "spmv_scpa_tpu/bench/roofline.py:60",
         "launches": launches["stream_probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

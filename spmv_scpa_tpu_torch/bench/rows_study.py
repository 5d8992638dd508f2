"""Design study of the row-layout PELL kernel on the card.

    python -m spmv_scpa_tpu_torch.bench.rows_study

Times ``pell_rows`` / ``pell_rows_fp64`` (``csrc/pell_rows.cu``) against
the two designs of ``bench/rows_study.cu`` that it replaced, on the
matrices of the row layout's main paths: ``powerlaw100k`` at f32 and
fp64 (``cuda-pell``, ``cuda-pell-fp64``) and ``webbase1m``'s compact tail
(the hybrid's big tail). Each design's y must equal the kernel's bit for
bit (one order of sums); times are device medians (``time_device``),
taken in turns: kernel, groups16, ring<2>, ring<4>, then back. Prints
the card's ``nvidia-smi`` name and power limit, then a line per matrix.
Needs the card and ``nvcc``; the library is built into ``_build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.bench.timing import time_device
from spmv_scpa_tpu_torch.ops import lane_ell, pell, pell_rows
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.vector import make_x

SOURCE = Path(__file__).resolve().parent / "rows_study.cu"
DESIGNS = ("groups16", "ring2", "ring4")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet


def build() -> ctypes.CDLL:
    header = _kernels.CSRC_DIR / "pell_rows.cuh"
    digest = hashlib.sha256(SOURCE.read_bytes() + header.read_bytes()
                            + " ".join(_kernels.NVCC_FLAGS).encode())
    out = _kernels.BUILD_DIR / f"librows_study-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                        str(tmp), str(SOURCE)], check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rows_study.argtypes = [I] + [P] * 7 + [I, ctypes.c_int64] + [I] * 4 \
        + [P]
    lib.rows_study.restype = I
    return lib


def study(lib, name, plan, n, dev):
    """One matrix: each design's y against the kernel's, and the times."""
    t = {k: torch.as_tensor(getattr(plan, k), device=dev)
         for k in ("vals", "cols", "qptr", "blk_lo")}
    x = torch.as_tensor(make_x(n), dtype=plan.dtype, device=dev)
    fp64 = plan.dtype == torch.float64
    kernel = pell_rows.pell_rows_fp64 if fp64 else pell_rows.pell_rows
    args = (t["vals"], t["cols"], t["qptr"], t["blk_lo"], x)
    want = kernel(*args)
    nb = t["blk_lo"].numel() - 1
    pad = nb * pell_rows.BLOCK_SLOTS - t["vals"].numel()
    padded = (torch.cat([t["vals"].view(-1), t["vals"].new_zeros(pad)]),
              torch.cat([t["cols"].view(-1), t["cols"].new_zeros(pad)]))
    y = torch.empty(plan.m, dtype=plan.dtype, device=dev)
    carry = torch.empty(2 * max(nb, 1), dtype=plan.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(design):
        vals, cols = padded if design else (t["vals"], t["cols"])
        err = lib.rows_study(design, vals.data_ptr(), cols.data_ptr(),
                             t["qptr"].data_ptr(), t["blk_lo"].data_ptr(),
                             x.data_ptr(), carry.data_ptr(), y.data_ptr(),
                             nb, vals.numel(), plan.m, n, plan.quantum,
                             int(fp64), stream)
        if err:
            raise RuntimeError(f"rows_study design {design}: CUDA error "
                               f"{err}")

    for d in range(len(DESIGNS)):
        run(d)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"{name}: {DESIGNS[d]}'s y differs from "
                                 "the kernel's")
    times = {k: [] for k in ("kernel", *DESIGNS)}
    order = ["kernel", *DESIGNS]
    for key in order + order[::-1]:
        fn = ((lambda: kernel(*args)) if key == "kernel"
              else (lambda d=DESIGNS.index(key): run(d)))
        times[key].append(float(np.median(time_device(fn, reps=20))))
    bound = plan.hbm_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[{name}] Q {plan.quantum} blocks {nb} hbm_bytes "
          f"{plan.hbm_bytes} (bound {bound:.4f} ms) | " + " | ".join(
              f"{k} " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
              for k, vs in times.items()) + " | each y equal to the "
          "kernel's", flush=True)


def main() -> int:
    dev = cuda_device()
    print(card_label(), flush=True)
    lib = build()
    A = cases.powerlaw100k()
    study(lib, "powerlaw100k", pell.plan_rows(A), A.n, dev)
    study(lib, "powerlaw100k-fp64", pell.plan_rows(A, torch.float64), A.n,
          dev)
    W = cases.webbase1m()
    tail, _ = lane_ell.compact_tail(W, lane_ell.pack_lane_ell(W))
    study(lib, "webbase1m-tail", pell.plan_rows(tail), tail.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

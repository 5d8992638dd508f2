"""Where the bitmap BCSR kernels' time goes, on the card: each kernel of
``csrc/bcsr_bits.cu`` timed as committed and with one part of its work
taken out (a text substitution in a copy of the source, built beside
the port's own libraries), on the flagship (SpMV, and SpMM at 8
columns) and ``stencil48k`` (SpMM at 64 columns):

    python -m spmv_scpa_tpu_torch.bench.bits_study

The ablations compute wrong results on purpose; only their times count.
What each takes out:

* SpMV ``no-sums``: the summation of staged slots (the staging of masks
  and values, the x loads and the writes of y stay);
* SpMV ``no-value-reads``: the shared-memory value reads (a constant);
* SpMV ``no-x``: the x loads (a constant);
* SpMM ``no-x``, ``no-values``, ``no-fp``: the X row loads, the value
  loads, or the multiply-adds (a plain add in their place).

Each line gives the device ms (``bench.timing.time_device``, median of
20) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.bench.timing import time_device
from spmv_scpa_tpu_torch.ops import bcsr_bits
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device

SPMV = {
    "no-sums": [("            acc[r] = w[r][q] & mine ? __fadd_rn(acc[r], "
                 "__fmul_rn(v, xv[q]))\n                                    "
                 ": acc[r];", "")],
    "no-value-reads": [(
        "sv[start[r] + __popc(w[r][q] & below)]", "1.0f")],
    "no-x": [("xv[q] = (any[q] & mine) && c < n ? __ldg(x + c) : 0.0f;",
              "xv[q] = 1.0f;")],
}
SPMM = {
    "no-x": [("    xv[c] = xr < n && c0 + c < cols ? "
              "__ldg(X + xr * cols + c0 + c) : 0.0f;",
              "    xv[c] = 1.0f + xr;")],
    "no-values": [("            const float v = __ldg(vals + pos[r]);",
                   "            const float v = 1.0f + pos[r];")],
    "no-fp": [("              acc[r][c] = __fadd_rn(acc[r][c], "
               "__fmul_rn(v, xv[c]));",
               "              acc[r][c] = v + xv[c];")],
}


def build_variant(name: str, subs) -> ctypes.CDLL:
    """``csrc/bcsr_bits.cu`` with ``subs`` applied, built into ``_build``."""
    src = (_kernels.CSRC_DIR / "bcsr_bits.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"bits_study: {name}: text not in the source")
        src = src.replace(old, new)
    _kernels.BUILD_DIR.mkdir(exist_ok=True)
    cu = _kernels.BUILD_DIR / f"bits_study_{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _kernels.SIGNATURES["bcsr_bits"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_variant(lib, args, x, out, m: int) -> float:
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args] + [x.data_ptr(), out.data_ptr()]

    def call():
        if x.dim() == 1:
            err = lib.bcsr_bits(*ptrs, m, x.numel(), stream)
        else:
            err = lib.bcsr_bits_spmm(*ptrs, m, x.shape[0], x.shape[1],
                                     stream)
        if err:
            raise RuntimeError(f"bits_study: CUDA error {err}")
    return float(np.median(time_device(call, reps=20)))


def main() -> int:
    if not torch.cuda.is_available():
        print("bits_study: no CUDA device", file=sys.stderr)
        return 2
    dev = cuda_device()
    card = card_label()
    libs = {"committed": build_variant("committed", [])}
    libs.update({f"spmv-{k}": build_variant(f"spmv_{k}", v)
                 for k, v in SPMV.items()})
    libs.update({f"spmm-{k}": build_variant(f"spmm_{k}", v)
                 for k, v in SPMM.items()})
    for path, make, cols in (("flagship-bcsr", cases.flagship, None),
                             ("flagship-spmm8", cases.flagship, 8),
                             ("stencil48k-spmm64", cases.stencil48k, 64)):
        A = make()
        plan = bcsr_bits.plan_bcsr_bits(A)
        args = [torch.as_tensor(a, device=dev) for a in (
            plan.bits, plan.vals, plan.vptr, plan.pan, plan.rowptr)]
        gen = torch.Generator(device=dev).manual_seed(0)
        shape = (A.n,) if cols is None else (A.n, cols)
        x = torch.randn(shape, device=dev, generator=gen)
        out = torch.empty((A.m,) + shape[1:], device=dev)
        kind = "spmv" if cols is None else "spmm"
        times = {name: time_variant(lib, args, x, out, A.m)
                 for name, lib in libs.items()
                 if name == "committed" or name.startswith(kind)}
        print(f"[{path}] " + " | ".join(f"{k} {v:.4f} ms"
                                         for k, v in times.items())
              + f" | {card}", flush=True)
        del args, x, out
    return 0


if __name__ == "__main__":
    sys.exit(main())

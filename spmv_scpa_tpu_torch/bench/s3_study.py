"""Where XPOSE's row-sum S3 kernel spends its time, on the card:
``xpose_s3_rows`` (``csrc/xpose.cu``) timed as committed and in copies of
the source with one part taken out or one knob changed (text
substitutions, built beside the port's own libraries), on the slot
tables of the three full-size XPOSE paths (``webbase1m`` and
``random30k`` through ``cuda-xpose``, ``amazon262k``'s far part through
``cuda-nearfar``):

    python -m spmv_scpa_tpu_torch.bench.s3_study

The ablations compute wrong results on purpose; only their times count:

* ``no-mid``: the product loads from mid (a position's value in their
  place); the pointer and position loads, the adds and y stay;
* ``mid-128k``: the product loads kept, but confined to mid's first
  128 KB (``p & 32767``), as if every product hit in L1: what the
  scattered sectors of mid cost;
* ``no-slots``: the walk over a row's slots (y gets the row's length);
  the pointer loads and y stay;
* ``no-long``: the whole-warp passes over rows of more than 32 slots
  (those rows get 0.0);
* ``block128``, ``block512``: 128 or 512 threads a block instead of 256
  (same order, so y must stay bit-equal);
* ``depth8``, ``depth4``: a lane keeps 8 or 4 loads in flight instead of
  16 (same order, so y must stay bit-equal);
* ``short8``: rows of more than 8 slots go to the whole warp (another
  order, so y only within rel-L2 1e-6).

Each line gives the device ms (``bench.timing.time_device``, median of
20, the variants timed in turns and then in the reverse order), the
kernel's bytes bound at 3.35 TB/s and the card's name and power limit.
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
from spmv_scpa_tpu_torch.ops import nearfar, xpose
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.vector import make_x

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
LOAD = "  return p >= 0 && p < n_mid ? __ldg(mid + p) : 0.0f;"
WALK = ("  if (hi - lo <= kShortRow) acc = strided_sum(mid, n_mid, pos, lo, "
        "hi, 1);\n  unsigned long_rows = __ballot_sync(kFull, hi - lo > "
        "kShortRow);")
DEPTH = "constexpr int kDepth = 16;"
BALLOT = ("  unsigned long_rows = __ballot_sync(kFull, hi - lo > "
          "kShortRow);")
BLOCK = "constexpr int kRowThreads = 256;"
SHORT = "constexpr int kShortRow = 32;"
VARIANTS = {
    "committed": [],
    "no-mid": [(LOAD, "  return p >= 0 && p < n_mid ? "
                      "static_cast<float>(p) : 0.0f;")],
    "mid-128k": [(LOAD, "  return p >= 0 && p < n_mid ? "
                        "__ldg(mid + (p & 32767)) : 0.0f;")],
    "no-slots": [(WALK, "  acc = static_cast<float>(hi - lo);\n"
                        "  unsigned long_rows = 0;")],
    "no-long": [(BALLOT, "  unsigned long_rows = 0;")],
    "block128": [(BLOCK, "constexpr int kRowThreads = 128;")],
    "block512": [(BLOCK, "constexpr int kRowThreads = 512;")],
    "depth8": [(DEPTH, "constexpr int kDepth = 8;")],
    "depth4": [(DEPTH, "constexpr int kDepth = 4;")],
    "short8": [(SHORT, "constexpr int kShortRow = 8;")],
}
SAME_ORDER = ("committed", "block128", "block512", "depth8", "depth4")


def build_variant(name: str, subs) -> ctypes.CDLL:
    """``csrc/xpose.cu`` with ``subs`` applied, built into ``_build``."""
    src = (_kernels.CSRC_DIR / "xpose.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"s3_study: {name}: text not in the source")
        src = src.replace(old, new)
    _kernels.BUILD_DIR.mkdir(exist_ok=True)
    cu = _kernels.BUILD_DIR / f"s3_study_{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.xpose_s3_rows.argtypes = list(
        _kernels.SIGNATURES["xpose"]["xpose_s3_rows"])
    lib.xpose_s3_rows.restype = ctypes.c_int
    return lib


def study(name, prep, n, libs, card, dev):
    """One path's table: each variant's y against the kernel's, and the
    times. The recorded call's products come from S1's plain version on
    the card, equal to the kernel's."""
    xd = torch.as_tensor(make_x(n), dtype=torch.float32, device=dev)
    (args,) = [a for k, a in prep.kernel_calls(xd) if k == "xpose_s3_rows"]
    mid, rowptr, pos = args
    m = rowptr.numel() - 1
    want = xpose.xpose_s3_rows(mid, rowptr, pos)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib):
        err = lib.xpose_s3_rows(mid.data_ptr(), mid.numel(),
                                rowptr.data_ptr(), pos.data_ptr(),
                                pos.numel(), y.data_ptr(), m, stream)
        if err:
            raise RuntimeError(f"s3_study: CUDA error {err}")

    for key in (*SAME_ORDER, "short8"):
        call(libs[key])
        torch.cuda.synchronize()
        if key in SAME_ORDER:
            ok = torch.equal(y, want)
        else:
            ok = float((y - want).norm()) <= 1e-6 * float(want.norm())
        if not ok:
            raise AssertionError(f"{name}: {key}'s y differs from the "
                                 "kernel's")
    times = {k: [] for k in libs}
    order = list(libs)
    for key in order + order[::-1]:
        times[key].append(float(np.median(time_device(
            lambda lib=libs[key]: call(lib), reps=20))))
    src = pos.long()
    used = torch.unique(src[(src >= 0) & (src < mid.numel())]).numel()
    nbytes = (rowptr.numel() + pos.numel() + used + m) * 4
    print(f"[{name}] rows {m} slots {pos.numel()} | " + " | ".join(
        f"{k} " + ", ".join(f"{t:.4f}" for t in v) + " ms"
        for k, v in times.items())
          + f" | bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms | y of "
          f"{'/'.join(SAME_ORDER[1:])} equal to the kernel's | {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("s3_study: no CUDA device", file=sys.stderr)
        return 2
    dev = cuda_device()
    card = card_label()
    libs = {k: build_variant(k.replace("-", "_"), v)
            for k, v in VARIANTS.items()}
    W = cases.webbase1m()
    study("webbase1m-xpose", xpose.prepare_xpose(W, device=dev), W.n, libs,
          card, dev)
    R = cases.random30k()
    study("random30k", xpose.prepare_xpose(R, device=dev), R.n, libs, card,
          dev)
    A = cases.amazon262k()
    _, far = nearfar.split_by_window(A, nearfar.choose_window(A))
    study("amazon262k-nearfar", xpose.prepare_xpose(far, device=dev), far.n,
          libs, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

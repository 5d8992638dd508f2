"""Design study of the stream probe on the card.

    python -m spmv_scpa_tpu_torch.bench.probe_study

Times the probe ``stream_reduce`` and the grid-stride
``stream_reduce_strided`` (``csrc/stream_probe.cu``) against the designs
of ``bench/probe_study.cu`` (16-byte loads with an L2 prefetch hint at
other block shapes, and rings of TMA bulk copies) and ``torch.sum`` on
one buffer of ones of ``roofline.PROBE_BYTES``. Each design's tile must
equal the plain version's exactly (sums of ones); times are device
medians (``time_device``), taken in turns, every design once, then in
the reverse order. Prints the card's ``nvidia-smi`` name and power limit,
then one line per design: ms of the two turns, GB/s of their mean, and
the bytes bound at 3.35 TB/s. Needs the card and ``nvcc``; the library
is built into ``_build/``.
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
from spmv_scpa_tpu_torch.bench import roofline as roof
from spmv_scpa_tpu_torch.bench.timing import time_device
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device

SOURCE = Path(__file__).resolve().parent / "probe_study.cu"
# design id in probe_study.cu -> (name, blocks an SM)
# (the probe itself is a ring of 4 x 32 KB at one block an SM)
DESIGNS = {0: ("ldg512x8@2", 2), 1: ("ldg1024x8@1", 1),
           2: ("ldg1024x4@1", 1), 3: ("ldg512x16@1", 1),
           4: ("ring6x32K@1", 1), 5: ("ring8x16K@1", 1),
           6: ("ring3x32K@2", 2)}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet


def build() -> ctypes.CDLL:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_kernels.NVCC_FLAGS).encode())
    out = _kernels.BUILD_DIR / f"libprobe_study-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                        str(tmp), str(SOURCE)], check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.probe_study.argtypes = [ctypes.c_int, P, ctypes.c_int64,
                                ctypes.c_int, P, P]
    lib.probe_study.restype = ctypes.c_int
    lib.probe_study_error.argtypes = [ctypes.c_int]
    lib.probe_study_error.restype = ctypes.c_char_p
    return lib


def design_fn(lib, design: int, sms: int):
    """``fn(buf) -> (8, 128)`` through one design of the study."""
    per_sm = DESIGNS[design][1]

    def fn(buf):
        out = torch.zeros(8, 128, dtype=torch.float32, device=buf.device)
        err = lib.probe_study(design, buf.data_ptr(), buf.numel(),
                              per_sm * sms, out.data_ptr(),
                              _kernels.stream_handle(buf.device))
        if err:
            raise RuntimeError(f"probe_study {DESIGNS[design][0]}: CUDA "
                               f"error {err} "
                               f"({lib.probe_study_error(err).decode()})")
        return out

    return fn


def main() -> int:
    dev = cuda_device()
    card = card_label()
    print(card, flush=True)
    lib = build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = {"stream_reduce": roof.stream_reduce,
           "stream_reduce_strided": roof.stream_reduce_strided,
           **{DESIGNS[d][0]: design_fn(lib, d, sms) for d in DESIGNS},
           "torch.sum": lambda b: b.sum()}
    # exactness on a length that is no multiple of a block's span
    odd = torch.ones(roof.TILE * 100_003, dtype=torch.float32, device=dev)
    buf = torch.ones(roof.PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    for name, fn in fns.items():
        if name == "torch.sum":
            continue
        for b in (odd, buf):
            got = fn(b)
            torch.cuda.synchronize()
            if not torch.equal(got, roof.stream_reduce_plain(b)):
                raise AssertionError(f"{name} differs from the plain "
                                     f"version on {b.numel()} floats")
    times = {k: [] for k in fns}
    order = list(fns)
    for name in order + order[::-1]:
        times[name].append(float(np.median(time_device(fns[name], buf,
                                                       reps=20))))
    bound = roof.PROBE_BYTES / HBM_BYTES_PER_S * 1e3
    for name, ts in times.items():
        gbs = roof.PROBE_BYTES / (np.mean(ts) * 1e-3) / 1e9
        print(f"[probe-study] {name}: "
              + ", ".join(f"{t:.4f}" for t in ts)
              + f" ms = {gbs:.1f} GB/s | bound {bound:.4f} ms | exact on "
              f"{buf.numel()} and {odd.numel()} floats | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

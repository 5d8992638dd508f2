"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, on first use, under
``_build/`` (listed in ``.gitignore``). The library's file name carries
a hash of its source and flags, so an edited source builds anew and an
unchanged one is reused; nvcc writes to a temporary name that is then
renamed, so a reader never sees half a library. Libraries are loaded
with ``ctypes``; every entry point returns ``cudaGetLastError()`` and
:func:`check` turns a non-zero code into an exception.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64

# C entry points of each source: name -> argtypes (restype is int).
SIGNATURES = {
    "lane_ell": {"lane_ell_spmv": (P, P, P, P, P, P, P, P,
                                   I, I, I, I, I, I, I, I, I, P),
                 "lane_ell_fp64": (P, P, P, P, I, I, I, P),
                 "lane_ell_sharded": (P, P, P, P, P, P, P, P, I64,
                                      I, I, I, I, I, I, I, I, P)},
    "lane_rows": {"lane_rows": (P, P, P, P, P, P, P, P, I, I64, I, I, I,
                                P)},
    "stream_probe": {"stream_reduce": (P, I64, I, P, P),
                     "stream_reduce_strided": (P, I64, I, P, P)},
    "ext_gather": {"sorted_gather": (P, P, P, P, P, I, I, I64, P),
                   "ranked_gather": (P, P, P, P, I, I, P),
                   "window_gather": (P, P, P, P, P, I, I, I64, P)},
    "chips_products": {"chips_products": (P, P, P, I64, P, I64, P)},
    "segsum": {"dest_segsum": (P, P, P, P, P, P, P, P, I, I, I, P)},
    "pell": {"pell_tiles": (P, P, P, P, P, I64, I, I, I, I, I, P),
             "pell_fused": (P, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, I, I, I, I, I, P),
             "pell_fused_fp64": (P, P, P, P, P, P, P, P, P,
                                 I, I, I, I, I, I, I, I, I, I, P),
             "pell_unpermute": (P, P, P, I64, I, P)},
    "pell_rows": {"pell_rows": (P, P, P, P, P, P, P, I, I64, I, I, I, P),
                  "pell_rows_fp64": (P, P, P, P, P, P, P, I, I64, I, I, I,
                                     P)},
    "xpose": {"xpose_mirror": (P, I64, P, P, P, P, I, P),
              "xpose_s1": (P, I64, P, I, I, P, P, P, P, P, P, I, I, P),
              "xpose_s1_slots": (P, I64, P, P, P, I, I, P, I64, I, P),
              "xpose_s3": (P, P, P, I, I, I64, P),
              "xpose_s3_rows": (P, I64, P, P, I, P, I, P)},
    "spmm": {"bcsr_spmm": (P, P, P, P, P, I, I, I, P)},
    "bcsr_bits": {"bcsr_bits": (P, P, P, P, P, P, P, I, I, P),
                  "bcsr_bits_spmm": (P, P, P, P, P, P, P, I, I, I, P)},
}

_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from csrc/ on the machine with the card")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built (the hash
    covers the source, the shared headers ``csrc/*.cuh`` and the flags)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name])[0]


def build_all(names=None) -> list[Path]:
    """Compile the given sources (all of ``SIGNATURES`` by default) that
    are not built yet, one nvcc process each, all started together."""
    names = list(SIGNATURES if names is None else names)
    outs = [library_path(name) for name in names]
    todo = [(name, out) for name, out in zip(names, outs)
            if not out.exists()]
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with argtypes set."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.spmv_error_string.argtypes = [ctypes.c_int]
        lib.spmv_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.spmv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

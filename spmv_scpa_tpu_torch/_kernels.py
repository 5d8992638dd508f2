"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, on first use, under
``_build/`` (listed in ``.gitignore``). The library's file name carries
a hash of its source and flags, so an edited source builds anew and an
unchanged one is reused; nvcc writes to a temporary name that is then
renamed, so a reader never sees half a library. Libraries are loaded
with ``ctypes``; every entry point returns ``cudaGetLastError()`` and
:func:`check` turns a non-zero code into an exception.

The host harness's C++ sources (``native/*.cpp``: the Matrix Market
parser and the OpenMP kernels, copies of the JAX package's
``native/``) are built the same way by ``g++`` (:func:`build_native`),
into the same directory, keyed on their source, flags, compiler and
CPU.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import torch

from spmv_scpa_tpu_torch import trace

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# native/Makefile's flags: a source built by both packages computes the
# same bits (-march=native lets g++ contract a*b + c into one FMA).
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")
# native/<name>.cpp -> its extra flags
NATIVE = {"mtx_parser": (), "spmv_omp": ("-fopenmp",)}
# What a failed native build or load raises: the native modules then
# report the library unavailable.
BUILD_ERRORS = (OSError, RuntimeError, subprocess.SubprocessError)

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
    "heavy_land": {"heavy_land": (P, P, P, I64, I64, P)},
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
              "xpose_s3_rows": (P, I64, P, P, I, P, I, P, I, P)},
    "spmm": {"bcsr_spmm": (P, P, P, P, P, I, I, I, P)},
    "bcsr_bits": {"bcsr_bits": (P, P, P, P, P, P, P, I, I, P),
                  "bcsr_bits_spmm": (P, P, P, P, P, P, P, I, I, I, P),
                  "bcsr_bits_spmm_design": (I,)},
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
    if todo:
        nvcc = find_nvcc()
        _compile([((nvcc, *NVCC_FLAGS), CSRC_DIR / f"{name}.cu", out)
                  for name, out in todo])
    return outs


@trace.span("kernels.build")
def _compile(jobs) -> None:
    """Run each job ``(command, source, library)`` as ``command -o tmp
    source``, all started together; each output is renamed onto its
    library when its compiler succeeds, so a reader never sees half a
    library. Raises with every failure's output."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for cmd, src, out in jobs:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{Path(proc.args[0]).name} failed to build "
                          f"{src.parent.name}/{src.name} (exit "
                          f"{proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def _host_key() -> bytes:
    """What a ``-march=native`` build depends on beside its source and
    flags: the compiler's version and this CPU's features."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's native parser and "
                           "OpenMP kernels are built from native/*.cpp")
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    try:
        cpu = next(ln for ln in Path("/proc/cpuinfo").read_text()
                   .splitlines() if ln.startswith("flags"))
    except (OSError, StopIteration):
        cpu = platform.processor()
    return (version + cpu).encode()


def native_library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` lives once built."""
    flags = GXX_FLAGS + NATIVE[name]
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes()
                            + " ".join(flags).encode()
                            + _host_key()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_native(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with g++ unless it is built."""
    out = native_library_path(name)
    if not out.exists():
        _compile([(("g++", *GXX_FLAGS, *NATIVE[name]),
                   NATIVE_DIR / f"{name}.cpp", out)])
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with argtypes set.
    The first load of a library is a ``kernels.load`` span (``built``:
    whether nvcc ran)."""
    lib = _LOADED.get(name)
    if lib is None:
        with trace.span("kernels.load", name=name) as s:
            s.attrs["built"] = not library_path(name).exists()
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


def stream_getter(device):
    """A function of no argument that returns :func:`stream_handle` of
    ``device`` (a CUDA device with its index), through PyTorch's raw
    stream query where this build has it: no stream object is made."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None or device.index is None:
        return lambda: stream_handle(device)
    index = device.index
    return lambda: raw(index)

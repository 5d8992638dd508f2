"""Where XPOSE's slot-table S1 kernel spends its time, on the card:
``xpose_s1_slots`` (``csrc/xpose.cu``) timed as committed and in copies
of the source with one part taken out or one knob changed (text
substitutions, built beside the port's own libraries), and a flat
12-byte table (``bench/s1_study.cu``), on the slot tables of the three
full-size XPOSE paths (``webbase1m`` and ``random30k`` through
``cuda-xpose``, ``amazon262k``'s far part through ``cuda-nearfar``):

    python -m spmv_scpa_tpu_torch.bench.s1_study

The ablations compute wrong results on purpose; only their times count:

* ``no-x``: the x gathers (an entry's value stands for its product);
  the table loads and the stores stay;
* ``no-stores``: the stores into mid (kept only for a product equal to
  1.5e-38, which none is); the table loads and x gathers stay;
* ``contiguous``: a lane's four entries stored at four consecutive
  positions of mid, its quad's index times four (as if the table were in
  S3's row order and S3's positions the identity; each store instruction
  strides 16 B): what the scattered store sectors cost.

Other designs, whose mid must equal the committed kernel's at every slot
it writes:

* ``flat12``: a flat table of 12 B an entry (position, column, value,
  sorted by position and interleaved as the committed table, four
  entries a thread) against the committed 8 B (step and source windows
  in a 32-byte header a chunk of 1024);
* ``t128``: 128 threads a block, 8 entries a thread (chunks of 1024);
* ``t128-c512``: 128 threads a block, chunks of 512 (4 a thread);
* ``c2048``: 256 threads a block, chunks of 2048 (8 a thread);
* ``prefetch-c2048``: the same, both passes' table loads issued before
  either pass's gathers and stores.

Each line gives the device ms (``bench.timing.time_device``, median of
20, the variants timed in turns and then in the reverse order), the
bounds of the 8 B and the 12 B tables at 3.35 TB/s (table, slots written,
distinct x elements read), and the card's name and power limit. A
second line per path gives the whole call (S1 on the slots, S3 as row
sums) as the caller sees it (``time_cuda``) and on the device alone
(``time_device``), the two kernels alone back to back, and cuSPARSE's
CSR product of the path's matrix.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.bench.timing import time_cuda, time_device
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import nearfar, xpose, xpose_plan
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.vector import make_x

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
GATHER = "p[j] = __fmul_rn(__ldg(x + col), vs[j]);"
STORE = "if (pos >= 0 && pos < n_mid) mid[pos] = p[j];"
POS = ("const int64_t pos = (static_cast<int64_t>(kc2 >> 7) * J1 + s) * "
       "kLanes + (kc2 & (kLanes - 1));")
THREADS = "constexpr int kSlotThreads = 256;"
LOOP = """  for (int e = threadIdx.x; e < chunk4; e += kSlotThreads) {
    const int64_t i = b * chunk4 + e;
    slot_quad(x, n, __ldcs(code + i), __ldcs(val + i), s, src, mid, n_mid, J1);
  }"""
# two passes a thread, both passes' table loads issued before either's
# gathers and stores
PREFETCH = """  for (int e = threadIdx.x; e < chunk4; e += 2 * kSlotThreads) {
    const int64_t i = b * chunk4 + e;
    const uint4 c0 = __ldcs(code + i);
    const float4 v0 = __ldcs(val + i);
    uint4 c1 = make_uint4(~0u, ~0u, ~0u, ~0u);
    float4 v1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (e + kSlotThreads < chunk4) {
      c1 = __ldcs(code + i + kSlotThreads);
      v1 = __ldcs(val + i + kSlotThreads);
    }
    slot_quad(x, n, c0, v0, s, src, mid, n_mid, J1);
    slot_quad(x, n, c1, v1, s, src, mid, n_mid, J1);
  }"""
# name: (substitutions of csrc/xpose.cu, the table's chunk)
VARIANTS = {
    "committed": ([], xpose.SLOT_CHUNK),
    "no-x": ([(GATHER, "p[j] = vs[j];")], xpose.SLOT_CHUNK),
    "no-stores": ([(STORE, "if (pos >= 0 && pos < n_mid && p[j] == 1.5e-38f)"
                           " mid[pos] = p[j];")], xpose.SLOT_CHUNK),
    "contiguous": ([(POS, "const int64_t pos = ((static_cast<int64_t>("
                          "blockIdx.x) * blockDim.x + threadIdx.x) * 4 + j)"
                          " % n_mid;")], xpose.SLOT_CHUNK),
    "t128": ([(THREADS, "constexpr int kSlotThreads = 128;")],
             xpose.SLOT_CHUNK),
    "t128-c512": ([(THREADS, "constexpr int kSlotThreads = 128;")], 512),
    "c2048": ([], 2048),
    "prefetch-c2048": ([(LOOP, PREFETCH)], 2048),
}
SAME_RESULT = ("committed", "t128", "t128-c512", "c2048", "prefetch-c2048",
               "flat12")


def _build(name: str, src: str, entry: str, argtypes) -> ctypes.CDLL:
    _kernels.BUILD_DIR.mkdir(exist_ok=True)
    cu = _kernels.BUILD_DIR / f"s1_study_{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    getattr(lib, entry).argtypes = list(argtypes)
    getattr(lib, entry).restype = ctypes.c_int
    return lib


def build_variants() -> dict:
    """Each variant of ``VARIANTS`` built (one per distinct source), and
    the flat kernel."""
    P, I64 = _kernels.P, _kernels.I64
    base = (_kernels.CSRC_DIR / "xpose.cu").read_text()
    sig = _kernels.SIGNATURES["xpose"]["xpose_s1_slots"]
    libs = {}
    for name, (subs, _) in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"s1_study: {name}: text not in the "
                                   "source")
            src = src.replace(old, new)
        libs[name] = _build(name.replace("-", "_"), src, "xpose_s1_slots",
                            sig)
    flat = (_kernels.PKG_DIR / "bench" / "s1_study.cu").read_text()
    libs["flat12"] = _build("flat12", flat, "s1_flat",
                            (P, I64, P, P, P, I64, P, I64, P))
    return libs


def flat_table(head, code, val, J1):
    """The same entries as a flat table sorted by mid position and
    interleaved as the committed table is (``xpose.slot_order``): (pos,
    col, val) int32, int32, f32, padded to a multiple of 128 with
    position -1 (column -1 where no x is read)."""
    pos, col, live = xpose.decode_slots(head, code, J1)
    pos, col, v = pos[live], col[live], val[live]
    order = torch.argsort(pos)
    pos, col, v = pos[order], col[order], v[order]
    pad = -pos.numel() % xpose.SLOT_GROUP
    dev = pos.device
    pos = torch.cat([pos, torch.full((pad,), -1, device=dev)])
    col = torch.cat([torch.where(v != 0, col, -1),
                     torch.full((pad,), -1, device=dev)])
    v = torch.cat([v, torch.zeros(pad, device=dev)])
    at = torch.as_tensor(xpose.slot_order(np.arange(pos.numel())),
                         device=dev)
    out = []
    for t, dtype in ((pos, torch.int32), (col, torch.int32),
                     (v, torch.float32)):
        u = torch.empty(t.numel(), dtype=dtype, device=dev)
        u[at] = t.to(dtype)
        out.append(u)
    return tuple(out)


def study(name, A, prep, libs, card, dev):
    """One path's table: each variant's mid against the kernel's, the
    times, and the whole call."""
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=dev)
    plan = xpose_plan.plan_xpose(A)
    rowptr, pos3 = xpose.s3_rows_table(plan)
    B2, J1, n = plan.B2, plan.J1, A.n
    n_mid = B2 * J1 * BC
    mid = torch.empty(n_mid, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tables = {}
    for chunk in sorted({c for _, c in VARIANTS.values()}):
        tables[chunk] = [torch.as_tensor(a, device=dev)
                         for a in xpose.s1_slots_table(plan, pos3, chunk)]
    fpos, fcol, fval = flat_table(*tables[xpose.SLOT_CHUNK], J1)

    def call(key):
        if key == "flat12":
            err = libs[key].s1_flat(xd.data_ptr(), n, fpos.data_ptr(),
                                    fcol.data_ptr(), fval.data_ptr(),
                                    fpos.numel() // 4, mid.data_ptr(), n_mid,
                                    stream)
        else:
            head, code, val = tables[VARIANTS[key][1]]
            err = libs[key].xpose_s1_slots(
                xd.data_ptr(), n, head.data_ptr(), code.data_ptr(),
                val.data_ptr(), code.shape[0], code.shape[1], mid.data_ptr(),
                n_mid, J1, stream)
        if err:
            raise RuntimeError(f"s1_study: {key}: CUDA error {err}")

    at = torch.as_tensor(np.unique(pos3), dtype=torch.int64, device=dev)
    want = xpose.xpose_s1_slots(xd, *tables[xpose.SLOT_CHUNK], B2, J1)
    want = want.view(-1)[at]
    for key in SAME_RESULT:
        call(key)
        torch.cuda.synchronize()
        if not torch.equal(mid[at], want):
            raise AssertionError(f"{name}: {key}'s mid differs from the "
                                 "kernel's")
    times = {k: [] for k in libs}
    order = list(libs)
    for key in order + order[::-1]:
        times[key].append(float(np.median(time_device(
            lambda k=key: call(k), reps=20))))
    head, code, val = tables[xpose.SLOT_CHUNK]
    _, col, live = xpose.decode_slots(head, code, J1)
    reads = live & (val != 0)
    x_bytes = torch.unique(col[reads]).numel() * 4
    b8 = (head.numel() + code.numel() + val.numel()) * 4 + at.numel() * 4
    b12 = fpos.numel() * 12 + at.numel() * 4

    def ms(nbytes):
        return (nbytes + x_bytes) / HBM_BYTES_PER_S * 1e3

    print(f"[{name}] slots {at.numel()} chunks {code.shape[0]} (padding "
          f"{code.numel() - at.numel()}) | " + " | ".join(
              f"{k} " + ", ".join(f"{t:.4f}" for t in v) + " ms"
              for k, v in times.items())
          + f" | bound 8 B {ms(b8):.4f} ms, 12 B {ms(b12):.4f} ms | mid of "
          f"{'/'.join(SAME_RESULT[1:])} equal to the kernel's | {card}",
          flush=True)
    (s1, a1), (s3, a3) = prep.kernel_calls(xd)
    kern = {s1: getattr(xpose.KERNELS, s1), s3: getattr(xpose.KERNELS, s3)}

    def kernels():
        kern[s3](kern[s1](*a1), *a3[1:])

    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(A.irp, dtype=torch.int64, device=dev),
        torch.as_tensor(A.ja, dtype=torch.int64, device=dev),
        torch.as_tensor(A.as_, dtype=torch.float32, device=dev),
        size=(A.m, A.n))
    x2 = xd.view(-1, 1)
    print(f"[{name}] whole call (xpose_s1_slots, xpose_s3_rows): "
          f"{np.median(time_cuda(prep.fn, xd)):.4f} ms as the caller sees "
          f"it, {np.median(time_device(prep.fn, xd)):.4f} ms on the device, "
          f"the two kernels alone {np.median(time_device(kernels)):.4f} ms | "
          f"cuSPARSE CSR of the matrix "
          f"{np.median(time_device(lambda: Acsr.matmul(x2))):.4f} ms | "
          f"{card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("s1_study: no CUDA device", file=sys.stderr)
        return 2
    dev = cuda_device()
    card = card_label()
    libs = build_variants()
    W = cases.webbase1m()
    study("webbase1m-xpose", W, xpose.prepare_xpose(W, device=dev), libs,
          card, dev)
    R = cases.random30k()
    study("random30k", R, xpose.prepare_xpose(R, device=dev), libs, card,
          dev)
    A = cases.amazon262k()
    _, far = nearfar.split_by_window(A, nearfar.choose_window(A))
    study("amazon262k-nearfar", far, xpose.prepare_xpose(far, device=dev),
          libs, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The lane-ELL core at fp64 grade on PyTorch and CUDA (``cuda-hybrid-fp64``,
counterpart of ``spmv_scpa_tpu/ops/lane_ell.py:prepare_lane_ell_df64``,
the ``pallas-hybrid-df64`` strategy).

The reference study computes in fp64 throughout (include/csr.h:12). The
TPU has no fp64, so the JAX package splits values and x into f32 hi/lo
pairs, forms Dekker products and accumulates 8 planes of 7-bit digits on
a power-of-two scale, which the host adds in float64. Hopper has native
fp64: the port computes the same function, y = A·x, in ``double``.

* :func:`pack_lane_ell_fp64` — the host half of the reference's
  ``prepare_lane_ell_df64`` (lane_ell.py:366-461), copied JAX-free: the
  scope checks (every entry inside the ``loc_w`` diagonal window, at most
  128 slot planes, the x-pair budget, each refusal a ``ValueError`` with
  the reference's words), the slot placement and the int16 window
  offsets. The value planes keep the original float64 values; the
  reference's ``vh``/``vl`` f32 planes are ``v.astype(f32)`` and
  ``(v - vh).astype(f32)`` of them (the parity tests check both).
* :func:`lane_ell_fp64` — the wrapper of the CUDA kernel
  (``csrc/lane_ell.cu``, ``lane_ell_fp64``), with
  :func:`lane_ell_fp64_plain` beside it.
* :func:`prepare_lane_ell_fp64` — stages the padded x as the reference's
  ``raw`` does (``xp[loc_w:loc_w + n_local] = x[:n_local]``) and launches
  the kernel once. x goes in as float64, y comes out float64 on the
  device; ``meta["rtol"]`` is the 1e-9 gate of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, trace
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops.lane_ell import (_LOC_CHOICES, X_VMEM_BUDGET,
                                              strip_pairs)
from spmv_scpa_tpu_torch.ops.registry import (FP64_RTOL, Prepared,
                                              record_calls)
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# Launches of the CUDA kernel by ``lane_ell_fp64`` in this process.
KERNEL_LAUNCHES = 0


@dataclass(frozen=True)
class LaneFp64Cfg:
    """Static geometry of one packed matrix: Q slot planes, ``chunk``
    128-row groups per step, ``P_pad`` rows of the padded x."""

    Q: int
    chunk: int
    steps: int
    P_pad: int

    @property
    def G_pad(self) -> int:
        return self.steps * self.chunk


@dataclass
class LaneFp64Plan:
    cfg: LaneFp64Cfg
    vals: np.ndarray        # (steps*Q*chunk, 128) float64
    idx: np.ndarray         # (steps*Q*chunk, 128) int16 window offsets
    used: tuple             # per plane, the window strips its entries read
    loc_w: int
    n_local: int
    m: int
    n: int
    meta: dict

    @property
    def slots(self) -> int:
        return self.vals.size


@trace.span("pack.plan", fn="pack_lane_ell_fp64")
def pack_lane_ell_fp64(A: CSR, chunk: int | None = None,
                       loc_w: int | str = "auto", **_) -> LaneFp64Plan:
    """Pack ``A`` as the reference's ``prepare_lane_ell_df64`` does (its
    knobs and defaults; TPU-only ones are ignored, as there)."""
    m, n = A.m, A.n
    nnz = A.nnz
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)

    if loc_w == "auto":
        loc_w = _LOC_CHOICES[-1]
        if nnz:
            d = np.abs(cols - rows)
            for w in _LOC_CHOICES:
                if float(np.max(d, initial=0)) <= w:
                    loc_w = w
                    break
    if loc_w % BC:
        raise ValueError("loc_w must be a multiple of 128")
    S = 1 + 2 * (loc_w // BC)

    grp = rows // BC
    off = cols - grp * BC + loc_w
    if nnz and not bool(np.all((off >= 0) & (off < S * BC))):
        n_out = int(np.sum((off < 0) | (off >= S * BC)))
        raise ValueError(
            f"cuda-hybrid-fp64: {n_out} entries outside the loc_w={loc_w} "
            "diagonal window (no fp64 tail); use cuda-pell-fp64 (the "
            "reference's pallas-pell-df64)")
    sl = (np.arange(nnz, dtype=np.int64)
          - A.irp[rows].astype(np.int64)) if nnz else np.zeros(0, np.int64)
    Q = int(sl.max(initial=0)) + 1
    if Q > 128:
        raise ValueError(
            f"cuda-hybrid-fp64: max row length {Q} > 128 slot planes; use "
            "cuda-pell-fp64")
    if chunk is None:
        chunk = max(8, min(256, (2048 // Q) // 8 * 8))

    G_tot = max(1, -(-m // BC))
    G_pad = -(-G_tot // chunk) * chunk
    steps = G_pad // chunk
    P_pad = G_pad + S
    x_bytes = 2 * P_pad * BC * 4
    if x_bytes > X_VMEM_BUDGET:
        # the reference's resident hi/lo x pair on the TPU, kept for
        # parity until ROADMAP queue 1 #5 drops it
        raise ValueError(
            f"cuda-hybrid-fp64: resident x pair ({x_bytes} B) exceeds the "
            f"budget {X_VMEM_BUDGET} B; use torch-ell-fp64")
    n_local = min(n, P_pad * BC - loc_w)

    vals = np.zeros((steps * Q * chunk, BC), np.float64)
    idx = np.zeros((steps * Q * chunk, BC), np.int16)
    used: list[list] = [[] for _ in range(Q)]
    if nnz:
        lane = rows % BC
        arow = (grp // chunk) * (Q * chunk) + sl * chunk + grp % chunk
        vals[arow, lane] = np.asarray(A.as_, np.float64)
        idx[arow, lane] = off.astype(np.int16)
        for key in strip_pairs(sl, off // BC, S, Q)[0].tolist():
            used[key // S].append(key % S)
    meta = {"loc_w": loc_w, "slots": Q, "strips": S, "chunk": chunk,
            "steps": steps, "fill": float(nnz) / max(G_pad * Q * BC, 1),
            "rtol": FP64_RTOL}
    return LaneFp64Plan(
        cfg=LaneFp64Cfg(Q=Q, chunk=chunk, steps=steps, P_pad=P_pad),
        vals=vals, idx=idx, used=tuple(tuple(u) for u in used),
        loc_w=loc_w, n_local=n_local, m=m, n=n, meta=meta)


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _check_args(xpad, vals, idx, cfg: LaneFp64Cfg):
    rows = cfg.steps * cfg.Q * cfg.chunk
    want = {"xpad": (xpad, torch.float64, (cfg.P_pad * BC,)),
            "vals": (vals, torch.float64, (rows, BC)),
            "idx": (idx, torch.int16, (rows, BC))}
    for name, (t, dtype, shape) in want.items():
        if t.device != xpad.device:
            raise ValueError(f"lane_ell_fp64: {name} is on {t.device}, xpad "
                             f"on {xpad.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"lane_ell_fp64: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"lane_ell_fp64: {name} is not contiguous")
    if xpad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_ell_fp64: unsupported device {xpad.device}")


@trace.launch("lane_ell_fp64")
def lane_ell_fp64(xpad, vals, idx, cfg: LaneFp64Cfg) -> torch.Tensor:
    """y (G_pad*128,) float64, row ``g*128 + l``: the sum over the slot
    planes q, in order, of ``vals[q] * xpad[g*128 + idx[q]]`` (plane q of
    group g = step*chunk + c at row (step*Q + q)*chunk + c). CUDA tensors
    launch ``csrc/lane_ell.cu``; CPU tensors run
    :func:`lane_ell_fp64_plain`."""
    global KERNEL_LAUNCHES
    _check_args(xpad, vals, idx, cfg)
    if xpad.device.type == "cpu":
        return lane_ell_fp64_plain(xpad, vals, idx, cfg)
    lib = _kernels.load("lane_ell")
    y = torch.empty(cfg.G_pad * BC, dtype=torch.float64, device=xpad.device)
    err = lib.lane_ell_fp64(xpad.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                            y.data_ptr(), cfg.G_pad, cfg.Q, cfg.chunk,
                            _kernels.stream_handle(xpad.device))
    _kernels.check(lib, err, "lane_ell_fp64")
    KERNEL_LAUNCHES += 1
    return y


def lane_ell_fp64_plain(xpad, vals, idx, cfg: LaneFp64Cfg) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: per plane in ascending
    order, gather, multiply and add in float64, product and sum rounded
    separately."""
    steps, Q, chunk = cfg.steps, cfg.Q, cfg.chunk
    v4 = vals.view(steps, Q, chunk, BC)
    i4 = idx.view(steps, Q, chunk, BC)
    base = torch.arange(cfg.G_pad, device=xpad.device).view(steps, chunk,
                                                            1) * BC
    acc = torch.zeros((steps, chunk, BC), dtype=torch.float64,
                      device=xpad.device)
    for q in range(Q):
        acc = acc + v4[:, q] * xpad[base + i4[:, q].to(torch.int64)]
    return acc.reshape(-1)


class LaneFp64Kernels(NamedTuple):
    """The functions a ``cuda-hybrid-fp64`` call runs, by name."""

    lane_ell_fp64: Callable


KERNELS = LaneFp64Kernels(lane_ell_fp64)
PLAIN = LaneFp64Kernels(lane_ell_fp64_plain)


# ---------------------------------------------------------------------------
# The strategy
# ---------------------------------------------------------------------------

def prepare_lane_ell_fp64(A: CSR, device="cuda", **knobs) -> Prepared:
    """``cuda-hybrid-fp64``: pack ``A`` (:func:`pack_lane_ell_fp64`) and
    bind ``fn(x) -> y`` (float64 in, float64 out) on ``device``."""
    dev = resolve_device(device)
    plan = pack_lane_ell_fp64(A, **knobs)
    cfg = plan.cfg
    with trace.span("pack.upload", bytes=plan.vals.nbytes + plan.idx.nbytes):
        vals = torch.as_tensor(plan.vals, device=dev)
        idx = torch.as_tensor(plan.idx, device=dev)
    loc_w, n_local, m, n = plan.loc_w, plan.n_local, plan.m, plan.n

    def run(x, ops):
        xd = torch.as_tensor(x, dtype=torch.float64, device=dev)
        if xd.shape != (n,):
            raise ValueError(f"cuda-hybrid-fp64: x has shape "
                             f"{tuple(xd.shape)}, expected ({n},)")
        xpad = torch.zeros(cfg.P_pad * BC, dtype=torch.float64, device=dev)
        xpad[loc_w:loc_w + n_local] = xd[:n_local]
        return ops.lane_ell_fp64(xpad, vals, idx, cfg)[:m]

    return Prepared(
        "cuda-hybrid-fp64", A.name, lambda x: run(x, KERNELS), device=dev,
        nnz=A.nnz, ref="pallas-hybrid-df64",
        hbm_bytes=plan.slots * 10 + 8 * cfg.P_pad * BC + 8 * m,
        meta=plan.meta, plain=lambda x: run(x, PLAIN),
        kernel_calls=lambda xd: record_calls(lambda ops: run(xd, ops),
                                             PLAIN))

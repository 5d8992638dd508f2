"""Near/far composition on PyTorch and CUDA (counterpart of
``spmv_scpa_tpu/ops/nearfar.py``), ``cuda-nearfar``.

A matrix with a tight diagonal band plus scattered hubs (the amazon
archetype) is split per entry at a diagonal window W, ``A = A_near +
A_far``: ``cuda-hybrid`` runs the band (its planner then sees locality
1.0: no ext panels, no chips tail) and ``cuda-xpose`` the scattered
rest, and the two y vectors add. SpMV is linear, so the split is exact
up to one f32 rounding per row.

``split_by_window`` and ``choose_window`` are copies of the reference's.
``W_CANDS``, ``FAR_MIN`` and ``NEAR_FRAC_MIN`` are the reference's
TPU-measured choices, kept for parity (ROADMAP queue 1 #5). Two of the
reference's faults are not copied: ``choose_window`` returns None on an
empty matrix instead of taking an empty mean, and a delegation keeps the
delegate's own ``meta["delegated"]`` (the hybrid's escape to PELL) under
``"delegate_delegated"`` instead of overwriting it.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops import xpose
from spmv_scpa_tpu_torch.ops.lane_ell import prepare_lane_ell_hybrid
from spmv_scpa_tpu_torch.ops.registry import Prepared
from spmv_scpa_tpu_torch.ops.xpose_plan import quick_envelope_ok
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# Split-window candidates (columns), panel-aligned powers of two.
W_CANDS = (512, 1024, 2048, 4096)
# Below this many scattered entries the split is not worth XPOSE's
# fixed pipeline (the reference's TPU estimate).
FAR_MIN = 8192
# Least fraction of the entries the band must hold for the split.
NEAR_FRAC_MIN = 0.45


def split_by_window(A: CSR, W: int) -> tuple[CSR, CSR]:
    """Exact per-entry split at |col - row| <= W (same (m, n) shape)."""
    rows = A.row_ids().astype(np.int64)
    d = np.abs(A.ja.astype(np.int64) - rows)
    near = d <= W
    far = ~near
    A_near = CSR.from_coo(A.name + "_near", A.m, A.n,
                          rows[near], A.ja[near], A.as_[near])
    A_far = CSR.from_coo(A.name + "_far", A.m, A.n,
                         rows[far], A.ja[far], A.as_[far])
    return A_near, A_far


def choose_window(A: CSR) -> int | None:
    """Smallest candidate window that captures NEAR_FRAC_MIN of the
    entries. None = no usable band (pure scatter, or no entries)."""
    if A.nnz == 0:
        return None
    rows = A.row_ids().astype(np.int64)
    d = np.abs(A.ja.astype(np.int64) - rows)
    for W in W_CANDS:
        if float(np.mean(d <= W)) >= NEAR_FRAC_MIN:
            return W
    return None


def _delegate(A: CSR, to: str, reason: str, dev, hybrid_kw,
              s3: str = "rows", s1: str = "auto") -> Prepared:
    """No band/scatter mix worth splitting: the single strategy that fits
    the whole matrix, under this strategy's name (``cuda-xpose`` falls
    back to ``cuda-hybrid`` when its planner refuses, the refusal kept
    in ``meta["reject_reason"]``)."""
    extra = {}
    if to == "cuda-xpose":
        try:
            p = xpose.prepare_xpose(A, device=dev, s3=s3, s1=s1)
        except ValueError as err:
            to, extra = "cuda-hybrid", {"reject_reason": str(err)}
    if to == "cuda-hybrid":
        p = prepare_lane_ell_hybrid(A, device=dev, **hybrid_kw)
    meta = dict(p.meta)
    if "delegated" in meta:
        meta["delegate_delegated"] = meta.pop("delegated")
    meta.update(delegated=to, why=reason, **extra)
    return Prepared("cuda-nearfar", A.name, p.fn, device=dev, nnz=A.nnz,
                    ref="pallas-nearfar", hbm_bytes=p.hbm_bytes, meta=meta,
                    plain=p.plain, kernel_inputs=p.kernel_inputs,
                    kernel_calls=p.kernel_calls, run=p.run)


def prepare_nearfar(A: CSR, device="cuda", W: int = 0, s3: str = "rows",
                    s1: str = "auto", **hybrid_kw) -> Prepared:
    """``cuda-nearfar``: the hybrid on the band |col - row| <= W (chosen
    by :func:`choose_window` unless given) plus XPOSE on the rest, stages
    S3 and S1 on designs ``s3`` and ``s1`` (:func:`xpose.prepare_xpose`),
    bound on ``device``; delegates to one of the two for the whole matrix
    when there is no mix worth splitting."""
    dev = resolve_device(device)
    xpose.resolve_s1(s1, s3)
    if not W:
        W = choose_window(A)
        if W is None:
            return _delegate(A, "cuda-xpose", "pure scatter", dev, hybrid_kw,
                             s3, s1)
    A_near, A_far = split_by_window(A, W)
    if A_far.nnz < FAR_MIN:
        return _delegate(A, "cuda-hybrid", "scattered part too small", dev,
                         hybrid_kw)
    if not quick_envelope_ok(A_far):
        return _delegate(A, "cuda-hybrid",
                         "scattered part outside the XPOSE envelope", dev,
                         hybrid_kw)
    p_near = prepare_lane_ell_hybrid(A_near, device=dev, **hybrid_kw)
    try:
        p_far = xpose.prepare_xpose(A_far, device=dev, s3=s3, s1=s1)
    except ValueError as err:
        # quick_envelope_ok is necessary, not sufficient
        p = _delegate(A, "cuda-hybrid", "XPOSE mid-plan rejection", dev,
                      hybrid_kw)
        p.meta["reject_reason"] = str(err)
        return p
    n = A.n

    def both(near, far):
        def fn(x, *ops):
            xf = torch.as_tensor(x, dtype=torch.float32, device=dev)
            if xf.shape != (n,):
                raise ValueError(f"cuda-nearfar: x has shape "
                                 f"{tuple(xf.shape)}, expected ({n},)")
            return near(xf, *ops) + far(xf, *ops)
        return fn

    return Prepared(
        "cuda-nearfar", A.name, both(p_near.fn, p_far.fn), device=dev,
        nnz=A.nnz, ref="pallas-nearfar",
        hbm_bytes=p_near.hbm_bytes + p_far.hbm_bytes,
        meta={"W": W, "near_nnz": A_near.nnz, "far_nnz": A_far.nnz,
              "near_frac": round(A_near.nnz / max(A.nnz, 1), 4),
              "near": p_near.meta, "far": p_far.meta},
        plain=both(p_near.plain, p_far.plain),
        kernel_calls=lambda xf: (p_near.kernel_calls(xf)
                                 + p_far.kernel_calls(xf)),
        run=both(p_near.run, p_far.run))

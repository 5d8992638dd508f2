"""Strategy registry of the port (counterpart of
``spmv_scpa_tpu/ops/registry.py``).

Each strategy has a ``prepare(A, device=..., **params) -> Prepared``
whose ``fn(x)`` runs on ``device``, and names in ``ref`` the strategy
of the JAX package it is held against:

=================  ===================  ==================================
 name               ref                  what
=================  ===================  ==================================
 cuda-hybrid        pallas-hybrid        lane-ELL hybrid, CUDA core kernel
 cuda-pell          pallas-pell          PELL, fused / span / pure schemes
 cuda-bcsr          pallas-bcsr          dense (8, 128) tiles, tile kernel
 cuda-xpose         pallas-xpose         static-routed transpose (mirror,
                                         S1 and S3 kernels)
 cuda-nearfar       pallas-nearfar       cuda-hybrid on the diagonal band +
                                         cuda-xpose on the scattered rest
 torch-csr-segsum   xla-csr-segsum       gather + ``index_add_`` baseline
 torch-dense        xla-dense            dense matvec (tiny matrices)
 oracle-csr         oracle-csr           fp64 host oracle
=================  ===================  ==================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.xpose_plan import quick_envelope_ok
from spmv_scpa_tpu_torch.utils.platform import resolve_device


@dataclass
class Prepared:
    """A strategy instantiated for one matrix on one device."""

    strategy: str
    matrix: str
    fn: Callable[[Any], Any]          # fn(x) -> y, a tensor on ``device``
    device: torch.device
    nnz: int
    ref: str                          # the JAX strategy held against
    # Bytes the kernel must stream per call (matrix data only, without
    # x/y), for roofline accounting. 0 if unknown.
    hbm_bytes: int = 0
    meta: dict = field(default_factory=dict)
    # fn with every hand-written kernel replaced by its plain PyTorch
    # version (None where the strategy has no kernel).
    plain: Callable[[Any], Any] | None = None
    # For a strategy with one core kernel: x (f32 tensor on ``device``)
    # -> the argument tuple of that kernel's wrapper, for timing the
    # kernel alone.
    kernel_inputs: Callable[[Any], tuple] | None = None
    # x (f32 tensor on ``device``) -> every kernel call of ``fn(x)`` in
    # order as (kernel name, wrapper arguments), for checking and timing
    # each kernel alone at the call's shapes.
    kernel_calls: Callable[[Any], list] | None = None


def record_calls(run: Callable[[Any], Any], plain) -> list:
    """Every kernel call of ``run(ops)`` in order, as (name, args), with
    ``ops`` the plain versions ``plain`` (a NamedTuple of the kernels by
    name) each wrapped to record its call: no kernel launches."""
    calls = []

    def rec(name, f):
        def call(*args):
            calls.append((name, args))
            return f(*args)
        return call

    run(type(plain)(*(rec(name, f) for name, f in
                      zip(plain._fields, plain))))
    return calls


@dataclass(frozen=True)
class StrategySpec:
    name: str
    fmt: str                          # CSR | HLL | PELL | BCSR | DENSE
    backend: str                      # host | torch | cuda
    ref: str
    prepare: Callable[..., Prepared] = None


_REGISTRY: dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate strategy {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get_strategy(name: str) -> StrategySpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_strategies(backend: str | None = None,
                    fmt: str | None = None) -> list[str]:
    _ensure_builtin()
    return sorted(
        n for n, s in _REGISTRY.items()
        if (backend is None or s.backend == backend)
        and (fmt is None or s.fmt == fmt)
    )


def to_numpy(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y, dtype=np.float64)


def spmv(A: CSR, x, strategy: str = "auto", device="cuda",
         **params) -> np.ndarray:
    """One-shot convenience: prepare + run a strategy on (A, x); y comes
    back as a float64 numpy array."""
    auto = strategy == "auto"
    if auto:
        strategy = pick_auto(A)
    try:
        prep = get_strategy(strategy).prepare(A, device=device, **params)
    except ValueError:
        if not auto:
            raise
        # auto fallback chain for a refusal mid-plan (the reference's
        # registry.py:138-157); NotImplementedError is not caught
        for fb in ("cuda-hybrid", "cuda-pell", "torch-csr-segsum"):
            if fb == strategy:
                continue
            try:
                prep = get_strategy(fb).prepare(A, device=device, **params)
                break
            except ValueError:
                continue
        else:
            raise
    return to_numpy(prep.fn(x))


def pick_auto(A: CSR) -> str:
    """The JAX package's choice on a TPU (``registry.pick_auto``, its
    TPU branch), mapped onto the port: ``xla-dense`` -> ``torch-dense``,
    ``pallas-hybrid`` -> ``cuda-hybrid``, ``pallas-xpose`` ->
    ``cuda-xpose`` (``quick_envelope_ok`` is necessary only: a mid-plan
    refusal is ``spmv``'s fallback), ``pallas-pell`` -> ``cuda-pell``.
    The thresholds are the TPU's, kept until ROADMAP queue 1 #5
    measures them on the card."""
    if A.m * A.n <= 500_000:
        return "torch-dense"
    if A.nnz:
        # resident-x bound of the hybrid (lane_ell.X_VMEM_BUDGET)
        g_pad = -(-A.m // 128)
        fits = ((g_pad + 65) * 128 * 4 <= 10 << 20
                and A.n <= (10 << 20) // 4)
        if fits:
            avg = A.nnz / max(A.m, 1)
            d = np.abs(A.ja.astype(np.int64) - A.row_ids())
            loc = float(np.mean(d <= 4096))
            if loc >= 0.98 or (loc >= 0.5 and avg >= 3.0):
                return "cuda-hybrid"
        if quick_envelope_ok(A):
            return "cuda-xpose"
    return "cuda-pell"


# ---------------------------------------------------------------------------
# Built-in strategy registration (lazy to avoid import cycles)
# ---------------------------------------------------------------------------

_BUILTIN_DONE = False


def _ensure_builtin():
    global _BUILTIN_DONE
    if _BUILTIN_DONE:
        return
    _BUILTIN_DONE = True

    from spmv_scpa_tpu_torch.ops import torch_ops
    from spmv_scpa_tpu_torch.ops.lane_ell import prepare_lane_ell_hybrid
    from spmv_scpa_tpu_torch.ops.nearfar import prepare_nearfar
    from spmv_scpa_tpu_torch.ops.pell import prepare_bcsr, prepare_pell
    from spmv_scpa_tpu_torch.ops.xpose import prepare_xpose

    def _prep_oracle_csr(A: CSR, **_):
        return Prepared("oracle-csr", A.name, lambda x: spmv_oracle(A, x),
                        device=torch.device("cpu"), nnz=A.nnz,
                        ref="oracle-csr",
                        hbm_bytes=A.nnz * 12 + (A.m + 1) * 4)

    def _prep_segsum(A: CSR, device="cuda", **_):
        dev = resolve_device(device)
        return Prepared("torch-csr-segsum", A.name,
                        torch_ops.make_csr_segsum(A, dev), device=dev,
                        nnz=A.nnz, ref="xla-csr-segsum",
                        hbm_bytes=A.nnz * 12)  # val4 + ja4 + rowid4

    def _prep_dense(A: CSR, device="cuda", max_bytes: int = 512 << 20,
                    **_):
        if A.m * A.n * 4 > max_bytes:
            raise ValueError(
                f"torch-dense: {A.m}x{A.n} dense materialization exceeds "
                f"{max_bytes} B (the tiny-matrix regime only)")
        dev = resolve_device(device)
        return Prepared("torch-dense", A.name, torch_ops.make_dense(A, dev),
                        device=dev, nnz=A.nnz, ref="xla-dense",
                        hbm_bytes=A.m * A.n * 4)

    register(StrategySpec("oracle-csr", "CSR", "host", "oracle-csr",
                          prepare=_prep_oracle_csr))
    register(StrategySpec("torch-csr-segsum", "CSR", "torch",
                          "xla-csr-segsum", prepare=_prep_segsum))
    register(StrategySpec("torch-dense", "DENSE", "torch", "xla-dense",
                          prepare=_prep_dense))
    register(StrategySpec("cuda-hybrid", "HLL", "cuda", "pallas-hybrid",
                          prepare=prepare_lane_ell_hybrid))
    register(StrategySpec("cuda-pell", "PELL", "cuda", "pallas-pell",
                          prepare=prepare_pell))
    register(StrategySpec("cuda-bcsr", "BCSR", "cuda", "pallas-bcsr",
                          prepare=prepare_bcsr))
    register(StrategySpec("cuda-xpose", "XPOSE", "cuda", "pallas-xpose",
                          prepare=prepare_xpose))
    register(StrategySpec("cuda-nearfar", "XPOSE", "cuda", "pallas-nearfar",
                          prepare=prepare_nearfar))

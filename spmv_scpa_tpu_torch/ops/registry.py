"""Strategy registry of the port (counterpart of
``spmv_scpa_tpu/ops/registry.py``).

Each strategy has a ``prepare(A, device=..., **params) -> Prepared``
whose ``fn(x)`` runs on ``device``, and names in ``ref`` the strategy
of the JAX package it is held against:

=====================  ===================  ==============================
 name                   ref                  what
=====================  ===================  ==============================
 cuda-hybrid            pallas-hybrid        lane-ELL hybrid, CUDA core
                                             kernel
 cuda-pell              pallas-pell          PELL, fused / span / pure
                                             schemes
 cuda-bcsr              pallas-bcsr          (8, 128) tiles as bitmaps of
                                             their stored slots (or dense)
 cuda-xpose             pallas-xpose         static-routed transpose
                                             (mirror, S1 and S3 kernels)
 cuda-nearfar           pallas-nearfar       cuda-hybrid on the diagonal
                                             band + cuda-xpose on the rest
 cuda-hybrid-fp64       pallas-hybrid-df64   lane-ELL core in float64
 cuda-pell-fp64         pallas-pell-df64     fused PELL in float64
 cuda-bcsr-spmm         pallas-bcsr-spmm     SpMM over the same tiles (X
                                             is (n, cols), spmm_only)
 cuda-chips             pallas-chips         the whole matrix as chips
                                             (gathers + window segment-sum)
 torch-csr-segsum       xla-csr-segsum       gather + ``index_add_`` (spmm)
 torch-csr-segsum-spmm  xla-csr-segsum-spmm  its SpMM form (spmm_only)
 torch-ell-rm / -cm     xla-ell-rm / -cm     uniform ELL, row-/col-major
                                             (spmm)
 torch-ell-fp64         xla-ell-df64         uniform ELL in float64
 torch-dense            xla-dense            dense matvec (tiny matrices)
 oracle-csr             oracle-csr           fp64 host oracle
 oracle-ell             oracle-ell           fp64 host HLL oracle
 omp-csr-guided         omp-csr-guided       native OpenMP CSR, guided
 omp-csr-nnz            omp-csr-nnz          native OpenMP CSR, nnz spans
 omp-ell                omp-ell              native OpenMP ELL slices
=====================  ===================  ==============================

The fp64 strategies take x as float64 and return y float64 on the
device; their ``meta["rtol"]`` is the reference's 1e-9 gate. Those
marked ``spmm`` also take X (n, cols) to Y (m, cols); ``spmm_only``
ones take only that, and ``spmv`` drives them with a 1-D x in column 0.
``tunable`` marks the device strategies whose plan on the card changes
with ``chunk``, the runner's sweep axis; the others record it, if at
all, and get one sweep cell. A strategy's ``fmt`` is the reference's,
the ``format`` column of the CSV logs.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from spmv_scpa_tpu_torch import trace
from spmv_scpa_tpu_torch.formats.csr import CSR
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.xpose_plan import quick_envelope_ok
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# The reference's gate for its fp64 grades, against the fp64 oracle.
FP64_RTOL = 1e-9


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
    # run(x, ops): ``fn`` with each kernel taken by its name from ``ops``
    # (a NamedTuple of kernels, or of their plain versions, such as
    # ``lane_ell.KERNELS``), so that another strategy's call can run this
    # one inside it (a hybrid's compact big tail). None where the
    # strategy has no kernel: ``fn`` is then its own plain version.
    run: Callable[[Any, Any], Any] | None = None


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
    spmm: bool = False                # takes a 2-D (n, cols) x too
    spmm_only: bool = False           # requires a 2-D (n, cols) x
    tunable: bool = True              # chunk changes the plan (module
                                      # docstring); False = one sweep cell


_REGISTRY: dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    """Register ``spec`` with its ``prepare`` traced: a ``prepare`` root
    span over the whole set-up (attributes strategy, m, n, nnz, cols),
    and a ``call`` span around the returned ``Prepared.fn``."""
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate strategy {spec.name!r}")
    spec = dataclasses.replace(spec, prepare=traced(spec.name)(spec.prepare))
    _REGISTRY[spec.name] = spec
    return spec


def traced(name: str):
    """Decorator of a prepare function ``prepare(A, ...)`` of strategy
    ``name``: the set-up under a ``prepare`` root span (attributes
    strategy, m, n, nnz, cols), and the returned object's ``fn`` under a
    ``call`` span."""
    def deco(prepare):
        @functools.wraps(prepare)
        def traced_prepare(A, *args, **kwargs):
            with trace.span("prepare", strategy=name, m=A.m, n=A.n,
                            nnz=A.nnz, cols=kwargs.get("cols", 1)):
                prep = prepare(A, *args, **kwargs)
            prep.fn = trace.call_span("call", strategy=prep.strategy)(prep.fn)
            return prep
        return traced_prepare
    return deco


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


def by_ref(ref: str) -> StrategySpec | None:
    """The port's strategy held against the JAX strategy ``ref``, or
    None."""
    _ensure_builtin()
    return next((s for s in _REGISTRY.values() if s.ref == ref), None)


def spmv(A: CSR, x, strategy: str = "auto", device="cuda",
         **params) -> np.ndarray:
    """One-shot convenience: prepare + run a strategy on (A, x); y comes
    back as a float64 numpy array. An SpMM-only strategy takes a 1-D x
    too: it rides column 0 of an (n, ``cols``) block and y is that column
    of Y (the reference's registry.py:120-159). A 2-D x passes through to
    a strategy that takes one (``spmm``); any other refuses it."""
    auto = strategy == "auto"
    if auto:
        strategy = pick_auto(A)
    spec = get_strategy(strategy)
    if np.ndim(x) == 2 and not spec.spmm:
        raise ValueError(f"{strategy} takes a 1-D x; X of shape "
                         f"{tuple(np.shape(x))} needs an SpMM strategy")
    squeeze = spec.spmm_only and np.ndim(x) == 1
    if squeeze:
        cols = params.get("cols", 8)
        if isinstance(x, torch.Tensor):
            X = x.new_zeros((x.shape[0], cols))
        else:
            x = np.asarray(x)
            X = np.zeros((x.shape[0], cols), x.dtype)
        X[:, 0] = x
        x = X
    try:
        prep = spec.prepare(A, device=device, **params)
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
    y = to_numpy(prep.fn(x))
    return y[:, 0] if squeeze else y


@trace.span("pick_auto")
def pick_auto(A: CSR) -> str:
    """The JAX package's choice on a TPU (``registry.pick_auto``, its
    TPU branch), mapped onto the port: ``xla-dense`` -> ``torch-dense``,
    ``pallas-hybrid`` -> ``cuda-hybrid``, ``pallas-xpose`` ->
    ``cuda-xpose`` (``quick_envelope_ok`` is necessary only: a mid-plan
    refusal is ``spmv``'s fallback), ``pallas-pell`` -> ``cuda-pell``.
    The thresholds are the TPU's, kept until ROADMAP #5 measures them
    on the card."""
    if A.m * A.n <= 500_000:
        return "torch-dense"
    if A.nnz:
        from spmv_scpa_tpu_torch.ops.lane_ell import x_fits
        # the hybrid's resident x (its widest window, 65 strips of 128
        # rows past the groups), and x itself
        g_pad = -(-A.m // 128)
        fits = x_fits((g_pad + 65) * 128 * 4) and x_fits(A.n * 4)
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

    from spmv_scpa_tpu_torch.formats.ell import csr_to_ell
    from spmv_scpa_tpu_torch.ops.chips_tail import prepare_chips_strategy
    from spmv_scpa_tpu_torch.ops import native_omp, torch_ops
    from spmv_scpa_tpu_torch.ops.lane_ell import prepare_lane_ell_hybrid
    from spmv_scpa_tpu_torch.ops.lane_ell_fp64 import prepare_lane_ell_fp64
    from spmv_scpa_tpu_torch.ops.nearfar import prepare_nearfar
    from spmv_scpa_tpu_torch.ops.pell import (prepare_bcsr, prepare_pell,
                                              prepare_pell_fp64)
    from spmv_scpa_tpu_torch.ops.spmm import prepare_bcsr_spmm
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

    def _prep_oracle_ell(A: CSR, slice_h: int = 32, **_):
        E = csr_to_ell(A, slice_h=slice_h, col_major=False, pad_mode="neg1")
        return Prepared("oracle-ell", A.name,
                        lambda x: torch_ops.serial_ell(E, x),
                        device=torch.device("cpu"), nnz=A.nnz,
                        ref="oracle-ell", hbm_bytes=E.padded_nnz * 12,
                        meta={"num_blocks": E.num_slices})

    def _prep_segsum_spmm(A: CSR, device="cuda", **_):
        dev = resolve_device(device)
        return Prepared("torch-csr-segsum-spmm", A.name,
                        torch_ops.make_csr_segsum_spmm(A, dev), device=dev,
                        nnz=A.nnz, ref="xla-csr-segsum-spmm",
                        hbm_bytes=A.nnz * 12)

    def _uniform_ell(A: CSR, slice_h: int, max_padded: int, col_major: bool,
                     refusal: str):
        """The uniform ELL view, refused (the reference's words) when
        padding every row to the longest explodes (power-law matrices;
        the reference HLL study shows the same failure, SURVEY.md
        section 6)."""
        max_len = int(np.diff(A.irp).max(initial=1))
        if -(-A.m // slice_h) * slice_h * max(max_len, 1) > max_padded:
            raise ValueError(
                f"uniform ELL padding too large (max row {max_len}); "
                + refusal)
        E = csr_to_ell(A, slice_h=slice_h, col_major=col_major,
                       pad_mode="last")
        return E, E.to_uniform()

    def _prep_ell(A: CSR, col_major: bool, device="cuda", slice_h: int = 32,
                  max_padded: int = 1 << 28, **_):
        E, U = _uniform_ell(A, slice_h, max_padded, col_major,
                            "use CSR/PELL strategies for this matrix")
        dev = resolve_device(device)
        name = "torch-ell-cm" if col_major else "torch-ell-rm"
        return Prepared(name, A.name, torch_ops.make_ell_uniform(U, dev),
                        device=dev, nnz=A.nnz,
                        ref="xla-ell-cm" if col_major else "xla-ell-rm",
                        hbm_bytes=U.ja.size * 8,
                        meta={"num_blocks": E.num_slices,
                              "fill": A.nnz / max(U.ja.size, 1)})

    def _prep_ell_fp64(A: CSR, device="cuda", slice_h: int = 32,
                       max_padded: int = 1 << 28, **_):
        E, U = _uniform_ell(A, slice_h, max_padded, True,
                            "df64 path unavailable for this matrix")
        dev = resolve_device(device)
        return Prepared("torch-ell-fp64", A.name,
                        torch_ops.make_ell_fp64(U, dev), device=dev,
                        nnz=A.nnz, ref="xla-ell-df64",
                        hbm_bytes=U.ja.size * 12,
                        meta={"num_blocks": E.num_slices, "rtol": FP64_RTOL,
                              "fill": A.nnz / max(U.ja.size, 1)})

    def _prep_omp(A: CSR, kind: str, nthreads: int = 0, **_):
        if not native_omp.available():
            raise ValueError("native OpenMP library unavailable "
                             "(g++ -fopenmp required; see native/)")
        nblocks = None
        if kind == "guided":
            fn = native_omp.make_csr_omp_guided(A, nthreads)
        elif kind == "nnz":
            fn = native_omp.make_csr_omp_nnz(A, nthreads or 1)
        else:
            E = csr_to_ell(A, slice_h=32, col_major=True, pad_mode="last")
            fn = native_omp.make_ell_omp(E, nthreads)
            nblocks = E.num_slices
        name = f"omp-csr-{kind}" if kind != "ell" else "omp-ell"
        return Prepared(name, A.name, fn, device=torch.device("cpu"),
                        nnz=A.nnz, ref=name, hbm_bytes=A.nnz * 12,
                        meta={"num_blocks": nblocks, "num_threads": nthreads})

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
                          "xla-csr-segsum", prepare=_prep_segsum,
                          spmm=True))
    register(StrategySpec("torch-dense", "DENSE", "torch", "xla-dense",
                          prepare=_prep_dense))
    # the lane-ELL packer picks the core's entries by chunk
    # (ops/lane_ell.py:pack_lane_ell), for near/far's band too; the row
    # layouts of PELL and the bitmap tiles of BCSR record it only;
    # XPOSE's geometry comes from its plan (the reference's
    # pallas-xpose is untunable too)
    register(StrategySpec("cuda-hybrid", "LELL", "cuda", "pallas-hybrid",
                          prepare=prepare_lane_ell_hybrid))
    register(StrategySpec("cuda-pell", "PELL", "cuda", "pallas-pell",
                          prepare=prepare_pell, tunable=False))
    register(StrategySpec("cuda-bcsr", "BCSR", "cuda", "pallas-bcsr",
                          prepare=prepare_bcsr, tunable=False))
    register(StrategySpec("cuda-xpose", "XPOSE", "cuda", "pallas-xpose",
                          prepare=prepare_xpose, tunable=False))
    register(StrategySpec("cuda-nearfar", "XPOSE", "cuda", "pallas-nearfar",
                          prepare=prepare_nearfar))
    register(StrategySpec("oracle-ell", "HLL", "host", "oracle-ell",
                          prepare=_prep_oracle_ell))
    register(StrategySpec("torch-csr-segsum-spmm", "CSR", "torch",
                          "xla-csr-segsum-spmm", prepare=_prep_segsum_spmm,
                          spmm=True, spmm_only=True))
    register(StrategySpec("torch-ell-rm", "HLL", "torch", "xla-ell-rm",
                          prepare=lambda A, **kw: _prep_ell(A, False, **kw),
                          spmm=True))
    register(StrategySpec("torch-ell-cm", "HLL", "torch", "xla-ell-cm",
                          prepare=lambda A, **kw: _prep_ell(A, True, **kw),
                          spmm=True))
    register(StrategySpec("torch-ell-fp64", "HLL", "torch", "xla-ell-df64",
                          prepare=_prep_ell_fp64))
    register(StrategySpec("cuda-hybrid-fp64", "LELL", "cuda",
                          "pallas-hybrid-df64",
                          prepare=prepare_lane_ell_fp64))
    register(StrategySpec("cuda-pell-fp64", "PELL", "cuda", "pallas-pell-df64",
                          prepare=prepare_pell_fp64, tunable=False))
    register(StrategySpec("cuda-bcsr-spmm", "BCSR", "cuda",
                          "pallas-bcsr-spmm", prepare=prepare_bcsr_spmm,
                          spmm=True, spmm_only=True, tunable=False))
    register(StrategySpec("cuda-chips", "CHIPS", "cuda", "pallas-chips",
                          prepare=prepare_chips_strategy, tunable=False))
    # the reference study's OpenMP family: csr.c:278-298 (guided),
    # csr.c:218-339 (nnz spans), hll.c:178-211 (ELL slices)
    for kind, name, fmt in (("guided", "omp-csr-guided", "CSR"),
                            ("nnz", "omp-csr-nnz", "CSR"),
                            ("ell", "omp-ell", "HLL")):
        register(StrategySpec(
            name, fmt, "host", name,
            prepare=lambda A, kind=kind, **kw: _prep_omp(A, kind, **kw)))

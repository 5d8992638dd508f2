"""PELL over row quanta: the Hopper layout of ``cuda-pell`` and
``cuda-pell-fp64`` (their default layout), with the kernels
:func:`pell_rows` and :func:`pell_rows_fp64` (``csrc/pell_rows.cu``).

The reference's PELL (``ops/pell.py``, ``layout="tiles"``) cuts every
row into 128-column panels so that a TPU keeps x in VMEM and gathers
within 128 lanes, and pads every row of an 8-row block to the block's
longest: on scattered matrices most of its slots are padding. On Hopper
x is read through the 50 MB L2, so none of that has a role. Here a
quantum is ``Q`` consecutive entries of one row, with any columns:

* ``vals (NQ, Q)`` in the grade's type and ``cols (NQ, Q)`` int32 hold
  each row's entries in CSR order, the row padded to a multiple of Q
  with value 0 and the row's last column (in range, and a line already
  read);
* ``qptr (m + 1,)`` int32 is a row pointer over quanta: row r owns
  quanta ``qptr[r] .. qptr[r + 1] - 1``. It costs 4 (m + 1) bytes,
  against 4 NQ for a row index per quantum: fewer whenever the rows
  average more than one quantum, as every matrix these paths take does
  (a compacted tail has no empty rows);
* ``blk_lo (nb + 1,)`` int32 is, for each kernel block of
  ``BLOCK_SLOTS`` slots (``QB = BLOCK_SLOTS // Q`` quanta), the first
  row whose first quantum lies at or after the block's first quantum: a
  block reads its row range with two loads instead of a search.

There is no row sort, so nothing is un-permuted. ``Q`` comes from
{2, 4, 8, 16} by a fixed rule on the row lengths: the fewest bytes,
counting slots x (value + 4) + quanta x 4, ties to the larger Q; an
explicit ``quantum=`` overrides it.

The sum (the kernels and :func:`pell_rows_plain` alike, every product
and sum rounded separately):
1. each quantum: a pairwise tree over its slots (adjacent slots, then
   adjacent pairs, ...);
2. each block's quanta, in 32-quantum chunks: a segmented inclusive
   Hillis-Steele scan within the chunk (step d adds the value d places
   back while that stays inside the chunk and the row), then the same
   scan over the chunks' last values, then each element whose row
   started before its chunk adds the scanned total of the chunk before;
   a row's block-local sum is the value at its last quantum in the block;
3. a row that crosses block boundaries: its sums from its first block
   to its last, added left to right (the second pass, which also writes
   0 to the rows with no entries).
Deterministic, without atomics: the plain version on the CPU equals the
kernels bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import CSR

QUANTA = (2, 4, 8, 16)       # the quantum sizes the kernels take
BLOCK_SLOTS = 2048           # slots per kernel block (256 threads x 8)
CHUNK = 32                   # quanta per scan chunk (a warp)

# Launches of each CUDA kernel by its wrapper in this process.
LAUNCHES = {"pell_rows": 0, "pell_rows_fp64": 0}


@dataclass
class RowsPlan:
    """One matrix packed in row quanta, host side."""

    m: int
    n: int
    quantum: int
    vals: np.ndarray         # (NQ, Q) float32 or float64
    cols: np.ndarray         # (NQ, Q) int32
    qptr: np.ndarray         # (m + 1,) int32
    blk_lo: np.ndarray       # (nb + 1,) int32
    meta: dict
    hbm_bytes: int
    dtype: torch.dtype = torch.float32


def pick_quantum(lens: np.ndarray, itemsize: int) -> int:
    """The Q of {2, 4, 8, 16} whose layout costs the fewest bytes for
    rows of these lengths: slots x (value + 4) + quanta x 4, ties to the
    larger Q."""
    best, best_cost = None, None
    for q in sorted(QUANTA, reverse=True):
        quanta = int((-(-lens // q)).sum())
        cost = quanta * q * (itemsize + 4) + quanta * 4
        if best_cost is None or cost < best_cost:
            best, best_cost = q, cost
    return best


def plan_pell_rows(A: CSR, dtype=torch.float32,
                   quantum: int | None = None) -> RowsPlan:
    """Pack ``A`` in row quanta of ``Q`` slots (:func:`pick_quantum`
    unless ``quantum`` is given) with values in ``dtype`` (float32 or
    float64)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pell_rows: grade {dtype} is not float32 or "
                         "float64")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lens = np.diff(A.irp).astype(np.int64)
    if quantum is None:
        quantum = pick_quantum(lens, np.dtype(np_dtype).itemsize)
    if quantum not in QUANTA:
        raise ValueError(f"pell_rows: quantum {quantum} is not one of "
                         f"{QUANTA}")
    Q = quantum
    nq_row = -(-lens // Q)
    qptr = np.zeros(A.m + 1, np.int64)
    np.cumsum(nq_row, out=qptr[1:])
    NQ = int(qptr[-1])
    if NQ * Q >= 1 << 31:
        raise ValueError(f"pell_rows: {NQ * Q} slots exceed the int32 "
                         "slot index")
    rows = np.repeat(np.arange(A.m, dtype=np.int64), lens)
    dest = qptr[rows] * Q + (np.arange(A.nnz, dtype=np.int64)
                             - A.irp[:-1].astype(np.int64)[rows])
    last_col = np.where(lens > 0, A.ja[np.maximum(A.irp[1:] - 1, 0)]
                        if A.nnz else 0, 0)
    cols = np.repeat(last_col.astype(np.int32), nq_row * Q)
    cols[dest] = A.ja
    vals = np.zeros(NQ * Q, np_dtype)
    vals[dest] = A.as_
    QB = BLOCK_SLOTS // Q
    nb = -(-NQ // QB)
    blk_lo = np.searchsorted(qptr, np.arange(nb + 1, dtype=np.int64) * QB,
                             side="left")
    plan = RowsPlan(
        m=A.m, n=A.n, quantum=Q, vals=vals.reshape(NQ, Q),
        cols=cols.reshape(NQ, Q), qptr=qptr.astype(np.int32),
        blk_lo=blk_lo.astype(np.int32), meta={}, hbm_bytes=0, dtype=dtype)
    plan.hbm_bytes = sum(a.nbytes for a in (plan.vals, plan.cols, plan.qptr,
                                            plan.blk_lo))
    plan.meta = {"layout": "rows", "quantum": Q, "quanta": NQ,
                 "blocks": nb, "fill": A.nnz / max(NQ * Q, 1)}
    return plan


# ---------------------------------------------------------------------------
# The kernels and their plain version
# ---------------------------------------------------------------------------

def _check(what, vals, cols, qptr, blk_lo, x, dtype) -> int:
    """Check one call's arguments; returns the number of blocks."""
    if vals.dtype != dtype or vals.dim() != 2 \
            or vals.shape[1] not in QUANTA:
        raise ValueError(f"{what}: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected {dtype} (NQ, Q) "
                         f"with Q in {QUANTA}")
    Q = vals.shape[1]
    if cols.dtype != torch.int32 or cols.shape != vals.shape:
        raise ValueError(f"{what}: cols are {cols.dtype} "
                         f"{tuple(cols.shape)}, expected int32 "
                         f"{tuple(vals.shape)}")
    if qptr.dtype != torch.int32 or qptr.dim() != 1 or qptr.numel() < 1:
        raise ValueError(f"{what}: qptr is {qptr.dtype} "
                         f"{tuple(qptr.shape)}, expected int32 (m + 1,)")
    nb = -(-vals.shape[0] // (BLOCK_SLOTS // Q))
    if blk_lo.dtype != torch.int32 or blk_lo.shape != (nb + 1,):
        raise ValueError(f"{what}: blk_lo is {blk_lo.dtype} "
                         f"{tuple(blk_lo.shape)}, expected int32 "
                         f"({nb + 1},) for {vals.shape[0]} quanta of {Q}")
    if x.dtype != dtype or x.dim() != 1:
        raise ValueError(f"{what}: x is {x.dtype} {tuple(x.shape)}, "
                         f"expected {dtype} (n,)")
    for name, t in (("vals", vals), ("cols", cols), ("qptr", qptr),
                    ("blk_lo", blk_lo), ("x", x)):
        if t.device != vals.device:
            raise ValueError(f"{what}: {name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {vals.device}")
    return nb


def _rows(what, dtype, vals, cols, qptr, blk_lo, x) -> torch.Tensor:
    """Run the plain version on CPU tensors, or launch entry point
    ``what`` of ``csrc/pell_rows.cu`` on CUDA tensors."""
    nb = _check(what, vals, cols, qptr, blk_lo, x, dtype)
    if vals.device.type == "cpu":
        return pell_rows_plain(vals, cols, qptr, blk_lo, x)
    m = qptr.numel() - 1
    lib = _kernels.load("pell_rows")
    y = torch.empty(m, dtype=dtype, device=vals.device)
    carry = torch.empty(2 * max(nb, 1), dtype=dtype, device=vals.device)
    err = getattr(lib, what)(
        vals.data_ptr(), cols.data_ptr(), qptr.data_ptr(), blk_lo.data_ptr(),
        x.data_ptr(), carry.data_ptr(), y.data_ptr(), nb, vals.numel(), m,
        x.numel(), vals.shape[1], _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, what)
    LAUNCHES[what] += 1
    return y


def pell_rows(vals, cols, qptr, blk_lo, x) -> torch.Tensor:
    """y (m,) f32 of the row-quantum matrix (``m = qptr.numel() - 1``):
    the module docstring's sum of ``vals * x[cols]``, a column outside x
    reading 0.0. CUDA tensors launch ``csrc/pell_rows.cu``; CPU tensors
    run :func:`pell_rows_plain`."""
    return _rows("pell_rows", torch.float32, vals, cols, qptr, blk_lo, x)


def pell_rows_fp64(vals, cols, qptr, blk_lo, x) -> torch.Tensor:
    """:func:`pell_rows` in float64 (vals, x and y)."""
    return _rows("pell_rows_fp64", torch.float64, vals, cols, qptr, blk_lo,
                 x)


def quantum_sums(vals, cols, x) -> torch.Tensor:
    """Each quantum's sum (NQ,): products rounded, then the pairwise tree
    over its slots."""
    n = x.numel()
    ok = (cols >= 0) & (cols < n)
    xg = (torch.where(ok, x[cols.long().clamp(0, max(n - 1, 0))], 0.0)
          if n else torch.zeros_like(vals))
    p = vals * xg
    while p.shape[1] > 1:
        p = p[:, 0::2] + p[:, 1::2]
    return p[:, 0]


def _shift(t, d, dim):
    """``t`` moved d places up along ``dim``, zeros (or False) in front."""
    out = torch.zeros_like(t)
    src = t.narrow(dim, 0, t.shape[dim] - d)
    out.narrow(dim, d, t.shape[dim] - d).copy_(src)
    return out


def block_sums(part, qptr, Q: int) -> torch.Tensor:
    """Step 2 of the sum over quantum sums ``part`` (NQ,): for every
    quantum, the sum of its row's quanta from the row's first quantum in
    the block (or the block's first) up to it, (nb * QB,)."""
    dev = part.device
    NQ = part.numel()
    QB = BLOCK_SLOTS // Q
    C = QB // CHUNK
    nb = -(-NQ // QB)
    v = torch.zeros(nb * QB, dtype=part.dtype, device=dev)
    v[:NQ] = part
    v = v.view(nb, C, CHUNK)
    starts = qptr[:-1].long()
    flag = torch.zeros(nb * QB, dtype=torch.bool, device=dev)
    flag[starts[starts < nb * QB]] = True
    flag = flag.view(nb, C, CHUNK)
    lane = torch.arange(CHUNK, device=dev)
    head = torch.where(flag, lane, -1).cummax(dim=-1).values
    lim = head.clamp(min=0)
    d = 1
    while d < CHUNK:
        v = torch.where(lane - d >= lim, _shift(v, d, 2) + v, v)
        d *= 2
    tot = v[..., CHUNK - 1].clone()
    seen = flag.any(dim=-1)
    chunk = torch.arange(C, device=dev)
    d = 1
    while d < C:
        tot = torch.where((chunk >= d) & ~seen, _shift(tot, d, 1) + tot, tot)
        seen = seen | ((chunk >= d) & _shift(seen, d, 1))
        d *= 2
    before = _shift(tot, 1, 1)[..., None]
    carry_in = (chunk[:, None] >= 1) & (head < 0)
    return torch.where(carry_in, before + v, v).reshape(-1)


def pell_rows_plain(vals, cols, qptr, blk_lo=None, x=None) -> torch.Tensor:
    """:func:`pell_rows` and :func:`pell_rows_fp64` in PyTorch ops, in
    the kernels' order (the module docstring's steps 1-3) and in the
    dtype of ``vals``. ``blk_lo`` is the kernels' look-up table; the sum
    follows from ``qptr`` alone."""
    Q = vals.shape[1]
    QB = BLOCK_SLOTS // Q
    m = qptr.numel() - 1
    y = torch.zeros(m, dtype=vals.dtype, device=vals.device)
    if vals.shape[0] == 0 or m == 0:
        return y
    fin = block_sums(quantum_sums(vals, cols, x), qptr, Q)
    a, e = qptr[:-1].long(), qptr[1:].long()
    live = a < e
    bs, be = a // QB, (e - 1) // QB
    one = live & (bs == be)
    y[one] = fin[e[one] - 1]
    cross = (live & (bs != be)).nonzero().view(-1)
    if cross.numel():
        bs, be, e = bs[cross], be[cross], e[cross]
        acc = fin[bs * QB + QB - 1]
        for k in range(1, int((be - bs).max()) + 1):
            blk = bs + k
            end = torch.where(blk < be, blk * QB + QB, e) - 1
            acc = torch.where(blk <= be, acc + fin[end.clamp(max=fin.numel()
                                                             - 1)], acc)
        y[cross] = acc
    return y


# ---------------------------------------------------------------------------
# Binding
# ---------------------------------------------------------------------------

def bind_plan(plan: RowsPlan, dev) -> Callable:
    """The plan's arrays on ``dev``, and ``run(xf, ops) -> y (m,)`` for x
    (on ``dev``, in ``plan.dtype``) through ``ops.pell_rows`` or, for a
    float64 plan, ``ops.pell_rows_fp64``."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    vals, cols = put(plan.vals), put(plan.cols)
    qptr, blk_lo = put(plan.qptr), put(plan.blk_lo)
    fp64 = plan.dtype == torch.float64

    def run(xf, ops):
        kernel = ops.pell_rows_fp64 if fp64 else ops.pell_rows
        return kernel(vals, cols, qptr, blk_lo, xf)

    return run

"""The lane-ELL core in row quanta: the Hopper layout of the hybrid's
core (``core_layout="rows"``, the default of ``cuda-hybrid`` and of
``prepare_row_sharded_hybrid``), with the kernel :func:`lane_rows`
(``csrc/lane_rows.cu``).

``pack_lane_ell`` decides which of A's entries the core keeps and
records them (``LanePlan.core``, ``CoreBuild.core``: indices into A's
entries, each row's in plane order). Its lanes layout stores them in
slot planes that every 128-row group pays to the global plane count,
with strip codes into a staged x, so that a TPU keeps x in VMEM. Here x
is read in place through the 50 MB L2, and the entries lie as
``ops/pell_rows.py`` lays out a matrix:

* ``vals (NQ, Q)`` f32 holds each row's entries in quanta of ``Q``
  slots, the row padded to a multiple of Q with value 0 and the column
  of its last entry (in range, and in the same block);
* ``qptr (m + 1,)`` int32 is a row pointer over quanta, ``blk_lo (nb +
  1,)`` int32 the first row of each kernel block of ``BLOCK_SLOTS``
  slots (``pell_rows``' tables);
* the index is the only new part. Each block's columns are stored as
  uint16 offsets from the block's least column where they span less
  than 2^16, else as 32-bit columns. ``idx`` (int16 storage) holds one
  16-bit word per slot at the slot's own position: the offset in a
  16-bit block, the column's low half in a 32-bit block; the 32-bit
  blocks' high halves follow, block after block. ``ctab (nb, 2)`` int32
  gives each block's base column (-1 for a 32-bit block) and where its
  high halves start in ``idx``. A slot's low word thus loads without
  waiting for the table (a first layout put every block's indices
  behind the table's start: one more dependent load per block, PERF.md
  §6).

``Q`` comes from {2, 4, 8, 16} by ``pell_rows.pick_quantum``'s rule
with the index width counted: the fewest bytes of the whole layout
(values, index, ``qptr``, ``blk_lo`` and ``ctab``), ties to the larger
Q. The sum is ``pell_rows``' tree (its module docstring), so
:func:`lane_rows_plain` is ``pell_rows_plain`` over the decoded
columns and equals the kernel bit for bit on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.ops.pell_rows import (BLOCK_SLOTS, QUANTA,
                                               pell_rows_plain)

SPAN16 = 1 << 16             # a block whose columns span less is 16-bit

# Launches of the CUDA kernel by its wrapper in this process.
LAUNCHES = {"lane_rows": 0}


@dataclass
class CorePlan:
    """One core packed in row quanta with the compact index, host side."""

    m: int
    n: int
    quantum: int
    vals: np.ndarray         # (NQ, Q) float32
    idx: np.ndarray          # (n_idx,) int16: a low word a slot, then
                             # the 32-bit blocks' high halves
    ctab: np.ndarray         # (nb, 2) int32: base (-1: 32-bit), start
                             # of the block's high halves
    qptr: np.ndarray         # (m + 1,) int32
    blk_lo: np.ndarray       # (nb + 1,) int32
    meta: dict
    hbm_bytes: int

    def arrays(self) -> tuple:
        """The kernel's tables in its argument order (x comes last)."""
        return self.vals, self.idx, self.ctab, self.qptr, self.blk_lo


def _rows_layout(lens: np.ndarray, Q: int):
    """(quanta of each row, qptr int64 (m + 1,)) at quantum ``Q``."""
    nq_row = -(-lens // Q)
    qptr = np.zeros(lens.size + 1, np.int64)
    np.cumsum(nq_row, out=qptr[1:])
    return nq_row, qptr


def _entry_slots(rows, lens, qptr, Q: int) -> np.ndarray:
    """Each entry's slot: its row's first slot plus its rank in the row
    (the entries are grouped by row, rows ascending)."""
    first = np.cumsum(lens) - lens
    return qptr[rows] * Q + (np.arange(rows.size, dtype=np.int64)
                             - first[rows])


def _block_spans(slot, cols, nb: int):
    """Least and greatest column of each block of ``BLOCK_SLOTS`` slots.
    Every block holds a real entry (a quantum holds at least one and a
    block whole quanta), and a padding slot repeats a column of its
    quantum, so the real entries give the spans."""
    bounds = np.searchsorted(slot, np.arange(nb, dtype=np.int64)
                             * BLOCK_SLOTS)
    return (np.minimum.reduceat(cols, bounds),
            np.maximum.reduceat(cols, bounds))


def _index_units(lo, hi, n_slots: int):
    """Per block: 16-bit or not, and its index length in 16-bit words
    (one a slot, two in a 32-bit block)."""
    nb = lo.size
    cnt = np.full(nb, BLOCK_SLOTS, np.int64)
    if nb:
        cnt[-1] = n_slots - (nb - 1) * BLOCK_SLOTS
    narrow = (hi - lo) < SPAN16
    return narrow, np.where(narrow, cnt, 2 * cnt)


def layout_bytes(rows, cols, lens, Q: int) -> int:
    """Bytes of the whole layout at quantum ``Q``: values, index,
    ``qptr``, ``blk_lo`` and ``ctab``."""
    nq_row, qptr = _rows_layout(lens, Q)
    n_slots = int(qptr[-1]) * Q
    nb = -(-n_slots // BLOCK_SLOTS)
    if not nb:
        return 4 * (lens.size + 2)
    lo, hi = _block_spans(_entry_slots(rows, lens, qptr, Q), cols, nb)
    _, units = _index_units(lo, hi, n_slots)
    return (4 * n_slots + 2 * int(units.sum()) + 4 * (lens.size + 1)
            + 4 * (nb + 1) + 8 * nb)


def pick_quantum(rows, cols, lens) -> int:
    """The Q of {2, 4, 8, 16} whose layout costs the fewest bytes
    (:func:`layout_bytes`), ties to the larger Q."""
    best, best_cost = None, None
    for q in sorted(QUANTA, reverse=True):
        cost = layout_bytes(rows, cols, lens, q)
        if best_cost is None or cost < best_cost:
            best, best_cost = q, cost
    return best


def plan_core(m: int, n: int, rows, cols, vals,
              quantum: int | None = None) -> CorePlan:
    """Pack the entries ``(rows, cols, vals)`` (grouped by row, rows
    ascending; each row's in the order its sum takes them) of an
    ``m x n`` core in row quanta with the compact index."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size and np.any(np.diff(rows) < 0):
        raise ValueError("lane_rows: the entries are not grouped by row")
    lens = np.bincount(rows, minlength=m).astype(np.int64)
    if quantum is None:
        quantum = pick_quantum(rows, cols, lens)
    if quantum not in QUANTA:
        raise ValueError(f"lane_rows: quantum {quantum} is not one of "
                         f"{QUANTA}")
    Q = quantum
    nq_row, qptr = _rows_layout(lens, Q)
    NQ = int(qptr[-1])
    n_slots = NQ * Q
    if 2 * n_slots >= 1 << 31:
        raise ValueError(f"lane_rows: {n_slots} slots exceed the int32 "
                         "index offsets")
    slot = _entry_slots(rows, lens, qptr, Q)
    ends = np.cumsum(lens)
    last_col = np.where(lens > 0, cols[np.maximum(ends - 1, 0)]
                        if rows.size else 0, 0)
    scol = np.repeat(last_col, nq_row * Q)
    scol[slot] = cols
    svals = np.zeros(n_slots, np.float32)
    svals[slot] = vals

    nb = -(-n_slots // BLOCK_SLOTS)
    lo, hi = _block_spans(slot, cols, nb) if nb else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    narrow, units = _index_units(lo, hi, n_slots)
    extra = np.where(narrow, 0, units // 2)          # high halves
    start = n_slots + np.cumsum(extra) - extra
    blk = np.arange(n_slots, dtype=np.int64) // BLOCK_SLOTS
    base = np.where(narrow, lo, 0)[blk] if nb else np.zeros(0, np.int64)
    word = scol - base
    idx = np.zeros(int(units.sum()), np.int16)
    idx[:n_slots] = (word & 0xFFFF).astype(np.uint16).view(np.int16)
    wide = ~narrow[blk] if nb else np.zeros(0, bool)
    j = np.arange(n_slots, dtype=np.int64) - blk * BLOCK_SLOTS
    idx[start[blk[wide]] + j[wide]] = (
        word[wide] >> 16).astype(np.uint16).view(np.int16)
    ctab = np.stack([np.where(narrow, lo, -1), start], axis=1) \
        .astype(np.int32).reshape(nb, 2)
    QB = BLOCK_SLOTS // Q
    blk_lo = np.searchsorted(qptr, np.arange(nb + 1, dtype=np.int64) * QB,
                             side="left")
    plan = CorePlan(
        m=m, n=n, quantum=Q, vals=svals.reshape(NQ, Q), idx=idx, ctab=ctab,
        qptr=qptr.astype(np.int32), blk_lo=blk_lo.astype(np.int32),
        meta={}, hbm_bytes=0)
    plan.hbm_bytes = sum(a.nbytes for a in plan.arrays())
    plan.meta = {"layout": "rows", "quantum": Q, "quanta": NQ,
                 "blocks": nb, "wide_blocks": int(nb - narrow.sum()),
                 "fill": rows.size / max(n_slots, 1),
                 "bytes_per_entry": plan.hbm_bytes / max(rows.size, 1)}
    return plan


def bind(plan: CorePlan, dev) -> tuple:
    """The plan's tables on ``dev``, in the kernel's argument order."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in plan.arrays())


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _check(vals, idx, ctab, qptr, blk_lo, x) -> int:
    """Check one call's arguments; returns the number of blocks."""
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[1] not in QUANTA:
        raise ValueError(f"lane_rows: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected float32 (NQ, Q) "
                         f"with Q in {QUANTA}")
    n_slots = vals.numel()
    nb = -(-n_slots // BLOCK_SLOTS)
    if idx.dtype != torch.int16 or idx.dim() != 1 \
            or not n_slots <= idx.numel() <= 2 * n_slots:
        raise ValueError(f"lane_rows: idx is {idx.dtype} "
                         f"{tuple(idx.shape)}, expected int16 with "
                         f"{n_slots} to {2 * n_slots} elements")
    if ctab.dtype != torch.int32 or ctab.shape != (nb, 2):
        raise ValueError(f"lane_rows: ctab is {ctab.dtype} "
                         f"{tuple(ctab.shape)}, expected int32 ({nb}, 2) "
                         f"for {n_slots} slots")
    if qptr.dtype != torch.int32 or qptr.dim() != 1 or qptr.numel() < 1:
        raise ValueError(f"lane_rows: qptr is {qptr.dtype} "
                         f"{tuple(qptr.shape)}, expected int32 (m + 1,)")
    if blk_lo.dtype != torch.int32 or blk_lo.shape != (nb + 1,):
        raise ValueError(f"lane_rows: blk_lo is {blk_lo.dtype} "
                         f"{tuple(blk_lo.shape)}, expected int32 "
                         f"({nb + 1},)")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"lane_rows: x is {x.dtype} {tuple(x.shape)}, "
                         "expected float32 (n,)")
    for name, t in (("vals", vals), ("idx", idx), ("ctab", ctab),
                    ("qptr", qptr), ("blk_lo", blk_lo), ("x", x)):
        if t.device != vals.device:
            raise ValueError(f"lane_rows: {name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"lane_rows: {name} is not contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_rows: unsupported device {vals.device}")
    return nb


def lane_rows(vals, idx, ctab, qptr, blk_lo, x) -> torch.Tensor:
    """y (m,) f32 of the core (``m = qptr.numel() - 1``): ``pell_rows``'
    sum of ``vals * x[col]`` with each slot's column decoded from the
    compact index (:func:`decode_cols`), a column outside x reading 0.0.
    CUDA tensors launch ``csrc/lane_rows.cu``; CPU tensors run
    :func:`lane_rows_plain`."""
    nb = _check(vals, idx, ctab, qptr, blk_lo, x)
    if vals.device.type == "cpu":
        return lane_rows_plain(vals, idx, ctab, qptr, blk_lo, x)
    m = qptr.numel() - 1
    lib = _kernels.load("lane_rows")
    y = torch.empty(m, dtype=torch.float32, device=vals.device)
    carry = torch.empty(2 * max(nb, 1), dtype=torch.float32,
                        device=vals.device)
    err = lib.lane_rows(
        vals.data_ptr(), idx.data_ptr(), ctab.data_ptr(), qptr.data_ptr(),
        blk_lo.data_ptr(), x.data_ptr(), carry.data_ptr(), y.data_ptr(), nb,
        vals.numel(), m, x.numel(), vals.shape[1],
        _kernels.stream_handle(vals.device))
    _kernels.check(lib, err, "lane_rows")
    LAUNCHES["lane_rows"] += 1
    return y


def decode_cols(idx, ctab, n_slots: int) -> torch.Tensor:
    """Each slot's column (n_slots,) int64: a 16-bit block's base plus
    the slot's unsigned word, a 32-bit block's low word joined with its
    high half (a column of 2^31 or more lies outside x, as the kernel's
    unsigned compare finds it)."""
    dev = idx.device
    s = torch.arange(n_slots, device=dev)
    blk = s // BLOCK_SLOTS
    base = ctab[:, 0].long()[blk]
    u = idx.long() & 0xFFFF
    narrow = base >= 0
    high_at = ctab[:, 1].long()[blk] + s - blk * BLOCK_SLOTS
    high = u[torch.where(narrow, s, high_at)]
    return torch.where(narrow, base + u[:n_slots], u[:n_slots] | (high << 16))


def lane_rows_plain(vals, idx, ctab, qptr, blk_lo, x) -> torch.Tensor:
    """:func:`lane_rows` in PyTorch ops: the columns decoded, then
    ``pell_rows_plain``, the kernel's order."""
    cols = decode_cols(idx, ctab, vals.numel()).view(vals.shape)
    return pell_rows_plain(vals, cols, qptr, blk_lo, x)

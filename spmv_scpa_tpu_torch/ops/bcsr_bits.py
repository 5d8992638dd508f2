"""BCSR over bitmap tiles: the Hopper layout of ``cuda-bcsr`` and
``cuda-bcsr-spmm`` (their default layout), with the kernels
:func:`bcsr_bits` (SpMV) and :func:`bcsr_bits_spmm` (SpMM) in
``csrc/bcsr_bits.cu``.

The reference's BCSR (``formats/bcsr.py``, ``layout="tiles"``) streams
every (8, 128) tile dense, 4 KB a tile, so that a TPU's vector unit and
MXU take whole tiles; at the flagship's fill of 0.16 most of those bytes
are zeros. Here the tiles are the same, in the same order, with the same
f32 values, but only the stored slots are kept:

* ``bits (T, 8, 4)`` int32: each tile row's 128-bit occupancy mask, word
  ``w`` holding lanes ``32w .. 32w + 31`` (bit ``lane % 32``). A bit is
  set where A has an entry: the mask is structural, so an explicit zero
  stays stored, and duplicate coordinates are one slot holding their
  sum (added in CSR order in float64, then rounded to f32, as
  ``csr_to_bcsr`` accumulates them);
* ``vals (S,)`` f32: the stored slots in (tile, row, lane) order;
* ``vptr (T + 1,)`` int32: tile t's first value, ``vptr[T] = S``;
* ``pan (T,)`` int32: each tile's column panel (columns
  ``pan[t] * 128 .. + 127``);
* ``rowptr (mb + 1,)`` int32: block row b's tiles are
  ``rowptr[b] .. rowptr[b + 1] - 1``, in column order.

No window padding and no step tables: a warp walks its block row's
tiles through ``rowptr``, so nothing is carried between blocks. The
plan is built from A's coordinates in one sort, without the dense tile
stack; the tests decode it back to ``csr_to_bcsr``'s tiles exactly.

The sums (the kernels and the plain versions alike, every product and
sum rounded separately, no atomics, so the plain versions run on the
CPU equal the kernels bit for bit):

* SpMV: lane l of a block row's warp owns lanes ``l, 32 + l, 64 + l,
  96 + l`` (bit l of each mask word) of each of the 8 rows. Per row it
  keeps one sum across all the block row's tiles, adding its slots'
  products tile by tile, word by word; then the 32 lanes' sums of a row
  are added as a halving tree (lane l with l + 16, then with l + 8, ...,
  l + 1).
* SpMM: ``Y[i, c]`` adds the products of row i's stored slots in (tile,
  lane) order, that is in column order, one after another.

An absent slot adds nothing. So y differs from the dense tiles' y only
in the order of the sums, and where x holds inf or NaN at an absent
slot's column (the dense tiles multiply it by 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.formats.panel_ell import BR

WORDS = BC // 32             # mask words per tile row

# Launches of each CUDA kernel by its wrapper in this process.
LAUNCHES = {"bcsr_bits": 0, "bcsr_bits_spmm": 0}


@dataclass
class BitsPlan:
    """One matrix packed in bitmap tiles, host side."""

    m: int
    n: int
    bits: np.ndarray         # (T, 8, 4) int32
    vals: np.ndarray         # (S,) float32
    vptr: np.ndarray         # (T + 1,) int32
    pan: np.ndarray          # (T,) int32
    rowptr: np.ndarray       # (mb + 1,) int32
    meta: dict
    hbm_bytes: int
    dtype: torch.dtype = torch.float32

    @property
    def num_tiles(self) -> int:
        return self.pan.size


def refuse_dense_tiles(tiles: int, max_padded_bytes: int) -> None:
    """The reference's refusal of a matrix too scattered for dense tiles
    (``prepare_bcsr``): raise ValueError past ``max_padded_bytes``."""
    if tiles * BR * BC * 4 > max_padded_bytes:
        raise ValueError(
            f"bcsr: {tiles} tiles would need {tiles * BR * BC * 4} B; "
            "matrix too scattered for dense tiles — use cuda-pell")


def plan_bcsr_bits(A: CSR, max_padded_bytes: int | None = None) -> BitsPlan:
    """Pack ``A`` in bitmap tiles (module docstring). With
    ``max_padded_bytes``, refuse (ValueError) a matrix whose dense tiles
    would exceed it, as ``plan_bcsr`` does, before any value is packed."""
    rows = A.row_ids().astype(np.int64)
    cols = A.ja.astype(np.int64)
    npan = max(1, -(-A.n // BC))
    mb = -(-A.m // BR)
    # a slot's key: tile (block row, panel), then row, then lane
    key = (((rows // BR) * npan + cols // BC) * BR + rows % BR) * BC \
        + cols % BC
    slots, inv = np.unique(key, return_inverse=True)
    S = slots.size
    tkey = slots // (BR * BC)
    first = np.ones(S, dtype=bool)
    first[1:] = tkey[1:] != tkey[:-1]
    starts = np.flatnonzero(first)
    T = starts.size
    if max_padded_bytes is not None:
        refuse_dense_tiles(T, max_padded_bytes)
    if S >= 1 << 31:
        raise ValueError(f"bcsr_bits: {S} stored slots exceed the int32 "
                         "value index")
    # duplicates add in CSR order from 0.0 in float64, as np.add.at does
    # in csr_to_bcsr (bincount walks its input in order)
    vals = np.bincount(inv.reshape(-1), weights=A.as_,
                       minlength=S).astype(np.float32)
    tile_of = np.cumsum(first) - 1
    word = tile_of * (BR * WORDS) + (slots % (BR * BC)) // 32
    bit = np.left_shift(np.uint32(1), (slots % 32).astype(np.uint32))
    wfirst = np.ones(S, dtype=bool)
    wfirst[1:] = word[1:] != word[:-1]
    wstart = np.flatnonzero(wfirst)
    bits = np.zeros(T * BR * WORDS, dtype=np.uint32)
    if S:
        bits[word[wstart]] = np.bitwise_or.reduceat(bit, wstart)
    vptr = np.append(starts, S).astype(np.int32)
    tile_keys = tkey[starts]
    pan = (tile_keys % npan).astype(np.int32)
    rowptr = np.zeros(mb + 1, dtype=np.int64)
    np.cumsum(np.bincount(tile_keys // npan, minlength=mb), out=rowptr[1:])
    plan = BitsPlan(m=A.m, n=A.n,
                    bits=bits.view(np.int32).reshape(T, BR, WORDS),
                    vals=vals, vptr=vptr, pan=pan,
                    rowptr=rowptr.astype(np.int32), meta={}, hbm_bytes=0)
    plan.hbm_bytes = sum(a.nbytes for a in (plan.bits, plan.vals, plan.vptr,
                                            plan.pan, plan.rowptr))
    plan.meta = {"layout": "bits", "num_blocks": T, "stored": S,
                 "block_rows": mb, "fill": A.nnz / max(T * BR * BC, 1)}
    return plan


def decode(bits, vals, vptr) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, tiles) of a bitmap plan, each (T, 8, 128): the occupancy
    and the dense f32 tiles (0.0 at absent slots). A slot's value is
    ``vals[vptr[t] + its rank among the tile's set bits]``, as the
    kernels find it."""
    T = bits.shape[0]
    dev = bits.device
    w = bits.view(T, BR, WORDS, 1).to(torch.int64) & 0xFFFFFFFF
    mask = ((w >> torch.arange(32, device=dev)) & 1).bool().view(T, BR, BC)
    rank = mask.view(T, BR * BC).to(torch.int64).cumsum(1) - 1
    pos = (vptr[:T].to(torch.int64)[:, None] + rank).clamp(
        0, max(vals.numel() - 1, 0))
    got = vals[pos] if vals.numel() else torch.zeros_like(pos,
                                                          dtype=vals.dtype)
    tiles = torch.where(mask.view(T, BR * BC), got, 0.0).view(T, BR, BC)
    return mask, tiles


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------

def _check(what, bits, vals, vptr, pan, rowptr, x, m: int, xdim: int):
    if bits.dtype != torch.int32 or bits.dim() != 3 \
            or tuple(bits.shape[1:]) != (BR, WORDS):
        raise ValueError(f"{what}: bits are {bits.dtype} "
                         f"{tuple(bits.shape)}, expected int32 (T, 8, 4)")
    T = bits.shape[0]
    if vals.dtype != torch.float32 or vals.dim() != 1 \
            or vals.numel() >= 1 << 31:
        raise ValueError(f"{what}: vals are {vals.dtype} "
                         f"{tuple(vals.shape)}, expected float32 (S,) with "
                         "S < 2^31")
    if vptr.dtype != torch.int32 or tuple(vptr.shape) != (T + 1,):
        raise ValueError(f"{what}: vptr is {vptr.dtype} "
                         f"{tuple(vptr.shape)}, expected int32 ({T + 1},)")
    if pan.dtype != torch.int32 or tuple(pan.shape) != (T,):
        raise ValueError(f"{what}: pan is {pan.dtype} {tuple(pan.shape)}, "
                         f"expected int32 ({T},)")
    mb = -(-m // BR)
    if rowptr.dtype != torch.int32 or tuple(rowptr.shape) != (mb + 1,):
        raise ValueError(f"{what}: rowptr is {rowptr.dtype} "
                         f"{tuple(rowptr.shape)}, expected int32 "
                         f"({mb + 1},)")
    if x.dtype != torch.float32 or x.dim() != xdim:
        raise ValueError(f"{what}: x is {x.dtype} {tuple(x.shape)}, "
                         f"expected float32 with {xdim} dimension(s)")
    for name, t in (("bits", bits), ("vals", vals), ("vptr", vptr),
                    ("pan", pan), ("rowptr", rowptr), ("x", x)):
        if t.device != bits.device:
            raise ValueError(f"{what}: {name} is on {t.device}, bits on "
                             f"{bits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {bits.device}")
    if bits.device.type == "cuda" and bits.data_ptr() % 16:
        raise ValueError(f"{what}: bits are not 16-byte aligned")


def bcsr_bits(bits, vals, vptr, pan, rowptr, x, m: int) -> torch.Tensor:
    """y (m,) f32 of the bitmap tiles: the module docstring's SpMV sum of
    ``vals * x[pan * 128 + lane]`` over the stored slots, a column at or
    past ``x.numel()`` reading 0.0. CUDA tensors launch
    ``csrc/bcsr_bits.cu``; CPU tensors run :func:`bcsr_bits_plain`."""
    _check("bcsr_bits", bits, vals, vptr, pan, rowptr, x, m, 1)
    if bits.device.type == "cpu":
        return bcsr_bits_plain(bits, vals, vptr, pan, rowptr, x, m)
    lib = _kernels.load("bcsr_bits")
    y = torch.empty(m, dtype=torch.float32, device=bits.device)
    err = lib.bcsr_bits(bits.data_ptr(), vals.data_ptr(), vptr.data_ptr(),
                        pan.data_ptr(), rowptr.data_ptr(), x.data_ptr(),
                        y.data_ptr(), m, x.numel(),
                        _kernels.stream_handle(bits.device))
    _kernels.check(lib, err, "bcsr_bits")
    LAUNCHES["bcsr_bits"] += 1
    return y


def bcsr_bits_spmm(bits, vals, vptr, pan, rowptr, X, m: int) -> torch.Tensor:
    """Y (m, cols) f32 = A @ X of the bitmap tiles, X (n, cols): the
    module docstring's SpMM sum, a row of X at or past ``X.shape[0]``
    reading 0.0. CUDA tensors launch ``csrc/bcsr_bits.cu``; CPU tensors
    run :func:`bcsr_bits_spmm_plain`."""
    _check("bcsr_bits_spmm", bits, vals, vptr, pan, rowptr, X, m, 2)
    if bits.device.type == "cpu":
        return bcsr_bits_spmm_plain(bits, vals, vptr, pan, rowptr, X, m)
    lib = _kernels.load("bcsr_bits")
    Y = torch.empty((m, X.shape[1]), dtype=torch.float32, device=bits.device)
    err = lib.bcsr_bits_spmm(bits.data_ptr(), vals.data_ptr(),
                             vptr.data_ptr(), pan.data_ptr(),
                             rowptr.data_ptr(), X.data_ptr(), Y.data_ptr(),
                             m, X.shape[0], X.shape[1],
                             _kernels.stream_handle(bits.device))
    _kernels.check(lib, err, "bcsr_bits_spmm")
    LAUNCHES["bcsr_bits_spmm"] += 1
    return Y


def _gather_rows(x, col):
    """``x[col]`` (rows of x for a 2-D x), 0.0 where ``col`` is at or
    past ``x.shape[0]``."""
    n = x.shape[0]
    ok = col < n
    if n == 0:
        return torch.zeros(col.shape + x.shape[1:], dtype=x.dtype,
                           device=x.device)
    g = x[col.clamp(max=n - 1)]
    return torch.where(ok.view(ok.shape + (1,) * (x.dim() - 1)), g, 0.0)


def bcsr_bits_plain(bits, vals, vptr, pan, rowptr, x, m: int) -> torch.Tensor:
    """:func:`bcsr_bits` in PyTorch ops, in the kernel's order: every
    block row at once, its j-th tile, then the tile's 4 slots of each
    lane (one a mask word) in order, each product and sum rounded
    separately (a slot that is not stored leaves the sum as it is); then
    the halving tree over the 32 lanes."""
    dev = bits.device
    T = bits.shape[0]
    mb = rowptr.numel() - 1
    mask, tiles = decode(bits, vals, vptr)
    col = pan.to(torch.int64)[:, None] * BC + torch.arange(BC, device=dev)
    xg = _gather_rows(x, col)                                   # (T, 128)
    prod = (tiles * xg[:, None]).view(T, BR, WORDS, 32)
    live4 = mask.view(T, BR, WORDS, 32)
    start = rowptr[:-1].to(torch.int64)
    count = rowptr[1:].to(torch.int64) - start
    acc = torch.zeros((mb, BR, 32), dtype=torch.float32, device=dev)
    for j in range(int(count.max()) if mb and T else 0):
        live = (count > j).view(mb, 1, 1)
        t = torch.where(count > j, start + j, 0)
        for q in range(WORDS):
            acc = torch.where(live & live4[t, :, q],
                              acc + prod[t, :, q], acc)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc.reshape(mb * BR)[:m].contiguous()


def bcsr_bits_spmm_plain(bits, vals, vptr, pan, rowptr, X,
                         m: int) -> torch.Tensor:
    """:func:`bcsr_bits_spmm` in PyTorch ops, in the kernel's order: the
    stored slots of each row in (tile, lane) order, the k-th of every row
    at once, each product and sum rounded separately."""
    dev = bits.device
    mb = rowptr.numel() - 1
    cols = X.shape[1]
    mask, tiles = decode(bits, vals, vptr)
    t, r, lane = mask.nonzero(as_tuple=True)            # (tile, row, lane)
    v = tiles[t, r, lane]
    counts = (rowptr[1:] - rowptr[:-1]).to(torch.int64)
    blk = torch.repeat_interleave(torch.arange(mb, device=dev), counts)
    row = blk[t] * BR + r
    col = pan.to(torch.int64)[t] * BC + lane
    order = torch.sort(row, stable=True).indices
    row, col, v = row[order], col[order], v[order]
    n_row = torch.bincount(row, minlength=mb * BR)
    first = torch.cumsum(n_row, 0) - n_row
    rank = torch.arange(row.numel(), device=dev) - first[row]
    acc = torch.zeros((mb * BR, cols), dtype=torch.float32, device=dev)
    for k in range(int(n_row.max()) if row.numel() else 0):
        sel = (rank == k).nonzero(as_tuple=True)[0]
        rk = row[sel]
        acc[rk] = acc[rk] + v[sel, None] * _gather_rows(X, col[sel])
    return acc[:m].contiguous()


# ---------------------------------------------------------------------------
# Binding
# ---------------------------------------------------------------------------

def bind_plan(plan: BitsPlan, dev, spmm: bool = False) -> Callable:
    """The plan's arrays on ``dev``, and ``run(x, ops)`` for x (n,) or,
    with ``spmm``, X (n, cols) (f32, on ``dev``) through
    ``ops.bcsr_bits`` or ``ops.bcsr_bits_spmm``."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    args = tuple(put(a) for a in (plan.bits, plan.vals, plan.vptr, plan.pan,
                                  plan.rowptr))
    m = plan.m

    def run(x, ops):
        kernel = ops.bcsr_bits_spmm if spmm else ops.bcsr_bits
        return kernel(*args, x, m)

    return run

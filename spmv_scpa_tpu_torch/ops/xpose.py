"""XPOSE on PyTorch and CUDA (counterpart of ``spmv_scpa_tpu/ops/xpose.py``):
the static-routed transpose SpMV of the scattered regime, ``cuda-xpose``.

The host plan (``ops/xpose_plan.py``, the reference's planner copied)
turns the matrix into uint8 routing planes. A call runs two stages, S1
(x times the values, each product stored at its slot of the product
array ``mid`` (B2, J1, 128), in S3's layout) and S3 (each row of y from
its products), each in one of two designs.

Stage S1 (``s1``, knob of :func:`prepare_xpose` and :func:`bind_plan`):

* ``"slots"``, :func:`xpose_s1_slots`: the plan's S1 routing resolved
  once on the host (:func:`s1_slots_table`) into "mid slot <- (x
  column, value)" for exactly the slots that S3's row table reads, the
  mirror windows folded in; one launch reads x in place and writes
  those slots, nothing else;
* ``"slab"``: the reference's design carried over, :func:`xpose_mirror`
  copying popular x ranges into mirror windows, then :func:`xpose_s1`
  per step of one (128, 128) x window building the slab of products and
  routing it to every slot of ``mid`` (the reference's S2 ``swapaxes``
  folded into these stores);
* ``"auto"`` (the default): ``"slots"`` on ``s3="rows"``, ``"slab"`` on
  ``s3="prefix"``, whose block prefix sums read every slot of ``mid``
  and so need the zeros that only the slab design writes.

Stage S3 (``s3``):

* ``"rows"`` (the default), :func:`xpose_s3_rows`: each row of y as the
  sum of its product slots, read through a table that
  :func:`s3_rows_table` builds from the plan's S3 planes once (each real
  row's slots in ``mid``, its virtual rows' folded in), so y comes out
  whole;
* ``"prefix"``, :func:`xpose_s3`: the reference's design carried over,
  per out-block routing the products to dense row-major slots, taking
  the block's prefix sum and writing ``y[row] = prefix(end of row) -
  prefix(end of previous row)`` straight into y's row order; the
  virtual (split) rows then add back onto their rows with
  ``index_add_``, an XLA scatter outside any kernel in the reference
  too.

Each kernel's wrapper launches ``csrc/xpose.cu`` on a CUDA tensor and
runs its plain PyTorch version on a CPU tensor; an index outside its
range reads 0.0. The plain versions repeat the kernels' arithmetic (one
f32 product per slot; the prefix sums as Hillis-Steele steps ``p[l] +
p[l - d]``; the row sums in :func:`xpose_s3_rows_plain`'s fixed order),
so kernel and plain version agree bit for bit, and both S1 designs give
the same products at every slot S3 reads.

The reference's TPU-only geometry (G_SUB step batching, the VMEM caps,
the K1p padding of S3's planes and W3's two-window split) has no role
here and is recorded in ``meta["tpu_knobs"]``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import xpose_plan
from spmv_scpa_tpu_torch.ops.registry import Prepared, record_calls
from spmv_scpa_tpu_torch.ops.xpose_plan import CCAP, X_EXT_BUDGET, XposePlan
from spmv_scpa_tpu_torch.utils.platform import resolve_device

# The reference's TPU step batching and the VMEM bound derived from it
# (ops/xpose.py:42-47), recorded for parity only.
G_SUB = 8
X_VMEM_CAP = X_EXT_BUDGET + (G_SUB - 1) * BC * BC * 4
STAGE_ROWS = 64              # y staging rows (of 128) per out-block
N_S3_PLANES = 8              # sub, r3b, rpre1, ys1, r3y1, rpre2, ys2, r3y2
S3_DESIGNS = ("rows", "prefix")
S1_DESIGNS = ("auto", "slots", "slab")
SLOT_CHUNK = 1024            # table entries a block of xpose_s1_slots
SLOT_GROUP = 128             # entries a warp loads at once (32 lanes x 4)
NO_SLOT = 0xFFFF             # an entry's (k, c2) field: padding, no store
SHORT_ROW = 32               # longest row one lane sums (csrc kShortRow)
WARP = 32

# Launches of each CUDA kernel by its wrapper in this process.
LAUNCHES = {"xpose_mirror": 0, "xpose_s1": 0, "xpose_s1_slots": 0,
            "xpose_s3": 0, "xpose_s3_rows": 0}


# ---------------------------------------------------------------------------
# The kernels: wrappers and plain versions
# ---------------------------------------------------------------------------

def _check(what: str, tensors: dict, dev):
    """Each ``name: (tensor, dtype, shape)`` on ``dev``, of that dtype and
    shape, contiguous."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_x(what: str, x):
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"{what}: x is {x.dtype} {tuple(x.shape)}, "
                         "expected float32 (n,)")


def _launch(what: str, out, *args):
    lib = _kernels.load("xpose")
    err = getattr(lib, what)(*args, _kernels.stream_handle(out.device))
    _kernels.check(lib, err, what)
    LAUNCHES[what] += 1
    return out


def _x_rows(x, rows: int):
    """x zero-padded to ``rows`` rows of 128 (the plain versions' view of
    the normal windows)."""
    xr = torch.zeros(rows * BC, dtype=torch.float32, device=x.device)
    k = min(x.numel(), rows * BC)
    xr[:k] = x[:k]
    return xr.view(rows, BC)


def xpose_mirror(x, msw, mir_sel, mir_sub) -> torch.Tensor:
    """The mirror windows (replaces ``_mirror_kernel``): ``out[v*128 + s,
    l]`` = row ``msw[v*4 + mir_sel[v, s]] * 128 + mir_sub[v, s]`` of x as
    rows of 128, lane ``l`` (0.0 past x). ``x`` (n,) f32, ``msw`` int32
    (NWm*4,), ``mir_sel``/``mir_sub`` (NWm, 128) uint8; returns
    (NWm*128, 128) f32."""
    _check_x("xpose_mirror", x)
    nwm = mir_sel.shape[0]
    _check("xpose_mirror", {
        "msw": (msw, torch.int32, (nwm * 4,)),
        "mir_sel": (mir_sel, torch.uint8, (nwm, BC)),
        "mir_sub": (mir_sub, torch.uint8, (nwm, BC))}, x.device)
    if x.device.type == "cpu":
        return xpose_mirror_plain(x, msw, mir_sel, mir_sub)
    out = torch.empty((nwm * BC, BC), dtype=torch.float32, device=x.device)
    return _launch("xpose_mirror", out, x.data_ptr(), x.numel(),
                   msw.data_ptr(), mir_sel.data_ptr(), mir_sub.data_ptr(),
                   out.data_ptr(), nwm)


def xpose_mirror_plain(x, msw, mir_sel, mir_sub) -> torch.Tensor:
    nwm = mir_sel.shape[0]
    dev = x.device
    sel = mir_sel.to(torch.int64)
    sub = mir_sub.to(torch.int64)
    v = torch.arange(nwm, device=dev)[:, None]
    src = msw.to(torch.int64)[v * 4 + sel.clamp(max=3)] * BC + sub
    idx = src[:, :, None] * BC + torch.arange(BC, device=dev)
    ok = ((sel < 4) & (sub < BC))[:, :, None] & (idx >= 0) \
        & (idx < x.numel())
    xz = torch.cat([x, x.new_zeros(1)])
    return xz[torch.where(ok, idx, x.numel())].view(nwm * BC, BC)


def xpose_s1(x, xm, win, gidx, asv, r2, r3, nw0: int,
             B2: int) -> torch.Tensor:
    """Stage S1 (replaces ``_s1_kernel`` and the S2 transpose): per step
    ``s`` with window ``xw`` (``win[s] < nw0``: rows of x, else rows of
    the mirror table ``xm``), ``slab[r, c] = xw[r, gidx[s*128 + r, c]] *
    asv[s*128 + r, c]`` (lane 127 zero), and ``mid[k, s, c2] =
    slab[r2[rt, c1], c1]`` with ``c1 = r3[rt, c2]``, ``rt = s*B2 + k``.
    ``gidx``/``asv`` (J1*128, 128) uint8/f32, ``r2``/``r3`` (J1*B2, 128)
    uint8; returns mid (B2, J1, 128) f32."""
    _check_x("xpose_s1", x)
    J1 = win.numel()
    if B2 <= 0 or nw0 * BC * BC < x.numel():
        raise ValueError(f"xpose_s1: B2={B2}, nw0={nw0} do not cover x "
                         f"({x.numel()} elements)")
    _check("xpose_s1", {
        "xm": (xm, torch.float32, (xm.shape[0] // BC * BC, BC)),
        "win": (win, torch.int32, (J1,)),
        "gidx": (gidx, torch.uint8, (J1 * BC, BC)),
        "asv": (asv, torch.float32, (J1 * BC, BC)),
        "r2": (r2, torch.uint8, (J1 * B2, BC)),
        "r3": (r3, torch.uint8, (J1 * B2, BC))}, x.device)
    if x.device.type == "cpu":
        return xpose_s1_plain(x, xm, win, gidx, asv, r2, r3, nw0, B2)
    mid = torch.empty((B2, J1, BC), dtype=torch.float32, device=x.device)
    return _launch("xpose_s1", mid, x.data_ptr(), x.numel(), xm.data_ptr(),
                   xm.shape[0] // BC, nw0, win.data_ptr(), gidx.data_ptr(),
                   asv.data_ptr(), r2.data_ptr(), r3.data_ptr(),
                   mid.data_ptr(), J1, B2)


def xpose_s1_plain(x, xm, win, gidx, asv, r2, r3, nw0: int,
                   B2: int) -> torch.Tensor:
    dev = x.device
    J1 = win.numel()
    xe = torch.cat([_x_rows(x, nw0 * BC), xm]).view(-1)
    nwt = xe.numel() // (BC * BC)
    w = win.to(torch.int64).view(J1, 1, 1)
    g = gidx.to(torch.int64).view(J1, BC, BC)
    idx = (w * BC + torch.arange(BC, device=dev).view(1, BC, 1)) * BC + g
    ok = (w >= 0) & (w < nwt) & (g < BC)
    xz = torch.cat([xe, xe.new_zeros(1)])
    slab = xz[torch.where(ok, idx, xe.numel())] * asv.view(J1, BC, BC)
    slab[:, :, CCAP] = 0.0
    c1 = r3.to(torch.int64).view(J1, B2, BC)
    c1c = c1.clamp(max=BC - 1)
    r = r2.to(torch.int64).view(J1, B2, BC).gather(2, c1c)
    ok = (c1 < BC) & (r < BC)
    flat = torch.where(ok, r * BC + c1c, BC * BC).view(J1, -1)
    slabz = torch.cat([slab.view(J1, -1), slab.new_zeros(J1, 1)], 1)
    return slabz.gather(1, flat).view(J1, B2, BC).transpose(0, 1) \
        .contiguous()


def decode_slots(head, code, J1: int):
    """Each entry of an S1 slot table (:func:`s1_slots_table`) in table
    order: (its flat index into mid (B2, J1, 128), its x column, whether
    it is an entry at all: padding stores nothing). ``head`` (C, 8)
    int32, ``code`` (C, chunk) int32."""
    c = code.to(torch.int64) & 0xFFFFFFFF
    kc2, off = c >> 16, c & 0xFFFF
    s = head[:, :1].to(torch.int64)
    pos = ((kc2 >> 7) * J1 + s) * BC + (kc2 & (BC - 1))
    src = head[:, 4:].to(torch.int64).gather(1, off >> 14)
    return pos, src * (BC * BC) + (off & (BC * BC - 1)), kc2 != NO_SLOT


def xpose_s1_slots(x, head, code, val, B2: int, J1: int) -> torch.Tensor:
    """Stage S1 over a slot table (replaces ``_mirror_kernel``,
    ``_s1_kernel`` and the S2 transpose): ``mid.flat[pos] = x[col] *
    val`` for each entry of :func:`s1_slots_table`'s table, 0.0 where
    ``val`` is 0.0 (no x read: a slot whose product is 0.0 in the slab
    design) or ``col`` lies outside x; padding stores nothing, and a
    position outside mid is skipped. ``head`` (C, 8) int32, ``code``
    and ``val`` (C, chunk) int32 and f32 (:func:`decode_slots`); returns
    mid (B2, J1, 128) f32, whose slots that the table does not name are
    left unwritten on the card (0.0 here)."""
    _check_x("xpose_s1_slots", x)
    if code.dim() != 2 or code.shape[1] % 4:
        raise ValueError(f"xpose_s1_slots: code is {tuple(code.shape)}, "
                         "expected (C, chunk) with chunk a multiple of 4")
    if B2 <= 0 or J1 <= 0 or B2 * J1 * BC >= 2 ** 31:
        raise ValueError(f"xpose_s1_slots: B2={B2}, J1={J1} give no mid "
                         "of under 2^31 slots")
    C, chunk = code.shape
    _check("xpose_s1_slots", {"head": (head, torch.int32, (C, 8)),
                              "code": (code, torch.int32, (C, chunk)),
                              "val": (val, torch.float32, (C, chunk))},
           x.device)
    if x.device.type == "cpu":
        return xpose_s1_slots_plain(x, head, code, val, B2, J1)
    if any(t.data_ptr() % 16 for t in (head, code, val)):
        raise ValueError("xpose_s1_slots: the table is not 16-byte aligned")
    mid = torch.empty((B2, J1, BC), dtype=torch.float32, device=x.device)
    return _launch("xpose_s1_slots", mid, x.data_ptr(), x.numel(),
                   head.data_ptr(), code.data_ptr(), val.data_ptr(), C,
                   chunk, mid.data_ptr(), mid.numel(), J1)


def xpose_s1_slots_plain(x, head, code, val, B2: int,
                         J1: int) -> torch.Tensor:
    pos, col, live = decode_slots(head, code, J1)
    n = x.numel()
    ok = (val != 0) & (col >= 0) & (col < n)
    xz = torch.cat([x, x.new_zeros(1)])
    prod = torch.where(ok, xz[torch.where(ok, col, n)] * val, 0.0)
    mid = torch.zeros(B2 * J1 * BC, dtype=torch.float32, device=x.device)
    keep = live & (pos >= 0) & (pos < mid.numel())
    mid[pos[keep]] = prod[keep]
    return mid.view(B2, J1, BC)


def xpose_s3(mid, planes, m2: int) -> torch.Tensor:
    """Stage S3 (replaces ``_s3_kernel`` and the strided un-blocking):
    per out-block ``b``, ``fin[f, l] = mid[b, sub[f, c], c]`` with ``c =
    r3b[f, l]``; ``psg`` = each row's inclusive prefix plus the exclusive
    prefix of the row totals; two passes ``st[q, lq] = psg[ys[q, r],
    rpre[ys[q, r], r]]`` with ``r = r3y[q, lq]`` (0 where r >= 128); and
    ``y_all[b + (q*128 + lq)*B2] = st1 - st2`` for q < 64 and rows below
    ``m2``. ``mid`` (B2, J1, 128) f32; ``planes`` (8, B2*128, 128) uint8
    in the order sub, r3b, rpre1, ys1, r3y1, rpre2, ys2, r3y2; returns
    (m2,) f32."""
    if mid.dtype != torch.float32 or mid.dim() != 3 or mid.shape[2] != BC:
        raise ValueError(f"xpose_s3: mid is {mid.dtype} "
                         f"{tuple(mid.shape)}, expected float32 (B2, J1, "
                         f"{BC})")
    B2, J1 = mid.shape[:2]
    if not 0 <= m2 <= B2 * STAGE_ROWS * BC:
        raise ValueError(f"xpose_s3: m2={m2} rows do not fit {B2} blocks "
                         f"of {STAGE_ROWS * BC}")
    _check("xpose_s3", {"mid": (mid, torch.float32, (B2, J1, BC)),
                        "planes": (planes, torch.uint8,
                                   (N_S3_PLANES, B2 * BC, BC))}, mid.device)
    if mid.device.type == "cpu":
        return xpose_s3_plain(mid, planes, m2)
    y = torch.empty(m2, dtype=torch.float32, device=mid.device)
    return _launch("xpose_s3", y, mid.data_ptr(), planes.data_ptr(),
                   y.data_ptr(), J1, B2, m2)


def _scan(p):
    """Inclusive prefix along the last axis of 128, as the kernel's
    Hillis-Steele steps: ``p[l] + p[l - d]`` for d = 1, 2, ..., 64."""
    d = 1
    while d < p.shape[-1]:
        p = torch.cat([p[..., :d], p[..., d:] + p[..., :-d]], -1)
        d *= 2
    return p


def xpose_s3_plain(mid, planes, m2: int) -> torch.Tensor:
    B2, J1 = mid.shape[:2]
    dev = mid.device
    sub, r3b, rp1, ys1, ry1, rp2, ys2, ry2 = planes.to(torch.int64).view(
        N_S3_PLANES, B2, BC, BC)
    blk = torch.arange(B2, device=dev).view(B2, 1, 1)
    cc = r3b.clamp(max=BC - 1)
    s = sub.gather(2, cc)
    ok = (r3b < BC) & (s < J1)
    midz = torch.cat([mid.view(-1), mid.new_zeros(1)])
    fin = midz[torch.where(ok, (blk * J1 + s) * BC + cc, mid.numel())]
    psum = _scan(fin)
    cinc = _scan(psum[..., BC - 1])
    cpre = torch.cat([cinc.new_zeros(B2, 1), cinc[:, :-1]], 1)
    psg = torch.cat([(psum + cpre[..., None]).view(-1), mid.new_zeros(1)])

    def extract(rpre, ys, r3y):
        r = r3y[:, :STAGE_ROWS]
        rc = r.clamp(max=BC - 1)
        f = ys[:, :STAGE_ROWS].gather(2, rc)
        fc = f.clamp(max=BC - 1)
        c = rpre.view(-1)[(blk * BC + fc) * BC + rc]
        ok = (r < BC) & (f < BC) & (c < BC)
        return psg[torch.where(ok, (blk * BC + fc) * BC + c, B2 * BC * BC)]

    st = extract(rp1, ys1, ry1) - extract(rp2, ys2, ry2)
    return st.reshape(B2, STAGE_ROWS * BC).t().reshape(-1)[:m2]


def xpose_s3_rows(mid, rowptr, pos) -> torch.Tensor:
    """Stage S3 as row sums (replaces ``_s3_kernel``, the un-blocking of y
    and the virtual rows' scatter-add): ``y[r]`` = the sum of
    ``mid.flat[pos[k]]`` over ``rowptr[r] <= k < rowptr[r + 1]``, in
    :func:`xpose_s3_rows_plain`'s order. ``mid`` (B2, J1, 128) f32;
    ``rowptr`` (m + 1,) int32 and ``pos`` (S,) int32 from
    :func:`s3_rows_table`; returns (m,) f32. A pointer outside [0, S] is
    clamped into it, an end below its start taken as the start, and a
    position outside ``mid`` reads 0.0."""
    if mid.dtype != torch.float32 or mid.dim() != 3 or mid.shape[2] != BC:
        raise ValueError(f"xpose_s3_rows: mid is {mid.dtype} "
                         f"{tuple(mid.shape)}, expected float32 (B2, J1, "
                         f"{BC})")
    if rowptr.dim() != 1 or rowptr.numel() < 1 or pos.dim() != 1:
        raise ValueError(f"xpose_s3_rows: rowptr {tuple(rowptr.shape)} and "
                         f"pos {tuple(pos.shape)} must be 1-D, rowptr of "
                         "m + 1 >= 1 pointers")
    if mid.numel() >= 2 ** 31 or pos.numel() >= 2 ** 31:
        raise ValueError("xpose_s3_rows: mid or pos past 32-bit positions")
    m = rowptr.numel() - 1
    _check("xpose_s3_rows", {"mid": (mid, torch.float32, mid.shape),
                             "rowptr": (rowptr, torch.int32, (m + 1,)),
                             "pos": (pos, torch.int32, pos.shape)},
           mid.device)
    if mid.device.type == "cpu":
        return xpose_s3_rows_plain(mid, rowptr, pos)
    y = torch.empty(m, dtype=torch.float32, device=mid.device)
    return _launch("xpose_s3_rows", y, mid.data_ptr(), mid.numel(),
                   rowptr.data_ptr(), pos.data_ptr(), pos.numel(),
                   y.data_ptr(), m)


def _halve(v):
    """The lanes' halving tree along the last axis (the kernel's xor
    shuffles 16, 8, 4, 2, 1): ``v[:h] + v[h:2h]`` until one is left."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def xpose_s3_rows_plain(mid, rowptr, pos) -> torch.Tensor:
    """:func:`xpose_s3_rows` in PyTorch ops, in the kernel's order: a row
    of at most ``SHORT_ROW`` slots adds them in table order from 0.0; a
    longer one deals them round-robin to 32 lanes, each adding its share
    in order from 0.0, and takes the lanes' halving tree."""
    dev = mid.device
    S = pos.numel()
    lo = rowptr[:-1].to(torch.int64).clamp(0, S)
    hi = torch.maximum(rowptr[1:].to(torch.int64).clamp(0, S), lo)
    n = hi - lo
    p = pos.to(torch.int64)
    p = torch.where((p >= 0) & (p < mid.numel()), p, mid.numel())
    vals = torch.cat([mid.reshape(-1), mid.new_zeros(1)])[
        torch.cat([p, p.new_full((1,), mid.numel())])]     # vals[S] = 0.0
    y = torch.zeros(n.numel(), dtype=torch.float32, device=dev)
    short = torch.nonzero((n > 0) & (n <= SHORT_ROW)).view(-1)
    for k in range(int(n[short].max()) if short.numel() else 0):
        rows = short[n[short] > k]
        y[rows] = y[rows] + vals[lo[rows] + k]
    wide = torch.nonzero(n > SHORT_ROW).view(-1)
    if wide.numel():
        lane = torch.arange(WARP, device=dev)
        part = torch.zeros((wide.numel(), WARP), dtype=torch.float32,
                           device=dev)
        for k0 in range(0, int(n[wide].max()), WARP):
            k = lo[wide, None] + k0 + lane
            part = part + vals[torch.where(k < hi[wide, None], k, S)]
        y[wide] = _halve(part)
    return y


class XposeKernels(NamedTuple):
    """The functions an XPOSE call runs, by name."""

    xpose_mirror: Callable
    xpose_s1: Callable
    xpose_s1_slots: Callable
    xpose_s3: Callable
    xpose_s3_rows: Callable


KERNELS = XposeKernels(xpose_mirror, xpose_s1, xpose_s1_slots, xpose_s3,
                       xpose_s3_rows)
PLAIN = XposeKernels(xpose_mirror_plain, xpose_s1_plain,
                     xpose_s1_slots_plain, xpose_s3_plain,
                     xpose_s3_rows_plain)


# ---------------------------------------------------------------------------
# The strategy
# ---------------------------------------------------------------------------

def plan_or_raise(A: CSR) -> XposePlan:
    """``plan_xpose(A)``, or the reference's ``ValueError`` (with the
    planner's reason) when the matrix is outside the envelope, so that
    ``spmv``'s auto route falls back."""
    plan = xpose_plan.plan_xpose(A)
    if plan is None:
        raise ValueError(
            "cuda-xpose: matrix outside the v1 planning envelope "
            "(concentrated (window, block) cells, >4M entries, or a "
            ">16k-entry row); use cuda-hybrid/cuda-pell (planner: "
            f"{xpose_plan.REJECT_REASON})")
    return plan


def s3_planes(plan: XposePlan) -> np.ndarray:
    """S3's eight routing planes stacked (8, B2*128, 128) uint8."""
    return np.stack([plan.sub, plan.r3b, plan.rpre1, plan.ys1, plan.r3y1,
                     plan.rpre2, plan.ys2, plan.r3y2])


def compact_routes(plan: XposePlan, a: np.ndarray) -> np.ndarray:
    """S1's r2 or r3 with the rows of out-blocks past B2 dropped: row
    ``s*B2 + k`` for step s and out-block k (the plan's row is ``(s*W1 +
    k // 128)*128 + k % 128``)."""
    return a.reshape(plan.J1, plan.W1 * BC, BC)[:, :plan.B2].reshape(-1, BC)


def s3_rows_table(plan: XposePlan) -> tuple[np.ndarray, np.ndarray]:
    """S3's routing resolved on the host: (rowptr (m + 1,) int32, pos (S,)
    int32), row r's product slots ``pos[rowptr[r]:rowptr[r + 1]]`` as
    flat indices into mid (B2, J1, 128), ascending.

    A final slot (f, l) of out-block b holds ``mid[b, s, c]`` with ``c =
    r3b[f, l]``, ``s = sub[f, c]`` (occupied where c < CCAP and s < J1:
    lane 127 and steps past J1 read 0.0). Row ``b + (q*128 + lq)*B2`` of
    y_all is the block's prefix at its end minus that at the previous
    row's end (the extraction passes ``(rpre1, ys1, r3y1)`` and ``(rpre2,
    ys2, r3y2)``, 255 = nothing), so it sums the occupied slots after the
    second end up to the first, in the block's row-major slot order.
    Virtual row ``m + i`` folds into row ``v_row[i]``."""
    B2, J1, m, m2 = plan.B2, plan.J1, plan.m, plan.m2

    def planes(a, rows=BC):
        return a.reshape(B2, BC, BC)[:, :rows].astype(np.int64)

    r3b = planes(plan.r3b)
    c = np.minimum(r3b, BC - 1)
    s = np.take_along_axis(planes(plan.sub), c, 2)
    occ = ((r3b < CCAP) & (s < J1)).reshape(B2, BC * BC)
    blk = np.arange(B2).reshape(B2, 1, 1)
    src = ((blk * J1 + s) * BC + c).reshape(B2, BC * BC)[occ]
    # occupied slots before each (block, slot), counted over all blocks
    before = np.zeros((B2, BC * BC + 1), np.int64)
    np.cumsum(occ, 1, out=before[:, 1:])
    before += np.r_[0, np.cumsum(before[:-1, -1])][:, None]

    def ends(rpre, ys, r3y):
        r = planes(r3y, STAGE_ROWS)
        rc = np.minimum(r, BC - 1)
        f = np.take_along_axis(planes(ys, STAGE_ROWS), rc, 2)
        fc = np.minimum(f, BC - 1)
        e = planes(rpre)[blk, fc, rc]
        return np.where((r < BC) & (f < BC) & (e < BC), fc * BC + e, -1)

    rows = blk + np.arange(STAGE_ROWS * BC).reshape(1, STAGE_ROWS, BC) * B2
    live = rows < m2
    b = np.broadcast_to(blk, rows.shape)[live]
    e1 = ends(plan.rpre1, plan.ys1, plan.r3y1)[live]
    e2 = ends(plan.rpre2, plan.ys2, plan.r3y2)[live]
    first = before[b, e2 + 1]              # e2 = -1: the block's first slot
    count = np.maximum(np.where(e1 >= 0, before[b, e1 + 1], first) - first,
                       0)
    # each y_all row's slots, then their real row
    slot = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count
                                              - first, count)
    row = np.repeat(rows[live], count)
    virt = row >= m
    row[virt] = plan.v_row[row[virt] - m]
    pos = src[slot]
    order = np.lexsort((pos, row))
    rowptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=m), out=rowptr[1:])
    return rowptr.astype(np.int32), pos[order].astype(np.int32)


def _s1_resolve(plan: XposePlan):
    """Every product slot of the S1 planes, step-major (J1, B2, 128) for
    slot (s, k, c2), which is ``mid[k, s, c2]``: (whether its product can
    be nonzero, its x offset within its step's source windows, its value)
    and each step's four source windows (J1, 4).

    The slab design computes ``mid[k, s, c2] = slab[r, c1]`` with ``c1 =
    r3[s*B2 + k, c2]``, ``r = r2[s*B2 + k, c1]`` and ``slab[r, c1] = xw[r,
    g] * asv[s*128 + r, c1]``, ``g = gidx[s*128 + r, c1]``, in the window
    ``w = win_of_step[s]``: a normal window (w < nw0) reads x column ``(w
    * 128 + r) * 128 + g``; mirror window ``v = w - nw0`` reads ``(msw[v
    * 4 + q] * 128 + sub) * 128 + g`` with ``q = mir_sel[v, r]``, ``sub =
    mir_sub[v, r]``. Both are ``src[q] * 16384 + sub * 128 + g`` with the
    offset ``q << 14 | sub << 7 | g`` (a normal window: q = 0, sub = r,
    all four sources w). The product is 0.0, and reads no x, at c1 >= 127
    (lane 127 is the reserved zero), r, g, sub >= 128, q >= 4, a window
    out of range, a column outside x, or a zero value."""
    J1, B2 = plan.J1, plan.B2
    nw0, NWm = plan.NR // BC, plan.NWm
    c1 = compact_routes(plan, plan.r3).reshape(J1, B2, BC).astype(np.int64)
    c1c = np.minimum(c1, BC - 1)
    r = np.take_along_axis(compact_routes(plan, plan.r2).reshape(
        J1, B2, BC), c1c, 2).astype(np.int64)
    rc = np.minimum(r, BC - 1)
    step = np.arange(J1).reshape(J1, 1, 1)
    cell = (step * BC + rc) * BC + c1c
    g = plan.gidx.reshape(-1)[cell].astype(np.int64)
    a = plan.asv.reshape(-1)[cell]
    w = plan.win_of_step.astype(np.int64)
    mirror = (w >= nw0) & (w < nw0 + NWm)
    v = np.where(mirror, w - nw0, 0)
    src = np.where(mirror[:, None],
                   plan.msw.astype(np.int64)[v[:, None] * 4 + np.arange(4)],
                   w[:, None])
    mir = mirror.reshape(J1, 1, 1)
    vv = v.reshape(J1, 1, 1)
    q = np.where(mir, plan.mir_sel[vv, rc], 0).astype(np.int64)
    sub = np.where(mir, plan.mir_sub[vv, rc], rc).astype(np.int64)
    qc = np.minimum(q, 3)
    col = src[step, qc] * (BC * BC) + sub * BC + g
    ok = ((c1 < CCAP) & (r < BC) & (g < BC) & (a != 0) & (q < 4)
          & (sub < BC) & (((w >= 0) & (w < nw0)) | mirror).reshape(J1, 1, 1)
          & (col >= 0) & (col < plan.n))
    off = qc << 14 | np.minimum(sub, BC - 1) << 7 | np.minimum(g, BC - 1)
    return ok, off, a, src


def s1_slots_table(plan: XposePlan, pos=None, chunk: int = SLOT_CHUNK):
    """S1's routing resolved on the host (:func:`_s1_resolve`, the mirror
    folded away) for the slots of mid that ``pos`` lists (by default the
    positions :func:`s3_rows_table` reads: stage S3 reads exactly those).
    Returns (head (C, 8) int32, code (C, chunk) int32, val (C, chunk)
    f32): chunk c holds entries of step ``head[c, 0]`` only, whose four
    source windows are ``head[c, 4:8]``; an entry's code is ``(k * 128 +
    c2) << 16 | offset`` for ``mid[k, s, c2]`` (k * 128 + c2 < B2_MAX *
    128 < 2^15) and its x column ``src[offset >> 14] * 16384 + (offset &
    16383)``; a value of 0.0 marks a slot whose product is 0.0 (no x
    read), a code of ``NO_SLOT << 16`` the padding that fills each step's
    last chunk. Entries run by step, then by mid position, each group of
    ``SLOT_GROUP`` stored interleaved (:func:`slot_order`) so that the
    kernel's 16-byte loads give lane l entries l, l + 32, l + 64, l + 96
    and each of its four stores covers 32 consecutive entries. 8 B an
    entry and 32 B a chunk, against 12 B an entry for a flat (position,
    column, value) table.

    Raises ValueError if a slot whose product can be nonzero is not in
    ``pos``: neither design would bring that product to y."""
    J1, B2 = plan.J1, plan.B2
    if chunk % SLOT_GROUP:
        raise ValueError(f"s1_slots_table: chunk {chunk} is not a multiple "
                         f"of {SLOT_GROUP}")
    if pos is None:
        pos = s3_rows_table(plan)[1]
    pos = np.asarray(pos, np.int64)
    if pos.size and (pos.min() < 0 or pos.max() >= B2 * J1 * BC):
        raise ValueError(f"s1_slots_table: positions outside mid ({B2}, "
                         f"{J1}, {BC})")
    ok, off, a, src = _s1_resolve(plan)
    read = np.zeros(B2 * J1 * BC, bool)
    read[pos] = True
    read = read.reshape(B2, J1, BC).transpose(1, 0, 2)
    lost = ok & ~read
    if lost.any():
        s, k, c2 = np.argwhere(lost)[0]
        raise ValueError(
            f"s1_slots_table: {int(lost.sum())} product slots hold an "
            f"entry that stage S3 never reads (the first: mid[{k}, {s}, "
            f"{c2}]); the plan would drop them from y")
    s_of, k_of, c2_of = np.nonzero(read)
    live = ok[s_of, k_of, c2_of]
    cnt = np.bincount(s_of, minlength=J1)
    nch = -(-cnt // chunk)
    at = slot_order(np.repeat(np.cumsum(nch) - nch, cnt) * chunk
                    + np.arange(s_of.size) - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt))
    C = int(nch.sum())
    code = np.full(C * chunk, NO_SLOT << 16, np.int64)
    code[at] = (k_of * BC + c2_of) << 16 | np.where(
        live, off[s_of, k_of, c2_of], 0)
    val = np.zeros(C * chunk, np.float32)
    val[at] = np.where(live, a[s_of, k_of, c2_of], 0.0)
    step = np.repeat(np.arange(J1), nch)
    head = np.zeros((C, 8), np.int64)
    head[:, 0] = step
    head[:, 4:] = src[step]
    return (head.astype(np.int32),
            code.astype(np.uint32).view(np.int32).reshape(C, chunk),
            val.reshape(C, chunk))


def slot_order(i):
    """Where entry ``i`` of a slot table (in step, then mid-position
    order) is stored: entry ``g * 128 + j * 32 + l`` of group g at ``g *
    128 + l * 4 + j``."""
    g, r = np.divmod(np.asarray(i), SLOT_GROUP)
    return g * SLOT_GROUP + r % 32 * 4 + r // 32


def resolve_s1(s1: str, s3: str) -> str:
    """The S1 design that ``s1`` names beside S3 design ``s3``:
    ``"auto"`` is ``"slots"`` on the row sums and ``"slab"`` on the prefix
    S3, which reads every slot of mid. Raises ValueError for a name that
    is no design, and for the slot table beside the prefix S3."""
    if s3 not in S3_DESIGNS:
        raise ValueError(f"s3 {s3!r} is not one of {S3_DESIGNS}")
    if s1 not in S1_DESIGNS:
        raise ValueError(f"s1 {s1!r} is not one of {S1_DESIGNS}")
    if s1 == "auto":
        return "slots" if s3 == "rows" else "slab"
    if s1 == "slots" and s3 == "prefix":
        raise ValueError("s1='slots' with s3='prefix': the prefix S3 reads "
                         "every slot of mid, the slot table writes only "
                         "those the row sums read; take s1='slab' or "
                         "'auto'")
    return s1


def host_tables(plan: XposePlan, s3: str = "rows", s1: str = "auto",
                tables=None) -> dict:
    """``tables`` (a dict, may be None) completed with the host tables
    that design (``s3``, ``s1``) reads: ``"rows"``, :func:`s3_rows_table`;
    ``"slots"``, :func:`s1_slots_table` over those rows' positions."""
    s1 = resolve_s1(s1, s3)
    out = dict(tables or {})
    if s3 == "rows" and "rows" not in out:
        out["rows"] = s3_rows_table(plan)
    if s1 == "slots" and "slots" not in out:
        out["slots"] = s1_slots_table(plan, out["rows"][1])
    return out


def hbm_bytes(plan: XposePlan, s3: str = "rows", s1: str = "auto",
              tables=None) -> int:
    """Bytes one call moves on the card, the port's own layout. S1 on
    ``"slots"``: the slot table (8 B an entry, 32 B a chunk), the
    products it writes and x; on ``"slab"``: S1's planes (gidx, asv, the
    used rows of r2/r3), the mirror's planes and table (written, then
    read), the product array written whole and x. Then S3's own: on
    ``"rows"`` the slot table (a pointer per row, a position per
    product), the occupied products and y; on ``"prefix"`` the product
    array whole, the eight planes and y with its virtual rows. ``tables``
    as :func:`host_tables` gives them (built here when missing)."""
    s1 = resolve_s1(s1, s3)
    J1, B2, NWm = plan.J1, plan.B2, plan.NWm
    if s1 == "slots":
        tables = host_tables(plan, s3, s1, tables)
        head, code, val = tables["slots"]
        s1_bytes = (head.nbytes + code.nbytes + val.nbytes
                    + tables["rows"][1].size * 4 + plan.n * 4)
    else:
        s1_bytes = (J1 * BC * BC * 5 + 2 * J1 * B2 * BC
                    + NWm * (4 * 4 + 2 * BC) + 2 * NWm * BC * BC * 4
                    + B2 * J1 * BC * 4 + plan.n * 4)
    if s3 == "prefix":
        return (s1_bytes + B2 * J1 * BC * 4 + N_S3_PLANES * B2 * BC * BC
                + plan.m2 * 4)
    # each entry fills one product slot: the table holds nnz positions
    return s1_bytes + (plan.m + 1) * 4 + plan.nnz * 8 + plan.m * 4


def plan_meta(plan: XposePlan, nnz: int) -> dict:
    """The reference's meta keys (``x_bytes``: the port's x table, x and
    the mirror windows), the count of virtual (split) rows, and the
    TPU-only geometry under ``tpu_knobs``."""
    nwmp = -(-plan.NWm // G_SUB) * G_SUB if plan.NWm else 0
    x_vmem = (plan.NR // BC + nwmp) * BC * BC * 4
    return {"J1": plan.J1, "B2": plan.B2, "W1": plan.W1, "W3": plan.W3,
            "NWm": plan.NWm, "x_bytes": plan.n * 4 + plan.NWm * BC * BC * 4,
            "virtual_rows": plan.m2 - plan.m,
            "fill": nnz / max(plan.J1 * CCAP * BC, 1),
            "tpu_knobs": {"G_SUB": G_SUB, "X_VMEM_CAP": X_VMEM_CAP,
                          "K1p": plan.K1p, "x_vmem_bytes": x_vmem,
                          "vmem_limit_bytes": {
                              "mirror": min(plan.NR * BC * 4 + (16 << 20),
                                            120 << 20),
                              "s1": min(x_vmem + (24 << 20), 126 << 20),
                              "s3": 64 << 20}}}


def bind_plan(plan: XposePlan, dev, s3: str = "rows", s1: str = "auto",
              tables=None) -> Callable:
    """The plan's tables on ``dev``, and ``run(xf, ops) -> y (m,)`` for x
    (f32 on ``dev``) through the kernels in ``ops`` (any object with
    :class:`XposeKernels`' fields), stage S1 on design ``s1`` and S3 on
    ``s3``; ``tables`` as :func:`host_tables` gives them."""
    s1 = resolve_s1(s1, s3)
    tables = host_tables(plan, s3, s1, tables)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    u8 = torch.uint8
    NWm, B2, J1, m, m2 = plan.NWm, plan.B2, plan.J1, plan.m, plan.m2
    nw0 = plan.NR // BC
    if s1 == "slots":
        head, code, val = (put(a, t) for a, t in zip(
            tables["slots"], (torch.int32, torch.int32, torch.float32)))
    else:
        msw = put(plan.msw[:NWm * 4], torch.int32)
        mir_sel = put(plan.mir_sel[:NWm], u8)
        mir_sub = put(plan.mir_sub[:NWm], u8)
        no_mirror = torch.zeros((0, BC), dtype=torch.float32, device=dev)
        win = put(plan.win_of_step, torch.int32)
        gidx, asv = put(plan.gidx, u8), put(plan.asv, torch.float32)
        r2 = put(compact_routes(plan, plan.r2), u8)
        r3 = put(compact_routes(plan, plan.r3), u8)
    if s3 == "rows":
        rowptr, pos = (put(a, torch.int32) for a in tables["rows"])
    else:
        planes = put(s3_planes(plan), u8)
        v_row = put(plan.v_row, torch.int64)

    def run(xf, ops):
        if s1 == "slots":
            mid = ops.xpose_s1_slots(xf, head, code, val, B2, J1)
        else:
            xm = (ops.xpose_mirror(xf, msw, mir_sel, mir_sub) if NWm
                  else no_mirror)
            mid = ops.xpose_s1(xf, xm, win, gidx, asv, r2, r3, nw0, B2)
        if s3 == "rows":
            return ops.xpose_s3_rows(mid, rowptr, pos)
        y_all = ops.xpose_s3(mid, planes, m2)
        y = y_all[:m]
        if m2 > m:
            y.index_add_(0, v_row, y_all[m:])
        return y

    return run


def prepare_xpose(A: CSR, device="cuda", s3: str = "rows", s1: str = "auto",
                  **_) -> Prepared:
    """``cuda-xpose``: plan ``A`` (:func:`plan_or_raise`) and bind ``fn(x)
    -> y`` on ``device`` (the card by default; ``"cpu"`` runs the plain
    versions), stage S3 on design ``s3`` (``"rows"``, the default, or
    ``"prefix"``; ``meta["s3"]``) and S1 on ``s1`` (``"auto"``, the
    default, ``"slots"`` or ``"slab"``; ``meta["s1"]`` the design it
    resolves to)."""
    return prepare_xpose_designs(A, ((s3, s1),), device)[(s3, s1)]


def prepare_xpose_designs(A: CSR, designs=S3_DESIGNS,
                          device="cuda") -> dict:
    """:func:`prepare_xpose` on each design of ``designs`` from one plan
    and one build of each host table: a design is an S3 design (S1 on
    ``"auto"``) or an ``(s3, s1)`` pair. Returns ``{design: Prepared}``."""
    pairs = {d: (d, "auto") if isinstance(d, str) else tuple(d)
             for d in designs}
    for s3, s1 in pairs.values():
        resolve_s1(s1, s3)
    dev = resolve_device(device)
    plan = plan_or_raise(A)
    tables = None
    for s3, s1 in pairs.values():
        tables = host_tables(plan, s3, s1, tables)
    n = A.n

    def prepared(s3, s1):
        run = bind_plan(plan, dev, s3, s1, tables)

        def call(x, ops):
            xf = torch.as_tensor(x, dtype=torch.float32, device=dev)
            if xf.shape != (n,):
                raise ValueError(f"cuda-xpose: x has shape "
                                 f"{tuple(xf.shape)}, expected ({n},)")
            return run(xf, ops)

        return Prepared("cuda-xpose", A.name, lambda x: call(x, KERNELS),
                        device=dev, nnz=A.nnz, ref="pallas-xpose",
                        hbm_bytes=hbm_bytes(plan, s3, s1, tables),
                        meta={**plan_meta(plan, A.nnz), "s3": s3,
                              "s1": resolve_s1(s1, s3)},
                        plain=lambda x: call(x, PLAIN),
                        kernel_calls=lambda xf: record_calls(
                            lambda ops: call(xf, ops), PLAIN))

    return {d: prepared(*pair) for d, pair in pairs.items()}

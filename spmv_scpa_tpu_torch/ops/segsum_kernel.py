"""Segment-sums on PyTorch and CUDA: per-quantum 8-row partials into y
(counterparts of ``spmv_scpa_tpu/ops/segsum_kernel.py``:
``make_window_segsum`` and ``make_span_segsum``).

Rows of y are grouped into windows of ``h`` 8-row blocks. The partials
(steps * rows_per_step, nq) arrive in steps; quantum ``q = t * nq + j``
(tile t, column j) carries the 8-vector in rows t*8 .. t*8+7, column j,
and adds it into one row block of y, its destination:

* :func:`window_segsum`: every step belongs to one window ``win[s]``
  and ``rbl`` holds window-local row blocks; one outside [0, h) (``h``
  marks padding) adds nothing. The chips tail, PELL's window-pure scheme
  and BCSR use it.
* :func:`span_segsum`: step s adds into the ``span`` windows
  ``base[s] .. base[s] + span - 1`` and ``rbl`` holds global row blocks;
  one outside those windows, or past ``num_windows * h``, adds nothing.
  PELL's span scheme uses it.

Both launch ``csrc/segsum.cu`` on a CUDA tensor, which reads the quanta
through tables by destination (:func:`dest_tables`, built on the host
once per matrix by :func:`window_tables` or :func:`span_tables`); on a
CPU tensor they run the plain version, which reads ``rbl`` itself. Both
sum in the same fixed order: each destination's live quanta in
ascending order, cut into chunks of at most :data:`CHUNK`; a chunk's
quanta dealt round-robin to 32 lanes that each add their share in
order, the lanes then combined pairwise (lane l with l + 16, then l + 8,
...; :func:`cell_sums`); a destination of several chunks adds their sums
in chunk order. So the kernel equals the plain version bit for bit, on
the CPU and on the card. The product that makes the chips tail's
partials stays a PyTorch multiply before the call, as it is an XLA op
outside the TPU kernel.

The fused PELL kernels (``ops/pell.py``, ``csrc/pell.cu``) keep the
older tree of ``csrc/segsum_pass.cuh``: a sum per (step, cell), then
each window's steps in step order. Its index (:func:`segment_lists`)
and plain version (:func:`step_tree_plain`) live here too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels
from spmv_scpa_tpu_torch.formats.csr import BC

BR = 8          # rows of a partial tile, and columns of y
LANES = 32      # lanes that share a cell's quanta (one warp)
# C: the most quanta one warp of csrc/segsum.cu adds (a multiple of 32)
CHUNK = 512

# Launches of the CUDA kernel by :func:`window_segsum` and by
# :func:`span_segsum` in this process.
KERNEL_LAUNCHES = 0
SPAN_LAUNCHES = 0


def make_visit_masks(base_of_step, num_windows: int, span: int,
                     rep: int) -> np.ndarray:
    """The reference's visit masks (``make_visit_masks``, copied):
    ``masks[k]`` is True, repeated ``rep`` times per window, where some
    grid step writes window ``base + k``; bool (span, num_windows*rep).
    The TPU sums its staggered outputs through them. The port's kernels
    write every window and need none: they are kept for the parity tests
    of the plans that ship them."""
    vis = np.unique(base_of_step)
    masks = np.zeros((span, num_windows), dtype=bool)
    for k in range(span):
        vk = vis + k
        masks[k, vk[vk < num_windows]] = True
    return np.repeat(masks, rep, axis=1)


# ---- the destination tables -------------------------------------------------

class DestTables(NamedTuple):
    """The kernel's index of the live quanta by destination, int32:

    * ``order`` (live quanta,): the global ids ``s * g + q``, by
      destination and ascending within one;
    * ``chunk`` (chunks + 1,): chunk c holds ``order[chunk[c]:chunk[c +
      1]]``; every destination has one chunk or more (an empty one for a
      row block no quantum reaches), consecutive, in destination order;
    * ``dest`` (chunks,): the destination row block of a chunk that is
      its destination's only one; ``-1 - d`` for each chunk of a
      destination d that has several;
    * ``warp`` (warps + 1,): warp w takes chunks ``warp[w] .. warp[w +
      1] - 1`` (:func:`warp_groups`);
    * ``hub`` (destinations of several chunks, 2): each one's first
      chunk and its number of chunks.
    """

    order: torch.Tensor
    chunk: torch.Tensor
    dest: torch.Tensor
    warp: torch.Tensor
    hub: torch.Tensor


def window_dest(rbl, win, h: int) -> torch.Tensor:
    """Destination row block of each quantum of :func:`window_segsum`
    (int64, -1 for none): ``win[s] * h + rbl`` where ``rbl`` is in [0,
    h)."""
    rbl = torch.as_tensor(rbl).reshape(-1).to(torch.int64)
    win = torch.as_tensor(win, device=rbl.device).to(torch.int64)
    step_base = win.repeat_interleave(rbl.numel() // max(win.numel(), 1)) * h
    return torch.where((rbl >= 0) & (rbl < h), step_base + rbl, -1)


def span_dest(rbl, base, h: int, span: int, num_windows: int) -> torch.Tensor:
    """Destination row block of each quantum of :func:`span_segsum`
    (int64, -1 for none): ``rbl`` where it lies in the windows ``base[s]
    .. base[s] + span - 1`` and below ``num_windows * h``."""
    rbl = torch.as_tensor(rbl).reshape(-1).to(torch.int64)
    base = torch.as_tensor(base, device=rbl.device).to(torch.int64)
    lo = base.repeat_interleave(rbl.numel() // max(base.numel(), 1)) * h
    ok = (rbl >= lo) & (rbl < lo + span * h) & (rbl < num_windows * h)
    return torch.where(ok, rbl, -1)


def chunk_layout(dest: torch.Tensor, n_dest: int, chunk: int = CHUNK):
    """How the live quanta (``dest`` >= 0, in [0, n_dest)) fall into
    chunks: ``(ids, cid, start, first, nch)`` with ``ids`` the live
    quanta by destination and ascending within one, ``cid`` (per quantum)
    its chunk or -1, and per destination where its quanta start in
    ``ids``, its first chunk ``first`` and its chunk count ``nch`` (at
    least 1)."""
    dev = dest.device
    ids = torch.nonzero(dest >= 0).flatten()
    d = dest[ids]
    srt = torch.argsort(d, stable=True)
    ids, d = ids[srt], d[srt]
    count = torch.bincount(d, minlength=n_dest)
    nch = torch.clamp((count + chunk - 1) // chunk, min=1)
    first = torch.cumsum(nch, 0) - nch
    start = torch.cumsum(count, 0) - count
    pos = torch.arange(d.numel(), device=dev) - start[d]
    cid = torch.full_like(dest, -1)
    cid[ids] = first[d] + pos // chunk
    return ids, cid, start, first, nch


def warp_groups(size: torch.Tensor) -> torch.Tensor:
    """The kernel's warps over chunks of ``size`` quanta: the first chunk
    of each warp, then the number of chunks. Aligned runs of 8, 4 or 2
    chunks share a warp when none holds more than 4, 8 or 16 quanta
    (32/k lanes a chunk, one quantum a lane), the largest run first;
    any other chunk takes a warp of its own."""
    n = size.numel()
    pad = torch.zeros(-(-n // 8) * 8, dtype=size.dtype)
    pad[:n] = size
    j8 = pad.view(-1, 8).amax(1) <= 4
    j4 = pad.view(-1, 4).amax(1) <= 8
    j2 = pad.view(-1, 2).amax(1) <= 16
    c = torch.arange(n)
    start = (c % 8 == 0) | (~j8[c // 8] & (
        (c % 4 == 0) | (~j4[c // 4] & ((c % 2 == 0) | ~j2[c // 2]))))
    return torch.cat([torch.nonzero(start).flatten(), torch.tensor([n])])


def dest_tables(dest, n_dest: int, device, chunk: int = CHUNK) -> DestTables:
    """:class:`DestTables` on ``device`` of the quanta's destinations
    ``dest`` (per quantum, -1 for none), in chunks of at most ``chunk``
    quanta; built on the host, once per matrix."""
    dest = torch.as_tensor(dest).reshape(-1).to(torch.int64).cpu()
    ids, _, start, first, nch = chunk_layout(dest, n_dest, chunk)
    owner = torch.repeat_interleave(torch.arange(n_dest), nch)
    k = torch.arange(owner.numel()) - first[owner]
    cptr = torch.cat([start[owner] + k * chunk,
                      torch.tensor([ids.numel()])])
    hubs = nch > 1
    cdest = torch.where(hubs[owner], -1 - owner, owner)

    def put(t):
        return t.to(torch.int32).contiguous().to(device)

    return DestTables(put(ids), put(cptr), put(cdest),
                      put(warp_groups(cptr.diff())),
                      put(torch.stack([first[hubs], nch[hubs]], 1)))


def window_tables(rbl, win, num_windows: int, h: int,
                  device) -> DestTables:
    """:func:`dest_tables` of :func:`window_segsum`'s quanta: ``rbl``
    (steps * g,) and ``win`` (steps,) as the call takes them."""
    return dest_tables(window_dest(np.asarray(rbl), np.asarray(win), h),
                       num_windows * h, device)


def span_tables(rbl, base, num_windows: int, h: int, span: int,
                device) -> DestTables:
    """:func:`dest_tables` of :func:`span_segsum`'s quanta."""
    return dest_tables(span_dest(np.asarray(rbl), np.asarray(base), h, span,
                                 num_windows), num_windows * h, device)


def check_dest_tables(what, device, n_quanta: int, n_dest: int, tables):
    """Raise ValueError unless ``tables`` are :class:`DestTables` of
    contiguous int32 tensors on ``device`` that fit ``n_quanta`` quanta
    and ``n_dest`` destinations."""
    if tables is None:
        raise ValueError(f"{what}: the kernel needs tables (window_tables "
                         "or span_tables of rbl, built once per matrix)")
    order, chunk, dest, warp, hub = tables
    n_chunks = dest.numel()
    want = [("order", order, (order.numel(),)),
            ("chunk", chunk, (n_chunks + 1,)),
            ("dest", dest, (n_chunks,)), ("warp", warp, (warp.numel(),)),
            ("hub", hub, (hub.shape[0], 2))]
    for name, t, shape in want:
        _check_int32(what, device, name, t, shape)
    if order.numel() > n_quanta or n_chunks < n_dest:
        raise ValueError(f"{what}: tables of {order.numel()} quanta and "
                         f"{n_chunks} chunks do not fit {n_quanta} quanta "
                         f"and {n_dest} destinations")


def _check_int32(what, device, name, t, shape):
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} is {t.dtype} "
                         f"{tuple(t.shape)}, expected int32 {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def _check(what, part, rbl, base, num_windows: int, h: int, span: int,
           rows_per_step: int, tables):
    if rows_per_step <= 0 or rows_per_step % BR:
        raise ValueError(f"{what}: rows_per_step {rows_per_step} is not a "
                         f"positive multiple of {BR}")
    if h <= 0 or num_windows <= 0 or span <= 0:
        raise ValueError(f"{what}: h {h}, num_windows {num_windows} and "
                         f"span {span} must be positive")
    if part.dtype != torch.float32 or part.dim() != 2 \
            or BC % max(part.shape[1], 1) or part.shape[0] % rows_per_step:
        raise ValueError(f"{what}: partials are {part.dtype} "
                         f"{tuple(part.shape)}, expected float32 "
                         f"(steps*{rows_per_step}, nq) with nq dividing {BC}")
    if not part.is_contiguous():
        raise ValueError(f"{what}: partials are not contiguous")
    if part.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {part.device}")
    steps = part.shape[0] // rows_per_step
    n_quanta = steps * (rows_per_step // BR) * part.shape[1]
    _check_int32(what, part.device, "rbl", rbl, (n_quanta,))
    _check_int32(what, part.device, "base", base, (steps,))
    if part.device.type != "cpu" or tables is not None:
        check_dest_tables(what, part.device, n_quanta, num_windows * h,
                          tables)


def _launch(part, tables, n_dest):
    order, chunk, dest, warp, hub = tables
    lib = _kernels.load("segsum")
    y = torch.empty((n_dest, BR), dtype=torch.float32, device=part.device)
    # chunk sums of the destinations of several chunks, by chunk id
    scratch = torch.empty((dest.numel() if hub.numel() else 0, BR),
                          dtype=torch.float32, device=part.device)
    err = lib.dest_segsum(part.data_ptr(), order.data_ptr(), chunk.data_ptr(),
                          dest.data_ptr(), warp.data_ptr(), hub.data_ptr(),
                          scratch.data_ptr(), y.data_ptr(), part.shape[1],
                          warp.numel() - 1, hub.shape[0],
                          _kernels.stream_handle(part.device))
    _kernels.check(lib, err, "dest_segsum")
    return y


def window_segsum(part, rbl, win, num_windows: int, h: int,
                  rows_per_step: int, tables) -> torch.Tensor:
    """y (num_windows * h, 8) f32 with ``y[win[s]*h + rbl[q], r] +=
    part[s*rows_per_step + (q//nq)*8 + r, q % nq]`` over the quanta q of
    each step s (q counted within the step); ``rbl`` outside [0, h) adds
    nothing, and every row of y is written. ``win`` values must lie in
    [0, num_windows). ``tables``: ``window_tables(rbl, win, num_windows,
    h, device)``, the kernel's index (the plain version reads ``rbl``)."""
    global KERNEL_LAUNCHES
    _check("window_segsum", part, rbl, win, num_windows, h, 1,
           rows_per_step, tables)
    if part.device.type == "cpu":
        return window_segsum_plain(part, rbl, win, num_windows, h,
                                   rows_per_step, tables)
    y = _launch(part, tables, num_windows * h)
    KERNEL_LAUNCHES += 1
    return y


def span_segsum(part, rbl, base, num_windows: int, h: int, span: int,
                rows_per_step: int, tables) -> torch.Tensor:
    """y (num_windows * h, 8) f32 with ``y[rbl[q], r] += part[...]`` (as
    :func:`window_segsum`) for the quanta of step s whose global row
    block ``rbl[q]`` lies in windows ``base[s] .. base[s] + span - 1``;
    rows past ``num_windows * h`` are dropped, and every row of y is
    written. ``tables``: ``span_tables(rbl, base, num_windows, h, span,
    device)``."""
    global SPAN_LAUNCHES
    _check("span_segsum", part, rbl, base, num_windows, h, span,
           rows_per_step, tables)
    if part.device.type == "cpu":
        return span_segsum_plain(part, rbl, base, num_windows, h, span,
                                 rows_per_step, tables)
    y = _launch(part, tables, num_windows * h)
    SPAN_LAUNCHES += 1
    return y


# ---- the plain versions -----------------------------------------------------

def cell_sums(qv, cell, n_cells: int) -> torch.Tensor:
    """(n_cells, 8): each cell's sum of the 8-vectors ``qv`` of the quanta
    with that ``cell`` (-1: none), in the kernels' order: the cell's
    quanta in ascending order dealt round-robin to 32 lanes, each lane
    adding its share in order, then lane l + w added into lane l for w =
    16, 8, 4, 2, 1."""
    dev = qv.device
    live = cell >= 0
    c, v = cell[live], qv[live]
    srt = torch.argsort(c, stable=True)
    c, v = c[srt], v[srt]
    count = torch.bincount(c, minlength=n_cells)
    pos = torch.arange(c.numel(), device=dev) - (torch.cumsum(count, 0)
                                                 - count)[c]
    lane, rnd = pos % LANES, pos // LANES
    by_rnd = torch.argsort(rnd, stable=True)
    per_rnd = torch.bincount(rnd, minlength=1).tolist()
    acc = torch.zeros((n_cells, LANES, BR), dtype=qv.dtype, device=dev)
    lo = 0
    for k in per_rnd:                  # one lane slot per cell per round
        i = by_rnd[lo:lo + k]
        lo += k
        acc[c[i], lane[i]] = acc[c[i], lane[i]] + v[i]
    w = LANES
    while w > 1:
        w //= 2
        acc = acc[:, :w] + acc[:, w:2 * w]
    return acc[:, 0]


def quanta(part):
    """The partials (rows, nq) as quantum-major 8-vectors, (rows/8 * nq,
    8)."""
    nq = part.shape[1]
    return part.view(-1, BR, nq).transpose(1, 2).reshape(-1, BR)


def dest_plain(part, dest, n_dest: int, chunk: int = CHUNK) -> torch.Tensor:
    """y (n_dest, 8) of the quanta's destinations ``dest`` in the
    kernel's order: :func:`cell_sums` over the chunks of
    :func:`chunk_layout`, then each destination's chunk sums in chunk
    order."""
    _, cid, _, first, nch = chunk_layout(dest, n_dest, chunk)
    sums = cell_sums(quanta(part), cid, int(nch.sum()))
    y = sums[first]
    for k in range(1, int(nch.max())):
        more = nch > k
        y[more] = y[more] + sums[first[more] + k]
    return y


def window_segsum_plain(part, rbl, win, num_windows: int, h: int,
                        rows_per_step: int, tables=None) -> torch.Tensor:
    """:func:`window_segsum` in PyTorch ops (``tables`` unused)."""
    return dest_plain(part, window_dest(rbl, win, h), num_windows * h)


def span_segsum_plain(part, rbl, base, num_windows: int, h: int, span: int,
                      rows_per_step: int, tables=None) -> torch.Tensor:
    """:func:`span_segsum` in PyTorch ops (``tables`` unused)."""
    return dest_plain(part, span_dest(rbl, base, h, span, num_windows),
                      num_windows * h)


# ---- the fused PELL kernels' tree -------------------------------------------

def segment_lists(rel: np.ndarray, nrel: int):
    """The fused PELL kernels' index of the quanta by (step, cell):
    ``rel`` (steps, g) is each quantum's cell in its step's ``nrel``
    cells (a value outside [0, nrel) adds nothing). Returns ``(order,
    ptr)`` int32: ``order[ptr[s * nrel + k]:ptr[s * nrel + k + 1]]`` are
    the global ids ``s * g + q`` of the quanta of cell k of step s,
    ascending."""
    rel = np.asarray(rel, np.int64)
    steps, g = rel.shape
    live = (rel >= 0) & (rel < nrel)
    key = (np.arange(steps, dtype=np.int64)[:, None] * nrel + rel)[live]
    ids = np.flatnonzero(live.reshape(-1))
    order = ids[np.argsort(key, kind="stable")].astype(np.int32)
    ptr = np.zeros(steps * nrel + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=steps * nrel), out=ptr[1:])
    return order, ptr.astype(np.int32)


def span_rel(rbl: np.ndarray, base: np.ndarray, h: int) -> np.ndarray:
    """Cells of the fused kernels' quanta: the global row block less the
    step's first row block, (steps, g)."""
    base = np.asarray(base, np.int64)
    return (np.asarray(rbl, np.int64).reshape(base.size, -1)
            - base[:, None] * h)


def device_lists(rel: np.ndarray, nrel: int, device):
    """:func:`segment_lists` as int32 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in segment_lists(rel, nrel))


def check_tables(what, device, steps: int, g: int, rbl, base,
                 span: int, h: int, lists):
    """Raise ValueError unless ``rbl`` (steps*g,), ``base`` (steps,) and
    ``lists`` (order, ptr (steps*span*h + 1,)) are contiguous int32
    tensors on ``device``. The plain versions, which run on the CPU,
    read ``rbl`` itself and take ``lists`` None."""
    want = [("rbl", rbl, (steps * g,)), ("base", base, (steps,))]
    if lists is None and device.type != "cpu":
        raise ValueError(f"{what}: the kernel needs lists (device_lists "
                         "of rbl, built once per matrix)")
    if lists is not None:
        order, ptr = lists
        want += [("order", order, (order.numel(),)),
                 ("ptr", ptr, (steps * span * h + 1,))]
    for name, t, shape in want:
        _check_int32(what, device, name, t, shape)


def step_tree_plain(part, rbl, base, num_windows: int, h: int, span: int,
                    rows_per_step: int) -> torch.Tensor:
    """The fused PELL kernels' segment-sum in PyTorch ops: per step an
    (span*h, 8) tile of its cells' sums (:func:`cell_sums` by (step,
    cell)), then per window the sum of the tiles of the steps that cover
    it, in step order (``index_add_``, whose atomics add in a varying
    order on the card). The partials' dtype is kept (float64 for the fp64
    fused kernel)."""
    dev = part.device
    steps = part.shape[0] // rows_per_step
    g = rows_per_step // BR * part.shape[1]
    nrel = span * h
    step_of = torch.arange(steps * g, device=dev) // g
    rel = rbl.to(torch.int64) - base.to(torch.int64)[step_of] * h
    ok = (rel >= 0) & (rel < nrel)
    tiles = cell_sums(quanta(part),
                      torch.where(ok, step_of * nrel + rel, -1),
                      steps * nrel)
    dest = (base.to(torch.int64)[:, None]
            + torch.arange(span, device=dev)).reshape(-1)
    y = torch.zeros((num_windows + span - 1, h * BR), dtype=part.dtype,
                    device=dev)
    y.index_add_(0, dest, tiles.view(steps * span, h * BR))
    return y[:num_windows].reshape(num_windows * h, BR)

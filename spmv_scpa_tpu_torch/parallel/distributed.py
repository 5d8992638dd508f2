"""Row-sharded SpMV over a list of devices (counterpart of
``spmv_scpa_tpu/parallel/distributed.py``).

A's rows are cut into nnz-balanced contiguous spans
(:func:`plan_row_shards`, the reference study's OpenMP planner
``partition_csr_rows``, csr.c:218-276), every shard padded to one row
count; x is replicated; each shard computes its rows; y is reassembled
from the shards' rows by static slices.

The mesh is a list of ``torch.device``s, one shard per entry
(:func:`make_mesh`). An entry may repeat: ``["cuda:0"] * 4`` runs four
shards on one card, ``["cpu"] * k`` runs k shards through the plain
versions on the CPU, as the tests do. x is copied once to each distinct
device, and each shard's padded y is cut to its rows and gathered on
``mesh[0]``'s device; copies between devices happen only on a host with
several cards. There is no ``torch.distributed`` process group: the
JAX package runs one program from one controller, and so does the port.

Four prepare functions, as in the reference:

* :func:`prepare_row_sharded`: gather, multiply and ``index_add_`` per
  shard (the reference's XLA segment-sum), padded entries into a dump row;
* :func:`prepare_row_sharded_hybrid`: the lane-ELL hybrid. Each shard
  packs its own core (``lane_ell.pack_lane_ell(..., x_off=r0,
  core_only=True)``: the diagonal window frame shifts by the shard's
  first row). On ``core_layout="rows"`` (the default) the cores of a
  device's shards form one row-quantum plan over their padded rows
  (shard j's at ``j * h_rows``, ``ops/lane_rows.py``), which one launch
  of :func:`lane_rows.lane_rows` runs, reading x in place. On
  ``"lanes"`` the planes pad to the shards' largest QT and strip sets
  union across shards, so one launch of :func:`lane_ell.lane_ell_sharded`
  runs every shard of a device, each reading its window of one shared
  padded x from ``r0``, out-of-window entries through per-shard ext
  panels. The tail rides per-shard chips pipelines (single plans or
  split plans, padded to shared shapes by ``chips_tail.pad_resident_plan``
  / ``pad_split_plan``: one ``chips_products`` launch per device over
  all its shards' slot tables, one ``window_segsum`` launch over every
  stream of every shard and one ``heavy_land`` into the core's (k, rows)
  y), or a padded segment-sum, on either layout;
* :func:`prepare_row_sharded_pell`: on ``layout="rows"`` (the default)
  a device's shards as one row-quantum plan over their padded rows
  (``ops/pell_rows.py``), one :func:`pell_rows.pell_rows` launch per
  device; on ``"tiles"`` the reference's fused PELL per shard, the
  tuning resolved once from the whole matrix, the tile count and span
  pinned to the shards' largest, and a per-shard row sort undone by the
  un-permute kernel.

Each returns a :class:`RowShardedSpmv` whose ``fn(x)`` runs the
kernels and whose ``plain(x)`` runs their plain versions. The TPU-tuned
choices stay for parity (the packed arrays equal the reference's).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_scpa_tpu_torch.formats.csr import BC, CSR, partition_rows_by_nnz
from spmv_scpa_tpu_torch.formats.panel_ell import BR, csr_to_pell
from spmv_scpa_tpu_torch.ops import chips_tail as CT
from spmv_scpa_tpu_torch.ops import ext_gather, lane_rows, pell
from spmv_scpa_tpu_torch.ops import pell_rows as prows
from spmv_scpa_tpu_torch.ops import lane_ell as LE
from spmv_scpa_tpu_torch.ops.registry import record_calls, traced
from spmv_scpa_tpu_torch.utils.platform import resolve_device


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The mesh: ``devices`` as ``torch.device``s (repeats allowed), or
    the first ``n_devices`` CUDA devices (all of them by default), as
    ``jax.devices()[:n]`` does. Without ``devices`` and without a CUDA
    device it raises: it never falls back to the CPU."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device; pass devices=['cpu'] * k to run "
            "the shards' plain versions on the CPU")
    mesh = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return mesh if n_devices is None else mesh[:n_devices]


def _device_groups(mesh) -> list:
    """(device, its shard indices) for each distinct device of the mesh,
    in the order of first appearance."""
    groups: dict = {}
    for d, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(d)
    return list(groups.items())


def _unpad_rows(y_pad, bounds: np.ndarray, m: int, device):
    """Global y from the shards' padded rows by static slices (``bounds``
    are host values), on ``device``."""
    parts = [y[:int(bounds[d + 1] - bounds[d])].to(device)
             for d, y in enumerate(y_pad)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    if out.shape[0] != m:
        raise AssertionError((out.shape, m))
    return out


def plan_row_shards(A: CSR, n_shards: int) -> tuple[np.ndarray, int]:
    """nnz-balanced contiguous row spans and the padded uniform shard
    height."""
    bounds = partition_rows_by_nnz(A.irp, n_shards)
    heights = np.diff(bounds)
    return bounds, int(heights.max(initial=0))


def _shard(A: CSR, bounds: np.ndarray, d: int, h_rows: int) -> CSR:
    """Shard d's rows as a CSR of ``h_rows`` rows (trailing rows empty),
    columns global."""
    S = A.slice_rows(int(bounds[d]), int(bounds[d + 1]))
    irp = np.concatenate([S.irp, np.full(h_rows + 1 - S.irp.shape[0],
                                         S.irp[-1], S.irp.dtype)])
    return CSR(S.name, h_rows, A.n, irp, S.ja, S.as_)


class DistKernels(NamedTuple):
    """The functions a row-sharded call runs, by name."""

    lane_ell_sharded: Callable
    lane_rows: Callable
    sorted_gather: Callable
    ranked_gather: Callable
    window_segsum: Callable
    chips_products: Callable
    heavy_land: Callable
    pell_fused: Callable
    unpermute: Callable
    pell_rows: Callable


KERNELS = DistKernels(LE.lane_ell_sharded, lane_rows.lane_rows,
                      ext_gather.sorted_gather, ext_gather.ranked_gather,
                      *CT.KERNELS, pell.pell_fused, pell.unpermute,
                      prows.pell_rows)
PLAIN = DistKernels(LE.lane_ell_sharded_plain, lane_rows.lane_rows_plain,
                    ext_gather.sorted_gather_plain,
                    ext_gather.ranked_gather_plain, *CT.PLAIN,
                    pell.pell_fused_plain, pell.unpermute_plain,
                    prows.pell_rows_plain)


@dataclass
class RowShardedSpmv:
    """A prepared row-sharded SpMV: ``fn(x) -> y`` (m,) f32 on
    ``mesh[0]``'s device (``device``) through the kernels, ``plain(x)``
    through their plain versions, ``kernel_calls(xf)`` every kernel call
    of one call as (name, arguments). ``args`` holds the shards' stacked
    host arrays in the order the reference stacks them (its
    ``out.args``), for the parity tests."""

    strategy: str             # row-sharded-{segsum,hybrid,pell}
    mesh: list
    fn: Callable
    m: int
    n: int
    nnz: int
    bounds: np.ndarray
    shard_nnz: np.ndarray
    plain: Callable | None = None
    kernel_calls: Callable | None = None
    meta: dict = field(default_factory=dict)
    args: tuple = ()
    hbm_bytes: int = 0

    @property
    def device(self) -> torch.device:
        return self.mesh[0]


def _finish(name: str, A: CSR, mesh, bounds, run, **kw) -> RowShardedSpmv:
    """The RowShardedSpmv of ``run(x, ops) -> y``: x (numpy or tensor)
    goes to each distinct device once, as f32 of shape (n,)."""
    n = A.n
    devs = [dev for dev, _ in _device_groups(mesh)]

    def call(x, ops):
        xs = {dev: torch.as_tensor(x, dtype=torch.float32, device=dev)
              for dev in devs}
        if xs[devs[0]].shape != (n,):
            raise ValueError(f"row-sharded SpMV: x has shape "
                             f"{tuple(xs[devs[0]].shape)}, expected ({n},)")
        return run(xs, ops)

    return RowShardedSpmv(
        strategy=name, mesh=mesh, fn=lambda x: call(x, KERNELS), m=A.m,
        n=n, nnz=A.nnz, bounds=bounds, shard_nnz=np.diff(A.irp[bounds].astype(np.int64)),
        plain=lambda x: call(x, PLAIN),
        kernel_calls=lambda xf: record_calls(lambda ops: call(xf, ops),
                                             PLAIN), **kw)


def _put(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


# ---------------------------------------------------------------------------
# Segment-sum shards
# ---------------------------------------------------------------------------

@traced("row-sharded-segsum")
def prepare_row_sharded(A: CSR, mesh=None, n_shards: int | None = None):
    """Row shards of a gather-multiply-``index_add_`` SpMV (the
    reference's XLA segment-sum local kernel). Each shard's entries pad
    to the largest shard's count; padded entries read column 0 with value
    0 into a dump row, sliced off."""
    if mesh is None:
        mesh = make_mesh(n_shards)
    n_dev = len(mesh)
    bounds, h = plan_row_shards(A, n_dev)
    shard_nnz = np.diff(A.irp[bounds].astype(np.int64))
    max_nnz = max(int(shard_nnz.max(initial=1)), 1)

    ja = np.zeros((n_dev, max_nnz), dtype=np.int32)
    as_ = np.zeros((n_dev, max_nnz), dtype=np.float64)
    seg = np.full((n_dev, max_nnz), h - 1 if h else 0, dtype=np.int32)
    all_rows = A.row_ids()
    for d in range(n_dev):
        r0, r1 = int(bounds[d]), int(bounds[d + 1])
        lo, hi = int(A.irp[r0]), int(A.irp[r1])
        k = hi - lo
        ja[d, :k] = A.ja[lo:hi]
        as_[d, :k] = A.as_[lo:hi]
        seg[d, :k] = all_rows[lo:hi] - r0
        if k < max_nnz:
            seg[d, k:] = h              # dump row (sliced off)

    groups = []
    for dev, ids in _device_groups(mesh):
        k = len(ids)
        # the device's shards as one segment-sum, shard j's rows at
        # j*(h+1)
        segj = seg[ids].astype(np.int64) + (np.arange(k) * (h + 1))[:, None]
        groups.append((dev, ids, _put(ja[ids], torch.int64, dev),
                       _put(as_[ids], torch.float32, dev),
                       _put(segj.reshape(-1), torch.int64, dev)))

    def run(xs, ops):
        y_pad = [None] * n_dev
        for dev, ids, ja_t, as_t, seg_t in groups:
            y = torch.zeros(len(ids) * (h + 1), dtype=torch.float32,
                            device=dev)
            y.index_add_(0, seg_t, (as_t * xs[dev][ja_t]).view(-1))
            y = y.view(len(ids), h + 1)
            for j, d in enumerate(ids):
                y_pad[d] = y[j, :h]
        return _unpad_rows(y_pad, bounds, A.m, mesh[0])

    return _finish("row-sharded-segsum", A, mesh, bounds, run,
                   args=(ja, as_.astype(np.float32), seg),
                   hbm_bytes=n_dev * max_nnz * 12,
                   meta={"max_nnz": max_nnz, "h_rows": h})


# ---------------------------------------------------------------------------
# The lane-ELL hybrid
# ---------------------------------------------------------------------------

def _plan_sharded_chips(cores, h_rows: int, n: int,
                        split_only: bool = False):
    """The shards' chips plans padded to one set of shapes: single plans
    when every shard's fits at one shared stage-1 reach, else split plans
    (:func:`_plan_sharded_split`). A shard without a tail plans one
    zero-valued dummy entry. None when a shard's tail fits neither."""
    tails = []
    for c in cores:
        tr, tc, tv = c.trows, c.tcols, c.tvals
        if tr.size == 0:
            tr = np.zeros(1, np.int64)
            tc = np.zeros(1, np.int64)
            tv = np.zeros(1, np.float64)
        tails.append((np.asarray(tr, np.int64),
                      np.asarray(tc, np.int64), tv))

    if split_only:                 # forced (tail_kind="chips-split")
        return _plan_sharded_split(tails, h_rows, n)

    def _plan_all(r_cap):
        ps = []
        for tr, tc, tv in tails:
            p = CT._plan_single(tr, tc, tv, h_rows, n, 256, 8,
                                r_cap=r_cap)
            if p is None:
                return None
            ps.append(p)
        return ps

    plans = _plan_all(None)
    if plans is None:
        return _plan_sharded_split(tails, h_rows, n)
    R = max(p.R for p in plans)         # one stage-1 reach
    if any(p.R != R for p in plans):
        plans = _plan_all(R)
        if plans is None:
            return _plan_sharded_split(tails, h_rows, n)

    ng = max(p.n_groups for p in plans)
    n1p = max(p.n1p_blocks for p in plans)
    nw = max(p.num_windows for p in plans)
    NH = max(p.NH for p in plans)
    steps = max(p.E8 // p.rows_per_step + (nw - p.num_windows)
                for p in plans)
    if steps * 8 * ng * 8 * 128 * 3 > CT.SPLIT_VPU_BUDGET:
        return _plan_sharded_split(tails, h_rows, n)
    out = []
    for p in plans:
        pool = np.setdiff1d(np.arange(h_rows, dtype=np.int64),
                            p.heavy_ids, assume_unique=False)
        out.append(CT.pad_resident_plan(
            p, n_groups=ng, n1p_blocks=n1p, steps=steps,
            num_windows=nw, NH=NH, heavy_pad_pool=pool))
    return out


def _plan_sharded_split(tails, h_rows: int, n: int):
    """The shards' split plans with every decision forced to one shared
    value (direct x, the windowed reach, the stage-1 reaches, the
    popularity cutoff, the stream set), padded to one template. None when
    a shard's tail does not fit, or the shared local stream would need
    the dedup'd windowed mode (past about 2M columns)."""
    frees = [CT.plan_chips_split(tr, tc, tv, h_rows, n)
             for tr, tc, tv in tails]
    if any(f is None for f in frees):
        return None
    r_hot = max((f.loc.r_hot for f in frees if f.loc), default=16)
    if -(-n // 128) + r_hot > CT.H_WIN_CAP:
        return None
    r_far = max((f.far.r1 for f in frees if f.far), default=None)
    r_cold = max((f.cold.r1 for f in frees if f.cold), default=None)
    pop_k = max(f.pop_k for f in frees)
    names = tuple(sorted(set().union(*(
        {k for k in ("loc", "far", "cold")
         if getattr(f, k) is not None} for f in frees))))
    plans = [CT.plan_chips_split(
        tr, tc, tv, h_rows, n, x_direct=True, r_hot=r_hot,
        r_far=r_far, r_cold=r_cold, pop_k=pop_k, force_streams=names)
        for tr, tc, tv in tails]
    if any(p is None for p in plans):
        return None
    tpl = CT.split_shape_template(plans)
    out = []
    for p in plans:
        pool = np.setdiff1d(np.arange(h_rows, dtype=np.int64),
                            p.heavy_ids, assume_unique=False)
        out.append(CT.pad_split_plan(p, tpl, pool))
    return out


def pack_shards(A: CSR, n_dev: int, loc_w: int | str = "auto",
                slots: int | str = "auto", chunk: int = 24,
                strip_cov: float | None = 0.985, ext: bool | str = "auto"):
    """The hybrid's row shards, each packed on its own
    (``pack_lane_ell(..., x_off=r0, core_only=True)``): (bounds, h_rows,
    loc_w, the shards as CSRs of ``h_rows`` rows, their CoreBuilds)."""
    # one window width from the global diagonal frame (x_off shifts a
    # shard's rows and window together, so the frames coincide)
    if loc_w == "auto":
        loc_w = (LE._auto_loc_w(A.row_ids().astype(np.int64),
                                A.ja.astype(np.int64))
                 if A.nnz else 128)
    bounds, h_rows = plan_row_shards(A, n_dev)
    h_rows = max(h_rows, BC)
    shards = [_shard(A, bounds, d, h_rows) for d in range(n_dev)]
    cores = [LE.pack_lane_ell(
        S, chunk=chunk, loc_w=loc_w, slots=slots, hot_k=0, ext=ext,
        ext_windowed=False, strip_cov=strip_cov, x_off=int(bounds[d]),
        core_only=True) for d, S in enumerate(shards)]
    return bounds, h_rows, loc_w, shards, cores


@traced("row-sharded-hybrid")
def prepare_row_sharded_hybrid(A: CSR, mesh=None,
                               n_shards: int | None = None,
                               core_layout: str = "rows", **knobs):
    """Row shards of the lane-ELL hybrid (module docstring), the
    reference's knobs and defaults (:func:`row_sharded_hybrid_layouts`).
    ``core_layout``: ``"rows"`` (the default) or ``"lanes"``."""
    return row_sharded_hybrid_layouts(A, (core_layout,), mesh, n_shards,
                                      **knobs)[core_layout]


def row_sharded_hybrid_layouts(A: CSR, layouts=LE.CORE_LAYOUTS, mesh=None,
                               n_shards: int | None = None,
                               loc_w: int | str = "auto",
                               slots: int | str = "auto",
                               chunk: int = 24,
                               strip_cov: float | None = 0.985,
                               tail_kind: str = "auto",
                               ext: bool | str = "auto",
                               idx8: bool = False) -> dict:
    """The row-sharded hybrid on each core layout of ``layouts`` from one
    packing of the shards: ``{layout: RowShardedSpmv}``, the tails bound
    once.
    ``tail_kind``: ``"auto"`` (per-shard chips pipelines for 2048 tail
    entries or more when they fit, else the padded segment-sum),
    ``"chips"`` (the chips
    pipelines, ValueError when a shard's tail fits no plan or there is no
    tail),
    ``"chips-split"`` (split plans even where single ones fit) or
    ``"xla"`` (the segment-sum). A device's chips tails run as one: the
    slot tables of its shards concatenated (one ``chips_products``
    launch), one segment-sum launch over every stream of every shard (the
    shards' heavy-row spaces stacked), then one ``heavy_land`` launch
    into the core's y, in place. f32, as the reference's default
    ``dtype``. The meta has the reference's keys (``panel_merge``: the
    reference's choice, ``chips_tail.merge_kind``), and ``strip_sets``
    (the union strip set of each plane) and ``tail_meta`` (each shard's
    chips plan, as the hybrid's meta states it) beside them; ``args`` are
    the reference's stacked arrays but its merge tables, the same on
    every layout; ``hbm_bytes`` counts the layout's own."""
    LE.check_layouts(layouts)
    if mesh is None:
        mesh = make_mesh(n_shards)
    n_dev = len(mesh)
    bounds, h_rows, loc_w, shards, cores = pack_shards(
        A, n_dev, loc_w=loc_w, slots=slots, chunk=chunk,
        strip_cov=strip_cov, ext=ext)

    c0 = cores[0]
    steps, S, G_pad, P_pad = c0.steps, c0.S, c0.G_pad, c0.P_pad
    if not all(c.steps == steps and c.S == S for c in cores):
        raise AssertionError("row shards packed to different steps or "
                             "strips")
    QT = max(c.QT for c in cores)
    chunk = c0.chunk

    # planes padded to the shared QT; per-plane strip sets unioned
    used_u: list[set] = [set() for _ in range(QT)]
    vals_l, idx_l = [], []
    for c in cores:
        v = c.vals_a.reshape(steps, c.QT, chunk, BC)
        ix = c.idx_a.reshape(steps, c.QT, chunk, BC)
        if c.QT < QT:
            padq = ((0, 0), (0, QT - c.QT), (0, 0), (0, 0))
            v = np.pad(v, padq)
            ix = np.pad(ix, padq)
        vals_l.append(v)
        idx_l.append(ix)
        for q, ws in enumerate(c.used):
            used_u[q].update(ws)
    sets = [tuple(sorted(u)) for u in used_u]

    # idx8 on the union strip sets: <= 2-strip planes lead and take int8
    # codes positional over the union; the shards' absolute int16 codes
    # translate here (a padding 0 decodes to the set's first strip)
    n8 = 0
    if idx8:
        order, sets, n8, second8 = LE.idx8_partition(sets, chunk)
        vals_l = [v[:, order] for v in vals_l]
        idx_l = [ix[:, order] for ix in idx_l]
    used_t = tuple(sets)
    n16 = QT - n8
    if n8:
        idx8_l = [LE.idx8_encode(ix[:, :n8], second8[None, :, None, None])
                  .reshape(-1, BC) for ix in idx_l]
        idx16_l = [ix[:, n8:].reshape(-1, BC) for ix in idx_l]
    else:
        idx8_l = [np.zeros((0, BC), np.int8) for _ in idx_l]
        idx16_l = [ix.reshape(-1, BC) for ix in idx_l]
    # (n_dev, rows, BC) stacks: the reference's sharded arrays
    vals_s = np.stack([v.reshape(-1, BC) for v in vals_l])
    idx8_s, idx16_s = np.stack(idx8_l), np.stack(idx16_l)

    # per-shard ext panels: stage-1 groups pad to the largest shard's
    # (padding groups gather into hot rows no p2 names), stage-2 tables
    # to 8-group blocks; a shard without ext never selects its panel
    use_ext_d = any(c.ext_ng for c in cores)
    if use_ext_d:
        ng_u = max(c.ext_ng for c in cores)
        n1p_u = max(max(c.ext_n1p for c in cores), 1)
        n1e = n1p_u * ext_gather.R_PANELS * BC
        G2e = -(-G_pad // 8) * 8
        etabs = []               # per shard: base, p1, l1, p2, l2
        for c in cores:
            ng = c.ext_ng
            b = np.zeros(ng_u, np.int32)
            p1 = np.zeros((ng_u * 8, BC), np.int32)
            l1 = np.zeros((ng_u * 8, BC), np.int32)
            p2 = np.zeros((G2e, BC), np.int32)
            l2 = np.zeros((G2e, BC), np.int32)
            if ng:
                b[:ng] = c.ext_base
                p1[:ng * 8] = c.ext_p1
                l1[:ng * 8] = c.ext_l1
                p2[:G_pad] = c.ext_p2
                l2[:G_pad] = c.ext_l2
            etabs.append((b, p1, l1, p2, l2))
        ext_s = [np.stack([t[i] for t in etabs]) for i in range(5)]

    # the tail: per-shard chips pipelines for big tails, else the padded
    # segment-sum
    tail_nnz_tot = int(sum(c.trows.size for c in cores))
    cplans = None
    if tail_kind in ("auto", "chips", "chips-split") and tail_nnz_tot >= (
            2048 if tail_kind == "auto" else 1):
        cplans = _plan_sharded_chips(
            cores, h_rows, A.n, split_only=(tail_kind == "chips-split"))
    if tail_kind in ("chips", "chips-split") and cplans is None:
        raise ValueError(
            f"tail_kind={tail_kind!r} forced but the tail cannot ride "
            f"the per-shard pipeline (tail_nnz={tail_nnz_tot}: empty, "
            "or a shard busts the resident-hot/VPU budgets)")
    use_chips = cplans is not None
    split_mode = use_merge = False
    if use_chips:
        split_mode = isinstance(cplans[0], CT.SplitChipsPlan)
        # the reference's landing: its ranked merge where every shard's
        # tables would fit, else index_add_ on the heavy rows
        use_merge = all(CT.merge_kind(p.heavy_ids, h_rows, G_pad,
                                      windowed=False) != "scatter"
                        for p in cplans)
    else:
        t_max = max(1, max(c.trows.size for c in cores))
        seg_a = np.full((n_dev, t_max), h_rows, np.int32)  # dump row
        tc_a = np.zeros((n_dev, t_max), np.int32)
        tv_a = np.zeros((n_dev, t_max), np.float32)
        for d, c in enumerate(cores):
            k = int(c.trows.size)
            seg_a[d, :k] = c.trows
            tc_a[d, :k] = c.tcols
            tv_a[d, :k] = c.tvals

    # host arrays in the reference's stacked order
    args = [vals_s]
    if n8:
        args.append(idx8_s)
    if n16 or not n8:
        args.append(idx16_s)
    args.append(bounds[:-1].astype(np.int32).reshape(n_dev, 1))
    if use_ext_d:
        args += ext_s
    if use_chips:
        if split_mode:
            args += [np.stack(a) for a in zip(*(
                CT.split_plan_host_args(p) for p in cplans))]
        else:
            args += [np.stack([getattr(p, k).astype(dt) for p in cplans])
                     for k, dt in (("base", np.int32), ("p1", np.int32),
                                   ("l1", np.int32), ("p2", np.int32),
                                   ("l2", np.int32), ("vals", np.float32),
                                   ("rbl", np.int32),
                                   ("win_of_step", np.int32))]
        if not (use_merge or split_mode):
            args.append(np.stack([p.heavy_ids.astype(np.int32)
                                  for p in cplans]))
    else:
        args += [seg_a, tc_a, tv_a]

    cfg = LE.LaneCfg(QT=QT, n8=n8, chunk=chunk, steps=steps, S=S,
                     nw=S + use_ext_d, TD=0, P_pad=P_pad,
                     ext_w=S if use_ext_d else -1)
    tabs_np = LE.plane_tabs(used_t, n8)
    xw = P_pad * BC
    n, m = A.n, A.m

    def ext_fn(ids, dev):
        """The ext panels (k, G_pad, 128) of a device's shards ``ids``:
        stage 1 over the global x frame (x zero-padded), one gather for
        all k shards (their tables stacked, shard j's hot rows at
        j*ng_u*8), then each shard's stage 2."""
        b, p1, l1 = (_put(ext_s[i][ids].reshape((-1,) + ext_s[i].shape[2:]),
                          torch.int32, dev) for i in range(3))
        st2 = [tuple(_put(ext_s[i][d], torch.int32, dev) for i in (3, 4))
               for d in ids]
        H = ng_u * 8

        def fn(xf, ops):
            x1 = torch.zeros(n1e, dtype=torch.float32, device=dev)
            x1[:n] = xf
            hot = ops.sorted_gather(b, x1.view(-1, BC), p1, l1,
                                    ext_gather.R_PANELS)
            return torch.stack([
                ops.ranked_gather(hot[j * H:(j + 1) * H], p2, l2)[:G_pad]
                for j, (p2, l2) in enumerate(st2)])
        return fn

    tail_hbm = 0

    def tail_group(ids, dev):
        """The tails of a device's shards ``ids``: ``fn(y, xf, ops) ->
        [y_j]`` taking the device's core output y (k, W) and giving each
        shard's padded y (h_rows,), its tail added (a shard without one
        adds nothing). The chips shards' sums come from one segment-sum
        (``CT.bind_sums``) and land by one ``heavy_land`` launch into y in
        place, shard j's heavy row r at ``j * W + r`` (a land map per core
        width: the rows core's ``h_rows``, the lanes core's ``G_pad *
        128``)."""
        nonlocal tail_hbm
        k = len(ids)
        chips = [d for d in ids if cores[d].trows.size] if use_chips else []
        if chips:
            plans = [cplans[d] for d in chips]
            sums, ranks, hbm = CT.bind_sums(plans, n, dev)
            pos = [ids.index(d) for d in chips]
            size = ranks[-1] + plans[-1].NH
            lands = {}
            for W in widths:
                land = CT.land_map(plans, ranks, size, [j * W for j in pos])
                lands[W] = CT.bind_land(land, k * W, dev)
            tail_hbm += hbm + CT.land_hbm(land)

            def fn(y, xf, ops):
                ops.heavy_land(y, sums(xf, ops), lands[y.shape[1]])
                return [y[j, :h_rows] for j in range(k)]
            return fn
        tails = [segsum_tail(d, dev) for d in ids]

        def fn(y, xf, ops):
            return [y[j, :h_rows] if tail is None else tail(y[j, :h_rows], xf)
                    for j, tail in enumerate(tails)]
        return fn

    def segsum_tail(d, dev):
        """Shard d's tail without chips: the reference's padded
        segment-sum, its real entries added into y in place (as the
        single-card compact tail does); None for a shard without one."""
        nonlocal tail_hbm
        c = cores[d]
        if not c.trows.size:
            return None
        rows = _put(c.trows, torch.int64, dev)
        tcol = _put(c.tcols, torch.int64, dev)
        tv = _put(c.tvals, torch.float32, dev)
        tail_hbm += c.trows.size * 12

        def fn(y, xf):
            return y.index_add_(0, rows, tv * xf[tcol])
        return fn

    def rows_plan(ids):
        """The cores of a device's shards ``ids`` as one row-quantum
        plan over their padded rows, shard j's at ``j * h_rows``."""
        parts = []
        for j, d in enumerate(ids):
            S, c = shards[d], cores[d].core
            parts.append((S.row_ids()[c] + j * h_rows, S.ja[c], S.as_[c]))
        r, col, v = (np.concatenate(a) for a in zip(*parts))
        return lane_rows.plan_core(len(ids) * h_rows, n, r, col,
                                   v.astype(np.float32))

    # the core's y (k, W) on each bound layout, into which the tails land
    widths = {h_rows if layout == "rows" else cfg.G_pad * BC
              for layout in layouts}
    groups = []
    rows_hbm = 0
    for dev, ids in _device_groups(mesh):
        k = len(ids)
        g = dict(dev=dev, ids=ids, tail=tail_group(ids, dev))
        if "rows" in layouts:
            cp = rows_plan(ids)
            rows_hbm += cp.hbm_bytes
            g["rows"] = lane_rows.bind(cp, dev)
        if "lanes" in layouts:
            g.update(
                vals=_put(vals_s[ids], torch.float32, dev),
                idx8=_put(idx8_s[ids], torch.int8, dev),
                idx16=_put(idx16_s[ids], torch.int16, dev),
                r0=_put(bounds[ids], torch.int32, dev),
                tabs=_put(tabs_np, torch.int32, dev),
                no_ext=torch.zeros((k, 0, BC), dtype=torch.float32,
                                   device=dev),
                ext=ext_fn(ids, dev) if use_ext_d else None)
        groups.append(g)

    def lanes_core(g, xf, ops):
        xpad = xf.new_zeros(loc_w + n + xw)
        xpad[loc_w:loc_w + n] = xf
        ext = g["no_ext"] if g["ext"] is None else g["ext"](xf, ops)
        return ops.lane_ell_sharded(xpad, g["r0"], g["vals"], g["idx8"],
                                    g["idx16"], g["tabs"], ext, cfg)

    def rows_core(g, xf, ops):
        return ops.lane_rows(*g["rows"], xf).view(len(g["ids"]), h_rows)

    def run_on(core):
        def run(xs, ops):
            y_pad = [None] * n_dev
            for g in groups:
                xf = xs[g["dev"]]
                ys = g["tail"](core(g, xf, ops), xf, ops)
                for d, y in zip(g["ids"], ys):
                    y_pad[d] = y
            return _unpad_rows(y_pad, bounds, m, mesh[0])
        return run

    slot_b = 4 * QT + n8 + 2 * n16
    meta = {"slots": QT, "loc_w": loc_w, "chunk": chunk,
            "tail_nnz": tail_nnz_tot,
            "tail_kind": (("chips-split" if split_mode else "chips")
                          if use_chips else "xla"),
            "panel_merge": bool(use_chips and use_merge),
            "strips": S, "idx8_planes": n8,
            "ext": use_ext_d,
            "ext_groups": (ng_u if use_ext_d else 0),
            "ext_n_out": int(sum(c.ext_n_out for c in cores)),
            "demoted": int(sum(c.n_demoted for c in cores)),
            "relocated": int(sum(c.n_reloc for c in cores)),
            "strip_sets": used_t}
    if use_chips:
        meta["tail_meta"] = [CT.chips_meta(p, use_merge) for p in cplans]
    core_hbm = {"rows": rows_hbm, "lanes": n_dev * G_pad * BC * slot_b}
    return {layout: _finish(
        "row-sharded-hybrid", A, mesh, bounds,
        run_on(rows_core if layout == "rows" else lanes_core),
        meta=dict(meta), args=tuple(args),
        hbm_bytes=core_hbm[layout] + tail_hbm)
        for layout in layouts}


# ---------------------------------------------------------------------------
# Fused PELL
# ---------------------------------------------------------------------------

@traced("row-sharded-pell")
def prepare_row_sharded_pell(A: CSR, mesh=None, n_shards: int | None = None,
                             layout: str = "rows",
                             quantum: int | str = "auto",
                             window_h: int | str = "auto",
                             chunk: int | str = "auto",
                             panel_w: int | str = "auto",
                             row_sort: bool | str = "auto",
                             span_max: int = 8):
    """Row shards of PELL. ``layout``: ``"rows"`` (the default: each
    device's shards as one row-quantum plan over their padded rows,
    shard j's at ``j * h_rows``, one :func:`pell_rows.pell_rows` launch
    per device, x read in place; Q from
    :func:`pell_rows.pick_quantum` over the whole matrix's row lengths,
    so that every device takes the same Q, unless ``quantum`` is given;
    no row sort, no window escalation, no un-permute; the tile knobs
    given recorded in ``meta["tile_knobs"]``) or ``"tiles"`` (the
    reference's fused PELL per shard, :func:`_row_sharded_pell_tiles`)."""
    if layout not in ("rows", "tiles"):
        raise ValueError(f"row-sharded PELL: layout {layout!r} is not "
                         "'rows' or 'tiles'")
    if mesh is None:
        mesh = make_mesh(n_shards)
    if layout == "tiles":
        return _row_sharded_pell_tiles(A, mesh, quantum, window_h, chunk,
                                       panel_w, row_sort, span_max)
    n_dev = len(mesh)
    Q = (prows.pick_quantum(np.diff(A.irp).astype(np.int64), 4)
         if quantum == "auto" else quantum)
    bounds, h_rows = plan_row_shards(A, n_dev)
    groups, plans = [], []
    for dev, ids in _device_groups(mesh):
        plan = prows.plan_pell_rows(_stack_shards(A, bounds, ids, h_rows),
                                    torch.float32, Q)
        plans.append(plan)
        groups.append((dev, ids, prows.bind_plan(plan, dev)))

    def run(xs, ops):
        y_pad = [None] * n_dev
        for dev, ids, rows in groups:
            y = rows(xs[dev], ops).view(len(ids), h_rows)
            for j, d in enumerate(ids):
                y_pad[d] = y[j]
        return _unpad_rows(y_pad, bounds, A.m, mesh[0])

    quanta = sum(p.meta["quanta"] for p in plans)
    meta = {"layout": "rows", "quantum": Q, "quanta": quanta,
            "blocks": sum(p.meta["blocks"] for p in plans),
            "fill": A.nnz / max(quanta * Q, 1), "h_rows": h_rows}
    tile = {k: v for k, v, default in (
        ("window_h", window_h, "auto"), ("chunk", chunk, "auto"),
        ("panel_w", panel_w, "auto"), ("row_sort", row_sort, "auto"),
        ("span_max", span_max, 8)) if v != default}
    if tile:
        meta["tile_knobs"] = tile
    return _finish("row-sharded-pell", A, mesh, bounds, run, meta=meta,
                   args=tuple(a for p in plans for a in (
                       p.vals, p.cols, p.qptr, p.blk_lo)),
                   hbm_bytes=sum(p.hbm_bytes for p in plans))


def _stack_shards(A: CSR, bounds: np.ndarray, ids, h_rows: int) -> CSR:
    """The shards ``ids`` of ``A`` as one CSR of ``len(ids) * h_rows``
    rows, shard j's rows at ``j * h_rows`` (each padded with empty rows
    to ``h_rows``), columns global."""
    parts = [_shard(A, bounds, d, h_rows) for d in ids]
    off = np.cumsum([0] + [S.nnz for S in parts])
    irp = np.concatenate([np.zeros(1, np.int64)] + [
        S.irp[1:].astype(np.int64) + o for S, o in zip(parts, off)])
    return CSR(A.name, len(ids) * h_rows, A.n, irp,
               np.concatenate([S.ja for S in parts]),
               np.concatenate([S.as_ for S in parts]))


def _row_sharded_pell_tiles(A: CSR, mesh, quantum, window_h, chunk,
                            panel_w, row_sort, span_max: int):
    """Row shards of the fused PELL kernel (``layout="tiles"``). The
    tuning (quantum, window_h, panel_w, row_sort, chunk) is resolved once
    from the whole matrix, so one shard packs as single-card
    ``cuda-pell`` on the tiles does; the
    window height escalates jointly until every shard's span is within
    ``span_max`` (or windows cover a shard); the tile count and the span
    pin to the shards' largest. A row-sorted shard's y goes through the
    un-permute kernel."""
    n_dev = len(mesh)

    auto = pell.auto_pell_params(A, quantum=quantum, window_h=window_h,
                                 panel_w=panel_w, row_sort=row_sort,
                                 chunk=chunk)
    quantum, pw = auto["quantum"], auto["panel_w"]
    row_sort, chunk = auto["row_sort"], auto["chunk"]

    bounds, h_rows = plan_row_shards(A, n_dev)
    h_rows = max(h_rows, BR)
    scsrs, bsrcs = [], []
    for d in range(n_dev):
        S = _shard(A, bounds, d, h_rows)
        if row_sort:
            # the shard's own rank sort; its padded height is uniform
            # because h_rows is
            sigma, bsrc = pell._rank_sort_sigma(S)
            bsrcs.append(bsrc)
            S = CSR.from_coo(S.name, bsrc.shape[0] * BR, S.n,
                             sigma[S.row_ids()], S.ja, S.as_)
        scsrs.append(S)
    m_local = scsrs[0].m                 # h_rows, or row-sort padded

    # joint window_h escalation: coarser windows until every shard's span
    # fits span_max, or the windows cover a shard
    wh0 = auto["window_h"]
    mb_local = (m_local + BR - 1) // BR
    for mult in (1, 2, 4, 0):
        wh = mb_local if mult == 0 else min(wh0 * mult, mb_local)
        wh = max(wh, 1)
        shards = [csr_to_pell(S, quantum=quantum, window_h=wh,
                              chunk_align=1, min_chunk_align=1,
                              panel_w=pw)
                  for S in scsrs]
        w_max = max(pell._span_of(p.window, chunk) for p in shards)
        if w_max <= span_max or wh >= mb_local:
            break
    use_wh = wh
    t_max = max(-(-p.num_tiles // chunk) * chunk for p in shards)

    plans = []
    for d, p in enumerate(shards):
        t = pell.fused_tables(
            m=m_local, n=A.n, vals=p.vals.astype(np.float32), lcol=p.lcol,
            panel=p.panel, rbl=p.rbl, window=p.window, window_h=use_wh,
            chunk=chunk, panel_w=p.panel_w, force_span=w_max,
            force_tiles=t_max)
        T = t["vals"].shape[0]
        plans.append(pell.PellPlan(
            kind="fused", m=m_local, n=A.n, m_orig=h_rows, quantum=quantum,
            panel_w=p.panel_w, chunk=chunk,
            vals=t["vals"].reshape(T * BR, BC),
            idx=pell._idx_plane(t["lcol"], T, p.panel_w), pan2=t["pan2"],
            rbl=t["rbl2"], base=t["base"], span=t["W"], seg="span",
            rows_per_step=chunk * BR, h=use_wh, num_win=t["num_win"],
            bsrc=bsrcs[d] if row_sort else None, meta={},
            hbm_bytes=T * BR * BC * (5 if p.panel_w == 1 else 6)))
    runs = [pell.bind_plan(p, mesh[d]) for d, p in enumerate(plans)]

    def run(xs, ops):
        return _unpad_rows([r(xs[mesh[d]], ops) for d, r in enumerate(runs)],
                           bounds, A.m, mesh[0])

    args = [np.stack([p.base for p in plans]),
            np.stack([p.pan2 for p in plans]),
            np.stack([p.rbl for p in plans]),
            np.stack([p.vals for p in plans])]
    if plans[0].idx is not None:
        args.append(np.stack([p.idx for p in plans]))
    if row_sort:
        args.append(np.stack(bsrcs))
    meta = {"quantum": quantum, "panel_w": plans[0].panel_w,
            "window_h": use_wh, "chunk": chunk, "row_sort": bool(row_sort),
            "span": w_max, "tiles": t_max}
    return _finish("row-sharded-pell", A, mesh, bounds, run, meta=meta,
                   args=tuple(args),
                   hbm_bytes=sum(p.hbm_bytes for p in plans))

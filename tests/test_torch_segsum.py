"""The segment-sum's destination tables and summation trees
(spmv_scpa_tpu_torch/ops/segsum_kernel.py) on the CPU.

* The tables (``window_tables``, ``span_tables``): every live quantum
  once, ascending within its destination, no chunk past ``CHUNK``
  quanta, and the quanta that add nothing absent.
* The plain versions of ``window_segsum`` and ``span_segsum``, which the
  CUDA kernel equals bit for bit, pinned by a numpy loop over the
  destinations, their chunks and the 32 lanes: exact, on values whose
  sums round differently in another order.
* The fused PELL kernels' two-level tree (``step_tree_plain``: cells per
  step, then windows in step order) pinned by a numpy loop, and
  ``pell_fused_plain`` equal to it on the tile kernel's partials: exact.
* A window segment-sum with a hub row block against the Pallas kernel in
  interpret mode: rel-L2 <= 1e-6 (the TPU reduces with a one-hot matmul
  on three bf16 terms of the partials, f32-grade, in another order).
* The chips tails' one table over every stream of every plan
  (``chips_tail.bind_sums``, the direct landing's) walked as the kernel
  walks it against the plain version: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_scpa_tpu.ops.segsum_kernel import make_window_segsum

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import chips_tail, pell, segsum_kernel as sk
from spmv_scpa_tpu_torch.parallel import distributed
from spmv_scpa_tpu_torch.utils.vector import make_x

C = sk.CHUNK
HUB = 3 * C + 40           # quanta of the hub row block: four chunks

# nq, tiles a step, steps: nq 1 (dense tiles), 16 (quantum 8), 128 (the
# chips tail)
SHAPES = {1: (160, 24), 16: (16, 16), 128: (4, 8)}


def _case(nq, kind, seed=0):
    """Partials with wide magnitudes, and each step's rbl and window(s):
    steps out of window order; a hub row block of HUB quanta; padding
    quanta. Four windows of 16 row blocks: the window segment-sum's steps
    sit on windows 0 and 2, the span segment-sum's (span 2) on windows
    0-1 and 3-4, of which 4 lies past y. Returns (part, rbl, base,
    num_windows, h, span, rows_per_step, dest, empty) with dest the numpy
    destination of each quantum (-1: none) and empty the windows no
    quantum reaches."""
    rng = np.random.default_rng(seed + nq)
    tps, steps = SHAPES[nq]
    g = tps * nq
    rps = tps * 8
    h, nw = 16, 4
    top, span, empty = (2, 1, [1, 3]) if kind == "window" else (3, 2, [2])
    base = np.array([top, 0, top, 0] * (steps // 4), np.int32)
    part = (rng.standard_normal((steps * rps, nq))
            * 10.0 ** rng.integers(-6, 7, (steps * rps, 1))).astype(np.float32)
    if kind == "window":
        rbl = rng.integers(0, h + 1, (steps, g))          # h: padding
        hub_rbl = np.full((steps, 1), 5)
    else:
        # global row blocks around the step's windows, some outside
        rbl = base[:, None] * h + rng.integers(-3, span * h + 3, (steps, g))
        hub_rbl = np.full((steps, 1), top * h + 5)
    # the hub: quanta of the steps of the top window
    on = np.flatnonzero(base == top)
    assert on.size * g > HUB
    pick = rng.permutation(on.size * g)[:HUB]
    hub = np.zeros(on.size * g, bool)
    hub[pick] = True
    rbl[on] = np.where(hub.reshape(on.size, g), hub_rbl[on], rbl[on])
    rbl = rbl.astype(np.int32)
    s = np.repeat(np.arange(steps), g)
    r = rbl.reshape(-1).astype(np.int64)
    if kind == "window":
        dest = np.where((r >= 0) & (r < h), base[s] * h + r, -1)
    else:
        lo = base[s].astype(np.int64) * h
        dest = np.where((r >= lo) & (r < lo + span * h) & (r < nw * h), r, -1)
    return part, rbl.reshape(-1), base, nw, h, span, rps, dest, empty


def _quanta(part, nq):
    return part.reshape(-1, 8, nq).transpose(0, 2, 1).reshape(-1, 8)


def _lanes(qv):
    """The 32 lanes' sum of the rows qv, in list order: round-robin, then
    lane l + w into lane l for w = 16, 8, 4, 2, 1."""
    lanes = np.zeros((32, 8), qv.dtype)
    for i, row in enumerate(qv):
        lanes[i % 32] = lanes[i % 32] + row
    w = 32
    while w > 1:
        w //= 2
        lanes = lanes[:w] + lanes[w:2 * w]
    return lanes[0]


def _numpy_dest_tree(qv, dest, n_dest):
    y = np.zeros((n_dest, 8), np.float32)
    for d in range(n_dest):
        ids = np.flatnonzero(dest == d)
        sums = [_lanes(qv[ids[c:c + C]]) for c in range(0, ids.size, C)]
        for k, s in enumerate(sums):
            y[d] = s if k == 0 else y[d] + s
    return y


def _call(kind, part, rbl, base, nw, h, span, rps, tables=None):
    t = (torch.as_tensor(part), torch.as_tensor(rbl), torch.as_tensor(base))
    if kind == "window":
        return sk.window_segsum(*t, nw, h, rps, tables)
    return sk.span_segsum(*t, nw, h, span, rps, tables)


def _tables(kind, rbl, base, nw, h, span):
    if kind == "window":
        return sk.window_tables(rbl, base, nw, h, "cpu")
    return sk.span_tables(rbl, base, nw, h, span, "cpu")


@pytest.mark.parametrize("chunk", [32, C])
@pytest.mark.parametrize("nq", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["window", "span"])
def test_tables_list_each_live_quantum_once_by_destination(kind, nq, chunk):
    part, rbl, base, nw, h, span, rps, dest, empty = _case(nq, kind)
    tables = (_tables(kind, rbl, base, nw, h, span) if chunk == C
              else sk.dest_tables(dest, nw * h, "cpu", chunk))
    order, cptr, cdest, warp, hub = (t.numpy() for t in tables)
    assert all(t.dtype == np.int32 for t in (order, cptr, cdest, warp, hub))
    live = np.flatnonzero(dest >= 0)
    assert np.array_equal(np.sort(order), live)        # once, and no other
    assert cptr[0] == 0 and cptr[-1] == order.size
    assert np.all(np.diff(cptr) >= 0) and np.all(np.diff(cptr) <= chunk)
    # each chunk's destination, from dest or, for a hub's chunks, the hub
    owner = np.where(cdest >= 0, cdest, -1 - cdest)
    assert np.all(np.diff(owner) >= 0)                 # destination order
    assert np.array_equal(np.unique(owner), np.arange(nw * h))
    for c in range(cdest.size):
        ids = order[cptr[c]:cptr[c + 1]]
        assert np.all(dest[ids] == owner[c])
        assert np.all(np.diff(ids) > 0)
    for d in range(nw * h):                            # ascending across
        ids = np.concatenate([order[cptr[c]:cptr[c + 1]]
                              for c in np.flatnonzero(owner == d)])
        assert np.array_equal(ids, np.flatnonzero(dest == d))
    multi = np.flatnonzero(np.bincount(owner) > 1)
    assert np.array_equal(hub[:, 0], [np.flatnonzero(owner == d)[0]
                                      for d in multi])
    assert np.array_equal(hub[:, 1], np.bincount(owner)[multi])
    assert np.array_equal(np.flatnonzero(cdest < 0),
                          np.flatnonzero(np.isin(owner, multi)))
    assert np.bincount(owner).max() >= -(-HUB // chunk) >= 2
    # warps: 1-8 chunks each, a shared warp's chunks within their lanes
    k = np.diff(warp)
    assert warp[0] == 0 and warp[-1] == cdest.size
    assert np.all((k >= 1) & (k <= 8))
    lanes = np.select([k == 1, k == 2, k <= 4], [chunk, 16, 8], 4)
    assert np.all(np.repeat(lanes, k) >= np.diff(cptr))


@pytest.mark.parametrize("nq", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["window", "span"])
def test_plain_versions_follow_the_chunk_tree(kind, nq):
    part, rbl, base, nw, h, span, rps, dest, empty = _case(nq, kind)
    y = _call(kind, part, rbl, base, nw, h, span, rps,
              _tables(kind, rbl, base, nw, h, span)).numpy()
    want = _numpy_dest_tree(_quanta(part, nq), dest, nw * h)
    np.testing.assert_array_equal(y, want)
    for w in empty:
        assert np.all(y[w * h:(w + 1) * h] == 0)
    # the order shows: the hub's sum in one running sum rounds otherwise
    hub_d = np.bincount(dest[dest >= 0]).argmax()
    flat = _quanta(part, nq)[dest == hub_d]
    assert not np.array_equal(y[hub_d], np.cumsum(flat, 0, np.float32)[-1])


def _numpy_step_tree(part, rbl, base, nw, h, span, rps):
    steps = base.size
    qv = _quanta(part, part.shape[1])
    g = qv.shape[0] // steps
    y = np.zeros(((nw + span - 1) * h, 8), part.dtype)
    for s in range(steps):
        rel = rbl[s * g:(s + 1) * g].astype(np.int64) - base[s] * h
        for k in range(span * h):
            ids = s * g + np.flatnonzero(rel == k)
            row = base[s] * h + k
            y[row] = y[row] + _lanes(qv[ids])
    return y[:nw * h]


@pytest.mark.parametrize("nq", [16, 128])
def test_step_tree_follows_cells_then_steps(nq):
    part, rbl, base, nw, h, _, rps, *_ = _case(nq, "span")
    span = 3
    y = sk.step_tree_plain(torch.as_tensor(part), torch.as_tensor(rbl),
                           torch.as_tensor(base), nw, h, span, rps).numpy()
    np.testing.assert_array_equal(
        y, _numpy_step_tree(part, rbl, base, nw, h, span, rps))


def test_pell_fused_plain_keeps_the_step_tree():
    A = synth.powerlaw_csr(3000, 3000, seed=4)
    prep = get_strategy("cuda-pell").prepare(A, device="cpu", layout="tiles")
    xf = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    (name, args), = [c for c in prep.kernel_calls(xf)
                     if c[0] == "pell_fused"]
    vals, idx, pan, x, rbl, base, cfg, _ = args
    part = pell.pell_tiles_plain(vals, idx, pan, x, cfg.quantum, cfg.panel_w)
    rps = cfg.chunk * 8
    y = pell.pell_fused_plain(*args)
    assert torch.equal(y, sk.step_tree_plain(part, rbl, base,
                                             cfg.num_windows, cfg.h,
                                             cfg.span, rps))
    np.testing.assert_array_equal(
        y.numpy(), _numpy_step_tree(part.numpy(), rbl.numpy(), base.numpy(),
                                    cfg.num_windows, cfg.h, cfg.span, rps))


def test_window_segsum_with_a_hub_matches_pallas():
    part, rbl, base, nw, h, _, rps, *_ = _case(16, "window")
    # the Pallas kernel's contract: steps in window order, and partials
    # of a size one matmul pass rounds like a sum (no 1e6 spread)
    srt = np.argsort(base, kind="stable")
    g = rbl.size // base.size
    part = part.reshape(base.size, rps, 16)[srt].reshape(-1, 16)
    part = part / np.abs(part).max(1, keepdims=True)
    rbl = rbl.reshape(base.size, g)[srt].reshape(-1)
    base = base[srt]
    y = _call("window", part, rbl, base, nw, h, 1, rps,
              _tables("window", rbl, base, nw, h, 1)).numpy()
    fn, (win_d,) = make_window_segsum(
        win_of_step=base, num_windows=nw, h=h, rows_per_step=rps, nq=16,
        total_tile_rows=part.shape[0], interpret=True)
    yj = np.asarray(fn(jnp.asarray(part), jnp.asarray(rbl), win_d))
    visited = np.repeat(np.isin(np.arange(nw), base), h)
    assert np.linalg.norm(y[visited] - yj[visited]) \
        <= 1e-6 * np.linalg.norm(yj[visited])
    assert np.all(y[~visited] == 0)


def _group_tree(qv, lanes):
    """The sum of at most ``lanes`` rows qv, one a lane from +0, then lane
    l + w into lane l for w = lanes / 2, ..., 1."""
    acc = np.zeros((lanes, 8), np.float32)
    acc[:len(qv)] = acc[:len(qv)] + qv
    while lanes > 1:
        lanes //= 2
        acc = acc[:lanes] + acc[lanes:2 * lanes]
    return acc[0]


def _walk(part, tables, n_dest):
    """y as csrc/segsum.cu computes it from the tables: per warp one
    chunk by the whole warp's lane tree, or k chunks of 32/k lanes each
    by their lanes' tree; into y or, for a hub's chunks, a scratch row by
    chunk; then each hub's rows in chunk order."""
    qv = sk.quanta(torch.as_tensor(part)).numpy()
    order, cptr, cdest, warp, hub = (t.numpy() for t in tables)
    y = np.full((n_dest, 8), np.nan, np.float32)
    scratch = np.full((cdest.size, 8), np.nan, np.float32)
    for w in range(warp.size - 1):
        k = warp[w + 1] - warp[w]
        lanes = {1: 32, 2: 16, 3: 8, 4: 8}.get(k, 4)
        for c in range(warp[w], warp[w + 1]):
            ids = order[cptr[c]:cptr[c + 1]]
            assert k == 1 or ids.size <= lanes
            s = _lanes(qv[ids]) if k == 1 else _group_tree(qv[ids], lanes)
            if cdest[c] >= 0:
                y[cdest[c]] = s
            else:
                scratch[c] = s
    for first, n in hub:
        acc = scratch[first]
        for i in range(1, n):
            acc = acc + scratch[first + i]
        y[-1 - cdest[first]] = acc
    assert not np.isnan(y).any()                 # every row written
    return y


@pytest.mark.parametrize("nq", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["window", "span"])
def test_tables_walked_as_the_kernel_walks_them_give_the_plain_y(kind, nq):
    part, rbl, base, nw, h, span, rps, *_ = _case(nq, kind)
    tables = _tables(kind, rbl, base, nw, h, span)
    assert tables.hub.shape[0] >= 1
    assert (tables.warp.diff() > 1).any()
    np.testing.assert_array_equal(
        _walk(part, tables, nw * h),
        _call(kind, part, rbl, base, nw, h, span, rps).numpy())


def _chips_plans(name):
    """Chips plans that share one table: ``megarow``'s (one row of 600
    quanta, a hub) or webbase12k's padded split plans on 4 shards."""
    if name == "megarow":
        A = cases.CHIPS_CASES["megarow"]()
        return [chips_tail.plan_chips(A.row_ids().astype(np.int64),
                                      A.ja.astype(np.int64), A.as_, A.m,
                                      A.n)], A.n
    A = synth.webbase_csr(m=12000, seed=5)
    _, h_rows, _, _, cores = distributed.pack_shards(A, 4)
    return distributed._plan_sharded_chips(cores, h_rows, A.n,
                                           split_only=True), A.n


@pytest.mark.parametrize("name", ["megarow", "split-4-shards"])
def test_one_chips_table_walked_as_the_kernel_walks_it(name):
    """The direct landing's one window segment-sum over every stream of
    every plan (``chips_tail.bind_sums``): its tables, walked as the
    kernel walks them, give the plain version's y bit for bit, a hub row
    block included."""
    plans, n = _chips_plans(name)
    calls = []

    def rec(*args):
        calls.append(args)
        return sk.window_segsum_plain(*args)

    sums, _, _ = chips_tail.bind_sums(plans, n, torch.device("cpu"))
    sums(torch.as_tensor(make_x(n), dtype=torch.float32),
         chips_tail.PLAIN._replace(window_segsum=rec))
    (part, rbl, win, nw, h, rps, tables), = calls
    assert tables.hub.shape[0] >= (name == "megarow")
    np.testing.assert_array_equal(
        _walk(part, tables, nw * h),
        sk.window_segsum_plain(part, rbl, win, nw, h, rps).numpy())


def test_warp_groups_share_a_warp_among_small_chunks():
    size = torch.tensor([0, 1, 4, 3, 0, 0, 2, 1,      # 8 of <= 4: one warp
                         5, 8, 0, 7, 17, 1, 2, 3,     # 4 of <= 8, 1+1, 2
                         40, 0, 16, 16, 9, 9])        # 1, 1, 2, then 2
    assert sk.warp_groups(size).tolist() == [0, 8, 12, 13, 14, 16, 17, 18,
                                             20, 22]
    assert sk.warp_groups(torch.zeros(3, dtype=torch.int64)).tolist() == \
        [0, 3]


def test_a_small_chunk_sums_alike_on_its_lanes_and_on_the_warp():
    """The tree over a chunk's 32/k lanes equals the whole warp's: the
    lanes past the chunk hold +0, and every lane starts from +0 (so -0.0
    sums as the warp's tree sums it)."""
    rng = np.random.default_rng(9)
    for lanes in (4, 8, 16):
        for n in range(lanes + 1):
            qv = (rng.standard_normal((n, 8))
                  * 10.0 ** rng.integers(-6, 7, (n, 1))).astype(np.float32)
            qv[:, 0] = -0.0
            got, want = _group_tree(qv, lanes), _lanes(qv)
            assert np.array_equal(got.view(np.int32), want.view(np.int32))

"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Every test here needs an NVIDIA card (marker ``cuda``) and
skips without one. The file imports no JAX and nothing of the JAX
package, so the machine with the card runs it as it is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the lane-ELL kernel rounds each product and sum as its
plain version does, so the core's output must be bit-equal; the whole
call (whose tails add with ``index_add_``, whose atomics add in a
varying order on the card) is held to rel-L2 <= 1e-6 and, per row,
|dy| <= 1e-5 * (|A||x|)_row. The gathers move values without
arithmetic: bit-equal. The segment-sum adds in a fixed order, the order
of its plain version: bit-equal to it on the CPU and on the card. The
stream probe (both entry points) sums
ones, which is exact in f32 in any order: bit-equal. The PELL family:
the tile kernel rounds as its plain version does and the un-permute
moves values, so both are bit-equal to their plain versions on the
card; the fused kernel adds in the fixed order of its plain version on
the CPU (bit-equal) and is within rel-L2 1e-6 of that on the card, and
the span segment-sum is bit-equal to its plain version on both. The row-layout kernels ``pell_rows`` and
``pell_rows_fp64`` add in their plain version's fixed order: bit-equal
to it run on the CPU, at both grades. XPOSE's five kernels move values, take one
f32 product per slot, scan or add rows in the plain versions' order:
bit-equal on the card and against the CPU (the slot-table S1 at the
slots of mid it writes); the two S1 designs' y equal; a whole XPOSE call (on
``s3="prefix"`` virtual rows added by ``index_add_``) within rel-L2 1e-6
of its plain call. Against
``spmv_oracle``: ``validate_result`` defaults. The fp64 grade: the
lane-ELL fp64 kernel rounds each product and sum as its plain version
does (bit-equal); the fp64 fused PELL kernel is bit-equal to its plain
version run on the CPU; a whole fp64 call within rel-L2 1e-12 of its
plain call, and within rel-L2 1e-9 of the oracle with the absolute gate
off. The SpMM kernel adds each row's tiles and lanes in order in f32, as
its plain version does: bit-equal; Y against ``spmm_oracle`` by
``validate_result``. The row-shard core ``lane_ell_sharded`` rounds as
its plain version does: bit-equal at 1, 2 and 4 shards on one card; a
whole row-sharded call, and the chips tail's split streams, as the whole
hybrid call (each kernel call replayed as above). The rows core
``lane_rows`` adds in ``pell_rows``' fixed order: bit-equal to its plain
version run on the CPU, and within rel-L2 1e-6 of it on the card, on
16-bit and 32-bit index blocks, single-card and row-sharded. The
bitmap BCSR kernels ``bcsr_bits`` and ``bcsr_bits_spmm`` add in their
plain versions' fixed order without atomics: bit-equal to them on the
card and run on the CPU, at 1, 3, 8, 64 and 100 columns. The chips
tail's slot products ``chips_products`` round one f32 product a slot as
their plain version does: bit-equal on the card and run on the CPU; y on
``chips_x="slots"`` equals y on ``"hot"``. The direct landing
``heavy_land`` adds one f32 sum into each heavy row as its plain version
does: bit-equal on the card and run on the CPU; its one segment-sum over
every stream of every shard (a split plan at 4 shards of one card) is
held as the segment-sums are, and the call's y within rel-L2 1e-6 of the
merge landing's (the one segment-sum adds a heavy row's streams in
another order). The row-sharded PELL on row
quanta, one ``pell_rows`` launch a call, as the whole hybrid call. The
benchmark runner (``bench/runner.py``) on the card: every row validated
against the oracle (``validate_result`` defaults; fp64 rows at rel-L2
1e-9, the absolute gate off), through the kernels.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import roofline, runner, timing
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.bench.cases import PELL_CASES, SMALL_CASES
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import (bcsr_bits, chips_slots, ext_gather,
                                     lane_ell, lane_ell_fp64, lane_rows,
                                     pell, pell_rows, segsum_kernel, spmm,
                                     xpose)
from spmv_scpa_tpu_torch.parallel import distributed
from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle, spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

KERNEL_VS_PLAIN_REL_L2 = 1e-6
KERNEL_VS_PLAIN_ROW = 1e-5
FP64_VS_PLAIN_REL_L2 = 1e-12
FP64_VS_ORACLE_REL_L2 = 1e-9

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no "
                    "interpret mode")
    return torch.device("cuda")


def _launches():
    return (lane_ell.KERNEL_LAUNCHES, dict(ext_gather.LAUNCHES),
            segsum_kernel.KERNEL_LAUNCHES)


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_lane_ell_kernel_matches_plain(card, name):
    make, kw = SMALL_CASES[name]
    A = make()
    x = make_x(A.n)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device=card,
                                            core_layout="lanes", **kw)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = lane_ell.KERNEL_LAUNCHES
    yk = to_numpy(prep.fn(xd))
    assert lane_ell.KERNEL_LAUNCHES == before + 1
    yt = to_numpy(prep.plain(xd))
    assert np.linalg.norm(yk - yt) <= \
        KERNEL_VS_PLAIN_REL_L2 * np.linalg.norm(yt)
    absA = CSR(A.name, A.m, A.n, A.irp, A.ja, np.abs(A.as_))
    assert np.all(np.abs(yk - yt)
                  <= KERNEL_VS_PLAIN_ROW * spmv_oracle(absA, np.abs(x)))
    validate_result(spmv_oracle(A, x), yk, what=f"cuda-hybrid on {name}")
    args = prep.kernel_inputs(xd)
    assert torch.equal(lane_ell.lane_ell_spmv(*args),
                       lane_ell.lane_ell_spmv_plain(*args))


def test_small_cases_launch_every_hybrid_kernel(card):
    """Between them the small cases drive the ext route (both stage-2
    forms, on the lanes core) and the chips tail through their
    kernels."""
    before = _launches()
    for name in ("amazon60k", "ext-windowed40k"):
        make, kw = SMALL_CASES[name]
        A = make()
        prep = lane_ell.prepare_lane_ell_hybrid(A, device=card,
                                                core_layout="lanes", **kw)
        prep.fn(make_x(A.n))
    after = _launches()
    assert after[0] >= before[0] + 2
    for k in ext_gather.LAUNCHES:
        assert after[1][k] > before[1][k], k
    assert after[2] > before[2]


def _tables(rng, rows, P, card):
    """(rows, 128) int32 p and l with every kind of out-of-range entry:
    p = -1, p = P, a lane of -1 and a lane of 128."""
    p = rng.integers(0, P, (rows, BC)).astype(np.int32)
    l = rng.integers(0, BC, (rows, BC)).astype(np.int32)
    p[0, :4] = (-1, P, 0, 0)
    l[0, 2:4] = (-1, BC)
    return (torch.as_tensor(p, device=card), torch.as_tensor(l, device=card))


def _check_gather(fn, plain, args, what):
    before = ext_gather.LAUNCHES[what]
    out = fn(*args)
    assert ext_gather.LAUNCHES[what] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, plain(*args))
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert torch.equal(out.cpu(), plain(*cpu))
    assert bool((out[0, :4] == 0).all())       # out of range -> 0.0
    return out


def test_sorted_gather_matches_plain(card):
    rng = np.random.default_rng(0)
    R, n_groups, n1p = 8, 3, 4
    x1 = torch.as_tensor(rng.standard_normal((n1p * R, BC)),
                         dtype=torch.float32, device=card)
    base = torch.as_tensor([0, 3, 2], dtype=torch.int32, device=card)
    p1, l1 = _tables(rng, n_groups * 8, R, card)
    _check_gather(ext_gather.sorted_gather, ext_gather.sorted_gather_plain,
                  (base, x1, p1, l1, R), "sorted_gather")


def test_ranked_gather_matches_plain(card):
    rng = np.random.default_rng(1)
    H, G = 40, 24
    hot = torch.as_tensor(rng.standard_normal((H, BC)), dtype=torch.float32,
                          device=card)
    p2, l2 = _tables(rng, G, H, card)
    _check_gather(ext_gather.ranked_gather, ext_gather.ranked_gather_plain,
                  (hot, p2, l2), "ranked_gather")


def test_window_gather_matches_plain(card):
    rng = np.random.default_rng(2)
    G, R_h, H_pad = 32, 16, 64
    hot = torch.as_tensor(rng.standard_normal((H_pad, BC)),
                          dtype=torch.float32, device=card)
    b8 = rng.integers(0, (H_pad - R_h) // 8 + 1, G).astype(np.int32)
    b8[-1] = H_pad // 8        # a window past the end of hot reads 0
    base8 = torch.as_tensor(b8, device=card)
    p, l = _tables(rng, G, R_h, card)
    out = _check_gather(ext_gather.window_gather,
                        ext_gather.window_gather_plain,
                        (base8, hot, p, l, R_h), "window_gather")
    assert bool((out[-1] == 0).all())


def test_window_segsum_matches_plain(card):
    """Three windows, the middle one unvisited; padding and unsorted
    rbl; steps in window order and out of it; no row block of a second
    chunk (one launch), then row block 7 of both windows a hub of
    several chunks (the hub pass)."""
    rng = np.random.default_rng(3)
    h, rows_per_step, steps = 64, 64, 5
    g = rows_per_step // 8 * BC
    part = torch.as_tensor(rng.standard_normal((steps * rows_per_step, BC)),
                           dtype=torch.float32, device=card)
    rbl_np = rng.integers(0, h + 1, steps * g).astype(np.int32)  # h = pad
    rbl_np[:7] = (h, h, 3, 3, 0, h - 1, 3)
    hub_np = rbl_np.copy()
    hub_np[rng.permutation(steps * g)[:3 * segsum_kernel.CHUNK + 100]] = 7
    for rbl_np, hubs in ((rbl_np, False), (hub_np, True)):
        rbl = torch.as_tensor(rbl_np, device=card)
        for order in ([0, 0, 2, 2, 2], [2, 0, 2, 0, 2]):
            tables = segsum_kernel.window_tables(rbl_np, order, 3, h, card)
            assert (tables.hub.shape[0] > 0) == hubs
            win = torch.as_tensor(order, dtype=torch.int32, device=card)
            args = (part, rbl, win, 3, h, rows_per_step)
            before = segsum_kernel.KERNEL_LAUNCHES
            y = segsum_kernel.window_segsum(*args, tables)
            assert segsum_kernel.KERNEL_LAUNCHES == before + 1
            torch.cuda.synchronize()
            assert y.shape == (3 * h, 8)
            assert bool((y[h:2 * h] == 0).all())
            cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args]
            assert torch.equal(y.cpu(),
                               segsum_kernel.window_segsum_plain(*cpu))
            assert torch.equal(y, segsum_kernel.window_segsum_plain(*args))
    with pytest.raises(ValueError, match="tables"):
        segsum_kernel.window_segsum(*args, None)


# the kernels held bit-equal to their plain versions run on the CPU; the
# fused and row kernels' plain versions use index_add_ (atomics on the
# card), the segment-sums' add in the kernel's order there too
ORDERED = ("pell_fused", "span_segsum", "window_segsum", "pell_fused_fp64",
           "pell_rows", "pell_rows_fp64", "lane_rows")
# every kernel and its plain version, by name
KERNELS = {**lane_ell.KERNELS._asdict(), **lane_ell_fp64.KERNELS._asdict(),
           **pell.FP64_KERNELS._asdict(), **spmm.KERNELS._asdict(),
           **distributed.KERNELS._asdict()}
PLAIN = {**lane_ell.PLAIN._asdict(), **lane_ell_fp64.PLAIN._asdict(),
         **pell.FP64_PLAIN._asdict(), **spmm.PLAIN._asdict(),
         **distributed.PLAIN._asdict()}


def _written(name, args, out):
    """What a call's output holds: the slots of mid that an
    ``xpose_s1_slots`` call's table names (it leaves the others
    unwritten), else all of it."""
    if name != "xpose_s1_slots":
        return out
    pos, _, live = xpose.decode_slots(args[1], args[2], args[5])
    pos = pos[live & (pos >= 0) & (pos < out.numel())]
    return out.reshape(-1)[pos.to(out.device)]


def _fresh(name, args):
    """The arguments of one replay: ``heavy_land`` updates y (its first
    argument) in place, so each replay gets its own copy."""
    return (args[0].clone(), *args[1:]) if name == "heavy_land" else args


def _replay(name, args):
    """One recorded kernel call against its plain versions."""
    out = _written(name, args, KERNELS[name](*_fresh(name, args)))
    torch.cuda.synchronize()
    plain = _written(name, args, PLAIN[name](*_fresh(name, args)))
    if name in ORDERED:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else
               tuple(t.cpu() for t in a) if isinstance(a, tuple) else a
               for a in args]
        assert torch.equal(out.cpu(), PLAIN[name](*cpu))
        assert float((out - plain).norm()) <= \
            KERNEL_VS_PLAIN_REL_L2 * float(plain.norm())
    else:
        assert torch.equal(out, plain), name
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
               for a in _fresh(name, args)]
        if name == "heavy_land":
            assert torch.equal(out.cpu(), PLAIN[name](*cpu))


@pytest.mark.parametrize("name", sorted(PELL_CASES))
def test_pell_case_kernels_match_plain(card, name):
    make, strategy, kw = PELL_CASES[name]
    A = make()
    x = make_x(A.n)
    prep = get_strategy(strategy).prepare(A, device=card, **kw)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = (dict(pell.LAUNCHES), segsum_kernel.SPAN_LAUNCHES,
              segsum_kernel.KERNEL_LAUNCHES, pell_rows.LAUNCHES["pell_rows"],
              bcsr_bits.LAUNCHES["bcsr_bits"])
    yk = to_numpy(prep.fn(xd))
    calls = prep.kernel_calls(xd)
    launched = {**{k: pell.LAUNCHES[k] - before[0][k] for k in pell.LAUNCHES},
                "span_segsum": segsum_kernel.SPAN_LAUNCHES - before[1],
                "window_segsum": segsum_kernel.KERNEL_LAUNCHES - before[2],
                "pell_rows": pell_rows.LAUNCHES["pell_rows"] - before[3],
                "bcsr_bits": bcsr_bits.LAUNCHES["bcsr_bits"] - before[4]}
    assert {k for k, v in launched.items() if v} == {k for k, _ in calls}
    yt = to_numpy(prep.plain(xd))
    assert np.linalg.norm(yk - yt) <= \
        KERNEL_VS_PLAIN_REL_L2 * max(np.linalg.norm(yt), 1e-30)
    validate_result(spmv_oracle(A, x), yk, what=f"{strategy} on {name}")
    for kname, args in calls:
        _replay(kname, args)


@pytest.mark.parametrize("quantum", [1, 2, 4, 8, 16, 32, 128])
@pytest.mark.parametrize("kind", ["int8", "int16", "dense"])
def test_pell_tiles_matches_plain(card, kind, quantum):
    """Every quantum size and index kind, columns past n reading 0."""
    rng = np.random.default_rng(quantum)
    T, n = 40, 1000
    vals = torch.as_tensor(rng.standard_normal((T * 8, BC)),
                           dtype=torch.float32, device=card)
    pw = 4 if kind == "int16" else 1
    idx = None if kind == "dense" else torch.as_tensor(
        rng.integers(0, BC * pw, (T * 8, BC)),
        dtype=torch.int8 if kind == "int8" else torch.int16, device=card)
    pan = torch.as_tensor(rng.integers(0, -(-n // (BC * pw)) + 1, T),
                          dtype=torch.int32, device=card)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=card)
    before = pell.LAUNCHES["pell_tiles"]
    part = pell.pell_tiles(vals, idx, pan, x, quantum, pw)
    assert pell.LAUNCHES["pell_tiles"] == before + 1
    torch.cuda.synchronize()
    assert part.shape == (T * 8, BC // quantum)
    assert torch.equal(part, pell.pell_tiles_plain(vals, idx, pan, x,
                                                   quantum, pw))


def test_pell_fused_takes_a_large_step(card):
    """chunk 256 at quantum 8 (the scattered regime's auto choice): a
    step's partials take 128 KB of shared memory, past the 48 KB a
    block gets unasked."""
    from spmv_scpa_tpu_torch import testing as synth
    A = synth.powerlaw_csr(4000, 4000, seed=5)
    prep = pell.prepare_pell(A, device=card, chunk=256, quantum=8,
                             g_max=4096, layout="tiles")
    assert prep.meta["scheme"] == "fused" and prep.meta["chunk"] == 256
    x = make_x(A.n)
    validate_result(spmv_oracle(A, x), to_numpy(prep.fn(x)),
                    what="cuda-pell chunk 256")
    for kname, args in prep.kernel_calls(
            torch.as_tensor(x, dtype=torch.float32, device=card)):
        _replay(kname, args)


def test_span_segsum_matches_plain(card):
    """Steps straddling windows, in order and out of it; no row block of
    a second chunk, then a hub of several chunks (90% of two steps)."""
    rng = np.random.default_rng(5)
    h, rps, nq, span, num_win = 32, 512, 16, 3, 6
    g = rps // 8 * nq
    for base_np in ([0, 0, 1, 3, 3, 4], [3, 0, 1, 4, 0, 3]):
        base_np = np.asarray(base_np, np.int32)
        steps = base_np.size
        rbl_np = (base_np[:, None] * h + rng.integers(
            -4, span * h + 4, (steps, g))).astype(np.int32)
        hub_np = rbl_np.copy()
        hub_np[base_np == 3] = np.where(
            rng.random((2, g)) < 0.9, 3 * h + 1, hub_np[base_np == 3])
        part = torch.as_tensor(rng.standard_normal((steps * rps, nq)),
                               dtype=torch.float32, device=card)
        for rbl_np, hubs in ((rbl_np, False), (hub_np, True)):
            tables = segsum_kernel.span_tables(rbl_np, base_np, num_win, h,
                                               span, card)
            assert (tables.hub.shape[0] > 0) == hubs
            args = (part, torch.as_tensor(rbl_np.reshape(-1), device=card),
                    torch.as_tensor(base_np, device=card), num_win, h, span,
                    rps, tables)
            before = segsum_kernel.SPAN_LAUNCHES
            y = segsum_kernel.span_segsum(*args)
            assert segsum_kernel.SPAN_LAUNCHES == before + 1
            assert y.shape == (num_win * h, 8)
            _replay("span_segsum", args)
            assert torch.equal(y, segsum_kernel.span_segsum_plain(*args))


@pytest.mark.parametrize("tiles", [roofline.PROBE_BYTES // 4 // roofline.TILE,
                                   100_003])
@pytest.mark.parametrize("entry, count", [
    ("stream_reduce", "KERNEL_LAUNCHES"),
    ("stream_reduce_strided", "STRIDED_LAUNCHES")])
def test_stream_probe_matches_plain_exactly(card, entry, count, tiles):
    """Both entry points on the probe's 512 MB and on 100,003 tiles, a
    length that is no multiple of a block's span (264 or 528 blocks)."""
    buf = torch.ones(tiles * roofline.TILE, device=card)
    before = getattr(roofline, count)
    out = getattr(roofline, entry)(buf)
    assert getattr(roofline, count) == before + 1
    assert torch.equal(out, roofline.stream_reduce_plain(buf))
    assert bool((out == tiles).all())


def test_stream_bw_and_event_timing(card):
    bw = roofline.measure_stream_bw(card)
    assert 100.0 < bw < 10_000.0
    times = timing.time_cuda(lambda: torch.ones(1 << 20, device=card))
    assert len(times) == 20 and min(times) > 0


def test_time_device_leaves_out_the_host(card):
    """A call whose host side outlasts its kernel: the device-only time
    is the kernel's, below the call's event-pair time."""
    import time as _time
    x = torch.ones(1024, device=card)

    def slow_host():
        _time.sleep(0.002)
        return x + 1

    dev = timing.time_device(slow_host)
    call = timing.time_cuda(slow_host)
    assert len(dev) == 20 and min(dev) > 0
    assert np.median(dev) < 0.5 < np.median(call)


def _check_prepared(prep, A, card, what):
    """A whole call on the card against its plain call and the oracle,
    the launches against the recorded kernel calls, and each kernel call
    replayed against its plain version."""
    x = make_x(A.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = dict(xpose.LAUNCHES)
    yk = to_numpy(prep.fn(xd))
    calls = prep.kernel_calls(xd)
    launched = {k: xpose.LAUNCHES[k] - before[k] for k in xpose.LAUNCHES}
    assert {k for k, v in launched.items() if v} == \
        {k for k, _ in calls if k in xpose.LAUNCHES}
    yt = to_numpy(prep.plain(xd))
    assert np.linalg.norm(yk - yt) <= \
        KERNEL_VS_PLAIN_REL_L2 * max(np.linalg.norm(yt), 1e-30)
    validate_result(spmv_oracle(A, x), yk, what=what)
    for kname, args in calls:
        _replay(kname, args)
    return calls


# the kernels of each (s3, s1) design
XPOSE_CALLS = {("rows", "auto"): ["xpose_s1_slots", "xpose_s3_rows"],
               ("rows", "slab"): ["xpose_mirror", "xpose_s1",
                                  "xpose_s3_rows"],
               ("prefix", "auto"): ["xpose_mirror", "xpose_s1", "xpose_s3"]}


@pytest.mark.parametrize("s3, s1", sorted(XPOSE_CALLS))
@pytest.mark.parametrize("name", sorted(cases.XPOSE_CASES))
def test_xpose_case_kernels_match_plain(card, name, s3, s1):
    A = cases.make(cases.XPOSE_CASES[name])
    prep = get_strategy("cuda-xpose").prepare(A, device=card, s3=s3, s1=s1)
    calls = _check_prepared(prep, A, card, f"cuda-xpose on {name}")
    assert [k for k, _ in calls] == XPOSE_CALLS[s3, s1]
    for kname, args in calls:       # bit-equal to the CPU's plain version
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        assert torch.equal(
            _written(kname, args, getattr(xpose.KERNELS, kname)(*args)).cpu(),
            _written(kname, cpu, getattr(xpose.PLAIN, kname)(*cpu)))


def test_xpose_s1_slots_matches_plain_and_the_slab(card):
    """On every case the slot kernel launches once, equals its plain
    version on the card and on the CPU at every slot it writes, equals
    the slab design's mid (mirror and ``xpose_s1``) there, and the two
    designs' y are equal."""
    for name in sorted(cases.XPOSE_CASES):
        A = cases.make(cases.XPOSE_CASES[name])
        preps = xpose.prepare_xpose_designs(A, ("rows", ("rows", "slab")),
                                            device=card)
        xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card)
        (_, args), = [c for c in preps["rows"].kernel_calls(xd)
                      if c[0] == "xpose_s1_slots"]
        before = xpose.LAUNCHES["xpose_s1_slots"]
        mid = xpose.xpose_s1_slots(*args)
        assert xpose.LAUNCHES["xpose_s1_slots"] == before + 1
        got = _written("xpose_s1_slots", args, mid)
        assert got.numel() == A.nnz
        assert torch.equal(got, _written("xpose_s1_slots", args,
                                         xpose.xpose_s1_slots_plain(*args)))
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        assert torch.equal(got.cpu(), _written(
            "xpose_s1_slots", cpu, xpose.xpose_s1_slots_plain(*cpu)))
        slab = dict(preps["rows", "slab"].kernel_calls(xd))
        xm = xpose.xpose_mirror(*slab["xpose_mirror"])
        s1 = xpose.xpose_s1(xd, xm, *slab["xpose_s1"][2:])
        assert torch.equal(got, _written("xpose_s1_slots", args, s1))
        assert torch.equal(preps["rows"].fn(xd),
                           preps["rows", "slab"].fn(xd))


def test_xpose_s1_slots_reads_zero_out_of_range(card):
    """A random table: steps and source windows past their ranges, codes
    naming columns past x or below 0, zero values, padding and positions
    outside mid; kernel equals plain at every slot written (positions
    unique, as the host builds them), and an inf in x at a column only a
    zero value names stays out of mid."""
    rng = np.random.default_rng(13)
    n, B2, J1, C, chunk = 70_000, 5, 9, 6, 1024
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    x[3] = float("inf")
    head = np.zeros((C, 8), np.int64)
    head[:, 0] = rng.integers(-1, J1 + 1, C)
    head[:, 4:] = rng.integers(-1, 6, (C, 4))
    head[:, 4] = 0
    kc2 = rng.integers(0, 1 << 15, C * chunk)
    kc2[rng.random(kc2.size) < 0.05] = xpose.NO_SLOT
    off = rng.integers(0, 1 << 16, kc2.size)
    off[(np.arange(kc2.size) % chunk) < 4] = 3     # x[3] from window 0
    val = rng.standard_normal(kc2.size).astype(np.float32)
    val[rng.random(val.size) < 0.2] = 0.0
    src = head[np.arange(kc2.size) // chunk, 4 + (off >> 14)]
    val[src * BC * BC + (off & (BC * BC - 1)) == 3] = 0.0
    # one entry a position of mid, as the host builds them
    pos = (((kc2 >> 7) * J1 + head[np.arange(kc2.size) // chunk, 0]) * BC
           + (kc2 & (BC - 1)))
    live = np.flatnonzero(kc2 != xpose.NO_SLOT)
    _, first = np.unique(pos[live], return_index=True)
    dup = np.setdiff1d(live, live[first])
    kc2[dup] = xpose.NO_SLOT
    code = kc2 << 16 | off
    args = (x, torch.as_tensor(head, dtype=torch.int32),
            torch.as_tensor(code.astype(np.uint32).view(np.int32)
                            .reshape(C, chunk)),
            torch.as_tensor(val.reshape(C, chunk)), B2, J1)
    want = xpose.xpose_s1_slots_plain(*args)
    dargs = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    got = _written("xpose_s1_slots", dargs, xpose.xpose_s1_slots(*dargs))
    assert got.numel() > 0
    assert torch.equal(got.cpu(), _written("xpose_s1_slots", args, want))
    assert bool(torch.isfinite(got).all())


def test_xpose_s1_slots_refuses_bad_tables(card):
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    plan = xpose.plan_or_raise(A)
    head, code, val = (torch.as_tensor(a, device=card)
                       for a in xpose.s1_slots_table(plan))
    xd = torch.zeros(A.n, device=card)
    ok = (xd, head, code, val, plan.B2, plan.J1)
    before = xpose.LAUNCHES["xpose_s1_slots"]
    for i, bad, what in ((1, head.long(), "head is"),
                         (2, code.cpu(), "code is on cpu"),
                         (3, val.double(), "val is"),
                         (3, val[:, :-4], "val is"),
                         (2, code[:, :-2].contiguous(), "multiple of 4"),
                         (0, xd.double(), "x is"),
                         (4, 0, "B2=0")):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError, match=what):
            xpose.xpose_s1_slots(*args)
    flat = code.view(-1)[1:1 + (code.numel() - code.shape[1])]
    with pytest.raises(ValueError, match="16-byte aligned"):
        xpose.xpose_s1_slots(xd, head[:-1], flat.view(-1, code.shape[1]),
                             val[:-1], plan.B2, plan.J1)
    assert xpose.LAUNCHES["xpose_s1_slots"] == before


def test_xpose_default_keeps_y_finite_on_the_card(card):
    """x[0] = inf and x[n-1] = NaN at columns A never reads: the default
    design's y is finite and equal to its plain version's."""
    for name in ("rand-1k", "amazon8k", "webbase30k"):
        A0 = cases.make(cases.XPOSE_CASES[name])
        keep = (A0.ja != 0) & (A0.ja != A0.n - 1)
        A = CSR.from_coo(name, A0.m, A0.n, A0.row_ids()[keep], A0.ja[keep],
                         A0.as_[keep])
        x = make_x(A.n)
        x[0], x[-1] = np.inf, np.nan
        xd = torch.as_tensor(x, dtype=torch.float32, device=card)
        prep = get_strategy("cuda-xpose").prepare(A, device=card)
        y = prep.fn(xd)
        assert bool(torch.isfinite(y).all()), name
        assert torch.equal(y, prep.plain(xd))


def test_xpose_s3_rows_matches_plain_on_every_case(card):
    """The row sums bit-equal to their plain version on the card and on
    the CPU, on the six cases' products and tables; among them a plan
    with virtual rows, rows with no slots and rows past one lane's 32."""
    seen = {"virtual": False, "empty": False, "long": False}
    for name in sorted(cases.XPOSE_CASES):
        A = cases.make(cases.XPOSE_CASES[name])
        prep = get_strategy("cuda-xpose").prepare(A, device=card)
        (_, args), = [c for c in prep.kernel_calls(
            torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card))
            if c[0] == "xpose_s3_rows"]
        mid, rowptr, pos = args
        before = xpose.LAUNCHES["xpose_s3_rows"]
        y = xpose.xpose_s3_rows(*args)
        assert xpose.LAUNCHES["xpose_s3_rows"] == before + 1
        assert y.shape == (A.m,)
        assert torch.equal(y, xpose.xpose_s3_rows_plain(*args))
        assert torch.equal(y.cpu(), xpose.xpose_s3_rows_plain(
            *[a.cpu() for a in args]))
        n = (rowptr[1:] - rowptr[:-1]).cpu()
        seen["virtual"] |= prep.meta["virtual_rows"] > 0
        seen["empty"] |= bool((n == 0).any())
        seen["long"] |= bool((n > xpose.SHORT_ROW).any())
    assert all(seen.values()), seen


def test_xpose_s3_rows_reads_zero_out_of_range(card):
    """A table of random pointers (some past the positions, some ends
    below their starts) and positions (some outside mid), rows of up to
    3,000 slots: kernel equals plain, whose rule clamps the pointers and
    reads 0.0 for such a position."""
    rng = np.random.default_rng(11)
    mid = torch.as_tensor(rng.standard_normal((7, 9, BC)),
                          dtype=torch.float32, device=card)
    lens = rng.choice([0, 1, 3, 17, 32, 33, 64, 500, 3000], 2000,
                      p=[.2, .2, .2, .1, .1, .05, .05, .05, .05])
    rowptr = np.r_[0, np.cumsum(lens)]
    S = int(rowptr[-1])
    bad = rng.random(rowptr.size) < 0.01
    rowptr[bad] = rng.integers(-50, S + 5000, int(bad.sum()))
    pos = rng.integers(-100, mid.numel() + 100, S)
    args = (mid, torch.as_tensor(rowptr, dtype=torch.int32, device=card),
            torch.as_tensor(pos, dtype=torch.int32, device=card))
    y = xpose.xpose_s3_rows(*args)
    assert torch.equal(y, xpose.xpose_s3_rows_plain(*args))
    assert torch.equal(y.cpu(), xpose.xpose_s3_rows_plain(
        *[a.cpu() for a in args]))
    assert bool(torch.isfinite(y).all())


def test_xpose_s3_rows_refuses_bad_tables(card):
    mid = torch.zeros((2, 8, BC), device=card)
    rowptr = torch.zeros(11, dtype=torch.int32, device=card)
    pos = torch.zeros(5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="rowptr is"):
        xpose.xpose_s3_rows(mid, rowptr.long(), pos)
    with pytest.raises(ValueError, match="pos is on cpu"):
        xpose.xpose_s3_rows(mid, rowptr, pos.cpu())
    with pytest.raises(ValueError, match="must be 1-D"):
        xpose.xpose_s3_rows(mid, rowptr, pos.view(5, 1))
    with pytest.raises(ValueError, match="must be 1-D"):
        xpose.xpose_s3_rows(mid, rowptr[:0], pos)
    with pytest.raises(ValueError, match="mid is"):
        xpose.xpose_s3_rows(mid.double(), rowptr, pos)


@pytest.mark.parametrize("s3, s1", sorted(XPOSE_CALLS))
@pytest.mark.parametrize("layout, core", [("lanes", "lane_ell_spmv"),
                                          ("rows", "lane_rows")])
def test_xpose_big_tail_and_nearfar_on_the_card(card, layout, core, s3, s1):
    spec, kw = cases.XPOSE_TAIL
    A = cases.make(spec)
    want = XPOSE_CALLS[s3, s1]
    prep = lane_ell.prepare_lane_ell_hybrid(A, device=card,
                                            core_layout=layout,
                                            xpose_s3=s3, xpose_s1=s1, **kw)
    assert prep.meta["tail_kind"] == "compact-cuda-xpose"
    calls = _check_prepared(prep, A, card, "cuda-hybrid with an XPOSE tail")
    assert [k for k, _ in calls][1:1 + len(want)] == want
    A = cases.make(("amazon_csr", dict(m=24000, seed=6)))
    prep = get_strategy("cuda-nearfar").prepare(A, device=card,
                                                core_layout=layout, s3=s3,
                                                s1=s1)
    assert "W" in prep.meta
    calls = _check_prepared(prep, A, card, "cuda-nearfar")
    assert calls[0][0] == core
    assert [k for k, _ in calls][-len(want):] == want


def test_xpose_kernels_read_zero_out_of_range(card):
    """Planes of random bytes (0..255: lanes, rows and steps past their
    ranges) and windows past x: each kernel equals its plain version,
    whose rule is that such an index reads 0.0."""
    rng = np.random.default_rng(7)
    n, nwm, nw0, J1, B2 = 5000, 3, 1, 9, 5

    def u8(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                               device=card)

    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=card)
    msw = torch.as_tensor(rng.integers(-1, 3, nwm * 4), dtype=torch.int32,
                          device=card)
    sel = torch.as_tensor(rng.integers(0, 6, (nwm, BC)), dtype=torch.uint8,
                          device=card)
    mir = (x, msw, sel, u8(nwm, BC))
    xm = xpose.xpose_mirror(*mir)
    assert torch.equal(xm, xpose.xpose_mirror_plain(*mir))
    win = torch.as_tensor(rng.integers(-1, nw0 + nwm + 2, J1),
                          dtype=torch.int32, device=card)
    asv = torch.as_tensor(rng.standard_normal((J1 * BC, BC)),
                          dtype=torch.float32, device=card)
    s1 = (x, xm, win, u8(J1 * BC, BC), asv, u8(J1 * B2, BC),
          u8(J1 * B2, BC), nw0, B2)
    mid = xpose.xpose_s1(*s1)
    assert torch.equal(mid, xpose.xpose_s1_plain(*s1))
    planes = u8(8, B2 * BC, BC)
    y = xpose.xpose_s3(mid, planes, B2 * 64 * BC - 3)
    assert torch.equal(y, xpose.xpose_s3_plain(mid, planes,
                                               B2 * 64 * BC - 3))
    assert bool(torch.isfinite(y).all())


def test_xpose_wrappers_refuse_mixed_devices(card):
    A = cases.make(cases.XPOSE_CASES["rand-1k"])
    plan = xpose.plan_or_raise(A)
    xd = torch.zeros(A.n, device=card)
    msw = torch.as_tensor(plan.msw[:plan.NWm * 4])
    sel = torch.as_tensor(plan.mir_sel[:plan.NWm])
    with pytest.raises(ValueError, match="msw is on cpu"):
        xpose.xpose_mirror(xd, msw, sel.to(card), sel.to(card))
    mid = torch.zeros((plan.B2, plan.J1, BC), device=card)
    with pytest.raises(ValueError, match="planes is on cpu"):
        xpose.xpose_s3(mid, torch.as_tensor(xpose.s3_planes(plan)), plan.m2)


# ---- the fp64 grade and the SpMM ------------------------------------------

FP64_LAUNCHES = {"cuda-hybrid-fp64": lambda: lane_ell_fp64.KERNEL_LAUNCHES,
                 "cuda-pell-fp64":
                 lambda: pell_rows.LAUNCHES["pell_rows_fp64"]}


@pytest.mark.parametrize("name", sorted(cases.FP64_CASES))
def test_fp64_case_kernels_match_plain(card, name):
    make, strategy, kw = cases.FP64_CASES[name]
    A = make()
    x = make_x(A.n)
    prep = get_strategy(strategy).prepare(A, device=card, **kw)
    xd = torch.as_tensor(x, dtype=torch.float64, device=card)
    before = FP64_LAUNCHES[strategy]()
    y = prep.fn(xd)
    assert FP64_LAUNCHES[strategy]() == before + 1
    assert y.dtype == torch.float64 and y.device.type == "cuda"
    yk, yt = to_numpy(y), to_numpy(prep.plain(xd))
    assert np.linalg.norm(yk - yt) <= \
        FP64_VS_PLAIN_REL_L2 * np.linalg.norm(yt)
    validate_result(spmv_oracle(A, x), yk, rtol=FP64_VS_ORACLE_REL_L2,
                    abs_l2=0.0, what=f"{strategy} on {name}")
    for kname, args in prep.kernel_calls(xd):
        _replay(kname, args)


@pytest.mark.parametrize("name", sorted(cases.SPMM_CASES))
def test_spmm_case_kernel_matches_plain(card, name):
    make, kw = cases.SPMM_CASES[name]
    A = make()
    X = make_x(A.n, cols=kw["cols"]).reshape(A.n, kw["cols"])
    prep = spmm.prepare_bcsr_spmm(A, device=card, layout="tiles", **kw)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=card)
    before = spmm.KERNEL_LAUNCHES
    Y = prep.fn(Xd)
    assert spmm.KERNEL_LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert Y.shape == (A.m, kw["cols"]) and Y.dtype == torch.float32
    assert torch.equal(Y, prep.plain(Xd))
    validate_result(spmm_oracle(A, X), to_numpy(Y), what=f"SpMM on {name}")
    (kname, args), = prep.kernel_calls(Xd)
    _replay(kname, args)
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert torch.equal(spmm.bcsr_spmm(*args).cpu(),
                       spmm.bcsr_spmm_plain(*cpu))


def test_new_wrappers_refuse_mixed_devices_and_dtypes(card):
    A = cases.FP64_CASES["fp64-hybrid-stencil2k"][0]()
    prep = get_strategy("cuda-hybrid-fp64").prepare(A, device=card)
    (_, (xpad, vals, idx, cfg)), = prep.kernel_calls(
        torch.zeros(A.n, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="vals is on cpu"):
        lane_ell_fp64.lane_ell_fp64(xpad, vals.cpu(), idx, cfg)
    with pytest.raises(ValueError, match="xpad is torch.float32"):
        lane_ell_fp64.lane_ell_fp64(xpad.float(), vals, idx, cfg)
    B = cases.FP64_CASES["fp64-pell-banded512"][0]()
    prep = get_strategy("cuda-pell-fp64").prepare(B, device=card,
                                                  layout="tiles")
    (_, fused), = prep.kernel_calls(
        torch.zeros(B.n, dtype=torch.float64, device=card))
    vals, idx, pan, x, rbl, base, cfg, lists = fused
    with pytest.raises(ValueError, match="vals"):
        pell.pell_fused_fp64(vals.float(), idx, pan, x, rbl, base, cfg,
                             lists)
    with pytest.raises(ValueError, match="x is on cpu"):
        pell.pell_fused_fp64(vals, idx, pan, x.cpu(), rbl, base, cfg, lists)
    S = cases.SPMM_CASES["spmm-banded200x300"]
    prep = spmm.prepare_bcsr_spmm(S[0](), device=card, layout="tiles",
                                  **S[1])
    (_, (v, p, rp, X, m)), = prep.kernel_calls(
        torch.zeros((300, 8), device=card))
    with pytest.raises(ValueError, match="X is on cpu"):
        spmm.bcsr_spmm(v, p, rp, X.cpu(), m)
    with pytest.raises(ValueError, match="X is torch.float64"):
        spmm.bcsr_spmm(v, p, rp, X.double(), m)


def test_pell_fused_fp64_refuses_a_step_past_shared_memory(card):
    """chunk 256 at quantum 8: a step's float64 partials take 256 KB,
    past the 227 KB of a block. The plan refuses it, and the wrapper,
    given the f32 kernel's step of 128 KB in float64, raises and
    launches nothing."""
    A = synth.webbase_csr(6000, seed=7)
    with pytest.raises(ValueError, match="shared memory"):
        pell.prepare_pell_fp64(A, device=card, chunk=256, quantum=8,
                               layout="tiles")
    prep = pell.prepare_pell(A, device=card, chunk=256, quantum=8,
                             scheme="fused", row_sort=False, panel_w=1,
                             layout="tiles")
    (name, args), = prep.kernel_calls(
        torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card))
    assert name == "pell_fused" and args[6].chunk == 256
    vals, idx, pan, x, rbl, base, cfg, lists = args
    before = pell.LAUNCHES["pell_fused_fp64"]
    with pytest.raises(ValueError, match="shared memory"):
        pell.pell_fused_fp64(vals.double(), idx, pan, x.double(), rbl, base,
                             cfg, lists)
    assert pell.LAUNCHES["pell_fused_fp64"] == before


# ---- PELL over row quanta ---------------------------------------------------

def _carry_matrix():
    """Rows that cross 2048-slot blocks: a row over four blocks at Q=2,
    empty first, middle and last rows, a run of one-entry rows across a
    boundary."""
    rng = np.random.default_rng(17)
    lens = np.array([0, 3, 7000, 0, 1, 1, 1, 2500, 0, 0, 40, 1, 0] * 3
                    + [900, 0])
    rows = np.repeat(np.arange(lens.size), lens)
    cols = rng.integers(0, 5000, rows.size)
    return CSR.from_coo("carry", lens.size, 5000, rows, cols,
                        rng.standard_normal(rows.size))


ROWS_MATRICES = {
    "powerlaw4000": lambda: synth.powerlaw_csr(4000, 4000, seed=5),
    "webbase20k": lambda: synth.webbase_csr(20000, seed=5),
    "carry": _carry_matrix,
    "empty": lambda: CSR.from_coo("empty", 7, 9, [], [], []),
}


@pytest.mark.parametrize("quantum", [None, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(ROWS_MATRICES))
def test_pell_rows_matches_plain_on_the_cpu(card, name, dtype, quantum):
    """Both grades, every quantum (None: the host rule): the kernel
    equals its plain version run on the CPU bit for bit, launching once
    a call."""
    A = ROWS_MATRICES[name]()
    plan = pell_rows.plan_pell_rows(A, dtype, quantum)
    args = [torch.as_tensor(a) for a in (plan.vals, plan.cols, plan.qptr,
                                          plan.blk_lo)]
    args.append(torch.as_tensor(make_x(A.n), dtype=dtype))
    what = "pell_rows" if dtype == torch.float32 else "pell_rows_fp64"
    before = pell_rows.LAUNCHES[what]
    y = getattr(pell_rows, what)(*[a.to(card) for a in args])
    torch.cuda.synchronize()
    assert pell_rows.LAUNCHES[what] == before + 1
    assert y.shape == (A.m,) and y.dtype == dtype
    assert torch.equal(y.cpu(), pell_rows.pell_rows_plain(*args))


def test_pell_rows_wrappers_refuse_bad_arguments(card):
    A = synth.powerlaw_csr(2000, 2000, seed=3)
    plan = pell_rows.plan_pell_rows(A)
    vals, cols, qptr, blk_lo = (torch.as_tensor(a, device=card) for a in (
        plan.vals, plan.cols, plan.qptr, plan.blk_lo))
    x = torch.zeros(A.n, device=card)
    fn = pell_rows.pell_rows
    before = dict(pell_rows.LAUNCHES)
    for bad, what in (((vals.double(), cols, qptr, blk_lo, x), "vals"),
                      ((vals, cols.long(), qptr, blk_lo, x), "cols"),
                      ((vals, cols, qptr, blk_lo[:-1], x), "blk_lo"),
                      ((vals, cols, qptr, blk_lo, x.cpu()), "x is on cpu"),
                      ((vals, cols, qptr.cpu(), blk_lo, x), "qptr is on cpu"),
                      ((vals, cols, qptr, blk_lo, x.double()), "x is torch")):
        with pytest.raises(ValueError, match=what):
            fn(*bad)
    with pytest.raises(ValueError, match="vals"):
        pell_rows.pell_rows_fp64(vals, cols, qptr, blk_lo, x.double())
    assert pell_rows.LAUNCHES == before


# ---- row shards and the split chips plan ------------------------------------

def _dist_check(prep, A, card):
    """A row-sharded call against its plain call and the oracle, one
    ``lane_ell_sharded`` launch per call, each kernel call replayed."""
    x = make_x(A.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = lane_ell.SHARDED_LAUNCHES
    yk = to_numpy(prep.fn(xd))
    calls = prep.kernel_calls(xd)
    n_core = sum(k == "lane_ell_sharded" for k, _ in calls)
    assert lane_ell.SHARDED_LAUNCHES - before == n_core
    yt = to_numpy(prep.plain(xd))
    assert np.linalg.norm(yk - yt) <= \
        KERNEL_VS_PLAIN_REL_L2 * max(np.linalg.norm(yt), 1e-30)
    validate_result(spmv_oracle(A, x), yk, what=f"row shards, {A.name}")
    for kname, args in calls:
        _replay(kname, args)
    return calls


# matrix, knobs: the sharded core with ext panels on and off and idx8 on
# and off (tests/test_distributed.py's matrices)
SHARD_CORE_CASES = {
    "banded1200": (lambda: synth.banded_csr(1200, row_nnz=11,
                                                  bandwidth=90, seed=21), {}),
    "banded6000-idx8": (lambda: synth.banded_csr(
        6000, row_nnz=12, bandwidth=100, seed=2), {"idx8": True}),
    "amazon40k-ext": (lambda: synth.amazon_csr(40_000, seed=11), {}),
    "amazon40k-ext-idx8": (lambda: synth.amazon_csr(40_000, seed=11),
                           {"idx8": True}),
}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHARD_CORE_CASES))
def test_lane_ell_sharded_matches_plain(card, name, k):
    make, kw = SHARD_CORE_CASES[name]
    A = make()
    prep = distributed.prepare_row_sharded_hybrid(
        A, mesh=[card] * k, core_layout="lanes", **kw)
    assert prep.meta["ext"] == ("ext" in name)
    assert (prep.meta["idx8_planes"] > 0) == ("idx8" in name)
    calls = _dist_check(prep, A, card)
    core = [a for n, a in calls if n == "lane_ell_sharded"]
    assert len(core) == 1 and core[0][2].shape[0] == k


@pytest.mark.parametrize("layout", ["lanes", "rows"])
@pytest.mark.parametrize("name", sorted(cases.DIST_CASES))
def test_dryrun_routes_on_one_card(card, name, layout):
    prep_fn, make, kw = cases.DIST_CASES[name]
    A = make(4)
    if prep_fn == "prepare_row_sharded_hybrid":
        kw = {**kw, "core_layout": layout}
    prep = getattr(distributed, prep_fn)(A, mesh=[card] * 4, **kw)
    _dist_check(prep, A, card)


def test_sharded_pell_row_sort_on_one_card(card):
    A = synth.powerlaw_csr(1200, 1200, seed=21)
    prep = distributed.prepare_row_sharded_pell(A, mesh=[card] * 4,
                                                layout="tiles")
    assert prep.meta["row_sort"]
    calls = _dist_check(prep, A, card)
    assert {k for k, _ in calls} == {"pell_fused", "unpermute"}


def test_lane_ell_sharded_refuses_bad_arguments(card):
    A = synth.amazon_csr(40_000, seed=11)
    prep = distributed.prepare_row_sharded_hybrid(A, mesh=[card] * 2,
                                                  core_layout="lanes")
    calls = prep.kernel_calls(torch.zeros(A.n, device=card))
    (xpad, r0, vals, idx8, idx16, tabs, ext, cfg), = [
        a for n, a in calls if n == "lane_ell_sharded"]
    fn = lane_ell.lane_ell_sharded
    before = lane_ell.SHARDED_LAUNCHES
    with pytest.raises(ValueError, match="r0 is on cpu"):
        fn(xpad, r0.cpu(), vals, idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="r0 is torch.int64"):
        fn(xpad, r0.long(), vals, idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="vals is torch.float64"):
        fn(xpad, r0, vals.double(), idx8, idx16, tabs, ext, cfg)
    with pytest.raises(ValueError, match="ext is torch.float32"):
        fn(xpad, r0, vals, idx8, idx16, tabs, ext[:, :-1].contiguous(), cfg)
    with pytest.raises(ValueError, match="xpad"):
        fn(xpad[:8], r0, vals, idx8, idx16, tabs, ext, cfg)
    assert lane_ell.SHARDED_LAUNCHES == before


def test_split_streams_match_plain(card):
    """The split plan's streams on the card: heavy_scatter through
    cuda-hybrid (direct-x local stream and a far resident one), and a
    whole webbase stand-in through cuda-chips (split)."""
    A = cases.heavy_scatter()
    B = synth.webbase_csr(m=30000)
    ys = {}
    for chips_x, kernel in (("hot", "window_gather"),
                            ("slots", "chips_products")):
        prep = lane_ell.prepare_lane_ell_hybrid(A, device=card,
                                                chips_x=chips_x)
        assert prep.meta["tail_meta"]["split"]
        chips = get_strategy("cuda-chips").prepare(B, device=card,
                                                   chips_x=chips_x)
        assert chips.meta["split"]
        for M, p in ((A, prep), (B, chips)):
            x = make_x(M.n)
            xd = torch.as_tensor(x, dtype=torch.float32, device=card)
            yk = p.fn(xd)
            ys.setdefault(M.name, []).append(yk)
            yk = to_numpy(yk)
            yt = to_numpy(p.plain(xd))
            assert np.linalg.norm(yk - yt) <= \
                KERNEL_VS_PLAIN_REL_L2 * np.linalg.norm(yt)
            validate_result(spmv_oracle(M, x), yk,
                            what=f"split on {M.name}, {chips_x}")
            calls = p.kernel_calls(xd)
            assert {kernel, "window_segsum"} <= {k for k, _ in calls}
            for kname, args in calls:
                _replay(kname, args)
    for name, (hot, slots) in ys.items():
        assert torch.equal(hot, slots), name


# ---- the chips tail's slot products and the row-sharded PELL on rows ------

def _products_case(card):
    """A table of 64 chip rows over x of 5,000: columns in x, -1 (reads
    nothing) and past x (reads nothing), explicit 0.0 values; x is inf
    and NaN at columns no slot names."""
    rng = np.random.default_rng(4)
    n = 5000
    cols = rng.integers(0, n - 2, (64, BC)).astype(np.int32)
    cols[rng.random(cols.shape) < 0.2] = -1
    cols[0, :3] = (n, n + 7, -1)
    vals = rng.standard_normal(cols.shape).astype(np.float32)
    vals[1, :5] = 0.0
    x = rng.standard_normal(n).astype(np.float32)
    x[n - 2], x[n - 1] = np.inf, np.nan
    return tuple(torch.as_tensor(a, device=card) for a in (cols, vals, x))


def test_chips_products_matches_plain(card):
    """Bit-equal to its plain version on the card and run on the CPU,
    +0.0 at every slot whose column lies outside x, finite where x is
    non-finite only at columns no slot names; one launch a call."""
    from spmv_scpa_tpu_torch.ops import chips_slots
    cols, vals, x = _products_case(card)
    before = chips_slots.LAUNCHES["chips_products"]
    out = chips_slots.chips_products(cols, vals, x)
    torch.cuda.synchronize()
    assert chips_slots.LAUNCHES["chips_products"] == before + 1
    plain = chips_slots.chips_products_plain(cols, vals, x)
    assert torch.equal(out, plain)
    assert torch.equal(out.cpu(), chips_slots.chips_products_plain(
        cols.cpu(), vals.cpu(), x.cpu()))
    assert bool(torch.isfinite(out).all())
    off = (cols < 0) | (cols >= x.numel())
    assert bool((out[off] == 0).all()) and not bool(out[off].signbit().any())
    ok = ~off
    want = vals[ok] * x[cols[ok].long()]
    assert torch.equal(out[ok], want)


def test_chips_products_refuses_bad_arguments(card):
    from spmv_scpa_tpu_torch.ops import chips_slots
    cols, vals, x = _products_case(card)
    fn = chips_slots.chips_products
    before = dict(chips_slots.LAUNCHES)
    for bad, what in (((cols.long(), vals, x), "cols"),
                      ((cols, vals.double(), x), "vals"),
                      ((cols, vals, x.cpu()), "x is on cpu"),
                      ((cols, vals, x.double()), "x is"),
                      ((cols.view(-1)[1:1 + 63 * BC].view(63, BC),
                        vals[1:].contiguous(), x), "16-byte")):
        with pytest.raises(ValueError, match=what):
            fn(*bad)
    assert chips_slots.LAUNCHES == before


def test_sharded_chips_launch_once_per_card(card):
    """amazon40k at 4 shards of one card: the shards' chips tails share
    one ``chips_products`` launch a call, and y equals the two gather
    stages' (``chips_x="hot"``)."""
    from spmv_scpa_tpu_torch.ops import chips_slots
    A = synth.amazon_csr(40_000, seed=11)
    slots = distributed.prepare_row_sharded_hybrid(A, mesh=[card] * 4)
    hot = distributed.prepare_row_sharded_hybrid(A, mesh=[card] * 4,
                                                 chips_x="hot")
    assert slots.meta["tail_kind"] == "chips"
    calls = _dist_check(slots, A, card)
    assert [k for k, _ in calls].count("chips_products") == 1
    assert "sorted_gather" not in {k for k, _ in calls}
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card)
    before = chips_slots.LAUNCHES["chips_products"]
    y = slots.fn(xd)
    assert chips_slots.LAUNCHES["chips_products"] == before + 1
    assert torch.equal(y, hot.fn(xd))


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_pell_rows_on_one_card(card, k):
    """The row-sharded PELL on row quanta: one ``pell_rows`` launch a
    call for the card's k shards, against its plain call and the
    oracle."""
    A = synth.powerlaw_csr(6000, 6000, seed=21)
    prep = distributed.prepare_row_sharded_pell(A, mesh=[card] * k)
    assert prep.meta["layout"] == "rows"
    calls = _dist_check(prep, A, card)
    assert [n for n, _ in calls] == ["pell_rows"]
    before = pell_rows.LAUNCHES["pell_rows"]
    prep.fn(torch.zeros(A.n, device=card))
    assert pell_rows.LAUNCHES["pell_rows"] == before + 1


# ---- the lane-ELL core in row quanta ----------------------------------------

def _mixed_matrix(seed=3):
    """Near-diagonal rows (16-bit index blocks), then rows of columns
    spread over 300,000 (32-bit blocks), long rows crossing blocks in
    both, empty rows."""
    rng = np.random.default_rng(seed)
    n = 300_000
    lens = np.concatenate([rng.integers(0, 12, 800), [3000, 0, 5],
                           rng.integers(0, 12, 800), [2600], [0] * 3])
    rows = np.repeat(np.arange(lens.size), lens)
    near = (rows * 37 + rng.integers(0, 900, rows.size)) % n
    cols = np.where(rows < 803, near, rng.integers(0, n, rows.size))
    return CSR.from_coo("mixed", lens.size, n, rows, cols,
                        rng.standard_normal(rows.size))


def _core_tables(A, quantum=None):
    plan = lane_rows.plan_core(A.m, A.n, A.row_ids(), A.ja,
                               A.as_.astype(np.float32), quantum)
    return plan, lane_rows.bind(plan, "cpu")


@pytest.mark.parametrize("quantum", [None, 2, 4, 8, 16])
def test_lane_rows_matches_plain_on_both_index_widths(card, quantum):
    """Blocks of 16-bit offsets and of int32 columns in one core: the
    kernel equals its plain version run on the CPU bit for bit, once a
    call; a matrix with no entries writes zeros."""
    for A in (_mixed_matrix(), CSR.from_coo("empty", 7, 9, [], [], [])):
        plan, tabs = _core_tables(A, quantum)
        if A.nnz:
            wide = plan.ctab[:, 0] < 0
            assert wide.any() and (~wide).any()
        x = torch.as_tensor(make_x(A.n), dtype=torch.float32)
        before = lane_rows.LAUNCHES["lane_rows"]
        y = lane_rows.lane_rows(*[t.to(card) for t in tabs], x.to(card))
        torch.cuda.synchronize()
        assert lane_rows.LAUNCHES["lane_rows"] == before + 1
        assert y.shape == (A.m,) and y.dtype == torch.float32
        assert torch.equal(y.cpu(), lane_rows.lane_rows_plain(*tabs, x))


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_lane_rows_hybrid_matches_plain(card, name):
    """The small cases on the rows core: the call against its plain call
    and the oracle, one ``lane_rows`` launch, each kernel call
    replayed."""
    make, kw = SMALL_CASES[name]
    A = make()
    prep = lane_ell.prepare_lane_ell_hybrid(A, device=card, **kw)
    before = lane_rows.LAUNCHES["lane_rows"]
    prep.fn(torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card))
    torch.cuda.synchronize()
    assert lane_rows.LAUNCHES["lane_rows"] == before + 1
    calls = _check_prepared(prep, A, card, f"rows core on {name}")
    assert [k for k, _ in calls].count("lane_rows") == 1


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHARD_CORE_CASES))
def test_lane_rows_sharded_matches_plain(card, name, k):
    """A card's shards on the rows core: one ``lane_rows`` launch over
    their padded rows."""
    make, kw = SHARD_CORE_CASES[name]
    A = make()
    prep = distributed.prepare_row_sharded_hybrid(A, mesh=[card] * k, **kw)
    before = lane_rows.LAUNCHES["lane_rows"]
    calls = _dist_check(prep, A, card)
    core = [a for n, a in calls if n == "lane_rows"]
    assert len(core) == 1 and lane_rows.LAUNCHES["lane_rows"] > before
    assert core[0][3].numel() - 1 == k * max(
        int(np.diff(prep.bounds).max()), BC)


def test_lane_rows_refuses_bad_arguments(card):
    plan, tabs = _core_tables(_mixed_matrix())
    vals, idx, ctab, qptr, blk_lo = (t.to(card) for t in tabs)
    x = torch.zeros(plan.n, device=card)
    before = dict(lane_rows.LAUNCHES)
    for bad, what in (((vals, idx, ctab, qptr, blk_lo, x.cpu()),
                       "x is on cpu"),
                      ((vals, idx.cpu(), ctab, qptr, blk_lo, x),
                       "idx is on cpu"),
                      ((vals.double(), idx, ctab, qptr, blk_lo, x), "vals"),
                      ((vals, idx.int(), ctab, qptr, blk_lo, x), "idx"),
                      ((vals, idx, ctab, qptr, blk_lo, x.double()), "x is"),
                      ((vals, idx[:100], ctab, qptr, blk_lo, x), "idx"),
                      ((vals, idx, ctab[:-1], qptr, blk_lo, x), "ctab"),
                      ((vals, idx, ctab, qptr, blk_lo[:-1], x), "blk_lo")):
        with pytest.raises(ValueError, match=what):
            lane_rows.lane_rows(*bad)
    assert lane_rows.LAUNCHES == before


# ---- the bitmap BCSR kernels ---------------------------------------------

def _bits_args(A, card):
    plan = bcsr_bits.plan_bcsr_bits(A)
    return tuple(torch.as_tensor(a, device=card) for a in (
        plan.bits, plan.vals, plan.vptr, plan.pan, plan.rowptr))


@pytest.mark.parametrize("name", sorted(cases.BITS_CASES))
def test_bcsr_bits_matches_plain(card, name):
    A = cases.BITS_CASES[name]()
    args = _bits_args(A, card)
    x = make_x(A.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = dict(bcsr_bits.LAUNCHES)
    y = bcsr_bits.bcsr_bits(*args, xd, A.m)
    assert bcsr_bits.LAUNCHES == {**before,
                                  "bcsr_bits": before["bcsr_bits"] + 1}
    torch.cuda.synchronize()
    assert y.shape == (A.m,)
    assert torch.equal(y, bcsr_bits.bcsr_bits_plain(*args, xd, A.m))
    cpu = [a.cpu() for a in args]
    assert torch.equal(y.cpu(), bcsr_bits.bcsr_bits_plain(*cpu, xd.cpu(),
                                                           A.m))
    validate_result(spmv_oracle(A, x), to_numpy(y), what=f"bcsr_bits {name}")


@pytest.mark.parametrize("cols", [1, 3, 8, 64, 100])
@pytest.mark.parametrize("name", sorted(cases.BITS_CASES))
def test_bcsr_bits_spmm_matches_plain(card, name, cols):
    """Every lane mapping: 1 column a lane (cols 1), groups of 2, 4 and
    32 lanes, and two column groups (100)."""
    A = cases.BITS_CASES[name]()
    args = _bits_args(A, card)
    X = make_x(A.n, cols=cols).reshape(A.n, cols)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=card)
    before = bcsr_bits.LAUNCHES["bcsr_bits_spmm"]
    Y = bcsr_bits.bcsr_bits_spmm(*args, Xd, A.m)
    assert bcsr_bits.LAUNCHES["bcsr_bits_spmm"] == before + 1
    torch.cuda.synchronize()
    assert Y.shape == (A.m, cols)
    assert torch.equal(Y, bcsr_bits.bcsr_bits_spmm_plain(*args, Xd, A.m))
    cpu = [a.cpu() for a in args]
    assert torch.equal(Y.cpu(), bcsr_bits.bcsr_bits_spmm_plain(
        *cpu, Xd.cpu(), A.m))
    validate_result(spmm_oracle(A, X), to_numpy(Y),
                    what=f"bcsr_bits_spmm {name} at {cols} columns")


@pytest.mark.parametrize("strategy, kw", [("cuda-bcsr", {}),
                                          ("cuda-bcsr-spmm", {"cols": 8})])
def test_bcsr_strategies_launch_the_bitmap_kernels(card, strategy, kw):
    """Both BCSR strategies run their bitmap kernel alone by default and
    the dense tiles' kernels on ``layout="tiles"``; an inf in x at a
    column that no stored slot names leaves the bitmap y finite."""
    A = cases.BITS_CASES["bits-dup-zeros"]()
    x, xd, gold = _bcsr_input(A, kw.get("cols"), card)
    for layout, want in (("auto", {"bcsr_bits", "bcsr_bits_spmm"}),
                         ("tiles", {"pell_tiles", "window_segsum",
                                    "bcsr_spmm"})):
        prep = get_strategy(strategy).prepare(A, device=card, layout=layout,
                                              **kw)
        before = _bcsr_launches()
        y = prep.fn(xd)
        after = _bcsr_launches()
        ran = {k for k in after if after[k] > before[k]}
        assert ran and ran <= want
        assert ran == {k for k, _ in prep.kernel_calls(xd)}
        validate_result(gold, to_numpy(y), what=f"{strategy} {layout}")
    free = np.setdiff1d(np.arange(A.n), A.ja)[0]
    x[free] = np.inf
    prep = get_strategy(strategy).prepare(A, device=card, **kw)
    xd = torch.as_tensor(x, dtype=torch.float32, device=card)
    y = prep.fn(xd)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, prep.plain(xd))


def _bcsr_input(A, cols, card):
    x = make_x(A.n) if cols is None else make_x(A.n, cols=cols)
    gold = spmv_oracle(A, x) if cols is None else spmm_oracle(A, x)
    return x, torch.as_tensor(x, dtype=torch.float32, device=card), gold


def _bcsr_launches():
    return {**bcsr_bits.LAUNCHES, "bcsr_spmm": spmm.KERNEL_LAUNCHES,
            "pell_tiles": pell.LAUNCHES["pell_tiles"],
            "window_segsum": segsum_kernel.KERNEL_LAUNCHES}


def test_bcsr_bits_wrappers_refuse_bad_arguments(card):
    A = cases.BITS_CASES["bits-banded200x300"]()
    bits, vals, vptr, pan, rowptr = _bits_args(A, card)
    x = torch.zeros(A.n, device=card)
    X = torch.zeros((A.n, 8), device=card)
    before = dict(bcsr_bits.LAUNCHES)
    for bad, what in (((bits, vals, vptr, pan, rowptr, x.cpu()),
                       "x is on cpu"),
                      ((bits.cpu(), vals, vptr, pan, rowptr, x),
                       "vals is on cuda"),
                      ((bits, vals.double(), vptr, pan, rowptr, x), "vals"),
                      ((bits, vals, vptr, pan, rowptr, x.double()), "x is"),
                      ((bits.view(-1, 8, 2, 2).reshape(-1, 4, 8), vals,
                        vptr, pan, rowptr, x), "bits"),
                      ((bits.view(-1)[1:1 + (bits.shape[0] - 1) * 32]
                        .view(-1, 8, 4), vals, vptr[:-1], pan[:-1], rowptr,
                        x), "aligned")):
        with pytest.raises(ValueError, match=what):
            bcsr_bits.bcsr_bits(*bad, A.m)
    with pytest.raises(ValueError, match="x is on cpu"):
        bcsr_bits.bcsr_bits_spmm(bits, vals, vptr, pan, rowptr, X.cpu(), A.m)
    with pytest.raises(ValueError, match="x is not contiguous"):
        bcsr_bits.bcsr_bits_spmm(bits, vals, vptr, pan, rowptr,
                                 X.t().contiguous().t(), A.m)
    assert bcsr_bits.LAUNCHES == before


def _runner_launches():
    return {**lane_rows.LAUNCHES, **pell_rows.LAUNCHES,
            **chips_slots.LAUNCHES, **bcsr_bits.LAUNCHES,
            "window_segsum": segsum_kernel.KERNEL_LAUNCHES,
            "lane_ell_fp64": lane_ell_fp64.KERNEL_LAUNCHES}


def test_run_benchmarks_on_the_card(card, tmp_path):
    """``run_benchmarks`` on the card with -d, the row shards and the
    SpMM: every row validated, through the kernels."""
    A = synth.amazon_csr(m=6000, seed=30)          # a chips tail
    before = _runner_launches()
    cfg = runner.RunConfig(
        out_dir=str(tmp_path / "r"), debug=True, chunks=(64,),
        strategies=["cuda-hybrid", "cuda-pell", "cuda-bcsr",
                    "cuda-pell-fp64", "torch-csr-segsum"],
        distributed=True, spmm_cols=(8,))
    results = runner.run_benchmarks(A, cfg)
    assert cfg.skipped == []
    assert all(r.rel_err is not None for r in results)
    assert [r.strategy for r in results[2:]] == [
        "cuda-hybrid", "cuda-pell", "cuda-bcsr", "cuda-pell-fp64",
        "torch-csr-segsum", "distributed-rowshard", "distributed-rowshard",
        "cuda-bcsr-spmm", "torch-csr-segsum-spmm"]
    assert results[5].rel_err <= FP64_VS_ORACLE_REL_L2
    dist = [r for r in results if r.strategy == "distributed-rowshard"]
    assert [r.chunk for r in dist] == [torch.cuda.device_count()] * 2
    after = _runner_launches()
    for name in ("lane_rows", "pell_rows", "pell_rows_fp64",
                 "chips_products", "window_segsum", "bcsr_bits",
                 "bcsr_bits_spmm"):
        assert after[name] > before[name], name
    assert all(r.bench.duration_ms > 0 for r in results)


def test_time_device_fn_on_the_card(card):
    A = synth.banded_csr(4096, row_nnz=9, bandwidth=64, seed=1)
    prep = get_strategy("cuda-hybrid").prepare(A, device=card)
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card)
    r = timing.time_device_fn(prep.fn, xd, nnz=A.nnz)
    assert r.duration_ms > 0 and r.reps == 20
    validate_result(spmv_oracle(A, make_x(A.n)), r.data)


# ---- the direct landing -----------------------------------------------------

def _land_case(card):
    """y of 70,000 rows, 6,000 sums of which 5,000 land (each in its own
    row) and 1,000 are padding (-1)."""
    from spmv_scpa_tpu_torch.ops import chips_tail
    rng = np.random.default_rng(8)
    y = rng.standard_normal(70_000).astype(np.float32)
    land = np.full(6000, -1, np.int64)
    land[rng.choice(6000, 5000, replace=False)] = rng.choice(
        y.size, 5000, replace=False)
    ys = rng.standard_normal(6000).astype(np.float32)
    return (torch.as_tensor(y, device=card), torch.as_tensor(ys, device=card),
            chips_tail.bind_land(land, y.size, card))


def test_heavy_land_matches_plain(card):
    """Bit-equal to its plain version on the card and run on the CPU, in
    place, one launch a call; the rows no rank names keep their values;
    a 2-D y (the row shards' (k, W)) is indexed flat."""
    from spmv_scpa_tpu_torch.ops import chips_tail
    y, ys, land = _land_case(card)
    before = chips_tail.LAUNCHES["heavy_land"]
    yk = y.clone()
    out = chips_tail.heavy_land(yk, ys, land)
    torch.cuda.synchronize()
    assert out is yk and chips_tail.LAUNCHES["heavy_land"] == before + 1
    plain = chips_tail.heavy_land_plain(y.clone(), ys, land)
    assert torch.equal(out, plain)
    assert torch.equal(out.cpu(), chips_tail.heavy_land_plain(
        y.cpu().clone(), ys.cpu(), land.cpu()))
    hit = torch.zeros(y.numel(), dtype=torch.bool, device=card)
    hit[land[land >= 0].long()] = True
    assert torch.equal(out[~hit], y[~hit]) and not torch.equal(out[hit],
                                                               y[hit])
    y2 = chips_tail.heavy_land(y.clone().view(7, 10_000), ys, land)
    assert torch.equal(y2.view(-1), out)


def test_heavy_land_refuses_bad_arguments(card):
    from spmv_scpa_tpu_torch.ops import chips_tail
    y, ys, land = _land_case(card)
    before = chips_tail.LAUNCHES["heavy_land"]
    for bad, what in (((y, ys.cpu(), land), "ys is on cpu"),
                      ((y, ys, land.cpu()), "land is on cpu"),
                      ((y, ys, land.long()), "land is"),
                      ((y.double(), ys, land), "float32"),
                      ((y, ys[:-1], land), "land is")):
        with pytest.raises(ValueError, match=what):
            chips_tail.heavy_land(*bad)
    assert chips_tail.LAUNCHES["heavy_land"] == before


def test_one_table_segsum_on_four_shards_matches_plain(card):
    """A split chips plan on 4 shards of one card, the direct landing:
    one ``window_segsum`` over every stream of every shard and one
    ``heavy_land`` a call; the segment-sum bit-equal to its plain version
    run on the CPU (and within rel-L2 1e-6 of it on the card), the call
    against its plain call, the oracle and the merge landing's y."""
    from spmv_scpa_tpu_torch.ops import chips_tail
    A = synth.webbase_csr(m=12000, seed=5)
    direct = distributed.prepare_row_sharded_hybrid(
        A, mesh=[card] * 4, tail_kind="chips-split")
    merge = distributed.prepare_row_sharded_hybrid(
        A, mesh=[card] * 4, tail_kind="chips-split", landing="merge")
    assert direct.meta["tail_kind"] == "chips-split"
    calls = _dist_check(direct, A, card)
    names = [k for k, _ in calls]
    assert names.count("window_segsum") == names.count("heavy_land") == 1
    (args,) = [a for k, a in calls if k == "window_segsum"]
    assert args[0].shape[0] == sum(a[0].shape[0] for k, a in
                                   merge.kernel_calls(torch.zeros(
                                       A.n, device=card))
                                   if k == "window_segsum")
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=card)
    before = (segsum_kernel.KERNEL_LAUNCHES,
              chips_tail.LAUNCHES["heavy_land"])
    y = direct.fn(xd)
    torch.cuda.synchronize()
    assert (segsum_kernel.KERNEL_LAUNCHES - before[0],
            chips_tail.LAUNCHES["heavy_land"] - before[1]) == (1, 1)
    y_m = merge.fn(xd)
    assert float((y - y_m).norm()) <= \
        KERNEL_VS_PLAIN_REL_L2 * float(y_m.norm())

"""The port's timing, stream probe and roofline
(spmv_scpa_tpu_torch/bench/), and the nvcc build of its kernels
(spmv_scpa_tpu_torch/_kernels.py). On the CPU every device measurement
must refuse rather than make a number up; the probe's plain version is
checked here, its kernel in tests/test_torch_cuda.py."""

import importlib.util
import pathlib
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spmv_scpa_tpu.bench import roofline as jax_roofline

from spmv_scpa_tpu_torch import _kernels, get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import roofline, timing


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this pins the CPU-only refusal")


FAKE_PREP = SimpleNamespace(hbm_bytes=168_523_776, nnz=22_588_601,
                            device=torch.device("cpu"))


@pytest.mark.parametrize("ms", [0.1, 0.35, 2.0])
def test_roofline_matches_reference_arithmetic(ms):
    """Same fraction / fraction_ideal arithmetic as the JAX package's
    roofline, which assumes 50 GB/s off a TPU; here the bandwidth is
    passed explicitly."""
    gf = 2 * FAKE_PREP.nnz / (ms * 1e6)
    want = jax_roofline.roofline(FAKE_PREP, ms, gf, x_bytes=1_508_000,
                                 y_bytes=1_508_000)
    got = roofline.roofline(FAKE_PREP, ms, gf, x_bytes=1_508_000,
                            y_bytes=1_508_000, bw=want.stream_bw_gbs)
    assert vars(got) == pytest.approx(vars(want), rel=1e-12)


def test_roofline_by_hand():
    rep = roofline.roofline(FAKE_PREP, 0.1, 400.0, x_bytes=1000,
                            y_bytes=1000, bw=2000.0)
    t_min = (168_523_776 + 2000) / 2000e9 * 1e3
    assert rep.t_min_ms == pytest.approx(t_min)
    assert rep.fraction == pytest.approx(t_min / 0.1)
    assert rep.fraction_ideal == pytest.approx(
        (22_588_601 * 6 + 2000) / 2000e9 * 1e3 / 0.1)
    assert rep.gflops_at_roofline == pytest.approx(400.0 / rep.fraction)


def test_roofline_measures_on_the_card_or_refuses(no_card):
    with pytest.raises(RuntimeError, match="on the card"):
        roofline.roofline(FAKE_PREP, 0.1, 400.0)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_measure_stream_bw_refuses_without_card(no_card, device):
    with pytest.raises(RuntimeError):
        roofline.measure_stream_bw(device)


def test_time_cuda_refuses_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.time_cuda(lambda: None)


def test_time_cuda_takes_at_least_ten_reps():
    with pytest.raises(ValueError, match="reps"):
        timing.time_cuda(lambda: None, reps=5)


def test_time_device_refuses_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.time_device(lambda: None)


def test_time_device_takes_at_least_ten_reps():
    with pytest.raises(ValueError, match="reps"):
        timing.time_device(lambda: None, reps=5)


def test_time_prepared_refuses_a_cpu_strategy():
    A = synth.banded_csr(512, row_nnz=12, bandwidth=96, seed=7)
    prep = get_strategy("torch-csr-segsum").prepare(A, device="cpu")
    with pytest.raises(RuntimeError, match="on the card"):
        timing.time_prepared(prep, np.ones(A.n))


def test_stream_reduce_plain_on_cpu():
    buf = torch.ones(64 * roofline.TILE)
    before = roofline.KERNEL_LAUNCHES
    out = roofline.stream_reduce(buf)
    assert roofline.KERNEL_LAUNCHES == before
    assert out.shape == (8, 128)
    assert torch.equal(out, torch.full((8, 128), 64.0))
    rng = np.random.default_rng(0)
    buf = torch.as_tensor(rng.standard_normal(5 * roofline.TILE),
                          dtype=torch.float32)
    np.testing.assert_allclose(
        roofline.stream_reduce_plain(buf).numpy(),
        buf.numpy().reshape(5, 8, 128).sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", [
    torch.ones(1000), torch.ones(2048, dtype=torch.float64),
    torch.ones(2, 1024)])
def test_stream_reduce_rejects_bad_buffers(bad):
    with pytest.raises(ValueError, match="stream_reduce"):
        roofline.stream_reduce(bad)


def test_probe_buffer_dwarfs_the_l2():
    assert roofline.PROBE_BYTES >= 512 << 20
    assert roofline.PROBE_BYTES % (4 * roofline.TILE) == 0


# ---- the nvcc build --------------------------------------------------------

def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_build_raises_without_nvcc(build_dir, monkeypatch):
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("lane_ell")


def test_build_reports_nvcc_stderr(build_dir, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no sm_90a here' >&2\nexit 3\n")
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: nvcc)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _kernels.build("stream_probe")
    assert not any(build_dir.iterdir())        # no half-built library


def test_build_is_keyed_by_source_and_reused(build_dir, tmp_path,
                                             monkeypatch):
    # the fake nvcc writes a file at its -o path
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"\n')
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: nvcc)
    paths = _kernels.build_all()
    assert [p.parent for p in paths] == [build_dir] * len(_kernels.SIGNATURES)
    assert sorted(p.name for p in build_dir.iterdir()) == \
        sorted(p.name for p in paths)             # no temporaries left
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: None)
    assert _kernels.build("lane_ell") == paths[0]  # reused, no nvcc
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "lane_ell.cu").write_text("// edited\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", src)
    assert _kernels.library_path("lane_ell") != paths[0]


def test_nvcc_flags_target_sm90a():
    flags = " ".join(_kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert set(_kernels.SIGNATURES) == {
        p.stem for p in _kernels.CSRC_DIR.glob("*.cu")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bound_case(name):
    """One small call of ``name`` and the bytes its bound must count:
    the gathers' in-range indices name 4 distinct source elements (rows
    0-1, lanes 0-1) and a third of them are out of range; the
    segment-sum has one quantum in five as padding."""
    i32 = torch.int32
    r, j = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    p = torch.as_tensor(np.array([0, 1, 4])[(r + j) % 3], dtype=i32)
    l = torch.as_tensor(j % 2, dtype=i32)
    src = torch.arange(8 * 128, dtype=torch.float32).view(8, 128)
    zero2 = torch.zeros(2, dtype=i32)
    tables = p.numel() * 8 + 16 * 128 * 4        # p, l and the output
    if name == "sorted_gather":
        return (zero2, src, p, l, 4), tables + 8 + 4 * 4
    if name == "ranked_gather":
        return (src[:4].contiguous(), p, l), tables + 4 * 4
    if name == "window_gather":                  # one base per row
        return (torch.zeros(16, dtype=i32), src, p, l, 4), \
            tables + 16 * 4 + 4 * 4
    part = torch.ones(16, 128)
    rbl = torch.as_tensor(np.arange(256) % 5, dtype=i32)     # 4 = padding
    live = int((rbl < 4).sum())
    return ((part, rbl, zero2, 1, 4, 8),
            256 * 4 + 2 * 4 + live * 8 * 4 + 4 * 8 * 4)


@pytest.mark.parametrize("name", ["sorted_gather", "ranked_gather",
                                  "window_gather", "window_segsum"])
def test_chip_smoke_bound_counts_what_the_data_reads(name):
    """A gather's bound charges its index tables, its output and the
    distinct in-range source elements, never the whole source; the
    segment-sum's only the partials of quanta that are not padding. A
    gather's library yardstick returns what the gather does."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.ops import lane_ell
    args, nbytes = _bound_case(name)
    out = getattr(lane_ell.PLAIN, name)(*args)
    ms, by = cs.bound(name, args, out)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    if name != "window_segsum":
        lib = cs.gather_library(name, args)()
        assert torch.equal(lib.view_as(out), out)


def test_build_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A library's name covers the headers its source includes: an
    edited csrc/*.cuh builds anew."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "segsum.cu").write_text('#include "segsum_pass.cuh"\n')
    (src / "segsum_pass.cuh").write_text("// one\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", src)
    first = _kernels.library_path("segsum")
    (src / "segsum_pass.cuh").write_text("// two\n")
    assert _kernels.library_path("segsum") != first


@pytest.mark.parametrize("name", ["pell-pl3000", "pell-span1500",
                                  "pell-pure1500", "bcsr-banded200"])
def test_chip_smoke_pell_yardsticks_compute_the_kernels_function(name):
    """Each PELL-family kernel's library yardstick computes what the
    kernel does (run here on the plain versions), and its bound is set
    by bytes and counts fewer x elements than the slots name."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.bench.cases import PELL_CASES
    from spmv_scpa_tpu_torch.ops import lane_ell
    from spmv_scpa_tpu_torch.utils.vector import make_x
    make, strategy, kw = PELL_CASES[name]
    A = make()
    prep = get_strategy(strategy).prepare(A, device="cpu", **kw)
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    for kname, args in prep.kernel_calls(xd):
        out = getattr(lane_ell.PLAIN, kname)(*args)
        ms, by = cs.bound(kname, args, out)
        assert by == "bytes" and ms > 0
        lib = cs.library(kname, args, None, xd)
        got = lib().to_dense() if lib().is_sparse else lib()
        got = got.reshape(-1)[:out.numel()].view_as(out)
        if kname == "unpermute":
            assert torch.equal(got, out)
        else:
            torch.testing.assert_close(got, out, rtol=1e-5, atol=1e-5)


def test_chip_smoke_fused_yardstick_on_the_tile_layout():
    """The fused kernel's yardstick (``pell-pl3000`` on the tile layout,
    the row-sorted fused scheme) computes what the kernel does, and its
    bound is set by bytes; the row layout's format-free bound of the same
    matrix is below its format bound."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.bench.cases import PELL_CASES
    from spmv_scpa_tpu_torch.ops import pell
    from spmv_scpa_tpu_torch.utils.vector import make_x
    make, strategy, kw = PELL_CASES["pell-pl3000"]
    A = make()
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    tiles = pell.prepare_pell(A, device="cpu", layout="tiles", **kw)
    (kname, args), _ = tiles.kernel_calls(xd)
    assert kname == "pell_fused"
    out = pell.pell_fused_plain(*args)
    ms, by = cs.bound(kname, args, out)
    assert by == "bytes" and ms > 0
    got = cs.library(kname, args, None, xd)()
    torch.testing.assert_close(got.reshape(-1)[:out.numel()].view_as(out),
                               out, rtol=1e-5, atol=1e-5)
    (kname, args), = pell.prepare_pell(A, device="cpu").kernel_calls(xd)
    out = cs.PLAIN[kname](*args)
    assert cs.free_bound_ms(args, out) <= cs.bound(kname, args, out)[0]


@pytest.mark.parametrize("s3", ["rows", "prefix"])
@pytest.mark.parametrize("name", ["webbase30k", "amazon8k"])
def test_chip_smoke_xpose_yardsticks_compute_the_kernels_function(name, s3):
    """Each XPOSE kernel's library yardstick computes what the kernel
    does (run here on the plain versions): the mirror's flat indexing
    and S1's one-entry-per-row CSR product (over x and the mirror windows
    on the slab, over x on the slot table) to f32 rounding, S3's gather
    and index_add_ up to the order of the sums (the prefix kernel
    differences f32 block prefix sums, the row sums add in their own
    order); every bound is set by bytes and counts only the elements the
    data reads. Both S3 designs add the same products into the same
    rows."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.bench import cases
    from spmv_scpa_tpu_torch.ops import xpose
    from spmv_scpa_tpu_torch.utils.vector import make_x
    A = cases.make(cases.XPOSE_CASES[name])
    prep = get_strategy("cuda-xpose").prepare(A, device="cpu", s3=s3)
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    calls = prep.kernel_calls(xd)
    assert [k for k, _ in calls] == list(
        cs.XPOSE_KERNELS if s3 == "rows" else cs.PREFIX_KERNELS)
    for kname, args in calls:
        out = getattr(xpose.PLAIN, kname)(*args)
        ms, by = cs.bound(kname, args, out)
        assert by == "bytes"
        assert 0 < ms <= (cs.tensor_bytes(args) + out.numel() * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        got = cs.library(kname, args, None, xd)().reshape(out.shape)
        if kname in ("xpose_s3", "xpose_s3_rows"):
            assert float((got - out).norm()) <= 1e-5 * float(out.norm())
        else:
            torch.testing.assert_close(got, out, rtol=1e-6, atol=0)
    s1 = dict(calls)
    if s3 == "rows":
        _, col, _, reads = cs.s1_slot_entries(s1["xpose_s1_slots"])
        col = col[reads]
    else:
        _, col, _ = cs.s1_slots(s1["xpose_s1"])
    slots = cs.s3_slots if s3 == "prefix" else cs.s3_rows_slots
    src, dest = slots(calls[-1][1])
    assert col.numel() == src.numel() == dest.numel() == A.nnz
    if s3 == "rows":
        plan = xpose.plan_or_raise(A)
        mid = calls[-1][1][0]
        src0, dest0 = cs.s3_slots((mid, torch.as_tensor(
            xpose.s3_planes(plan)), plan.m2))
        v_row = torch.as_tensor(np.r_[np.arange(plan.m), plan.v_row],
                                dtype=torch.int64)
        assert sorted(zip(dest.tolist(), src.tolist())) == sorted(
            zip(v_row[dest0].tolist(), src0.tolist()))


def test_chip_smoke_bound_counts_the_slot_table():
    """``xpose_s1_slots``' bound charges its table whole, the slots it
    writes (padding writes none) and the distinct x elements that its
    nonzero entries read (a zero value or a column past x reads none):
    seven slots written, columns 5, 9 and 11 read; its operations are the
    five products. Its yardstick computes the kernel's mid."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.ops import xpose
    B2, J1, chunk = 2, 3, 8
    x = torch.arange(1, 301, dtype=torch.float32)
    head = torch.zeros((2, 8), dtype=torch.int32)
    head[1, 0] = 2                       # chunk 1: step 2; all windows 0
    # (k * 128 + c2, x offset, value); the rest of each chunk is padding
    entries = [[(0, 5, 1.0), (1, 5, 2.0), (2, 7, 0.0), (3, 400, 3.0),
                (4, 9, 4.0)],
               [(0, 9, 5.0), (130, 11, 6.0)]]
    code = torch.full((2, chunk), xpose.NO_SLOT << 16, dtype=torch.int64)
    val = torch.zeros((2, chunk))
    for c, chunk_entries in enumerate(entries):
        for i, (kc2, off, v) in enumerate(chunk_entries):
            code[c, i], val[c, i] = kc2 << 16 | off, v
    args = (x, head, code.to(torch.int32), val, B2, J1)
    out = xpose.xpose_s1_slots_plain(*args)
    ms, by = cs.bound("xpose_s1_slots", args, out)
    nbytes = 3 * 2 * chunk * 4 + 7 * 4 + 3 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    pos, col, _, reads = cs.s1_slot_entries(args)
    assert pos.numel() == 7 and int(reads.sum()) == 5
    assert sorted(col[reads].unique().tolist()) == [5, 9, 11]
    assert out.view(-1)[pos].tolist() == [6.0, 12.0, 0.0, 0.0, 40.0, 50.0,
                                          72.0]
    got = cs.library("xpose_s1_slots", args, None, x)().reshape(out.shape)
    assert torch.equal(got, out)


@pytest.mark.parametrize("name", ["fp64-hybrid-stencil2k",
                                  "fp64-pell-powerlaw4k",
                                  "spmm-banded200x300",
                                  "spmm-stencil4k-c64"])
def test_chip_smoke_fp64_and_spmm_yardsticks(name):
    """The fp64 kernels' and the SpMM's yardsticks compute what the
    kernels do (run here on the plain versions): cuSPARSE's fp64 CSR
    product of the whole matrix and of the fused kernel's tiles, and its
    f32 CSR SpMM. Each bound counts f64 operands at 8 bytes and, for the
    SpMM, only the rows of X its tiles read, and its operations only the
    MACs of the tiles' nonzero values: bytes bound it at 64 columns too
    (counting the stored zeros' MACs, as dense tiles do, would flip it
    to operations there)."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.bench import cases
    if name in cases.FP64_CASES:
        make, strategy, kw = cases.FP64_CASES[name]
    else:   # the dense tiles' kernel; the bitmap one's bound is pinned below
        (make, kw), strategy = cases.SPMM_CASES[name], "cuda-bcsr-spmm"
        kw = {**kw, "layout": "tiles"}
    A = make()
    x, xd, gold, vkw, _ = cs.path_input(A, strategy, kw,
                                        torch.device("cpu"))
    assert xd.dtype == (torch.float32 if strategy == "cuda-bcsr-spmm"
                        else torch.float64)
    prep = get_strategy(strategy).prepare(A, device="cpu", **kw)
    (kname, args), = prep.kernel_calls(xd)
    out = cs.PLAIN[kname](*args)
    ms, by = cs.bound(kname, args, out)
    assert by == "bytes"
    assert ms > 0
    got = cs.library(kname, args, A, xd)()
    got = (got.to_dense() if got.is_sparse else got).reshape(-1)
    want = out.reshape(-1)[:got.numel()]
    assert got.dtype == out.dtype
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if kname == "bcsr_spmm":
        vals, pan = args[:2]
        T = vals.shape[0] // 8
        rows = torch.unique((pan[:T].long()[:, None] * 128
                             + torch.arange(128)).clamp(max=A.n - 1))
        nbytes = (vals.numel() * 4 + T * 4 + args[2].numel() * 4
                  + rows.numel() * xd.shape[1] * 4 + out.numel() * 4)
        ops = 2 * A.nnz * xd.shape[1]
        assert ms * 1e-3 == pytest.approx(max(
            nbytes / cs.HBM_BYTES_PER_S, ops / cs.F32_OPS_PER_S), rel=1e-12)
        dense_ops = 2 * vals.numel() * xd.shape[1]
        assert (dense_ops / cs.F32_OPS_PER_S > nbytes / cs.HBM_BYTES_PER_S) \
            == name.endswith("c64")
    from spmv_scpa_tpu_torch.utils.validation import validate_result
    y = out if kname == "bcsr_spmm" else out.reshape(-1)[:A.m]
    validate_result(gold, cs.to_numpy(y), **vkw, what=name)


@pytest.mark.parametrize("name", ["amazon60k", "ext-windowed40k",
                                  "stencil4k-idx8"])
def test_chip_smoke_rows_core_yardstick_and_bound(name):
    """``lane_rows``' yardstick is cuSPARSE of the core's own entries: it
    computes what the kernel does (run here on the plain version); the
    bound is set by bytes and counts the layout's tables, the distinct x
    elements the slots read and y (a 16-bit index can take it below the
    format-free bound, which counts 4-byte columns and all of x);
    ``core_call`` finds each layout's core call."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES
    from spmv_scpa_tpu_torch.ops import lane_ell, lane_rows
    from spmv_scpa_tpu_torch.utils.vector import make_x
    make, kw = SMALL_CASES[name]
    A = make()
    preps = lane_ell.prepare_hybrid_layouts(A, device="cpu", **kw)
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32)
    kname, args = cs.core_call(preps["rows"], xd)
    assert kname == "lane_rows"
    assert cs.core_call(preps["lanes"], xd)[0] == "lane_ell_spmv"
    out = lane_rows.lane_rows_plain(*args)
    ms, by = cs.bound(kname, args, out)
    cols = lane_rows.decode_cols(args[1], args[2], args[0].numel())
    nbytes = (cs.tensor_bytes(args[:5]) + torch.unique(cols).numel() * 4
              + out.numel() * 4)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert cs.free_bound_ms(args, out) > 0
    got = cs.library(kname, args, A, xd)().reshape(-1)
    torch.testing.assert_close(got, out, rtol=1e-5, atol=1e-5)
    assert cs.LINE_ORDER.count("lane_rows") == 1 and len(cs.LINE_ORDER) == 28
    assert cs.LINE_ORDER.count("pell_rows") == 2    # single card, row shards


def _bits_bound_case():
    """16 rows, 300 columns: rows 0 and 1 share column 5, row 3 stores
    column 130, row 9 column 7 twice (one slot) and row 10 column 299:
    5 stored slots in 4 tiles (block row 0: panels 0 and 1; block row 1:
    panels 0 and 2), reading 4 distinct columns."""
    from spmv_scpa_tpu_torch.formats.csr import CSR
    return CSR.from_coo("bits_bound", 16, 300, [0, 1, 3, 9, 9, 10],
                        [5, 5, 130, 7, 7, 299],
                        [1.0, 2.0, 3.0, 4.0, 0.5, 6.0])


@pytest.mark.parametrize("cols", [None, 3])
def test_chip_smoke_bound_counts_the_bitmap_layout(cols):
    """The bitmap kernels' bound charges the masks, the stored values,
    vptr, pan and rowptr whole, x (or X's rows) only at the distinct
    columns the stored slots name, and the output; their operations are
    2 x stored x cols. Their yardstick, cuSPARSE of the matrix the tiles
    hold, computes what the kernels do."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.ops import bcsr_bits
    A = _bits_bound_case()
    plan = bcsr_bits.plan_bcsr_bits(A)
    assert (plan.num_tiles, plan.vals.size) == (4, 5)
    args = tuple(torch.as_tensor(a) for a in (plan.bits, plan.vals,
                                              plan.vptr, plan.pan,
                                              plan.rowptr))
    width = 1 if cols is None else cols
    x = torch.arange(300 * width, dtype=torch.float32).view(
        (300,) if cols is None else (300, cols))
    name = "bcsr_bits" if cols is None else "bcsr_bits_spmm"
    args = args + (x, A.m)
    out = cs.PLAIN[name](*args)
    ms, by = cs.bound(name, args, out)
    nbytes = (4 * 8 * 4 * 4 + 5 * 4 + 5 * 4 + 4 * 4 + 3 * 4
              + 4 * width * 4 + 16 * width * 4)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    ops = 2 * 5 * width
    assert nbytes / cs.HBM_BYTES_PER_S > ops / cs.F32_OPS_PER_S
    got = cs.library(name, args, A, x)().reshape(out.shape)
    torch.testing.assert_close(got, out, rtol=1e-6, atol=0)
    assert cs.SOURCES[name][0] == "spmv_scpa_tpu_torch/csrc/bcsr_bits.cu"
    assert name in cs.LINE_ORDER and name in cs.EXACT_BOTH


def test_chip_smoke_bound_counts_the_slot_products():
    """``chips_products``' bound charges its column and value tables and
    its products whole (12 B a slot) and x only at the distinct columns
    its slots read (-1 and columns past x read nothing): 5 distinct
    columns; its operations are the reading slots' products. Its
    yardstick ``x_pad[cols]`` gathers what the kernel multiplies."""
    cs = _chip_smoke()
    from spmv_scpa_tpu_torch.ops import chips_slots
    cols = torch.full((2, 128), -1, dtype=torch.int32)
    cols[0, :6] = torch.tensor([3, 3, 7, 11, 300, 400], dtype=torch.int32)
    cols[1, :3] = torch.tensor([7, 0, 299], dtype=torch.int32)
    vals = torch.arange(256, dtype=torch.float32).view(2, 128) + 1
    x = torch.arange(300, dtype=torch.float32)
    args = (cols, vals, x)
    out = chips_slots.chips_products_plain(*args)
    ms, by = cs.bound("chips_products", args, out)
    nbytes = 3 * 256 * 4 + 5 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    got = cs.library("chips_products", args, None, x)()
    assert torch.equal(got * vals, out)
    assert cs.SOURCES["chips_products"][0] == \
        "spmv_scpa_tpu_torch/csrc/chips_products.cu"
    assert "chips_products" in cs.LINE_ORDER and \
        "chips_products" in cs.EXACT_BOTH

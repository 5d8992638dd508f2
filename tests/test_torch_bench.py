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

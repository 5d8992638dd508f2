"""The port's timing, stream probe and roofline
(spmv_scpa_tpu_torch/bench/), and the nvcc build of its kernels
(spmv_scpa_tpu_torch/_kernels.py). On the CPU every device measurement
must refuse rather than make a number up; the probe's plain version is
checked here, its kernel in tests/test_torch_cuda.py."""

import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as synth
from spmv_scpa_tpu.bench import roofline as jax_roofline

from spmv_scpa_tpu_torch import _kernels, get_strategy
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
    assert [p.parent for p in paths] == [build_dir] * 2
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

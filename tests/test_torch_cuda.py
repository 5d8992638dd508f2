"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Every test here needs an NVIDIA card (marker ``cuda``) and
skips without one. The file imports no JAX, so the machine with the
card runs it without the reference installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the lane-ELL kernel rounds each product and sum as its
plain version does, so the core's output must be bit-equal; the whole
call (with the compact tail's ``index_add_``, whose atomics add in a
varying order) is held to rel-L2 <= 1e-6 and, per row,
|dy| <= 1e-5 * (|A||x|)_row. The stream probe sums ones, which is exact
in f32 in any order: bit-equal. Against ``spmv_oracle``:
``validate_result`` defaults.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu.formats.csr import CSR
from spmv_scpa_tpu.ops.oracle import spmv_oracle
from spmv_scpa_tpu.utils.validation import validate_result
from spmv_scpa_tpu.utils.vector import make_x

from spmv_scpa_tpu_torch.bench import roofline, timing
from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.registry import to_numpy

KERNEL_VS_PLAIN_REL_L2 = 1e-6
KERNEL_VS_PLAIN_ROW = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_lane_ell_kernel_matches_plain(card, name):
    make, kw = SMALL_CASES[name]
    A = make()
    x = make_x(A.n)
    prep = lane_ell.prepare_lane_ell_hybrid(A, device=card, **kw)
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


def test_stream_probe_matches_plain_exactly(card):
    buf = torch.ones(roofline.PROBE_BYTES // 4, device=card)
    before = roofline.KERNEL_LAUNCHES
    out = roofline.stream_reduce(buf)
    assert roofline.KERNEL_LAUNCHES == before + 1
    assert torch.equal(out, roofline.stream_reduce_plain(buf))
    assert bool((out == buf.numel() // roofline.TILE).all())


def test_stream_bw_and_event_timing(card):
    bw = roofline.measure_stream_bw(card)
    assert 100.0 < bw < 10_000.0
    times = timing.time_cuda(lambda: torch.ones(1 << 20, device=card))
    assert len(times) == 20 and min(times) > 0

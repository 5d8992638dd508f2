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
of its plain version on the CPU: bit-equal to that; against the plain
version on the card (atomics) rel-L2 <= 1e-6. The stream probe sums
ones, which is exact in f32 in any order: bit-equal. Against
``spmv_oracle``: ``validate_result`` defaults.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu_torch.bench import roofline, timing
from spmv_scpa_tpu_torch.bench.cases import SMALL_CASES
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import ext_gather, lane_ell, segsum_kernel
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

KERNEL_VS_PLAIN_REL_L2 = 1e-6
KERNEL_VS_PLAIN_ROW = 1e-5

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


def test_small_cases_launch_every_hybrid_kernel(card):
    """Between them the small cases drive the ext route (both stage-2
    forms) and the chips tail through their kernels."""
    before = _launches()
    for name in ("amazon60k", "ext-windowed40k"):
        make, kw = SMALL_CASES[name]
        A = make()
        prep = lane_ell.prepare_lane_ell_hybrid(A, device=card, **kw)
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
    rbl; steps in window order (each window reads its own steps) and
    out of it (each window scans every step)."""
    rng = np.random.default_rng(3)
    h, rows_per_step, steps = 64, 16, 5
    g = rows_per_step // 8 * BC
    part = torch.as_tensor(rng.standard_normal((steps * rows_per_step, BC)),
                           dtype=torch.float32, device=card)
    rbl_np = rng.integers(0, h + 1, steps * g).astype(np.int32)  # h = pad
    rbl_np[:7] = (h, h, 3, 3, 0, h - 1, 3)
    rbl = torch.as_tensor(rbl_np, device=card)
    for order in ([0, 0, 2, 2, 2], [2, 0, 2, 0, 2]):
        win = torch.as_tensor(order, dtype=torch.int32, device=card)
        args = (part, rbl, win, 3, h, rows_per_step)
        before = segsum_kernel.KERNEL_LAUNCHES
        y = segsum_kernel.window_segsum(*args)
        assert segsum_kernel.KERNEL_LAUNCHES == before + 1
        torch.cuda.synchronize()
        assert y.shape == (3 * h, 8)
        assert bool((y[h:2 * h] == 0).all())
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        assert torch.equal(y.cpu(), segsum_kernel.window_segsum_plain(*cpu))
        yt = segsum_kernel.window_segsum_plain(*args)
        assert float((y - yt).norm()) <= \
            KERNEL_VS_PLAIN_REL_L2 * float(yt.norm())


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

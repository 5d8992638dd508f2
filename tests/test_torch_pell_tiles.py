"""The port's tile kernel routes (``cuda-pell`` with the span and pure
schemes, ``cuda-bcsr``), the span segment-sum and the un-permute against
the JAX package's, run in interpret mode on the CPU. The cases, the
checks and their tolerances are tests/test_torch_pell.py's: host tables
exact, y within rel-L2 1e-4 of JAX and 1e-6 of the oracle; the span
segment-sum within rel-L2 1e-6 of its Pallas kernel (f32-grade bf16
splits) and the un-permute exact (a permutation; the Pallas kernel's two
bf16 passes keep it within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_scpa_tpu.ops import pallas_kernels as jpk
from spmv_scpa_tpu.ops.segsum_kernel import make_span_segsum

from test_torch_pell import (TILE_CASES, _rel_l2, _run, check_meta_and_bytes,
                             check_plain_y, check_plan_arrays)

from spmv_scpa_tpu_torch.ops import pell, segsum_kernel


@pytest.fixture(scope="module", params=TILE_CASES)
def case(request):
    return (request.param, *_run(request.param))


def test_plan_arrays_match_jax(case):
    check_plan_arrays(case)
    assert case[2].kind == "tiles"


def test_meta_and_bytes_match_jax(case):
    check_meta_and_bytes(case)


def test_plain_y_matches_jax_and_oracle(case):
    check_plain_y(case)


# ---- the kernels' plain versions against the Pallas kernels -----------------

@pytest.mark.parametrize("nq, span", [(16, 2), (8, 3), (1, 1)])
def test_span_segsum_matches_pallas(nq, span):
    """Steps straddling windows, global row blocks, padding quanta whose
    row block points at the next window (zero partials), a window no
    step touches."""
    rng = np.random.default_rng(nq)
    h, tiles_per_step, steps, num_win = 16, 4, 6, 5
    rps = tiles_per_step * 8
    g = tiles_per_step * nq
    base = np.array([0, 0, 1, 1, 3, 3], np.int32)
    rel = rng.integers(0, span * h, (steps, g))
    rbl = (base[:, None] * h + rel).astype(np.int32)
    pad = rng.random((steps, g)) < 0.2          # sentinel quanta
    rbl[pad] = np.broadcast_to(base[:, None] * h + h, pad.shape)[pad]
    part3 = rng.standard_normal((steps * tiles_per_step, 8, nq)) \
        .astype(np.float32)
    part3[np.broadcast_to(pad.reshape(-1, 1, nq), part3.shape)] = 0.0
    part = part3.reshape(steps * rps, nq)
    tables = segsum_kernel.span_tables(rbl, base, num_win, h, span, "cpu")
    y = segsum_kernel.span_segsum(
        torch.as_tensor(part), torch.as_tensor(rbl.reshape(-1)),
        torch.as_tensor(base), num_win, h, span, rps, tables).numpy()
    fn, (base_d, mask_d) = make_span_segsum(
        base_of_step=base, num_windows=num_win, h=h, rows_per_step=rps,
        nq=nq, total_tile_rows=steps * rps, span=span, interpret=True)
    yj = np.asarray(fn(jnp.asarray(part), jnp.asarray(rbl.reshape(-1)),
                       base_d, mask_d))
    assert y.shape == yj.shape == (num_win * h, 8)
    assert _rel_l2(y, yj) <= 1e-6
    visited = {int(b) + k for b in base for k in range(span)}
    for w in set(range(num_win)) - visited:
        assert np.all(y[w * h:(w + 1) * h] == 0.0)


def test_unpermute_matches_pallas():
    rng = np.random.default_rng(4)
    mbp = 2 * pell.SORT_WIN
    yp = rng.standard_normal((mbp, 8)).astype(np.float32)
    bsrc = np.stack([rng.permutation(pell.SORT_WIN)
                     for _ in range(2 * 8)]).reshape(2, 8, -1)
    bsrc = bsrc.transpose(0, 2, 1).reshape(mbp, 8).astype(np.int32)
    y = pell.unpermute(torch.as_tensor(yp), torch.as_tensor(bsrc)).numpy()
    call, bsrc_d = jpk._make_unpermute(bsrc, jnp.float32, True)
    yj = np.asarray(call(jnp.asarray(yp), bsrc_d))
    blk = np.arange(mbp)[:, None] // pell.SORT_WIN * pell.SORT_WIN
    np.testing.assert_array_equal(y, yp[blk + bsrc, np.arange(8)])
    assert _rel_l2(y, yj) <= 1e-5      # the TPU's two bf16 passes


def test_cell_sums_follow_the_lane_order():
    """A cell's quanta go round-robin to 32 lanes, each lane adds its
    share in order, and the lanes combine l + 16 into l, then l + 8, ...:
    values whose sums round differently in another order pin it."""
    rng = np.random.default_rng(7)
    n = 70
    v = (rng.standard_normal((n, 8)) * 10.0 ** rng.integers(-6, 7, (n, 1))) \
        .astype(np.float32)
    cell = np.zeros(n, np.int64)
    cell[::5] = 1                      # a second, shorter cell
    cell[3] = -1                       # a quantum that adds nothing
    got = segsum_kernel.cell_sums(torch.as_tensor(v), torch.as_tensor(cell),
                                  3).numpy()
    for c in range(3):
        q = v[cell == c]
        lanes = np.zeros((32, 8), np.float32)
        for i, row in enumerate(q):
            lanes[i % 32] = lanes[i % 32] + row
        w = 32
        while w > 1:
            w //= 2
            lanes = lanes[:w] + lanes[w:2 * w]
        np.testing.assert_array_equal(got[c], lanes[0])
    assert not np.array_equal(got[0], v[cell == 0].sum(0, dtype=np.float32))

"""The port's SpMM and ELL baselines against the JAX package's, on the
CPU: ``cuda-bcsr-spmm`` (spmv_scpa_tpu_torch/ops/spmm.py: the host plan
of ``make_bcsr_spmm`` and the plain version of the ``bcsr_spmm`` kernel)
against ``pallas-bcsr-spmm`` in interpret mode, ``torch-csr-segsum-spmm``
against ``xla-csr-segsum-spmm``, ``torch-ell-rm``/``-cm`` against
``xla-ell-rm``/``-cm`` and ``oracle-ell`` against its original, and
``registry.spmv``'s 1-D drive of SpMM-only strategies. Each side builds
its matrix with its own generator from the same seed. The CUDA kernel is
held against its plain version in tests/test_torch_cuda.py.

Tolerances:
* the SpMM plan's tiles and window tables against JAX: exact;
* Y against the JAX Y: relative L2 <= 1e-5 (both f32; the TPU kernel's
  MXU dots at HIGHEST and one-hot window reduce add in another order
  than the port's row walk), and ``validate_result`` against
  ``spmm_oracle``;
* the f32 ELL and segment-sum baselines against JAX: rel-L2 <= 1e-6
  (f32 sums in other orders); ``oracle-ell`` equal to its original.
"""

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.ops.registry import get_strategy as jax_strategy

from spmv_scpa_tpu_torch import get_strategy, spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.ops import spmm
from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle, spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_SPMM = 1e-5
VS_JAX_F32 = 1e-6


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


# name -> matrix drawn by either package's generators (``s``)
MATRICES = {
    # tests/test_kernels.py:223-229
    "banded200x300": lambda s: s.banded_csr(200, 300, row_nnz=11,
                                            bandwidth=48, runs=3, seed=5),
    "stencil4k": lambda s: s.stencil_csr(4000, points=6, run_len=8,
                                         bandwidth=300, seed=2),
    "banded256": lambda s: s.banded_csr(256, row_nnz=9, bandwidth=40,
                                        seed=1),
    "diag": lambda s: s.diag_csr(37),
    "random": lambda s: s.random_csr(200, 300, density=0.02, seed=3),
    "powerlaw": lambda s: s.powerlaw_csr(400, 400, seed=4),
}


def _pair(name):
    A, Aj = MATRICES[name](synth), MATRICES[name](jax_synth)
    np.testing.assert_array_equal(A.ja, Aj.ja)
    return A, Aj


# ---- the SpMM plan ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("cols, chunk", [(8, 4), (64, 64), (1, 16)])
def test_spmm_plan_matches_jax(name, cols, chunk):
    A, Aj = _pair(name)
    plan = spmm.plan_bcsr_spmm(A, cols=cols, chunk=chunk)
    tables = spmm.spmm_tables(plan)
    jprep = jax_strategy("pallas-bcsr-spmm").prepare(Aj, cols=cols,
                                                     chunk=chunk)
    base, pan2, rbl2, mask, vals = (np.asarray(a) for a in jprep.args)
    np.testing.assert_array_equal(tables["base"], base)
    np.testing.assert_array_equal(tables["pan2"], pan2)
    np.testing.assert_array_equal(tables["rbl2"], rbl2)
    np.testing.assert_array_equal(tables["masks"], mask[:, :, 0])
    assert tables["W"] == mask.shape[0]
    np.testing.assert_array_equal(tables["vals"].astype(np.float32), vals)
    # the kernel's arrays are the reference's before its padding
    T = plan.num_tiles
    np.testing.assert_array_equal(plan.vals.astype(np.float32), vals[:T * 8])
    np.testing.assert_array_equal(plan.pan, pan2.reshape(-1)[:T])
    prep = spmm.prepare_bcsr_spmm(A, cols=cols, chunk=chunk, device="cpu")
    assert prep.meta == jprep.meta
    assert prep.hbm_bytes == jprep.hbm_bytes == T * 8 * BC * 4
    assert prep.ref == jprep.strategy == "pallas-bcsr-spmm"
    # the kernel's walk: block row b's tiles are rowptr[b] .. rowptr[b+1]
    rowblk = np.repeat(np.arange(plan.rowptr.size - 1), np.diff(plan.rowptr))
    np.testing.assert_array_equal(
        rowblk, tables["rbl2"].reshape(-1)[:T * 8:8] // 8)


def test_spmm_x_budget_refuses_before_packing(monkeypatch):
    """The flagship's n at 64 columns: X is 96.5 MB, past the
    reference's 12 MiB; both refuse (the port before building any
    tile)."""
    n = 377_000
    coo = (np.arange(4), np.arange(4), np.ones(4))
    monkeypatch.setattr(spmm, "csr_to_bcsr", None)     # never reached
    with pytest.raises(ValueError, match="exceeds VMEM budget"):
        spmm.plan_bcsr_spmm(CSR.from_coo("flag_n", n, n, *coo), cols=64)
    with pytest.raises(ValueError, match="exceeds VMEM budget"):
        jax_strategy("pallas-bcsr-spmm").prepare(
            JaxCSR.from_coo("flag_n", n, n, *coo), cols=64)


def test_spmm_y_matches_jax_and_oracle():
    """tests/test_kernels.py:223-229's case (chunk 4)."""
    A, Aj = _pair("banded200x300")
    X = make_x(A.n, cols=8)
    Y = to_numpy(spmm.prepare_bcsr_spmm(A, cols=8, chunk=4,
                                        device="cpu").fn(X))
    Y_jax = np.asarray(jax_strategy("pallas-bcsr-spmm").prepare(
        Aj, cols=8, chunk=4).fn(X), np.float64)
    assert Y.shape == (A.m, 8)
    assert _rel(Y, Y_jax) <= VS_JAX_SPMM
    validate_result(spmm_oracle(A, X), Y, what="cuda-bcsr-spmm")
    validate_result(spmm_oracle(A, X), Y_jax, what="pallas-bcsr-spmm")


@pytest.mark.parametrize("index", range(7))
@pytest.mark.parametrize("cols", [1, 8, 64])
def test_bcsr_spmm_matches_oracle_on_zoo(matrices, index, cols):
    Aj = matrices[index]
    A = CSR(Aj.name, Aj.m, Aj.n, Aj.irp, Aj.ja, Aj.as_)
    X = make_x(A.n, cols=cols)
    prep = get_strategy("cuda-bcsr-spmm").prepare(A, cols=cols,
                                                  device="cpu")
    Y = prep.fn(X)
    assert Y.shape == (A.m, cols) and Y.dtype == torch.float32
    validate_result(spmm_oracle(A, X), to_numpy(Y),
                    what=f"cuda-bcsr-spmm cols {cols} on {A.name}")


def test_bcsr_spmm_plain_adds_in_the_kernels_order():
    """Each element of Y is its row's tiles in order, each tile's 128
    products summed as a pairwise tree, one rounded product and one
    rounded sum at a time: a scalar loop over the same tiles gives the
    same bits, and so does a binary counter over groups of four (the
    kernel's way to the same tree)."""
    A = MATRICES["random"](synth)
    prep = spmm.prepare_bcsr_spmm(A, cols=3, device="cpu")
    X = torch.as_tensor(make_x(A.n, cols=3), dtype=torch.float32)
    (_, (vals, pan, rowptr, Xa, m)), = prep.kernel_calls(X)
    Y = spmm.bcsr_spmm(vals, pan, rowptr, Xa, m)
    v = vals.view(-1, 8, BC).numpy()
    f32 = np.float32
    for i in (0, 7, 9, 100, m - 1):
        b, r = divmod(i, 8)
        for c in range(3):
            acc = acc_counter = f32(0.0)
            for t in range(int(rowptr[b]), int(rowptr[b + 1])):
                col = int(pan[t]) * BC + np.arange(BC)
                xv = np.where(col < A.n, Xa[np.minimum(col, A.n - 1),
                                            c].numpy(), f32(0.0))
                p = [f32(f32(v[t, r, k]) * f32(xv[k])) for k in range(BC)]
                tree = p
                while len(tree) > 1:
                    tree = [f32(tree[2 * q] + tree[2 * q + 1])
                            for q in range(len(tree) // 2)]
                acc = f32(acc + tree[0])
                pending = {}
                for k4 in range(BC // 4):
                    s = f32(f32(p[4 * k4] + p[4 * k4 + 1])
                            + f32(p[4 * k4 + 2] + p[4 * k4 + 3]))
                    lvl = 0
                    while (k4 >> lvl) & 1:
                        s = f32(pending[lvl] + s)
                        lvl += 1
                    pending[lvl] = s
                acc_counter = f32(acc_counter + pending[5])
            assert Y[i, c].item() == acc == acc_counter, (i, c)


def test_bcsr_spmm_wrapper_on_cpu_tensors():
    A = MATRICES["banded200x300"](synth)
    prep = spmm.prepare_bcsr_spmm(A, device="cpu")
    X = torch.as_tensor(make_x(A.n, cols=8), dtype=torch.float32)
    (name, args), = prep.kernel_calls(X)
    assert name == "bcsr_spmm"
    before = spmm.KERNEL_LAUNCHES
    assert torch.equal(spmm.bcsr_spmm(*args), spmm.bcsr_spmm_plain(*args))
    assert spmm.KERNEL_LAUNCHES == before
    vals, pan, rowptr, Xa, m = args
    for bad, what in (((vals.double(), pan, rowptr, Xa, m), "vals"),
                      ((vals, pan.long(), rowptr, Xa, m), "pan"),
                      ((vals, pan, rowptr[:-1], Xa, m), "rowptr"),
                      ((vals, pan, rowptr, Xa[:, 0], m), "X is"),
                      ((vals, pan, rowptr, Xa.t().contiguous().t(), m),
                       "contiguous")):
        with pytest.raises(ValueError, match=what):
            spmm.bcsr_spmm(*bad)
    with pytest.raises(ValueError, match="X has shape"):
        prep.fn(np.ones((A.n, 4)))


@pytest.mark.parametrize("name", sorted(cases.SPMM_CASES))
def test_spmm_cases_on_cpu(name):
    """``bench/cases.py``'s small SpMM cases, which ``chip_smoke.py``
    runs on the card: the plain version against the oracle."""
    make, kw = cases.SPMM_CASES[name]
    A = make()
    X = make_x(A.n, cols=kw["cols"])
    Y = get_strategy("cuda-bcsr-spmm").prepare(A, device="cpu", **kw).fn(X)
    validate_result(spmm_oracle(A, X), to_numpy(Y), what=name)


def test_stencil48k_has_the_64_column_sizes():
    """The 64-column input fits the reference's X budget; the
    flagship's n would not."""
    A = cases.stencil48k()
    assert (A.m, A.n) == (48_000, 48_000)
    assert -(-A.n // BC) * BC * 64 * 4 <= spmm.X_VMEM_BUDGET
    assert -(-377_000 // BC) * BC * 64 * 4 > spmm.X_VMEM_BUDGET


# ---- spmv's drive of SpMM-only strategies -----------------------------------

@pytest.mark.parametrize("strategy", ["cuda-bcsr-spmm",
                                      "torch-csr-segsum-spmm"])
def test_spmv_drives_spmm_only_strategies_with_1d_x(strategy):
    """tests/test_kernels.py:183-195: a 1-D x rides column 0 of an (n,
    cols) block; a 2-D x passes through."""
    A = synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    x = make_x(A.n)
    assert get_strategy(strategy).spmm_only and get_strategy(strategy).spmm
    y = spmv(A, x, strategy, device="cpu")
    assert y.shape == (A.m,)
    validate_result(spmv_oracle(A, x), y, what=f"{strategy} via spmv()")
    np.testing.assert_array_equal(
        y, spmv(A, torch.as_tensor(x, dtype=torch.float32), strategy,
                device="cpu", cols=4))
    X = make_x(A.n, cols=8)
    Y = spmv(A, X, strategy, device="cpu")
    assert Y.shape == (A.m, 8)
    validate_result(spmm_oracle(A, X), Y, what=f"{strategy} 2-D")


def test_segsum_spmm_matches_jax():
    """tests/test_kernels.py:142-149's case."""
    A = synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    Aj = jax_synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    X = make_x(A.n, cols=8)
    prep = get_strategy("torch-csr-segsum-spmm").prepare(A, device="cpu")
    jprep = jax_strategy("xla-csr-segsum-spmm").prepare(Aj)
    Y, Y_jax = to_numpy(prep.fn(X)), np.asarray(jprep.fn(X), np.float64)
    assert _rel(Y, Y_jax) <= VS_JAX_F32
    assert prep.hbm_bytes == jprep.hbm_bytes
    validate_result(spmm_oracle(A, X), Y, what="torch-csr-segsum-spmm")


# ---- the ELL baselines -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("layout", ["rm", "cm"])
def test_ell_baselines_match_jax(name, layout):
    A, Aj = _pair(name)
    x = make_x(A.n)
    prep = get_strategy(f"torch-ell-{layout}").prepare(A, device="cpu")
    jprep = jax_strategy(f"xla-ell-{layout}").prepare(Aj)
    y, y_jax = to_numpy(prep.fn(x)), np.asarray(jprep.fn(x), np.float64)
    assert _rel(y, y_jax) <= VS_JAX_F32
    assert prep.meta == jprep.meta and prep.hbm_bytes == jprep.hbm_bytes
    assert prep.ref == jprep.strategy
    validate_result(spmv_oracle(A, x), y, what=f"torch-ell-{layout}")


def test_ell_spmm_form_matches_oracle():
    """``make_ell_uniform`` on X (n, c): the reference's
    ``make_ell_uniform_spmm`` (xla.py:94), as ``torch-ell-rm``/``-cm``
    run it for a 2-D x."""
    import jax.numpy as jnp
    from spmv_scpa_tpu.formats.ell import csr_to_ell as jax_csr_to_ell
    from spmv_scpa_tpu.ops import xla as jax_xla
    from spmv_scpa_tpu_torch.formats.ell import csr_to_ell
    from spmv_scpa_tpu_torch.ops import torch_ops
    A, Aj = _pair("random")
    X = make_x(A.n, cols=5)
    for col_major in (False, True):
        U = csr_to_ell(A, col_major=col_major).to_uniform()
        Y = to_numpy(torch_ops.make_ell_uniform(U, torch.device("cpu"))(X))
        raw, args = jax_xla.make_ell_uniform_spmm(
            jax_csr_to_ell(Aj, col_major=col_major).to_uniform())
        Y_jax = np.asarray(raw(jnp.asarray(X), *args), np.float64)
        assert Y.shape == (A.m, 5) and _rel(Y, Y_jax) <= VS_JAX_F32
        validate_result(spmm_oracle(A, X), Y,
                        what=f"ELL SpMM col_major={col_major}")


@pytest.mark.parametrize("strategy", ["torch-csr-segsum", "torch-ell-rm",
                                      "torch-ell-cm", "cuda-hybrid"])
def test_spmv_passes_2d_x_only_to_spmm_strategies(strategy):
    """A 2-D x goes through a strategy marked ``spmm`` and gives Y (m,
    cols); any other strategy refuses it before packing."""
    A = synth.banded_csr(100, row_nnz=6, bandwidth=30, seed=2)
    X = make_x(A.n, cols=3)
    if not get_strategy(strategy).spmm:
        with pytest.raises(ValueError, match="takes a 1-D x"):
            spmv(A, X, strategy, device="cpu")
        return
    Y = spmv(A, X, strategy, device="cpu")
    assert Y.shape == (A.m, 3)
    validate_result(spmm_oracle(A, X), Y, what=f"{strategy} 2-D")
    y1 = spmv(A, X[:, 1], strategy, device="cpu")
    assert _rel(Y[:, 1], y1) <= VS_JAX_F32


def test_ell_refuses_explosive_padding():
    A, Aj = (synth.powerlaw_csr(4000, 4000, seed=5),
             jax_synth.powerlaw_csr(4000, 4000, seed=5))
    with pytest.raises(ValueError, match="uniform ELL padding too large"):
        get_strategy("torch-ell-cm").prepare(A, device="cpu",
                                             max_padded=1 << 16)
    with pytest.raises(ValueError, match="uniform ELL padding too large"):
        jax_strategy("xla-ell-cm").prepare(Aj, max_padded=1 << 16)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_oracle_ell_matches_the_original(name):
    A, Aj = _pair(name)
    x = make_x(A.n)
    prep = get_strategy("oracle-ell").prepare(A)
    jprep = jax_strategy("oracle-ell").prepare(Aj)
    np.testing.assert_array_equal(prep.fn(x), jprep.fn(x))
    assert prep.meta == jprep.meta and prep.hbm_bytes == jprep.hbm_bytes
    assert prep.device.type == "cpu"

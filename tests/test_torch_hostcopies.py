"""The port's own copies of the JAX package's host modules
(spmv_scpa_tpu_torch/{formats/csr,formats/ell,errors,io,ops/oracle,
utils/validation,utils/vector,testing}.py, bench/timing.py's BenchResult
and compute_gflops), and the import boundary that makes them necessary: the
port and ``chip_smoke.py`` import neither ``jax`` nor any module of
``spmv_scpa_tpu``.

Each copy is held equal to its original: the same arrays from every
generator and seed, the same CSR from ``load_csr`` on the same file, the
same oracle output and the same ``validate_result`` verdicts. All
comparisons are exact.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spmv_scpa_tpu import errors as jax_errors
from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.bench import timing as jax_timing
from spmv_scpa_tpu.formats import bcsr as jax_bcsr
from spmv_scpa_tpu.formats import ell as jax_ell
from spmv_scpa_tpu.formats import panel_ell as jax_panel_ell
from spmv_scpa_tpu.formats.csr import CSR as JaxCSR
from spmv_scpa_tpu.formats.csr import \
    partition_rows_by_nnz as jax_partition_rows_by_nnz
from spmv_scpa_tpu.io import loader as jax_loader
from spmv_scpa_tpu.io import mmio as jax_mmio
from spmv_scpa_tpu.ops import segsum_kernel as jax_segsum
from spmv_scpa_tpu.ops import xla as jax_xla
from spmv_scpa_tpu.ops import xpose_plan as jax_xpose_plan
from spmv_scpa_tpu.ops.oracle import spmm_oracle as jax_spmm_oracle
from spmv_scpa_tpu.ops.oracle import spmv_oracle as jax_oracle
from spmv_scpa_tpu.utils import validation as jax_validation
from spmv_scpa_tpu.utils.vector import make_x as jax_make_x

from spmv_scpa_tpu_torch import errors, load_csr, testing as synth
from spmv_scpa_tpu_torch.bench import timing
from spmv_scpa_tpu_torch.formats import bcsr, ell, panel_ell
from spmv_scpa_tpu_torch.formats.csr import BC, CSR, partition_rows_by_nnz
from spmv_scpa_tpu_torch.ops import (registry, segsum_kernel, torch_ops,
                                     xpose_plan)
from spmv_scpa_tpu_torch.io import mmio
from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle, spmv_oracle
from spmv_scpa_tpu_torch.utils import validation
from spmv_scpa_tpu_torch.utils.vector import make_x

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "spmv_scpa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spmv_scpa_tpu")


def _same_csr(a, b):
    assert (a.name, a.m, a.n, a.nnz) == (b.name, b.m, b.n, b.nnz)
    for field in ("irp", "ja", "as_"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


# ---- the import boundary ---------------------------------------------------

def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_load_no_jax_package():
    """In a fresh interpreter (tests/conftest.py imports both packages),
    importing every module of the port and chip_smoke loads neither."""
    mods = _port_modules()
    assert {"spmv_scpa_tpu_torch.ops.chips_tail",
            "spmv_scpa_tpu_torch.ops.pell",
            "spmv_scpa_tpu_torch.ops.pell_rows",
            "spmv_scpa_tpu_torch.bench.rows_study",
            "spmv_scpa_tpu_torch.ops.xpose",
            "spmv_scpa_tpu_torch.ops.xpose_plan",
            "spmv_scpa_tpu_torch.ops.nearfar",
            "spmv_scpa_tpu_torch.formats.panel_ell",
            "spmv_scpa_tpu_torch.formats.bcsr",
            "spmv_scpa_tpu_torch.formats.ell",
            "spmv_scpa_tpu_torch.ops.lane_ell_fp64",
            "spmv_scpa_tpu_torch.ops.spmm",
            "spmv_scpa_tpu_torch.parallel",
            "spmv_scpa_tpu_torch.parallel.distributed",
            "spmv_scpa_tpu_torch.cli",
            "spmv_scpa_tpu_torch.bench.runner",
            "spmv_scpa_tpu_torch.bench.logger",
            "spmv_scpa_tpu_torch.io.native",
            "spmv_scpa_tpu_torch.io.cache",
            "spmv_scpa_tpu_torch.ops.native_omp"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1)[1].strip() == "[]", out.stdout


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_the_jax_package(path):
    for mod in _imported(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


# ---- the copies against their originals ------------------------------------

# case -> (generator, arguments)
GENERATORS = {
    "banded": ("banded_csr", dict(m=700, row_nnz=9, bandwidth=40, seed=1)),
    "banded-runs": ("banded_csr", dict(m=512, row_nnz=12, bandwidth=96,
                                       runs=3, seed=7)),
    "banded-rect": ("banded_csr", dict(m=300, n=200, row_nnz=7,
                                       bandwidth=64, seed=2)),
    "stencil": ("stencil_csr", dict(m=4000, points=6, run_len=8,
                                    bandwidth=300, seed=2)),
    "random": ("random_csr", dict(m=200, n=300, density=0.02, seed=3)),
    "powerlaw": ("powerlaw_csr", dict(m=400, n=400, seed=4)),
    "webbase": ("webbase_csr", dict(m=20000, seed=5)),
    "amazon": ("amazon_csr", dict(m=3000, seed=6)),
    "amazon-avg": ("amazon_csr", dict(m=20000, avg_nnz=4.7, seed=4)),
    "diag": ("diag_csr", dict(m=37)),
    "tiny": ("tiny_fixture_csr", dict()),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_draw_the_same_matrices(name):
    fn, kw = GENERATORS[name]
    _same_csr(getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw))


def test_csr_from_coo_and_views_match():
    rng = np.random.default_rng(11)
    m, n, k = 50, 40, 400
    r, c = rng.integers(0, m, k), rng.integers(0, n, k)
    v = rng.standard_normal(k)
    for dup in (False, True):
        a = CSR.from_coo("t", m, n, r, c, v, sum_duplicates=dup)
        b = JaxCSR.from_coo("t", m, n, r, c, v, sum_duplicates=dup)
        _same_csr(a, b)
        np.testing.assert_array_equal(a.row_ids(), b.row_ids())
        np.testing.assert_array_equal(a.row_lengths(), b.row_lengths())
        np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    d = rng.standard_normal((9, 7)) * (rng.random((9, 7)) < 0.3)
    _same_csr(CSR.from_dense("d", d), JaxCSR.from_dense("d", d))
    assert BC == jax_panel_ell.BC


@pytest.mark.parametrize("name", ["powerlaw", "webbase", "diag", "tiny",
                                  "banded-rect"])
def test_row_slices_and_the_shard_planner_match(name):
    """``CSR.slice_rows`` and ``partition_rows_by_nnz``: the same bounds
    (more parts than rows too: empty trailing spans) and the same sliced
    arrays."""
    fn, kw = GENERATORS[name]
    a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    for parts in (1, 3, 8, a.m + 2):
        bounds = partition_rows_by_nnz(a.irp, parts)
        np.testing.assert_array_equal(
            bounds, jax_partition_rows_by_nnz(b.irp, parts))
        assert bounds.dtype == np.int64 and bounds.shape == (parts + 1,)
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            _same_csr(a.slice_rows(r0, r1), b.slice_rows(r0, r1))
    _same_csr(a.slice_rows(0, a.m, name="all"),
              b.slice_rows(0, b.m, name="all"))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            partition_rows_by_nnz(a.irp, bad)


def _write_mtx(path, kind, rng):
    m, n = (60, 60) if kind != "general" else (60, 45)
    k = 300
    r, c = rng.integers(0, m, k), rng.integers(0, n, k)
    if kind == "symmetric":
        r, c = np.maximum(r, c), np.minimum(r, c)       # lower triangle
    val = None if kind == "pattern" else rng.standard_normal(k)
    mmio.write(path, m, n, r, c, val,
               symmetry="symmetric" if kind == "symmetric" else "general",
               comment="written by the port's mmio.write")


@pytest.mark.parametrize("kind", ["general", "symmetric", "pattern"])
def test_load_csr_matches_the_original(tmp_path, kind):
    path = tmp_path / f"m_{kind}.mtx"
    _write_mtx(path, kind, np.random.default_rng(len(kind)))
    a = load_csr(str(path))
    b = jax_loader.load_csr(str(path), use_native=False)
    _same_csr(a, b)
    assert a.name == f"m_{kind}"
    # the port's writer and the original's write the same file
    coo = mmio.read(str(path))
    other = tmp_path / "again.mtx"
    jax_mmio.write(other, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
                   symmetry=coo.banner.symmetry,
                   comment="written by the port's mmio.write")
    assert other.read_bytes() == path.read_bytes()


def test_load_csr_errors_match(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(errors.MatrixFormatError) as e1:
        load_csr(str(bad))
    with pytest.raises(jax_errors.MatrixFormatError) as e2:
        jax_loader.load_csr(str(bad), use_native=False)
    assert str(e1.value) == str(e2.value)
    oob = tmp_path / "oob.mtx"
    oob.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 1\n3 1 1.0\n")
    with pytest.raises(errors.MatrixBoundsError):
        load_csr(str(oob))
    with pytest.raises(jax_errors.MatrixBoundsError):
        jax_loader.load_csr(str(oob), use_native=False)
    for cls in ("MatrixFormatError", "MatrixBoundsError", "ValidationError",
                "ConfigError"):
        assert getattr(errors, cls).code == getattr(jax_errors, cls).code


def test_load_csr_native_waits_for_its_roadmap_item(tmp_path):
    """The item is done: ``use_native=True`` reads with the port's C++
    parser, to the CSR of the NumPy parser and of the original."""
    path = tmp_path / "g.mtx"
    _write_mtx(path, "general", np.random.default_rng(0))
    a = load_csr(str(path), use_native=True)
    _same_csr(a, load_csr(str(path), use_native=False))
    _same_csr(a, jax_loader.load_csr(str(path), use_native=False))


def test_oracle_and_make_x_match():
    for A_p, A_j in ((synth.amazon_csr(m=3000, seed=6),
                      jax_synth.amazon_csr(m=3000, seed=6)),
                     (synth.tiny_fixture_csr(), jax_synth.tiny_fixture_csr())):
        x = make_x(A_p.n)
        np.testing.assert_array_equal(x, jax_make_x(A_j.n))
        np.testing.assert_array_equal(spmv_oracle(A_p, x),
                                      jax_oracle(A_j, x))
    np.testing.assert_array_equal(make_x(33, seed=5), jax_make_x(33, seed=5))
    np.testing.assert_array_equal(make_x(10, cols=3), jax_make_x(10, cols=3))


@pytest.mark.parametrize("scale, noise", [
    (1.0, 0.0), (1.0, 1e-6), (1.0, 1e-2), (1e-3, 1e-5), (1e-3, 1e-2),
    (50.0, 1e-7), (50.0, 1e-3)])
def test_validate_result_verdicts_match(scale, noise):
    rng = np.random.default_rng(7)
    want = rng.standard_normal(500) * scale
    got = want * (1 + noise * rng.standard_normal(500))
    verdicts = []
    for mod in (validation, jax_validation):
        try:
            verdicts.append(("ok", mod.validate_result(want, got, what="t")))
        except Exception as err:                      # noqa: BLE001
            verdicts.append((type(err).__name__, str(err)))
    assert verdicts[0] == verdicts[1]
    with pytest.raises(errors.ValidationError):
        validation.validate_result(want, got[:-1])
    assert validation.l2_error(want, got) == jax_validation.l2_error(want,
                                                                      got)


def test_bench_result_and_gflops_match():
    for nnz, ms, cols in ((22_588_601, 0.1034, 1), (1000, 0.0, 1),
                          (999_563, 0.25, 4)):
        assert timing.compute_gflops(nnz, ms, cols) == \
            jax_timing.compute_gflops(nnz, ms, cols)
    a = timing.BenchResult(1.5, 2.0, reps=3)
    b = jax_timing.BenchResult(1.5, 2.0, reps=3)
    assert (a.duration_ms, a.gflops, a.data, a.reps, a.all_ms) == \
        (b.duration_ms, b.gflops, b.data, b.reps, b.all_ms)


# ---- the PELL-family formats ------------------------------------------------

PELL_KNOBS = [
    dict(),
    dict(quantum=8, window_h=16, chunk_align=4),
    dict(quantum=8, chunk_align=1, min_chunk_align=1, panel_w=4),
    dict(quantum=32, window_h=48, chunk_align=64, min_chunk_align=16),
    dict(quantum=128, chunk_align=1, min_chunk_align=1, panel_w=8),
]


def _same_fields(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("name", ["banded", "powerlaw", "webbase",
                                  "random", "tiny"])
def test_csr_to_pell_matches_the_original(name):
    fn, kw = GENERATORS[name]
    a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    for knobs in PELL_KNOBS:
        _same_fields(panel_ell.csr_to_pell(a, **knobs),
                     jax_panel_ell.csr_to_pell(b, **knobs),
                     ("name", "m", "n", "nnz", "quantum", "vals", "lcol",
                      "panel", "rowblk", "window_h", "chunk_align",
                      "window", "rbl", "panel_w"))
    empty = CSR.from_coo("e", 3000, 40, np.zeros(0, np.int64),
                         np.zeros(0, np.int64), np.zeros(0))
    empty_j = JaxCSR.from_coo("e", 3000, 40, np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0))
    _same_fields(panel_ell.csr_to_pell(empty, chunk_align=4),
                 jax_panel_ell.csr_to_pell(empty_j, chunk_align=4),
                 ("vals", "lcol", "panel", "rowblk", "window", "rbl"))
    assert (panel_ell.BR, panel_ell.BC, panel_ell.DEFAULT_QUANTUM,
            panel_ell.DEFAULT_WINDOW_H) == (
        jax_panel_ell.BR, jax_panel_ell.BC, jax_panel_ell.DEFAULT_QUANTUM,
        jax_panel_ell.DEFAULT_WINDOW_H)


@pytest.mark.parametrize("name", ["banded", "banded-rect", "stencil",
                                  "random", "diag"])
def test_csr_to_bcsr_matches_the_original(name):
    fn, kw = GENERATORS[name]
    a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    for br, bc in ((8, 128), (4, 64)):
        mine = bcsr.csr_to_bcsr(a, br=br, bc=bc)
        want = jax_bcsr.csr_to_bcsr(b, br=br, bc=bc)
        _same_fields(mine, want, ("name", "m", "n", "nnz", "br", "bc",
                                  "vals", "col_panel", "rowptr"))
        assert mine.fill == want.fill


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_quick_envelope_ok_matches_the_original(name):
    fn, kw = GENERATORS[name]
    a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    assert registry.quick_envelope_ok(a) == jax_xpose_plan.quick_envelope_ok(b)
    big_row = CSR.from_coo("r", 10, 20000, np.zeros(16385, np.int64),
                           np.arange(16385), np.ones(16385))
    assert registry.quick_envelope_ok(big_row) is False
    # one envelope: the registry's is the planner's copy
    assert registry.quick_envelope_ok is xpose_plan.quick_envelope_ok
    assert (xpose_plan.J1_MAX, xpose_plan.CCAP, xpose_plan.B2_MAX,
            xpose_plan.ROWS_PER_BLK) == (
        jax_xpose_plan.J1_MAX, jax_xpose_plan.CCAP, jax_xpose_plan.B2_MAX,
        jax_xpose_plan.ROWS_PER_BLK)


# ---- the ELL format and the SpMM oracle -------------------------------------

ELL_KNOBS = [dict(), dict(slice_h=8, col_major=False),
             dict(slice_h=16, pad_mode="neg1"),
             dict(col_major=False, pad_mode="neg1")]


@pytest.mark.parametrize("name", ["banded", "banded-rect", "powerlaw",
                                  "random", "diag", "tiny"])
def test_csr_to_ell_matches_the_original(name):
    fn, kw = GENERATORS[name]
    a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    x = make_x(a.n)
    for knobs in ELL_KNOBS:
        mine, want = ell.csr_to_ell(a, **knobs), jax_ell.csr_to_ell(b,
                                                                    **knobs)
        _same_fields(mine, want, ("name", "m", "n", "nnz", "slice_h",
                                  "col_major", "pad_mode", "max_nz", "offs",
                                  "ja_flat", "as_flat"))
        assert (mine.num_slices, mine.padded_nnz, mine.fill) == (
            want.num_slices, want.padded_nnz, want.fill)
        for s in (0, mine.num_slices - 1):
            for u, v in zip(mine.block(s), want.block(s)):
                np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(mine.to_dense(), want.to_dense())
        for lane_pad in (1, 8):
            _same_fields(mine.to_uniform(lane_pad),
                         want.to_uniform(lane_pad),
                         ("name", "m", "n", "nnz", "slice_h", "k",
                          "col_major", "ja", "as_"))
        # the serial HLL oracle is a copy too
        np.testing.assert_array_equal(torch_ops.serial_ell(mine, x),
                                      jax_xla.serial_ell(want, x))
    assert ell.HACK_SIZE == jax_ell.HACK_SIZE
    with pytest.raises(ValueError, match="pad_mode"):
        ell.csr_to_ell(a, pad_mode="zero")


def test_spmm_oracle_and_visit_masks_match():
    for name in ("amazon", "random", "diag"):
        fn, kw = GENERATORS[name]
        a, b = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
        for cols in (None, 1, 8):
            X = make_x(a.n, cols=cols)
            np.testing.assert_array_equal(spmm_oracle(a, X),
                                          jax_spmm_oracle(b, X))
        with pytest.raises(ValueError, match="rows"):
            spmm_oracle(a, np.ones((a.n + 1, 2)))
    rng = np.random.default_rng(4)
    for base, nw, span, rep in ((rng.integers(0, 9, 40), 9, 3, 4),
                                (np.zeros(0, np.int64), 2, 1, 8),
                                (np.array([0, 0, 5]), 6, 2, 1)):
        np.testing.assert_array_equal(
            segsum_kernel.make_visit_masks(base, nw, span, rep),
            jax_segsum.make_visit_masks(base, nw, span, rep))

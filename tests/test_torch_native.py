"""The port's native host pieces against the JAX package's: the C++
Matrix Market parser (``io/native.py``), ``load_csr``'s ``use_native``,
the ``.npz`` layout cache (``io/cache.py``) and the OpenMP kernels
(``ops/native_omp.py``, the ``omp-*`` strategies).

The JAX package builds its libraries with ``make -C native`` into
``native/``; here its sources are built with that Makefile's flags into
a temporary directory instead (its other tests may be building
``native/`` in another process at the same time), and its bindings point
there. The port builds its own copies of the sources into
``spmv_scpa_tpu_torch/_build/``.

Tolerances: parsers and caches give exactly the same arrays; the OpenMP
kernels, one source with one set of flags and one row partition, give
the same bits, and are within rel-L2 1e-12 of the fp64 oracle.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

from spmv_scpa_tpu import errors as jax_errors
from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.formats.ell import csr_to_ell as jax_csr_to_ell
from spmv_scpa_tpu.io import cache as jax_cache
from spmv_scpa_tpu.io import loader as jax_loader
from spmv_scpa_tpu.io import native as jax_native
from spmv_scpa_tpu.ops import native_omp as jax_omp

from spmv_scpa_tpu_torch import _kernels, errors, get_strategy
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.formats.ell import csr_to_ell
from spmv_scpa_tpu_torch.io import cache, loader, mmio, native
from spmv_scpa_tpu_torch.ops import native_omp
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.utils.vector import make_x

ROOT = Path(__file__).resolve().parents[1]
ORACLE_REL_L2 = 1e-12

GENERAL = """%%MatrixMarket matrix coordinate real general
% comment line
4 5 6
1 1 1.5
1 3 2.0e1
2 2 -3.25
3 5 4.0
4 1 5.5
4 4 -1e-3
"""
SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
5 5 6
1 1 2.0
2 1 -1.0
3 2 0.5
4 4 3.25
5 2 1e-2
5 5 -7
"""
PATTERN = ("%%MatrixMarket matrix coordinate pattern symmetric\n"
           "3 3 2\n2 1\n3 3\n")
INTEGER = ("%%MatrixMarket matrix coordinate integer general\n"
           "3 4 3\n1 4 7\n2 2 -3\n3 1 12\n")
TRUNCATED = ("%%MatrixMarket matrix coordinate real general\n"
             "2 2 3\n1 1 1.0\n")
TRAILING = ("%%MatrixMarket matrix coordinate real general\n"
            "2 2 1\n1 1 1.0\n2 2 2.0\n")
GOOD = {"general": GENERAL, "symmetric": SYMMETRIC, "pattern": PATTERN,
        "integer": INTEGER}
BAD = {"truncated": TRUNCATED, "trailing": TRAILING}

# name -> (generator, arguments), drawn by each package's own copy
OMP_MATRICES = {
    "powerlaw": ("powerlaw_csr", dict(m=1500, n=1200, seed=21)),
    "banded": ("banded_csr", dict(m=2000, row_nnz=9, bandwidth=64, seed=1)),
    "amazon": ("amazon_csr", dict(m=3000, seed=6)),
}


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's two libraries, built from ``native/`` with its
    Makefile's flags into a temporary directory."""
    make = (ROOT / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    out = tmp_path_factory.mktemp("jax_native")
    libs = {}
    for src, lib, extra in (("mtx_parser.cpp", "libmtxparser.so", []),
                            ("spmv_omp.cpp", "libspmvomp.so", ["-fopenmp"])):
        libs[lib] = out / lib
        subprocess.run(["g++", *flags, *extra, "-o", str(libs[lib]),
                        str(ROOT / "native" / src)], check=True,
                       capture_output=True, timeout=300)
    return libs


@pytest.fixture
def jax_bindings(jax_libs, monkeypatch):
    """Point the JAX package's bindings at :func:`jax_libs`."""
    for mod, lib in ((jax_native, "libmtxparser.so"),
                     (jax_omp, "libspmvomp.so")):
        monkeypatch.setattr(mod, "_LIB_PATH", str(jax_libs[lib]))
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    assert jax_native.available() and jax_omp.available()


@pytest.fixture
def mtx(tmp_path):
    def write(text, name="m.mtx"):
        path = tmp_path / name
        path.write_text(text)
        return str(path)
    return write


def _same_coo(a, b):
    assert (a.nrows, a.ncols, str(a.banner)) == (b.nrows, b.ncols,
                                                 str(b.banner))
    for field in ("row", "col", "val"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def _same_csr(a, b):
    assert (a.name, a.m, a.n, a.nnz) == (b.name, b.m, b.n, b.nnz)
    for field in ("irp", "ja", "as_"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_native_sources_are_the_jax_packages():
    """The port's native sources are the JAX package's, comment lines
    aside."""
    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.lstrip().startswith("//")]
    for name in _kernels.NATIVE:
        assert code(_kernels.NATIVE_DIR / f"{name}.cpp") == \
            code(ROOT / "native" / f"{name}.cpp"), name


def test_native_libraries_build_into_the_ports_build_dir():
    assert native.available() and native_omp.available()
    for lib in (native._lib, native_omp._lib):
        path = Path(lib._name)
        assert path.parent == _kernels.BUILD_DIR
        assert path.parent != ROOT / "native"
    assert _kernels.native_library_path("spmv_omp").exists()


@pytest.mark.parametrize("kind", sorted(GOOD))
def test_native_parser_matches_the_jax_one_and_mmio(jax_bindings, mtx,
                                                    kind):
    path = mtx(GOOD[kind])
    got = native.read_mtx(path)
    _same_coo(got, jax_native.read_mtx(path))
    _same_coo(got, mmio.read(path))


@pytest.mark.parametrize("kind", sorted(BAD))
def test_native_parser_refuses_as_the_jax_one(jax_bindings, mtx, kind):
    path = mtx(BAD[kind])
    with pytest.raises(errors.MatrixFormatError) as mine:
        native.read_mtx(path)
    with pytest.raises(jax_errors.MatrixFormatError) as theirs:
        jax_native.read_mtx(path)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(errors.MatrixFormatError):
        loader.load_csr(path, use_native=True)


@pytest.mark.parametrize("kind", sorted(GOOD))
def test_load_csr_use_native_equals_numpy(mtx, kind):
    path = mtx(GOOD[kind], f"{kind}.mtx")
    before = native.PARSES
    a = loader.load_csr(path, use_native=True)
    assert native.PARSES == before + 1
    _same_csr(a, loader.load_csr(path, use_native=False))
    assert native.PARSES == before + 1
    _same_csr(a, loader.load_csr(path))              # auto: native
    assert native.PARSES == before + 2


def test_load_csr_use_native_raises_where_it_is_unavailable(mtx,
                                                            monkeypatch):
    path = mtx(GENERAL)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)       # the build failed
    assert not native.available()
    with pytest.raises(RuntimeError, match="not available"):
        loader.load_csr(path, use_native=True)
    _same_csr(loader.load_csr(path), loader.load_csr(path,
                                                     use_native=False))


def test_native_parser_on_a_large_file(tmp_path):
    """A 40,000-entry file written by the port's writer parses to the
    matrix it was written from."""
    A = synth.amazon_csr(m=8000, seed=3)
    path = tmp_path / "amazon8k.mtx"
    mmio.write(path, A.m, A.n, A.row_ids(), A.ja, A.as_)
    got = loader.load_csr(str(path), use_native=True)
    np.testing.assert_array_equal(got.irp, A.irp)
    np.testing.assert_array_equal(got.ja, A.ja)
    np.testing.assert_array_equal(got.as_, A.as_)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_cache(mtx, tmp_path, writer,
                                             monkeypatch):
    path = mtx(SYMMETRIC, "sym.mtx")
    cdir = str(tmp_path / "cache")
    assert cache.cache_path(path, cdir) == jax_cache.cache_path(path, cdir)
    assert cache.CACHE_VERSION == jax_cache.CACHE_VERSION
    if writer == "port":
        A = cache.load_csr_cached(path, cache_dir=cdir)
    else:
        A = jax_cache.load_csr_cached(path, cache_dir=cdir, use_native=False)

    def no_parse(*_, **__):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(loader, "load_csr", no_parse)
    monkeypatch.setattr(jax_loader, "load_csr", no_parse)
    mine = cache.load_csr_cached(path, cache_dir=cdir)
    theirs = jax_cache.load_csr_cached(path, cache_dir=cdir)
    _same_csr(mine, theirs)
    _same_csr(mine, A)
    assert mine.name == "sym"


@pytest.mark.parametrize("name", sorted(OMP_MATRICES))
def test_omp_kernels_bit_equal_to_the_jax_ones(jax_bindings, name):
    fn, kw = OMP_MATRICES[name]
    A, Aj = getattr(synth, fn)(**kw), getattr(jax_synth, fn)(**kw)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    E = csr_to_ell(A, slice_h=32, col_major=True, pad_mode="last")
    Ej = jax_csr_to_ell(Aj, slice_h=32, col_major=True, pad_mode="last")
    pairs = [(native_omp.make_csr_serial(A), jax_omp.make_csr_serial(Aj))]
    for nt in (1, 2, 4):
        pairs += [(native_omp.make_csr_omp_guided(A, nt),
                   jax_omp.make_csr_omp_guided(Aj, nt)),
                  (native_omp.make_csr_omp_nnz(A, nt),
                   jax_omp.make_csr_omp_nnz(Aj, nt)),
                  (native_omp.make_ell_omp(E, nt),
                   jax_omp.make_ell_omp(Ej, nt))]
    for mine, theirs in pairs:
        y = mine(x)
        np.testing.assert_array_equal(y, theirs(x))
        rel = np.linalg.norm(y - gold) / np.linalg.norm(gold)
        assert rel <= ORACLE_REL_L2


@pytest.mark.parametrize("strategy", ["omp-csr-guided", "omp-csr-nnz",
                                      "omp-ell"])
def test_omp_strategies_match_the_oracle(strategy):
    A = synth.powerlaw_csr(1500, 1200, seed=21)
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    spec = get_strategy(strategy)
    assert (spec.backend, spec.ref) == ("host", strategy)
    for nt in (1, 4):
        prep = spec.prepare(A, nthreads=nt)
        assert prep.device.type == "cpu" and prep.meta["num_threads"] == nt
        y = prep.fn(x)
        assert np.linalg.norm(y - gold) / np.linalg.norm(gold) <= \
            ORACLE_REL_L2
    with pytest.raises(ValueError, match="shape"):
        prep.fn(x[:-1])


def test_omp_strategies_refuse_without_the_library(monkeypatch):
    monkeypatch.setattr(native_omp, "_lib", None)
    monkeypatch.setattr(native_omp, "_tried", True)
    A = synth.banded_csr(64, row_nnz=4, bandwidth=16)
    for name in ("omp-csr-guided", "omp-csr-nnz", "omp-ell"):
        with pytest.raises(ValueError, match="unavailable"):
            get_strategy(name).prepare(A)


def test_native_build_failure_reports_the_compiler(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's words and leaves
    no library behind; the bindings then report the library
    unavailable."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "mtx_parser.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_kernels, "NATIVE_DIR", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g[+][+] failed to build "
                                           "native/mtx_parser.cpp"):
        _kernels.build_native("mtx_parser")
    assert not any((tmp_path / "_build").iterdir())
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()

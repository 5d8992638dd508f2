"""The hybrid's big tail through every reference ``tail_strategy``
(spmv_scpa_tpu_torch/ops/lane_ell.py: ``COMPACT_TAILS``,
``compact_strategy``): the names whose compact branch runs in the JAX
package's ``prepare_lane_ell_hybrid`` (lane_ell.py:1563-1590) run in the
port through the strategy that holds each name as its ``ref``, on both
core layouts; every other name is refused at prepare time with a
``ValueError`` that says what the reference does with it.

The matrix is the one the reference's names were tried on:
``amazon_csr(m=20000, avg_nnz=4.7, seed=4)`` with ``ext=False``,
``diag="nochips"`` and ``tail_xla_max=1000`` (a 3,091-entry tail), the
JAX side in interpret mode on the CPU.

Tolerances: tail_nnz, the tail's route and its meta (the reference's
keys, on the reference's layouts: ``pell_layout="tiles"``) against JAX:
exact; y (the plain versions) against
the JAX y: f32 rel-L2 <= 1e-5, and against ``spmv_oracle``: rel-L2 <=
1e-6 and ``validate_result``. The PELL and XPOSE tails' y is held
against the JAX y on this matrix in tests/test_torch_big_tail.py (the
JAX side's interpret-mode call is most of this file's time), so here
against the oracle only.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_scpa_tpu import testing as jax_synth
from spmv_scpa_tpu.ops.lane_ell import prepare_lane_ell_hybrid as jax_prepare

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import lane_ell
from spmv_scpa_tpu_torch.ops.oracle import spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import by_ref, to_numpy
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

VS_JAX_REL_L2 = 1e-5
VS_ORACLE_REL_L2 = 1e-6
SPEC, KNOBS = cases.BIG_TAIL
# the reference's route names that are not strategy names -> the port's
ROUTES = {"xla-compact": "torch-compact"}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.cache
def _matrix():
    A = cases.make(SPEC)
    x = make_x(A.n)
    return A, x, spmv_oracle(A, x)


# held against the JAX y in tests/test_torch_big_tail.py
ELSEWHERE = ("pallas-pell", "pallas-xpose")


@functools.cache
def _jax(name):
    """The JAX hybrid's meta with this tail, and its y (None for the
    names of ``ELSEWHERE``)."""
    A = cases.make(SPEC, jax_synth)
    prep = jax_prepare(A, tail_strategy=name, interpret=True, **KNOBS)
    return prep.meta, (None if name in ELSEWHERE else
                       np.asarray(prep.fn(_matrix()[1]), np.float64))


def _port_names(v):
    """A JAX meta value with the reference's strategy and route names
    mapped to the port's (``compact-<name>`` too), nested meta included."""
    if isinstance(v, dict):
        return {k: _port_names(w) for k, w in v.items()}
    if isinstance(v, str):
        if v in ROUTES:
            return ROUTES[v]
        head, _, ref = v.rpartition("compact-") if v.startswith(
            "compact-") else ("", "", v)
        spec = by_ref(ref)
        if spec is not None:
            return head + "compact-" * v.startswith("compact-") + spec.name
    return v


def test_the_names_that_run_and_those_refused_cover_the_reference():
    from spmv_scpa_tpu.ops.registry import list_strategies
    named = (set(lane_ell.COMPACT_TAILS) | set(lane_ell.REFUSED_TAILS)
             | set(lane_ell.FP64_GRADES) | {"pallas-hybrid"})
    assert named == set(list_strategies())
    assert not set(lane_ell.COMPACT_TAILS) & set(lane_ell.REFUSED_TAILS)


CORE = {"rows": "lane_rows", "lanes": "lane_ell_spmv"}


@pytest.mark.parametrize("core_layout", lane_ell.CORE_LAYOUTS)
@pytest.mark.parametrize("name", lane_ell.COMPACT_TAILS)
def test_compact_tail_matches_jax_and_oracle(name, core_layout):
    A, x, gold = _matrix()
    prep = lane_ell.prepare_lane_ell_hybrid(
        A, device="cpu", tail_strategy=name, core_layout=core_layout,
        **KNOBS)
    jmeta, y_jax = _jax(name)
    port = by_ref(name).name
    assert prep.meta["tail_nnz"] == jmeta["tail_nnz"] == 3091
    kind = prep.meta["tail_kind"]
    assert kind.startswith(f"compact-{port}")
    assert jmeta["tail_kind"] == f"compact-{name}"
    y = to_numpy(prep.fn(x))
    assert y_jax is None or _rel(y, y_jax) <= VS_JAX_REL_L2
    assert _rel(y, gold) <= VS_ORACLE_REL_L2
    validate_result(gold, y, what=f"cuda-hybrid, {name} tail, "
                    f"{core_layout} core")
    # the tail's rows land once: the core and the landing are the call's
    # only kernel calls but the tail strategy's own
    xf = torch.as_tensor(x, dtype=torch.float32)
    calls = [k for k, _ in prep.kernel_calls(xf)]
    assert calls[0] == CORE[core_layout]
    assert calls[-1] == "heavy_land"
    assert np.array_equal(to_numpy(prep.plain(x)), y)


@pytest.mark.parametrize("name", lane_ell.COMPACT_TAILS)
def test_compact_tail_meta_matches_jax_on_its_layouts(name):
    """On the reference's layouts the tail's meta holds each of the
    reference's keys at its value, but XPOSE's ``x_bytes``, which counts
    the port's own x table (as in tests/test_torch_big_tail.py)."""
    A, *_ = _matrix()
    prep = lane_ell.prepare_lane_ell_hybrid(
        A, device="cpu", tail_strategy=name, pell_layout="tiles",
        xpose_s3="prefix", **KNOBS)
    jmeta, _ = _jax(name)
    assert prep.meta["tail_kind"] == _port_names(jmeta["tail_kind"])
    want = _port_names(jmeta["tail_meta"])
    got = prep.meta["tail_meta"]
    missing = {k: v for k, v in want.items() if got.get(k, object()) != v
               and not (name == "pallas-xpose" and k == "x_bytes")}
    assert not missing, (missing, got)


@pytest.mark.parametrize("name", sorted(lane_ell.REFUSED_TAILS))
def test_other_names_are_refused_at_prepare(name):
    A, *_ = _matrix()
    with pytest.raises(ValueError, match="the reference prepares the tail "
                                         "and fails at its first call"):
        lane_ell.prepare_lane_ell_hybrid(A, device="cpu",
                                         tail_strategy=name, **KNOBS)
    # a tail under tail_xla_max never reaches the big-tail branch
    prep = lane_ell.prepare_lane_ell_hybrid(
        A, device="cpu", tail_strategy=name,
        **{**KNOBS, "tail_xla_max": 32768})
    assert prep.meta["tail_kind"] == "torch-compact"


def test_an_unknown_name_is_refused_at_prepare():
    A, *_ = _matrix()
    with pytest.raises(ValueError, match="not one of its strategies"):
        lane_ell.prepare_lane_ell_hybrid(A, device="cpu",
                                         tail_strategy="cuda-pell", **KNOBS)

"""spmv_scpa_tpu_torch — the PyTorch and CUDA port of ``spmv_scpa_tpu``.

The JAX package beside it is the reference each slice is held against:
the same matrix gives the same y within f32 tolerance, both pass
``validate_result`` against ``spmv_oracle``, and the ported host
packer produces the same arrays. Every Pallas kernel of the reference
becomes a hand-written Hopper kernel (``csrc/``, built by nvcc for
``sm_90a`` on first use, see ``_kernels.py``) with a plain PyTorch
version beside it.

``spmv(A, x)`` on a matrix with diagonal locality runs the lane-ELL
hybrid (``cuda-hybrid``): its core, the ext gather route for
out-of-window entries and the chips tail for spilled rows. Beside it
sit PELL, BCSR and XPOSE, the fp64 grade (``cuda-hybrid-fp64``,
``cuda-pell-fp64``: x and y float64), the BCSR SpMM
(``cuda-bcsr-spmm``), the baselines, CUDA-event timing and the
stream-probe roofline. ``python -m spmv_scpa_tpu_torch.cli`` is the
JAX package's benchmark CLI on the card (``bench/runner.py``, the three
CSVs of ``bench/logger.py``, the native parser and OpenMP kernels).
The port imports nothing of the JAX package: the host modules it needs
(CSR, loader, synthetic matrices, oracle, validation) are its own
copies, held equal to the originals by the tests.
"""

from spmv_scpa_tpu_torch.io.loader import load_csr
from spmv_scpa_tpu_torch.ops import registry as _registry
from spmv_scpa_tpu_torch.ops.registry import (
    get_strategy,
    list_strategies,
    spmv,
)

# The built-in strategies' modules load with the package, not inside the
# first get_strategy, whose caller may be timing a prepare.
_registry._ensure_builtin()

__all__ = ["load_csr", "spmv", "get_strategy", "list_strategies"]

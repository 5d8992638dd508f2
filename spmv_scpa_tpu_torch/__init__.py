"""spmv_scpa_tpu_torch — the PyTorch and CUDA port of ``spmv_scpa_tpu``.

The JAX package beside it is the reference each slice is held against:
the same matrix gives the same y within f32 tolerance, both pass
``validate_result`` against ``spmv_oracle``, and the ported host
packer produces the same arrays. Every Pallas kernel of the reference
becomes a hand-written Hopper kernel (``csrc/``, built by nvcc for
``sm_90a`` on first use, see ``_kernels.py``) with a plain PyTorch
version beside it.

This slice is the main path: ``spmv(A, x)`` on a matrix with diagonal
locality through the lane-ELL hybrid (``cuda-hybrid``), the baselines,
CUDA-event timing and the stream-probe roofline. JAX-free host modules
of the reference (CSR, loader, synthetic matrices, oracle, validation)
are imported from it, not copied.
"""

from spmv_scpa_tpu.io.loader import load_csr
from spmv_scpa_tpu_torch.ops.registry import (
    get_strategy,
    list_strategies,
    spmv,
)

__all__ = ["load_csr", "spmv", "get_strategy", "list_strategies"]

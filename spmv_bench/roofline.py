"""The table of peaks and the format-free bound of one call.

The bound is the least time any implementation could take for the
call's work on the card: the larger of its bytes over the card's
published memory bandwidth and its operations over the card's published
rate in the configuration's precision (float32, or float64 outside the
tensor cores). The bytes are A's values read once and X and Y once
each, at the precision's item size (4 B for float32, 8 B for float64);
the structure counts no byte, since a packed layout may encode it in
less than any fixed count. The bound therefore reads the same work
whatever layout or kernel does it, and no sound implementation can pass
100% of it.
"""

from __future__ import annotations

import numpy as np

# torch.cuda.get_device_name() -> published peaks (NVIDIA's H100 SXM5
# data sheet, dense rates, at the full 700 W power limit): the memory
# bandwidth, and the rate of each precision outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "flops": {"float32": 67e12, "float64": 34e12}},
}


def call_bytes(nnz: int, m: int, n: int, cols: int,
               itemsize: int = 4) -> int:
    """A's values once, X (n, cols) and Y (m, cols) once, ``itemsize``
    bytes each (4: float32)."""
    return itemsize * (nnz + (n + m) * cols)


def call_flops(nnz: int, cols: int) -> int:
    return 2 * nnz * cols


def bound_ms(kind: str, nnz: int, m: int, n: int, cols: int,
             dtype=np.float32):
    """The format-free bound in milliseconds on the card ``kind`` for a
    call whose values, X and Y are ``dtype`` (float32 or float64), or
    None for a card without published peaks in :data:`PEAKS`."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    dtype = np.dtype(dtype)
    return 1e3 * max(
        call_bytes(nnz, m, n, cols, dtype.itemsize) / peak["bytes_per_s"],
        call_flops(nnz, cols) / peak["flops"][dtype.name])

"""The table of peaks and the format-free bound of one call.

The bound is the least time any implementation could take for the
call's work on the card: the larger of its bytes over the card's
published memory bandwidth and its operations over the card's published
float32 rate. The bytes are A's values read once (4 B each, float32)
and X and Y once each; the structure counts no byte, since a packed
layout may encode it in less than any fixed count. The bound therefore
reads the same work whatever layout or kernel does it, and no sound
implementation can pass 100% of it.
"""

from __future__ import annotations

# torch.cuda.get_device_name() -> published peaks (NVIDIA's H100 SXM5
# data sheet, dense rates, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flops": 67e12},
}

VALUE_BYTES = 4      # float32


def call_bytes(nnz: int, m: int, n: int, cols: int) -> int:
    """A's values once, X (n, cols) and Y (m, cols) once, in float32."""
    return VALUE_BYTES * (nnz + (n + m) * cols)


def call_flops(nnz: int, cols: int) -> int:
    return 2 * nnz * cols


def bound_ms(kind: str, nnz: int, m: int, n: int, cols: int):
    """The format-free bound in milliseconds on the card ``kind``, or
    None for a card without published peaks in :data:`PEAKS`."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return 1e3 * max(call_bytes(nnz, m, n, cols) / peak["bytes_per_s"],
                     call_flops(nnz, cols) / peak["f32_flops"])

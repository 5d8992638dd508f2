"""The format-free bound of each stage of ``cuda-xpose`` and each stage's
device time, for the per-layer metrics of a cell that names that
strategy.

The stages are ``s1`` (kernel ``xpose_s1_slots``: each entry's product
``x[col] * value`` stored at its slot of the product array) and ``s3``
(kernel ``xpose_s3_rows``: each row of y as the sum of its products).
Their bytes, as in ``roofline.py``, count what the data needs and no
structure, since a packed layout may encode it in less than any fixed
count: S1 reads A's values and x once and writes one 4-byte product an
entry; S3 reads one product an entry and writes y. Operations: one
multiply an entry (S1), one add an entry (S3). Float32 only, the
strategy's precision.
"""

from __future__ import annotations

from spmv_bench import roofline

# stage -> the name of its kernel on the device (the profiler's, without
# namespace and arguments: ``trace.short_name``)
KERNELS = {"s1": "s1_slots_kernel", "s3": "s3_rows_kernel"}
ITEM = 4


def stage_bytes(stage: str, nnz: int, m: int, n: int) -> int:
    if stage == "s1":
        return ITEM * (nnz + n + nnz)
    if stage == "s3":
        return ITEM * (nnz + m)
    raise ValueError(f"no XPOSE stage {stage!r}; one of {sorted(KERNELS)}")


def stage_flops(stage: str, nnz: int) -> int:
    if stage not in KERNELS:
        raise ValueError(f"no XPOSE stage {stage!r}; one of {sorted(KERNELS)}")
    return nnz


def bound_ms(kind: str, stage: str, nnz: int, m: int, n: int):
    """The stage's bound in milliseconds on the card ``kind``, None for a
    card without published peaks (``roofline.PEAKS``)."""
    peak = roofline.PEAKS.get(kind)
    if peak is None:
        return None
    return 1e3 * max(stage_bytes(stage, nnz, m, n) / peak["bytes_per_s"],
                     stage_flops(stage, nnz) / peak["flops"]["float32"])


def stage_ms(run, stage: str):
    """The stage kernel's device milliseconds a call: the call's device
    time (``run.device_ms()``) times that kernel's share of the profiler
    window's busy seconds. None off the card, where the window did not
    see every launch, or where the kernel is not in its breakdown (a
    program or a strategy without it)."""
    prof = run.profile()
    if prof is None or not prof["whole"] or not prof["busy_s"]:
        return None
    name = KERNELS[stage]
    seconds = sum(s for op, s in prof["breakdown"]["device_ops"]
                  if name in op)
    ms = run.device_ms()
    if not seconds or not ms:
        return None
    return ms * seconds / prof["busy_s"]


def stage_roofline(run, stage: str):
    """The stage's bound over its device time, in %."""
    ms = stage_ms(run, stage)
    if ms is None:
        return None
    mat = run.mat
    bound = bound_ms(run.kind, stage, mat.nnz, mat.m, mat.n)
    return None if bound is None else 100.0 * bound / ms

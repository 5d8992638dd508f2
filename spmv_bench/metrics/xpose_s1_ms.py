"""Device milliseconds a call of ``cuda-xpose``'s stage S1, kernel
``xpose_s1_slots``: the call's ``device_ms`` times the kernel's share of
the profiler window's busy seconds (``xpose_roofline.stage_ms``). None
off the card, where the window did not see every launch, or where the
kernel did not run."""

from spmv_bench import xpose_roofline


def read(run):
    return xpose_roofline.stage_ms(run, "s1")

"""Stage S1's format-free bound (``xpose_roofline.bound_ms``) over its
device milliseconds a call (``xpose_s1_ms``), in %: no sound
implementation of the stage can pass 100."""

from spmv_bench import xpose_roofline


def read(run):
    return xpose_roofline.stage_roofline(run, "s1")

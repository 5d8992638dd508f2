"""Host seconds of ``cuda-xpose``'s plan (``xpose.plan_or_raise``: the
step assignment, the edge colorings and the routing planes): the
outermost ``pack.plan`` spans under the run's ``prepare`` root span,
summed (``spans.pack_seconds``)."""

from spmv_bench import spans


def read(run):
    return spans.pack_seconds(run, "pack.plan")

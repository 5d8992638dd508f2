"""Host seconds of the pack's layout, building the tables the kernel
reads: the outermost ``pack.layout`` spans under the run's ``prepare``
root span, summed (``spans.pack_seconds``)."""

from spmv_bench import spans


def read(run):
    return spans.pack_seconds(run, "pack.layout")

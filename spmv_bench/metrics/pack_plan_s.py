"""Host seconds of the pack's plan, deciding where each of A's entries
goes: the outermost ``pack.plan`` spans under the run's ``prepare`` root
span, summed (``spans.pack_seconds``)."""

from spmv_bench import spans


def read(run):
    return spans.pack_seconds(run, "pack.plan")

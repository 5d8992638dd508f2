"""Host seconds of the pack's upload, the tables' copies to the device:
the outermost ``pack.upload`` spans under the run's ``prepare`` root
span, summed (``spans.pack_seconds``)."""

from spmv_bench import spans


def read(run):
    return spans.pack_seconds(run, "pack.upload")

"""Host seconds of loading the port's kernel libraries before the
window: every ``kernels.load`` span of the process, a library's first
load, its build by nvcc among it where the library was not built yet
(``spans.before_window_seconds``). None where no kernel was loaded."""

from spmv_bench import spans


def read(run):
    return spans.before_window_seconds(run, "kernels.load")

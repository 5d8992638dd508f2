"""Host milliseconds of one call inside the port: after the window, with
the port's call spans on, calls back to back (the X in turn) in blocks
until the host clock spans a quarter of a second
(``timing.host_enqueue_ms``); the median ``call`` span
(``spans.median_call_ms``). None off the card."""

from spmv_bench import spans, timing


def read(run):
    if not run.on_card:
        return None
    return spans.median_call_ms(
        run, lambda: timing.host_enqueue_ms(run.fn, run.xs))

"""The device's idle share of the profiler's window of calls back to
back, in %: 1 less its operations' busy seconds (the union of their
intervals) over the window's wall seconds (``trace.profile_window``,
without the timed window's event pairs, whose own gaps would read as
idle). None where no profiler window saw every launch: a window that
lost kernel events would read idle what was busy."""


def read(run):
    prof = run.profile()
    if prof is None or not prof["whole"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

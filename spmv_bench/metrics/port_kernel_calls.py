"""The port's kernel launches a call: its launch counters over both
timed windows, divided by their calls."""


def read(run):
    if run.calls == 0:
        return None
    return run.launches / run.calls

"""2·nnz·cols for every call of the rate's window, over that window's
wall seconds (the first call's issue to the return of the closing
synchronisation), in GFLOP/s. The window records nothing but the calls,
so no timing event's own device time enters the rate."""


def read(run):
    if not run.on_card:
        return None
    flops = 2.0 * run.mat.nnz * run.cols * run.rate_calls
    return flops / run.rate_wall_s / 1e9

"""Host milliseconds to enqueue one call, over calls back to back
without a synchronisation (``timing.host_enqueue_ms``)."""


def read(run):
    return run.host_enqueue_ms()

"""The device's milliseconds for one call alone: the median over 20 blocks
of 10 calls, each block between one pair of events, with the stream held
until all are queued (``timing.time_device``)."""


def read(run):
    return run.device_ms()

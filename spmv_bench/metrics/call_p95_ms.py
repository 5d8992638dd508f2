"""The 95th percentile of the tail's window's calls' event-pair spans, in
ms: each call of that window is bracketed by its own pair of events on
the stream, so where the host is the slower side its enqueue enters the
span."""

import numpy as np


def read(run):
    if not run.on_card or run.spans_ms.size == 0:
        return None
    return float(np.percentile(run.spans_ms, 95))

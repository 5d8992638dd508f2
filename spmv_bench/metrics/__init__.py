"""One reader a metric: ``metrics/<name>.py`` has ``read(run) -> float |
None`` over a ``harness.Run``; None leaves the metric out of the line
(a reader that finds nothing to read, or a device number off the card).
"""

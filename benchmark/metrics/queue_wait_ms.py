"""Batcher: the mean wait of an enqueued request before its flush, in ms,
from the daemon's stage histogram (stage ``queue_wait``)."""


def read(run):
    c, s = run["counters"]["stages"]["queue_wait"]
    return s / c * 1e3 if c > 0 else None

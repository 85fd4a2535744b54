"""Batcher: the items the window sent over the flushes that carried them."""


def read(run):
    f = run["counters"]["flushes"]
    return run["items"] / f if f > 0 else None

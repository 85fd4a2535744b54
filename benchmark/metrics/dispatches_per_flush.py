"""Engine host loop: decide dispatches (``LocalEngine.stats.dispatches``)
over the batcher's flushes in the window."""


def read(run):
    c = run["counters"]
    return c["dispatches"] / c["flushes"] if c["flushes"] > 0 else None

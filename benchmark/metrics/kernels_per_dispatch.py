"""Decide dispatch: kernels the device ran in the profiled slice over the
engine's dispatches in the same slice."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["counters"]["dispatches"] <= 0:
        return None
    return tr["kernels"] / tr["counters"]["dispatches"]

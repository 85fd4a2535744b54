"""Device: percent of the profiled slice in which no device operation ran
(one minus the union of kernel, copy and set intervals over the slice)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

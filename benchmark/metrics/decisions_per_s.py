"""The served rate: items answered without an error by the requests that
completed inside the window, over the window's seconds (all the work over
all the time)."""

from benchmark.yardstick import rate


def read(run):
    return rate(run["answered_in_window"], run["seconds"])

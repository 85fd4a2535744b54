"""Runner: the mean host time of a flush's ``issue`` stage (the engine
thread's launches and the outputs' copy), in ms, from the daemon's stage
histogram."""


def read(run):
    c, s = run["counters"]["stages"]["issue"]
    return s / c * 1e3 if c > 0 else None

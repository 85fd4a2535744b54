"""Front door: the mean host time of a request's ``parse`` plus its
``encode`` stage, in ms, from the daemon's stage histogram (sums and
counts over the window)."""


def read(run):
    st = run["counters"]["stages"]
    (cp, sp), (ce, se) = st["parse"], st["encode"]
    if cp <= 0 or ce <= 0:
        return None
    return (sp / cp + se / ce) * 1e3

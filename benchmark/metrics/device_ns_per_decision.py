"""The card's time a decision costs: the seconds in which a device
operation ran (the union of kernel, copy and set intervals) while the
window's requests were served, from the first request to the last
answer, over the items those requests had answered without an error, in
ns."""


def read(run):
    tr = run["trace"]
    if tr is None or run["answered"] <= 0 or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] / run["answered"] * 1e9

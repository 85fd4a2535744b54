"""Kernels: percent of the HBM roofline. The least time the profiled
slice's decisions need at the data sheet's 3.35 TB/s (each item's request
read and response written once, each key's 64 B state row read and
written once; ``yardstick.decide_bytes``) over the summed time of every
device operation in the slice."""

from benchmark.yardstick import decide_bytes, roofline_share


def read(run):
    tr = run["trace"]
    if tr is None or tr["items"] <= 0 or tr["device_op_s"] <= 0:
        return None
    return roofline_share(decide_bytes(tr["items"], tr["distinct_keys"]), tr["device_op_s"])

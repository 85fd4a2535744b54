"""The benchmark's arithmetic: peaks, the work a decision needs, and the
statistics of a window. Later changes to the program are measured against
these, so they count what the requests need, never what an implementation
happens to do.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12

# one decided item, as the request and the response carry it: the key's
# 8-byte fingerprint, hits, limit, duration, burst and created_at (8 bytes
# each) and algorithm and behavior (4 each) read once; status (4), limit,
# remaining and reset_time (8 each) written once
REQUEST_BYTES = 8 + 8 + 8 + 8 + 8 + 8 + 4 + 4
RESPONSE_BYTES = 4 + 8 + 8 + 8
# the key's canonical state row, read once and written once
STATE_ROW_BYTES = 64


def decide_bytes(items: int, distinct_keys: int) -> int:
    """Bytes the decisions of `items` items over `distinct_keys` keys need
    at the least: each item's request read and response written once, and
    each key's 64 B state row read and written once."""
    return items * (REQUEST_BYTES + RESPONSE_BYTES) + distinct_keys * 2 * STATE_ROW_BYTES


def roofline_share(nbytes: int, device_s: float) -> float:
    """Percent of the HBM roofline: the least time the bytes need at the
    data sheet's rate over the device time spent."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values by nearest rank: the
    smallest value with at least q% of the values at or below it."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(v[max(0, math.ceil(q / 100.0 * v.size) - 1)])


def rate(count: float, seconds: float) -> float:
    """All the work over all the time."""
    return float(count) / float(seconds)

"""Front door: the 99th percentile (nearest rank) of every request the
window sent, timed by the benchmark's clock around each
``get_rate_limits_raw`` call, in ms."""

from benchmark.yardstick import percentile


def read(run):
    lat = run["latency_s"]
    return percentile(lat, 99.0) * 1e3 if lat.size else None

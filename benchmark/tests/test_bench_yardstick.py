"""The metric arithmetic: rate over the whole window, the percentile of
all requests, the roofline's byte count, the readers, and the reduction
of a profiled slice."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import devtrace, yardstick
from benchmark.registry import Registry


def test_rate_is_all_the_work_over_all_the_time():
    assert yardstick.rate(2_500_000, 10.0) == 250_000.0


def test_percentile_is_nearest_rank_over_all_values():
    v = np.arange(1, 201, dtype=np.float64)  # 1..200
    assert yardstick.percentile(v, 99) == 198.0
    assert yardstick.percentile(v, 50) == 100.0
    assert yardstick.percentile([5.0], 99) == 5.0
    # one stall among many fast requests shows at p99 once it is >1% of them
    lat = np.r_[np.full(97, 0.01), np.full(3, 2.0)]
    assert yardstick.percentile(lat, 99) == 2.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 99)


def test_decide_bytes_count_requests_and_keys_not_kernels():
    # 56 B of request and 28 B of response an item, 128 B a distinct key
    assert yardstick.decide_bytes(1, 1) == 56 + 28 + 128
    assert yardstick.decide_bytes(1000, 10) == 1000 * 84 + 10 * 128
    one_ms = yardstick.HBM_BYTES_PER_S * 1e-3
    assert yardstick.roofline_share(int(one_ms), 2e-3) == pytest.approx(50.0)


def _run(**kw):
    st = {s: (0.0, 0.0) for s in ("parse", "queue_wait", "put", "issue", "fetch", "encode")}
    st.update(parse=(100, 0.2), encode=(100, 0.1), queue_wait=(400, 2.0), issue=(10, 0.5))
    run = {"latency_s": np.linspace(0.1, 1.0, 100), "items": 120_000,
           "answered_in_window": 110_000, "answered": 119_000, "seconds": 10.0,
           "setup_s": 31.5,
           "counters": {"stages": st, "flushes": 10, "dispatches": 12},
           "trace": {"kernels": 1400, "counters": {"dispatches": 10}, "items": 50_000,
                     "distinct_keys": 40_000, "device_op_s": 0.01, "busy_s": 0.01,
                     "window_s": 2.0}}
    run.update(kw)
    return run


def test_readers_read_their_numbers():
    reg = Registry()
    got = {m["name"]: reg.reader(m["name"])(_run())
           for m in reg.bench["per_layer"] + reg.bench["end_to_end"]}
    assert got["request_p99_ms"] == pytest.approx(1000 * np.linspace(0.1, 1.0, 100)[98])
    assert got["parse_encode_ms"] == pytest.approx(3.0)
    assert got["rows_per_flush"] == 12_000
    assert got["queue_wait_ms"] == pytest.approx(5.0)
    assert got["issue_ms"] == pytest.approx(50.0)
    assert got["dispatches_per_flush"] == pytest.approx(1.2)
    assert got["kernels_per_dispatch"] == 140
    want = 100 * (50_000 * 84 + 40_000 * 128) / 3.35e12 / 0.01
    assert got["decide_roofline"] == pytest.approx(want)
    assert got["device_idle_pct"] == pytest.approx(99.5)
    for name in ("rows_per_flush", "dispatches_per_flush", "kernels_per_dispatch",
                 "decide_roofline"):
        assert got[name + ".card"] == got[name]
    # the served rate: answers inside the window over its seconds
    assert got["decisions_per_s"] == got["served_decisions_per_s"] == 11_000.0
    # the card's busy seconds over every answered item of the window's requests
    assert got["device_ns_per_decision"] == pytest.approx(0.01 / 119_000 * 1e9)
    assert got["setup_s"] == 31.5


def test_readers_find_nothing_without_a_trace():
    reg = Registry()
    for name in ("kernels_per_dispatch", "decide_roofline", "device_idle_pct",
                 "device_ns_per_decision"):
        assert reg.reader(name)(_run(trace=None)) is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_slice_reduction_busy_union_and_labelled_gaps():
    # anchors at trace 1,000 us and 11,000 us = perf_counter 5.000 s and 5.010 s
    start = "void at::native::vectorized_elementwise_kernel<c10::complex<float>>"
    end = "void at::native::vectorized_elementwise_kernel<c10::complex<double>>"
    ev = [_ev("kernel", start, 1000.0, 1.0), _ev("kernel", end, 11000.0, 1.0),
          _ev("kernel", "k_a", 2000.0, 1000.0), _ev("kernel", "k_b", 2500.0, 1000.0),
          _ev("gpu_memcpy", "Memcpy HtoD", 6000.0, 500.0),
          _ev("kernel", "k_a", 10900.0, 500.0),  # clipped at the slice's end
          _ev("kernel", "k_out", 20000.0, 5.0),  # outside the slice
          _ev("cpu_op", "aten::add", 3000.0, 5.0)]
    stages = [("issue", 5.0035, 5.0060), ("encode", 5.0066, 5.0099)]
    r = devtrace.reduce(ev, [5.0, 5.010], stages)
    assert r["window_s"] == pytest.approx(0.010)
    assert r["busy_s"] == pytest.approx((1500 + 500 + 100) / 1e6)
    assert r["kernels"] == 3 and r["device_ops"] == 4
    assert r["device_op_s"] == pytest.approx((1000 + 1000 + 500 + 100) / 1e6)
    assert r["top_ops"][0][0] == "k_a"
    gaps = {round(s * 1e6): n for n, s in r["idle_gaps"]}
    assert gaps == {1000: "no host stage", 2500: "issue", 4400: "encode"}
    # either marker alone ties the clocks and bounds the slice
    for drop in (start, end):
        one = devtrace.reduce([e for e in ev if e["name"] != drop], [5.0, 5.010], stages)
        assert one["busy_s"] == pytest.approx(r["busy_s"])
        assert one["idle_gaps"] == r["idle_gaps"]


def test_slice_reduction_without_device_work_reads_nothing():
    mark = "void at::native::vectorized_elementwise_kernel<c10::complex<float>>"
    ev = [_ev("kernel", mark, 1000.0, 1.0)]
    assert devtrace.reduce(ev, [1.0, 1.001], []) is None
    assert devtrace.reduce([_ev("kernel", "k", 1000.0, 5.0)], [1.0, 1.001], []) is None

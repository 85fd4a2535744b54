"""A profiled window, reduced to numbers.

``torch.profiler`` (the CUDA activity alone: no host op is recorded, so
the program's threads run as they do untraced) records the window from
just before its first request to just after its last answer, while the
daemon is idle at both ends. Its results give every device operation
(kernels, copies, sets) with its start and length. Two marker kernels,
launched on a stream of their own at the slice's start and end, tie the
trace's clock to ``time.perf_counter``, so the host stages recorded by the
harness label the device's idle gaps.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the marker kernels' names hold their complex types; the program has none
MARKS = ("c10::complex<float>", "c10::complex<double>")  # the slice's start, end


class Slice:
    """Start, mark and stop one profiled slice."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._activities = [ProfilerActivity.CUDA]
        self._profile = profile
        self.prof = profile(activities=self._activities)
        self.side = torch.cuda.Stream()
        self.markers = [torch.zeros(1, dtype=t, device="cuda")
                        for t in (torch.complex64, torch.complex128)]
        self.anchors: List[float] = []
        self.stages: List[Tuple[str, float, float]] = []

    def warm(self) -> None:
        """Start and stop a profiler once, in set-up: the first start
        initialises the device tracer, which stalls the process."""
        with self._profile(activities=self._activities):
            self._mark(0)
            self._mark(1)
            self._torch.cuda.synchronize()

    def _mark(self, which: int) -> float:
        with self._torch.cuda.stream(self.side):
            self.markers[which].add_(1)
        return time.perf_counter()

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self.prof.start()
        self.anchors.append(self._mark(0))

    def stop(self) -> None:
        self.anchors.append(self._mark(1))
        self._torch.cuda.synchronize()
        self.prof.stop()

    def stage(self, name: str, t0: float, t1: float) -> None:
        """A host stage that ran from t0 to t1 (perf_counter seconds)."""
        self.stages.append((name, t0, t1))

    def events(self) -> list:
        """The slice's device operations as Chrome-trace events (``cat``,
        ``name``, ``ts`` and ``dur`` in us), read from the profiler's own
        results: no trace file is written or parsed. A device event is a
        copy or a set by its name (``Memcpy ...``, ``Memset ...``), else a
        kernel."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            cat = ("gpu_memcpy" if name.startswith("Memcpy") else
                   "gpu_memset" if name.startswith("Memset") else "kernel")
            out.append({"ph": "X", "cat": cat, "name": name,
                        "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3})
        return out


def union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the (N, 2) intervals `iv`."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    starts = iv[new, 0]
    ends = np.maximum.reduceat(iv[:, 1], np.nonzero(new)[0])
    return np.stack([starts, ends], axis=1)


def reduce(events: list, anchors: List[float], stages: List[Tuple[str, float, float]],
           top: int = 10) -> Optional[Dict]:
    """Numbers of a slice: its length, the device's busy time (the union
    of device operations), device operations and kernels counted, their
    summed time, the operations that took most time, and the longest idle
    gaps with the host stage that overlapped each most. `anchors` holds the
    host's clock (perf_counter s) at the start and end markers' launches;
    either marker found in the trace ties the clocks. None when the trace
    holds neither marker or no device operation."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and "dur" in e]
    found = [[float(e["ts"]) for e in dev if m in e.get("name", "")] for m in MARKS]
    dev = [e for e in dev if not any(m in e.get("name", "") for m in MARKS)]
    if len(anchors) < 2 or not (found[0] or found[1]):
        return None
    # perf_counter us = trace us + off, from the first marker the trace holds
    off = anchors[0] * 1e6 - found[0][0] if found[0] else anchors[1] * 1e6 - found[1][0]
    t0, t1 = anchors[0] * 1e6 - off, anchors[1] * 1e6 - off
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])] for e in dev],
                  np.float64).reshape(-1, 2)
    inside = (iv[:, 1] > t0) & (iv[:, 0] < t1) if iv.size else np.zeros(0, bool)
    dev = [e for e, k in zip(dev, inside) if k]
    iv = np.clip(iv[inside], t0, t1)
    if not dev:
        return None
    busy = union(iv)
    per_name: Dict[str, float] = {}
    for e, (a, b) in zip(dev, iv):
        per_name[e["name"][:96]] = per_name.get(e["name"][:96], 0.0) + (b - a)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:top]
    st = [(n, a * 1e6 - off, b * 1e6 - off) for n, a, b in stages]
    labelled = []
    for a, b in gaps:
        best, cover = "no host stage", 0.0
        for name in sorted({n for n, _, _ in st}):
            span = union(np.array([[max(x, a), min(y, b)] for n, x, y in st
                                   if n == name and y > a and x < b]).reshape(-1, 2))
            c = float((span[:, 1] - span[:, 0]).sum()) if span.size else 0.0
            if c > cover:
                best, cover = name, c
        labelled.append([best, (b - a) / 1e6])
    kernels = sum(1 for e in dev if e.get("cat") == "kernel")
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
        "device_ops": len(dev),
        "kernels": kernels,
        "device_op_s": float((iv[:, 1] - iv[:, 0]).sum()) / 1e6,
        "top_ops": [[n, s / 1e6] for n, s in ops],
        "idle_gaps": labelled,
        "perf_open": anchors[0],
        "perf_close": anchors[-1],
    }

"""Timing and reporting shared by the exp entry points and chip_smoke.py.

On the card a time is the median of CUDA-event intervals around
back-to-back calls queued behind a spin kernel (after a warm call); on the
CPU it is the host clock, and every result says which (``timer``), so a
CPU number is never read as a device time."""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_info(device: torch.device) -> dict:
    info = {"device": str(device),
            "timer": "cuda_events" if device.type == "cuda" else "host_clock"}
    if device.type == "cuda":
        info["card"] = torch.cuda.get_device_name(device)
    return info


SPIN_CYCLES = 20_000_000  # ≈ 10 ms of spinning on an H100


def events_ms(fn, reps: int = 7, inner: int = 5, queued: bool = True) -> float:
    """Median per-call time of `fn` in ms on the current CUDA device, from
    CUDA events around `inner` back-to-back calls, over `reps` repeats,
    after one warm call. With `queued`, each repeat first enqueues a spin
    kernel, so the calls queue behind it and the card runs them without
    waiting on the host's launches: the device time per call (unless `fn`
    synchronises inside, as ``torch.unique`` does; then it is the time per
    call). Without, the host paces the calls: the time a caller sees."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_ms(fn, device: torch.device, reps: int = 7, inner: int = 5) -> float:
    """Median per-call time of `fn` in ms over `reps` groups of `inner`
    back-to-back calls, after one warm call: the device time on the card
    (``events_ms``), the host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return events_ms(fn, reps, inner)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def randint32(gen: torch.Generator, shape, device: torch.device, low: int = -(2**31),
              high: int = 2**31) -> torch.Tensor:
    """Uniform int32 in [low, high) (high may be 2^31)."""
    return torch.randint(low, high, shape, dtype=torch.int64, device=device,
                         generator=gen).to(torch.int32)

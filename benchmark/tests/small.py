"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
the same code path as on the card (the daemon, its front door, the
engine's plain versions of the kernels), with fewer keys, slots,
submitters and items."""

from __future__ import annotations

import sys
import time

from benchmark import run
from benchmark.registry import Registry

SIZES = {
    "headline-batch1000": {"keys": 20_000, "slots": 1 << 15},
    "skew-batch1000": {"keys": 8_192, "slots": 1 << 14},
}


def small_cell(cell_name: str):
    reg = Registry()
    cell = reg.cell(cell_name)
    cfg = dict(reg.config(cell["config"]), **SIZES[cell_name])
    traffic = dict(reg.traffic(cell["traffic"]), submitters=4, items_per_request=200,
                   warm_s=0.3, budget_items_per_s=200_000)
    return reg, cell, cfg, traffic


def measure_small(cell_name: str, seed: int = 4242, seconds: float = 1.0) -> dict:
    """One run of the cut cell on the CPU, skipping the look for a card."""
    reg, cell, cfg, traffic = small_cell(cell_name)
    return run.measure(reg, cell, cfg, traffic, seed, seconds, False, time.perf_counter(),
                       log=lambda *a: print(*a, file=sys.stderr), device="cpu")

"""The served rate, read where it is a per-layer metric (a cell whose
runs spread too widely for it to guard end to end)."""

from benchmark.metrics.decisions_per_s import read  # noqa: F401

"""Per-layer metric readers, one module a metric, each with ``read(run)``:
the metric's value from the run's counters, clocks or profiled slice, or
None when the run holds nothing to read it from."""

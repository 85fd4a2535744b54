"""The benchmark of the PyTorch and CUDA port (``gubernator_tpu_torch``).

One command runs one cell once and prints one JSON line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are data: the
harness finds each by the name ``BENCHMARK.json`` gives it (``configs/``,
``traffic/``, ``metrics/``). ``reference/`` holds the plain NumPy model of
the limiter's semantics that decides ``correct``; it imports nothing of the
port.
"""

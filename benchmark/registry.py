"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``) and the reader of each per-layer metric
(``metrics/<name>.py``, a function ``read(run)``; a name split by cell,
``<name>.<part>``, is read by ``metrics/<name>.py``). A new cell, mix,
configuration or metric is a new file and a new entry; nothing here
changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, bench_path: Path = ROOT / "BENCHMARK.json", here: Path = HERE):
        self.bench = json.loads(Path(bench_path).read_text())
        self.here = Path(here)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.here.parent / c["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read` function of metrics/<metric>.py, the part of the
        name before its first dot."""
        pkg = self.here.name
        return importlib.import_module(f"{pkg}.metrics.{metric.split('.')[0]}").read

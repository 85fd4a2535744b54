"""The loader: a new configuration, traffic mix and per-layer metric are
found by name from new files and new entries, with no file edited."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

from benchmark.registry import HERE, ROOT, Registry


def test_the_benchmark_names_its_pieces():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        tr = reg.traffic(w["traffic"])
        assert cfg["name"] == w["config"] and tr["items_per_request"] > 0
        e2e = {m["name"] for m in reg.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = reg.per_layer(w["name"])
        assert layers
        for m in reg.end_to_end(w["name"]) + layers:
            assert callable(reg.reader(m["name"]))
        # each per-layer metric moves an end-to-end metric its cell reports
        assert {m["moves"] for m in layers} <= e2e - {"setup_s"}
    assert {m["name"] for m in reg.per_layer("skew-batch1000")} == {
        "request_p99_ms", "parse_encode_ms", "rows_per_flush", "queue_wait_ms", "issue_ms",
        "dispatches_per_flush", "kernels_per_dispatch", "decide_roofline", "device_idle_pct"}
    assert {m["name"] for m in reg.end_to_end("headline-batch1000")} == {
        "device_ns_per_decision", "setup_s"}
    assert reg.reader("rows_per_flush.card") is reg.reader("rows_per_flush")


def test_new_files_and_entries_are_found_without_edits(tmp_path, monkeypatch):
    pkg = tmp_path / "benchcopy"
    shutil.copytree(HERE, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (pkg / "configs" / "tiny_cfg.json").write_text(json.dumps(
        {"name": "tiny_cfg", "algorithm": "token_bucket", "limit": 5, "duration_ms": 1000,
         "keys": 10, "slots": 64, "seed_hits": [1, 2], "window_after_seed_ms": 10}))
    (pkg / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"submitters": 1, "items_per_request": 3, "hits": 1, "keys": "uniform",
         "warm_s": 0, "budget_items_per_s": 10}))
    (pkg / "metrics" / "answers_twice.py").write_text(
        "def read(run):\n    return 2.0 * run['items']\n")
    bench["configs"].append({"name": "tiny_cfg", "source": "https://example.org",
                             "file": "benchcopy/configs/tiny_cfg.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny_cfg",
                               "traffic": "tiny_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "answers_twice", "unit": "items", "better": "higher",
                               "source": "program_counter", "layer": "front door",
                               "moves": "decisions_per_s", "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.syspath_prepend(str(tmp_path))
    reg = Registry(tmp_path / "BENCHMARK.json", pkg)
    cell = reg.cell("tiny-cell")
    assert reg.config(cell["config"])["limit"] == 5
    assert reg.traffic(cell["traffic"])["items_per_request"] == 3
    assert [m["name"] for m in reg.per_layer("tiny-cell")] == ["answers_twice"]
    assert reg.reader("answers_twice")({"items": 21}) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
    sys.modules.pop("benchcopy", None)


@pytest.mark.parametrize("fault", [None, "every_repeat_folded"])
def test_a_new_cell_of_files_alone_runs_and_is_judged(tmp_path, monkeypatch, fault):
    """A deployment of two algorithms and a mix of drawn hits over zipfian
    keys, added as two data files and three entries, runs through the
    harness on the CPU and is judged: correct when sound, not correct with
    every repeat of a flush folded."""
    import time

    from benchmark import run
    from benchmark.tests.test_bench_faults import FAULTS

    pkg = tmp_path / "benchcopy"
    shutil.copytree(HERE, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (pkg / "configs" / "mixed_small.json").write_text(json.dumps(
        {"name": "mixed_small", "algorithm": {"token_bucket": 1, "leaky_bucket": 1},
         "limit": 100, "duration_ms": 60000, "keys": 4096, "slots": 8192,
         "seed_hits": [11, 90], "exact_rows_per_flush": 7, "window_after_seed_ms": 6300}))
    (pkg / "traffic" / "drawn_hits.json").write_text(json.dumps(
        {"submitters": 4, "items_per_request": 200,
         "hits": {"values": [1, 2, 5], "weights": [6, 3, 1]}, "keys": "zipfian",
         "zipf_theta": 0.99, "warm_s": 0.3, "budget_items_per_s": 200000}))
    bench["configs"].append({"name": "mixed_small", "source": "https://example.org",
                             "file": "benchcopy/configs/mixed_small.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "mixed-cell", "config": "mixed_small",
                               "traffic": "drawn_hits", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(tmp_path / "BENCHMARK.json", pkg)
    cell = reg.cell("mixed-cell")
    if fault:
        FAULTS[fault](monkeypatch)
    out = run.measure(reg, cell, reg.config(cell["config"]), reg.traffic(cell["traffic"]),
                      2**32 + 9, 1.0, False, time.perf_counter(), log=lambda *a: None,
                      device="cpu")
    assert out["detail"]["rows"] > 1000 and out["detail"]["over_limit_rows"] > 0
    assert out["correct"] is (fault is None), out["checks"]


def test_benchmark_json_keeps_the_contract_shapes():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert Path(ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in bench["end_to_end"]} == {"decisions_per_s",
                                                        "device_ns_per_decision", "setup_s"}
    assert len(bench["per_layer"]) == 14
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])

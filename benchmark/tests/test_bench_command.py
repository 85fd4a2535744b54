"""The run command refuses without a card, and without the program, and
prints no result line then."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from benchmark.registry import ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "headline-batch1000", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    p = _run(ROOT, dict(os.environ, GUBER_PROBE_KERNEL="pallas"))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
    assert "ignoring GUBER_PROBE_KERNEL" in p.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""

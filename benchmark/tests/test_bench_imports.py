"""Nothing the harness loads has the whole top-level name jax, jaxlib,
flax or gubernator_tpu, and nothing under benchmark/reference/ imports
the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.registry import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gubernator_tpu"}


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys, json\n"
        "import benchmark.run, benchmark.cell, benchmark.control, benchmark.devtrace\n"
        "import benchmark.reference.limiter, benchmark.reference.keyhash\n"
        "import benchmark.reference.respwire\n"
        "from benchmark.registry import Registry\n"
        "reg = Registry()\n"
        "[reg.reader(m['name']) for m in reg.bench['per_layer'] + reg.bench['end_to_end']]\n"
        "import gubernator_tpu_torch.service.daemon\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "gubernator_tpu_torch" in tops  # the port's name is compared whole


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"gubernator_tpu_torch"}, (path, n)
                assert n.split(".")[0] in {"numpy", "__future__", "typing"} or n.startswith(
                    "benchmark.reference."), (path, n)


def test_run_refuses_forbidden_modules():
    from benchmark import run

    assert run.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules}
                                             & FORBIDDEN)

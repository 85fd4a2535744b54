"""The port stands alone: importing gubernator_tpu_torch loads no JAX module and
nothing of the JAX package, and builds no kernel; no port source (nor
chip_smoke.py) names jax, xxhash or gubernator_tpu."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "gubernator_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]

_PROBE = """
import json, sys
import gubernator_tpu_torch
import gubernator_tpu_torch.ops.engine, gubernator_tpu_torch.ops.kernel2
import gubernator_tpu_torch.ops.slot_write, gubernator_tpu_torch._build as b
import gubernator_tpu_torch.ops.wire, gubernator_tpu_torch.ops.ring_drain
import gubernator_tpu_torch.ops.probe_walk, gubernator_tpu_torch.service.wire
import gubernator_tpu_torch.exp.sweeps, gubernator_tpu_torch.exp.exp_sweep2
import gubernator_tpu_torch.exp.exp_sweep4, gubernator_tpu_torch.exp.exp_sweep5
import gubernator_tpu_torch.exp.exp_mem2
import gubernator_tpu_torch.parallel, gubernator_tpu_torch.parallel.mesh
import gubernator_tpu_torch.parallel.ring, gubernator_tpu_torch.parallel.a2a
import gubernator_tpu_torch.parallel.sharded, gubernator_tpu_torch.parallel.global_sync
import gubernator_tpu_torch.parallel.telemetry
import gubernator_tpu_torch.ops.checkpoint, gubernator_tpu_torch.ops.telemetry
import gubernator_tpu_torch.ops.loop, gubernator_tpu_torch.bench_guard
import gubernator_tpu_torch.store, gubernator_tpu_torch.tier, gubernator_tpu_torch.tier.shadow
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xxhash", "gubernator_tpu"))
print(json.dumps({"bad": bad, "libs": sorted(b._LIBS), "torch": "torch" in sys.modules}))
"""


def test_import_loads_no_jax_and_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "libs": [], "torch": True}


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_imports_only_the_port(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "xxhash", "gubernator_tpu"), (path, name)

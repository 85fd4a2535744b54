"""The port stands alone: importing gubernator_tpu_torch loads no JAX module and
nothing of the JAX package, and builds no kernel nor the native extension; no
port source (nor chip_smoke.py) names jax, xxhash or gubernator_tpu. The
serving pipeline imports without the service layer's packages, which the
card's machine may lack."""

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
import gubernator_tpu_torch.config, gubernator_tpu_torch.tracing, gubernator_tpu_torch.otel
import gubernator_tpu_torch.native as native, gubernator_tpu_torch.proto
import gubernator_tpu_torch.peers, gubernator_tpu_torch.peers.ownership
import gubernator_tpu_torch.service.deadline, gubernator_tpu_torch.service.breaker
import gubernator_tpu_torch.service.metrics, gubernator_tpu_torch.service.batcher
import gubernator_tpu_torch.service.runner, gubernator_tpu_torch.service.peer_client
import gubernator_tpu_torch.service.global_manager, gubernator_tpu_torch.service.handoff
import gubernator_tpu_torch.service.daemon, gubernator_tpu_torch.service.server
import gubernator_tpu_torch.service.checkpoint, gubernator_tpu_torch.service.ring
import gubernator_tpu_torch.service.tls, gubernator_tpu_torch.service.region_manager
import gubernator_tpu_torch.tier.manager, gubernator_tpu_torch.ops.reconcile
import gubernator_tpu_torch.cmd.server, gubernator_tpu_torch.cmd.cli
import gubernator_tpu_torch.cmd.cluster, gubernator_tpu_torch.cmd.healthcheck
import gubernator_tpu_torch.client, gubernator_tpu_torch.edge, gubernator_tpu_torch.edge.local_limiter
import gubernator_tpu_torch.service.lease_manager, gubernator_tpu_torch.discovery
import gubernator_tpu_torch.discovery.dns, gubernator_tpu_torch.discovery.etcd
import gubernator_tpu_torch.discovery.kubernetes, gubernator_tpu_torch.discovery.memberlist
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xxhash", "gubernator_tpu"))
print(json.dumps({"bad": bad, "libs": sorted(b._LIBS) + ([native.parser()] if native._tried else []),
                  "torch": "torch" in sys.modules}))
"""

# the card's machine may lack these: the serving pipeline must not need them
_SERVICE_PACKAGES = ("grpc", "aiohttp", "google.protobuf", "prometheus_client")
_PIPELINE_PROBE = """
import json, sys
for name in %r:
    sys.modules[name] = None
import gubernator_tpu_torch.service.batcher, gubernator_tpu_torch.service.runner
import gubernator_tpu_torch.service.wire as wire, gubernator_tpu_torch.native
import gubernator_tpu_torch.tracing, gubernator_tpu_torch.config
import gubernator_tpu_torch.service as service
try:
    service.Daemon
    daemon = "imported"
except ImportError:
    daemon = "needs the service packages"
print(json.dumps({"wire_batch": wire.WireBatch.__name__, "daemon": daemon}))
""" % (_SERVICE_PACKAGES,)


def test_import_loads_no_jax_and_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "libs": [], "torch": True}


def test_serving_pipeline_imports_without_the_service_packages():
    out = subprocess.run(
        [sys.executable, "-c", _PIPELINE_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"wire_batch": "WireBatch", "daemon": "needs the service packages"}


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

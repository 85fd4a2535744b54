"""Sharded table telemetry: the per-shard scan of ops/telemetry.py over a
mesh engine's tables (the port of ``gubernator_tpu/parallel/telemetry.py``).

Each shard streams only its own table, and the per-shard stats vectors come
back stacked (D, VEC_LEN). That makes shard imbalance observable: a hot
shard's live count (column 0) diverges long before its buckets start
evicting live keys. Every vector entry is additive over disjoint row sets,
so ``ops/telemetry.finish_scan`` sums the D rows for the table-wide totals
and keeps column 0 per shard.
"""

from __future__ import annotations

import torch

from gubernator_tpu_torch.ops.table2 import K
from gubernator_tpu_torch.ops.telemetry import PendingScan, _scan_body, block_width


def sharded_scan_begin(engine, now_ms: int) -> PendingScan:
    """Launch the telemetry scan over a mesh engine's tables without
    fetching (the engine-thread half; finish with ops.telemetry.finish_scan)."""
    D = engine.n_shards
    nb = engine.tables[0].n_buckets
    blk = block_width(nb)
    dev0 = engine.tables[0].rows.device
    # (D, VEC_LEN) stats vectors on shard 0's device; nothing is mutated
    vec = torch.stack([
        _scan_body(t.rows, int(now_ms), blk, engine.layout).to(dev0, non_blocking=True)
        for t in engine.tables
    ])
    return PendingScan(vec, now_ms, capacity=D * nb * K, n_buckets=D * nb, per_shard=True)

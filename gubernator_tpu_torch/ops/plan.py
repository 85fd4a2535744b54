"""Batch pass planning: same-key sequential semantics on a parallel device
(the port of ``gubernator_tpu/ops/plan.py``; numpy, unchanged).

The decision kernel requires unique fingerprints per dispatch. The planner
splits a batch into passes: occurrence r of every key goes to pass r for
the first `max_exact`-1 occurrences; later occurrences are aggregated into
a final pass — hits summed, RESET_REMAINING OR-ed, config taken from the
newest request, the aggregate's response shared by all members (reference
global.go:109-123). Engines that aggregate duplicates in the dispatch plan
with ``single_pass`` instead.

It also owns the table-walk plans: GUBER_PROBE_KERNEL picks the decide
path's walk ("xla": gather + sort-based claim + slot write; "pallas": the
fused probe walk, ops/probe_walk.py) and GUBER_WALK_KERNEL the install and
merge walks, independently. Both resolve "auto" to "xla", as in the JAX
package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from gubernator_tpu_torch.ops.batch import HostBatch

def probe_kernel_env() -> str:
    """The GUBER_PROBE_KERNEL knob: auto | xla | pallas."""
    v = os.environ.get("GUBER_PROBE_KERNEL", "auto")
    if v not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"GUBER_PROBE_KERNEL must be auto, xla or pallas, got {v!r}"
        )
    return v


def default_probe_kernel() -> str:
    """Resolve the probe-kernel plan: "xla" unless GUBER_PROBE_KERNEL=pallas
    opts into the fused probe walk."""
    v = probe_kernel_env()
    return "xla" if v == "auto" else v


def walk_kernel_env() -> str:
    """The GUBER_WALK_KERNEL knob: auto | xla | pallas — which walk the
    install and merge paths run: the gather + slot write, or the fused probe
    walk. Independent of GUBER_PROBE_KERNEL."""
    v = os.environ.get("GUBER_WALK_KERNEL", "auto")
    if v not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"GUBER_WALK_KERNEL must be auto, xla or pallas, got {v!r}"
        )
    return v


def default_walk_kernel() -> str:
    """Resolve the walk-kernel plan: "xla" unless GUBER_WALK_KERNEL=pallas."""
    v = walk_kernel_env()
    return "xla" if v == "auto" else v


@dataclass
class Pass:
    rows: np.ndarray  # original row indices whose response comes from this pass
    batch: HostBatch
    # for the aggregated final pass: member_rows[i] lists every original row
    # sharing batch row i's response
    member_rows: List[np.ndarray]


def _subset(b: HostBatch, rows: np.ndarray) -> HostBatch:
    return HostBatch(*[f[rows] for f in b])


def single_pass(b: HostBatch) -> List[Pass]:
    """O(1) plan for engines that aggregate duplicate keys in the dispatch
    (kernel2.dedup_packed_cols, ShardedEngine dedup="device"): one pass of
    the batch's active rows, no host group-by. Members are answered from
    their carrier in the dispatch (kernel2.fanout_packed), so member_rows
    stays empty and each row comes back with its own response."""
    act = np.nonzero(b.active)[0]
    if act.size == b.fp.shape[0]:
        return [Pass(rows=act, batch=b, member_rows=[])]
    return [Pass(rows=act, batch=_subset(b, act), member_rows=[])]


def plan_passes(b: HostBatch, max_exact: int = 8) -> List[Pass]:
    """Split a packed batch into unique-fingerprint passes. Rows with
    active=False (padding or per-request validation errors) are skipped."""
    act = np.nonzero(b.active)[0]
    fp = b.fp[act]
    uniq, inv, counts = np.unique(fp, return_inverse=True, return_counts=True)
    if counts.max(initial=0) <= 1:
        if act.size == b.fp.shape[0]:
            return [Pass(rows=act, batch=b, member_rows=[])]
        return [Pass(rows=act, batch=_subset(b, act), member_rows=[])]

    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    group_start = np.searchsorted(sorted_inv, sorted_inv)
    occ = np.empty(act.size, dtype=np.int64)
    occ[order] = np.arange(act.size) - group_start

    passes: List[Pass] = []
    for r in range(min(int(occ.max()) + 1, max_exact - 1)):
        rows = act[np.nonzero(occ == r)[0]]
        if rows.size == 0:
            break
        passes.append(Pass(rows=rows, batch=_subset(b, rows), member_rows=[]))

    tail_pos = np.nonzero(occ >= max_exact - 1)[0]
    if tail_pos.size:
        tail = act[tail_pos]
        # aggregation groups key on (fp, cascade level): two levels of one
        # cascade whose keys collide on a fingerprint must not merge
        tail_lvl = (b.behavior[tail].astype(np.int64) >> 8) & 0xFF
        tail_key = inv[tail_pos].astype(np.int64) * 256 + tail_lvl
        tuniq, tinv = np.unique(tail_key, return_inverse=True)
        # the newest member of each group carries the config
        last_rows = np.zeros(tuniq.size, dtype=np.int64)
        np.maximum.at(last_rows, tinv, tail)
        agg = _subset(b, last_rows)
        hits = np.zeros(tuniq.size, dtype=np.int64)
        np.add.at(hits, tinv, b.hits[tail])
        # only RESET_REMAINING survives the merge (reference global.go:117-121)
        reset_bit = np.zeros(tuniq.size, dtype=np.int32)
        np.bitwise_or.at(reset_bit, tinv, b.behavior[tail] & 8)
        agg = agg._replace(hits=hits, behavior=agg.behavior | reset_bit)
        member_rows = [tail[tinv == g] for g in range(tuniq.size)]
        passes.append(Pass(rows=last_rows, batch=agg, member_rows=member_rows))
    return passes

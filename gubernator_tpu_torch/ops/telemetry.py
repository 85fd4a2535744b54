"""Table telemetry: one scan of the rows → the table's health counters (the
port of ``gubernator_tpu/ops/telemetry.py``, single-device part).

One pass over the rows computes how full the buckets are (collision
pressure, which predicts unexpired evictions), how the TTL horizon is
spread, how much admission headroom is left and what share of live keys is
OVER_LIMIT. The output is one small int64 vector; ``finish_scan`` decodes
it into a ``TableSnapshot``. The scan is launched on the engine thread
(``scan_begin``: a coherent table, an enqueue) and fetched off it.

``host_telemetry`` is the numpy oracle the device scan is held to. The
ratios rem / limit and the block-fill deciles are float32, with IEEE
division, as the JAX package computes them, so the counts agree exactly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops.layout import FULL, SlotLayout, layout_for_row
from gubernator_tpu_torch.ops.table2 import (
    EXP_HI,
    EXP_LO,
    FLAGS,
    FP_HI,
    FP_LO,
    K,
    LIMIT,
    REM_I,
)

# TTL-horizon bucket edges (ms since `now`): live keys expiring within each
# horizon, cumulative — ≤1s, ≤10s, ≤1m, ≤10m, ≤1h, ≤1d, +Inf
TTL_EDGES_MS = (1_000, 10_000, 60_000, 600_000, 3_600_000, 86_400_000)
# remaining-capacity edges (remaining / limit, cumulative ≤)
REMAIN_EDGES = (0.01, 0.1, 0.25, 0.5, 0.9)
# buckets per occupancy block (the write's default sparse block width)
BLOCK_BUCKETS = 64

# stats-vector layout (int64), shared with the decoder below
_N_SCALAR = 3  # live, occupied, over
VEC_LEN = _N_SCALAR + (K + 1) + len(TTL_EDGES_MS) + len(REMAIN_EDGES) + 10


@dataclass
class TableSnapshot:
    """One decoded telemetry scan (host side)."""

    now_ms: int
    capacity: int  # total slots
    n_buckets: int
    live_keys: int
    occupied_slots: int  # fp != 0, including expired-not-yet-evicted
    over_keys: int  # live slots whose stored status is OVER_LIMIT
    # count of buckets holding exactly j live slots, j = 0..K
    bucket_occupancy: List[int] = field(default_factory=list)
    # cumulative live keys with (expire - now) <= TTL_EDGES_MS[i]
    ttl_horizon: List[int] = field(default_factory=list)
    # cumulative live keys with remaining/limit <= REMAIN_EDGES[i]
    remaining_frac: List[int] = field(default_factory=list)
    # sweep-block fill-fraction histogram, 10 decile bins
    block_fill: List[int] = field(default_factory=list)
    scan_ms: float = 0.0
    per_shard_live: Optional[List[int]] = None  # mesh engines only

    @property
    def load_factor(self) -> float:
        return self.live_keys / max(self.capacity, 1)

    @property
    def over_fraction(self) -> float:
        return self.over_keys / max(self.live_keys, 1)

    @property
    def probe_depth(self) -> List[int]:
        """Live keys by their bucket's occupancy: j * bucket_occupancy[j],
        j = 1..K."""
        return [j * self.bucket_occupancy[j] for j in range(1, K + 1)]

    def to_dict(self) -> dict:
        d = {
            "now_ms": self.now_ms,
            "capacity": self.capacity,
            "n_buckets": self.n_buckets,
            "live_keys": self.live_keys,
            "occupied_slots": self.occupied_slots,
            "expired_slots": self.occupied_slots - self.live_keys,
            "over_keys": self.over_keys,
            "over_fraction": round(self.over_fraction, 6),
            "load_factor": round(self.load_factor, 6),
            "bucket_occupancy": self.bucket_occupancy,
            "probe_depth": self.probe_depth,
            "ttl_horizon_ms": dict(
                zip([str(e) for e in TTL_EDGES_MS] + ["+Inf"],
                    self.ttl_horizon + [self.live_keys])
            ),
            "remaining_frac": dict(
                zip([str(e) for e in REMAIN_EDGES] + ["+Inf"],
                    self.remaining_frac + [self.live_keys])
            ),
            "block_fill_deciles": self.block_fill,
            "scan_ms": round(self.scan_ms, 3),
        }
        if self.per_shard_live is not None:
            d["per_shard_live"] = self.per_shard_live
        return d


def _hist(vals: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of vals == j for j < n, as int64 (compares, not bincount:
    bincount reads the maximum back to the host)."""
    bins = torch.arange(n, dtype=vals.dtype, device=vals.device)
    return (vals[:, None] == bins[None, :]).sum(dim=0, dtype=torch.int64)


def _scan_body(rows: torch.Tensor, now: int, blk: int,
               layout: Optional[SlotLayout] = None) -> torch.Tensor:
    """Scan of an (..., NB, K·F) rows tensor → (VEC_LEN,) int64 stats
    vector. Every entry is additive across disjoint row sets (a sharded
    scan sums per-shard vectors). `blk` is the occupancy-block width in
    buckets; packed fields unpack to the canonical 16 first."""
    layout = FULL if layout is None else layout
    i64 = torch.int64
    slots = layout.unpack(rows.reshape(-1, K, layout.F))  # (M, K, 16)
    fp = (slots[:, :, FP_HI].to(i64) << 32) | (slots[:, :, FP_LO].to(i64) & 0xFFFFFFFF)
    exp = (slots[:, :, EXP_HI].to(i64) << 32) | (slots[:, :, EXP_LO].to(i64) & 0xFFFFFFFF)
    occupied = fp != 0
    live = occupied & (exp >= now)
    over = live & ((slots[:, :, FLAGS] >> 8) == 1)  # FLAGS = algo | status<<8

    parts = [live.sum(dtype=i64)[None], occupied.sum(dtype=i64)[None],
             over.sum(dtype=i64)[None]]
    # bucket occupancy histogram: buckets holding exactly j live slots
    bucket_occ = live.sum(dim=1, dtype=torch.int32)  # (M,)
    parts.append(_hist(bucket_occ, K + 1))
    # TTL horizon (cumulative over live slots)
    rel = exp - now
    parts.append(torch.stack([(live & (rel <= e)).sum(dtype=i64) for e in TTL_EDGES_MS]))
    # remaining-capacity fraction: rem_i / limit per live slot, in float32
    rem = torch.clamp(slots[:, :, REM_I], min=0).to(torch.float32)
    lim = torch.clamp(slots[:, :, LIMIT], min=1).to(torch.float32)
    frac = rem / lim
    parts.append(torch.stack([
        (live & (frac <= torch.tensor(e, dtype=torch.float32))).sum(dtype=i64)
        for e in REMAIN_EDGES
    ]))
    # sweep-block fill deciles
    block_live = bucket_occ.reshape(-1, blk).sum(dim=1, dtype=torch.int32)
    fill = block_live.to(torch.float32) / torch.tensor(float(blk * K), dtype=torch.float32)
    decile = torch.clamp((fill * 10).to(torch.int32), 0, 9)
    parts.append(_hist(decile, 10))
    return torch.cat(parts)


def block_width(n_buckets: int) -> int:
    """Occupancy-block width for a table geometry: the 64-bucket block when
    it divides, the whole (tiny) table otherwise."""
    return BLOCK_BUCKETS if n_buckets % BLOCK_BUCKETS == 0 else n_buckets


class PendingScan:
    """An issued telemetry scan: the device computes while serving goes on;
    ``finish_scan`` fetches the stats vector. ``per_shard`` marks a
    (D, VEC_LEN) vector of a sharded scan."""

    __slots__ = ("vec", "now_ms", "capacity", "n_buckets", "t0", "per_shard")

    def __init__(self, vec, now_ms, capacity, n_buckets, per_shard=False):
        self.vec = vec
        self.now_ms = now_ms
        self.capacity = capacity
        self.n_buckets = n_buckets
        self.t0 = time.perf_counter()
        self.per_shard = per_shard


def scan_begin(rows: torch.Tensor, now_ms: int,
               layout: Optional[SlotLayout] = None) -> PendingScan:
    """Launch the scan over a single-device rows tensor without fetching."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    nb = int(rows.shape[-2])
    vec = _scan_body(rows, int(now_ms), block_width(nb), layout)
    total_buckets = int(np.prod(rows.shape[:-1]))
    return PendingScan(vec, now_ms, total_buckets * K, total_buckets)


def decode_vec(vec: np.ndarray) -> dict:
    """Split one (VEC_LEN,) stats vector into named pieces."""
    i = _N_SCALAR
    out = {"live": int(vec[0]), "occupied": int(vec[1]), "over": int(vec[2])}
    out["occ_hist"] = [int(x) for x in vec[i: i + K + 1]]
    i += K + 1
    out["ttl"] = [int(x) for x in vec[i: i + len(TTL_EDGES_MS)]]
    i += len(TTL_EDGES_MS)
    out["remain"] = [int(x) for x in vec[i: i + len(REMAIN_EDGES)]]
    i += len(REMAIN_EDGES)
    out["blocks"] = [int(x) for x in vec[i: i + 10]]
    return out


def finish_scan(pending: PendingScan) -> TableSnapshot:
    """Fetch and decode an issued scan (the off-engine-thread half)."""
    vec = pending.vec
    vech = vec.cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    per_shard = None
    if pending.per_shard:
        per_shard = [int(x) for x in vech[:, 0]]
        vech = vech.sum(axis=0)
    d = decode_vec(vech)
    return TableSnapshot(
        now_ms=pending.now_ms,
        capacity=pending.capacity,
        n_buckets=pending.n_buckets,
        live_keys=d["live"],
        occupied_slots=d["occupied"],
        over_keys=d["over"],
        bucket_occupancy=d["occ_hist"],
        ttl_horizon=d["ttl"],
        remaining_frac=d["remain"],
        block_fill=d["blocks"],
        scan_ms=(time.perf_counter() - pending.t0) * 1e3,
        per_shard_live=per_shard,
    )


def host_telemetry(rows: np.ndarray, now_ms: int,
                   layout: Optional[SlotLayout] = None) -> TableSnapshot:
    """Numpy oracle: the same statistics computed on the host from a table
    snapshot — the reference the device scan is held to, and a way to read
    a checkpoint file after the fact."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    nb = int(rows.shape[-2])
    blk = block_width(nb)
    slots = np.asarray(layout.unpack(rows.reshape(-1, K, layout.F)))
    lo = slots[:, :, FP_LO].astype(np.int64) & 0xFFFFFFFF
    hi = slots[:, :, FP_HI].astype(np.int64)
    fp = (hi << 32) | lo
    exp = (slots[:, :, EXP_LO].astype(np.int64) & 0xFFFFFFFF) | (
        slots[:, :, EXP_HI].astype(np.int64) << 32
    )
    occupied = fp != 0
    live = occupied & (exp >= now_ms)
    status = slots[:, :, FLAGS] >> 8
    bucket_occ = live.sum(axis=1)
    rel = exp - now_ms
    rem = np.maximum(slots[:, :, REM_I], 0).astype(np.float32)
    lim = np.maximum(slots[:, :, LIMIT], 1).astype(np.float32)
    frac = rem / lim
    block_live = bucket_occ.reshape(-1, blk).sum(axis=1)
    decile = np.clip((block_live.astype(np.float32) / (blk * K) * 10).astype(np.int32), 0, 9)
    total_buckets = slots.shape[0]
    return TableSnapshot(
        now_ms=now_ms,
        capacity=total_buckets * K,
        n_buckets=total_buckets,
        live_keys=int(live.sum()),
        occupied_slots=int(occupied.sum()),
        over_keys=int((live & (status == 1)).sum()),
        bucket_occupancy=[int((bucket_occ == j).sum()) for j in range(K + 1)],
        ttl_horizon=[int((live & (rel <= e)).sum()) for e in TTL_EDGES_MS],
        remaining_frac=[int((live & (frac <= e)).sum()) for e in REMAIN_EDGES],
        block_fill=[int((decile == j).sum()) for j in range(10)],
    )

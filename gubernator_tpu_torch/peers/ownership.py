"""Fingerprint → ring-point ownership sidecar.

The device table stores only 63-bit fingerprints (raw keys never reach the
device, hashing.py), but PEER ownership is decided on the string hash key's
32-bit ring point (peers/hash_ring.py — fnv1a over "name_uniquekey"). The
two are not mutually derivable, so a topology-change handoff (which must map
each live table row to its new ring owner) needs this host-side sidecar: the
daemon records (fingerprint, ring_point) pairs for every row it serves AS
OWNER — both are already computed on the serving path (the native wire
parser emits ring points per item; the pb path hashes per item anyway) — and
the handoff reads the mapping back when partitioning extracted rows.

Rows with no recorded point (e.g. restored from a checkpoint taken by an
older build, or replica installs) cannot be routed; the handoff skips them,
degrading for exactly those rows to the pre-handoff behavior (fresh state at
the new owner, over-admission bounded by one config window). Transfer chunks
carry the points alongside the slots so a receiver can route the same rows
onward in a later rebalance (the hand-back half of a rolling restart).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class OwnershipIndex:
    """Append-mostly {fingerprint: ring_point} map with vectorized batch
    record/lookup. Not thread-safe by design: every writer runs on the
    asyncio event loop (daemon routing paths), and the handoff reads from
    there too."""

    def __init__(self):
        self._map: dict = {}

    def __len__(self) -> int:
        return len(self._map)

    def record(self, fps: np.ndarray, points: np.ndarray) -> None:
        """Remember the ring point for each fingerprint (newest wins — the
        point for a given key never changes, so collisions are rewrites of
        the same value)."""
        if fps.shape[0] == 0:
            return
        self._map.update(
            zip(
                np.asarray(fps, dtype=np.int64).tolist(),
                np.asarray(points, dtype=np.uint32).tolist(),
            )
        )

    def record_keys(self, fps, keys, hash_fn) -> None:
        """pb-path variant: compute each key's ring point with the picker's
        own hash function (the native path gets points for free from the
        wire parser)."""
        for fp, key in zip(fps, keys):
            if key:
                self._map[int(fp)] = hash_fn(key.encode()) & 0xFFFFFFFF

    def points_for(self, fps: np.ndarray):
        """(points (N,) uint32, found (N,) bool) for a batch of
        fingerprints; unmapped entries carry point 0 with found=False."""
        n = fps.shape[0]
        points = np.zeros(n, dtype=np.uint32)
        found = np.zeros(n, dtype=bool)
        get = self._map.get
        for i, fp in enumerate(np.asarray(fps, dtype=np.int64).tolist()):
            p = get(fp)
            if p is not None:
                points[i] = p
                found[i] = True
        return points, found

    def discard(self, fps: np.ndarray) -> None:
        """Forget transferred-and-tombstoned rows (bounds sidecar memory to
        the live, still-owned key set over time)."""
        pop = self._map.pop
        for fp in np.asarray(fps, dtype=np.int64).tolist():
            pop(fp, None)

    def prune(self, live_fps: Optional[np.ndarray]) -> int:
        """Drop every entry not in `live_fps` (post-handoff housekeeping
        against the extract's live set). Returns the number pruned."""
        if live_fps is None:
            n = len(self._map)
            self._map.clear()
            return n
        keep = set(np.asarray(live_fps, dtype=np.int64).tolist())
        stale = [fp for fp in self._map if fp not in keep]
        for fp in stale:
            del self._map[fp]
        return len(stale)

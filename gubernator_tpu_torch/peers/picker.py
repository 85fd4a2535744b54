"""RegionPicker — per-datacenter consistent-hash rings.

The multi-region analog of the reference's RegionPicker (reference
region_picker.go:19-103): peers are grouped by their ``data_center`` label,
each region gets its own ReplicatedConsistentHash ring, and a key resolves to
one owning peer *per region* (cross-region replication targets). Within the
local region the plain ring (peers/hash_ring.py) decides ownership; the
RegionPicker exists so MULTI_REGION traffic and health checks can enumerate
every region's owner for a key.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from gubernator_tpu_torch.peers.hash_ring import (
    DEFAULT_REPLICAS,
    ReplicatedConsistentHash,
    fnv1a_32,
)
from gubernator_tpu_torch.types import PeerInfo


class RegionPicker:
    """Encapsulates one consistent-hash ring per region (data center)."""

    def __init__(
        self,
        hash_fn: Optional[Callable[[bytes], int]] = None,
        replicas: int = DEFAULT_REPLICAS,
    ):
        self.hash_fn = hash_fn or fnv1a_32
        self.replicas = replicas
        self._regions: Dict[str, ReplicatedConsistentHash] = {}

    def add(self, peer: PeerInfo) -> None:
        """Register a peer under its data_center's ring (created on first
        sighting — reference region_picker.go:96-103)."""
        ring = self._regions.get(peer.data_center)
        if ring is None:
            ring = ReplicatedConsistentHash(self.hash_fn, self.replicas)
            self._regions[peer.data_center] = ring
        ring.add(peer)

    def get_clients(
        self, key: str, exclude: frozenset = frozenset()
    ) -> List[PeerInfo]:
        """The owning peer of `key` in EVERY region (reference
        region_picker.go:57-69) — the cross-region replication fan-out set.
        `exclude` routes around unreachable (open-breaker) peers within each
        region's ring; a region whose peers are ALL excluded contributes no
        target rather than failing the whole fan-out."""
        out: List[PeerInfo] = []
        for ring in self._regions.values():
            try:
                out.append(ring.get(key, exclude))
            except RuntimeError:
                continue  # every peer in this region excluded
        return out

    def get_by_address(self, address: str) -> Optional[PeerInfo]:
        """First peer whose address matches, searching all regions
        (reference region_picker.go:72-79)."""
        for ring in self._regions.values():
            peer = ring.get_by_address(address)
            if peer is not None:
                return peer
        return None

    def pickers(self) -> Dict[str, ReplicatedConsistentHash]:
        """region → ring map (reference region_picker.go:82-84)."""
        return self._regions

    def peers(self) -> List[PeerInfo]:
        """All peers across all regions (reference region_picker.go:86-94)."""
        out: List[PeerInfo] = []
        for ring in self._regions.values():
            out.extend(ring.peers())
        return out

    def size(self) -> int:
        return sum(r.size() for r in self._regions.values())

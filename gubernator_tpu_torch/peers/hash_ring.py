"""Replicated consistent hash ring — peer-level key ownership.

The cluster analog of the reference's LocalPicker (reference
replicated_hash.go:36-119): 512 virtual replicas per peer placed on a 32-bit
ring; a key's owner is the first replica clockwise from the key's hash
(binary search). The ring is rebuilt from scratch on every peer-set change
(reference gubernator.go:694-746) — cheap and simple.

Within a host, device-shard ownership uses fingerprint high bits
(parallel/mesh.py); this ring decides which HOST owns a key across the
cluster, exactly like the reference decides which node does.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Dict, List, Optional

from gubernator_tpu_torch.hashing import xxh32
from gubernator_tpu_torch.types import PeerInfo

DEFAULT_REPLICAS = 512  # reference replicated_hash.go:29


def _hash32(data: bytes) -> int:
    return xxh32(data)


def fnv1a_32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def fnv1_32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h * 0x01000193) & 0xFFFFFFFF) ^ b
    return h


HASH_FUNCTIONS: Dict[str, Callable[[bytes], int]] = {
    # the reference offers fnv1a (default) and fnv1 (config.go:479-502)
    "fnv1a": fnv1a_32,
    "fnv1": fnv1_32,
    "xxhash": _hash32,
}


class ReplicatedConsistentHash:
    """Peer picker with virtual-replica consistent hashing."""

    def __init__(
        self,
        hash_fn: Optional[Callable[[bytes], int]] = None,
        replicas: int = DEFAULT_REPLICAS,
    ):
        self.hash_fn = hash_fn or fnv1a_32
        self.replicas = replicas
        self._peers: Dict[str, PeerInfo] = {}
        self._ring: List[tuple] = []  # sorted (point, PeerInfo)

    def peers(self) -> List[PeerInfo]:
        return list(self._peers.values())

    def add(self, peer: PeerInfo) -> None:
        """Place `replicas` points for the peer; the replica key mixes the
        replica index with an md5 of the address (reference
        replicated_hash.go:78-91)."""
        self._peers[peer.grpc_address] = peer
        digest = hashlib.md5(peer.grpc_address.encode()).hexdigest()
        for i in range(self.replicas):
            point = self.hash_fn(f"{i}{digest}".encode())
            self._ring.append((point, peer))
        self._ring.sort(key=lambda t: t[0])
        self._ring_pts = None  # invalidate the vectorized-lookup cache

    def get(self, key: str, exclude: frozenset = frozenset()) -> PeerInfo:
        """Owner of `key` — first ring point at or after hash(key), wrapping
        (reference replicated_hash.go:104-119). `exclude` (grpc addresses)
        skips peers along the ring — the fault-tolerance route-around: the
        first non-excluded peer clockwise is the key's natural fallback
        owner. Raises when every peer is excluded."""
        if not self._ring:
            raise RuntimeError("unable to pick a peer; pool is empty")
        point = self.hash_fn(key.encode())
        idx = bisect.bisect_left(self._ring, (point,))
        if idx == len(self._ring):
            idx = 0
        if not exclude:
            return self._ring[idx][1]
        seen = set()
        for off in range(len(self._ring)):
            peer = self._ring[(idx + off) % len(self._ring)][1]
            if peer.grpc_address not in exclude:
                return peer
            seen.add(peer.grpc_address)
            if len(seen) == len(self._peers):
                break
        raise RuntimeError("unable to pick a peer; all peers excluded")

    def owners_of(self, points, exclude: frozenset = frozenset()) -> List[PeerInfo]:
        """Vectorized get(): precomputed 32-bit ring points (numpy array) →
        owner per element. Used by the native ingress path, which computes
        fnv1a ring points during wire parsing so no key strings need to be
        materialized for routing. `exclude` (grpc addresses) removes peers'
        replicas from the ring before the lookup — the vectorized form of
        get(key, exclude), used by the graceful drain to find every row's
        ring successor (ownership as if this peer were already gone)."""
        if not self._ring:
            raise RuntimeError("unable to pick a peer; pool is empty")
        import numpy as np

        if exclude:
            ring = [
                (p, peer)
                for p, peer in self._ring
                if peer.grpc_address not in exclude
            ]
            if not ring:
                raise RuntimeError("unable to pick a peer; all peers excluded")
            pts = np.fromiter((p for p, _ in ring), np.uint32, len(ring))
        else:
            ring = self._ring
            if getattr(self, "_ring_pts", None) is None or len(
                self._ring_pts
            ) != len(self._ring):
                self._ring_pts = np.fromiter(
                    (p for p, _ in self._ring), np.uint32, len(self._ring)
                )
            pts = self._ring_pts
        idx = np.searchsorted(pts, points, side="left")
        idx[idx == len(ring)] = 0
        return [ring[i][1] for i in idx]

    def size(self) -> int:
        return len(self._peers)

    def get_by_address(self, address: str) -> Optional[PeerInfo]:
        return self._peers.get(address)

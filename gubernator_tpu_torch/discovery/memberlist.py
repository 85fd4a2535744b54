"""Memberlist peer discovery — a self-contained anti-entropy gossip pool (the
port of ``gubernator_tpu/discovery/memberlist.py``: the same wire format,
byte for byte, so JAX-package nodes and port nodes gossip with each other).

The reference embeds hashicorp/memberlist (SWIM gossip over UDP/TCP) and
carries each node's PeerInfo as JSON metadata; join retries against seed
nodes, and join/leave/update events rebuild the peer map (reference
memberlist.go:93-192, 228-301). This re-implementation keeps the same
observable behavior with a deliberately simple protocol:

* full-state **push-pull over TCP**: every gossip tick each node syncs its
  member table with one random known peer (and with every seed at join);
  entries are (name → PeerInfo JSON, incarnation, heartbeat) and merge by
  (incarnation, heartbeat) dominance — the anti-entropy half of SWIM, which
  is what drives hashicorp's convergence too.
* **liveness by heartbeat age**: a node bumps its own heartbeat every tick;
  entries not refreshed within `suspect_ticks` ticks are dropped (the
  probe/suspect machinery collapses into this because state rides the same
  sync channel).
* **graceful leave**: close() pushes a tombstone (incarnation bump + dead
  flag) to known peers, the NotifyLeave analog.

Encryption: an optional AES-256/192/128-GCM keyring (the reference's
SecretKey/keyring, memberlist.go:149-167) seals every state blob —
`GUBER_MEMBERLIST_SECRET_KEYS` takes comma-separated base64 keys, the FIRST
encrypts outbound gossip and ALL decrypt inbound (key rotation: add the new
key everywhere, promote it to first, drop the old). With a keyring set,
plaintext blobs are rejected (GossipVerifyIncoming semantics); without one,
sealed blobs are undecodable noise. The message format is one (optionally
sealed) JSON object per connection, length-prefixed by socket EOF.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator_tpu_torch.memberlist")

MAX_STATE_BYTES = 1 << 20
ENC_MAGIC = b"GUBENC1\x00"  # sealed-blob marker + format version
_ENC_AAD = b"gubernator-memberlist-v1"


@dataclass
class Member:
    name: str  # advertise address — unique node id
    peer: dict  # PeerInfo fields (grpc_address, http_address, data_center)
    incarnation: int = 0
    heartbeat: int = 0
    dead: bool = False
    age_ticks: int = 0  # local staleness counter (not gossiped)

    def dominates(self, other: "Member") -> bool:
        return (self.incarnation, self.heartbeat, self.dead) > (
            other.incarnation,
            other.heartbeat,
            other.dead,
        )


class MemberlistPool:
    """Gossip discovery pool; calls on_update(peers) when membership changes."""

    def __init__(
        self,
        bind_address: str,
        known_nodes: List[str],
        on_update: Callable[[List[PeerInfo]], None],
        peer_info: PeerInfo,
        advertise_address: str = "",
        gossip_interval_ms: float = 500.0,
        suspect_ticks: int = 6,
        secret_keys: Optional[List[bytes]] = None,
        rng: Optional[random.Random] = None,
    ):
        for k in secret_keys or []:
            if len(k) not in (16, 24, 32):
                raise ValueError(
                    "memberlist secret keys must be 16, 24 or 32 bytes "
                    f"(got {len(k)})"
                )
        self.secret_keys = list(secret_keys or [])
        self.bind_address = bind_address
        self.advertise_address = advertise_address or bind_address
        self.known_nodes = [n for n in known_nodes if n]
        self.on_update = on_update
        self.interval_s = max(gossip_interval_ms / 1e3, 0.01)
        self.suspect_ticks = suspect_ticks
        self.name = self.advertise_address
        self._self = Member(
            name=self.name,
            peer=dict(
                grpc_address=peer_info.grpc_address,
                http_address=peer_info.http_address,
                data_center=peer_info.data_center,
            ),
            incarnation=0,
        )
        self._members: Dict[str, Member] = {self.name: self._self}
        self._server: Optional[asyncio.AbstractServer] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._last_published: Optional[List[str]] = None
        self.gossip_port: Optional[int] = None
        # picks each tick's gossip target uniformly; a test passes a seeded one
        self._rng = rng or random.Random()

    # ---------------------------------------------------------------- state
    def _state_blob(self) -> bytes:
        rows = [
            dict(
                name=m.name,
                peer=m.peer,
                incarnation=m.incarnation,
                heartbeat=m.heartbeat,
                dead=m.dead,
            )
            for m in self._members.values()
        ]
        blob = json.dumps({"from": self.name, "members": rows}).encode()
        return self._seal(blob)

    # ------------------------------------------------------------ encryption
    def _seal(self, blob: bytes) -> bytes:
        """AES-GCM-seal with the primary key (reference memberlist.go:149-167
        keyring); identity when no keyring is configured."""
        if not self.secret_keys:
            return blob
        import os as _os

        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        nonce = _os.urandom(12)
        ct = AESGCM(self.secret_keys[0]).encrypt(nonce, blob, _ENC_AAD)
        return ENC_MAGIC + nonce + ct

    def _unseal(self, raw: bytes) -> Optional[bytes]:
        """Inverse of _seal; None = reject (plaintext under a keyring,
        sealed without one, or no key authenticates — the
        GossipVerifyIncoming/Outgoing contract)."""
        sealed = raw.startswith(ENC_MAGIC)
        if not self.secret_keys:
            return None if sealed else raw
        if not sealed:
            return None  # keyring on → plaintext gossip is rejected
        from cryptography.exceptions import InvalidTag
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        nonce = raw[len(ENC_MAGIC) : len(ENC_MAGIC) + 12]
        ct = raw[len(ENC_MAGIC) + 12 :]
        for key in self.secret_keys:  # any keyring member may authenticate
            try:
                return AESGCM(key).decrypt(nonce, ct, _ENC_AAD)
            except InvalidTag:
                continue
        return None

    def _merge(self, blob: dict) -> None:
        changed = False
        for row in blob.get("members", []):
            name = row.get("name")
            if not name:
                continue
            inc = Member(
                name=name,
                peer=row.get("peer", {}),
                incarnation=int(row.get("incarnation", 0)),
                heartbeat=int(row.get("heartbeat", 0)),
                dead=bool(row.get("dead", False)),
            )
            if name == self.name:
                # someone claims we're dead/stale — refute by out-incarnating
                # (the memberlist Alive/refute rule)
                if inc.dead and inc.incarnation >= self._self.incarnation:
                    self._self.incarnation = inc.incarnation + 1
                    changed = True
                continue
            cur = self._members.get(name)
            if cur is None or inc.dominates(cur):
                inc.age_ticks = 0
                if cur is None and not inc.dead:
                    log.info("%s: join %s", self.name, name)
                self._members[name] = inc
                changed = True
        if changed:
            self._publish()

    def _publish(self) -> None:
        alive = [m for m in self._members.values() if not m.dead]
        key = sorted(m.name for m in alive)
        if key == self._last_published:
            return
        self._last_published = key
        peers = [
            PeerInfo(
                grpc_address=m.peer.get("grpc_address", m.name),
                http_address=m.peer.get("http_address", ""),
                data_center=m.peer.get("data_center", ""),
                is_owner=(m.name == self.name),
            )
            for m in alive
        ]
        self.on_update(peers)

    # ------------------------------------------------------------- transport
    @staticmethod
    async def _read_blob(reader) -> bytes:
        """Read the peer's whole state blob (terminated by write_eof). A bare
        read() returns after the FIRST segment, so multi-segment blobs (any
        non-trivial member count) would parse partially — loop to EOF."""
        chunks = []
        total = 0
        while total <= MAX_STATE_BYTES:
            chunk = await reader.read(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
            total += len(chunk)
        return b"".join(chunks)

    async def _handle(self, reader, writer) -> None:
        """Push-pull: read the remote table, merge, answer with ours."""
        try:
            raw = await asyncio.wait_for(self._read_blob(reader), 5.0)
            blob = self._unseal(raw)
            if blob is None:
                return  # unauthenticated gossip is dropped silently
            remote = json.loads(blob.decode())
            writer.write(self._state_blob())
            await writer.drain()
            writer.write_eof()
            self._merge(remote)
        except (asyncio.TimeoutError, ValueError, OSError):
            pass
        finally:
            writer.close()

    async def _push_pull(self, addr: str) -> bool:
        host, _, port = addr.rpartition(":")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host or "127.0.0.1", int(port)), 2.0
            )
        except (OSError, asyncio.TimeoutError, ValueError):
            return False
        try:
            writer.write(self._state_blob())
            await writer.drain()
            writer.write_eof()
            raw = await asyncio.wait_for(self._read_blob(reader), 5.0)
            blob = self._unseal(raw)
            if blob is None:
                return False
            self._merge(json.loads(blob.decode()))
            return True
        except (OSError, asyncio.TimeoutError, ValueError):
            return False
        finally:
            writer.close()

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        host, _, port = self.bind_address.rpartition(":")
        self._server = await asyncio.start_server(
            self._handle, host or "127.0.0.1", int(port)
        )
        self.gossip_port = self._server.sockets[0].getsockname()[1]
        if self.bind_address.endswith(":0"):
            self.bind_address = f"{host or '127.0.0.1'}:{self.gossip_port}"
            if self.advertise_address.endswith(":0"):
                self.advertise_address = self.bind_address
                self.name = self._self.name = self.advertise_address
                self._members = {self.name: self._self}
        # join: sync with every seed, retrying like the reference's 300 ms
        # join loop (memberlist.go:178-192); non-fatal if all are down — the
        # gossip loop keeps trying
        for seed in self.known_nodes:
            if seed != self.advertise_address:
                await self._push_pull(seed)
        self._publish()
        self._task = asyncio.create_task(self._loop(), name="memberlist-gossip")

    async def _loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self.interval_s)
            try:
                self._tick()
                targets = [
                    m.name for m in self._members.values()
                    if m.name != self.name and not m.dead
                ] or [s for s in self.known_nodes if s != self.advertise_address]
                if targets:
                    await self._push_pull(self._rng.choice(targets))
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("gossip tick failed")

    def _tick(self) -> None:
        self._self.heartbeat += 1
        expired = []
        reap = []
        for m in self._members.values():
            if m.name == self.name:
                continue
            m.age_ticks += 1
            if not m.dead and m.age_ticks > self.suspect_ticks:
                expired.append(m.name)
            elif m.dead and m.age_ticks > 8 * self.suspect_ticks:
                # the tombstone has gossiped long enough — reap it, or the
                # state blob grows forever under identity churn (pod restarts
                # mint fresh names) and eventually overflows MAX_STATE_BYTES,
                # wedging every future push-pull
                reap.append(m.name)
        for name in expired:
            log.info("%s: suspect-timeout %s", self.name, name)
            self._members[name].dead = True
        for name in reap:
            del self._members[name]
        if expired:
            self._publish()

    async def close(self) -> None:
        """Graceful leave: tombstone ourselves and tell live peers."""
        if self._closed:
            return
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._self.incarnation += 1
        self._self.dead = True
        for m in list(self._members.values()):
            if m.name != self.name and not m.dead:
                await self._push_pull(m.name)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

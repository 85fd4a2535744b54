"""Etcd peer discovery — register self under a key prefix with a kept-alive
lease; watch the prefix for the peer set (the port of
``gubernator_tpu/discovery/etcd.py``).

Mirrors reference etcd.go:221-315: each node PUTs its PeerInfo JSON at
`<prefix><advertise-address>` bound to a TTL lease (30 s default), keeps the
lease alive at TTL/2 cadence, re-grants + re-registers if the lease is lost,
and on close deletes its key and revokes the lease so peers see it disappear
immediately. Peer changes surface through a **watch stream** on the prefix
(reference etcd.go:173-219) — each event triggers a fresh range read, so
membership changes propagate at event latency, not poll cadence; the range
poll stays on as a low-cadence fallback that also observes lease expiry
through an outage of the stream.

Speaks etcd's v3 HTTP/JSON gateway (`/v3/kv/*`, `/v3/lease/*`; keys/values
are base64 in JSON), so no etcd client library is required; the endpoint is
injectable and tests run an in-process fake.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Callable, Dict, List, Optional

import aiohttp

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator_tpu_torch.etcd")

DEFAULT_PREFIX = "/gubernator/peers/"  # reference etcd.go etcdKeyPrefix


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


def unmarshall_peer(value: str) -> PeerInfo:
    """PeerInfo from a stored JSON value; a bare address string is accepted
    for interop with old registrations (reference etcd.go:162-170)."""
    try:
        d = json.loads(value)
        return PeerInfo(
            grpc_address=d.get("grpc_address") or d.get("GRPCAddress", ""),
            http_address=d.get("http_address") or d.get("HTTPAddress", ""),
            data_center=d.get("data_center") or d.get("DataCenter", ""),
        )
    except (ValueError, AttributeError):
        return PeerInfo(grpc_address=value)


class EtcdPool:
    def __init__(
        self,
        endpoint: str,  # http(s)://host:port of any etcd gateway
        on_update: Callable[[List[PeerInfo]], None],
        peer_info: PeerInfo,
        key_prefix: str = DEFAULT_PREFIX,
        lease_ttl_s: int = 30,
        poll_ms: float = 2_000.0,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.on_update = on_update
        self.peer_info = peer_info
        self.key_prefix = key_prefix
        self.lease_ttl_s = lease_ttl_s
        self.poll_s = max(poll_ms / 1e3, 0.01)
        self.lease_id: Optional[int] = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._tasks: List[asyncio.Task] = []
        self._closed = False
        self._last: Optional[List[str]] = None
        # serializes _poll_once between the watch and poll loops: without it
        # a slow stale range read can land after a fresher watch-triggered
        # one and re-publish an outdated peer list
        self._poll_lock = asyncio.Lock()

    @property
    def _key(self) -> str:
        return self.key_prefix + self.peer_info.grpc_address

    def _prefix_range_end(self) -> str:
        """etcd successor key covering everything under the prefix."""
        return self.key_prefix[:-1] + chr(ord(self.key_prefix[-1]) + 1)

    async def _post(self, path: str, body: dict) -> dict:
        async with self._session.post(
            f"{self.endpoint}{path}", json=body, timeout=aiohttp.ClientTimeout(5)
        ) as resp:
            resp.raise_for_status()
            return await resp.json()

    # ------------------------------------------------------------- register
    async def _register(self) -> None:
        """Grant a lease and PUT our PeerInfo bound to it (etcd.go:221-266)."""
        got = await self._post("/v3/lease/grant", {"TTL": self.lease_ttl_s})
        self.lease_id = int(got["ID"])
        value = json.dumps(
            dict(
                grpc_address=self.peer_info.grpc_address,
                http_address=self.peer_info.http_address,
                data_center=self.peer_info.data_center,
            )
        )
        await self._post(
            "/v3/kv/put",
            {"key": _b64(self._key), "value": _b64(value), "lease": self.lease_id},
        )

    async def _keepalive_loop(self) -> None:
        """Refresh the lease at TTL/2; on failure re-grant + re-register
        (the reference re-registers on keepalive channel loss,
        etcd.go:286-315)."""
        while not self._closed:
            await asyncio.sleep(self.lease_ttl_s / 2)
            try:
                got = await self._post(
                    "/v3/lease/keepalive", {"ID": self.lease_id}
                )
                ttl = int(got.get("result", {}).get("TTL", 0))
                if ttl <= 0:
                    raise RuntimeError("lease lost")
            except asyncio.CancelledError:
                raise
            except Exception:
                if self._closed:
                    return
                log.warning("etcd keepalive failed; re-registering")
                try:
                    await self._register()
                except Exception:
                    log.exception("etcd re-register failed")

    # ----------------------------------------------------------------- watch
    async def _collect_peers(self) -> Optional[Dict[str, PeerInfo]]:
        try:
            got = await self._post(
                "/v3/kv/range",
                {
                    "key": _b64(self.key_prefix),
                    "range_end": _b64(self._prefix_range_end()),
                },
            )
        except Exception:
            return None  # transient outage: keep the stale list
        out: Dict[str, PeerInfo] = {}
        for kv in got.get("kvs", []):
            info = unmarshall_peer(_unb64(kv["value"]))
            if info.grpc_address:
                out[info.grpc_address] = info
        return out

    async def _poll_loop(self) -> None:
        while not self._closed:
            try:
                await self._poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("etcd poll failed")
            await asyncio.sleep(self.poll_s)

    async def _poll_once(self) -> None:
        async with self._poll_lock:
            await self._poll_once_locked()

    async def _poll_once_locked(self) -> None:
        peers = await self._collect_peers()
        if peers is None:
            return
        key = sorted(peers)
        if key == self._last:
            return
        self._last = key
        for info in peers.values():
            info.is_owner = info.grpc_address == self.peer_info.grpc_address
        self.on_update(list(peers.values()))

    async def _watch_loop(self) -> None:
        """Hold a watch stream on the key prefix (reference etcd.go:173-219,
        via the v3 gateway's server-streaming /v3/watch). Events are change
        NOTIFIERS: each one triggers a range re-read, so watch-vs-state
        consistency never depends on replaying incremental events. Reconnects
        with backoff; the poll loop covers any stream outage."""
        body = {
            "create_request": {
                "key": _b64(self.key_prefix),
                "range_end": _b64(self._prefix_range_end()),
            }
        }
        backoff = 0.05
        while not self._closed:
            try:
                async with self._session.post(
                    f"{self.endpoint}/v3/watch",
                    json=body,
                    timeout=aiohttp.ClientTimeout(total=None),
                ) as resp:
                    resp.raise_for_status()
                    backoff = 0.05
                    async for line in resp.content:
                        if self._closed:
                            return
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            msg = json.loads(line)
                        except ValueError:
                            continue
                        if msg.get("result", {}).get("events"):
                            await self._poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                if self._closed:
                    return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._session = aiohttp.ClientSession()
        await self._register()
        await self._poll_once()
        self._tasks = [
            asyncio.create_task(self._keepalive_loop(), name="etcd-keepalive"),
            asyncio.create_task(self._poll_loop(), name="etcd-poll"),
            asyncio.create_task(self._watch_loop(), name="etcd-watch"),
        ]

    async def close(self) -> None:
        """Deregister: delete our key + revoke the lease (etcd.go:297-309)."""
        if self._closed:
            return
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        try:
            await self._post("/v3/kv/deleterange", {"key": _b64(self._key)})
            if self.lease_id is not None:
                await self._post("/v3/lease/revoke", {"ID": self.lease_id})
        except Exception:
            pass  # best effort; the lease TTL cleans up
        if self._session is not None:
            await self._session.close()

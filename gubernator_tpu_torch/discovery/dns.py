"""DNS peer discovery — poll A/AAAA records of one or more FQDNs (the port
of ``gubernator_tpu/discovery/dns.py``).

Mirrors reference dns.go:160-277: poll at a fixed cadence, build the peer list
from resolved IPs (the FQDN doubles as the datacenter label in multi-DC mode,
dns.go:112-136), mark self by address match, and NEVER clear the peer list on
an empty/failed response — a resolver blip must not drop the cluster
(dns.go:253-264).

The resolver is injectable so tests run against an in-process fake
(reference dns_test.go:81-294 does the same with a local DNS server).
"""

from __future__ import annotations

import asyncio
import socket
from typing import Callable, List, Optional

from gubernator_tpu_torch.types import PeerInfo


def system_resolver(fqdn: str, port: str) -> List[str]:
    """Resolve A/AAAA records → ip:port list (blocking; called in executor)."""
    out = []
    for family, _, _, _, sockaddr in socket.getaddrinfo(
        fqdn, None, proto=socket.IPPROTO_TCP
    ):
        ip = sockaddr[0]
        if family == socket.AF_INET6:
            out.append(f"[{ip}]:{port}")
        else:
            out.append(f"{ip}:{port}")
    return sorted(set(out))


class DNSPool:
    """Polling discovery pool; calls on_update(peers) when the set changes."""

    def __init__(
        self,
        fqdn: str,
        poll_ms: float,
        on_update: Callable[[List[PeerInfo]], None],
        self_address: str,
        http_address: str = "",
        data_center: str = "",
        resolver: Optional[Callable[[str, str], List[str]]] = None,
    ):
        # multiple FQDNs comma-separated; each may carry its own DC label as
        # fqdn=dc (multi-DC mode, reference dns.go:112-136 uses the FQDN
        # itself; the explicit label keeps tests deterministic)
        self.fqdns = [f.strip() for f in fqdn.split(",") if f.strip()]
        self.poll_s = max(poll_ms / 1e3, 0.01)
        self.on_update = on_update
        self.self_address = self_address
        self.http_address = http_address
        self.data_center = data_center
        self.resolver = resolver or system_resolver
        self._task: Optional[asyncio.Task] = None
        self._last: List[str] = []
        self._closed = False
        port = self_address.rsplit(":", 1)[-1] if ":" in self_address else "1051"
        self.port = port

    async def start(self) -> None:
        await self._poll_once()
        self._task = asyncio.create_task(self._loop(), name="dns-pool")

    async def _loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self.poll_s)
            await self._poll_once()

    async def _poll_once(self) -> None:
        loop = asyncio.get_running_loop()
        addrs: List[tuple] = []
        for entry in self.fqdns:
            fqdn, _, dc = entry.partition("=")
            try:
                got = await loop.run_in_executor(
                    None, self.resolver, fqdn, self.port
                )
            except Exception:
                got = []
            addrs.extend((a, dc or self.data_center) for a in got)
        if not addrs:
            return  # keep the stale list (reference dns.go:253-264)
        flat = sorted(a for a, _ in addrs)
        if flat == self._last:
            return
        self._last = flat
        peers = [
            PeerInfo(
                grpc_address=a,
                http_address=self.http_address,
                data_center=dc,
                is_owner=(a == self.self_address),
            )
            for a, dc in addrs
        ]
        self.on_update(peers)

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

"""Kubernetes peer discovery — EndpointSlices (default) or Pods (the port of
``gubernator_tpu/discovery/kubernetes.py``).

Mirrors reference kubernetes.go:79-114 + 214-313: watch the objects that
track the gubernator Service, extract ready addresses with **pure functions**
(unit-testable on fixture JSON, as the reference tests them), mark self by
pod IP, and rebuild the peer list on every change. Not-ready endpoints are
skipped UNLESS they are self — a booting pod must still see itself
(kubernetes.go:281-289).

Speaks the Kubernetes REST API directly over aiohttp with **list + watch**
(the reference's SharedIndexInformer pattern, kubernetes.go:79-114): the list
records a resourceVersion, a watch stream from that version turns every
ADDED/MODIFIED/DELETED event into a fresh list+extract, and a low-cadence
poll remains as the informer-resync fallback. No kubernetes client library
is required. In-cluster config comes from the standard service-account
mount; the API URL/token are injectable and tests run an in-process fake
API server.
"""

from __future__ import annotations

import asyncio
import logging
import ssl
from typing import Callable, List, Optional

import aiohttp

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator_tpu_torch.k8s")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


# ------------------------------------------------------------ pure extraction


def extract_peers_from_endpoint_slices(
    slices: List[dict], pod_ip: str, pod_port: str
) -> List[PeerInfo]:
    """EndpointSlice JSON objects → peers (reference
    ExtractPeersFromEndpointSlices, kubernetes.go:266-313)."""
    peer_map = {}
    for slice_ in slices:
        if slice_.get("addressType", "IPv4") != "IPv4":
            continue
        for endpoint in slice_.get("endpoints") or []:
            addrs = endpoint.get("addresses") or []
            if not addrs:
                continue
            ip = addrs[0]
            conditions = endpoint.get("conditions") or {}
            is_ready = conditions.get("ready") is not False
            is_owner = ip == pod_ip
            if not is_ready and not is_owner:
                continue
            peer = PeerInfo(grpc_address=f"{ip}:{pod_port}", is_owner=is_owner)
            existing = peer_map.get(ip)
            if existing is not None:
                if not existing.is_owner and is_owner:
                    peer_map[ip] = peer
                continue
            peer_map[ip] = peer
    return list(peer_map.values())


def extract_peers_from_pods(
    pods: List[dict], pod_ip: str, pod_port: str
) -> List[PeerInfo]:
    """Pod JSON objects → peers (reference ExtractPeersFromPods,
    kubernetes.go:214-245): a pod counts when Running with condition
    Ready=True, or when it is self."""
    out = []
    for pod in pods:
        status = pod.get("status") or {}
        ip = status.get("podIP", "")
        if not ip:
            continue
        is_owner = ip == pod_ip
        ready = status.get("phase") == "Running" and any(
            c.get("type") == "Ready" and c.get("status") == "True"
            for c in status.get("conditions") or []
        )
        if not ready and not is_owner:
            continue
        out.append(PeerInfo(grpc_address=f"{ip}:{pod_port}", is_owner=is_owner))
    return out


# --------------------------------------------------------------------- pool


class K8sPool:
    def __init__(
        self,
        on_update: Callable[[List[PeerInfo]], None],
        pod_ip: str,
        pod_port: str,
        namespace: str = "default",
        selector: str = "",  # REQUIRED label selector (the reference keys
        # endpointslices on kubernetes.io/service-name, kubernetes.go:181-193)
        mechanism: str = "endpointslices",  # or "pods"
        api_url: str = "",  # override for tests; default in-cluster
        token: str = "",
        poll_ms: float = 5_000.0,
        ca_file: str = "",
    ):
        if mechanism not in ("endpointslices", "pods"):
            raise ValueError(f"unknown k8s watch mechanism {mechanism!r}")
        self.on_update = on_update
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.namespace = namespace
        self.selector = selector
        self.mechanism = mechanism
        self.poll_s = max(poll_ms / 1e3, 0.01)
        self._api_url = api_url
        self._token = token
        self._ca_file = ca_file
        self._session: Optional[aiohttp.ClientSession] = None
        self._task: Optional[asyncio.Task] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._closed = False
        self._last: Optional[List[str]] = None
        self._rv: str = ""  # list resourceVersion the watch resumes from
        # serializes _poll_once between the watch and resync loops (a stale
        # in-flight list must not clobber a fresher watch-triggered update)
        self._poll_lock = asyncio.Lock()

    def _in_cluster(self) -> None:
        """Default to the standard in-cluster config (env + SA mount)."""
        import os

        if not self._api_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a cluster: KUBERNETES_SERVICE_HOST unset and no "
                    "api_url override"
                )
            self._api_url = f"https://{host}:{port}"
        if not self._token and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                self._token = f.read().strip()
        if not self._ca_file and os.path.exists(f"{SA_DIR}/ca.crt"):
            self._ca_file = f"{SA_DIR}/ca.crt"

    @property
    def _path(self) -> str:
        if self.mechanism == "endpointslices":
            return f"/apis/discovery.k8s.io/v1/namespaces/{self.namespace}/endpointslices"
        return f"/api/v1/namespaces/{self.namespace}/pods"

    async def _list(self) -> Optional[List[dict]]:
        params = {"labelSelector": self.selector} if self.selector else {}
        headers = (
            {"Authorization": f"Bearer {self._token}"} if self._token else {}
        )
        try:
            async with self._session.get(
                f"{self._api_url}{self._path}",
                params=params,
                headers=headers,
                timeout=aiohttp.ClientTimeout(10),
            ) as resp:
                resp.raise_for_status()
                body = await resp.json()
                rv = (body.get("metadata") or {}).get("resourceVersion")
                if rv:
                    self._rv = rv
                return body.get("items", [])
        except Exception:
            return None  # keep the stale peer list over a transient API error

    async def _poll_once(self) -> None:
        async with self._poll_lock:
            await self._poll_once_locked()

    async def _poll_once_locked(self) -> None:
        items = await self._list()
        if items is None:
            return
        if self.mechanism == "endpointslices":
            peers = extract_peers_from_endpoint_slices(
                items, self.pod_ip, self.pod_port
            )
        else:
            peers = extract_peers_from_pods(items, self.pod_ip, self.pod_port)
        key = sorted(p.grpc_address for p in peers)
        if key == self._last:
            return
        self._last = key
        self.on_update(peers)

    async def _loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self.poll_s)
            try:
                await self._poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("k8s poll failed")

    async def _watch_loop(self) -> None:
        """list+watch (reference kubernetes.go:79-114 informer pattern): a
        watch stream from the last list's resourceVersion; every membership
        event triggers a fresh list+extract, so propagation is event-latency
        while correctness never depends on replaying incremental events.
        Reconnects with backoff; the resync poll covers stream outages."""
        import json

        backoff = 0.05
        while not self._closed:
            try:
                params = {"watch": "1"}
                if self.selector:
                    params["labelSelector"] = self.selector
                if self._rv:
                    params["resourceVersion"] = self._rv
                headers = (
                    {"Authorization": f"Bearer {self._token}"}
                    if self._token
                    else {}
                )
                async with self._session.get(
                    f"{self._api_url}{self._path}",
                    params=params,
                    headers=headers,
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
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        obj = ev.get("object") or {}
                        rv = (obj.get("metadata") or {}).get("resourceVersion")
                        if rv:
                            self._rv = rv
                        if ev.get("type") in ("ADDED", "MODIFIED", "DELETED"):
                            await self._poll_once()
                        elif ev.get("type") == "ERROR":
                            self._rv = ""  # expired RV: next watch relists
                            break
            except asyncio.CancelledError:
                raise
            except Exception:
                if self._closed:
                    return
                # the resourceVersion may be the reason the watch was
                # rejected (HTTP 410 on an expired RV); drop it so the next
                # attempt starts from current state instead of retrying a
                # dead version forever
                self._rv = ""
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    async def start(self) -> None:
        self._in_cluster()
        ssl_ctx = None
        if self._api_url.startswith("https") and self._ca_file:
            ssl_ctx = ssl.create_default_context(cafile=self._ca_file)
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=ssl_ctx)
        )
        await self._poll_once()
        self._task = asyncio.create_task(self._loop(), name="k8s-pool")
        self._watch_task = asyncio.create_task(
            self._watch_loop(), name="k8s-watch"
        )

    async def close(self) -> None:
        self._closed = True
        for t in (self._task, self._watch_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        if self._session is not None:
            await self._session.close()

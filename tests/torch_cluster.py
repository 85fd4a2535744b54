"""In-process multi-daemon test cluster of the port's daemons — the twin of
tests/cluster.py over ``gubernator_tpu_torch.service.daemon.Daemon``.

Boots N port daemons in one process on 127.0.0.1 ephemeral ports, on the
CPU (``device="cpu"``) or over an engine each from ``engine_factory``,
with tests/cluster.daemon_config's settings (``port_config``) and explicit
set_peers. The surface is tests/cluster.py's: ``Cluster.start``,
``proxy_for``, ``find_owning_daemon``, ``non_owning_daemons``,
``restart``, ``stop``, and ``scrape``, ``metric_value``, ``wait_for``.
``chaos=True`` fronts each daemon's peer plane with tests/chaos.py's
ChaosProxy (pure asyncio). ``freeze_clock`` (and the ``frozen`` fixture)
pins ms_now in every module that reads it. Nothing here imports JAX or
the JAX package at import time, so a test on the card can use it too.
"""

from __future__ import annotations

import asyncio
import importlib
from typing import Callable, List, Optional

import pytest

from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
from gubernator_tpu_torch.service.daemon import Daemon
from gubernator_tpu_torch.types import PeerInfo


NOW = 1_700_000_000_000
# every module that reads the serving clock through its own ms_now name
CLOCK_MODULES = ("ops.engine", "service.batcher", "service.daemon", "service.runner",
                 "parallel.sharded", "parallel.global_sync")


def freeze_clock(monkeypatch, now: int = NOW,
                 packages=("gubernator_tpu", "gubernator_tpu_torch")) -> int:
    """Freeze ms_now at `now` in those of CLOCK_MODULES of each package
    named that read it."""
    for pkg in packages:
        for mod in CLOCK_MODULES:
            m = importlib.import_module(f"{pkg}.{mod}")
            if hasattr(m, "ms_now"):
                monkeypatch.setattr(m, "ms_now", lambda: now)
    return now


@pytest.fixture
def frozen(monkeypatch):
    """freeze_clock over both packages, for a test that compares them."""
    return freeze_clock(monkeypatch)


def port_config(dc: str = "", **overrides) -> DaemonConfig:
    """tests/cluster.daemon_config's settings in the port's config class."""
    conf = DaemonConfig(
        grpc_address="127.0.0.1:0", http_address="127.0.0.1:0", data_center=dc,
        cache_size=8192,
        behaviors=BehaviorConfig(batch_wait_ms=1.0, global_sync_wait_ms=50.0,
                                 batch_timeout_ms=5000.0, global_timeout_ms=5000.0),
    )
    for k, v in overrides.items():
        setattr(conf, k, v)
    return conf


class Cluster:
    def __init__(self, daemons: List[Daemon], proxies: Optional[list] = None,
                 engine_factory: Optional[Callable] = None):
        self.daemons = daemons
        # chaos=True: proxies[i] fronts daemons[i]'s peer traffic
        self.proxies = proxies or [None] * len(daemons)
        self.engine_factory = engine_factory

    @staticmethod
    async def _spawn(conf: DaemonConfig, engine_factory, **kw) -> Daemon:
        if engine_factory is None:
            return await Daemon.spawn(conf, device="cpu", **kw)
        return await Daemon.spawn(conf, engine=engine_factory(), **kw)

    @classmethod
    async def start(
        cls,
        n: int,
        dcs: Optional[List[str]] = None,
        chaos: bool = False,
        engine_factory: Optional[Callable] = None,
        event_channels: Optional[list] = None,
        **overrides,
    ):
        """Start n port daemons (optionally with per-daemon datacenter
        labels, an engine each from `engine_factory`, an event channel
        each) and wire them together with explicit set_peers. chaos=True:
        each daemon advertises its ChaosProxy's address, so every other
        daemon's forwards, hit syncs and broadcasts flow through it; direct
        client traffic bypasses the proxy."""
        dcs = dcs or [""] * n
        proxies = [None] * n
        daemons = []
        for i in range(n):
            conf_kw = dict(overrides)
            if chaos:
                from tests.chaos import ChaosProxy

                proxies[i] = await ChaosProxy().start()
                conf_kw["advertise_address"] = proxies[i].address
            kw = {}
            if event_channels is not None:
                kw["event_channel"] = event_channels[i]
            daemons.append(await cls._spawn(port_config(dc=dcs[i], **conf_kw),
                                            engine_factory, **kw))
            if chaos:
                host, _, port = daemons[i].conf.grpc_address.rpartition(":")
                proxies[i].set_target(host, int(port))
        c = cls(daemons, proxies, engine_factory)
        c.wire()
        return c

    def wire(self) -> None:
        peers = [d.peer_info() for d in self.daemons]
        for d in self.daemons:
            # fresh PeerInfo copies: set_peers mutates is_owner per daemon
            d.set_peers([PeerInfo(**vars(p)) for p in peers])

    def proxy_for(self, daemon: Daemon):
        """The ChaosProxy fronting `daemon`'s peer traffic."""
        return self.proxies[self.daemons.index(daemon)]

    def find_owning_daemon(self, name: str, key: str) -> Daemon:
        hk = name + "_" + key
        owner = self.daemons[0].get_peer(hk)
        for d in self.daemons:
            if d.conf.advertise_address == owner.grpc_address:
                return d
        raise AssertionError(f"no daemon owns {hk}")

    def non_owning_daemons(self, name: str, key: str) -> List[Daemon]:
        owner = self.find_owning_daemon(name, key)
        return [d for d in self.daemons if d is not owner]

    async def restart(self, i: int) -> Daemon:
        """Stop and respawn daemon i with the same config (and a fresh
        engine from the factory)."""
        old = self.daemons[i]
        await old.close()
        self.daemons[i] = await self._spawn(old.conf, self.engine_factory)
        self.wire()
        return self.daemons[i]

    async def stop(self) -> None:
        await asyncio.gather(*(d.close() for d in self.daemons))
        await asyncio.gather(*(p.stop() for p in self.proxies if p is not None))


async def scrape(daemon: Daemon) -> dict:
    """GET the daemon's /metrics endpoint and parse it with the port's
    parser."""
    import aiohttp

    from gubernator_tpu_torch.service.metrics import parse_metrics

    url = f"http://{daemon.conf.http_address}/metrics"
    async with aiohttp.ClientSession() as s:
        async with s.get(url) as resp:
            assert resp.status == 200
            return parse_metrics(await resp.text())


def metric_value(scraped: dict, name: str, **labels) -> float:
    fam = scraped.get(name, {})
    want = tuple(sorted(labels.items()))
    for labelset, value in fam.items():
        if all(kv in labelset for kv in want):
            return value
    return 0.0


async def wait_for(predicate, timeout_s: float = 5.0, interval_s: float = 0.05):
    """Poll an async predicate until truthy."""
    deadline = asyncio.get_running_loop().time() + timeout_s
    while True:
        val = await predicate()
        if val:
            return val
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("condition not met before timeout")
        await asyncio.sleep(interval_s)

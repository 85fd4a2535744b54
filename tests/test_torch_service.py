"""The port's daemon of one data center against the JAX package's, over live
listeners on 127.0.0.1:0 with the clock frozen in both packages.

- One seeded sequence of GetRateLimits calls through a port daemon and a
  JAX daemon, each call over gRPC and as HTTP JSON: byte-equal responses,
  equal HealthCheck (addresses aside) and LiveCheck, the same /metrics
  families and request counters.
- A mixed ring (one JAX daemon, two port daemons, wired by set_peers):
  one owner per key whichever daemon is asked, GLOBAL convergence, and a
  set_peers that drops a port daemon hands its rows off with the counters
  intact — the port held to the peer wire both ways.
- LeaseQuota over gRPC and HTTP and /v1/debug/leases; each discovery type
  starts its pool; the supports_grow repair; the entry point imports
  nothing of JAX and serves over HTTP, also with the checkpoint, ring and
  tier planes on (tests/test_torch_planes.py, tests/test_torch_region.py,
  tests/test_torch_leases.py and tests/test_torch_discovery.py hold those
  planes to the JAX package's).
"""

import asyncio
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import grpc
import numpy as np
import pytest
from aiohttp import ClientSession
from google.protobuf import json_format

from gubernator_tpu.client import V1Client
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch.ops.engine import LocalEngine as TEngine
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.service.metrics import parse_metrics
from gubernator_tpu_torch.types import PeerInfo as TPeer

from tests.cluster import daemon_config
from tests.torch_cluster import port_config

REPO = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000_000
CLOCK_MODULES = ("ops.engine", "service.batcher", "service.daemon")


def async_test(fn):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        asyncio.run(fn(*a, **k))

    return wrapper


@pytest.fixture
def frozen(monkeypatch):
    """Freeze ms_now in both packages' engine, batcher and daemon."""
    import importlib

    for pkg in ("gubernator_tpu", "gubernator_tpu_torch"):
        for mod in CLOCK_MODULES:
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"), "ms_now",
                                lambda: NOW)
    return NOW


def _sequence(rng, n_calls: int):
    """Seeded GetRateLimits calls: the five algorithms, Gregorian,
    RESET_REMAINING, DRAIN_OVER_LIMIT, MULTI_REGION, cascades, per-item
    errors, an empty batch and one above max_batch_size. No GLOBAL: a
    daemon's broadcast re-reads its GLOBAL keys on its own timer, so their
    count would depend on timing (the mixed-ring test covers GLOBAL)."""
    calls = [[]]
    for c in range(n_calls):
        items = []
        for _ in range(int(rng.integers(1, 24))):
            k = int(rng.integers(0, 30))
            algo = int(rng.integers(0, 5))
            it = pb.RateLimitReq(name=f"s{k % 3}", unique_key=f"key{k}",
                                 hits=int(rng.integers(0, 4)), limit=int(rng.integers(1, 10)),
                                 duration=int(rng.integers(1, 5)) * 10_000, algorithm=algo)
            kind = int(rng.integers(0, 14))
            if kind == 0:
                it.name = ""
            elif kind == 1:
                it.unique_key = ""
            elif kind == 2:
                it.behavior = 4  # DURATION_IS_GREGORIAN (3 = weeks: an error)
                it.duration = int(rng.integers(0, 6))
            elif kind == 3:
                it.behavior = 8  # RESET_REMAINING
            elif kind == 4:
                it.behavior = 32  # DRAIN_OVER_LIMIT
            elif kind == 5:
                it.behavior = 16  # MULTI_REGION
            elif kind == 6:
                it.behavior = 64 | 8  # priority tier 1, RESET_REMAINING
            elif kind == 7:
                for lv in range(int(rng.integers(1, 3))):
                    it.cascade.add(name="tenant", unique_key=f"t{k % 4}-{lv}",
                                   limit=int(rng.integers(2, 20)), duration=60_000,
                                   algorithm=int(rng.integers(0, 4)))
            elif kind == 8:
                it.algorithm = 9  # invalid
            elif kind == 9 and algo in (1, 2):
                it.burst = it.limit + 2
            elif kind == 10:
                it.created_at = NOW - int(rng.integers(0, 300))
            elif kind == 11:
                it.behavior = 1  # NO_BATCHING
            items.append(it)
        calls.append(items)
        if c == n_calls // 2:
            calls.append([pb.RateLimitReq(name="big", unique_key=f"b{i}", hits=1, limit=5,
                                          duration=1000) for i in range(1001)])
    return calls


async def _grpc_raw(port: int, items):
    """One GetRateLimits over gRPC through the JAX package's client:
    (serialized response or None, status code name, details)."""
    client = V1Client(f"127.0.0.1:{port}", timeout_s=30)
    try:
        resp = await client.get_rate_limits(items)
        return resp.SerializeToString(), "OK", ""
    except grpc.aio.AioRpcError as exc:
        return None, exc.code().name, exc.details()
    finally:
        await client.close()


async def _http(session, port: int, items):
    body = json_format.MessageToDict(pb.GetRateLimitsReq(requests=items),
                                     preserving_proto_field_name=True)
    async with session.post(f"http://127.0.0.1:{port}/v1/GetRateLimits", json=body) as r:
        return r.status, await r.read()


@async_test
async def test_daemon_matches_jax_over_grpc_and_http(frozen):
    calls = _sequence(np.random.default_rng(21), 40)
    jd = await JDaemon.spawn(daemon_config())
    td = await TDaemon.spawn(port_config(), device="cpu")
    try:
        async with ClientSession() as s:
            for items in calls:
                g = [await _grpc_raw(d.grpc_port, items) for d in (jd, td)]
                assert g[1] == g[0], items[:3]
                h = [await _http(s, d.http_port, items) for d in (jd, td)]
                assert h[1] == h[0], items[:3]
            hc = []
            for d in (jd, td):
                client = V1Client(f"127.0.0.1:{d.grpc_port}")
                r = await client.health_check()
                live = await client.live_check()
                await client.close()
                hc.append(live.SerializeToString())
                async with s.get(f"http://127.0.0.1:{d.http_port}/v1/LiveCheck") as resp:
                    hc.append((resp.status, await resp.read()))
                r.advertise_address = ""
                hc.append(r.SerializeToString())
                async with s.get(f"http://127.0.0.1:{d.http_port}/v1/HealthCheck") as resp:
                    body = json.loads(await resp.read())
                body.pop("advertise_address")
                hc.append(body)
            assert hc[4:] == hc[:4]
            metrics = []
            for d in (jd, td):
                async with s.get(f"http://127.0.0.1:{d.http_port}/metrics") as resp:
                    metrics.append(parse_metrics((await resp.read()).decode()))
    finally:
        await td.close()
        await jd.close()
    jm, tm = metrics
    assert set(tm) == set(jm)
    for fam in ("gubernator_grpc_request_counts_total", "gubernator_over_limit_counter_total",
                "gubernator_tpu_decisions_total", "gubernator_tpu_cascade_depth_count"):
        assert tm.get(fam) and tm.get(fam) == jm.get(fam), fam


class _Ring:
    """One JAX daemon and two port daemons wired by set_peers."""

    def __init__(self, daemons):
        self.daemons = daemons

    @classmethod
    async def start(cls):
        ds = [await JDaemon.spawn(daemon_config())]
        for _ in range(2):
            ds.append(await TDaemon.spawn(port_config(), device="cpu"))
        ring = cls(ds)
        ring.wire(ds)
        return ring

    def wire(self, members):
        addrs = [(d.conf.advertise_address, d.conf.http_address) for d in members]
        for d in self.daemons:
            cls = JPeer if isinstance(d, JDaemon) else TPeer
            d.set_peers([cls(grpc_address=a, http_address=h) for a, h in addrs])

    async def close(self):
        for d in self.daemons:
            await d.close()


async def _ask(d, name, key, hits, limit=1000, behavior=0):
    r = await _grpc_raw(d.grpc_port, [pb.RateLimitReq(
        name=name, unique_key=key, hits=hits, limit=limit, duration=600_000,
        behavior=behavior)])
    assert r[1] == "OK", r
    return pb.GetRateLimitsResp.FromString(r[0]).responses[0]


@async_test
async def test_mixed_ring_owners_global_and_handoff(frozen):
    rng = np.random.default_rng(22)
    ring = await _Ring.start()
    ds = ring.daemons
    try:
        keys = [f"r{i}" for i in range(48)]
        hits = {k: 0 for k in keys}
        for _ in range(3):
            for k in keys:
                h = int(rng.integers(1, 4))
                hits[k] += h
                await _ask(ds[int(rng.integers(0, 3))], "ring", k, h)
        # one owner per key: every daemon reads the same remaining
        for k in keys:
            got = [(await _ask(d, "ring", k, 0)).remaining for d in ds]
            assert got == [1000 - hits[k]] * 3, (k, got)
        owners = {k: ds[0].get_peer("ring_" + k).grpc_address for k in keys}
        assert all(d.get_peer("ring_" + k).grpc_address == owners[k] for d in ds for k in keys)
        assert len(set(owners.values())) == 3

        # GLOBAL: hits at non-owners reach the owner, broadcasts reach all
        g = [f"g{i}" for i in range(6)]
        for i, k in enumerate(g):
            for d in ds:
                await _ask(d, "glob", k, 1 + i % 2, behavior=2)
        await asyncio.sleep(0.6)  # global_sync_wait_ms 50: a few sync rounds
        for i, k in enumerate(g):
            want = 1000 - 3 * (1 + i % 2)
            got = [(await _ask(d, "glob", k, 0, behavior=2)).remaining for d in ds]
            assert got == [want] * 3, (k, got)

        # drop the second port daemon: its rows move to their new owners
        gone = ds[2]
        moved = [k for k in keys if owners[k] == gone.conf.advertise_address]
        assert moved
        ring.wire(ds[:2])
        await asyncio.gather(*gone._handoff_tasks)
        assert gone.handoff.rounds >= 1
        for k in moved:
            got = [(await _ask(d, "ring", k, 0)).remaining for d in ds[:2]]
            assert got == [1000 - hits[k]] * 2, (k, got)
    finally:
        await ring.close()


@async_test
async def test_lease_rpcs_answer_over_grpc_and_http():
    """LeaseQuota over gRPC and as HTTP JSON, and /v1/debug/leases, on a port
    daemon: a grant, a return by the HTTP door, a bad request's 400."""
    d = await TDaemon.spawn(port_config(data_center="dc1"), device="cpu")
    client = V1Client(f"127.0.0.1:{d.grpc_port}", timeout_s=30)
    try:
        got = await client.lease_quota(pb.LeaseQuotaReq(
            name="lq", unique_key="k", tokens=20, limit=100, duration=60_000, ttl_ms=5_000))
        assert got.granted == 20 and got.outstanding == 20 and got.lease_id
        async with ClientSession() as s:
            base = f"http://127.0.0.1:{d.http_port}"
            body = {"name": "lq", "unique_key": "k", "return_tokens": "5", "limit": "100",
                    "duration": "60000", "lease_id": got.lease_id}
            async with s.post(base + "/v1/LeaseQuota", json=body) as r:
                assert r.status == 200
                back = await r.json()
            assert back["outstanding"] == "15" and back["remaining"] == "85"
            async with s.post(base + "/v1/LeaseQuota", json={"bogus": 1}) as r:
                assert r.status == 400
            async with s.get(base + "/v1/debug/leases") as r:
                dbg = await r.json()
            assert dbg["outstanding_tokens_total"] == 15 and dbg["ops"]["returns"] == 1
            async with s.get(base + "/v1/debug/pipeline") as r:
                assert r.status == 200 and (await r.json())["parser"] == "native"
    finally:
        await client.close()
        await d.close()


@pytest.mark.parametrize("kind", ["dns", "etcd", "k8s", "member-list"])
@async_test
async def test_discovery_type_starts_its_pool(kind, monkeypatch, tmp_path):
    """Each GUBER_PEER_DISCOVERY_TYPE starts the pool the JAX daemon starts
    for it (etcd and k8s against the in-process fakes of
    tests/test_discovery.py, DNS with a stub resolver), the pool's first
    answer reaches the ring, and close stops the pool."""
    from gubernator_tpu_torch.discovery import dns as tdns
    from gubernator_tpu_torch.discovery import kubernetes as tk8s

    from tests.test_discovery import FakeEtcd, _fake_k8s_api, _slice

    fake = runner = None
    kw = {"peer_discovery_type": kind}
    if kind == "dns":
        monkeypatch.setattr(tdns, "system_resolver", lambda fqdn, port: [f"127.0.0.1:{port}"])
        kw.update(dns_fqdn="gubernator.svc", grpc_address="127.0.0.1:0",
                  advertise_address="127.0.0.1:0")
    elif kind == "etcd":
        fake = FakeEtcd()
        await fake.start()
        kw.update(etcd_endpoint=fake.url, etcd_poll_ms=50.0)
    elif kind == "k8s":
        state = {"items": [_slice([{"addresses": ["10.9.0.1"], "conditions": {"ready": True}}])]}
        url, runner, notify = await _fake_k8s_api(state)
        kw.update(k8s_pod_ip="10.9.0.1", k8s_selector="app=gubernator", k8s_api_url=url,
                  k8s_pod_port="1051")
        (tmp_path / "token").write_text("test-token")  # the service-account mount
        monkeypatch.setattr(tk8s, "SA_DIR", str(tmp_path))
    else:
        kw.update(memberlist_address="127.0.0.1:0", memberlist_gossip_interval_ms=50.0)
    d = await TDaemon.spawn(port_config(**kw), device="cpu")
    try:
        module = {"k8s": "kubernetes", "member-list": "memberlist"}.get(kind, kind)
        assert type(d._pool).__module__ == f"gubernator_tpu_torch.discovery.{module}"
        want = {"k8s": "10.9.0.1:1051"}.get(kind, d.conf.advertise_address)
        assert [p.grpc_address for p in d.local_peers()] == [want]
    finally:
        await d.close()
        assert d._pool._closed
        if runner is not None:
            notify()
            await runner.cleanup()
        if fake is not None:
            await fake.stop()


@async_test
async def test_port_engine_grows_under_either_daemon():
    """The repair of supports_grow: with cache_max_size = 2 × cache_size the
    daemon starts its auto-grow loop over a port LocalEngine (it used to
    log that the engine cannot grow)."""
    assert TEngine.supports_grow
    jd = await JDaemon.spawn(daemon_config(cache_size=4096, cache_max_size=8192),
                             engine=TEngine(capacity=4096, device="cpu"))
    td = await TDaemon.spawn(port_config(cache_size=4096, cache_max_size=8192), device="cpu")
    try:
        assert jd._maintenance_task is not None
        assert td._maintenance_task is not None
    finally:
        await jd.close()
        await td.close()


_SERVE = """
import asyncio, json, sys, urllib.request
from gubernator_tpu_torch.cmd.server import serve

def ready(d):
    async def go():
        body = json.dumps({"requests": [{"name": "t", "unique_key": "k", "hits": 1,
                                         "limit": 3, "duration": 60000}]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{d.http_port}/v1/GetRateLimits",
                                     data=body, method="POST")
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(None, lambda: urllib.request.urlopen(req).read())
        print(json.dumps({"resp": json.loads(out), "modules": sorted(sys.modules)}))
        stop.set()
    asyncio.get_running_loop().create_task(go())

async def main():
    global stop
    stop = asyncio.Event()
    await serve(stop=stop, ready=ready, device="cpu")

asyncio.run(main())
"""


def test_entry_point_serves_without_jax(tmp_path):
    env = dict(os.environ, GUBER_GRPC_ADDRESS="127.0.0.1:0", GUBER_HTTP_ADDRESS="127.0.0.1:0",
               GUBER_CACHE_SIZE="4096")
    planes = dict(GUBER_CHECKPOINT_PATH=str(tmp_path / "base.npz"),
                  GUBER_CHECKPOINT_INTERVAL_MS="200", GUBER_RING_ENABLE="true",
                  GUBER_TIER_ENABLED="true", GUBER_TIER_SPILL_PATH=str(tmp_path / "spill"))
    for extra in ({}, planes):
        out = subprocess.run([sys.executable, "-c", _SERVE], cwd=REPO, env=dict(env, **extra),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["resp"]["responses"][0]["remaining"] == "2"
        bad = [m for m in res["modules"]
               if m.split(".")[0] in ("jax", "jaxlib", "xxhash", "gubernator_tpu")]
        assert bad == []
    # the planes really ran: the graceful stop compacted into the base
    assert (tmp_path / "base.npz").exists()
    # no --device and no card (hidden where there is one): it raises, it
    # never falls back to the CPU
    out = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch"], cwd=REPO,
                         env=dict(env, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr.lower()


@async_test
async def test_sharded_daemon_serves_on_the_named_device():
    """GUBER_ENGINE=sharded builds GlobalShardedEngine over make_mesh: all
    cards by default, the named device alone with `device=`; the standalone
    mesh daemon serves GLOBAL through its collective sync tick."""
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine

    d = await TDaemon.spawn(port_config(engine="sharded", cache_size=4096), device="cpu")
    try:
        assert isinstance(d.engine, GlobalShardedEngine) and d.engine.n_shards == 1
        assert d._global_sync_task is not None
        got = [await _ask(d, "sh", "k", 1, limit=3) for _ in range(4)]
        assert [r.remaining for r in got] == [2, 1, 0, 0]
        assert [r.status for r in got] == [0, 0, 0, 1]
        g = [await _ask(d, "shg", "k", 1, limit=5, behavior=2) for _ in range(2)]
        assert all(r.error == "" for r in g)
    finally:
        await d.close()

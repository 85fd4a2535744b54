"""The port's peer discovery and binaries against the JAX package's
(tests/test_discovery.py and tests/test_cmd.py on the port).

- etcd and Kubernetes: the port's pools and the JAX pools against the same
  in-process fakes (tests/test_discovery.FakeEtcd, _fake_k8s_api) report
  the same peer lists; extract_peers on the same endpoint-slice and pod
  documents; DNS with a stub resolver.
- Memberlist: a mixed ring of JAX and port pools converges and leaves,
  with and without an AES-GCM keyring (the wire format is the JAX one,
  byte for byte); heartbeat timeout; keyring validation; two port daemons
  finding each other by gossip.
- The binaries with ``--device cpu``: server, cluster + healthcheck probe,
  the load generator, the probe's exit codes, the corpus (seeded, equal to
  the JAX corpus) and the open-loop limiter; without ``--device`` and no
  card the cluster raises.
"""

import asyncio
import io
import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from gubernator_tpu.discovery import dns as jdns
from gubernator_tpu.discovery import kubernetes as jk8s
from gubernator_tpu.discovery.etcd import EtcdPool as JEtcdPool
from gubernator_tpu.discovery.memberlist import MemberlistPool as JMemberlistPool
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch.config import ConfigError, DaemonConfig
from gubernator_tpu_torch.discovery import dns as tdns
from gubernator_tpu_torch.discovery import kubernetes as tk8s
from gubernator_tpu_torch.discovery.etcd import EtcdPool as TEtcdPool
from gubernator_tpu_torch.discovery.memberlist import MemberlistPool as TMemberlistPool
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.types import PeerInfo as TPeer

from tests.test_discovery import FakeEtcd, _fake_k8s_api, _slice, wait_until
from tests.test_torch_service import async_test
from tests.torch_cluster import port_config

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (JPeer, JEtcdPool, JMemberlistPool, jk8s, jdns),
            "port": (TPeer, TEtcdPool, TMemberlistPool, tk8s, tdns)}


def _recorder(seen, name):
    def cb(peers):
        seen[name] = sorted(p.grpc_address for p in peers)

    return cb


# ----------------------------------------------------------------------- etcd


@async_test
async def test_etcd_pools_report_the_jax_pools_peer_lists():
    """A port pool and a JAX pool register on one fake gateway: both see the
    same two peers, store the same JSON value, and both see a deregister."""
    fake = FakeEtcd()
    await fake.start()
    seen = {}
    pools = [cls(fake.url, _recorder(seen, name), peer(grpc_address=addr, data_center="dc-a"),
                 poll_ms=50.0)
             for name, addr in (("port", "10.0.0.1:1051"), ("jax", "10.0.0.2:1051"))
             for peer, cls in [PACKAGES[name][:2]]]
    try:
        for p in pools:
            await p.start()
        want = ["10.0.0.1:1051", "10.0.0.2:1051"]
        await wait_until(lambda: seen.get("port") == want and seen.get("jax") == want)
        stored = {k: json.loads(v) for k, (v, _) in fake.kv.items()}
        assert stored["/gubernator/peers/10.0.0.1:1051"] == {
            "grpc_address": "10.0.0.1:1051", "http_address": "", "data_center": "dc-a"}
        assert list(stored["/gubernator/peers/10.0.0.2:1051"]) == ["grpc_address",
                                                                   "http_address",
                                                                   "data_center"]
        await pools[1].close()
        await wait_until(lambda: seen["port"] == want[:1])
        # a fresh JAX pool registers; then the port pool leaves
        pools.append(JEtcdPool(fake.url, _recorder(seen, "jax2"),
                               JPeer(grpc_address="10.0.0.3:1051"), poll_ms=50.0))
        await pools[2].start()
        await wait_until(lambda: seen["port"] == ["10.0.0.1:1051", "10.0.0.3:1051"])
        await pools[0].close()
        await wait_until(lambda: seen["jax2"] == ["10.0.0.3:1051"])
    finally:
        for p in pools:
            await p.close()
        await fake.stop()


@async_test
async def test_etcd_lease_expiry_drops_a_dead_port_peer():
    fake = FakeEtcd()
    await fake.start()
    seen = {}
    a = JEtcdPool(fake.url, _recorder(seen, "a"), JPeer(grpc_address="10.0.0.1:1051"),
                  poll_ms=50.0, lease_ttl_s=1)
    b = TEtcdPool(fake.url, lambda ps: None, TPeer(grpc_address="10.0.0.2:1051"),
                  poll_ms=50.0, lease_ttl_s=1)
    try:
        await a.start()
        await b.start()
        await wait_until(lambda: seen.get("a") == ["10.0.0.1:1051", "10.0.0.2:1051"])
        b._closed = True  # hard kill: no deregister, the keepalive stops
        for t in b._tasks:
            t.cancel()
        await wait_until(lambda: seen["a"] == ["10.0.0.1:1051"], timeout_s=15)
    finally:
        await a.close()
        await b._session.close()
        await fake.stop()


@async_test
async def test_etcd_watch_propagates_membership_sub_poll():
    fake = FakeEtcd()
    await fake.start()
    seen = {}
    pool = TEtcdPool(fake.url, _recorder(seen, "p"), TPeer(grpc_address="127.0.0.1:1"),
                     poll_ms=60_000.0)
    other = JEtcdPool(fake.url, lambda ps: None, JPeer(grpc_address="127.0.0.1:2"),
                      poll_ms=60_000.0)
    try:
        await pool.start()
        await wait_until(lambda: seen.get("p") == ["127.0.0.1:1"], timeout_s=5)
        loop = asyncio.get_running_loop()
        for start_or_close, want in ((other.start, ["127.0.0.1:1", "127.0.0.1:2"]),
                                     (other.close, ["127.0.0.1:1"])):
            t0 = loop.time()
            await start_or_close()
            await wait_until(lambda: seen.get("p") == want, timeout_s=5, interval_s=0.005)
            assert loop.time() - t0 < 2.0  # event latency, not the 60 s poll
    finally:
        await pool.close()
        await fake.stop()


# ------------------------------------------------------------------------ k8s

SLICES = [
    _slice([
        {"addresses": ["10.0.0.1"], "conditions": {"ready": True}},
        {"addresses": ["10.0.0.2"], "conditions": {"ready": False}},
        {"addresses": ["10.0.0.3"]},
        {"addresses": []},
    ]),
    _slice([{"addresses": ["fe80::1"]}], address_type="IPv6"),
    _slice([{"addresses": ["10.0.0.1"], "conditions": {"ready": True}}]),
    _slice([{"addresses": ["10.0.0.2"], "conditions": {"ready": True}}]),
]
PODS = [
    {"status": {"podIP": "10.0.0.1", "phase": "Running",
                "conditions": [{"type": "Ready", "status": "True"}]}},
    {"status": {"podIP": "10.0.0.2", "phase": "Pending", "conditions": []}},
    {"status": {"podIP": "10.0.0.3", "phase": "Running",
                "conditions": [{"type": "Ready", "status": "False"}]}},
    {"status": {}},
]


@pytest.mark.parametrize("pod_ip", ["10.0.0.9", "10.0.0.1", "10.0.0.2", "10.0.0.3"])
@pytest.mark.parametrize("kind", ["endpoint_slices", "pods"])
def test_extract_peers_matches_jax(kind, pod_ip):
    docs = SLICES if kind == "endpoint_slices" else PODS
    got = [[(p.grpc_address, p.is_owner) for p in
            getattr(mod, f"extract_peers_from_{kind}")(docs, pod_ip, "1051")]
           for mod in (jk8s, tk8s)]
    assert got[0] == got[1] and got[1]


@async_test
async def test_k8s_pools_report_the_jax_pools_peer_lists():
    state = {"items": [_slice([{"addresses": ["10.0.0.1"], "conditions": {"ready": True}}])]}
    url, runner, notify = await _fake_k8s_api(state)
    seen = {}
    pools = [mod.K8sPool(on_update=_recorder(seen, name), pod_ip="10.0.0.1", pod_port="1051",
                         selector="app=gubernator", api_url=url, token="test-token",
                         poll_ms=poll)
             for name, mod, poll in (("jax", jk8s, 50.0), ("port", tk8s, 50.0),
                                     ("port_watch", tk8s, 60_000.0))]
    try:
        for p in pools:
            await p.start()
        await wait_until(lambda: all(seen.get(n) == ["10.0.0.1:1051"] for n in
                                     ("jax", "port", "port_watch")))
        await wait_until(lambda: len(state["watchers"]) == len(pools), timeout_s=5)
        state["items"][0]["endpoints"].append(
            {"addresses": ["10.0.0.2"], "conditions": {"ready": True}})
        notify()  # the 60 s-poll pool sees it through its watch alone
        want = ["10.0.0.1:1051", "10.0.0.2:1051"]
        await wait_until(lambda: all(seen.get(n) == want for n in
                                     ("jax", "port", "port_watch")), timeout_s=5)
    finally:
        for p in pools:
            await p.close()
        # one more event ends the fake's watch handlers on their closed
        # streams, so the cleanup does not wait out aiohttp's shutdown timeout
        await asyncio.sleep(0.05)
        notify()
        await asyncio.sleep(0.05)
        await runner.cleanup()


# ------------------------------------------------------------------------ dns


@async_test
async def test_dns_pools_match_jax_with_a_stub_resolver():
    """Multi-FQDN with data-center labels, self marking, an answer that
    changes, and a failed then an empty answer that keep the stale list."""
    answers = {"a.svc": [["10.0.0.1:1051", "10.0.0.2:1051"], ["10.0.0.2:1051"], "fail", []],
               "b.svc": [["10.0.1.1:1051"], ["10.0.1.1:1051"], [], []]}
    updates = {}
    pools = {}
    for name, (peer, _, _, _, mod) in PACKAGES.items():
        calls = {k: 0 for k in answers}

        def resolver(fqdn, port, calls=calls):
            got = answers[fqdn][min(calls[fqdn], len(answers[fqdn]) - 1)]
            calls[fqdn] += 1
            if got == "fail":
                raise OSError("resolver down")
            return got

        updates[name] = []
        pools[name] = mod.DNSPool(
            fqdn="a.svc=dc-a, b.svc", poll_ms=60_000.0,
            on_update=lambda ps, n=name: updates[n].append(
                [(p.grpc_address, p.data_center, p.is_owner) for p in ps]),
            self_address="10.0.0.2:1051", data_center="dc-z", resolver=resolver)
    for _ in range(4):
        for p in pools.values():
            await p._poll_once()
    assert updates["jax"] == updates["port"] and len(updates["port"]) == 2
    assert updates["port"][1] == [("10.0.0.2:1051", "dc-a", True),
                                  ("10.0.1.1:1051", "dc-z", False)]


def test_system_resolver_matches_jax():
    # a numeric host: getaddrinfo answers it without a lookup
    assert tdns.system_resolver("127.0.0.1", "1051") == jdns.system_resolver("127.0.0.1", "1051")
    assert tdns.system_resolver("127.0.0.1", "1051") == ["127.0.0.1:1051"]


# ----------------------------------------------------------------- memberlist


def _ml(package, seen, name, addr, seeds, keys=None, **kw):
    peer, _, cls, _, _ = PACKAGES[package]
    return cls(bind_address="127.0.0.1:0", known_nodes=seeds, on_update=_recorder(seen, name),
               peer_info=peer(grpc_address=addr), gossip_interval_ms=50.0,
               secret_keys=keys, **kw)


@pytest.mark.parametrize("keyring", [False, True])
@async_test
async def test_mixed_gossip_ring_converges_and_leaves(keyring):
    """A JAX seed, a port node and a port node: one member list everywhere;
    a port node's leave reaches the JAX node, the JAX node's leave reaches a
    port node. With a keyring, a keyless port node stays outside."""
    keys = [os.urandom(32)] if keyring else None
    seen = {}
    n0 = _ml("jax", seen, "n0", "10.0.0.1:1051", [], keys)
    await n0.start()
    seed = n0.advertise_address
    n1 = _ml("port", seen, "n1", "10.0.0.2:1051", [seed], keys, rng=random.Random(1))
    n2 = _ml("port", seen, "n2", "10.0.0.3:1051", [seed], keys, rng=random.Random(2))
    pools = [n0, n1, n2]
    if keyring:
        pools.append(_ml("port", seen, "evil", "10.66.0.1:1051", [seed]))
    want = ["10.0.0.1:1051", "10.0.0.2:1051", "10.0.0.3:1051"]
    try:
        for p in pools[1:]:
            await p.start()
        await wait_until(lambda: all(seen.get(n) == want for n in ("n0", "n1", "n2")))
        if keyring:
            assert seen["evil"] == ["10.66.0.1:1051"]
        await n2.close()
        await wait_until(lambda: seen["n0"] == want[:2] and seen["n1"] == want[:2])
        await n0.close()
        await wait_until(lambda: seen["n1"] == want[1:2])
    finally:
        for p in pools:
            await p.close()


@async_test
async def test_memberlist_detects_dead_peer_by_heartbeat_timeout():
    seen = {}
    p0 = _ml("port", seen, "n0", "10.0.0.1:1051", [], suspect_ticks=4)
    await p0.start()
    p1 = _ml("jax", seen, "n1", "10.0.0.2:1051", [p0.advertise_address])
    await p1.start()
    try:
        await wait_until(lambda: seen.get("n0") == ["10.0.0.1:1051", "10.0.0.2:1051"])
        p1._closed = True  # hard kill: no tombstone
        p1._task.cancel()
        p1._server.close()
        await wait_until(lambda: seen.get("n0") == ["10.0.0.1:1051"], timeout_s=15)
    finally:
        await p0.close()
        await p1.close()


def test_memberlist_state_blob_is_the_jax_wire_format():
    """The same members serialize to the same bytes in both packages, and
    each package unseals the other's sealed blob."""
    import base64

    key = os.urandom(16)
    blobs = []
    for name in ("jax", "port"):
        pool = _ml(name, {}, name, "10.0.0.1:1051", ["10.0.0.9:7946"], [key])
        pool._self.heartbeat = 5
        blobs.append((pool, pool._state_blob()))
    (jp, jb), (tp, tb) = blobs
    assert jp._unseal(jb) == tp._unseal(tb) == tp._unseal(jb) == jp._unseal(tb)
    assert json.loads(tp._unseal(tb)) == {"from": "127.0.0.1:0", "members": [{
        "name": "127.0.0.1:0", "peer": {"grpc_address": "10.0.0.1:1051", "http_address": "",
                                        "data_center": ""},
        "incarnation": 0, "heartbeat": 5, "dead": False}]}
    # the keyring's validation: the pool's and the config's
    with pytest.raises(ValueError, match="16, 24 or 32"):
        _ml("port", {}, "bad", "x:1", [], [b"short"])
    DaemonConfig(memberlist_secret_keys=base64.b64encode(os.urandom(32)).decode()).validate()
    with pytest.raises(ConfigError, match="base64"):
        DaemonConfig(memberlist_secret_keys="!!notb64!!").validate()
    with pytest.raises(ConfigError, match="16, 24 or 32"):
        DaemonConfig(memberlist_secret_keys=base64.b64encode(b"tooshort").decode()).validate()


@async_test
async def test_port_daemons_discover_each_other_via_memberlist():
    kw = dict(peer_discovery_type="member-list", memberlist_address="127.0.0.1:0",
              memberlist_gossip_interval_ms=50.0)
    d0 = await TDaemon.spawn(port_config(**kw), device="cpu")
    d1 = await TDaemon.spawn(port_config(memberlist_known_nodes=d0._pool.advertise_address,
                                         **kw), device="cpu")
    try:
        want = sorted([d0.conf.advertise_address, d1.conf.advertise_address])
        await wait_until(lambda: all(sorted(p.grpc_address for p in d.local_peers()) == want
                                     for d in (d0, d1)), timeout_s=15)
        assert d0.get_peer("some_key").grpc_address == d1.get_peer("some_key").grpc_address
    finally:
        await d1.close()
        await d0.close()


# ------------------------------------------------------------------- binaries


@async_test
async def test_server_binary_boots_from_env(tmp_path, monkeypatch):
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.cmd.server import serve

    conf_file = tmp_path / "server.conf"
    conf_file.write_text("GUBER_GRPC_ADDRESS=127.0.0.1:0\nGUBER_HTTP_ADDRESS=127.0.0.1:0\n"
                         "GUBER_CACHE_SIZE=4096\n")
    monkeypatch.delenv("GUBER_GRPC_ADDRESS", raising=False)
    stop = asyncio.Event()
    got = {}

    async def ready(daemon):
        client = V1Client(daemon.conf.grpc_address)
        try:
            resp = await client.get_rate_limits(
                [dict(name="boot", unique_key="k", hits=1, limit=3, duration=60_000)])
            got["remaining"] = resp.responses[0].remaining
            got["status"] = (await client.health_check()).status
        finally:
            await client.close()
        stop.set()

    await asyncio.wait_for(serve(str(conf_file), stop=stop, ready=ready, device="cpu"),
                           timeout=60)
    assert got == {"remaining": 2, "status": "healthy"}


def _free_base_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1] + 10


async def _serve_on_free_ports(serve, n: int, attempts: int = 3, **kw):
    """cmd.cluster.serve on a free base port, started again on another one
    when a port was taken between the probe and the bind."""
    for attempt in range(attempts):
        try:
            return await serve(n, base_port=_free_base_port(), **kw)
        except (OSError, RuntimeError) as exc:
            msg = str(exc).lower()
            if attempt == attempts - 1 or not (
                    "failed to bind" in msg or "address already in use" in msg):
                raise


@async_test
async def test_cluster_binary_and_healthcheck_probe():
    from gubernator_tpu_torch.cmd.cluster import serve
    from gubernator_tpu_torch.cmd.healthcheck import NotHealthy, check

    stop = asyncio.Event()
    result = {}

    async def ready(daemons):
        loop = asyncio.get_running_loop()
        out = io.StringIO()
        await loop.run_in_executor(
            None, lambda: check(daemons[0].conf.http_address, attempts=3, delay_s=0.05, out=out))
        result["attempts"] = out.getvalue().count("checking")
        result["peers"] = [len(d.local_peers()) for d in daemons]
        result["devices"] = {str(d.engine.device) for d in daemons}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        try:
            await loop.run_in_executor(None, lambda: check(
                f"127.0.0.1:{dead}", attempts=1, delay_s=0, out=io.StringIO()))
        except Exception as exc:  # noqa: BLE001 - a transport error, not NotHealthy
            result["transport_is_not_healthy"] = isinstance(exc, NotHealthy)
        stop.set()

    await asyncio.wait_for(_serve_on_free_ports(serve, 3, stop=stop, ready=ready,
                                                device="cpu"), timeout=120)
    assert result == {"attempts": 1, "peers": [3, 3, 3], "devices": {"cpu"},
                      "transport_is_not_healthy": False}


@async_test
async def test_load_generator_cli_against_port_daemon():
    from gubernator_tpu_torch.cmd import cli

    d = await TDaemon.spawn(port_config(), device="cpu")
    try:
        ns = type("Args", (), dict(endpoint=d.conf.grpc_address, concurrency=4, timeout=5.0,
                                   checks=10, rate=0, limits=40, seconds=0, once=True,
                                   quiet=True))()
        stats = cli.Stats(random.Random(3))
        await asyncio.wait_for(cli.run(ns, stats), timeout=60)
        assert (stats.checks, stats.requests, stats.errors) == (40, 4, 0)
        rep = stats.report(1.0)
        assert rep["latency_ms"]["p99"] >= rep["latency_ms"]["p50"] > 0
    finally:
        await d.close()


def test_healthcheck_main_exit_codes(monkeypatch):
    from gubernator_tpu_torch.cmd import healthcheck

    monkeypatch.setenv("GUBER_HTTP_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("GUBER_HTTP_RETRY_COUNT", "1")
    assert healthcheck.main() == 1
    monkeypatch.setenv("GUBER_HTTP_RETRY_COUNT", "bogus")
    assert healthcheck.main() == 1


def test_cli_corpus_matches_jax_and_limiter_paces():
    """The port's corpus from a seeded generator equals the JAX corpus from
    the same seed in the module generator; the reservoir draws from its own."""
    from gubernator_tpu.cmd import cli as jcli
    from gubernator_tpu_torch.cmd import cli as tcli

    corpus = tcli.make_rate_limits(50, random.Random(11))
    state = random.getstate()
    try:
        random.seed(11)
        want = jcli.make_rate_limits(50)
    finally:
        random.setstate(state)
    assert [r.SerializeToString() for r in corpus] == [r.SerializeToString() for r in want]
    assert all(1 <= r.limit <= 999 and 500 <= r.duration <= 6000 for r in corpus)
    assert len({r.name for r in corpus}) == 50
    stats = tcli.Stats(random.Random(5))
    for i in range(tcli.RESERVOIR_CAP + 50):
        stats.observe(i * 1e-6)
    assert len(stats.latencies) == tcli.RESERVOIR_CAP

    async def paced():
        import time

        lim = tcli.OpenLoopLimiter(200.0)
        t0 = time.perf_counter()
        for _ in range(10):
            await lim.wait()
        return time.perf_counter() - t0

    assert asyncio.run(paced()) >= 0.03


def test_cluster_without_device_raises_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cmd.cluster", "-n", "1",
                          "--base-port", str(_free_base_port())], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr.lower()

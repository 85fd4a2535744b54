"""Peer faults on port daemons: the four cases of tests/test_chaos.py on a
port cluster (tests/torch_cluster.py) whose peer plane runs through
tests/chaos.py's ChaosProxy, plus the pin of a forward that times out
after its owner applied it.

- The proxy modes on a forward between two port daemons: pass, delay,
  drop, error, blackhole, heal.
- A blackholed owner: the breaker opens after two failures, the cluster
  serves degraded-local answers fast, GLOBAL hits requeue, and after the
  heal the requeued hits land and the breaker closes.
- A killed owner: the reference's error string, retries counted, health
  degraded (passing, unless strict).
- Three partition and heal cycles against one owner.
- A forward whose owner answers after the forward's timeout is retried
  and counted again at the owner, as the reference's asyncRequest does:
  the same over-count on a JAX cluster and a port cluster.

The breaker's states and the metric families are held to what the JAX
cases assert.
"""

import asyncio
import io
import time

import pytest

from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.config import BehaviorConfig, DegradationPolicy
from gubernator_tpu_torch.service.breaker import BreakerState
from gubernator_tpu_torch.service.daemon import FORWARD_RETRIES
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

from tests import torch_cluster as tcluster
from tests.test_torch_service import async_test
from tests.torch_cluster import Cluster, metric_value, scrape, wait_for


def chaos_behaviors(**over) -> BehaviorConfig:
    """tests/test_chaos.py's cadences: 400 ms RPC timeouts, a two-failure
    trip, sub-second breaker cooldowns."""
    kw = dict(batch_wait_ms=1.0, global_sync_wait_ms=50.0, batch_timeout_ms=400.0,
              global_timeout_ms=400.0, peer_breaker_errors=2,
              peer_breaker_backoff_base_ms=300.0, peer_breaker_backoff_cap_ms=600.0,
              global_requeue_retries=200)
    kw.update(over)
    return BehaviorConfig(**kw)


def req(key, name="chaos", hits=1, limit=100, behavior=0):
    return RateLimitRequest(name=name, unique_key=key, hits=hits, limit=limit,
                            duration=60_000, behavior=behavior)


async def one(client, r):
    return (await client.get_rate_limits([r])).responses[0]


@async_test
async def test_chaos_proxy_modes_on_port_daemons():
    """Each proxy mode on the owner's peer plane, seen through a forward
    from the other port daemon (ERROR policy; the breaker's threshold is
    out of reach, so every mode meets a live channel)."""
    c = await Cluster.start(2, chaos=True, behaviors=chaos_behaviors(
        batch_timeout_ms=300.0, peer_breaker_errors=1000))
    owner = c.find_owning_daemon("chaos", "m")
    non_owner = c.non_owning_daemons("chaos", "m")[0]
    proxy = c.proxy_for(owner)
    client = V1Client(non_owner.conf.grpc_address)
    try:
        r = await one(client, req("m"))
        assert (r.error, r.remaining) == ("", 99)  # pass
        proxy.set_mode("delay", delay_s=0.02)
        t0 = time.perf_counter()
        r = await one(client, req("m"))
        assert (r.error, r.remaining) == ("", 98)
        assert time.perf_counter() - t0 >= 0.04  # a chunk each way
        proxy.set_mode("blackhole")
        t0 = time.perf_counter()
        r = await one(client, req("m"))
        assert r.error.startswith("Error while fetching rate limit from peer:")
        assert time.perf_counter() - t0 >= 0.3  # at least one RPC timeout
        for mode in ("drop", "error"):
            proxy.set_mode(mode)
            r = await one(client, req("m"))
            assert r.error.startswith("Error while fetching rate limit from peer:"), mode
        proxy.heal()

        async def healed():  # the channel's reconnect backoff runs out
            return (await one(client, req("m", hits=0))).error == ""

        await wait_for(healed, timeout_s=10)
        r = await one(client, req("m"))
        # the owner counted only the forwards that reached it
        assert (r.error, r.remaining) == ("", 97)
        s = await scrape(non_owner)
        assert metric_value(s, "gubernator_batch_send_retries_total") >= 3 * (
            FORWARD_RETRIES - 1)
    finally:
        await client.close()
        await c.stop()


@async_test
async def test_blackholed_owner_breaker_degraded_local_and_recovery():
    c = await Cluster.start(3, chaos=True, behaviors=chaos_behaviors(
        degradation_policy=DegradationPolicy.LOCAL.value))
    owner = c.find_owning_daemon("chaos", "k1")
    non_owner = c.non_owning_daemons("chaos", "k1")[0]
    client = V1Client(non_owner.conf.grpc_address)
    try:
        r = await one(client, req("k1"))
        assert r.error == "" and "degraded" not in r.metadata and r.remaining == 99

        c.proxy_for(owner).set_mode("blackhole")
        owner_addr = owner.conf.advertise_address
        breaker = non_owner._peer_clients[owner_addr].breaker
        t0 = time.perf_counter()
        r = await one(client, req("k1"))
        pre_open_s = time.perf_counter() - t0
        assert r.error == "" and r.metadata["degraded"] == "true"
        assert r.remaining == 99  # the non-owner's own store never saw a hit
        assert breaker.state is BreakerState.OPEN
        assert pre_open_s >= 0.4

        t0 = time.perf_counter()
        r = await one(client, req("k1"))
        post_open_s = time.perf_counter() - t0
        assert r.error == "" and r.metadata["degraded"] == "true"
        assert post_open_s < pre_open_s / 2, (pre_open_s, post_open_s)
        s = await scrape(non_owner)
        assert metric_value(s, "gubernator_degraded_response_count_total") >= 2
        assert metric_value(s, "gubernator_circuit_breaker_state", peer=owner_addr) == 2.0

        # GLOBAL hits toward a dead owner requeue instead of dropping
        gkey, gname = "gk-requeue", "chaosg"
        gowner = c.find_owning_daemon(gname, gkey)
        gnon = [d for d in c.daemons if d is not gowner][0]
        if gowner is not owner:
            c.proxy_for(gowner).set_mode("blackhole")
        gclient = V1Client(gnon.conf.grpc_address)
        resp = await one(gclient, req(gkey, name=gname, hits=7, behavior=Behavior.GLOBAL))
        assert resp.error == ""
        await gclient.close()

        async def requeued():
            return metric_value(await scrape(gnon), "gubernator_global_requeue_count_total")

        await wait_for(requeued, timeout_s=10)
        for p in c.proxies:
            p.heal()

        async def owner_got_hits():
            return metric_value(await scrape(gowner), "gubernator_broadcast_counter_total",
                                condition="broadcast")

        await wait_for(owner_got_hits, timeout_s=15)
        gc2 = V1Client(gowner.conf.grpc_address)
        rg = await one(gc2, req(gkey, name=gname, hits=0, behavior=Behavior.GLOBAL))
        await gc2.close()
        assert rg.remaining == 93  # the 7 requeued hits arrived

        async def recovered():
            r = await one(client, req("k1", hits=0))
            return r.error == "" and "degraded" not in r.metadata

        await wait_for(recovered, timeout_s=10)
        assert breaker.state is BreakerState.CLOSED
    finally:
        await client.close()
        await c.stop()


@async_test
async def test_forward_owner_killed_returns_reference_error_and_retries():
    from gubernator_tpu_torch.cmd.healthcheck import NotHealthy, check

    c = await Cluster.start(2)
    owner = c.find_owning_daemon("killed", "k1")
    non_owner = c.non_owning_daemons("killed", "k1")[0]
    client = V1Client(non_owner.conf.grpc_address)
    try:
        r = await one(client, req("k1", name="killed"))
        assert r.error == "" and r.remaining == 99
        await owner.close()
        r = await one(client, req("k1", name="killed"))
        assert r.error.startswith("Error while fetching rate limit from peer:")
        assert "degraded" not in r.metadata
        s = await scrape(non_owner)
        assert metric_value(s, "gubernator_batch_send_retries_total") >= 1.0
        assert metric_value(s, "gubernator_check_error_counter_total", error="forward") >= 1.0
        hc = await non_owner.health_check()
        assert hc.status == "degraded"
        entry = {p.grpc_address: p for p in hc.local_peers}[owner.conf.advertise_address]
        assert entry.breaker_state in ("closed", "half-open", "open")
        assert len(entry.recent_errors) >= 1
        loop = asyncio.get_running_loop()
        out = io.StringIO()
        await loop.run_in_executor(None, lambda: check(
            non_owner.conf.http_address, attempts=1, delay_s=0, out=out))
        assert "degraded (passing)" in out.getvalue()
        with pytest.raises(NotHealthy):
            await loop.run_in_executor(None, lambda: check(
                non_owner.conf.http_address, attempts=1, delay_s=0, out=io.StringIO(),
                strict=True))
    finally:
        await client.close()
        await c.stop()


@async_test
async def test_repeated_partition_recovery_cycles():
    c = await Cluster.start(3, chaos=True, behaviors=chaos_behaviors(
        degradation_policy=DegradationPolicy.LOCAL.value))
    owner = c.find_owning_daemon("chaos", "cyc")
    non_owner = c.non_owning_daemons("chaos", "cyc")[0]
    breaker = non_owner._peer_clients[owner.conf.advertise_address].breaker
    client = V1Client(non_owner.conf.grpc_address)
    try:
        forwarded = 0
        for cycle in range(3):
            r = await one(client, req("cyc"))
            forwarded += 1
            assert r.error == "" and "degraded" not in r.metadata
            assert r.remaining == 100 - forwarded, f"cycle {cycle}"
            c.proxy_for(owner).set_mode("blackhole")
            r = await one(client, req("cyc"))
            assert r.metadata["degraded"] == "true"
            assert breaker.state is BreakerState.OPEN, f"cycle {cycle}"
            for _ in range(3):
                r = await one(client, req("cyc"))
                assert r.error == "" and r.metadata["degraded"] == "true"
            c.proxy_for(owner).heal()

            async def recovered():
                r = await one(client, req("cyc", hits=0))
                return "degraded" not in r.metadata and r.error == ""

            await wait_for(recovered, timeout_s=10)
            assert breaker.state is BreakerState.CLOSED, f"cycle {cycle}"
    finally:
        await client.close()
        await c.stop()


LATE_DELAY_S = 0.15  # each proxied chunk's delay, past the forward timeout


async def _late_answer_count(cluster_mod, client_cls, req_cls, behaviors) -> tuple:
    """One hit forwarded through an owner proxy that delays every chunk past
    the forward's timeout, on a live channel: (the forwarder's answer, the
    owner's remaining once every delayed chunk has landed, retries)."""
    c = await cluster_mod.Cluster.start(2, chaos=True, behaviors=behaviors)
    owner = c.find_owning_daemon("late", "k")
    non_owner = c.non_owning_daemons("late", "k")[0]
    client = client_cls(non_owner.conf.grpc_address)
    ocl = client_cls(owner.conf.grpc_address)
    try:
        mk = lambda hits: req_cls(name="late", unique_key="k", hits=hits, limit=100,  # noqa: E731
                                  duration=60_000)
        warm = (await client.get_rate_limits([mk(1)])).responses[0]
        assert (warm.error, warm.remaining) == ("", 99)
        # delay the established channel in place (set_mode would sever it
        # and the retries would meet a handshake instead of the owner)
        proxy = c.proxy_for(owner)
        proxy.delay_s, proxy.mode = LATE_DELAY_S, "delay"
        got = (await client.get_rate_limits([mk(1)])).responses[0]
        # settle: the owner's count holds still for four delayed chunks
        seen = []
        while len(seen) < 4 or len(set(seen[-4:])) > 1:
            await asyncio.sleep(LATE_DELAY_S)
            seen.append((await ocl.get_rate_limits([mk(0)])).responses[0].remaining)
            assert len(seen) < 60, seen
        proxy.heal()
        left = (await ocl.get_rate_limits([mk(0)])).responses[0].remaining
        retries = metric_value(await cluster_mod.scrape(non_owner),
                               "gubernator_batch_send_retries_total")
        return got.error.split(":")[0], left, retries
    finally:
        await ocl.close()
        await client.close()
        await c.stop()


@async_test
async def test_forward_answered_after_its_timeout_counts_again():
    """The reference's asyncRequest semantics, shared by both packages: a
    forward that times out after the owner applied it is retried, and each
    retry that reaches the owner counts again."""
    from gubernator_tpu.client import V1Client as JClient
    from gubernator_tpu.config import BehaviorConfig as JBehaviors
    from gubernator_tpu.types import RateLimitRequest as JReq

    from tests import cluster as jcluster

    kw = dict(batch_wait_ms=1.0, global_sync_wait_ms=50.0, batch_timeout_ms=100.0,
              global_timeout_ms=100.0, peer_breaker_errors=1000)
    jax_side = await _late_answer_count(jcluster, JClient, JReq, JBehaviors(**kw))
    port_side = await _late_answer_count(tcluster, V1Client, RateLimitRequest,
                                         BehaviorConfig(**kw))
    assert port_side == jax_side
    error, left, retries = port_side
    assert error == "Error while fetching rate limit from peer"
    assert retries == FORWARD_RETRIES
    # one hit sent, counted once for each attempt that reached the owner
    # before its cancellation did (4 of the 5 at these timings)
    assert left <= 97, port_side

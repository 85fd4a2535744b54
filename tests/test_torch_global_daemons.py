"""GLOBAL across daemons on port daemons: the seven cases of
tests/test_global_daemons.py, each run on a port cluster
(tests/torch_cluster.py) and on a JAX cluster of the same size with both
packages' clocks frozen. The answers each case reads (the first answer, the
converged reads, the answers after depletion) are byte-equal between the
clusters; the exact broadcast and install counters, scraped from /metrics,
are held to the reference's contract on both.
"""

from types import SimpleNamespace

from gubernator_tpu import client as jclient
from gubernator_tpu import types as jtypes
from gubernator_tpu_torch import client as tclient
from gubernator_tpu_torch import types as ttypes

from tests import cluster as jcluster
from tests import torch_cluster as tcluster
from tests.test_torch_service import async_test
from tests.torch_cluster import NOW, frozen  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(cluster=jcluster, Client=jclient.V1Client, types=jtypes),
    "port": SimpleNamespace(cluster=tcluster, Client=tclient.V1Client, types=ttypes),
}


async def run_both(scenario, n: int, **overrides):
    """Run `scenario(P, cluster, clients, record)` on a JAX cluster and on a
    port cluster of n daemons; the answers each recorded must be equal."""
    records = {}
    for name, P in PKGS.items():
        c = await P.cluster.Cluster.start(n, **overrides)
        clients = [P.Client(d.conf.grpc_address) for d in c.daemons]
        out = records[name] = []
        try:
            await scenario(P, c, clients, lambda r: out.append(r.SerializeToString()) or r)
        finally:
            for cl in clients:
                await cl.close()
            await c.stop()
    assert records["port"] == records["jax"]
    return records["port"]


def greq(P, key, hits=1, limit=100, **kw):
    return P.types.RateLimitRequest(name="glob", unique_key=key, hits=hits, limit=limit,
                                    duration=60_000, behavior=P.types.Behavior.GLOBAL, **kw)


async def ask(client, r):
    return (await client.get_rate_limits([r])).responses[0]


async def broadcast_count(P, d) -> float:
    return P.cluster.metric_value(await P.cluster.scrape(d),
                                  "gubernator_broadcast_counter_total", condition="broadcast")


async def updates_installed(P, d) -> float:
    return P.cluster.metric_value(await P.cluster.scrape(d),
                                  "gubernator_update_peer_globals_installed_total")


@async_test
async def test_global_hits_converge_via_owner_broadcast(frozen):
    async def scenario(P, c, clients, record):
        owner = c.find_owning_daemon("glob", "gk1")
        non_owners = c.non_owning_daemons("glob", "gk1")
        r = record(await ask(clients[c.daemons.index(non_owners[0])], greq(P, "gk1", hits=5)))
        assert r.error == "" and r.remaining == 95
        await P.cluster.wait_for(lambda: broadcast_count(P, owner), timeout_s=15)
        for d in non_owners:
            await P.cluster.wait_for(lambda d=d: updates_installed(P, d), timeout_s=15)
        # exact counters before the reads below (an owner read queues
        # another broadcast)
        assert await broadcast_count(P, owner) == 2.0
        for d in non_owners:
            assert await broadcast_count(P, d) == 0.0
            assert await updates_installed(P, d) == 1.0
        for cl in clients:
            assert record(await ask(cl, greq(P, "gk1", hits=0))).remaining == 95

    await run_both(scenario, 3)


@async_test
async def test_global_owner_hit_broadcasts(frozen):
    async def scenario(P, c, clients, record):
        owner = c.find_owning_daemon("glob", "gk2")
        r = record(await ask(clients[c.daemons.index(owner)], greq(P, "gk2", hits=3)))
        assert r.remaining == 97
        await P.cluster.wait_for(lambda: broadcast_count(P, owner), timeout_s=15)
        assert await broadcast_count(P, owner) == 2.0
        for d in c.non_owning_daemons("glob", "gk2"):
            await P.cluster.wait_for(lambda d=d: updates_installed(P, d), timeout_s=15)
            r = record(await ask(clients[c.daemons.index(d)], greq(P, "gk2", hits=0)))
            assert r.remaining == 97  # from the replica, without the owner

    await run_both(scenario, 3)


@async_test
async def test_global_negative_hits_propagate(frozen):
    async def scenario(P, c, clients, record):
        peers = c.non_owning_daemons("glob", "neg")
        pc = [clients[c.daemons.index(d)] for d in peers]

        async def send(cl, hits, want):
            r = record(await ask(cl, greq(P, "neg", hits=hits, limit=2)))
            assert r.error == "" and r.remaining == want, (hits, r.remaining)

        async def installed_at_least(d, k):
            return (await updates_installed(P, d)) >= k

        await send(pc[0], -1, 3)  # a credit: limit 2 - (-1)
        await P.cluster.wait_for(lambda: installed_at_least(peers[1], 1), timeout_s=20)
        await send(pc[1], -1, 4)
        await P.cluster.wait_for(lambda: installed_at_least(peers[2], 2), timeout_s=20)
        await send(pc[2], 4, 0)  # spends all four banked tokens
        await P.cluster.wait_for(lambda: installed_at_least(peers[0], 3), timeout_s=20)
        await send(pc[0], 0, 0)

    await run_both(scenario, 4)


@async_test
async def test_global_request_more_than_available(frozen):
    async def scenario(P, c, clients, record):
        pc = [clients[c.daemons.index(d)] for d in c.non_owning_daemons("glob", "over")]

        def lreq(hits):
            return P.types.RateLimitRequest(
                name="glob", unique_key="over", hits=hits, limit=100, duration=600_000,
                behavior=P.types.Behavior.GLOBAL, algorithm=P.types.Algorithm.LEAKY_BUCKET)

        for cl in pc:  # 50 at each replica: both UNDER until the sync lands
            r = record(await ask(cl, lreq(50)))
            assert r.error == "" and r.status == 0

        async def depleted():
            return (await ask(pc[0], lreq(0))).remaining == 0

        await P.cluster.wait_for(depleted, timeout_s=20)
        record(await ask(pc[0], lreq(0)))
        assert record(await ask(pc[0], lreq(1))).status == 1

    await run_both(scenario, 3)


@async_test
async def test_global_load_balanced_owner_and_non_owner(frozen):
    async def scenario(P, c, clients, record):
        oc = clients[c.daemons.index(c.find_owning_daemon("glob", "lb"))]
        nc = clients[c.daemons.index(c.non_owning_daemons("glob", "lb")[0])]
        for cl in (oc, nc):
            r = record(await ask(cl, greq(P, "lb", hits=1, limit=2)))
            assert (r.error, r.status) == ("", 0)

        async def synced_to_zero():
            a = await ask(oc, greq(P, "lb", hits=0, limit=2))
            b = await ask(nc, greq(P, "lb", hits=0, limit=2))
            return a.remaining == 0 and b.remaining == 0

        await P.cluster.wait_for(synced_to_zero, timeout_s=20)
        for cl in (oc, nc, nc):
            assert record(await ask(cl, greq(P, "lb", hits=1, limit=2))).status == 1

    await run_both(scenario, 3)


@async_test
async def test_global_aggregates_hits_across_non_owners(frozen):
    async def scenario(P, c, clients, record):
        owner = c.find_owning_daemon("glob", "gk3")
        oi = c.daemons.index(owner)
        for i in range(len(c.daemons)):
            if i != oi:
                record(await ask(clients[i], greq(P, "gk3", hits=4)))
        await P.cluster.wait_for(lambda: broadcast_count(P, owner), timeout_s=15)

        async def converged():
            return (await ask(clients[oi], greq(P, "gk3", hits=0))).remaining == 100 - 8

        await P.cluster.wait_for(converged, timeout_s=15)
        record(await ask(clients[oi], greq(P, "gk3", hits=0)))

    await run_both(scenario, 3)


@async_test
async def test_sliding_window_broadcast_carries_prev_window_aux(frozen):
    """Owner broadcasts of SLIDING_WINDOW keys carry the previous window's
    count, so a replica interpolates the owner's exact `used`."""
    dur, limit = 600_000, 100
    ws = NOW - NOW % dur
    t_prev = ws - dur // 2  # the middle of the previous window
    t_cur = ws + max(1, (NOW - ws) // 2)  # inside the current one
    t_q = t_cur + 10

    async def scenario(P, c, clients, record):
        owner = c.find_owning_daemon("wing", "wk1")
        replica = c.non_owning_daemons("wing", "wk1")[0]
        ocl, rcl = clients[c.daemons.index(owner)], clients[c.daemons.index(replica)]

        def wreq(hits, created):
            return P.types.RateLimitRequest(
                name="wing", unique_key="wk1", hits=hits, limit=limit, duration=dur,
                algorithm=P.types.Algorithm.SLIDING_WINDOW, behavior=P.types.Behavior.GLOBAL,
                created_at=created)

        for hits, t in ((40, t_prev), (10, t_cur)):  # owner state (cur 10, prev 40)
            r = record(await ask(ocl, wreq(hits, t)))
            assert r.error == "" and r.status == 0
        own = record(await ask(ocl, wreq(0, t_q)))
        weighted_prev = (40 * (dur - (t_q - ws))) // dur
        assert weighted_prev > 0
        assert own.remaining == limit - 10 - weighted_prev

        async def replica_matches():
            return (await ask(rcl, wreq(0, t_q))).remaining == own.remaining

        await P.cluster.wait_for(replica_matches, timeout_s=15)
        record(await ask(rcl, wreq(0, t_q)))

    await run_both(scenario, 2, created_at_tolerance_ms=3_600_000.0)

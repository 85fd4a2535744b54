"""The port's edge quota leases against the JAX package's (tests/test_edge_lease.py
on the port): service/lease_manager.py, edge/local_limiter.py, client.py.

- The engine's negative-hit miss-safety: returns against unknown, expired
  and over-released CONCURRENCY_LEASE and extension-algorithm rows, a
  partial return and a mixed batch, on a port LocalEngine(device="cpu")
  beside the JAX LocalEngine for probe xla and pallas: responses,
  EngineStats and raw table bytes equal (exact).
- The server plane on port daemons: the grant against the real limit, the
  cap and exhaustion, forged returns, TTL reclamation, GLOBAL and
  MULTI_REGION riding, retry_after_ms in the client.
- One scripted sequence (chip_smoke.lease_script) through a port daemon
  and a JAX daemon, one frozen clock and one seeded uuid4 each: every
  response byte-equal, debug_leases(), the GLOBAL and region queues and
  the table bytes equal.
- LocalLimiter interop both ways (a port limiter against a JAX daemon, a
  JAX limiter against a port daemon) and the edge cases on the port:
  adaptive sizing, thread-concurrency exactness, the crash-restart bound.
"""

import asyncio
import dataclasses
import threading

import numpy as np
import pytest
import torch

from gubernator_tpu.edge import LocalLimiter as JLimiter
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JEngine
from gubernator_tpu.service import lease_manager as jlm
from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch.client import V1Client, response_from_pb, response_retry_after_ms
from gubernator_tpu_torch.edge import LocalLimiter
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TEngine
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.service import lease_manager as tlm
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.types import Behavior
from gubernator_tpu_torch.types import PeerInfo as TPeer

import chip_smoke as cs
from tests.cluster import daemon_config, wait_for
from tests.test_torch_service import NOW, async_test
from tests.torch_cluster import port_config

torch.set_num_threads(1)

MINUTE = 60_000


# ------------------------------------------------------- engine miss-safety


def _cols(cls, fps, hits, algo, limit=100, dur=MINUTE, now=NOW):
    n = len(fps)
    return cls(
        fp=np.asarray(fps, dtype=np.int64),
        algo=np.broadcast_to(np.asarray(algo, dtype=np.int32), (n,)).copy(),
        behavior=np.zeros(n, dtype=np.int32), hits=np.asarray(hits, dtype=np.int64),
        limit=np.full(n, limit, dtype=np.int64), burst=np.zeros(n, dtype=np.int64),
        duration=np.full(n, dur, dtype=np.int64), created_at=np.full(n, now, dtype=np.int64),
        err=np.zeros(n, dtype=np.int8),
    )


# scenario → [(fps, hits, algo, duration, now offset)], from
# tests/test_edge_lease.py:72-150
MISS_SAFETY = {
    # a release of a key the table never saw installs nothing
    "unknown_release": [([11], [-3], 4, MINUTE, 0)],
    # a late release after TTL reclamation does not resurrect the slot
    "expired_release": [([13], [2], 4, 10, 0), ([13], [-2], 4, 10, 50_000)],
    # extension lanes clamp an over-release at the limit; token and leaky bank it
    "over_release": [(list(range(21, 26)), [5] * 5, [2, 3, 4, 0, 1], MINUTE, 0),
                     (list(range(21, 26)), [-50] * 5, [2, 3, 4, 0, 1], MINUTE, 1),
                     (list(range(21, 26)), [0] * 5, [2, 3, 4, 0, 1], MINUTE, 2)],
    "partial_return": [([31], [10], 0, MINUTE, 0), ([31], [-4], 0, MINUTE, 1)],
    # lease and window miss-returns remove, the leaky hit installs
    "mixed_batch": [([41, 42, 43], [-3, -2, 1], [4, 3, 1], MINUTE, 0)],
}
# the remaining each scenario's last batch answers (tests/test_edge_lease.py;
# over_release, read with 0 hits: the extension lanes clamped at the limit,
# the token bucket banked the credit, the leaky bucket's read caps it)
MISS_SAFETY_REMAINING = {
    "unknown_release": [100], "expired_release": [100], "over_release": [100, 100, 100, 145, 100],
    "partial_return": [94], "mixed_batch": [100, 100, 99],
}
MISS_SAFETY_LIVE = {"unknown_release": 0, "expired_release": 0, "mixed_batch": 1}


@pytest.mark.parametrize("probe", ["xla", "pallas"])
@pytest.mark.parametrize("scenario", sorted(MISS_SAFETY))
def test_negative_hits_match_jax_engine(scenario, probe):
    j = JEngine(capacity=4096, probe=probe, wire="full")
    t = TEngine(capacity=4096, probe=probe, device="cpu")
    for fps, hits, algo, dur, dt in MISS_SAFETY[scenario]:
        now = NOW + dt
        jr = j.check_columns(_cols(JCols, fps, hits, algo, dur=dur, now=now), now_ms=now)
        tr = t.check_columns(_cols(TCols, fps, hits, algo, dur=dur, now=now), now_ms=now)
        for f in tr._fields:
            assert np.array_equal(np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))), f
        assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
        assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()
        assert j.live_count(now) == t.live_count(now)
    assert tr.remaining.tolist() == MISS_SAFETY_REMAINING[scenario]
    if scenario in MISS_SAFETY_LIVE:
        assert t.live_count(now) == MISS_SAFETY_LIVE[scenario]


# ------------------------------------------------------------ server plane


async def _port_cluster(n, dcs=None, **overrides):
    dcs = dcs or [""] * n
    ds = [await TDaemon.spawn(port_config(data_center=dc, **overrides), device="cpu")
          for dc in dcs[:n]]
    peers = [d.peer_info() for d in ds]
    for d in ds:
        d.set_peers([TPeer(**vars(p)) for p in peers])
    return ds


async def _close(ds):
    await asyncio.gather(*(d.close() for d in ds))


def _req(name, key, hits=0, limit=100, **kw):
    return pb.RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                           duration=kw.pop("duration", MINUTE), **kw)


@async_test
async def test_daemon_layer_miss_safe_return():
    (d,) = await _port_cluster(1)
    try:
        r = (await d.get_rate_limits([_req("ret", "ghost", -5,
                                           algorithm=int(pb.CONCURRENCY_LEASE))]))[0]
        assert r.status == pb.UNDER_LIMIT and r.remaining == 100
        assert await d.runner.live_count() == 0
    finally:
        await _close([d])


@async_test
async def test_lease_quota_grant_accounts_against_real_limit():
    (d,) = await _port_cluster(1)
    c = V1Client(d.conf.grpc_address)
    try:
        r = await c.lease_quota(pb.LeaseQuotaReq(
            name="api", unique_key="t1", tokens=20, limit=100, duration=MINUTE, ttl_ms=5_000))
        assert r.granted == 20 and r.lease_id and r.outstanding == 20
        assert r.expires_at > d.now_ms()
        chk = (await c.get_rate_limits([_req("api", "t1")])).responses[0]
        assert chk.remaining == 80
        led = (await c.get_rate_limits([_req(
            "api" + tlm.LEDGER_SUFFIX, "t1", limit=50, duration=5_000,
            algorithm=int(pb.CONCURRENCY_LEASE))])).responses[0]
        assert led.remaining == 30
        r2 = await c.lease_quota(pb.LeaseQuotaReq(
            name="api", unique_key="t1", return_tokens=5, limit=100, duration=MINUTE,
            lease_id=r.lease_id))
        assert r2.outstanding == 15 and r2.remaining == 85
        dbg = d.debug_leases()
        assert dbg["outstanding_tokens_total"] == dbg["over_admission_bound"] == 15
        assert dbg["ops"]["returns"] == 1
    finally:
        await c.close()
        await _close([d])


@async_test
async def test_lease_cap_and_exhaustion_fall_back():
    (d,) = await _port_cluster(1)
    c = V1Client(d.conf.grpc_address)
    try:
        ask = lambda n: c.lease_quota(pb.LeaseQuotaReq(  # noqa: E731
            name="cap", unique_key="k", tokens=n, limit=100, duration=MINUTE, ttl_ms=5_000))
        assert (await ask(1000)).granted == 50
        r2 = await ask(10)
        assert r2.granted == 0 and r2.outstanding == 50 and r2.retry_after_ms >= 0
        assert d.lease_manager.denies == 1
        chk = (await c.get_rate_limits([_req("cap", "k", 1)])).responses[0]
        assert chk.status == pb.UNDER_LIMIT
    finally:
        await c.close()
        await _close([d])


@async_test
async def test_lease_forged_return_cannot_mint_tokens():
    (d,) = await _port_cluster(1)
    c = V1Client(d.conf.grpc_address)

    async def remaining():
        return (await c.get_rate_limits([_req("forge", "k")])).responses[0].remaining

    try:
        await c.get_rate_limits([_req("forge", "k", 40)])
        r = await c.lease_quota(pb.LeaseQuotaReq(
            name="forge", unique_key="k", return_tokens=40, limit=100, duration=MINUTE,
            lease_id="deadbeef"))
        assert r.granted == 0 and await remaining() == 60
        assert d.lease_manager.unknown_returns == 1
        other = await c.lease_quota(pb.LeaseQuotaReq(
            name="other", unique_key="x", tokens=5, limit=100, duration=MINUTE))
        assert other.granted == 5
        r2 = await c.lease_quota(pb.LeaseQuotaReq(
            name="forge", unique_key="k", return_tokens=40, limit=100, duration=MINUTE,
            lease_id=other.lease_id))
        assert r2.granted == 0 and await remaining() == 60
        assert d.lease_manager.unknown_returns == 2
        assert d.lease_manager._leases[other.lease_id].outstanding == 5
        r3 = await c.lease_quota(pb.LeaseQuotaReq(
            name="forge", unique_key="k", tokens=4, limit=100, duration=MINUTE,
            lease_id=other.lease_id))
        assert r3.granted == 4 and r3.lease_id != other.lease_id
        assert d.lease_manager._leases[other.lease_id].outstanding == 5
        assert d.lease_manager._leases[r3.lease_id].outstanding == 4
    finally:
        await c.close()
        await _close([d])


@async_test
async def test_lease_ttl_reclaims_ledger_without_scan():
    (d,) = await _port_cluster(1)
    c = V1Client(d.conf.grpc_address)
    ask = lambda: c.lease_quota(pb.LeaseQuotaReq(  # noqa: E731
        name="ttl", unique_key="k", tokens=50, limit=100, duration=MINUTE, ttl_ms=150))
    try:
        assert (await ask()).granted == 50

        async def reclaimed():
            return (await ask()).granted == 50

        await wait_for(reclaimed, timeout_s=5)
        assert d.debug_leases()["ops"]["expirations"] >= 1
        chk = (await c.get_rate_limits([_req("ttl", "k")])).responses[0]
        assert chk.remaining == 0  # expiry refunds nothing: conservative
    finally:
        await c.close()
        await _close([d])


@pytest.mark.parametrize("behavior,dcs,want", [
    (int(Behavior.GLOBAL), None, 70),
    (int(Behavior.MULTI_REGION), ["dc-a", "dc-b"], 75),
])
@async_test
async def test_lease_grant_rides_global_and_multi_region(behavior, dcs, want):
    """A GLOBAL grant is broadcast like ordinary GLOBAL hits; a MULTI_REGION
    grant replicates through the region plane: the other daemon's view
    converges to limit - granted."""
    ds = await _port_cluster(2, dcs=dcs)
    cl = V1Client(ds[0].conf.grpc_address)
    try:
        r = await cl.lease_quota(pb.LeaseQuotaReq(
            name="rides", unique_key="k", tokens=100 - want, limit=100, duration=MINUTE,
            behavior=behavior, ttl_ms=5_000))
        assert r.granted == 100 - want

        async def converged():
            views = ds if dcs is None else ds[1:]
            outs = [(await d.get_rate_limits([_req("rides", "k", behavior=behavior)]))[0]
                    for d in views]
            return all(o.remaining == want for o in outs)

        await wait_for(converged, timeout_s=10)
    finally:
        await cl.close()
        await _close(ds)


@async_test
async def test_retry_after_first_class_in_client():
    (d,) = await _port_cluster(1)
    c = V1Client(d.conf.grpc_address)
    try:
        req = _req("ra", "k", 1, limit=1)
        await c.get_rate_limits([req])
        denied = (await c.check([req]))[0]
        assert denied.status == 1 and 0 < denied.retry_after_ms <= MINUTE
        raw = (await c.get_rate_limits([req])).responses[0]
        assert response_retry_after_ms(raw) > 0
        assert response_from_pb(raw).retry_after_ms == response_retry_after_ms(raw)
    finally:
        await c.close()
        await _close([d])


# ------------------------------------------------- the scripted sequence


@pytest.fixture
def clock(monkeypatch):
    """A settable ms_now in both packages' engine, batcher and daemon, and one
    seeded uuid4 in each package's lease manager."""
    import importlib
    import types

    now = [NOW]
    for pkg in ("gubernator_tpu", "gubernator_tpu_torch"):
        for mod in ("ops.engine", "service.batcher", "service.daemon"):
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"), "ms_now",
                                lambda: now[0])
    for lm in (jlm, tlm):
        monkeypatch.setattr(lm, "uuid", types.SimpleNamespace(uuid4=cs.lease_uuid(15)))
    return now


@async_test
async def test_lease_sequence_matches_jax_daemon(clock):
    confs = [daemon_config(**cs.LEASE_PARITY_CONF), port_config(**cs.LEASE_PARITY_CONF)]
    for conf in confs:
        for k, v in cs.LEASE_PARITY_BEHAVIORS.items():
            setattr(conf.behaviors, k, v)
    jd = await JDaemon.spawn(confs[0])
    td = await TDaemon.spawn(confs[1], device="cpu")
    ds = (jd, td)
    for d, peer in zip(ds, (JPeer, TPeer)):
        d.set_peers(cs.lease_peers(d, peer))
    clients = [V1Client(d.conf.grpc_address) for d in ds]
    try:
        outs = []
        for c in clients:
            clock[0] = NOW

            def advance(ms):
                clock[0] += ms

            outs.append(await cs.run_lease_script(c, advance))
        assert outs[0] == outs[1]
        states = [cs.lease_state(d) for d in ds]
        assert states[0] == states[1]
        assert td.engine.snapshot().tobytes() == np.asarray(jd.engine.table.rows).tobytes()
        leases = cs.lease_responses(outs[1])
        # acquire, the partial grant at the cap, the denial, the clamped
        # renew, the forged and unknown returns, priority scaling with its
        # shrink hints, GLOBAL, MULTI_REGION, and the whole cap after TTL
        assert [r.granted for r in leases] == [20, 30, 0, 10, 0, 0, 20, 25, 1, 1, 10, 10, 50]
        assert leases[2].retry_after_ms > 0 and [r.shrink_to for r in leases[8:10]] == [10, 1]
        dbg = states[1]["debug"]
        assert dbg["ops"]["unknown_returns"] == 2 and dbg["ops"]["expirations"] == 7
        assert list(states[1]["global_updates"]) == ["ls_g"]
        assert list(states[1]["region_pending"]["dc2"]) == ["ls_m"]
    finally:
        for c in clients:
            await c.close()
        for d, peer in zip(ds, (JPeer, TPeer)):
            d.set_peers(cs.lease_peers(d, peer)[:1])  # dc2's queue drops at close
            await d.close()


@async_test
async def test_local_limiters_interop_with_jax():
    """A port LocalLimiter against a JAX daemon and a JAX LocalLimiter
    against a port daemon: local admissions, the per-check fallback, and
    admissions ≤ what the daemon consumed."""
    jd = await JDaemon.spawn(daemon_config())
    (td,) = await _port_cluster(1)
    try:
        for cls, d in ((LocalLimiter, jd), (JLimiter, td)):
            lim = cls(d.conf.grpc_address, "edge", "u1", limit=100, duration=MINUTE,
                      ttl_ms=5_000, initial_grant=10)
            await lim.start()
            assert lim.budget == 10
            assert all(lim.allow() for _ in range(10)) and not lim.allow()
            ok, _ = await lim.check()
            assert ok and lim.stats.rpc_checks >= 1
            total = lim.stats.local_admits + lim.stats.rpc_admits
            await lim.close()
            chk = (await d.get_rate_limits([_req("edge", "u1")]))[0]
            assert total <= 100 - chk.remaining
    finally:
        await jd.close()
        await _close([td])


# -------------------------------------------------------------- edge plane


@async_test
async def test_local_limiter_adaptive_sizing():
    (d,) = await _port_cluster(1)
    lim = LocalLimiter(d.conf.grpc_address, "adapt", "u", limit=10_000, duration=MINUTE,
                       ttl_ms=400, initial_grant=8)
    try:
        await lim.start()
        for _ in range(200):
            lim.allow()
            await asyncio.sleep(0)

        async def doubled():
            while lim.allow():
                pass
            return lim.stats.grants >= 2 and any(g > 8 for g in lim.stats.grant_sizes)

        await wait_for(doubled, timeout_s=10)
        peak = max(lim.stats.grant_sizes)

        async def shrunk():
            return lim.stats.tokens_returned > 0 and lim.stats.grant_sizes[-1] < peak

        await wait_for(shrunk, timeout_s=10)
    finally:
        await lim.close()
        await _close([d])


@async_test
async def test_local_limiter_thread_concurrency_exact():
    (d,) = await _port_cluster(1)
    lim = LocalLimiter(d.conf.grpc_address, "conc", "u", limit=5_000, duration=MINUTE,
                       ttl_ms=300, initial_grant=64)
    try:
        await lim.start()
        admitted = [0] * 8
        stop = threading.Event()

        def worker(i):
            while not stop.is_set():
                if lim.allow():
                    admitted[i] += 1
                else:
                    stop.wait(0.001)

        loop = asyncio.get_running_loop()
        futs = [loop.run_in_executor(None, worker, i) for i in range(8)]
        await asyncio.sleep(1.0)
        stop.set()
        await asyncio.gather(*futs)
        await asyncio.sleep(0.05)
        total = sum(admitted)
        assert total == lim.stats.local_admits > 0 and lim.stats.grants >= 2
        assert (lim.stats.local_admits + lim.budget + lim.stats.tokens_returned
                == lim.stats.tokens_granted)
        await lim.close()
        chk = (await d.get_rate_limits([_req("conc", "u", limit=5_000)]))[0]
        assert total <= 5_000 - chk.remaining
    finally:
        await _close([d])


@async_test
async def test_local_limiter_daemon_restart_bound(tmp_path):
    """kill -9 and a warm restart mid-lease: admissions ≤ limit +
    outstanding-at-crash, and ≥ outstanding-at-crash."""
    LIMIT = 100
    conf = lambda: port_config(checkpoint_path=str(tmp_path / "ckpt.bin"),  # noqa: E731
                               checkpoint_interval_ms=25.0)
    d = await TDaemon.spawn(conf(), device="cpu")
    addr = d.conf.grpc_address
    lim = LocalLimiter(addr, "boom", "k", limit=LIMIT, duration=10 * MINUTE,
                       ttl_ms=20_000, initial_grant=30)
    try:
        await lim.start()
        assert lim.stats.tokens_granted == 30
        assert all(lim.allow() for _ in range(10))
        outstanding = lim.budget
        assert outstanding == 20
        await asyncio.sleep(0.3)  # the incremental checkpoint covers every grant
        await d.abort()
        c = conf()
        c.grpc_address = addr
        d = await TDaemon.spawn(c, device="cpu")
        while lim.allow():
            pass
        for _ in range(3 * LIMIT):
            await lim.check()
            await asyncio.sleep(0)
        total = lim.stats.local_admits + lim.stats.rpc_admits
        assert outstanding <= total <= LIMIT + outstanding
    finally:
        await lim.close()
        await d.close()

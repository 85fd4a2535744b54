"""The overload plane on the port: the nine cases of tests/test_overload.py.

The batcher cases drive the port's ``Batcher`` behind ``GatedRunner``, an
echo runner that holds its first dispatch (the twin of the reference's);
the daemon cases run on port daemons over CPU engines. The contract is the
reference's: zero priority inversions, the shed counts by tier and reason,
shed rows never reaching the engine, the auto deadline following the
runner's issue EWMA, lease grants scaled by tier (the same grants and hints
as a JAX daemon's) and the LocalLimiter honoring a push-shrink hint.
"""

import asyncio
import time

import grpc
import numpy as np

from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.edge import LocalLimiter
from gubernator_tpu_torch.ops.batch import ERR_OVERLOAD, RequestColumns, ResponseColumns
from gubernator_tpu_torch.ops.engine import ms_now
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.service import deadline as deadline_mod
from gubernator_tpu_torch.service.batcher import OVERLOAD_AUTO_DEADLINE_MULT, Batcher
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.types import priority_tier, with_cascade_level, with_priority

from tests.cluster import daemon_config
from tests.test_torch_service import async_test
from tests.torch_cluster import port_config

NOW = ms_now()


def _cols(rows: int, tier: int = 0, base: int = 0, fp0: int = 0) -> RequestColumns:
    """A column batch at one priority tier; fp0 pins the leading
    fingerprint (the batcher's tenant bucket) when nonzero."""
    fp = np.arange(base + 1, base + rows + 1, dtype=np.int64)
    if fp0:
        fp[0] = fp0
    return RequestColumns(
        fp=fp, algo=np.zeros(rows, dtype=np.int32),
        behavior=np.full(rows, with_priority(0, tier), dtype=np.int32),
        hits=np.ones(rows, dtype=np.int64), limit=np.full(rows, 100, dtype=np.int64),
        burst=np.zeros(rows, dtype=np.int64), duration=np.full(rows, 60_000, dtype=np.int64),
        created_at=np.full(rows, NOW, dtype=np.int64), err=np.zeros(rows, dtype=np.int8),
    )


class GatedRunner:
    """Echo runner that blocks the FIRST dispatch on an event — the
    saturated engine the overload cases queue behind."""

    def __init__(self):
        self.gate = asyncio.Event()
        self.dispatch_rows = []
        self.dispatch_tiers = []  # leading row's tier, per dispatch

    async def check_wire(self, parts, span=None):
        return None

    async def check(self, cols, now_ms=None, span=None):
        self.dispatch_rows.append(cols.fp.shape[0])
        self.dispatch_tiers.append(priority_tier(int(cols.behavior[0])))
        if len(self.dispatch_rows) == 1:
            await self.gate.wait()
        n = cols.fp.shape[0]
        return ResponseColumns(
            status=np.zeros(n, dtype=np.int32), limit=cols.limit.copy(),
            remaining=cols.limit - cols.hits, reset_time=np.zeros(n, dtype=np.int64),
            err=np.zeros(n, dtype=np.int8),
        )


class GatedDaemonRunner:
    """A daemon's own runner behind a gate on its first dispatch: every
    other attribute is the real runner's."""

    def __init__(self, runner):
        self._runner = runner
        self.gate = asyncio.Event()
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._runner, name)

    async def _gated(self):
        self.calls += 1
        if self.calls == 1:
            await self.gate.wait()

    async def check_wire(self, parts, span=None):
        await self._gated()
        return await self._runner.check_wire(parts, span=span)

    async def check(self, cols, now_ms=None, span=None):
        await self._gated()
        return await self._runner.check(cols, now_ms=now_ms, span=span)


def _shed_all(rc: ResponseColumns) -> bool:
    return bool((np.asarray(rc.err) == ERR_OVERLOAD).all()
                and (np.asarray(rc.status) == 1).all())


def _served_all(rc: ResponseColumns) -> bool:
    return bool((np.asarray(rc.err) == 0).all())


def _gated_batcher(**kw):
    runner = GatedRunner()
    return runner, Batcher(runner, batch_wait_ms=0.5, workers=1, adaptive=True, **kw)


@async_test
async def test_preemption_sheds_lowest_tier_zero_inversions():
    runner, b = _gated_batcher(coalesce_limit=64, max_queue_rows=64,
                               overload_deadline_ms=2_000.0)
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)  # the worker took it; the engine is gated
    low = asyncio.ensure_future(b.check(_cols(64, tier=0, base=100)))
    await asyncio.sleep(0.05)  # fills the ring
    high = asyncio.ensure_future(b.check(_cols(32, tier=3, base=300)))
    await asyncio.sleep(0.05)
    runner.gate.set()
    r_first, r_low, r_high = await asyncio.gather(first, low, high)
    assert _served_all(r_first)
    assert _shed_all(r_low), "queued tier-0 rows must be preempted"
    assert _served_all(r_high), "tier-3 arrival must be served"
    assert b.shed_rows["preempted"] == 64
    assert b.shed_by_tier[0] == 64 and b.shed_by_tier[3] == 0
    assert b.priority_inversions == 0
    assert sum(runner.dispatch_rows) == 16 + 32  # preempted rows never dispatched
    assert (np.asarray(r_low.reset_time) > 0).all()  # the retry hint
    await b.drain()


@async_test
async def test_fair_admission_caps_abusive_tenant():
    runner, b = _gated_batcher(coalesce_limit=128, max_queue_rows=128,
                               overload_deadline_ms=5_000.0, tenant_share=0.25,
                               tenant_buckets=64)
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)
    abuse1 = asyncio.ensure_future(b.check(_cols(64, base=1_000, fp0=5)))
    await asyncio.sleep(0.05)  # 64 pending = half the ring: pressured
    abuse2 = asyncio.ensure_future(b.check(_cols(32, base=2_000, fp0=5)))
    victim = asyncio.ensure_future(b.check(_cols(16, base=3_000, fp0=7)))
    await asyncio.sleep(0.05)
    runner.gate.set()
    r1, ra1, ra2, rv = await asyncio.gather(first, abuse1, abuse2, victim)
    assert _served_all(r1) and _served_all(ra1)
    assert _shed_all(ra2), "abuser beyond its share must shed"
    assert _served_all(rv), "other tenants must keep being admitted"
    assert b.shed_rows["fairness"] == 32
    assert b.priority_inversions == 0
    await b.drain()


@async_test
async def test_deadline_expired_items_shed_not_served():
    runner, b = _gated_batcher(coalesce_limit=64, max_queue_rows=1024,
                               overload_deadline_ms=100.0)
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)
    stale = asyncio.ensure_future(b.check(_cols(32, base=100)))
    await asyncio.sleep(0.3)  # stale's 100 ms deadline passes in the queue
    runner.gate.set()
    r_first, r_stale = await asyncio.gather(first, stale)
    assert _served_all(r_first)
    assert _shed_all(r_stale), "expired work must be shed, not served"
    assert b.shed_rows["deadline"] == 32
    assert runner.dispatch_rows == [16], "expired rows must not dispatch"
    await b.drain()


@async_test
async def test_inbound_grpc_deadline_bounds_queue_wait():
    """Without the overload knob a caller's inbound deadline alone bounds
    the queue wait: on the batcher through the contextvar, and on a port
    daemon through a real gRPC deadline, whose rows never reach the
    engine."""
    runner, b = _gated_batcher(coalesce_limit=64, max_queue_rows=1024)
    assert not b.armed
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)
    deadline_mod.set_inbound_deadline(0.1)
    stale = asyncio.ensure_future(b.check(_cols(8, base=100)))
    deadline_mod.set_inbound_deadline(None)
    await asyncio.sleep(0.3)
    runner.gate.set()
    _, r_stale = await asyncio.gather(first, stale)
    assert _shed_all(r_stale)
    assert b.shed_rows["deadline"] == 8
    await b.drain()

    conf = port_config()
    conf.behaviors.pipeline_inflight = 1
    conf.behaviors.front_workers = 1
    d = await TDaemon.spawn(conf, device="cpu")
    gated = GatedDaemonRunner(d.batcher.runner)
    d.batcher.runner = gated
    client = V1Client(f"127.0.0.1:{d.grpc_port}", timeout_s=30)
    try:
        assert not d.batcher.armed
        checks0 = d.engine.stats.checks

        def items(prefix, n):
            return [pb.RateLimitReq(name="dl", unique_key=f"{prefix}{i}", hits=1, limit=10,
                                    duration=60_000) for i in range(n)]

        first = asyncio.ensure_future(client.get_rate_limits(items("a", 16)))
        await asyncio.sleep(0.1)
        try:
            await client.get_rate_limits(items("b", 8), timeout_s=0.1)
            raise AssertionError("a call past its deadline was answered")
        except grpc.aio.AioRpcError as exc:
            assert exc.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        await asyncio.sleep(0.1)
        gated.gate.set()
        r = await first
        assert [x.remaining for x in r.responses] == [9] * 16

        async def shed():
            return d.batcher.shed_rows["deadline"] == 8

        from tests.torch_cluster import wait_for

        await wait_for(shed, timeout_s=5)
        assert d.engine.stats.checks - checks0 == 16  # the shed rows never ran
    finally:
        await client.close()
        await d.close()


@async_test
async def test_tier_rides_wire_and_dispatch_order():
    assert priority_tier(with_priority(0, 3)) == 3
    assert priority_tier(with_priority(8, 2)) == 2  # RESET kept below
    runner, b = _gated_batcher(coalesce_limit=16, max_queue_rows=1024,
                               overload_deadline_ms=5_000.0)
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)
    lo = asyncio.ensure_future(b.check(_cols(16, tier=0, base=100)))
    hi = asyncio.ensure_future(b.check(_cols(16, tier=2, base=200)))
    await asyncio.sleep(0.05)
    runner.gate.set()
    await asyncio.gather(first, lo, hi)
    # one chunk per entry; tier 2 goes before tier 0 though it came later
    assert runner.dispatch_rows == [16, 16, 16]
    assert runner.dispatch_tiers == [0, 2, 0]
    assert b.admitted_by_tier[2] == 16 and b.admitted_by_tier[0] == 32
    assert b.priority_inversions == 0
    await b.drain()


def _cascade_cols(rows: int, level: int, base: int = 0, fp0: int = 0) -> RequestColumns:
    c = _cols(rows, base=base, fp0=fp0)
    return c._replace(behavior=np.full(rows, with_cascade_level(0, level), dtype=np.int32))


@async_test
async def test_cost_weighted_fairness_stops_cascade_starvation():
    """A cascade-heavy tenant exhausts its share by cost and sheds while a
    cheap tenant is admitted; the same row counts without cascades never
    pressure the door."""
    kw = dict(coalesce_limit=128, max_queue_rows=128, overload_deadline_ms=5_000.0,
              tenant_share=0.25, tenant_buckets=64)
    runner, b = _gated_batcher(**kw)
    first = asyncio.ensure_future(b.check(_cols(16)))
    await asyncio.sleep(0.05)
    casc1 = asyncio.ensure_future(b.check(_cascade_cols(16, 3, base=1_000, fp0=5)))
    await asyncio.sleep(0.05)  # 64 cost units pending: pressured
    casc2 = asyncio.ensure_future(b.check(_cascade_cols(8, 3, base=2_000, fp0=5)))
    victim = asyncio.ensure_future(b.check(_cols(16, base=3_000, fp0=7)))
    await asyncio.sleep(0.05)
    runner.gate.set()
    r1, rc1, rc2, rv = await asyncio.gather(first, casc1, casc2, victim)
    assert _served_all(r1) and _served_all(rc1)
    assert _shed_all(rc2), "cascade tenant beyond its cost share must shed"
    assert _served_all(rv), "cheap single-row traffic must not starve"
    assert b.shed_rows["fairness"] == 8
    assert b.priority_inversions == 0
    await b.drain()

    runner2, b2 = _gated_batcher(**kw)
    first2 = asyncio.ensure_future(b2.check(_cols(16)))
    await asyncio.sleep(0.05)
    p1 = asyncio.ensure_future(b2.check(_cols(16, base=1_000, fp0=5)))
    await asyncio.sleep(0.05)
    p2 = asyncio.ensure_future(b2.check(_cols(8, base=2_000, fp0=5)))
    await asyncio.sleep(0.05)
    runner2.gate.set()
    rf, rp1, rp2 = await asyncio.gather(first2, p1, p2)
    assert _served_all(rf) and _served_all(rp1) and _served_all(rp2)
    assert b2.shed_rows["fairness"] == 0
    await b2.drain()


@async_test
async def test_auto_deadline_tracks_issue_ewma():
    """Auto arms the door with OVERLOAD_AUTO_DEADLINE_MULT × the runner's
    issue EWMA, floored at shed_retry_ms: on the batcher with a set EWMA,
    and on a port daemon with the EWMA its own runner measured."""
    runner, b = _gated_batcher(coalesce_limit=64, max_queue_rows=1024,
                               overload_deadline_auto=True, shed_retry_ms=25)
    assert b.armed
    d0 = b._item_deadline()
    assert d0 is not None and abs((d0 - time.monotonic()) - 0.025) < 0.01
    runner.issue_ewma = 0.002
    d1 = b._item_deadline()
    assert abs((d1 - time.monotonic()) - OVERLOAD_AUTO_DEADLINE_MULT * 0.002) < 0.05
    await b.drain()

    conf = port_config()
    conf.behaviors.overload_deadline_auto = True
    conf.behaviors.overload_retry_ms = 1
    d = await TDaemon.spawn(conf, device="cpu")
    client = V1Client(f"127.0.0.1:{d.grpc_port}", timeout_s=30)
    try:
        assert d.batcher.armed
        for i in range(3):
            r = await client.get_rate_limits([pb.RateLimitReq(
                name="auto", unique_key=f"k{j}", hits=1, limit=10, duration=60_000)
                for j in range(64)])
            assert all(x.remaining == 9 - i for x in r.responses)
        ewma = d.runner.issue_ewma
        assert ewma > 0, "the port runner measured no issue stage"
        got = d.batcher._item_deadline() - time.monotonic()
        assert abs(got - max(0.001, OVERLOAD_AUTO_DEADLINE_MULT * ewma)) < 0.05
        assert d.batcher.priority_inversions == 0
    finally:
        await client.close()
        await d.close()


@async_test
async def test_lease_grants_scale_with_tier():
    """GUBER_PRIORITY_LEASE_SCALING on a port daemon: tier 3 gets the full
    ask, tier 0 a quarter, pressured keys push shrink_to at low tiers — the
    same grants and hints as a JAX daemon's."""
    from gubernator_tpu.proto import gubernator_pb2 as jpb

    def req(mod, key, tokens, tier, lease_id=""):
        return mod.LeaseQuotaReq(name="qos", unique_key=key, tokens=tokens, limit=1_000,
                                 duration=60_000, ttl_ms=2_000, lease_id=lease_id,
                                 behavior=with_priority(0, tier))

    seen = []
    for mod, spawn, conf in ((jpb, lambda c: JDaemon.spawn(c), daemon_config()),
                             (pb, lambda c: TDaemon.spawn(c, device="cpu"), port_config())):
        conf.lease_priority_scaling = True
        conf.lease_max_fraction = 0.5  # cap = 500 of the 1,000 limit
        d = await spawn(conf)
        try:
            r3 = await d.lease_quota(req(mod, "k-hi", 400, 3))
            r0 = await d.lease_quota(req(mod, "k-lo", 400, 0))
            ra = await d.lease_quota(req(mod, "k-lo", 1_000, 3))
            rb = await d.lease_quota(req(mod, "k-lo", 4, 0, lease_id=r0.lease_id))
            rc = await d.lease_quota(req(mod, "k-lo", 4, 3, lease_id=ra.lease_id))
        finally:
            await d.close()
        seen.append([(r.granted, r.shrink_to, r.remaining, r.outstanding, r.limit)
                     for r in (r3, r0, ra, rb, rc)])
    assert seen[1] == seen[0]
    (g3, s3, *_), (g0, s0, *_), (ga, *_), (gb, sb, *_), (_, sc, *_) = seen[1]
    assert g3 == 400 and g0 == 100  # tier 3 the full ask, tier 0 a quarter
    assert s3 == 0 and s0 == 0  # no pressure yet
    assert ga > 0
    assert 0 < sb < 100 + gb, "a pressured low-tier lease must be asked to shrink"
    assert sc == 0  # tier 3 is never asked to shrink


class _ShrinkClient(V1Client):
    """Stub lease endpoint: grants, then pushes a shrink_to hint."""

    def __init__(self):
        super().__init__("127.0.0.1:1")  # a lazy channel, never connected
        self.calls = 0
        self.shrink_to = 0
        self.returned = 0

    async def lease_quota(self, req, timeout_s=None):
        self.calls += 1
        self.returned += int(req.return_tokens)
        return pb.LeaseQuotaResp(lease_id="L1", granted=int(req.tokens),
                                 expires_at=ms_now() + 60_000, limit=req.limit,
                                 remaining=req.limit, shrink_to=self.shrink_to)


@async_test
async def test_local_limiter_honors_push_shrink_hint():
    """A shrink_to hint clamps the edge's grant target and the next renewal
    returns the excess: from a stub endpoint, as the reference drives it,
    then from a port daemon whose priority scaling pushes the hint to a
    tier-0 limiter once a tier-3 lease presses its key."""
    client = _ShrinkClient()
    # waste_fraction 10: no adaptive halving, so a giveback is the hint's
    lim = LocalLimiter(client, "edge", "u1", limit=1_000, duration=60_000, ttl_ms=60_000,
                       initial_grant=64, waste_fraction=10.0)
    await lim.start()
    assert lim.budget == 64 and lim.stats.shrinks == 0
    client.shrink_to = 8
    await lim._renew_once()
    assert lim.stats.shrinks == 1
    assert lim._grant <= 8, "the grant target must clamp to the hint"
    deadline = time.perf_counter() + 5
    while client.returned == 0 and time.perf_counter() < deadline:
        await asyncio.sleep(0.05)
    assert client.returned > 0, "the excess budget must return early"
    await lim.close()
    await client.close()

    conf = port_config()
    conf.lease_priority_scaling = True
    conf.lease_max_fraction = 0.5  # cap = 500 of the 1,000 limit
    d = await TDaemon.spawn(conf, device="cpu")
    lim = LocalLimiter(f"127.0.0.1:{d.grpc_port}", "edge", "u2", limit=1_000,
                       duration=60_000, behavior=with_priority(0, 0), ttl_ms=60_000,
                       initial_grant=64, waste_fraction=10.0)
    try:
        await lim.start()
        granted = lim.budget
        assert granted == 16  # tier 0: a quarter of the ask
        hog = await d.lease_quota(pb.LeaseQuotaReq(
            name="edge", unique_key="u2", tokens=1_000, limit=1_000, duration=60_000,
            ttl_ms=60_000, behavior=with_priority(0, 3)))
        assert hog.granted == 500 - granted  # the rest of the cap
        await lim._renew_once()  # the daemon answers with a shrink hint
        assert lim.stats.shrinks == 1 and 0 < lim._grant < 64
        before = d.debug_leases()["outstanding_tokens_total"]
        await lim._renew_once()  # returns what the clamped target exceeds
        assert lim.stats.tokens_returned > 0
        assert d.debug_leases()["outstanding_tokens_total"] < before
    finally:
        await lim.close()
        await d.close()

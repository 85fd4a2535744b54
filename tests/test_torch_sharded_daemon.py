"""The port's mesh daemon over more than one shard against the JAX
package's 8-device mesh daemon: the five cases of
tests/test_sharded_daemon.py on port daemons whose engine is a
``GlobalShardedEngine`` over an 8-shard CPU mesh (``engine=``), each beside
the JAX daemon with both packages' clocks frozen.

- gRPC serving: byte-equal responses, ``n_shards == 8`` on both sides.
- The device route under ``a2a="collective"`` and ``a2a="ring"`` (the
  second runs ``ring_exchange``'s plain version through the daemon).
- GLOBAL between two mesh daemons, and the standalone mesh's GLOBAL
  through its collective sync tick: the same remainders and counters.
- A checkpoint round trip into a fresh port mesh daemon; the snapshot
  file is byte-equal to the JAX daemon's.

Then the daemon's own sharded branch raises without a card, and a
reference property of the pipelined GLOBAL path (a finish retry after a
sync leaves the replicas off the owner) is pinned in both packages.
"""

import pytest
import torch

from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu_torch.parallel import global_sync as tglobal
from gubernator_tpu_torch.parallel import make_mesh
from gubernator_tpu_torch.parallel import ring as tring
from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon

from tests import cluster as jcluster
from tests import torch_cluster as tcluster
from tests.test_torch_service import _grpc_raw, async_test
from tests.torch_cluster import frozen, port_config  # noqa: F401

SHARDS = 8
GLOBAL = 2


def mesh_factory(conf):
    """A fresh port mesh engine for `conf`, built as the daemon's sharded
    branch builds it, over an 8-shard CPU mesh."""
    knob = lambda v: None if v == "auto" else v  # noqa: E731

    def make():
        return GlobalShardedEngine(
            make_mesh(SHARDS, devices=["cpu"] * SHARDS),
            capacity_per_shard=conf.cache_size // SHARDS,
            created_at_tolerance_ms=int(conf.created_at_tolerance_ms),
            route=knob(conf.shard_route), dedup=knob(conf.shard_dedup),
            a2a=knob(conf.a2a_impl))

    return make


async def spawn_pair(**kw):
    """A JAX sharded daemon and a port mesh daemon on the same settings."""
    jd = await JDaemon.spawn(jcluster.daemon_config(engine="sharded", **kw))
    tconf = port_config(engine="sharded", **kw)
    td = await TDaemon.spawn(tconf, engine=mesh_factory(tconf)())
    return jd, td


def req(key, name="sh", hits=1, limit=100, **kw):
    return pb.RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                           duration=60_000, **kw)


async def ask_both(ds, items):
    """The same request over gRPC to each daemon: the responses must be
    byte-equal; returns the decoded response."""
    got = [await _grpc_raw(d.grpc_port, items) for d in ds]
    assert all(g == got[0] for g in got), (items[:2], got)
    assert got[0][1] == "OK", got[0]
    return pb.GetRateLimitsResp.FromString(got[0][0]).responses


@async_test
async def test_sharded_daemon_serves_over_grpc(frozen):
    jd, td = await spawn_pair(cache_size=8192)
    try:
        assert isinstance(td.engine, GlobalShardedEngine)
        assert jd.engine.n_shards == td.engine.n_shards == SHARDS
        keys = [f"k{i}" for i in range(64)]
        r1 = await ask_both((jd, td), [req(k, hits=2) for k in keys])
        assert all(x.error == "" and x.remaining == 98 for x in r1)
        r2 = await ask_both((jd, td), [req(k, hits=1) for k in keys])
        assert all(x.remaining == 97 for x in r2)
        r3 = await ask_both((jd, td), [req("good"), pb.RateLimitReq(
            name="", unique_key="x", hits=1, limit=5, duration=60_000)])
        assert r3[0].error == "" and "namespace" in r3[1].error
        assert td.engine.live_count() == jd.engine.live_count() >= 64
        assert (td.engine.snapshot() == jd.engine.snapshot()).all()
    finally:
        await td.close()
        await jd.close()


@pytest.mark.parametrize("a2a", ["collective", "ring"])
@async_test
async def test_sharded_daemon_device_route_serves_over_grpc(a2a, frozen, monkeypatch):
    exchanges = []
    plain = tring.ring_exchange
    monkeypatch.setattr(tring, "ring_exchange",
                        lambda blocks, devices=None: exchanges.append(len(blocks))
                        or plain(blocks, devices))
    jd, td = await spawn_pair(cache_size=8192, shard_route="device", a2a_impl=a2a)
    try:
        assert jd.engine.route == td.engine.route == "device"
        assert td.engine.a2a_impl == a2a
        keys = [f"dr{i}" for i in range(96)]
        r1 = await ask_both((jd, td), [req(k, hits=2) for k in keys])
        assert all(x.error == "" and x.remaining == 98 for x in r1)
        r2 = await ask_both((jd, td), [req(k, hits=1) for k in keys])
        assert all(x.remaining == 97 for x in r2)
        assert td.engine.live_count() == jd.engine.live_count() >= 96
        # the ring's plain version ran through the daemon, 8 shards a call
        assert exchanges == ([SHARDS] * len(exchanges) if a2a == "ring" else [])
        assert len(exchanges) >= (4 if a2a == "ring" else 0)
        rg = await ask_both((jd, td), [req("drg", hits=2, behavior=GLOBAL)])
        assert rg[0].error == "" and rg[0].remaining == 98

        async def synced():
            return all(d.engine.global_stats.sync_rounds >= 1 for d in (jd, td))

        await tcluster.wait_for(synced, timeout_s=30.0)
        assert (td.engine.snapshot() == jd.engine.snapshot()).all()
    finally:
        await td.close()
        await jd.close()


@async_test
async def test_sharded_daemons_global_converges(frozen):
    """Two mesh daemons in each package: GLOBAL hits at the non-owner reach
    the owner, and the owner's answer converges to the same bytes."""
    conf = port_config(engine="sharded", cache_size=4096)
    jc = await jcluster.Cluster.start(2, engine="sharded", cache_size=4096)
    tc = await tcluster.Cluster.start(2, engine_factory=mesh_factory(conf),
                                      engine="sharded", cache_size=4096)
    try:
        assert all(d.engine.n_shards == SHARDS for d in tc.daemons)
        got = []
        for c in (jc, tc):
            owner = c.find_owning_daemon("sh", "gkey")
            non_owner = c.non_owning_daemons("sh", "gkey")[0]
            r = await _grpc_raw(non_owner.grpc_port, [req("gkey", hits=4, behavior=GLOBAL)])
            (x,) = pb.GetRateLimitsResp.FromString(r[0]).responses
            assert x.error == "" and x.remaining == 96

            async def owner_converged(owner=owner):
                ro = await owner.get_rate_limits([req("gkey", hits=0)])
                return ro[0].remaining == 96

            await tcluster.wait_for(owner_converged, timeout_s=15)
            got.append((r, await _grpc_raw(owner.grpc_port, [req("gkey", hits=0)])))
        assert got[1] == got[0]
    finally:
        await tc.stop()
        await jc.stop()


@async_test
async def test_standalone_mesh_global_over_grpc(frozen):
    """The standalone mesh daemon answers GLOBAL through its collective sync
    tick: the same answers at every home, and the exact mesh counters."""
    jd, td = await spawn_pair(cache_size=8192)
    try:
        D = td.engine.n_shards
        assert D == jd.engine.n_shards == SHARDS
        keys = [f"g{i}" for i in range(16)]
        r1 = await ask_both((jd, td), [req(k, hits=3, behavior=GLOBAL) for k in keys])
        assert all(x.error == "" and x.remaining == 97 for x in r1)
        for d in (jd, td):
            scrape = tcluster.scrape if d is td else jcluster.scrape

            async def synced(d=d, scrape=scrape):
                m = await scrape(d)
                return tcluster.metric_value(m, "gubernator_mesh_sync_rounds_total") >= 1

            await tcluster.wait_for(synced, timeout_s=40)
            m = await scrape(d)
            assert tcluster.metric_value(m, "gubernator_mesh_broadcasts_applied_total") == 16
            assert tcluster.metric_value(
                m, "gubernator_mesh_updates_installed_total") == 16 * (D - 1)
        # a zero-hit read at every home (homes rotate per dispatch)
        for _ in range(D):
            r = await ask_both((jd, td), [req(k, hits=0, behavior=GLOBAL) for k in keys])
            assert all(x.remaining == 97 for x in r)
        m = await tcluster.scrape(td)
        assert tcluster.metric_value(m, "gubernator_mesh_broadcasts_applied_total") == 16
        # hits from several homes reconcile at the owner: 97 - 4 × 2 = 89
        # (each answer depends on the sync ticks before it: errors only)
        for _ in range(4):
            for d in (jd, td):
                r = await _grpc_raw(d.grpc_port, [req("g0", hits=2, behavior=GLOBAL)])
                assert pb.GetRateLimitsResp.FromString(r[0]).responses[0].error == ""
        for d in (jd, td):
            async def converged(d=d):
                if d.engine.has_pending():
                    return False
                r = await _grpc_raw(d.grpc_port, [req("g0", hits=0, behavior=GLOBAL)])
                return pb.GetRateLimitsResp.FromString(r[0]).responses[0].remaining == 89

            await tcluster.wait_for(converged, timeout_s=40)
        for _ in range(D):
            r = await ask_both((jd, td), [req("g0", hits=0, behavior=GLOBAL)])
            assert r[0].remaining == 89
    finally:
        await td.close()
        await jd.close()


@async_test
async def test_sharded_daemon_checkpoint_roundtrip(frozen, tmp_path):
    """A port mesh daemon's shutdown snapshot restores into a fresh port
    mesh daemon; the file equals the JAX mesh daemon's, byte for byte."""
    snaps = {p: str(tmp_path / f"{p}.snap") for p in ("jax", "port")}
    jd = await JDaemon.spawn(jcluster.daemon_config(engine="sharded", cache_size=4096,
                                                    checkpoint_path=snaps["jax"]))
    tconf = port_config(engine="sharded", cache_size=4096, checkpoint_path=snaps["port"])
    td = await TDaemon.spawn(tconf, engine=mesh_factory(tconf)())
    try:
        await ask_both((jd, td), [req("persist", hits=7)])
    finally:
        await td.close()  # checkpoints on close
        await jd.close()
    assert open(snaps["port"], "rb").read() == open(snaps["jax"], "rb").read()
    # the port's file restores into a fresh port mesh daemon, and so does
    # the JAX daemon's
    for path in (snaps["port"], snaps["jax"]):
        conf = port_config(engine="sharded", cache_size=4096, checkpoint_path=path)
        d2 = await TDaemon.spawn(conf, engine=mesh_factory(conf)())
        try:
            r = await _grpc_raw(d2.grpc_port, [req("persist", hits=0)])
            assert pb.GetRateLimitsResp.FromString(r[0]).responses[0].remaining == 93
        finally:
            await d2.close()


def test_sharded_branch_raises_without_a_card(monkeypatch):
    """GUBER_ENGINE=sharded with no engine and no device names the card; with
    none present it raises, it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="cards asked for"):
        TDaemon(port_config(engine="sharded"))
    d = TDaemon(port_config(engine="sharded", cache_size=4096), device="cpu")
    assert d.engine.n_shards == 1


def test_finish_retry_after_a_sync_leaves_replicas_off_the_owner():
    """A reference property, pinned in both packages: on the pipelined
    GLOBAL path, rows a device-routed dispatch drops (pair-capacity
    overflow at a home-pinned replica dispatch) are retried in finish. The
    hits were queued at issue, so a sync between issue and finish
    broadcasts the owner's state and the retry then applies the hit to the
    home's replica once more: the replicas answer off the owner until the
    key's next hit. The same rows, answers and reads on both engines."""
    import numpy as np

    from gubernator_tpu.ops import batch as jbatch
    from gubernator_tpu.ops import engine as jengine
    from gubernator_tpu.ops.table2 import REM_I
    from gubernator_tpu.parallel import global_sync as jglobal
    from gubernator_tpu.parallel.mesh import make_mesh as jmesh
    from gubernator_tpu_torch.ops import batch as tbatch
    from gubernator_tpu_torch.ops import engine as tengine

    now = 1_700_000_000_000
    fp = np.arange(1, 1025, dtype=np.int64) * 7919
    got = {}
    for name, glob, mesh, batch, eng_mod in (
            ("jax", jglobal, jmesh(4), jbatch, jengine),
            ("port", tglobal, make_mesh(4, devices=["cpu"] * 4), tbatch, tengine)):
        eng = glob.GlobalShardedEngine(mesh, capacity_per_shard=1 << 12, route="device",
                                       dedup="device", a2a="collective", sync_out=4096)

        def cols(hits):
            n = fp.size
            return batch.RequestColumns(
                fp=fp, algo=np.zeros(n, np.int32), behavior=np.full(n, GLOBAL, np.int32),
                hits=np.full(n, hits, np.int64), limit=np.full(n, 100, np.int64),
                burst=np.zeros(n, np.int64), duration=np.full(n, 3_600_000, np.int64),
                created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))

        retries = []

        def fixup(fn):
            retries.append(1)
            return fn()

        pending = eng_mod.issue_check_columns(
            eng, eng_mod.prepare_check_columns(eng, cols(1), now_ms=now))
        eng.sync(now_ms=now)  # a sync tick between the issue and the finish
        rc, _ = eng_mod.finish_check_columns(eng, pending, fixup)
        eng.sync(now_ms=now)
        reads = [eng.check_columns(cols(0), now_ms=now).remaining.tolist() for _ in range(4)]
        found, slots = eng.read_state(fp)
        got[name] = (len(retries), rc.remaining.tolist(), reads, found.tolist(),
                     slots[:, REM_I].tolist())
    assert got["port"] == got["jax"]
    n_retries, answers, reads, found, owner = got["port"]
    assert n_retries == 1 and answers == [99] * fp.size
    assert all(found) and owner == [99] * fp.size  # the owner counted each hit once
    assert sum(r != 99 for read in reads for r in read) > 0  # replicas off the owner

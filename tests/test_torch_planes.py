"""The port daemon's planes of one process against the JAX package's: TLS,
incremental checkpoints and warm restart, the tiering sweep and the request
ring. One small config (8192 slots, the JAX test cluster's) and, where a
daemon's clock matters, the clock frozen in both packages.

- TLS from files, in a mixed ring that forwards both ways over mutual TLS,
  and AutoTLS in both directions between a JAX and a port daemon; AutoTLS
  without ``cryptography`` is a ConfigError, never plaintext.
- Checkpoints: a JAX-written base + delta log restores into a port daemon
  and the port's frames restore into a JAX daemon, with the restored
  tables byte-equal; the port's versions of tests/test_durability.py's
  replay, never-over-grant, torn-log, geometry-mismatch and kill -9 cases.
- The tiering sweep: the port's TierManager.sweep_once against the JAX
  one — shadow rows, tombstone frames, table bytes, fault-back responses.
- The request ring: the JAX ring's own protocol cases run on both rings
  with equal results, the persistent tier's watchdog, and a ring-armed
  port daemon byte-equal to a JAX one over gRPC.
"""

import asyncio
import ssl
import sys

import aiohttp
import grpc
import numpy as np
import pytest
from aiohttp import ClientSession

from gubernator_tpu.client import V1Client
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.service import ring as jring
from gubernator_tpu.service import tls as jtls
from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch.config import ConfigError
from gubernator_tpu_torch.ops.checkpoint import EpochTracker, extract_begin, finish_extract
from gubernator_tpu_torch.ops.engine import LocalEngine as TEngine
from gubernator_tpu_torch.ops.table2 import decode_live_slots
from gubernator_tpu_torch.service import ring as tring
from gubernator_tpu_torch.service import tls as ttls
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.service.peer_client import PeerClient as TPeerClient
from gubernator_tpu_torch.store import DeltaLog, fps_from_slots, load_snapshot_meta, save_snapshot
from gubernator_tpu_torch.types import PeerInfo as TPeer

from tests.cluster import daemon_config
from tests.test_torch_service import NOW, _grpc_raw, async_test, frozen  # noqa: F401
from tests.torch_cluster import port_config

HOUR = 3_600_000


@pytest.fixture
def clock(monkeypatch):
    """A settable ms_now in both packages' engine, batcher and daemon:
    clock[0] is the time every one of them reads."""
    import importlib

    now = [NOW]
    for pkg in ("gubernator_tpu", "gubernator_tpu_torch"):
        for mod in ("ops.engine", "service.batcher", "service.daemon"):
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"), "ms_now",
                                lambda: now[0])
    return now


def _item(key, hits, limit=100, name="pl", duration=HOUR, **kw):
    return pb.RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                           duration=duration, **kw)


def _live(rows, now=NOW):
    """fp → slot bytes of every live slot of a snapshot."""
    slots, fp, _exp = decode_live_slots(np.asarray(rows), now)
    return {int(f): s.tobytes() for f, s in zip(np.asarray(fp), np.asarray(slots))}


# ------------------------------------------------------------------- TLS


def _tls_files(tmp_path):
    bundle = jtls.generate_self_signed(("127.0.0.1",))
    paths = {}
    for name, data in (("ca", bundle.ca_pem), ("crt", bundle.cert_pem), ("key", bundle.key_pem)):
        p = tmp_path / f"{name}.pem"
        p.write_bytes(data)
        paths[name] = str(p)
    return bundle, dict(tls_ca_file=paths["ca"], tls_cert_file=paths["crt"],
                        tls_key_file=paths["key"], tls_client_auth="verify")


@async_test
async def test_tls_files_mixed_ring_forwards_both_ways(tmp_path):
    """A JAX and a port daemon on one CA-signed pair from files, mutual TLS:
    each forwards the other's keys over the TLS peer channel; the port's
    gateway serves HTTPS with the client certificate and refuses plaintext."""
    bundle, tls = _tls_files(tmp_path)
    jd = await JDaemon.spawn(daemon_config(**tls))
    td = await TDaemon.spawn(port_config(**tls), device="cpu")
    try:
        addrs = [(d.conf.advertise_address, d.conf.http_address) for d in (jd, td)]
        jd.set_peers([JPeer(grpc_address=a, http_address=h) for a, h in addrs])
        td.set_peers([TPeer(grpc_address=a, http_address=h) for a, h in addrs])
        creds = grpc.ssl_channel_credentials(root_certificates=bundle.ca_pem,
                                             private_key=bundle.key_pem,
                                             certificate_chain=bundle.cert_pem)
        keys = [f"t{i}" for i in range(24)]
        owners = {k: td.get_peer("pl_" + k).grpc_address for k in keys}
        assert set(owners.values()) == {jd.conf.advertise_address, td.conf.advertise_address}
        for d in (jd, td):
            client = V1Client(d.conf.grpc_address, credentials=creds, timeout_s=15.0)
            try:
                resp = await client.get_rate_limits([_item(k, 1, limit=10) for k in keys])
            finally:
                await client.close()
            want = 9 if d is jd else 8
            assert [(r.error, r.remaining) for r in resp.responses] == [("", want)] * len(keys)
        mtls = ssl.create_default_context(cadata=bundle.ca_pem.decode())
        mtls.check_hostname = False
        mtls.load_cert_chain(tls["tls_cert_file"], tls["tls_key_file"])
        async with ClientSession() as s:
            async with s.post(f"https://{td.conf.http_address}/v1/GetRateLimits",
                              json={"requests": [{"name": "pl", "unique_key": "t0",
                                                  "hits": 0, "limit": 10,
                                                  "duration": HOUR}]}, ssl=mtls) as r:
                assert r.status == 200
                assert (await r.json())["responses"][0]["remaining"] == "8"
            with pytest.raises(aiohttp.ClientError):
                async with s.get(f"http://{td.conf.http_address}/metrics") as r:
                    await r.read()
    finally:
        await td.close()
        await jd.close()


@async_test
async def test_auto_tls_both_directions_against_jax():
    """AutoTLS on both sides: a JAX client given the port daemon's CA and a
    port peer client given the JAX daemon's CA each get answers; a plaintext
    client gets none from the port daemon."""
    jconf = daemon_config(tls_auto=True, http_address="")
    tconf = port_config(tls_auto=True, http_address="")
    jd = await JDaemon.spawn(jconf)
    td = await TDaemon.spawn(tconf, device="cpu")
    try:
        tca = ttls.bundle_from_config(tconf).ca_pem
        client = V1Client(td.conf.grpc_address, timeout_s=15.0,
                          credentials=grpc.ssl_channel_credentials(root_certificates=tca))
        resp = await client.get_rate_limits([_item("a", 1, limit=5)])
        await client.close()
        assert resp.responses[0].remaining == 4
        plain = V1Client(td.conf.grpc_address, timeout_s=2.0)
        with pytest.raises(grpc.aio.AioRpcError):
            await plain.get_rate_limits([_item("b", 1, limit=5)])
        await plain.close()
        from gubernator_tpu_torch.proto import peers_pb2 as tpeers_pb
        from gubernator_tpu_torch.proto import gubernator_pb2 as tpb

        jca = jtls.bundle_from_config(jconf).ca_pem
        peer = TPeerClient(TPeer(grpc_address=jd.conf.advertise_address),
                           channel_credentials=grpc.ssl_channel_credentials(root_certificates=jca))
        try:
            out = await peer.get_peer_rate_limits(tpeers_pb.GetPeerRateLimitsReq(requests=[
                tpb.RateLimitReq(name="pl", unique_key="c", hits=2, limit=5, duration=HOUR)]),
                timeout=15.0)
        finally:
            await peer.shutdown()
        assert out.rate_limits[0].remaining == 3
    finally:
        await td.close()
        await jd.close()


def test_auto_tls_without_cryptography_is_a_config_error(monkeypatch):
    """AutoTLS where `cryptography` is missing raises ConfigError naming the
    package at Daemon(): the daemon never serves plaintext instead."""
    monkeypatch.setattr(ttls, "_auto_cache", {})
    monkeypatch.setitem(sys.modules, "cryptography", None)
    with pytest.raises(ConfigError, match="cryptography"):
        TDaemon(port_config(tls_auto=True), device="cpu")
    with pytest.raises(OSError):
        TDaemon(port_config(tls_cert_file="/nonexistent/c.pem",
                            tls_key_file="/nonexistent/k.pem"), device="cpu")


# ------------------------------------------------------------ checkpoints


def _ckpt(path, **kw):
    """Checkpoints at `path`, their loop and the telemetry (and so the tier
    sweep) cadence too slow to tick during a test: the tests drive them."""
    return dict(checkpoint_path=str(path), checkpoint_interval_ms=600_000.0,
                telemetry_interval_ms=600_000.0, **kw)


async def _wave(d, keys, hits):
    out = await d.get_rate_limits([_item(k, hits, limit=1000) for k in keys])
    assert all(r.error == "" for r in out)


@async_test
async def test_checkpoints_restore_across_packages(frozen, tmp_path):
    """A JAX daemon writes a base and two delta frames, then dies (abort:
    no final compaction). A port daemon and a JAX daemon restore them into
    byte-equal tables holding the writer's live rows. The port daemon then
    appends its own frames and dies; a JAX daemon and a port daemon restore
    base + JAX frames + port frames, again byte-equal, holding the port
    writer's rows."""
    path = tmp_path / "base.npz"
    keys = [f"c{i}" for i in range(300)]
    jw = await JDaemon.spawn(daemon_config(**_ckpt(path)))
    await _wave(jw, keys[:150], 3)
    await jw.checkpointer.compact()
    await _wave(jw, keys[100:250], 2)
    assert (await jw.checkpointer.checkpoint_once())["rows"] > 0
    await _wave(jw, keys[200:], 1)
    assert (await jw.checkpointer.checkpoint_once())["rows"] > 0
    want = _live(jw.engine.snapshot())
    await jw.abort()

    for writer in ("jax", "port"):
        jr = await JDaemon.spawn(daemon_config(**_ckpt(path)))
        tr = await TDaemon.spawn(port_config(**_ckpt(path)), device="cpu")
        try:
            assert jr.checkpointer.restored == tr.checkpointer.restored == "base+delta"
            assert jr.checkpointer.replayed_rows == tr.checkpointer.replayed_rows
            jt, tt = jr.engine.snapshot(), tr.engine.snapshot()
            assert jt.tobytes() == tt.tobytes(), writer
            assert _live(tt) == want, writer
        finally:
            await jr.abort()
        if writer == "port":
            await tr.abort()
            break
        # the port daemon writes next: more traffic, two frames, kill -9
        await _wave(tr, keys[:50], 4)
        assert (await tr.checkpointer.checkpoint_once())["rows"] > 0
        await _wave(tr, keys[250:] + ["n0", "n1"], 1)
        assert (await tr.checkpointer.checkpoint_once())["rows"] > 0
        want = _live(tr.engine.snapshot())
        await tr.abort()


def _cols(fps, hits=1, limit=1 << 20):
    from gubernator_tpu_torch.ops.batch import RequestColumns

    n = fps.shape[0]
    return RequestColumns(
        fp=fps, algo=np.zeros(n, np.int32), behavior=np.zeros(n, np.int32),
        hits=np.full(n, hits, np.int64), limit=np.full(n, limit, np.int64),
        burst=np.zeros(n, np.int64), duration=np.full(n, HOUR, np.int64),
        created_at=np.full(n, NOW, np.int64), err=np.zeros(n, np.int8))


def _frame(eng, now):
    """Take the engine's dirty epoch: (epoch, the live rows of its blocks)."""
    epoch, gids = eng.ckpt.take()
    return epoch, finish_extract(extract_begin(eng.table.rows, gids, eng.ckpt.blk, now))[1]


def test_replay_reconstructs_live_rows(tmp_path):
    """Base + delta frames replayed through the conservative merge rebuild
    the source table's live rows byte for byte (test_durability.py's
    replay case on the port)."""
    log = DeltaLog(str(tmp_path / "x.delta"))
    src = TEngine(capacity=1 << 14, device="cpu", write_mode="xla")
    src.ckpt = EpochTracker(src.table.n_buckets)
    rng = np.random.default_rng(7)
    fps = np.unique(rng.integers(1, (1 << 63) - 1, size=6000, dtype=np.int64))[:3000]
    src.check_columns(_cols(fps[:2000], hits=3), now_ms=NOW)
    base = str(tmp_path / "base.npz")
    save_snapshot(base, src.snapshot(), epoch=src.ckpt.take()[0])
    for i in range(3):
        src.check_columns(_cols(fps[2000 + 300 * i:2300 + 300 * i], hits=2), now_ms=NOW + 1 + i)
        src.check_columns(_cols(fps[:200], hits=1), now_ms=NOW + 1 + i)
        epoch, slots = _frame(src, NOW + 1 + i)
        log.append(epoch, NOW + 1 + i, slots)
    dst = TEngine(capacity=1 << 14, device="cpu", write_mode="xla")
    rows, base_epoch, _layout = load_snapshot_meta(base)
    dst.restore(rows)
    for epoch, now_ms, slots, _lay in log.scan().frames:
        assert epoch > base_epoch
        dst.merge_rows(fps_from_slots(slots), slots, now_ms=now_ms)
    assert _live(dst.snapshot(), NOW + 4) == _live(src.snapshot(), NOW + 4)


def test_replay_never_over_grants():
    """A stale frame replayed over newer state re-grants nothing, and an
    OVER_LIMIT frame pins OVER on an UNDER table."""
    fp = np.asarray([12345], np.int64)
    eng = TEngine(capacity=1 << 10, device="cpu", write_mode="xla")
    eng.ckpt = EpochTracker(eng.table.n_buckets)
    eng.check_columns(_cols(fp, hits=3, limit=10), now_ms=NOW)
    _, stale = _frame(eng, NOW)
    eng.check_columns(_cols(fp, hits=4, limit=10), now_ms=NOW + 10)
    eng.merge_rows(fps_from_slots(stale), stale, now_ms=NOW + 20)
    assert int(eng.check_columns(_cols(fp, hits=0, limit=10), now_ms=NOW + 30).remaining[0]) == 3
    eng2 = TEngine(capacity=1 << 10, device="cpu", write_mode="xla")
    eng2.ckpt = EpochTracker(eng2.table.n_buckets)
    eng2.check_columns(_cols(fp, hits=10, limit=10), now_ms=NOW)
    eng2.check_columns(_cols(fp, hits=1, limit=10), now_ms=NOW)
    _, over = _frame(eng2, NOW)
    eng3 = TEngine(capacity=1 << 10, device="cpu", write_mode="xla")
    eng3.check_columns(_cols(fp, hits=1, limit=10), now_ms=NOW)
    eng3.merge_rows(fps_from_slots(over), over, now_ms=NOW + 1)
    assert int(eng3.check_columns(_cols(fp, hits=0, limit=10), now_ms=NOW + 2).status[0]) == 1


@async_test
async def test_restore_repairs_torn_delta_log(frozen, tmp_path):
    """A torn tail is cut back to the clean prefix before serving, so the
    frames a restarted daemon appends stay reachable by the next restore."""
    conf = lambda: port_config(**_ckpt(tmp_path / "base.npz"))  # noqa: E731
    d = await TDaemon.spawn(conf(), device="cpu")
    await _wave(d, ["a", "b"], 2)
    await d.checkpointer.checkpoint_once()
    delta = d.checkpointer.delta_path
    await d.abort()
    with open(delta, "ab") as f:
        f.write(b"\x00torn-frame-bytes")
    d = await TDaemon.spawn(conf(), device="cpu")
    assert d.checkpointer.restored == "delta"
    assert DeltaLog(delta).scan().error is None  # repaired before serving
    await _wave(d, ["c"], 5)
    await d.checkpointer.checkpoint_once()
    await d.abort()
    d = await TDaemon.spawn(conf(), device="cpu")
    try:
        out = await d.get_rate_limits([_item(k, 0, limit=1000) for k in ("a", "b", "c")])
        assert [r.remaining for r in out] == [998, 998, 995]
    finally:
        await d.close()


@pytest.mark.parametrize("interval", [0.0, 600_000.0], ids=["loader", "incremental"])
@async_test
async def test_geometry_mismatch_cold_starts(tmp_path, interval):
    """A base whose geometry no longer fits the table cold-starts (logged,
    counted) on both restore paths instead of failing the boot."""
    path = str(tmp_path / "base.npz")
    save_snapshot(path, np.ones((64, 128), np.int32), epoch=1)
    d = await TDaemon.spawn(port_config(checkpoint_path=path, checkpoint_interval_ms=interval),
                            device="cpu")
    try:
        assert await d.runner.live_count() == 0
        out = await d.get_rate_limits([_item("g", 1, limit=5, duration=60_000)])
        assert out[0].remaining == 4
        assert d.metrics.checkpoint_errors.labels(stage="restore")._value.get() >= 1
    finally:
        await d.abort()


@async_test
async def test_kill9_recovery_bound(frozen, tmp_path):
    """A port daemon aborted mid-traffic recovers the checkpointed count and
    over-admits at most the writes after the last epoch; the graceful close
    of the second life compacts everything into the base."""
    conf = lambda: port_config(**_ckpt(tmp_path / "base.npz"))  # noqa: E731
    d = await TDaemon.spawn(conf(), device="cpu")

    async def hit(n):
        r = (await d.get_rate_limits([_item("k", n, limit=1000, name="chaos")]))[0]
        assert not r.error
        return r

    for _ in range(12):
        await hit(50)
    await d.checkpointer.checkpoint_once()
    for _ in range(2):
        await hit(50)
    assert (await hit(0)).remaining == 300
    await d.abort()
    d = await TDaemon.spawn(conf(), device="cpu")
    try:
        assert (await hit(0)).remaining == 400  # the 600 checkpointed survive
        admitted = 700
        while (await hit(50)).status != pb.OVER_LIMIT:
            admitted += 50
        assert admitted <= 1000 + 100
        st = d.debug_durability()
        assert st["enabled"] and st["restored"] == "delta" and st["last_error"] is None
    finally:
        await d.close()
    _rows, epoch, _layout = load_snapshot_meta(str(tmp_path / "base.npz"))
    assert epoch >= 1 and DeltaLog(str(tmp_path / "base.npz") + ".delta").frame_count() == 0


# ------------------------------------------------------------- tiering


def _shadow(d):
    sh = d.tier.shadow
    rows = [r.tobytes() for r in sh._rows.values()]
    stats = sh.stats()
    stats["spill"].pop("path")  # each daemon spills into its own file
    return list(sh._rows.keys()), rows, stats


@async_test
async def test_tier_sweep_matches_jax(clock, tmp_path):
    """The same traffic, idle sweep and fault-back on a JAX and a port
    daemon with tiering, a spill file and checkpoints: equal sweep summaries,
    shadow rows, tombstone frames (delta-log bytes), table bytes and
    responses."""
    ds = []
    for pkg, spawn, conf in (("j", JDaemon.spawn, daemon_config), ("t", TDaemon.spawn, port_config)):
        root = tmp_path / pkg
        root.mkdir()
        c = conf(tier_enabled=True, tier_idle_ms=60_000.0, tier_spill_path=str(root / "spill"),
                 **_ckpt(root / "base.npz"))
        ds.append(await (spawn(c, device="cpu") if pkg == "t" else spawn(c)))
    try:
        idle = [f"i{i}" for i in range(120)]
        hot = [f"h{i}" for i in range(40)]
        outs = [[], []]
        for k, d in enumerate(ds):
            clock[0] = NOW
            outs[k].append(await d.get_rate_limits([_item(x, 2, limit=50) for x in idle]))
            await d.checkpointer.checkpoint_once()
            clock[0] = NOW + 90_000
            outs[k].append(await d.get_rate_limits([_item(x, 1, limit=50) for x in hot]))
            outs[k].append(await d.tier.sweep_once())
        assert outs[0][2] == outs[1][2] and outs[1][2]["demoted"] == len(idle)
        assert _shadow(ds[0]) == _shadow(ds[1])
        assert ds[0].engine.snapshot().tobytes() == ds[1].engine.snapshot().tobytes()
        logs = [open(d.checkpointer.delta_path, "rb").read() for d in ds]
        assert logs[0] == logs[1]
        for k, d in enumerate(ds):
            clock[0] = NOW + 95_000
            outs[k].append(await d.get_rate_limits([_item(x, 1, limit=50) for x in idle[:60]]))
            outs[k].append(d.debug_tier()["shadow"]["promoted"])
        for a, b in zip(outs[0], outs[1]):
            if isinstance(a, list):
                assert [r.SerializeToString() for r in a] == [r.SerializeToString() for r in b]
            else:
                assert a == b
        assert [r.remaining for r in outs[1][3]] == [47] * 60  # state faulted back
        assert ds[0].engine.snapshot().tobytes() == ds[1].engine.snapshot().tobytes()
        assert (await ds[1].debug_table())["tiering"]["shadow_rows"] == len(idle) - 60
    finally:
        for d in ds:
            await d.close()


# -------------------------------------------------------- request ring


class StubRunner:
    """The runner surface the ring drives, as tests/test_request_ring.py
    stubs it: check_wire echoes the payload and records launch order."""

    def __init__(self, delay=0.0, fail_on=None, fuse=True):
        self.delay, self.fail_on, self.fuse = delay, fail_on, fuse
        self.launch_order, self.active, self.max_active, self.check_calls = [], 0, 0, 0

    def _observe_stage(self, stage, t0, span=None):
        pass

    async def check_wire(self, parts, now_ms=None, span=None, launch_path="xla"):
        assert launch_path == "ring"
        if not self.fuse:
            return None
        self.active += 1
        self.max_active = max(self.max_active, self.active)
        self.launch_order.append(parts[0])
        try:
            if self.delay:
                await asyncio.sleep(self.delay)
            if self.fail_on is not None and parts[0] == self.fail_on:
                raise RuntimeError(f"boom on {parts[0]}")
            return ("rc", parts[0])
        finally:
            self.active -= 1

    async def check(self, cols, now_ms=None, span=None, launch_path="xla"):
        self.check_calls += 1
        return ("cols-rc", cols)


def _both(case):
    """Run `case(ring module)` on the JAX ring and on the port's; return
    both results after asserting they are equal."""
    got = [asyncio.run(case(mod)) for mod in (jring, tring)]
    assert got[1] == got[0]
    return got[1]


def _state(ring, runner):
    d = ring.debug()
    d.pop("issue_mode")
    return d, runner.launch_order, runner.max_active, ring.seq_in.tolist(), ring.seq_out.tolist()


def test_ring_orders_launches_and_fences():
    async def case(mod):
        r = StubRunner(delay=0.001)
        ring = mod.RequestRing(r, slots=4)
        outs = await asyncio.gather(*(ring.submit([i]) for i in range(11)))
        return outs, _state(ring, r)

    outs, (dbg, order, _m, seq_in, seq_out) = _both(case)
    assert order == list(range(11)) and [o[1] for o in outs] == list(range(11))
    assert seq_in == seq_out == [9, 10, 11, 8]  # slot s: last ticket ≡ s (mod 4), + 1
    assert dbg["published"] == dbg["consumed"] == dbg["launches"] == 11


def test_ring_backpressure_drops_nothing():
    async def case(mod):
        r = StubRunner(delay=0.002)
        ring = mod.RequestRing(r, slots=3)
        outs = await asyncio.gather(*(ring.submit([i]) for i in range(32)))
        return [o[1] for o in outs], r.max_active, ring.max_occupancy, ring.backpressure_waits > 0

    outs, max_active, max_occ, waited = _both(case)
    assert outs == list(range(32)) and max_active <= 3 and max_occ <= 3 and waited


def test_ring_drain_is_zero_loss():
    async def case(mod):
        r = StubRunner(delay=0.005)
        ring = mod.RequestRing(r, slots=4)
        pending = [asyncio.create_task(ring.submit([i])) for i in range(8)]
        await asyncio.sleep(0.006)
        await ring.drain()
        outs = await asyncio.gather(*pending, return_exceptions=True)
        try:
            await ring.submit(["late"])
            late = None
        except mod.RingClosed:
            late = "closed"
        ok = [o[1] for o in outs if not isinstance(o, Exception)]
        closed = sum(isinstance(o, mod.RingClosed) for o in outs)
        return len(ok) + closed, len(ok) == ring.debug()["launches"], ok == sorted(ok), late

    assert _both(case) == (8, True, True, "closed")


def test_ring_nonfusable_chunk_rides_columns_path(monkeypatch):
    class P:
        cols = "c0"

    async def case(mod):
        monkeypatch.setattr(mod, "concat_columns", lambda cols: cols[0])
        r = StubRunner(fuse=False)
        ring = mod.RequestRing(r, slots=2)
        out = await ring.submit([P()])
        return out, r.check_calls, ring.fallbacks

    assert _both(case) == (("cols-rc", "c0"), 1, 1)


def test_ring_dispatch_error_reaches_its_submitter_only():
    async def case(mod):
        r = StubRunner(delay=0.001, fail_on=2)
        ring = mod.RequestRing(r, slots=4)
        outs = await asyncio.gather(*(ring.submit([i]) for i in range(6)), return_exceptions=True)
        return [type(o).__name__ if isinstance(o, Exception) else o[1] for o in outs], \
            ring.debug()["consumed"]

    assert _both(case) == ([0, 1, "RuntimeError", 3, 4, 5], 6)


class FlakyDrainRunner(StubRunner):
    """A fused-tier runner surface whose first drain fails: the persistent
    tier re-launches it once, the fused tier fails the group."""

    _prep = None  # the loop's default executor prepares the slots

    def __init__(self):
        super().__init__()
        self.drains = 0

    async def drain_ring_issue(self, dring, group, start, span=None):
        self.drains += 1
        if self.drains == 1:
            raise RuntimeError("preempted")
        return [g.v for g in group], len(group)

    async def drain_ring_finish(self, group, bank, n, span=None):
        return [("drained", v) for v in bank]


@pytest.mark.parametrize("mode", ["fused", "persistent"])
def test_ring_fused_tiers_watchdog(monkeypatch, mode):
    """The fused and persistent tiers over one failing drain: persistent
    re-launches it (watchdog_relaunches 1) and answers, fused fails that
    group's submitters; neither falls back to the host loop."""
    from types import SimpleNamespace as NS

    async def case(mod):
        r = FlakyDrainRunner()
        ring = mod.RequestRing(r, slots=4, issue_mode=mode, slot_width=64)
        # every slot fusable, one math mode, no fault-back: one group
        monkeypatch.setattr(ring, "_prepare_slot", lambda parts, span: NS(
            v=parts[0], math="int", cascade=False, pending=NS(promote=None)))
        monkeypatch.setattr(ring, "_ensure_dring", lambda: None)
        outs = await asyncio.gather(*(ring.submit([i]) for i in range(3)),
                                    return_exceptions=True)
        d = ring.debug()
        return ([type(o).__name__ if isinstance(o, Exception) else o for o in outs],
                d["watchdog_relaunches"], d["host_slots"], d["drain_launches"])

    outs, relaunches, host_slots, _launches = _both(case)
    assert host_slots == 0
    if mode == "persistent":
        assert relaunches == 1 and "RuntimeError" not in outs
    else:
        assert relaunches == 0 and outs[0] == "RuntimeError"


@pytest.mark.parametrize("issue", ["host", "fused"])
@async_test
async def test_ring_daemon_matches_jax_over_grpc(frozen, issue):
    """A ring-armed port daemon (compact wire, so all-wire flushes ride the
    ring) answers a seeded request sequence over gRPC byte for byte as a
    ring-armed JAX daemon does; its ring retires every ticket and drains
    at close."""
    from gubernator_tpu.ops.engine import LocalEngine as JEngine
    from tests.test_torch_service import _sequence

    calls = _sequence(np.random.default_rng(31), 14)
    jc, tc = daemon_config(), port_config()
    for c in (jc, tc):
        c.behaviors.ring_enable = True
        c.behaviors.ring_issue = issue
        c.behaviors.ring_slot_width = 64
    jd = await JDaemon.spawn(jc, engine=JEngine(capacity=8192, wire="compact"))
    td = await TDaemon.spawn(tc, engine=TEngine(capacity=8192, device="cpu", wire="compact"))
    try:
        for items in calls:
            g = [await _grpc_raw(d.grpc_port, items) for d in (jd, td)]
            assert g[1] == g[0], items[:3]
        jr, tr = jd.ring.debug(), td.ring.debug()
        for k in ("published", "consumed", "fallbacks", "host_slots", "drained_slots"):
            assert tr[k] == jr[k], k
        assert tr["published"] > 0 and td.batcher.debug()["ring_dispatches"] == tr["published"]
        if issue == "fused":
            assert tr["drain_launches"] > 0
    finally:
        await jd.close()
        await td.close()
    assert td.ring.debug()["closed"] and td.ring.debug()["occupancy"] == 0

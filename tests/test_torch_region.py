"""The port's multi-region plane against the JAX package's.

- ``reconcile_region_rows`` against the JAX function: on random stored and
  sender rows for every algorithm, and on the inputs of
  tests/test_region_sync.py's cases (exact union, duplicate delivery, GCRA,
  the over-limit clamp, bootstrap from the sender row, cross-layout
  senders), whose outcomes the port engines reproduce.
- The receive ledger's dedup rules and the SyncRegionsWire codec: the
  port's bytes are the JAX codec's, and each decodes the other's.
- A mixed pair — a JAX daemon in dc1, a port daemon in dc2 — converges to
  the exact union of MULTI_REGION hits over the compact codec, and
  non-encodable items ride the proto fallback; a port receiver skips a
  re-shipped batch exactly.
"""

import asyncio

import numpy as np
import pytest
from aiohttp import ClientSession

from gubernator_tpu.hashing import fingerprint as jfingerprint
from gubernator_tpu.ops import reconcile as jrec
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.service import wire as jwire
from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu.types import Behavior
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch.ops import reconcile as trec
from gubernator_tpu_torch.ops.batch import RequestColumns
from gubernator_tpu_torch.ops.engine import LocalEngine as TEngine
from gubernator_tpu_torch.ops.engine import ms_now
from gubernator_tpu_torch.ops.layout import GCRA32, TOKEN32
from gubernator_tpu_torch.service import wire as twire
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.types import PeerInfo as TPeer

from tests.cluster import daemon_config, wait_for
from tests.test_torch_service import async_test
from tests.torch_cluster import port_config

NOW = ms_now()
MINUTE = 60_000
MR = int(Behavior.MULTI_REGION)


def _cols(fps, hits, limit=100, dur=MINUTE, algo=0):
    n = len(fps)
    return RequestColumns(
        fp=np.asarray(fps, np.int64), algo=np.full(n, algo, np.int32),
        behavior=np.zeros(n, np.int32), hits=np.full(n, hits, np.int64),
        limit=np.full(n, limit, np.int64), burst=np.zeros(n, np.int64),
        duration=np.full(n, dur, np.int64), created_at=np.full(n, NOW, np.int64),
        err=np.zeros(n, np.int8))


def _cfg(algo=0, n=1, limit=100):
    return {"limit": np.full(n, limit, np.int64), "duration": np.full(n, MINUTE, np.int64),
            "algo": np.full(n, algo, np.int64), "created_at": np.full(n, NOW, np.int64)}


def _ship(src, dst, fp, delta, algo=0, now=NOW, with_sender=True):
    """One region hop on port engines: the receiver's reconcile rows are
    held to the JAX function's on the same inputs, then merged."""
    fps = np.array([fp], np.int64)
    deltas = np.array([delta], np.int64)
    sender = lay = None
    if with_sender:
        _found, sender = src.read_state(fps, raw=True)
        lay = src.table.layout
    found, local = dst.read_state(fps)
    full = dst._slots_to_full(sender, lay) if sender is not None else None
    args = (fps, deltas, _cfg(algo), local, found, full, now)
    want = jrec.reconcile_region_rows(*args)
    assert trec.reconcile_region_rows(*args).tobytes() == want.tobytes()
    return trec.apply_region_sync(dst, fps, deltas, _cfg(algo), sender, lay, now_ms=now)


def _eng(**kw):
    return TEngine(capacity=4096, device="cpu", **kw)


def _rem(eng, fp, algo=0, now=NOW + 2):
    return int(eng.check_columns(_cols([fp], 0, algo=algo), now_ms=now).remaining[0])


def _case_exact_union():
    A, B = _eng(), _eng()
    assert int(A.check_columns(_cols([42], 3), now_ms=NOW).remaining[0]) == 97
    assert int(B.check_columns(_cols([42], 4), now_ms=NOW).remaining[0]) == 96
    assert _ship(A, B, 42, 3, now=NOW + 1) == 1 and _ship(B, A, 42, 4, now=NOW + 1) == 1
    assert _rem(A, 42) == _rem(B, 42) == 93


def _case_duplicate_under_grants():
    A, B = _eng(), _eng()
    A.check_columns(_cols([7], 5), now_ms=NOW)
    B.check_columns(_cols([7], 2), now_ms=NOW)
    _ship(A, B, 7, 5, now=NOW + 1)
    exact = _rem(B, 7)
    _ship(A, B, 7, 5, now=NOW + 3)
    assert exact == 93 and _rem(B, 7, now=NOW + 4) <= exact


def _case_gcra_union():
    A, B, O = _eng(), _eng(), _eng()
    for e, h in ((A, 10), (B, 5), (O, 15)):
        e.check_columns(_cols([9], h, algo=2), now_ms=NOW)
    _ship(A, B, 9, 10, algo=2, now=NOW + 1)
    assert _rem(B, 9, algo=2) == _rem(O, 9, algo=2)


def _case_over_limit_sticks():
    B = _eng()
    B.check_columns(_cols([11], 1), now_ms=NOW)
    _ship(None, B, 11, 500, now=NOW + 1, with_sender=False)
    rc = B.check_columns(_cols([11], 0), now_ms=NOW + 2)
    assert int(rc.remaining[0]) == 0 and int(rc.status[0]) == 1


def _case_absent_bootstraps():
    A, C = _eng(), _eng()
    A.check_columns(_cols([13], 9), now_ms=NOW)
    _ship(A, C, 13, 9, now=NOW + 1)
    assert _rem(C, 13) == 91


def _case_cross_layout(lay, algo):
    P, Q, O = _eng(layout=lay), _eng(), _eng()
    for e, h in ((P, 9), (Q, 4), (O, 13)):
        e.check_columns(_cols([77], h, algo=algo), now_ms=NOW)
    assert P.table.layout.F == 8
    _ship(P, Q, 77, 9, algo=algo, now=NOW + 1)
    ro = _rem(O, 77, algo=algo)
    assert _rem(Q, 77, algo=algo) == ro
    _ship(Q, P, 77, 4, algo=algo, now=NOW + 3)
    assert _rem(P, 77, algo=algo, now=NOW + 4) == ro


@pytest.mark.parametrize("case", [
    _case_exact_union, _case_duplicate_under_grants, _case_gcra_union,
    _case_over_limit_sticks, _case_absent_bootstraps,
    lambda: _case_cross_layout(TOKEN32.name, 0), lambda: _case_cross_layout(GCRA32.name, 2),
], ids=["exact-union", "duplicate", "gcra", "over-limit", "bootstrap", "token32", "gcra32"])
def test_region_sync_cases_hold_on_the_port(case):
    case()


@pytest.mark.parametrize("algo", range(5))
def test_reconcile_region_rows_matches_jax_on_random_rows(algo):
    """Random stored and sender rows (live, expired, absent, another
    algorithm) for one algorithm: the port's rows equal the JAX function's."""
    from gubernator_tpu_torch.ops import table2 as t2

    rng = np.random.default_rng(100 + algo)
    n = 512
    fps = rng.integers(1, 1 << 62, n, dtype=np.int64)

    def rows():
        r = rng.integers(-(1 << 31), 1 << 31, (n, 16), dtype=np.int64).astype(np.int32)
        exp = NOW + rng.integers(-MINUTE, 2 * MINUTE, n)
        r[:, t2.EXP_LO] = (exp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        r[:, t2.EXP_HI] = (exp >> 32).astype(np.int32)
        a = np.where(rng.random(n) < 0.8, algo, (algo + 1) % 5)
        r[:, t2.FLAGS] = (a | (rng.integers(0, 2, n) << 8)).astype(np.int32)
        r[:, t2.LIMIT] = rng.integers(1, 1000, n)
        r[:, t2.BURST] = rng.integers(0, 1000, n)
        r[:, t2.REM_I] = rng.integers(0, 1000, n)
        dur = rng.integers(1, 10 * MINUTE, n)
        r[:, t2.DUR_LO] = dur
        r[:, t2.DUR_HI] = 0
        # finite float pairs in the remainder lanes (GCRA and the window
        # read the same lanes as one int64)
        r[:, t2.REMF_HI] = (rng.random(n) * 1000).astype(np.float32).view(np.int32)
        r[:, t2.REMF_LO] = (rng.random(n) * 1e-4).astype(np.float32).view(np.int32)
        r[:, t2.FP_LO] = (fps & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        r[:, t2.FP_HI] = (fps >> 32).astype(np.int32)
        return r

    local, sender = rows(), rows()
    sender[rng.random(n) < 0.3] = 0  # keys the sender no longer holds
    cfg = {"limit": rng.integers(1, 1000, n), "duration": rng.integers(1, 10 * MINUTE, n),
           "algo": np.full(n, algo, np.int64), "created_at": NOW - rng.integers(0, 500, n)}
    args = (fps, rng.integers(0, 300, n), cfg, local, rng.random(n) < 0.7, sender, NOW)
    assert trec.reconcile_region_rows(*args).tobytes() == \
        jrec.reconcile_region_rows(*args).tobytes()
    assert trec.reconcile_region_rows(*args[:5], None, NOW).tobytes() == \
        jrec.reconcile_region_rows(*args[:5], None, NOW).tobytes()


def test_dedup_ledger_rules_match_jax():
    """The receive ledger's skip, partial-overlap, dropped-batch, sender-reset
    and pre-dedup rules, step by step on both packages' ledgers."""
    fps = np.array([1, 2, 3, 4], np.int64)
    steps = [
        (fps, [5, 3, 7, 2], [5, 3, 7, 2], True), (fps, [5, 3, 7, 2], [5, 3, 7, 2], False),
        (fps[:1], [9], [9], False), (fps[:1], [2], [50], False),
        (fps[:1], [3], [3], True), (fps, [5, 3, 7, 2], None, False),
    ]
    ledgers = [{}, {}]
    for f, d, c, commit in steps:
        d = np.array(d, np.int64)
        c = None if c is None else np.array(c, np.int64)
        got = [m.dedup_source_deltas(led, f, d, c).tolist() for m, led in zip((jrec, trec), ledgers)]
        assert got[1] == got[0]
        if commit:
            for m, led in zip((jrec, trec), ledgers):
                m.commit_source_cums(led, f, c)
    assert ledgers[1] == ledgers[0] == {1: 3, 2: 3, 3: 7, 4: 2}


def _codec_pairs():
    base = dict(limit=100, duration=MINUTE, created_at=NOW)
    items = [
        ("k1", dict(hits=5, behavior=MR)),
        ("k2", dict(hits=1, behavior=MR | int(Behavior.RESET_REMAINING))),
        ("k3", dict(hits=1, behavior=MR | int(Behavior.DURATION_IS_GREGORIAN), duration=1)),
        ("k4", dict(hits=-2, behavior=MR, algorithm=4)),
        ("k5", dict(hits=1, behavior=MR, created_at=NOW + 10_000)),
        ("k6", dict(hits=3, behavior=MR | int(Behavior.DRAIN_OVER_LIMIT) | 64, algorithm=2)),
        ("k7", dict(hits=7, behavior=MR, algorithm=1, burst=100)),
    ]
    return [("mr_" + k, pb.RateLimitReq(name="mr", unique_key=k, **{**base, **kw}))
            for k, kw in items]


def test_region_codec_matches_jax_both_ways():
    """The encodability split, the SyncRegionsWireReq bytes (detail rows,
    sender slots in a packed layout, cumulative counters) and the decode
    are the JAX codec's; each package decodes the other's request."""
    from gubernator_tpu_torch.proto import regionsync_pb2 as tregion_pb

    pairs = _codec_pairs()
    enc, fb = twire.split_region_encodable(pairs)
    jenc, jfb = jwire.split_region_encodable(pairs)
    assert [k for k, _ in enc] == [k for k, _ in jenc] == ["mr_k1", "mr_k6", "mr_k7"]
    assert [k for k, _ in fb] == [k for k, _ in jfb]
    n = len(enc)
    slots = np.arange(n * TOKEN32.F, dtype=np.int32).reshape(n, TOKEN32.F)
    detail = np.array([True, False, True])
    cums = np.array([5, 9, 7], np.int64)
    from gubernator_tpu.ops.layout import TOKEN32 as JTOKEN32

    treq = twire.sync_regions_pb(enc, "a:1", "dc1", slots, TOKEN32, detail_rows=detail, cums=cums)
    jreq = jwire.sync_regions_pb(enc, "a:1", "dc1", slots, JTOKEN32, detail_rows=detail, cums=cums)
    assert treq.SerializeToString() == jreq.SerializeToString()
    plain = twire.sync_regions_pb(enc, "a:1", "dc1")
    assert plain.SerializeToString() == jwire.sync_regions_pb(enc, "a:1", "dc1").SerializeToString()
    for req in (treq, plain):
        t = twire.sync_regions_arrays(tregion_pb.SyncRegionsWireReq.FromString(req.SerializeToString()))
        j = jwire.sync_regions_arrays(req)
        assert t[0].tolist() == j[0].tolist() == [jfingerprint("mr", k) for k in ("k1", "k6", "k7")]
        assert t[1].tolist() == j[1].tolist() == [5, 3, 7]
        assert {k: np.asarray(v).tolist() for k, v in t[2].items()} == \
            {k: np.asarray(v).tolist() for k, v in j[2].items()}
        assert t[3] == j[3]
        assert (t[4] is None) == (j[4] is None) and (t[4] is None or t[4].tolist() == j[4].tolist())
        assert t[5].name == j[5].name
        assert (t[6] is None) == (j[6] is None) and (t[6] is None or t[6].tolist() == j[6].tolist())
    assert t[3] == ["mr_k1", "mr_k6", "mr_k7"]
    bad = tregion_pb.SyncRegionsWireReq.FromString(treq.SerializeToString())
    bad.hits = bad.hits[:-8]
    with pytest.raises(ValueError):
        twire.sync_regions_arrays(bad)


def _mr(key, hits, limit=100, behavior=MR):
    return pb.RateLimitReq(name="mr", unique_key=key, hits=hits, limit=limit,
                           duration=MINUTE, behavior=behavior)


async def _pair():
    """A JAX daemon in dc1 and a port daemon in dc2, each the other's only
    peer in the other region."""
    jd = await JDaemon.spawn(daemon_config(dc="dc1"))
    td = await TDaemon.spawn(port_config(data_center="dc2"), device="cpu")
    infos = [(d.conf.advertise_address, d.conf.data_center) for d in (jd, td)]
    jd.set_peers([JPeer(grpc_address=a, data_center=c) for a, c in infos])
    td.set_peers([TPeer(grpc_address=a, data_center=c) for a, c in infos])
    return jd, td


async def _remaining(d, key, limit=100):
    return (await d.get_rate_limits([_mr(key, 0, limit)]))[0].remaining


@async_test
async def test_mixed_region_pair_converges_to_the_exact_union():
    """Concurrent MULTI_REGION hits on shared keys in both regions converge
    to the exact union over the compact codec, with no fallback and no
    ping-pong; the port's debug plane and health name its region."""
    jd, td = await _pair()
    try:
        rng = np.random.default_rng(5)
        keys = [f"u{i}" for i in range(16)]
        total = {k: 0 for k in keys}
        for _ in range(3):
            for k in keys:
                for d in (jd, td):
                    h = int(rng.integers(1, 4))
                    total[k] += h
                    out = await d.get_rate_limits([_mr(k, h, limit=1000)])
                    assert out[0].error == ""

        async def converged():
            for k in keys:
                got = [await _remaining(d, k, 1000) for d in (jd, td)]
                if got != [1000 - total[k]] * 2:
                    return False
            return True

        await wait_for(converged, timeout_s=15)
        await asyncio.sleep(0.2)  # a few more sync rounds: nothing re-ships
        assert await converged()
        rm = td.region_manager
        assert rm.wire_sent >= len(keys) and rm.wire_fallback == 0
        assert rm.rows_merged >= len(keys) and jd.region_manager.wire_sent >= len(keys)
        assert rm.oldest_delta_age_s() == 0.0
        async with ClientSession() as s:
            async with s.get(f"http://{td.conf.http_address}/v1/debug/regions") as r:
                assert r.status == 200
                js = await r.json()
        assert js["region"] == "dc2" and "dc1" in js["regions"]
        assert (await td.health_check()).region == "dc2"
    finally:
        await asyncio.gather(jd.close(), td.close())


@async_test
async def test_non_encodable_items_ride_the_proto_fallback():
    """A RESET_REMAINING hit from the port daemon cannot travel through the
    min-merge: it rides the GetPeerRateLimits fallback and still lands on
    the JAX daemon."""
    jd, td = await _pair()
    try:
        await td.get_rate_limits([_mr("kr", 30)])

        async def replicated():
            return await _remaining(jd, "kr") == 70

        await wait_for(replicated, timeout_s=15)
        out = await td.get_rate_limits([_mr("kr", 1, behavior=MR | int(Behavior.RESET_REMAINING))])
        assert out[0].error == ""
        want = await _remaining(td, "kr")
        assert want > 70

        async def reset_landed():
            return await _remaining(jd, "kr") == want

        await wait_for(reset_landed, timeout_s=15)
        assert td.region_manager.wire_fallback >= 1
    finally:
        await asyncio.gather(jd.close(), td.close())


@async_test
async def test_duplicate_delivery_skipped_exactly():
    """A re-shipped batch (lost ack) is skipped exactly by the port
    receiver's per-source ledger; a batch folded with fresh hits applies
    only those; a pre-dedup sender falls back to under-grant only."""
    d = await TDaemon.spawn(port_config(data_center="dc-b"), device="cpu")
    try:
        async def remaining():
            return await _remaining(d, "k")

        def batch(hits, cum=None):
            it = pb.RateLimitReq(name="mr", unique_key="k", hits=hits, limit=100,
                                 duration=MINUTE, behavior=MR, created_at=d.now_ms())
            enc, fb = jwire.split_region_encodable([("mr_k", it)])
            assert enc and not fb
            return jwire.sync_regions_pb(enc, "sender:1" if cum else "old:1", "dc-a",
                                         cums=None if cum is None else np.array([cum], np.int64))

        req = batch(5, 5)
        for _ in range(3):
            await d.sync_regions_wire(req)
            assert await remaining() == 95
        assert d.region_manager.debug()["wire"]["dedup_skipped_hits"] == 10
        await d.sync_regions_wire(batch(8, 8))
        assert await remaining() == 92
        legacy = batch(2)
        await d.sync_regions_wire(legacy)
        assert await remaining() == 90
        await d.sync_regions_wire(legacy)
        assert await remaining() <= 90
    finally:
        await d.close()

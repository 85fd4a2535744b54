"""The service layer's parts, no daemon: the port (gubernator_tpu_torch) held
to the JAX package on the config parser, the wire schema, the peer ring and
pickers, the breaker and deadlines, the pb/column converters and codecs,
and the native ingress parser and response encoder. Inputs are made from
numpy seeds; every comparison is exact (bytes, arrays, error texts)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from gubernator_tpu import config as jconfig
from gubernator_tpu import native as jnative
from gubernator_tpu.ops.batch import ResponseColumns as JResp
from gubernator_tpu.peers import hash_ring as jring
from gubernator_tpu.peers.ownership import OwnershipIndex as JOwn
from gubernator_tpu.peers.picker import RegionPicker as JPicker
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.service import breaker as jbreaker
from gubernator_tpu.service import deadline as jdeadline
from gubernator_tpu.service import wire as jwire
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch import config as tconfig
from gubernator_tpu_torch import hashing as thashing
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.batch import ResponseColumns as TResp
from gubernator_tpu_torch.peers import hash_ring as tring
from gubernator_tpu_torch.peers.ownership import OwnershipIndex as TOwn
from gubernator_tpu_torch.peers.picker import RegionPicker as TPicker
from gubernator_tpu_torch.service import breaker as tbreaker
from gubernator_tpu_torch.service import deadline as tdeadline
from gubernator_tpu_torch.service import wire as twire
from gubernator_tpu_torch.types import PeerInfo as TPeer

REPO = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000_000

# valid and invalid environments: the deferred planes' knobs parse too
# (refusing them is the daemon's job, not the parser's)
CONFIG_ENVS = [
    {},
    {"GUBER_CACHE_SIZE": "4096", "GUBER_BATCH_WAIT": "2ms", "GUBER_GLOBAL_SYNC_WAIT": "50ms",
     "GUBER_ENGINE": "sharded", "GUBER_PROBE_KERNEL": "pallas", "GUBER_DATA_CENTER": "dc1",
     "GUBER_INSTANCE_ID": "node-7"},
    {"GUBER_RING_ENABLE": "true", "GUBER_TIER_ENABLED": "true",
     "GUBER_CHECKPOINT_INTERVAL_MS": "250ms", "GUBER_CHECKPOINT_PATH": "/tmp/x.ckpt"},
    {"GUBER_OVERLOAD_DEADLINE_MS": "auto", "GUBER_ADAPTIVE_BATCH": "false",
     "GUBER_FORCE_GLOBAL": "true", "GUBER_DEGRADATION_POLICY": "local"},
    {"GUBER_ENGINE": "nope"},
    {"GUBER_CACHE_SIZE": "many"},
    {"GUBER_BATCH_WAIT": "soon"},
    {"GUBER_PEER_DISCOVERY_TYPE": "dns"},
    {"GUBER_PEER_DISCOVERY_TYPE": "carrier-pigeon"},
    {"GUBER_BATCH_LIMIT": "5000"},
    {"GUBER_PIPELINE_INFLIGHT": "0"},
    {"GUBER_CACHE_SIZE": "0"},
    {"GUBER_TLS_CLIENT_AUTH": "sometimes"},
]


def _parse(mod, env):
    try:
        conf = mod.setup_daemon_config(env=dict(env))
    except mod.ConfigError as exc:
        return "error", str(exc)
    out = dataclasses.asdict(conf)
    if "GUBER_INSTANCE_ID" not in env:
        out.pop("instance_id")  # a random id when unset
    return "ok", out


@pytest.mark.parametrize("env", CONFIG_ENVS, ids=[str(i) for i in range(len(CONFIG_ENVS))])
def test_config_parses_as_jax(env):
    assert _parse(tconfig, env) == _parse(jconfig, env)


def _literal_descriptor(path: Path) -> bytes:
    """The serialized FileDescriptorProto a protoc module registers."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "AddSerializedFile":
            return node.args[0].value
    raise AssertionError(f"{path}: no AddSerializedFile call")


@pytest.mark.parametrize("name", ["gubernator_pb2", "peers_pb2", "handoff_pb2",
                                  "globalsync_pb2", "regionsync_pb2"])
def test_proto_descriptors_are_byte_equal(name):
    import importlib

    j = importlib.import_module(f"gubernator_tpu.proto.{name}")
    t = importlib.import_module(f"gubernator_tpu_torch.proto.{name}")
    if hasattr(t, "_fdp"):  # built in code
        assert t._fdp.SerializeToString() == j._fdp.SerializeToString()
    else:  # protoc output
        assert (_literal_descriptor(REPO / "gubernator_tpu_torch" / "proto" / f"{name}.py")
                == _literal_descriptor(REPO / "gubernator_tpu" / "proto" / f"{name}.py"))
    # and what each module registered in the pool
    fd = lambda m: getattr(m, "DESCRIPTOR", None) or m._fd
    assert fd(t).serialized_pb == fd(j).serialized_pb


def test_xxh32_matches_the_xxhash_package():
    import xxhash

    rng = np.random.default_rng(3)
    for n in list(range(0, 70)) + [255, 1024]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 7, 0xFFFFFFFF):
            assert thashing.xxh32(data, seed) == xxhash.xxh32_intdigest(data, seed=seed)


@pytest.mark.parametrize("hash_name", ["fnv1a", "fnv1", "xxhash"])
def test_hash_ring_owners_match(hash_name):
    rng = np.random.default_rng(11)
    j = jring.ReplicatedConsistentHash(jring.HASH_FUNCTIONS[hash_name])
    t = tring.ReplicatedConsistentHash(tring.HASH_FUNCTIONS[hash_name])
    for i in range(5):
        addr = f"10.0.{i}.{int(rng.integers(1, 255))}:{int(rng.integers(1024, 65535))}"
        j.add(JPeer(grpc_address=addr))
        t.add(TPeer(grpc_address=addr))
    keys = [f"n{int(a)}_k{int(b)}" for a, b in rng.integers(0, 1 << 30, (4096, 2))]
    assert [t.get(k).grpc_address for k in keys] == [j.get(k).grpc_address for k in keys]
    pts = np.array([tring.fnv1a_32(k.encode()) for k in keys[:512]], dtype=np.uint32)
    ex = frozenset({t.peers()[0].grpc_address})
    assert ([p.grpc_address for p in t.owners_of(pts, ex)]
            == [p.grpc_address for p in j.owners_of(pts, ex)])
    assert [t.get(k, ex).grpc_address for k in keys[:256]] == [
        j.get(k, ex).grpc_address for k in keys[:256]]


def test_region_picker_and_ownership_index_match():
    rng = np.random.default_rng(12)
    jp, tp = JPicker(), TPicker()
    for i in range(6):
        kw = dict(grpc_address=f"h{i}:81", data_center=f"dc{i % 3}")
        jp.add(JPeer(**kw))
        tp.add(TPeer(**kw))
    keys = [f"k{int(x)}" for x in rng.integers(0, 1 << 40, 512)]
    assert [[p.grpc_address for p in tp.get_clients(k)] for k in keys] == [
        [p.grpc_address for p in jp.get_clients(k)] for k in keys]
    assert tp.size() == jp.size() and sorted(tp.pickers()) == sorted(jp.pickers())

    jo, to = JOwn(), TOwn()
    fps = rng.integers(1, 1 << 62, 2000, dtype=np.int64)
    pts = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    for o in (jo, to):
        o.record(fps[:1500], pts[:1500])
        o.record_keys(iter(fps[1500:]), iter(keys[:500]), tring.fnv1a_32)
        o.discard(fps[:100])
    probe = np.concatenate([fps, rng.integers(1, 1 << 62, 64, dtype=np.int64)])
    for a, b in zip(to.points_for(probe), jo.points_for(probe)):
        assert np.array_equal(a, b)
    assert len(to) == len(jo)
    assert to.prune(fps[200:900]) == jo.prune(fps[200:900]) and len(to) == len(jo)


def test_breaker_and_deadlines_match():
    import random

    clock = [0.0]
    events = np.random.default_rng(13).integers(0, 5, 400)
    trail = {}
    for name, mod in (("jax", jbreaker), ("port", tbreaker)):
        clock[0] = 0.0
        b = mod.CircuitBreaker(failure_threshold=3, backoff_base_ms=20, backoff_cap_ms=400,
                               probe_budget=2, clock=lambda: clock[0], rng=random.Random(5))
        out = []
        for e in events:
            if e == 0:
                out.append(b.allow())
            elif e == 1:
                b.record_success()
            elif e == 2:
                b.record_failure()
            elif e == 3:
                b.record_discard()
            else:
                clock[0] += 0.013
            out.append((b.state_name, b.blocked, round(b.retry_after_s(), 9)))
        trail[name] = out
    assert trail["port"] == trail["jax"]
    for mod in (jdeadline, tdeadline):
        mod.set_inbound_deadline(None)
        assert mod.remaining(1.5) == 1.5 and mod.inbound_deadline() is None
        mod.set_inbound_deadline(30.0)
        assert 29.0 < mod.remaining() <= 30.0
        mod.set_inbound_deadline(float("inf"))
        assert mod.inbound_deadline() is None


def _pb_items(rng, n: int):
    items = []
    for i in range(n):
        kind = int(rng.integers(0, 8))
        it = pb.RateLimitReq(
            name="" if kind == 0 else f"n{int(rng.integers(0, 4))}",
            unique_key="" if kind == 1 else f"k{int(rng.integers(0, 40))}",
            hits=int(rng.integers(-2, 6)), limit=int(rng.integers(0, 50)),
            duration=int(rng.integers(0, 90_000)), algorithm=int(rng.integers(0, 5)),
            behavior=int(rng.choice([0, 1, 2, 8, 16, 32, 64 | 8, 4])),
            burst=int(rng.integers(0, 3)),
        )
        if kind == 2:
            it.created_at = NOW - int(rng.integers(0, 400))
        if kind == 3:
            it.hits = 1 << 61
        if kind in (4, 5):
            for lv in range(int(rng.integers(1, 4))):
                it.cascade.add(name=f"c{lv}", unique_key="" if kind == 5 and lv else f"u{i}",
                               limit=int(rng.integers(1, 9)), duration=60_000,
                               algorithm=int(rng.integers(0, 4)))
        items.append(it)
    return items


def _cols_equal(a, b):
    return all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))


def test_wire_converters_match():
    rng = np.random.default_rng(14)
    items = _pb_items(rng, 300)
    jc, jk = jwire.columns_from_pb(items)
    tc, tk = twire.columns_from_pb(items)
    assert _cols_equal(tc, jc) and tk == jk
    for cap in (2, 4):
        je, jn = jwire.expand_cascades(jc, items, cap)
        te, tn = twire.expand_cascades(TCols(*tc), items, cap)
        assert _cols_equal(te, je) and tn == jn
        m = je.fp.shape[0]
        resp = dict(status=rng.integers(0, 2, m).astype(np.int32),
                    limit=rng.integers(0, 99, m), remaining=rng.integers(0, 99, m),
                    reset_time=NOW + rng.integers(-5, 9_000, m),
                    err=rng.integers(0, 3, m).astype(np.int8))
        resp["err"][rng.integers(0, m, 5)] = 9  # ERR_CASCADE_DEEP
        jr = jwire.pb_from_cascade_response_columns(JResp(**resp), jn, cap, now_ms=NOW)
        tr = twire.pb_from_cascade_response_columns(TResp(**resp), tn, cap, now_ms=NOW)
        assert [r.SerializeToString() for r in tr] == [r.SerializeToString() for r in jr]
    n = jc.fp.shape[0]
    resp = dict(status=rng.integers(0, 2, n).astype(np.int32), limit=rng.integers(0, 99, n),
                remaining=rng.integers(0, 99, n), reset_time=NOW + rng.integers(-5, 9_000, n),
                err=rng.integers(0, 4, n).astype(np.int8))
    for now in (None, NOW):
        assert [r.SerializeToString() for r in
                twire.pb_from_response_columns(TResp(**resp), now_ms=now)] == [
            r.SerializeToString() for r in jwire.pb_from_response_columns(JResp(**resp), now_ms=now)]
    assert twire.batch_too_large_error(7) == jwire.batch_too_large_error(7)


def test_sync_and_transfer_codecs_match():
    from gubernator_tpu.ops.layout import LAYOUTS as JLAY
    from gubernator_tpu_torch.ops.layout import LAYOUTS as TLAY

    rng = np.random.default_rng(15)
    pairs = []
    for i in range(200):
        it = pb.RateLimitReq(name=f"g{i % 7}", unique_key=f"k{i}", hits=int(rng.integers(0, 1 << 40)),
                             limit=int(rng.integers(0, 1 << 20)), duration=int(rng.integers(0, 1 << 26)),
                             algorithm=int(rng.integers(0, 5)), behavior=2 | int(rng.choice([0, 8, 32])),
                             created_at=NOW + int(rng.integers(-300, 300)))
        pairs.append((it.name + "_" + it.unique_key, it))
    j = jwire.sync_wire_pb(pairs, "src:1")
    t = twire.sync_wire_pb(pairs, "src:1")
    assert j is not None and t.SerializeToString() == j.SerializeToString()
    assert [x.SerializeToString() for x in twire.sync_wire_items(j)] == [
        x.SerializeToString() for x in jwire.sync_wire_items(j)]
    meta = pairs[0][1].__class__()
    meta.CopyFrom(pairs[0][1])
    meta.metadata["traceparent"] = "x"
    assert twire.sync_wire_pb([("a", meta)], "s") is None and jwire.sync_wire_pb([("a", meta)], "s") is None
    for name in ("full", "gcra32", "token32"):
        jl = next(x for x in JLAY.values() if x.name == name)
        tl = next(x for x in TLAY.values() if x.name == name)
        n = 33
        fps = rng.integers(1, 1 << 62, n, dtype=np.int64)
        pts = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        slots = rng.integers(-(1 << 31), 1 << 31, (n, jl.F), dtype=np.int64).astype(np.int32)
        jreq = jwire.transfer_chunk_pb("t1", 2, 5, "me:1", NOW, fps, pts, slots, jl)
        treq = twire.transfer_chunk_pb("t1", 2, 5, "me:1", NOW, fps, pts, slots, tl)
        assert treq.SerializeToString() == jreq.SerializeToString()
        tf, tp, ts, tlay = twire.transfer_chunk_arrays(jreq)
        assert np.array_equal(tf, fps) and np.array_equal(tp, pts) and np.array_equal(ts, slots)
        assert tlay.name == name
    bad = jwire.transfer_chunk_pb("t1", 0, 1, "me", NOW, fps[:3], pts[:2], slots[:3], jl)
    with pytest.raises(ValueError):
        twire.transfer_chunk_arrays(bad)


def _request_bytes(rng, n_req: int):
    out = []
    for r in range(n_req):
        items = _pb_items(rng, int(rng.integers(0, 60)))
        items = [it for it in items if not len(it.cascade)]
        if r % 5 == 0 and items:
            items[0].metadata["traceparent"] = (
                "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
        out.append(pb.GetRateLimitsReq(requests=items).SerializeToString())
    return out


def test_native_parser_and_encoder_match_jax():
    assert jnative.load() is not None and tnative.load() is not None
    assert tnative.parser() == "native"
    rng = np.random.default_rng(16)
    for data in _request_bytes(rng, 40):
        j = jwire.wire_batch_from_wire(data)
        t = twire.wire_batch_from_wire(data)
        (jwb, jr, js, jtp), (twb, tr, ts, ttp) = j, t
        assert _cols_equal(twb.cols, jwb.cols)
        assert np.array_equal(twb.lanes, jwb.lanes) and np.array_equal(twb.encodable, jwb.encodable)
        assert twb.nbytes == jwb.nbytes and ttp == jtp
        assert np.array_equal(tr, jr) and np.array_equal(ts, js)
        n = twb.rows
        cols = [rng.integers(0, 2, n), rng.integers(0, 1 << 40, n), rng.integers(-3, 1 << 40, n),
                NOW + rng.integers(-10, 10_000, n)]
        errors = {int(i): f"bad {int(i)}" for i in rng.integers(0, max(n, 1), 3) if n}
        for now in (None, NOW):
            assert (twire.encode_response_columns(*cols, errors, now)
                    == jwire.encode_response_columns(*cols, errors, now))
        # the lane pass over parsed columns is the parser's own
        lanes = twire.wire_batch_from_columns(twb.cols)
        assert np.array_equal(lanes.lanes, twb.lanes)
        assert np.array_equal(lanes.encodable, twb.encodable)
    cas = pb.GetRateLimitsReq(requests=[_pb_items(np.random.default_rng(1), 1)[0]])
    cas.requests[0].cascade.add(name="c", unique_key="u", limit=1, duration=1)
    assert twire.wire_batch_from_wire(cas.SerializeToString()) is None
    assert thashing.fingerprint("a", "b") == thashing.fingerprint_key("a_b")


def test_protobuf_parser_serves_without_the_extension(monkeypatch):
    """GUBER_NATIVE=0: the extension is not loaded, wire_batch_from_wire
    answers None (the daemon's cue for the protobuf path) and the pure-Python
    fingerprint gives the extension's values."""
    rng = np.random.default_rng(17)
    data = _request_bytes(rng, 2)[1]
    want = twire.wire_batch_from_wire(data)[0].cols
    keys = [("n", f"k{i}") for i in range(64)]
    fast = [thashing.fingerprint(*k) for k in keys]
    monkeypatch.setenv("GUBER_NATIVE", "0")
    monkeypatch.setattr(tnative, "_mod", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(thashing, "_native_fp", None)
    assert twire.wire_batch_from_wire(data) is None
    assert tnative.parser() == "protobuf"
    cols, _ = twire.columns_from_pb(list(pb.GetRateLimitsReq.FromString(data).requests))
    assert _cols_equal(cols, want)
    assert [thashing.fingerprint(*k) for k in keys] == fast


def test_hand_encoder_matches_protobuf():
    """chip_smoke.py's encoder, which makes the service phase's request
    bytes without a message object per item."""
    rng = np.random.default_rng(18)
    items = []
    for _ in range(200):
        f = dict(name=f"n{int(rng.integers(0, 9))}" * int(rng.integers(0, 3)),
                 unique_key="ключ" * int(rng.integers(0, 2)) + f"{int(rng.integers(0, 1 << 40))}",
                 hits=int(rng.integers(-3, 1 << 20)), limit=int(rng.integers(0, 1 << 50)),
                 duration=int(rng.integers(-1, 1 << 30)), algorithm=int(rng.integers(0, 5)),
                 behavior=int(rng.integers(0, 64)), burst=int(rng.integers(0, 9)))
        if rng.integers(0, 2):
            f["created_at"] = int(rng.integers(0, NOW))
        items.append(f)
    want = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(**f) for f in items]).SerializeToString()
    got = chip_smoke.encode_get_rate_limits_req(
        [chip_smoke.encode_rate_limit_req(**f) for f in items])
    assert got == want
    assert chip_smoke.encode_get_rate_limits_req([]) == pb.GetRateLimitsReq().SerializeToString()
    reqs, kids = chip_smoke._service_requests(np.random.default_rng(2), 2, 50, 1000)
    for req, ks in zip(reqs, kids):
        parsed = pb.GetRateLimitsReq.FromString(req)
        assert len(parsed.requests) == 50 and parsed.SerializeToString() == req
        assert [r.unique_key for r in parsed.requests] == [f"k{k}" for k in ks]
    kids = np.arange(6).reshape(2, 3)
    for req, ks in zip(chip_smoke._exact_requests("e", kids, 100 + np.arange(6)), kids):
        want = pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="e", unique_key=f"x{k}", hits=1, limit=100 + int(k),
                            duration=7_200_000) for k in ks])
        assert req == want.SerializeToString()

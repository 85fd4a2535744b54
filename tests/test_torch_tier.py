"""Port parity: hot-set tiering — gubernator_tpu_torch.tier (the host shadow
table) and the engine's evict capture, fault-back and miss re-check —
against the JAX package's ``gubernator_tpu.tier`` and engines.

The oracle cases of tests/test_tiering.py run on both packages from the
same numpy-seeded inputs: the evictee sidecar (its capture, its absence
without the flag, xla against pallas, its compact-wire egress), the
demote/promote round trip on every slot layout, stale duplicate promotes,
zero over-grant at 4x tracked keys, Zipf churn, the byte bound and LRU
shed, spill overflow and fault-back (the spill file byte-identical and
read across packages), conservative conflicts, the idle demote and
fault-back, the pipelined promote and the sharded idle demote on 4 shards.
After each step the responses, EngineStats, raw table bytes, the shadow's
fps and rows in order and its stats must be equal. Tolerance: exact.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gubernator_tpu.ops import kernel2 as jk2
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.ops.layout import FULL as JFULL
from gubernator_tpu.ops.table2 import Table2 as JTable2
from gubernator_tpu.ops.table2 import new_table2 as jnew_table2
from gubernator_tpu.tier import ShadowTable as JShadow
from gubernator_tpu.tier.shadow import merge_canonical_rows as jmerge
from gubernator_tpu_torch.ops import kernel2 as tk2
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine
from gubernator_tpu_torch.ops.layout import FULL as TFULL
from gubernator_tpu_torch.ops.table2 import Table2 as TTable2
from gubernator_tpu_torch.ops.table2 import new_table2 as tnew_table2
from gubernator_tpu_torch.tier import ROW_BYTES, ShadowTable as TShadow
from gubernator_tpu_torch.tier import merge_canonical_rows as tmerge

torch.set_num_threads(1)

NOW = 1_700_000_000_000
HOUR = 3_600_000


def _cols(fp, now, hits=1, limit=10, algo=0, duration=HOUR):
    n = fp.shape[0]
    mk = lambda v, dt: np.full(n, v, dtype=dt)
    return dict(fp=np.asarray(fp, np.int64), algo=mk(algo, np.int32),
                behavior=np.zeros(n, np.int32), hits=np.broadcast_to(
                    np.asarray(hits, np.int64), (n,)).copy(),
                limit=mk(limit, np.int64), burst=mk(0, np.int64), duration=mk(duration, np.int64),
                created_at=mk(now, np.int64), err=np.zeros(n, np.int8))


def _pair(capacity=256, shadow_bytes=1 << 22, wire="full", **kw):
    """A JAX and a port engine with the same knobs, each with its own
    shadow (None: no shadow)."""
    j = JaxEngine(capacity=capacity, write_mode="xla", wire=wire, **kw)
    t = TorchEngine(capacity=capacity, write_mode="xla", device="cpu", wire=wire, **kw)
    if shadow_bytes is not None:
        j.attach_shadow(JShadow(max_bytes=shadow_bytes))
        t.attach_shadow(TShadow(max_bytes=shadow_bytes))
    return j, t


def _shadow_state(sh):
    fps = np.fromiter(sh._rows.keys(), np.int64, len(sh._rows))
    rows = np.stack(list(sh._rows.values())) if len(sh._rows) else np.zeros((0, 16), np.int32)
    st = sh.stats()
    if "spill" in st:
        st["spill"].pop("path")
    return fps.tobytes(), rows.tobytes(), st


def _assert_same(j, t):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()
    if j.shadow is not None:
        assert _shadow_state(t.shadow) == _shadow_state(j.shadow)


def _check(j, t, cols, now):
    a = j.check_columns(JCols(**cols), now_ms=now)
    b = t.check_columns(TCols(**cols), now_ms=now)
    for f in ("status", "limit", "remaining", "reset_time", "err"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    _assert_same(j, t)
    return b


# ------------------------------------------------------------- the sidecar


def _arr12(fp, now, hits):
    n = fp.shape[0]
    z = np.zeros(n, np.int64)
    mk = lambda v: np.full(n, v, np.int64)
    hits = np.broadcast_to(np.asarray(hits, np.int64), (n,))
    return np.stack([np.asarray(fp, np.int64), z, z, hits, mk(10), z,
                     mk(HOUR), mk(now), mk(now + HOUR), z, mk(HOUR),
                     (np.asarray(fp) != 0).astype(np.int64)])


@pytest.mark.parametrize("probe", ["xla", "pallas"])
def test_evictee_sidecar_capture_matches_jax(probe):
    """A full bucket's displaced live rows ride the dispatch output: the
    output array (sidecar included), its decode and the table bytes equal
    the JAX package's, on either decide walk; without the flag the output
    keeps its (B+2, 4) shape."""
    seed = np.arange(1, 9, dtype=np.int64)
    pad = np.zeros(16, np.int64)
    pad[:4] = np.arange(101, 105)
    hits = (pad != 0).astype(np.int64)
    jt, tt = jnew_table2(8), tnew_table2(8, device="cpu")
    jt, _ = jk2.decide2_packed_cols(jt, jnp.asarray(_arr12(seed, NOW, 3)), write="xla",
                                    math="token", probe=probe)
    tt, _ = tk2.decide2_packed_cols(tt, torch.from_numpy(_arr12(seed, NOW, 3)), write="xla",
                                    math="token", probe=probe)
    jt, jo = jk2.decide2_packed_cols(jt, jnp.asarray(_arr12(pad, NOW + 5, hits)), write="xla",
                                     math="token", evictees=True, probe=probe)
    tt, to = tk2.decide2_packed_cols(tt, torch.from_numpy(_arr12(pad, NOW + 5, hits)),
                                     write="xla", math="token", evictees=True, probe=probe)
    jo, to = np.asarray(jo), to.numpy()
    assert to.dtype == jo.dtype and to.shape == jo.shape == (3 * 16 + 2, 4)
    np.testing.assert_array_equal(to, jo)
    assert tt.rows.numpy().tobytes() == np.asarray(jt.rows).tobytes()
    fps, rows = tk2.unpack_evictees(to)
    jf, jr = jk2.unpack_evictees(jo)
    np.testing.assert_array_equal(fps, jf)
    np.testing.assert_array_equal(rows, jr)
    _, st = tk2.unpack_outputs(to, 4)
    assert st[3] == fps.shape[0] == 4
    assert (rows[:, 2] == 10).all() and (rows[:, 4] == 7).all()  # pre-dispatch state
    _, plain = tk2.decide2_packed_cols(tnew_table2(8, device="cpu"),
                                       torch.from_numpy(_arr12(pad, NOW, hits)), write="xla",
                                       math="token", probe=probe)
    assert tuple(plain.shape) == (18, 4)


def test_evictee_sidecar_xla_equals_pallas():
    """The fused walk's sidecar is bit-identical to the XLA path's, and both
    equal the JAX package's (which holds its own two paths equal)."""
    rng = np.random.default_rng(11)
    seed = rng.integers(1, 1 << 60, size=64, dtype=np.int64)
    batch = _arr12(rng.integers(1, 1 << 60, size=32, dtype=np.int64), NOW + 5, np.ones(32))
    t0 = tnew_table2(64, device="cpu")
    t0, _ = tk2.decide2_packed_cols(t0, torch.from_numpy(_arr12(seed, NOW, np.ones(64))),
                                    write="xla", math="token")
    outs = []
    for probe in ("xla", "pallas"):
        t = TTable2(rows=t0.rows.clone(), layout=TFULL)
        t, o = tk2.decide2_packed_cols(t, torch.from_numpy(batch), write="xla", math="token",
                                       evictees=True, probe=probe)
        outs.append((o.numpy(), t.rows.numpy().tobytes()))
    jt = JTable2(rows=jnp.asarray(t0.rows.numpy()))
    jt, jo = jk2.decide2_packed_cols(jt, jnp.asarray(batch), write="xla", math="token",
                                     evictees=True)
    for o, rows in outs:
        np.testing.assert_array_equal(o, np.asarray(jo))
        assert rows == np.asarray(jt.rows).tobytes()
    assert tk2.unpack_evictees(outs[0][0])[0].shape[0] > 0  # the scenario evicts


def test_evictee_sidecar_rides_compact_wire():
    """Compact-wire engines (int32 egress with the raw sidecar rows) land
    the victims in the shadow exactly as the JAX package's does."""
    j, t = _pair(capacity=8, wire="compact")
    _check(j, t, _cols(np.arange(1, 9, dtype=np.int64), NOW, hits=3), NOW)
    _check(j, t, _cols(np.arange(101, 109, dtype=np.int64), NOW + 5), NOW + 5)
    st = t.shadow.stats()
    assert st["demoted_evict"] > 0
    assert t.stats.evicted_unexpired >= st["demoted_evict"]


# ------------------------------------------------------- round trip, conflicts


@pytest.mark.parametrize("layout,algo", [("full", 0), ("gcra32", 2), ("token32", 0)])
def test_demote_promote_roundtrip_matches_jax(layout, algo):
    """An idle-demoted row faulted back through merge_rows re-packs to the
    same table bytes on every layout, in both packages alike."""
    j, t = _pair(capacity=64, shadow_bytes=None, layout=layout)
    fp = np.array([12345], dtype=np.int64)
    _check(j, t, _cols(fp, NOW, hits=3, algo=algo), NOW)
    before = t.read_state(fp, raw=True)
    outs = []
    for eng, Shadow, lay_full in ((j, JShadow, JFULL), (t, TShadow, TFULL)):
        fps, slots = eng.extract_idle(NOW + 1000, 1)
        eng.tombstone_fps(fps)
        gone = eng.read_state(fp)[0][0]
        full = np.asarray(eng.table.layout.unpack(slots))
        sh = Shadow(max_bytes=1 << 20)
        sh.offer(fps, full, NOW + 1000, reason="idle")
        pf, rows = sh.take(fp, NOW + 1000)
        eng.merge_rows(pf, rows, now_ms=NOW + 1000, layout=lay_full)
        outs.append((fps, full, gone, pf, rows, eng.read_state(fp, raw=True), sh.stats()))
    for a, b in zip(outs[0], outs[1]):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        elif isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert not outs[1][2]
    np.testing.assert_array_equal(outs[1][5][1], before[1])  # bit-exact round trip
    _assert_same(j, t)


def test_stale_duplicate_promote_matches_jax():
    j, t = _pair(capacity=64)
    fp = np.array([777], dtype=np.int64)
    _check(j, t, _cols(fp, NOW, hits=2), NOW)
    old = t.read_state(fp)[1]
    np.testing.assert_array_equal(old, j.read_state(fp)[1])
    _check(j, t, _cols(fp, NOW + 10, hits=5), NOW + 10)
    for k, at in ((0, 20), (1, 40)):
        j.shadow.offer(fp, old, NOW + at)
        t.shadow.offer(fp, old, NOW + at)
        rc = _check(j, t, _cols(fp, NOW + at + 10, hits=0), NOW + at + 10)
        assert rc.remaining[0] <= 3  # a stale promote cannot re-grant


def test_merge_canonical_rows_matches_jax():
    """The host merge of same-fingerprint rows (the shadow's conflict
    rule) on random rows of every algorithm, bit for bit."""
    rng = np.random.default_rng(5)
    a = rng.integers(-(2**31), 2**31, (512, 16), dtype=np.int64).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, (512, 16), dtype=np.int64).astype(np.int32)
    for x in (a, b):
        x[:, 5] = rng.integers(0, 5, 512) | (rng.integers(0, 2, 512) << 8)
    b[:256, 5] = a[:256, 5]  # half agree on the algorithm
    np.testing.assert_array_equal(tmerge(a, b), jmerge(a, b))
    np.testing.assert_array_equal(tmerge(b, a), jmerge(b, a))


def test_shadow_conflict_merges_conservatively():
    outs = []
    for Shadow in (JShadow, TShadow):
        sh = Shadow(max_bytes=1 << 20)
        fp = np.array([5], dtype=np.int64)
        a = np.zeros((1, 16), np.int32)
        a[0, 0], a[0, 4], a[0, 10] = 5, 8, 100
        b = a.copy()
        b[0, 4], b[0, 10] = 3, 200
        sh.offer(fp, a, 0)
        sh.offer(fp, b, 0)
        f, r = sh.take(fp, 0)
        outs.append((f.tobytes(), r.tobytes(), sh.stats()))
    assert outs[0] == outs[1]
    assert outs[1][2]["conflicts_merged"] == 1


# ------------------------------------------------------ zero over-grant


def _drive(j, t, keys, passes=4, wave=128, hits=3, limit=10):
    adm = {int(k): 0 for k in keys}
    now = NOW
    for _ in range(passes):
        for i in range(0, len(keys), wave):
            w = keys[i:i + wave]
            rc = _check(j, t, _cols(w, now, hits=hits, limit=limit), now)
            for k in np.nonzero((rc.status == 0) & (rc.err == 0))[0]:
                adm[int(w[k])] += hits
            now += 7
    return adm


def test_zero_over_grant_at_4x_tracked_keys_matches_jax():
    """4x tracked keys beyond the table's capacity: with a shadow no key is
    admitted past its limit, in both packages alike; without one the same
    drive over-grants, also alike."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 62, size=1024 + 64, dtype=np.int64))[:1024]
    adm = _drive(*_pair(capacity=256), keys)
    assert max(adm.values()) <= 10
    adm = _drive(*_pair(capacity=256, shadow_bytes=None), keys)
    assert max(adm.values()) > 10  # the control still exercises eviction


def test_zipf_churn_bounded_shadow_matches_jax():
    rng = np.random.default_rng(17)
    keys = np.unique(rng.integers(1, 1 << 62, size=1024 + 64, dtype=np.int64))[:1024]
    j, t = _pair(capacity=256, shadow_bytes=1024 * ROW_BYTES)
    zipf = np.minimum(rng.zipf(1.3, size=12 * 128) - 1, 1023)
    adm = {int(k): 0 for k in keys}
    now = NOW
    for i in range(12):
        w = np.unique(keys[zipf[i * 128:(i + 1) * 128]])
        rc = _check(j, t, _cols(w, now, hits=1, limit=50), now)
        for k in np.nonzero((rc.status == 0) & (rc.err == 0))[0]:
            adm[int(w[k])] += 1
        now += 11
    assert max(adm.values()) <= 50
    assert t.shadow.stats()["nominal_bytes"] <= 1024 * ROW_BYTES


# ----------------------------------------------------- byte bound and spill


def _rows(fps, payload=None):
    rows = np.zeros((fps.shape[0], 16), np.int32)
    rows[:, 0] = fps.astype(np.int32)
    rows[:, 4] = fps.astype(np.int32) if payload is None else payload
    rows[:, 10] = 1  # expiry 1 ms: live at now 0
    return rows


def test_shadow_byte_bound_and_lru_shed_match_jax():
    outs = []
    for Shadow in (JShadow, TShadow):
        sh = Shadow(max_bytes=4 * ROW_BYTES)
        fps = np.arange(1, 11, dtype=np.int64)
        sh.offer(fps, _rows(fps), 0)
        f, r = sh.take(fps, 0)
        outs.append((f.tobytes(), r.tobytes(), sh.stats()))
    assert outs[0] == outs[1]
    assert outs[1][2]["shed"] == 6 and outs[1][2]["ram_rows"] == 0


def test_spill_overflow_faultback_and_files_match_jax(tmp_path):
    """Over-budget rows shed to the spill file (DeltaLog frames): the two
    packages write the same bytes, fault back the same rows, and each
    re-indexes the other's file after a flush."""
    paths = {k: str(tmp_path / f"spill.{k}") for k in ("jax", "torch")}
    shadows = {"jax": JShadow(max_bytes=4 * ROW_BYTES, spill_path=paths["jax"]),
               "torch": TShadow(max_bytes=4 * ROW_BYTES, spill_path=paths["torch"])}
    fps = np.arange(1, 11, dtype=np.int64)
    got = {}
    for k, sh in shadows.items():
        sh.offer(fps, _rows(fps), 0)
        f, r = sh.take(np.array([2, 9], dtype=np.int64), 0)
        sh.offer(np.array([42], dtype=np.int64), _rows(np.array([42])), 0)
        sh.flush(0)
        st = sh.stats()
        st["spill"].pop("path")
        got[k] = (f.tobytes(), r.tobytes(), st)
    assert got["jax"] == got["torch"]
    assert got["torch"][2]["shed"] == 0
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["jax"] == data["torch"]
    # each package re-indexes the other's spill and faults back the same rows
    reread = []
    for reader, writer in ((TShadow, "jax"), (JShadow, "torch")):
        sh = reader(max_bytes=1 << 20, spill_path=paths[writer])
        n = sh.load()
        f, r = sh.take(np.array([3, 42, 9], dtype=np.int64), 0)
        reread.append((n, f.tobytes(), r.tobytes()))
    assert reread[0] == reread[1] and reread[0][0] > 0


# ------------------------------------------------ idle demote and fault-back


def test_extract_idle_horizon_and_cap_match_jax():
    j, t = _pair(capacity=256, shadow_bytes=None)
    _check(j, t, _cols(np.arange(1, 33, dtype=np.int64), NOW), NOW)
    _check(j, t, _cols(np.arange(101, 133, dtype=np.int64), NOW + 50_000), NOW + 50_000)
    for cap in (1 << 16, 5):
        a, b = j.extract_idle(NOW + 60_000, 30_000, max_rows=cap), \
            t.extract_idle(NOW + 60_000, 30_000, max_rows=cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, np.asarray(x))
    assert set(b[0].tolist()) <= set(range(1, 33)) and b[0].shape[0] == 5


def test_idle_demote_then_faultback_matches_jax():
    j, t = _pair(capacity=256)
    fp = np.array([4242], dtype=np.int64)
    _check(j, t, _cols(fp, NOW, hits=6), NOW)
    for eng in (j, t):
        fps, slots = eng.extract_idle(NOW + 60_000, 30_000)
        eng.tombstone_fps(fps)
        eng.shadow.offer(fps, np.asarray(eng.table.layout.unpack(slots)), NOW + 60_000,
                         reason="idle")
    _assert_same(j, t)
    rc = _check(j, t, _cols(fp, NOW + 61_000, hits=1), NOW + 61_000)
    assert rc.remaining[0] == 3  # 10 - 6 - 1: no re-grant
    assert t.shadow.stats()["promoted"] == 1


# ------------------------------------------------------------ pipelined


def test_pipelined_promote_and_demote_match_jax():
    """The JAX package's EngineRunner (prepare / issue / finish) drives a
    port engine and a JAX engine: the shadow probe at prepare, the merge at
    issue and the sidecar harvest at finish give the same answers, every
    key denied on its second 6 hits."""
    from gubernator_tpu.service.runner import EngineRunner

    rng = np.random.default_rng(23)
    keys = np.unique(rng.integers(1, 1 << 62, size=1100, dtype=np.int64))[:1024]
    j, t = _pair(capacity=256)

    async def drive(runner, Cols):
        out, now = [], NOW
        for _ in range(2):
            for i in range(0, 1024, 256):
                out.append(await runner.check(Cols(**_cols(keys[i:i + 256], now, hits=6)),
                                              now_ms=now))
                now += 7
        return out

    results = []
    for eng, Cols in ((j, JCols), (t, TCols)):
        runner = EngineRunner(eng, fetch_workers=2)
        try:
            results.append(asyncio.run(drive(runner, Cols)))
        finally:
            runner.close()
    for a, b in zip(*results):
        for f in ("status", "limit", "remaining", "reset_time", "err"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    _assert_same(j, t)
    denied = sum(int(((rc.status == 1) & (rc.err == 0)).sum()) for rc in results[1][4:])
    assert denied == 1024
    assert t.shadow.stats()["demoted_evict"] > 0


# --------------------------------------------------------------- the mesh


def test_sharded_idle_demote_faultback_matches_jax():
    """A 4-shard mesh with a shadow set on it: per-shard extract_idle,
    tombstone, and the fault-back through the routed merge (and its
    collect=True surface), equal to the JAX package's 4-device mesh."""
    from gubernator_tpu.parallel import ShardedEngine as JSharded
    from gubernator_tpu.parallel import make_mesh as jmake_mesh
    from gubernator_tpu_torch.parallel import ShardedEngine as TSharded
    from gubernator_tpu_torch.parallel import make_mesh

    knobs = dict(capacity_per_shard=64, write_mode="xla", route="host", dedup="host",
                 wire="full", probe="xla", walk="xla")
    j = JSharded(jmake_mesh(4), **knobs)
    t = TSharded(make_mesh(4, devices=["cpu"] * 4), **knobs)
    j.shadow, t.shadow = JShadow(max_bytes=1 << 20), TShadow(max_bytes=1 << 20)
    keys = np.unique(np.random.default_rng(5).integers(1, 1 << 60, size=64, dtype=np.int64))
    _check(j, t, _cols(keys, NOW, hits=4), NOW)
    demoted = []
    for eng in (j, t):
        fps, slots = eng.extract_idle(NOW + 60_000, 30_000)
        eng.tombstone_fps(fps)
        full = np.asarray(eng.table.layout.unpack(slots))
        eng.shadow.offer(fps, full, NOW + 60_000, reason="idle")
        demoted.append((fps, full))
    np.testing.assert_array_equal(demoted[1][0], demoted[0][0])
    np.testing.assert_array_equal(demoted[1][1], demoted[0][1])
    assert set(demoted[1][0].tolist()) == set(keys.tolist())
    _assert_same(j, t)
    rc = _check(j, t, _cols(keys, NOW + 61_000, hits=1), NOW + 61_000)
    assert (rc.remaining == 5).all()  # 10 - 4 - 1, preserved
    fps, full = demoted[1]
    a = j.merge_rows(fps[:4], full[:4], now_ms=NOW + 62_000, collect=True)
    b = t.merge_rows(fps[:4], full[:4], now_ms=NOW + 62_000, collect=True)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(y, np.asarray(x))
    assert b[1].shape == (4,) and b[3].shape[1] == 16
    _assert_same(j, t)

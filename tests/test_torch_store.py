"""Port parity: the Store hooks and the persistence files —
gubernator_tpu_torch.store and the engines' write-through and rehydrate —
against the JAX package's ``gubernator_tpu.store`` and engines.

The store cases of tests/test_resize_store_multiregion.py and
tests/test_global.py run on both packages: the ChangeSet of persisted
fingerprints, its per-key state (last occurrence wins), the rehydrate of
state lost to a restart on a single device and on a device-routed 4-shard
mesh, the leaky custom-burst and leak-since-write cases, evict then
rehydrate, and the GLOBAL engine's round-by-round sync under a Store.
Every ChangeSet is compared field by field (dtypes included), with the
responses, EngineStats, GlobalStats and raw table bytes. The files — delta
logs with packed and tombstone frames, snapshots, torn tails and their
repair — are written by both packages, compared byte for byte, and each
package reads the other's. Tolerance: exact.
"""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

import gubernator_tpu.store as jstore
import gubernator_tpu_torch.store as tstore
from gubernator_tpu import types as jtypes
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.ops.layout import LAYOUTS as JLAYOUTS
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine
from gubernator_tpu_torch.ops.layout import LAYOUTS as TLAYOUTS

torch.set_num_threads(1)

T = 1_700_000_000_000
MINUTE = 60_000
D = 4


def _changes_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert v.dtype == u.dtype, f.name
                np.testing.assert_array_equal(v, u, err_msg=f.name)
            else:
                assert v == u, f.name


def _recorders():
    return jstore.RecordingStore(), tstore.RecordingStore()


class _JLogged(jstore.DictStore):
    def __init__(self):
        super().__init__()
        self.changes = []

    def on_change(self, change):
        self.changes.append(change)
        super().on_change(change)


class _TLogged(tstore.DictStore):
    def __init__(self):
        super().__init__()
        self.changes = []

    def on_change(self, change):
        self.changes.append(change)
        super().on_change(change)


def _locals(stores, capacity=256):
    return (JaxEngine(capacity=capacity, write_mode="xla", wire="full", store=stores[0]),
            TorchEngine(capacity=capacity, write_mode="xla", device="cpu", store=stores[1]))


def _check_both(engines, reqs, now):
    """reqs: RateLimitRequest kwargs; responses, stats and tables equal."""
    j, t = engines
    a = j.check([jtypes.RateLimitRequest(**r) for r in reqs], now_ms=now)
    b = t.check([ttypes.RateLimitRequest(**r) for r in reqs], now_ms=now)
    assert [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in b] == \
        [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in a]
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.snapshot().tobytes() == np.asarray(j.snapshot()).tobytes()
    return b


def _req(key, hits=1, limit=100, **kw):
    return dict(name="t", unique_key=key, hits=hits, limit=limit, duration=MINUTE, **kw)


# ------------------------------------------------------------ single device


def test_on_change_receives_persisted_fingerprints():
    stores = _recorders()
    engines = _locals(stores)
    _check_both(engines, [_req("a"), dict(name="t", unique_key="", hits=1, limit=5,
                                          duration=MINUTE), _req("b")], T)
    _changes_equal(stores[0].changes, stores[1].changes)
    assert len(stores[1].changes) == 1 and stores[1].changes[0].created_at == T
    assert stores[1].touched_fps == stores[0].touched_fps
    assert len(stores[1].changes[0].fps) == 2  # the invalid row is excluded


def test_change_set_carries_per_key_state():
    stores = _recorders()
    engines = _locals(stores)
    _check_both(engines, [_req("a", hits=4, limit=10), _req("b", hits=2, limit=20),
                          _req("a", hits=1, limit=10)], T)
    _changes_equal(stores[0].changes, stores[1].changes)
    c = stores[1].changes[0]
    assert sorted(c.remaining.tolist()) == [5, 18]  # last occurrence of "a": 10 - 4 - 1


def test_rehydrates_state_lost_to_restart():
    stores = (_JLogged(), _TLogged())
    _check_both(_locals(stores), [_req("a", hits=4, limit=10)], T)
    out = _check_both(_locals(stores), [_req("a", hits=1, limit=10)], T + 1_000)  # restart
    assert out[0].remaining == 5  # hydrated 6, minus this hit; NOT a fresh 9
    _changes_equal(stores[0].changes, stores[1].changes)
    assert stores[1].rows == stores[0].rows
    assert (stores[1].hydrated, stores[1].get_calls) == (stores[0].hydrated,
                                                         stores[0].get_calls) == (1, 2)


def test_rehydrate_after_restore_of_an_empty_table():
    """Restoring an all-zero snapshot loses every row; the next check of
    each key rehydrates from the store, on contended traffic with repeated
    keys (multi-pass plans) and every algorithm."""
    rng = np.random.default_rng(3)
    stores = (_JLogged(), _TLogged())
    engines = _locals(stores, capacity=512)
    keys = [f"k{i}" for i in range(120)]
    now = T
    for step in range(3):
        if step == 2:
            for e in engines:
                e.restore(np.zeros_like(np.asarray(e.snapshot())))
        reqs = [_req(keys[int(i)], hits=int(rng.integers(0, 4)), limit=int(rng.integers(1, 9)),
                     algorithm=int(rng.integers(0, 5))) for i in rng.integers(0, 120, 160)]
        _check_both(engines, reqs, now)
        now += 500
    _changes_equal(stores[0].changes, stores[1].changes)
    assert stores[1].rows == stores[0].rows
    assert stores[1].hydrated == stores[0].hydrated > 0


def test_rehydrate_preserves_custom_leaky_burst():
    stores = (jstore.DictStore(), tstore.DictStore())
    lreq = lambda hits: _req("lb", hits=hits, limit=10, burst=20, algorithm=1)
    assert _check_both(_locals(stores), [lreq(15)], T)[0].remaining == 5
    assert _check_both(_locals(stores), [lreq(1)], T)[0].remaining == 4  # not refreshed to 19


def test_rehydrate_accrues_leak_since_write():
    stores = (jstore.DictStore(), tstore.DictStore())
    lreq = lambda hits, at: _req("lk", hits=hits, limit=10, algorithm=1, created_at=at)
    assert _check_both(_locals(stores), [lreq(10, T)], T)[0].remaining == 0
    assert _check_both(_locals(stores), [lreq(0, T + 30_000)], T + 30_000)[0].remaining == 5


def test_evict_then_rehydrate():
    """An unexpired item evicted under bucket pressure rehydrates from the
    Store on its next request (reference store_test.go:127)."""
    stores = (_JLogged(), _TLogged())
    engines = _locals(stores)
    NB = engines[1].table.rows.shape[0]

    def run(fps, hits, duration):
        n = len(fps)
        c = dict(fp=np.asarray(fps, np.int64), algo=np.zeros(n, np.int32),
                 behavior=np.zeros(n, np.int32), hits=np.full(n, hits, np.int64),
                 limit=np.full(n, 10, np.int64), burst=np.zeros(n, np.int64),
                 duration=np.full(n, duration, np.int64), created_at=np.full(n, T, np.int64),
                 err=np.zeros(n, np.int8))
        a = engines[0].check_columns(JCols(**c), now_ms=T)
        b = engines[1].check_columns(TCols(**c), now_ms=T)
        for f in b._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert engines[1].snapshot().tobytes() == np.asarray(engines[0].snapshot()).tobytes()
        return b

    victim = 7 + NB
    assert run([victim], 4, MINUTE).remaining[0] == 6
    assert (run([7 + i * NB for i in range(2, 8 + 3)], 1, 2 * MINUTE).err == 0).all()
    assert engines[1].stats.evicted_unexpired >= 1
    assert run([victim], 1, MINUTE).remaining[0] == 5  # hydrated 6, minus this hit
    assert dataclasses.asdict(engines[1].stats) == dataclasses.asdict(engines[0].stats)
    _changes_equal(stores[0].changes, stores[1].changes)
    assert stores[1].hydrated == stores[0].hydrated >= 1


def test_store_engine_takes_the_columns_path():
    """The fused front door refuses a Store engine (the write-through needs
    the columns path), as the JAX package's does."""
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    cols = TCols(fp=np.arange(1, 9, dtype=np.int64), algo=np.zeros(8, np.int32),
                 behavior=np.zeros(8, np.int32), hits=np.ones(8, np.int64),
                 limit=np.full(8, 5, np.int64), burst=np.zeros(8, np.int64),
                 duration=np.full(8, MINUTE, np.int64), created_at=np.zeros(8, np.int64),
                 err=np.zeros(8, np.int8))
    wb = wire_batch_from_columns(cols)
    eng = TorchEngine(capacity=256, device="cpu", wire="compact")
    assert te.prepare_check_wire(eng, [wb], now_ms=T) is not None
    eng = TorchEngine(capacity=256, device="cpu", wire="compact", store=tstore.RecordingStore())
    assert te.prepare_check_wire(eng, [wb], now_ms=T) is None
    assert te.prepare_ring_slot(eng, [wb], 16, now_ms=T) is None


# --------------------------------------------------------------- the meshes


def test_store_rehydrates_on_device_routed_mesh():
    from gubernator_tpu.parallel import ShardedEngine as JSharded
    from gubernator_tpu.parallel import make_mesh as jmake_mesh
    from gubernator_tpu_torch.parallel import ShardedEngine as TSharded
    from gubernator_tpu_torch.parallel import make_mesh

    knobs = dict(capacity_per_shard=256, route="device", dedup="device", a2a="ring",
                 write_mode="sparse", wire="full", probe="xla", walk="xla")
    jm, tm = jmake_mesh(D), make_mesh(D, devices=["cpu"] * D)
    stores = (_JLogged(), _TLogged())
    make = lambda: (JSharded(jm, store=stores[0], **knobs), TSharded(tm, store=stores[1], **knobs))
    keys = [f"sr{i}" for i in range(24)]
    _check_both(make(), [_req(k, hits=4, limit=10) for k in keys], T)
    assert len(stores[1].rows) == 24
    out = _check_both(make(), [_req(k, hits=1, limit=10) for k in keys], T + 1_000)
    assert all(r.error == "" and r.remaining == 5 for r in out)
    _changes_equal(stores[0].changes, stores[1].changes)
    assert stores[1].hydrated == stores[0].hydrated == 24


def test_global_store_engine_sync_stays_serial():
    """A Store GLOBAL engine drains round by round: the owner rows write
    through at check time, and the sync delivers every reconciled entry
    exactly once, in the same ChangeSets as the JAX package's."""
    from gubernator_tpu.parallel import make_mesh as jmake_mesh
    from gubernator_tpu.parallel.global_sync import GlobalShardedEngine as JGlobal
    from gubernator_tpu_torch.ops.batch import columns_from_requests as tcfr
    from gubernator_tpu.ops.batch import columns_from_requests as jcfr
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine as TGlobal

    knobs = dict(capacity_per_shard=1024, sync_out=16, route="host", dedup="host", a2a="ring",
                 write_mode="sparse", wire="full", probe="xla", walk="xla")
    stores = _recorders()
    j = JGlobal(jmake_mesh(D), store=stores[0], **knobs)
    t = TGlobal(make_mesh(D, devices=["cpu"] * D), store=stores[1], **knobs)
    for batch in range(3):
        reqs = [dict(name="glob", unique_key=f"sk{batch}_{i}", hits=1, limit=100,
                     duration=MINUTE, behavior=int(jtypes.Behavior.GLOBAL), created_at=T)
                for i in range(64)]
        a = j.check_columns(jcfr([jtypes.RateLimitRequest(**r) for r in reqs]), now_ms=T)
        b = t.check_columns(tcfr([ttypes.RateLimitRequest(**r) for r in reqs]), now_ms=T)
        for f in b._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert max(len(p) for p in t.pending) > t.sync_out
    n_check = len(stores[1].changes)
    j.sync(now_ms=T)
    t.sync(now_ms=T)
    assert not t.has_pending()
    _changes_equal(stores[0].changes, stores[1].changes)
    assert dataclasses.asdict(t.global_stats) == dataclasses.asdict(j.global_stats)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.snapshot().tobytes() == np.asarray(j.snapshot()).tobytes()
    for d in range(D):
        assert t.replica[d].rows.numpy().tobytes() == np.asarray(j.replica.rows[d]).tobytes()
    synced = [fp for ch in stores[1].changes[n_check:] for fp in ch.fps.tolist()]
    assert len(synced) == len(set(synced)) == 192


def test_global_owner_rows_rehydrate_after_restart():
    """A DictStore GLOBAL engine: the owner rows of a GLOBAL batch write
    through, and after a restart onto fresh meshes with the same store they
    rehydrate on the primary (the reference's owner-side getLocalRateLimit),
    as in the JAX package."""
    from gubernator_tpu.ops.batch import columns_from_requests as jcfr
    from gubernator_tpu.parallel import make_mesh as jmake_mesh
    from gubernator_tpu.parallel.global_sync import GlobalShardedEngine as JGlobal
    from gubernator_tpu_torch.ops.batch import columns_from_requests as tcfr
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine as TGlobal

    knobs = dict(capacity_per_shard=1024, sync_out=16, route="host", dedup="host", a2a="ring",
                 write_mode="sparse", wire="full", probe="xla", walk="xla")
    jm, tm = jmake_mesh(D), make_mesh(D, devices=["cpu"] * D)
    stores = (_JLogged(), _TLogged())
    for k, hits in enumerate((3, 1)):
        j = JGlobal(jm, store=stores[0], **knobs)
        t = TGlobal(tm, store=stores[1], **knobs)
        reqs = [dict(name="glob", unique_key=f"rk{i}", hits=hits, limit=100, duration=MINUTE,
                     behavior=int(jtypes.Behavior.GLOBAL), created_at=T + k) for i in range(48)]
        a = j.check_columns(jcfr([jtypes.RateLimitRequest(**r) for r in reqs]), now_ms=T + k)
        b = t.check_columns(tcfr([ttypes.RateLimitRequest(**r) for r in reqs]), now_ms=T + k)
        for f in b._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        j.sync(now_ms=T + k)
        t.sync(now_ms=T + k)
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
        assert dataclasses.asdict(t.global_stats) == dataclasses.asdict(j.global_stats)
        assert t.snapshot().tobytes() == np.asarray(j.snapshot()).tobytes()
    _changes_equal(stores[0].changes, stores[1].changes)
    assert stores[1].rows == stores[0].rows
    assert stores[1].hydrated == stores[0].hydrated > 0


# ------------------------------------------------------------------- files


def _slot_rows(rng, n, width):
    rows = rng.integers(-(2**31), 2**31, (n, width), dtype=np.int64).astype(np.int32)
    return rows


def test_delta_log_files_are_byte_identical_and_cross_read(tmp_path):
    """Frames of every slot layout and tombstone frames: both packages write
    the same bytes, each scans the other's log to the same frames, and a
    torn tail scans, repairs and resets alike."""
    rng = np.random.default_rng(9)
    paths = {}
    for name, mod, lays in (("jax", jstore, JLAYOUTS), ("torch", tstore, TLAYOUTS)):
        log = mod.DeltaLog(str(tmp_path / f"{name}.delta"))
        r = np.random.default_rng(9)
        sizes = []
        for epoch, lay in enumerate(("full", "gcra32", "token32", "full")):
            L = lays[lay]
            sizes.append(log.append(epoch, T + epoch, _slot_rows(r, 5 + epoch, L.F), layout=L))
        sizes.append(log.append_tombstones(9, T + 9, r.integers(1, 2**63 - 1, 7,
                                                                dtype=np.int64)))
        paths[name] = (log, sizes)
    data = {k: open(v[0].path, "rb").read() for k, v in paths.items()}
    assert data["jax"] == data["torch"]
    assert paths["jax"][1] == paths["torch"][1]
    assert jstore.encode_tombstone_frame(3, T, np.array([1, -5, 1 << 40])) == \
        tstore.encode_tombstone_frame(3, T, np.array([1, -5, 1 << 40]))
    for reader, writer in ((tstore, "jax"), (jstore, "torch")):
        mine, theirs = reader.read_delta_frames(paths[writer][0].path), \
            (jstore if reader is tstore else tstore).read_delta_frames(paths[writer][0].path)
        assert mine.error is None and len(mine.frames) == len(theirs.frames) == 5
        assert (mine.rows, mine.clean_bytes, mine.skipped_bytes) == \
            (theirs.rows, theirs.clean_bytes, theirs.skipped_bytes)
        for (e1, n1, s1, l1), (e2, n2, s2, l2) in zip(mine.frames, theirs.frames):
            assert (e1, n1, l1.name) == (e2, n2, l2.name)
            np.testing.assert_array_equal(s1, s2)
        assert mine.frames[-1][3] is reader.TOMBSTONE
        np.testing.assert_array_equal(reader.fps_from_slots(mine.frames[-1][2]),
                                      jstore.fps_from_slots(theirs.frames[-1][2]))
    # a torn tail: the clean prefix scans, repair truncates it, alike
    for name, (log, _s) in paths.items():
        with open(log.path, "ab") as f:
            f.write(b"\x47\x55\x44\x46torn")
    scans = {}
    for name, mod in (("jax", jstore), ("torch", tstore)):
        scan = mod.read_delta_frames(paths[name][0].path)
        scans[name] = (scan.error, scan.skipped_bytes, scan.clean_bytes, len(scan.frames))
        paths[name][0].repair(scan)
    assert scans["jax"] == scans["torch"] and scans["torch"][0] is not None
    assert open(paths["jax"][0].path, "rb").read() == open(paths["torch"][0].path, "rb").read()
    paths["torch"][0].reset()
    assert open(paths["torch"][0].path, "rb").read() == jstore.DELTA_LOG_MAGIC


@pytest.mark.parametrize("layout", ["full", "gcra32"])
def test_snapshot_files_match_and_cross_read(tmp_path, layout):
    """A snapshot from either package holds the same array members (the zip
    container stamps its write time) and loads in the other, with its epoch
    and layout; FileLoader and MemoryLoader behave alike."""
    rng = np.random.default_rng(4)
    rows = _slot_rows(rng, 64, 128 if layout == "full" else 64).reshape(64, -1)
    paths = {}
    for name, mod in (("jax", jstore), ("torch", tstore)):
        paths[name] = str(tmp_path / f"{name}.snap")
        mod.save_snapshot(paths[name], rows, epoch=7, layout_name=layout)
    members = {}
    for name, p in paths.items():
        with zipfile.ZipFile(p) as z:
            members[name] = {i.filename: z.read(i.filename) for i in z.infolist()}
    assert members["jax"] == members["torch"]
    for reader, writer in ((tstore, "jax"), (jstore, "torch")):
        got, epoch, lay = reader.load_snapshot_meta(paths[writer])
        np.testing.assert_array_equal(got, rows)
        assert (epoch, lay) == (7, layout)
        np.testing.assert_array_equal(reader.load_snapshot(paths[writer]), rows)
    fl = tstore.FileLoader(str(tmp_path / "loader.snap"))
    assert fl.load() is None
    fl.save(rows)
    np.testing.assert_array_equal(jstore.FileLoader(fl.path).load(), rows)
    ml = tstore.MemoryLoader()
    ml.save(rows)
    assert ml.load() is rows and (ml.load_called, ml.save_called) == (1, 1)

"""Port parity: LocalEngine(device="cpu") (gubernator_tpu_torch.ops.engine)
against the JAX package's LocalEngine on check / check_columns.

Both engines start empty and see the same requests, made from a seed: mixed
algorithms over time steps, duplicate keys (multi-pass plans and the
aggregated tail), validation errors, Gregorian rows, a tiny table whose
claims drop and surface ERR_DROPPED, cascade groups, and a packed layout
migrated by off-family traffic. The JAX engine runs its full-width wire so
both dispatch the same (12, B) grids. Tolerance: exact — responses,
EngineStats and raw table bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gubernator_tpu.types as jtypes
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch.ops import engine as tengine
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _engines(capacity=256, write="xla", layout=None):
    j = JaxEngine(capacity=capacity, write_mode=write, wire="full", layout=layout or "full")
    t = TorchEngine(capacity=capacity, write_mode=write, layout=layout or "full", device="cpu")
    return j, t


def _assert_same_state(j, t):
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    assert t.table.layout.name == j.table.layout.name
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()


def _check_both(j, t, reqs, now):
    """reqs: list of RateLimitRequest kwargs."""
    jr = j.check([jtypes.RateLimitRequest(**r) for r in reqs], now_ms=now)
    tr = t.check([ttypes.RateLimitRequest(**r) for r in reqs], now_ms=now)
    assert len(jr) == len(tr) == len(reqs)
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert (a.status, a.limit, a.remaining, a.reset_time, a.error,
                a.retry_after_ms) == (b.status, b.limit, b.remaining,
                                      b.reset_time, b.error, b.retry_after_ms), i
    _assert_same_state(j, t)
    return tr


def _random_reqs(rng, n, keyspace, now, algos=(0, 1, 2, 3, 4)):
    reqs = []
    for _ in range(n):
        beh = 0
        r = rng.random()
        if r < 0.1:
            beh |= 8
        elif r < 0.2:
            beh |= 32
        reqs.append(dict(
            name="eng", unique_key=f"k{rng.integers(keyspace)}",
            hits=int(rng.integers(-1, 4)), limit=int(rng.integers(0, 9)),
            duration=int(rng.integers(1, 4)) * 1_000,
            algorithm=int(rng.choice(algos)), behavior=beh, created_at=now,
        ))
    return reqs


def test_random_traffic_over_time():
    rng = np.random.default_rng(1)
    j, t = _engines()
    now = NOW
    for _ in range(5):
        _check_both(j, t, _random_reqs(rng, 16, 24, now), now)
        now += int(rng.integers(0, 2_000))


def test_duplicate_keys_multi_pass():
    """One hot key 12 times (7 exact passes + an aggregated tail), another
    3 times, with RESET in the tail."""
    rng = np.random.default_rng(2)
    j, t = _engines()
    reqs = []
    for i in range(12):
        reqs.append(dict(name="d", unique_key="hot", hits=1, limit=9,
                         duration=5_000, behavior=8 if i == 10 else 0))
    for i in range(3):
        reqs.append(dict(name="d", unique_key="warm", hits=2, limit=5,
                         duration=5_000, algorithm=2))
    rng.shuffle(reqs)
    _check_both(j, t, reqs, NOW)
    _check_both(j, t, reqs, NOW + 100)


def test_validation_errors():
    j, t = _engines()
    reqs = [
        dict(name="v", unique_key="", hits=1, limit=5, duration=1_000),
        dict(name="", unique_key="k", hits=1, limit=5, duration=1_000),
        dict(name="v", unique_key="big", hits=1, limit=2**31, duration=1_000),
        dict(name="v", unique_key="burst", hits=1, limit=5, burst=-(2**31),
             duration=1_000, algorithm=1),
        dict(name="v", unique_key="algo", hits=1, limit=5, duration=1_000, algorithm=7),
        dict(name="v", unique_key="weeks", hits=1, limit=5, duration=3, behavior=4),
        dict(name="v", unique_key="ok", hits=1, limit=5, duration=1_000),
        dict(name="v", unique_key="skew", hits=1, limit=5, duration=1_000,
             created_at=NOW + 3_600_000),
    ]
    out = _check_both(j, t, reqs, NOW)
    assert [bool(r.error) for r in out] == [True] * 6 + [False, False]
    assert t.stats.created_at_clamped == 1


def test_gregorian_rows():
    rng = np.random.default_rng(3)
    j, t = _engines()
    reqs = [dict(name="g", unique_key=f"g{i}", hits=int(rng.integers(0, 3)),
                 limit=4, duration=int(d), behavior=4, algorithm=int(a))
            for i, (d, a) in enumerate(zip([0, 1, 2, 4, 5, 0, 1, 2],
                                           [0, 1, 0, 1, 0, 1, 0, 1]))]
    _check_both(j, t, reqs, NOW)
    _check_both(j, t, reqs, NOW + 30_000)


def test_tiny_capacity_drops_and_retries():
    """One bucket of K=8 slots and 32 new keys per batch, two claim
    retries: claims drop, retries evict, and the rows still unpersisted
    after three dispatches of 8 slots each answer ERR_DROPPED."""
    j, t = _engines(capacity=8)
    j.max_claim_retries = t.max_claim_retries = 2
    for step in range(3):
        reqs = [dict(name="tiny", unique_key=f"s{step}-{i}", hits=1, limit=3,
                     duration=10_000) for i in range(32)]
        out = _check_both(j, t, reqs, NOW + step)
    assert t.stats.dropped > 0 and t.stats.evicted_unexpired > 0
    assert any(r.error for r in out)


def test_redispatch_rows_matches():
    """The re-dispatch of dropped rows counts dispatches, evictions and
    final drops only, in both packages."""
    from gubernator_tpu.ops.batch import pack_columns as j_pack
    from gubernator_tpu_torch.ops.batch import pack_columns as t_pack

    j, t = _engines(capacity=8)
    _check_both(j, t, [dict(name="r", unique_key=f"a{i}", hits=1, limit=3,
                            duration=10_000) for i in range(8)], NOW)
    rng = np.random.default_rng(12)
    n = 12
    cols = dict(
        fp=rng.integers(1, 2**63 - 1, n, dtype=np.int64),
        algo=np.zeros(n, np.int32), behavior=np.zeros(n, np.int32),
        hits=np.ones(n, np.int64), limit=np.full(n, 3, np.int64),
        burst=np.zeros(n, np.int64), duration=np.full(n, 10_000, np.int64),
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )
    jb, _ = j_pack(JCols(**cols), NOW + 1)
    tb, _ = t_pack(TCols(**cols), NOW + 1)
    a = j._redispatch_rows(jb, n)
    b = t._redispatch_rows(tb, n)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    _assert_same_state(j, t)


def test_cascade_rows_fold_on_host():
    """Carrier + member rows (level bits 8-15): the carrier answers
    deny-if-any, min remaining and the latest denying reset."""
    j, t = _engines()
    lvl = lambda n: n << 8
    reqs = [
        dict(name="c", unique_key="user", hits=1, limit=5, duration=2_000),
        dict(name="c", unique_key="tenant", hits=1, limit=2, duration=3_000,
             behavior=lvl(1)),
        dict(name="c", unique_key="global", hits=1, limit=9, duration=1_000,
             behavior=lvl(2)),
        dict(name="c", unique_key="solo", hits=1, limit=1, duration=1_000),
    ]
    for step in range(4):
        out = _check_both(j, t, reqs, NOW + 10 * step)
    assert out[0].status == 1 and out[1].status == 1 and out[2].status == 0


def test_check_columns_matches():
    rng = np.random.default_rng(6)
    j, t = _engines()
    n = 16
    cols = dict(
        fp=rng.integers(1, 2**63 - 1, n, dtype=np.int64),
        algo=rng.integers(0, 5, n).astype(np.int32),
        behavior=np.zeros(n, np.int32),
        hits=rng.integers(0, 4, n).astype(np.int64),
        limit=rng.integers(1, 9, n).astype(np.int64),
        burst=np.zeros(n, np.int64),
        duration=np.full(n, 2_000, np.int64),
        created_at=np.zeros(n, np.int64),
        err=np.zeros(n, np.int8),
    )
    cols["fp"][3] = cols["fp"][5]  # a duplicate: two passes
    for step in range(2):
        a = j.check_columns(JCols(**cols), now_ms=NOW + step)
        b = t.check_columns(TCols(**cols), now_ms=NOW + step)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        _assert_same_state(j, t)


def test_packed_layout_migrates_on_offfamily_traffic():
    j, t = _engines(layout="token32")
    _check_both(j, t, [dict(name="p", unique_key=f"t{i}", hits=1, limit=4,
                            duration=4_000) for i in range(8)], NOW)
    assert t.table.layout.name == "token32"
    _check_both(j, t, [dict(name="p", unique_key=f"l{i}", hits=1, limit=4,
                            duration=4_000, algorithm=1) for i in range(8)], NOW + 5)
    assert t.table.layout.name == "full" and t.stats.layout_migrations == 1


def test_skill_recipe():
    """limit 3: remaining 2, 1, 0, then OVER_LIMIT."""
    t = TorchEngine(capacity=10_000, device="cpu")
    r = ttypes.RateLimitRequest(name="t", unique_key="k", hits=1, limit=3, duration=60_000)
    got = [t.check([r], now_ms=NOW)[0] for _ in range(4)]
    assert [g.remaining for g in got[:3]] == [2, 1, 0]
    assert [g.status for g in got] == [0, 0, 0, 1]
    assert got[3].retry_after_ms > 0


def test_snapshot_restore_and_live_count():
    rng = np.random.default_rng(8)
    j, t = _engines()
    _check_both(j, t, _random_reqs(rng, 16, 40, NOW), NOW)
    for dt in (0, 1_500, 10_000):
        assert t.live_count(NOW + dt) == j.live_count(NOW + dt)
    snap = t.snapshot()
    t2 = TorchEngine(capacity=256, write_mode="xla", device="cpu")
    t2.restore(snap)
    assert t2.snapshot().tobytes() == snap.tobytes()
    with pytest.raises(ValueError):
        t2.restore(snap[:16])


def test_default_write_mode_is_sparse():
    assert tengine.default_write_mode() == "sparse"
    assert TorchEngine(capacity=64, device="cpu").write_mode == "sparse"


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TorchEngine(capacity=64)
    with pytest.raises(RuntimeError):
        TorchEngine(capacity=64, device="cuda")


def test_store_and_shadow_options_are_accepted_and_work(monkeypatch):
    from gubernator_tpu_torch.store import RecordingStore
    from gubernator_tpu_torch.tier import ShadowTable

    # store=: every check fires a ChangeSet of the persisted keys
    store = RecordingStore()
    eng = TorchEngine(capacity=64, device="cpu", store=store)
    eng.check([ttypes.RateLimitRequest(name="t", unique_key="a", hits=1, limit=5,
                                       duration=60_000)], now_ms=NOW)
    assert len(store.changes) == 1 and store.changes[0].remaining.tolist() == [4]
    # attach_shadow: the evictee sidecar arms, and live evictions demote
    eng = TorchEngine(capacity=64, device="cpu")
    assert not eng._evictees
    eng.attach_shadow(ShadowTable(max_bytes=1 << 16))
    assert eng._evictees
    fps = np.arange(1, 257, dtype=np.int64)
    cols = TCols(fp=fps, algo=np.zeros(256, np.int32), behavior=np.zeros(256, np.int32),
                 hits=np.ones(256, np.int64), limit=np.full(256, 5, np.int64),
                 burst=np.zeros(256, np.int64), duration=np.full(256, 60_000, np.int64),
                 created_at=np.zeros(256, np.int64), err=np.zeros(256, np.int8))
    eng.check_columns(cols, now_ms=NOW)
    eng.check_columns(cols._replace(fp=fps + 1000), now_ms=NOW + 1)
    assert eng.shadow.stats()["demoted_evict"] == eng.stats.evicted_unexpired > 0
    # the fused walk is ported: the knobs resolve as the JAX package's do
    monkeypatch.setenv("GUBER_PROBE_KERNEL", "pallas")
    monkeypatch.setenv("GUBER_WALK_KERNEL", "pallas")
    eng = TorchEngine(capacity=64, device="cpu")
    assert (eng.probe_mode, eng.walk_mode) == ("pallas", "pallas")
    monkeypatch.setenv("GUBER_WALK_KERNEL", "fused")
    with pytest.raises(ValueError):
        TorchEngine(capacity=64, device="cpu")
    with pytest.raises(ValueError):
        TorchEngine(capacity=64, device="cpu", probe="fused")


@pytest.mark.parametrize("write", ["xla", "sweep"])
def test_cascade_fold_with_dropped_member(write):
    """The smallest cascade batch whose member the claim drops for good: a
    one-bucket table (8 lanes) and 41 levels of one cascade, so after three
    retries the last members still have no lane. The last member is over
    its limit. The JAX engine folds the dispatch's verdicts into the
    carrier before the retries (the dropped member counts), then on the
    host (it does not); the port must answer the carrier the same way."""
    j, t = _engines(capacity=8, write=write)
    n = 41
    reqs = [dict(name="casc", unique_key=f"k{i}", hits=5 if i == n - 1 else 1,
                 limit=3 if i == n - 1 else 10, duration=60_000,
                 behavior=(0 if i == 0 else 1) << 8, created_at=NOW)
            for i in range(n)]
    tr = _check_both(j, t, reqs, NOW)
    assert tr[-1].error  # the over-limit member was dropped ...
    assert tr[0].status == 1  # ... and its verdict still reached the carrier


@pytest.mark.parametrize(
    "algo,active,want",
    [
        ([0, 0, 0], [1, 1, 1], "token"),
        ([0, 1, 0], [1, 1, 0], "mixed"),
        ([2, 2, 0], [1, 1, 0], "gcra"),
        ([2, 3, 0], [1, 1, 1], "int"),
        ([4, 0, 0], [1, 0, 0], "int"),
    ],
)
def test_math_mode_matches(algo, active, want):
    from gubernator_tpu.ops import engine as jengine
    from gubernator_tpu_torch.ops.batch import HostBatch

    n = len(algo)
    z = np.zeros(n, np.int64)
    hb = HostBatch(fp=z, algo=np.asarray(algo, np.int32), behavior=z.astype(np.int32),
                   hits=z, limit=z, burst=z, duration=z, created_at=z, expire_new=z,
                   greg_interval=z, duration_eff=z, active=np.asarray(active, bool))
    assert tengine._math_mode(hb) == jengine._math_mode(hb) == want

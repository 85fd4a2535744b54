"""Port parity: the GLOBAL behavior on the mesh — ``GlobalShardedEngine`` of
gubernator_tpu_torch.parallel.global_sync on a 4-shard CPU mesh
(``make_mesh(4, devices=["cpu"] * 4)``) against the JAX package's
``GlobalShardedEngine(make_mesh(4))``.

Every case of tests/test_global.py runs as a scenario on both engines, with
all seven knobs (route, dedup, a2a, write_mode, wire, probe, walk) passed
to both; after each step the responses, EngineStats, GlobalStats and the
raw bytes of the primary and replica tables must be equal. Besides: single
rounds and many-round drains (the JAX package's fused step) with compact
and full outboxes, contended mixed-algorithm traffic with RESET_REMAINING
and DRAIN_OVER_LIMIT from several homes, the pipelined hooks, a failed
launch (its popped hits re-merge and the engine is poisoned), and
``PendingHits.merge`` / ``take`` against the JAX class on random inputs.
Tolerance: exact.

The JAX engines compile per knob set and shape, so the scenarios share two
knob sets: ``_knobs()`` (host routing, full outboxes) and ``_COMPACT``
(device routing and dedup, compact outboxes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import batch as jb
from gubernator_tpu.ops import engine as je
from gubernator_tpu.parallel import make_mesh as jax_make_mesh
from gubernator_tpu.parallel import global_sync as jg
from gubernator_tpu_torch.hashing import fingerprint
from gubernator_tpu_torch.ops import batch as tb
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.parallel import global_sync as tg
from gubernator_tpu_torch.parallel import make_mesh
from gubernator_tpu_torch.parallel.mesh import shard_of
from gubernator_tpu_torch.types import Algorithm, Behavior, MINUTE

torch.set_num_threads(1)

T = 1_700_000_000_000
D = 4
GLOBAL = int(Behavior.GLOBAL)


def _knobs(**kw):
    base = dict(capacity_per_shard=1024, sync_out=16, route="host", dedup="host", a2a="ring",
                write_mode="sparse", wire="full", probe="xla", walk="xla")
    base.update(kw)
    return base


_COMPACT = dict(wire="compact", route="device", dedup="device")


class _Pkg:
    """One package's classes, so a scenario runs unchanged on either."""

    def __init__(self, name):
        if name == "jax":
            from gubernator_tpu.types import RateLimitRequest

            self.engine, self.batch, self.ops, self.gs = jg.GlobalShardedEngine, jb, je, jg
            self.mesh = jax_make_mesh(D)
        else:
            from gubernator_tpu_torch.types import RateLimitRequest

            self.engine, self.batch, self.ops, self.gs = tg.GlobalShardedEngine, tb, te, tg
            self.mesh = make_mesh(D, devices=["cpu"] * D)
        self.name = name
        self.Req = RateLimitRequest
        self.shared = {}

    def new(self, **kw):
        """A fresh engine. JAX engines are shared per knob set (module
        scope), so their compiled steps are reused: a shared engine's state
        is reset to that of a new one, its compile caches kept."""
        kw = _knobs(**kw)
        if self.name == "torch":
            return self.engine(self.mesh, **kw)
        key = tuple(sorted(kw.items()))
        eng = self.shared.get(key)
        if eng is None:
            eng = self.shared[key] = self.engine(self.mesh, **kw)
            return eng
        from gubernator_tpu.parallel.sharded import new_sharded_table

        eng.table = new_sharded_table(self.mesh, kw["capacity_per_shard"])
        eng.replica = None
        eng.stats = je.EngineStats()
        eng.global_stats = jg.GlobalStats()
        eng.pending = [jg.PendingHits() for _ in range(D)]
        eng._rr = 0
        eng.poisoned = None
        eng.a2a_overflow = 0
        return eng

    def req(self, key, hits=1, limit=100, behavior=GLOBAL, algorithm=Algorithm.TOKEN_BUCKET,
            created_at=T):
        return self.Req(name="glob", unique_key=key, hits=hits, limit=limit, duration=MINUTE,
                        algorithm=int(algorithm), behavior=int(behavior), created_at=created_at)


_PKGS = {}


def _pkg(name):
    if name not in _PKGS:
        _PKGS[name] = _Pkg(name)
    return _PKGS[name]


def _replica_bytes(eng):
    if eng.replica is None:
        return None
    if isinstance(eng.replica, list):
        return np.stack([t.rows.numpy() for t in eng.replica]).tobytes()
    return np.asarray(eng.replica.rows).tobytes()


def _state(eng):
    return (dataclasses.asdict(eng.stats), dataclasses.asdict(eng.global_stats),
            eng.snapshot().tobytes(), _replica_bytes(eng))


def _answers(responses):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in responses]


def _cols(rc):
    return tuple(np.asarray(getattr(rc, f)).tobytes() for f in rc._fields)


def _run(scenario, **kw):
    """Run `scenario(pkg, eng, obs)` on both packages; each appended
    observation must be equal."""
    runs = {}
    for name in ("jax", "torch"):
        pkg = _pkg(name)
        obs = []
        scenario(pkg, pkg.new(**kw), obs)
        runs[name] = obs
    want, got = runs["jax"], runs["torch"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"observation {i} differs"
    return got


def owner_of(key: str) -> int:
    return int(shard_of(np.array([fingerprint("glob", key)], dtype=np.int64), D)[0])


def non_owner_of(key: str) -> int:
    return (owner_of(key) + 1) % D


# ------------------------------------------------ the cases of test_global


def _flow(pkg, eng, obs):
    key = "gk1"
    home = non_owner_of(key)
    for _ in range(5):
        obs.append(_answers(eng.check([pkg.req(key)], now_ms=T, home_shard=home)))
    obs.append(_state(eng))
    eng.sync(now_ms=T)
    obs.append(_state(eng))
    obs.append(_answers(eng.check([pkg.req(key, hits=0, behavior=0)], now_ms=T)))
    for h in range(D):
        obs.append(_answers(eng.check([pkg.req(key, hits=0)], now_ms=T, home_shard=h)))
    obs.append(_state(eng))


def _over_limit(pkg, eng, obs):
    key = "gk-over"
    home = non_owner_of(key)
    for _ in range(2):
        obs.append(_answers(eng.check([pkg.req(key, hits=3, limit=5)], now_ms=T,
                                      home_shard=home)))
        eng.sync(now_ms=T)
        obs.append(_state(eng))
    for h in range(D):
        obs.append(_answers(eng.check([pkg.req(key, hits=0, limit=5)], now_ms=T,
                                      home_shard=h)))
    obs.append(_answers(eng.check([pkg.req(key, hits=1, limit=5)], now_ms=T, home_shard=home)))
    obs.append(_state(eng))


def _multi_home(pkg, eng, obs):
    key = "gk-multi"
    for h in [h for h in range(D) if h != owner_of(key)]:
        obs.append(_answers(eng.check([pkg.req(key, hits=2)], now_ms=T, home_shard=h)))
    eng.sync(now_ms=T)
    obs.append(_answers(eng.check([pkg.req(key, hits=0, behavior=0)], now_ms=T)))
    obs.append(_state(eng))


def _leaky(pkg, eng, obs):
    key = "gk-leaky"
    leaky = Algorithm.LEAKY_BUCKET
    obs.append(_answers(eng.check([pkg.req(key, hits=4, limit=10, algorithm=leaky)], now_ms=T,
                                  home_shard=non_owner_of(key))))
    eng.sync(now_ms=T)
    for h in range(D):
        obs.append(_answers(eng.check([pkg.req(key, hits=0, limit=10, algorithm=leaky)],
                                      now_ms=T, home_shard=h)))
    obs.append(_state(eng))


def _zero_hit(pkg, eng, obs):
    obs.append(_answers(eng.check([pkg.req("gk-z", hits=0)], now_ms=T, home_shard=1)))
    obs.append(_state(eng))


def _mixed(pkg, eng, obs):
    reqs = [pkg.req("gm1"), pkg.req("plain1", limit=7, behavior=0), pkg.req("gm2")]
    obs.append(_answers(eng.check(reqs, now_ms=T, home_shard=2)))
    obs.append(_state(eng))


@pytest.mark.parametrize("scenario", [_flow, _over_limit, _multi_home, _leaky, _zero_hit,
                                      _mixed], ids=lambda f: f.__name__.strip("_"))
def test_global_cases_match_jax(scenario):
    got = _run(scenario)
    assert got  # every scenario observed something


def test_global_answers_converge():
    """The port's own reading of test_global's assertions (the parity above
    holds it to JAX; this holds both to the reference's contract)."""
    pkg = _pkg("torch")
    eng = pkg.new()
    key = "gk1"
    for _ in range(5):
        (r,) = eng.check([pkg.req(key)], now_ms=T, home_shard=non_owner_of(key))
        assert r.status == 0
    assert eng.global_stats.hits_queued == 5 and eng.global_stats.send_queue_length == 1
    eng.sync(now_ms=T)
    gs = eng.global_stats
    assert (gs.sync_rounds, gs.broadcasts_applied, gs.updates_installed) == (1, 1, D - 1)
    (r,) = eng.check([pkg.req(key, hits=0, behavior=0)], now_ms=T)
    assert r.remaining == 95
    for h in range(D):
        (r,) = eng.check([pkg.req(key, hits=0)], now_ms=T, home_shard=h)
        assert r.remaining == 95, h


def test_replica_pass_decides_on_its_home_shard_only(monkeypatch):
    """A GLOBAL replica pass pins every row to its home: only that shard's
    block is staged and only its replica decided (the other shards would
    walk all-inactive rows and change nothing)."""
    from gubernator_tpu_torch.parallel import sharded as ts

    pkg = _pkg("torch")
    eng = pkg.new()
    staged, ran = [], []
    decide, impl = eng._decide, ts.decide2_packed_cols_impl

    def spy_decide(tables, st):
        staged.append((tables is eng.replica, st.shards, len(st.dev)))
        return decide(tables, st)

    def spy_impl(table, block, **kw):
        ran.append(next(d for d, t in enumerate(eng.replica) if t is table))
        return impl(table, block, **kw)

    monkeypatch.setattr(eng, "_decide", spy_decide)
    monkeypatch.setattr(ts, "decide2_packed_cols_impl", spy_impl)
    key = "gk1"
    home = non_owner_of(key)
    (r,) = eng.check([pkg.req(key, hits=3)], now_ms=T, home_shard=home)
    assert (r.status, r.remaining) == (0, 97)
    assert staged == [(True, (home,), 1)] and ran == [home]


# ------------------------------------- contended traffic, rounds and wires


def _contended(steps=2, n=96, pool=80, seed=7):
    def scenario(pkg, eng, obs):
        rng = np.random.default_rng(seed)
        reset = int(Behavior.RESET_REMAINING)
        drain = int(Behavior.DRAIN_OVER_LIMIT)
        for step in range(steps):
            keys = rng.integers(0, pool, n)
            hits = rng.integers(0, 6, n)
            algos = rng.integers(0, 5, n)
            glob = rng.random(n) < 0.75
            extra = np.where(rng.random(n) < 0.1, reset, 0) | np.where(rng.random(n) < 0.2,
                                                                         drain, 0)
            beh = np.where(glob, GLOBAL, 0) | extra
            reqs = [pkg.req(f"c{k}", hits=int(h), limit=int(5 + k % 7), behavior=int(b),
                            algorithm=int(a))
                    for k, h, a, b in zip(keys, hits, algos, beh)]
            obs.append(_answers(eng.check(reqs, now_ms=T + step, home_shard=step % D)))
            cols = pkg.batch.columns_from_requests(reqs[: n // 2])
            obs.append(_cols(eng.check_columns(cols, now_ms=T + step)))
            obs.append(_state(eng))
            if step % 2:
                eng.sync(now_ms=T + step)
                obs.append(_state(eng))
    return scenario


@pytest.mark.parametrize("wire", ["full", "compact"])
def test_contended_traffic_and_sync_match_jax(wire):
    """Many-round drains of full-width and of compact outboxes."""
    _run(_contended(), **(_COMPACT if wire == "compact" else {}))


def _pipelined(pkg, eng, obs):
    reqs = ([pkg.req(f"pk{i}", behavior=0) for i in range(4)]
            + [pkg.req(f"gk{i}") for i in range(6)]
            + [pkg.req("gk0", hits=2), pkg.req("pk0", behavior=0)])
    cols = pkg.batch.columns_from_requests(reqs)
    for step in range(3):
        pending = pkg.ops.prepare_check_columns(eng, cols, now_ms=T + step)
        obs.append(isinstance(pending, pkg.gs.GlobalPending))
        pending = pkg.ops.issue_check_columns(eng, pending)
        rc, delta = pkg.ops.finish_check_columns(eng, pending, lambda fn: fn())
        eng.stats.merge(delta)
        obs.append(_cols(rc))
        obs.append(_state(eng))
    pure = pkg.batch.columns_from_requests([pkg.req(f"k{i}", behavior=0) for i in range(4)])
    obs.append(type(pkg.ops.prepare_check_columns(eng, pure, now_ms=T)).__name__)
    eng.sync(now_ms=T + 3)
    obs.append(_state(eng))


@pytest.mark.parametrize("dedup", ["host", "device"])
def test_pipelined_hooks_match_jax(dedup):
    """dedup "device" runs with device routing and compact outboxes."""
    _run(_pipelined, **(_COMPACT if dedup == "device" else {}))


def test_pipelined_hooks_match_serial_path():
    """The port's pipelined hooks against its own serial check_columns on a
    twin engine: responses, queue state and counters."""
    pkg = _pkg("torch")
    reqs = ([pkg.req(f"pk{i}", behavior=0) for i in range(4)]
            + [pkg.req(f"gk{i}") for i in range(6)]
            + [pkg.req("gk0", hits=2), pkg.req("pk0", behavior=0)])
    cols = tb.columns_from_requests(reqs)
    serial, piped = pkg.new(), pkg.new()
    rc_serial = serial.check_columns(cols, now_ms=T)
    pending = te.issue_check_columns(piped, te.prepare_check_columns(piped, cols, now_ms=T))
    rc_piped, delta = te.finish_check_columns(piped, pending, lambda fn: fn())
    piped.stats.merge(delta)
    assert _cols(rc_piped) == _cols(rc_serial)
    for ps, pp in zip(serial.pending, piped.pending):
        assert len(ps) == len(pp)
        if len(ps):
            np.testing.assert_array_equal(ps.hb.fp, pp.hb.fp)
            np.testing.assert_array_equal(ps.hits, pp.hits)
    assert dataclasses.asdict(serial.stats) == dataclasses.asdict(piped.stats)
    serial.sync(now_ms=T)
    piped.sync(now_ms=T)
    assert _state(serial)[1:] == _state(piped)[1:]


def _drain_vs_rounds(fused):
    def scenario(pkg, eng, obs):
        for batch in range(3):
            reqs = [pkg.req(f"fk{batch}_{i}", hits=2) for i in range(64)]
            obs.append(_cols(eng.check_columns(pkg.batch.columns_from_requests(reqs),
                                               now_ms=T)))
        obs.append(_state(eng))
        if fused:
            eng.sync(now_ms=T)
        else:
            while eng.has_pending():
                eng._sync_round(now_ms=T)  # one round a call
        obs.append(_state(eng))
        for h in range(D):
            obs.append(_answers(eng.check([pkg.req("fk1_3", hits=0)], now_ms=T,
                                          home_shard=h)))
    return scenario


@pytest.mark.parametrize("wire", ["full", "compact"])
def test_fused_drain_matches_jax_and_single_rounds(wire):
    """A deep backlog drains in one call of several rounds (JAX: its fused
    step); the same traffic drained round by round leaves the same tables
    and reconcile counters (sync_rounds counts rounds that carried work)."""
    kw = _COMPACT if wire == "compact" else {}
    fused = _run(_drain_vs_rounds(True), **kw)
    rounds = _run(_drain_vs_rounds(False), **kw)
    assert fused[4][1]["sync_rounds"] == 4 and rounds[4][1]["sync_rounds"] == 4
    assert fused[4][1:] == rounds[4][1:]  # GlobalStats and both tables


def _warm_then_serve(pkg, eng, obs):
    if pkg.name == "torch":
        # JAX's own test pins that warming leaves its engine as new; the
        # port's warmed engine is held to an unwarmed JAX engine
        snap = eng.snapshot().tobytes()
        eng.warm_sync_steps(now_ms=T)
        assert eng.global_stats.sync_rounds == 1  # one round, its outboxes empty
        assert eng.snapshot().tobytes() == snap and not any(r.rows.any() for r in eng.replica)
        eng.global_stats = pkg.gs.GlobalStats()
    key = "wk1"
    for _ in range(3):
        eng.check([pkg.req(key)], now_ms=T, home_shard=non_owner_of(key))
    eng.sync(now_ms=T)
    obs.append(_answers(eng.check([pkg.req(key, hits=0)], now_ms=T, home_shard=owner_of(key))))
    obs.append(_state(eng))


def test_warm_sync_steps_change_nothing():
    got = _run(_warm_then_serve)
    assert got[0][0][2] == 97 and got[1][1]["broadcasts_applied"] == 1


# ------------------------------------------------------ failure and Store


def _dead(*_a, **_k):
    raise RuntimeError("sync launch died")


@pytest.mark.parametrize("wire", ["full", "compact"])
def test_sync_launch_failure_requeues_hits_and_poisons(wire, monkeypatch):
    """A round that dies after the accumulators were popped loses no hit:
    the popped boxes re-merge, the engine is poisoned, and a healthy round
    afterwards drains to the JAX engine's state. The port's launch is the
    module's ``sync_round``; JAX's, the engine's compiled steps."""

    def scenario(pkg, eng, obs):
        for i in range(6):
            eng.check([pkg.req(f"rq{i}", hits=2)], now_ms=T, home_shard=i % D)
        before = [(len(p), sorted(zip(p.hb.fp.tolist(), p.hits.tolist()))) if len(p) else (0,)
                  for p in eng.pending]
        eng._ensure_global_plane()
        with monkeypatch.context() as m:
            if pkg.name == "torch":
                m.setattr(tg, "sync_round", _dead)
            else:
                m.setattr(eng, "_sync_step", _dead)
                m.setattr(eng, "_sync_step_wire", _dead)
            with pytest.raises(RuntimeError):
                eng._sync_round(now_ms=T)
        after = [(len(p), sorted(zip(p.hb.fp.tolist(), p.hits.tolist()))) if len(p) else (0,)
                 for p in eng.pending]
        assert after == before
        assert eng.poisoned is not None and "sync" in eng.poisoned
        obs.append(after)
        obs.append(_state(eng))
        eng.sync(now_ms=T)
        obs.append(_state(eng))

    got = _run(scenario, **(_COMPACT if wire == "compact" else {}))
    assert got[2][1]["send_queue_length"] == 0 and got[2][1]["broadcasts_applied"] == 6


def test_fused_launch_failure_requeues_every_round(monkeypatch):
    """A drain pops all its rounds before the first launch; a failure
    re-merges every one of them."""
    pkg = _pkg("torch")
    eng = pkg.new()
    for batch in range(3):
        reqs = [pkg.req(f"ff{batch}_{i}", hits=1 + i % 3) for i in range(64)]
        eng.check_columns(tb.columns_from_requests(reqs), now_ms=T)
    queued = {int(f): int(h) for p in eng.pending if len(p) for f, h in zip(p.hb.fp, p.hits)}
    assert max(len(p) for p in eng.pending) > 16  # a drain of several rounds
    monkeypatch.setattr(tg, "sync_round", _dead)
    with pytest.raises(RuntimeError):
        eng.sync(now_ms=T)
    after = {int(f): int(h) for p in eng.pending if len(p) for f, h in zip(p.hb.fp, p.hits)}
    assert after == queued and eng.poisoned is not None


def test_store_is_accepted_by_both_mesh_engines():
    from gubernator_tpu_torch.store import RecordingStore

    pkg = _pkg("torch")
    for cls in (tg.GlobalShardedEngine, tg.ShardedEngine):
        store = RecordingStore()
        eng = cls(pkg.mesh, capacity_per_shard=1024, store=store)
        assert eng.store is store
        (r,) = eng.check([pkg.req("st", hits=3, behavior=0)], now_ms=T)
        assert r.remaining == 97
        assert [c.remaining.tolist() for c in store.changes] == [[97]]


# ------------------------------------------------------------ PendingHits


def _host_batch(mod, rng, n, pool):
    fp = rng.choice(pool, n)
    cols = mod.RequestColumns(
        fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
        behavior=(GLOBAL | np.where(rng.random(n) < 0.2, int(Behavior.RESET_REMAINING), 0))
        .astype(np.int32),
        hits=rng.integers(0, 9, n).astype(np.int64), limit=rng.integers(1, 50, n),
        burst=np.zeros(n, np.int64), duration=rng.integers(1, 9, n).astype(np.int64) * 1000,
        created_at=T + rng.integers(-5, 5, n), err=np.zeros(n, np.int8))
    return mod.pack_columns(cols, T)[0]


def test_pending_hits_merge_and_take_match_jax():
    rng = np.random.default_rng(3)
    pool = rng.integers(1, 2**63 - 1, 40, dtype=np.int64)
    pj, pt = jg.PendingHits(), tg.PendingHits()
    for step in range(6):
        n = int(rng.integers(5, 60))
        seed = int(rng.integers(1 << 30))
        hbj = _host_batch(jb, np.random.default_rng(seed), n, pool)
        hbt = _host_batch(tb, np.random.default_rng(seed), n, pool)
        rows = np.sort(rng.choice(n, int(rng.integers(1, n + 1)), replace=False))
        hits = rng.integers(0, 7, rows.size).astype(np.int64)
        reset = (hbj.behavior[rows] & int(Behavior.RESET_REMAINING)).astype(np.int32)
        pj.merge(hbj, rows, hits, reset)
        pt.merge(hbt, rows, hits, reset)
        assert len(pt) == len(pj)
        for a, b in zip(pt.hb, pj.hb):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pt.hits, pj.hits)
        np.testing.assert_array_equal(pt.reset, pj.reset)
        if step % 2:
            k = int(rng.integers(1, 12))
            (cj, hj, rj), (ct, ht, rt) = pj.take(k), pt.take(k)
            for a, b in zip(ct, cj):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ht, hj)
            np.testing.assert_array_equal(rt, rj)
            ht[:] = -1  # popped columns are copies: the remainder is untouched
            assert len(pt) == len(pj) and (len(pt) == 0 or (pt.hits >= 0).all())
    pt.take(len(pt))
    assert len(pt) == 0 and pt.oldest_ts is None and pt.age_s() == 0.0


def test_pack_requests_matches_jax():
    from gubernator_tpu.types import RateLimitRequest as JReq
    from gubernator_tpu_torch.types import RateLimitRequest as TReq

    rng = np.random.default_rng(9)
    specs = []
    for i in range(40):
        specs.append(dict(
            name="" if i == 3 else "n", unique_key="" if i == 5 else f"k{i}",
            hits=int(rng.integers(0, 5)), limit=2**31 if i == 7 else int(rng.integers(1, 99)),
            burst=int(rng.integers(0, 3)), duration=MINUTE if i % 9 else 3,
            algorithm=int(rng.integers(0, 5)) if i != 11 else 99,
            behavior=int(Behavior.DURATION_IS_GREGORIAN) if i % 9 == 0 else 0,
            created_at=T + int(rng.integers(-10**6, 10**6)) if i % 4 else None))
    hj, ej = jb.pack_requests([JReq(**s) for s in specs], T, pad_to=48, tolerance_ms=1000)
    ht, et = tb.pack_requests([TReq(**s) for s in specs], T, pad_to=48, tolerance_ms=1000)
    assert et == ej
    for a, b in zip(ht, hj):
        np.testing.assert_array_equal(a, b)
    assert tb.created_at_tolerance_ms() == tb.CREATED_AT_TOLERANCE_MS == jb.CREATED_AT_TOLERANCE_MS

"""Port parity: the mesh engine — ``ShardedEngine(make_mesh(D, devices=
["cpu"] * D))`` of gubernator_tpu_torch.parallel — against the JAX
package's ``ShardedEngine(make_mesh(D))`` on the 8-device CPU mesh.

Every case passes route, dedup, a2a, write_mode, wire and probe explicitly
to both engines (the packages' defaults differ off the TPU) and compares,
after each step: responses (status, limit, remaining, reset, error),
EngineStats, ``a2a_overflow`` and the raw ``snapshot()`` bytes (the
(D, NB, 128) int32 tables, not a canonical form). Covered: three steps of
``test_ring_exchange.mixed_corpus`` for route × dedup × a2a at D = 4 and a
compact-wire case; the Zipf and hot-shard overflow batches of
``test_ring_zipf_overflow_parity`` at D = 8, whose last retry routes on the
host; the pipelined prepare / issue / finish path; and a JAX snapshot
restored into the port, then both engines stepped on. JAX's engines are
shared through module-scoped caches. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import engine as je
from gubernator_tpu.parallel import ShardedEngine as JaxSharded
from gubernator_tpu.parallel import make_mesh as jax_make_mesh
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.parallel import ShardedEngine, make_mesh
from tests.test_ring_exchange import mixed_corpus, req

torch.set_num_threads(1)

T = 1_700_000_000_000


def _knobs(**kw):
    base = dict(capacity_per_shard=2048, route="device", dedup="device", a2a="ring",
                write_mode="sparse", wire="full", probe="xla")
    base.update(kw)
    return base


def _pair(D, **kw):
    kw = _knobs(**kw)
    return JaxSharded(jax_make_mesh(D), **kw), ShardedEngine(make_mesh(D, devices=["cpu"] * D),
                                                             **kw)


def _answers(responses):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in responses]


def _state(eng):
    return (dataclasses.asdict(eng.stats), eng.a2a_overflow, eng.snapshot().tobytes())


def _assert_same(jax_eng, port_eng, ctx):
    js, tst = _state(jax_eng), _state(port_eng)
    assert tst[0] == js[0], f"{ctx}: stats {tst[0]} != {js[0]}"
    assert tst[1] == js[1], f"{ctx}: a2a_overflow {tst[1]} != {js[1]}"
    assert tst[2] == js[2], f"{ctx}: table bytes differ"


_JAX_RUNS = {}


def _jax_run(route, dedup, wire):
    """Three mixed_corpus steps through one JAX mesh engine (a2a "ring"):
    the answers and the state after each step, computed once per module."""
    key = (route, dedup, wire)
    if key not in _JAX_RUNS:
        eng = JaxSharded(jax_make_mesh(4), **_knobs(route=route, dedup=dedup, wire=wire))
        rng = np.random.default_rng(41)
        steps = []
        for step in range(3):
            reqs = mixed_corpus(rng, T, step, n=160)
            steps.append((reqs, _answers(eng.check(reqs, now_ms=T + step)), _state(eng)))
        _JAX_RUNS[key] = (steps, eng.stage_ms["wire_pack"] > 0)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("route,dedup,a2a,wire", [
    (route, dedup, a2a, "full")
    for route in ("host", "device") for dedup in ("host", "device")
    for a2a in ("ring", "collective")
] + [("device", "device", "ring", "compact"), ("host", "device", "ring", "compact")])
def test_mesh_matches_jax(route, dedup, a2a, wire):
    steps, jax_compact = _jax_run(route, dedup, wire)
    eng = ShardedEngine(make_mesh(4, devices=["cpu"] * 4),
                        **_knobs(route=route, dedup=dedup, a2a=a2a, wire=wire))
    for step, (reqs, want, state) in enumerate(steps):
        assert _answers(eng.check(reqs, now_ms=T + step)) == want, f"step {step}"
        got = _state(eng)
        assert got[:2] == state[:2], f"step {step}: {got[:2]} != {state[:2]}"
        assert got[2] == state[2], f"step {step}: table bytes differ"
    assert (eng.stage_ms["wire_pack"] > 0) == jax_compact == (wire == "compact")


def _hot_shard_keys(n, D):
    from gubernator_tpu.hashing import fingerprint
    from gubernator_tpu_torch.parallel.mesh import shard_of

    keys, i = [], 0
    while len(keys) < n:
        if int(shard_of(np.int64(fingerprint("ring", f"h{i}")), D)) == 0:
            keys.append(f"h{i}")
        i += 1
    return keys


def test_zipf_and_hot_shard_overflow_match_jax(monkeypatch):
    """Zipf duplicate traffic, then 800 distinct keys owned by shard 0 of 8:
    every source block overflows its pair capacity (sigma 0: mean + 8 rows),
    the retries overflow again, and the last retry routes on the host."""
    monkeypatch.setenv("GUBER_A2A_CAPACITY_SIGMA", "0")
    j, t = _pair(8, capacity_per_shard=4096)
    host_routed = []
    stage = t._stage
    t._stage = lambda batch, shard: (host_routed.append(shard is not None),
                                     stage(batch, shard))[1]
    rng = np.random.default_rng(17)
    z = np.minimum(rng.zipf(1.1, size=2048) - 1, 1023)
    reqs = [req(f"z{k}", hits=1, limit=1 << 20, created_at=T) for k in z]
    assert _answers(t.check(reqs, now_ms=T)) == _answers(j.check(reqs, now_ms=T))
    _assert_same(j, t, "zipf")
    reqs = [req(k, hits=1, limit=1 << 20, created_at=T) for k in _hot_shard_keys(800, 8)]
    got = _answers(t.check(reqs, now_ms=T))
    assert got == _answers(j.check(reqs, now_ms=T))
    assert all(g[4] == "" for g in got)
    _assert_same(j, t, "hot shard")
    assert t.a2a_overflow > 0 and host_routed[-1] and not host_routed[0]
    assert t.take_a2a_overflow_delta() == ("ring", t.a2a_overflow)
    assert t.take_a2a_overflow_delta() == ("ring", 0)


def test_pipelined_path_matches_jax(monkeypatch):
    """prepare / issue / finish_check_columns of ops/engine.py serving a
    mesh, with repeated keys (host dedup: several passes) and hot-shard
    overflow (sigma 0) retried through the fixup."""
    from gubernator_tpu.ops import batch as jb
    from gubernator_tpu_torch.ops import batch as tb

    monkeypatch.setenv("GUBER_A2A_CAPACITY_SIGMA", "0")
    j, t = _pair(4, dedup="host")
    rng = np.random.default_rng(5)
    hot = _hot_shard_keys(200, 4)
    for step in range(2):
        reqs = mixed_corpus(rng, T, step, n=120) + [
            req(k, hits=1, limit=100, created_at=T + step) for k in hot[step * 100:][:100]]
        jc, tc = jb.columns_from_requests(reqs), tb.columns_from_requests(reqs)
        jp = je.issue_check_columns(j, je.prepare_check_columns(j, jc, now_ms=T + step))
        jrc, jd = je.finish_check_columns(j, jp, lambda fn: fn())
        j.stats.merge(jd)
        tp = te.issue_check_columns(t, te.prepare_check_columns(t, tc, now_ms=T + step))
        trc, td = te.finish_check_columns(t, tp, lambda fn: fn())
        t.stats.merge(td)
        for f in trc._fields:
            np.testing.assert_array_equal(getattr(trc, f), getattr(jrc, f), err_msg=f)
        _assert_same(j, t, f"pipelined step {step}")
    assert t.a2a_overflow > 0


def test_jax_snapshot_restores_into_the_port():
    """State carried across: a JAX mesh's snapshot restores into the port
    byte for byte, both step on equal, and the port's restores into JAX."""
    j, t = _pair(4, dedup="host", route="host")
    rng = np.random.default_rng(23)
    j.check(mixed_corpus(rng, T, 0, n=160), now_ms=T)
    t.restore(j.snapshot())
    assert t.snapshot().tobytes() == j.snapshot().tobytes()
    reqs = mixed_corpus(rng, T, 1, n=160)
    assert _answers(t.check(reqs, now_ms=T + 1)) == _answers(j.check(reqs, now_ms=T + 1))
    assert t.snapshot().tobytes() == j.snapshot().tobytes()
    j2 = JaxSharded(jax_make_mesh(4), **_knobs(dedup="host", route="host"))
    j2.restore(t.snapshot())
    reqs = mixed_corpus(rng, T, 2, n=160)
    assert _answers(j2.check(reqs, now_ms=T + 2)) == _answers(t.check(reqs, now_ms=T + 2))
    assert t.snapshot().tobytes() == j2.snapshot().tobytes()


def test_nine_shard_ring_matches_collective():
    """A mesh wider than one exchange launch (9 shards; JAX's CPU mesh here
    has 8 devices): device routing over the ring exchange serves
    mixed_corpus exactly as the same engine over the collective exchange —
    responses, stats, a2a_overflow and snapshot bytes, step by step."""
    engines = [ShardedEngine(make_mesh(9, devices=["cpu"] * 9), **_knobs(a2a=a2a))
               for a2a in ("ring", "collective")]
    rng = np.random.default_rng(3)
    for step in range(2):
        reqs = mixed_corpus(rng, T, step, n=160)
        ring, coll = (_answers(e.check(reqs, now_ms=T + step)) for e in engines)
        assert ring == coll, f"step {step}"
        assert all(a[4] == "" for a in ring)
        assert _state(engines[0]) == _state(engines[1]), f"step {step}"

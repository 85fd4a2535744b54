"""Port parity through the service: the JAX package's
``service/runner.EngineRunner`` drives a port engine
(gubernator_tpu_torch.ops.engine.LocalEngine on the CPU) and a JAX engine
through the same sequence of the maintenance calls it makes — serial
checks, ``live_count``, ``table_telemetry``, ``snapshot``,
``tier_demote_idle`` (extract_idle + tombstone_fps in one engine job, rows
unpacked on the host), ``checkpoint_extract`` and ``checkpoint_snapshot``
with an epoch tracker attached, ``extract_live``, ``merge_rows``,
``tombstone_fps``, ``read_state`` and ``read_state_raw``, ``maybe_grow``
and ``snapshot_sync`` — on each slot layout. Every result, EngineStats and
the table bytes must be equal. Tolerance: exact.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import checkpoint as jck
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.service.runner import EngineRunner
from gubernator_tpu_torch.ops import checkpoint as tck
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine

torch.set_num_threads(1)

NOW = 1_700_000_000_000
ALGOS = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}


def _plain(x):
    """A comparable form of one runner result."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "to_dict"):  # a TableSnapshot of either package
        d = x.to_dict()
        d.pop("scan_ms")
        return d
    if hasattr(x, "F") and hasattr(x, "code"):  # a SlotLayout of either package
        return ("layout", x.name)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


async def _drive(runner, cols_cls, layout, seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63 - 1, 1500, dtype=np.int64)
    out = []
    now = NOW
    for _ in range(3):
        n = 512
        c = dict(fp=rng.choice(pool, n, replace=False),
                 algo=rng.choice(ALGOS[layout], n).astype(np.int32),
                 behavior=np.zeros(n, np.int32), hits=rng.integers(0, 4, n).astype(np.int64),
                 limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
                 duration=rng.integers(1, 40, n).astype(np.int64) * 3_600_000,
                 created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
        out.append(await runner.check_columns(cols_cls(**c), now_ms=now))
        now += int(rng.integers(1_000, 9_000))
    out.append(await runner.live_count())
    out.append(await runner.table_telemetry(now_ms=now))
    out.append(await runner.snapshot())
    out.append(await runner.tier_demote_idle(5_000, max_rows=100, now_ms=now))
    out.append(await runner.checkpoint_extract(now_ms=now))
    out.append(await runner.checkpoint_extract(now_ms=now))  # empty epoch
    out.append(await runner.checkpoint_snapshot())
    fps, slots = await runner.extract_live(now_ms=now)
    out += [fps, slots]
    # a transfer back under new keys, half of them repeated (two passes)
    new = rng.integers(1, 2**63 - 1, 64, dtype=np.int64)
    ms = slots[:64].copy()
    ms[:, 0] = (new & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ms[:, 1] = (new >> 32).astype(np.int32)
    out.append(await runner.merge_rows(np.concatenate([new, new[:32]]),
                                       np.concatenate([ms, ms[:32]]), now_ms=now))
    gone = np.concatenate([fps[:40], new[:8], [np.int64(7)]])
    out.append(await runner.tombstone_fps(gone))
    probe = np.concatenate([fps[30:90], new, [np.int64(7)]])
    out.append(await runner.read_state(probe))
    out.append(await runner.read_state_raw(probe))
    out.append(await runner.checkpoint_extract(now_ms=now))
    out.append(await runner.maybe_grow(threshold=0.05, now_ms=now))
    out.append(await runner.live_count())
    out.append(runner.snapshot_sync())
    return out


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
def test_runner_maintenance_calls_match(layout):
    j = JaxEngine(capacity=1 << 12, write_mode="xla", wire="full", layout=layout)
    t = TorchEngine(capacity=1 << 12, write_mode="xla", layout=layout, device="cpu")
    j.ckpt = jck.EpochTracker(j.table.n_buckets)
    t.ckpt = tck.EpochTracker(t.table.n_buckets)
    results = []
    for eng, cols_cls in ((j, JCols), (t, TCols)):
        runner = EngineRunner(eng, fetch_workers=2)
        try:
            results.append(asyncio.run(_drive(runner, cols_cls, layout, seed=17)))
        finally:
            runner.close()
    want, got = results
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _plain(a) == _plain(b), i
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.table.capacity == j.table.capacity == 1 << 13  # maybe_grow doubled it
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()
    assert t.ckpt.epoch == j.ckpt.epoch == 3


async def _drive_global(runner, eng, pkg, seed):
    """The runner's GLOBAL calls on a mesh engine: pipelined checks (the
    engine's prepare / issue / finish hooks), serial checks, sync_global,
    install_columns, then every maintenance call."""
    from gubernator_tpu.types import Behavior

    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63 - 1, 600, dtype=np.int64)
    out = []
    now = NOW
    for step in range(2):
        n = 160
        glob = rng.random(n) < 0.6
        c = dict(fp=rng.choice(pool, n), algo=rng.integers(0, 5, n).astype(np.int32),
                 behavior=np.where(glob, int(Behavior.GLOBAL), 0).astype(np.int32),
                 hits=rng.integers(0, 4, n).astype(np.int64),
                 limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
                 duration=rng.integers(1, 40, n).astype(np.int64) * 3_600_000,
                 created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
        cols = pkg.RequestColumns(**c)
        if step % 2:
            rc = await runner.check_columns(cols, now_ms=now)
        else:
            # every row GLOBAL: the engine's own pending type
            cols = cols._replace(behavior=np.full(n, int(Behavior.GLOBAL), np.int32))
            rc = await runner.check(cols, now_ms=now)
        out.append(tuple(getattr(rc, f) for f in rc._fields))
        await runner.sync_global()
        out.append(dataclasses.asdict(eng.global_stats))
    m = 48
    fps = rng.choice(pool, m, replace=False)
    out.append(await runner.install_columns(
        fp=fps, algo=rng.integers(0, 5, m).astype(np.int32),
        status=np.zeros(m, np.int32), limit=np.full(m, 20, np.int64),
        remaining=rng.integers(0, 20, m).astype(np.int64),
        reset_time=np.full(m, now + 60_000, np.int64), duration=np.full(m, 60_000, np.int64),
        now_ms=now))
    out.append(await runner.live_count())
    out.append(await runner.table_telemetry(now_ms=now))
    out.append(await runner.snapshot())
    out.append(await runner.tier_demote_idle(1, max_rows=50, now_ms=now + 10))
    out.append(await runner.checkpoint_extract(now_ms=now))
    out.append(await runner.checkpoint_snapshot())
    fps_l, slots_l = await runner.extract_live(now_ms=now)
    out += [fps_l, slots_l]
    out.append(await runner.merge_rows(fps_l[:32], slots_l[:32], now_ms=now))
    out.append(await runner.tombstone_fps(np.concatenate([fps_l[:20], [np.int64(7)]])))
    out.append(await runner.read_state(fps_l[10:50]))
    out.append(await runner.read_state_raw(fps_l[10:50]))
    out.append(await runner.maybe_grow(threshold=0.01, now_ms=now))
    out.append(runner.snapshot_sync())
    return out


def test_runner_drives_global_mesh_engine(monkeypatch):
    """The JAX EngineRunner drives a port GlobalShardedEngine beside a JAX
    one (4-shard CPU meshes, every knob named): GLOBAL and mixed checks,
    sync_global, install_columns and every maintenance call; results,
    EngineStats, GlobalStats and the primary and replica bytes equal.
    sync_global stamps the sync with the clock, frozen here in both."""
    from gubernator_tpu.ops import batch as jb
    from gubernator_tpu.parallel import global_sync as jg
    from gubernator_tpu.parallel import make_mesh as jax_make_mesh
    from gubernator_tpu_torch.ops import batch as tb
    from gubernator_tpu_torch.parallel import global_sync as tg
    from gubernator_tpu_torch.parallel import make_mesh

    JaxGlobal, TorchGlobal = jg.GlobalShardedEngine, tg.GlobalShardedEngine
    for mod in (jg, tg):
        monkeypatch.setattr(mod, "ms_now", lambda: NOW + 500)

    kw = dict(capacity_per_shard=1 << 10, sync_out=64, route="host", dedup="host",
              a2a="ring", write_mode="sparse", wire="full", probe="xla", walk="xla")
    j = JaxGlobal(jax_make_mesh(4), **kw)
    t = TorchGlobal(make_mesh(4, devices=["cpu"] * 4), **kw)
    j.ckpt = jck.EpochTracker(j.table.n_buckets, n_shards=4)
    t.ckpt = tck.EpochTracker(t.table.n_buckets, n_shards=4)
    results = []
    for eng, pkg in ((j, jb), (t, tb)):
        runner = EngineRunner(eng, fetch_workers=2)
        try:
            results.append(asyncio.run(_drive_global(runner, eng, pkg, seed=23)))
        finally:
            runner.close()
    want, got = results
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _plain(a) == _plain(b), i
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert dataclasses.asdict(t.global_stats) == dataclasses.asdict(j.global_stats)
    assert t.snapshot().tobytes() == j.snapshot().tobytes()
    assert (np.stack([r.rows.numpy() for r in t.replica]).tobytes()
            == np.asarray(j.replica.rows).tobytes())
    assert t.ckpt.epoch == j.ckpt.epoch == 1


async def _drive_tier(runner, eng, cols_cls, seed):
    """The runner's demote-on-idle sweep (the tier manager's one engine
    job) into the engine's shadow, then checks that fault the demoted keys
    back through the merge."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**63 - 1, 600, dtype=np.int64)
    out = []
    now = NOW
    for i in range(3):
        n = 200
        c = dict(fp=keys[i * n:(i + 1) * n], algo=rng.integers(0, 5, n).astype(np.int32),
                 behavior=np.zeros(n, np.int32), hits=rng.integers(0, 4, n).astype(np.int64),
                 limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
                 duration=np.full(n, 3_600_000, np.int64), created_at=np.zeros(n, np.int64),
                 err=np.zeros(n, np.int8))
        rc = await runner.check_columns(cols_cls(**c), now_ms=now)
        out.append(tuple(getattr(rc, f) for f in rc._fields))
        now += 20_000
    at, fps, full = await runner.tier_demote_idle(30_000, max_rows=150, now_ms=now)
    out += [at, fps, full]
    eng.shadow.offer(fps, full, at, reason="idle")
    out.append(eng.shadow.stats())
    out.append(runner.snapshot_sync())
    c["fp"] = np.concatenate([fps[:100], keys[:20]])
    c = {k: (v[:120] if k != "fp" else v) for k, v in c.items()}
    rc = await runner.check_columns(cols_cls(**c), now_ms=now + 1)
    out.append(tuple(getattr(rc, f) for f in rc._fields))
    out.append(eng.shadow.stats())
    out.append(runner.snapshot_sync())
    return out


@pytest.mark.parametrize("mesh", [False, True])
def test_runner_tier_demote_idle_feeds_port_shadow(mesh):
    """The JAX EngineRunner's tier_demote_idle (extract_idle then
    tombstone_fps in one engine job, canonical rows out) on a port engine
    with the port's ShadowTable, beside a JAX engine with the JAX one:
    the fps, the rows, the table bytes after, and the fault-back of the
    demoted keys, on a LocalEngine and on a 4-shard ShardedEngine."""
    from gubernator_tpu.tier import ShadowTable as JShadow
    from gubernator_tpu_torch.tier import ShadowTable as TShadow

    if mesh:
        from gubernator_tpu.parallel import ShardedEngine as JSharded
        from gubernator_tpu.parallel import make_mesh as jax_make_mesh
        from gubernator_tpu_torch.parallel import ShardedEngine as TSharded
        from gubernator_tpu_torch.parallel import make_mesh

        kw = dict(capacity_per_shard=1 << 9, route="host", dedup="host", a2a="ring",
                  write_mode="sparse", wire="full", probe="xla", walk="xla")
        j = JSharded(jax_make_mesh(4), **kw)
        t = TSharded(make_mesh(4, devices=["cpu"] * 4), **kw)
        j.shadow, t.shadow = JShadow(max_bytes=1 << 20), TShadow(max_bytes=1 << 20)
    else:
        j = JaxEngine(capacity=1 << 11, write_mode="xla", wire="full")
        t = TorchEngine(capacity=1 << 11, write_mode="xla", device="cpu")
        j.attach_shadow(JShadow(max_bytes=1 << 20))
        t.attach_shadow(TShadow(max_bytes=1 << 20))
    results = []
    for eng, cols_cls in ((j, JCols), (t, TCols)):
        runner = EngineRunner(eng, fetch_workers=2)
        try:
            results.append(asyncio.run(_drive_tier(runner, eng, cols_cls, seed=31)))
        finally:
            runner.close()
    want, got = results
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _plain(a) == _plain(b), i
    assert got[4].shape[0] == 150 and got[5].shape == (150, 16)
    assert got[-2]["promoted"] >= 100
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)

"""Port parity: the mesh engine's peer plane and maintenance surface —
``ShardedEngine`` of gubernator_tpu_torch.parallel on a 4-shard CPU mesh
against the JAX package's ``ShardedEngine(make_mesh(4))``, on each slot
layout (full, gcra32, token32).

After contended traffic both engines, all knobs named, run the same
sequence: ``install_columns`` (owner-routed), ``merge_rows`` with repeated
fingerprints (two passes) and with ``collect=True``, ``read_state`` (also raw),
``tombstone_fps``, ``extract_live``, ``extract_idle`` under a cap,
a checkpoint epoch (``checkpoint_begin`` / ``checkpoint_finish`` with an
``EpochTracker`` of 4 shards), the telemetry scan (per-shard live counts
included), ``live_count``, ``maybe_grow``, the per-decision byte model and
an off-family install that migrates a packed table to full. Every return,
EngineStats and the raw table bytes must be equal. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import checkpoint as jck
from gubernator_tpu.ops import telemetry as jtel
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.parallel import ShardedEngine as JaxSharded
from gubernator_tpu.parallel import make_mesh as jax_make_mesh
from gubernator_tpu_torch.ops import checkpoint as tck
from gubernator_tpu_torch.ops import telemetry as ttel
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.parallel import ShardedEngine, make_mesh

torch.set_num_threads(1)

NOW = 1_700_000_000_000
D = 4
ALGOS = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}
KNOBS = dict(capacity_per_shard=1 << 10, route="host", dedup="host", a2a="ring",
             write_mode="sparse", wire="full", probe="xla", walk="xla")


def _plain(x):
    """A comparable form of one result."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "to_dict"):  # a TableSnapshot of either package
        d = x.to_dict()
        d.pop("scan_ms")
        return d
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _slot_rows(rng, slots, fps):
    """`slots` re-keyed to `fps` (canonical rows)."""
    out = slots.copy()
    out[:, 0] = (fps & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    out[:, 1] = (fps >> 32).astype(np.int32)
    return out


def _drive(eng, cols_cls, tel, layout, seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63 - 1, 1200, dtype=np.int64)
    out = []
    now = NOW
    for _ in range(3):
        n = 384
        c = dict(fp=rng.choice(pool, n, replace=False),
                 algo=rng.choice(ALGOS[layout], n).astype(np.int32),
                 behavior=np.zeros(n, np.int32), hits=rng.integers(0, 4, n).astype(np.int64),
                 limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
                 duration=rng.integers(1, 40, n).astype(np.int64) * 3_600_000,
                 created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
        rc = eng.check_columns(cols_cls(**c), now_ms=now)
        out.append(tuple(getattr(rc, f) for f in rc._fields))
        now += int(rng.integers(1_000, 9_000))
    out.append(eng.live_count(now))
    out.append(tel.finish_scan(eng.telemetry_begin(now)))
    # install: a family batch with sliding-window fidelity columns, keys
    # half held, half new
    m = 96
    fps = np.concatenate([rng.choice(pool, m // 2, replace=False),
                          rng.integers(1, 2**63 - 1, m // 2, dtype=np.int64)])
    algo = rng.choice(ALGOS[layout], m).astype(np.int32)
    lim = rng.integers(1, 50, m).astype(np.int64)
    kw = dict(fp=fps, algo=algo, status=rng.integers(0, 2, m).astype(np.int32), limit=lim,
              remaining=rng.integers(0, 50, m).astype(np.int64),
              reset_time=now + rng.integers(1, 10**6, m).astype(np.int64),
              duration=rng.integers(1, 9, m).astype(np.int64) * 60_000, now_ms=now)
    # (the runner test installs without the fidelity columns)
    out.append(eng.install_columns(**kw, burst=lim + 1, stamp=np.full(m, now - 5, np.int64),
                                   aux=rng.integers(0, 9, m).astype(np.int64),
                                   rem_store=rng.integers(0, 9, m).astype(np.int64)))
    fps_l, slots_l = eng.extract_live(now)
    out += [fps_l, slots_l]
    # a transfer back under new keys, each sent twice (two passes)
    new = rng.integers(1, 2**63 - 1, 60, dtype=np.int64)
    full = np.asarray(eng.read_state(fps_l[:60])[1])
    ms = _slot_rows(rng, full, new)
    out.append(eng.merge_rows(np.concatenate([new, new]), np.concatenate([ms, ms]),
                              now_ms=now))
    new2 = rng.integers(1, 2**63 - 1, 40, dtype=np.int64)
    out.append(eng.merge_rows(new2, _slot_rows(rng, full[:40], new2), now_ms=now,
                              collect=True))
    probe = np.concatenate([fps_l[30:90], new, [np.int64(7)]])
    out.append(eng.read_state(probe))
    out.append(eng.read_state(probe, raw=True))
    out.append(eng.read_state(np.empty(0, np.int64), raw=True))
    out.append(eng.tombstone_fps(np.concatenate([fps_l[:40], new[:8], fps_l[:3], [7]])))
    out.append(eng.extract_idle(now, 5_000, max_rows=150))
    epoch, gids = eng.ckpt.take()
    out += [epoch, gids, eng.checkpoint_finish(eng.checkpoint_begin(gids, now))]
    out.append(eng.hbm_bytes_per_decision_estimate())
    out.append(eng.maybe_grow(threshold=0.01))
    if layout != "full":  # off-family rows migrate the shards to full
        out.append(eng.install_columns(**{**kw, "algo": np.full(m, 1, np.int32)}))
        out.append(eng.table.layout.name)
    out.append(eng.live_count(now))
    out.append(tel.finish_scan(eng.telemetry_begin(now)))
    return out


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
def test_mesh_maintenance_matches_jax(layout):
    j = JaxSharded(jax_make_mesh(D), layout=layout, **KNOBS)
    t = ShardedEngine(make_mesh(D, devices=["cpu"] * D), layout=layout, **KNOBS)
    j.ckpt = jck.EpochTracker(j.table.n_buckets, n_shards=D)
    t.ckpt = tck.EpochTracker(t.table.n_buckets, n_shards=D)
    want = _drive(j, JCols, jtel, layout, seed=11)
    got = _drive(t, TCols, ttel, layout, seed=11)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _plain(a) == _plain(b), i
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.snapshot().tobytes() == j.snapshot().tobytes()
    assert t.table.layout.name == j.table.layout.name
    assert (t.table.n_buckets, t.table.capacity) == (j.table.n_buckets, j.table.capacity)
    assert got[4].per_shard_live is not None and len(got[4].per_shard_live) == D


def test_restore_marks_every_block_dirty():
    t = ShardedEngine(make_mesh(D, devices=["cpu"] * D), **KNOBS)
    t.ckpt = tck.EpochTracker(t.table.n_buckets, n_shards=D)
    t.restore(t.snapshot())
    assert t.ckpt.dirty_blocks == D * t.ckpt.nblk
    assert not t.supports_grow and t.maybe_grow() is False

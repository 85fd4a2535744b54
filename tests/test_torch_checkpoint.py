"""Port parity: incremental checkpoints (gubernator_tpu_torch.ops.checkpoint and
the LocalEngine hooks) against the JAX package.

Both packages' engines carry an EpochTracker and see the same mutations,
made from a seed, on each slot layout: serial checks, a pipelined check
(prepare → issue → finish), GLOBAL installs, merges and tombstones. After
each, the trackers' dirty bitmaps must be equal; then a take and the
dirty-block extract (begin / finish) must give the same epoch, block ids,
fingerprints and slots. A restore marks everything dirty; a resize
rebuilds the tracker on the new geometry. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import checkpoint as jck
from gubernator_tpu.ops import engine as je
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu_torch.ops import checkpoint as tck
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols

torch.set_num_threads(1)

NOW = 1_700_000_000_000
ALGOS = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}


def _cols(rng, pool, layout, n=256):
    return dict(
        fp=rng.choice(pool, n, replace=False),
        algo=rng.choice(ALGOS[layout], n).astype(np.int32),
        behavior=np.zeros(n, np.int32),
        hits=rng.integers(0, 4, n).astype(np.int64),
        limit=rng.integers(1, 9, n).astype(np.int64),
        burst=np.zeros(n, np.int64),
        duration=rng.integers(1, 30, n).astype(np.int64) * 1_000,
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )


def _same_dirty(jt, tt, ctx):
    np.testing.assert_array_equal(tt._dirty, jt._dirty, err_msg=ctx)
    assert (tt.epoch, tt.marked_fps, tt.blk, tt.nblk) == (jt.epoch, jt.marked_fps, jt.blk,
                                                          jt.nblk), ctx
    assert tt.dirty_blocks == jt.dirty_blocks, ctx


def _same_epoch(j, t, now, ctx):
    """take() + the extract on both engines: equal epoch, ids and rows."""
    ej, gj = j.ckpt.take()
    et, gt = t.ckpt.take()
    assert et == ej, ctx
    np.testing.assert_array_equal(gt, gj, err_msg=ctx)
    if gj.shape[0]:
        fj, sj = j.checkpoint_finish(j.checkpoint_begin(gj, now))
        ft, st = t.checkpoint_finish(t.checkpoint_begin(gt, now))
        assert ft.dtype == fj.dtype and st.dtype == sj.dtype
        np.testing.assert_array_equal(ft, fj, err_msg=ctx)
        np.testing.assert_array_equal(st, sj, err_msg=ctx)
    _same_dirty(j.ckpt, t.ckpt, ctx + " after take")
    return gj.shape[0]


@pytest.mark.parametrize("name,blk", [("full", 1), ("gcra32", 4), ("token32", 1)])
def test_tracker_and_extract_follow_every_mutation(name, blk):
    rng = np.random.default_rng(5)
    j = je.LocalEngine(capacity=1 << 12, write_mode="xla", wire="full", layout=name)
    t = te.LocalEngine(capacity=1 << 12, write_mode="xla", layout=name, device="cpu")
    j.ckpt = jck.EpochTracker(j.table.n_buckets, blk=blk)
    t.ckpt = tck.EpochTracker(t.table.n_buckets, blk=blk)
    pool = rng.integers(1, 2**63 - 1, 1000, dtype=np.int64)
    now = NOW

    # serial checks
    c = _cols(rng, pool, name)
    j.check_columns(JCols(**c), now_ms=now)
    t.check_columns(TCols(**c), now_ms=now)
    _same_dirty(j.ckpt, t.ckpt, "check")
    assert _same_epoch(j, t, now, "epoch 1") > 0

    # a pipelined check marks at issue time
    c = _cols(rng, pool, name)
    pj = je.issue_check_columns(j, je.prepare_check_columns(j, JCols(**c), now_ms=now + 10))
    pt = te.issue_check_columns(t, te.prepare_check_columns(t, TCols(**c), now_ms=now + 10))
    _same_dirty(j.ckpt, t.ckpt, "pipelined issue")
    j.stats.merge(je.finish_check_columns(j, pj, lambda fn: fn())[1])
    t.stats.merge(te.finish_check_columns(t, pt, lambda fn: fn())[1])

    # GLOBAL installs (the engine's own algorithm family)
    m = 40
    fp = rng.integers(1, 2**63 - 1, m, dtype=np.int64)
    algo = rng.choice(ALGOS[name], m).astype(np.int32)
    args = (fp, algo, np.zeros(m, np.int32), np.full(m, 9, np.int64),
            rng.integers(0, 9, m).astype(np.int64), np.full(m, now + 5_000, np.int64),
            np.full(m, 5_000, np.int64))
    assert j.install_columns(*args, now_ms=now) == t.install_columns(*args, now_ms=now)
    _same_dirty(j.ckpt, t.ckpt, "install")

    # merges of live rows under new keys, and tombstones (one key missing)
    lf, ls = t.extract_live(now)
    mf = rng.integers(1, 2**63 - 1, 30, dtype=np.int64)
    ms = ls[:30].copy()
    ms[:, 0] = (mf & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ms[:, 1] = (mf >> 32).astype(np.int32)
    assert j.merge_rows(mf, ms, now_ms=now) == t.merge_rows(mf, ms, now_ms=now)
    _same_dirty(j.ckpt, t.ckpt, "merge")
    dead = np.concatenate([lf[:25], [np.int64(12345)]])
    assert j.tombstone_fps(dead) == t.tombstone_fps(dead) == 25
    _same_dirty(j.ckpt, t.ckpt, "tombstone")
    assert _same_epoch(j, t, now, "epoch 2") > 0
    assert _same_epoch(j, t, now, "empty epoch") == 0

    # a restore marks every block; the next epoch carries the whole live set
    snap = t.snapshot()
    j.restore(snap)
    t.restore(snap)
    _same_dirty(j.ckpt, t.ckpt, "restore")
    assert _same_epoch(j, t, now, "after restore") == t.ckpt.nblk

    # a resize (a rehash at the same capacity here) rebuilds the tracker,
    # all dirty
    t.ckpt.take()
    j.ckpt.take()
    j.resize(1 << 12, now)
    t.resize(1 << 12, now)
    assert t.ckpt.dirty_blocks == t.ckpt.nblk
    assert t.ckpt.n_buckets == j.ckpt.n_buckets == t.table.n_buckets
    _same_dirty(j.ckpt, t.ckpt, "resize")
    _same_epoch(j, t, now, "after resize")
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()


def test_tracker_shards_blocks_and_remark():
    """Sharded block ids (the port's own shard_of), odd block widths that
    fall back to a divisor, remark after a failed save, rebuild."""
    rng = np.random.default_rng(9)
    fps = np.concatenate([rng.integers(1, 2**63 - 1, 500, dtype=np.int64), [0, 0]])
    for n_buckets, shards, blk in ((4096, 1, 1), (4096, 4, 8), (6144, 3, 3), (512, 2, 1000)):
        jt = jck.EpochTracker(n_buckets, n_shards=shards, blk=blk, start_epoch=3)
        tt = tck.EpochTracker(n_buckets, n_shards=shards, blk=blk, start_epoch=3)
        np.testing.assert_array_equal(tt._block_ids(fps), jt._block_ids(fps))
        jt.mark(fps[:200])
        tt.mark(fps[:200])
        _same_dirty(jt, tt, f"mark {n_buckets}/{shards}/{blk}")
        (ej, gj), (et, gt) = jt.take(), tt.take()
        assert ej == et
        np.testing.assert_array_equal(gt, gj)
        jt.remark(gj[::2])
        tt.remark(gt[::2])
        _same_dirty(jt, tt, "remark")
        _same_dirty(jt.rebuild(n_buckets * 2), tt.rebuild(n_buckets * 2), "rebuild")


def test_extract_pads_with_a_sentinel_that_reads_as_empty():
    """Block lists of every length up to past a power of two: the padding
    ids (one past the last block) read as zero rows, never live."""
    import jax.numpy as jnp

    from gubernator_tpu.ops import layout as jlayout
    from gubernator_tpu_torch.ops import layout as tlayout

    rng = np.random.default_rng(13)
    rows = rng.integers(-(2**31), 2**31 - 1, (256, 64), dtype=np.int64).astype(np.int32)
    rows.reshape(-1, 8)[::3, :2] = 0  # some empty slots
    for name in ("gcra32", "token32"):
        for g in (1, 7, 8, 9, 64):
            gids = np.sort(rng.choice(256 // 4, g, replace=False)).astype(np.int64)
            jp = jck.extract_begin(jnp.asarray(rows), gids, 4, NOW, layout=jlayout.LAYOUTS[name])
            tp = tck.extract_begin(torch.from_numpy(rows), gids, 4, NOW,
                                   layout=tlayout.LAYOUTS[name])
            for a, b in zip(tck.finish_extract(tp), jck.finish_extract(jp)):
                np.testing.assert_array_equal(a, b)
            # the sorted arrays themselves, padding included
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ring_and_wire_paths_mark_their_keys():
    """The fused front door and the ring slot carry the active keys as their
    marks (PendingCheck.mark, the JAX package's act_fp): the ring's issue
    half marks them before its drain, as the JAX runner's drain does."""
    from gubernator_tpu.service.wire import WireBatch as JWireBatch
    from gubernator_tpu_torch.ops import ring_drain as rd
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    rng = np.random.default_rng(21)
    t = te.LocalEngine(capacity=1 << 12, write_mode="xla", wire="compact", device="cpu")
    t.ckpt = tck.EpochTracker(t.table.n_buckets)
    want = jck.EpochTracker(t.table.n_buckets)
    ring = rd.DeviceRing(slots=4, width=64, drain_k=2, device="cpu")
    group, jgroup = [], []
    j = je.LocalEngine(capacity=1 << 12, write_mode="xla", wire="compact")
    for _ in range(2):
        c = _cols(rng, rng.integers(1, 2**63 - 1, 200, dtype=np.int64), "full", n=40)
        c["algo"] = np.zeros(40, np.int32)
        c["err"][:3] = 1
        c["fp"][:3] = 0
        wb = wire_batch_from_columns(TCols(**c))
        group.append(te.prepare_ring_slot(t, [wb], 64, now_ms=NOW))
        jwb = JWireBatch(cols=JCols(**c), lanes=wb.lanes, encodable=wb.encodable,
                         nbytes=0)
        jgroup.append(je.prepare_ring_slot(j, [jwb], 64, now_ms=NOW))
    for g, jg in zip(group, jgroup):
        np.testing.assert_array_equal(g.pending.mark, jg.pending.mark)
        assert np.asarray(g.pending.hb.fp_view()).tolist() == np.asarray(
            jg.pending.hb.fp_view()).tolist()
        want.mark(jg.pending.mark)
    bank, n = rd.issue_ring_group(t, ring, group, start=0)
    _same_dirty(want, t.ckpt, "ring issue")
    assert t.last_dispatch_rows == 64 and 64 in t._seen_pad_sizes
    rd.finish_ring_group(t, group, bank, n, fixup=lambda fn: fn())

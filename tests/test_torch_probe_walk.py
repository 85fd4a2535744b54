"""Port parity: the fused probe walk's decide stage
(gubernator_tpu_torch.ops.probe_walk, reached through
``kernel2.decide2_impl(probe="pallas")``) against the JAX package's
``decide2(probe="pallas")``.

On the CPU the port runs the walk's plain version, ``probe_walk_ref``; the
JAX package runs its Pallas kernel in interpret mode at its CPU default of
one block per dispatch (that the result does not depend on the block size
is pinned by tests/test_pallas_probe.py). The cases are those of
tests/test_pallas_probe.py: every algorithm and math mode, the three slot
layouts, bucket-full eviction, same-target dedup, expired reclaim,
negative-hit release, RESET/DRAIN, Gregorian rows, inactive padding, one
bucket for the whole batch, and the evictee sidecar. Shapes are shared
across cases (128 rows; 16- and 64-bucket tables) so each JAX program
compiles once. Tolerance: exact — every response field, BatchStats, raw
table bytes and the evictee rows, after every step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops.batch import ReqBatch as JReq
from gubernator_tpu.ops.table2 import Table2 as JTable
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops import probe_walk as pw
from gubernator_tpu_torch.ops.batch import ReqBatch as TReq
from gubernator_tpu_torch.ops.table2 import K, table_from_numpy, table_to_numpy

torch.set_num_threads(1)

NOW = 1_700_000_000_000
N = 128
RESP_FIELDS = ("status", "limit", "remaining", "reset_time", "cache_hit",
               "dropped", "aux", "rem_store")


def mkreq(rng, n=N, n_active=None, algos=(0,), hits=None, behavior=0,
          limit=100, dur=60_000, now=NOW, bucket_pool=None, pool_nb=64,
          greg=0):
    """Unique-fp request columns (numpy); `bucket_pool` concentrates the
    keys into that many buckets of a pool_nb-bucket table."""
    n_active = n if n_active is None else n_active
    if bucket_pool:
        base = rng.integers(1, pool_nb, size=bucket_pool, dtype=np.int64)
        fp = base[rng.integers(0, bucket_pool, size=2 * n)] + pool_nb * \
            rng.integers(1, 1 << 40, size=2 * n, dtype=np.int64)
    else:
        fp = rng.integers(1, 1 << 62, size=2 * n, dtype=np.int64)
    fp = np.unique(fp)[:n]
    rng.shuffle(fp)
    h = (np.asarray(hits, dtype=np.int64) if hits is not None
         else rng.integers(-2, 4, size=n).astype(np.int64))
    h = np.broadcast_to(h, (n,)).copy()
    algo = np.array([algos[i % len(algos)] for i in range(n)], dtype=np.int32)
    return dict(
        fp=fp, algo=algo, behavior=np.full(n, behavior, np.int32), hits=h,
        limit=np.full(n, limit, np.int64), burst=np.full(n, limit, np.int64),
        duration=np.full(n, dur, np.int64), created_at=np.full(n, now, np.int64),
        expire_new=np.full(n, now + dur, np.int64),
        greg_interval=np.full(n, greg, np.int64),
        duration_eff=np.full(n, dur, np.int64),
        active=np.arange(n) < n_active,
    )


def _jreq(r):
    return JReq(**{k: jnp.asarray(v) for k, v in r.items()})


def _treq(r):
    return TReq(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in r.items()})


def assert_parity(nb, req, math="mixed", layout="full", steps=3, step_ms=20_000,
                  evictees=False, rows=None):
    """Drive both packages' fused walk over the same traffic from the same
    table bytes; assert equality at every step. `req` is one batch for
    every step or a list of one per step. Returns the summed stats."""
    jl, tl = jlayout.LAYOUTS[layout], tlayout.LAYOUTS[layout]
    rows = np.zeros((nb, tl.row), np.int32) if rows is None else rows
    jt = JTable(rows=jnp.asarray(rows), layout=jl)
    tt = table_from_numpy(rows, layout=tl, device="cpu")
    totals = np.zeros(5, np.int64)
    reqs = req if isinstance(req, list) else [req] * steps
    for s, q in enumerate(reqs):
        r = dict(q, created_at=q["created_at"] + s * step_ms,
                 expire_new=q["expire_new"] + s * step_ms)
        jo = jk.decide2(jt, _jreq(r), math=math, probe="pallas", evictees=evictees)
        to = tk.decide2_impl(tt, _treq(r), math=math, probe="pallas", evictees=evictees)
        jt = jo[0]
        for f in RESP_FIELDS:
            np.testing.assert_array_equal(
                getattr(to[1], f).numpy(), np.asarray(getattr(jo[1], f)),
                err_msg=f"step {s}: RespBatch.{f}",
            )
        for f in jo[2]._fields:
            assert int(getattr(to[2], f)) == int(getattr(jo[2], f)), f"step {s}: {f}"
        totals += [int(x) for x in jo[2]]
        assert table_to_numpy(to[0]).tobytes() == np.asarray(jt.rows).tobytes(), \
            f"step {s}: table bytes"
        if evictees:
            np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    return totals


@pytest.mark.parametrize("algo,math", [
    (0, "token"), (1, "mixed"), (2, "gcra"), (3, "int"), (4, "int"),
])
def test_parity_per_algorithm(algo, math):
    rng = np.random.default_rng(algo + 1)
    assert_parity(64, mkreq(rng, algos=(algo,)), math=math, steps=4)


def test_parity_mixed_batch_all_algorithms():
    rng = np.random.default_rng(42)
    assert_parity(64, mkreq(rng, algos=(0, 1, 2, 3, 4)), steps=4)


@pytest.mark.parametrize("lay,algo,math", [
    ("gcra32", 2, "gcra"), ("token32", 0, "token"),
])
def test_parity_packed_layouts(lay, algo, math):
    rng = np.random.default_rng(9)
    assert_parity(64, mkreq(rng, algos=(algo,)), math=math, layout=lay, steps=4)
    req = mkreq(rng, algos=(algo,), bucket_pool=6, pool_nb=16)
    assert_parity(16, req, math=math, layout=lay, steps=4)


def test_parity_bucket_full_eviction():
    """More keys per bucket than K lanes: rank-overflow drops, eviction of
    the soonest-expiring live lanes."""
    rng = np.random.default_rng(2)
    a = mkreq(rng, algos=(0, 2), bucket_pool=4, pool_nb=16, hits=1)
    b = mkreq(rng, algos=(2, 0), bucket_pool=4, pool_nb=16, hits=1)
    st = assert_parity(16, [a, b, a, b], math="int")
    assert st[3] > 0 and st[4] > 0  # evictions and drops really happened


def test_parity_same_target_dedup():
    """Owner-vs-inserter lane collisions: aged state makes owners' lanes
    expired, so fresh inserters pick them and the owner wins."""
    rng = np.random.default_rng(3)
    req = mkreq(rng, algos=(0,), bucket_pool=8, pool_nb=16, dur=5_000, hits=1)
    assert_parity(16, req, math="token", steps=5, step_ms=4_000)


def test_parity_expired_slot_reclaim():
    rng = np.random.default_rng(4)
    req = mkreq(rng, algos=(0, 2, 3, 4), bucket_pool=8, pool_nb=16,
                dur=5_000, hits=2)
    assert_parity(16, req, math="int", steps=4, step_ms=30_000)


def test_parity_negative_hit_release_on_missing_key():
    rng = np.random.default_rng(5)
    assert_parity(64, mkreq(rng, algos=(2, 3, 4), hits=-3), math="int", steps=3)


def test_parity_reset_and_drain_behaviors():
    rng = np.random.default_rng(6)
    assert_parity(64, mkreq(rng, algos=(0, 2), behavior=8), math="int")
    assert_parity(64, mkreq(rng, algos=(0, 1, 2, 3, 4), behavior=32, hits=60))
    req = mkreq(rng, algos=(0,), behavior=4, hits=1, greg=86_400_000)
    assert_parity(64, req)  # Gregorian token rows


def test_parity_inactive_padding_rows():
    rng = np.random.default_rng(7)
    assert_parity(64, mkreq(rng, n_active=70))
    assert_parity(64, mkreq(rng, n_active=0), math="token", steps=2)
    # padding as the engine makes it: fp 0, all in bucket 0, beside an
    # active key of bucket 0
    req = mkreq(rng, n_active=100, bucket_pool=3, pool_nb=16)
    req["fp"][100:] = 0
    req["fp"][0] = 16 * 12345
    assert_parity(16, req, steps=3)


def test_parity_single_bucket_whole_batch():
    rng = np.random.default_rng(10)
    req = mkreq(rng, algos=(0,), bucket_pool=1, pool_nb=16, hits=1)
    assert_parity(16, req, math="token", steps=3)


def test_parity_evictee_sidecar():
    rng = np.random.default_rng(12)
    a = mkreq(rng, algos=(0, 1, 2, 3, 4), bucket_pool=5, pool_nb=16, hits=1)
    b = mkreq(rng, algos=(4, 3, 2, 1, 0), bucket_pool=5, pool_nb=16, hits=1)
    st = assert_parity(16, [a, b, a], evictees=True)
    assert st[3] > 0


def test_parity_random_table_bytes():
    """A table of arbitrary bytes (empty lanes with nonzero expiry, negative
    expiries, duplicate fingerprints in one bucket): claim orders that
    differ between clocks, and two inserters that choose one lane."""
    rng = np.random.default_rng(13)
    rows = rng.integers(-(2**31), 2**31, size=(16, 128), dtype=np.int64).astype(np.int32)
    slots = rows.reshape(16, K, 16)
    req = mkreq(rng, algos=(0, 1, 2, 3, 4), bucket_pool=4, pool_nb=16)
    # owners: a few request keys already stored, twice in one bucket
    for i in range(0, 24, 3):
        b, f = int(req["fp"][i] % 16), int(req["fp"][i])
        pair = np.array([f & 0xFFFFFFFF, f >> 32], np.uint32).view(np.int32)
        slots[b, i % K, :2] = pair
        slots[b, (i + 1) % K, :2] = pair
    exp = NOW + rng.integers(-60_000, 60_000, size=(16, K))
    slots[:, :, 10:12] = exp.astype(np.int64).view(np.int32).reshape(16, K, 2)
    slots[:, ::3, :2] = 0  # empty lanes that keep their expiry bytes
    req["created_at"] = NOW + rng.integers(-40_000, 40_000, N)
    assert_parity(16, req, steps=2, rows=rows, step_ms=1)


def test_hbm_bytes_model_matches():
    from gubernator_tpu.ops.pallas_probe import hbm_bytes_per_decision as jb

    for lay in ("full", "gcra32"):
        for write in ("xla", "sweep", "sparse"):
            for probe in ("xla", "pallas"):
                args = (1 << 17, 1 << 21, write, probe)
                assert pw.hbm_bytes_per_decision(tlayout.LAYOUTS[lay], *args) == \
                    jb(jlayout.LAYOUTS[lay], *args)


def test_walk_schedule_units():
    """The kernel's split of the sorted order (``walk_units``, the host
    model of csrc/probe_walk.cu): every row lies in exactly one unit;
    writer units hold the active rows of one bucket; reader units hold at
    most UNIT_ROWS inactive rows of one bucket inside one chunk; a written
    bucket's readers count into the counter at its writer's end, their sum
    is the writer's wait, and they lie in chunks served before the
    writer's."""
    nb = 16
    fp = torch.tensor([16 * 3 + 5, 0, 0, 5, 16 * 9 + 5, 7, 16 + 7, 16 * 40, 16 * 41]
                      + [0] * 100 + [9] * 40 + [16 * 7 + 11], dtype=torch.int64)
    active = torch.ones(fp.shape[0], dtype=torch.bool)
    active[1:3] = False
    active[4] = False
    active[9:-1] = False
    perm, key_s = pw.walk_schedule(fp, active, nb)
    B = fp.shape[0]
    assert sorted(perm.tolist()) == list(range(B))
    assert torch.equal(key_s, ((fp % nb) * 2 + (~active).long()).int()[perm.long()])
    writers, readers = pw.walk_units(key_s)
    bucket = (fp % nb)[perm.long()].numpy()
    act = active[perm.long()].numpy()
    covered = np.zeros(B, np.int64)
    for s, e, waits in writers:
        covered[s:e] += 1
        assert act[s:e].all() and (bucket[s:e] == bucket[s]).all()
        inactive = int(((fp % nb) == int(bucket[s])).logical_and(~active).sum())
        assert waits == inactive
        mine = readers[readers[:, 3] == e]
        assert mine[:, 2].sum() - mine[:, 1].sum() == waits
        assert (mine[:, 0] >= s // pw.UNIT_ROWS).all()  # served no later than the writer
    for c, s, e, counter in readers:
        covered[s:e] += 1
        assert 0 < e - s <= pw.UNIT_ROWS and s // pw.UNIT_ROWS == c == (e - 1) // pw.UNIT_ROWS
        assert not act[s:e].any() and (bucket[s:e] == bucket[s]).all()
        assert (counter == -1) == (not (act & (bucket == bucket[s])).any())
    assert (covered == 1).all()
    # bucket 0: two active keys (a run) then 102 padding rows over four
    # chunks; bucket 5: a run of two, one reader; bucket 7: a run of two;
    # bucket 9: 40 rows nobody writes; bucket 11: a singleton
    runs = {int(bucket[s]): (e - s, w) for s, e, w in writers}
    assert runs == {0: (2, 102), 5: (2, 1), 7: (2, 0), 11: (1, 0)}
    assert (bucket[readers[:, 1]] == 0).sum() == 4
    assert list(readers[bucket[readers[:, 1]] == 9, 3]) == [-1, -1]


def test_parity_bucket0_padding_reader_units():
    """Engine padding (fp 0, inactive, all in bucket 0) beside active keys
    of bucket 0, one (a singleton writer) or two (a run): 108 padding rows
    fill four reader units that must all read bucket 0's pre-dispatch
    bytes. Responses of every row, stats and table bytes as JAX's walk."""
    rng = np.random.default_rng(14)
    for keys0 in (1, 2):
        req = mkreq(rng, n_active=20, bucket_pool=3, pool_nb=16)
        req["fp"][20:] = 0
        req["fp"][:keys0] = 16 * np.arange(12345, 12345 + keys0)
        key_s = pw.walk_schedule(torch.from_numpy(req["fp"]),
                                 torch.from_numpy(req["active"]), 16)[1]
        _writers, readers = pw.walk_units(key_s)
        bucket0 = readers[key_s.numpy()[readers[:, 1]] == 1]
        assert len(bucket0) >= 3 and (bucket0[:, 3] == keys0).all()
        assert_parity(16, req, steps=3)

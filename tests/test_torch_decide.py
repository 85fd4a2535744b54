"""Port parity: one decide dispatch (gubernator_tpu_torch.ops.kernel2
.decide2_packed_cols) against the JAX package, for write ∈ {xla, sweep,
sparse}.

JAX's sweep and sparse writes run their Pallas kernels in interpret mode on
the CPU, as tests/test_sparse_write.py runs them; the port writes through
slot_write's plain version. Multi-dispatch sequences start both packages
from the same table bytes and push more than K inserters into one bucket,
reclaim expired slots, evict the soonest-expiring live slot, force the
write-window overflow drop and cross the 2^31 / 2^32 millisecond boundaries
of the split expiry compare. Tolerance: exact — the packed (B+2, 4) outputs
and the raw int32 table bytes after every dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops.table2 import new_table2 as jax_new_table
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops.table2 import K, table_from_numpy, table_to_numpy

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _arr(fp, now, rng, algos=(0, 1, 2, 3, 4), active=None):
    """Packed (12, B) int64 ingress rows for fingerprints `fp`."""
    B = fp.shape[0]
    a = np.zeros((12, B), dtype=np.int64)
    active = np.ones(B, dtype=bool) if active is None else active
    a[0] = np.where(active, fp, 0)
    a[1] = rng.choice(np.asarray(algos), B)
    beh = np.where(rng.random(B) < 0.1, 8, 0) | np.where(rng.random(B) < 0.15, 32, 0)
    a[2] = beh
    a[3] = rng.integers(-2, 5, B)
    a[4] = rng.integers(0, 9, B)
    a[5] = np.where(rng.random(B) < 0.6, a[4], rng.integers(0, 9, B))
    a[6] = rng.integers(1, 4, B) * 1_000
    a[7] = now
    a[8] = now + a[6]
    a[10] = a[6]
    a[11] = active
    return a


class Pair:
    """The same table in both packages, advanced dispatch by dispatch."""

    def __init__(self, capacity, rows=None):
        self.jt = jax_new_table(capacity)
        if rows is not None:
            self.jt = jk.Table2(rows=jnp.asarray(rows))
        self.tt = table_from_numpy(np.asarray(self.jt.rows), device="cpu")
        self.nb = int(self.jt.rows.shape[0])

    def step(self, arr, write, math="mixed"):
        self.jt, j_out = jk.decide2_packed_cols(
            self.jt, jnp.asarray(arr), write=write, math=math
        )
        self.tt, t_out = tk.decide2_packed_cols(
            self.tt, torch.from_numpy(arr), write=write, math=math
        )
        j_out = np.asarray(j_out)
        np.testing.assert_array_equal(t_out.numpy(), j_out)
        assert table_to_numpy(self.tt).tobytes() == np.asarray(self.jt.rows).tobytes()
        return j_out


def _hot_fps(rng, nb, n, hot_buckets):
    """n unique fingerprints; two thirds land in `hot_buckets` buckets."""
    mult = rng.permutation(16 * n)[:n].astype(np.int64) + 1
    fp = mult * nb + rng.integers(0, nb, n)
    hot = rng.random(n) < 0.67
    fp[hot] = mult[hot] * nb + rng.integers(0, hot_buckets, hot.sum())
    return fp


@pytest.mark.parametrize("write", ["xla", "sweep"])
def test_contended_sequence(write):
    """>K inserters per bucket, evictions of the soonest-expiring slot,
    repeat keys (owners) and expiry reclaim, over six dispatches. ("sparse"
    on a table this small resolves to the sweep; the block-sparse grid
    itself runs in test_sparse_geometry_dispatch.)"""
    capacity = 256
    rng = np.random.default_rng(11)
    pair = Pair(capacity)
    keys = _hot_fps(rng, pair.nb, 40, hot_buckets=1)
    now = NOW
    dropped = evicted = 0
    for step in range(6):
        fp = rng.choice(keys, 16, replace=False)
        active = rng.random(16) < 0.9
        out = pair.step(_arr(fp, now, rng, active=active), write)
        dropped += out[-1, 0]
        evicted += out[-2, 3]
        now += int(rng.integers(0, 2_500))
    assert dropped > 0 and evicted > 0  # the claim's hard paths really ran


@pytest.mark.parametrize(
    "math,algos,capacity",
    [("token", (0,), 256), ("gcra", (2,), 4096), ("int", (0, 2, 3, 4), 256)],
)
def test_math_modes_sequence(math, algos, capacity):
    rng = np.random.default_rng(5)
    pair = Pair(capacity)
    keys = _hot_fps(rng, pair.nb, 32, hot_buckets=2)
    now = NOW
    for step in range(4):
        fp = rng.choice(keys, 16, replace=False)
        pair.step(_arr(fp, now, rng, algos=algos), "xla", math=math)
        now += int(rng.integers(0, 2_500))


def test_expired_slots_are_reclaimed_before_eviction():
    """A full bucket whose lanes have expired takes new keys into the dead
    lanes: no live slot is evicted."""
    rng = np.random.default_rng(3)
    pair = Pair(256)
    half = np.arange(16) < K  # K keys in bucket 0, then K padding rows
    fp = np.arange(1, 17, dtype=np.int64) * pair.nb
    a = _arr(fp, NOW, rng, algos=(0,), active=half)
    a[6] = 1_000
    a[8] = NOW + 1_000
    a[10] = 1_000
    pair.step(a, "xla", math="token")
    out = pair.step(_arr(fp + 16 * pair.nb, NOW + 1_001, rng, algos=(0,), active=half),
                    "xla", math="token")
    assert out[-2, 3] == 0 and out[-1, 0] == 0


def test_window_overflow_drop():
    """Every row in one write block: rows past the block's U-window drop,
    exactly as the TPU geometry rules (sweep geometry, which "xla" and
    "sweep" share: blk=2048, u=128 for a 256-row batch on 2^15 buckets)."""
    rng = np.random.default_rng(9)
    pair = Pair(1 << 18)
    blk, u = jk.sweep_geometry(pair.nb, 256)
    assert (blk, u) == tk.sweep_geometry(pair.nb, 256) == (2048, 128)
    fp = np.arange(256, dtype=np.int64) + pair.nb * rng.integers(1, 1 << 20)
    out = pair.step(_arr(fp, NOW, rng), "xla")
    assert out[-1, 0] == 256 - u


def test_sparse_geometry_dispatch():
    """A serving-size batch on a larger table resolves to the block-sparse
    grid in JAX; the port's claim uses the same sparse geometry."""
    rng = np.random.default_rng(4)
    pair = Pair(1 << 16)
    assert jk.resolve_write("sparse", pair.nb, 16) == "sparse"
    assert tk.resolve_write("sparse", pair.nb, 16) == "sparse"
    keys = _hot_fps(rng, pair.nb, 24, hot_buckets=2)
    now = NOW
    for _ in range(3):
        pair.step(_arr(rng.choice(keys, 16, replace=False), now, rng), "sparse")
        now += 700


@pytest.mark.parametrize("now", [2**31, 2**32, 2**32 + 1, 2**33 - 1])
def test_expiry_compare_at_word_boundaries(now):
    """Slots expiring one ms before, at and after `now`, where `now` sits on
    a 2^31 or 2^32 boundary of the (hi, lo) split the TPU kernel compares."""
    rng = np.random.default_rng(now % 97)
    nb = 32
    rows = np.zeros((nb, 128), dtype=np.int32)
    slots = rows.reshape(nb, K, 16)
    exp = now + np.array([-2, -1, 0, 1, -(2**31), 2**31 - 1, -1, 0])
    for b in range(4):
        for k in range(K):
            fp = (b + 1) * nb * 1000 + k * nb + b
            e = int(exp[(k + b) % K])
            slots[b, k, 0] = np.int64(fp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            slots[b, k, 1] = fp >> 32
            slots[b, k, 2] = 5
            slots[b, k, 4] = 3
            slots[b, k, 6] = 1_000
            slots[b, k, 8] = np.int64((now - 10) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            slots[b, k, 9] = (now - 10) >> 32
            slots[b, k, 10] = np.int64(e & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            slots[b, k, 11] = e >> 32
    pair = Pair(256, rows=rows)
    # half the rows are stored keys (owners), half new keys in the same
    # buckets (they must take the dead lanes first)
    own = np.array([(b + 1) * nb * 1000 + k * nb + b for b in range(2) for k in range(0, K, 2)])
    new = np.array([(9 + j) * nb * 1000 + (j % 4) for j in range(8)])
    fp = np.concatenate([own, new]).astype(np.int64)
    out = pair.step(_arr(fp, now, rng, algos=(0,)), "xla", math="token")
    hits = (out[:8, 3] & 2) != 0
    assert hits.any() and not hits.all()


@pytest.mark.parametrize("nb", [1, 32, 512, 2048, 4096, 16384, 1 << 21])
@pytest.mark.parametrize("batch", [16, 64, 256, 4096, 1 << 17])
def test_write_geometry_matches(nb, batch):
    assert tk.sweep_geometry(nb, batch) == jk.sweep_geometry(nb, batch)
    assert tk.sparse_geometry(nb, batch) == jk.sparse_geometry(nb, batch)
    for write in ("xla", "sweep", "sparse"):
        assert tk.resolve_write(write, nb, batch) == jk.resolve_write(write, nb, batch)


def test_headline_geometry_resolves_to_sweep():
    """At the headline deployment (2^21 buckets, 2^17-row batches) sparse
    coverage spans the whole table, so the sweep geometry rules the claim."""
    assert tk.resolve_write("sparse", 1 << 21, 1 << 17) == "sweep"
    assert tk.claim_geometry("sparse", 1 << 21, 1 << 17) == (2048, 256)


def test_unported_options_raise():
    """Every option of the serving entry is ported (probe="pallas", the
    cascade fold and the evictee sidecar have parity tests of their own);
    unknown values still raise."""
    pair = Pair(256)
    arr = torch.from_numpy(_arr(np.arange(1, 17, dtype=np.int64), NOW,
                                np.random.default_rng(0)))
    with pytest.raises(ValueError):
        tk.decide2_packed_cols(pair.tt, arr, write="scatter")
    with pytest.raises(ValueError):
        tk.decide2_packed_cols(pair.tt, arr, probe="scatter")
    _, out = tk.decide2_packed_cols(pair.tt, arr, evictees=True)
    assert out.shape == (3 * 16 + 2, 4)


def test_unpack_outputs_matches():
    rng = np.random.default_rng(2)
    arr = rng.integers(-(2**40), 2**40, size=(34, 4), dtype=np.int64)
    arr[:32, 3] = rng.integers(0, 128, 32)
    (js, jst) = jk.unpack_outputs(arr, 32)
    (ts, tst) = tk.unpack_outputs(arr, 32)
    assert jst == tst
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)

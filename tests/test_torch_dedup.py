"""Port parity: the mesh engine's in-dispatch dedup against the JAX package.

``dedup_packed_cols``, ``fanout_packed``, ``decide2_packed_dedup_impl``
(also ``cascade=True``) and the compact entry ``decide2_wire_dedup_impl``
(gubernator_tpu_torch.ops.kernel2 / ops.wire) on batches with repeated
keys, repeated keys across cascade levels, RESET_REMAINING rows and
inactive rows; and ``plan.single_pass``. The same numpy-seeded inputs go
through both packages. Tolerance: exact — every returned array, the packed
outputs and the raw int32 table bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops import plan as jplan
from gubernator_tpu.ops import wire as jw
from gubernator_tpu.ops.batch import HostBatch as JHostBatch
from gubernator_tpu.ops.table2 import new_table2 as jax_new_table
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops import plan as tplan
from gubernator_tpu_torch.ops import wire as tw
from gubernator_tpu_torch.ops.batch import HostBatch as THostBatch
from gubernator_tpu_torch.ops.table2 import table_from_numpy, table_to_numpy

torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _dup_arr(rng, n, keys=24, cascade=False, inactive=0.1):
    """Packed (12, n) rows over `keys` distinct fingerprints (so most repeat),
    RESET_REMAINING on some rows; with `cascade`, level bits 1-2 on a third
    of the rows (the same key at two levels stays two groups)."""
    a = np.zeros((12, n), dtype=np.int64)
    pool = rng.integers(1, 2**62, keys)
    act = rng.random(n) >= inactive
    a[0] = np.where(act, rng.choice(pool, n), 0)
    a[1] = rng.integers(0, 5, n)
    beh = np.where(rng.random(n) < 0.15, 8, 0) | np.where(rng.random(n) < 0.1, 32, 0)
    if cascade:
        beh = beh | (rng.integers(0, 3, n) * (rng.random(n) < 0.35)) << 8
    a[2] = beh
    a[3] = rng.integers(0, 4, n)
    a[4] = rng.integers(1, 30, n)
    a[5] = a[4]
    a[6] = rng.integers(1, 5, n) * 1_000
    a[7] = NOW
    a[8] = NOW + a[6]
    a[10] = a[6]
    a[11] = act
    return a


@pytest.mark.parametrize("cascade", [False, True])
def test_dedup_packed_cols_matches_jax(cascade):
    rng = np.random.default_rng(11 + cascade)
    for n in (16, 256):
        arr = _dup_arr(rng, n, cascade=cascade)
        want = [np.asarray(x) for x in jax.jit(jk.dedup_packed_cols)(jnp.asarray(arr))]
        got = [x.numpy() for x in tk.dedup_packed_cols(torch.from_numpy(arr))]
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert want[2].any()  # the batch really repeats keys


def test_fanout_packed_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    arr = _dup_arr(rng, n)
    _ded, carrier, member = jk.dedup_packed_cols(jnp.asarray(arr))
    packed = rng.integers(-(2**40), 2**40, (n + 2, 4))
    want = np.asarray(jk.fanout_packed(jnp.asarray(packed), carrier, member, n))
    got = tk.fanout_packed(torch.from_numpy(packed), torch.from_numpy(np.array(carrier)),
                           torch.from_numpy(np.array(member)), n).numpy()
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_dedup(write, cascade, wire):
    fn = jw.decide2_wire_dedup_impl if wire else jk.decide2_packed_dedup_impl
    return jax.jit(functools.partial(fn, write=write, math="mixed", cascade=cascade))


@pytest.mark.parametrize("write,cascade", [("xla", False), ("sparse", True)])
def test_decide2_packed_dedup_matches_jax(write, cascade):
    """Three dispatches on one table (keys repeat within and across them):
    outputs and table bytes equal after each."""
    rng = np.random.default_rng(5 + cascade)
    jt = jax_new_table(2048)
    tt = table_from_numpy(np.asarray(jt.rows), device="cpu")
    for step in range(3):
        arr = _dup_arr(rng, 128, keys=40, cascade=cascade)
        arr[7] = NOW + 500 * step
        arr[8] = arr[7] + arr[6]
        jt, j_out = _jax_dedup(write, cascade, False)(jt, jnp.asarray(arr))
        tt, t_out = tk.decide2_packed_dedup_impl(tt, torch.from_numpy(arr), write=write,
                                                 math="mixed", cascade=cascade)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        assert table_to_numpy(tt).tobytes() == np.asarray(jt.rows).tobytes()
        assert (np.asarray(j_out)[:-2, 3] & jk.FLAG_MEMBER).any()


def _host_batch(cls, arr):
    return cls(
        fp=arr[0], algo=arr[1].astype(np.int32), behavior=arr[2].astype(np.int32),
        hits=arr[3], limit=arr[4], burst=arr[5], duration=arr[6], created_at=arr[7],
        expire_new=arr[8], greg_interval=arr[9], duration_eff=arr[10],
        active=arr[11] != 0,
    )


def test_decide2_wire_dedup_matches_jax():
    """The compact entry: the same (5, n+1) wire block through both."""
    rng = np.random.default_rng(9)
    jt = jax_new_table(2048)
    tt = table_from_numpy(np.asarray(jt.rows), device="cpu")
    for step in range(2):
        arr = _dup_arr(rng, 128, keys=30, cascade=True)
        arr[5] = np.where((arr[1] == 1) | (arr[1] == 2), arr[4], 0)  # encodable bursts
        arr[2] &= ~np.int64(0x300) | np.int64(0x100)  # levels 0-1 only
        hb = _host_batch(JHostBatch, arr)
        base = jw.pick_base(hb)
        assert jw.wire_encodable(hb, base)
        grid = jw.pack_wire_full(hb, base)
        jt, j_out = _jax_dedup("sparse", step == 1, True)(jt, jnp.asarray(grid))
        tt, t_out = tw.decide2_wire_dedup_impl(tt, torch.from_numpy(grid), write="sparse",
                                               math="mixed", cascade=step == 1)
        assert t_out.dtype == torch.int32
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        assert table_to_numpy(tt).tobytes() == np.asarray(jt.rows).tobytes()


def test_single_pass_matches_jax():
    rng = np.random.default_rng(2)
    for inactive in (0.0, 0.3):
        arr = _dup_arr(rng, 64, inactive=inactive)
        (jp,) = jplan.single_pass(_host_batch(JHostBatch, arr))
        (tp,) = tplan.single_pass(_host_batch(THostBatch, arr))
        np.testing.assert_array_equal(tp.rows, jp.rows)
        assert tp.member_rows == jp.member_rows == []
        for a, b in zip(tp.batch, jp.batch):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

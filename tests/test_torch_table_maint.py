"""Port parity: the table maintenance surface (gubernator_tpu_torch.ops.layout,
ops/table2 and the LocalEngine methods built on them) against the JAX
package.

Both packages' engines see the same traffic, made from a seed, on each of
the three slot layouts (full with all five algorithms, gcra32, token32):
then the layout conversions on host arrays (the repaired numpy path),
``idle_ref``, the handoff extract, the idle extract, the stored-state read
(canonical and raw), tombstones, ``resize`` (growing and shrinking, with
drops) and ``maybe_grow``. Tolerance: exact — values, order, dtypes,
EngineStats and raw table bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops import table2 as jt2
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops import table2 as tt2
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine

torch.set_num_threads(1)

NOW = 1_700_000_000_000
LAYOUTS = ("full", "gcra32", "token32")
ALGOS = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}
CAPACITY = 1 << 12
ROWS = 256


def _cols(rng, pool, layout, n=ROWS):
    fp = rng.choice(pool, n, replace=False)
    return dict(
        fp=fp, algo=rng.choice(ALGOS[layout], n).astype(np.int32),
        behavior=rng.choice([0, 0, 8] if layout != "full" else [0, 8, 32], n).astype(np.int32),
        hits=rng.integers(0, 4, n).astype(np.int64),
        limit=rng.integers(1, 9, n).astype(np.int64),
        burst=np.zeros(n, np.int64),
        duration=rng.integers(1, 30, n).astype(np.int64) * 1_000,
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )


def _same_state(j, t, ctx=""):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats), ctx
    assert t.table.layout.name == j.table.layout.name, ctx
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes(), ctx


def _populated(layout, seed=0, steps=3, capacity=CAPACITY):
    """(jax engine, port engine, key pool, now) after `steps` batches of
    the same traffic; keys fill about a fifth of the table, with spread
    expiries so later reads see live, expired and idle rows."""
    rng = np.random.default_rng(seed)
    j = JaxEngine(capacity=capacity, write_mode="xla", wire="full", layout=layout)
    t = TorchEngine(capacity=capacity, write_mode="xla", layout=layout, device="cpu")
    pool = rng.integers(1, 2**63 - 1, 1200, dtype=np.int64)
    now = NOW
    for _ in range(steps):
        c = _cols(rng, pool, layout)
        a = j.check_columns(JCols(**c), now_ms=now)
        b = t.check_columns(TCols(**c), now_ms=now)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        now += int(rng.integers(1_000, 6_000))
    _same_state(j, t, "populate")
    return j, t, pool, now, rng


def _eq(got, want):
    """numpy equality with the dtype and the type (numpy in, numpy out)."""
    assert isinstance(got, np.ndarray), type(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_takes_host_arrays(name):
    """The repaired fault: the four conversions (and idle_ref) take numpy
    and return what JAX's return, for random field values."""
    rng = np.random.default_rng(7)
    jl, tl = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    slots = rng.integers(-(2**31), 2**31 - 1, (5, 3, jl.F), dtype=np.int64).astype(np.int32)
    full = rng.integers(-(2**31), 2**31 - 1, (5, 3, 16), dtype=np.int64).astype(np.int32)
    rows = rng.integers(-(2**31), 2**31 - 1, (4, 8 * jl.F), dtype=np.int64).astype(np.int32)
    rows_full = rng.integers(-(2**31), 2**31 - 1, (4, 128), dtype=np.int64).astype(np.int32)
    _eq(tl.unpack(slots), jl.unpack(slots))
    _eq(tl.pack(full), jl.pack(full))
    _eq(tl.unpack_rows(rows), jl.unpack_rows(rows))
    _eq(tl.pack_rows(rows_full), jl.pack_rows(rows_full))
    _eq(tl.idle_ref(slots), jl.idle_ref(slots))
    # the tensor path computes the same
    assert torch.equal(tl.idle_ref(torch.from_numpy(slots)), torch.from_numpy(jl.idle_ref(slots)))
    assert torch.equal(tl.unpack(torch.from_numpy(slots)), torch.from_numpy(jl.unpack(slots)))
    # the smallest input of the fault
    _eq(tl.unpack(np.zeros((4, jl.F), np.int32)), jl.unpack(np.zeros((4, jl.F), np.int32)))
    assert tlayout.layout_by_code(jl.code) is tl
    with pytest.raises(ValueError):
        tlayout.layout_by_code(9)


# ------------------------------------------------------------------ reads


@pytest.mark.parametrize("name", LAYOUTS)
def test_extract_live_and_decode(name):
    j, t, _pool, now, _rng = _populated(name)
    for at in (now, now + 9_000):
        jf, js = j.extract_live(at)
        tf, ts = t.extract_live(at)
        _eq(tf, jf)
        _eq(ts, js)
        assert tf.shape[0] == t.live_count(at) == j.live_count(at)
        # table order: the decode of the snapshot, on numpy and on tensors
        hs, hf, he = tt2.decode_live_slots(t.snapshot(), at, t.table.layout)
        js2, jf2, je2 = jt2.decode_live_slots(np.asarray(j.table.rows), at, j.table.layout)
        _eq(hs, js2)
        _eq(hf, jf2)
        _eq(he, je2)
        _eq(tf, hf)
        ds, df, _de = tt2.decode_live_slots(t.table.rows, at, t.table.layout)
        assert torch.equal(ds, torch.from_numpy(hs)) and torch.equal(df, torch.from_numpy(hf))
    _same_state(j, t)
    assert t._seen_pad_sizes == j._seen_pad_sizes
    assert t.hbm_bytes_per_decision_estimate() == j.hbm_bytes_per_decision_estimate()


@pytest.mark.parametrize("name", LAYOUTS)
def test_extract_idle(name):
    j, t, _pool, now, _rng = _populated(name)
    for idle_ms, cap in ((0, 1 << 16), (2_500, 1 << 16), (2_500, 37), (60_000, 1 << 16)):
        jf, js = j.extract_idle(now, idle_ms, cap)
        tf, ts = t.extract_idle(now, idle_ms, cap)
        _eq(tf, jf)
        _eq(ts, js)
    assert jf.shape[0] == 0 and ts.shape == (0, t.table.layout.F)


@pytest.mark.parametrize("name", LAYOUTS)
def test_read_state(name):
    j, t, pool, now, rng = _populated(name)
    live, _ = t.extract_live(now)
    fps = np.concatenate([live[:50], rng.integers(1, 2**63 - 1, 20, dtype=np.int64),
                          pool[:30], live[:3]])
    for raw in (False, True):
        jf, js = j.read_state(fps, raw=raw)
        tf, ts = t.read_state(fps, raw=raw)
        _eq(tf, jf)
        _eq(ts, js)
    for raw in (False, True):
        tf, ts = t.read_state(np.empty(0, np.int64), raw=raw)
        jf, js = j.read_state(np.empty(0, np.int64), raw=raw)
        _eq(tf, jf)
        _eq(ts, js)
    _same_state(j, t)


@pytest.mark.parametrize("name", LAYOUTS)
def test_first_matching_lane_and_sentinel(name):
    """A bucket holding one fingerprint twice: the gather and the tombstone
    take the first matching lane, as jnp.argmax does; a missing
    fingerprint (and an inactive row) kills nothing."""
    lay_j, lay_t = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    rng = np.random.default_rng(11)
    nb = 64
    rows = rng.integers(-(2**31), 2**31 - 1, (nb, 8 * lay_j.F), dtype=np.int64).astype(np.int32)
    fp = np.int64(nb * (3 << 40) + 5)
    slots = rows.reshape(nb, 8, lay_j.F)
    for lane in (2, 6):
        slots[5, lane, 0] = np.array([fp & 0xFFFFFFFF], np.int64).astype(np.int32)[0]
        slots[5, lane, 1] = np.int32(fp >> 32)
    slots[5, 6, 2:] = 77
    fps = np.array([fp, 999 * nb + 5, fp, 0], dtype=np.int64)
    active = np.array([True, True, False, True])
    jfull, jfound = jt2.gather_slots(jnp.asarray(rows), jnp.asarray(fps),
                                     jnp.asarray(active), layout=lay_j)
    trows = torch.from_numpy(rows.copy())
    tfull, tfound = tt2.gather_slots_impl(trows, torch.from_numpy(fps), torch.from_numpy(active),
                                          layout=lay_t)
    _eq(tfull.numpy(), np.asarray(jfull))
    _eq(tfound.numpy(), np.asarray(jfound))
    jout, jkill = jax.jit(jt2.tombstone_rows_impl)(jnp.asarray(rows), jnp.asarray(fps),
                                                   jnp.asarray(active))
    tkill = tt2.tombstone_rows_impl(trows, torch.from_numpy(fps), torch.from_numpy(active))
    _eq(tkill.numpy(), np.asarray(jkill))
    _eq(trows.numpy(), np.asarray(jout))
    after = trows.numpy().reshape(nb, 8, lay_j.F)
    assert (after[5, 2] == 0).all()  # the first matching lane, and only it
    after[5, 2] = slots[5, 2]
    _eq(after.reshape(nb, -1), rows)


# ----------------------------------------------------------------- writes


@pytest.mark.parametrize("name", LAYOUTS)
def test_tombstone_fps(name):
    j, t, pool, now, rng = _populated(name)
    live, _ = t.extract_live(now)
    fps = np.concatenate([live[::3], rng.integers(1, 2**63 - 1, 10, dtype=np.int64)])
    assert t.tombstone_fps(fps) == j.tombstone_fps(fps) == live[::3].shape[0]
    assert t.tombstone_fps(fps) == j.tombstone_fps(fps) == 0  # retried: no-op
    assert t.tombstone_fps(np.empty(0, np.int64)) == j.tombstone_fps(np.empty(0, np.int64)) == 0
    _same_state(j, t, "tombstone")
    # the idle sweep's job: extract the idle rows, then tombstone them
    jf, _ = j.extract_idle(now, 2_000)
    tf, ts = t.extract_idle(now, 2_000)
    _eq(tf, jf)
    assert t.tombstone_fps(tf) == j.tombstone_fps(jf)
    _eq(t.table.layout.unpack(ts), jlayout.LAYOUTS[name].unpack(ts))
    _same_state(j, t, "idle sweep")


@pytest.mark.parametrize("name", LAYOUTS)
def test_resize_and_maybe_grow(name):
    j, t, pool, now, rng = _populated(name, capacity=1 << 11)
    # shrink into fewer buckets than the live keys need: drops, counted as
    # unexpired evictions
    assert t.resize(1 << 8, now) == j.resize(1 << 8, now) > 0
    _same_state(j, t, "resize")
    # maybe_grow: a ceiling can forbid it; over the threshold it doubles
    assert t.maybe_grow(max_capacity=1 << 8, now_ms=now) is j.maybe_grow(
        max_capacity=1 << 8, now_ms=now) is False
    assert t.maybe_grow(threshold=1.0, now_ms=now) is j.maybe_grow(
        threshold=1.0, now_ms=now) is False
    assert t.maybe_grow(threshold=0.1, now_ms=now) is j.maybe_grow(
        threshold=0.1, now_ms=now) is True
    assert t.table.capacity == j.table.capacity == 1 << 9
    _same_state(j, t, "maybe_grow")
    # traffic after the growth lands the same
    c = _cols(rng, pool, name)
    a = j.check_columns(JCols(**c), now_ms=now)
    b = t.check_columns(TCols(**c), now_ms=now)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    _same_state(j, t, "after resize")


def test_rehash_rows_matches():
    _j, t, _pool, now, _rng = _populated("full", seed=3)
    snap = t.snapshot()
    for nb in (32, 512, 1024):
        got, gd = tt2.rehash_rows(snap, nb, now)
        want, wd = jt2.rehash_rows(snap, nb, now)
        _eq(got, want)
        assert gd == wd
    assert tt2.rehash_rows(np.zeros((8, 128), np.int32), 16, now)[1] == 0

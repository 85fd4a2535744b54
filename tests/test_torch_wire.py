"""Port parity: the compact wire codec (gubernator_tpu_torch.ops.wire) and
compact engines against the JAX package.

The same numpy inputs, made from a seed, go through both packages: the
host encoders and decoders, the device decode of the 5-lane ingress grid
(random lane bits and the edges of tests/test_wire_compact.py: created
delta -512 and +511, DRAIN in bit 31, priority and cascade level bits),
the egress narrowing (int32 saturation, the reset sentinel),
``wire_encodable``'s rejections, ``decide2_wire_cols_impl`` with both
probes, with the evictee sidecar and with the cascade fold, a compact
``LocalEngine`` against JAX's over four steps with duplicate keys, and the
compact port engine against its own full-width engine. The native parser's
lane pass is held against ``service/wire.wire_batch_from_wire``.
Tolerance: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops import wire as jw
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.batch import pack_columns as j_pack
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.ops.table2 import Table2 as JTable
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops import wire as tw
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.batch import pack_columns as t_pack
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine
from gubernator_tpu_torch.ops.table2 import table_from_numpy, table_to_numpy

torch.set_num_threads(1)

NOW = 1_700_000_000_000
RESET, DRAIN, GLOBAL = 8, 32, 2


def mk_cols(n, rng, dup=False, leaky_frac=0.5, created_at=NOW, hits_hi=4,
            behavior_pool=(0, RESET, DRAIN, GLOBAL, 64, 128 | DRAIN)):
    fp = rng.integers(1, (1 << 63) - 1, size=n, dtype=np.int64)
    if dup:
        fp[n // 2:] = fp[: n - n // 2]
    return dict(
        fp=fp,
        algo=(rng.random(n) < leaky_frac).astype(np.int32),
        behavior=rng.choice(behavior_pool, size=n).astype(np.int32),
        hits=rng.integers(0, hits_hi, n).astype(np.int64),
        limit=np.full(n, 100, dtype=np.int64),
        burst=np.zeros(n, dtype=np.int64),
        duration=np.full(n, 60_000, dtype=np.int64),
        created_at=np.full(n, created_at, dtype=np.int64),
        err=np.zeros(n, dtype=np.int8),
    )


def _hb_pair(cols, now=NOW):
    jb, _ = j_pack(JCols(**cols), now)
    tb, _ = t_pack(TCols(**cols), now)
    return jb, tb


def _edge_cols(rng, n=64):
    """Delta floor and ceiling, DRAIN (lane 4 bit 31), priority tiers and
    cascade levels 1-3 (lane 3 bits 30-31), all algorithms."""
    cols = mk_cols(n, rng)
    cols["created_at"][5] = NOW - 512
    cols["created_at"][6] = NOW + 511
    cols["behavior"][7:12] = [DRAIN, DRAIN | RESET | (3 << 6), 1 << 8, 2 << 8, 3 << 8]
    cols["algo"][:] = np.arange(n) % 5
    cols["burst"][:] = np.where((cols["algo"] == 1) | (cols["algo"] == 2), 100, 0)
    return cols


# ------------------------------------------------------------------- codec


@pytest.mark.parametrize("case", ["edges", "random_lanes"])
def test_decode_wire_block_matches(case):
    rng = np.random.default_rng(31)
    if case == "edges":
        jb, tb = _hb_pair(_edge_cols(rng))
        base = tw.pick_base(tb)
        assert base == jw.pick_base(jb) == NOW
        assert tw.wire_encodable(tb, base) and jw.wire_encodable(jb, base)
        grid = tw.pack_wire_full(tb, base)
        np.testing.assert_array_equal(grid, jw.pack_wire_full(jb, base))
        rows = tw.pack_wire_rows(tb, base)
        dec_t, dec_j = tw.decode_wire_host(rows, base), jw.decode_wire_host(rows, base)
        for key in dec_j:
            np.testing.assert_array_equal(dec_t[key], dec_j[key], err_msg=key)
    else:  # arbitrary lane bits, signed base included
        grid = rng.integers(-(2**31), 2**31, size=(5, 97), dtype=np.int64).astype(np.int32)
    arr_t, base_t = tw.decode_wire_block(torch.from_numpy(grid))
    arr_j, base_j = jw.decode_wire_block(jnp.asarray(grid))
    np.testing.assert_array_equal(arr_t.numpy(), np.asarray(arr_j))
    assert int(base_t) == int(base_j)


def test_encode_wire_out_saturation_and_sentinel():
    """The edges of tests/test_wire_compact.py plus random int64 cells:
    clamps before the int32 cast, reset == 0 through the sentinel, the base
    stamped into the stats row; the host decoders agree too."""
    rng = np.random.default_rng(32)
    n = 64
    packed = rng.integers(-(2**62), 2**62, size=(n + 2, 4), dtype=np.int64)
    packed[:6, 0] = [2**31 + 7, 5, 5, 5, 5, 5]
    packed[:6, 1] = [3, 2**31 + 9, -(2**31) - 9, -17, 0, 1]
    packed[:6, 2] = [NOW + 1, NOW + 2, NOW + 3, 0, NOW + 2**40, NOW - 5]
    packed[6:20, 2] = NOW + rng.integers(-(2**33), 2**33, 14)
    packed[:, 3] &= 0x7F
    for base in (NOW, -(2**40) - 3, 0):
        enc_t = tw.encode_wire_out(torch.from_numpy(packed), torch.tensor(base))
        enc_j = np.asarray(jw.encode_wire_out(jnp.asarray(packed), jnp.int64(base)))
        assert enc_t.dtype == torch.int32
        np.testing.assert_array_equal(enc_t.numpy(), enc_j)
        assert tw.wire_out_base(enc_j) == jw.wire_out_base(enc_j) == base
        ot, st_t = tw.unpack_wire_out(enc_j, n)
        oj, st_j = jw.unpack_wire_out(enc_j, n)
        assert st_t == st_j
        for a, b in zip(ot, oj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tk.unpack_tiers(enc_j, n), jk.unpack_tiers(enc_j, n))


def test_encodable_rejections():
    rng = np.random.default_rng(4)

    def pair(mut=None, **kw):
        jb, tb = _hb_pair(mk_cols(16, rng, **kw))
        for b in (jb, tb):
            if mut is not None:
                mut(b)
        return jb, tb

    cases = {
        "plain": pair(),
        "delta+512": pair(created_at=NOW + 512),
        "delta-513": pair(created_at=NOW - 513),
        "hits 2^18": pair(lambda b: b.hits.__setitem__(0, 1 << 18)),
        "hits -1": pair(lambda b: b.hits.__setitem__(0, -1)),
        "duration 2^30": pair(lambda b: b.duration.__setitem__(3, 1 << 30)),
        "limit -5": pair(lambda b: b.limit.__setitem__(0, -5)),
        "leaky burst": pair(lambda b: b.burst.__setitem__(0, b.limit[0] + 1), leaky_frac=1.0),
        "token burst": pair(lambda b: b.burst.__setitem__(0, 7), leaky_frac=0.0),
        "gregorian": pair(lambda b: b.greg_interval.__setitem__(2, 1000)),
        "level 4": pair(lambda b: b.behavior.__setitem__(1, 4 << 8)),
        "inactive": pair(lambda b: b.active.__setitem__(slice(None), False)),
    }
    got = {name: tw.wire_encodable(tb, NOW) for name, (jb, tb) in cases.items()}
    want = {name: jw.wire_encodable(jb, NOW) for name, (jb, tb) in cases.items()}
    assert got == want
    assert [name for name, ok in got.items() if ok] == ["plain", "token burst", "inactive"]


# ------------------------------------------------------ decide2_wire_cols


def _seed_table(rng, nb=64):
    """A 64-bucket full-layout table with live rows of every algorithm."""
    slots = np.zeros((nb, 8, 16), dtype=np.int32)
    live = rng.random((nb, 8)) < 0.5
    fp = rng.integers(1, 1 << 62, size=(nb, 8), dtype=np.int64)
    fp = fp - fp % nb + np.arange(nb)[:, None]  # each fp in its own bucket
    exp = NOW + rng.integers(-5_000, 60_000, size=(nb, 8))
    slots[..., 0] = (fp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    slots[..., 1] = (fp >> 32).astype(np.int32)
    slots[..., 2] = 100
    slots[..., 4] = rng.integers(0, 100, size=(nb, 8))
    slots[..., 5] = rng.integers(0, 5, size=(nb, 8))
    slots[..., 6] = 60_000
    slots[..., 10] = (exp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    slots[..., 11] = (exp >> 32).astype(np.int32)
    slots[~live] = 0
    return slots.reshape(nb, 128), fp[live]


@pytest.mark.parametrize("probe,evictees,cascade", [
    ("xla", True, True), ("pallas", False, True), ("pallas", True, False),
])
def test_decide2_wire_cols_matches(probe, evictees, cascade):
    rng = np.random.default_rng(33)
    rows, held = _seed_table(rng)
    cols = _edge_cols(rng, n=128)
    # owners among inserters; bucket 3 gets > K inserters and no owner, so
    # its live lanes are evicted
    cols["fp"][:40] = rng.permutation(held[held % 64 != 3])[:40]
    cols["fp"][40:64] = rng.integers(1, 1 << 40, 24) * 64 + 3
    if not cascade:
        cols["behavior"] &= 0xFF
    cols["fp"][-16:] = 0  # padding rows (inactive)
    cols["err"][-16:] = 1
    jb, tb = _hb_pair(cols)
    grid = tw.pack_wire_full(tb, NOW)
    math = "mixed"
    jt = JTable(rows=jnp.asarray(rows), layout=jlayout.FULL)
    tt = table_from_numpy(rows, tlayout.FULL, device="cpu")
    evicted = 0
    for step in range(2):
        g = grid.copy()
        tw.stamp_base(g, NOW + 1_000 * step)
        jt, out_j = jw.decide2_wire_cols(jt, jnp.asarray(g), write="xla", math=math,
                                         cascade=cascade, probe=probe, evictees=evictees)
        tt, out_t = tw.decide2_wire_cols_impl(tt, torch.from_numpy(g), write="xla", math=math,
                                              cascade=cascade, probe=probe, evictees=evictees)
        out_j = np.asarray(out_j)
        assert out_t.dtype == torch.int32
        np.testing.assert_array_equal(out_t.numpy(), out_j, err_msg=f"step {step}")
        np.testing.assert_array_equal(table_to_numpy(tt), np.asarray(jt.rows))
        if evictees:
            ft, rt = tk.unpack_evictees(out_t.numpy())
            fj, rj = jk.unpack_evictees(out_j)
            np.testing.assert_array_equal(ft, fj)
            np.testing.assert_array_equal(rt, rj)
            evicted += ft.shape[0]
    assert evicted > 0 or not evictees


# ------------------------------------------------------------- engines


def _rc_equal(a, b, ctx=""):
    for f in ("status", "limit", "remaining", "reset_time", "err"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{ctx}: {f}")


def test_local_engine_compact_matches_jax():
    """Compact port engine vs compact JAX engine (capacity 2^12) over four
    steps, duplicates every other step, then vs the port's full-width
    engine (JAX's own compact == full contract): responses, stats and
    table bytes."""
    rng = np.random.default_rng(11)
    je = JaxEngine(capacity=1 << 12, write_mode="xla", wire="compact")
    tc = TorchEngine(capacity=1 << 12, write_mode="xla", wire="compact", device="cpu")
    tf = TorchEngine(capacity=1 << 12, write_mode="xla", wire="full", device="cpu")
    for step in range(4):
        cols = mk_cols(200, rng, dup=(step % 2 == 1))
        if step == 2:
            cols["created_at"][3] = NOW + 2 * 1000 + 9_000  # skew: that pass ships full-width
        now = NOW + step * 1000
        a = je.check_columns(JCols(**cols), now_ms=now)
        b = tc.check_columns(TCols(**cols), now_ms=now)
        c = tf.check_columns(TCols(**cols), now_ms=now)
        _rc_equal(a, b, f"jax step {step}")
        _rc_equal(c, b, f"full step {step}")
    snap = tc.snapshot().tobytes()
    assert snap == np.asarray(je.table.rows).tobytes() == tf.snapshot().tobytes()
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(je.stats) \
        == dataclasses.asdict(tf.stats)


def test_default_wire_mode(monkeypatch):
    monkeypatch.delenv("GUBER_WIRE_COMPACT", raising=False)
    assert tw.default_wire_mode("cpu") == "full"
    assert tw.default_wire_mode("cuda") == tw.default_wire_mode() == "compact"
    assert TorchEngine(capacity=64, device="cpu").wire == "full"
    monkeypatch.setenv("GUBER_WIRE_COMPACT", "1")
    assert TorchEngine(capacity=64, device="cpu").wire == "compact"
    monkeypatch.setenv("GUBER_WIRE_COMPACT", "0")
    assert tw.default_wire_mode("cuda") == "full"
    with pytest.raises(ValueError):
        TorchEngine(capacity=64, device="cpu", wire="narrow")


# ---------------------------------------------------- the parser's lanes


def test_lane_pass_matches_native_parser():
    from gubernator_tpu.proto import gubernator_pb2 as pb
    from gubernator_tpu.service.wire import wire_batch_from_wire
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    rng = np.random.default_rng(35)
    items = []
    for i in range(96):
        algo = int(rng.integers(0, 6))
        items.append(pb.RateLimitReq(
            name="" if i == 5 else "lanes", unique_key="" if i == 9 else f"k{i}",
            hits=int(rng.choice([0, 1, 3, -1, 1 << 18, (1 << 18) - 1])),
            limit=int(rng.choice([0, 10, 2**31 - 1, 2**31, -4])),
            burst=int(rng.choice([0, 0, 0, 5, -(2**31)])),
            duration=int(rng.choice([1_000, 60_000, (1 << 27) - 1, 1 << 27, -1])),
            algorithm=algo,
            behavior=int(rng.choice([0, RESET, DRAIN, GLOBAL, 4, 16, 64, 192 | DRAIN, 256])),
            created_at=NOW + int(rng.integers(-900, 900)) if i % 3 else 0,
        ))
    data = pb.GetRateLimitsReq(requests=items).SerializeToString()
    got = wire_batch_from_wire(data)
    assert got is not None, "the native parser extension did not load"
    jwb = got[0]
    twb = wire_batch_from_columns(TCols(*[np.asarray(c) for c in jwb.cols]))
    np.testing.assert_array_equal(twb.lanes, jwb.lanes)
    np.testing.assert_array_equal(twb.encodable, jwb.encodable)
    assert 0 < int(twb.encodable.sum()) < 96

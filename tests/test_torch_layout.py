"""Port parity: slot layouts and the table (gubernator_tpu_torch.ops.layout,
ops/table2) against the JAX package.

Pack/unpack run on the same random int32 slot fields in both packages (the
JAX module's numpy path), for all three layouts; the table helpers carry a
JAX table's bytes across unchanged. Tolerance: exact (raw int32 bytes).
"""

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops import table2 as jtable2
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.types import RateLimitRequest
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops import table2 as ttable2

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

NOW = 1_700_000_000_000
LAYOUTS = ["full", "gcra32", "token32"]


def _rand_i32(shape, seed):
    return np.random.default_rng(seed).integers(
        -(2**31), 2**31, size=shape, dtype=np.int64
    ).astype(np.int32)


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_geometry_matches(name):
    j, t = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    for attr in ("code", "F", "modes", "algos", "greg_ok", "exp_lo_i",
                 "exp_hi_i", "row", "slot_bytes"):
        assert getattr(t, attr) == getattr(j, attr), attr


@pytest.mark.parametrize("name", LAYOUTS)
def test_unpack_matches(name):
    j, t = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    packed = _rand_i32((64, 8, j.F), seed=j.code)
    want = j.unpack(packed)
    got = t.unpack(torch.from_numpy(packed)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", LAYOUTS)
def test_pack_matches(name):
    j, t = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    full = _rand_i32((64, 8, 16), seed=10 + j.code)
    np.testing.assert_array_equal(t.pack(torch.from_numpy(full)).numpy(), j.pack(full))


@pytest.mark.parametrize("name", LAYOUTS)
def test_rows_roundtrip_matches(name):
    j, t = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    rows = _rand_i32((32, j.row), seed=20 + j.code)
    full_j = j.unpack_rows(rows)
    full_t = t.unpack_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(full_t.numpy(), full_j)
    np.testing.assert_array_equal(t.pack_rows(full_t).numpy(), j.pack_rows(full_j))


@pytest.mark.parametrize(
    "capacity", [1, 7, 8, 9, 255, 256, 4096, 16383, 16384, 16385, 50_000, 1 << 24]
)
def test_n_buckets_for(capacity):
    assert ttable2.n_buckets_for(capacity) == jtable2.n_buckets_for(capacity)


def test_n_buckets_for_rejects_nonpositive():
    with pytest.raises(ValueError):
        ttable2.n_buckets_for(0)


def test_field_constants_match():
    for name in ("K", "F", "ROW", "FP_LO", "FP_HI", "LIMIT", "BURST", "REM_I",
                 "FLAGS", "DUR_LO", "DUR_HI", "STAMP_LO", "STAMP_HI", "EXP_LO",
                 "EXP_HI", "REMF_HI", "REMF_LO"):
        assert getattr(ttable2, name) == getattr(jtable2, name), name


@pytest.mark.parametrize("name", LAYOUTS)
def test_new_table_matches(name):
    j = jtable2.new_table2(1000, layout=jlayout.LAYOUTS[name])
    t = ttable2.new_table2(1000, layout=tlayout.LAYOUTS[name], device="cpu")
    np.testing.assert_array_equal(ttable2.table_to_numpy(t), np.asarray(j.rows))
    assert t.layout is tlayout.LAYOUTS[name]


@pytest.fixture(scope="module")
def served_rows():
    """A JAX table after real decisions: 16 keys, some expiring."""
    eng = JaxEngine(capacity=256, write_mode="xla", wire="full")
    reqs = [
        RateLimitRequest(name="t", unique_key=f"k{i}", hits=1, limit=5,
                         duration=1_000 * (1 + i % 4), created_at=NOW)
        for i in range(16)
    ]
    eng.check(reqs, now_ms=NOW)
    return np.asarray(eng.table.rows)


def test_table_numpy_roundtrip(served_rows):
    t = ttable2.table_from_numpy(served_rows, device="cpu")
    assert t.rows.dtype == torch.int32 and t.layout is tlayout.FULL
    back = ttable2.table_to_numpy(t)
    assert back.dtype == np.int32
    assert back.tobytes() == served_rows.tobytes()
    # the table owns its bytes: writing it leaves the source untouched
    t.rows.zero_()
    assert served_rows.any()


@pytest.mark.parametrize("dt", [0, 999, 1000, 2500, 4000])
def test_live_count_and_decode_match(served_rows, dt):
    now = NOW + dt
    t = ttable2.table_from_numpy(served_rows, device="cpu")
    jt = jtable2.Table2(rows=served_rows)
    assert ttable2.live_count2(t, now) == jtable2.live_count2(jt, now)
    s_t, fp_t, exp_t = ttable2.decode_live_slots(t.rows, now)
    s_j, fp_j, exp_j = jtable2.decode_live_slots(served_rows, now)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(fp_t.numpy(), fp_j)
    np.testing.assert_array_equal(exp_t.numpy(), exp_j)


def test_table_from_numpy_rejects_bad_input():
    with pytest.raises(ValueError):
        ttable2.table_from_numpy(np.zeros((4, 128), dtype=np.int64), device="cpu")
    with pytest.raises(ValueError):
        ttable2.table_from_numpy(
            np.zeros((4, 128), dtype=np.int32), layout=tlayout.GCRA32, device="cpu"
        )


@pytest.mark.parametrize(
    "env,mode,hint",
    [
        (None, None, None), ("full", None, "gcra"), ("auto", None, "token"),
        ("packed", None, "gcra"), (None, "token32", None), ("auto", None, "int"),
        (None, "gcra32", "token"),
    ],
)
def test_resolve_layout_matches(monkeypatch, env, mode, hint):
    if env is None:
        monkeypatch.delenv("GUBER_SLOT_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("GUBER_SLOT_LAYOUT", env)
    assert (
        tlayout.resolve_layout(mode, hint).name
        == jlayout.resolve_layout(mode, hint).name
    )


def test_layout_env_rejects_unknown(monkeypatch):
    monkeypatch.setenv("GUBER_SLOT_LAYOUT", "bogus")
    with pytest.raises(ValueError):
        tlayout.resolve_layout()

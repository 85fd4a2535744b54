"""Port parity: the table-telemetry scan (gubernator_tpu_torch.ops.telemetry)
against the JAX package's ``_scan`` and its numpy oracle ``host_telemetry``.

Tables made from a seed on each slot layout: random slot fields with
fingerprints, expiries, statuses and remaining / limit pairs drawn around
every histogram edge (rem / limit exactly at 0.01, 0.1, 0.25, 0.5, 0.9 in
float32), a table filled by real traffic, and a geometry whose bucket count
64 does not divide. The stats vector, the decoded TableSnapshot and the
port's own oracle must equal JAX's. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops import telemetry as jtel
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops import telemetry as ttel

torch.set_num_threads(1)

NOW = 1_700_000_000_000
LAYOUTS = ("full", "gcra32", "token32")
_FIELDS = ("now_ms", "capacity", "n_buckets", "live_keys", "occupied_slots", "over_keys",
           "bucket_occupancy", "ttl_horizon", "remaining_frac", "block_fill", "per_shard_live")


def _table(name, nb, seed):
    """Canonical rows drawn around every edge, packed into the layout."""
    rng = np.random.default_rng(seed)
    n = nb * 8
    full = np.zeros((n, 16), np.int64)
    fp = rng.integers(1, 2**63 - 1, n, dtype=np.int64)
    fp[rng.random(n) < 0.3] = 0  # empty slots
    full[:, 0] = fp & 0xFFFFFFFF
    full[:, 1] = fp >> 32
    lim = rng.choice([1, 3, 10, 100, 1000, 7], n)
    rem = np.where(rng.random(n) < 0.5, (lim * rng.choice([0.01, 0.1, 0.25, 0.5, 0.9, 1], n)),
                   rng.integers(-3, 1200, n)).astype(np.int64)
    full[:, 2] = lim
    full[:, 4] = rem
    algo = 2 if name == "gcra32" else (0 if name == "token32" else rng.integers(0, 5, n))
    full[:, 5] = algo | (rng.integers(0, 2, n) << 8)
    dur = rng.choice([1_000, 60_000, 3_600_000], n)
    full[:, 6] = dur
    rel = rng.choice([-5, 0, 1, 999, 1_000, 1_001, 9_999, 60_000, 600_000, 3_600_000,
                      86_400_000, 86_400_001, 10**9], n)
    exp = NOW + rel
    full[:, 10] = exp & 0xFFFFFFFF
    full[:, 11] = exp >> 32
    full[:, 12] = exp >> 32  # gcra32 keeps its TAT in the aux pair
    full[:, 13] = exp & 0xFFFFFFFF
    stamp = exp - dur
    full[:, 8] = stamp & 0xFFFFFFFF
    full[:, 9] = stamp >> 32
    full32 = full.astype(np.uint64).astype(np.uint32).view(np.int32)
    return np.asarray(jlayout.LAYOUTS[name].pack(full32)).reshape(nb, -1).copy()


def _same_snapshot(got, want):
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("nb", [512, 96])
def test_scan_matches_jax(name, nb):
    rows = _table(name, nb, seed=nb)
    jl, tl = jlayout.LAYOUTS[name], tlayout.LAYOUTS[name]
    for now in (NOW, NOW + 1_000, NOW + 3_600_000):
        want = np.asarray(jtel._scan(jnp.asarray(rows), jnp.int64(now),
                                     blk=jtel.block_width(nb), layout=jl))
        got = ttel._scan_body(torch.from_numpy(rows), now, ttel.block_width(nb), tl)
        assert got.dtype == torch.int64 and got.shape == (ttel.VEC_LEN,)
        np.testing.assert_array_equal(got.numpy(), want)
        snap = ttel.finish_scan(ttel.scan_begin(torch.from_numpy(rows), now, layout=tl))
        _same_snapshot(snap, jtel.host_telemetry(rows, now, layout=jl))
        _same_snapshot(ttel.host_telemetry(rows, now, layout=tl),
                       jtel.host_telemetry(rows, now, layout=jl))
        assert snap.live_keys > 0 and snap.remaining_frac[0] > 0
    assert ttel.decode_vec(got.numpy()) == jtel.decode_vec(want)


def test_engine_telemetry_after_traffic():
    """telemetry_begin on a port engine filled by the same traffic as a JAX
    engine, finished by the JAX package's finish_scan (as the runner does)
    and by the port's."""
    from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
    from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine

    rng = np.random.default_rng(3)
    j = JaxEngine(capacity=1 << 12, write_mode="xla", wire="full")
    t = TorchEngine(capacity=1 << 12, write_mode="xla", device="cpu")
    n = 512
    c = dict(fp=rng.integers(1, 2**63 - 1, n, dtype=np.int64),
             algo=rng.integers(0, 5, n).astype(np.int32), behavior=np.zeros(n, np.int32),
             hits=rng.integers(0, 9, n).astype(np.int64),
             limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
             duration=rng.integers(1, 90, n).astype(np.int64) * 1_000,
             created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
    j.check_columns(JCols(**c), now_ms=NOW)
    t.check_columns(TCols(**c), now_ms=NOW)
    for now in (NOW, NOW + 30_000):
        want = jtel.finish_scan(j.telemetry_begin(now))
        _same_snapshot(ttel.finish_scan(t.telemetry_begin(now)), want)
        _same_snapshot(jtel.finish_scan(t.telemetry_begin(now)), want)
        d = ttel.finish_scan(t.telemetry_begin(now)).to_dict()
        w = want.to_dict()
        d.pop("scan_ms"), w.pop("scan_ms")
        assert d == w

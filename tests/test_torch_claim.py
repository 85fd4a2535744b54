"""Port parity: the probe + claim (gubernator_tpu_torch.ops.kernel2
._probe_claim2) against the JAX package's, field by field, including the
sweep-write routing fields ``got``, ``order``, ``tgt_sorted`` and
``written_sorted`` that the windowed sweeps of exp/ read.

Inputs are made from a numpy seed and handed to both packages. Cases:
duplicate fingerprints (the conflict dedup), owners next to inserters in
one bucket, expired and live lanes, inactive rows, and a block whose run
overflows its u-window. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops.table2 import K

torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _split(v: np.ndarray):
    """int64 → (lo, hi) int32 words, as the table stores them."""
    v = np.asarray(v, dtype=np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (v >> 32).astype(np.int32)


def _table(rng, nb: int, held: np.ndarray, fill: float) -> np.ndarray:
    """A full-layout table with `fill` of its lanes occupied: some by the
    keys in `held` (in their own bucket), the rest by other keys; expiries
    spread around NOW, so some lanes are dead."""
    rows = np.zeros((nb, K, 16), dtype=np.int32)
    occ = rng.random((nb, K)) < fill
    other = rng.integers(1, 2**62, (nb, K), dtype=np.int64)
    lo, hi = _split(other)
    rows[..., 0] = np.where(occ, lo, 0)
    rows[..., 1] = np.where(occ, hi, 0)
    exp = NOW + rng.integers(-5_000, 5_000, (nb, K))
    elo, ehi = _split(exp)
    rows[..., 10], rows[..., 11] = elo, ehi
    for j, fp in enumerate(held):
        b, k = int(fp % nb), j % K
        (flo,), (fhi,) = _split([fp])
        (elo,), (ehi,) = _split([NOW + 60_000])
        rows[b, k, 0], rows[b, k, 1], rows[b, k, 10], rows[b, k, 11] = flo, fhi, elo, ehi
    return rows.reshape(nb, K * 16)


def _both(rows: np.ndarray, fp: np.ndarray, active: np.ndarray, blk: int, u: int):
    now = np.full(fp.shape[0], NOW, dtype=np.int64)
    jc = jax.jit(lambda r, f, n, a: jk._probe_claim2(r, f, n, a, blk, u))(
        jnp.asarray(rows), jnp.asarray(fp), jnp.asarray(now), jnp.asarray(active))
    tc = tk._probe_claim2(torch.from_numpy(rows), torch.from_numpy(fp),
                          torch.from_numpy(now), torch.from_numpy(active), blk, u)
    return jc, tc


def _assert_same(jc, tc):
    assert tk.Claim2._fields == jk.Claim2._fields
    for name in jk.Claim2._fields:
        j = np.asarray(getattr(jc, name))
        t = getattr(tc, name).numpy()
        if name == "chosen":  # int32 in JAX, int64 lane index in the port
            j = j.astype(np.int64)
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def test_claim_duplicates_on_empty_table():
    """exp_sweep4's correctness geometry: 2^14 slots, 2^10 rows, the first
    100 rows one fingerprint, sweep geometry: only K of those 100 inserters
    find a lane in their one bucket."""
    rng = np.random.default_rng(11)
    nb, B = (1 << 14) // K, 1 << 10
    blk, u = tk.sweep_geometry(nb, B)
    fp = rng.integers(1, 2**63 - 1, B, dtype=np.int64)
    fp[:100] = fp[0]
    rows = np.zeros((nb, K * 16), dtype=np.int32)
    jc, tc = _both(rows, fp, np.ones(B, dtype=bool), blk, u)
    _assert_same(jc, tc)
    assert int(tc.got.sum()) == B - 100 + K


@pytest.mark.parametrize("seed", [0, 1])
def test_claim_overflow_owners_and_dead_lanes(seed):
    """A held table, owners and inserters in shared buckets, inactive rows,
    repeated fingerprints, and a window small enough that hot blocks
    overflow it."""
    rng = np.random.default_rng(seed)
    nb, B, blk, u = 64, 256, 8, 6
    held = rng.integers(1, 2**40, 48, dtype=np.int64) * nb + rng.integers(0, 16, 48)
    fresh = rng.integers(1, 2**40, 400, dtype=np.int64) * nb + rng.integers(0, nb, 400)
    rows = _table(rng, nb, held, fill=0.4)
    fp = np.concatenate([held, fresh])[rng.permutation(448)[:B]]
    fp[rng.integers(0, B, 20)] = fp[rng.integers(0, B, 20)]  # repeats
    active = rng.random(B) < 0.9
    jc, tc = _both(rows, fp, active, blk, u)
    _assert_same(jc, tc)
    assert bool(tc.owns.any()) and bool(tc.evict_live.any())
    # the window really dropped rows that had a lane and no duplicate
    tgt = tc.tgt_sorted
    dup = torch.zeros_like(tc.written_sorted)
    dup[1:] = tgt[1:] == tgt[:-1]
    assert bool(((tgt < nb * K) & ~dup & ~tc.written_sorted).any())

"""Port parity: the ring drain (gubernator_tpu_torch.ops.ring_drain) against
the JAX package.

* The fence claim: ``make_fence_claim`` on CPU tensors (the kernel's plain
  version) against the JAX package's ``make_fence_claim(interpret=True)``
  and its numpy oracle ``fence_claim_ref``, on the cases of
  tests/test_ring_drain.py (gap, wrap, k bound, nothing published, head
  unpublished) and random ones, with int32 and int64 fence words.
* The slice as a whole: ``prepare_ring_slot`` × k → ``DeviceRing.stage`` →
  ``DeviceRing.drain`` → ``finish_check_columns`` per slot, as the service
  runner drives it, against JAX's ``DeviceRing`` on engines in the same
  state, for both probes (S = 4 slots, W = 64 rows, K = 3): contended keys
  that repeat across slots (claim drops retried through ``fixup``), a ring
  loaded mid-lap so tickets wrap, and a group whose last slot is not
  published (n < k: that bank row is zero, the table untouched by it).

Tolerance: exact — table bytes, ``seq_out``, the bank, n, responses and
stats.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import engine as je
from gubernator_tpu.ops import ring_drain as jr
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.service.wire import WireBatch as JWireBatch
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.ops import ring_drain as tr
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.service.wire import wire_batch_from_columns

torch.set_num_threads(1)

NOW = 1_700_000_000_000
S, W, K = 4, 64, 3


def _publish(seq_in, tickets):
    for t in tickets:
        seq_in[t % seq_in.shape[0]] = t + 1
    return seq_in


CASES = [
    # (slots, published tickets, start, k) — contiguous, gap, wrap, k-bound
    (4, [0, 1, 2], 0, 4),
    (4, [0, 2, 3], 0, 4),
    (4, [4, 5, 6, 7], 4, 4),
    (8, list(range(6)), 0, 2),
    (4, [], 0, 4),
    (4, [1, 2], 0, 4),
    (4, [5, 6, 7, 8], 6, 4),  # starts mid-lap, wraps slot 3 → 0
]


@pytest.mark.parametrize("case", CASES)
def test_fence_claim_matches_jax_and_oracle(case):
    slots, tickets, start, k = case
    width = 6
    rng = np.random.default_rng(42 + slots + len(tickets))
    grids = rng.integers(-5, 100, size=(slots, 5, width + 1), dtype=np.int32)
    seq_in = _publish(np.zeros(slots, dtype=np.int32), tickets)
    seq_out = rng.integers(0, 3, slots).astype(np.int32)
    n_ref, bank_ref, seq_out_ref = jr.fence_claim_ref(seq_in, seq_out, grids, start, k)
    ctl = np.asarray([start, k], dtype=np.int32)
    so_j, bank_j, n_j = jr.make_fence_claim(slots, width, k_max=k, interpret=True)(
        seq_in, seq_out.copy(), grids, ctl)
    fn = tr.make_fence_claim(slots, width, k_max=k)
    so_t, bank_t, n_t = fn(torch.from_numpy(seq_in), torch.from_numpy(seq_out.copy()),
                           torch.from_numpy(grids), ctl)
    assert int(n_t[0]) == int(n_j[0]) == n_ref
    np.testing.assert_array_equal(so_t.numpy(), np.asarray(so_j))
    np.testing.assert_array_equal(so_t.numpy(), seq_out_ref)
    np.testing.assert_array_equal(bank_t.numpy()[:n_ref], np.asarray(bank_j)[:n_ref])
    np.testing.assert_array_equal(bank_t.numpy()[:n_ref], bank_ref)
    assert not bank_t.numpy()[n_ref:].any()  # the port defines the rest: zeros


@pytest.mark.parametrize("seed", range(4))
def test_fence_claim_random_int64(seed):
    """int64 fence words (DeviceRing's), random publish patterns, k_max
    above and below S, against the oracle."""
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(2, 9))
    start = int(rng.integers(0, 3 * slots))
    tickets = [t for t in range(start, start + slots) if rng.random() < 0.8]
    grids = rng.integers(-(2**31), 2**31, size=(slots, 5, 4), dtype=np.int64).astype(np.int32)
    seq_in = _publish(np.zeros(slots, dtype=np.int64), tickets)
    seq_out = seq_in.copy()
    k = int(rng.integers(0, slots + 3))
    k_max = max(1, int(rng.integers(k, k + 3)))
    n_ref, bank_ref, seq_out_ref = jr.fence_claim_ref(seq_in, seq_out, grids, start, k)
    so = torch.from_numpy(seq_out.copy())
    bank, n = tr.fence_claim(torch.from_numpy(seq_in), so, torch.from_numpy(grids),
                             start, k, k_max)
    assert int(n[0]) == n_ref
    np.testing.assert_array_equal(so.numpy(), seq_out_ref)
    np.testing.assert_array_equal(bank.numpy()[:n_ref], bank_ref)
    assert bank.shape[0] == k_max and not bank.numpy()[n_ref:].any()


def test_fence_claim_rejects_bad_operands():
    g = torch.zeros((4, 5, 7), dtype=torch.int32)
    with pytest.raises(TypeError):
        tr.fence_claim(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64),
                       g, 0, 1, 1)
    with pytest.raises(ValueError):
        tr.fence_claim(torch.zeros(3, dtype=torch.int64), torch.zeros(3, dtype=torch.int64),
                       g, 0, 1, 1)
    with pytest.raises(ValueError):
        tr.fence_claim(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
                       g, 0, 1, 0)


# ----------------------------------------------------------- whole slice


def _slot_cols(rng, n, pool, nb, hot_bucket=None):
    """Unique keys within a slot, repeated across slots; a third of them
    land in four hot buckets (more than K inserters per bucket), or 40% in
    `hot_bucket`."""
    fp = rng.choice(pool, n, replace=False)
    hot = rng.random(n) < (0.3 if hot_bucket is None else 0.4)
    keys = rng.integers(1, 1 << 40, int(hot.sum())) * nb
    fp[hot] = keys + (rng.integers(0, 4, int(hot.sum())) if hot_bucket is None else hot_bucket)
    fp = np.unique(fp)
    m = fp.shape[0]
    algo = rng.integers(0, 5, m).astype(np.int32)
    algo[0] = 1  # every slot has a leaky row: one math mode ("mixed") per group
    err = np.zeros(m, np.int8)
    err[rng.random(m) < 0.05] = 1
    return TCols(
        fp=np.where(err == 0, fp, 0), algo=algo,
        behavior=rng.choice([0, 8, 32, 64], m).astype(np.int32),
        hits=rng.integers(0, 4, m).astype(np.int64),
        limit=rng.integers(1, 8, m).astype(np.int64), burst=np.zeros(m, np.int64),
        duration=rng.integers(1, 4, m).astype(np.int64) * 1_000,
        created_at=np.zeros(m, np.int64), err=err,
    )


def _setup(probe, load=None):
    jeng = je.LocalEngine(capacity=256, write_mode="xla", wire="compact", probe=probe)
    teng = te.LocalEngine(capacity=256, write_mode="xla", wire="compact", probe=probe,
                          device="cpu")
    jring = jr.DeviceRing(S, W, K)
    tring = tr.DeviceRing(S, W, K, device="cpu")
    if load is not None:
        grids, seq_in, seq_out = load
        jring.grids = jnp.asarray(grids)
        jring.seq_in = jnp.asarray(seq_in)
        jring.seq_out = jnp.asarray(seq_out)
        tring.load_state(grids, seq_in, seq_out)
    return jeng, teng, jring, tring


def _group(rng, engines, now, n_slots, pool, hot_bucket=None):
    """Prepare the same slots on both engines."""
    out = {"j": [], "t": []}
    for _ in range(n_slots):
        cols = _slot_cols(rng, int(rng.integers(20, W)), pool, 32, hot_bucket)
        wb = wire_batch_from_columns(cols)
        jwb = JWireBatch(JCols(*cols), wb.lanes, wb.encodable, 0)
        pj = je.prepare_ring_slot(engines[0], [jwb], W, now_ms=now)
        pt = te.prepare_ring_slot(engines[1], [wb], W, now_ms=now)
        assert pj is not None and pt is not None and pj.math == pt.math == "mixed"
        np.testing.assert_array_equal(pt.grid, pj.grid)
        out["j"].append(pj)
        out["t"].append(pt)
    return out["j"], out["t"]


def _drain_both(jeng, teng, jring, tring, gj, gt, start, publish=None):
    publish = len(gj) if publish is None else publish
    for i in range(publish):
        jring.stage((start + i) % S, gj[i].grid, start + i)
    jbank, jn = jring.drain(jeng, start, len(gj), gj[0].math, gj[0].cascade)
    if publish == len(gt):
        tbank, tn = tr.issue_ring_group(teng, tring, gt, start)
    else:
        for i in range(publish):
            tring.stage((start + i) % S, gt[i].grid, start + i)
        tbank, tn = tring.drain(teng, start, len(gt), gt[0].math, gt[0].cascade)
    jbank = np.asarray(jbank)
    assert int(tn[0]) == int(jn) == publish
    np.testing.assert_array_equal(tbank.numpy(), jbank)
    np.testing.assert_array_equal(tring.seq_out.numpy(), np.asarray(jring.seq_out))
    assert teng.snapshot().tobytes() == np.asarray(jeng.table.rows).tobytes()
    return jbank, tbank, tn


def _finish_both(jeng, teng, gj, gt, jbank, tbank, tn):
    done_t = tr.finish_ring_group(teng, gt, tbank, tn, lambda fn: fn())
    for i, (pj, (rc_t, delta_t)) in enumerate(zip(gj, done_t)):
        pj.pending.passes[0][3] = jbank[i]
        rc_j, delta_j = je.finish_check_columns(jeng, pj.pending, lambda fn: fn())
        jeng.stats.merge(delta_j)
        teng.stats.merge(delta_t)
        for f in rc_j._fields:
            np.testing.assert_array_equal(getattr(rc_t, f), getattr(rc_j, f), err_msg=f)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.snapshot().tobytes() == np.asarray(jeng.table.rows).tobytes()


@pytest.mark.parametrize("probe", ["xla", "pallas"])
def test_ring_sequence_matches_jax(probe):
    rng = np.random.default_rng(51)
    pool = rng.integers(1, 2**63 - 1, 400, dtype=np.int64)
    # mid-lap: tickets 0..5 were consumed, slots hold old grids
    old = rng.integers(-(2**31), 2**31, size=(S, 5, W + 1), dtype=np.int64).astype(np.int32)
    fences = np.array([5, 6, 3, 4], dtype=np.int64)
    jeng, teng, jring, tring = _setup(probe, load=(old, fences, fences.copy()))
    start, now = 6, NOW
    for _ in range(2):
        gj, gt = _group(rng, (jeng, teng), now, K, pool)
        _finish_both(jeng, teng, gj, gt, *_drain_both(jeng, teng, jring, tring, gj, gt, start))
        start += K
        now += int(rng.integers(200, 1_500))
    assert teng.stats.dropped + teng.stats.evicted_unexpired > 0
    assert teng.stats.dispatches > 2 * K  # claim drops were retried


def test_ring_partial_group_leaves_rest_zero():
    """Two of a group of three published: n = 2, bank row 2 is zero, and the
    table equals the JAX drain's (the unpublished position wrote nothing)."""
    rng = np.random.default_rng(52)
    pool = rng.integers(1, 2**63 - 1, 400, dtype=np.int64)
    jeng, teng, jring, tring = _setup("xla")
    gj, gt = _group(rng, (jeng, teng), NOW, K, pool)
    before = teng.snapshot()
    _jbank, tbank, tn = _drain_both(jeng, teng, jring, tring, gj, gt, 0, publish=2)
    assert not tbank[2].any() and tbank[:2].any()
    assert teng.snapshot().tobytes() != before.tobytes()
    with pytest.raises(RuntimeError, match="fence violation"):
        tr.finish_ring_group(teng, gt, tbank, tn, lambda fn: fn())


def test_defaults_and_geometry():
    assert tr.default_ring_issue("cpu") == "host"
    assert tr.default_ring_issue() == tr.default_ring_issue("cuda") == "fused"
    assert tr.egress_rows(W, False) == jr.egress_rows(W, False) == W + 2
    assert tr.egress_rows(W, True) == jr.egress_rows(W, True) == 5 * W + 2
    ring = tr.DeviceRing(4, 8, 9, device="cpu")
    assert ring.drain_k == 4 and tuple(ring.grids.shape) == (4, 5, 9)
    with pytest.raises(ValueError):
        tr.DeviceRing(1, 8, 1, device="cpu")
    with pytest.raises(ValueError):
        ring.load_state(np.zeros((4, 5, 8), np.int32), np.zeros(4), np.zeros(4))


def test_drain_retries_after_the_group():
    """A drain retries a slot's dropped claims only after every slot of the
    group is decided (the JAX runner's order). With claims dropping in a
    hot bucket, the port's ring equals JAX's ring and the port's own
    pipelined prepare/issue/finish in that order, while serving the same
    slots one by one through check_columns leaves another table — in the
    JAX package too."""
    rng = np.random.default_rng(53)
    pool = rng.integers(1, 2**63 - 1, 400, dtype=np.int64)
    jeng, teng, jring, tring = _setup("xla")
    gj, gt = _group(rng, (jeng, teng), NOW, K, pool, hot_bucket=3)
    _finish_both(jeng, teng, gj, gt, *_drain_both(jeng, teng, jring, tring, gj, gt, 0))
    assert teng.stats.dispatches > K  # claims dropped and were retried
    pipe = te.LocalEngine(capacity=256, write_mode="xla", wire="compact", device="cpu")
    pend = [te.issue_check_columns(pipe, te.prepare_check_columns(pipe, p.pending.hb._parts[0],
                                                                    now_ms=NOW))
            for p in gt]
    for p in pend:
        pipe.stats.merge(te.finish_check_columns(pipe, p, lambda fn: fn())[1])
    assert pipe.snapshot().tobytes() == teng.snapshot().tobytes()
    assert dataclasses.asdict(pipe.stats) == dataclasses.asdict(teng.stats)
    serial = je.LocalEngine(capacity=256, write_mode="xla", wire="compact")
    for p in gj:
        serial.check_columns(p.pending.hb._parts[0], now_ms=NOW)
    assert np.asarray(serial.table.rows).tobytes() != np.asarray(jeng.table.rows).tobytes()

"""Port parity: the pipelined prepare → issue → finish protocol and the fused
wire front door (gubernator_tpu_torch.ops.engine) against the JAX package.

Both packages' engines (compact wire, ``write_mode="xla"``) see the same
batches, made from a seed: a multi-pass batch with duplicate keys (its pass
outputs fuse into one stacked fetch), claim drops in a one-bucket table
retried through ``fixup``, a single-pass cascade batch (folded in the
dispatch), and ``prepare_check_wire`` over pre-packed parser lanes, with a
batch it must refuse. Tolerance: exact — responses, the stats deltas and
raw table bytes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from gubernator_tpu.ops import engine as je
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.service.wire import WireBatch as JWireBatch
from gubernator_tpu_torch.ops import engine as te
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.service.wire import wire_batch_from_columns

torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _engines(capacity=1 << 10):
    j = je.LocalEngine(capacity=capacity, write_mode="xla", wire="compact")
    t = te.LocalEngine(capacity=capacity, write_mode="xla", wire="compact", device="cpu")
    return j, t


def _cols(rng, n, fp=None, algos=(0, 1, 2, 3, 4), behavior=None):
    fp = rng.integers(1, 2**63 - 1, n, dtype=np.int64) if fp is None else fp
    algo = rng.choice(algos, n).astype(np.int32)
    return dict(
        fp=fp, algo=algo,
        behavior=(rng.choice([0, 8, 32, 64], n) if behavior is None else behavior)
        .astype(np.int32),
        hits=rng.integers(0, 4, n).astype(np.int64),
        limit=rng.integers(1, 9, n).astype(np.int64),
        burst=np.zeros(n, np.int64),
        duration=rng.integers(1, 5, n).astype(np.int64) * 1_000,
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )


def _same(j, t, a, b, ctx):
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"{ctx}: {f}")
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats), ctx
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes(), ctx


def _pipeline(mod, eng, cols, now):
    pending = mod.prepare_check_columns(eng, cols, now_ms=now)
    pending = mod.issue_check_columns(eng, pending)
    rc, delta = mod.finish_check_columns(eng, pending, lambda fn: fn())
    eng.stats.merge(delta)
    return rc, pending


def test_pipeline_multi_pass_stacks_one_fetch():
    rng = np.random.default_rng(41)
    j, t = _engines()
    for step in range(2):
        c = _cols(rng, 48, algos=(0, 1))
        c["fp"][24:40] = c["fp"][:16]  # duplicates: two passes of 16-row pads
        c["fp"][40:44] = c["fp"][0]
        now = NOW + 700 * step
        a, pj = _pipeline(je, j, JCols(**c), now)
        b, pt = _pipeline(te, t, TCols(**c), now)
        assert len(pt.passes) == len(pj.passes) >= 2
        assert (pt.stacked is None) == (pj.stacked is None)
        _same(j, t, a, b, f"step {step}")
    assert t.stats.dispatches >= 4


def test_pipeline_claim_drops_retry_through_fixup():
    """One bucket of K = 8 lanes and 28 new keys per batch, two claim
    attempts: claims drop, finish re-dispatches them on the 'engine
    thread' (fixup), and the rows left answer ERR_DROPPED."""
    rng = np.random.default_rng(42)
    j, t = _engines(capacity=8)
    j.max_claim_retries = t.max_claim_retries = 2
    for step in range(2):
        c = _cols(rng, 28, algos=(0,))
        now = NOW + step
        a, _ = _pipeline(je, j, JCols(**c), now)
        b, _ = _pipeline(te, t, TCols(**c), now)
        _same(j, t, a, b, f"step {step}")
    assert t.stats.dropped > 0 and t.stats.evicted_unexpired > 0


def test_pipeline_single_pass_cascade():
    rng = np.random.default_rng(43)
    j, t = _engines()
    lvl = np.array([0, 1, 2, 0, 1, 0, 0, 3] * 2) << 8
    for step in range(3):
        c = _cols(rng, 16, behavior=lvl)
        c["limit"][:] = 2
        now = NOW + 10 * step
        a, pj = _pipeline(je, j, JCols(**c), now)
        b, pt = _pipeline(te, t, TCols(**c), now)
        assert pt.casc_intrace and pj.casc_intrace
        _same(j, t, a, b, f"step {step}")
    assert (b.status != 0).any()


def test_prepare_check_wire_matches():
    rng = np.random.default_rng(44)
    j, t = _engines(capacity=256)
    for step in range(3):
        parts_t, parts_j = [], []
        for n in (5, 11):  # two requests scattered into one grid
            c = TCols(**_cols(rng, n))
            c.created_at[0] = NOW + step * 900 - 300
            c.err[-1] = 1 if n == 11 else 0  # an error row rides inactive
            wb = wire_batch_from_columns(c)
            parts_t.append(wb)
            parts_j.append(JWireBatch(cols=JCols(*c), lanes=wb.lanes,
                                      encodable=wb.encodable, nbytes=0))
        now = NOW + step * 900
        pj = je.prepare_check_wire(j, parts_j, now_ms=now)
        pt = te.prepare_check_wire(t, parts_t, now_ms=now)
        assert pj is not None and pt is not None
        out = []
        for mod, eng, p in ((je, j, pj), (te, t, pt)):
            rc, delta = mod.finish_check_columns(eng, mod.issue_check_columns(eng, p),
                                                 lambda fn: fn())
            eng.stats.merge(delta)
            out.append(rc)
        _same(j, t, out[0], out[1], f"step {step}")
    # a duplicate key needs the pass planner: both refuse the fused path
    dup = wire_batch_from_columns(TCols(**_cols(rng, 4, fp=np.array([7, 8, 7, 9]))))
    assert te.prepare_check_wire(t, [dup]) is None
    assert je.prepare_check_wire(j, [JWireBatch(JCols(*dup.cols), dup.lanes,
                                                dup.encodable, 0)]) is None


def test_stack_pass_outputs_dtype_guard():
    a64 = torch.zeros((4, 4), dtype=torch.int64)
    a32 = torch.zeros((4, 4), dtype=torch.int32)
    assert te._stack_pass_outputs([a64, a32]) is None
    assert te._stack_pass_outputs([a64]) is None
    assert te._stack_pass_outputs([a32, torch.zeros((6, 4), dtype=torch.int32)]) is None
    got = te._stack_pass_outputs([a32, a32])
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 4, 4)
    assert je._stack_pass_outputs([jnp.zeros((4, 4), jnp.int64), jnp.zeros((4, 4), jnp.int32)]) \
        is None

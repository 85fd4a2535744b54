"""Port parity: the decide loop (gubernator_tpu_torch.ops.loop) and the bench
guards (gubernator_tpu_torch.bench_guard) against the JAX package.

``decide_loop`` on the CPU is the plain loop of ``decide2_impl`` over the
stacked batches; it must leave the same table bytes and the same [hits,
misses, over, dropped] totals as JAX's ``decide_loop`` (one jitted
fori_loop) for both probes — ``xla`` and the fused walk ``pallas`` (JAX in
interpret mode) — and both write modes, with k not a multiple of the
number of batches, keys repeated across batches, and one batch half
padding. The bench guards are held to the JAX module on a grid of inputs:
the same verdicts, rates and refusal texts. Tolerance: exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu import bench_guard as jbg
from gubernator_tpu.ops import loop as jloop
from gubernator_tpu.ops.batch import ReqBatch as JReq
from gubernator_tpu.ops.table2 import new_table2 as jnew
from gubernator_tpu_torch import bench_guard as tbg
from gubernator_tpu_torch.ops import loop as tloop
from gubernator_tpu_torch.ops.batch import ReqBatch as TReq
from gubernator_tpu_torch.ops.kernel2 import decide2_impl
from gubernator_tpu_torch.ops.table2 import new_table2 as tnew

torch.set_num_threads(1)

NOW = 1_700_000_000_000


def _batch_np(rng, pool, b, active=None):
    fp = rng.choice(pool, b, replace=False)
    act = np.ones(b, bool) if active is None else active
    fp = np.where(act, fp, 0)
    hits = rng.integers(0, 3, b).astype(np.int64)
    return dict(
        fp=fp, algo=np.zeros(b, np.int32), behavior=np.zeros(b, np.int32), hits=hits,
        limit=np.full(b, 5, np.int64), burst=np.zeros(b, np.int64),
        duration=np.full(b, 60_000, np.int64), created_at=np.full(b, NOW, np.int64),
        expire_new=np.full(b, NOW + 60_000, np.int64), greg_interval=np.zeros(b, np.int64),
        duration_eff=np.full(b, 60_000, np.int64), active=act,
    )


def _batches(seed, b=256, n=3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**62, 700, dtype=np.int64)  # keys repeat across batches
    out = [_batch_np(rng, pool, b) for _ in range(n - 1)]
    out.append(_batch_np(rng, pool, b, active=np.arange(b) < b // 2))  # half padding
    return out


@pytest.mark.parametrize("probe,write", [("xla", "xla"), ("xla", "sparse"), ("pallas", "xla")])
def test_decide_loop_matches_jax(probe, write):
    nps = _batches(seed=3)
    k = 7
    jst = jloop.stack_batches([JReq(**{f: jnp.asarray(v) for f, v in d.items()}) for d in nps])
    jt, jacc = jloop.decide_loop(jnew(1 << 12), jst, jnp.int32(k), write=write,
                                 math="token", probe=probe)
    tst = tloop.stack_batches([TReq(**{f: torch.from_numpy(v) for f, v in d.items()})
                               for d in nps])
    assert tst.fp.shape == (3, 256) and tst.active.dtype == torch.bool
    tt, tacc = tloop.decide_loop(tnew(1 << 12, device="cpu"), tst, k, write=write,
                                 math="token", probe=probe)
    assert tacc.dtype == torch.int64 and tacc.shape == (4,)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tt.rows.numpy().tobytes() == np.asarray(jt.rows).tobytes()
    # the proof of work: every active row decided once per iteration
    active = sum(int(nps[i % 3]["active"].sum()) for i in range(k))
    assert jbg.check_work(int(tacc[0] + tacc[1]), active) is None
    assert tbg.check_work(int(tacc[0] + tacc[1]), active) is None


def test_decide_loop_equals_sequential_dispatches_and_any_k():
    """k iterations == k decide2_impl calls; k = 0 touches nothing."""
    nps = _batches(seed=5, b=64, n=2)
    reqs = [TReq(**{f: torch.from_numpy(v) for f, v in d.items()}) for d in nps]
    st = tloop.stack_batches(reqs)
    t0 = tnew(1 << 10, device="cpu")
    _, acc0 = tloop.decide_loop(t0, st, 0, write="xla", math="token")
    assert acc0.tolist() == [0, 0, 0, 0] and not t0.rows.any()
    seq = tnew(1 << 10, device="cpu")
    for k in (2, 4):  # an even k: each call starts again at batch 0
        tot = np.zeros(4, np.int64)
        for i in range(k):
            _, _, s = decide2_impl(seq, reqs[i % 2], write="xla", math="token")
            tot += [int(s.cache_hits), int(s.cache_misses), int(s.over_limit), int(s.dropped)]
        t, acc = tloop.decide_loop(t0, st, k, write="xla", math="token")
        assert torch.equal(t.rows, seq.rows)
        np.testing.assert_array_equal(acc.numpy(), tot)
    with pytest.raises(ValueError):
        tloop.decide_loop(tnew(1 << 10, device="meta"), st, 1)


_SLOPES = list(itertools.product(
    (0.0, 0.01, 0.2, 1.0), (0.0, 0.05, 0.3, 1.5, 30.0), (1, 4), (4, 68, 1 << 20), (1, 1 << 17),
))


def _outcome(fn, *a, **kw):
    """fn's result as a tuple, or the type of what it raised."""
    try:
        return tuple(fn(*a, **kw))
    except ZeroDivisionError as e:
        return type(e)


@pytest.mark.parametrize("chunk", range(4))
def test_bench_guard_matches_jax(chunk):
    assert tbg.MAX_SANE_RATE == jbg.MAX_SANE_RATE
    assert (tbg.MAX_SANE_BANDWIDTH, tbg.MIN_SANE_BANDWIDTH) == (jbg.MAX_SANE_BANDWIDTH,
                                                                jbg.MIN_SANE_BANDWIDTH)
    for t_s, t_l, n_s, n_l, rows in _SLOPES[chunk::4]:
        for kw in ({}, {"min_dt": 0.0, "min_ratio": 1.0}, {"max_rate": 1e15}):
            got = _outcome(tbg.slope, t_s, t_l, n_s, n_l, rows, **kw)
            assert got == _outcome(jbg.slope, t_s, t_l, n_s, n_l, rows, **kw)
    for counted, expected in ((10, 10), (9, 10), (0, 0)):
        assert tbg.check_work(counted, expected, label="x") == jbg.check_work(
            counted, expected, label="x")
    for dropped, dec in ((0, 100), (1, 100), (2, 100), (5, 0), (50, 1000)):
        for frac in (0.01, 0.0):
            assert tbg.check_dropped(dropped, dec, max_frac=frac) == jbg.check_dropped(
                dropped, dec, max_frac=frac)
    for s, nbytes in ((0.0, 1024), (0.1, 0), (0.1, -5), (1e-9, 1 << 30), (10.0, 8),
                      (0.01, 1 << 20), (5.0, 1024)):
        for kw in ({}, {"min_bandwidth": 0.0}, {"max_bandwidth": 1e20, "label": "w"}):
            assert tbg.check_transport(s, nbytes, **kw) == jbg.check_transport(s, nbytes, **kw)
    assert not issubclass(tbg.WorkMismatchError, RuntimeError)
    assert isinstance(tbg.slope(0.1, 0.3, 4, 68, 1 << 17), tbg.Slope)

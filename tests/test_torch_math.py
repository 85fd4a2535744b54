"""Port parity: the decision math (gubernator_tpu_torch.ops.math.bucket_math,
through kernel2.decide_payload) against the JAX package in all four static
modes.

The same stored lanes and request rows, made from a seed with numpy, go
through both. The rows cover the five algorithms, stored state of the same
and of another algorithm, expired and absent items, negative hits,
RESET_REMAINING, DRAIN_OVER_LIMIT, Gregorian rows, limit 0, the int32
extremes and leaky rows with duration 0 (whose float64 leak is infinite and
exercises the saturating float→int conversion). Tolerance: exact — every
Decision field, float64 remainders compared as raw bits, and the int32
write payload, which holds the leaky remainder as an f32 hi/lo pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops.batch import ReqBatch as JReq
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops.batch import ReqBatch as TReq
from gubernator_tpu_torch.ops.math import bucket_math, f64_to_i64

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

NOW = 1_700_000_000_000
B = 256
I32_MAX = 2**31 - 1

MODE_ALGOS = {
    "token": [0],
    "gcra": [2],
    "int": [0, 2, 3, 4],
    "mixed": [0, 1, 2, 3, 4],
}


def _split_f64(x: np.ndarray):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi.view(np.int32), lo.view(np.int32)


def _case(mode: str, seed: int):
    """(lane16 (B,16) i32, request columns dict, owns (B,) bool)."""
    rng = np.random.default_rng(seed)
    algos = np.asarray(MODE_ALGOS[mode])
    now = NOW + rng.integers(0, 3, B) * 1000
    algo = rng.choice(algos, B).astype(np.int32)
    # ---- requests
    limit = rng.integers(0, 12, B).astype(np.int64)
    limit[rng.random(B) < 0.05] = I32_MAX
    limit[rng.random(B) < 0.05] = 0
    hits = rng.integers(-3, 7, B).astype(np.int64)
    hits[rng.random(B) < 0.03] = I32_MAX
    burst = np.where(rng.random(B) < 0.5, limit, rng.integers(0, 12, B)).astype(np.int64)
    burst[rng.random(B) < 0.03] = -I32_MAX
    duration = rng.choice([1_000, 2_000, 60_000], B).astype(np.int64)
    leaky = algo == 1
    duration[leaky & (rng.random(B) < 0.1)] = 0
    behavior = np.zeros(B, dtype=np.int32)
    behavior[rng.random(B) < 0.12] |= 8  # RESET_REMAINING
    behavior[rng.random(B) < 0.15] |= 32  # DRAIN_OVER_LIMIT
    behavior |= (rng.integers(0, 4, B) << 6).astype(np.int32)  # priority tier
    greg = (rng.random(B) < 0.1) & (duration > 0)
    greg_interval = np.where(greg, np.where(rng.random(B) < 0.5, 60_000, 3_600_000), 0)
    behavior[greg] |= 4  # DURATION_IS_GREGORIAN
    expire_new = np.where(greg, now - now % np.maximum(greg_interval, 1)
                          + greg_interval - 1, now + duration)
    duration_eff = np.where(greg, expire_new - now, duration)
    active = rng.random(B) < 0.95
    fp = np.where(active, rng.integers(1, 2**63 - 1, B, dtype=np.int64), 0)
    req = dict(
        fp=fp, algo=algo, behavior=behavior, hits=hits, limit=limit,
        burst=burst, duration=duration, created_at=now, expire_new=expire_new,
        greg_interval=greg_interval.astype(np.int64),
        duration_eff=duration_eff.astype(np.int64), active=active,
    )
    # ---- stored lanes: mostly the request's own algorithm and config
    s_algo = np.where(rng.random(B) < 0.8, algo, rng.choice(algos, B)).astype(np.int64)
    s_limit = np.where(rng.random(B) < 0.7, limit, rng.integers(0, 12, B))
    s_burst = np.where(rng.random(B) < 0.7, burst, rng.integers(0, 12, B))
    s_dur = np.where(rng.random(B) < 0.8, duration, rng.choice([1_000, 3_000], B))
    s_rem = rng.integers(-2, 14, B)
    s_status = (rng.random(B) < 0.2).astype(np.int64)
    s_stamp = now - rng.integers(0, 4_000, B)
    # sliding windows: stamps on this window's or the previous window's start
    wdur = np.maximum(duration_eff, 1)
    ws = now - now % wdur
    win = s_algo == 3
    s_stamp = np.where(win, np.where(rng.random(B) < 0.5, ws, ws - wdur), s_stamp)
    s_exp = now + rng.integers(-1_500, 5_000, B)
    s_exp = np.where(rng.random(B) < 0.1, now, s_exp)  # expires now: still live
    # REMF pair: the leaky f64 remainder as f32 hi/lo, or a raw int64 aux
    rem_f = rng.integers(0, 14, B) + rng.random(B) * 0.75
    f_hi, f_lo = _split_f64(rem_f)
    aux = np.where(s_algo == 2, now + rng.integers(-3_000, 9_000, B),
                   rng.integers(0, 12, B))
    remf_hi = np.where(s_algo == 1, f_hi, (aux >> 32).astype(np.int32))
    remf_lo = np.where(s_algo == 1, f_lo, (aux & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    lo32 = lambda x: (np.asarray(x, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi32 = lambda x: (np.asarray(x, dtype=np.int64) >> 32).astype(np.int32)
    lane16 = np.stack(
        [lo32(fp), hi32(fp), s_limit.astype(np.int32), s_burst.astype(np.int32),
         s_rem.astype(np.int32), (s_algo | (s_status << 8)).astype(np.int32),
         lo32(s_dur), hi32(s_dur), lo32(s_stamp), hi32(s_stamp),
         lo32(s_exp), hi32(s_exp), remf_hi, remf_lo,
         np.zeros(B, np.int32), np.zeros(B, np.int32)],
        axis=1,
    ).astype(np.int32)
    owns = active & (rng.random(B) < 0.75)
    return lane16, req, owns


_REQ_DTYPES = dict(algo=np.int32, behavior=np.int32, active=bool)

_jax_decide = jax.jit(jk.decide_payload, static_argnames=("math",))


def _jax_req(req):
    return JReq(**{k: jnp.asarray(np.asarray(v, dtype=_REQ_DTYPES.get(k, np.int64)))
                   for k, v in req.items()})


def _torch_req(req):
    tdt = {np.int32: torch.int32, np.int64: torch.int64, bool: torch.bool}
    return TReq(**{k: torch.from_numpy(np.asarray(v, dtype=_REQ_DTYPES.get(k, np.int64))).to(
        tdt[_REQ_DTYPES.get(k, np.int64)]) for k, v in req.items()})


def _as_bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int64) if x.dtype == np.float64 else x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["token", "gcra", "int", "mixed"])
def test_decide_payload_matches(mode, seed):
    lane16, req, owns = _case(mode, seed)
    j_exists, j_d, j_new = _jax_decide(
        jnp.asarray(lane16), _jax_req(req), jnp.asarray(owns), math=mode
    )
    t_exists, t_d, t_new = tk.decide_payload(
        torch.from_numpy(lane16), _torch_req(req), torch.from_numpy(owns), math=mode
    )
    np.testing.assert_array_equal(t_exists.numpy(), np.asarray(j_exists))
    for name in j_d._fields:
        want = np.asarray(getattr(j_d, name))
        got = getattr(t_d, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(_as_bits(got), _as_bits(want), err_msg=name)
    assert t_new.dtype == torch.int32
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))


def test_cases_reach_the_edges():
    """Tripwire for the generator above: the mixed case really holds every
    edge the module docstring lists."""
    lane16, req, owns = _case("mixed", 0)
    algo, beh = req["algo"], req["behavior"]
    assert set(np.unique(algo)) == {0, 1, 2, 3, 4}
    assert (req["hits"] < 0).any() and (req["limit"] == 0).any()
    assert (req["limit"] == I32_MAX).any() and (req["burst"] == -I32_MAX).any()
    for bit in (4, 8, 32):
        assert (beh & bit).any(), bit
    assert ((algo == 1) & (req["duration"] == 0)).any()
    assert (owns & ((lane16[:, 5] & 0xFF) == algo)).any()


def test_bucket_math_rejects_unknown_mode():
    lane16, req, owns = _case("token", 0)
    with pytest.raises(ValueError):
        tk.decide_payload(torch.from_numpy(lane16), _torch_req(req),
                          torch.from_numpy(owns), math="float")
    assert bucket_math  # the public name the decide stage calls


def test_f64_to_i64_saturates_like_xla():
    vals = np.array([np.inf, -np.inf, np.nan, 1e300, -1e300, 2.0**63, -(2.0**63),
                     9.3e18, -9.3e18, 2.5, -2.5, 0.0, -0.0, 4.5e15, 2.0**62],
                    dtype=np.float64)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int64))
    np.testing.assert_array_equal(f64_to_i64(torch.from_numpy(vals)).numpy(), want)

"""Branchless decision math for every algorithm (the port of
``gubernator_tpu/ops/math.py``).

Token and leaky bucket are the exact decision tables of the reference's
algorithms.go, expressed as masked tensor arithmetic over per-row stored
state + request fields; GCRA, sliding-window counters and concurrency leases
are this repo's extensions (docs/algorithms.md). Every line mirrors the JAX
function so the two agree bit for bit, with three rules kept by hand:

* dtypes follow the JAX graph (int32 status/flags/algo, int64 counters,
  float64 leaky remainders) — torch promotes int32⊕int64 to int64 as JAX
  does under x64;
* ``//`` and ``%`` on int64 floor, as jnp's do;
* float64 → int64 conversions saturate like XLA's (NaN → 0, ±inf and
  out-of-range values clamp to the int64 limits) instead of torch's
  platform-dependent result (``f64_to_i64``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gubernator_tpu_torch.types import Algorithm, Behavior, Status

i32 = torch.int32
i64 = torch.int64
f64 = torch.float64

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1
_TWO63 = 9.223372036854775808e18  # 2.0**63, the first float past int64


class StoredState(NamedTuple):
    """Per-row stored slot state, decoded from the table layout."""

    limit: torch.Tensor  # int64
    burst: torch.Tensor  # int64
    rem_i: torch.Tensor  # int64 (remaining-style integer lane)
    algo: torch.Tensor  # int32
    status: torch.Tensor  # int32
    duration: torch.Tensor  # int64
    stamp: torch.Tensor  # int64 (CreatedAt / UpdatedAt; window start for windows)
    exp: torch.Tensor  # int64 (ExpireAt, ms exact)
    rem_f: torch.Tensor  # float64 (leaky remaining — REMF lane pair as f32+f32)
    aux: Optional[torch.Tensor] = None  # int64 raw REMF pair (GCRA TAT / window prev)


class Decision(NamedTuple):
    """Everything the write + response phases need."""

    status_out: torch.Tensor  # int32
    rem_i_out: torch.Tensor  # int64
    rem_f_out: torch.Tensor  # float64
    stamp_out: torch.Tensor  # int64
    dur_out: torch.Tensor  # int64
    exp_out: torch.Tensor  # int64
    burst_out: torch.Tensor  # int64
    flags_out: torch.Tensor  # int32 (algo | status << 8)
    remove: torch.Tensor  # bool — slot is removed
    aux_out: torch.Tensor  # int64 — raw REMF pair writeback
    resp_status: torch.Tensor  # int32
    resp_rem: torch.Tensor  # int64
    resp_reset: torch.Tensor  # int64


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 → int64 with XLA's saturating semantics: truncation toward
    zero in range, NaN → 0, values at or past ±2^63 (and ±inf) clamp."""
    ok = (x > -_TWO63) & (x < _TWO63)
    out = torch.where(ok, x, torch.zeros_like(x)).to(i64)
    out = torch.where(x >= _TWO63, torch.full_like(out, _I64_MAX), out)
    return torch.where(x <= -_TWO63, torch.full_like(out, _I64_MIN), out)


def _where(c, a, b):
    """jnp.where with Python scalars typed like the tensor branch."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(c, a, b)


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = min(max(x, lo), hi), tensors or scalars."""
    lo = lo if isinstance(lo, torch.Tensor) else torch.full_like(x, lo)
    hi = hi if isinstance(hi, torch.Tensor) else torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _max1(x):
    return torch.clamp(x, min=1)


def bucket_math(
    s: StoredState, req, exists: torch.Tensor, *, mode: str = "mixed"
) -> Decision:
    """One decision per row. `req` is a ReqBatch (ops/batch.py); `exists`
    marks rows whose slot held a live matching item.

    `mode` is a host-side specialization (engine._math_mode): "token" (all
    rows token bucket), "gcra" (all active rows GCRA), "int" (token, GCRA,
    window and lease; no leaky float64 lanes) or "mixed" (everything)."""
    if mode not in ("token", "gcra", "int", "mixed"):
        raise ValueError(f"unknown math mode {mode!r}")
    return _bucket_math_impl(s, req, exists, mode=mode)


def _bucket_math_impl(s: StoredState, req, exists, *, mode: str) -> Decision:
    now = req.created_at
    is_greg = (req.behavior & int(Behavior.DURATION_IS_GREGORIAN)) != 0
    is_reset = (req.behavior & int(Behavior.RESET_REMAINING)) != 0
    is_drain = (req.behavior & int(Behavior.DRAIN_OVER_LIMIT)) != 0
    is_token = req.algo == int(Algorithm.TOKEN_BUCKET)
    h = req.hits
    zero64 = torch.zeros_like(h)

    # existing-item path applies only when algorithms agree (go:96-105,307-317)
    algo_match = exists & (s.algo == req.algo)
    # negative hits against absent state are a no-op removal for the
    # extension algorithms (algo >= 2); token/leaky bank credit instead
    neg_miss = (h < 0) & ~algo_match & (req.algo >= 2)

    OVER = int(Status.OVER_LIMIT)
    UNDER = int(Status.UNDER_LIMIT)
    under32 = torch.full_like(req.algo, UNDER)

    # ==================================================== GCRA
    def gcra_lanes():
        s_aux = s.aux if s.aux is not None else torch.zeros_like(s.stamp)
        g_T = torch.clamp(req.duration // _max1(req.limit), min=1)
        g_tau = g_T * req.burst
        g_tat0 = torch.maximum(torch.where(algo_match, s_aux, now), now)
        g_tat1 = torch.maximum(g_tat0 + h * g_T, now)
        g_deny = (h > 0) & (g_tat1 - g_tau > now)
        g_tat_out = torch.where(
            g_deny, torch.where(is_drain, now + g_tau, g_tat0), g_tat1
        )
        g_rem = _clip((now + g_tau - g_tat_out) // g_T, 0, req.burst)
        g_reset = g_tat_out - g_tau + g_T * req.limit
        g_reset = torch.where(g_deny & ~is_drain, g_tat1 - g_tau, g_reset)
        g_status = _where(g_deny, OVER, under32)
        g_rm = (exists & is_reset) | neg_miss
        return dict(
            tat=g_tat_out,
            exp=torch.maximum(g_tat_out, now),
            status=g_status,
            remove=g_rm,
            resp_status=_where(g_rm, UNDER, g_status),
            resp_rem=torch.where(g_rm, req.burst, g_rem),
            resp_reset=_where(g_rm, 0, g_reset),
        )

    if mode == "gcra":
        g = gcra_lanes()
        return Decision(
            status_out=g["status"],
            rem_i_out=torch.zeros_like(s.rem_i),
            rem_f_out=torch.zeros_like(s.rem_f),
            stamp_out=now.expand(s.stamp.shape).clone(),
            dur_out=req.duration,
            exp_out=g["exp"],
            burst_out=req.burst,
            flags_out=req.algo | (g["status"] << 8),
            remove=g["remove"],
            aux_out=g["tat"],
            resp_status=g["resp_status"],
            resp_rem=g["resp_rem"],
            resp_reset=g["resp_reset"],
        )

    # ==================================================== token bucket
    # reference algorithms.go:37-252; limit change adds the delta (go:108-115)
    t_rem = torch.where(
        s.limit != req.limit,
        torch.clamp(s.rem_i + req.limit - s.limit, min=0),
        s.rem_i,
    )
    # duration change (go:125-146)
    dur_changed = s.duration != req.duration
    expire_dc = torch.where(is_greg, req.expire_new, s.stamp + req.duration)
    renew = dur_changed & (expire_dc <= now)
    expire_dc = torch.where(renew, now + req.duration, expire_dc)
    t_created = torch.where(renew, now, s.stamp)
    t_rem = torch.where(renew, req.limit, t_rem)
    t_exp = torch.where(dur_changed, expire_dc, s.exp)
    t_reset = t_exp

    zero_hits = h == 0
    at_limit = (t_rem == 0) & (h > 0)  # go:161-168
    exact = ~zero_hits & ~at_limit & (t_rem == h)  # go:171-175
    overask = ~zero_hits & ~at_limit & ~exact & (h > t_rem)  # go:179-190
    consume = ~zero_hits & ~at_limit & ~exact & ~overask  # go:192-194

    tok_rem_out = torch.where(
        exact | (overask & is_drain), zero64, torch.where(consume, t_rem - h, t_rem)
    )
    tok_resp_status = _where(at_limit | overask, OVER, s.status)
    tok_stored_status = _where(at_limit, OVER, s.status)
    tok_resp_rem = tok_rem_out
    tok_resp_reset = t_reset

    # --- new item (go:202-252)
    new_over = h > req.limit
    tokn_rem = torch.where(new_over, req.limit, req.limit - h)
    tokn_status = _where(new_over, OVER, under32)
    tokn_exp = req.expire_new

    tok_is_new = ~algo_match
    tok_status_out = _where(tok_is_new, UNDER, tok_stored_status)
    tok_rem_store = torch.where(tok_is_new, tokn_rem, tok_rem_out)
    tok_created_out = torch.where(tok_is_new, now, t_created)
    tok_exp_out = torch.where(tok_is_new, tokn_exp, t_exp)
    tok_resp_status = torch.where(tok_is_new, tokn_status, tok_resp_status)
    tok_resp_rem = torch.where(tok_is_new, tokn_rem, tok_resp_rem)
    tok_resp_reset = torch.where(tok_is_new, tokn_exp, tok_resp_reset)

    # RESET_REMAINING on an existing item removes it (go:82-94)
    tok_reset_rm = exists & is_reset
    tok_resp_status = _where(tok_reset_rm, UNDER, tok_resp_status)
    tok_resp_rem = torch.where(tok_reset_rm, req.limit, tok_resp_rem)
    tok_resp_reset = _where(tok_reset_rm, 0, tok_resp_reset)

    if mode == "token":
        return Decision(
            status_out=tok_status_out,
            rem_i_out=tok_rem_store,
            rem_f_out=torch.zeros_like(s.rem_f),
            stamp_out=tok_created_out,
            dur_out=req.duration,
            exp_out=tok_exp_out,
            burst_out=torch.zeros_like(s.burst),
            flags_out=req.algo | (tok_status_out << 8),
            remove=tok_reset_rm,
            aux_out=torch.zeros_like(s.stamp),
            resp_status=tok_resp_status,
            resp_rem=tok_resp_rem,
            resp_reset=tok_resp_reset,
        )

    # ==================================================== GCRA (shared lanes)
    s_aux = s.aux if s.aux is not None else torch.zeros_like(s.stamp)
    _g = gcra_lanes()
    g_tat_out, g_exp, g_status = _g["tat"], _g["exp"], _g["status"]
    g_reset_rm = _g["remove"]
    g_resp_status, g_resp_rem, g_resp_reset = (
        _g["resp_status"], _g["resp_rem"], _g["resp_reset"]
    )

    # ==================================================== sliding window
    w_dur = _max1(req.duration_eff)
    w_ws = now - now % w_dur
    w_elapsed = now - w_ws
    w_same = algo_match & (s.stamp == w_ws)
    w_roll1 = algo_match & (s.stamp == w_ws - w_dur)
    w_cur_s = s.limit - s.rem_i
    w_prev = torch.where(w_same, s_aux, torch.where(w_roll1, w_cur_s, zero64))
    w_cur = torch.where(w_same, w_cur_s, zero64)
    w_used = w_cur + (w_prev * (w_dur - w_elapsed)) // w_dur
    w_deny = (h > 0) & (w_used + h > req.limit)
    w_take = torch.where(w_deny & ~is_drain, zero64, h)
    w_cur_out = torch.clamp(w_cur + w_take, min=0)
    w_rem = _clip(req.limit - (w_used + w_take), 0, req.limit)
    w_reset = w_ws + w_dur
    w_status = _where(w_deny, OVER, under32)
    w_reset_rm = (exists & is_reset) | neg_miss
    w_resp_status = _where(w_reset_rm, UNDER, w_status)
    w_resp_rem = torch.where(w_reset_rm, req.limit, w_rem)
    w_resp_reset = _where(w_reset_rm, 0, w_reset)

    # ==================================================== concurrency lease
    l_inflight_s = torch.where(algo_match, s.limit - s.rem_i, zero64)
    l_deny = (h > 0) & (l_inflight_s + h > req.limit)
    l_take = torch.where(l_deny & ~is_drain, zero64, h)
    l_inflight = torch.clamp(l_inflight_s + l_take, min=0)
    l_refresh = (h > 0) & ~(l_deny & ~is_drain)
    l_exp = torch.where(algo_match & ~l_refresh, s.exp, now + req.duration_eff)
    l_rem = _clip(req.limit - l_inflight, 0, req.limit)
    l_status = _where(l_deny, OVER, under32)
    l_reset_rm = (exists & is_reset) | neg_miss
    l_resp_status = _where(l_reset_rm, UNDER, l_status)
    l_resp_rem = torch.where(l_reset_rm, req.limit, l_rem)
    l_resp_reset = _where(l_reset_rm, 0, l_exp)

    # ------------------------------------------------ int-algo select masks
    is_gcra = req.algo == int(Algorithm.GCRA)
    is_win = req.algo == int(Algorithm.SLIDING_WINDOW)
    is_lease = req.algo == int(Algorithm.CONCURRENCY_LEASE)

    def pick5(tok, g, w, le, lk):
        """Per-row algorithm select: token / gcra / window / lease / leaky."""
        return torch.where(
            is_token, tok,
            torch.where(is_gcra, g, torch.where(is_win, w, torch.where(is_lease, le, lk))),
        )

    w_rem_store = req.limit - w_cur_out
    l_rem_store = req.limit - l_inflight
    remove_all = (
        (tok_reset_rm & is_token)
        | (g_reset_rm & is_gcra)
        | (w_reset_rm & is_win)
        | (l_reset_rm & is_lease)
    )
    now_b = now.expand(h.shape)
    aux_out = torch.where(is_gcra, g_tat_out, torch.where(is_win, w_prev, zero64))

    if mode == "int":
        status_out = pick5(tok_status_out, g_status, w_status, l_status,
                           tok_status_out)
        return Decision(
            status_out=status_out,
            rem_i_out=pick5(tok_rem_store, zero64, w_rem_store, l_rem_store,
                            tok_rem_store),
            rem_f_out=torch.zeros_like(s.rem_f),
            stamp_out=pick5(tok_created_out, now_b, w_ws, now_b, tok_created_out),
            dur_out=req.duration,
            exp_out=pick5(tok_exp_out, g_exp, w_ws + 2 * w_dur, l_exp,
                          tok_exp_out),
            burst_out=torch.where(is_gcra, req.burst, zero64),
            flags_out=req.algo | (status_out << 8),
            remove=remove_all,
            aux_out=aux_out,
            resp_status=pick5(tok_resp_status, g_resp_status, w_resp_status,
                              l_resp_status, tok_resp_status),
            resp_rem=pick5(tok_resp_rem, g_resp_rem, w_resp_rem, l_resp_rem,
                           tok_resp_rem),
            resp_reset=pick5(tok_resp_reset, g_resp_reset, w_resp_reset,
                             l_resp_reset, tok_resp_reset),
        )

    # ==================================================== leaky bucket
    # reference algorithms.go:255-492; remaining is float64 (store.go:32) and
    # comparisons truncate toward zero like Go's int64(float64)
    lk_is_new = ~algo_match
    rate = torch.where(is_greg, req.greg_interval, req.duration).to(f64) / _max1(
        req.limit
    ).to(f64)
    irate = f64_to_i64(rate)

    # --- existing item (go:304-430)
    b_rem = torch.where(is_reset, s.burst.to(f64), s.rem_f)  # go:319-321
    burst_changed = s.burst != req.burst
    b_rem = torch.where(  # go:324-329
        burst_changed & (req.burst > f64_to_i64(b_rem)), req.burst.to(f64), b_rem
    )
    # leak since UpdatedAt, applied once a whole token has leaked (go:359-366)
    elapsed = (now - s.stamp).to(f64)
    leak = elapsed / rate
    leak_applies = f64_to_i64(leak) > 0
    b_rem = torch.where(leak_applies, b_rem + leak, b_rem)
    lk_stamp = torch.where(leak_applies, now, s.stamp)
    # clamp to burst (go:368-370)
    b_rem = torch.where(f64_to_i64(b_rem) > req.burst, req.burst.to(f64), b_rem)

    lk_rem_now = f64_to_i64(b_rem)
    lk_at_limit = (lk_rem_now == 0) & (h > 0)  # go:388-394
    lk_exact = ~lk_at_limit & (lk_rem_now == h)  # go:397-402
    lk_overask = ~lk_at_limit & ~lk_exact & (h > lk_rem_now)  # go:406-419
    lk_zero = ~lk_at_limit & ~lk_exact & ~lk_overask & (h == 0)  # go:422-424
    lk_consume = ~lk_at_limit & ~lk_exact & ~lk_overask & ~lk_zero

    zero_f = torch.zeros_like(b_rem)
    lk_rem_out = torch.where(
        lk_exact | (lk_overask & is_drain),
        zero_f,
        torch.where(lk_consume, b_rem - h.to(f64), b_rem),
    )
    lk_resp_status = _where(lk_at_limit | lk_overask, OVER, under32)
    lk_resp_rem = torch.where(
        lk_overask & ~is_drain, lk_rem_now, f64_to_i64(lk_rem_out)
    )
    # reset_time from the PRE-hit remaining (go:372-377), recomputed only by
    # the exact/consume branches (go:400,428)
    lk_reset_basis = torch.where(
        lk_exact, zero64, torch.where(lk_consume, f64_to_i64(lk_rem_out), lk_rem_now)
    )
    lk_resp_reset = now + (req.limit - lk_reset_basis) * irate
    # hits≠0 refreshes expiry before any verdict (go:355-357)
    lk_exp = torch.where(h != 0, now + req.duration_eff, s.exp)

    # --- new item (go:436-492)
    lkn_over = h > req.burst
    lkn_rem = torch.where(lkn_over, zero_f, (req.burst - h).to(f64))
    lkn_resp_rem = torch.where(lkn_over, zero64, req.burst - h)
    lkn_status = _where(lkn_over, OVER, under32)
    lkn_reset = now + (req.limit - lkn_resp_rem) * irate
    lkn_exp = now + req.duration_eff

    lk_rem_store = torch.where(lk_is_new, lkn_rem, lk_rem_out)
    lk_stamp_out = torch.where(lk_is_new, now, lk_stamp)
    lk_exp_out = torch.where(lk_is_new, lkn_exp, lk_exp)
    # new items persist the effective duration (go:452-458), existing items
    # the raw request duration (go:332)
    lk_dur_out = torch.where(lk_is_new, req.duration_eff, req.duration)
    lk_resp_status = torch.where(lk_is_new, lkn_status, lk_resp_status)
    lk_resp_rem = torch.where(lk_is_new, lkn_resp_rem, lk_resp_rem)
    lk_resp_reset = torch.where(lk_is_new, lkn_reset, lk_resp_reset)

    # ==================================================== merge
    is_leaky = req.algo == int(Algorithm.LEAKY_BUCKET)
    status_out = pick5(tok_status_out, g_status, w_status, l_status, under32)
    return Decision(
        status_out=status_out,
        rem_i_out=pick5(tok_rem_store, zero64, w_rem_store, l_rem_store, zero64),
        rem_f_out=torch.where(is_leaky, lk_rem_store, zero_f),
        stamp_out=pick5(tok_created_out, now_b, w_ws, now_b, lk_stamp_out),
        dur_out=torch.where(is_leaky, lk_dur_out, req.duration),
        exp_out=pick5(tok_exp_out, g_exp, w_ws + 2 * w_dur, l_exp, lk_exp_out),
        burst_out=torch.where(is_leaky | is_gcra, req.burst, zero64),
        flags_out=req.algo | (status_out << 8),
        remove=remove_all,
        aux_out=aux_out,
        resp_status=pick5(tok_resp_status, g_resp_status, w_resp_status,
                          l_resp_status, lk_resp_status),
        resp_rem=pick5(tok_resp_rem, g_resp_rem, w_resp_rem, l_resp_rem,
                       lk_resp_rem),
        resp_reset=pick5(tok_resp_reset, g_resp_reset, w_resp_reset,
                         l_resp_reset, lk_resp_reset),
    )

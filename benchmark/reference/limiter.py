"""The limiter's semantics in plain NumPy, and the judge of a run's answers.

A deployment's table is seeded, before the window, with one request of
``s_k`` hits on each key ``k`` at the seed time ``ts``; the window then runs
at a frozen clock ``t1 > ts``. Token and leaky buckets follow Gubernator's
algorithms.go:

* token bucket, new key: remaining ``limit - hits``, reset (and expiry)
  ``now + duration``; an existing key with ``R`` left answers ``R - h``
  (UNDER_LIMIT) when ``h < R``, ``0`` when ``h == R``, and ``R``
  (OVER_LIMIT, nothing taken) when ``h > R`` or ``R == 0``; reset is the
  key's expiry.
* leaky bucket: the float remaining leaks back ``elapsed / rate`` tokens
  (``rate = duration / limit`` ms a token) once a whole token has leaked,
  capped at the burst (the limit here); the verdicts are the token
  bucket's on ``R = trunc(remaining)``; every hit moves the expiry to
  ``now + duration``; reset is ``now + (limit - basis) * trunc(rate)``
  where basis is the answered remaining.

Keys live in 8-slot buckets (``fp % n_buckets``). A bucket that more than
8 of the deployment's keys hash to overflows: its keys evict one another,
in an order that the concurrent front door does not fix. So a key in a
bucket of at most 8 keys ("closed") is held exactly, and a key in an
overflowing bucket by the rules any order of its bucket's claims obeys.

Exactly, for one key: the front door gathers requests into flushes, and
the configuration states how a flush answers a key that repeats in it
(``exact_rows_per_flush``, E): its first E rows in the flush each apply
alone, one after another, and only its later rows there may be applied
together as one group of their summed hits that shares one answer
(Gubernator's aggregation of a hot key's hits, global.go). Every such
application that is answered UNDER_LIMIT leaves a remaining that no other
does, and ``value == R0 - (hits of the applications answered UNDER_LIMIT
with a value >= it)``; an OVER_LIMIT answer names a remaining the key
passed through, refused for more hits than it had left. The state the run
leaves is the last value of that chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmark.reference.respwire import Answers

TOKEN = "token_bucket"
LEAKY = "leaky_bucket"
WAYS = 8


class Clock(NamedTuple):
    ts: int  # ms, the seed requests' time
    t1: int  # ms, the window's frozen time


class Seeded(NamedTuple):
    rem: np.ndarray  # int64, integer remaining at the window's time (R0)
    rem_f: np.ndarray  # float64, leaky remaining at the window's time
    rem_unleaked: np.ndarray  # float64, leaky remaining as stored at seed time
    expiry: np.ndarray  # int64, expiry as seeded
    leaky: np.ndarray  # bool, the key is a leaky bucket (else a token bucket)


def algorithm_shares(cfg: dict) -> dict:
    """The configuration's algorithms and the share of keys each holds:
    ``"algorithm"`` is one name, or a mapping of names to shares."""
    a = cfg["algorithm"]
    shares = {a: 1.0} if isinstance(a, str) else {k: float(v) for k, v in a.items()}
    bad = sorted(set(shares) - {TOKEN, LEAKY})
    if bad or not shares or min(shares.values()) < 0 or sum(shares.values()) <= 0:
        raise ValueError(f"the reference holds token and leaky buckets, not {a!r}")
    return shares


def seeded(cfg: dict, clock: Clock, hits: np.ndarray, leaky: np.ndarray = None) -> Seeded:
    """Each key's state at the window's time after one seed request of
    `hits` (per key) at ``clock.ts``. `leaky` marks the leaky keys (per
    key); None means the configuration's one algorithm for every key."""
    shares = algorithm_shares(cfg)
    if leaky is None:
        if len(shares) != 1:
            raise ValueError("a configuration of two algorithms needs each key's")
        leaky = np.full(hits.shape, LEAKY in shares, bool)
    limit, dur = int(cfg["limit"]), int(cfg["duration_ms"])
    base = (limit - hits).astype(np.float64)
    expiry = np.full(hits.shape, clock.ts + dur, np.int64)
    rate = float(dur) / float(limit)
    leak = float(clock.t1 - clock.ts) / rate
    lk_f = base + leak if int(leak) > 0 else base.copy()
    lk_f = np.where(np.trunc(lk_f) > limit, float(limit), lk_f)
    rem = np.where(leaky, np.trunc(lk_f), base).astype(np.int64)
    return Seeded(rem, np.where(leaky, lk_f, base), base, expiry, leaky)


def closed_keys(fps: np.ndarray, n_buckets: int) -> np.ndarray:
    """True for each key whose bucket at most WAYS of the keys hash to."""
    b = fps % n_buckets
    return np.bincount(b, minlength=n_buckets)[b] <= WAYS


def flush_occurrence(kid: np.ndarray, flush: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Each row's occurrence (from 0) among the rows of its key in its
    flush, in the flush's order `pos`."""
    n = kid.size
    order = np.lexsort((pos, kid, flush))
    f, k = flush[order], kid[order]
    new = np.r_[True, (f[1:] != f[:-1]) | (k[1:] != k[:-1])] if n else np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(new, np.arange(n), 0)) if n else np.zeros(0, int)
    occ = np.empty(n, np.int64)
    occ[order] = np.arange(n) - start
    return occ


def _sum_ge(k: np.ndarray, v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """For each row, the summed `w` of the rows of its key with a value
    >= its value."""
    n = k.size
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((-v, k))
    ks, vs = k[order], v[order]
    cs = np.cumsum(w[order])
    idx = np.arange(n)
    first = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(first, idx, 0))
    before = np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    run_end = np.r_[(ks[1:] != ks[:-1]) | (vs[1:] != vs[:-1]), True]
    end = np.minimum.accumulate(np.where(run_end, idx, n)[::-1])[::-1]
    out = np.empty(n, np.int64)
    out[order] = cs[end] - before
    return out


def _pair(k: np.ndarray, v: np.ndarray) -> np.ndarray:
    return k.astype(np.int64) * (1 << 24) + np.clip(v, -1, (1 << 23) - 1)


def _applications(k, status, rem, single, flush):
    """Each row's application: a row of a key's first E in its flush is
    one alone; the later rows of one key in one flush that share a status
    and a remaining are one group."""
    n = k.size
    app = np.empty(n, np.int64)
    si = np.nonzero(single)[0]
    app[si] = np.arange(si.size)
    ti = np.nonzero(~single)[0]
    n_app = si.size
    if ti.size:
        ts = ti[np.lexsort((rem[ti], status[ti], k[ti], flush[ti]))]
        change = np.r_[True, (flush[ts][1:] != flush[ts][:-1]) | (k[ts][1:] != k[ts][:-1])
                       | (status[ts][1:] != status[ts][:-1]) | (rem[ts][1:] != rem[ts][:-1])]
        gid = np.cumsum(change) - 1
        app[ts] = n_app + gid
        n_app += int(gid[-1]) + 1
    return app, n_app


def chain_wrong(k: np.ndarray, status: np.ndarray, rem: np.ndarray, start: np.ndarray,
                hits: np.ndarray, single: np.ndarray, flush: np.ndarray) -> np.ndarray:
    """Rows (of keys each starting at `start`, per row) that no order of
    the key's applications gives: each `single` row applies its `hits`
    alone, the other rows of one key in one `flush` may share one answer."""
    wrong = (rem < 0) | ((status != 0) & (status != 1))
    ok = np.nonzero(~wrong)[0]
    if ok.size == 0:
        return wrong
    k, status, rem, start = k[ok], status[ok], rem[ok], start[ok]
    app, n_app = _applications(k, status, rem, single[ok], flush[ok])
    _, idx = np.unique(app, return_index=True)
    ak, ast, arem, astart = k[idx], status[idx], rem[idx], start[idx]
    aw = np.bincount(app, weights=hits[ok], minlength=n_app).astype(np.int64)
    bad = np.zeros(n_app, bool)
    iu = np.nonzero(ast == 0)[0]
    pu = _pair(ak[iu], arem[iu])
    _, inv, cnt = np.unique(pu, return_inverse=True, return_counts=True)
    bad[iu] |= cnt[inv] > 1  # two applications cannot leave one remaining
    bad[iu] |= arem[iu] != astart[iu] - _sum_ge(ak[iu], arem[iu], aw[iu])
    io = np.nonzero(ast == 1)[0]
    if io.size:
        ku, kk = np.unique(ak[io], return_index=True)
        points = np.concatenate([pu, _pair(ku, astart[io][kk])])
        bad[io] |= ~np.isin(_pair(ak[io], arem[io]), points)
        bad[io] |= aw[io] <= arem[io]  # refused with hits that fit
    wrong[ok] |= bad[app]
    return wrong


def judge(cfg: dict, clock: Clock, kid: np.ndarray, ans, seed: Seeded,
          closed: np.ndarray, hits: np.ndarray, flush: np.ndarray,
          pos: np.ndarray) -> dict:
    """Judge every answered row. `kid` is each row's key id, `hits` its
    hits, `flush` the flush that carried it (-1: none recorded) and `pos`
    its place in that flush; `ans` holds the decoded columns (status,
    limit, remaining, reset, error) of the same rows. Returns the wrong
    rows and how many rows are of closed and of overflowing buckets."""
    limit, dur = int(cfg["limit"]), int(cfg["duration_ms"])
    n_exact = int(cfg["exact_rows_per_flush"])
    st, rem, rst = ans.status, ans.remaining, ans.reset
    hits = np.broadcast_to(np.asarray(hits, np.int64), kid.shape)
    wrong = ans.error | (ans.limit != limit) | (flush < 0)
    cl = closed[kid]
    lk = seed.leaky[kid]
    # token buckets: the reset names the seeded expiry, or, in an
    # overflowing bucket, a key created anew in the window, which starts
    # again from the limit
    seeded_row = rst == seed.expiry[kid]
    fresh_row = rst == clock.t1 + dur
    tok = ~lk
    wrong |= tok & cl & ~seeded_row
    wrong |= tok & ~cl & ~seeded_row & ~fresh_row
    wrong |= tok & ~cl & fresh_row & ((rem < 0) | (rem > limit - hits))
    # leaky buckets: the reset follows from the answered remaining
    irate = int(float(dur) / float(limit))
    wrong |= lk & (rst != clock.t1 + (limit - rem) * irate)
    wrong |= lk & ~cl & ((rem < 0) | (rem > limit) | ((st == 0) & (rem > limit - hits)))
    exact = np.where(lk, cl, seeded_row)  # closed keys, and overflow tokens' seeded chain
    single = flush_occurrence(kid, flush, pos) < n_exact
    ie = np.nonzero(exact & ~wrong)[0]
    wrong[ie] |= chain_wrong(kid[ie], st[ie], rem[ie], seed.rem[kid[ie]], hits[ie],
                             single[ie], flush[ie])
    return {"wrong": wrong, "closed_rows": int(cl.sum()), "overflow_rows": int((~cl).sum())}


def final_state(cfg: dict, kid: np.ndarray, ans, seed: Seeded):
    """Per key hit in the window (closed keys' rows only): (keys, integer
    remaining the chain ends at, leaky float remaining it ends at)."""
    keys, inv = np.unique(kid, return_inverse=True)
    big = np.iinfo(np.int64).max
    vmin = np.full(keys.size, big, np.int64)
    under = ans.status == 0
    np.minimum.at(vmin, inv[under], ans.remaining[under])
    r0 = seed.rem[keys]
    end = np.where(vmin == big, r0, vmin)
    end_f = np.where(vmin == big, seed.rem_f[keys],
                     np.where(end > 0, seed.rem_f[keys] - (r0 - end), 0.0))
    return keys, end, end_f


def stale_answers(cfg: dict, clock: Clock, kid: np.ndarray, seed: Seeded, hits):
    """The control: answers from the seeded table that the window's hits
    never update (a replica that is never synced)."""
    limit, dur = int(cfg["limit"]), int(cfg["duration_ms"])
    h = np.broadcast_to(np.asarray(hits, np.int64), kid.shape)
    r = seed.rem[kid]
    status = np.where(h <= r, 0, 1).astype(np.int64)
    rem = np.where(h <= r, r - h, r)
    reset = np.where(seed.leaky[kid], clock.t1 + (limit - rem) * int(float(dur) / float(limit)),
                     seed.expiry[kid])
    n = kid.size
    return Answers(status, np.full(n, limit, np.int64), rem, reset, np.zeros(n, bool),
                   np.zeros(0, np.int64), 0)

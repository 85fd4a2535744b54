"""The reference against hand-worked cases: the frozen key hash, the
bucket placement that decides which keys are held exactly, the token and
leaky seeded states, the chain of answers, and the response decoder."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import keyhash, limiter, respwire

TOKEN = {"algorithm": "token_bucket", "limit": 100, "duration_ms": 60_000,
         "exact_rows_per_flush": 7}
LEAKY = dict(TOKEN, algorithm="leaky_bucket")
CLOCK = limiter.Clock(ts=1_000_000, t1=1_006_300)


def _rows(*keys):
    n = len(keys[0])
    return np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), n)


def test_xxh64_vectors_and_the_port():
    from gubernator_tpu_torch.hashing import fingerprint_key, xxh64

    rows = _rows(b"a", b"b")
    assert int(keyhash.xxh64_rows(rows, seed=0)[0]) == 0xD24EC4F1A98C6E5B
    for n in (1, 3, 4, 7, 8, 12, 17, 31):
        keys = [bytes((i * 7 + j) % 251 for j in range(n)) for i in range(5)]
        got = keyhash.xxh64_rows(_rows(*keys))
        assert [int(x) for x in got] == [xxh64(k, keyhash.SEED) for k in keys]
    names = [b"rl00ab_k%08d" % i for i in (0, 1, 99999999)]
    assert list(keyhash.fingerprints(_rows(*names))) == [fingerprint_key(k.decode())
                                                        for k in names]


def test_n_buckets_matches_the_port():
    from gubernator_tpu_torch.ops.table2 import n_buckets_for

    for slots in (8, 100, 1 << 14, 1 << 21, 1 << 24, 3 * 2048 * 8 + 5):
        assert keyhash.n_buckets_for(slots) == n_buckets_for(slots)


def test_closed_and_overflowing_buckets():
    nb = 16
    fps = np.array([3] * 8 + [5] * 9 + [7], np.int64) + nb * np.arange(18)
    closed = limiter.closed_keys(fps, nb)
    assert closed[:8].all() and not closed[8:17].any() and closed[17]


def test_seeded_token_and_leaky_states():
    hits = np.array([1, 50, 11, 90])
    t = limiter.seeded(TOKEN, CLOCK, hits)
    assert list(t.rem) == [99, 50, 89, 10] and (t.expiry == 1_060_000).all()
    lk = limiter.seeded(LEAKY, CLOCK, hits)
    # 6,300 ms at 600 ms a token leaks 10.5 tokens back, capped at the burst
    assert list(lk.rem_f) == [100.0, 60.5, 99.5, 20.5]
    assert list(lk.rem) == [100, 60, 99, 20]
    assert list(lk.rem_unleaked) == [99.0, 50.0, 89.0, 10.0]
    slow = limiter.seeded(LEAKY, limiter.Clock(ts=0, t1=599), hits)
    assert list(slow.rem_f) == [99.0, 50.0, 89.0, 10.0]  # no whole token leaked yet
    with pytest.raises(ValueError):
        limiter.seeded(dict(TOKEN, algorithm="gcra"), CLOCK, hits)
    # two algorithms: each key's own
    both = dict(TOKEN, algorithm={"token_bucket": 1, "leaky_bucket": 1})
    mixed = limiter.seeded(both, CLOCK, hits, np.array([False, True, False, True]))
    assert list(mixed.rem) == [99, 60, 89, 20]
    assert list(mixed.rem_f) == [99.0, 60.5, 89.0, 20.5]
    with pytest.raises(ValueError):
        limiter.seeded(both, CLOCK, hits)


def _wrong(k, st, rem, start, hits=1, single=None, flush=None):
    n = len(k)
    single = np.ones(n, bool) if single is None else np.array(single, bool)
    flush = np.zeros(n, np.int64) if flush is None else np.array(flush)
    return limiter.chain_wrong(np.array(k), np.array(st), np.array(rem), np.array(start),
                               np.broadcast_to(np.asarray(hits), (n,)), single, flush).tolist()


def test_chain_one_at_a_time_in_any_order():
    assert _wrong([0, 0, 0], [0, 0, 0], [7, 9, 8], [10] * 3) == [False] * 3
    # the state left unchanged: every hit answers the first hit's value
    assert _wrong([0, 0, 0], [0, 0, 0], [9, 9, 9], [10] * 3) == [True] * 3
    # one answer altered by one
    assert _wrong([0, 0, 0], [0, 0, 0], [9, 8, 8], [10] * 3) == [False, True, True]
    # hits of more than one: 10 -> 7 -> 5, in either order of the rows
    assert _wrong([0, 0], [0, 0], [5, 7], [10, 10], hits=[2, 3]) == [False, False]
    assert _wrong([0, 0], [0, 0], [7, 6], [10, 10], hits=[3, 2]) == [False, True]


def test_chain_grouped_and_over_limit():
    # two single hits, then a key's later rows of one flush folded into a
    # group of three sharing one answer: 10 -> 9 -> 8 -> 5
    tail = [True, True, False, False, False]
    assert _wrong([1] * 5, [0] * 5, [9, 8, 5, 5, 5], [10] * 5, single=tail) == [False] * 5
    # rows that have to stand alone cannot share an answer
    assert _wrong([1] * 5, [0] * 5, [9, 8, 5, 5, 5], [10] * 5) == [False, False] + [True] * 3
    # nor can later rows of two flushes
    assert _wrong([1] * 4, [0] * 4, [9, 9, 7, 7], [10] * 4, single=[False] * 4,
                  flush=[0, 0, 1, 1]) == [True] * 4
    # 3 -> 2, then a group of four refused at 2 left (OVER_LIMIT, nothing
    # taken), then, in a later flush, two single hits 2 -> 1 -> 0, then a
    # hit refused at 0
    k, st = [2] * 8, [0, 1, 1, 1, 1, 0, 0, 1]
    rem = [2, 2, 2, 2, 2, 1, 0, 0]
    single, flush = [True] + [False] * 4 + [True] * 3, [0] * 5 + [1] * 3
    assert _wrong(k, st, rem, [3] * 8, single=single, flush=flush) == [False] * 8
    assert _wrong(k[:6], st[:6], rem[:6], [3] * 6, single=single[:6],
                  flush=flush[:6]) == [False] * 6
    # a single hit refused at 2 left
    assert _wrong(k[:2], st[:2], rem[:2], [3] * 2) == [False, True]
    # refused at 0 by a key that never reached 0
    assert _wrong([2, 2], [0, 1], [2, 0], [3, 3]) == [False, True]
    assert _wrong([3] * 4, [0, 0, 1, 1], [1, 0, 0, 0], [2] * 4) == [False] * 4
    # an OVER_LIMIT answer at a value the key never passed through
    assert _wrong([4, 4], [0, 1], [9, 6], [10, 10]) == [False, True]
    # refused at 3 left by a group of only 3 rows: a group that fits is taken
    assert _wrong([5] * 3, [1] * 3, [3] * 3, [3] * 3, single=[False] * 3) == [True] * 3


def test_flush_occurrence_counts_a_key_in_its_flush():
    kid = np.array([1, 1, 2, 1, 1])
    flush = np.array([0, 0, 0, 1, 0])
    pos = np.array([5, 2, 1, 0, 9])
    assert limiter.flush_occurrence(kid, flush, pos).tolist() == [1, 0, 0, 0, 2]


def test_judge_holds_a_flush_to_its_first_rows_alone():
    """A key 9 times in one flush: the program answers its first 7 rows one
    at a time and folds the last 2 (10 -> 9 ... -> 3 -> 1). Answering
    those 2 alone too is more exact and allowed; folding every repeat (one
    shared answer, 10 -> 1) is wrong."""
    cfg = dict(TOKEN, exact_rows_per_flush=7)
    seed = limiter.seeded(cfg, CLOCK, np.array([90]))  # 10 left
    kid = np.zeros(9, np.int64)
    e0 = seed.expiry[0]
    args = (np.ones(9, np.int64), np.zeros(9, np.int64), np.arange(9))

    def judged(rem):
        ans = _answers([0] * 9, rem, [e0] * 9)
        return limiter.judge(cfg, CLOCK, kid, ans, seed, np.array([True]), *args)["wrong"]

    assert not judged([9, 8, 7, 6, 5, 4, 3, 1, 1]).any()
    assert not judged([9, 8, 7, 6, 5, 4, 3, 2, 1]).any()  # more exact is allowed
    assert judged([1] * 9).sum() == 9
    assert judged([9, 8, 7, 6, 5, 5, 3, 1, 1]).sum() >= 2
    # a row no flush carried is wrong
    ans = _answers([0] * 9, [9, 8, 7, 6, 5, 4, 3, 1, 1], [e0] * 9)
    flush = np.zeros(9, np.int64)
    flush[4] = -1
    w = limiter.judge(cfg, CLOCK, kid, ans, seed, np.array([True]), args[0], flush, args[2])
    assert w["wrong"][4]


def _answers(st, rem, reset, limit=100, err=None):
    n = len(st)
    return respwire.Answers(np.array(st), np.full(n, limit), np.array(rem), np.array(reset),
                            np.zeros(n, bool) if err is None else np.array(err),
                            np.zeros(0, np.int64), 0)


def _judge(cfg, kid, ans, seed, closed, hits=1):
    """Every row in one flush, in order."""
    n = kid.size
    return limiter.judge(cfg, CLOCK, kid, ans, seed, closed, np.broadcast_to(hits, (n,)),
                         np.zeros(n, np.int64), np.arange(n))


def test_judge_token_closed_and_overflow_keys():
    seed = limiter.seeded(TOKEN, CLOCK, np.array([1, 1, 40]))
    closed = np.array([True, False, True])
    e0, fresh = 1_060_000, CLOCK.t1 + 60_000
    kid = np.array([0, 0, 1, 1, 1, 2])
    # key 1 overflows: one hit from its seeded chain, then evicted and
    # created anew (remaining 99 from the limit, a new reset)
    ans = _answers([0] * 6, [98, 97, 98, 99, 98, 59], [e0, e0, e0, fresh, fresh, e0])
    j = _judge(TOKEN, kid, ans, seed, closed)
    assert not j["wrong"].any()
    # a closed key cannot be created anew: its reset names its seeded expiry
    ans2 = _answers([0] * 6, [98, 97, 98, 99, 98, 99], [e0, e0, e0, fresh, fresh, fresh])
    assert _judge(TOKEN, kid, ans2, seed, closed)["wrong"].tolist() == \
        [False] * 5 + [True]
    ans3 = _answers([0] * 6, [98, 97, 98, 99, 98, 59], [e0] * 3 + [fresh] * 2 + [e0],
                    err=[False] * 5 + [True])
    assert _judge(TOKEN, kid, ans3, seed, closed)["wrong"][-1]


def test_judge_leaky_reset_and_chain():
    seed = limiter.seeded(LEAKY, CLOCK, np.array([50]))  # 60.5 at the window
    kid = np.zeros(3, np.int64)
    reset = lambda r: CLOCK.t1 + (100 - r) * 600  # noqa: E731
    ans = _answers([0, 0, 0], [59, 58, 57], [reset(59), reset(58), reset(57)])
    assert not _judge(LEAKY, kid, ans, seed, np.array([True]))["wrong"].any()
    bad = _answers([0, 0, 0], [59, 58, 57], [reset(59), reset(58), reset(58)])
    assert _judge(LEAKY, kid, bad, seed, np.array([True]))["wrong"].tolist() == \
        [False, False, True]


def test_judge_mixed_algorithms_and_hits():
    cfg = dict(TOKEN, algorithm={"token_bucket": 1, "leaky_bucket": 1})
    seed = limiter.seeded(cfg, CLOCK, np.array([50, 50]), np.array([False, True]))
    kid = np.array([0, 1, 0, 1])
    hits = np.array([2, 3, 1, 60])
    lreset = lambda r: CLOCK.t1 + (100 - r) * 600  # noqa: E731
    # token 50 -> 48 -> 47; leaky 60.5 -> 57, then 60 hits refused at 57
    ans = _answers([0, 0, 0, 1], [48, 57, 47, 57],
                   [seed.expiry[0], lreset(57), seed.expiry[0], lreset(57)])
    assert not _judge(cfg, kid, ans, seed, np.array([True, True]), hits)["wrong"].any()
    # read as one hit each, the same answers are wrong
    assert _judge(cfg, kid, ans, seed, np.array([True, True]))["wrong"].any()
    stale = limiter.stale_answers(cfg, CLOCK, kid, seed, hits)
    assert stale.status.tolist() == [0] * 4 and stale.remaining.tolist() == [48, 57, 49, 0]


def test_final_state_ends_where_the_chain_ends():
    seed = limiter.seeded(LEAKY, CLOCK, np.array([50, 89, 11]))
    kid = np.array([0, 0, 1, 1, 1])
    ans = _answers([0, 0, 0, 0, 1], [59, 58, 1, 0, 0], [0] * 5)
    keys, end, end_f = limiter.final_state(LEAKY, kid, ans, seed)
    assert keys.tolist() == [0, 1] and end.tolist() == [58, 0]
    assert end_f.tolist() == [58.5, 0.0]


def test_stale_control_breaks_the_chain():
    seed = limiter.seeded(TOKEN, CLOCK, np.array([5, 5]))
    kid = np.array([0, 0, 1])
    ans = limiter.stale_answers(TOKEN, CLOCK, kid, seed, 1)
    j = _judge(TOKEN, kid, ans, seed, np.array([True, True]))
    assert j["wrong"].tolist() == [True, True, False]


def test_decoder_matches_protobuf():
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    rng = np.random.default_rng(1)
    resps, want = [], []
    for _ in range(40):
        items = []
        for _ in range(int(rng.integers(0, 30))):
            f = dict(status=int(rng.integers(0, 2)), limit=int(rng.integers(0, 300)),
                     remaining=int(rng.integers(0, 200)), reset_time=int(rng.integers(0, 2**41)))
            e = "bad" if rng.random() < 0.1 else ""
            md = {"retry-after": "5"} if rng.random() < 0.2 else {}
            items.append(pb.RateLimitResp(error=e, metadata=md, **f))
            want.append((f["status"], f["limit"], f["remaining"], f["reset_time"], bool(e)))
        resps.append(pb.GetRateLimitsResp(responses=items).SerializeToString())
    a = respwire.decode(resps)
    got = list(zip(a.status.tolist(), a.limit.tolist(), a.remaining.tolist(),
                   a.reset.tolist(), a.error.tolist()))
    assert got == want and a.malformed == 0
    assert a.items.tolist() == [len(pb.GetRateLimitsResp.FromString(r).responses) for r in resps]
    assert respwire.decode([b"\x12\x00"]).malformed > 0

"""The one traffic generator: keys, seed requests and window requests from
a configuration, a traffic mix and ``--seed``, vectorised.

Request bytes are GetRateLimitsReq wire bytes (protobuf encoding rules,
proto3 defaults left out), built from one template an item and the key's
digits, so a run makes millions of items in seconds. The encoding of
``chip_smoke.py``'s ``_service_requests`` (uniform 1,000-item token
requests) is the model; this builds the same bytes without a Python loop
per item.

A traffic mix's parameters (``traffic/<name>.json``):

* ``submitters``: closed-loop submitters, each awaiting its request's
  answer before it sends the next;
* ``items_per_request``: the items of each request;
* ``hits``: the hits of each item: one number, or ``{"values": [...],
  "weights": [...]}``, each item's drawn from the seed (1 to 127);
* ``keys``: ``uniform`` over the deployment's keys, or ``zipfian``
  (``zipf_theta``): YCSB's CoreWorkload ``requestdistribution=zipfian``,
  its ScrambledZipfianGenerator: a zipfian rank over 10^10 items, hashed
  with FNV-1a 64 and taken modulo the keys (plus one, the draws past the
  last key drawn again, as CoreWorkload's ``nextKeynum`` does);
* ``warm_s``: seconds of warm-up traffic before the window: the same mix
  with 0 hits, a pool of ``WARM_ROUNDS`` requests a submitter sent over
  and over (a request of 0 hits changes no count);
* ``budget_items_per_s``: items made for each second of the window; a run
  that answers faster runs out and fails.

A configuration's ``algorithm`` is one algorithm for every key, or a
mapping of algorithms to the share of keys that each holds (each key's
drawn from the seed; a key keeps its algorithm in every request).
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference.limiter import algorithm_shares

KEY_DIGITS = 8
SEED_CHUNK = 1 << 19  # items per seed request buffer
WARM_ROUNDS = 4  # warm-up requests a submitter, sent over and over
ALGORITHMS = {"token_bucket": 0, "leaky_bucket": 1}  # the proto enum


def varint(v: int) -> bytes:
    """Protobuf base-128 varint of a non-negative int."""
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, from the run's seed."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    s = int(seed)
    return np.random.default_rng([abs(s) & ((1 << 64) - 1), abs(s) >> 64, int(s < 0), tag])


def key_name(seed: int) -> bytes:
    """The limit's name for a run: the same for a seed, new across seeds,
    so each seed lays its keys out over the table anew."""
    return b"rl%06x" % (int(seed) % (1 << 24))


def hash_keys(name: bytes, ids: np.ndarray) -> np.ndarray:
    """(N, L) uint8 rows ``name + b"_k" + 8 digits`` (the hash keys)."""
    head = np.frombuffer(name + b"_k", np.uint8)
    rows = np.empty((ids.size, head.size + KEY_DIGITS), np.uint8)
    rows[:, :head.size] = head
    rows[:, head.size:] = _digits(ids)
    return rows


_QUADS = np.frombuffer(b"".join(b"%04d" % i for i in range(10_000)), np.uint8).reshape(-1, 4)


def _digits(ids: np.ndarray) -> np.ndarray:
    """(N, KEY_DIGITS) ASCII decimal digits of each id (below 10**8),
    zero-padded."""
    hi, lo = np.divmod(ids.astype(np.int64).reshape(-1), 10_000)
    return np.concatenate([_QUADS[hi], _QUADS[lo]], axis=1)


def _template(cfg: dict, name: bytes, hits_slot: bool, hits: int, algo_slot: bool):
    """One item's bytes with the key digits (and a 1-byte hits varint
    when `hits_slot`, a 1-byte algorithm when `algo_slot`) left to fill:
    (template, digit offset, hits offset, algorithm offset)."""
    key_len = 1 + KEY_DIGITS
    body = b"\x0a" + varint(len(name)) + name + b"\x12" + varint(key_len)
    digit_at = len(body) + 1
    body += b"k" + b"0" * KEY_DIGITS
    hits_at = algo_at = -1
    if hits_slot:
        body += b"\x18"
        hits_at = len(body)
        body += b"\x01"
    elif hits:
        body += b"\x18" + varint(hits)
    body += b"\x20" + varint(int(cfg["limit"])) + b"\x28" + varint(int(cfg["duration_ms"]))
    if algo_slot:
        body += b"\x30"
        algo_at = len(body)
        body += b"\x00"
    else:
        algo = ALGORITHMS[next(iter(algorithm_shares(cfg)))]
        if algo:
            body += b"\x30" + varint(algo)
    item = b"\x0a" + varint(len(body)) + body
    shift = len(item) - len(body)
    return (np.frombuffer(item, np.uint8), digit_at + shift,
            hits_at + shift if hits_slot else -1, algo_at + shift if algo_slot else -1)


def encode(cfg: dict, name: bytes, ids: np.ndarray, hits, per_request: int,
           leaky: np.ndarray = None) -> List[bytes]:
    """GetRateLimitsReq bytes of `per_request` items each over key ids
    `ids` (flat, a multiple of per_request long). `hits` is one int for
    every item, or an array of per-item hits below 128; `leaky` marks each
    item's algorithm where the configuration has two (else None)."""
    per_item = np.ndim(hits) > 0
    tpl, d_at, h_at, a_at = _template(cfg, name, per_item, 0 if per_item else int(hits),
                                      leaky is not None)
    n = ids.size
    buf = np.empty((n, tpl.size), np.uint8)
    buf[:] = tpl
    buf[:, d_at:d_at + KEY_DIGITS] = _digits(ids)
    if per_item:
        h = np.asarray(hits)
        if h.min(initial=1) < 1 or h.max(initial=1) > 127:
            raise ValueError("per-item hits must lie in [1, 127]")
        buf[:, h_at] = h.astype(np.uint8)
    if leaky is not None:
        buf[:, a_at] = np.where(leaky, ALGORITHMS["leaky_bucket"], ALGORITHMS["token_bucket"])
    flat = buf.reshape(-1)
    step = per_request * tpl.size
    mv = memoryview(flat)
    return [bytes(mv[i:i + step]) for i in range(0, flat.size, step)]


# YCSB's ScrambledZipfianGenerator: a ZipfianGenerator over ITEM_COUNT + 1
# items (0..ITEM_COUNT), with the zeta YCSB precomputed for 0.99
YCSB_ITEM_COUNT = 10_000_000_000
YCSB_ZETAN_099 = 26.46902820178302
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def zeta(n: int, theta: float, head: int = 1 << 20) -> float:
    """sum of i ** -theta for i in 1..n: the first `head` terms summed,
    the rest by Euler-Maclaurin."""
    m = min(int(n), head)
    s = float(np.sum(np.arange(1, m + 1, dtype=np.float64) ** -theta))
    if n <= m:
        return s
    a, b = float(m), float(n)
    f = lambda x: x ** -theta  # noqa: E731
    df = lambda x: -theta * x ** (-theta - 1.0)  # noqa: E731
    integral = (b ** (1.0 - theta) - a ** (1.0 - theta)) / (1.0 - theta)
    return s - f(a) + integral + (f(a) + f(b)) / 2.0 + (df(b) - df(a)) / 12.0


def fnvhash64(v: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64: FNV-1a 64 over the 8 little-endian bytes of
    each value, then Java's Math.abs of the signed result (int64)."""
    x = np.asarray(v, np.int64).astype(np.uint64)
    h = np.full(x.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime, low = np.uint64(FNV_PRIME_64), np.uint64(0xFF)
    for _ in range(8):
        h ^= x & low
        h *= prime
        x >>= np.uint64(8)
    return np.abs(h.view(np.int64))


def zipfian_ranks(u: np.ndarray, theta: float, items: int, zetan: float) -> np.ndarray:
    """YCSB ZipfianGenerator.nextLong (Gray et al., SIGMOD 1994) for
    uniform draws `u` in [0, 1)."""
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    ret = (float(items) * np.power(eta * u - eta + 1.0, alpha)).astype(np.int64)
    return np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, ret))


def scrambled_zipfian(rng: np.random.Generator, count: int, n_keys: int,
                      theta: float) -> np.ndarray:
    """`count` key ids in [0, n_keys) as YCSB's CoreWorkload draws them for
    ``requestdistribution=zipfian`` over ``recordcount = n_keys`` loaded
    records: ScrambledZipfianGenerator(0, n_keys) (n_keys + 1 values), a
    value past the last record drawn again."""
    items = YCSB_ITEM_COUNT + 1
    zetan = YCSB_ZETAN_099 if theta == 0.99 else zeta(items, theta)
    out = np.empty(count, np.int64)
    got = 0
    while got < count:
        need = count - got
        ranks = zipfian_ranks(rng.random(need + need // 64 + 16), theta, items, zetan)
        keys = np.fmod(fnvhash64(ranks), n_keys + 1)  # Java's % keeps the sign
        keys = keys[(keys >= 0) & (keys < n_keys)][:need]
        out[got:got + keys.size] = keys
        got += keys.size
    return out


def draw_keys(traffic: dict, n_keys: int, rng: np.random.Generator, count: int) -> np.ndarray:
    """`count` key ids under the mix's key distribution."""
    kind = traffic["keys"]
    if kind == "uniform":
        return rng.integers(0, n_keys, count, dtype=np.int64)
    if kind == "zipfian":
        return scrambled_zipfian(rng, count, n_keys, float(traffic["zipf_theta"]))
    raise ValueError(f"unknown key distribution {kind!r}")


def draw_hits(traffic: dict, rng: np.random.Generator, count: int):
    """Each item's hits: the mix's one number (an int), or `count` draws
    from its ``{"values", "weights"}``."""
    h = traffic["hits"]
    if isinstance(h, dict):
        values = np.asarray(h["values"], np.int64)
        w = np.asarray(h.get("weights", [1] * values.size), np.float64)
        return values[rng.choice(values.size, count, p=w / w.sum())]
    return int(h)


def leaky_keys(cfg: dict, seed: int) -> np.ndarray:
    """Which keys are leaky buckets: every key or none for one algorithm,
    else each key by its share, from the seed."""
    shares = algorithm_shares(cfg)
    n = int(cfg["keys"])
    if len(shares) == 1:
        return np.full(n, "leaky_bucket" in shares, bool)
    p = shares.get("leaky_bucket", 0.0) / sum(shares.values())
    return rng_for(seed, "algo").random(n) < p


class Inputs:
    """Everything a run sends, made from the configuration, the mix and
    the seed before the window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, seconds: float):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        n = int(cfg["keys"])
        self.name = key_name(seed)
        lo, hi = cfg["seed_hits"]
        self.seed_hits = rng_for(seed, "seedhit").integers(lo, hi + 1, n, dtype=np.int64)
        self.leaky = leaky_keys(cfg, seed)
        mixed = len(algorithm_shares(cfg)) > 1
        per = int(traffic["items_per_request"])
        self.per_request = per
        n_req = int(np.ceil(float(traffic["budget_items_per_s"]) * seconds / per))
        self.window_ids = draw_keys(traffic, n, rng_for(seed, "window"),
                                    n_req * per).reshape(n_req, per)
        self.window_hits = draw_hits(traffic, rng_for(seed, "hits"), n_req * per)
        n_warm = WARM_ROUNDS * int(traffic["submitters"])
        self.warm_ids = draw_keys(traffic, n, rng_for(seed, "warm"),
                                  n_warm * per).reshape(-1, per)
        order = rng_for(seed, "seedorder").permutation(n)
        self.seed_order = order
        self.seed_reqs = [encode(cfg, self.name, order[i:i + SEED_CHUNK],
                                 self.seed_hits[order[i:i + SEED_CHUNK]],
                                 min(SEED_CHUNK, n - i),
                                 self.leaky[order[i:i + SEED_CHUNK]] if mixed else None)[0]
                          for i in range(0, n, SEED_CHUNK)]
        wid = self.window_ids.reshape(-1)
        self.window_reqs = encode(cfg, self.name, wid, self.window_hits, per,
                                  self.leaky[wid] if mixed else None)
        self.warm_reqs = encode(cfg, self.name, self.warm_ids.reshape(-1), 0, per,
                                self.leaky[self.warm_ids.reshape(-1)] if mixed else None)

    def hits_of(self, rows: np.ndarray):
        """The hits of window items at flat indices `rows` (an int where
        every item has the same)."""
        h = self.window_hits
        return h if np.ndim(h) == 0 else h[rows]

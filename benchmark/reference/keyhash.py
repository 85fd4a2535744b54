"""The key fingerprint, frozen: XXH64 of the hash key ``name + "_" +
unique_key`` with seed 0x6775626572, masked to 63 bits, 0 remapped to 1
(the empty-slot sentinel), and the key's bucket ``fp % n_buckets``.

Written from the xxHash specification (XXH64, inputs shorter than 32
bytes) over rows of equal length, vectorised in uint64 NumPy arithmetic,
which wraps modulo 2**64 as the specification's arithmetic does.
"""

from __future__ import annotations

import numpy as np

SEED = 0x6775626572
MASK63 = (1 << 63) - 1

P1 = np.uint64(0x9E3779B185EBCA87)
P2 = np.uint64(0xC2B2AE3D27D4EB4F)
P3 = np.uint64(0x165667B19E3779F9)
P4 = np.uint64(0x85EBCA77C2B2AE63)
P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _le(rows: np.ndarray, p: int, width: int) -> np.ndarray:
    """Little-endian words of `width` (4 or 8) bytes at column p of each
    row, as uint64."""
    word = np.ascontiguousarray(rows[:, p:p + width]).view("<u%d" % width)
    return word.reshape(-1).astype(np.uint64)


def xxh64_rows(rows: np.ndarray, seed: int = SEED) -> np.ndarray:
    """XXH64 of each row of `rows`, an (N, L) uint8 array with L < 32, as
    uint64."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, length = rows.shape
    if length >= 32:
        raise ValueError("xxh64_rows covers inputs shorter than 32 bytes")
    with np.errstate(over="ignore"):
        h = np.full(n, (seed + int(P5) + length) & ((1 << 64) - 1), np.uint64)
        p = 0
        while p + 8 <= length:
            k = _rotl(_le(rows, p, 8) * P2, 31) * P1
            h = _rotl(h ^ k, 27) * P1 + P4
            p += 8
        if p + 4 <= length:
            h = _rotl(h ^ (_le(rows, p, 4) * P1), 23) * P2 + P3
            p += 4
        while p < length:
            h = _rotl(h ^ (rows[:, p].astype(np.uint64) * P5), 11) * P1
            p += 1
        h ^= h >> np.uint64(33)
        h *= P2
        h ^= h >> np.uint64(29)
        h *= P3
        h ^= h >> np.uint64(32)
    return h


def fingerprints(hash_keys: np.ndarray) -> np.ndarray:
    """63-bit fingerprints (int64, never 0) of hash keys given as an (N, L)
    uint8 array of equal-length ``name_uniquekey`` byte strings."""
    fp = (xxh64_rows(hash_keys) & np.uint64(MASK63)).astype(np.int64)
    fp[fp == 0] = 1
    return fp


def n_buckets_for(slots: int, ways: int = 8) -> int:
    """Buckets of a table of `slots` slots in `ways`-slot buckets: a power
    of two up to 2048 buckets, a multiple of 2048 above."""
    nb = -(-slots // ways)
    if nb <= 2048:
        return 1 << (nb - 1).bit_length()
    return -(-nb // 2048) * 2048

"""Key fingerprinting: XXH64 and XXH32 in pure Python.

The JAX package hashes with the ``xxhash`` extension; the port cannot count
on that package being installed, so it carries the algorithms itself
(xxHash specification, XXH64 and XXH32). The result is bit-identical: the
same seed, the same 63-bit mask, and the same remap of 0 (the empty-slot
sentinel) to 1. Strings hash as their UTF-8 bytes.

Pure-Python XXH64 costs microseconds a key. Once the native host extension
is loaded (``native.load()``), ``fingerprint`` calls its ``fingerprint64``,
the same function in C; nothing here builds or loads it.
"""

from __future__ import annotations

_SEED = 0x6775626572  # must be identical across peers and packages
_MASK63 = (1 << 63) - 1
_M64 = (1 << 64) - 1

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5

_M32 = (1 << 32) - 1
_Q1 = 0x9E3779B1
_Q2 = 0x85EBCA77
_Q3 = 0xC2B2AE3D
_Q4 = 0x27D4EB2F
_Q5 = 0x165667B1

# the native extension's seeded 63-bit XXH64, set by native.load()
_native_fp = None


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` as an unsigned 64-bit integer."""
    n = len(data)
    p = 0
    seed &= _M64
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        limit = n - 32
        while p <= limit:
            v1 = _round(v1, int.from_bytes(data[p:p + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[p + 8:p + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[p + 16:p + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[p + 24:p + 32], "little"))
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round32(acc: int, lane: int) -> int:
    acc = (acc + lane * _Q2) & _M32
    return (_rotl32(acc, 13) * _Q1) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of `data` as an unsigned 32-bit integer (the ring hash
    "xxhash" of peers/hash_ring.py)."""
    n = len(data)
    p = 0
    seed &= _M32
    if n >= 16:
        v1 = (seed + _Q1 + _Q2) & _M32
        v2 = (seed + _Q2) & _M32
        v3 = seed
        v4 = (seed - _Q1) & _M32
        limit = n - 16
        while p <= limit:
            v1 = _round32(v1, int.from_bytes(data[p:p + 4], "little"))
            v2 = _round32(v2, int.from_bytes(data[p + 4:p + 8], "little"))
            v3 = _round32(v3, int.from_bytes(data[p + 8:p + 12], "little"))
            v4 = _round32(v4, int.from_bytes(data[p + 12:p + 16], "little"))
            p += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _Q5) & _M32
    h = (h + n) & _M32
    while p + 4 <= n:
        h = (h + int.from_bytes(data[p:p + 4], "little") * _Q3) & _M32
        h = (_rotl32(h, 17) * _Q4) & _M32
        p += 4
    while p < n:
        h = (h + data[p] * _Q5) & _M32
        h = (_rotl32(h, 11) * _Q1) & _M32
        p += 1
    h ^= h >> 15
    h = (h * _Q2) & _M32
    h ^= h >> 13
    h = (h * _Q3) & _M32
    h ^= h >> 16
    return h


def fingerprint_key(hash_key: str) -> int:
    """63-bit fingerprint of a pre-joined hash key ("name_uniquekey"); equal
    to fingerprint(name, unique_key), which joins with "_". Never 0."""
    data = hash_key.encode("utf-8")
    if _native_fp is not None:
        return _native_fp(data)
    h = xxh64(data, _SEED) & _MASK63
    return h if h != 0 else 1


def fingerprint(name: str, unique_key: str) -> int:
    """63-bit fingerprint of a rate limit's hash key (name + "_" + key,
    reference client.go:39-41). Never returns 0 (the empty-slot sentinel)."""
    return fingerprint_key(name + "_" + unique_key)

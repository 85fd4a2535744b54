"""Key fingerprinting: XXH64 in pure Python.

The JAX package hashes with the ``xxhash`` extension; the port cannot count
on that package being installed, so it carries the algorithm itself
(xxHash specification, XXH64). The result is bit-identical: the same seed,
the same 63-bit mask, and the same remap of 0 (the empty-slot sentinel) to 1.
Strings hash as their UTF-8 bytes.
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


def fingerprint(name: str, unique_key: str) -> int:
    """63-bit fingerprint of a rate limit's hash key (name + "_" + key,
    reference client.go:39-41). Never returns 0 (the empty-slot sentinel)."""
    h = xxh64((name + "_" + unique_key).encode("utf-8"), _SEED) & _MASK63
    return h if h != 0 else 1

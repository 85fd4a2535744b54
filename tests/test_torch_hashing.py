"""Port parity: the pure-Python XXH64 fingerprint (gubernator_tpu_torch.hashing)
against the JAX package's xxhash-backed fingerprint and xxhash itself.

Lengths 0-80 cover every branch of XXH64: the short path (< 32 bytes), one
and two 32-byte stripes, and each 8-, 4- and 1-byte tail. Tolerance: exact.
"""

import numpy as np
import pytest
import xxhash

from gubernator_tpu import hashing as jax_hashing
from gubernator_tpu_torch import hashing

SEED = 0x6775626572


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", range(81))
def test_xxh64_every_length(n):
    data = _bytes(n, n)
    for seed in (0, SEED, 2**64 - 1):
        assert hashing.xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed=seed)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 64, 80])
def test_fingerprint_matches_reference(n):
    key = "k" * n
    for name in ("", "api", "name_with_underscores"):
        assert hashing.fingerprint(name, key) == jax_hashing.fingerprint(name, key)


@pytest.mark.parametrize(
    "name,key",
    [
        ("débit", "clé"),
        ("日本", "キー/ユーザー"),
        ("emoji", "🙂" * 9),
        ("mixed", "aé中\U0001f600" * 5),
        ("nul", "a\x00b"),
    ],
)
def test_fingerprint_non_ascii(name, key):
    assert hashing.fingerprint(name, key) == jax_hashing.fingerprint(name, key)
    full = (name + "_" + key).encode("utf-8")
    h = xxhash.xxh64_intdigest(full, seed=SEED) & ((1 << 63) - 1)
    assert hashing.fingerprint(name, key) == (h or 1)


def test_fingerprint_is_63_bit_and_nonzero():
    rng = np.random.default_rng(7)
    for i in range(200):
        fp = hashing.fingerprint("n", f"key-{rng.integers(1 << 40)}-{i}")
        assert 0 < fp < (1 << 63)


@pytest.mark.parametrize("raw", [0, 1 << 63])
def test_fingerprint_zero_remaps_to_one(monkeypatch, raw):
    """A hash whose low 63 bits are 0 is the empty-slot sentinel: both
    packages answer 1 instead."""
    monkeypatch.setattr(hashing, "xxh64", lambda data, seed=0: raw)
    monkeypatch.setattr(
        jax_hashing.xxhash, "xxh64_intdigest", lambda data, seed=0: raw
    )
    assert hashing.fingerprint("a", "b") == 1
    assert jax_hashing.fingerprint("a", "b") == 1

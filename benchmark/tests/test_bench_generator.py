"""The seeded generator: the same bytes from the same seed, new bytes
from a new one, the zipfian ranks' frequencies, and bytes that the port's
own parser reads back as the reference's keys and fields."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import generator
from benchmark.reference.keyhash import fingerprints
from benchmark.tests.small import small_cell


@pytest.mark.parametrize("cell", ["headline-batch1000", "skew-batch1000"])
def test_same_seed_same_bytes(cell):
    _, _, cfg, traffic = small_cell(cell)
    a = generator.Inputs(cfg, traffic, 2**31 + 77, 0.5)
    b = generator.Inputs(cfg, traffic, 2**31 + 77, 0.5)
    c = generator.Inputs(cfg, traffic, 2**31 + 78, 0.5)
    assert a.window_reqs == b.window_reqs and a.seed_reqs == b.seed_reqs
    assert a.warm_reqs == b.warm_reqs
    assert a.window_reqs != c.window_reqs and a.seed_reqs != c.seed_reqs
    assert len(a.window_reqs) == int(np.ceil(traffic["budget_items_per_s"] * 0.5
                                             / traffic["items_per_request"]))


def _fnv_plain(v: int) -> int:
    """YCSB Utils.fnvhash64, one value in plain Python ints."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = ((h ^ (v & 0xFF)) * 1099511628211) % (1 << 64)
        v >>= 8
    h = h - (1 << 64) if h >= 1 << 63 else h
    return abs(h) if h != -(1 << 63) else h


def test_fnvhash64_and_ycsb_zeta():
    vals = np.array([0, 1, 2, 255, 256, 2**31 - 1, 12_345_678_901, 10**10], np.int64)
    assert generator.fnvhash64(vals).tolist() == [_fnv_plain(int(v)) for v in vals]
    # YCSB precomputed its zeta for 0.99 over 10^10 items
    assert abs(generator.zeta(10**10, 0.99) / generator.YCSB_ZETAN_099 - 1) < 1e-9
    assert abs(generator.zeta(1000, 0.99)
               - np.sum(np.arange(1, 1001, dtype=np.float64) ** -0.99)) < 1e-9


def test_zipfian_ranks_follow_ycsb():
    """ZipfianGenerator's ranks over 10^10 items: rank 0 takes 1/zetan of
    the draws, rank 1 2^-0.99/zetan, and the top ranks' counts fall with a
    log-log slope within 0.03 of -0.99 (4M draws)."""
    z = generator.YCSB_ZETAN_099
    u = np.random.default_rng(5).random(4_000_000)
    r = generator.zipfian_ranks(u, 0.99, generator.YCSB_ITEM_COUNT + 1, z)
    assert r.min() >= 0 and r.max() <= generator.YCSB_ITEM_COUNT
    for rank in (0, 1):
        want = (rank + 1) ** -0.99 / z
        assert abs(np.mean(r == rank) / want - 1) < 0.02
    counts = np.bincount(r[r < 200], minlength=200).astype(np.float64)
    slope = np.polyfit(np.log(np.arange(1, 201)), np.log(counts), 1)[0]
    assert abs(slope + 0.99) < 0.03, slope


def test_scrambled_zipfian_over_the_keys():
    """CoreWorkload's zipfian over 2^20 records: every id is a record, the
    hottest key is FNV(rank 0)'s with 1/zetan of the draws, and most keys
    are drawn (the scrambled tail spreads almost uniformly)."""
    n = 1 << 20
    ids = generator.draw_keys({"keys": "zipfian", "zipf_theta": 0.99}, n,
                              np.random.default_rng(2), 2_000_000)
    assert ids.min() >= 0 and ids.max() < n
    c = np.bincount(ids, minlength=n)
    hot = _fnv_plain(0) % (n + 1)
    assert c.argmax() == hot
    assert abs(c[hot] / ids.size * generator.YCSB_ZETAN_099 - 1) < 0.05
    assert (c > 0).mean() > 0.6  # 2M draws reach 64% of the 2^20 keys


def test_hits_drawn_from_the_mix():
    rng = np.random.default_rng(4)
    assert generator.draw_hits({"hits": 3}, rng, 10) == 3
    h = generator.draw_hits({"hits": {"values": [1, 5], "weights": [3, 1]}}, rng, 40_000)
    assert set(np.unique(h).tolist()) == {1, 5} and abs(np.mean(h == 5) - 0.25) < 0.02


def test_uniform_keys_cover_the_key_space():
    ids = generator.draw_keys({"keys": "uniform"}, 1000, np.random.default_rng(3), 100_000)
    c = np.bincount(ids, minlength=1000)
    assert c.min() > 50 and c.max() < 160


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        generator.draw_keys({"keys": "latest"}, 10, np.random.default_rng(0), 5)


@pytest.mark.parametrize("cell", ["headline-batch1000", "skew-batch1000"])
def test_port_parses_the_bytes_as_the_reference_keys(cell):
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    _, _, cfg, traffic = small_cell(cell)
    inp = generator.Inputs(cfg, traffic, 99, 0.2)
    algo = generator.ALGORITHMS[cfg["algorithm"]]
    for i in (0, len(inp.window_reqs) - 1):
        cols = wire_batch_from_wire(inp.window_reqs[i])[0].cols
        fp = fingerprints(generator.hash_keys(inp.name, inp.window_ids[i]))
        assert (cols.fp == fp).all() and (cols.err == 0).all()
        assert (cols.hits == traffic["hits"]).all() and (cols.algo == algo).all()
        assert (cols.limit == cfg["limit"]).all() and (cols.duration == cfg["duration_ms"]).all()
    cols = wire_batch_from_wire(inp.warm_reqs[0])[0].cols
    assert (cols.hits == 0).all()
    cols = wire_batch_from_wire(inp.seed_reqs[0])[0].cols
    order = inp.seed_order[: cols.fp.size]
    assert (cols.hits == inp.seed_hits[order]).all()
    assert (cols.fp == fingerprints(generator.hash_keys(inp.name, order))).all()


def test_varint_and_digits():
    assert generator.varint(0) == b"\x00" and generator.varint(300) == b"\xac\x02"
    assert generator.varint(60000) == b"\xe0\xd4\x03"
    d = generator.hash_keys(b"rl", np.array([0, 12345678, 99999999]))
    assert [bytes(r) for r in d] == [b"rl_k00000000", b"rl_k12345678", b"rl_k99999999"]


def test_two_algorithms_and_drawn_hits_parse_as_the_reference_reads_them():
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    _, _, cfg, traffic = small_cell("skew-batch1000")
    cfg = dict(cfg, algorithm={"token_bucket": 1, "leaky_bucket": 1})
    traffic = dict(traffic, hits={"values": [1, 2, 7], "weights": [5, 2, 1]})
    inp = generator.Inputs(cfg, traffic, 2**33 + 5, 0.2)
    assert 0.4 < inp.leaky.mean() < 0.6
    per = inp.per_request
    for i in (0, len(inp.window_reqs) - 1):
        cols = wire_batch_from_wire(inp.window_reqs[i])[0].cols
        ids = inp.window_ids[i]
        assert (cols.err == 0).all()
        assert (cols.fp == fingerprints(generator.hash_keys(inp.name, ids))).all()
        assert (cols.algo == inp.leaky[ids].astype(int)).all()
        assert (cols.hits == inp.hits_of(np.arange(i * per, (i + 1) * per))).all()
    cols = wire_batch_from_wire(inp.seed_reqs[0])[0].cols
    order = inp.seed_order[: cols.fp.size]
    assert (cols.algo == inp.leaky[order].astype(int)).all()

"""Card-only tests of the port: the CUDA kernels against their plain PyTorch
versions, and the engine on the card against the engine on the CPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports only torch, numpy and the port — the
machine with the card has no JAX — so run it there without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.ops.batch import RequestColumns
from gubernator_tpu_torch.ops.engine import LocalEngine
from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

pytestmark = pytest.mark.cuda

NOW = 1_700_000_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _claim(card, layout, n, sentinel, seed, nb=1 << 18, chosen=None):
    """A table, canonical rows and a claim with unique slots on the card;
    `sentinel` of the rows not written, `chosen` pins every lane."""
    from gubernator_tpu_torch.ops.layout import LAYOUTS

    lay, k = LAYOUTS[layout], 8
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    base = torch.randint(-(2**31), 2**31 - 1, (nb, k * lay.F), dtype=torch.int32,
                         device=card, generator=gen)
    new16 = torch.randint(-(2**31), 2**31 - 1, (n, 16), dtype=torch.int32,
                          device=card, generator=gen)
    if chosen is None:
        slots = torch.randperm(nb * k, device=card, generator=gen)[:n]
    else:
        slots = torch.randperm(nb, device=card, generator=gen)[:n] * k + chosen
    written = torch.rand(n, device=card, generator=gen) >= sentinel
    return base, (new16, written, (slots // k).to(torch.int32), slots % k, lay)


def _write_both(base, args):
    got, want = base.clone(), base.clone()
    before = slot_write.launches
    slot_write(got, *args)
    slot_write_ref(want, *args)
    torch.cuda.synchronize()
    assert slot_write.launches == before + 1
    return got, want


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
@pytest.mark.parametrize(
    "n,sentinel", [(1 << 17, 0.0), (100_003, 0.1), (1, 0.0), (129, 0.0), (4096, 1.0)],
    ids=["headline", "ragged_sentinels", "one_row", "one_past_a_tile", "none_written"])
def test_slot_write_matches_plain_version(card, layout, n, sentinel):
    base, args = _claim(card, layout, n, sentinel, seed=n)
    got, want = _write_both(base, args)
    assert torch.equal(got, want)
    if sentinel == 1.0:
        assert torch.equal(got, base)


@pytest.mark.parametrize("layout", ["full", "token32"])
@pytest.mark.parametrize("chosen", [0, 7])
def test_slot_write_first_and_last_lane(card, layout, chosen):
    base, args = _claim(card, layout, 5_000, 0.2, seed=chosen, chosen=chosen)
    got, want = _write_both(base, args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("operand", ["rows", "new16"])
def test_slot_write_rejects_misaligned_operand(card, operand):
    """The kernel moves 16-byte pieces of the table and the canonical rows:
    either one off a 16-byte boundary raises instead of launching."""
    base, (new16, written, bucket, chosen, lay) = _claim(card, "full", 64, 0.0, seed=1,
                                                         nb=64)
    ops = {"rows": base, "new16": new16}
    t = ops[operand]
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=card)
    ops[operand] = buf[1:t.numel() + 1].view(t.shape)  # 4 bytes in: not 16-byte aligned
    before = slot_write.launches
    with pytest.raises(ValueError, match="aligned"):
        slot_write(ops["rows"], ops["new16"], written, bucket, chosen, lay)
    assert slot_write.launches == before


@pytest.mark.parametrize("layout", ["full", "gcra32"])
def test_slot_write_graph_replay_matches_eager(card, layout):
    """The write captured in a CUDA graph and replayed lands the same bytes
    as the eager call: the launch allocates, syncs and queries nothing."""
    base, args = _claim(card, layout, 20_000, 0.1, seed=3)
    eager, captured = base.clone(), base.clone()
    slot_write(eager, *args)
    slot_write(captured.clone(), *args)  # warm: the build
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            slot_write(captured, *args)
    assert torch.equal(captured, base)  # capture runs nothing
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.parametrize("probe", ["xla", "pallas"])
def test_engine_card_matches_cpu(card, probe):
    """Contended mixed-algorithm batches: responses, stats and table bytes of
    the card's engine equal the CPU engine's, on either decide walk; each
    dispatch launched its walk's kernel once."""
    from gubernator_tpu_torch.ops.probe_walk import probe_walk

    rng = np.random.default_rng(0)
    gpu = LocalEngine(capacity=1 << 14, device=card, probe=probe)
    cpu = LocalEngine(capacity=1 << 14, device="cpu", probe=probe)
    nb = gpu.table.n_buckets
    pool = rng.integers(1, 2**63 - 1, 3_000, dtype=np.int64)
    now = NOW
    kernel = slot_write if probe == "xla" else probe_walk
    launches = kernel.launches
    for _ in range(4):
        n = 1024
        fp = rng.choice(pool, n)
        hot = rng.random(n) < 0.3
        fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 8, hot.sum())
        cols = RequestColumns(
            fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=(np.where(rng.random(n) < 0.1, 8, 0)
                      | np.where(rng.random(n) < 0.1, 32, 0)).astype(np.int32),
            hits=rng.integers(-1, 5, n).astype(np.int64),
            limit=rng.integers(0, 20, n).astype(np.int64),
            burst=np.zeros(n, np.int64),
            duration=rng.integers(1, 6, n).astype(np.int64) * 1_000,
            created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
        )
        a = gpu.check_columns(cols, now_ms=now)
        b = cpu.check_columns(cols, now_ms=now)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert gpu.snapshot().tobytes() == cpu.snapshot().tobytes()
        now += int(rng.integers(0, 3_000))
    assert dataclasses.asdict(gpu.stats) == dataclasses.asdict(cpu.stats)
    assert kernel.launches - launches == gpu.stats.dispatches


# ------------------------------------------------------------- probe walk


def _walk_inputs(rng, n, nb, layout_name, math, now=NOW, hot_frac=0.3, active_frac=0.9,
                 key0=0):
    """Request rows (numpy) and (n, 16) incoming slots for one walk: random
    and bucket-concentrated (`hot_frac`) keys, inactive padding (fp 0, all
    in bucket 0; 1 - `active_frac` of the rows), `key0` active keys of
    bucket 0 first, per-row clocks."""
    from gubernator_tpu_torch.ops.layout import LAYOUTS

    algos = {"token": (0,), "gcra": (2,), "int": (0, 2, 3, 4), "mixed": (0, 1, 2, 3, 4)}[math]
    if layout_name == "gcra32":
        algos = (2,)
    elif layout_name == "token32":
        algos = (0,)
    fp = rng.integers(1, 1 << 62, n, dtype=np.int64)
    hot = rng.random(n) < hot_frac
    fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 8, hot.sum())
    fp = np.unique(fp)
    fp = np.concatenate([fp, rng.integers(1, 1 << 62, n - fp.size, dtype=np.int64)])
    active = rng.random(n) < active_frac
    fp[~active] = 0
    if key0:
        fp[key0:][active[key0:] & (fp[key0:] % nb == 0)] += 1  # bucket 0: only these
        fp[:key0] = rng.integers(1, 1 << 40, key0) * nb
        active[:key0] = True
    cols = dict(
        fp=fp, algo=rng.choice(np.asarray(algos, np.int32), n),
        behavior=(np.where(rng.random(n) < 0.1, 8, 0)
                  | np.where(rng.random(n) < 0.1, 32, 0)).astype(np.int32),
        hits=rng.integers(-1, 5, n).astype(np.int64),
        limit=rng.integers(0, 20, n).astype(np.int64),
        burst=rng.integers(0, 20, n).astype(np.int64),
        duration=rng.integers(1, 6, n).astype(np.int64) * 1_000,
        created_at=now + rng.integers(-2_000, 2_000, n).astype(np.int64),
        greg_interval=np.where(rng.random(n) < 0.05, 86_400_000, 0).astype(np.int64),
        active=active,
    )
    cols["expire_new"] = cols["created_at"] + cols["duration"]
    cols["duration_eff"] = cols["duration"].copy()
    pay16 = rng.integers(-(2**31), 2**31, (n, 16), dtype=np.int64).astype(np.int32)
    pay16[:, 0] = (fp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    pay16[:, 1] = (fp >> 32).astype(np.int32)
    exp = now + rng.integers(-5_000, 60_000, n)
    pay16[:, 10:12] = exp.astype(np.int64).view(np.int32).reshape(n, 2)
    return cols, pay16, LAYOUTS[layout_name]


def _run_walk(fn, device, rows_np, layout, stage, cols, pay16, math, evictees):
    """One walk through `fn` (the kernel's wrapper or its plain version) on
    fresh tensors on `device`: (rows after, responses)."""
    from gubernator_tpu_torch.ops.batch import ReqBatch

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in cols.items()}
    rows = torch.from_numpy(rows_np.copy()).to(device)
    req = ReqBatch(**t) if stage == "decide" else None
    p16 = None if stage == "decide" else torch.from_numpy(pay16).to(device)
    out = fn(rows, layout, stage, t["fp"], t["created_at"], t["active"], req=req,
             pay16=p16, math=math, evictees=evictees)
    return rows, out


WALK_CASES = {  # name: (buckets, rows, _walk_inputs keywords)
    # contended buckets, 10% padding (bucket 0 holds hot keys and padding)
    "contended": (256, 4096, {}),
    # about one row per bucket: nearly every row a singleton writer
    "singletons": (1 << 16, 4096, dict(hot_frac=0.0, active_frac=0.99)),
    # half padding beside one active key of bucket 0: a singleton writer
    # whose ~2048 readers fill some 64 reader units
    "bucket0": (256, 4096, dict(hot_frac=0.0, active_frac=0.5, key0=1)),
}


@pytest.mark.parametrize("stage,math,layout_name,evictees,case", [
    ("decide", "token", "full", False, "contended"),
    ("decide", "gcra", "full", False, "contended"),
    ("decide", "int", "full", False, "contended"),
    ("decide", "mixed", "full", True, "contended"),
    ("decide", "gcra", "gcra32", False, "contended"),
    ("decide", "token", "token32", False, "contended"),
    ("install", "mixed", "full", False, "contended"),
    ("install", "mixed", "gcra32", False, "contended"),
    ("merge", "mixed", "full", True, "contended"),
    ("merge", "mixed", "token32", False, "contended"),
    ("decide", "mixed", "full", False, "singletons"),
    ("decide", "mixed", "full", False, "bucket0"),
    ("install", "mixed", "full", False, "bucket0"),
    ("merge", "mixed", "full", True, "bucket0"),
    # the tiering walks: a decide with the evictee sidecar on singletons and
    # bucket-0 padding, and the promote merge with evictees on singletons
    ("decide", "token", "full", True, "singletons"),
    ("decide", "mixed", "full", True, "bucket0"),
    ("merge", "mixed", "full", True, "singletons"),
])
def test_probe_walk_matches_plain_version(card, stage, math, layout_name, evictees, case):
    """The kernel against probe_walk_ref on the same CUDA inputs: a table
    filled by earlier walks plus rows of arbitrary bytes, per-row clocks,
    and the WALK_CASES key mixes (contended buckets, singletons, bucket-0
    padding beside an active key); responses and table bytes equal."""
    from gubernator_tpu_torch.ops.probe_walk import (
        probe_walk, probe_walk_ref, walk_schedule, walk_units,
    )

    seed = len(stage) * 100 + len(math) * 10 + len(layout_name)
    rng = np.random.default_rng(seed if case == "contended" else seed + 1000 * len(case))
    nb, n, kw = WALK_CASES[case]
    cols, pay16, layout = _walk_inputs(rng, n, nb, layout_name, math, **kw)
    writers, _readers = walk_units(walk_schedule(
        torch.from_numpy(cols["fp"]), torch.from_numpy(cols["active"]), nb)[1])
    if case == "bucket0":  # bucket 0's writer is the first unit, a singleton
        assert writers[0][1] - writers[0][0] == 1 and writers[0][2] > 3 * 32
    rows_np = np.zeros((nb, layout.row), np.int32)
    junk = rng.random(nb) < 0.1
    rows_np[junk] = rng.integers(-(2**31), 2**31, (junk.sum(), layout.row)).astype(np.int32)
    for step in range(3):
        c = dict(cols, created_at=cols["created_at"] + step * 1_500)
        c["expire_new"] = c["created_at"] + c["duration"]
        before = probe_walk.launches
        got_rows, got = _run_walk(probe_walk, card, rows_np, layout, stage, c, pay16,
                                  math, evictees)
        want_rows, want = _run_walk(probe_walk_ref, card, rows_np, layout, stage, c,
                                    pay16, math, evictees)
        torch.cuda.synchronize()
        assert probe_walk.launches == before + 1
        assert torch.equal(got, want), f"step {step}: responses"
        assert torch.equal(got_rows, want_rows), f"step {step}: table bytes"
        rows_np = got_rows.cpu().numpy()


# ------------------------------------------------------------ fence claim

FENCE_CASES = [
    # (slots, published tickets, start, k): contiguous, gap, wrap, k-bound,
    # nothing published, head unpublished
    (4, [0, 1, 2], 0, 4),
    (4, [0, 2, 3], 0, 4),
    (4, [4, 5, 6, 7], 4, 4),
    (8, list(range(6)), 0, 2),
    (4, [], 0, 4),
    (4, [1, 2], 0, 4),
]


def _fence_inputs(rng, slots, width, tickets, dtype):
    grids = rng.integers(-(2**31), 2**31, (slots, 5, width + 1), dtype=np.int64)
    seq_in = np.zeros(slots, np.int64)
    for t in tickets:
        seq_in[t % slots] = t + 1
    seq_out = rng.integers(0, 3, slots)
    as_t = lambda a, dt: torch.from_numpy(a.astype(dt))
    return as_t(grids, np.int32), as_t(seq_in, dtype), as_t(seq_out, dtype)


def _claim_both(card, grids, seq_in, seq_out, start, k, k_max):
    from gubernator_tpu_torch.ops.ring_drain import fence_claim, fence_claim_plain

    g, si = grids.to(card), seq_in.to(card)
    so_k, so_p = seq_out.to(card), seq_out.to(card)
    before = fence_claim.launches
    bank_k, n_k = fence_claim(si, so_k, g, start, k, k_max)
    bank_p, n_p = fence_claim_plain(si, so_p, g, start, k, k_max)
    torch.cuda.synchronize()
    assert fence_claim.launches == before + 1
    assert torch.equal(n_k, n_p)
    assert torch.equal(so_k, so_p)
    assert torch.equal(bank_k, bank_p)
    return int(n_k[0])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", FENCE_CASES)
def test_fence_claim_matches_plain_version(card, case, dtype):
    slots, tickets, start, k = case
    rng = np.random.default_rng(slots + len(tickets))
    grids, seq_in, seq_out = _fence_inputs(rng, slots, 6, tickets, dtype)
    _claim_both(card, grids, seq_in, seq_out, start, k, k)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_fence_claim_ring_geometry(card, dtype):
    """The ring's geometry (S 64, W 16384, k 8): a full claim across the
    wrap, then a claim cut by a gap."""
    rng = np.random.default_rng(9)
    grids, seq_in, seq_out = _fence_inputs(rng, 64, 16384, range(60, 68), dtype)
    assert _claim_both(card, grids, seq_in, seq_out, 60, 8, 8) == 8
    seq_in[(63 % 64)] = 0  # ticket 63 unpublished
    assert _claim_both(card, grids, seq_in, seq_out, 60, 8, 8) == 3


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_fence_claim_misaligned_slots_spare_bank_rows(card, dtype):
    """Slots whose base lies 4, 8 or 12 bytes off their bank row's
    alignment (a slot is 5·(W+1)·4 = 327,700 B at the ring width), and
    k_max above the claim: the bank rows past n are zeros."""
    rng = np.random.default_rng(21)
    grids, seq_in, seq_out = _fence_inputs(rng, 16, 16384, range(1, 8), dtype)
    for start in (1, 2, 3, 4):
        # tickets start .. 7 are published: a gap stops the claim at 8
        n = _claim_both(card, grids, seq_in, seq_out, start, 8, 12)
        assert n == 8 - start


@pytest.mark.parametrize("probe", ["xla", "pallas"])
def test_ring_drain_card_matches_cpu(card, probe):
    """Ring groups on the card against the same ring on the CPU: bank, n,
    seq_out, responses, stats and table bytes; one fence_claim launch per
    drain."""
    from gubernator_tpu_torch.ops import ring_drain as rd
    from gubernator_tpu_torch.ops.engine import prepare_ring_slot
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    rng = np.random.default_rng(3)
    S, W, K = 8, 512, 4
    engines = [LocalEngine(capacity=1 << 12, device=d, probe=probe, wire="compact")
               for d in (card, "cpu")]
    rings = [rd.DeviceRing(S, W, K, device=d) for d in (card, "cpu")]
    nb = engines[0].table.n_buckets
    pool = rng.integers(1, 2**63 - 1, 4_000, dtype=np.int64)
    start, now = 0, NOW
    launches = rd.fence_claim.launches
    for _ in range(5):
        slots = []
        for _ in range(K):
            m = int(rng.integers(100, W))
            fp = rng.choice(pool, m, replace=False)
            hot = rng.random(m) < 0.3
            fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 8, hot.sum())
            fp = np.unique(fp)
            m = fp.shape[0]
            algo = rng.integers(0, 5, m).astype(np.int32)
            algo[0] = 1
            slots.append(wire_batch_from_columns(RequestColumns(
                fp=fp, algo=algo, behavior=np.where(rng.random(m) < 0.1, 8, 0).astype(np.int32),
                hits=rng.integers(0, 5, m).astype(np.int64),
                limit=rng.integers(0, 20, m).astype(np.int64), burst=np.zeros(m, np.int64),
                duration=rng.integers(1, 6, m).astype(np.int64) * 1_000,
                created_at=np.zeros(m, np.int64), err=np.zeros(m, np.int8))))
        results = []
        for eng, ring in zip(engines, rings):
            group = [prepare_ring_slot(eng, [wb], W, now_ms=now) for wb in slots]
            bank, n = rd.issue_ring_group(eng, ring, group, start)
            done = rd.finish_ring_group(eng, group, bank, n, lambda fn: fn())
            for _rc, delta in done:
                eng.stats.merge(delta)
            results.append((bank.cpu().numpy(), ring.seq_out.cpu().numpy(), done))
        (ba, sa, da), (bb, sb, db) = results
        assert np.array_equal(ba, bb) and np.array_equal(sa, sb)
        for (ra, _), (rb, _) in zip(da, db):
            for f in ra._fields:
                np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f), err_msg=f)
        assert engines[0].snapshot().tobytes() == engines[1].snapshot().tobytes()
        start += K
        now += int(rng.integers(0, 2_000))
    assert dataclasses.asdict(engines[0].stats) == dataclasses.asdict(engines[1].stats)
    assert rd.fence_claim.launches - launches == 5


# ------------------------------------------- the exp/ sweep kernels (slice 4)


def _i32(rng, shape):
    return torch.from_numpy(rng.integers(-(2**31), 2**31, shape, dtype=np.int64)
                            .astype(np.int32))


def _both_ways(card, kernel, plain, table, *args, **kw):
    """Run `kernel` and `plain` on copies of `table` on the card; the kernel
    launched once and the tables are byte-equal."""
    from gubernator_tpu_torch.exp import sweeps

    wrapper = sweeps.kernels()[kernel]
    args = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    got, want = table.clone().to(card), table.clone().to(card)
    before = wrapper.launches
    wrapper(got, *args, **kw)
    plain(want, *args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("nb,aliased", [(1 << 16, False), (1 << 16, True), (3001, False),
                                        (3001, True), (40, False), (40, True)])
def test_sweep_copy_matches_plain_version(card, nb, aliased):
    """Out of place byte-equal, in place unchanged: a table of many chunks,
    a ragged last chunk (NB 3001) and a table smaller than one stage."""
    from gubernator_tpu_torch.exp import sweeps

    src = _i32(np.random.default_rng(nb), (nb, 128)).to(card)
    dst = src if aliased else torch.zeros_like(src)
    want = src.clone()
    before = sweeps.sweep_copy.launches
    sweeps.sweep_copy(src, dst)
    torch.cuda.synchronize()
    assert sweeps.sweep_copy.launches == before + 1
    assert torch.equal(dst, want)


@pytest.mark.parametrize("u,inplace", [(64, False), (128, False), (64, True), (1, True)])
def test_sweep_rows_matches_plain_version(card, u, inplace):
    """Signed bytes, masks in [-2, 2], targets in [-1, 2048) with hot rows
    that collide, four 2048-row blocks."""
    from gubernator_tpu_torch.exp import sweeps

    rng = np.random.default_rng(u + inplace)
    nb = 4 * 2048
    n = 4 * u
    table = _i32(rng, (nb, 128))
    rows = _i32(rng, (n, 128))
    mask = torch.from_numpy(rng.integers(-2, 3, (n, 128)).astype(np.int8))
    bkt = rng.integers(-1, 2048, n).astype(np.int32)
    hot = rng.random(n) < 0.5
    bkt[hot] = rng.integers(-1, 8, int(hot.sum()))
    bkt = torch.from_numpy(bkt)
    if inplace:
        got = _both_ways(card, "sweep_rows", sweeps.sweep_rows_ref, table, rows, mask, bkt, u)
    else:
        outs = [torch.zeros((nb, 128), dtype=torch.int32, device=card) for _ in range(2)]
        t = table.to(card)
        args = [x.to(card) for x in (rows, mask, bkt)]
        sweeps.sweep_rows(t, *args, u, out=outs[0])
        sweeps.sweep_rows_ref(t, *args, u, out=outs[1])
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        got = outs[0]
    assert not torch.equal(got.cpu(), table)


def _slot_inputs(card, case, planes):
    """(table, new16, slot, lb, U) of one sweep_slots case: exp_sweep2's
    data at 2^15 rows (16 windows of 256) with dense colliding targets in
    two windows, as the script draws it, with each window sorted by target
    (dead entries last) or shuffled; or numpy-drawn windows."""
    from gubernator_tpu_torch.exp import exp_sweep2

    if case in ("script", "sorted", "shuffled"):
        u = 256
        gen = torch.Generator(device=card)
        gen.manual_seed(planes)
        rows, wnew, wslot, wlb = exp_sweep2.make_data(gen, card, nb=1 << 15, blk=2048, u=u)
        wlb = wlb.clone()
        for w0 in (0, u):
            wlb[w0:w0 + 64] = torch.randint(0, 4, (64, 1), dtype=torch.int32, device=card,
                                            generator=gen)
        if case == "sorted":
            wnew, wslot, wlb = exp_sweep2.sort_windows(wnew, wslot, wlb, u, 2048)
        elif case == "shuffled":
            order = torch.argsort(torch.rand((wlb.shape[0] // u, u), device=card,
                                             generator=gen), dim=1)
            idx = (order + torch.arange(order.shape[0], device=card)[:, None] * u).reshape(-1)
            wnew, wslot, wlb = wnew[idx], wslot[idx], wlb[idx]
        return rows.cpu(), wnew, wslot, wlb, u
    rng = np.random.default_rng(planes + 7 * len(case))
    u, nblk, blk = {"one_run": (256, 4, 64), "u2048": (2048, 3, 128), "u100": (100, 6, 32),
                    "out_of_range": (64, 4, 64)}[case]
    n = nblk * u
    if case == "one_run":  # every entry live, one target a window
        lb, slot = np.full(n, 17), np.full(n, 3)
    elif case == "u2048":  # 2048 entries over 1024 slots, a tenth dead
        lb, slot = rng.integers(0, blk, n), rng.integers(0, 8, n)
        lb[rng.random(n) < 0.1] = -1
    else:  # lb and slot a little outside their ranges, hot targets
        lb, slot = rng.integers(-3, blk + 3, n), rng.integers(-2, 10, n)
        hot = rng.random(n) < 0.3
        lb[hot], slot[hot] = rng.integers(0, 2, int(hot.sum())), 5
        if case == "out_of_range":
            out = rng.random(n) < 0.5
            lb[out] = np.where(rng.random(int(out.sum())) < 0.5,
                               -1 - rng.integers(0, 5, int(out.sum())),
                               blk + rng.integers(0, 5, int(out.sum())))
    return (_i32(rng, (nblk * blk, 128)), _i32(rng, (n, 16)),
            torch.from_numpy(slot.astype(np.int32)[:, None]),
            torch.from_numpy(lb.astype(np.int32)[:, None]), u)


@pytest.mark.parametrize("planes,case", [
    (p, c) for c in ("script", "sorted", "shuffled", "one_run", "u100", "out_of_range")
    for p in (8, 16)] + [(8, "u2048")])
def test_sweep_slots_matches_plain_version(card, planes, case):
    """The owner-table kernel and the kept link design
    (guber_sweep_slots_link) byte-equal to the plain version: exp_sweep2's
    data as drawn, sorted by target and shuffled (no order of targets
    changes a byte); a single run of U; U 2048, the largest window, whose
    owner table needs more than 48 KB of shared memory; a U that is not a
    multiple of 32; lb and slot out of range."""
    import ctypes

    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.exp import sweeps

    table, new16, slot, lb, u = _slot_inputs(card, case, planes)
    got = _both_ways(card, "sweep_slots", sweeps.sweep_slots_ref, table, new16, slot, lb, u,
                     planes)
    assert not torch.equal(got.cpu(), table)
    link = _build.load("sweep_slots").guber_sweep_slots_link
    link.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    link.restype = ctypes.c_int
    old = table.clone().to(card)
    new16, slot, lb = new16.to(card), slot.to(card), lb.to(card)
    err = link(old.data_ptr(), new16.data_ptr(), slot.data_ptr(), lb.data_ptr(),
               new16.shape[0] // u, u, table.shape[0] * u // new16.shape[0], planes,
               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(old, got)


@pytest.mark.parametrize("marker,skip2", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_sweep_window_matches_plain_version(card, marker, skip2):
    """Sorted targets with a block whose run overflows its two windows,
    repeated targets and a sentinel tail; marker fields that are 1, 0,
    negative or high-byte."""
    from gubernator_tpu_torch.exp import exp_sweep5, sweeps

    rng = np.random.default_rng(2 * marker + skip2)
    nb, B, blk, u = 4096, 2048, 64, 32
    kblk = 8 * blk
    tgt = np.sort(rng.choice(nb * 8, size=B - 190, replace=False))
    crowd = 5 * kblk + np.sort(rng.choice(kblk, 180, replace=False))
    tgt = np.sort(np.concatenate([tgt, crowd, tgt[:10]]))[: B - 4]
    assert tgt.shape[0] == B - 4
    tgt = torch.from_numpy(np.concatenate([tgt, [nb * 8] * 4]).astype(np.int32))
    pay = _i32(rng, (B, 16))
    if marker:
        pay[:, 15] = torch.from_numpy(rng.choice(
            np.array([1, 1, 1, 0, -1, 0x80, 0x100, -(2**31)], dtype=np.int32), B))
    s_blk, need2 = exp_sweep5.window_starts(tgt.to(card), nb, blk, u)
    _both_ways(card, "sweep_window", sweeps.sweep_window_ref, _i32(rng, (nb, 128)), pay,
               tgt, s_blk, need2, blk, u, marker, skip2)


def _window_inputs(rng, nb, B, blk, u, shuffled):
    """exp_sweep5's layout (sorted unique targets, a sentinel tail), the
    targets optionally shuffled within each window of u."""
    from gubernator_tpu_torch.exp import exp_sweep5

    tgt = np.sort(rng.choice(nb * 8, size=B - 8, replace=False))
    tgt = np.concatenate([tgt, [nb * 8] * 8]).astype(np.int32)
    s_blk, need2 = exp_sweep5.window_starts(torch.from_numpy(tgt), nb, blk, u)
    if shuffled:
        for w in range(B // u):
            rng.shuffle(tgt[w * u:(w + 1) * u])
    return torch.from_numpy(tgt), s_blk, need2


@pytest.mark.parametrize("marker,skip2", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_sweep_window_shuffled_targets_match_plain_version(card, marker, skip2):
    """The function does not need sorted targets: windows shuffled inside,
    with the window starts of the sorted order."""
    from gubernator_tpu_torch.exp import sweeps

    rng = np.random.default_rng(10 + 2 * marker + skip2)
    nb, B, blk, u = 4096, 2048, 64, 32
    tgt, s_blk, need2 = _window_inputs(rng, nb, B, blk, u, shuffled=True)
    pay = _i32(rng, (B, 16))
    if marker:
        pay[:, 15] = torch.from_numpy(rng.choice(np.array([1, 0, -1, 2], dtype=np.int32), B))
    _both_ways(card, "sweep_window", sweeps.sweep_window_ref, _i32(rng, (nb, 128)), pay,
               tgt, s_blk, need2, blk, u, marker, skip2)


def test_sweep_window_marker_sums_that_cancel(card):
    """Targets in both halves of one block whose marker sums cancel: each
    half's w is a bytewise sum of field 15, and the slot is written only
    where w_1 + w_2 > 0 as a wrapping int32."""
    from gubernator_tpu_torch.exp import sweeps

    rng = np.random.default_rng(5)
    nb, blk, u = 64, 64, 8  # one block, two windows of 8
    tgt = np.array([3, 3, 9, 17, 17, 40, 41, 42,  # half 1
                    3, 9, 17, 17, 40, 41, 42, 50], np.int32)  # half 2
    f15 = np.array([5, -2, 1, 2**31 - 1, 0, 1, 0x80, 0,
                    253, -1, 1, 0, 1, 0x80, 0, 7], np.int32)
    pay = _i32(rng, (16, 16))
    pay[:, 15] = torch.from_numpy(f15)
    table = _i32(rng, (nb, 128))
    got = _both_ways(card, "sweep_window", sweeps.sweep_window_ref, table, pay,
                     torch.from_numpy(tgt), torch.zeros(1, dtype=torch.int32), None, blk, u,
                     True, False)
    slots, before = got.cpu().view(-1, 16), table.view(-1, 16)
    # slot 3: 0xFFFFFF03 (5 and -2 bytewise) + 253 == 0; slot 9: 1 - 1;
    # slot 17: 0x7FFFFFFF + 1 wraps negative; slot 42: 0 + 0
    for t in (3, 9, 17, 42):
        assert torch.equal(slots[t], before[t]), t
    # slot 40: 1 + 1; slot 41: 0x80 + 0x80 (no byte carries across halves);
    # slot 50: half 2 alone
    for t in (40, 41, 50):
        assert not torch.equal(slots[t], before[t]), t


@pytest.mark.parametrize("u", [1024, 1])
def test_sweep_window_every_entry_live(card, u):
    """Both windows of every block live with colliding targets: at u 1024
    a block sorts all 2048 entries, the largest sort; at u 1 one entry a
    window."""
    from gubernator_tpu_torch.exp import sweeps

    rng = np.random.default_rng(u)
    blk = 1024 if u == 1024 else 4
    nblk = 3
    nb, kblk = nblk * blk, 8 * blk
    B = 2 * u * nblk
    tgt = np.concatenate([i * kblk + rng.integers(0, kblk // 2, 2 * u)
                          for i in range(nblk)]).astype(np.int32)
    s_blk = torch.arange(0, 2 * nblk, 2, dtype=torch.int32)
    pay = _i32(rng, (B, 16))
    for marker in (False, True):
        _both_ways(card, "sweep_window", sweeps.sweep_window_ref, _i32(rng, (nb, 128)), pay,
                   torch.from_numpy(tgt), s_blk, None, blk, u, marker, False)


def _rows_both_ways(card, table, rows, mask, bkt, u, inplace):
    """sweep_rows on the card against its plain version, in place or into
    a fresh output; one launch, byte-equal. Returns the kernel's table."""
    from gubernator_tpu_torch.exp import sweeps

    if inplace:
        return _both_ways(card, "sweep_rows", sweeps.sweep_rows_ref, table, rows, mask, bkt, u)
    t = table.to(card)
    args = [x.to(card) for x in (rows, mask, bkt)]
    outs = [torch.full_like(t, 7) for _ in range(2)]
    before = sweeps.sweep_rows.launches
    sweeps.sweep_rows(t, *args, u, out=outs[0])
    sweeps.sweep_rows_ref(t, *args, u, out=outs[1])
    torch.cuda.synchronize()
    assert sweeps.sweep_rows.launches == before + 1
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(t.cpu(), table)
    return outs[0]


@pytest.mark.parametrize("u,inplace", [(64, False), (128, False), (64, True), (128, True)])
def test_sweep_rows_one_row_named_by_every_entry(card, u, inplace):
    """Every entry of a block names one row: a run of U entries, whose
    signed-byte sums carry past 8 bits; masks all +1 or in [-2, 2]."""
    rng = np.random.default_rng(100 + u + inplace)
    nb, n = 2 * 2048, 2 * u
    table = _i32(rng, (nb, 128))
    rows = _i32(rng, (n, 128))
    mask = rng.integers(-2, 3, (n, 128)).astype(np.int8)
    mask[:u] = 1
    bkt = np.concatenate([np.full(u, 17), np.full(u, 2047)]).astype(np.int32)
    got = _rows_both_ways(card, table, rows, torch.from_numpy(mask), torch.from_numpy(bkt),
                          u, inplace)
    assert not torch.equal(got.cpu()[17], table[17])


@pytest.mark.parametrize("inplace", [False, True])
def test_sweep_rows_u128_across_every_row(card, inplace):
    """U 128 (the window needs more than 48 KB of shared memory) with
    targets spread over every row and hot rows that collide."""
    rng = np.random.default_rng(128 + inplace)
    u, nb = 128, 8 * 2048
    n = nb // 2048 * u
    bkt = rng.integers(-1, 2049, n).astype(np.int32)
    bkt[rng.random(n) < 0.3] = rng.integers(0, 4)
    _rows_both_ways(card, _i32(rng, (nb, 128)), _i32(rng, (n, 128)),
                    torch.from_numpy(rng.integers(-2, 3, (n, 128)).astype(np.int8)),
                    torch.from_numpy(bkt), u, inplace)


@pytest.mark.parametrize("inplace", [False, True])
def test_sweep_rows_every_target_out_of_range(card, inplace):
    """No entry names a row of its block: in place nothing is written, out
    of place the output is an exact copy."""
    rng = np.random.default_rng(7 + inplace)
    u, nb = 64, 4 * 2048
    n = 4 * u
    bkt = np.where(rng.random(n) < 0.5, -1 - rng.integers(0, 5, n),
                   2048 + rng.integers(0, 5, n)).astype(np.int32)
    table = _i32(rng, (nb, 128))
    got = _rows_both_ways(card, table, _i32(rng, (n, 128)),
                          torch.from_numpy(np.full((n, 128), 2, np.int8)),
                          torch.from_numpy(bkt), u, inplace)
    assert torch.equal(got.cpu(), table)


@pytest.mark.parametrize("u", [64, 128, 256, 512])
@pytest.mark.parametrize("inplace", [False, True])
def test_sweep_rows_window_names_the_first_rows(card, u, inplace):
    """exp_mem2's layout: entry j of each window names row j, so the first
    rows of every block draw the whole window. Out of place the stream
    block that owns them stages all U entries beside a shorter ring, or
    from U 256 on reads them from global memory; in place the window is
    staged whole, or at U 512 read from global memory."""
    rng = np.random.default_rng(200 + u + inplace)
    nb = 4 * 2048
    n = 4 * u
    bkt = torch.arange(u, dtype=torch.int32).repeat(4)
    _rows_both_ways(card, _i32(rng, (nb, 128)), _i32(rng, (n, 128)),
                    torch.from_numpy(rng.integers(-2, 3, (n, 128)).astype(np.int8)), bkt, u,
                    inplace)


@pytest.mark.parametrize("nb,u", [(2048, 64), (1000, 16), (5, 2)])
@pytest.mark.parametrize("inplace", [False, True])
def test_sweep_rows_one_block_table(card, nb, u, inplace):
    """A table of one block: 2048 rows; 1000 rows (a ragged last stage of
    the stream); 5 rows."""
    rng = np.random.default_rng(nb + u + inplace)
    bkt = rng.integers(-1, nb + 1, u).astype(np.int32)
    bkt[: u // 2] = bkt[0]
    _rows_both_ways(card, _i32(rng, (nb, 128)), _i32(rng, (u, 128)),
                    torch.from_numpy(rng.integers(-2, 3, (u, 128)).astype(np.int8)),
                    torch.from_numpy(bkt), u, inplace)


def test_sweep4_write_on_card_matches_engine_write(card):
    """exp_sweep4's correctness check on the card: the windowed sweep,
    routed by the claim, equals the engine's slot_write."""
    from gubernator_tpu_torch.exp import exp_sweep4
    from gubernator_tpu_torch.exp._timing import generator

    res = exp_sweep4.check_small(generator(card, 11), card, 1 << 14, 1 << 10)
    assert res["equal"] and res["written"] > 0


# ----------------------------------------------------- the mesh exchange


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_ring_exchange_matches_plain_version(card, D, dtype):
    """D shards on one card: one launch, byte-equal to exchange_ref and to
    the all_to_all layout."""
    from gubernator_tpu_torch.parallel import ring

    gen = torch.Generator(device=card)
    gen.manual_seed(D)
    blocks = [torch.randint(-(2**31), 2**31 - 1, (D, 12, 256), dtype=dtype, device=card,
                            generator=gen) for _ in range(D)]
    before = ring.ring_exchange.launches
    got = ring.ring_exchange(blocks)
    want = ring.exchange_ref(blocks, [card] * D)
    coll = ring.exchange_collective(blocks, [card] * D)
    torch.cuda.synchronize()
    assert ring.ring_exchange.launches == before + 1
    for g, w, c in zip(got, want, coll):
        assert torch.equal(g, w) and torch.equal(g, c)


@pytest.mark.parametrize("D", [9, 16, 33])
def test_ring_exchange_wide_mesh_matches_plain_version(card, D):
    """Wider meshes (D 33 takes the wide parameter block): still one
    launch, byte-equal to exchange_ref and to the all_to_all layout."""
    from gubernator_tpu_torch.parallel import ring

    gen = torch.Generator(device=card)
    gen.manual_seed(D)
    blocks = [torch.randint(-(2**62), 2**62, (D, 12, 256), dtype=torch.int64, device=card,
                            generator=gen) for _ in range(D)]
    before = ring.ring_exchange.launches
    got = ring.ring_exchange(blocks)
    want = ring.exchange_ref(blocks, [card] * D)
    coll = ring.exchange_collective(blocks, [card] * D)
    torch.cuda.synchronize()
    assert ring.ring_exchange.launches == before + 1
    for g, w, c in zip(got, want, coll):
        assert torch.equal(g, w) and torch.equal(g, c)


def test_ring_exchange_rejects_what_it_cannot_take(card):
    from gubernator_tpu_torch.parallel import ring

    with pytest.raises(ValueError):
        ring.ring_exchange([torch.zeros((8, 4, 8), dtype=torch.int64, device=card)] * 9)
    base = torch.zeros((2, 8, 4), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ring.ring_exchange([base, base.transpose(1, 2)])  # not contiguous
    with pytest.raises(ValueError):
        ring.ring_exchange([torch.zeros((2, 3), dtype=torch.int8, device=card)] * 2)
    wide = ring.MAXD + 1  # above the widest parameter block
    with pytest.raises(ValueError):
        ring.ring_exchange([torch.zeros((wide, 2), dtype=torch.int64, device=card)] * wide)


@pytest.mark.parametrize("route,dedup,probe", [("device", "device", "pallas"),
                                               ("device", "host", "xla"),
                                               ("host", "device", "pallas")])
def test_mesh_card_matches_cpu(card, route, dedup, probe):
    """A 4-shard mesh on one card against the same mesh on the CPU:
    responses, stats and table bytes equal on contended mixed-algorithm
    batches (the card's exchange is the ring kernel)."""
    from gubernator_tpu_torch.parallel import ShardedEngine, make_mesh

    kw = dict(capacity_per_shard=1 << 12, route=route, dedup=dedup, probe=probe, a2a="ring",
              wire="full", write_mode="sparse")
    engines = [ShardedEngine(make_mesh(4, devices=[d] * 4), **kw) for d in (card, "cpu")]
    rng = np.random.default_rng(3)
    pool = rng.integers(1, 2**63 - 1, 600, dtype=np.int64)
    for step in range(3):
        n = 1024
        fp = rng.choice(pool, n)
        cols = RequestColumns(
            fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=np.where(rng.random(n) < 0.1, 8, 0).astype(np.int32),
            hits=rng.integers(0, 4, n).astype(np.int64),
            limit=rng.integers(1, 20, n).astype(np.int64), burst=np.zeros(n, np.int64),
            duration=np.full(n, 5_000, np.int64), created_at=np.zeros(n, np.int64),
            err=np.zeros(n, np.int8))
        a, b = (e.check_columns(cols, now_ms=NOW + 700 * step) for e in engines)
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (f, step)
        assert engines[0].snapshot().tobytes() == engines[1].snapshot().tobytes()
    assert dataclasses.asdict(engines[0].stats) == dataclasses.asdict(engines[1].stats)


@pytest.mark.parametrize("wire,sync_out,probe", [("compact", 512, "pallas"),
                                                  ("full", 512, "xla"),
                                                  ("compact", 32, "xla")])
def test_global_sync_card_matches_cpu(card, wire, sync_out, probe):
    """A GLOBAL 4-shard mesh on one card against the same mesh on the CPU:
    contended mixed-algorithm GLOBAL and plain rows from rotating homes,
    then sync() — one round (sync_out 512) or a drain of several (32):
    responses, EngineStats, GlobalStats and the primary and replica bytes
    equal. A round launches slot_write twice per shard (owner decide,
    replica install), and a drain runs exactly the rounds it needs."""
    from gubernator_tpu_torch.ops.slot_write import slot_write as sw
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine

    kw = dict(capacity_per_shard=1 << 12, sync_out=sync_out, route="device", dedup="device",
              a2a="ring", wire=wire, write_mode="sparse", probe=probe, walk="xla")
    engines = [GlobalShardedEngine(make_mesh(4, devices=[d] * 4), **kw) for d in (card, "cpu")]
    rng = np.random.default_rng(5)
    pool = rng.integers(1, 2**63 - 1, 700, dtype=np.int64)

    def same(what):
        a, b = engines
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats), what
        assert dataclasses.asdict(a.global_stats) == dataclasses.asdict(b.global_stats), what
        assert a.snapshot().tobytes() == b.snapshot().tobytes(), what
        reps = [np.stack([t.rows.cpu().numpy() for t in e.replica]) for e in engines]
        assert reps[0].tobytes() == reps[1].tobytes(), what

    for step in range(3):
        n = 512
        beh = (np.where(rng.random(n) < 0.7, 2, 0) | np.where(rng.random(n) < 0.1, 8, 0)
               | np.where(rng.random(n) < 0.2, 32, 0))  # GLOBAL, RESET, DRAIN
        cols = RequestColumns(
            fp=rng.choice(pool, n), algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=beh.astype(np.int32), hits=rng.integers(0, 5, n).astype(np.int64),
            limit=rng.integers(1, 20, n).astype(np.int64), burst=np.zeros(n, np.int64),
            duration=np.full(n, 60_000, np.int64), created_at=np.zeros(n, np.int64),
            err=np.zeros(n, np.int8))
        a, b = (e.check_columns(cols, now_ms=NOW + step) for e in engines)
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (f, step)
        same(f"check {step}")
    rounds = max((len(p) + sync_out - 1) // sync_out for p in engines[0].pending)
    before = sw.launches
    engines[0].sync(now_ms=NOW + 9)
    torch.cuda.synchronize()
    engines[1].sync(now_ms=NOW + 9)
    same("sync")
    assert sw.launches - before == 2 * 4 * rounds
    assert engines[0].global_stats.sync_rounds == rounds


def _cards(card, least: int = 2):
    n = torch.cuda.device_count()
    if n < least:
        pytest.skip(f"needs {least} or more cards, {n} present")
    return [torch.device("cuda", i) for i in range(min(n, 8))]


def test_ring_exchange_across_cards(card):
    """Shards on several cards: peer stores, one launch per card, also
    when each card holds two interleaved shards (shard s on card s % n),
    byte-equal to exchange_ref."""
    from gubernator_tpu_torch.parallel import ring

    cards = _cards(card)
    for devices in (cards, [cards[i % len(cards)] for i in range(min(2 * len(cards), 8))]):
        D = len(devices)
        blocks = [torch.randint(-(2**62), 2**62, (D, 12, 512), dtype=torch.int64, device=d)
                  for d in devices]
        before = ring.ring_exchange.launches
        got = ring.ring_exchange(blocks)
        want = ring.exchange_ref(blocks, devices)
        for d in cards:
            torch.cuda.synchronize(d)
        assert ring.ring_exchange.launches == before + len(set(devices))
        for g, w, dv in zip(got, want, devices):
            assert g.device == dv and torch.equal(g, w)


def test_mesh_across_cards_matches_cpu(card):
    """A mesh of one shard per card against the same mesh on the CPU:
    responses, stats and table bytes equal."""
    from gubernator_tpu_torch.parallel import ShardedEngine, make_mesh

    D = len(_cards(card))
    kw = dict(capacity_per_shard=1 << 12, route="device", dedup="device", probe="pallas",
              a2a="ring", wire="full", write_mode="sparse")
    engines = [ShardedEngine(make_mesh(D), **kw),
               ShardedEngine(make_mesh(D, devices=["cpu"] * D), **kw)]
    rng = np.random.default_rng(4)
    pool = rng.integers(1, 2**63 - 1, 600, dtype=np.int64)
    for step in range(3):
        n = 1024
        cols = RequestColumns(
            fp=rng.choice(pool, n), algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=np.zeros(n, np.int32), hits=rng.integers(0, 4, n).astype(np.int64),
            limit=rng.integers(1, 20, n).astype(np.int64), burst=np.zeros(n, np.int64),
            duration=np.full(n, 5_000, np.int64), created_at=np.zeros(n, np.int64),
            err=np.zeros(n, np.int8))
        a, b = (e.check_columns(cols, now_ms=NOW + 700 * step) for e in engines)
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (f, step)
        assert engines[0].snapshot().tobytes() == engines[1].snapshot().tobytes()
    assert dataclasses.asdict(engines[0].stats) == dataclasses.asdict(engines[1].stats)


# ---------------------------------------- the decide loop and maintenance


def _loop_batches(card, nb, n, b, seed, math="token"):
    """`n` request batches of `b` unique keys each on the card, keys repeated
    across batches, a quarter of them in 16 hot buckets, the last batch half
    padding; stacked (ops/loop.stack_batches)."""
    from gubernator_tpu_torch.ops.batch import ReqBatch
    from gubernator_tpu_torch.ops.loop import stack_batches

    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 1 << 62, 3 * b, dtype=np.int64))
    hot = rng.random(pool.shape[0]) < 0.25
    pool[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 16, hot.sum())
    pool = np.unique(pool)
    out = []
    for i in range(n):
        fp = rng.choice(pool, b, replace=False)
        act = np.ones(b, bool) if i < n - 1 else np.arange(b) < b // 2
        fp = np.where(act, fp, 0)
        algo = np.zeros(b, np.int32) if math == "token" else rng.integers(0, 5, b).astype(np.int32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
        out.append(ReqBatch(
            fp=t(fp), algo=t(algo), behavior=t(np.zeros(b, np.int32)),
            hits=t(rng.integers(0, 3, b).astype(np.int64)), limit=t(np.full(b, 5, np.int64)),
            burst=t(np.full(b, 5, np.int64)), duration=t(np.full(b, 60_000, np.int64)),
            created_at=t(np.full(b, NOW, np.int64)),
            expire_new=t(np.full(b, NOW + 60_000, np.int64)),
            greg_interval=t(np.zeros(b, np.int64)), duration_eff=t(np.full(b, 60_000, np.int64)),
            active=t(act)))
    return stack_batches(out)


def _eager_loop(table, stacked, k, **kw):
    """The loop's plain form on the card: k eager dispatches."""
    from gubernator_tpu_torch.ops import loop

    acc = torch.zeros(4, dtype=torch.int64, device=table.rows.device)
    n = stacked.fp.shape[0]
    for i in range(k):
        loop._step(table, loop._batch(stacked, i % n), acc, kw["write"], kw["math"], kw["probe"])
    return acc


@pytest.mark.parametrize("probe,write,math", [("pallas", "sparse", "token"),
                                              ("xla", "sparse", "token"),
                                              ("xla", "xla", "mixed")])
def test_decide_loop_graph_matches_eager(card, probe, write, math):
    """The graph loop against the eager loop on a clone of the table: equal
    bytes and totals over two calls (replays of one capture), the walk's
    scratch left zeroed, and a new capture after a resize."""
    from gubernator_tpu_torch import device as device_mod
    from gubernator_tpu_torch.ops.loop import LoopGraphs, decide_loop
    from gubernator_tpu_torch.ops.table2 import Table2, new_table2

    table = new_table2(1 << 16, device=card)
    nb = table.n_buckets
    stacked = _loop_batches(card, nb, 3, 2048, seed=1, math=math)
    graphs = LoopGraphs()
    twin = Table2(table.rows.clone(), table.layout)
    kw = dict(write=write, math=math, probe=probe)
    for k in (7, 4):
        _, acc = decide_loop(table, stacked, k, graphs=graphs, **kw)
        want = _eager_loop(twin, stacked, k, **kw)
        torch.cuda.synchronize()
        assert torch.equal(acc, want), (acc, want)
        assert torch.equal(table.rows, twin.rows)
        assert graphs.captures == 1
        assert int(acc[0] + acc[1]) == sum(int(stacked.active[i % 3].sum()) for i in range(k))
    for buf in device_mod.scratch_buffers():
        assert not buf.any()
    # a resize gives the table a new rows tensor: a new capture
    from gubernator_tpu_torch.ops.engine import LocalEngine

    eng = LocalEngine(capacity=1 << 16, device=card, probe=probe)
    eng.table = table
    eng.resize(1 << 17, now_ms=NOW)
    twin = Table2(eng.table.rows.clone(), eng.table.layout)
    stacked2 = _loop_batches(card, eng.table.n_buckets, 3, 2048, seed=2, math=math)
    _, acc = decide_loop(eng.table, stacked2, 5, graphs=graphs, **kw)
    want = _eager_loop(twin, stacked2, 5, **kw)
    torch.cuda.synchronize()
    assert graphs.captures == 2
    assert torch.equal(acc, want) and torch.equal(eng.table.rows, twin.rows)


def _maint_pair(card, layout, seed, capacity=1 << 16):
    """A card engine and a CPU engine after the same contended traffic of
    the layout's algorithm family, each with an epoch tracker."""
    from gubernator_tpu_torch.ops.checkpoint import EpochTracker

    algos = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}[layout]
    rng = np.random.default_rng(seed)
    engines = [LocalEngine(capacity=capacity, device=d, layout=layout) for d in (card, "cpu")]
    for e in engines:
        e.ckpt = EpochTracker(e.table.n_buckets)
    nb = engines[0].table.n_buckets
    pool = rng.integers(1, 2**63 - 1, 6_000, dtype=np.int64)
    now = NOW
    for _ in range(3):
        n = 2048
        fp = rng.choice(pool, n)
        hot = rng.random(n) < 0.2
        fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 8, hot.sum())
        cols = RequestColumns(
            fp=fp, algo=rng.choice(algos, n).astype(np.int32),
            behavior=np.where(rng.random(n) < 0.1, 8, 0).astype(np.int32),
            hits=rng.integers(0, 5, n).astype(np.int64),
            limit=rng.integers(1, 20, n).astype(np.int64), burst=np.zeros(n, np.int64),
            duration=rng.integers(1, 30, n).astype(np.int64) * 1_000,
            created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
        )
        a, b = (e.check_columns(cols, now_ms=now) for e in engines)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        now += int(rng.integers(1_000, 5_000))
    return engines, now, rng


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
def test_maintenance_card_matches_cpu(card, layout):
    from gubernator_tpu_torch.ops.telemetry import finish_scan

    (gpu, cpu), now, rng = _maint_pair(card, layout, seed=3)

    def both(fn, what):
        a, b = fn(gpu), fn(cpu)
        flat = lambda x: x if isinstance(x, tuple) else (x,)
        for x, y in zip(flat(a), flat(b)):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, what
                np.testing.assert_array_equal(x, y, err_msg=what)
            else:
                assert x == y, what
        assert gpu.snapshot().tobytes() == cpu.snapshot().tobytes(), what
        return a

    live, _ = both(lambda e: e.extract_live(now), "extract_live")
    assert live.shape[0] == gpu.live_count(now) > 0
    both(lambda e: e.extract_idle(now, 3_000, 500), "extract_idle")
    probe = np.concatenate([live[::7], rng.integers(1, 2**63 - 1, 50, dtype=np.int64)])
    both(lambda e: e.read_state(probe), "read_state")
    both(lambda e: e.read_state(probe, raw=True), "read_state raw")
    snap = both(lambda e: dataclasses.replace(finish_scan(e.telemetry_begin(now)), scan_ms=0.0),
                "telemetry")
    assert snap.live_keys == live.shape[0]

    def epoch(e):
        ep, gids = e.ckpt.take()
        return (ep, gids) + tuple(e.checkpoint_finish(e.checkpoint_begin(gids, now)))

    both(epoch, "checkpoint epoch")
    idle, _ = both(lambda e: e.extract_idle(now, 3_000), "extract_idle, all")
    assert both(lambda e: e.tombstone_fps(np.concatenate([idle, probe[-5:]])),
                "tombstone") == idle.shape[0]
    both(lambda e: e.resize(1 << 15, now), "resize down")
    both(lambda e: e.maybe_grow(threshold=0.2, now_ms=now), "maybe_grow")
    both(epoch, "epoch after resize")
    assert dataclasses.asdict(gpu.stats) == dataclasses.asdict(cpu.stats)

# ------------------------------------------------------- tiering and Store


def _tier_cols(fp, now, hits=3, limit=12):
    n = fp.shape[0]
    return RequestColumns(
        fp=fp, algo=np.zeros(n, np.int32), behavior=np.zeros(n, np.int32),
        hits=np.full(n, hits, np.int64), limit=np.full(n, limit, np.int64),
        burst=np.zeros(n, np.int64), duration=np.full(n, 86_400_000, np.int64),
        created_at=np.full(n, now, np.int64), err=np.zeros(n, np.int8))


def _shadow_contents(eng):
    sh = eng.shadow
    fps = np.fromiter(sh._rows.keys(), np.int64, len(sh._rows))
    rows = np.stack(list(sh._rows.values())) if len(sh._rows) else np.zeros((0, 16), np.int32)
    return fps.tobytes(), rows.tobytes(), sh.stats()


@pytest.mark.parametrize("probe,walk", [("xla", "xla"), ("pallas", "pallas"),
                                        ("xla", "pallas")])
def test_tiering_card_matches_cpu(card, probe, walk):
    """A shadow-armed engine on the card (compact wire: the evictee sidecar
    rides the int32 egress) against one on the CPU (full width) over 4x
    tracked keys, then an idle demote and its fault-back: responses,
    stats, table bytes, the shadow's fps and rows in order and its stats;
    the decide walk's kernel ran on every decide dispatch."""
    from gubernator_tpu_torch.ops.probe_walk import probe_walk
    from gubernator_tpu_torch.tier import ROW_BYTES, ShadowTable

    rng = np.random.default_rng(7)
    gpu = LocalEngine(capacity=1 << 10, device=card, probe=probe, walk=walk, wire="compact")
    cpu = LocalEngine(capacity=1 << 10, device="cpu", probe=probe, walk=walk, wire="full")
    keys = np.unique(rng.integers(1, 1 << 62, 4 << 10, dtype=np.int64))
    for e in (gpu, cpu):
        e.attach_shadow(ShadowTable(max_bytes=keys.shape[0] * ROW_BYTES))
    kernel = slot_write if probe == "xla" else probe_walk
    launches = kernel.launches
    now = NOW
    order = np.concatenate([keys, rng.permutation(keys)[:2048]])
    for i in range(0, order.shape[0], 512):
        cols = _tier_cols(order[i:i + 512], now)
        a, b = gpu.check_columns(cols, now_ms=now), cpu.check_columns(cols, now_ms=now)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert gpu.snapshot().tobytes() == cpu.snapshot().tobytes()
        now += 7
    assert _shadow_contents(gpu) == _shadow_contents(cpu)
    assert gpu.shadow.stats()["demoted_evict"] > 0 and gpu.shadow.stats()["promoted"] > 0
    if probe == walk:  # every dispatch, promote merges included, ran the kernel
        assert kernel.launches - launches == gpu.stats.dispatches
    now += 5_000
    for e in (gpu, cpu):
        fps, slots = e.extract_idle(now, 1_000, max_rows=256)
        e.tombstone_fps(fps)
        e.shadow.offer(fps, e.table.layout.unpack(slots), now, reason="idle")
    back = _tier_cols(fps[:128], now + 1, hits=1)
    a, b = gpu.check_columns(back, now_ms=now + 1), cpu.check_columns(back, now_ms=now + 1)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert gpu.snapshot().tobytes() == cpu.snapshot().tobytes()
    assert _shadow_contents(gpu) == _shadow_contents(cpu)
    assert dataclasses.asdict(gpu.stats) == dataclasses.asdict(cpu.stats)


def test_store_card_matches_cpu(card):
    """A DictStore engine on the card against one on the CPU: contended
    traffic, a restart onto a fresh table with the same store (every miss
    rehydrates), then a restore of an empty table: responses, stats, table
    bytes, every ChangeSet field by field and the stores' rows."""
    from gubernator_tpu_torch.store import DictStore

    class Logged(DictStore):
        def __init__(self):
            super().__init__()
            self.log = []

        def on_change(self, change):
            self.log.append(change)
            super().on_change(change)

    rng = np.random.default_rng(11)
    stores = [Logged(), Logged()]
    make = lambda d, s: LocalEngine(capacity=1 << 12, device=d, probe="pallas", walk="pallas",
                                    wire="full", store=s)
    engines = [make(card, stores[0]), make("cpu", stores[1])]
    pool = rng.integers(1, 2**63 - 1, 3_000, dtype=np.int64)
    now = NOW
    for step in range(5):
        if step == 2:  # restart: fresh tables, the same stores
            engines = [make(card, stores[0]), make("cpu", stores[1])]
        if step == 4:
            for e in engines:
                e.restore(np.zeros_like(e.snapshot()))
        n = 1024
        fp = rng.choice(pool, n)
        cols = RequestColumns(
            fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=np.where(rng.random(n) < 0.1, 8, 0).astype(np.int32),
            hits=rng.integers(0, 5, n).astype(np.int64),
            limit=rng.integers(1, 20, n).astype(np.int64),
            burst=np.zeros(n, np.int64), duration=rng.integers(1, 6, n).astype(np.int64) * 60_000,
            created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
        a, b = (e.check_columns(cols, now_ms=now) for e in engines)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert engines[0].snapshot().tobytes() == engines[1].snapshot().tobytes()
        assert dataclasses.asdict(engines[0].stats) == dataclasses.asdict(engines[1].stats)
        now += 1_000
    assert len(stores[0].log) == len(stores[1].log) == 5
    for x, y in zip(stores[0].log, stores[1].log):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v, err_msg=f.name)
            else:
                assert u == v, f.name
    assert stores[0].rows == stores[1].rows
    assert stores[0].hydrated == stores[1].hydrated > 0


def test_decide_loop_raises_when_the_capture_fails(card, monkeypatch):
    """A dispatch that syncs with the host cannot be captured: decide_loop
    raises and never runs the eager loop on the card instead. (Last in the
    file: a failed capture is left to the CUDA runtime to discard.)"""
    from gubernator_tpu_torch.ops import loop
    from gubernator_tpu_torch.ops.table2 import new_table2

    table = new_table2(1 << 14, device=card)
    stacked = _loop_batches(card, table.n_buckets, 2, 256, seed=3)
    before = table.rows.clone()
    real = loop.decide2_impl

    def syncing(table, req, **kw):
        int(req.fp.sum())  # a host read: not permitted while capturing
        return real(table, req, **kw)

    monkeypatch.setattr(loop, "decide2_impl", syncing)
    with pytest.raises(RuntimeError):
        loop.decide_loop(table, stacked, 3, write="xla", math="token", probe="xla",
                         graphs=loop.LoopGraphs())
    torch.cuda.synchronize()
    assert torch.equal(table.rows, before)  # nothing ran in place of the graphs


@pytest.mark.parametrize("probe", ["xla", "pallas"])
def test_serving_pipeline_bytes_match_cpu(card, probe):
    """The daemon's serving path on the card against the CPU (chip_smoke.py
    phase service at a small size): hand-encoded GetRateLimitsReq bytes
    through ``Daemon.get_rate_limits_raw`` (native parser → Batcher →
    EngineRunner → engine → encoder), one request at a time under a frozen
    clock, on the card (compact wire, the fused front door) and on the CPU
    (full width, the columns path): the response bytes are equal."""
    import chip_smoke as cs
    from gubernator_tpu_torch import native

    if native.load() is None:
        pytest.fail("the native parser did not build (g++ and Python.h are needed)")
    now = NOW + 30_000
    reqs = cs._service_parity_requests(np.random.default_rng(5), 48, now)
    outs = {str(dev): cs.serve_one_by_one(
        LocalEngine(capacity=1 << 14, device=dev, probe=probe), reqs, now)
        for dev in (card, "cpu")}
    assert outs["cuda"] == outs["cpu"]


def test_ring_armed_daemon_bytes_match_cpu(card):
    """The request ring from the front door: a daemon with
    GUBER_RING_ENABLE (issue auto, which is "fused" on the card) answers
    hand-encoded GetRateLimitsReq bytes one at a time as a ring-armed daemon
    on the CPU (the host tier) does, byte for byte; on the card its all-wire
    flushes were claimed by ``fence_claim``."""
    import chip_smoke as cs
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.ops.ring_drain import fence_claim

    if native.load() is None:
        pytest.fail("the native parser did not build (g++ and Python.h are needed)")
    now = NOW + 30_000
    reqs = cs._service_parity_requests(np.random.default_rng(7), 48, now)
    beh = {"ring_enable": True, "ring_issue": "auto", "ring_slot_width": 1024}
    before = fence_claim.launches
    info = {}
    card_out = cs.serve_one_by_one(LocalEngine(capacity=1 << 14, device=card), reqs, now,
                                   behaviors=beh, info=info)
    assert info["ring"]["issue_mode"] == "fused" and info["ring"]["drain_launches"] > 0
    assert fence_claim.launches > before
    cpu_out = cs.serve_one_by_one(LocalEngine(capacity=1 << 14, device="cpu"), reqs, now,
                                  behaviors=beh)
    assert card_out == cpu_out


def test_lease_sequence_card_matches_cpu(card):
    """Edge quota leases through the daemon on the card against the CPU
    (chip_smoke.py phase leases_parity at a small size): the scripted
    LeaseQuota / GetRateLimits sequence over gRPC, frozen clock, one seeded
    uuid4, for probe xla and pallas: every response, debug_leases(), the
    GLOBAL and region queues and the table bytes equal (the phase raises
    SystemExit otherwise)."""
    import chip_smoke as cs

    out = cs.phase_leases_parity(0, "test", device=str(card), capacity=1 << 12)
    assert all(out[p][k] for p in ("xla", "pallas") for k in ("responses", "lease_state",
                                                              "table"))


def test_mesh_daemon_serves_two_card_shards_over_grpc(card):
    """A port Daemon over a 2-shard mesh of one card (the card's defaults:
    device route and dedup, the ring exchange) answers 64 keys twice over
    gRPC with the right remainders, and its routed dispatches launch
    ring_exchange (the twin of the first case of
    tests/test_torch_sharded_daemon.py)."""
    import asyncio

    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine
    from gubernator_tpu_torch.parallel.ring import ring_exchange
    from gubernator_tpu_torch.service.daemon import Daemon
    from gubernator_tpu_torch.types import RateLimitRequest

    from tests.torch_cluster import port_config

    async def run():
        eng = GlobalShardedEngine(make_mesh(devices=[f"cuda:{card.index or 0}"] * 2),
                                  capacity_per_shard=1 << 12)
        assert (eng.n_shards, eng.route, eng.dedup, eng.a2a_impl) == (2, "device", "device",
                                                                      "ring")
        d = await Daemon.spawn(port_config(engine="sharded"), engine=eng)
        client = V1Client(d.conf.grpc_address)
        before = ring_exchange.launches
        try:
            keys = [f"k{i}" for i in range(64)]
            for hits, want in ((2, 98), (1, 97)):
                r = await client.get_rate_limits([RateLimitRequest(
                    name="sh", unique_key=k, hits=hits, limit=100, duration=60_000)
                    for k in keys])
                assert [(x.error, x.remaining) for x in r.responses] == [("", want)] * 64
            assert ring_exchange.launches > before
            assert eng.live_count() >= 64
        finally:
            await client.close()
            await d.close()

    asyncio.run(run())

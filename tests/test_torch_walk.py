"""Port parity: the peer plane's table walks — ``install2_impl`` (GLOBAL
UpdatePeerGlobals) and ``merge2_impl`` (handoff / region-sync
TransferState), with ``probe="xla"`` (gather + slot_write) and
``probe="pallas"`` (the fused probe walk, ops/probe_walk.py) — and the
engine surface above them (``LocalEngine(probe=, walk=)``: check_columns,
install_columns, merge_rows with ``collect=True``), against the JAX
package.

The JAX package runs its walks jitted, with its Pallas kernels in
interpret mode at the CPU default of one block; the port runs each
kernel's plain version. Both start from the same table bytes (one numpy
snapshot for the engines). Inputs come from numpy with fixed seeds; the
claim is pushed by concentrating keys into a few buckets of a 16-bucket
table (128-row batches, shared across cases so each JAX program compiles
once). Tolerance: exact — masks, evictee rows, responses, EngineStats and
raw table bytes after every step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops import layout as jlayout
from gubernator_tpu.ops.batch import InstallBatch as JInst
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.ops.table2 import Table2 as JTable
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops import layout as tlayout
from gubernator_tpu_torch.ops.batch import InstallBatch as TInst
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine
from gubernator_tpu_torch.ops.table2 import table_from_numpy, table_to_numpy

torch.set_num_threads(1)

NOW = 1_700_000_000_000
N = 128
NB = 16


def mkfp(rng, n, bucket_pool=4, pool_nb=NB):
    """n unique fingerprints concentrated into `bucket_pool` buckets."""
    base = rng.integers(1, pool_nb, size=bucket_pool, dtype=np.int64)
    fp = base[rng.integers(0, bucket_pool, size=2 * n)] + pool_nb * \
        rng.integers(1, 1 << 40, size=2 * n, dtype=np.int64)
    fp = np.unique(fp)[:n]
    rng.shuffle(fp)
    return fp


def mkinst(rng, fp, algos, now=NOW, fidelity=False, n_active=None):
    """Install columns (numpy) for owner broadcasts of `fp`."""
    n = fp.shape[0]
    algo = np.array([algos[i % len(algos)] for i in range(n)], dtype=np.int32)
    remaining = rng.integers(0, 101, size=n).astype(np.int64)
    dur = rng.integers(1, 60, size=n).astype(np.int64) * 1_000
    return dict(
        fp=fp, algo=algo, status=(rng.integers(0, 4, size=n) == 0).astype(np.int32),
        limit=np.full(n, 100, np.int64), remaining=remaining,
        reset_time=now + dur, duration=dur, now=np.full(n, now, np.int64),
        active=np.arange(n) < (n if n_active is None else n_active),
        burst=rng.integers(50, 150, size=n).astype(np.int64),
        stamp=now - rng.integers(0, 5_000, size=n).astype(np.int64),
        aux=rng.integers(0, 100, size=n).astype(np.int64) if fidelity else None,
        rem_store=remaining.copy() if fidelity else None,
    )


def _jinst(d):
    return JInst(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})


def _tinst(d):
    return TInst(**{k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in d.items()})


class Pair:
    """One table in both packages, advanced walk by walk."""

    def __init__(self, layout="full", rows=None):
        jl, tl = jlayout.LAYOUTS[layout], tlayout.LAYOUTS[layout]
        rows = np.zeros((NB, tl.row), np.int32) if rows is None else rows
        self.jt = JTable(rows=jnp.asarray(rows), layout=jl)
        self.tt = table_from_numpy(rows, layout=tl, device="cpu")

    def same_bytes(self, what):
        assert table_to_numpy(self.tt).tobytes() == np.asarray(self.jt.rows).tobytes(), what

    def install(self, d, probe):
        self.jt, jm = jk.install2(self.jt, _jinst(d), write="xla", probe=probe)
        self.tt, tm = tk.install2_impl(self.tt, _tinst(d), write="xla", probe=probe)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        self.same_bytes("install")
        return int(tm.sum())

    def merge(self, fp, slots, now, active, probe, evictees=False):
        n = fp.shape[0]
        jo = jk.merge2(self.jt, jnp.asarray(fp), jnp.asarray(slots),
                       jnp.full(n, now, jnp.int64), jnp.asarray(active),
                       write="xla", evictees=evictees, probe=probe)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        to = tk.merge2_impl(self.tt, t(fp), t(slots), t(np.full(n, now, np.int64)),
                            t(active), write="xla", evictees=evictees, probe=probe)
        self.jt = jo[0]
        for a, b in zip(to[1:], jo[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        self.same_bytes("merge")
        return to


@pytest.mark.parametrize("probe", ["xla", "pallas"])
@pytest.mark.parametrize("lay,algos", [
    ("full", (0, 1, 2, 3, 4)), ("gcra32", (2,)), ("token32", (0,)),
])
def test_install_parity(lay, algos, probe):
    """Owner broadcasts into contended buckets over three steps: fresh
    installs, owners overwriting their lane, rank-overflow drops and
    evictions of live lanes by later keys."""
    rng = np.random.default_rng(21)
    pair = Pair(lay)
    keys = mkfp(rng, 2 * N)
    installed = 0
    for step in range(3):
        fp = keys[rng.permutation(2 * N)[:N]]
        d = mkinst(rng, fp, algos, now=NOW + step * 2_000, fidelity=lay == "full",
                   n_active=N - 8)
        installed += pair.install(d, probe)
    assert 0 < installed < 3 * (N - 8)  # some installs were dropped


def _incoming(rng, fp, now, algos=(0, 1, 2, 3, 4)):
    """Canonical slot rows a peer would transfer for `fp`: install payloads
    of random owner state, some already expired at `now`."""
    d = mkinst(rng, fp, algos, now=now - 1_000)
    d["reset_time"] = now + rng.integers(-3_000, 60_000, fp.shape[0])
    rows = tk.install_payload16(_tinst(d)).numpy()
    return rows


@pytest.mark.parametrize("probe,evictees", [
    ("xla", False), ("xla", True), ("pallas", False), ("pallas", True),
])
def test_merge_parity(probe, evictees):
    """Transfers into a table that already holds half the keys: min
    remaining, max expiry, OVER sticks, newest config; absent keys install,
    expired incoming rows are dropped, full buckets evict."""
    rng = np.random.default_rng(5)
    pair = Pair("full")
    keys = mkfp(rng, 2 * N)
    pair.install(mkinst(rng, keys[:N], (0, 1, 2, 3, 4), fidelity=True), probe)
    evicted = 0
    for step in range(2):
        fp = keys[rng.permutation(2 * N)[:N]]
        now = NOW + 1_000 + step * 1_000
        active = rng.random(N) < 0.95
        out = pair.merge(fp, _incoming(rng, fp, now), now, active, probe, evictees)
        if evictees:
            evicted += int((out[2][:, :2] != 0).any(axis=1).sum())
    assert not evictees or evicted > 0


def test_merge_parity_packed_receiver():
    """A token32 table merging full-width token rows through both walks."""
    rng = np.random.default_rng(6)
    for probe in ("xla", "pallas"):
        pair = Pair("token32")
        keys = mkfp(rng, N)
        pair.install(mkinst(rng, keys, (0,), n_active=N // 2), probe)
        pair.merge(keys, _incoming(rng, keys, NOW + 500, algos=(0,)), NOW + 500,
                   np.ones(N, bool), probe)


@pytest.mark.parametrize("stage", ["install", "merge"])
def test_walk_bucket0_padding_parity(stage):
    """The fused install / merge walks over a batch padded as the engine
    pads it — 108 inactive rows of fp 0, all in bucket 0 — beside two
    active keys of bucket 0, so bucket 0's writer has four reader units
    that must read its pre-dispatch bytes: masks, evictee rows and table
    bytes as JAX's."""
    rng = np.random.default_rng(33)
    pair = Pair("full")
    fp = mkfp(rng, N)
    fp[20:] = 0
    fp[:2] = NB * np.array([12345, 12346])
    active = np.arange(N) < 20
    installed = pair.install(mkinst(rng, fp, (0, 1, 2, 3, 4), fidelity=True, n_active=20),
                             "pallas")
    assert installed > 2
    if stage == "install":
        d = mkinst(rng, fp, (0, 2, 3), now=NOW + 1_000, fidelity=True, n_active=20)
        assert pair.install(d, "pallas") > 2
    else:
        fp[1] = NB * 12347  # one held key of bucket 0, one new
        out = pair.merge(fp, _incoming(rng, fp, NOW + 1_000), NOW + 1_000, active,
                         "pallas", evictees=True)
        assert out[1][:2].any()


# ------------------------------------------------------------ engine layer


def _cols(rng, n, keys, now):
    fp = rng.choice(keys, n, replace=False)
    return dict(
        fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
        behavior=np.where(rng.random(n) < 0.1, 8, 0).astype(np.int32),
        hits=rng.integers(-1, 4, n).astype(np.int64),
        limit=rng.integers(0, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
        duration=rng.integers(1, 4, n).astype(np.int64) * 1_000,
        created_at=np.full(n, now, np.int64), err=np.zeros(n, np.int8),
    )


def _assert_engines_equal(j, t):
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()


@pytest.mark.parametrize("probe,walk", [("pallas", "pallas"), ("xla", "xla")])
def test_engine_walks_from_one_snapshot(probe, walk):
    """Both engines restored from one numpy snapshot, then: serving checks
    (the decide walk), GLOBAL installs, transfers (with a duplicate key, so
    merge_rows splits passes) and a tiering promote (collect=True)."""
    rng = np.random.default_rng(31)
    keys = mkfp(rng, 3 * N)
    seed = Pair("full")
    seed.install(mkinst(rng, keys[:N], (0, 1, 2, 3, 4), fidelity=True), "xla")
    snap = np.array(seed.jt.rows)
    j = JaxEngine(capacity=NB * 8, write_mode="xla", wire="full", layout="full",
                  probe=probe, walk=walk)
    t = TorchEngine(capacity=NB * 8, write_mode="xla", layout="full", device="cpu",
                    probe=probe, walk=walk)
    j.restore(snap)
    t.restore(snap)
    _assert_engines_equal(j, t)

    now = NOW + 1_000
    c = _cols(rng, 100, keys, now)
    a = j.check_columns(JCols(**c), now_ms=now)
    b = t.check_columns(TCols(**c), now_ms=now)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    _assert_engines_equal(j, t)

    d = mkinst(rng, keys[N:N + 100], (0, 2, 3), now=now)
    args = [d[k] for k in ("fp", "algo", "status", "limit", "remaining",
                           "reset_time", "duration")]
    assert t.install_columns(*args, now_ms=now) == j.install_columns(*args, now_ms=now)
    _assert_engines_equal(j, t)

    fp = keys[2 * N:2 * N + 100].copy()
    fp[7] = fp[3]  # a crossed transfer: one key twice
    slots = _incoming(rng, fp, now)
    assert t.merge_rows(fp, slots, now_ms=now) == j.merge_rows(fp, slots, now_ms=now)
    _assert_engines_equal(j, t)

    fp = keys[rng.permutation(3 * N)[:100]]
    slots = _incoming(rng, fp, now + 1)
    jr = j.merge_rows(fp, slots, now_ms=now + 1, collect=True)
    tr = t.merge_rows(fp, slots, now_ms=now + 1, collect=True)
    assert tr[0] == jr[0]
    for x, y in zip(tr[1:], jr[1:]):
        np.testing.assert_array_equal(x, y)
    _assert_engines_equal(j, t)


def test_engine_merge_packed_sender_rows():
    """merge_rows infers an 8-field row as the table's own packed layout and
    converts it through the canonical row, as the JAX engine does."""
    rng = np.random.default_rng(32)
    j = JaxEngine(capacity=NB * 8, write_mode="xla", wire="full", layout="token32",
                  walk="pallas")
    t = TorchEngine(capacity=NB * 8, write_mode="xla", layout="token32",
                    device="cpu", walk="pallas")
    fp = mkfp(rng, 100)
    full = _incoming(rng, fp, NOW, algos=(0,))
    packed = tlayout.TOKEN32.pack(torch.from_numpy(full)).numpy()
    assert t.merge_rows(fp, packed, now_ms=NOW) == j.merge_rows(fp, packed, now_ms=NOW)
    _assert_engines_equal(j, t)
    assert t.merge_rows(fp[:0], packed[:0]) == 0
    assert t.merge_rows(fp[:0], packed[:0], collect=True)[0] == 0

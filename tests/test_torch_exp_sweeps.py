"""Port parity: the sweep kernels of gubernator_tpu_torch.exp (their plain
versions, which the wrappers run on CPU tensors) against the Pallas kernels
of the TPU measurement scripts in exp/, run in Pallas interpret mode.

The scripts are imported by path and left as they are; their module
globals are shrunk for the test (exp_sweep2's NB, BLK, U, NBLK;
exp_mem2's NB, B and buckets), and exp_mem2's kernels, closures inside its
main(), are captured from its `timed` calls. Inputs are made from numpy
seeds and handed to both sides. Cases: colliding targets (planes 8 and
16, which differ there), signed bytes and negative masks, a block whose run
overflows its two windows, the marker and skip2 flags, and exp_sweep4's
claim-routed write on a multi-block table with the port's own Claim2.
Tolerance: exact (table bytes).
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu_torch.exp import exp_sweep4 as t_sweep4
from gubernator_tpu_torch.exp import exp_sweep5 as t_sweep5
from gubernator_tpu_torch.exp import sweeps
from gubernator_tpu_torch.ops import kernel2 as tk
from gubernator_tpu_torch.ops.table2 import K, Table2

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000_000


def _script(name: str, monkeypatch):
    """A fresh module object of exp/<name>.py (its globals are the test's
    to shrink). Some scripts put an absolute path first on sys.path when
    imported; the test restores sys.path afterwards."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"_exp_{name}_under_test",
                                                  REPO / "exp" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the scripts runs in interpret mode."""
    orig = pallas.pallas_call
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(orig, interpret=True))


def _i32(rng, shape, low=-(2**31), high=2**31):
    return rng.integers(low, high, size=shape, dtype=np.int64).astype(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- exp_sweep2


def test_sweep2_variants_with_collisions(interpret, monkeypatch):
    """k_copy == sweep_copy in place; k_cur == k_i8acc == sweep_slots
    planes=8 and k_f32x2 == planes=16, under colliding (lb, slot) targets,
    where planes 16 and 8 differ."""
    m = _script("exp_sweep2", monkeypatch)
    nb, blk, u = 256, 64, 32
    for name, v in (("NB", nb), ("BLK", blk), ("U", u), ("NBLK", nb // blk)):
        monkeypatch.setattr(m, name, v)
    rng = np.random.default_rng(3)
    rows = _i32(rng, (nb, 128))
    wnew = _i32(rng, (nb // blk * u, 16))
    wslot = rng.integers(0, K, (nb // blk * u, 1)).astype(np.int32)
    lb = np.full((nb // blk, u), -1, dtype=np.int32)
    lb[:, : u // 2] = rng.integers(0, 6, (nb // blk, u // 2))  # dense: collisions
    lb[:, u // 2: u // 2 + 4] = rng.integers(0, blk, (nb // blk, 4))
    wslot[rng.random(wslot.shape) < 0.05] = 9  # a slot no lane has
    wlb = lb.reshape(-1, 1)
    args = [jnp.asarray(a) for a in (wnew, wslot, wlb, rows)]
    want = {name: np.asarray(m.build(getattr(m, f"k_{name}"))(*args))
            for name in ("copy", "cur", "i8acc", "f32x2")}

    inplace = _t(rows.copy())
    np.testing.assert_array_equal(sweeps.sweep_copy(inplace, inplace).numpy(), want["copy"])
    got8 = sweeps.sweep_slots(_t(rows.copy()), _t(wnew), _t(wslot), _t(wlb), u, 8).numpy()
    got16 = sweeps.sweep_slots(_t(rows.copy()), _t(wnew), _t(wslot), _t(wlb), u, 16).numpy()
    np.testing.assert_array_equal(got8, want["cur"])
    np.testing.assert_array_equal(got8, want["i8acc"])
    np.testing.assert_array_equal(got16, want["f32x2"])
    assert (got16 != got8).any()
    assert (got8 != rows).any()


def test_sweep2_sorted_windows_compose_alike():
    """sort_windows orders each window's entries by target slot, the ones
    that name nothing last, and sweep_slots composes the sorted windows
    into the same table as the drawn ones."""
    from gubernator_tpu_torch.exp import exp_sweep2

    nb, blk, u = 256, 64, 32
    gen = torch.Generator().manual_seed(5)
    rows, wnew, wslot, wlb = exp_sweep2.make_data(gen, torch.device("cpu"), nb, blk, u)
    wslot[::7] = 9  # a slot no lane has: names nothing
    s_new, s_slot, s_lb = exp_sweep2.sort_windows(wnew, wslot, wlb, u, blk)
    live = (s_lb >= 0) & (s_lb < blk) & (s_slot < K)
    key = torch.where(live, s_lb * K + s_slot, blk * K).view(-1, u)
    assert (key[:, 1:] >= key[:, :-1]).all()
    for planes in (8, 16):
        want = sweeps.sweep_slots(rows.clone(), wnew, wslot, wlb, u, planes)
        assert torch.equal(sweeps.sweep_slots(rows.clone(), s_new, s_slot, s_lb, u, planes),
                           want)


# --------------------------------------------------------------- exp_mem2


class _Stop(Exception):
    pass


@pytest.fixture
def mem2_kernels(interpret, monkeypatch):
    """exp_mem2's jitted P1, P2, P3 at NB=4096 (two 2048-row blocks)."""
    m = _script("exp_mem2", monkeypatch)
    nb, b = 4096, 256
    monkeypatch.setattr(m, "NB", nb)
    monkeypatch.setattr(m, "B", b)
    monkeypatch.setattr(m, "buckets_np", np.random.default_rng(0).integers(0, nb, b))
    got = {}

    def record(name, fn, *args, **kw):
        got[name[:2]] = fn
        if name.startswith("P3"):
            raise _Stop

    monkeypatch.setattr(m, "timed", record)
    with pytest.raises(_Stop):
        m.main()
    return nb, got


def test_mem2_copy_and_scatter_signed_bytes(mem2_kernels):
    """P1 == sweep_copy out of place; P2 (U=64) and P3 (U=128) ==
    sweep_rows out of place, on random rows (signed bytes), masks in
    [-2, 2] and targets in [-1, 2048) with hot rows that collide; P4 (P2's
    body, the table donated) == sweep_rows in place, held against P2."""
    nb, p = mem2_kernels
    rng = np.random.default_rng(7)
    table = _i32(rng, (nb, 128))
    np.testing.assert_array_equal(
        sweeps.sweep_copy(_t(table), torch.empty((nb, 128), dtype=torch.int32)).numpy(),
        np.asarray(p["P1"](jnp.asarray(table))))
    for u, fn in ((64, p["P2"]), (128, p["P3"])):
        n = nb // 2048 * u
        rows = _i32(rng, (n, 128))
        mask = rng.integers(-2, 3, (n, 128)).astype(np.int8)
        bkt = rng.integers(-1, 2048, n).astype(np.int32)
        hot = rng.random(n) < 0.5
        bkt[hot] = rng.integers(-1, 8, int(hot.sum()))
        with jax.enable_x64(False):
            want = np.asarray(fn(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(mask),
                                 jnp.asarray(bkt)))
        out = torch.empty((nb, 128), dtype=torch.int32)
        got = sweeps.sweep_rows(_t(table), _t(rows), _t(mask), _t(bkt), u, out=out)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want != table).any() and ((rows >> 24) < 0).any()
        if u == 64:
            inplace = sweeps.sweep_rows(_t(table.copy()), _t(rows), _t(mask), _t(bkt), u)
            np.testing.assert_array_equal(inplace.numpy(), want)


# ------------------------------------------------------------- exp_sweep5


def _window_case(rng, nb, B, dup_block, marker, shuffled=False):
    """Sorted targets: one block's run longer than two windows, a few
    repeated targets, a sentinel tail; random payloads whose field 15
    mixes 1, 0, negative and high-byte values under `marker`. `shuffled`
    permutes the targets, so a block's entries lie in any window and the
    skip2 gate (need2) decides what its second half sees."""
    kblk = 64
    tgt = np.sort(rng.choice(nb * K, size=B - 24, replace=False))
    crowd = dup_block * kblk + np.sort(rng.choice(kblk, 20, replace=False))
    tgt = np.sort(np.concatenate([tgt, crowd, tgt[:2]]))[: B - 2]
    tgt = np.concatenate([tgt, [nb * K, nb * K]]).astype(np.int32)
    pay = _i32(rng, (B, 16))
    if marker:
        pay[:, 15] = rng.choice(np.array([1, 1, 1, 0, -1, 0x80, 0x100, -(2**31)]), B)
    if shuffled:
        tgt = rng.permutation(tgt)
    return tgt[:, None], pay


@pytest.mark.parametrize("marker,skip2,shuffled", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, False),
    (False, True, True), (True, False, True)])
def test_sweep5_flags_overflow_and_repeats(interpret, monkeypatch, marker, skip2, shuffled):
    """exp_sweep5.sweep_call == the port's sweep_call (sweeps.sweep_window),
    blk 8 (64 slots a block), u 8, 8 windows; block 3's run overflows."""
    m = _script("exp_sweep5", monkeypatch)
    rng = np.random.default_rng(5 + 2 * marker + skip2 + 4 * shuffled)
    nb, B, blk, u = 64, 64, 8, 8
    tgt, pay = _window_case(rng, nb, B, dup_block=3, marker=marker, shuffled=shuffled)
    table = _i32(rng, (nb, 128))
    want = np.asarray(jax.jit(functools.partial(
        m.sweep_call, blk=blk, u=u, marker=marker, skip2=skip2))(
        jnp.asarray(table), jnp.asarray(pay), jnp.asarray(tgt)))
    got = t_sweep5.sweep_call(_t(table.copy()), _t(pay), _t(tgt), blk, u, marker, skip2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != table).any()
    if shuffled:
        return
    # the crowded block's run is longer than its two windows: some of its
    # targets keep their old bytes
    in3 = tgt[:, 0][(tgt[:, 0] >= 3 * 64) & (tgt[:, 0] < 4 * 64)]
    kept = [(table.reshape(-1, 16)[t] == want.reshape(-1, 16)[t]).all() for t in in3]
    assert len(in3) > 2 * u and any(kept)


# ------------------------------------------------------------- exp_sweep4


def test_sweep4_claim_routed_write(interpret, monkeypatch):
    """exp_sweep4.make_sweep2 on an 8-block table, routed by JAX's claim,
    == the port's make_sweep2 routed by the port's Claim2 == the port's
    engine write (_write_claim) == JAX's _write_xla; repeated
    fingerprints and an overflowing hot block included."""
    m = _script("exp_sweep4", monkeypatch)
    rng = np.random.default_rng(11)
    nb, B, blk, u = 512, 128, 64, 16
    rows = np.zeros((nb, 128), dtype=np.int32)
    fps = rng.integers(1, 2**62, B, dtype=np.int64)
    fps[:10] = fps[0]
    hot = rng.random(B) < 0.3
    fps[hot] = (fps[hot] // nb) * nb + rng.integers(0, 8, int(hot.sum()))  # block 0
    new16 = _i32(rng, (B, 16))
    now = np.full(B, NOW, dtype=np.int64)
    active = np.ones(B, dtype=bool)

    jc = jax.jit(lambda r, f, n, a: jk._probe_claim2(r, f, n, a, blk, u))(
        jnp.asarray(rows), jnp.asarray(fps), jnp.asarray(now), jnp.asarray(active))
    want = np.asarray(jax.jit(m.make_sweep2(nb, B, blk, u))(
        jnp.asarray(rows), jnp.asarray(new16), jc))
    np.testing.assert_array_equal(np.asarray(jk._write_xla(jnp.asarray(rows),
                                                           jnp.asarray(new16), jc)), want)

    tc = tk._probe_claim2(_t(rows), _t(fps), _t(now), _t(active), blk, u)
    got = t_sweep4.make_sweep2(nb, B, blk, u)(_t(rows.copy()), _t(new16), tc)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = Table2(_t(rows.copy()))
    tk._write_claim(ref, _t(new16), tc)
    np.testing.assert_array_equal(ref.rows.numpy(), want)
    written = int(tc.written.sum())
    assert 0 < written < int(tc.got.sum())  # dedup and overflow dropped rows


# ------------------------------------------------------- the entry points


def _entry_runs():
    from gubernator_tpu_torch.exp import exp_mem2, exp_sweep2

    small5 = {"tiny": (64, 64, 8, 8, True, True), "tiny-base": (64, 64, 8, 8, False, False)}
    return {
        "exp_sweep2": lambda d: exp_sweep2.run(device=d, nb=512, blk=64, u=16, reps=1,
                                               inner=1),
        "exp_sweep4": lambda d: t_sweep4.run(device=d, small=(1 << 12, 1 << 8),
                                             headline=(1 << 12, 1 << 8), blks=(64, 128),
                                             u=16, reps=1, inner=1),
        "exp_sweep5": lambda d: t_sweep5.run(cases="tiny,tiny-base", device=d,
                                             matrix=small5, reps=1, inner=1),
        "exp_mem2": lambda d: exp_mem2.run(device=d, nb=4096, batch=256, reps=1, inner=1),
    }


@pytest.mark.parametrize("name", ["exp_sweep2", "exp_sweep4", "exp_sweep5", "exp_mem2"])
def test_entry_point_runs_on_the_cpu_when_asked(name):
    """Each entry point at a tiny geometry with device="cpu" (the plain
    versions): one result naming the device and its timer."""
    out = _entry_runs()[name]("cpu")
    assert out["script"] == name and out["device"] == "cpu" and out["timer"] == "host_clock"
    if name == "exp_sweep4":
        assert out["small"]["equal"]


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep5.run(cases="base")


def test_sweep5_cases_match_the_script():
    src = (REPO / "exp" / "exp_sweep5.py").read_text()
    assert f'"SWEEP5_CASES", "{t_sweep5.DEFAULT_CASES}"' in src
    assert set(t_sweep5.MATRIX) == {ln.split('"')[1] for ln in src.splitlines()
                                     if ln.strip().startswith('"') and '": (' in ln}

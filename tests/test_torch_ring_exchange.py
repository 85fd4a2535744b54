"""Port parity: the mesh exchange (gubernator_tpu_torch.parallel.ring)
against the JAX package's exchange inside shard_map on the 8-device CPU
mesh.

``exchange_ref`` (the ring kernel's plain version, the ``_ring_shifts``
schedule in torch ops) and ``exchange_collective`` (the all_to_all layout)
are held to JAX's ``exchange`` with impl "ring" and "collective" inside
shard_map, for D in (2, 4, 8), int64 and int32 blocks, 1-D and folded
(host, device) meshes; the truncated ring (``hops=``) to the k-hop
prefixes of JAX's ``make_exchange_probe``; and ``a2a_impl``'s resolution.
The same numpy-seeded blocks go through both. Tolerance: exact (every
byte).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gubernator_tpu.parallel import make_mesh as jax_make_mesh
from gubernator_tpu.parallel.mesh import shard_map_compat, shard_spec
from gubernator_tpu.parallel.ring import exchange as jax_exchange
from gubernator_tpu.parallel.ring import make_exchange_probe
from gubernator_tpu_torch.parallel import ring as tr
from gubernator_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _jax_exchange(mesh, x, impl, hops=None):
    """JAX's exchange of the (D, D, ...) blocks inside shard_map (with `hops`,
    the truncated ring of its exchange probe)."""
    xs = jax.device_put(x, NamedSharding(mesh, shard_spec(mesh)))
    if hops is not None:
        return np.asarray(make_exchange_probe(mesh, x.shape[1:], impl, hops=hops)(xs))
    spec = shard_spec(mesh)
    fn = shard_map_compat(lambda b: jax_exchange(b[0], mesh, impl)[None], mesh=mesh,
                          in_specs=(spec,), out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(fn)(xs))


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_exchange_matches_jax(D, dtype):
    rng = np.random.default_rng(D * 3 + (dtype == np.int32))
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=(D, D, 5, 16), dtype=dtype, endpoint=True)
    want = _jax_exchange(jax_make_mesh(D), x, "collective")
    np.testing.assert_array_equal(_jax_exchange(jax_make_mesh(D), x, "ring"), want)
    blocks = [torch.from_numpy(x[s].copy()) for s in range(D)]
    for hosts in (None, 2):
        mesh = make_mesh(D, devices=["cpu"] * D, hosts=hosts)
        for impl in ("ring", "collective"):
            got = np.stack([t.numpy() for t in tr.exchange(blocks, mesh, impl)])
            np.testing.assert_array_equal(got, want, err_msg=f"{impl} hosts={hosts}")
    # the kernel wrapper takes its plain version on CPU tensors
    before = tr.ring_exchange.launches
    got = np.stack([t.numpy() for t in tr.ring_exchange(blocks)])
    np.testing.assert_array_equal(got, want)
    assert tr.ring_exchange.launches == before


@pytest.mark.parametrize("D", [9, 16])
def test_exchange_wider_than_one_launch(D):
    """Meshes wider than 8 shards: the ring (its plain version on CPU
    tensors, through ``exchange`` and the kernel's wrapper) equals the
    all_to_all layout, which test_exchange_matches_jax holds to JAX's.
    JAX's CPU mesh here has 8 devices, so the collective is the oracle."""
    rng = np.random.default_rng(D)
    x = rng.integers(-(2**62), 2**62, size=(D, D, 3, 16), dtype=np.int64)
    blocks = [torch.from_numpy(x[s].copy()) for s in range(D)]
    mesh = make_mesh(D, devices=["cpu"] * D)
    want = np.stack([t.numpy() for t in tr.exchange_collective(blocks, mesh.devices)])
    np.testing.assert_array_equal(want, x.transpose(1, 0, 2, 3))
    got = np.stack([t.numpy() for t in tr.exchange(blocks, mesh, "ring")])
    np.testing.assert_array_equal(got, want)
    got = np.stack([t.numpy() for t in tr.ring_exchange(blocks)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slab_bytes", [16, 96 * 1024, 96_016])
@pytest.mark.parametrize("D", [1, 2, 4, 8, 9, 16, 33, 64])
def test_exchange_chunks_cover_every_piece(D, slab_bytes):
    """The kernel's split of a launch (host model ``exchange_chunks``): every
    16-byte piece of every slab falls in exactly one unit, for a launch of
    all D sources and for one of half of them (a card's share), on an H100's
    132 SMs and on 3 (more units than blocks); the grid and the units fit
    the launch limits."""
    slab16 = slab_bytes // 16
    for sms, ns in ((132, D), (3, D), (132, max(1, D // 2))):
        grid, chunk, units = tr.exchange_chunks(D, slab_bytes, sms, ns=ns)
        assert 1 <= grid <= min(sms * 8, 2**31 - 1)
        assert chunk % 256 == 0 and 256 <= chunk <= 4096
        blk, sl, lo, hi = units.T
        assert ((blk >= 0) & (blk < grid)).all() and (hi > lo).all()
        assert int((hi - lo).sum()) == ns * D * slab16
        order = np.lexsort((lo, sl))
        sl, lo, hi = sl[order], lo[order], hi[order]
        np.testing.assert_array_equal(np.unique(sl), np.arange(ns * D))
        first = np.r_[True, sl[1:] != sl[:-1]]
        last = np.r_[sl[1:] != sl[:-1], True]
        assert (lo[first] == 0).all() and (hi[last] == slab16).all()
        np.testing.assert_array_equal(lo[~first], hi[np.flatnonzero(~first) - 1])


def test_exchange_chunks_refuse_what_the_kernel_cannot_take():
    grid, chunk, units = tr.exchange_chunks(tr.MAXD, 16, 132)
    assert grid == 132 * 8 and units.shape == (tr.MAXD**2, 4)
    with pytest.raises(ValueError):
        tr.exchange_chunks(tr.MAXD + 1, 16, 132)
    with pytest.raises(ValueError):
        tr.exchange_chunks(4, 24, 132)  # not whole 16-byte pieces


def test_exchange_truncated_hops_match_jax():
    """A k-hop prefix of the ring delivers exactly the blocks within k hops;
    the rest stay zero — as the JAX probe's truncated schedule."""
    D = 8
    rng = np.random.default_rng(3)
    x = rng.integers(1, 1 << 30, size=(D, D, 4, 16), dtype=np.int64)
    blocks = [torch.from_numpy(x[s].copy()) for s in range(D)]
    devices = [torch.device("cpu")] * D
    for hops in (1, 3):
        want = _jax_exchange(jax_make_mesh(D), x, "ring", hops=hops)
        got = np.stack([t.numpy() for t in tr.exchange_ref(blocks, devices, hops=hops)])
        np.testing.assert_array_equal(got, want, err_msg=f"hops={hops}")
        assert (got != 0).any() and (got == 0).any()


def test_a2a_impl_resolution(monkeypatch):
    monkeypatch.delenv("GUBER_A2A_IMPL", raising=False)
    assert tr.a2a_impl("ring", "cpu") == "ring"
    assert tr.a2a_impl("collective", "cuda") == "collective"
    # auto: the ring on the card, the collective on the CPU
    assert tr.a2a_impl(None, "cpu") == "collective"
    assert tr.a2a_impl(None, "cuda:0") == "ring"
    assert tr.a2a_impl(None) == "ring"  # None means the card
    monkeypatch.setenv("GUBER_A2A_IMPL", "ring")
    assert tr.a2a_impl(None, "cpu") == "ring"
    monkeypatch.setenv("GUBER_A2A_IMPL", "auto")
    assert tr.a2a_impl(None, "cpu") == "collective"
    monkeypatch.setenv("GUBER_A2A_IMPL", "bogus")
    with pytest.raises(ValueError):
        tr.a2a_impl(None, "cpu")


def test_ring_exchange_checks_its_inputs():
    blocks = [torch.zeros((2, 4, 8), dtype=torch.int64) for _ in range(2)]
    with pytest.raises(ValueError):
        tr.ring_exchange(blocks[:1])  # leading axis must be D
    with pytest.raises(ValueError):
        tr.ring_exchange([blocks[0], blocks[1].transpose(1, 2)])  # not contiguous
    with pytest.raises(ValueError):
        tr.ring_exchange([torch.zeros((8, 2), dtype=torch.int64)] * 9)  # leading axis != D
    with pytest.raises(ValueError):
        tr.ring_exchange([torch.zeros((2, 3), dtype=torch.int8)] * 2)  # 3-byte slabs

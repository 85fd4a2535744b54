"""Port parity: the mesh's topology and geometry helpers
(gubernator_tpu_torch.parallel.mesh and parallel.a2a) against the JAX
package on the 8-device CPU mesh.

``make_mesh`` axes and host-major addressing, 1-D and ``hosts=2`` and
GUBER_MESH_HOSTS (as tests/test_ring_exchange.py::test_make_mesh_topology
pins them for JAX); ``make_mesh`` refusing to fold shards onto missing
cards; ``shard_of`` on numpy and on torch; and the ``pair_capacity`` curve
and its sigma knob (tests/test_a2a_capacity.py). Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from gubernator_tpu.parallel import a2a as ja2a
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu_torch.parallel import a2a as ta2a
from gubernator_tpu_torch.parallel import mesh as tmesh


def _cpu(n):
    return ["cpu"] * n


def test_make_mesh_topology_matches_jax(monkeypatch):
    monkeypatch.delenv("GUBER_MESH_HOSTS", raising=False)
    for hosts in (None, 2):
        jm = jmesh.make_mesh(8, hosts=hosts)
        tm = tmesh.make_mesh(8, devices=_cpu(8), hosts=hosts)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape)
        assert tm.size == jm.devices.size == 8
        assert tmesh.shard_axes(tm) == jmesh.shard_axes(jm)
        assert tmesh.mesh_hosts(tm) == jmesh.mesh_hosts(jm)
        assert tmesh.devices_per_host(tm) == jmesh.devices_per_host(jm)
        np.testing.assert_array_equal(tmesh.host_of_shard(tm, np.arange(8)),
                                      jmesh.host_of_shard(jm, np.arange(8)))
    assert tmesh.make_mesh(8, devices=_cpu(8), hosts=2).devices == \
        tmesh.make_mesh(devices=_cpu(8)).devices
    with pytest.raises(ValueError):
        tmesh.make_mesh(6, devices=_cpu(6), hosts=4)  # uneven split
    monkeypatch.setenv("GUBER_MESH_HOSTS", "4")
    jm, tm = jmesh.make_mesh(8), tmesh.make_mesh(devices=_cpu(8))
    assert tmesh.mesh_hosts(tm) == jmesh.mesh_hosts(jm) == 4
    assert tmesh.devices_per_host(tm) == jmesh.devices_per_host(jm) == 2


def test_make_mesh_names_a_simulated_mesh_explicitly():
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, devices=_cpu(3))
    if not torch.cuda.is_available():
        # no cards: a mesh of cards cannot be made, and none is made of CPUs
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(2)
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(2, devices=["cuda:0"] * 2)


def test_shard_of_matches_jax():
    rng = np.random.default_rng(1)
    fp = rng.integers(1, 2**63 - 1, 4096, dtype=np.int64)
    fp[:4] = [1, 2**32, 2**63 - 1, ((2**31) - 1) << 32]
    for D in (1, 2, 3, 4, 8):
        want = jmesh.shard_of(fp, D)
        got_np = tmesh.shard_of(fp, D)
        got_t = tmesh.shard_of(torch.from_numpy(fp), D)
        assert got_np.dtype == np.int64 and got_t.dtype == torch.int64
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)
    assert int(tmesh.shard_of(np.int64(fp[7]), 8)) == int(jmesh.shard_of(np.int64(fp[7]), 8))


def test_pair_capacity_matches_jax(monkeypatch):
    monkeypatch.delenv("GUBER_A2A_CAPACITY_SIGMA", raising=False)
    pinned = {(8, 8): 16, (16, 8): 32, (64, 8): 32, (256, 8): 128, (1024, 8): 256,
              (16384, 8): 4096, (8, 1): 32, (1024, 1): 2048, (32768, 4): 16384}
    for (c, D), want in pinned.items():
        assert ta2a.pair_capacity(c, D) == ja2a.pair_capacity(c, D) == want
    for D in (1, 2, 4, 8, 16):
        for c in (8, 16, 64, 256, 1024, 4096, 16384):
            assert ta2a.pair_capacity(c, D) == ja2a.pair_capacity(c, D)
    for sigma, want in (("0", 256), ("20", 512)):
        monkeypatch.setenv("GUBER_A2A_CAPACITY_SIGMA", sigma)
        assert ta2a.a2a_capacity_sigma() == ja2a.a2a_capacity_sigma() == float(sigma)
        assert ta2a.pair_capacity(1024, 8) == ja2a.pair_capacity(1024, 8) == want

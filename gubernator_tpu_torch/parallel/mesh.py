"""Device mesh: which device holds which shard of the key table (the port of
``gubernator_tpu/parallel/mesh.py``).

Gubernator consistent-hashes each key to one of N nodes; the mesh engine
hashes each key to one of D shards, one per mesh device (``shard_of``: the
high 32 bits of the fingerprint modulo D, so shard ownership is independent
of the in-table slot, which uses low bits).

A ``Mesh`` is an ordered list of ``torch.device``s with the JAX package's
axis names: ``("shard",)`` on one host, ``("host", "device")`` when the
mesh is folded into H hosts. The linear shard numbering is host-major
(shard s ↔ host s // dl, device s % dl), so re-meshing the same devices
from 1 host to H moves no keys; ``hosts`` is pure addressing, as
GUBER_MESH_HOSTS is in the JAX package.

The mesh is one process driving its devices, as JAX's ``ShardedEngine`` is
a single controller. ``make_mesh(n)`` takes the first n cards and raises
when there are fewer. A simulated mesh, several shards on one device, is
always named by the caller: ``make_mesh(4, devices=["cuda:0"] * 4)`` on one
card, ``make_mesh(8, devices=["cpu"] * 8)`` in the CPU tests. Shards are
never folded onto one card silently.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

SHARD_AXIS = "shard"  # the 1-D single-host axis
HOST_AXIS = "host"  # folded meshes: leading axis, one row per host
DEVICE_AXIS = "device"  # folded meshes: trailing axis, devices within a host


class Mesh:
    """Ordered shard devices plus axis names and sizes. ``devices[s]`` holds
    shard s; ``shape`` maps each axis name to its size."""

    __slots__ = ("devices", "axis_names", "shape")

    def __init__(self, devices: Sequence[torch.device], axis_names: Tuple[str, ...],
                 shape: dict):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def env_mesh_hosts() -> Optional[int]:
    """GUBER_MESH_HOSTS: fold the devices into this many simulated hosts.
    Unset or empty means one host."""
    raw = os.environ.get("GUBER_MESH_HOSTS", "").strip()
    if not raw:
        return None
    hosts = int(raw)
    if hosts < 1:
        raise ValueError(f"GUBER_MESH_HOSTS must be >= 1, got {hosts}")
    return hosts


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    hosts: Optional[int] = None,
) -> Mesh:
    """Mesh over `devices`, or over the first `n_devices` cards (all cards
    when both are None; raises when there are fewer cards than asked for).
    With `devices` and `n_devices` both given, their lengths must agree.
    1-D ("shard",) for one host; 2-D ("host", "device") when `hosts`, or
    else GUBER_MESH_HOSTS, is above 1."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else int(n_devices)
        if want < 1 or want > have:
            raise RuntimeError(
                f"make_mesh: {want} cards asked for, {have} present; name the "
                "devices of a simulated mesh explicitly (devices=['cuda:0'] * n "
                "or ['cpu'] * n)"
            )
        devs = [torch.device("cuda", i) for i in range(want)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices named")
        if not devs:
            raise ValueError("a mesh needs at least one device")
    if any(d.type == "cuda" for d in devs):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name CPU devices to run a mesh on the CPU"
            )
        # "cuda" names the current card: pin its index, the exchange
        # addresses cards by index
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    D = len(devs)
    if hosts is None:
        hosts = env_mesh_hosts() or 1
    if hosts <= 1:
        return Mesh(devs, (SHARD_AXIS,), {SHARD_AXIS: D})
    if D % hosts != 0:
        raise ValueError(f"mesh of {D} devices cannot split over {hosts} hosts evenly")
    return Mesh(devs, (HOST_AXIS, DEVICE_AXIS), {HOST_AXIS: hosts, DEVICE_AXIS: D // hosts})


def shard_axes(mesh: Mesh):
    """The axis name(s) the shard dimension spans: "shard" on 1-D meshes,
    ("host", "device") on folded ones."""
    names = mesh.axis_names
    return names if len(names) > 1 else names[0]


def mesh_hosts(mesh: Mesh) -> int:
    """Host rows in the mesh (1 on single-host meshes)."""
    return int(mesh.shape.get(HOST_AXIS, 1))


def devices_per_host(mesh: Mesh) -> int:
    if HOST_AXIS in mesh.shape:
        return int(mesh.shape[DEVICE_AXIS])
    return mesh.size


def host_of_shard(mesh: Mesh, shard: np.ndarray) -> np.ndarray:
    """Owning host row for linear shard ids (shard s ↔ host s // dl)."""
    return np.asarray(shard) // devices_per_host(mesh)


def shard_of(fp, n_shards: int):
    """Owning shard of each fingerprint: ``(fp >> 32) % n_shards`` as int64,
    for a numpy array or a torch tensor (the a2a prologue calls it on device
    tensors). Fingerprints are positive 63-bit values, so the modulo of the
    shifted value is the same in both."""
    if isinstance(fp, torch.Tensor):
        return torch.remainder(fp.to(torch.int64) >> 32, n_shards)
    return ((np.asarray(fp, dtype=np.int64) >> 32) % n_shards).astype(np.int64)

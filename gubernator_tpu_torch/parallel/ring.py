"""Ownership exchange over the mesh (the port of
``gubernator_tpu/parallel/ring.py``).

The mesh engine's device routing (parallel/a2a.py) needs one primitive:
every shard s holds a (D, L, C) send buffer whose block d is meant for
shard d; deliver each block and hand every shard a (D, L, C) receive buffer
whose block s came from shard s — ``recv[d][s] = send[s][d]``, the layout
of ``lax.all_to_all(split_axis=0, concat_axis=0)``.

``exchange(blocks, mesh, impl)`` takes the D send tensors (each on its
shard's device) and returns the D receive tensors. Two schedules compute
the same bytes (GUBER_A2A_IMPL = ring | collective | auto):

* **ring** — on the card, the hand-written Hopper kernel
  ``csrc/ring_exchange.cu`` through ``ring_exchange`` (one launch per card
  that holds source shards, per group of at most MAXD sources and MAXD
  destinations; the port of the TPU kernel ``_ring_kernel``).
  On CPU tensors its plain version ``exchange_ref``: the ``_ring_shifts``
  schedule in torch ops — the own block first, then hop k moves block
  (me+k) % D of each shard to its owner's slot me.
* **collective** — ``exchange_collective``, the all_to_all layout in torch
  ops, the oracle the tests hold the other two against.

``auto`` resolves to ring on the card and collective on the CPU, as the JAX
package resolves by backend. The mesh is one process driving its devices,
so the exchange needs no process group.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import torch

from gubernator_tpu_torch import _build

A2A_IMPLS = ("auto", "ring", "collective")
MAXD = 8  # sources, and destinations, one launch addresses (GUBER_RING_MAXD)
_THREADS = 256  # the kernel's block size (kThreads)
_SM_BLOCKS = 132 * 8  # blocks that keep every SM of an H100 busy


def a2a_impl(override: Optional[str] = None, device=None) -> str:
    """The exchange schedule: `override`, then GUBER_A2A_IMPL, then auto
    (ring on the card, collective on the CPU; ``device`` is the mesh's
    device, None meaning the card)."""
    impl = override or os.environ.get("GUBER_A2A_IMPL", "auto")
    if impl not in A2A_IMPLS:
        raise ValueError(f"GUBER_A2A_IMPL must be one of {A2A_IMPLS}, got {impl!r}")
    if impl == "auto":
        dev = torch.device("cuda" if device is None else device)
        return "ring" if dev.type == "cuda" else "collective"
    return impl


def exchange(blocks: Sequence[torch.Tensor], mesh, impl: str) -> List[torch.Tensor]:
    """Deliver per-destination blocks (leading axis = destination shard) and
    return per-source blocks (leading axis = source shard). `blocks[s]`
    lies on ``mesh.devices[s]``; the result's d-th tensor on
    ``mesh.devices[d]``. The bytes are the same for every impl."""
    D = mesh.size
    if len(blocks) != D:
        raise ValueError(f"exchange needs {D} send blocks, got {len(blocks)}")
    if D == 1:
        return list(blocks)
    if impl == "collective":
        return exchange_collective(blocks, mesh.devices)
    if impl != "ring":
        raise ValueError(f"unknown exchange impl {impl!r}")
    return ring_exchange(blocks, mesh.devices)


def exchange_collective(blocks: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The all_to_all layout: recv[d] = stack over s of send[s][d]."""
    D = len(blocks)
    return [torch.stack([blocks[s][d].to(devices[d]) for s in range(D)]) for d in range(D)]


def exchange_ref(blocks: Sequence[torch.Tensor], devices,
                 hops: Optional[int] = None) -> List[torch.Tensor]:
    """The ring schedule in torch ops, the plain version of the kernel:
    shard me keeps its own block, then hop k (1 .. D-1) moves block
    (me + k) % D of shard me to shard (me + k) % D, which files it under
    source me. `hops` truncates the schedule, as the JAX package's exchange
    probe does: blocks more than `hops` hops away stay zero."""
    D = len(blocks)
    out = [torch.zeros_like(b, device=devices[me]) for me, b in enumerate(blocks)]
    for me in range(D):
        out[me][me] = blocks[me][me]
    n_hops = D - 1 if hops is None else min(hops, D - 1)
    for k in range(1, n_hops + 1):
        for me in range(D):
            dst = (me + k) % D
            out[dst][me] = blocks[me][dst].to(devices[dst])
    return out


# ------------------------------------------------------------- the kernel


class _RingArgs(ctypes.Structure):
    _fields_ = [
        ("send", ctypes.c_void_p * MAXD),
        ("recv", ctypes.c_void_p * MAXD),
        ("slab_bytes", ctypes.c_longlong),
        ("D", ctypes.c_int),
        ("s0", ctypes.c_int),
        ("ns", ctypes.c_int),
        ("d0", ctypes.c_int),
        ("nd", ctypes.c_int),
    ]


def _lib():
    lib = _build.load("ring_exchange")
    if lib.guber_ring_exchange.argtypes is None:
        lib.guber_ring_exchange.argtypes = [
            ctypes.c_int, ctypes.POINTER(_RingArgs), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.guber_ring_exchange.restype = ctypes.c_int
        lib.guber_ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.guber_ring_enable_peer.restype = ctypes.c_int
    return lib


_PEERS_ENABLED = set()


def _enable_peer(lib, dev: int, peer: int) -> None:
    if (dev, peer) in _PEERS_ENABLED:
        return
    with torch.cuda.device(dev):
        err = lib.guber_ring_enable_peer(dev, peer)
    if err != 0:
        raise RuntimeError(f"ring_exchange: card {dev} cannot store into card {peer} "
                           f"(cudaError {err})")
    _PEERS_ENABLED.add((dev, peer))


def _check(blocks: Sequence[torch.Tensor]) -> int:
    """Validate the send blocks; returns the slab size in bytes."""
    D = len(blocks)
    if D < 1:
        raise ValueError("ring_exchange needs at least one shard")
    b0 = blocks[0]
    for b in blocks:
        if b.shape != b0.shape or b.dtype != b0.dtype:
            raise ValueError("ring_exchange: every send block must have one shape and dtype")
        if b.dim() < 1 or b.shape[0] != D:
            raise ValueError(f"ring_exchange: send blocks must be (D={D}, ...), got {tuple(b.shape)}")
        if not b.is_contiguous():
            raise ValueError("ring_exchange: send blocks must be contiguous")
    slab = b0[0].numel() * b0.element_size()
    if slab % 16:
        raise ValueError(f"ring_exchange: a slab of {slab} bytes is not a multiple of 16")
    return slab


def ring_exchange(blocks: Sequence[torch.Tensor], devices=None) -> List[torch.Tensor]:
    """The ring exchange, for any number of shards. CPU tensors take the
    plain version (``exchange_ref``); CUDA tensors launch the kernel, or
    raise: one launch per card that holds source shards when D <= MAXD,
    else one per group of at most MAXD sources of one card and MAXD
    destinations. `devices[d]` is where receive buffer d goes (default:
    where send block d lies)."""
    slab = _check(blocks)
    D = len(blocks)
    devices = [b.device if devices is None else torch.device(devices[s])
               for s, b in enumerate(blocks)]
    if all(b.device.type == "cpu" for b in blocks):
        return exchange_ref(blocks, devices)
    if any(b.device.type != "cuda" for b in blocks) or any(d.type != "cuda" for d in devices):
        raise ValueError("ring_exchange runs on cuda or cpu tensors, not a mix")
    if any(b.device != dv for b, dv in zip(blocks, devices)):
        raise ValueError("ring_exchange: send block s must lie on device s")
    for b in blocks:
        if b.data_ptr() % 16:
            raise ValueError("ring_exchange: send blocks must be 16-byte aligned")
    lib = _lib()
    cards = sorted({d.index for d in devices})
    recv = [torch.empty_like(b) for b in blocks]
    args = _RingArgs()
    args.slab_bytes = slab
    args.D = D
    n16 = slab // 16
    dgroups = [(d0, min(d0 + MAXD, D)) for d0 in range(0, D, MAXD)]
    multi = len(cards) > 1
    if multi:
        # the receive buffers were allocated on their own cards' streams:
        # every source card starts after them
        alloc = {}
        for c in cards:
            with torch.cuda.device(c):
                ev = torch.cuda.Event()
                ev.record()
                alloc[c] = ev
    done = []
    for c in cards:
        srcs = [s for s in range(D) if devices[s].index == c]
        runs = []  # contiguous source ranges of at most MAXD: one launch each
        for s in srcs:
            if runs and runs[-1][1] == s and s - runs[-1][0] < MAXD:
                runs[-1][1] = s + 1
            else:
                runs.append([s, s + 1])
        with torch.cuda.device(c):
            stream = torch.cuda.current_stream(c)
            if multi:
                for peer in cards:
                    if peer != c:
                        _enable_peer(lib, c, peer)
                        stream.wait_event(alloc[peer])
            for s0, s1 in runs:
                args.s0, args.ns = s0, s1 - s0
                for i in range(s0, s1):
                    args.send[i - s0] = blocks[i].data_ptr()
                for d0, d1 in dgroups:
                    args.d0, args.nd = d0, d1 - d0
                    for j in range(d0, d1):
                        args.recv[j - d0] = recv[j].data_ptr()
                    bx = max(1, min(-(-n16 // _THREADS), _SM_BLOCKS // (args.ns * args.nd)))
                    err = lib.guber_ring_exchange(c, ctypes.byref(args), bx,
                                                  stream.cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"ring_exchange launch failed: cudaError {err}")
                    ring_exchange.launches += 1
            if multi:
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
    if multi:
        # every receiving card reads its buffer after all sources stored
        for c in cards:
            with torch.cuda.device(c):
                for ev in done:
                    torch.cuda.current_stream(c).wait_event(ev)
    return recv


ring_exchange.launches = 0

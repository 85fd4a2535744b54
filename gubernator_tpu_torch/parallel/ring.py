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
  that holds source shards, for any mesh of at most MAXD shards; the port
  of the TPU kernel ``_ring_kernel``). ``exchange_chunks`` is the host
  model of its split of the slabs into blocks' units.
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

import numpy as np
import torch

from gubernator_tpu_torch import _build

A2A_IMPLS = ("auto", "ring", "collective")
# The kernel's constants (csrc/ring_exchange.cu): the widest mesh its
# parameter block holds (kWideD), threads per block, blocks per SM of the
# grid, and the bounds of a unit in 16-byte pieces.
MAXD = 1024
_THREADS = 256
_BLOCKS_PER_SM = 8
_MIN_CHUNK16, _MAX_CHUNK16 = _THREADS, 4096


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


def exchange_chunks(D: int, slab_bytes: int, sms: int, ns: Optional[int] = None):
    """Host model of the kernel's split of one launch (for tests and
    reports; the C entry computes the same on the card). The launch's ns
    sources (default D) × D destinations are slabs i·D + d of slab_bytes;
    each is cut into units of ``chunk16`` 16-byte pieces, the last one
    ragged, and unit u = slab · chunks + c goes to block u % grid of a
    persistent grid. Returns (grid, chunk16, units), units an int64 array of
    rows (block, slab, first piece, end piece), in unit order."""
    if not 1 <= D <= MAXD:
        raise ValueError(f"ring_exchange takes 1 to {MAXD} shards, got {D}")
    if slab_bytes < 0 or slab_bytes % 16:
        raise ValueError(f"a slab of {slab_bytes} bytes is not a multiple of 16")
    ns = D if ns is None else ns
    ceil = lambda a, b: -(-a // b)
    slab16 = slab_bytes // 16
    slabs = ns * D
    wave = sms * _BLOCKS_PER_SM
    chunk = ceil(ceil(slabs * slab16, wave), _THREADS) * _THREADS
    chunk = min(max(chunk, _MIN_CHUNK16), _MAX_CHUNK16)
    chunks = ceil(slab16, chunk)
    grid = min(slabs * chunks, wave)
    u = np.arange(slabs * chunks, dtype=np.int64)
    lo = u % max(chunks, 1) * chunk
    units = np.stack([u % max(grid, 1), u // max(chunks, 1), lo,
                      np.minimum(lo + chunk, slab16)], axis=1)
    return grid, chunk, units


def _lib():
    lib = _build.load("ring_exchange")
    if lib.guber_ring_exchange.argtypes is None:
        lib.guber_ring_exchange.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
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
    raise: one launch per card that holds source shards, for meshes of at
    most MAXD shards. `devices[d]` is where receive buffer d goes (default:
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
    if D > MAXD:
        raise ValueError(f"ring_exchange: the kernel takes at most {MAXD} shards, got {D}")
    for b in blocks:
        if b.data_ptr() % 16:
            raise ValueError("ring_exchange: send blocks must be 16-byte aligned")
    lib = _lib()
    cards = sorted({d.index for d in devices})
    recv = [torch.empty_like(b) for b in blocks]
    recv_ptrs = (ctypes.c_void_p * D)(*[r.data_ptr() for r in recv])
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
        send_ptrs = (ctypes.c_void_p * len(srcs))(*[blocks[s].data_ptr() for s in srcs])
        src_idx = (ctypes.c_int * len(srcs))(*srcs)
        with torch.cuda.device(c):
            stream = torch.cuda.current_stream(c)
            if multi:
                for peer in cards:
                    if peer != c:
                        _enable_peer(lib, c, peer)
                        stream.wait_event(alloc[peer])
            err = lib.guber_ring_exchange(c, send_ptrs, src_idx, len(srcs), recv_ptrs, D,
                                          slab, stream.cuda_stream)
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

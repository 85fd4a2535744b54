"""Device-resident request ring and its drain (the port of
``gubernator_tpu/ops/ring_drain.py``).

The ring holds S compact wire-grid slots of one fixed width W plus the
``seq_in`` / ``seq_out`` fence words on the card (``DeviceRing``). A slot
carries ticket t when ``seq_in[t % S] == t + 1`` (never 0, so an unused
slot cannot alias). One drain decides up to k published slots, in ticket
order, and returns (bank, n): ``bank[i]`` is the i-th drained ticket's
compact egress image and n the claimed count — the same
``(table', seq_out', bank, drained)`` as the JAX package's ``drain_ring``.

The JAX drain is one ``lax.while_loop`` whose condition reads the ingress
fence on the device. Eager PyTorch has no device-side loop condition, and
reading the fences on the host costs a sync per slot, which is what the
drain exists to remove. So the port claims through ``fence_claim`` — the
hand-written Hopper kernel ``csrc/fence_claim.cu``, the port of the JAX
package's ``_fence_claim_kernel``, whose own documentation calls it the
device-side replacement of the host's claim loop — and then decides claim
position i for every i < k (the host knows k: it is the group it
published):

  (a) ``fence_claim`` copies the claimed grids into a claim bank, zeroes
      the positions past the claim and writes n; nothing leaves the card;
  (b) position i is decided by ``decide2_wire_cols_impl``; past the claim
      its grid is all zeros, every row inactive, so the decide writes
      nothing;
  (c) ``bank[i]`` takes the decide's output, zeroed for i >= n as JAX's
      fresh bank leaves it;
  (d) ``seq_out[slot] = t + 1`` is published for a claimed ticket only
      after its output exists (the JAX egress ordering). For that reason
      the claim kernel writes its own fence words into a claim-side array
      (``DeviceRing.claimed``), not into ``seq_out``.

No step syncs with the host. Threading: every ring and table operation
runs on the current stream of the engine's device, issued by one thread
(the engine thread of the service layer), so stream order is the only
ordering the protocol needs; a second writer would race it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.device import resolve_device, stream_scratch
from gubernator_tpu_torch.ops.engine import finish_check_columns, promote_rows
from gubernator_tpu_torch.ops.wire import WIRE_LANES, decide2_wire_cols_impl

i32 = torch.int32
i64 = torch.int64


def default_ring_issue(device=None) -> str:
    """GUBER_RING_ISSUE's default: the fused drain on the card, the host
    per-slot issue loop on the CPU (the byte-parity oracle)."""
    dev = torch.device("cuda" if device is None else device)
    return "fused" if dev.type == "cuda" else "host"


def egress_rows(width: int, evictees: bool) -> int:
    """Rows of one slot's compact egress image: (W+2, 4), or (5W+2, 4) with
    the raw evictee sidecar (kernel2.attach_evictees_wire)."""
    return 5 * width + 2 if evictees else width + 2


# ------------------------------------------------------------ fence claim


def fence_claim_ref(seq_in: np.ndarray, seq_out: np.ndarray, grids: np.ndarray,
                    start: int, k: int):
    """Numpy oracle of the fence-claim protocol: claim contiguously
    published tickets from `start` (a gap or k stops it), copy each claimed
    slot's grid, bump its egress fence. Returns (n, bank (n, ...),
    seq_out')."""
    S = seq_in.shape[0]
    seq_out = seq_out.copy()
    claimed = []
    n = 0
    while n < k:
        t = start + n
        slot = t % S
        if int(seq_in[slot]) != t + 1:
            break
        claimed.append(grids[slot].copy())
        seq_out[slot] = t + 1
        n += 1
    bank = (
        np.stack(claimed) if claimed
        else np.zeros((0,) + grids.shape[1:], dtype=grids.dtype)
    )
    return n, bank, seq_out


def _check_claim(seq_in, fence_out, grids, start: int, k: int, k_max: int) -> int:
    """Validate the operands; returns m = min(k, k_max, S), the positions a
    claim can reach (n <= S: ticket t + S would need a second fence word in
    slot t % S)."""
    if seq_in.dtype not in (i32, i64) or fence_out.dtype != seq_in.dtype:
        raise TypeError(
            f"fence words must be int32 or int64 and alike, got {seq_in.dtype} "
            f"and {fence_out.dtype}"
        )
    if grids.dtype != i32 or grids.dim() != 3 or grids.shape[1] != WIRE_LANES:
        raise ValueError(f"grids must be (S, {WIRE_LANES}, W+1) int32, got "
                         f"{grids.dtype} {tuple(grids.shape)}")
    S = grids.shape[0]
    if seq_in.shape != (S,) or fence_out.shape != (S,):
        raise ValueError(f"fence words must be ({S},), got {tuple(seq_in.shape)} "
                         f"and {tuple(fence_out.shape)}")
    if not (seq_in.is_contiguous() and fence_out.is_contiguous() and grids.is_contiguous()):
        raise ValueError("fence words and grids must be contiguous")
    if not (seq_in.device == fence_out.device == grids.device):
        raise ValueError(f"operands on different devices: {seq_in.device}, "
                         f"{fence_out.device}, {grids.device}")
    if k_max < 1 or k < 0 or start < 0:
        raise ValueError(f"need k_max >= 1, k >= 0, start >= 0; got {k_max}, {k}, {start}")
    m = min(k, k_max, S)
    if seq_in.dtype == i32 and start + m >= 2**31:
        raise ValueError("int32 fence words: tickets must stay below 2^31")
    return m


def fence_claim_plain(seq_in: torch.Tensor, fence_out: torch.Tensor, grids: torch.Tensor,
                      start: int, k: int, k_max: int):
    """Plain PyTorch version of the claim, on any device and without a host
    sync: the prefix of published tickets as a cumulative product. Updates
    `fence_out` in place; returns (bank (k_max, 5, W+1) int32 with zero rows
    past the claim, n (1,) int32)."""
    m = _check_claim(seq_in, fence_out, grids, start, k, k_max)
    dev = grids.device
    bank = torch.zeros((k_max,) + tuple(grids.shape[1:]), dtype=i32, device=dev)
    if m == 0:
        return bank, torch.zeros(1, dtype=i32, device=dev)
    t = start + torch.arange(m, dtype=i64, device=dev)
    slot = t % grids.shape[0]
    published = seq_in[slot].to(i64) == t + 1
    claimed = torch.cumprod(published.to(i32), dim=0) != 0
    bank[:m] = torch.where(claimed[:, None, None], grids[slot], torch.zeros((), dtype=i32, device=dev))
    fence_out[slot] = torch.where(claimed, (t + 1).to(fence_out.dtype), fence_out[slot])
    return bank, claimed.sum(dtype=i32).reshape(1)


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("fence_claim").guber_fence_claim
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def fence_claim(seq_in: torch.Tensor, fence_out: torch.Tensor, grids: torch.Tensor,
                start: int, k: int, k_max: int):
    """Claim up to k contiguously published tickets from `start`. Updates
    `fence_out` in place (t + 1 for each claimed ticket's slot, stored
    after its grid is copied); returns (bank (k_max, 5, W+1) int32, the
    claimed grids in ticket order and zeros past the claim, n (1,) int32).
    `start` and `k` are host integers: the host knows the group it
    published. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    m = _check_claim(seq_in, fence_out, grids, start, k, k_max)
    if grids.device.type == "cpu":
        return fence_claim_plain(seq_in, fence_out, grids, start, k, k_max)
    if grids.device.type != "cuda":
        raise ValueError(f"fence_claim runs on cuda or cpu tensors, got {grids.device}")
    dev = grids.device
    bank = torch.empty((k_max,) + tuple(grids.shape[1:]), dtype=i32, device=dev)
    n = torch.empty(1, dtype=i32, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = stream_scratch("fence_claim", dev, k_max)
        err = fn(seq_in.element_size(), seq_in.data_ptr(), fence_out.data_ptr(),
                 grids.data_ptr(), bank.data_ptr(), n.data_ptr(), counters.data_ptr(),
                 grids.shape[0], grids[0].numel(), start, m, k_max, stream)
    if err != 0:
        raise RuntimeError(f"fence_claim launch failed: cudaError {err}")
    fence_claim.launches += 1
    return bank, n


fence_claim.launches = 0


def make_fence_claim(slots: int, width: int, k_max: int):
    """The claim for one ring geometry, with the JAX package's contract:
    fn(seq_in (S,), seq_out (S,), grids (S, 5, W+1), ctl = [start, k]) →
    (seq_out', bank (k_max, 5, W+1), n (1,)). `ctl` is read on the host
    (a numpy array, a sequence or a CPU tensor); `seq_out` is updated in
    place and returned."""

    def fn(seq_in, seq_out, grids, ctl):
        if tuple(grids.shape) != (slots, WIRE_LANES, width + 1):
            raise ValueError(f"grids must be ({slots}, {WIRE_LANES}, {width + 1}), "
                             f"got {tuple(grids.shape)}")
        start, k = (int(v) for v in np.asarray(ctl).reshape(2))
        bank, n = fence_claim(seq_in, seq_out, grids, start, k, k_max)
        return seq_out, bank, n

    return fn


# ------------------------------------------------------------------ drain


def drain_ring(table, grids, seq_in, seq_out, claimed, start: int, k: int, *,
               k_max: int, write: str, math: str, cascade: bool, probe: str,
               evictees: bool):
    """One drain over tickets [start, start + min(k, k_max)), steps (a)-(d)
    of the module docstring. `seq_out`, `claimed` and ``table.rows`` are
    updated in place. Returns (table, seq_out, bank (k_max, E, 4) int32, n
    (1,) int32), all on the device."""
    S = grids.shape[0]
    k = min(int(k), int(k_max))
    claim_bank, n = fence_claim(seq_in, claimed, grids, start, k, k_max)
    dev = grids.device
    bank = torch.zeros((k_max, egress_rows(grids.shape[2] - 1, evictees), 4),
                       dtype=i32, device=dev)
    valid = torch.arange(k_max, device=dev) < n
    zero = torch.zeros((), dtype=i32, device=dev)
    for i in range(k):
        table, out = decide2_wire_cols_impl(
            table, claim_bank[i], write=write, math=math, cascade=cascade,
            probe=probe, evictees=evictees,
        )
        torch.where(valid[i], out, zero, out=bank[i])
        # egress fence AFTER the slot's output exists in the bank
        t = start + i
        slot = t % S
        seq_out[slot:slot + 1] = torch.where(valid[i], t + 1, seq_out[slot:slot + 1])
    return table, seq_out, bank, n


class DeviceRing:
    """The device-resident ring: S wire-grid slots of one fixed width plus
    the int64 fence words ``seq_in`` / ``seq_out`` and the claim kernel's
    own fence words ``claimed``, on the engine's device. Mutated only by
    the engine thread, on the device's current stream."""

    def __init__(self, slots: int, width: int, drain_k: int, evictees: bool = False,
                 device=None):
        if slots < 2 or drain_k < 1 or width < 1:
            raise ValueError("DeviceRing needs slots>=2, drain_k>=1, width>=1")
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.width = int(width)
        self.drain_k = int(min(drain_k, slots))
        self.evictees = bool(evictees)
        z = lambda *shape, dt=i64: torch.zeros(shape, dtype=dt, device=self.device)
        self.grids = z(self.slots, WIRE_LANES, self.width + 1, dt=i32)
        self.seq_in = z(self.slots)
        self.seq_out = z(self.slots)
        self.claimed = z(self.slots)

    def load_state(self, grids: np.ndarray, seq_in: np.ndarray, seq_out: np.ndarray) -> None:
        """Load a ring state from host arrays (for instance one taken from
        another ring mid-lap); the claim-side fence words follow seq_out."""
        shapes = ((self.slots, WIRE_LANES, self.width + 1), (self.slots,), (self.slots,))
        for a, shape in zip((grids, seq_in, seq_out), shapes):
            if np.shape(a) != shape:
                raise ValueError(f"ring state: expected {shape}, got {np.shape(a)}")
        self.grids.copy_(torch.from_numpy(np.asarray(grids, dtype=np.int32)))
        self.seq_in.copy_(torch.from_numpy(np.asarray(seq_in, dtype=np.int64)))
        self.seq_out.copy_(torch.from_numpy(np.asarray(seq_out, dtype=np.int64)))
        self.claimed.copy_(self.seq_out)

    def stage(self, slot: int, grid: np.ndarray, ticket: int) -> None:
        """Stage one slot's (5, width+1) grid, then publish its ingress
        fence: STAGE before PUBLISH, in stream order. On the card the grid
        leaves from pinned memory without blocking the host."""
        g = np.ascontiguousarray(grid, dtype=np.int32)
        if g.shape != (WIRE_LANES, self.width + 1):
            raise ValueError(f"slot grid must be ({WIRE_LANES}, {self.width + 1}), got {g.shape}")
        src = torch.from_numpy(g)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self.grids[slot].copy_(src, non_blocking=True)
        # fill_ launches a kernel; assigning a Python int would copy a host
        # scalar and block the host
        self.seq_in[slot:slot + 1].fill_(ticket + 1)

    def drain(self, engine, start: int, k: int, math: str, cascade: bool):
        """One drain over tickets [start, start+k) on the engine's table.
        Returns (bank, n) as device tensors; the finish half fetches them."""
        if engine.table.rows.device != self.grids.device:
            raise ValueError(f"ring on {self.grids.device}, engine on {engine.table.rows.device}")
        table, self.seq_out, bank, n = drain_ring(
            engine.table, self.grids, self.seq_in, self.seq_out, self.claimed, start, k,
            k_max=self.drain_k, write=engine.write_mode, math=math, cascade=cascade,
            probe=engine.probe_mode, evictees=engine._evictees,
        )
        engine.table = table
        return bank, n


# ------------------------------------------------------ issue and finish
# The two halves of a fused drain as the service runner drives them
# (gubernator_tpu/service/runner.py drain_ring_issue / drain_ring_finish),
# without its threads and metrics.


def issue_ring_group(engine, dring: DeviceRing, group, start: int):
    """Engine-thread half: issue-time work per slot in ticket order, stage
    each slot's grid and fence, then ONE drain over the group (prepared
    by engine.prepare_ring_slot, sharing one math mode and cascade flag).
    Returns the un-fetched (bank, n)."""
    for prep in group:
        pending = prep.pending
        if pending.promote is not None:
            _, pending.promote_putback = promote_rows(engine, pending.promote, pending.now)
            pending.promote = None
        if pending.mark is not None and getattr(engine, "ckpt", None) is not None:
            engine.ckpt.mark(pending.mark)  # checkpoint marks, before the launch
    head = group[0]
    if engine._batch_needs_full(head.math):
        engine.migrate_layout_full()
    engine._seen_pad_sizes.add(dring.width)
    engine.last_dispatch_rows = dring.width
    for i, prep in enumerate(group):
        dring.stage((start + i) % dring.slots, prep.grid, start + i)
    return dring.drain(engine, start, len(group), head.math, head.cascade)


def finish_ring_group(engine, group, bank, n, fixup):
    """Fetch-thread half: ONE bank fetch covers the group; each slot's
    PendingCheck then runs the standard finish over its egress image.
    Raises when the device claimed another count than the group published
    (a fence-protocol violation, not a recovery path). Returns the
    per-slot (ResponseColumns, EngineStats delta) in ticket order."""
    fetched = bank.cpu().numpy()
    drained = int(n.cpu()[0])
    if drained != len(group):
        raise RuntimeError(
            f"ring drain fence violation: group of {len(group)} published slots, "
            f"device retired {drained}"
        )
    done = []
    for i, prep in enumerate(group):
        prep.pending.passes[0][3] = fetched[i]
        done.append(finish_check_columns(engine, prep.pending, fixup))
    return done

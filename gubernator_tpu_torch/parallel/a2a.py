"""Device routing: the mesh routes its own requests with an all-to-all
exchange (the port of ``gubernator_tpu/parallel/a2a.py``).

The host-routed path (sharded.py ``_stage``) sorts rows by owning shard on
the host. With ``route="device"`` the host ships rows in arrival order and
the shards route them, MoE-dispatch style:

 1. the packed (12, n) columns become one (12, c) block per shard (row i →
    shard i // c);
 2. each shard computes its rows' owners (``mesh.shard_of``), sorts them
    stably by owner (inactive rows get owner D and sort last), ranks each
    row within its owner's group (``searchsorted``, side left) and gathers
    rows into a (D, 12, C) send buffer — C is the per-pair capacity, mean
    + 5σ of the multinomial per-pair count (``pair_capacity``); rows past a
    pair's capacity are marked dropped and unprocessed, and the engine
    re-dispatches them;
 3. one exchange (parallel/ring.py) delivers every row to its owner;
 4. each owner decides its (D·C) received rows in source-major, rank-minor
    order (the claim breaks ties by row order, so this order sets the table
    bytes);
 5. a second exchange returns the (D, C, 4) responses to each row's source
    shard, which un-sorts them to arrival order.

With ``dedup=True`` duplicate keys aggregate at both ends: once per source
block before the owners are computed (a hot key costs at most one row of
each pair's capacity) and once at the owner over the received rows; member
rows answer from their carrier with FLAG_MEMBER. With ``wire=True`` the
(5, c+1) compact blocks decode before the exchange and the (c+2, 4)
outputs encode after it; the exchange moves full 12-lane rows.

The output of shard d is its (c+2, 4) block — c responses in arrival order
and its owner decide's two stats rows — so the engine decodes both routes
with the same code. ``make_a2a_decide`` returns a plain function over the D
shards; PyTorch runs it eagerly, each shard's work on its own device.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

from gubernator_tpu_torch.ops.engine import default_write_mode
from gubernator_tpu_torch.ops.kernel2 import (
    FLAG_DROPPED,
    FLAG_UNPROCESSED,
    _unsort,
    decide2_packed_cols_impl,
    decide2_packed_dedup_impl,
    dedup_packed_cols,
    fanout_packed,
)
from gubernator_tpu_torch.ops.table2 import Table2
from gubernator_tpu_torch.ops.wire import decode_wire_block, encode_wire_out
from gubernator_tpu_torch.parallel.mesh import shard_of
from gubernator_tpu_torch.parallel.ring import a2a_impl, exchange

i32 = torch.int32
i64 = torch.int64


def a2a_capacity_sigma() -> float:
    """GUBER_A2A_CAPACITY_SIGMA (default 5.0): the standard deviations of
    the per-pair capacity's multinomial tail bound. Lower values shrink the
    exchanged buffers at the price of more overflow drops, which the engine
    retries: a speed knob, never a lost request."""
    return float(os.environ.get("GUBER_A2A_CAPACITY_SIGMA", "5.0"))


def pair_capacity(c: int, D: int) -> int:
    """Per-(source, destination) row capacity: mean + σ·sqrt(mean) of the
    count of c hash-routed rows over D destinations, plus 8, rounded up to
    a power of two >= 8."""
    mean = c / D
    cap = int(mean + a2a_capacity_sigma() * mean**0.5) + 8
    p = 8
    while p < cap:
        p *= 2
    return p


def _route(a: torch.Tensor, D: int, C: int):
    """Step 2 on one shard: (send (D, 12, C), o_s, idx_s, rank, ok_s) for
    its (12, c) arrival-order rows."""
    c = a.shape[1]
    dev = a.device
    active = a[11] != 0
    owner = torch.where(active, shard_of(a[0], D), torch.full_like(a[0], D)).to(i32)
    o_s, idx_s = torch.sort(owner, stable=True)
    gstart = torch.searchsorted(o_s, o_s)
    rank = torch.arange(c, device=dev) - gstart  # position within the owner's group
    ok_s = (rank < C) & (o_s < D)
    # slot (d, j) of the send buffer takes sorted row searchsorted(o_s, d) + j
    # when j < count(d)
    slot = torch.arange(D * C, device=dev)
    d_iota = (slot // C).to(i32)
    j_iota = slot % C
    g0 = torch.searchsorted(o_s, d_iota)
    g1 = torch.searchsorted(o_s, d_iota, right=True)
    src = g0 + j_iota
    valid = src < g1
    rows_sorted = a[:, idx_s]
    send = torch.where(valid[None, :], rows_sorted[:, torch.clip(src, 0, c - 1)],
                       torch.zeros((), dtype=i64, device=dev))  # zero slots are inactive
    send3 = send.reshape(12, D, C).transpose(0, 1).contiguous()
    return send3, o_s, idx_s, rank, ok_s


def make_a2a_decide(
    mesh, c: int, math: str = "mixed", write=None, dedup: bool = False,
    wire: bool = False, impl=None, probe: str = "xla",
):
    """The all-shards decide with device routing: fn(tables, blocks) →
    (tables, outs). `tables[d]` is shard d's Table2 (its rows updated in
    place), `blocks[d]` its (12, c) int64 arrival-order block — or with
    `wire`, its (5, c+1) int32 compact block — and `outs[d]` its (c+2, 4)
    output, int64 or compact int32. `impl` picks the exchange (None:
    GUBER_A2A_IMPL, auto by device)."""
    write = write or default_write_mode()
    impl = a2a_impl(impl, mesh.devices[0])
    D = mesh.size
    C = pair_capacity(c, D)

    def fn(tables: List[Table2], blocks: Sequence[torch.Tensor]):
        srcs = []
        sends = []
        for d in range(D):
            if wire:
                a, base = decode_wire_block(blocks[d])
            else:
                a, base = blocks[d], None
            carrier0 = member0 = None
            if dedup:
                # source-local merge: members deactivate and are not sent
                a, carrier0, member0 = dedup_packed_cols(a)
            send3, o_s, idx_s, rank, ok_s = _route(a, D, C)
            sends.append(send3)
            srcs.append((a[11] != 0, base, carrier0, member0, o_s, idx_s, rank, ok_s))

        # rows to their owners: the leading axis turns from destination to source
        recv = exchange(sends, mesh, impl)
        resps, stats = [], []
        for d in range(D):
            local = recv[d].transpose(0, 1).reshape(12, D * C)
            if dedup:
                # the same key can arrive from up to D source carriers
                tables[d], packed = decide2_packed_dedup_impl(
                    tables[d], local, write=write, math=math, probe=probe)
            else:
                tables[d], packed = decide2_packed_cols_impl(
                    tables[d], local, write=write, math=math, probe=probe)
            resps.append(packed[: D * C].reshape(D, C, 4).contiguous())
            stats.append(packed[D * C:])

        # responses back to each row's source shard
        back = exchange(resps, mesh, impl)
        outs = []
        for d in range(D):
            active, base, carrier0, member0, o_s, idx_s, rank, ok_s = srcs[d]
            dev = active.device
            back_d = back[d].reshape(D * C, 4)
            # un-sort to arrival order: arrival row idx_s[p] sat in slot
            # o_s[p] * C + rank[p]
            slot_s = torch.where(ok_s, o_s.to(i64) * C + rank, torch.zeros_like(rank))
            slot_u = _unsort(idx_s, slot_s)
            sent = _unsort(idx_s, ok_s)
            out = back_d[slot_u]
            zero = torch.zeros((), dtype=i64, device=dev)
            # capacity overflow: dropped and unprocessed, so the engine
            # re-dispatches the row and counts it where it is decided
            drop_flags = torch.where(
                active, torch.full((), FLAG_DROPPED | FLAG_UNPROCESSED, dtype=i64, device=dev),
                zero)
            out = torch.where(sent[:, None], out, zero)
            out = torch.cat([out[:, :3], torch.where(sent, out[:, 3], drop_flags)[:, None]],
                            dim=1)
            packed_out = torch.cat([out, stats[d]], dim=0)
            if dedup:
                # source-local members answer from their carrier (a dropped
                # carrier hands them its drop flags: the retry re-sends the
                # whole group)
                packed_out = fanout_packed(packed_out, carrier0, member0, out.shape[0])
            if wire:
                packed_out = encode_wire_out(packed_out, base)
            outs.append(packed_out)
        return tables, outs

    return fn

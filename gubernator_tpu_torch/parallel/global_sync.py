"""The GLOBAL behavior on the mesh: replica tables and a collective sync
(the port of ``gubernator_tpu/parallel/global_sync.py``).

In gubernator a GLOBAL rate limit has one owning node; every other node
answers from a local read-replica at once and ships its accumulated hits
to the owner asynchronously (runAsyncHits, a 100 ms cadence), which
applies them with DRAIN_OVER_LIMIT forced and broadcasts the authoritative
status to every peer (runBroadcasts → UpdatePeerGlobals;
docs/architecture.md:84-105).

Here the mesh is the peer group. Every shard keeps

* its authoritative table (the ShardedEngine's ``tables``),
* a **replica table** holding the installed statuses of GLOBAL keys other
  shards own (``replica``, created full on first GLOBAL use), and
* a host-side accumulator of pending hits (``PendingHits``: sum the hits,
  OR RESET_REMAINING, newest config wins — reference global.go:109-123).

``sync()`` drains the accumulators in collective rounds (``sync_round``):

1. all-gather every home's outbox, D × ``sync_out`` rows;
2. each shard keeps the rows it owns, groups equal keys by a stable sort
   and sums their hits, then decides the aggregate on its primary with
   DRAIN_OVER_LIMIT forced (reference gubernator.go:526-532);
3. all-gather the resulting statuses (``bc``); each shard installs the
   rows it does NOT own into its replica (UpdatePeerGlobals semantics,
   reference gubernator.go:434-474).

A round is plain torch ops over the D shard tables (the decide and the
install write through ``slot_write``), with no host read inside: shards on
one card read one stacked outbox, shards on several cards receive every
outbox and every ``bc`` by device-to-device copies. A sync tick drains
the accumulators in rounds with no host read between them; the counters
stay on the device until the drain ends and are fetched once.

GLOBAL requests are answered from the home shard's replica at once ("as
if we owned it", with GLOBAL stripped and NO_BATCHING forced, reference
gubernator.go:401-429) — eventually consistent within one sync cadence,
the reference's contract.

With ``store=`` the owner rows of a GLOBAL check write through and
rehydrate their misses on the primary (the reference's owner-side
getLocalRateLimit), and ``sync()`` drains round by round, firing each
round's reconciled owner state (``bc``) as a ChangeSet, so that every
reconciled entry reaches ``on_change`` exactly once.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.ops import wire as wire_mod
from gubernator_tpu_torch.ops.batch import (
    ERR_DROPPED,
    ERROR_STRINGS,
    HostBatch,
    InstallBatch,
    ReqBatch,
    RequestColumns,
    ResponseColumns,
    pack_columns,
    pack_host_batch,
    pack_requests,
    pad_batch,
)
from gubernator_tpu_torch.ops.engine import (
    EngineStats,
    _fold_cascades_host,
    _pad_size,
    _rehydrate_misses,
    _stack_pass_outputs,
    _store_change_set,
    ms_now,
)
from gubernator_tpu_torch.ops.kernel2 import decide2_impl, install2_impl, req_from_arr
from gubernator_tpu_torch.ops.plan import _subset
from gubernator_tpu_torch.parallel.mesh import Mesh, shard_of
from gubernator_tpu_torch.parallel.sharded import ShardedEngine, new_sharded_table
from gubernator_tpu_torch.types import Behavior, RateLimitRequest, RateLimitResponse, has_behavior

# the all-inactive rows of a round sort into their own leading segment:
# real fingerprints are in [1, 2^63 - 1]
DROP_FP = -1
_RESET = int(Behavior.RESET_REMAINING)
_DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
_GLOBAL = int(Behavior.GLOBAL)


class PendingHits:
    """Columnar per-home accumulator of GLOBAL hits awaiting the sync tick.

    ``merge`` is the reference's async-hit aggregation (global.go:109-123:
    sum the hits, OR RESET_REMAINING, the newest request's config wins) as
    one numpy group-by per batch. Entry order only decides which round an
    entry rides in (sync() drains everything every tick), never the
    reconciled result."""

    __slots__ = ("hb", "hits", "reset", "oldest_ts")

    def __init__(self):
        self.hb: Optional[HostBatch] = None  # unique-fp config carrier rows
        self.hits: Optional[np.ndarray] = None  # (n,) int64 accumulated hits
        self.reset: Optional[np.ndarray] = None  # (n,) int32 RESET bits OR-ed
        # monotonic time of the oldest entry still queued: set when the
        # first entry lands in an empty queue, cleared only by a full drain
        # (a partial take keeps it: staleness stays an upper bound)
        self.oldest_ts: Optional[float] = None

    def age_s(self) -> float:
        """Seconds the oldest pending entry has waited (0 when empty)."""
        if self.oldest_ts is None or self.hb is None:
            return 0.0
        return max(0.0, time.monotonic() - self.oldest_ts)

    def __len__(self) -> int:
        # one read of self.hb: take() on the engine thread may clear it
        hb = self.hb
        return 0 if hb is None else int(hb.fp.shape[0])

    def merge(self, hb: HostBatch, rows: np.ndarray, hits: np.ndarray,
              reset: np.ndarray) -> None:
        """Fold rows `rows` of `hb` in (hits pre-zeroed for owner-side rows
        that only mark a broadcast)."""
        if self.hb is None:
            self.oldest_ts = time.monotonic()
        new = _subset(hb, rows)
        if self.hb is not None:
            new = HostBatch(*[np.concatenate([a, b]) for a, b in zip(self.hb, new)])
            hits = np.concatenate([self.hits, hits])
            reset = np.concatenate([self.reset, reset])
        uniq, inv = np.unique(new.fp, return_inverse=True)
        m = uniq.size
        h = np.zeros(m, dtype=np.int64)
        np.add.at(h, inv, hits)
        r = np.zeros(m, dtype=np.int32)
        np.bitwise_or.at(r, inv, reset.astype(np.int32))
        # newest config wins: the highest concatenated position per key
        # (queued entries come before the batch's rows, in request order)
        pos = np.full(m, -1, dtype=np.int64)
        np.maximum.at(pos, inv, np.arange(new.fp.shape[0]))
        self.hb = _subset(new, pos)
        self.hits, self.reset = h, r

    def take(self, k: int):
        """Pop up to k entries → (config rows, hits, reset). The popped
        columns are copies (`_build_box` stamps them in place); the
        remainder stays a view, so a deep drain is O(Q), not O(Q²)."""
        n = len(self)
        k = min(k, n)
        out = (
            HostBatch(*[f[:k].copy() for f in self.hb]),
            self.hits[:k].copy(),
            self.reset[:k].copy(),
        )
        if k == n:
            self.hb = self.hits = self.reset = None
            self.oldest_ts = None
        else:
            self.hb = HostBatch(*[f[k:] for f in self.hb])
            self.hits = self.hits[k:]
            self.reset = self.reset[k:]
        return out


@dataclass
class _QueuedHits:
    """Queue-merge inputs computed at prepare time and applied at issue time:
    the accumulator has one writer, the engine thread."""

    hb: HostBatch  # the GLOBAL sub-batch (config carrier rows)
    rows: np.ndarray  # rows to queue (active, nonzero hits)
    hits: np.ndarray  # per-row hits (0 for owner-side broadcast markers)
    reset: np.ndarray  # RESET_REMAINING bits
    home: int  # the batch's rotating home shard
    n_remote: int  # non-owner rows (the hits_queued delta)


@dataclass
class GlobalPending:
    """An in-flight pipelined GLOBAL check: the staged replica / owner /
    plain dispatches and the deferred queue merge."""

    hb: HostBatch
    err: np.ndarray
    now: int
    queue: _QueuedHits
    # [Pass, n_rows, batch, staged → (staged, out), table_attr, home_pin, rowmap]
    passes: list
    clamped: int
    stacked: object = None  # same-shape pass outputs fused for ONE fetch


@dataclass
class GlobalStats:
    """The reference's global-behavior counters (global.go:53-79)."""

    hits_queued: int = 0
    sync_rounds: int = 0
    broadcasts_applied: int = 0  # entries applied and broadcast as owner
    updates_installed: int = 0  # entries installed into replica tables
    send_queue_length: int = 0


# ------------------------------------------------------- the collective round


def _gather(blocks: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """All-gather: the D blocks concatenated along `dim` on `device` (a
    device-to-device copy for blocks on other cards)."""
    return torch.cat([b if b.device == device else b.to(device, non_blocking=True)
                      for b in blocks], dim=dim)


def _decode_outbox(block: torch.Tensor, wire: bool) -> torch.Tensor:
    """One home's outbox as the (12, OUT) int64 ingress layout: a full-width
    block as it is, a compact (5, OUT+1) int32 block decoded."""
    return wire_mod.decode_wire_block(block)[0] if wire else block


def _owner_decide(primary, flat: ReqBatch, me: int, D: int, write: str):
    """Stage 2 of a round on shard `me`: keep the gathered rows it owns,
    group equal keys (a stable sort, the non-owned rows in front under
    DROP_FP), sum their hits, OR their RESET bits, take the newest row's
    config, and decide the aggregate with DRAIN_OVER_LIMIT forced. Empty
    segments take JAX's identities (0 for a sum, the dtype's least value
    for a max). Returns (primary, bc InstallBatch, applied count tensor)."""
    dev = flat.fp.device
    i64 = torch.int64
    N = flat.fp.shape[0]
    mine = flat.active & (shard_of(flat.fp, D) == me)
    key = torch.where(mine, flat.fp, torch.full_like(flat.fp, DROP_FP))
    sfp, order = torch.sort(key, stable=True)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = sfp[1:] != sfp[:-1]
    seg = torch.cumsum(first.to(i64), 0) - 1
    hits = torch.zeros(N, dtype=i64, device=dev).index_add_(0, seg, flat.hits[order])
    beh = flat.behavior[order] & _RESET
    reset_bit = torch.full((N,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                           device=dev).scatter_reduce_(0, seg, beh, "amax")
    pos = torch.arange(N, dtype=i64, device=dev)
    carrier_pos = torch.full((N,), torch.iinfo(i64).min, dtype=i64, device=dev).scatter_reduce_(
        0, seg, torch.where(mine[order], pos, torch.full_like(pos, -1)), "amax")
    valid = carrier_pos >= 0
    carrier = order[torch.clamp(carrier_pos, 0, N - 1)]
    cfg = ReqBatch(*[f[carrier] for f in flat])
    agg = cfg._replace(hits=hits, behavior=cfg.behavior | _DRAIN | reset_bit, active=valid)
    primary, resp, _stats = decide2_impl(primary, agg, write=write)
    bc = InstallBatch(
        fp=torch.where(valid, agg.fp, torch.zeros_like(agg.fp)),
        algo=agg.algo,
        status=resp.status,
        limit=resp.limit,
        remaining=resp.remaining,
        reset_time=resp.reset_time,
        duration=agg.duration,
        now=agg.created_at,
        active=valid,
        # the config's real burst, and the owner's previous-window count
        # and stored remaining, so replicas interpolate as the owner does
        burst=agg.burst,
        stamp=agg.created_at,
        aux=resp.aux,
        rem_store=resp.rem_store,
    )
    return primary, bc, valid.sum(dtype=i64)


def sync_round(primaries: List, replicas: List, outboxes: Sequence[torch.Tensor], D: int,
               write: str, wire: bool = False, bc_out: Optional[list] = None):
    """One collective round over the D shards, in place: `outboxes[d]` is
    home d's (12, OUT) int64 outbox block, or its (5, OUT+1) int32 compact
    block with `wire`. Returns a (D, 2) int64 tensor on shard 0's device:
    per shard the entries applied as owner and the replica installs.
    `bc_out`, when given, receives the D shards' owner-applied broadcasts
    (InstallBatch each, in shard order). Nothing here reads the device on
    the host."""
    devs = [p.rows.device for p in primaries]
    decoded = [_decode_outbox(o, wire) for o in outboxes]
    flats = {}
    bcs, applied = [], []
    for me in range(D):
        dev = devs[me]
        if dev not in flats:  # the gathered outboxes, once per device
            flats[dev] = req_from_arr(_gather(decoded, dev, dim=1))
        primaries[me], bc, n = _owner_decide(primaries[me], flats[dev], me, D, write)
        bcs.append(bc)
        applied.append(n)
    if bc_out is not None:
        bc_out.extend(bcs)
    gathered = {}
    counters = []
    for me in range(D):
        dev = devs[me]
        if dev not in gathered:
            gathered[dev] = InstallBatch(*[
                None if f0 is None else _gather([getattr(bc, name) for bc in bcs], dev)
                for name, f0 in zip(InstallBatch._fields, bcs[0])
            ])
        inst = gathered[dev]
        theirs = inst.active & (shard_of(inst.fp, D) != me)
        replicas[me], installed = install2_impl(replicas[me], inst._replace(active=theirs),
                                                write=write)
        counters.append(torch.stack([applied[me], installed.sum(dtype=torch.int64)])
                        .to(devs[0], non_blocking=True))
    return torch.stack(counters)


class GlobalShardedEngine(ShardedEngine):
    """ShardedEngine plus GLOBAL replica tables and the collective sync.

    `home_shard` models the node a client connected to (the reference's
    non-owner): GLOBAL requests are answered from that shard's replica and
    their hits accumulate until the next sync tick. ``check_columns`` gives
    each GLOBAL batch a rotating home, modelling clients spread over the
    peer group (BASELINE config #3: an 8-peer cluster as a mesh)."""

    mesh_global = True  # daemon marker: GLOBAL is served by replicas + sync
    _SYNC_DRAIN_CAP = 64  # most rounds in one drain (one counter fetch)

    def __init__(
        self,
        mesh: Mesh,
        capacity_per_shard: int = 50_000,
        max_exact_passes: int = 8,
        sync_out: int = 256,
        created_at_tolerance_ms=None,
        store=None,
        route: Optional[str] = None,
        write_mode: Optional[str] = None,
        dedup: Optional[str] = None,
        wire: Optional[str] = None,
        a2a: Optional[str] = None,
        layout: Optional[str] = None,
        probe: Optional[str] = None,
        walk: Optional[str] = None,
    ):
        super().__init__(
            mesh, capacity_per_shard=capacity_per_shard, max_exact_passes=max_exact_passes,
            created_at_tolerance_ms=created_at_tolerance_ms, store=store, route=route,
            write_mode=write_mode, dedup=dedup, wire=wire, a2a=a2a, layout=layout,
            probe=probe, walk=walk,
        )
        # the replicas appear on first GLOBAL use: a daemon that routes
        # GLOBAL over the host peer plane never pays for a second table
        self._capacity_per_shard = capacity_per_shard
        self.replica: Optional[List] = None
        self.sync_out = sync_out
        self.pending: List[PendingHits] = [PendingHits() for _ in range(self.n_shards)]
        self.global_stats = GlobalStats()
        self._rr = 0  # rotating home shard of served batches
        # the home counter is the one piece of engine state the pipelined
        # prepare stage touches (prepare threads run concurrently)
        self._rr_lock = threading.Lock()

    def _ensure_global_plane(self) -> None:
        # the reconcile runs the mixed decision over whatever algorithms
        # GLOBAL keys use, so the primary goes full and replicas are full
        self.migrate_layout_full("GLOBAL collective sync needs mixed math")
        if self.replica is None:
            self.replica = new_sharded_table(self.mesh, self._capacity_per_shard)

    def _next_home(self) -> int:
        with self._rr_lock:
            h = self._rr % self.n_shards
            self._rr += 1
            return h

    def has_pending(self) -> bool:
        return any(len(p) for p in self.pending)

    def oldest_pending_age_s(self) -> float:
        """Age of the oldest un-synced GLOBAL hit over every home's outbox."""
        return max((p.age_s() for p in self.pending), default=0.0)

    # ------------------------------------------------------------------ check

    def check(self, requests: Sequence[RateLimitRequest], now_ms: Optional[int] = None,
              home_shard: int = 0) -> List[RateLimitResponse]:
        now = now_ms if now_ms is not None else ms_now()
        glob = [i for i, r in enumerate(requests) if has_behavior(r.behavior, Behavior.GLOBAL)]
        if not glob:
            return super().check(requests, now_ms=now)
        gset = set(glob)
        rest = [i for i in range(len(requests)) if i not in gset]
        out: List[Optional[RateLimitResponse]] = [None] * len(requests)
        if rest:
            for i, r in zip(rest, super().check([requests[i] for i in rest], now_ms=now)):
                out[i] = r
        for i, r in zip(glob, self._check_global([requests[i] for i in glob], now,
                                                 home_shard)):
            out[i] = r
        return out  # type: ignore[return-value]

    def _check_global(self, requests: Sequence[RateLimitRequest], now: int,
                      home: int) -> List[RateLimitResponse]:
        """The GLOBAL dispatch of the object API (the array core is shared
        with check_columns)."""
        hb, errors = pack_requests(requests, now, tolerance_ms=self.created_at_tolerance_ms)
        out: List[Optional[RateLimitResponse]] = [None] * len(requests)
        for i, err in enumerate(errors):
            if err is not None:
                out[i] = RateLimitResponse(error=err)
        status, limit, remaining, reset, dropped = self._global_hb(hb, home, now)
        for i in range(len(requests)):
            if out[i] is None:
                out[i] = RateLimitResponse(
                    status=int(status[i]), limit=int(limit[i]), remaining=int(remaining[i]),
                    reset_time=int(reset[i]), error=ERROR_STRINGS[ERR_DROPPED] if dropped[i] else "",
                )
        self.stats.checks += len(requests)
        return out  # type: ignore[return-value]

    def check_columns(self, cols: RequestColumns,
                      now_ms: Optional[int] = None) -> ResponseColumns:
        """Columns in, columns out, with GLOBAL honored on the mesh: GLOBAL
        rows are answered from a rotating home's replica (non-owner
        semantics, reference gubernator.go:401-429) and their hits queued
        for the sync; every other row takes the owner-routed path."""
        gmask = (np.asarray(cols.behavior) & np.int32(_GLOBAL)) != 0
        if not gmask.any():
            return super().check_columns(cols, now_ms=now_ms)
        now = now_ms if now_ms is not None else ms_now()
        n = cols.fp.shape[0]
        status = np.zeros(n, dtype=np.int32)
        limit = np.zeros(n, dtype=np.int64)
        remaining = np.zeros(n, dtype=np.int64)
        reset = np.zeros(n, dtype=np.int64)
        err = np.zeros(n, dtype=np.int8)
        rest = np.nonzero(~gmask)[0]
        if rest.size:
            rc = super().check_columns(RequestColumns(*[f[rest] for f in cols]), now_ms=now)
            status[rest] = rc.status
            limit[rest] = rc.limit
            remaining[rest] = rc.remaining
            reset[rest] = rc.reset_time
            err[rest] = rc.err
        g = np.nonzero(gmask)[0]
        hb, perr = pack_columns(RequestColumns(*[f[g] for f in cols]), now,
                                tolerance_ms=self.created_at_tolerance_ms)
        err[g] = perr
        g_created = cols.created_at[g]
        self.stats.created_at_clamped += int(((g_created != 0)
                                              & (hb.created_at != g_created)).sum())
        s, l, r, t, dropped = self._global_hb(hb, self._next_home(), now)
        status[g] = s
        limit[g] = l
        remaining[g] = r
        reset[g] = t
        err[g[dropped]] = ERR_DROPPED
        self.stats.checks += int(g.size)
        # the fold over the reassembled order (the split kept row positions)
        _fold_cascades_host(np.asarray(cols.behavior), status, remaining, reset, err)
        return ResponseColumns(status=status, limit=limit, remaining=remaining,
                               reset_time=reset, err=err)

    # ------------------------------------------------- pipelined GLOBAL path
    # The generic prepare / issue / finish split cannot express the GLOBAL
    # fork (replica answers, owner applies, hit queueing), so this engine
    # has its own pending type behind ops/engine.py's hooks: prepare stages
    # the replica, owner and plain dispatches; issue merges the queued hits
    # and launches every dispatch; finish fetches them all at once.

    def _global_fork(self, hb: HostBatch, home: int):
        """The GLOBAL fork, the one place the queue rules live: zero-hit
        requests are never queued (global.go:85-95); owner-side hits queue
        as hits=0 broadcast markers (QueueUpdate → runBroadcasts);
        non-owner hits accumulate for the owner. Non-owner rows answer from
        the home replica with GLOBAL stripped and NO_BATCHING forced
        (reference gubernator.go:416-422); owner rows run the primary."""
        owner = shard_of(hb.fp, self.n_shards)
        is_owner_here = (owner == home) & hb.active
        q = np.nonzero(hb.active & (hb.hits != 0))[0]
        queue = _QueuedHits(
            hb=hb,
            rows=q,
            hits=np.where(is_owner_here[q], 0, hb.hits[q]).astype(np.int64),
            reset=hb.behavior[q] & np.int32(_RESET),
            home=home,
            n_remote=int((~is_owner_here[q]).sum()),
        )
        hb_replica = hb._replace(
            behavior=(hb.behavior & ~np.int32(_GLOBAL)) | np.int32(Behavior.NO_BATCHING),
            active=hb.active & ~is_owner_here,
        )
        hb_owner = hb._replace(active=is_owner_here)
        return is_owner_here, queue, hb_replica, hb_owner

    def _apply_queue(self, qu: _QueuedHits) -> None:
        """Fold prepared queue inputs into the accumulator (engine thread)."""
        if qu.rows.size:
            self.pending[qu.home].merge(qu.hb, qu.rows, qu.hits, qu.reset)
            self.global_stats.hits_queued += qu.n_remote
        self.global_stats.send_queue_length = sum(len(p) for p in self.pending)

    def prepare_columns(self, cols: RequestColumns, now_ms=None):
        """Prepare hook (any thread): a GlobalPending for a batch with
        GLOBAL rows, None to send a plain batch down the generic path."""
        gmask = (np.asarray(cols.behavior) & np.int32(_GLOBAL)) != 0
        if not gmask.any():
            return None
        now = now_ms if now_ms is not None else ms_now()
        hb, err = pack_columns(cols, now, tolerance_ms=self.created_at_tolerance_ms)
        clamped = int(((cols.created_at != 0) & (hb.created_at != cols.created_at)).sum())
        home = self._next_home()
        passes = []

        def plan_into(batch, table_attr, home_pin, rowmap):
            if not batch.active.any():
                return
            for p in self.plan(batch):
                if len(p.rows) == 0:
                    continue
                shard = (np.full(p.batch.fp.shape[0], home_pin, dtype=np.int64)
                         if home_pin is not None else None)
                staged = self._stage(p.batch, shard)
                passes.append([p, len(p.rows), p.batch, staged, table_attr, home_pin, rowmap])

        rest = np.nonzero(~gmask)[0]
        if rest.size:
            plan_into(_subset(hb, rest), "table", None, rest)
        g = np.nonzero(gmask)[0]
        _owner_here, queue, hb_replica, hb_owner = self._global_fork(_subset(hb, g), home)
        plan_into(hb_replica, "replica", home, g)
        plan_into(hb_owner, "table", None, g)
        return GlobalPending(hb=hb, err=err, now=now, queue=queue, passes=passes,
                             clamped=clamped)

    def issue_pending(self, pending: GlobalPending) -> GlobalPending:
        """Issue hook (engine thread): fold the queued hits in, then launch
        every staged dispatch without fetching."""
        self._ensure_global_plane()
        # replica-pinned rows mark a harmless superset (dirty blocks only
        # cost extract bytes); marking here keeps mark → mutate in one job
        self._mark_dirty(pending.hb.fp)
        self._apply_queue(pending.queue)
        for entry in pending.passes:
            staged, table_attr = entry[3], entry[4]
            entry[3] = (staged, self._decide(self._tables(table_attr), staged))
        pending.stacked = _stack_pass_outputs([entry[3][1] for entry in pending.passes])
        return pending

    def finish_pending(self, pending: GlobalPending, fixup):
        """Finish hook (fetch thread): fetch every pass's output at once and
        assemble the response; claim-drop retries run on the engine thread
        through `fixup`, against the same tables, replica pins kept."""
        if pending.stacked is not None:
            fetched = pending.stacked.cpu().numpy()  # ONE fetch for every pass
            for i, entry in enumerate(pending.passes):
                entry[3] = (entry[3][0], fetched[i])
        hb, err = pending.hb, pending.err
        n = hb.fp.shape[0]
        status = np.zeros(n, dtype=np.int32)
        limit_o = np.zeros(n, dtype=np.int64)
        remaining = np.zeros(n, dtype=np.int64)
        reset = np.zeros(n, dtype=np.int64)
        delta = EngineStats(created_at_clamped=pending.clamped, checks=n)
        for p, np_, batch, pend, table_attr, home_pin, rowmap in pending.passes:
            (s, l, r, t, dropped, hit), st, uncounted = self.finish_staged(pend, np_)
            delta.cache_hits += st[0]
            delta.cache_misses += st[1]
            delta.over_limit += st[2]
            delta.evicted_unexpired += st[3]
            delta.dispatches += 1
            if dropped.any():
                rows = np.nonzero(dropped)[0]

                def retry(rows=rows, batch=batch, uncounted=uncounted, table_attr=table_attr,
                          home_pin=home_pin):
                    shard = (np.full(rows.size, home_pin, dtype=np.int64)
                             if home_pin is not None else None)
                    _, vals = self._dispatch(
                        _subset(batch, rows), depth=1, shard=shard, table_attr=table_attr,
                        count=uncounted[rows] if uncounted is not None else None,
                    )
                    return vals

                s2, l2, r2, t2, d2, h2 = fixup(retry)
                s[rows], l[rows], r[rows], t[rows] = s2, l2, r2, t2
                dropped[rows] = d2
                hit[rows] = h2
            if p.member_rows:
                members = rowmap[np.concatenate(p.member_rows)]
                src = np.repeat(np.arange(np_), [len(m) for m in p.member_rows])
                status[members] = s[src]
                limit_o[members] = l[src]
                remaining[members] = r[src]
                reset[members] = t[src]
                err[members[dropped[src]]] = ERR_DROPPED
            else:
                rows_f = rowmap[p.rows]
                status[rows_f] = s[:np_]
                limit_o[rows_f] = l[:np_]
                remaining[rows_f] = r[:np_]
                reset[rows_f] = t[:np_]
                err[rows_f[dropped[:np_]]] = ERR_DROPPED
        # the fork re-orders rows, so no dispatch folded cascades
        _fold_cascades_host(hb.behavior, status, remaining, reset, err)
        rc = ResponseColumns(status=status, limit=limit_o, remaining=remaining,
                             reset_time=reset, err=err)
        return rc, delta

    def _global_hb(self, hb: HostBatch, home: int, now: Optional[int] = None):
        """The GLOBAL core over a packed batch: rows whose owner IS the home
        run the owner path on the primary and queue a broadcast (reference
        getLocalRateLimit + QueueUpdate, gubernator.go:653-690); the rest
        answer from the home replica and queue their hits for the owner
        (getGlobalRateLimit, gubernator.go:401-429). Returns per-row
        response arrays."""
        self._ensure_global_plane()
        n = hb.fp.shape[0]
        is_owner_here, queue, hb2, hb3 = self._global_fork(hb, home)
        self._apply_queue(queue)
        status = np.zeros(n, dtype=np.int32)
        limit = np.zeros(n, dtype=np.int64)
        remaining = np.zeros(n, dtype=np.int64)
        reset = np.zeros(n, dtype=np.int64)
        dropped = np.zeros(n, dtype=bool)
        self._global_passes(hb2, status, limit, remaining, reset, dropped,
                            table_attr="replica", home=home)
        # owner rows run the authoritative path on the primary, with the
        # Store contract honored there (write-through and miss rehydrate,
        # the reference's owner-side getLocalRateLimit)
        self._global_passes(hb3, status, limit, remaining, reset, dropped,
                            table_attr="table", home=None, now=now)
        if self.store is not None and now is not None:
            own = np.nonzero(is_owner_here & ~dropped)[0]
            if own.size:
                self.store.on_change(_store_change_set(
                    hb.fp, now, hb.algo, status, limit, remaining, reset, hb.duration,
                    hb.burst, hb.created_at, own,
                ))
        return status, limit, remaining, reset, dropped

    def _global_passes(self, hb: HostBatch, status, limit, remaining, reset, dropped,
                       table_attr: str, home, now: Optional[int] = None) -> None:
        if not hb.active.any():
            return
        use_store = (table_attr == "table" and home is None and self.store is not None
                     and now is not None)
        for pi, p in enumerate(self.plan(hb)):
            nrows = len(p.rows)
            batch = pad_batch(p.batch, _pad_size(nrows))
            shard = (np.full(batch.fp.shape[0], home, dtype=np.int64)
                     if home is not None else None)
            _, (s, l, r, t, d, _h) = self._dispatch(batch, shard=shard, table_attr=table_attr)
            if pi == 0 and use_store:
                def disp(b, nb):
                    _, vals = self._dispatch(pad_batch(b, _pad_size(nb)), table_attr="table")
                    return vals

                s, l, r, t, d, _h = _rehydrate_misses(self, p.batch, nrows,
                                                      (s, l, r, t, d, _h), now, disp)
            if p.member_rows:
                members = np.concatenate(p.member_rows)
                src = np.repeat(np.arange(nrows), [len(m) for m in p.member_rows])
                status[members] = s[src]
                limit[members] = l[src]
                remaining[members] = r[src]
                reset[members] = t[src]
                dropped[members] = d[src]
            else:
                rows = p.rows
                status[rows] = s[:nrows]
                limit[rows] = l[:nrows]
                remaining[rows] = r[:nrows]
                reset[rows] = t[:nrows]
                dropped[rows] = d[:nrows]

    # ------------------------------------------------------------------- sync

    def sync(self, now_ms: Optional[int] = None) -> None:
        """One sync tick: drain ALL pending hits in as many rounds as the
        fixed outbox needs (the reference flushes its queue and leaves no
        backlog behind a tick, global.go:125-151), at most _SYNC_DRAIN_CAP
        rounds a drain. A tick with nothing pending still runs one round.
        A Store engine drains one round at a time: each round's broadcast
        reaches the host and the Store before the next round runs."""
        first = True
        while first or self.has_pending():
            first = False
            rounds = max((len(p) + self.sync_out - 1) // self.sync_out for p in self.pending)
            if self.store is not None:
                rounds = 1
            self._drain(max(1, min(rounds, self._SYNC_DRAIN_CAP)), now_ms)

    def _build_box(self, d: int, now: int):
        """Pop ≤ sync_out entries of home `d` into one padded outbox.
        Returns (box, popped): `popped` is the (cfg, hits, reset) columns
        taken from the accumulator (None when empty), kept so that a failed
        launch re-merges them instead of losing the hits."""
        OUT = self.sync_out
        k = min(len(self.pending[d]), OUT)
        if k:
            popped = self.pending[d].take(OUT)
            cfg, hits, reset = popped
            # the round mutates owner shards and replicas for these keys
            self._mark_dirty(cfg.fp)
            box = pad_batch(cfg, OUT)
            box.hits[:k] = hits
            box.behavior[:k] |= reset
            box.created_at[:k] = now
            # re-anchor non-Gregorian expiries at the applied-at stamp (the
            # linear rule the compact decode rebuilds); Gregorian rows keep
            # their calendar expiry and force the full-width outbox
            ng = box.greg_interval[:k] == 0
            box.expire_new[:k] = np.where(ng, now + box.duration[:k], box.expire_new[:k])
        else:
            popped = None
            box = pad_batch(HostBatch(*[np.zeros(0, dtype=f.dtype)
                                        for f in pack_requests([], now)[0]]), OUT)
        return box, popped

    def _requeue_popped(self, popped, exc: BaseException) -> None:
        """A sync launch failed after the accumulators were popped: re-merge
        every popped box (`popped`: (home, (cfg, hits, reset)) pairs) so no
        hit is lost, and poison the engine — the tables may hold a partial
        drain, so serving must surface unhealthy."""
        for d, (cfg, hits, reset) in popped:
            self.pending[d].merge(cfg, np.arange(cfg.fp.shape[0]), hits, reset)
        self.global_stats.send_queue_length = sum(len(p) for p in self.pending)
        self.poisoned = f"GLOBAL collective sync launch failed: {exc}"

    def _wire_boxes(self, boxes, now: int) -> bool:
        """Can this drain's outboxes ride the compact wire? All or nothing:
        hot-key hits ≥ 2^18 or Gregorian configs send the drain full-width
        (the same semantics)."""
        if self.wire != "compact":
            return False
        return all(wire_mod.wire_encodable(b, now) for b in boxes)

    def _box_grid(self, boxes, now: int, wire: bool, out: np.ndarray) -> None:
        """Pack D outboxes into `out`: a (D, 5, OUT+1) int32 compact grid or
        a (D, 12, OUT) int64 grid (the kernel2.req_from_arr layout)."""
        for d, b in enumerate(boxes):
            if wire:
                wire_mod.pack_wire_full(b, now, out=out[d])
            else:
                pack_host_batch(b, out=out[d])

    def _drain(self, rounds: int, now_ms: Optional[int]) -> None:
        """Pop `rounds` outboxes per home and run that many collective rounds
        (``sync_round``) with no host read between them; the counters are
        fetched once, at the end. Every box is popped before the first
        launch, and a failed launch re-merges them all (ADVICE.md, round 5).
        The outboxes ship as ONE compact int32 grid when every box is
        representable, else as the full-width int64 grid."""
        self._ensure_global_plane()
        now = now_ms if now_ms is not None else ms_now()
        D, OUT = self.n_shards, self.sync_out
        empty_box = None
        popped = []  # (home, cfg / hits / reset) popped this drain
        boxes = []
        for _r in range(rounds):
            row = []
            for d in range(D):
                if len(self.pending[d]) == 0:
                    if empty_box is None:
                        empty_box, _ = self._build_box(d, now)
                    row.append(empty_box)
                    continue
                b, p = self._build_box(d, now)
                popped.append((d, p))
                row.append(b)
            boxes.append(row)
        wire = self._wire_boxes([b for row in boxes for b in row], now)
        try:
            if wire:
                grid = np.zeros((D, rounds, wire_mod.WIRE_LANES, OUT + 1), dtype=np.int32)
            else:
                grid = np.empty((D, rounds, 12, OUT), dtype=np.int64)
            for r in range(rounds):
                self._box_grid(boxes[r], now, wire, grid[:, r])
            outboxes = self._put_grid(grid)
            counters = None
            # a Store drain is one round (sync): its broadcast goes to the host
            bcs = [] if self.store is not None else None
            for r in range(rounds):
                c = sync_round(self.tables, self.replica, [o[r] for o in outboxes], D,
                               self.write_mode, wire=wire, bc_out=bcs)
                counters = c if counters is None else counters + c
        except Exception as exc:
            self._requeue_popped(popped, exc)
            raise
        c = counters.cpu().numpy()  # the drain's one host read
        self.global_stats.sync_rounds += rounds
        self.global_stats.broadcasts_applied += int(c[:, 0].sum())
        self.global_stats.updates_installed += int(c[:, 1].sum())
        self.global_stats.send_queue_length = sum(len(p) for p in self.pending)
        if bcs:
            self._store_round(bcs, now)

    def _store_round(self, bcs, now: int) -> None:
        """Write one round's owner-reconciled GLOBAL state through to the
        Store (the reference fires OnChange on the owner's GLOBAL apply
        too): the D shards' broadcasts in shard order, active rows only."""
        from gubernator_tpu_torch.store import ChangeSet

        dev = bcs[0].fp.device
        flat = {name: torch.cat([getattr(b, name).to(dev) for b in bcs]).cpu().numpy()
                for name in ("active", "fp", "algo", "status", "limit", "remaining",
                             "reset_time", "duration", "burst", "stamp")}
        rows = np.nonzero(flat["active"])[0]
        if rows.size:
            self.store.on_change(ChangeSet(
                fps=flat["fp"][rows], created_at=now, algo=flat["algo"][rows],
                status=flat["status"][rows].astype(np.int32), limit=flat["limit"][rows],
                remaining=flat["remaining"][rows], reset_time=flat["reset_time"][rows],
                duration=flat["duration"][rows], burst=flat["burst"][rows],
                stamp=flat["stamp"][rows],
            ))

    def _sync_round(self, now_ms: Optional[int] = None) -> None:
        """One collective hit-sync and broadcast round: a drain of one."""
        self._drain(1, now_ms)

    def warm_sync_steps(self, now_ms: Optional[int] = None) -> None:
        """Run one round, building its kernels before traffic needs them; a
        round with empty outboxes applies nothing (the JAX package's name,
        which its daemon calls at start). Engine thread only; the caller
        resets global_stats afterwards."""
        self._drain(1, now_ms)

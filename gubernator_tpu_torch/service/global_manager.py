"""Cross-daemon GLOBAL behavior — async hit sync + owner broadcasts.

The host-side peer plane for GLOBAL rate limits across daemons (reference
global.go:31-307). Complements the in-mesh collective path
(parallel/global_sync.py): inside one TPU slice the sync is two all_gathers
over ICI; ACROSS daemons (slices, regions) it is this manager speaking the
reference's own two-stage protocol over gRPC:

* runAsyncHits analog: non-owner aggregates hits per key (sum Hits, OR
  RESET_REMAINING — reference global.go:109-123) and ships them to owners via
  GetPeerRateLimits every GlobalSyncWait (100 ms) or at GlobalBatchLimit.
* runBroadcasts analog: the owner re-reads each updated key's status with
  Hits=0 and pushes UpdatePeerGlobals to every local peer except itself
  (reference global.go:255-298), bounded by GlobalPeerRequestsConcurrency.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

log = logging.getLogger("gubernator_tpu_torch.global")

from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb
from gubernator_tpu_torch.types import Behavior, has_behavior


def _unimplemented(exc: BaseException) -> bool:
    """Does this (possibly PeerError-wrapped) failure mean the peer does not
    implement the RPC (a pre-compact build)?"""
    import grpc

    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        code = getattr(exc, "code", None)
        if callable(code):
            try:
                if code() == grpc.StatusCode.UNIMPLEMENTED:
                    return True
            except Exception:
                pass
        exc = getattr(exc, "cause", None) or exc.__cause__
    return False


class GlobalManager:
    def __init__(self, daemon):
        self.daemon = daemon
        b = daemon.conf.behaviors
        self.sync_wait_s = b.global_sync_wait_ms / 1e3
        self.batch_limit = b.global_batch_limit
        self.timeout_s = b.global_timeout_ms / 1e3
        self.concurrency = b.global_peer_concurrency
        self.metrics = daemon.metrics
        self.requeue_retries = b.global_requeue_retries
        self.queue_cap = b.global_queue_cap
        # inter-slice compact sync (SyncGlobalsWire): batches ≥ _WIRE_MIN
        # encodable entries ship as ONE lane-codec message instead of N
        # nested RateLimitReq protos (service/wire.sync_wire_pb); smaller
        # or non-encodable batches take the classic proto path
        self.wire_sync = b.global_wire_sync
        # pending hits: hash_key → aggregated RateLimitReq (non-owner side)
        self._hits: Dict[str, pb.RateLimitReq] = {}
        # hash_key → monotonic ts of the key's FIRST un-synced hit; survives
        # requeues (the hit is that old however many sends failed) and is
        # dropped only when the key's hits reach the owner or are dropped.
        # min() over this is the gubernator_global_sync_staleness_seconds
        # gauge — the convergence-lag signal (docs/observability.md).
        self._hit_age: Dict[str, float] = {}
        # requeue accounting: hash_key → failed-send count (bounded retries)
        self._hit_attempts: Dict[str, int] = {}
        # pending broadcasts: hash_key → latest owner-side request (config carrier)
        self._updates: Dict[str, pb.RateLimitReq] = {}
        self._hits_wake = asyncio.Event()
        self._bcast_wake = asyncio.Event()
        self._tasks = []
        self._closed = False

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._hits_loop(), name="global-hits"),
            asyncio.create_task(self._broadcast_loop(), name="global-bcast"),
        ]

    async def close(self) -> None:
        self._closed = True
        self._hits_wake.set()
        self._bcast_wake.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        # final flush so queued hits/updates aren't lost on graceful shutdown
        await self._send_hits()
        await self._broadcast()

    # --------------------------------------------------------------- queueing
    def queue_hit(self, key: str, item: "pb.RateLimitReq") -> None:
        """Non-owner hit on a GLOBAL key (reference global.go:85-123).
        Zero-hit requests are never queued (global.go:85-95)."""
        if item.hits == 0:
            return
        self._hit_age.setdefault(key, time.monotonic())
        agg = self._hits.get(key)
        if agg is None:
            agg = pb.RateLimitReq()
            agg.CopyFrom(item)
            self._hits[key] = agg
        else:
            hits = agg.hits + item.hits
            reset = (agg.behavior | item.behavior) & int(Behavior.RESET_REMAINING)
            agg.CopyFrom(item)  # newest config wins
            agg.hits = hits
            agg.behavior |= reset
        self.metrics.global_queue_length.set(len(self._hits))
        if len(self._hits) >= self.batch_limit:
            self._hits_wake.set()

    def queue_update(self, key: str, item: "pb.RateLimitReq") -> None:
        """Owner-side: mark the key for an authoritative broadcast (reference
        QueueUpdate, global.go:92-99)."""
        self._updates[key] = item
        self.metrics.broadcast_queue_length.set(len(self._updates))
        if len(self._updates) >= self.batch_limit:
            self._bcast_wake.set()

    # ------------------------------------------------------------- hits loop
    async def _hits_loop(self) -> None:
        while not self._closed:
            try:
                await asyncio.wait_for(self._hits_wake.wait(), self.sync_wait_s)
            except asyncio.TimeoutError:
                pass
            self._hits_wake.clear()
            try:
                await self._send_hits()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a failed round must not kill the loop (reference counts and
                # moves on, global.go:190-195)
                log.exception("global hit-sync round failed")

    async def _send_hits(self) -> None:
        if not self._hits:
            return
        batch, self._hits = self._hits, {}
        self.metrics.global_queue_length.set(len(self._hits))
        t0 = time.perf_counter()
        # group by owning peer (reference sendHits, global.go:155-199)
        by_peer: Dict[str, list] = {}  # addr → [(hash_key, item)]
        infos = {}
        for key, item in batch.items():
            try:
                info = self.daemon.get_peer(key)
            except Exception:
                # no peers; drop (eventual consistency tolerates it)
                self._hit_attempts.pop(key, None)
                self._hit_age.pop(key, None)
                continue
            if self.daemon.is_self(info):
                # became owner since queueing; owner path handles it
                self._hit_attempts.pop(key, None)
                self._hit_age.pop(key, None)
                continue
            by_peer.setdefault(info.grpc_address, []).append((key, item))
            infos[info.grpc_address] = info
        sem = asyncio.Semaphore(self.concurrency)

        async def send(addr, pairs):
            client = self.daemon.peer_client(infos[addr])
            if client is None:
                # peer vanished between grouping and send — requeue so the
                # next round re-resolves ownership
                self._requeue(pairs)
                return
            if client.breaker.blocked:
                # fail fast: no RPC (and no timeout wait) toward an open
                # breaker; the batch requeues for the next sync round
                self.metrics.check_error_counter.labels(
                    error="global_send"
                ).inc()
                self._requeue(pairs)
                return
            async with sem:
                try:
                    await self._ship(client, pairs)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # counted + REQUEUED (bounded): brief owner outages no
                    # longer lose replication traffic (the reference drops
                    # on error, global.go:190-195)
                    self.metrics.check_error_counter.labels(
                        error="global_send"
                    ).inc()
                    self._requeue(pairs)
                else:
                    for key, _ in pairs:
                        self._hit_attempts.pop(key, None)
                        self._hit_age.pop(key, None)

        await asyncio.gather(*(send(a, p) for a, p in by_peer.items()))
        if by_peer:
            self.metrics.global_send_duration.observe(time.perf_counter() - t0)

    _WIRE_MIN = 4  # below this the proto path's framing overhead is moot

    async def _ship(self, client, pairs) -> None:
        """One owner-bound batch over the wire: the compact SyncGlobalsWire
        codec when enabled, the batch is big enough to pay off, every entry
        is representable, AND the peer speaks it — the classic
        GetPeerRateLimits proto path otherwise (identical semantics). An
        UNIMPLEMENTED answer latches `wire_sync_ok` off for that peer (a
        pre-compact build) and the batch re-ships as proto in the same
        round, so mixed-version clusters converge without losing a tick."""
        req = None
        if (
            self.wire_sync
            and len(pairs) >= self._WIRE_MIN
            and getattr(client, "wire_sync_ok", True)
        ):
            from gubernator_tpu_torch.service.wire import sync_wire_pb

            req = sync_wire_pb(pairs, self.daemon.conf.advertise_address)
        if req is not None:
            try:
                await client.sync_globals_wire(req, timeout=self.timeout_s)
            except Exception as exc:
                if not _unimplemented(exc):
                    raise
                client.wire_sync_ok = False
            else:
                self.metrics.global_wire_entries.labels(
                    direction="sent"
                ).inc(len(pairs))
                return
        await client.get_peer_rate_limits(
            peers_pb.GetPeerRateLimitsReq(requests=[i for _, i in pairs]),
            timeout=self.timeout_s,
        )
        if self.wire_sync and len(pairs) >= self._WIRE_MIN:
            self.metrics.global_wire_entries.labels(
                direction="fallback"
            ).inc(len(pairs))

    def _requeue(self, pairs) -> None:
        """Re-merge a failed batch into the pending queue, bounded by a
        per-key retry cap and a total queue-size cap (so a long partition
        degrades to the reference's drop behavior instead of growing
        memory without bound)."""
        requeued = dropped = 0
        for key, item in pairs:
            attempts = self._hit_attempts.get(key, 0) + 1
            if attempts > self.requeue_retries or (
                key not in self._hits and len(self._hits) >= self.queue_cap
            ):
                self._hit_attempts.pop(key, None)
                self._hit_age.pop(key, None)
                dropped += 1
                continue
            self._hit_attempts[key] = attempts
            agg = self._hits.get(key)
            if agg is None:
                self._hits[key] = item
            else:
                # fresh hits arrived for the key since the failed send: fold
                # the failed batch back in (same merge rule as queue_hit —
                # newest config wins, hits add, RESET_REMAINING sticks)
                agg.hits += item.hits
                agg.behavior |= item.behavior & int(Behavior.RESET_REMAINING)
            requeued += 1
        if requeued:
            self.metrics.global_requeued.inc(requeued)
        if dropped:
            self.metrics.global_requeue_dropped.inc(dropped)
        self.metrics.global_queue_length.set(len(self._hits))

    # ----------------------------------------------------------- introspection
    def oldest_hit_age_s(self) -> float:
        """Age of the oldest GLOBAL hit not yet acked by its owner (0 when
        nothing is pending) — queued AND in-flight/requeued keys count; a
        hit is only "synced" once an owner send succeeded."""
        if not self._hit_age:
            return 0.0
        return max(0.0, time.monotonic() - min(self._hit_age.values()))

    def debug(self) -> dict:
        """Live GLOBAL-plane state for /v1/debug/global."""
        return {
            "pending_hits": len(self._hits),
            "pending_updates": len(self._updates),
            "unsynced_keys": len(self._hit_age),
            "requeue_attempts": len(self._hit_attempts),
            "oldest_hit_age_s": round(self.oldest_hit_age_s(), 3),
            "sync_wait_ms": self.sync_wait_s * 1e3,
            "batch_limit": self.batch_limit,
            "wire_sync": self.wire_sync,
        }

    # -------------------------------------------------------- broadcast loop
    async def _broadcast_loop(self) -> None:
        while not self._closed:
            try:
                await asyncio.wait_for(self._bcast_wake.wait(), self.sync_wait_s)
            except asyncio.TimeoutError:
                pass
            self._bcast_wake.clear()
            try:
                await self._broadcast()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("global broadcast round failed")

    async def _broadcast(self) -> None:
        if not self._updates:
            return
        batch, self._updates = self._updates, {}
        self.metrics.broadcast_queue_length.set(0)
        t0 = time.perf_counter()
        # re-read each key's current status with Hits=0 (reference
        # global.go:255-262) — a zero-hit check is the authoritative read
        import numpy as np

        from gubernator_tpu_torch.service.wire import columns_from_pb

        reads = []
        for key, item in batch.items():
            r = pb.RateLimitReq()
            r.CopyFrom(item)
            r.hits = 0
            r.behavior &= ~int(Behavior.GLOBAL)  # local read, not re-queued
            reads.append(r)
        cols, _ = columns_from_pb(reads)
        rc = await self.daemon.runner.check_columns(cols)
        # sliding-window fidelity: the wire's (status, remaining)
        # alone cannot rebuild a window — replicas need the previous-window
        # count and the STORED-style remaining to interpolate the same
        # `used` as the owner. Read the owner's stored slots for the
        # window keys once per broadcast and ride them as status metadata
        # (the frozen proto schema has no field; old receivers ignore it —
        # mixed-version clusters degrade to the legacy permissive rebuild).
        win_meta: dict = {}
        win_rows = [
            i for i, (_k, it) in enumerate(batch.items())
            if it.algorithm == int(pb.SLIDING_WINDOW)
        ]
        if win_rows:
            import numpy as np

            from gubernator_tpu_torch.ops.table2 import (
                LIMIT, REM_I, REMF_HI, REMF_LO,
            )

            found, slots = await self.daemon.runner.read_state(
                np.asarray(cols.fp)[win_rows]
            )
            for j, i in enumerate(win_rows):
                if not found[j]:
                    continue
                prev = (int(slots[j, REMF_HI]) << 32) | (
                    int(slots[j, REMF_LO]) & 0xFFFFFFFF
                )
                rem_store = int(slots[j, REM_I])
                win_meta[i] = (prev, rem_store)
        globals_ = []
        for i, (key, item) in enumerate(batch.items()):
            status = pb.RateLimitResp(
                status=int(rc.status[i]),
                limit=int(rc.limit[i]),
                remaining=int(rc.remaining[i]),
                reset_time=int(rc.reset_time[i]),
            )
            if i in win_meta:
                prev, rem_store = win_meta[i]
                status.metadata["w_prev"] = str(prev)
                status.metadata["w_rem"] = str(rem_store)
            globals_.append(
                peers_pb.UpdatePeerGlobal(
                    key=key,
                    status=status,
                    algorithm=item.algorithm,
                    duration=item.duration,
                    created_at=item.created_at or self.daemon.now_ms(),
                )
            )
        req = peers_pb.UpdatePeerGlobalsReq(globals=globals_)
        peers = [p for p in self.daemon.local_peers() if not self.daemon.is_self(p)]
        sem = asyncio.Semaphore(self.concurrency)

        async def push(info):
            client = self.daemon.peer_client(info)
            if client is None:
                return
            if client.breaker.blocked:
                # skip (no RPC) — broadcasts are not requeued: every owner
                # update re-reads authoritative state, so the next round
                # after the breaker closes refreshes this peer anyway
                self.metrics.check_error_counter.labels(
                    error="broadcast"
                ).inc()
                return
            async with sem:
                try:
                    await client.update_peer_globals(req, timeout=self.timeout_s)
                    self.metrics.broadcast_counter.labels(condition="broadcast").inc()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    self.metrics.check_error_counter.labels(
                        error="broadcast"
                    ).inc()

        await asyncio.gather(*(push(p) for p in peers))
        self.metrics.broadcast_duration.observe(time.perf_counter() - t0)

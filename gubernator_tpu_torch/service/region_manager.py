"""MULTI_REGION behavior — active-active cross-region replication (the
port of ``gubernator_tpu/service/region_manager.py``).

The reference declares MULTI_REGION (gubernator.proto:131-134) and builds the
per-region machinery (RegionPicker rings + a request queue,
region_picker.go:19-103) but ships no cross-region push loop; its README
marks the behavior "not fully implemented". This module is the push loop,
rebuilt the way the GLOBAL inter-slice sync works (docs/robustness.md
"Multi-region active-active"):

* every region serves every decision LOCALLY at full speed — replication is
  asynchronous and never sits on the serving path;
* the key's in-region owner aggregates its MULTI_REGION hits per key (sum
  Hits, newest config wins) into one pending queue PER DESTINATION REGION,
  and every sync tick ships each region's queue to the key's owner in that
  region (RegionPicker rings);
* encodable batches ride the compact ``SyncRegionsWire`` codec — per-key hit
  deltas + config lanes + the sender's own stored slot rows — and the
  receiver reconciles through ``kernel2.merge2`` via ``engine.merge_rows``
  (ops/reconcile.py), NEVER the serving path: replication is convergent and
  can only under-grant, by the same pinned conservatism that covers
  checkpoint replay and handoff. Non-encodable items (resets, Gregorian,
  lease releases, metadata carriers) and pre-upgrade peers fall back per
  item to the classic GetPeerRateLimits proto path with MULTI_REGION
  stripped and DRAIN_OVER_LIMIT forced (the legacy semantics — and still no
  ping-pong: the stripped copy is not re-replicated by the receiver);
* the plane is partition-tolerant: every send is gated by the destination
  peer's circuit breaker (fail fast, no timeout stacking), failed batches
  REQUEUE bounded by GUBER_REGION_REQUEUE_RETRIES / GUBER_REGION_QUEUE_CAP
  (mirroring the GLOBAL requeue) instead of the reference's
  count-and-drop, and a partitioned region keeps serving degraded-local with
  over-admission bounded by the sum of its unreplicated deltas. After heal
  the requeued backlog drains through the merge and regions reconverge to
  the exact union of hits.

Cascade requests span regions too: a MULTI_REGION cascade carrier
queues its own delta AND one delta per cascade level (each under the level's
own key), so every level's count converges across regions — the
GLOBAL-behavior cascade semantics extended to the region plane.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

import numpy as np

from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb
from gubernator_tpu_torch.service.global_manager import _unimplemented
from gubernator_tpu_torch.types import Behavior

log = logging.getLogger("gubernator_tpu_torch.region")

# behavior bits a replicated cascade level inherits from its carrier —
# the client-facing flags minus GREGORIAN (level durations are always ms,
# service/wire._CASCADE_INHERIT) and minus GLOBAL (the level's region copy
# must not ALSO enter the receiver's GLOBAL queues)
_LEVEL_INHERIT = int(
    Behavior.NO_BATCHING
    | Behavior.MULTI_REGION
    | Behavior.DRAIN_OVER_LIMIT
)


class RegionManager:
    def __init__(self, daemon):
        self.daemon = daemon
        b = daemon.conf.behaviors
        self.sync_wait_s = (
            b.region_sync_wait_ms or b.global_sync_wait_ms
        ) / 1e3
        self.batch_limit = b.global_batch_limit
        # replication sends get a deliberately generous deadline (derived
        # max(global_timeout, 2 s) unless GUBER_REGION_TIMEOUT overrides):
        # nothing user-facing waits on this plane, and a deadline that
        # cancels the receiver mid-merge turns one slow round into a
        # duplicate delivery on retry — under-granting, but needless
        self.timeout_s = (
            b.region_timeout_ms or max(b.global_timeout_ms, 2_000.0)
        ) / 1e3
        self.concurrency = b.global_peer_concurrency
        self.requeue_retries = b.region_requeue_retries
        self.queue_cap = b.region_queue_cap
        self.wire_sync = b.region_wire_sync
        self.metrics = daemon.metrics
        # destination region (data_center) → hash_key → aggregated item.
        # Fanning out at QUEUE time (not send time) keeps per-region
        # delivery independent: a partition toward one region must not
        # stall or re-send another region's already-acked deltas.
        self._pending: Dict[str, Dict[str, pb.RateLimitReq]] = {}
        # dc → hash_key → monotonic ts of the key's FIRST un-replicated
        # hit; survives requeues and is cleared only when the key's deltas
        # reach that region's owner (or are dropped). min() over every
        # region is the gubernator_region_sync_staleness_seconds gauge.
        self._age: Dict[str, Dict[str, float]] = {}
        # dc → hash_key → failed-send count (bounded retries)
        self._attempts: Dict[str, Dict[str, int]] = {}
        # dc → monotonic ts of the last successful send (debug plane)
        self.last_sync: Dict[str, float] = {}
        # dc → keys whose bootstrap detail (strings + sender slot row)
        # already reached that region: steady-state deltas for them ship
        # as pure 32 B lane+hits entries. Cleared wholesale at the cap —
        # re-shipping detail is merely bytes, never wrong.
        self._shipped: Dict[str, set] = {}
        # dc → hash_key → CUMULATIVE hits ever queued toward that region
        # (incremented at queue time ONLY — a requeue re-merges already-
        # counted hits). Shipped alongside each delta so the receiver's
        # per-source ledger skips re-shipped batches after a lost ack
        # EXACTLY (ops/reconcile.dedup_source_deltas). Cleared wholesale
        # at the cap: the receiver sees the counter go backwards and falls
        # back to the legacy under-grant rule for one round, never over.
        self._cum: Dict[str, Dict[str, int]] = {}
        # source address → fp → highest cumulative counter already MERGED
        # on this daemon (the RECEIVE half; committed only after the merge
        # lands so a cancelled apply is re-appliable)
        self._recv_cum: Dict[str, Dict[int, int]] = {}
        self.dedup_skipped = 0  # duplicate hits skipped exactly (receive)
        # lifetime path counters (debug plane; prometheus carries the same)
        self.wire_sent = 0
        self.wire_fallback = 0
        self.wire_recv = 0
        self.rows_merged = 0
        self._wake = asyncio.Event()
        self._task = None
        self._closed = False

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="region-hits")

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self._send()

    # --------------------------------------------------------------- queueing
    def queue_hit(self, key: str, item: "pb.RateLimitReq") -> None:
        """Owner-side MULTI_REGION hit to replicate across DCs. Cascade
        carriers additionally queue one delta per level (module docstring).
        Zero-hit requests replicate nothing — reads are local."""
        if item.hits == 0:
            return
        dcs = [
            dc for dc, ring in self.daemon._region_picker.pickers().items()
            if ring.size() > 0
        ]
        if not dcs:
            return
        now_ms = self.daemon.now_ms()
        entries = []
        rep = pb.RateLimitReq()
        rep.CopyFrom(item)
        if len(rep.cascade):
            # the carrier replicates WITHOUT its levels (they queue as
            # their own keys below) — otherwise the proto fallback would
            # re-expand the cascade at the receiver and consume every
            # level a second time
            rep.ClearField("cascade")
        if not rep.HasField("created_at"):
            # stamp at queue time: the compact codec needs the hit's
            # instant, and "now" IS when these hits happened
            rep.created_at = now_ms
        entries.append((key, rep))
        inherit = item.behavior & _LEVEL_INHERIT
        for lvl in item.cascade:
            if lvl.name == "" or lvl.unique_key == "":
                continue
            entries.append((
                lvl.name + "_" + lvl.unique_key,
                pb.RateLimitReq(
                    name=lvl.name,
                    unique_key=lvl.unique_key,
                    hits=item.hits,
                    limit=lvl.limit,
                    burst=lvl.burst,
                    duration=lvl.duration,
                    algorithm=lvl.algorithm,
                    behavior=inherit,
                    created_at=rep.created_at,
                ),
            ))
        t = time.monotonic()
        for dc in dcs:
            pend = self._pending.setdefault(dc, {})
            ages = self._age.setdefault(dc, {})
            cum = self._cum.setdefault(dc, {})
            for k, it in entries:
                if it.hits > 0:
                    if len(cum) >= self._SHIPPED_CAP and k not in cum:
                        cum.clear()
                    cum[k] = cum.get(k, 0) + int(it.hits)
                ages.setdefault(k, t)
                agg = pend.get(k)
                if agg is None:
                    agg = pb.RateLimitReq()
                    agg.CopyFrom(it)
                    pend[k] = agg
                else:
                    hits = agg.hits + it.hits
                    reset = (agg.behavior | it.behavior) & int(
                        Behavior.RESET_REMAINING
                    )
                    agg.CopyFrom(it)  # newest config wins
                    agg.hits = hits
                    agg.behavior |= reset
        total = self._queue_len()
        self.metrics.region_queue_length.set(total)
        if total >= self.batch_limit:
            self._wake.set()

    def _queue_len(self) -> int:
        return sum(len(p) for p in self._pending.values())

    # -------------------------------------------------------------- sync loop
    async def _loop(self) -> None:
        while not self._closed:
            try:
                await asyncio.wait_for(self._wake.wait(), self.sync_wait_s)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            try:
                await self._send()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("multi-region sync round failed")

    async def _send(self) -> None:
        if not any(self._pending.values()):
            return
        t0 = time.perf_counter()
        sem = asyncio.Semaphore(self.concurrency)
        tasks = []
        for dc in list(self._pending.keys()):
            batch = self._pending.get(dc)
            if not batch:
                continue
            self._pending[dc] = {}
            ring = self.daemon._region_picker.pickers().get(dc)
            if ring is None or ring.size() == 0:
                # the region left the peer set: its deltas have nowhere to
                # go (eventual consistency tolerates the loss, like the
                # reference's no-peers drop)
                for k in batch:
                    self._clear_key(dc, k)
                continue
            by_addr: Dict[str, list] = {}
            infos = {}
            for k, it in batch.items():
                try:
                    info = ring.get(k)
                except Exception:
                    self._clear_key(dc, k)
                    continue
                by_addr.setdefault(info.grpc_address, []).append((k, it))
                infos[info.grpc_address] = info
            for addr, pairs in by_addr.items():
                tasks.append(self._send_peer(dc, infos[addr], pairs, sem))
        if tasks:
            await asyncio.gather(*tasks)
            self.metrics.global_send_duration.observe(
                time.perf_counter() - t0
            )
        self.metrics.region_queue_length.set(self._queue_len())

    async def _send_peer(self, dc: str, info, pairs, sem) -> None:
        client = self.daemon.peer_client(info)
        if client is None or client.breaker.blocked:
            # fail fast: no RPC (and no timeout wait) toward a missing
            # client or an open breaker; the batch requeues bounded
            self.metrics.check_error_counter.labels(
                error="region_send"
            ).inc()
            self._requeue(dc, pairs)
            return
        async with sem:
            try:
                await self._ship(dc, client, pairs)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.metrics.check_error_counter.labels(
                    error="region_send"
                ).inc()
                self._requeue(dc, pairs)
            else:
                for k, _ in pairs:
                    self._clear_key(dc, k)
                self.last_sync[dc] = time.monotonic()

    _SHIPPED_CAP = 1 << 20  # per-region bootstrap-ledger bound

    async def _ship(self, dc: str, client, pairs) -> None:
        """One region-owner-bound batch: the compact SyncRegionsWire merge
        codec for every encodable item (per-item split — one exotic item
        never forces the batch off the merge path), the classic proto
        fallback for the rest. A key's FIRST batch to a region carries the
        bootstrap detail (strings + the sender's stored slot row in its
        native layout); steady-state deltas ship as pure 32 B lane+hits
        entries merged by fingerprint. An UNIMPLEMENTED answer latches
        `region_wire_ok` off for that peer (a pre-region-merge build) and
        the whole batch re-ships as proto in the same round. A failure
        ANYWHERE raises and the caller requeues the full batch — a batch
        whose wire half already landed then re-applies it, which the merge
        turns into under-grant, never over."""
        from gubernator_tpu_torch.service.wire import (
            split_region_encodable,
            sync_regions_pb,
        )

        enc: list = []
        fb = list(pairs)
        if self.wire_sync and getattr(client, "region_wire_ok", True):
            enc, fb = split_region_encodable(pairs)
        if enc:
            from gubernator_tpu_torch.hashing import fingerprint

            shipped = self._shipped.setdefault(dc, set())
            detail = np.fromiter(
                (k not in shipped for k, _ in enc), dtype=bool,
                count=len(enc),
            )
            slots = layout = None
            if detail.any():
                fps = np.fromiter(
                    (fingerprint(it.name, it.unique_key)
                     for _k, it in enc),
                    dtype=np.int64, count=len(enc),
                )
                # the sender's own stored rows for first-shipped keys, in
                # the table's native layout (zero rows for keys already
                # evicted): the receiver bootstraps keys it has never
                # seen from them — gathered as ONE engine job
                _found, got, layout = (
                    await self.daemon.runner.read_state_raw(fps[detail])
                )
                slots = np.zeros((len(enc), layout.F), dtype=np.int32)
                slots[detail] = got
            # per-key cumulative counters ride every batch: the receiver's
            # per-source ledger turns a re-shipped batch (lost ack +
            # requeue) into an EXACT skip instead of an under-grant
            cum = self._cum.get(dc, {})
            cums = np.fromiter(
                (cum.get(k, 0) for k, _ in enc), dtype=np.int64,
                count=len(enc),
            )
            req = sync_regions_pb(
                enc,
                self.daemon.conf.advertise_address,
                self.daemon.conf.data_center,
                slots,
                layout,
                detail_rows=detail,
                cums=cums,
            )
            try:
                await client.sync_regions_wire(req, timeout=self.timeout_s)
            except Exception as exc:
                if not _unimplemented(exc):
                    raise
                client.region_wire_ok = False
                fb = list(pairs)  # re-ship everything classic, same round
            else:
                self.wire_sent += len(enc)
                self.metrics.region_wire_entries.labels(
                    direction="sent"
                ).inc(len(enc))
                shipped.update(k for k, _ in enc)
                if len(shipped) > self._SHIPPED_CAP:
                    shipped.clear()
        if fb:
            items = [self._fallback_item(it) for _k, it in fb]
            await client.get_peer_rate_limits(
                peers_pb.GetPeerRateLimitsReq(requests=items),
                timeout=self.timeout_s,
            )
            self.wire_fallback += len(fb)
            self.metrics.region_wire_entries.labels(
                direction="fallback"
            ).inc(len(fb))

    @staticmethod
    def _fallback_item(item: "pb.RateLimitReq") -> "pb.RateLimitReq":
        """The legacy replication transform (mirror of the GLOBAL owner
        rule, gubernator.go:526-532): MULTI_REGION stripped so the
        receiving owner applies locally and does NOT re-replicate (which
        would ping-pong hits between DCs forever), DRAIN_OVER_LIMIT forced
        so the remote hits always drain the replica bucket."""
        rep = pb.RateLimitReq()
        rep.CopyFrom(item)
        rep.behavior = (
            rep.behavior & ~int(Behavior.MULTI_REGION)
        ) | int(Behavior.DRAIN_OVER_LIMIT)
        return rep

    def _requeue(self, dc: str, pairs) -> None:
        """Re-merge a failed region batch into that region's pending queue,
        bounded by a per-key retry cap and a per-region queue cap — a
        partition longer than retries × sync_wait degrades to the
        reference's drop behavior instead of growing memory without bound
        (dropped deltas are counted AND widen the documented over-admission
        bound; size the knobs to the partitions you want to ride out)."""
        pend = self._pending.setdefault(dc, {})
        att = self._attempts.setdefault(dc, {})
        ages = self._age.setdefault(dc, {})
        requeued = dropped = 0
        for key, item in pairs:
            attempts = att.get(key, 0) + 1
            if attempts > self.requeue_retries or (
                key not in pend and len(pend) >= self.queue_cap
            ):
                att.pop(key, None)
                ages.pop(key, None)
                dropped += 1
                continue
            att[key] = attempts
            agg = pend.get(key)
            if agg is None:
                pend[key] = item
            else:
                # fresh hits arrived for the key since the failed send:
                # fold the failed batch back in (hits add, newest config —
                # already in `agg` — stays, RESET_REMAINING sticks)
                agg.hits += item.hits
                agg.behavior |= item.behavior & int(Behavior.RESET_REMAINING)
            requeued += 1
        if requeued:
            self.metrics.region_requeued.inc(requeued)
        if dropped:
            self.metrics.region_requeue_dropped.inc(dropped)
        self.metrics.region_queue_length.set(self._queue_len())

    def _clear_key(self, dc: str, key: str) -> None:
        a = self._attempts.get(dc)
        if a is not None:
            a.pop(key, None)
        g = self._age.get(dc)
        if g is not None:
            g.pop(key, None)

    # ----------------------------------------------------------- introspection
    def oldest_delta_age_s(self) -> float:
        """Age of the oldest MULTI_REGION hit delta not yet acked by every
        remote region's owner (0 when nothing is pending) — queued AND
        in-flight/requeued keys count; a delta is only "replicated" once
        its region's owner send succeeded. The region-plane analog of
        GlobalManager.oldest_hit_age_s."""
        oldest: Optional[float] = None
        for ages in self._age.values():
            if ages:
                m = min(ages.values())
                oldest = m if oldest is None else min(oldest, m)
        if oldest is None:
            return 0.0
        return max(0.0, time.monotonic() - oldest)

    def dedup_recv(self, source: str, fps, deltas, cums):
        """Receive-side exact dedup (ops/reconcile.dedup_source_deltas):
        returns (effective_deltas, commit). The caller applies the
        effective deltas through the merge and calls `commit()` ONLY after
        the merge landed — so a cancelled/failed apply leaves the ledger
        untouched and the sender's retry re-applies in full."""
        from gubernator_tpu_torch.ops.reconcile import (
            commit_source_cums,
            dedup_source_deltas,
        )

        ledger = self._recv_cum.setdefault(source, {})
        eff = dedup_source_deltas(ledger, fps, deltas, cums)
        skipped = int(
            (np.asarray(deltas, dtype=np.int64) - eff).sum()
        ) if cums is not None else 0

        def commit():
            commit_source_cums(ledger, fps, cums)
            if skipped > 0:
                self.dedup_skipped += skipped
                self.metrics.region_dedup_skipped.inc(skipped)

        return eff, commit

    def note_recv(self, n_entries: int, n_merged: int) -> None:
        """Receive-side accounting (daemon.sync_regions_wire)."""
        self.wire_recv += n_entries
        self.rows_merged += n_merged
        self.metrics.region_wire_entries.labels(direction="recv").inc(
            n_entries
        )
        self.metrics.region_rows_merged.inc(n_merged)

    def debug(self) -> dict:
        """Live region-plane state for /v1/debug/regions."""
        now = time.monotonic()
        pickers = self.daemon._region_picker.pickers()
        regions = {}
        for dc in sorted(set(self._pending) | set(pickers)):
            ring = pickers.get(dc)
            peers = []
            for p in (ring.peers() if ring is not None else []):
                c = self.daemon.peer_client(p)
                peers.append({
                    "address": p.grpc_address,
                    "breaker_state": (
                        c.breaker.state_name if c is not None else None
                    ),
                    "region_wire_ok": (
                        getattr(c, "region_wire_ok", True)
                        if c is not None else None
                    ),
                })
            ages = self._age.get(dc) or {}
            regions[dc] = {
                "queue_depth": len(self._pending.get(dc) or {}),
                "unreplicated_keys": len(ages),
                "oldest_delta_age_s": (
                    round(now - min(ages.values()), 3) if ages else 0.0
                ),
                "last_sync_age_s": (
                    round(now - self.last_sync[dc], 3)
                    if dc in self.last_sync else None
                ),
                "requeue_attempts": len(self._attempts.get(dc) or {}),
                "peers": peers,
            }
        return {
            "region": self.daemon.conf.data_center,
            "staleness_s": round(self.oldest_delta_age_s(), 3),
            "sync_wait_ms": self.sync_wait_s * 1e3,
            "wire_sync": self.wire_sync,
            "requeue_retries": self.requeue_retries,
            "queue_cap": self.queue_cap,
            "wire": {
                "sent": self.wire_sent,
                "recv": self.wire_recv,
                "fallback": self.wire_fallback,
                "rows_merged": self.rows_merged,
                # duplicate hits skipped EXACTLY by the per-source
                # cumulative-counter ledger (re-shipped batches after a
                # lost ack) — nonzero means retries happened AND exactness
                # held instead of degrading to under-grant
                "dedup_skipped_hits": self.dedup_skipped,
            },
            "regions": regions,
        }

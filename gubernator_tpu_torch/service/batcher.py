"""Front-door request coalescing — the multi-worker adaptive batch window.

The reference's defining serving mechanic: requests arriving within a 500 µs
window (up to a batch limit) coalesce into one batch (reference
peer_client.go:289-344 does this toward peers; config.go:138-140 sets the
window). Here the same window feeds the DEVICE: concurrent GetRateLimits
handlers enqueue column slices (or pre-parsed wire batches), and N flush
workers pull coalesced chunks off a bounded ring into the single engine
thread's prepare/issue/finish pipeline — one TPU batch instead of one
channel message per item.

Three serving-plane mechanics live here (docs/latency.md "Serving plane"):

* **Bounded ring.** Enqueues append to a deque capped at `max_queue_rows`;
  past the cap, callers await drain progress (backpressure) instead of
  growing an unbounded queue whose tail latency nobody sees until OOM.
* **N workers.** Each worker forms a chunk, dispatches it, and slices the
  coalesced response back onto its callers' futures — so chunk formation
  and response fan-out for dispatch K run in parallel with dispatch K+1's,
  keeping the engine's depth-N pipeline saturated instead of starving it
  behind one event-loop task.
* **Adaptive window.** Under load the window closes on accumulated
  rows/bytes (engine-sized dispatches), not a wall-clock tick; when the
  engine is idle the window closes immediately (light load pays no
  batching latency). `batch_wait_ms` remains the hard ceiling.

* **Overload plane** (docs/robustness.md "Overload & QoS"). Armed by
  `GUBER_OVERLOAD_DEADLINE_MS` (a ms value, or `auto` to derive the
  deadline from the engine's issue-stage EWMA — OVERLOAD_AUTO_DEADLINE_MULT
  below) or an inbound gRPC deadline; each enqueue carries a deadline and a
  priority tier (types.PRIORITY_SHIFT behavior bits). A full ring or a
  hopeless queue-wait estimate sheds the LOWEST tier first with a fast
  per-item OVER_LIMIT-style overload row (ops/batch.ERR_OVERLOAD) instead
  of queueing work whose answer nobody will wait for; a higher-tier arrival
  preempts queued lower-tier entries rather than being shed itself, which
  makes priority inversions zero by construction. Per-tenant fair admission
  (fingerprint buckets) caps any one tenant at its share of the window once
  the queue is under pressure. The admission estimate and fairness shares
  are COST-weighted (_payload_cost: cascade levels and lease rows dispatch
  more device work per row), so an expensive tenant cannot starve cheap
  traffic by staying under a raw row budget. With the knob unset and no
  inbound deadline, behavior is exactly the legacy unbounded backpressure.

NO_BATCHING items bypass the window (reference peer_client.go:126-162's fast
path) by calling the runner directly.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from gubernator_tpu_torch import tracing
from gubernator_tpu_torch.ops.batch import (
    ERR_OVERLOAD,
    RequestColumns,
    ResponseColumns,
)
from gubernator_tpu_torch.ops.engine import ms_now
from gubernator_tpu_torch.service import deadline as deadline_mod
from gubernator_tpu_torch.service.wire import WireBatch, concat_columns
from gubernator_tpu_torch.types import (
    CASCADE_LEVEL_MASK,
    CASCADE_LEVEL_SHIFT,
    PRIORITY_MASK,
    PRIORITY_SHIFT,
    Algorithm,
)

# device batches coalesce far beyond the reference's 1000-item RPC cap — the
# kernel's throughput comes from large batches; this caps one dispatch.
DEFAULT_COALESCE_LIMIT = 16384

# GUBER_OVERLOAD_DEADLINE_MS=auto: the per-item deadline is this multiple of
# the engine's issue-stage EWMA (runner.issue_ewma, the device-launch half of
# a dispatch), floored at shed_retry_ms. 200 launches of queue-wait headroom
# ≈ tens of ms on CPU loopback / low ms on TPU — deep enough that the door
# only closes under genuine backlog, shallow enough that a doomed caller gets
# its overload verdict while a retry is still useful (docs/robustness.md
# "Overload & QoS").
OVERLOAD_AUTO_DEADLINE_MULT = 200


def _payload_rows(payload) -> int:
    return (
        payload.rows
        if isinstance(payload, WireBatch)
        else payload.fp.shape[0]
    )


def _payload_cols(payload) -> RequestColumns:
    return payload.cols if isinstance(payload, WireBatch) else payload


def _payload_tier(payload) -> int:
    """The enqueue's priority tier: the MAX tier among its rows — a batch
    carrying any high-priority row is protected as a whole (shedding is
    per-enqueue; one RPC's batch shares one future)."""
    beh = _payload_cols(payload).behavior
    if beh.shape[0] == 0:
        return 0
    return int(((beh.astype(np.int64) >> PRIORITY_SHIFT) & PRIORITY_MASK).max())


def _payload_cost(payload) -> int:
    """The enqueue's dispatch cost in row-equivalents: 1 per row, plus the
    row's cascade depth (every extra level walks its own kernel row) and a
    +1 surcharge for concurrency-lease rows (lease acquire/renew carries
    install/reclaim work a plain bucket row doesn't). The overload door's
    admission estimate and fairness shares are denominated in this, not raw
    row count — a cascade-heavy tenant consumes its share proportionally to
    the device work it dispatches. For plain single-level traffic cost ==
    rows, so uniform workloads see exactly the legacy row-weighted door."""
    cols = _payload_cols(payload)
    if cols.fp.shape[0] == 0:
        return 0
    beh = cols.behavior.astype(np.int64)
    casc = (beh >> CASCADE_LEVEL_SHIFT) & CASCADE_LEVEL_MASK
    lease = (cols.algo == int(Algorithm.CONCURRENCY_LEASE)).astype(np.int64)
    return int((1 + casc + lease).sum())


def _payload_bucket(payload, buckets: int) -> int:
    """The enqueue's tenant bucket: its first row's fingerprint folded into
    `buckets` — key fingerprints are name+key hashes, so a tenant's
    namespace lands in a stable bucket without a host-side tenant table."""
    fp = _payload_cols(payload).fp
    if fp.shape[0] == 0:
        return 0
    return int(fp[0]) & (buckets - 1)


class _Entry:
    """One enqueued batch awaiting dispatch."""

    __slots__ = ("payload", "fut", "t_enq", "span", "rows", "cost", "tier",
                 "bucket", "deadline")

    def __init__(self, payload, fut, t_enq, span, rows, cost, tier, bucket,
                 deadline):
        self.payload = payload
        self.fut = fut
        self.t_enq = t_enq  # perf_counter at enqueue
        self.span = span
        self.rows = rows
        self.cost = cost  # row-equivalents (_payload_cost)
        self.tier = tier  # 0 (best-effort) .. 3 (shed last)
        self.bucket = bucket  # tenant fingerprint bucket
        self.deadline = deadline  # absolute monotonic instant, or None


class Batcher:
    """Coalesce concurrent column/wire batches into single engine dispatches.

    `workers` long-lived flush tasks (the runBatch goroutine analog,
    peer_client.go:289-344, N-way) wake on enqueue, wait out the adaptive
    batch window, and each flushes + fans out one chunk at a time. Items
    enqueued while every worker's dispatch is in flight keep coalescing —
    backpressure produces FEWER, LARGER dispatches instead of a queue of
    tiny ones. FIFO chunk formation preserves each request's contiguous
    slice of the coalesced response."""

    def __init__(
        self,
        runner,
        batch_wait_ms: float = 0.5,
        coalesce_limit: int = DEFAULT_COALESCE_LIMIT,
        metrics=None,
        max_inflight: int = 4,
        workers: int = 0,
        adaptive: bool = True,
        close_rows: int = 0,
        close_bytes: int = 1 << 20,
        max_queue_rows: int = 0,
        ring=None,
        overload_deadline_ms: float = 0.0,
        overload_deadline_auto: bool = False,
        tenant_share: float = 0.5,
        tenant_buckets: int = 64,
        shed_retry_ms: int = 25,
    ):
        self.runner = runner
        # device-resident request ring (service/ring.py): when armed,
        # all-wire chunks are staged into ring slots and consumed by the
        # persistent serving loop instead of paying a fresh dispatch
        # round-trip per flush; None = the direct path
        self.ring = ring
        self.batch_wait_s = batch_wait_ms / 1e3
        self.coalesce_limit = coalesce_limit
        self.metrics = metrics
        # worker count IS the dispatch concurrency cap: each worker runs one
        # dispatch at a time, so `workers` replaces the old in-flight
        # semaphore. Sized to the engine pipeline depth unless overridden.
        self.workers = workers if workers > 0 else max(1, max_inflight)
        self.adaptive = adaptive
        # adaptive close thresholds: rows defaults to one engine-sized
        # dispatch, bytes bounds parse-heavy wire traffic
        self.close_rows = close_rows if close_rows > 0 else coalesce_limit
        self.close_bytes = close_bytes
        self.max_queue_rows = (
            max_queue_rows if max_queue_rows > 0 else coalesce_limit * 8
        )
        # overload plane (docs/robustness.md "Overload & QoS"): the default
        # per-item deadline; 0 disarms everything but inbound-gRPC-deadline
        # bounding (legacy unbounded backpressure otherwise)
        self.overload_deadline_s = max(0.0, overload_deadline_ms) / 1e3
        # auto mode (GUBER_OVERLOAD_DEADLINE_MS=auto): armed with a deadline
        # derived per enqueue from the runner's issue-stage EWMA
        # (OVERLOAD_AUTO_DEADLINE_MULT × issue_ewma, floored at
        # shed_retry_ms) — self-tuning to what a launch costs here
        self.overload_deadline_auto = bool(overload_deadline_auto)
        self.armed = self.overload_deadline_s > 0 or self.overload_deadline_auto
        self.tenant_share = tenant_share
        # fairness bucket count, forced to a power of two (fp & (n-1) fold)
        tb = max(1, tenant_buckets)
        self.tenant_buckets = 1 << (tb - 1).bit_length()
        self.shed_retry_ms = shed_retry_ms
        # deque of _Entry: workers pop from the head per coalesced chunk —
        # a list's pop(0) is O(n) per pop, O(n²) across a backlog drain.
        # entry.span is the enqueueing request's trace context, linked to
        # the dispatch span that ends up serving it (batching breaks
        # parent-child causality; OTLP links restore it —
        # docs/observability.md).
        self._pending: Deque[_Entry] = deque()
        self._bucket_cost: dict = {}  # tenant bucket → queued cost units
        # EWMA of the drain rate (cost units/s over dispatch completions) —
        # the queue-wait estimate `pending_cost / rate` that sheds doomed
        # enqueues up front instead of letting them expire in the queue.
        # Cost units (_payload_cost), NOT raw rows: a cascade row drains
        # slower than a plain row, and the estimate must know that.
        self._drain_rate = 0.0
        self._drain_t = 0.0
        self._drain_cost = 0
        self._pending_rows = 0
        self._pending_cost = 0
        self._pending_bytes = 0
        self._wake: Optional[asyncio.Event] = None
        self._full: Optional[asyncio.Event] = None  # adaptive early close
        self._space: Optional[asyncio.Event] = None  # backpressure release
        self._worker_tasks: List[asyncio.Task] = []
        self._closed = False
        self._inflight = 0
        # introspection counters (CI serving smoke + tests read these)
        self.fused_dispatches = 0  # rode the fused wire→grid path
        self.column_dispatches = 0  # generic columns path
        self.wire_fallbacks = 0  # all-wire chunk that could NOT fuse
        self.ring_dispatches = 0  # all-wire chunk staged into the ring
        self.adaptive_closes = 0  # window closed on rows/bytes/idle engine
        self.window_expires = 0  # window closed on the wall-clock ceiling
        # adaptive-close reason split (the /v1/debug/pipeline payload):
        # rows/bytes thresholds, idle engine, freed dispatch slot
        self.close_reasons = {"rows": 0, "bytes": 0, "idle": 0, "slot": 0}
        # overload-plane counters (tests + /v1/debug/pipeline + CI gate)
        self.shed_rows = {
            "queue_full": 0, "deadline": 0, "fairness": 0, "preempted": 0
        }
        self.shed_by_tier = [0, 0, 0, 0]
        self.admitted_by_tier = [0, 0, 0, 0]
        # capacity sheds that left a strictly lower tier still queued —
        # zero by construction (preemption runs first); the CI overload
        # smoke gates this at exactly 0
        self.priority_inversions = 0

    # ------------------------------------------------------------- enqueue
    async def check(self, payload, now_ms: Optional[int] = None) -> ResponseColumns:
        """Enqueue a column batch (RequestColumns) or a pre-parsed wire
        batch (service/wire.WireBatch); resolves with this batch's slice of
        the coalesced response."""
        now = now_ms if now_ms is not None else ms_now()
        # stamp unset created_at at ENQUEUE time (reference stamps at request
        # entry, gubernator.go:225-227), not at flush time
        if isinstance(payload, WireBatch):
            cols = payload.cols
            payload = payload._replace(
                cols=cols._replace(
                    created_at=np.where(cols.created_at == 0, now, cols.created_at)
                )
            )
        else:
            payload = payload._replace(
                created_at=np.where(
                    payload.created_at == 0, now, payload.created_at
                )
            )
        rows = _payload_rows(payload)
        loop = asyncio.get_running_loop()
        if self._wake is None:
            self._wake = asyncio.Event()
            self._full = asyncio.Event()
            self._space = asyncio.Event()
        tier = _payload_tier(payload)
        cost = _payload_cost(payload)
        bucket = _payload_bucket(payload, self.tenant_buckets)
        deadline = self._item_deadline()
        entry = _Entry(
            payload, loop.create_future(), time.perf_counter(),
            tracing.current_span(), rows, cost, tier, bucket, deadline,
        )
        # per-tenant fair admission: once the queue is under pressure
        # (≥ half full), no tenant bucket may hold more than its share of
        # the window — one abusive tenant saturating the ring cannot starve
        # the rest (armed mode only). Shares are COST units against the
        # row-denominated window: a cascade-heavy tenant exhausts its share
        # in proportion to the device work it dispatches, so it cannot
        # starve cheap single-row traffic by staying under a raw row count.
        if (
            self.armed
            and self._pending_cost * 2 >= self.max_queue_rows
            and self._bucket_cost.get(bucket, 0) + cost
            > self.tenant_share * self.max_queue_rows
        ):
            return self._shed(entry, "fairness")
        # queue-wait estimate: work that cannot be served before its
        # deadline is answered NOW, not after expiring in the queue
        # (cost units over a cost-unit drain rate)
        if deadline is not None:
            remain = deadline - time.monotonic()
            if remain <= 0 or (
                self._drain_rate > 0
                and self._pending_cost / self._drain_rate > remain
            ):
                return self._shed(entry, "deadline")
        # bounded ring: callers past the cap wait for drain progress instead
        # of growing the queue without limit (an oversized single batch is
        # admitted alone rather than deadlocking). A higher-tier arrival
        # first PREEMPTS queued strictly-lower-tier entries (shed lowest
        # first) — capacity pressure falls on the lowest tier by
        # construction; an item with a deadline never waits past it.
        while (
            not self._closed
            and self._pending_rows > 0
            and self._pending_rows + rows > self.max_queue_rows
        ):
            if self.armed and self._preempt_lower(entry):
                break
            if deadline is None:
                self._space.clear()
                await self._space.wait()
                continue
            remain = deadline - time.monotonic()
            if remain <= 0:
                return self._shed(entry, "queue_full")
            self._space.clear()
            try:
                await asyncio.wait_for(self._space.wait(), remain)
            except asyncio.TimeoutError:
                return self._shed(entry, "queue_full")
        self._pending.append(entry)
        self._pending_rows += rows
        self._pending_cost += cost
        self._bucket_cost[bucket] = self._bucket_cost.get(bucket, 0) + cost
        self.admitted_by_tier[tier] += rows
        self._pending_bytes += (
            payload.nbytes if isinstance(payload, WireBatch) else 0
        )
        if self._closed:
            # shutdown path: no workers to wake; dispatch inline
            await self._flush_all()
        else:
            self._ensure_workers(loop)
            self._wake.set()
            if (
                self._pending_rows >= self.close_rows
                or self._pending_bytes >= self.close_bytes
            ):
                self._full.set()
        return await entry.fut

    # ------------------------------------------------------ overload plane
    def _item_deadline(self) -> Optional[float]:
        """This enqueue's absolute monotonic deadline: the tighter of the
        overload knob and the inbound gRPC deadline (service/deadline.py);
        None when neither applies — the legacy unbounded contract.

        Auto mode (GUBER_OVERLOAD_DEADLINE_MS=auto) derives the knob per
        enqueue: OVERLOAD_AUTO_DEADLINE_MULT × the runner's issue-stage
        EWMA, floored at shed_retry_ms (and at any explicit ms value also
        set). Re-evaluated every enqueue, so the door tracks the engine's
        actual launch cost as load and batch shapes shift."""
        knob_s = self.overload_deadline_s
        if self.overload_deadline_auto:
            knob_s = max(
                knob_s,
                self.shed_retry_ms / 1e3,
                OVERLOAD_AUTO_DEADLINE_MULT
                * getattr(self.runner, "issue_ewma", 0.0),
            )
        knob = time.monotonic() + knob_s if knob_s > 0 else None
        inbound = deadline_mod.inbound_deadline()
        if knob is None:
            return inbound
        if inbound is None:
            return knob
        return min(knob, inbound)

    def _shed(self, entry: _Entry, reason: str) -> ResponseColumns:
        """Answer an entry WITHOUT dispatching it: a fast per-item
        OVER_LIMIT-style overload row (ERR_OVERLOAD, reset_time = the
        suggested retry instant). The caller's RPC succeeds — overload is
        a per-item decision, like every other limit verdict."""
        self.shed_rows[reason] += entry.rows
        self.shed_by_tier[entry.tier] += entry.rows
        if reason in ("queue_full", "preempted") and any(
            e.tier < entry.tier for e in self._pending
        ):
            # should be unreachable (preemption sheds lowest-first); the
            # counter existing — and being gated at 0 in CI — is the proof
            self.priority_inversions += 1
        if self.metrics is not None:
            self.metrics.shed_total.labels(
                reason=reason, tier=str(entry.tier)
            ).inc(entry.rows)
        rc = self._overload_columns(entry.payload)
        if not entry.fut.done():
            entry.fut.set_result(rc)
        return rc

    def _overload_columns(self, payload) -> ResponseColumns:
        cols = _payload_cols(payload)
        n = cols.fp.shape[0]
        reset = ms_now() + self.shed_retry_ms
        return ResponseColumns(
            status=np.ones(n, dtype=np.int32),  # Status.OVER_LIMIT
            limit=cols.limit.astype(np.int64, copy=True),
            remaining=np.zeros(n, dtype=np.int64),
            reset_time=np.full(n, reset, dtype=np.int64),
            err=np.full(n, ERR_OVERLOAD, dtype=np.int8),
        )

    def _preempt_lower(self, entry: _Entry) -> bool:
        """Make room for a higher-tier arrival by evicting queued entries of
        STRICTLY lower tiers, lowest tier first then oldest first. Only
        evicts when the freed rows actually admit the newcomer (no pointless
        victims); returns True when space was made."""
        need = self._pending_rows + entry.rows - self.max_queue_rows
        victims = sorted(
            (e for e in self._pending if e.tier < entry.tier),
            key=lambda e: (e.tier, e.t_enq),
        )
        avail = sum(e.rows for e in victims)
        if avail < need:
            return False
        freed = 0
        chosen = []
        for v in victims:
            chosen.append(v)
            freed += v.rows
            if freed >= need:
                break
        for v in chosen:
            self._pending.remove(v)
            self._pending_rows -= v.rows
            self._pending_cost -= v.cost
            self._drop_bucket_cost(v)
            self._shed(v, "preempted")
        self._pending_bytes = sum(
            e.payload.nbytes
            for e in self._pending
            if isinstance(e.payload, WireBatch)
        )
        return True

    def _drop_bucket_cost(self, entry: _Entry) -> None:
        left = self._bucket_cost.get(entry.bucket, 0) - entry.cost
        if left > 0:
            self._bucket_cost[entry.bucket] = left
        else:
            self._bucket_cost.pop(entry.bucket, None)

    def _note_drained(self, cost: int) -> None:
        """Fold one dispatch completion into the drain-rate EWMA (cost
        units/s — the same units the queue-wait estimate divides by)."""
        now = time.monotonic()
        if self._drain_t == 0.0:
            self._drain_t = now
            self._drain_cost = cost
            return
        self._drain_cost += cost
        dt = now - self._drain_t
        if dt < 1e-4:
            return
        inst = self._drain_cost / dt
        self._drain_rate = (
            inst if self._drain_rate == 0.0
            else 0.7 * self._drain_rate + 0.3 * inst
        )
        self._drain_t = now
        self._drain_cost = 0

    def _ensure_workers(self, loop) -> None:
        self._worker_tasks = [t for t in self._worker_tasks if not t.done()]
        while len(self._worker_tasks) < self.workers:
            self._worker_tasks.append(
                loop.create_task(
                    self._run(), name=f"batcher-{len(self._worker_tasks)}"
                )
            )

    # ------------------------------------------------------------- workers
    async def _run(self) -> None:
        while not self._closed:
            if not self._pending:
                self._wake.clear()
                if self._pending:  # raced an enqueue between check and clear
                    continue
                await self._wake.wait()
                continue
            await self._window()
            chunk = self._take_chunk()
            if chunk is None:
                continue
            await self._dispatch(chunk)

    async def _window(self) -> None:
        """Hold the coalesce window open until it should close: on
        accumulated rows/bytes (engine-sized dispatch ready), on an idle
        engine (light load — why wait?), on a dispatch slot freeing (refill
        the pipeline), or on the `batch_wait_ms` wall-clock ceiling."""
        if self.batch_wait_s <= 0:
            return
        if (
            self._pending_rows >= self.close_rows
            or self._pending_bytes >= self.close_bytes
        ):
            self._close_adaptive()
            return
        if self.adaptive and self._inflight == 0:
            # engine idle: dispatching now beats waiting for company —
            # requests arriving during THIS dispatch coalesce into the next
            self.adaptive_closes += 1
            self.close_reasons["idle"] += 1
            return
        if not self.adaptive:
            await asyncio.sleep(self.batch_wait_s)
            return
        self._full.clear()
        if (
            self._pending_rows >= self.close_rows
            or self._pending_bytes >= self.close_bytes
        ):  # filled while clearing
            self._close_adaptive()
            return
        try:
            await asyncio.wait_for(self._full.wait(), self.batch_wait_s)
            self._close_adaptive()
        except asyncio.TimeoutError:
            self.window_expires += 1

    def _close_adaptive(self) -> None:
        """Count one adaptive close, attributed to what actually tripped it
        (rows/bytes threshold, else a freed dispatch slot re-evaluating)."""
        self.adaptive_closes += 1
        if self._pending_rows >= self.close_rows:
            self.close_reasons["rows"] += 1
        elif self._pending_bytes >= self.close_bytes:
            self.close_reasons["bytes"] += 1
        else:
            self.close_reasons["slot"] += 1

    def _take_chunk(self):
        """Pop a chunk of whole enqueued batches up to the coalesce limit
        (a single oversized enqueue dispatches alone), bounding dispatch
        latency and compile-shape spread. Armed mode orders the window by
        tier (highest first, FIFO within a tier) once a backlog has mixed
        tiers, and sheds deadline-expired entries instead of serving them
        — an answer after the caller stopped waiting is pure waste. One
        clamped gauge update per flush — per-enqueue sets only churned the
        gauge with intermediate values (hot-path metric cost at high
        request rates)."""
        if not self._pending:
            return None
        if (
            self.armed
            and len(self._pending) > 1
            and len({e.tier for e in self._pending}) > 1
        ):
            # stable sort: FIFO preserved within each tier
            self._pending = deque(
                sorted(self._pending, key=lambda e: -e.tier)
            )
        chunk = []
        rows = 0
        now = time.monotonic()
        while self._pending:
            head = self._pending[0]
            if chunk and rows + head.rows > self.coalesce_limit:
                break
            entry = self._pending.popleft()
            self._pending_rows -= entry.rows
            self._pending_cost -= entry.cost
            self._drop_bucket_cost(entry)
            if entry.deadline is not None and now > entry.deadline:
                self._shed(entry, "deadline")
                continue
            chunk.append(entry)
            rows += entry.rows
        self._pending_bytes = sum(
            e.payload.nbytes
            for e in self._pending
            if isinstance(e.payload, WireBatch)
        )
        if self._space is not None:
            self._space.set()
        if self.metrics is not None:
            self.metrics.queue_length.set(max(self._pending_rows, 0))
        return chunk if chunk else None

    # ------------------------------------------------------------ dispatch
    async def _dispatch(self, batch) -> None:
        self._inflight += 1
        # one `dispatch` span per flush: batching breaks request→engine
        # parent-child causality (N requests share one flush), so the flush
        # gets its OWN trace with stage child spans (queue here; put/issue/
        # fetch in the runner) and every request span gains an OTLP link to
        # it — minted only when spans actually export
        disp_span = tracing.new_span() if tracing.exporter is not None else None
        fused = False
        try:
            t0 = time.perf_counter()
            oldest = min(e.t_enq for e in batch)
            if self.metrics is not None:
                self.metrics.stage_duration.labels(stage="queue").observe(
                    t0 - oldest,
                    exemplar=(
                        {"trace_id": disp_span.trace_id} if disp_span else None
                    ),
                )
                # per-enqueue queue wait (the shed policy's p99 story):
                # "queue" above is per-CHUNK (its oldest member); these are
                # per admitted batch, the distribution deadlines cut into
                qw = self.metrics.stage_duration.labels(stage="queue_wait")
                for e in batch:
                    wait = t0 - e.t_enq
                    qw.observe(wait)
                    self.metrics.queue_wait_seconds.observe(wait)
            if disp_span is not None:
                q_ns = time.time_ns()
                tracing.record_span(
                    "queue", tracing.new_span(disp_span), disp_span.span_id,
                    q_ns - int((t0 - oldest) * 1e9), q_ns,
                )
            payloads = [e.payload for e in batch]
            rc = None
            if all(isinstance(p, WireBatch) for p in payloads):
                if self.ring is not None:
                    # ring path: stage the chunk into a request-ring slot;
                    # the serving loop consumes it in ticket order through
                    # the SAME runner surface (byte-identical responses). A
                    # ring racing drain falls through to the direct path
                    # below — zero loss.
                    from gubernator_tpu_torch.service.ring import RingClosed

                    try:
                        rc = await self.ring.submit(payloads, span=disp_span)
                        self.ring_dispatches += 1
                        fused = True
                    except RingClosed:
                        rc = None
                if rc is None:
                    # fused path: pre-packed parser lanes scatter straight
                    # into one staged compact grid
                    # (ops/engine.prepare_check_wire) — the request bytes
                    # are traversed exactly once end to end
                    rc = await self.runner.check_wire(
                        payloads, span=disp_span
                    )
                    if rc is not None:
                        self.fused_dispatches += 1
                        fused = True
                    else:
                        self.wire_fallbacks += 1
            if rc is None:
                cat = concat_columns([_payload_cols(p) for p in payloads])
                rc = await self.runner.check(cat, span=disp_span)
                self.column_dispatches += 1
        except Exception as exc:  # pragma: no cover - defensive
            for e in batch:
                if not e.fut.done():
                    e.fut.set_exception(exc)
            return
        finally:
            self._inflight -= 1
            self._note_drained(sum(e.cost for e in batch))
            if self._full is not None:
                # a slot freed: a worker holding its window open should
                # re-evaluate — refilling the pipeline beats waiting
                self._full.set()
        if self.metrics is not None:
            self.metrics.batch_send_duration.observe(
                time.perf_counter() - t0,
                exemplar=(
                    {"trace_id": disp_span.trace_id} if disp_span else None
                ),
            )
        if disp_span is not None:
            # request spans → dispatch span links (registered while their
            # scopes are still open: the futures resolve after this), and
            # the dispatch span itself links back to every distinct request
            req_spans = [e.span for e in batch if e.span is not None]
            for rs in req_spans:
                tracing.add_span_link(rs, disp_span)
            end_ns = time.time_ns()
            tracing.record_span(
                "dispatch", disp_span, "",
                end_ns - int((time.perf_counter() - oldest) * 1e9), end_ns,
                attributes={
                    "batch.rows": sum(e.rows for e in batch),
                    "batch.requests": len(batch),
                    "batch.fused": fused,
                },
                links=req_spans,
            )
        off = 0
        for e in batch:
            payload, fut = e.payload, e.fut
            n = e.rows
            sl = slice(off, off + n)
            if not fut.done():
                fut.set_result(
                    ResponseColumns(
                        status=rc.status[sl],
                        limit=rc.limit[sl],
                        remaining=rc.remaining[sl],
                        reset_time=rc.reset_time[sl],
                        err=rc.err[sl],
                    )
                )
            off += n

    def arm_overload(self, deadline_ms: float) -> None:
        """(Re)arm or disarm the overload door at runtime. The scenario
        harness (bench.py) warms XLA chunk shapes through the OPEN door and
        only then arms it for the timed windows — a warm wave shed by the
        armed door never dispatches, leaving its chunk shape uncompiled so
        the compile lands inside a measured step disguised as queueing
        latency. Per-entry deadlines are stamped at enqueue, so flipping
        between windows never retro-affects queued items."""
        self.overload_deadline_s = max(0.0, deadline_ms) / 1e3
        self.armed = self.overload_deadline_s > 0 or self.overload_deadline_auto

    def debug(self) -> dict:
        """Live front-door state for /v1/debug/pipeline (docs/observability.md):
        ring depth, worker liveness, dispatch-path counters, and WHY the
        adaptive window has been closing."""
        return {
            "pending_requests": len(self._pending),
            "pending_rows": self._pending_rows,
            "pending_cost": self._pending_cost,
            "pending_bytes": self._pending_bytes,
            "inflight": self._inflight,
            "workers": self.workers,
            "workers_alive": sum(1 for t in self._worker_tasks if not t.done()),
            "adaptive": self.adaptive,
            "batch_wait_ms": self.batch_wait_s * 1e3,
            "coalesce_limit": self.coalesce_limit,
            "close_rows": self.close_rows,
            "close_bytes": self.close_bytes,
            "max_queue_rows": self.max_queue_rows,
            "fused_dispatches": self.fused_dispatches,
            "column_dispatches": self.column_dispatches,
            "wire_fallbacks": self.wire_fallbacks,
            "ring_dispatches": self.ring_dispatches,
            "ring": self.ring.debug() if self.ring is not None else None,
            "adaptive_closes": self.adaptive_closes,
            "window_expires": self.window_expires,
            "close_reasons": dict(self.close_reasons),
            "overload_armed": self.armed,
            "overload_deadline_ms": self.overload_deadline_s * 1e3,
            "overload_deadline_auto": self.overload_deadline_auto,
            "tenant_share": self.tenant_share,
            "tenant_buckets": self.tenant_buckets,
            "shed_rows": dict(self.shed_rows),
            "shed_by_tier": list(self.shed_by_tier),
            "admitted_by_tier": list(self.admitted_by_tier),
            "priority_inversions": self.priority_inversions,
            "drain_rate_cost_per_s": self._drain_rate,
            "closed": self._closed,
        }

    async def _flush_all(self) -> None:
        """Drain every pending chunk inline (shutdown path)."""
        while self._pending:
            chunk = self._take_chunk()
            if chunk is None:
                break
            await self._dispatch(chunk)

    async def drain(self) -> None:
        """Stop the flush workers and flush anything pending (shutdown
        path). Lets in-flight dispatches finish rather than cancelling them
        — cancelled dispatches would strand their callers' futures."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()
            self._full.set()
            self._space.set()
        if self._worker_tasks:
            await asyncio.gather(*self._worker_tasks, return_exceptions=True)
            self._worker_tasks = []
        await self._flush_all()

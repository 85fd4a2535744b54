"""The request ring — the always-on serving loop's front end (the port of
``gubernator_tpu/service/ring.py``).

Every coalesced flush of the direct path walks the whole host dispatch
machinery (executor hop, launch, fetch). The ring instead feeds a fixed set
of S request slots: a submitter claims ticket ``t`` (slot ``t % S``) under
the submit lock, stages its payload into the slot, and only THEN publishes
``seq_in[slot] = t + 1``; the serving loop consumes tickets strictly in
order and publishes ``seq_out[slot] = t + 1`` only after the result exists.
The submitter's result wait is that egress-fence poll. When all S slots are
published and unconsumed, submit WAITS (no drops, FIFO order kept), and
``drain()`` stops intake, retires every published ticket and only then
parks the loop (zero loss).

The consume side has three tiers behind GUBER_RING_ISSUE:

* **host** — one runner dispatch per published slot, through the same
  ``EngineRunner.check_wire`` the direct path drives, so responses are
  byte-identical. The CPU default and the byte-parity oracle.
* **fused** — the device-resident drain (ops/ring_drain.py): the slots and
  fence words live on the engine's device (``DeviceRing``), and one drain
  decides up to GUBER_RING_DRAIN_K consecutively published slots. On the
  card a drain claims its slots with the ``fence_claim`` kernel
  (csrc/fence_claim.cu) and decides each claimed slot on the table. Slots
  the drain cannot take (repeated keys, non-encodable rows, chunks wider
  than a slot) ride the per-slot host path in ticket order — byte-identical
  either way. The card's default.
* **persistent** — the fused drain with the reference's watchdog: a failed
  drain re-launches once (counted in ``watchdog_relaunches``) before its
  group fails. It never falls back to the host loop.

Consumption is strictly in ticket order, but each group's finish overlaps
the next group's issue through the runner's fetch pool: the ring serializes
LAUNCH order, not completion latency.

Knobs: GUBER_RING_ENABLE, GUBER_RING_SLOTS, GUBER_RING_ISSUE,
GUBER_RING_DRAIN_K, GUBER_RING_SLOT_WIDTH (0 = auto-size to the first fused
chunk). Metrics: gubernator_tpu_dispatch_launches_total{path="ring"|"fused"|
"xla"}, gubernator_tpu_ring_drain_slots (slots retired per fused drain),
gubernator_tpu_ring_occupancy, and the ring_put / ring_poll stage_duration
labels.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

import numpy as np

from gubernator_tpu_torch.ops.batch import ResponseColumns
from gubernator_tpu_torch.service.wire import concat_columns


class RingClosed(RuntimeError):
    """Raised to a submitter racing drain(): the caller (Batcher._dispatch)
    falls back to the direct dispatch path — no request is lost."""


class RequestRing:
    """Fixed ring of S request slots with sequence-number fencing.

    `seq_in` / `seq_out` are the ingress/egress fence words — int64 arrays
    indexed by slot, exactly the layout the device ring keeps resident in
    device memory. Slot `t % S` carries ticket
    `t`; fence value `t + 1` (never 0, so an unused slot is unambiguous).
    """

    def __init__(self, runner, slots: int = 64, metrics=None,
                 issue_mode: str = "host", drain_k: int = 8,
                 slot_width: int = 0):
        if slots < 2:
            raise ValueError("RequestRing needs at least 2 slots")
        if issue_mode not in ("host", "fused", "persistent"):
            raise ValueError(
                f"GUBER_RING_ISSUE must be host|fused|persistent, "
                f"got {issue_mode!r}"
            )
        if drain_k < 1:
            raise ValueError("GUBER_RING_DRAIN_K must be >= 1")
        self.runner = runner
        self.slots = int(slots)
        self.metrics = metrics
        self.issue_mode = issue_mode
        self.drain_k = int(min(drain_k, slots))
        # fixed device slot width (rows); 0 = auto-size to the first fused
        # chunk's padded size (wider chunks then ride the host path)
        self.slot_width = int(slot_width)
        self._dring = None  # ops/ring_drain.DeviceRing, fused tiers only
        self.seq_in = np.zeros(self.slots, dtype=np.int64)
        self.seq_out = np.zeros(self.slots, dtype=np.int64)
        # slot payload staging (the emulation's stand-in for the DMA'd
        # wire grids): (parts, span) per slot, cleared on consume
        self._staged: List[Optional[Tuple[list, object]]] = (
            [None] * self.slots
        )
        self._head = 0  # next ticket to claim (== tickets published)
        self._consumed = 0  # tickets fully retired (seq_out published)
        self._done = {}  # ticket -> result future (the egress poll)
        self._lock: Optional[asyncio.Lock] = None
        self._published: Optional[asyncio.Event] = None
        self._space: Optional[asyncio.Event] = None
        self._drained: Optional[asyncio.Event] = None
        self._issue_task: Optional[asyncio.Task] = None
        self._finish_task: Optional[asyncio.Task] = None
        self._inorder: Optional[asyncio.Queue] = None
        self._closed = False
        # introspection counters (ring_smoke + /v1/debug/pipeline)
        self.launches = 0  # tickets retired through the ring
        self.fallbacks = 0  # non-fusable slots that rode the columns path
        self.backpressure_waits = 0  # submits that found the ring full
        self.max_occupancy = 0
        # fused-tier counters (ring_drain_smoke + /v1/debug/pipeline)
        self.drain_launches = 0  # fused drain launches
        self.drained_slots = 0  # tickets retired by fused drains
        self.host_slots = 0  # fused-ineligible tickets (per-slot path)
        self.watchdog_relaunches = 0  # persistent-tier drain re-launches

    # ------------------------------------------------------------ lifecycle
    def _ensure_started(self) -> None:
        if self._lock is not None:
            return
        loop = asyncio.get_running_loop()
        self._lock = asyncio.Lock()
        self._published = asyncio.Event()
        self._space = asyncio.Event()
        self._drained = asyncio.Event()
        self._inorder = asyncio.Queue()
        consume = (
            self._issue_loop if self.issue_mode == "host"
            else self._issue_loop_fused
        )
        self._issue_task = loop.create_task(consume(), name="ring-issue")
        self._finish_task = loop.create_task(self._finish_loop(),
                                             name="ring-finish")

    def _set_occupancy(self) -> None:
        occ = self._head - self._consumed
        if occ > self.max_occupancy:
            self.max_occupancy = occ
        if self.metrics is not None:
            self.metrics.ring_occupancy.set(occ)

    # -------------------------------------------------------------- submit
    async def submit(self, parts, span=None) -> ResponseColumns:
        """Claim a ticket, stage the payload, publish the ingress fence,
        and poll the egress fence for the coalesced response. `parts` is
        the all-WireBatch chunk the batcher formed — the same value the
        direct path hands `runner.check_wire`, which is what makes the two
        paths byte-identical."""
        self._ensure_started()
        if self._closed:
            raise RingClosed("request ring is draining")
        t0 = time.perf_counter()
        async with self._lock:
            ticket = self._head
            # bounded backpressure: every slot published-but-unconsumed →
            # wait for the serving loop to retire the oldest (FIFO under
            # the lock: later submitters queue behind this one)
            while not self._closed and (
                ticket - self._consumed >= self.slots
            ):
                self.backpressure_waits += 1
                self._space.clear()
                await self._space.wait()
            if self._closed:
                raise RingClosed("request ring is draining")
            self._head = ticket + 1
            slot = ticket % self.slots
            fut = asyncio.get_running_loop().create_future()
            self._done[ticket] = fut
            # STAGE before PUBLISH — the store-fence ordering: the payload
            # must be slot-resident before seq_in makes it claimable
            self._staged[slot] = (parts, span)
            self.seq_in[slot] = ticket + 1
            self._published.set()
        self._set_occupancy()
        self.runner._observe_stage("ring_put", t0, span)
        # egress-fence poll: resolve when the serving loop publishes
        # seq_out[slot] == ticket + 1
        t1 = time.perf_counter()
        try:
            rc = await fut
        finally:
            self._done.pop(ticket, None)
        self.runner._observe_stage("ring_poll", t1, span)
        return rc

    # ------------------------------------------------------- serving loop
    async def _dispatch(self, parts, span):
        """One slot's dispatch: the exact runner surface the direct path
        drives. Non-fusable chunks (duplicate keys, non-encodable rows)
        fall back to the columns path, same as Batcher._dispatch."""
        rc = await self.runner.check_wire(parts, span=span,
                                          launch_path="ring")
        if rc is None:
            self.fallbacks += 1
            cat = concat_columns([p.cols for p in parts])
            rc = await self.runner.check(cat, span=span, launch_path="ring")
        return rc

    async def _issue_loop(self) -> None:
        """Walk tickets strictly in order (the persistent kernel's slot
        walk): check the ingress fence, lift the payload, and start its
        dispatch. Completion ordering is the finish loop's job."""
        t = 0
        loop = asyncio.get_running_loop()
        while True:
            while t >= self._head:
                if self._closed:
                    await self._inorder.put(None)  # finish-loop sentinel
                    return
                self._published.clear()
                if t < self._head:  # raced a publish
                    break
                await self._published.wait()
            slot = t % self.slots
            # ingress fence: the slot must carry exactly this ticket
            assert int(self.seq_in[slot]) == t + 1, (
                f"ring fence violation: slot {slot} has seq "
                f"{int(self.seq_in[slot])}, expected {t + 1}"
            )
            parts, span = self._staged[slot]
            self._staged[slot] = None
            await self._inorder.put(
                ([t], loop.create_task(self._dispatch(parts, span)))
            )
            t += 1

    # ------------------------------------------------- fused consume tier
    def _prepare_slot(self, parts, span):
        """Prep-pool half of one fused slot: assemble the fixed-width wire
        grid + PendingCheck (ops/engine.prepare_ring_slot). None routes
        the chunk to the per-slot host path. Auto-sizes the device ring on
        the first fusable chunk when GUBER_RING_SLOT_WIDTH=0."""
        from gubernator_tpu_torch.ops.engine import _pad_size, prepare_ring_slot

        engine = self.runner.engine
        if self._dring is None and self.slot_width == 0:
            # first fused chunk sizes the slots: wide enough for its own
            # padded dispatch, floored so ordinary coalesced flushes fit
            n = sum(p.cols.fp.shape[0] for p in parts)
            self.slot_width = max(64, _pad_size(n))
        t0 = time.perf_counter()
        prep = prepare_ring_slot(engine, parts, self.slot_width)
        if prep is not None:
            self.runner._observe_stage("put", t0, span)
            for p in parts:
                self.runner._count_decisions(p.cols.algo)
        return prep

    def _ensure_dring(self):
        if self._dring is None:
            from gubernator_tpu_torch.ops.ring_drain import DeviceRing

            engine = self.runner.engine
            self._dring = DeviceRing(
                self.slots, self.slot_width, self.drain_k,
                evictees=bool(getattr(engine, "_evictees", False)),
                device=engine.device,
            )
        return self._dring

    async def _fail(self, exc):
        raise exc

    async def _issue_loop_fused(self) -> None:
        """Fused consume loop (GUBER_RING_ISSUE=fused|persistent): walk
        tickets strictly in order, group consecutively published fusable
        slots that share the drain graph's static modes (math, cascade),
        and retire each group with ONE device drain launch
        (ops/ring_drain.drain_ring). Launch order across groups — and
        across the interleaved per-slot host dispatches — stays strict
        ticket order, the byte-parity contract; each group's finish
        overlaps the next group's prepare/issue through the runner's fetch
        pool, same as the host tier."""
        t = 0
        loop = asyncio.get_running_loop()
        while True:
            while t >= self._head:
                if self._closed:
                    await self._inorder.put(None)  # finish-loop sentinel
                    return
                self._published.clear()
                if t < self._head:  # raced a publish
                    break
                await self._published.wait()
            # lift every currently published ticket, up to one drain's worth
            todo = []
            while t < self._head and len(todo) < self.drain_k:
                slot = t % self.slots
                assert int(self.seq_in[slot]) == t + 1, (
                    f"ring fence violation: slot {slot} has seq "
                    f"{int(self.seq_in[slot])}, expected {t + 1}"
                )
                parts, span = self._staged[slot]
                self._staged[slot] = None
                todo.append((t, parts, span))
                t += 1
            preps = await asyncio.gather(*(
                loop.run_in_executor(
                    self.runner._prep, self._prepare_slot, parts, span
                )
                for _t, parts, span in todo
            ))
            i = 0
            while i < len(todo):
                if preps[i] is None:
                    # fused-ineligible: per-slot host dispatch. Awaited in
                    # full (not pipelined) so a following fused drain can
                    # never launch before this earlier ticket's dispatch —
                    # strict launch order is what byte-parity rests on.
                    tk, parts, span = todo[i]
                    self.host_slots += 1
                    task = loop.create_task(self._dispatch(parts, span))
                    await asyncio.wait({task})
                    await self._inorder.put(([tk], task))
                    i += 1
                    continue
                j = i + 1
                while (
                    j < len(todo)
                    and preps[j] is not None
                    and preps[j].math == preps[i].math
                    and preps[j].cascade == preps[i].cascade
                    # a slot with shadow fault-backs must HEAD its group:
                    # its promote-merge precedes the whole launch, so any
                    # earlier slot in the same drain would decide against
                    # post-merge state the per-slot path never saw
                    and preps[j].pending.promote is None
                ):
                    j += 1
                group = [preps[x] for x in range(i, j)]
                tickets = [todo[x][0] for x in range(i, j)]
                span = todo[i][2]
                try:
                    bank, n = await self.runner.drain_ring_issue(
                        self._ensure_dring(), group, tickets[0], span=span
                    )
                except Exception as exc:
                    if self.issue_mode == "persistent":
                        # watchdog: a preempted/failed drain re-launches
                        # once before the group is failed out
                        self.watchdog_relaunches += 1
                        try:
                            bank, n = await self.runner.drain_ring_issue(
                                self._ensure_dring(), group, tickets[0],
                                span=span,
                            )
                        except Exception as exc2:
                            await self._inorder.put(
                                (tickets, loop.create_task(self._fail(exc2)))
                            )
                            i = j
                            continue
                    else:
                        await self._inorder.put(
                            (tickets, loop.create_task(self._fail(exc)))
                        )
                        i = j
                        continue
                self.drain_launches += 1
                self.drained_slots += len(group)
                task = loop.create_task(
                    self.runner.drain_ring_finish(group, bank, n, span=span)
                )
                await self._inorder.put((tickets, task))
                i = j

    async def _finish_loop(self) -> None:
        """Retire tickets in order: await each dispatch (one ticket on the
        host/fallback path, a whole drain group on the fused path),
        publish the egress fences, resolve the submitters' polls, free the
        slots."""
        while True:
            item = await self._inorder.get()
            if item is None:
                self._drained.set()
                return
            tickets, task = item
            try:
                rc = await task
            except Exception as exc:  # pragma: no cover - defensive
                results = [exc] * len(tickets)
            else:
                results = rc if isinstance(rc, list) else [rc]
            for t, res in zip(tickets, results):
                slot = t % self.slots
                fut = self._done.get(t)
                if fut is not None and not fut.done():
                    if isinstance(res, Exception):
                        fut.set_exception(res)
                    else:
                        fut.set_result(res)
                self.launches += 1
                # egress fence AFTER the result is materialized — the
                # order the submitter's poll relies on
                self.seq_out[slot] = t + 1
                self._consumed = t + 1
            self._set_occupancy()
            self._space.set()

    # --------------------------------------------------------------- drain
    async def drain(self) -> None:
        """Stop intake and retire every published ticket in order before
        parking the serving loop — zero-loss shutdown (the ring_smoke
        drain gate). Safe to call with nothing ever submitted."""
        self._closed = True
        if self._lock is None:
            return  # never started
        self._published.set()  # wake the issue loop to emit its sentinel
        self._space.set()  # release submitters blocked on backpressure
        await self._drained.wait()
        for task in (self._issue_task, self._finish_task):
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass

    def debug(self) -> dict:
        """Ring-plane state for /v1/debug/pipeline."""
        return {
            "slots": self.slots,
            "occupancy": self._head - self._consumed,
            "published": self._head,
            "consumed": self._consumed,
            "launches": self.launches,
            "fallbacks": self.fallbacks,
            "backpressure_waits": self.backpressure_waits,
            "max_occupancy": self.max_occupancy,
            "closed": self._closed,
            "issue_mode": self.issue_mode,
            "drain_k": self.drain_k,
            "slot_width": self.slot_width,
            "drain_launches": self.drain_launches,
            "drained_slots": self.drained_slots,
            "host_slots": self.host_slots,
            "watchdog_relaunches": self.watchdog_relaunches,
        }

"""EngineRunner: the single-writer dispatch thread (the port of
``gubernator_tpu/service/runner.py``).

The device table has exactly one owner — the kernel — and the host side
funnels every mutation through ONE thread, the TPU analog of the reference's
"each worker owns its cache, no mutexes" rule (reference workers.go:19-37).
asyncio handlers await engine work through this runner; ordering of submitted
jobs is FIFO, which is what makes the front-door batcher's request-order
contract hold.

On the card the pipelined dispatch's ISSUE half (engine thread) also
enqueues the copy of its outputs into pinned host buffers, on the engine's
stream right behind the launches, and records a CUDA event after it; the
FINISH half (fetch pool) waits on that event alone. A fetch so never
synchronizes the device, never waits on a later dispatch, and does not
depend on the fetch thread's current stream. The request ring's fused
drain (``drain_ring_issue`` / ``drain_ring_finish``) fetches its bank the
same way. The planes' engine jobs live here too: the region receive path
(``apply_region``, ops/reconcile.py), the tier sweep
(``tier_demote_idle``) and the checkpoint reads (``checkpoint_extract`` /
``checkpoint_snapshot``).
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from gubernator_tpu_torch import tracing
from gubernator_tpu_torch.ops.batch import RequestColumns, ResponseColumns
from gubernator_tpu_torch.ops.engine import LocalEngine


def _exemplar(span) -> Optional[dict]:
    """OpenMetrics exemplar payload for a stage observation: the dispatch
    span's trace_id, so a p99 bucket is one click from its trace. None when
    the dispatch is untraced (no exporter) — prometheus_client treats None
    as no-exemplar."""
    return {"trace_id": span.trace_id} if span is not None else None


def _to_host(tensors):
    """Copy card tensors into pinned host buffers on the current stream
    and record a CUDA event after the copies: (host tensors, event). CPU
    tensors come back as they are, with no event."""
    if not all(t.is_cuda for t in tensors):
        return list(tensors), None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return hosts, ev


def _stage_fetch(pending):
    """Start the device→host copy of an issued PendingCheck's outputs on
    the engine's stream and return the CUDA event that marks it done (None
    when there is nothing on a card to fetch, or for an engine's own
    pending type, which fetches itself). The outputs are replaced in place
    by their pinned host buffers, so finish decodes host memory only after
    the event. Runs on the engine thread, right after the launches."""
    from gubernator_tpu_torch.ops.engine import PendingCheck

    if not isinstance(pending, PendingCheck):
        return None
    stacked = pending.stacked is not None
    outs = [pending.stacked] if stacked else [e[3] for e in pending.passes]
    if not outs or not all(isinstance(t, torch.Tensor) and t.is_cuda for t in outs):
        return None
    hosts, ev = _to_host(outs)
    if stacked:
        pending.stacked = hosts[0]
    else:
        for e, h in zip(pending.passes, hosts):
            e[3] = h
    return ev


# gubernator_tpu_decisions_total label values (types.Algorithm order)
_ALGO_LABELS = (
    "token_bucket", "leaky_bucket", "gcra", "sliding_window",
    "concurrency_lease", "invalid",
)


class EngineRunner:
    """Serializes engine table access onto one thread; async façade.

    The pipelined path (`check`) splits each request batch into an ISSUE
    half on the engine thread (pack + enqueue kernel dispatches, no fetch)
    and a FINISH half on a small fetch pool (materialize outputs) — so the
    engine thread packs dispatch N+1 while N executes on-device and N-1's
    results stream back. Rare feedback (claim drops, Store rehydrates) runs
    back on the engine thread via the `fixup` hook; stats deltas are folded
    in on the engine thread too, keeping every engine mutation single-
    writer."""

    def __init__(self, engine: LocalEngine, metrics=None, fetch_workers: int = 4):
        self.engine = engine
        self.metrics = metrics
        self._exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine")
        # sized to the configured pipeline depth: fewer fetch workers than
        # in-flight dispatches would silently cap the pipeline
        self._fetch = ThreadPoolExecutor(
            max_workers=max(1, fetch_workers), thread_name_prefix="fetch"
        )
        # preparation pool separate from the fetch pool: finish() blocks a
        # worker for a device round trip, and a prepare stuck behind blocked
        # fetchers would stall the whole pipeline's intake
        self._prep = ThreadPoolExecutor(
            max_workers=max(2, fetch_workers // 2), thread_name_prefix="prep"
        )
        # background telemetry fetches get their OWN single thread (lazy):
        # a table scan parked on a fetch worker would steal a pipeline slot
        self._telemetry: Optional[ThreadPoolExecutor] = None
        # checkpoint-extract fetches likewise (lazy): the dirty-block
        # fetch overlaps serving dispatches, never competes with them
        self._ckpt: Optional[ThreadPoolExecutor] = None
        # cumulative per-algorithm decision counts (the debug-plane mirror
        # of gubernator_tpu_decisions_total; /v1/debug/pipeline)
        self.algo_counts = {k: 0 for k in _ALGO_LABELS}
        # EWMA of the issue stage (seconds) — the device-launch half of a
        # dispatch. The batcher's auto overload deadline
        # (GUBER_OVERLOAD_DEADLINE_MS=auto) is derived from this: a queue
        # estimate denominated in what a launch actually costs on THIS
        # deployment, not a hand-tuned wall-clock guess.
        self.issue_ewma = 0.0

    def _count_decisions(self, algo_col) -> None:
        """Per-algorithm decision accounting (the
        gubernator_tpu_decisions_total{algorithm} family) — one vectorized
        bincount per dispatch, never per row. Cascade member rows carry
        their own algorithm, so every level counts as one decision."""
        a = np.asarray(algo_col)
        if a.size == 0:
            return
        lab = np.where((a >= 0) & (a < len(_ALGO_LABELS) - 1), a,
                       len(_ALGO_LABELS) - 1)
        counts = np.bincount(lab, minlength=len(_ALGO_LABELS))
        for v, c in enumerate(counts):
            if c:
                self.algo_counts[_ALGO_LABELS[v]] += int(c)
                if self.metrics is not None:
                    self.metrics.decisions_total.labels(
                        algorithm=_ALGO_LABELS[v]
                    ).inc(int(c))

    async def check(
        self, cols: RequestColumns, now_ms: Optional[int] = None, span=None,
        launch_path: str = "xla",
    ) -> ResponseColumns:
        """Pipelined check when the engine supports the prepare/issue/finish
        split, else the serial path. Store-configured engines stay serial:
        write-through ordering and miss-rehydrates must serialize against
        every same-key dispatch, which interleaved pipelined chunks cannot
        guarantee — durability trades pipeline throughput. Engines may also
        veto per batch via `can_pipeline(cols)`; engines whose batches need
        a custom split (the mesh-global engine's replica/owner fork) provide
        their own pending type through the prepare_columns/issue_pending/
        finish_pending hooks instead of vetoing.

        `span` is the batcher's dispatch SpanContext: each pipeline stage
        emits a child span under it (and stage_duration exemplars carry its
        trace_id), so a coalesced flush decomposes per-stage in the trace
        view."""
        can = getattr(self.engine, "can_pipeline", None)
        if (
            not getattr(self.engine, "supports_pipeline", False)
            or getattr(self.engine, "store", None) is not None
            or (can is not None and not can(cols))
        ):
            return await self.check_columns(
                cols, now_ms=now_ms, launch_path=launch_path
            )
        self._count_decisions(cols.algo)
        from gubernator_tpu_torch.ops.engine import prepare_check_columns

        loop = asyncio.get_running_loop()

        def prepare():
            t0 = time.perf_counter()
            prepared = prepare_check_columns(self.engine, cols, now_ms=now_ms)
            self._observe_stage("put", t0, span)
            if self.metrics is not None:
                self._observe_shard_stages()
            return prepared

        prepared = await loop.run_in_executor(self._prep, prepare)
        return await self._issue_and_finish(
            prepared, span=span, launch_path=launch_path
        )

    async def check_wire(
        self, parts, now_ms=None, span=None, launch_path: str = "xla"
    ) -> Optional[ResponseColumns]:
        """Fused front-door check: pre-parsed WireBatch pieces
        (service/wire.py — native-parser lanes) staged straight into ONE
        compact ingress grid, no column concat and no HostBatch pack.
        Returns None when the batch cannot ride the fused path (engine not
        wire-capable, duplicate keys, non-encodable rows, Store attached) —
        the caller falls back to the columns path, which is semantically
        identical."""
        engine = self.engine
        if (
            not getattr(engine, "supports_wire_ingress", False)
            or getattr(engine, "store", None) is not None
        ):
            return None
        from gubernator_tpu_torch.ops.engine import prepare_check_wire

        loop = asyncio.get_running_loop()

        def prepare():
            t0 = time.perf_counter()
            prepared = prepare_check_wire(engine, parts, now_ms=now_ms)
            if prepared is not None:
                self._observe_stage("put", t0, span)
            return prepared

        prepared = await loop.run_in_executor(self._prep, prepare)
        if prepared is None:
            return None
        for p in parts:
            self._count_decisions(p.cols.algo)
        return await self._issue_and_finish(
            prepared, span=span, launch_path=launch_path
        )

    def _observe_stage(self, stage: str, t0: float, span) -> None:
        """One pipeline-stage observation: histogram sample (with the
        dispatch trace_id as its OpenMetrics exemplar) plus a child span
        under the dispatch span. Wall-clock ns for the span are derived
        from the same perf_counter interval the histogram measured."""
        dt = time.perf_counter() - t0
        if stage == "issue":
            self.issue_ewma = (
                dt if self.issue_ewma == 0.0
                else 0.9 * self.issue_ewma + 0.1 * dt
            )
        if self.metrics is not None:
            self.metrics.stage_duration.labels(stage=stage).observe(
                dt, exemplar=_exemplar(span)
            )
        if span is not None and tracing.exporter is not None:
            end_ns = time.time_ns()
            tracing.record_span(
                stage, tracing.new_span(span), span.span_id,
                end_ns - int(dt * 1e9), end_ns,
            )

    async def _issue_and_finish(
        self, prepared, span=None, launch_path: str = "xla"
    ) -> ResponseColumns:
        """Shared issue/finish halves of the pipelined dispatch: ISSUE on
        the engine thread (enqueue kernel launches, no fetch), FINISH on a
        fetch worker (materialize outputs, rare fixups back on the engine
        thread), stats folded in on the engine thread."""
        from gubernator_tpu_torch.ops.engine import (
            finish_check_columns,
            issue_check_columns,
        )

        loop = asyncio.get_running_loop()

        def issue(prepared):
            t0 = time.perf_counter()
            pending = issue_check_columns(self.engine, prepared)
            ready = _stage_fetch(pending)
            self._observe_stage("issue", t0, span)
            if self.metrics is not None:
                # feed-path accounting (docs/latency.md "Dispatch budget"):
                # ring = launched from the device-resident request ring's
                # serving loop, xla = the direct per-flush round-trip
                self.metrics.dispatch_launches.labels(path=launch_path).inc()
            return pending, ready

        def fixup(fn):
            # executes fn on the engine thread; called FROM a fetch thread
            # (never from the engine thread — that would deadlock the
            # single-worker executor)
            return self._exec.submit(fn).result()

        def finish(issued):
            pending, ready = issued
            t0 = time.perf_counter()
            if ready is not None:
                ready.synchronize()  # this dispatch's outputs, nothing else
            rc, delta = finish_check_columns(self.engine, pending, fixup)
            self._observe_stage("fetch", t0, span)
            # fire-and-forget, engine thread
            self._exec.submit(self._fold_stats, [delta], t0)
            return rc

        issued = await loop.run_in_executor(self._exec, lambda: issue(prepared))
        return await loop.run_in_executor(self._fetch, lambda: finish(issued))

    # ------------------------------------------------- fused ring drain
    # (ops/ring_drain.py) — the multi-slot twin of _issue_and_finish: one
    # ENGINE-THREAD drain decides a whole group of published ring slots,
    # one FETCH-THREAD wait decodes every slot's egress bank. Split into two
    # awaitables (not one) so the ring's consume loop can serialize LAUNCH
    # order across groups while group j's finish overlaps group j+1's
    # issue — the same pipelining shape the host issue loop has.

    async def drain_ring_issue(self, dring, group, start: int, span=None):
        """ENGINE-THREAD half of one fused drain
        (ring_drain.issue_ring_group: per-slot issue-time work in ticket
        order, stage each slot's grid + ingress fence, ONE drain over the
        group; on the card its claim is a ``fence_claim`` launch), then the
        copy of (bank, n) into pinned host buffers behind it. Returns
        (bank, (n, event)): the un-fetched pair and the event that marks
        its copy done, as drain_ring_finish takes them."""
        from gubernator_tpu_torch.ops.ring_drain import issue_ring_group

        loop = asyncio.get_running_loop()

        def issue():
            t0 = time.perf_counter()
            bank, n = issue_ring_group(self.engine, dring, group, start)
            (bank, n), ready = _to_host([bank, n])
            self._observe_stage("issue", t0, span)
            if self.metrics is not None:
                self.metrics.dispatch_launches.labels(path="fused").inc()
                self.metrics.ring_drain_slots.observe(len(group))
            return bank, (n, ready)

        return await loop.run_in_executor(self._exec, issue)

    async def drain_ring_finish(self, group, bank, n, span=None):
        """FETCH-THREAD half of one fused drain
        (ring_drain.finish_ring_group): wait for this drain's copy alone,
        then each slot's PendingCheck runs the standard finish (dropped-
        claim retries and shadow rehydrates via the engine thread, evictee
        harvest, cascade folds) over its egress slice. Returns the per-slot
        responses in ticket order."""
        from gubernator_tpu_torch.ops.ring_drain import finish_ring_group

        loop = asyncio.get_running_loop()
        n, ready = n

        def fixup(fn):
            return self._exec.submit(fn).result()

        def finish():
            t0 = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            done = finish_ring_group(self.engine, group, bank, n, fixup)
            self._observe_stage("fetch", t0, span)
            self._exec.submit(self._fold_stats, [d for _rc, d in done], t0)
            return [rc for rc, _delta in done]

        return await loop.run_in_executor(self._fetch, finish)

    def _fold_stats(self, deltas, t0: float) -> None:
        """Engine thread: merge finished dispatches' EngineStats deltas and
        refresh the engine's metric families (`t0`: the finish's start)."""
        for delta in deltas:
            self.engine.stats.merge(delta)
        if self.metrics is not None:
            self.metrics.dispatch_duration.observe(time.perf_counter() - t0)
            self.metrics.observe_engine(self.engine.stats)
            self._observe_probe_bytes()
            # GLOBAL batches ride the pipeline too: without this the
            # queue-length gauge would only ever be observed post-drain
            # (sync_global) and read 0 forever
            gs = getattr(self.engine, "global_stats", None)
            if gs is not None:
                self.metrics.observe_global(gs)

    def _observe_shard_stages(self) -> None:
        """Fold the mesh engine's host-staging split (route/pack/put ms
        accumulated in ShardedEngine._stage*) into the stage_duration
        summaries as shard_* labels — the mesh-path mirror of the local
        pipeline's put/issue/fetch stages, and the series the ingress bench
        reads to show staging cost ∝ batch rows. The compact-wire codec
        stages keep their own wire_pack/wire_decode labels, and the bytes
        the engine moved across the boundary feed the
        gubernator_tpu_wire_bytes_total counter so bytes/decision is
        scrapeable rather than bench-computed."""
        take = getattr(self.engine, "take_stage_deltas", None)
        if take is not None:
            for k, ms in take().items():
                if ms > 0:
                    label = k if k.startswith("wire_") else f"shard_{k}"
                    self.metrics.stage_duration.labels(stage=label).observe(
                        ms / 1e3
                    )
        wtake = getattr(self.engine, "take_wire_deltas", None)
        if wtake is not None:
            for direction, nbytes in wtake().items():
                if nbytes > 0:
                    self.metrics.wire_bytes.labels(direction=direction).inc(
                        nbytes
                    )
        otake = getattr(self.engine, "take_a2a_overflow_delta", None)
        if otake is not None:
            impl, rows = otake()
            if rows > 0:
                self.metrics.a2a_overflow.labels(impl=impl).inc(rows)

    def _observe_probe_bytes(self) -> None:
        """Refresh the gubernator_table_hbm_bytes_per_decision gauge from
        the engine's current layout × write-mode × probe-kernel × dispatch
        geometry (a few integer ops — the model, not a measurement)."""
        est = getattr(self.engine, "hbm_bytes_per_decision_estimate", None)
        if est is not None:
            self.metrics.table_hbm_bytes_per_decision.set(est())

    async def check_columns(
        self, cols: RequestColumns, now_ms: Optional[int] = None,
        launch_path: str = "xla",
    ) -> ResponseColumns:
        self._count_decisions(cols.algo)
        loop = asyncio.get_running_loop()

        def run():
            t0 = time.perf_counter()
            rc = self.engine.check_columns(cols, now_ms=now_ms)
            if self.metrics is not None:
                self.metrics.dispatch_launches.labels(path=launch_path).inc()
                self.metrics.dispatch_duration.observe(time.perf_counter() - t0)
                self._observe_shard_stages()
                self.metrics.observe_engine(self.engine.stats)
                self._observe_probe_bytes()
                gs = getattr(self.engine, "global_stats", None)
                if gs is not None:
                    self.metrics.observe_global(gs)
            return rc

        return await loop.run_in_executor(self._exec, run)

    async def install_columns(self, **kw) -> int:
        loop = asyncio.get_running_loop()

        def run():
            n = self.engine.install_columns(**kw)
            if self.metrics is not None:
                self.metrics.observe_engine(self.engine.stats)
            return n

        return await loop.run_in_executor(self._exec, run)

    async def sync_global(self) -> None:
        """One collective GLOBAL sync (mesh engines): drain pending hits
        through the all_gather/aggregate/install step, serialized onto the
        engine thread like every other table mutation. Metric observation
        happens HERE (on the engine thread) so observe_global's read-modify-
        write of its delta baseline is never concurrent with the dispatch
        path's."""
        loop = asyncio.get_running_loop()

        def run():
            t0 = time.perf_counter()
            self.engine.sync()
            if self.metrics is not None:
                self.metrics.global_send_duration.observe(time.perf_counter() - t0)
                self.metrics.observe_global(self.engine.global_stats)

        await loop.run_in_executor(self._exec, run)

    async def live_count(self) -> int:
        """Table live-key count, serialized onto the engine thread — reading
        engine.table from another thread races the donated-buffer dispatch."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._exec, self.engine.live_count)

    async def table_telemetry(self, now_ms: Optional[int] = None):
        """One background table-telemetry scan (ops/telemetry.py), split
        like a serving dispatch: the LAUNCH runs on the engine thread (the
        scan must read a coherent table — every mutation is single-writer
        there, and the enqueue costs microseconds), the FETCH runs on a
        dedicated telemetry thread so the device streams the table WHILE
        the engine thread keeps issuing serving dispatches. The scan is
        never on the serving path; its only engine-thread cost is the
        launch."""
        from gubernator_tpu_torch.ops.telemetry import finish_scan

        loop = asyncio.get_running_loop()
        if self._telemetry is None:
            self._telemetry = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="telemetry"
            )
        pending = await loop.run_in_executor(
            self._exec, lambda: self.engine.telemetry_begin(now_ms)
        )
        return await loop.run_in_executor(
            self._telemetry, lambda: finish_scan(pending)
        )

    async def snapshot(self) -> np.ndarray:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._exec, self.engine.snapshot)

    # ------------------------------------------------------------- tiering

    async def tier_demote_idle(
        self, idle_ms: int, max_rows: int = 1 << 16, now_ms=None
    ):
        """One demote-on-idle sweep (tier/manager.py): extract rows
        idle past the horizon AND tombstone them out of HBM in ONE
        engine-thread job — no decide can interleave between the read and
        the removal, so the demoted copy is exactly the state that left
        the table. Returns (now_ms, fps, canonical full rows); the caller
        (TierManager) appends them to the shadow. Crash ordering: a death
        after the tombstone but before the shadow append loses nothing
        the delta log doesn't still hold — restart replays the row back
        (no tombstone frame was written yet), which is the conservative
        direction."""
        loop = asyncio.get_running_loop()

        def run():
            from gubernator_tpu_torch.ops.engine import ms_now

            eng = self.engine
            now = now_ms if now_ms is not None else ms_now()
            fps, slots = eng.extract_idle(now, idle_ms, max_rows)
            if fps.shape[0] == 0:
                return now, fps, np.empty((0, 16), dtype=np.int32)
            eng.tombstone_fps(fps)
            # canonical rows at the shadow boundary (the one cross-layout
            # conversion point, ops/layout.py)
            full = np.asarray(eng.table.layout.unpack(slots))
            return now, fps, full

        return await loop.run_in_executor(self._exec, run)

    # ------------------------------------------------- incremental checkpoint
    # (service/checkpoint.py) — split like telemetry: take+launch atomically
    # on the engine thread, fetch on a dedicated lazy thread so the extract
    # streams off-device WHILE serving dispatches keep issuing.

    async def checkpoint_extract(self, now_ms: Optional[int] = None):
        """One checkpoint epoch's dirty-block extract: (epoch, gids, fps,
        slots). The tracker take() and the extract LAUNCH run in one
        engine-thread job — the ordering contract that makes every
        mark→mutate pair land wholly inside one epoch (ops/checkpoint.py)."""
        loop = asyncio.get_running_loop()

        def begin():
            tracker = self.engine.ckpt
            epoch, gids = tracker.take()
            if gids.shape[0] == 0:
                return epoch, gids, None
            return epoch, gids, self.engine.checkpoint_begin(gids, now_ms)

        epoch, gids, pending = await loop.run_in_executor(self._exec, begin)
        if pending is None:
            width = self.engine.table.layout.F
            return (
                epoch, gids,
                np.empty(0, dtype=np.int64),
                np.empty((0, width), dtype=np.int32),
            )
        if self._ckpt is None:
            self._ckpt = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt"
            )
        fps, slots = await loop.run_in_executor(
            self._ckpt, lambda: self.engine.checkpoint_finish(pending)
        )
        return epoch, gids, fps, slots

    async def checkpoint_snapshot(self):
        """(full table rows, epoch, slot layout) read atomically on the
        engine thread — the compaction input (rows coherent with the epoch
        counter AND the layout those bytes are in)."""
        loop = asyncio.get_running_loop()

        def run():
            tracker = self.engine.ckpt
            return (
                self.engine.snapshot(),
                tracker.epoch if tracker is not None else 0,
                self.engine.table.layout,
            )

        return await loop.run_in_executor(self._exec, run)

    # ---------------------------------------------------------- handoff ops
    # All three mutate (or scan state coherent with) the device table, so
    # they serialize onto the engine thread like every dispatch.

    async def extract_live(self, now_ms: Optional[int] = None):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, lambda: self.engine.extract_live(now_ms)
        )

    async def merge_rows(
        self, fps: np.ndarray, slots: np.ndarray,
        now_ms: Optional[int] = None, layout=None,
    ) -> int:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec,
            lambda: self.engine.merge_rows(fps, slots, now_ms, layout=layout),
        )

    async def tombstone_fps(self, fps: np.ndarray) -> int:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, lambda: self.engine.tombstone_fps(fps)
        )

    async def read_state(self, fps: np.ndarray):
        """(found, full-width slots) stored-state read — engine thread for
        a coherent table view (the GLOBAL broadcast aux source)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, lambda: self.engine.read_state(fps)
        )

    async def read_state_raw(self, fps: np.ndarray):
        """(found, slots, layout) stored-state read in the table's OWN slot
        layout — the region-sync sender's staging read. The layout is
        captured inside the same engine-thread job as the gather, so a
        concurrent layout migration can never mis-tag the rows."""
        loop = asyncio.get_running_loop()

        def run():
            found, slots = self.engine.read_state(fps, raw=True)
            return found, slots, self.engine.table.layout

        return await loop.run_in_executor(self._exec, run)

    async def apply_region(
        self, fps: np.ndarray, deltas: np.ndarray, cfg: dict,
        sender_slots, sender_layout,
    ) -> int:
        """Apply one received cross-region delta batch through the
        conservative merge (ops/reconcile.apply_region_sync). ONE engine
        job, so the read→reconcile→merge triplet is atomic with respect to
        serving dispatches — no concurrent hit slips between the stored-
        state read and the merge."""
        from gubernator_tpu_torch.ops.reconcile import apply_region_sync

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec,
            lambda: apply_region_sync(
                self.engine, fps, deltas, cfg, sender_slots, sender_layout
            ),
        )

    async def maybe_grow(self, **kw) -> bool:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, lambda: self.engine.maybe_grow(**kw)
        )

    def snapshot_sync(self) -> np.ndarray:
        """Synchronous snapshot for shutdown paths with no running loop."""
        return self._exec.submit(self.engine.snapshot).result()

    def close(self) -> None:
        if self._telemetry is not None:
            self._telemetry.shutdown(wait=True)
        if self._ckpt is not None:
            self._ckpt.shutdown(wait=True)
        self._prep.shutdown(wait=True)
        self._fetch.shutdown(wait=True)
        self._exec.shutdown(wait=True)

"""Incremental checkpointing — the daemon's durability plane (the port of
``gubernator_tpu/service/checkpoint.py``).

The seed persists nothing by default: the Loader hooks snapshot the whole
table at graceful shutdown only (reference store.go:49-78), so a `kill -9`
loses every counter since the last clean stop and a 100M-key cold restart
re-seeds for minutes. This manager bounds both:

* a background loop (GUBER_CHECKPOINT_INTERVAL_MS) takes the engine's dirty
  epoch (ops/checkpoint.EpochTracker — blocks touched since the last take),
  extracts just those blocks' live rows ON DEVICE (engine.checkpoint_begin
  on the engine thread, fetch off it — the telemetry scan's overlap split, so
  checkpointing overlaps serving), and appends one CRC-framed delta to the
  log beside the base snapshot (store.DeltaLog). Checkpoint cost is
  proportional to the write rate, never table size.
* every GUBER_CHECKPOINT_COMPACT_FRAMES frames the log compacts: one full
  snapshot becomes the new base (atomic rename FIRST), then the log resets
  — a crash between the two steps leaves stale deltas atop a newer base,
  which the epoch filter skips and the conservative merge renders harmless
  anyway.
* warm restart replays base + clean frame prefix through the engine's
  conservative merge (kernel2.merge2: remaining=min, expiry=max, OVER
  sticks) — a stale, duplicated, or torn checkpoint can only UNDER-grant.
  Recovery after an unclean death is bounded by the cadence: at most one
  interval of admitted writes is forgotten (re-granted), proven by the
  chaos test in tests/test_durability.py.

Failure discipline: a failed delta append re-arms the taken dirty set
(EpochTracker.remark) so a full disk defers dirt instead of dropping it; a
failed restore logs and cold-starts instead of dying at boot; a failed
shutdown snapshot is logged and counted, never allowed to wedge close().

The files are those of ``store.DeltaLog`` and ``store.save_snapshot``, byte
for byte the JAX package's, so a checkpoint either package wrote restores
into the other. Replay runs on the engine's own device: with ``walk="pallas"``
on the card each delta frame's merge is a ``probe_walk`` merge-stage launch.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

import numpy as np

log = logging.getLogger("gubernator_tpu_torch.checkpoint")


class CheckpointManager:
    """One daemon's incremental-checkpoint plane. Inert (enabled=False)
    unless GUBER_CHECKPOINT_INTERVAL_MS > 0 and a checkpoint path is
    configured — the classic restore-on-boot / snapshot-on-close Loader
    behavior is untouched then."""

    def __init__(self, daemon):
        self.daemon = daemon
        conf = daemon.conf
        self.interval_s = conf.checkpoint_interval_ms / 1e3
        self.compact_frames = int(conf.checkpoint_compact_frames)
        self.base_path = conf.checkpoint_path
        self.delta_path = conf.checkpoint_delta_path or (
            self.base_path + ".delta" if self.base_path else ""
        )
        self.enabled = self.interval_s > 0 and bool(self.base_path)
        self._log = None
        if self.enabled:
            from gubernator_tpu_torch.store import DeltaLog

            self._log = DeltaLog(self.delta_path)
        # epoch the on-disk base snapshot includes (frames ≤ this are
        # already compacted and skipped on replay)
        self.base_epoch = 0
        self.frames_since_compaction = 0
        self.last_epoch = 0  # last epoch durably persisted (frame or base)
        self.last_epoch_ts: Optional[float] = None  # wall time of ^
        self.last_error: Optional[str] = None
        self.replayed_frames = 0
        self.replayed_rows = 0
        self.restored = "none"  # none | cold | base | base+delta
        self._lock = asyncio.Lock()  # one checkpoint/compaction at a time

    # ---------------------------------------------------------------- boot
    def restore(self) -> None:
        """Warm restart: base snapshot + delta-frame replay, validated —
        any damage (missing/corrupt/geometry-mismatched base, torn log)
        degrades to a logged cold start, never a boot failure. Runs BEFORE
        the tracker attaches, so replay marks nothing dirty (the restored
        state already equals what is on disk)."""
        daemon = self.daemon
        engine = daemon.engine
        self.restored = "cold"
        rows = None
        base_layout = None
        if os.path.exists(self.base_path):
            from gubernator_tpu_torch.store import load_snapshot_meta

            try:
                rows, self.base_epoch, layout_name = load_snapshot_meta(
                    self.base_path
                )
                from gubernator_tpu_torch.ops.layout import LAYOUTS

                base_layout = LAYOUTS[layout_name]
            except Exception as exc:
                log.warning(
                    "base snapshot %s unreadable (%s); cold start",
                    self.base_path, exc,
                )
                daemon.metrics.checkpoint_errors.labels(stage="restore").inc()
                rows = None
        if rows is not None:
            try:
                # cross-layout restores (snapshot written under a different
                # GUBER_SLOT_LAYOUT) convert through the canonical full row
                # inside engine.restore
                engine.restore(np.asarray(rows), layout=base_layout)
                self.restored = "base"
            except Exception as exc:
                # geometry/schema mismatch (cache_size changed across
                # restart, corrupted array): serve cold rather than die
                log.warning(
                    "base snapshot %s does not fit the configured table "
                    "(%s); cold start", self.base_path, exc,
                )
                daemon.metrics.checkpoint_errors.labels(stage="restore").inc()
                self.base_epoch = 0
        self.last_epoch = self.base_epoch
        scan = self._log.scan()
        if scan.error:
            log.warning(
                "delta log %s: %s — replaying the clean %d-frame prefix, "
                "skipping %d bytes",
                self.delta_path, scan.error, len(scan.frames),
                scan.skipped_bytes,
            )
            daemon.metrics.checkpoint_errors.labels(stage="restore").inc()
            # repair BEFORE serving: appends land at the physical end of
            # the file but replay stops at the first bad frame, so new
            # frames written after a torn tail would be unreachable until
            # the next compaction — a second unclean death before then
            # would lose them, breaking the one-interval recovery bound
            try:
                self._log.repair(scan)
                log.info(
                    "delta log %s truncated to its %d-byte clean prefix",
                    self.delta_path, scan.clean_bytes,
                )
            except Exception as exc:
                self.last_error = f"delta-log repair: {exc}"
                daemon.metrics.checkpoint_errors.labels(
                    stage="restore"
                ).inc()
                log.warning(
                    "delta log repair failed (%s); frames appended before "
                    "the next compaction may not survive another unclean "
                    "death", exc,
                )
        from gubernator_tpu_torch.store import TOMBSTONE, fps_from_slots

        t0 = time.perf_counter()
        for epoch, _now_ms, slots, frame_layout in scan.frames:
            if epoch <= self.base_epoch:
                continue  # already compacted into the base
            if slots.shape[0] == 0:
                self.last_epoch = max(self.last_epoch, epoch)
                continue
            if frame_layout is TOMBSTONE:
                # demote-on-idle removal record (hot-set tiering): applied
                # in file order so a row demoted AFTER its last state
                # frame does not resurrect — it faults back from the
                # shadow spill instead (docs/tiering.md)
                try:
                    engine.tombstone_fps(fps_from_slots(slots))
                except Exception as exc:
                    log.warning(
                        "tombstone frame (epoch %d) replay failed (%s)",
                        epoch, exc,
                    )
                    daemon.metrics.checkpoint_errors.labels(
                        stage="restore"
                    ).inc()
                    break
                self.last_epoch = max(self.last_epoch, epoch)
                continue
            try:
                # frames written under another layout (restart with a
                # different GUBER_SLOT_LAYOUT) convert through the
                # canonical full row inside merge_rows — replay stays
                # conservative whatever the layouts
                engine.merge_rows(
                    fps_from_slots(slots), slots, layout=frame_layout
                )
            except Exception as exc:
                log.warning(
                    "delta frame (epoch %d) replay failed (%s); stopping "
                    "replay at the last clean frame", epoch, exc,
                )
                daemon.metrics.checkpoint_errors.labels(stage="restore").inc()
                break
            self.replayed_frames += 1
            self.replayed_rows += slots.shape[0]
            self.last_epoch = max(self.last_epoch, epoch)
        if self.restored == "base" and self.replayed_frames:
            self.restored = "base+delta"
        elif self.restored == "cold" and self.replayed_frames:
            self.restored = "delta"  # frames landed before the first base
        if self.restored != "cold":
            log.info(
                "warm restart: %s — base epoch %d + %d delta frames "
                "(%d rows) in %.1f ms",
                self.restored, self.base_epoch, self.replayed_frames,
                self.replayed_rows, (time.perf_counter() - t0) * 1e3,
            )
        self.last_epoch_ts = time.monotonic()

    def attach(self) -> None:
        """Create the engine's epoch tracker (clean — everything restored
        is already durable) and continue the epoch lineage past every
        frame on disk. Must run before the listeners start serving."""
        from gubernator_tpu_torch.ops.checkpoint import EpochTracker

        engine = self.daemon.engine
        engine.ckpt = EpochTracker(
            int(engine.table.n_buckets),  # per shard on a mesh
            n_shards=getattr(engine, "n_shards", 1),
            start_epoch=self.last_epoch,
        )

    # ---------------------------------------------------------------- loop
    async def loop(self) -> None:
        while not self.daemon._shutting_down:
            await asyncio.sleep(self.interval_s)
            try:
                await self.checkpoint_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("checkpoint tick failed")

    async def checkpoint_once(self) -> dict:
        """One delta epoch: take the dirty set + launch the extract
        atomically on the engine thread, fetch off it, append the frame off
        the event loop. A failed append re-arms the dirty set."""
        daemon = self.daemon
        async with self._lock:
            t0 = time.perf_counter()
            epoch, gids, fps, slots = await daemon.runner.checkpoint_extract()
            out = dict(
                epoch=epoch, dirty_blocks=int(gids.shape[0]),
                rows=int(fps.shape[0]), bytes=0,
            )
            if gids.shape[0] == 0:
                # nothing dirtied: the previous epoch is still fresh
                self.last_epoch = epoch
                self.last_epoch_ts = time.monotonic()
                self._observe_age()
                return out
            loop = asyncio.get_running_loop()
            now_ms = daemon.now_ms()
            lay = daemon.engine.table.layout
            try:
                nbytes = await loop.run_in_executor(
                    None, lambda: self._log.append(
                        epoch, now_ms, slots, layout=lay
                    )
                )
            except Exception as exc:
                # disk full / unwritable path: defer the dirt to the next
                # epoch instead of dropping it, count + surface the error
                daemon.engine.ckpt.remark(gids)
                self.last_error = f"delta append: {exc}"
                daemon.metrics.checkpoint_errors.labels(stage="delta").inc()
                log.warning("delta frame append failed: %s", exc)
                return {**out, "error": str(exc)}
            dt = time.perf_counter() - t0
            self.frames_since_compaction += 1
            self.last_epoch = epoch
            self.last_epoch_ts = time.monotonic()
            self.last_error = None
            m = daemon.metrics
            m.checkpoint_duration.labels(kind="delta").observe(dt)
            m.checkpoint_bytes.labels(kind="delta").inc(nbytes)
            m.checkpoint_rows.labels(kind="delta").inc(int(fps.shape[0]))
            self._observe_age()
            out["bytes"] = nbytes
        if self.frames_since_compaction >= self.compact_frames:
            await self.compact()
        return out

    async def append_tombstones(self, fps) -> int:
        """Record demote-on-idle removals in the delta log (hot-set
        tiering): one tombstone frame stamped with the UPCOMING epoch
        (tracker.epoch + 1 — always past the base even right after a
        compaction; the log reset at compaction discards it once the base
        itself no longer holds the rows). Failure is non-fatal: the row
        merely resurrects on a warm restart, which the fault-back merge
        renders harmless (docs/tiering.md)."""
        if not self.enabled or fps.shape[0] == 0:
            return 0
        daemon = self.daemon
        tracker = getattr(daemon.engine, "ckpt", None)
        epoch = (tracker.epoch + 1) if tracker is not None else (
            self.last_epoch + 1
        )
        now_ms = daemon.now_ms()
        loop = asyncio.get_running_loop()
        async with self._lock:
            try:
                return await loop.run_in_executor(
                    None,
                    lambda: self._log.append_tombstones(epoch, now_ms, fps),
                )
            except Exception as exc:
                self.last_error = f"tombstone append: {exc}"
                daemon.metrics.checkpoint_errors.labels(stage="delta").inc()
                log.warning("tombstone frame append failed: %s", exc)
                return 0

    async def compact(self) -> None:
        """Fold the delta log into a fresh base: full snapshot (engine
        thread for coherence, disk write off-loop, atomic rename), THEN
        log reset. Dirty bits marked since the snapshot stay armed — the
        next delta may duplicate a little state, which replay's
        conservative merge absorbs."""
        daemon = self.daemon
        async with self._lock:
            t0 = time.perf_counter()
            rows, epoch, lay = await daemon.runner.checkpoint_snapshot()
            loop = asyncio.get_running_loop()
            import torch

            from gubernator_tpu_torch.ops.table2 import live_count2, Table2
            from gubernator_tpu_torch.store import save_snapshot

            now_ms = daemon.now_ms()

            def write_base():
                # everything that touches disk stays off the event loop:
                # snapshot write + rename, log reset, size stat
                save_snapshot(self.base_path, rows, epoch,
                              layout_name=lay.name)
                self._log.reset()
                # the rows are already host-side; the live count is one
                # vectorized pass over memory the save just touched
                return (
                    live_count2(
                        Table2(rows=torch.from_numpy(rows), layout=lay), now_ms
                    ),
                    os.path.getsize(self.base_path),
                )

            try:
                base_rows, base_bytes = await loop.run_in_executor(
                    None, write_base
                )
            except Exception as exc:
                self.last_error = f"compaction: {exc}"
                daemon.metrics.checkpoint_errors.labels(stage="base").inc()
                log.warning("delta-log compaction failed: %s", exc)
                return
            dt = time.perf_counter() - t0
            self.base_epoch = epoch
            self.frames_since_compaction = 0
            self.last_epoch = max(self.last_epoch, epoch)
            self.last_epoch_ts = time.monotonic()
            self.last_error = None
            m = daemon.metrics
            m.checkpoint_duration.labels(kind="base").observe(dt)
            m.checkpoint_bytes.labels(kind="base").inc(base_bytes)
            m.checkpoint_rows.labels(kind="base").inc(base_rows)
            self._observe_age()
            log.info(
                "delta log compacted into base (epoch %d) in %.1f ms",
                epoch, dt * 1e3,
            )

    async def final_checkpoint(self) -> None:
        """Shutdown flush: one last compaction so the base alone carries
        the final state (the incremental plane's maybe_checkpoint analog).
        Caller guards exceptions — shutdown must always complete."""
        await self.compact()

    def _observe_age(self) -> None:
        self.daemon.metrics.checkpoint_epoch_age.set(self.epoch_age_s())

    def epoch_age_s(self) -> float:
        """Seconds since the last durable epoch — the live bound on what a
        kill -9 would lose right now."""
        if self.last_epoch_ts is None:
            return 0.0
        return max(0.0, time.monotonic() - self.last_epoch_ts)

    # --------------------------------------------------------------- status
    def status(self) -> dict:
        """/v1/debug/durability snapshot."""
        tracker = getattr(self.daemon.engine, "ckpt", None)
        out = {
            "enabled": self.enabled,
            "interval_ms": self.interval_s * 1e3,
            "base_path": self.base_path,
            "delta_path": self.delta_path,
            "restored": self.restored,
            "base_epoch": self.base_epoch,
            "last_epoch": self.last_epoch,
            "epoch_age_s": round(self.epoch_age_s(), 3),
            "frames_since_compaction": self.frames_since_compaction,
            "compact_frames": self.compact_frames,
            "delta_log_bytes": self._log.size_bytes() if self._log else 0,
            "replayed_frames": self.replayed_frames,
            "replayed_rows": self.replayed_rows,
            "last_error": self.last_error,
        }
        if tracker is not None:
            out["pending_dirty_blocks"] = tracker.dirty_blocks
            out["tracker_blk"] = tracker.blk
            out["marked_fps"] = tracker.marked_fps
        return out

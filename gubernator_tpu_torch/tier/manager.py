"""TierManager: the daemon's hot-set tiering plane (the port of
``gubernator_tpu/tier/manager.py``).

Inert unless GUBER_TIER_ENABLED — then it owns the ShadowTable, arms the
engine's evict capture + fault-back (engine.shadow), runs the
demote-on-idle sweep on the telemetry cadence, writes tombstone frames
into the delta log so demoted rows do not resurrect on warm restart
(service/checkpoint.append_tombstones), and feeds the gubernator_tier_*
metric families + /v1/debug/tier.

Sweep ordering (the crash-safety argument, docs/tiering.md):

  1. ONE engine-thread job extracts idle rows AND tombstones them out of
     the device table (EngineRunner.tier_demote_idle — no decide
     interleaves, so the demoted copy is exactly the state that left the table);
  2. the rows enter the shadow (RAM) and, when a spill file is
     configured, flush to it durably;
  3. only THEN the tombstone frame is appended to the delta log.

A death between (1) and (3) leaves the row's last state frame replayable
with no tombstone — restart resurrects it into the device table, which is the
conservative direction (the state survives; the capacity win of one
sweep is re-earned). A death after (3) finds the row in the spill, and
fault-back serves it from there.
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger("gubernator_tpu_torch.tier")

# rows demoted per sweep at most — bounds the engine-thread job the sweep
# enqueues (extract fetch + tombstone); the remainder demotes next sweep
SWEEP_MAX_ROWS = 1 << 16


class TierManager:
    def __init__(self, daemon):
        self.daemon = daemon
        conf = daemon.conf
        self.enabled = bool(getattr(conf, "tier_enabled", False))
        self.idle_ms = float(getattr(conf, "tier_idle_ms", 60_000.0))
        # sweep on the telemetry cadence; a disabled
        # telemetry loop falls back to its default 5 s so tiering does
        # not silently stop demoting
        self.sweep_s = (conf.telemetry_interval_ms or 5_000.0) / 1e3
        self.shadow = None
        self.sweeps = 0
        self.last_sweep_demoted = 0
        if self.enabled:
            from gubernator_tpu_torch.tier.shadow import ShadowTable

            self.shadow = ShadowTable(
                max_bytes=int(conf.tier_shadow_bytes),
                spill_path=conf.tier_spill_path or None,
            )

    # ----------------------------------------------------------------- boot
    def attach(self) -> None:
        """Arm the engine (evict capture + fault-back) and index an
        existing spill file. Must run AFTER the checkpoint restore (the
        delta replay — including tombstone frames — settles the device
        table first)
        and before the listeners serve."""
        if not self.enabled:
            return
        loaded = self.shadow.load()
        if loaded:
            log.info("tier shadow spill indexed %d rows", loaded)
        eng = self.daemon.engine
        if hasattr(eng, "attach_shadow"):
            eng.attach_shadow(self.shadow)
        else:
            eng.shadow = self.shadow
        log.info(
            "hot-set tiering armed: idle_ms=%d shadow_bytes=%d spill=%s",
            int(self.idle_ms), self.shadow.max_bytes,
            self.daemon.conf.tier_spill_path or "(none)",
        )

    # ----------------------------------------------------------------- sweep
    async def loop(self) -> None:
        while not self.daemon._shutting_down:
            await asyncio.sleep(self.sweep_s)
            try:
                await self.sweep_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("tier sweep tick failed")

    async def sweep_once(self) -> dict:
        """One demote-on-idle round; returns a summary for tests/debug."""
        daemon = self.daemon
        now, fps, rows = await daemon.runner.tier_demote_idle(
            int(self.idle_ms), SWEEP_MAX_ROWS
        )
        self.sweeps += 1
        self.last_sweep_demoted = int(fps.shape[0])
        out = {"demoted": self.last_sweep_demoted}
        if fps.shape[0]:
            self.shadow.offer(fps, rows, now, reason="idle")
            self.shadow.flush(now)
            # removal record for warm restart — AFTER the shadow holds
            # the rows (module docstring ordering)
            await daemon.checkpointer.append_tombstones(fps)
        self.observe()
        return out

    # --------------------------------------------------------------- status
    def observe(self) -> None:
        """Refresh the gubernator_tier_* families from shadow counters
        (delta-inc for the monotone ones, set for the gauges)."""
        if not self.enabled:
            return
        m = self.daemon.metrics
        st = self.shadow.stats()
        m.tier_shadow_rows.set(st["ram_rows"])
        m.tier_shadow_bytes.set(st["nominal_bytes"])
        if "spill" in st:
            m.tier_spilled_rows.set(st["spill"]["indexed_rows"])
        last = getattr(self, "_last", None) or {}
        for key, counter, labels in (
            ("demoted_evict", m.tier_demoted, {"reason": "evict"}),
            ("demoted_idle", m.tier_demoted, {"reason": "idle"}),
            ("promoted", m.tier_promoted, None),
            ("shed", m.tier_shed, None),
            ("promote_returned", m.tier_promote_returned, None),
        ):
            d = st[key] - last.get(key, 0)
            if d > 0:
                (counter.labels(**labels) if labels else counter).inc(d)
        self._last = {
            k: st[k]
            for k in ("demoted_evict", "demoted_idle", "promoted", "shed",
                      "promote_returned")
        }

    def debug(self) -> dict:
        """/v1/debug/tier snapshot."""
        out = {
            "enabled": self.enabled,
            "idle_ms": self.idle_ms,
            "sweep_interval_s": self.sweep_s,
            "sweeps": self.sweeps,
            "last_sweep_demoted": self.last_sweep_demoted,
        }
        if self.enabled:
            out["shadow"] = self.shadow.stats()
            out["evicted_live_total"] = self.daemon.engine.stats.evicted_unexpired
        return out

    def close(self, now_ms: int) -> None:
        """Shutdown flush (sync — runs in an executor off the loop):
        persist unspilled shadow rows so a graceful restart faults them
        back from disk."""
        if self.enabled and self.shadow is not None:
            self.shadow.flush(now_ms)

"""Single-device engine (the port of ``gubernator_tpu/ops/engine.py``,
serial check path).

Owns one device table and turns requests into responses: pack → plan
same-key passes → dispatch the decision kernel per pass → retry rows whose
claim dropped → fold cascade verdicts on the host. Batches are padded to
power-of-two sizes (floor 16), as in the JAX package, so both packages
dispatch identical shapes.

The device is explicit: ``device=None`` means the card, and without one
the constructor raises; tests pass ``device="cpu"``. Ingress is the
full-width (12, B) int64 grid; the compact wire, the pipelined
prepare/issue/finish protocol, the Store hooks and hot-set tiering are not
ported yet.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.ops.batch import (
    ERR_DROPPED,
    ERROR_STRINGS,
    HostBatch,
    RequestColumns,
    ResponseColumns,
    columns_from_requests,
    pack_columns,
    pack_host_batch,
    pad_batch,
)
from gubernator_tpu_torch.ops.kernel2 import decide2_packed_cols, unpack_outputs
from gubernator_tpu_torch.ops.layout import FULL, resolve_layout
from gubernator_tpu_torch.ops.plan import default_probe_kernel, plan_passes
from gubernator_tpu_torch.ops.table2 import (
    F as F_FULL,
    FLAGS,
    Table2,
    live_count2,
    new_table2,
    table_to_numpy,
)
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse, retry_after_ms


def default_write_mode() -> str:
    """"sparse" on every device, the TPU default. In the port the write mode
    only sets the claim geometry (and with it the window-overflow drop);
    every mode writes through the one slot_write kernel."""
    return "sparse"


def ms_now() -> int:
    # reference store.go MillisecondNow()
    return time.time_ns() // 1_000_000


def _pad_size(n: int, floor: int = 16) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _math_mode(hb: HostBatch) -> str:
    """Kernel specialization chosen host-side per dispatch: all-token
    batches run only the token lanes, all-GCRA batches only the TAT lanes,
    integer algorithms the int lanes, and a leaky row the float64 lanes.
    Padding rows carry algo=0 (token)."""
    algo = hb.algo
    if not algo.any():
        return "token"
    if (algo == 1).any():
        return "mixed"
    act = algo[np.asarray(hb.active)]
    if act.size and (act == 2).all():
        return "gcra"
    return "int"


def batch_needs_full_layout(layout, math: str, hb=None) -> bool:
    """Host-side: must the table migrate to the full layout to serve this
    batch?"""
    if layout is FULL:
        return False
    if not layout.supports_math(math):
        return True
    if hb is not None:
        if not layout.greg_ok and (np.asarray(hb.greg_interval) != 0).any():
            return True
        if not layout.supports_algos(hb.algo, hb.active):
            return True
    return False


def effective_math(layout, hb) -> str:
    """The dispatch's math mode, layout-adjusted: an all-padding batch takes
    the layout's own mode instead of forcing a spurious migration."""
    math = _math_mode(hb)
    if not layout.supports_math(math) and not np.asarray(hb.active).any():
        return layout.modes[0]
    return math


def _has_cascade(hb) -> bool:
    """Whether a packed batch carries cascade level bits (behavior 8-15)."""
    return bool((hb.behavior & np.int32(0xFF00)).any())


def _fold_cascades_host(behavior, status, remaining, reset, err) -> None:
    """Host-side cascade verdict fold over assembled response columns: each
    carrier row (level 0) takes deny-if-any status, min remaining and the
    latest reset among denying levels of its group (the level>0 rows that
    follow it). Rows with errors are excluded; arrays mutate in place."""
    lvl = (behavior.astype(np.int64) >> 8) & 0xFF
    if not lvl.any():
        return
    n = lvl.shape[0]
    member = lvl > 0
    idx = np.arange(n)
    carrier = np.maximum.accumulate(np.where(~member, idx, -1))
    carrier = np.where(carrier < 0, idx, carrier)
    ok = err == 0
    mrows = np.nonzero(member & ok)[0]
    if mrows.size == 0:
        return
    c = carrier[mrows]
    np.maximum.at(status, c, status[mrows])
    np.minimum.at(remaining, c, remaining[mrows])
    deny = mrows[status[mrows] != 0]
    if deny.size:
        deny_reset = np.zeros(n, dtype=reset.dtype)
        np.maximum.at(deny_reset, carrier[deny], reset[deny])
        crows = np.nonzero(~member & ok & (status != 0))[0]
        reset[crows] = np.maximum(reset[crows], deny_reset[crows])


@dataclass
class EngineStats:
    """Host-side accumulation of kernel BatchStats."""

    cache_hits: int = 0
    cache_misses: int = 0
    over_limit: int = 0
    evicted_unexpired: int = 0
    dropped: int = 0
    checks: int = 0
    dispatches: int = 0
    created_at_clamped: int = 0
    unprocessed_dropped: int = 0
    layout_migrations: int = 0


def serve_columns(engine, cols, now_ms, dispatch) -> ResponseColumns:
    """Columns-in/columns-out serving loop: pack + clamp-count, plan
    same-key passes, dispatch each (member-row fan-out, ERR_DROPPED for
    unpersisted rows), fold cascade verdicts. `dispatch(pass_batch, n_rows)`
    returns (status, limit, remaining, reset, dropped, cache_hit)."""
    now = now_ms if now_ms is not None else ms_now()
    hb, err = pack_columns(cols, now, tolerance_ms=engine.created_at_tolerance_ms)
    engine.stats.created_at_clamped += int(
        ((cols.created_at != 0) & (hb.created_at != cols.created_at)).sum()
    )
    n = hb.fp.shape[0]
    status = np.zeros(n, dtype=np.int32)
    limit_o = np.zeros(n, dtype=np.int64)
    remaining = np.zeros(n, dtype=np.int64)
    reset = np.zeros(n, dtype=np.int64)
    for p in plan_passes(hb, max_exact=engine.max_exact_passes):
        np_ = len(p.rows)
        s, l, r, t, dropped, _hit = dispatch(p.batch, np_)
        if p.member_rows:
            # fan the aggregate's response out to every member row
            members = np.concatenate(p.member_rows)
            src = np.repeat(np.arange(np_), [len(m) for m in p.member_rows])
            status[members] = s[src]
            limit_o[members] = l[src]
            remaining[members] = r[src]
            reset[members] = t[src]
            err[members[dropped[src]]] = ERR_DROPPED
        else:
            rows = p.rows
            status[rows] = s[:np_]
            limit_o[rows] = l[:np_]
            remaining[rows] = r[:np_]
            reset[rows] = t[:np_]
            err[rows[dropped[:np_]]] = ERR_DROPPED
    engine.stats.checks += n
    if _has_cascade(hb):
        # the authoritative cascade fold (the port folds on the host only)
        _fold_cascades_host(hb.behavior, status, remaining, reset, err)
    return ResponseColumns(
        status=status, limit=limit_o, remaining=remaining,
        reset_time=reset, err=err,
    )


class LocalEngine:
    """One device-resident rate-limit table + its dispatch loop."""

    # single-device dispatches preserve row order, but the port does not
    # carry the in-kernel cascade fold: cascades fold on the host
    supports_cascade_intrace = False

    def __init__(
        self,
        capacity: int = 50_000,
        max_exact_passes: int = 8,
        write_mode: Optional[str] = None,
        created_at_tolerance_ms: Optional[int] = None,
        layout: Optional[str] = None,
        device=None,
        store=None,
    ):
        if store is not None:
            raise NotImplementedError("the Store write-through hooks are not ported yet")
        self.device = resolve_device(device)
        # GUBER_PROBE_KERNEL=pallas raises: the fused kernel is not ported
        self.probe_mode = default_probe_kernel()
        self.table = new_table2(capacity, layout=resolve_layout(layout), device=self.device)
        self.write_mode = write_mode or default_write_mode()
        if self.write_mode not in ("sweep", "sparse", "xla"):
            raise ValueError(
                f"write_mode must be 'sweep', 'sparse' or 'xla', got {self.write_mode!r}"
            )
        self.max_exact_passes = max_exact_passes
        self.max_claim_retries = 3
        self.created_at_tolerance_ms = created_at_tolerance_ms
        self.stats = EngineStats()

    def attach_shadow(self, shadow) -> None:
        raise NotImplementedError("hot-set tiering (the shadow table) is not ported yet")

    # ---------------------------------------------------------- slot layout

    def _batch_needs_full(self, math: str, hb=None) -> bool:
        return batch_needs_full_layout(self.table.layout, math, hb)

    def _effective_math(self, hb: HostBatch) -> str:
        return effective_math(self.table.layout, hb)

    def migrate_layout_full(self, reason: str = "off-family traffic") -> bool:
        """Migrate a packed table to the canonical full layout (one row
        unpack on the device). Returns True when a migration happened."""
        lay = self.table.layout
        if lay is FULL:
            return False
        logging.getLogger("gubernator_tpu_torch.engine").warning(
            "migrating table layout %s -> full (%s)", lay.name, reason
        )
        self.table = Table2(rows=lay.unpack_rows(self.table.rows).contiguous(), layout=FULL)
        self.stats.layout_migrations += 1
        return True

    # ------------------------------------------------------------- dispatch

    def _decide_packed(self, hb: HostBatch, cascade: bool = False) -> np.ndarray:
        """One dispatch: the full-width (12, B) int64 ingress grid in, the
        packed (B+2, 4) int64 output fetched. Updates the table in place."""
        if cascade:
            raise NotImplementedError(
                "the in-kernel cascade fold is not ported (supports_cascade_intrace)"
            )
        math = self._effective_math(hb)
        if self._batch_needs_full(math, hb):
            self.migrate_layout_full()
        arr = torch.from_numpy(pack_host_batch(hb)).to(self.device)
        self.table, packed = decide2_packed_cols(
            self.table, arr, write=self.write_mode, math=math, probe=self.probe_mode
        )
        return packed.cpu().numpy()

    def _retry_dropped(
        self, batch, n, status, limit, remaining, reset, dropped, hit, retries
    ):
        """Re-dispatch dropped rows (evictions + dispatches counted only)
        until persisted or the attempt budget runs out. Mutates the response
        arrays in place; returns the final dropped mask."""
        while dropped.any() and retries < self.max_claim_retries:
            rows = np.nonzero(dropped)[0]
            sub = HostBatch(*[f[:n][rows] for f in batch])
            sub = pad_batch(sub, _pad_size(len(rows)))
            m = len(rows)
            (s2, l2, r2, t2, d2, h2), st = unpack_outputs(self._decide_packed(sub), m)
            self.stats.dispatches += 1
            self.stats.evicted_unexpired += st[3]
            status[rows], limit[rows], remaining[rows], reset[rows] = s2, l2, r2, t2
            hit[rows] = h2
            nd = np.zeros(n, dtype=bool)
            nd[rows] = d2
            dropped = nd
            retries += 1
        return dropped

    def _dispatch_with_retry(self, batch, n: int, cascade: bool = False):
        """Run one unique-fp pass; rows whose claim dropped are re-dispatched
        up to `max_claim_retries` times in all, then surface ERR_DROPPED."""
        (status, limit, remaining, reset, dropped, hit), st = unpack_outputs(
            self._decide_packed(batch, cascade), n
        )
        self.stats.cache_hits += st[0]
        self.stats.cache_misses += st[1]
        self.stats.over_limit += st[2]
        self.stats.evicted_unexpired += st[3]
        self.stats.dispatches += 1
        dropped = self._retry_dropped(
            batch, n, status, limit, remaining, reset, dropped, hit, retries=0
        )
        self.stats.dropped += int(dropped.sum())
        return status, limit, remaining, reset, dropped, hit

    def _redispatch_rows(self, batch, n: int):
        """Re-dispatch rows whose phase-1 claim dropped: accounts dispatches,
        evictions and final drops only (hits/misses/over were counted by
        the phase-1 pass); this dispatch is retry #1."""
        batch = pad_batch(batch, _pad_size(n))
        (status, limit, remaining, reset, dropped, hit), st = unpack_outputs(
            self._decide_packed(batch), n
        )
        self.stats.dispatches += 1
        self.stats.evicted_unexpired += st[3]
        dropped = self._retry_dropped(
            batch, n, status, limit, remaining, reset, dropped, hit, retries=1
        )
        self.stats.dropped += int(dropped.sum())
        return status, limit, remaining, reset, dropped, hit

    def check(
        self, requests: Sequence[RateLimitRequest], now_ms: Optional[int] = None
    ) -> List[RateLimitResponse]:
        """Apply a batch; responses come back in request order."""
        if not requests:
            return []
        now = now_ms if now_ms is not None else ms_now()
        rc = self.check_columns(columns_from_requests(requests), now_ms=now)
        return [
            RateLimitResponse(
                status=int(rc.status[i]),
                limit=int(rc.limit[i]),
                remaining=int(rc.remaining[i]),
                reset_time=int(rc.reset_time[i]),
                error=ERROR_STRINGS[int(rc.err[i])],
                retry_after_ms=retry_after_ms(
                    int(rc.status[i]), int(rc.reset_time[i]), now
                ),
            )
            for i in range(len(requests))
        ]

    def check_columns(
        self, cols: RequestColumns, now_ms: Optional[int] = None
    ) -> ResponseColumns:
        """Vectorized serving path: columns in, columns out (request order).
        Per-request validation errors come back as ERR_* codes."""

        def dispatch(pass_batch, n_rows: int):
            batch = pad_batch(pass_batch, _pad_size(n_rows))
            return self._dispatch_with_retry(batch, n_rows)

        return serve_columns(self, cols, now_ms, dispatch)

    # ------------------------------------------------------- table surface

    def live_count(self, now_ms: Optional[int] = None) -> int:
        return live_count2(self.table, now_ms if now_ms is not None else ms_now())

    def snapshot(self) -> np.ndarray:
        """Device→host copy of the whole table (the Loader.Save analog)."""
        return table_to_numpy(self.table)

    def restore(self, rows: np.ndarray, layout=None) -> None:
        """Host→device restore of a snapshot. A snapshot written under a
        different slot layout converts through the canonical full row when
        the bucket geometry matches; the engine's own layout is kept unless
        the snapshot holds rows it cannot store (then it migrates to full)."""
        lay = self.table.layout
        rows = np.asarray(rows)
        if layout is not None and layout is not lay:
            if rows.shape[:-1] != tuple(self.table.rows.shape[:-1]):
                raise ValueError(
                    f"snapshot geometry {rows.shape} incompatible with "
                    f"table {tuple(self.table.rows.shape)}"
                )
            full = layout.unpack_rows(torch.from_numpy(np.ascontiguousarray(rows)))
            slots = full.reshape(-1, F_FULL)
            occupied = (slots[:, 0] != 0) | (slots[:, 1] != 0)
            if not lay.supports_algos((slots[:, FLAGS] & 0xFF)[occupied].numpy()):
                self.migrate_layout_full("restore of off-family snapshot")
                lay = self.table.layout
            rows = lay.pack_rows(full).numpy()
        if rows.shape != tuple(self.table.rows.shape):
            raise ValueError(
                f"snapshot shape {rows.shape} != table {tuple(self.table.rows.shape)}"
            )
        self.table = Table2(
            rows=torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(
                self.device, copy=True
            ),
            layout=lay,
        )

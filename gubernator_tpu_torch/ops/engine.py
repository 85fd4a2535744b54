"""Single-device engine (the port of ``gubernator_tpu/ops/engine.py``).

Owns one device table and turns requests into responses: pack → plan
same-key passes → dispatch the decision kernel per pass → retry rows whose
claim dropped → fold cascade verdicts (in the dispatch for single-pass
batches, then on the host). Batches are padded to power-of-two sizes
(floor 16), as in the JAX package, so both packages dispatch identical
shapes. The peer plane's walks, ``install_columns`` (GLOBAL
UpdatePeerGlobals) and ``merge_rows`` (handoff / region-sync
TransferState), run on the same table.

``probe=`` / GUBER_PROBE_KERNEL picks the decide walk and ``walk=`` /
GUBER_WALK_KERNEL the install and merge walks: "xla" (gather, sort-based
claim, slot_write) or "pallas" (the fused probe walk, ops/probe_walk.py).

``wire=`` / GUBER_WIRE_COMPACT picks the ingress: "compact" (the 5-lane
int32 grid of ops/wire.py, the default on the card) or "full" (the (12, B)
int64 grid, the default on the CPU and the parity oracle). A compact
engine still ships a batch the narrow layout cannot represent full-width.

Besides the serial path (``check_columns``), the pipelined protocol is
ported: ``prepare_check_columns`` (pack, plan, stage each pass's ingress;
touches no engine state) → ``issue_check_columns`` (launch every pass, no
fetch) → ``finish_check_columns`` (fetch, decode, retry dropped claims
through ``fixup``). ``prepare_check_wire`` and ``prepare_ring_slot`` are
its fused front door: pre-packed parser lanes (service/wire.WireBatch)
scattered into one compact grid, for a direct dispatch or a ring slot
(ops/ring_drain.py).

The device is explicit: ``device=None`` means the card, and without one
the constructor raises; tests pass ``device="cpu"``. All table work runs
on the current stream of the engine's device.

The maintenance surface the service runner calls is ported too: the
handoff reads and writes (``extract_live``, ``merge_rows``,
``tombstone_fps``, ``read_state``), the idle sweep's read
(``extract_idle``), the telemetry scan (``telemetry_begin``), incremental
checkpoints (``ckpt``, an ``ops/checkpoint.EpochTracker`` marked at every
table mutation; ``checkpoint_begin`` / ``checkpoint_finish``) and growth
(``resize``, ``maybe_grow``: a host rehash, as in the JAX package).

Hot-set tiering: ``attach_shadow(tier.ShadowTable)`` arms the evictee
sidecar on every decide dispatch (the victim rows ride the one fetched
output and demote to the shadow, ``_harvest_evictees``) and the
fault-back, which takes the batch's shadowed keys out of the shadow and
merges them into the table before the decide, with a miss re-check of the
rows that merge handed back. ``store=`` (a ``store.Store``) fires a
``ChangeSet`` of the persisted per-key state after every check and
rehydrates device cache misses from ``get_many``; a Store engine takes the
columns path, never the fused front door.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.ops import wire as wire_mod
from gubernator_tpu_torch.ops.batch import (
    ERR_DROPPED,
    ERROR_STRINGS,
    HostBatch,
    InstallBatch,
    RequestColumns,
    ResponseColumns,
    columns_from_requests,
    created_at_tolerance_ms,
    pack_columns,
    pack_host_batch,
    pad_batch,
)
from gubernator_tpu_torch.ops.kernel2 import (
    decide2_packed_cols,
    install2_impl,
    merge2_impl,
    unpack_outputs,
)
from gubernator_tpu_torch.ops.layout import FULL, resolve_layout
from gubernator_tpu_torch.ops.plan import (
    Pass,
    default_probe_kernel,
    default_walk_kernel,
    plan_passes,
)
from gubernator_tpu_torch.ops.table2 import (
    F as F_FULL,
    FLAGS,
    K,
    Table2,
    extract_idle_rows,
    extract_live_rows,
    gather_slots_impl,
    live_count2,
    n_buckets_for,
    new_table2,
    rehash_rows,
    table_to_numpy,
    tombstone_rows_impl,
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


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A staged host array on `device`. On the card the copy leaves from
    pinned memory without blocking the host; PyTorch's pinned-memory
    allocator holds the staging buffer until the copy has run, so it is
    never reused early."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _occurrence_rank(fps: np.ndarray) -> np.ndarray:
    """Per-row occurrence index of its fingerprint (0 for the first, 1 for
    the second duplicate, …): the merge path's analog of the planner's
    same-key pass split."""
    n = fps.shape[0]
    order = np.argsort(fps, kind="stable")
    sorted_f = fps[order]
    first = np.concatenate([[True], sorted_f[1:] != sorted_f[:-1]])
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(first, idx, -1))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = idx - start
    return rank


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

    def merge(self, d: "EngineStats") -> None:
        """Fold a pipelined check's stats delta in."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(d, f.name))


def _plan(engine, hb):
    """One batch's pass plan: the engine's `plan` hook when it has one (the
    mesh engine with dedup="device" plans O(1), ops/plan.single_pass), else
    the host group-by planner."""
    plan = getattr(engine, "plan", None)
    if plan is not None:
        return plan(hb)
    return plan_passes(hb, max_exact=engine.max_exact_passes)


def serve_columns(engine, cols, now_ms, dispatch) -> ResponseColumns:
    """Columns-in/columns-out serving loop: pack + clamp-count, fault-back
    from the shadow, plan same-key passes, dispatch each (member-row
    fan-out, ERR_DROPPED for unpersisted rows; on pass 0 the Store
    rehydrate and the tiering miss re-check), fire the Store write-through,
    fold cascade verdicts. `dispatch(pass_batch, n_rows, cascade)` returns
    (status, limit, remaining, reset, dropped, cache_hit); `cascade` asks
    for the fold in the dispatch."""
    now = now_ms if now_ms is not None else ms_now()
    hb, err = pack_columns(cols, now, tolerance_ms=engine.created_at_tolerance_ms)
    engine.stats.created_at_clamped += int(
        ((cols.created_at != 0) & (hb.created_at != cols.created_at)).sum()
    )
    # fault-back: shadowed keys re-enter the table through the conservative
    # merge BEFORE their decide (this path runs on the engine thread); the
    # putback fps feed the miss re-check below
    _, promote_putback = promote_rows(engine, shadow_probe(engine, hb.fp, now), now)
    n = hb.fp.shape[0]
    status = np.zeros(n, dtype=np.int32)
    limit_o = np.zeros(n, dtype=np.int64)
    remaining = np.zeros(n, dtype=np.int64)
    reset = np.zeros(n, dtype=np.int64)
    passes = _plan(engine, hb)
    has_casc = _has_cascade(hb)
    # the fold in the dispatch needs the whole batch in one pass (carrier
    # adjacency); the host fold below completes every other case
    casc_intrace = has_casc and len(passes) == 1 and engine.supports_cascade_intrace
    store = engine.store
    for pi, p in enumerate(passes):
        np_ = len(p.rows)
        outs = dispatch(p.batch, np_, cascade=casc_intrace)
        if pi == 0 and store is not None:
            # cache miss → consult the store and re-apply against hydrated
            # state (reference algorithms.go:45-51); later passes hit what
            # pass 0 created
            outs = _rehydrate_misses(engine, p.batch, np_, outs, now, dispatch)
        if pi == 0 and getattr(engine, "shadow", None) is not None:
            outs, _ = _shadow_rehydrate(
                engine, p.batch, np_, outs, np.asarray(p.batch.active[:np_]), now,
                lambda fn: fn(), promote_putback,
            )
        s, l, r, t, dropped, _hit = outs
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
    if store is not None:
        ok = np.nonzero((err == 0) & (hb.fp != 0))[0]
        if ok.size:
            store.on_change(_store_change_set(
                hb.fp, now, hb.algo, status, limit_o, remaining, reset, hb.duration,
                hb.burst, hb.created_at, ok,
            ))
    if has_casc:
        # the authoritative fold, AFTER the Store hook (the store records
        # each key's own state; only the carrier's response takes the
        # verdict); idempotent over a carrier folded in the dispatch
        _fold_cascades_host(hb.behavior, status, remaining, reset, err)
    return ResponseColumns(
        status=status, limit=limit_o, remaining=remaining,
        reset_time=reset, err=err,
    )


# --------------------------------------------------------------- tiering
# Hot-set tiering (gubernator_tpu_torch/tier/): the fault-back probe, the
# promote through the conservative merge, and the miss re-check of rows a
# promote handed back to the shadow.


def shadow_probe(engine, fps: np.ndarray, now_ms: int):
    """Fault-back probe: exact-match the batch's fingerprints against the
    host-RAM shadow and REMOVE the hits — (fps, canonical rows) or None.
    Hits must be installed through the conservative merge BEFORE the
    batch's decide dispatch (promote_rows / PendingCheck.promote)."""
    shadow = getattr(engine, "shadow", None)
    if shadow is None:
        return None
    pf, rows = shadow.take(fps, now_ms)
    if pf.shape[0] == 0:
        return None
    return pf, rows


def promote_rows(engine, promote, now_ms: int):
    """Install a shadow_probe result through kernel2.merge2 (engine thread:
    mutates the table, on its stream before the decide that follows). A
    stale, duplicated or raced promote can only UNDER-grant. Live rows the
    installs displace demote onward to the shadow (merge2's evictee
    sidecar), and promote rows whose claim dropped (> K same-bucket
    inserters in one batch) retry and finally RETURN to the shadow.
    Returns (installed_count, putback_fps): the fingerprints handed BACK
    to the shadow, the miss re-check's eligibility set. Rows the DECIDE
    dispatch itself later evicts are not eligible: their decide served
    from pre-evict state, and re-dispatching them would apply their hits
    twice."""
    if promote is None:
        return 0, np.empty(0, dtype=np.int64)
    pf, rows = promote
    shadow = getattr(engine, "shadow", None)
    total = 0
    putback = []
    for _ in range(max(1, getattr(engine, "max_claim_retries", 3))):
        n, mask, ev_fps, ev_rows = engine.merge_rows(
            pf, rows, now_ms=now_ms, layout=FULL, collect=True
        )
        total += n
        if shadow is not None and ev_fps.shape[0]:
            shadow.offer(ev_fps, ev_rows, now_ms=0, reason="evict")
            putback.append(ev_fps)
        if mask.all():
            pf = pf[:0]
            break
        pf, rows = pf[~mask], rows[~mask]
    if shadow is not None and pf.shape[0]:
        shadow.offer(pf, rows, now_ms=0, reason="return")
        putback.append(pf)
    if not putback:
        return total, np.empty(0, dtype=np.int64)
    return total, np.concatenate(putback)


def _batch_fps(batch, n: int) -> np.ndarray:
    """Output-row-aligned fingerprints of a pass batch (HostBatch or the
    fused front door's lazy wire batch, read without packing)."""
    if isinstance(batch, HostBatch):
        return np.asarray(batch.fp[:n])
    return batch.fp_view()[:n]


def _shadow_rehydrate(engine, batch, n, outs, active, now, redispatch, eligible):
    """Tiering miss re-check: device-reported misses whose state the
    PROMOTE handed back to the shadow (`eligible`, promote_rows' putback
    fps) are promoted through the conservative merge and RE-DISPATCHED,
    overwriting their phase-1 fresh-grant responses. Single-shot: a
    residual miss keeps its fresh grant and the state stays shadowed for
    the next batch. `redispatch(fn)` runs fn on the engine thread and
    returns its result. Returns (outs, changed)."""
    shadow = getattr(engine, "shadow", None)
    if shadow is None or eligible is None or eligible.shape[0] == 0:
        return outs, False
    s, l, r, t, dropped, hit = outs
    miss = ~hit[:n] & active
    if not miss.any():
        return outs, False
    rows = np.nonzero(miss)[0]
    fps = _batch_fps(batch, n)[rows]
    has = np.isin(fps, eligible) & shadow.contains(fps)
    if not has.any():
        return outs, False
    # one re-dispatch row per fingerprint: duplicate-fp rows (mesh member
    # fan-outs) keep their phase-1 response, the first occurrence carries
    # the correction
    sel = np.nonzero(has)[0]
    _, first = np.unique(fps[sel], return_index=True)
    fr = rows[sel[np.sort(first)]]
    sub_fps = _batch_fps(batch, n)[fr]

    def run():
        promote_rows(engine, shadow_probe(engine, sub_fps, now), now)
        sub = HostBatch(*[f[fr] for f in batch])
        return engine._redispatch_rows(sub, len(fr))

    s2, l2, r2, t2, d2, h2 = redispatch(run)
    m = len(fr)
    s[fr], l[fr], r[fr], t[fr] = s2[:m], l2[:m], r2[:m], t2[:m]
    dropped[fr] = d2[:m]
    hit[fr] = h2[:m]
    return (s, l, r, t, dropped, hit), True


# ---------------------------------------------------------------- Store
# The write-through hook (gubernator_tpu_torch/store.Store): a ChangeSet of
# the persisted per-key state after every check, and the cache-miss
# rehydrate from `get_many` before a decision stands.


def _rehydrate_misses(engine, batch, n: int, outs, now: int, dispatch):
    """Re-hydrate device cache misses from the Store: install found rows
    and re-dispatch just those requests against the stored state,
    overwriting their phase-1 (fresh-create) responses. The install
    overwrites the phase-1 slot, so hits apply exactly once."""
    s, l, r, t, dropped, hit = outs
    active = np.asarray(batch.active[:n])
    miss = ~hit[:n] & active
    if not miss.any():
        return outs
    rows = np.nonzero(miss)[0]
    res = engine.store.get_many(np.asarray(batch.fp[rows]), now)
    if res is None:
        return outs
    found = np.asarray(res["found"])
    if not found.any():
        return outs
    fr = rows[found]
    engine.install_columns(
        fp=np.asarray(batch.fp[fr]),
        algo=np.asarray(res["algo"])[found],
        status=np.asarray(res["status"])[found],
        limit=np.asarray(res["limit"])[found],
        remaining=np.asarray(res["remaining"])[found],
        reset_time=np.asarray(res["reset_time"])[found],
        duration=np.asarray(res["duration"])[found],
        now_ms=now,
        burst=np.asarray(res["burst"])[found],
        stamp=np.asarray(res["stamp"])[found],
    )
    sub = HostBatch(*[f[fr] for f in batch])
    m = len(fr)
    prev_status = s[fr].copy()
    prev_dropped = dropped[fr].copy()
    s2, l2, r2, t2, d2, h2 = dispatch(sub, m)
    for dst, src in ((s, s2), (l, l2), (r, r2), (t, t2), (dropped, d2), (hit, h2)):
        dst[fr] = src[:m]
    # a rehydrated row is ONE miss-then-warm, not a miss plus a hit: undo
    # the re-dispatch's counting, and the phase-1 over_limit / dropped of
    # rows the hydrated re-run superseded
    engine.stats.cache_hits -= int(h2[:m].sum())
    engine.stats.cache_misses -= int((~h2[:m]).sum())
    engine.stats.over_limit -= int((prev_status == 1).sum())
    engine.stats.dropped -= int((prev_dropped & ~d2[:m]).sum())
    return s, l, r, t, dropped, hit


def _store_change_set(fp, now, algo, status, limit, remaining, reset, duration, burst,
                      stamp, rows):
    """The ChangeSet of `rows`: one row per unique fingerprint, the LAST
    occurrence's state (a state delta, not a request log; reference
    OnChange carries the stored item, store.go:66-70)."""
    from gubernator_tpu_torch.store import ChangeSet

    rev = rows[::-1]
    _, pos = np.unique(fp[rev], return_index=True)
    keep = rev[pos]
    return ChangeSet(
        fps=fp[keep], created_at=now, algo=algo[keep],
        status=status[keep].astype(np.int32), limit=limit[keep],
        remaining=remaining[keep], reset_time=reset[keep], duration=duration[keep],
        burst=burst[keep], stamp=stamp[keep],
    )


# ---------------------------------------------------- pipelined protocol
# prepare (any thread: pack, plan, stage) → issue (engine thread: launch,
# no fetch) → finish (fetch thread: fetch, decode, retry through `fixup`).


class PendingCheck:
    """An in-flight pipelined check: every pass's dispatch has been issued
    (outputs are device tensors) and nothing fetched yet."""

    __slots__ = (
        "hb", "err", "now", "passes", "clamped", "stacked", "rows", "mark",
        "casc", "casc_intrace", "promote", "promote_putback",
    )

    def __init__(self, hb, err, now, passes, clamped, rows=None, mark=None, casc=False,
                 casc_intrace=False, promote=None):
        self.stacked = None  # same-shape pass outputs fused for ONE fetch
        self.hb = hb
        self.err = err
        self.now = now
        self.passes = passes  # [[Pass, n_rows, padded batch, staged / output]]
        self.clamped = clamped
        # total request rows (fused wire batches carry no eager HostBatch)
        self.rows = rows if rows is not None else int(hb.fp.shape[0])
        # fingerprints the checkpoint tracker marks dirty at issue time
        self.mark = mark
        # `casc`: the batch carries cascade level bits; `casc_intrace`: its
        # dispatches fold verdicts themselves (single pass), so finish
        # re-folds on the host only after a dropped-row retry
        self.casc = casc
        self.casc_intrace = casc_intrace
        # shadow fault-back rows (fps, canonical rows), probed out of the
        # shadow at prepare and merged by issue_check_columns on the engine
        # thread BEFORE the launches, so a promoted row's state is ahead of
        # the decide that needs it
        self.promote = promote
        # fps the promote handed back to the shadow (the miss re-check's
        # eligibility set), set at issue
        self.promote_putback = None


class _LazyWireBatch:
    """Padded HostBatch of a fused wire batch, materialized ONLY if a
    dropped-claim retry needs it (the fused path skips pack_columns).
    Duck-types the HostBatch uses of the retry: field iteration and the
    padded row count."""

    __slots__ = ("_parts", "_now", "_tol", "rows", "_hb")

    def __init__(self, parts, now, tol, rows):
        self._parts = parts  # RequestColumns pieces, concatenated on demand
        self._now = now
        self._tol = tol
        self.rows = rows  # padded dispatch rows
        self._hb = None

    def _materialize(self) -> HostBatch:
        if self._hb is None:
            if len(self._parts) == 1:
                cols = self._parts[0]
            else:
                cols = RequestColumns(
                    *[np.concatenate([p[k] for p in self._parts])
                      for k in range(len(self._parts[0]))]
                )
            hb, _ = pack_columns(cols, self._now, tolerance_ms=self._tol)
            self._hb = pad_batch(hb, self.rows)
        return self._hb

    def __iter__(self):
        return iter(self._materialize())

    def fp_view(self) -> np.ndarray:
        """Fingerprint column without materializing the HostBatch."""
        if self._hb is not None:
            return np.asarray(self._hb.fp)
        if len(self._parts) == 1:
            return self._parts[0].fp
        return np.concatenate([p.fp for p in self._parts])


def _padded_rows(batch) -> int:
    """Padded dispatch rows of a pass batch (HostBatch or lazy wire batch)."""
    if isinstance(batch, HostBatch):
        return int(batch.fp.shape[0])
    return batch.rows


def _assemble_wire_parts(engine, parts, now_ms=None, pad_to=None):
    """Gating + single-scatter grid assembly of the fused wire paths (direct
    front door and ring slots): pre-packed lanes are scattered into ONE
    padded compact grid. Returns None when the batch needs the general
    columns path (engine not compact, Store attached, non-encodable rows,
    duplicate fingerprints, created_at skew beyond ±511 ms, all-error
    batch, or more rows than `pad_to`), else (grid, cols_list, err, now, n, act_fp,
    clamped, casc, tol, pad). `pad_to` fixes the padded width (a ring
    slot); by default the width is the bucketed dispatch size."""
    if not getattr(engine, "supports_wire_ingress", False) or not engine.supports_pipeline:
        return None
    if engine.store is not None:
        return None
    if not all(bool(p.encodable.all()) for p in parts):
        return None
    cols_list = [p.cols for p in parts]
    n = sum(c.fp.shape[0] for c in cols_list)
    if n == 0 or (pad_to is not None and n > pad_to):
        return None
    one = len(cols_list) == 1
    fp = cols_list[0].fp if one else np.concatenate([c.fp for c in cols_list])
    err = cols_list[0].err.copy() if one else np.concatenate([c.err for c in cols_list])
    active = err == 0
    n_act = int(active.sum())
    if n_act == 0:
        return None  # all-error batch: the columns path produces it
    act_fp = fp[active]
    # unique-fingerprint contract: duplicate keys need the pass planner
    if np.unique(act_fp).size != n_act:
        return None
    now = now_ms if now_ms is not None else ms_now()
    created = (
        cols_list[0].created_at if one
        else np.concatenate([c.created_at for c in cols_list])
    )
    tol = engine.created_at_tolerance_ms
    if tol is None:
        tol = created_at_tolerance_ms()
    stamped = np.where(created == 0, now, created)
    clipped = np.clip(stamped, now - tol, now + tol)
    clamped = int((clipped != stamped).sum())
    base = int(clipped[int(np.argmax(active))])
    delta = clipped - base
    if ((delta[active] < -wire_mod.DELTA_BIAS)
            | (delta[active] > wire_mod.DELTA_BIAS - 1)).any():
        return None
    pad = pad_to if pad_to is not None else _pad_size(n)
    grid = wire_mod.assemble_wire_grid([p.lanes for p in parts], clipped, base, pad, active)
    # unique fingerprints make the batch single-pass, so a cascade folds in
    # the dispatch
    casc = wire_mod.grid_has_cascade(grid, n)
    return grid, cols_list, err, now, n, act_fp, clamped, casc, tol, pad


def _wire_pending(engine, assembled, staged):
    """PendingCheck over one assembled wire grid (direct or ring slot)."""
    _grid, cols_list, err, now, n, act_fp, clamped, casc, tol, pad = assembled
    lazy = _LazyWireBatch(cols_list, now, tol, pad)
    p = Pass(rows=np.arange(n), batch=lazy, member_rows=[])
    return PendingCheck(
        hb=lazy, err=err, now=now, passes=[[p, n, lazy, staged]], clamped=clamped,
        rows=n, mark=act_fp, casc=casc, casc_intrace=casc, promote=shadow_probe(engine, act_fp, now),
    )


def prepare_check_wire(engine, parts, now_ms=None) -> "PendingCheck | None":
    """Fused front door: pre-packed parser lanes (service/wire.WireBatch
    pieces) scattered into ONE staged compact grid. Returns a PendingCheck
    for issue/finish, or None when the batch needs the general columns
    path (same semantics, the full pack)."""
    assembled = _assemble_wire_parts(engine, parts, now_ms=now_ms)
    if assembled is None:
        return None
    grid, n = assembled[0], assembled[4]
    staged = engine.stage_wire(grid, wire_mod.grid_math_mode(grid, n), cascade=assembled[7])
    return _wire_pending(engine, assembled, staged)


class RingSlotPrep:
    """One ring slot's prepared dispatch (no engine state): the host grid
    padded to the ring's fixed slot width, the static math/cascade modes
    the ring groups slots by, and the PendingCheck that finish consumes
    once the drain's egress bank is fetched. The engine thread stages the
    grid (ops/ring_drain.DeviceRing.stage)."""

    __slots__ = ("grid", "math", "cascade", "pending")

    def __init__(self, grid, math, cascade, pending):
        self.grid = grid
        self.math = math
        self.cascade = cascade
        self.pending = pending


def prepare_ring_slot(engine, parts, width: int, now_ms=None) -> "RingSlotPrep | None":
    """Ring-slot variant of prepare_check_wire: the same gating and grid,
    padded to the ring's fixed `width`. None sends the chunk down the
    per-slot path (including chunks wider than the slot)."""
    assembled = _assemble_wire_parts(engine, parts, now_ms=now_ms, pad_to=width)
    if assembled is None:
        return None
    grid, n, casc = assembled[0], assembled[4], assembled[7]
    return RingSlotPrep(grid, wire_mod.grid_math_mode(grid, n), casc,
                        _wire_pending(engine, assembled, None))


def prepare_check_columns(engine, cols, now_ms=None) -> PendingCheck:
    """Preparation half (any thread, no engine state): pack, clamp, plan
    same-key passes and stage each pass's single ingress transfer.

    An engine whose batches the generic split cannot express (the GLOBAL
    mesh engine's replica / owner fork) provides `prepare_columns`, which
    returns its own pending object, or None to take the generic path for a
    batch without such rows; issue and finish then go to its
    `issue_pending` / `finish_pending`."""
    hook = getattr(engine, "prepare_columns", None)
    if hook is not None:
        alt = hook(cols, now_ms=now_ms)
        if alt is not None:
            return alt
    now = now_ms if now_ms is not None else ms_now()
    hb, err = pack_columns(cols, now, tolerance_ms=engine.created_at_tolerance_ms)
    clamped = int(((cols.created_at != 0) & (hb.created_at != cols.created_at)).sum())
    plan = _plan(engine, hb)
    casc = _has_cascade(hb)
    casc_intrace = casc and len(plan) == 1 and engine.supports_cascade_intrace
    passes = []
    for p in plan:
        n = len(p.rows)
        batch, staged = engine.stage_pass(p.batch, n, cascade=casc_intrace)
        passes.append([p, n, batch, staged])
    return PendingCheck(
        hb=hb, err=err, now=now, passes=passes, clamped=clamped, mark=hb.fp, casc=casc,
        casc_intrace=casc_intrace, promote=shadow_probe(engine, hb.fp, now),
    )


def issue_check_columns(engine, pending: PendingCheck) -> PendingCheck:
    """Engine-thread half: launch every staged pass WITHOUT fetching (later
    passes depend only on device state). Each entry's staged ingress is
    replaced by its output, a device tensor until finish fetches it."""
    if not isinstance(pending, PendingCheck):  # an engine's own pending
        return engine.issue_pending(pending)
    if pending.promote is not None:
        _, pending.promote_putback = promote_rows(engine, pending.promote, pending.now)
        pending.promote = None
    if pending.mark is not None and getattr(engine, "ckpt", None) is not None:
        # dirty-block marks for incremental checkpoints: the same engine-
        # thread job as the launches below (ops/checkpoint.py)
        engine.ckpt.mark(pending.mark)
    for entry in pending.passes:
        _p, _n, batch, staged = entry
        entry[3] = engine.issue_staged(staged, _padded_rows(batch))
    pending.stacked = _stack_pass_outputs([_pending_out(entry[3]) for entry in pending.passes])
    return pending


# A pass's pending handle is its output tensor here; the JAX package's mesh
# engines issue (staged, out) tuples, so the two helpers keep that shape.
def _pending_out(pend):
    return pend[1] if isinstance(pend, tuple) else pend


def _pending_with_out(pend, out):
    return (pend[0], out) if isinstance(pend, tuple) else out


def _stack_pass_outputs(outs):
    """Fuse same-shape, same-dtype pass outputs into one stacked tensor, so
    finish fetches once (None when there is nothing to fuse). A batch can
    mix compact (int32) and full-width (int64) passes; stacking those would
    promote the int32 outputs and lose the dtype the decoder reads."""
    if len(outs) < 2:
        return None
    shape = getattr(outs[0], "shape", None)
    if shape is None or any(getattr(o, "shape", None) != shape for o in outs[1:]):
        return None
    dtype = outs[0].dtype
    if any(o.dtype != dtype for o in outs[1:]):
        return None
    return torch.stack(list(outs))


def finish_check_columns(engine, pending: PendingCheck, fixup):
    """Fetch-thread half: fetch each pass's output and assemble the
    response. Claim drops re-dispatch through `fixup(fn)`, which runs fn on
    the engine thread and returns its result, and so does the tiering miss
    re-check. Returns (ResponseColumns, EngineStats delta) for the caller
    to merge on the engine thread. Store engines take the serial path (the
    runner routes them there): the Store contract orders rehydrates and
    write-throughs against every same-key dispatch."""
    if not isinstance(pending, PendingCheck):  # an engine's own pending
        return engine.finish_pending(pending, fixup)
    if pending.stacked is not None:
        fetched = pending.stacked.cpu().numpy()  # ONE fetch for every pass
        for i, entry in enumerate(pending.passes):
            entry[3] = _pending_with_out(entry[3], fetched[i])
    err, n = pending.err, pending.rows
    status = np.zeros(n, dtype=np.int32)
    limit_o = np.zeros(n, dtype=np.int64)
    remaining = np.zeros(n, dtype=np.int64)
    reset = np.zeros(n, dtype=np.int64)
    delta = EngineStats(created_at_clamped=pending.clamped, checks=n)
    retried_any = False
    for pi, (p, np_, batch, pend) in enumerate(pending.passes):
        (s, l, r, t, dropped, hit), st, uncounted = engine.finish_staged(pend, np_)
        delta.cache_hits += st[0]
        delta.cache_misses += st[1]
        delta.over_limit += st[2]
        delta.evicted_unexpired += st[3]
        delta.dispatches += 1
        if dropped.any():
            # contended-claim retries mutate the table → engine thread
            retried_any = True
            rows = np.nonzero(dropped)[0]

            def retry(rows=rows, batch=batch, uncounted=uncounted):
                sub = HostBatch(*[f[rows] for f in batch])
                unc = uncounted[rows] if uncounted is not None else None
                return engine._redispatch_rows(sub, len(rows), uncounted=unc)

            s2, l2, r2, t2, d2, h2 = fixup(retry)
            s[rows], l[rows], r[rows], t[rows] = s2, l2, r2, t2
            dropped[rows] = d2
            hit[rows] = h2
        if pi == 0 and getattr(engine, "shadow", None) is not None:
            # tiering miss re-check through the same fixup. A fused wire
            # batch has no activity column: its inactive rows are exactly
            # its error rows
            if isinstance(batch, HostBatch):
                act = np.asarray(batch.active[:np_])
            else:
                act = (err == 0)[:np_]
            (s, l, r, t, dropped, hit), changed = _shadow_rehydrate(
                engine, batch, np_, (s, l, r, t, dropped, hit), act, pending.now, fixup,
                pending.promote_putback,
            )
            retried_any = retried_any or changed
        if p.member_rows:
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
    if pending.casc and (retried_any or not pending.casc_intrace):
        # the fold in the dispatch predates any retry; the idempotent host
        # fold makes the carriers authoritative again
        hbm = pending.hb
        if not isinstance(hbm, HostBatch):
            hbm = hbm._materialize()
        _fold_cascades_host(hbm.behavior, status, remaining, reset, err)
    rc = ResponseColumns(status=status, limit=limit_o, remaining=remaining,
                         reset_time=reset, err=err)
    return rc, delta


class LocalEngine:
    """One device-resident rate-limit table + its dispatch loop."""

    # single-device dispatches preserve row order, so single-pass cascade
    # batches fold in the dispatch (kernel2.fold_cascade_packed)
    supports_cascade_intrace = True
    supports_grow = True  # resize()/maybe_grow() are real (cf. ShardedEngine)
    supports_pipeline = True  # prepare/issue/finish split

    def __init__(
        self,
        capacity: int = 50_000,
        max_exact_passes: int = 8,
        write_mode: Optional[str] = None,
        created_at_tolerance_ms: Optional[int] = None,
        layout: Optional[str] = None,
        device=None,
        store=None,
        probe: Optional[str] = None,
        walk: Optional[str] = None,
        wire: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        # ingress format: "compact" (ops/wire.py) or "full"; per-dispatch
        # encodability still sends a compact engine's batch full-width
        if wire is not None and wire not in ("compact", "full"):
            raise ValueError(f"wire must be 'compact' or 'full', got {wire!r}")
        self.wire = wire or wire_mod.default_wire_mode(self.device)
        # the decide walk (probe=, GUBER_PROBE_KERNEL) and the install /
        # merge walks (walk=, GUBER_WALK_KERNEL), flipped independently
        if probe is not None and probe not in ("xla", "pallas"):
            raise ValueError(f"probe must be 'xla' or 'pallas', got {probe!r}")
        self.probe_mode = probe or default_probe_kernel()
        if walk is not None and walk not in ("xla", "pallas"):
            raise ValueError(f"walk must be 'xla' or 'pallas', got {walk!r}")
        self.walk_mode = walk or default_walk_kernel()
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
        # incremental-checkpoint epoch tracker (ops/checkpoint.EpochTracker),
        # attached by the checkpoint service; None costs nothing
        self.ckpt = None
        # the write-through hook (store.Store): a ChangeSet after every
        # check, get_many on device cache misses (reference store.go:63-78)
        self.store = store
        # hot-set tiering (tier.ShadowTable, attach_shadow): non-None arms
        # the evictee sidecar of every decide and the fault-back
        self.shadow = None
        # padded batch sizes dispatched (the JAX package re-warms their
        # compiles after a resize; the runner and the roofline read them)
        self._seen_pad_sizes: set = set()
        self.last_dispatch_rows = 0
        # reason string when a failed launch left device state suspect
        # (read by the daemon's health check; never set on this path)
        self.poisoned: Optional[str] = None

    def _mark_dirty(self, fps) -> None:
        """Checkpoint hook: mark the touched fingerprints' blocks in the
        epoch tracker, on the engine thread, in the same job as the
        mutation it precedes."""
        if self.ckpt is not None:
            self.ckpt.mark(np.asarray(fps))

    # ------------------------------------------------------------- tiering

    @property
    def _evictees(self) -> bool:
        """Whether dispatches carry the evictee sidecar: with a shadow
        attached."""
        return self.shadow is not None

    def attach_shadow(self, shadow) -> None:
        """Arm hot-set tiering: evict capture and fault-back from `shadow`
        (tier.ShadowTable). Call before serving: a dispatch's sidecar is
        decoded by the flag as it stands at that dispatch's fetch."""
        self.shadow = shadow

    def _harvest_evictees(self, host_arr: np.ndarray) -> None:
        """Demote-on-evict: decode the sidecar of a fetched dispatch output
        (issued with evictees=True) and offer the victim rows to the
        shadow. It reads the host copy the response decode reads, so the
        sidecar costs no second fetch; the stats row's evicted_unexpired
        cell gates the decode, so a dispatch that evicted nothing pays one
        cell read. Expiry filtering is left to `take` (the request
        timeline's clock)."""
        if self.shadow is None:
            return
        if int(host_arr[-2, 3]) == 0:
            return
        from gubernator_tpu_torch.ops.kernel2 import unpack_evictees

        fps, rows = unpack_evictees(host_arr)
        if fps.shape[0]:
            self.shadow.offer(fps, rows, now_ms=0, reason="evict")

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
        """One dispatch: one ingress transfer (the compact grid when the
        engine is compact and the batch encodable, else the full-width
        grid) and one output fetch, int32 or int64 (unpack_outputs reads
        the dtype). Updates the table in place. `cascade` folds cascade
        verdicts in the dispatch."""
        self._mark_dirty(hb.fp)
        math = self._effective_math(hb)
        if self._batch_needs_full(math, hb):
            self.migrate_layout_full()
        dev, wired = self._stage_ingress(hb)
        out = self._issue_from_dev(dev, int(hb.fp.shape[0]), math, wired, cascade).cpu().numpy()
        if self._evictees:
            # the serial path fetched right here: demote the victims before
            # the caller decodes the responses
            self._harvest_evictees(out)
        return out

    def _stage_ingress(self, batch: HostBatch):
        """Stage ONE ingress tensor for a padded batch: the compact wire
        block when the engine is compact and the batch representable
        (wire.wire_encodable), else the full-width grid. Returns (device
        tensor, compact?)."""
        if self.wire == "compact":
            base = wire_mod.pick_base(batch)
            if wire_mod.wire_encodable(batch, base):
                return _to_device(wire_mod.pack_wire_full(batch, base), self.device), True
        return _to_device(pack_host_batch(batch), self.device), False

    def _issue_from_dev(self, dev_arr, batch_rows: int, math: str, wired: bool = False,
                        cascade: bool = False) -> torch.Tensor:
        """Issue one dispatch from a staged ingress tensor WITHOUT fetching:
        the table advances now; the output stays on the device."""
        kw = dict(write=self.write_mode, math=math, cascade=cascade,
                  probe=self.probe_mode, evictees=self._evictees)
        if wired:
            self.table, packed = wire_mod.decide2_wire_cols(self.table, dev_arr, **kw)
        else:
            self.table, packed = decide2_packed_cols(self.table, dev_arr, **kw)
        return packed

    # ------------------------------------------------- pipelined protocol

    @property
    def supports_wire_ingress(self) -> bool:
        """Whether the fused front door (prepare_check_wire) may target this
        engine: compact engines only; full-width stays the parity oracle."""
        return self.wire == "compact"

    def stage_pass(self, pass_batch: HostBatch, n: int, cascade: bool = False):
        """(padded batch, staged tuple) for one unique-fp pass; the tuple is
        (ingress tensor, math, compact?, cascade, needs full layout?)."""
        batch = pad_batch(pass_batch, _pad_size(n))
        math = self._effective_math(batch)
        dev, wired = self._stage_ingress(batch)
        return batch, (dev, math, wired, cascade, self._batch_needs_full(math, batch))

    def stage_wire(self, grid: np.ndarray, math: str, cascade: bool = False):
        """Stage a fused front-door grid (wire.assemble_wire_grid) as the
        same staged tuple stage_pass builds. Wire grids carry no Gregorian
        rows and their algorithm family is implied by the math mode, so the
        layout check needs no batch."""
        return (_to_device(grid, self.device), math, True, cascade,
                self._batch_needs_full(math))

    def issue_staged(self, staged, batch_rows: int) -> torch.Tensor:
        dev, math, wired, cascade, needs_full = staged
        if needs_full:
            self.migrate_layout_full()  # engine thread: the table's only writer
        self._seen_pad_sizes.add(batch_rows)
        self.last_dispatch_rows = batch_rows
        return self._issue_from_dev(dev, batch_rows, math, wired, cascade)

    def hbm_bytes_per_decision_estimate(self) -> float:
        """Modeled table bytes the walk moves per decision at the last
        dispatch geometry (probe_walk.hbm_bytes_per_decision)."""
        from gubernator_tpu_torch.ops.probe_walk import hbm_bytes_per_decision

        rows = self.last_dispatch_rows or max(self._seen_pad_sizes, default=4096)
        return hbm_bytes_per_decision(self.table.layout, rows, int(self.table.rows.shape[-2]),
                                      self.write_mode, self.probe_mode)

    def finish_staged(self, pending, n: int):
        """Fetch one pass's output → ((s, l, r, t, dropped, hit), (hits,
        misses, over, evicted), uncounted). Every row of a single-device
        dispatch reaches the kernel, so `uncounted` is None. With a shadow
        the fetched array carries the evictee sidecar, harvested here, on
        the fetch thread, before the response decode."""
        arr = pending.cpu().numpy() if isinstance(pending, torch.Tensor) else np.asarray(pending)
        if self._evictees:
            self._harvest_evictees(arr)
        outs, st = unpack_outputs(arr, n)
        return outs, st, None

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
        self._seen_pad_sizes.add(int(batch.fp.shape[0]))
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

    def _redispatch_rows(self, batch, n: int, uncounted=None):
        """Re-dispatch rows whose phase-1 claim dropped: accounts dispatches,
        evictions and final drops only (hits/misses/over were counted by
        the phase-1 pass); this dispatch is retry #1. `uncounted` is the
        mesh engines' concern and is ignored here."""
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

        def dispatch(pass_batch, n_rows: int, cascade: bool = False):
            batch = pad_batch(pass_batch, _pad_size(n_rows))
            return self._dispatch_with_retry(batch, n_rows, cascade)

        return serve_columns(self, cols, now_ms, dispatch)

    # ------------------------------------------------------------ peer plane

    def install_columns(
        self,
        fp: np.ndarray,
        algo: np.ndarray,
        status: np.ndarray,
        limit: np.ndarray,
        remaining: np.ndarray,
        reset_time: np.ndarray,
        duration: np.ndarray,
        now_ms: Optional[int] = None,
        burst: Optional[np.ndarray] = None,
        stamp: Optional[np.ndarray] = None,
        aux: Optional[np.ndarray] = None,
        rem_store: Optional[np.ndarray] = None,
    ) -> int:
        """Install owner-authoritative GLOBAL statuses as fresh items — the
        UpdatePeerGlobals receive path (reference gubernator.go:434-474).
        Returns the number installed. `burst`/`stamp` default to the wire
        path's rebuild (burst=limit, stamp=now); `aux`/`rem_store` carry
        sliding-window state when the broadcast has it."""
        now = now_ms if now_ms is not None else ms_now()
        n = fp.shape[0]
        if n == 0:
            return 0
        if burst is None:
            burst = np.asarray(limit, dtype=np.int64)
        if stamp is None:
            stamp = np.full(n, now, dtype=np.int64)
        if not self.table.layout.supports_algos(algo):
            self.migrate_layout_full("install of off-family algorithms")
        self._mark_dirty(fp)
        size = _pad_size(n)

        def pad(a, dtype):
            out = np.zeros(size, dtype=dtype)
            out[:n] = a
            return torch.from_numpy(out).to(self.device)

        inst = InstallBatch(
            fp=pad(fp, np.int64),
            algo=pad(algo, np.int32),
            status=pad(status, np.int32),
            limit=pad(limit, np.int64),
            remaining=pad(remaining, np.int64),
            reset_time=pad(reset_time, np.int64),
            duration=pad(duration, np.int64),
            now=pad(np.full(n, now, dtype=np.int64), np.int64),
            active=pad(np.ones(n, dtype=bool), bool),
            burst=pad(burst, np.int64),
            stamp=pad(stamp, np.int64),
            aux=None if aux is None else pad(aux, np.int64),
            rem_store=None if rem_store is None else pad(rem_store, np.int64),
        )
        self.table, installed = install2_impl(
            self.table, inst, write=self.write_mode, probe=self.walk_mode
        )
        self.stats.dispatches += 1
        return int(installed.sum())

    def _slots_to_full(self, slots: np.ndarray, layout=None) -> np.ndarray:
        """Incoming slot rows in the canonical full layout. With no explicit
        layout, a 16-field row is full and an 8-field row is this table's
        own packed layout."""
        if layout is None:
            if slots.shape[1] == FULL.F:
                layout = FULL
            elif slots.shape[1] == self.table.layout.F:
                layout = self.table.layout
            else:
                raise ValueError(f"cannot infer slot layout for width {slots.shape[1]}")
        # a received chunk's rows are a read-only view of the request bytes
        return layout.unpack(torch.from_numpy(np.require(slots, np.int32, ["C", "W"]))).numpy()

    def merge_rows(
        self, fps: np.ndarray, slots: np.ndarray,
        now_ms: Optional[int] = None, layout=None, collect: bool = False,
    ):
        """Conservatively merge transferred slot rows (the TransferState
        receive path): remaining = min, expiry = max, newest config wins.
        Returns the number merged. `slots` may come in any sender layout
        (`layout`; inferred for full-width and same-layout rows); the merge
        runs on canonical rows. Duplicate fingerprints merge as sequential
        passes.

        ``collect=True`` (unique fingerprints only) returns (count, merged
        mask (n,), evictee fps, evictee canonical rows): which rows landed,
        and the live rows their installs displaced."""
        n = fps.shape[0]
        if n == 0:
            if collect:
                return 0, np.zeros(0, dtype=bool), np.empty(0, dtype=np.int64), \
                    np.empty((0, 16), dtype=np.int32)
            return 0
        slots = self._slots_to_full(slots, layout)
        rank = _occurrence_rank(fps)
        if rank.max() > 0:
            if collect:
                raise ValueError("merge_rows(collect=True) requires unique fingerprints")
            return sum(
                self.merge_rows(fps[rank == r], slots[rank == r], now_ms)
                for r in range(int(rank.max()) + 1)
            )
        if not self.table.layout.supports_algos(slots[:, FLAGS] & 0xFF):
            self.migrate_layout_full("merge of off-family rows")
        now = now_ms if now_ms is not None else ms_now()
        self._mark_dirty(fps)
        size = _pad_size(n)
        fp_p = np.zeros(size, dtype=np.int64)
        fp_p[:n] = fps
        slots_p = np.zeros((size, slots.shape[1]), dtype=np.int32)
        slots_p[:n] = slots
        active = np.zeros(size, dtype=bool)
        active[:n] = True
        dev = lambda a: torch.from_numpy(a).to(self.device)
        args = (self.table, dev(fp_p), dev(slots_p),
                dev(np.full(size, now, dtype=np.int64)), dev(active))
        if collect:
            self.table, merged, ev = merge2_impl(
                *args, write=self.write_mode, evictees=True, probe=self.walk_mode
            )
            self.stats.dispatches += 1
            mask = merged.cpu().numpy()[:n].copy()
            ev_h = ev.cpu().numpy()
            ev_fp = (ev_h[:, 1].astype(np.int64) << 32) | (ev_h[:, 0].astype(np.int64) & 0xFFFFFFFF)
            keep = ev_fp != 0
            return int(mask.sum()), mask, ev_fp[keep], ev_h[keep].copy()
        self.table, merged = merge2_impl(*args, write=self.write_mode, probe=self.walk_mode)
        self.stats.dispatches += 1
        return int(merged.sum())

    # ------------------------------------------------------------- handoff
    # extract packs every live slot on the device and fetches the live
    # prefix; merge applies transferred slots conservatively; tombstone
    # zeroes acked rows so they are neither served nor snapshotted again.

    def _dev_fps(self, fps: np.ndarray):
        """(padded fps, active mask) tensors on the engine's device."""
        n = fps.shape[0]
        size = _pad_size(n)
        fp_p = np.zeros(size, dtype=np.int64)
        fp_p[:n] = fps
        active = np.zeros(size, dtype=bool)
        active[:n] = True
        return (torch.from_numpy(fp_p).to(self.device),
                torch.from_numpy(active).to(self.device))

    def extract_live(self, now_ms: Optional[int] = None):
        """All live slots as (fps (N,) int64, slots (N, F) int32) host
        arrays, in table order and the table's own layout: the device
        filters and packs, the host fetches the live prefix."""
        now = now_ms if now_ms is not None else ms_now()
        return extract_live_rows(self.table.rows, now, layout=self.table.layout)

    def extract_idle(self, now_ms: int, idle_ms: int, max_rows: int = 1 << 16):
        """Live rows idle past `idle_ms`: (fps (N,) int64, slots (N, F)
        int32), N ≤ max_rows — the idle sweep's read half (the runner pairs
        it with tombstone_fps in one engine-thread job)."""
        return extract_idle_rows(self.table.rows, now_ms, idle_ms,
                                 layout=self.table.layout, max_rows=max_rows)

    def read_state(self, fps: np.ndarray, raw: bool = False):
        """The stored slots of `fps`, read without mutating anything:
        (found (n,) bool, slots (n, 16) int32 canonical fields), or with
        ``raw=True`` the slots re-packed into this table's own layout ((n,
        F)). Expiry is not checked."""
        lay = self.table.layout
        n = fps.shape[0]
        if n == 0:
            width = lay.F if raw else F_FULL
            return np.zeros(0, dtype=bool), np.zeros((0, width), dtype=np.int32)
        fp_d, active = self._dev_fps(fps)
        slots, found = gather_slots_impl(self.table.rows, fp_d, active, layout=lay)
        out = slots.cpu().numpy()[:n].copy()
        if raw:
            out = lay.pack(out)
        return found.cpu().numpy()[:n].copy(), out

    def tombstone_fps(self, fps: np.ndarray) -> int:
        """Zero the slots holding `fps` (post-ack handoff cleanup, the idle
        sweep's removal). Missing fingerprints are no-ops; returns the
        number removed."""
        n = fps.shape[0]
        if n == 0:
            return 0
        self._mark_dirty(fps)
        fp_d, active = self._dev_fps(fps)
        found = tombstone_rows_impl(self.table.rows, fp_d, active)
        self.stats.dispatches += 1
        return int(found.sum())

    # ------------------------------------------------------------- telemetry

    def telemetry_begin(self, now_ms: Optional[int] = None):
        """Launch the table-telemetry scan (ops/telemetry.py) without
        fetching: the engine thread reads a coherent table, and the fetch
        (telemetry.finish_scan) runs off it."""
        from gubernator_tpu_torch.ops.telemetry import scan_begin

        return scan_begin(self.table.rows, now_ms if now_ms is not None else ms_now(),
                          layout=self.table.layout)

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
        the snapshot holds rows it cannot store (then it migrates to full).
        A restore marks every checkpoint block dirty."""
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
        if self.ckpt is not None:
            # state of unknown provenance: the next epoch captures it all
            self.ckpt.mark_all()

    # ---------------------------------------------------------- checkpoints

    def checkpoint_begin(self, gids: np.ndarray, now_ms: Optional[int] = None):
        """Launch half of a dirty-block checkpoint extract (engine thread);
        finish with checkpoint_finish on any thread."""
        from gubernator_tpu_torch.ops.checkpoint import extract_begin

        now = now_ms if now_ms is not None else ms_now()
        return extract_begin(self.table.rows, gids, self.ckpt.blk, now,
                             layout=self.table.layout)

    def checkpoint_finish(self, pending):
        """Fetch half: (fps (N,) int64, slots (N, F) int32) — only the live
        prefix of the dirty blocks crosses to the host."""
        from gubernator_tpu_torch.ops.checkpoint import finish_extract

        return finish_extract(pending)

    # -------------------------------------------------------------- resizing

    def resize(self, new_capacity: int, now_ms: Optional[int] = None) -> int:
        """Grow (or shrink) the table to `new_capacity` slots, re-placing
        every live entry: one device→host snapshot, the host rehash
        (table2.rehash_rows), one host→device copy. Returns the live
        entries dropped by per-bucket overflow in the new geometry (counted
        as unexpired evictions). The JAX package then re-warms its compiles
        with all-inactive dispatches, which change no table byte and no
        stat; eager torch compiles nothing, so none run here."""
        now = now_ms if now_ms is not None else ms_now()
        lay = self.table.layout
        new_rows, dropped = rehash_rows(self.snapshot(), n_buckets_for(new_capacity), now,
                                        layout=lay)
        self.table = Table2(rows=torch.from_numpy(new_rows).to(self.device), layout=lay)
        self.stats.evicted_unexpired += dropped
        if self.ckpt is not None:
            # block ids do not survive a geometry change: a fresh tracker,
            # the same epoch lineage, everything dirty
            self.ckpt = self.ckpt.rebuild(self.table.rows.shape[0])
        return dropped

    def maybe_grow(self, threshold: float = 0.6, factor: int = 2,
                   max_capacity: Optional[int] = None, now_ms: Optional[int] = None) -> bool:
        """Double the table when live slots exceed `threshold` of capacity
        (buckets degrade past ~0.6 load). Returns True if resized.
        `max_capacity` bounds the realized capacity: bucket counts round up
        to a valid geometry, so the clamp picks the largest conforming one
        under the ceiling."""
        cap = self.table.capacity
        if self.live_count(now_ms) <= threshold * cap:
            return False
        new_cap = cap * factor
        if max_capacity is not None:
            while new_cap > cap and n_buckets_for(new_cap) * K > max_capacity:
                new_cap //= factor
            if new_cap <= cap:
                return False
        self.resize(new_cap, now_ms)
        return True

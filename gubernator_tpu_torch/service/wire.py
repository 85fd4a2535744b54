"""Protobuf ↔ column conversion at the serving edge (the port of
``gubernator_tpu/service/wire.py``).

The wire surface is the reference's exact proto schema (proto/gubernator.proto,
re-created wire-compatibly); internally everything is columns
(ops/batch.py RequestColumns). The per-item loops live here, at the edge, and
nowhere else on the serving path.

The protobuf modules load lazily (``pb`` and ``peers_pb`` below resolve at
first attribute use), so the native serving pipeline — ``WireBatch``,
``wire_batch_from_wire``, ``encode_response_columns`` — imports and runs
where ``google.protobuf`` is not installed. The cross-region codec
(``sync_regions_pb`` / ``sync_regions_arrays``) writes and reads the JAX
package's ``SyncRegionsWireReq`` bytes.
"""

from __future__ import annotations

import importlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.hashing import fingerprint
from gubernator_tpu_torch.ops.batch import (
    ERR_CASCADE_DEEP,
    ERR_EMPTY_KEY,
    ERR_EMPTY_NAME,
    ERROR_STRINGS,
    RequestColumns,
    ResponseColumns,
)
from gubernator_tpu_torch.ops import wire as wire_mod
from gubernator_tpu_torch import types
from gubernator_tpu_torch.types import Behavior


class _LazyModule:
    """A module imported at its first attribute access."""

    def __init__(self, name: str):
        self._name = name
        self._mod = None

    def __getattr__(self, attr):
        if self._mod is None:
            self._mod = importlib.import_module(self._name)
        return getattr(self._mod, attr)


pb = _LazyModule("gubernator_tpu_torch.proto.gubernator_pb2")
peers_pb = _LazyModule("gubernator_tpu_torch.proto.peers_pb2")

# the client-facing behaviour bits the parser keeps (the higher bits are
# the internal cascade level)
BEHAVIOR_CLIENT_MASK = 255

def batch_too_large_error(cap: int) -> str:
    """The reference's exact rejection wording (gubernator.go:41-42),
    parameterized by the configured cap."""
    return f"Requests.RateLimits list too large; max size is '{cap}'"


class WireBatch(NamedTuple):
    """One parsed request batch carrying BOTH serving forms: the legacy
    column view (routing, pb fallback, non-encodable dispatches) and the
    pre-packed compact-wire lanes the native parser produced in the same
    pass over the bytes. When every row is `encodable`, the batcher stages
    `lanes` straight into the engine's ingress grid (ops/wire.py layout,
    created-delta stamped at flush) — the proto bytes are traversed exactly
    once on the whole serving path."""

    cols: RequestColumns
    lanes: np.ndarray  # (5, n) int32, lane-4 created-delta bits zero
    encodable: np.ndarray  # (n,) bool — compact-wire representable
    nbytes: int = 0  # request wire size (adaptive-window byte accounting)

    @property
    def rows(self) -> int:
        return self.cols.fp.shape[0]


def wire_batch_from_columns(cols: RequestColumns) -> WireBatch:
    """The native parser's lane pass over already-parsed columns (numpy).
    A row with a fingerprint-stage error (empty key or name) has all-zero
    lanes and counts as encodable; any other row is encodable when its
    masked behaviour holds only compact flags, its duration, hits, limit,
    burst and algorithm fit the lanes, an explicit burst is on a token row
    only, and it carries no cascade level (behaviour bits 8-15)."""
    n = cols.fp.shape[0]
    ok = cols.err == 0
    beh = cols.behavior.astype(np.int64)
    algo = cols.algo.astype(np.int64)
    enc = (
        ((beh & BEHAVIOR_CLIENT_MASK & ~wire_mod._ENCODABLE_BEHAVIOR) == 0)
        & (cols.duration >= 0) & (cols.duration <= wire_mod._DUR_MASK)
        & (cols.hits >= 0) & (cols.hits <= wire_mod._HITS_MASK)
        & (cols.limit >= 0) & (cols.limit <= wire_mod.I32_MAX)
        & (cols.burst >= -wire_mod.I32_MAX) & (cols.burst <= wire_mod.I32_MAX)
        & (algo >= 0) & (algo <= wire_mod._MAX_ALGO)
        & ((algo == 0) | (cols.burst == 0))
        & (((beh >> 8) & 0xFF) == 0)
    )
    fp = np.where(ok, cols.fp, 0).astype(np.int64)
    l4 = (
        (cols.hits.astype(np.int64) & wire_mod._HITS_MASK)
        | (((beh >> 6) & 3) << wire_mod.PRIO_SHIFT)
        | (((beh & 8) != 0).astype(np.int64) << 30)
        | (((beh & 32) != 0).astype(np.int64) << 31)
    )
    lanes = np.stack([
        fp & 0xFFFFFFFF,
        fp >> 32,
        cols.limit.astype(np.int64),
        (cols.duration.astype(np.int64) & wire_mod._DUR_MASK) | ((algo & 0xFFFFFFFF) << 27),
        l4,
    ])
    lanes = np.where(ok, lanes, 0).astype(np.int64).astype(np.int32)
    return WireBatch(cols=cols, lanes=lanes.reshape(5, n), encodable=np.where(ok, enc, True))


def subset_wire(wb: WireBatch, rows: np.ndarray) -> WireBatch:
    return WireBatch(
        cols=subset_columns(wb.cols, rows),
        lanes=wb.lanes[:, rows],
        encodable=wb.encodable[rows],
        nbytes=int(wb.nbytes * len(rows) / max(wb.rows, 1)),
    )


def columns_from_pb(
    items: Sequence["pb.RateLimitReq"],
) -> Tuple[RequestColumns, List[str]]:
    """RateLimitReq list → (RequestColumns, hash_keys). hash_keys feed the
    peer ring (ownership is decided on the string key, reference
    gubernator.go:243 + replicated_hash.go:104)."""
    n = len(items)
    fp = np.zeros(n, dtype=np.int64)
    err = np.zeros(n, dtype=np.int8)
    algo = np.zeros(n, dtype=np.int32)
    behavior = np.zeros(n, dtype=np.int32)
    hits = np.zeros(n, dtype=np.int64)
    limit = np.zeros(n, dtype=np.int64)
    burst = np.zeros(n, dtype=np.int64)
    duration = np.zeros(n, dtype=np.int64)
    created_at = np.zeros(n, dtype=np.int64)
    hash_keys: List[str] = [""] * n
    clip = 1 << 62
    for i, r in enumerate(items):
        if r.unique_key == "":
            err[i] = ERR_EMPTY_KEY
            continue
        if r.name == "":
            err[i] = ERR_EMPTY_NAME
            continue
        hash_keys[i] = r.name + "_" + r.unique_key
        fp[i] = fingerprint(r.name, r.unique_key)
        algo[i] = r.algorithm
        # client-facing bits only — flag values 1..32 plus the 2-bit
        # priority tier at bits 6-7 (native parser applies the same mask):
        # the behavior word's high bits carry the INTERNAL cascade level,
        # which must never arrive from the wire
        behavior[i] = r.behavior & 255
        hits[i] = min(max(r.hits, -clip), clip)
        limit[i] = min(max(r.limit, -clip), clip)
        burst[i] = min(max(r.burst, -clip), clip)
        duration[i] = min(max(r.duration, -clip), clip)
        created_at[i] = r.created_at if r.HasField("created_at") else 0
    return (
        RequestColumns(
            fp=fp, algo=algo, behavior=behavior, hits=hits, limit=limit,
            burst=burst, duration=duration, created_at=created_at, err=err,
        ),
        hash_keys,
    )


def pb_from_response_columns(
    rc: ResponseColumns, rows: Sequence[int] = None,
    now_ms: Optional[int] = None,
) -> List["pb.RateLimitResp"]:
    """ResponseColumns → RateLimitResp list (optionally a row subset).
    With `now_ms`, denied rows additionally surface
    metadata["retry_after_ms"] — the ms until the reset/conforming instant
    (for GCRA denials reset_time IS the exact TAT-derived conforming
    instant, ops/math.py). The frozen proto schema has no field for it;
    metadata keeps old clients compatible."""

    def resp(i):
        st = int(rc.status[i])
        r = pb.RateLimitResp(
            status=st,
            limit=int(rc.limit[i]),
            remaining=int(rc.remaining[i]),
            reset_time=int(rc.reset_time[i]),
            error=ERROR_STRINGS[int(rc.err[i])],
        )
        if now_ms is not None and st == 1:
            r.metadata["retry_after_ms"] = str(
                max(0, int(rc.reset_time[i]) - int(now_ms))
            )
        return r

    idx = range(rc.status.shape[0]) if rows is None else rows
    return [resp(i) for i in idx]


def subset_columns(cols: RequestColumns, rows: np.ndarray) -> RequestColumns:
    return RequestColumns(*[f[rows] for f in cols])


def concat_columns(parts: Sequence[RequestColumns]) -> RequestColumns:
    if len(parts) == 1:
        return parts[0]
    return RequestColumns(
        *[np.concatenate([p[k] for p in parts]) for k in range(len(parts[0]))]
    )


# ------------------------------------------------------------- cascades
#
# A cascade request (RateLimitReq.cascade — per-tenant, global, … levels on
# top of the request's own level-0 limit) expands into one engine row per
# level, carrier first then members in level order, with the level riding
# the behavior word's high bits (types.CASCADE_LEVEL_SHIFT). Expansion
# happens AFTER peer routing (the whole cascade lives on the level-0 key's
# owner) and the engine evaluates every level in ONE dispatch, folding the
# combined verdict into the carrier row (deny-if-any; kernel2
# fold_cascade_packed / engine._fold_cascades_host). Contraction maps the
# rows back: carrier → the top-level RateLimitResp, member rows → its
# `cascade` list.

# behavior bits a cascade level inherits from its parent request: the
# kernel-visible flags plus the routing bits (whatever routing treatment
# the parent received applies to the whole group — levels must never split
# across the GLOBAL/local forks, or the host verdict fold would misgroup).
# DURATION_IS_GREGORIAN is deliberately NOT inherited: level durations are
# always milliseconds.
_CASCADE_INHERIT = int(
    Behavior.NO_BATCHING
    | Behavior.GLOBAL
    | Behavior.RESET_REMAINING
    | Behavior.MULTI_REGION
    | Behavior.DRAIN_OVER_LIMIT
)


def cascade_too_deep_error(cap: int) -> str:
    return f"Cascade levels list too large; max size is '{cap}'"


def expand_cascades(
    cols: RequestColumns, items, max_levels: int
) -> Tuple[RequestColumns, Optional[List[int]]]:
    """Expand cascade requests of a column batch into per-level rows.

    `items` are the pb RateLimitReq objects aligned with `cols` rows (None
    when the caller knows no cascades are present). Returns
    (expanded_cols, member_counts): member_counts[j] is the number of
    member rows inserted after original row j, or None when nothing
    expanded (the common case — zero-copy). A cascade deeper than
    `max_levels` total levels errors the CARRIER row (reference-style
    per-item isolation); invalid level keys error their member row, which
    surfaces in that level's sub-response."""
    if items is None or not any(len(it.cascade) for it in items):
        return cols, None
    n = cols.fp.shape[0]
    parts: List[RequestColumns] = []
    counts: List[int] = []
    for j in range(n):
        it = items[j]
        m = len(it.cascade)
        row = subset_columns(cols, np.array([j]))
        if m == 0 or row.err[0] != 0:
            # no levels, or the carrier itself failed validation: the
            # request errors whole — no level is evaluated (or consumed)
            parts.append(row)
            counts.append(0)
            continue
        if 1 + m > max_levels:
            # per-item isolation, like the reference's oversized-batch rule:
            # the carrier row becomes an error, no level is evaluated
            parts.append(row._replace(
                fp=np.zeros(1, dtype=np.int64),
                err=np.full(1, ERR_CASCADE_DEEP, dtype=np.int8),
            ))
            counts.append(0)
            continue
        inherit = int(row.behavior[0]) & _CASCADE_INHERIT
        fp = np.zeros(1 + m, dtype=np.int64)
        err = np.zeros(1 + m, dtype=np.int8)
        algo = np.zeros(1 + m, dtype=np.int32)
        behavior = np.zeros(1 + m, dtype=np.int32)
        hits = np.full(1 + m, row.hits[0], dtype=np.int64)
        limit = np.zeros(1 + m, dtype=np.int64)
        burst = np.zeros(1 + m, dtype=np.int64)
        duration = np.zeros(1 + m, dtype=np.int64)
        created_at = np.full(1 + m, row.created_at[0], dtype=np.int64)
        fp[0] = row.fp[0]
        err[0] = row.err[0]
        algo[0] = row.algo[0]
        behavior[0] = row.behavior[0]
        limit[0] = row.limit[0]
        burst[0] = row.burst[0]
        duration[0] = row.duration[0]
        clip = 1 << 62
        for k, lvl in enumerate(it.cascade, start=1):
            if lvl.unique_key == "":
                err[k] = ERR_EMPTY_KEY
            elif lvl.name == "":
                err[k] = ERR_EMPTY_NAME
            else:
                fp[k] = fingerprint(lvl.name, lvl.unique_key)
            algo[k] = lvl.algorithm
            behavior[k] = inherit | (min(k, 255) << 8)
            limit[k] = min(max(lvl.limit, -clip), clip)
            burst[k] = min(max(lvl.burst, -clip), clip)
            duration[k] = min(max(lvl.duration, -clip), clip)
        parts.append(RequestColumns(
            fp=fp, algo=algo, behavior=behavior, hits=hits, limit=limit,
            burst=burst, duration=duration, created_at=created_at, err=err,
        ))
        counts.append(m)
    return concat_columns(parts), counts


def pb_from_cascade_response_columns(
    rc: ResponseColumns, counts: List[int], max_levels: int,
    now_ms: Optional[int] = None,
) -> List["pb.RateLimitResp"]:
    """Contract an expanded response back to per-request RateLimitResp
    messages: the carrier row (already folded to the combined verdict)
    becomes the top-level response; its member rows become the `cascade`
    sub-responses in level order."""
    out: List[pb.RateLimitResp] = []
    off = 0
    for m in counts:
        top = _resp_at(rc, off, max_levels, now_ms)
        for k in range(1, m + 1):
            top.cascade.append(_resp_at(rc, off + k, max_levels, now_ms))
        out.append(top)
        off += 1 + m
    return out


def _resp_at(
    rc: ResponseColumns, i: int, max_levels: int,
    now_ms: Optional[int] = None,
) -> "pb.RateLimitResp":
    code = int(rc.err[i])
    msg = (
        cascade_too_deep_error(max_levels)
        if code == ERR_CASCADE_DEEP
        else ERROR_STRINGS[code]
    )
    st = int(rc.status[i])
    r = pb.RateLimitResp(
        status=st,
        limit=int(rc.limit[i]),
        remaining=int(rc.remaining[i]),
        reset_time=int(rc.reset_time[i]),
        error=msg,
    )
    if now_ms is not None and st == 1:
        # the carrier's folded reset is the latest denying level's reset —
        # exactly the retry-after bound (kernel2.fold_cascade_packed)
        r.metadata["retry_after_ms"] = str(
            max(0, int(rc.reset_time[i]) - int(now_ms))
        )
    return r


# ------------------------------------------------------------ state handoff


def transfer_chunk_pb(
    transfer_id: str,
    chunk: int,
    total_chunks: int,
    source_address: str,
    now_ms: int,
    fps: np.ndarray,
    points: np.ndarray,
    slots: np.ndarray,
    layout=None,
):
    """One TransferState chunk from extract arrays (little-endian memory
    images — no per-row message objects; see proto/handoff_pb2.py). The
    slot rows travel in the SENDER's slot layout, tagged by `layout` (code
    0 = full, the proto3 default — a pre-layout peer's chunks decode as
    full automatically)."""
    from gubernator_tpu_torch.ops.layout import FULL
    from gubernator_tpu_torch.proto import handoff_pb2 as handoff_pb

    layout = layout or FULL
    return handoff_pb.TransferStateReq(
        transfer_id=transfer_id,
        chunk=chunk,
        total_chunks=total_chunks,
        source_address=source_address,
        now_ms=now_ms,
        count=int(fps.shape[0]),
        fps=np.ascontiguousarray(fps, dtype=np.int64).tobytes(),
        points=np.ascontiguousarray(points, dtype=np.uint32).tobytes(),
        slots=np.ascontiguousarray(slots, dtype=np.int32).tobytes(),
        layout=layout.code,
    )


def transfer_chunk_arrays(req):
    """Decode a TransferStateReq back into (fps, points, slots, layout),
    validating the advertised count against every buffer length (a short
    buffer must fail loudly, not merge garbage rows). `slots` come back in
    the SENDER's layout (`layout`); the receiver converts through the
    canonical full row (engine.merge_rows(layout=...))."""
    from gubernator_tpu_torch.ops.layout import layout_by_code

    layout = layout_by_code(int(req.layout))
    F = layout.F
    n = int(req.count)
    fps = np.frombuffer(req.fps, dtype=np.int64)
    points = np.frombuffer(req.points, dtype=np.uint32)
    slots = np.frombuffer(req.slots, dtype=np.int32)
    if fps.shape[0] != n or points.shape[0] != n or slots.shape[0] != n * F:
        raise ValueError(
            f"transfer chunk length mismatch: count={n} fps={fps.shape[0]} "
            f"points={points.shape[0]} slots={slots.shape[0]} "
            f"(layout {layout.name})"
        )
    return fps, points, slots.reshape(n, F), layout


# ----------------------------------------------------------- native ingress


def wire_batch_from_wire(data: bytes):
    """Native parse of GetRateLimitsReq wire bytes (gubernator_tpu_torch.native):
    → (WireBatch, ring_points uint32, spans (n,2) int64, traceparent) or
    None when the extension is unavailable OR any item carries a cascade —
    cascade requests need their levels expanded from the full pb message,
    so such batches take the pb path (Daemon._route) end to end.
    ring_points are fnv1a_32 of each item's hash key (the ring lookup hash)
    and spans are each item's byte range in `data` for lazy pb
    materialization — only items that must travel as messages (forwards,
    GLOBAL queue entries) ever become Python objects. The WireBatch
    additionally carries the parser's pre-packed compact-wire lanes — the
    "parse once, stage once" ingress image."""
    from gubernator_tpu_torch import native

    m = native.load()
    if m is None:
        return None
    (
        n, fp, algo, beh, hits, lim, burst, dur, ca, err, ring, span,
        traceparent, lanes, enc, casc,
    ) = m.parse_get_rate_limits(data)
    if n and np.frombuffer(casc, np.int8).any():
        return None  # cascade batch → pb path (level expansion needs items)
    # np.frombuffer over bytes is read-only; routing mutates behavior/err
    cols = RequestColumns(
        fp=np.frombuffer(fp, np.int64),
        algo=np.frombuffer(algo, np.int32),
        behavior=np.frombuffer(beh, np.int32).copy(),
        hits=np.frombuffer(hits, np.int64),
        limit=np.frombuffer(lim, np.int64),
        burst=np.frombuffer(burst, np.int64),
        duration=np.frombuffer(dur, np.int64),
        created_at=np.frombuffer(ca, np.int64),
        err=np.frombuffer(err, np.int8).copy(),
    )
    wb = WireBatch(
        cols=cols,
        lanes=np.frombuffer(lanes, np.int32).reshape(5, n),
        encodable=np.frombuffer(enc, np.int8).astype(bool),
        nbytes=len(data),
    )
    return (
        wb,
        np.frombuffer(ring, np.uint32),
        np.frombuffer(span, np.int64).reshape(-1, 2),
        traceparent,  # first propagated trace context in the batch, or None
    )


def item_from_span(data: bytes, span) -> "pb.RateLimitReq":
    """Materialize one request item from its wire span (lazy pb path)."""
    s, ln = int(span[0]), int(span[1])
    return pb.RateLimitReq.FromString(data[s : s + ln])


def encode_response_columns(
    status: np.ndarray,
    limit: np.ndarray,
    remaining: np.ndarray,
    reset_time: np.ndarray,
    errors: dict,
    now_ms: Optional[int] = None,
) -> bytes:
    """Native GetRateLimitsResp encode from response columns; `errors` is a
    sparse {row: message} dict. Arrays cross the boundary via the buffer
    protocol — contiguous int64 columns encode ZERO-COPY (no .tobytes()
    staging), and the C assembly loop drops the GIL so responder workers
    encode in parallel. With `now_ms`, denied rows carry
    metadata["retry_after_ms"] (the exact conforming-instant delta for
    GCRA — see ops/math.py)."""
    from gubernator_tpu_torch import native

    m = native.load()
    if m is None:
        raise RuntimeError("the native extension is not loaded (GUBER_NATIVE=0 or no g++)")
    return m.encode_responses(
        np.ascontiguousarray(status, dtype=np.int64),
        np.ascontiguousarray(limit, dtype=np.int64),
        np.ascontiguousarray(remaining, dtype=np.int64),
        np.ascontiguousarray(reset_time, dtype=np.int64),
        errors,
        -1 if now_ms is None else int(now_ms),
    )


# ----------------------------------------- inter-slice GLOBAL sync codec
# The compact lane layout (ops/wire.py) applied to the cross-daemon hit sync
# (docs/architecture.md "Pod-scale topology"): numeric config rides ONE
# 5-lane int32 image (ops/wire.pack_wire_rows — 20 B/entry instead of a
# nested RateLimitReq message), full-precision accumulated hits ride an
# int64 sidecar (inter-slice accumulations overflow the 18-bit lane
# budget), and the key strings the owner needs for its broadcast queue
# travel as one length-prefixed blob. Non-representable batches return
# None and the caller falls back to the classic GetPeerRateLimits proto
# path — identical semantics, more bytes (the compact wire's fallback contract).

_SYNC_WIRE_BEHAVIOR = int(
    Behavior.NO_BATCHING | Behavior.GLOBAL | Behavior.RESET_REMAINING
    | Behavior.DRAIN_OVER_LIMIT
) | (types.PRIORITY_MASK << types.PRIORITY_SHIFT)


def sync_wire_pb(
    pairs: Sequence[Tuple[str, "pb.RateLimitReq"]], source: str
) -> Optional["globalsync_pb.SyncGlobalsWireReq"]:
    """Pack one owner's pending-hit batch into a SyncGlobalsWireReq, or
    None when any entry cannot ride the compact layout exactly (Gregorian /
    MULTI_REGION behaviors must not be dropped, created_at must be present
    and within the ±511 ms delta budget of the batch base, tracing
    metadata has no compact lane). The receive half is sync_wire_items."""
    n = len(pairs)
    if n == 0:
        return None
    items = [it for _k, it in pairs]
    base = None
    names: List[bytes] = []
    keys: List[bytes] = []
    for it in items:
        if (
            not it.HasField("created_at")
            or it.behavior & ~_SYNC_WIRE_BEHAVIOR
            or not (0 <= it.algorithm <= wire_mod._MAX_ALGO)
            or it.hits < 0  # lease releases keep the proto fallback
            or not (0 <= it.duration <= wire_mod._DUR_MASK)
            or not (0 <= it.limit <= wire_mod.I32_MAX)
            or it.metadata  # trace propagation has no compact lane
            or len(it.cascade)  # cascade levels need the full message
            or not (
                it.burst == 0
                or (it.algorithm in (1, 2) and it.burst == it.limit)
            )
            or it.name == ""
            or it.unique_key == ""
        ):
            return None
        if base is None:
            base = it.created_at
        if not (-wire_mod.DELTA_BIAS <= it.created_at - base
                < wire_mod.DELTA_BIAS):
            return None
        nb, kb = it.name.encode(), it.unique_key.encode()
        if len(nb) >= 1 << 16 or len(kb) >= 1 << 16:
            return None
        names.append(nb)
        keys.append(kb)
    lanes = np.zeros((wire_mod.WIRE_LANES, n), dtype=np.int32)
    hits64 = np.zeros(n, dtype=np.int64)
    for i, it in enumerate(items):
        fp = fingerprint(it.name, it.unique_key)
        lanes[0, i] = np.int64(fp).astype(np.int32)
        lanes[1, i] = np.int64(fp >> 32).astype(np.int32)
        lanes[2, i] = it.limit
        lanes[3, i] = np.int64(
            (it.duration & wire_mod._DUR_MASK)
            | (int(it.algorithm) << wire_mod.DUR_BITS)
        ).astype(np.int32)
        reset = 1 if it.behavior & int(Behavior.RESET_REMAINING) else 0
        drain = 1 if it.behavior & int(Behavior.DRAIN_OVER_LIMIT) else 0
        prio = types.priority_tier(it.behavior)
        delta = (it.created_at - base + wire_mod.DELTA_BIAS)
        # lane hits stay 0: hits64 is authoritative on this codec
        lanes[4, i] = np.int64(
            ((delta & wire_mod._DELTA_MASK) << wire_mod.HITS_BITS)
            | (prio << wire_mod.PRIO_SHIFT)
            | (reset << 30) | (drain << 31)
        ).astype(np.int32)
        hits64[i] = it.hits
    from gubernator_tpu_torch.proto import globalsync_pb2 as globalsync_pb

    return globalsync_pb.SyncGlobalsWireReq(
        source=source,
        count=n,
        base=base,
        lanes=lanes.tobytes(),
        hits=hits64.tobytes(),
        name_lens=np.array([len(b) for b in names], dtype="<u2").tobytes(),
        key_lens=np.array([len(b) for b in keys], dtype="<u2").tobytes(),
        strings=b"".join(
            b for pair in zip(names, keys) for b in pair
        ),
    )


# ----------------------------------------- cross-region replication codec
# The SyncGlobalsWire shape applied to the region plane (ops/reconcile.py
# receive path): per-key hit DELTAS + config lanes + the sender's own
# stored slot rows in its slot layout. Items that cannot ride the compact
# layout exactly fall back PER ITEM to the classic GetPeerRateLimits proto
# path (legacy DRAIN semantics — the pre-upgrade behavior), so one exotic
# item never forces a whole batch off the merge path.

_REGION_WIRE_BEHAVIOR = int(
    Behavior.NO_BATCHING | Behavior.MULTI_REGION | Behavior.DRAIN_OVER_LIMIT
) | (types.PRIORITY_MASK << types.PRIORITY_SHIFT)


def region_wire_item_ok(it: "pb.RateLimitReq") -> bool:
    """Static (base-independent) encodability of one replicated item.
    RESET_REMAINING is deliberately NOT encodable: a reset cannot travel
    through a min-remaining merge (min can never raise remaining), so
    resets ride the classic serving-path fallback, which can."""
    return bool(
        it.HasField("created_at")
        and not (it.behavior & ~_REGION_WIRE_BEHAVIOR)
        and 0 <= it.algorithm <= wire_mod._MAX_ALGO
        and it.hits >= 0  # lease releases keep the proto fallback
        and 0 <= it.duration <= wire_mod._DUR_MASK
        and 0 <= it.limit <= wire_mod.I32_MAX
        and not it.metadata
        and not len(it.cascade)
        and (
            it.burst == 0
            or (it.algorithm in (1, 2) and it.burst == it.limit)
        )
        and it.name != ""
        and it.unique_key != ""
        and len(it.name.encode()) < (1 << 16)
        and len(it.unique_key.encode()) < (1 << 16)
    )


def split_region_encodable(pairs):
    """Partition one region-bound batch into (encodable, fallback) pairs.
    The lane base is the first encodable item's created_at; items outside
    its ±511 ms delta budget spill to the fallback too."""
    enc, fb = [], []
    base = None
    for key, it in pairs:
        if not region_wire_item_ok(it):
            fb.append((key, it))
            continue
        if base is None:
            base = it.created_at
        if not (
            -wire_mod.DELTA_BIAS
            <= it.created_at - base
            < wire_mod.DELTA_BIAS
        ):
            fb.append((key, it))
            continue
        enc.append((key, it))
    return enc, fb


def sync_regions_pb(
    pairs: Sequence[Tuple[str, "pb.RateLimitReq"]],
    source: str,
    region: str,
    slots: Optional[np.ndarray] = None,
    layout=None,
    detail_rows: Optional[np.ndarray] = None,
    cums: Optional[np.ndarray] = None,
):
    """Pack one region-bound delta batch (already split_region_encodable-
    filtered) into a SyncRegionsWireReq. `slots` are the sender's stored
    rows for the batch keys in the sender's own slot layout ((n, layout.F)
    i32, zero rows for missing keys; None ships no rows).

    `detail_rows` (bool (n,), default all-True) marks the rows that carry
    the BOOTSTRAP detail — key strings and the sender's stored slot row.
    A key's FIRST replication to a region ships detailed; steady-state
    deltas for already-shipped keys are pure 32 B lane+hits entries
    (zero-length strings, zero slot row) — the receiver merges them by
    fingerprint against its own stored state.

    `cums` (int64 (n,), optional) are the sender's PER-KEY CUMULATIVE hit
    counters toward this region (total ever queued, including this batch's
    deltas) — the receiver's per-source dedup ledger uses them to skip
    re-shipped batches after a lost ack EXACTLY instead of under-granting
    (ops/reconcile.dedup_source_deltas). Absent = pre-dedup sender; the
    receiver then applies deltas verbatim (the legacy at-least-once rule).
    The receive half is sync_regions_arrays → apply_region_sync."""
    from gubernator_tpu_torch.ops.layout import FULL
    from gubernator_tpu_torch.proto import regionsync_pb2 as regionsync_pb

    n = len(pairs)
    assert n > 0, "empty region batch"
    layout = layout or FULL
    items = [it for _k, it in pairs]
    base = items[0].created_at
    if detail_rows is None:
        detail_rows = np.ones(n, dtype=bool)
    names = [
        it.name.encode() if detail_rows[i] else b""
        for i, it in enumerate(items)
    ]
    keys = [
        it.unique_key.encode() if detail_rows[i] else b""
        for i, it in enumerate(items)
    ]
    lanes = np.zeros((wire_mod.WIRE_LANES, n), dtype=np.int32)
    hits64 = np.zeros(n, dtype=np.int64)
    for i, it in enumerate(items):
        fp = fingerprint(it.name, it.unique_key)
        lanes[0, i] = np.int64(fp).astype(np.int32)
        lanes[1, i] = np.int64(fp >> 32).astype(np.int32)
        lanes[2, i] = it.limit
        lanes[3, i] = np.int64(
            (it.duration & wire_mod._DUR_MASK)
            | (int(it.algorithm) << wire_mod.DUR_BITS)
        ).astype(np.int32)
        drain = 1 if it.behavior & int(Behavior.DRAIN_OVER_LIMIT) else 0
        prio = types.priority_tier(it.behavior)
        delta = it.created_at - base + wire_mod.DELTA_BIAS
        # lane hits stay 0: the hits64 sidecar is authoritative
        lanes[4, i] = np.int64(
            ((delta & wire_mod._DELTA_MASK) << wire_mod.HITS_BITS)
            | (prio << wire_mod.PRIO_SHIFT)
            | (drain << 31)
        ).astype(np.int32)
        hits64[i] = it.hits
    slot_bytes = b""
    if slots is not None and slots.size and detail_rows.any():
        assert slots.shape == (n, layout.F), "slots misaligned with pairs"
        slots = np.where(detail_rows[:, None], slots, 0)
        slot_bytes = np.ascontiguousarray(slots, dtype=np.int32).tobytes()
    cum_bytes = b""
    if cums is not None:
        assert len(cums) == n, "cums misaligned with pairs"
        cum_bytes = np.ascontiguousarray(cums, dtype=np.int64).tobytes()
    return regionsync_pb.SyncRegionsWireReq(
        source=source,
        region=region,
        count=n,
        base=base,
        lanes=lanes.tobytes(),
        hits=hits64.tobytes(),
        name_lens=np.array([len(b) for b in names], dtype="<u2").tobytes(),
        key_lens=np.array([len(b) for b in keys], dtype="<u2").tobytes(),
        strings=b"".join(b for pair in zip(names, keys) for b in pair),
        slots=slot_bytes,
        layout=layout.code,
        cums=cum_bytes,
    )


def sync_regions_arrays(req):
    """Decode a SyncRegionsWireReq into the reconcile inputs:
    (fps i64, deltas i64, cfg column dict, hash_keys, slots, layout, cums).
    `slots` come back in the SENDER's layout (None when the sender shipped
    no rows); `cums` are the per-key cumulative counters (None when the
    sender predates the dedup plane); every buffer length is validated — a
    short buffer must fail loudly, not merge garbage rows."""
    from gubernator_tpu_torch.ops.layout import layout_by_code
    from gubernator_tpu_torch.ops.wire import WIRE_LANES, decode_wire_host

    n = int(req.count)
    lanes = np.frombuffer(req.lanes, dtype="<i4").reshape(WIRE_LANES, n)
    cfg = decode_wire_host(lanes, int(req.base))
    deltas = np.frombuffer(req.hits, dtype="<i8")
    name_lens = np.frombuffer(req.name_lens, dtype="<u2")
    key_lens = np.frombuffer(req.key_lens, dtype="<u2")
    if not (
        deltas.shape[0] == n and name_lens.shape[0] == n
        and key_lens.shape[0] == n
        and int(name_lens.sum()) + int(key_lens.sum()) == len(req.strings)
    ):
        raise ValueError("SyncRegionsWireReq: inconsistent buffer lengths")
    layout = layout_by_code(int(req.layout))
    slots = None
    if req.slots:
        slots = np.frombuffer(req.slots, dtype="<i4")
        if slots.shape[0] != n * layout.F:
            raise ValueError(
                f"SyncRegionsWireReq: slots buffer holds {slots.shape[0]} "
                f"lanes, want {n}×{layout.F} (layout {layout.name})"
            )
        slots = slots.reshape(n, layout.F)
    cums = None
    if req.cums:
        cums = np.frombuffer(req.cums, dtype="<i8")
        if cums.shape[0] != n:
            raise ValueError(
                f"SyncRegionsWireReq: cums buffer holds {cums.shape[0]} "
                f"entries, want {n}"
            )
        cums = cums.astype(np.int64)
    hash_keys = []
    off = 0
    blob = req.strings
    for i in range(n):
        name = blob[off : off + int(name_lens[i])].decode()
        off += int(name_lens[i])
        key = blob[off : off + int(key_lens[i])].decode()
        off += int(key_lens[i])
        # steady-state rows travel string-less (fingerprint-only merge);
        # "" marks them so the receiver skips ownership recording
        hash_keys.append(name + "_" + key if (name or key) else "")
    return (
        np.asarray(cfg["fp"], dtype=np.int64),
        deltas.astype(np.int64),
        cfg,
        hash_keys,
        slots,
        layout,
        cums,
    )


def sync_wire_items(
    req: "globalsync_pb.SyncGlobalsWireReq",
) -> List["pb.RateLimitReq"]:
    """Decode a SyncGlobalsWireReq back to RateLimitReq items (owner side).
    GLOBAL is re-set on every entry — this codec only ever carries GLOBAL
    hit syncs — so the rebuilt items drive the exact
    _get_peer_rate_limits path the proto fallback drives."""
    from gubernator_tpu_torch.ops.wire import WIRE_LANES, decode_wire_host

    n = int(req.count)
    lanes = np.frombuffer(req.lanes, dtype="<i4").reshape(WIRE_LANES, n)
    cols = decode_wire_host(lanes, int(req.base))
    hits = np.frombuffer(req.hits, dtype="<i8")
    name_lens = np.frombuffer(req.name_lens, dtype="<u2")
    key_lens = np.frombuffer(req.key_lens, dtype="<u2")
    if not (
        hits.shape[0] == n and name_lens.shape[0] == n
        and key_lens.shape[0] == n
        and int(name_lens.sum()) + int(key_lens.sum()) == len(req.strings)
    ):
        raise ValueError("SyncGlobalsWireReq: inconsistent buffer lengths")
    items: List[pb.RateLimitReq] = []
    off = 0
    blob = req.strings
    for i in range(n):
        name = blob[off : off + int(name_lens[i])].decode()
        off += int(name_lens[i])
        key = blob[off : off + int(key_lens[i])].decode()
        off += int(key_lens[i])
        items.append(
            pb.RateLimitReq(
                name=name,
                unique_key=key,
                hits=int(hits[i]),
                limit=int(cols["limit"][i]),
                duration=int(cols["duration"][i]),
                algorithm=int(cols["algo"][i]),
                behavior=int(cols["behavior"][i]) | int(Behavior.GLOBAL),
                created_at=int(cols["created_at"][i]),
            )
        )
    return items

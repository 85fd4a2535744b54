"""Batch layouts and host-side packing (the port of
``gubernator_tpu/ops/batch.py``).

A `ReqBatch` is the struct-of-tensors form of a slice of requests after
host-side resolution: strings → fingerprints, Gregorian durations →
absolute expiries and interval lengths, burst defaulting (burst==0 → limit
for leaky and GCRA). The kernel requires all fingerprints within one batch
to be distinct; the pass planner (ops/plan.py) guarantees that.

Host staging is numpy, exactly as in the JAX package, so a batch packs to
the same bytes in both; only ``to_device`` is torch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import gregorian
from gubernator_tpu_torch.hashing import fingerprint
from gubernator_tpu_torch.types import (
    MAX_ALGORITHM,
    Algorithm,
    Behavior,
    RateLimitRequest,
    has_behavior,
)

# front-door bound on limit/burst: stored table fields are int32
INT32_MAX = 2**31 - 1
# client-supplied created_at is clamped to ingress now ± tolerance: item
# expiry is checked against the server clock, so a skewed client timestamp
# must not renew or expire live buckets
CREATED_AT_TOLERANCE_MS = 5 * 60 * 1000


def created_at_tolerance_ms() -> int:
    """The default clock-skew bound the packers apply (engines take their
    own through ``created_at_tolerance_ms=``)."""
    return CREATED_AT_TOLERANCE_MS


class ReqBatch(NamedTuple):
    """All tensors shape (B,). Fingerprints must be unique among active rows."""

    fp: torch.Tensor  # int64 (63-bit fingerprint; 0 reserved)
    algo: torch.Tensor  # int32
    behavior: torch.Tensor  # int32 bitflags
    hits: torch.Tensor  # int64
    limit: torch.Tensor  # int64
    burst: torch.Tensor  # int64 (resolved: 0 → limit)
    duration: torch.Tensor  # int64 raw request duration (ms, or Gregorian enum)
    created_at: torch.Tensor  # int64 epoch ms ("now" for this request)
    expire_new: torch.Tensor  # int64 absolute expiry for new/renewed token items
    greg_interval: torch.Tensor  # int64 full Gregorian interval ms (0 ⇒ not gregorian)
    duration_eff: torch.Tensor  # int64 effective duration for leaky expiry updates
    active: torch.Tensor  # bool padding mask

    @property
    def size(self) -> int:
        return self.fp.shape[0]


class RespBatch(NamedTuple):
    """Kernel outputs, shape (B,), in the same row order as the ReqBatch."""

    status: torch.Tensor  # int32
    limit: torch.Tensor  # int64
    remaining: torch.Tensor  # int64
    reset_time: torch.Tensor  # int64
    cache_hit: torch.Tensor  # bool — row found a live matching slot
    dropped: torch.Tensor  # bool — no slot could be claimed
    aux: Optional[torch.Tensor] = None  # int64 raw aux lane writeback
    rem_store: Optional[torch.Tensor] = None  # int64 remaining-style lane


class BatchStats(NamedTuple):
    """Per-dispatch scalar counters (0-d int64 tensors)."""

    cache_hits: torch.Tensor
    cache_misses: torch.Tensor
    over_limit: torch.Tensor  # rows answered OVER_LIMIT
    evicted_unexpired: torch.Tensor  # live slots evicted for new keys
    dropped: torch.Tensor  # rows that failed slot claiming


class InstallBatch(NamedTuple):
    """Authoritative GLOBAL statuses to install as fresh items, one owner
    broadcast entry per row (what UpdatePeerGlobalsReq.Globals carries).
    All tensors shape (B,)."""

    fp: torch.Tensor  # int64
    algo: torch.Tensor  # int32
    status: torch.Tensor  # int32
    limit: torch.Tensor  # int64
    remaining: torch.Tensor  # int64
    reset_time: torch.Tensor  # int64
    duration: torch.Tensor  # int64
    now: torch.Tensor  # int64
    active: torch.Tensor  # bool
    # full-fidelity state (Store rehydrate): the leaky burst and the item's
    # stamp; the wire path rebuilds with burst=limit, stamp=now
    burst: torch.Tensor  # int64
    stamp: torch.Tensor  # int64
    # sliding-window broadcast fidelity: previous-window count (raw aux
    # lane) and the stored-style remaining; None on legacy wire paths
    aux: Optional[torch.Tensor] = None  # int64
    rem_store: Optional[torch.Tensor] = None  # int64


class HostBatch(NamedTuple):
    """numpy staging form of a batch, before device transfer."""

    fp: np.ndarray
    algo: np.ndarray
    behavior: np.ndarray
    hits: np.ndarray
    limit: np.ndarray
    burst: np.ndarray
    duration: np.ndarray
    created_at: np.ndarray
    expire_new: np.ndarray
    greg_interval: np.ndarray
    duration_eff: np.ndarray
    active: np.ndarray


ERR_OK = 0
ERR_EMPTY_KEY = 1
ERR_EMPTY_NAME = 2
ERR_LIMIT_I32 = 3
ERR_BURST_I32 = 4
ERR_GREGORIAN = 5
ERR_DROPPED = 6
ERR_ALGORITHM = 7
ERR_CASCADE_DEEP = 8
ERR_OVERLOAD = 9

# wording parity with the reference where it has fixed strings
# (gubernator.go:215-224); ERR_DROPPED is this design's own failure mode
ERROR_STRINGS = {
    ERR_OK: "",
    ERR_EMPTY_KEY: "field 'unique_key' cannot be empty",
    ERR_EMPTY_NAME: "field 'namespace' cannot be empty",
    ERR_LIMIT_I32: "field 'limit' must fit int32",
    ERR_BURST_I32: "field 'burst' must fit int32",
    ERR_GREGORIAN: "invalid gregorian duration",
    ERR_DROPPED: "rate limit state could not be persisted (contended table); retry",
    ERR_ALGORITHM: "invalid rate limit algorithm",
    ERR_CASCADE_DEEP: "cascade levels list too large",
    ERR_OVERLOAD: "request shed under overload; retry after reset_time",
}


class RequestColumns(NamedTuple):
    """Column-oriented request batch (pre-fingerprinted). `created_at == 0`
    means unset (stamped with ingress now); `err` carries fingerprint-stage
    validation codes."""

    fp: np.ndarray  # int64; 0 where err != 0
    algo: np.ndarray  # int32
    behavior: np.ndarray  # int32
    hits: np.ndarray  # int64
    limit: np.ndarray  # int64
    burst: np.ndarray  # int64 (raw; 0 → limit resolved in pack)
    duration: np.ndarray  # int64
    created_at: np.ndarray  # int64; 0 = unset
    err: np.ndarray  # int8 error codes (ERR_*)


class ResponseColumns(NamedTuple):
    """Column-oriented responses, request order."""

    status: np.ndarray  # int32
    limit: np.ndarray  # int64
    remaining: np.ndarray  # int64
    reset_time: np.ndarray  # int64
    err: np.ndarray  # int8


def fingerprint_columns(names, keys) -> "tuple[np.ndarray, np.ndarray]":
    """Fingerprint parallel name/key string sequences; returns (fp, err)."""
    n = len(names)
    fp = np.zeros(n, dtype=np.int64)
    err = np.zeros(n, dtype=np.int8)
    for i in range(n):
        k = keys[i]
        nm = names[i]
        if k == "":
            err[i] = ERR_EMPTY_KEY
        elif nm == "":
            err[i] = ERR_EMPTY_NAME
        else:
            fp[i] = fingerprint(nm, k)
    return fp, err


def pack_columns(
    cols: RequestColumns, now_ms: int, tolerance_ms: Optional[int] = None
) -> "tuple[HostBatch, np.ndarray]":
    """Vectorized resolution of a RequestColumns batch into a HostBatch:
    validation, created_at clamping, burst defaulting and Gregorian
    resolution. Returns (batch, err_codes). `tolerance_ms` overrides the
    default clock-skew bound (engines pass their own)."""
    tol = created_at_tolerance_ms() if tolerance_ms is None else tolerance_ms
    n = cols.fp.shape[0]
    err = cols.err.copy()
    ok = err == ERR_OK
    bad_limit = ok & ((cols.limit > INT32_MAX) | (cols.limit < -INT32_MAX))
    err[bad_limit] = ERR_LIMIT_I32
    bad_burst = (err == ERR_OK) & (
        (cols.burst > INT32_MAX) | (cols.burst < -INT32_MAX)
    )
    err[bad_burst] = ERR_BURST_I32
    bad_algo = (err == ERR_OK) & ((cols.algo < 0) | (cols.algo > MAX_ALGORITHM))
    err[bad_algo] = ERR_ALGORITHM

    created = np.where(cols.created_at == 0, now_ms, cols.created_at)
    created = np.clip(created, now_ms - tol, now_ms + tol)
    # burst defaults to limit for the tolerance-shaped algorithms: leaky
    # (reference algorithms.go:259-261) and GCRA
    bursty = (cols.algo == int(Algorithm.LEAKY_BUCKET)) | (
        cols.algo == int(Algorithm.GCRA)
    )
    burst = np.where(bursty & (cols.burst == 0), cols.limit, cols.burst)

    expire_new = created + cols.duration
    greg_interval = np.zeros(n, dtype=np.int64)
    duration_eff = cols.duration.astype(np.int64).copy()
    greg_rows = (cols.behavior & int(Behavior.DURATION_IS_GREGORIAN)) != 0
    if greg_rows.any():
        # the whole batch shares one `now`: resolve once per enum value
        for val in np.unique(cols.duration[greg_rows]):
            rows = greg_rows & (cols.duration == val)
            try:
                expire = gregorian.gregorian_expiration(now_ms, int(val))
                interval = gregorian.gregorian_duration(now_ms, int(val))
            except gregorian.GregorianError:
                err[rows & (err == ERR_OK)] = ERR_GREGORIAN
                continue
            expire_new[rows] = expire
            greg_interval[rows] = interval
            duration_eff[rows] = expire - now_ms

    active = err == ERR_OK
    b = HostBatch(
        fp=np.where(active, cols.fp, 0),
        algo=cols.algo.astype(np.int32),
        behavior=cols.behavior.astype(np.int32),
        hits=cols.hits.astype(np.int64),
        limit=cols.limit.astype(np.int64),
        burst=burst.astype(np.int64),
        duration=cols.duration.astype(np.int64),
        created_at=created.astype(np.int64),
        expire_new=expire_new.astype(np.int64),
        greg_interval=greg_interval,
        duration_eff=duration_eff,
        active=active,
    )
    return b, err


def columns_from_requests(requests: Sequence[RateLimitRequest]) -> RequestColumns:
    """Object → columns edge conversion (the per-item loop lives here only)."""
    n = len(requests)
    fp = np.zeros(n, dtype=np.int64)
    err = np.zeros(n, dtype=np.int8)
    algo = np.zeros(n, dtype=np.int32)
    behavior = np.zeros(n, dtype=np.int32)
    hits = np.zeros(n, dtype=np.int64)
    limit = np.zeros(n, dtype=np.int64)
    burst = np.zeros(n, dtype=np.int64)
    duration = np.zeros(n, dtype=np.int64)
    created_at = np.zeros(n, dtype=np.int64)
    for i, r in enumerate(requests):
        if r.unique_key == "":
            err[i] = ERR_EMPTY_KEY
            continue
        if r.name == "":
            err[i] = ERR_EMPTY_NAME
            continue
        fp[i] = fingerprint(r.name, r.unique_key)
        algo[i] = int(r.algorithm)
        behavior[i] = int(r.behavior)
        hits[i] = r.hits
        limit[i] = min(max(r.limit, -(2**62)), 2**62)  # pre-clip against int64 overflow
        burst[i] = min(max(r.burst, -(2**62)), 2**62)
        duration[i] = r.duration
        created_at[i] = r.created_at if r.created_at else 0
    return RequestColumns(
        fp=fp, algo=algo, behavior=behavior, hits=hits, limit=limit,
        burst=burst, duration=duration, created_at=created_at, err=err,
    )


def pack_requests(
    requests: Sequence[RateLimitRequest],
    now_ms: int,
    pad_to: Optional[int] = None,
    tolerance_ms: Optional[int] = None,
) -> "tuple[HostBatch, List[Optional[str]]]":
    """Resolve and pack request objects into a HostBatch, row by row (the
    object API's packer; ``pack_columns`` is the vectorized one).

    Returns (batch, errors): errors[i] is the request's error string and
    its row stays inactive, so one invalid item never fails the batch
    (reference gubernator.go:215-237). Resolution: empty unique_key / name
    rejected (with the reference's "namespace" wording), limit / burst must
    fit int32, created_at stamped with `now_ms` when unset and clamped to
    now ± tolerance, burst 0 → limit for leaky and GCRA, and Gregorian
    durations resolved to the interval's end (expire_new), its length
    (greg_interval) and expire_new - now (duration_eff); otherwise
    expire_new = created_at + duration."""
    n = len(requests)
    size = pad_to if pad_to is not None else n
    if size < n:
        raise ValueError("pad_to smaller than batch")
    errors: List[Optional[str]] = [None] * n
    b = HostBatch(
        fp=np.zeros(size, dtype=np.int64),
        algo=np.zeros(size, dtype=np.int32),
        behavior=np.zeros(size, dtype=np.int32),
        hits=np.zeros(size, dtype=np.int64),
        limit=np.zeros(size, dtype=np.int64),
        burst=np.zeros(size, dtype=np.int64),
        duration=np.zeros(size, dtype=np.int64),
        created_at=np.zeros(size, dtype=np.int64),
        expire_new=np.zeros(size, dtype=np.int64),
        greg_interval=np.zeros(size, dtype=np.int64),
        duration_eff=np.zeros(size, dtype=np.int64),
        active=np.zeros(size, dtype=bool),
    )
    tol = created_at_tolerance_ms() if tolerance_ms is None else tolerance_ms
    for i, r in enumerate(requests):
        if r.unique_key == "":
            errors[i] = ERROR_STRINGS[ERR_EMPTY_KEY]
            continue
        if r.name == "":
            errors[i] = ERROR_STRINGS[ERR_EMPTY_NAME]
            continue
        if not (-INT32_MAX <= r.limit <= INT32_MAX):
            errors[i] = ERROR_STRINGS[ERR_LIMIT_I32]
            continue
        if not (-INT32_MAX <= r.burst <= INT32_MAX):
            errors[i] = ERROR_STRINGS[ERR_BURST_I32]
            continue
        if not (0 <= int(r.algorithm) <= MAX_ALGORITHM):
            errors[i] = ERROR_STRINGS[ERR_ALGORITHM]
            continue
        created = r.created_at if r.created_at is not None and r.created_at != 0 else now_ms
        created = min(max(created, now_ms - tol), now_ms + tol)
        b.fp[i] = fingerprint(r.name, r.unique_key)
        b.algo[i] = int(r.algorithm)
        b.behavior[i] = int(r.behavior)
        b.hits[i] = r.hits
        b.limit[i] = r.limit
        b.duration[i] = r.duration
        b.created_at[i] = created
        bursty = int(r.algorithm) in (int(Algorithm.LEAKY_BUCKET), int(Algorithm.GCRA))
        b.burst[i] = r.limit if bursty and r.burst == 0 else r.burst
        if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
            try:
                expire = gregorian.gregorian_expiration(now_ms, r.duration)
                b.greg_interval[i] = gregorian.gregorian_duration(now_ms, r.duration)
            except gregorian.GregorianError as e:
                errors[i] = str(e)
                b.fp[i] = 0
                continue
            b.expire_new[i] = expire
            b.duration_eff[i] = expire - now_ms
        else:
            b.expire_new[i] = created + r.duration
            b.duration_eff[i] = r.duration
        b.active[i] = True
    return b, errors


def pad_batch(b: HostBatch, to_size: int) -> HostBatch:
    """Zero-pad every field to `to_size` rows (inactive padding)."""
    n = b.fp.shape[0]
    if n == to_size:
        return b
    if n > to_size:
        raise ValueError("cannot pad smaller")
    return HostBatch(
        *[np.concatenate([f, np.zeros(to_size - n, dtype=f.dtype)]) for f in b]
    )


def pack_host_batch(b: HostBatch, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a HostBatch into ONE (12, B) int64 array — a single host→device
    transfer per dispatch; kernel2.req_from_arr rebuilds the ReqBatch."""
    n = b.fp.shape[0]
    if out is None:
        arr = np.empty((12, n), dtype=np.int64)
    else:
        if out.shape != (12, n) or out.dtype != np.int64:
            raise ValueError(f"out must be a (12, {n}) int64 array, got {out.dtype} {out.shape}")
        arr = out
    arr[0] = b.fp
    arr[1] = b.algo
    arr[2] = b.behavior
    arr[3] = b.hits
    arr[4] = b.limit
    arr[5] = b.burst
    arr[6] = b.duration
    arr[7] = b.created_at
    arr[8] = b.expire_new
    arr[9] = b.greg_interval
    arr[10] = b.duration_eff
    arr[11] = b.active
    return arr


def to_device(b: HostBatch, device) -> ReqBatch:
    """A HostBatch as tensors on `device` (the dtypes of ReqBatch)."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
    return ReqBatch(
        fp=t(b.fp, torch.int64),
        algo=t(b.algo, torch.int32),
        behavior=t(b.behavior, torch.int32),
        hits=t(b.hits, torch.int64),
        limit=t(b.limit, torch.int64),
        burst=t(b.burst, torch.int64),
        duration=t(b.duration, torch.int64),
        created_at=t(b.created_at, torch.int64),
        expire_new=t(b.expire_new, torch.int64),
        greg_interval=t(b.greg_interval, torch.int64),
        duration_eff=t(b.duration_eff, torch.int64),
        active=t(b.active, torch.bool),
    )

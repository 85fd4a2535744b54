"""Edge quota leases — the server-side admission-delegation plane (the port
of ``gubernator_tpu/service/lease_manager.py``, the same order of effects).

The V1 ``LeaseQuota`` RPC hands a *bounded slice* of a limit to a client
library (gubernator_tpu_torch/edge): N tokens with a TTL and a lease id.
The client then admits at memory speed from its local budget and only
comes back to renew, to return unused tokens, or when its slice is
exhausted — cutting the per-check fan-in into the daemon by the grant size.

Everything here is built from primitives the engine already proves:

* **The grant is just hits.** A grant of N tokens is ``hits = N`` through
  the NORMAL decide path (``daemon.get_rate_limits``), so ring ownership,
  GLOBAL broadcast queueing, and MULTI_REGION replication apply to leased
  consumption verbatim — a lease is indistinguishable from N ordinary hits
  to every other plane, and the region/handoff conservatism bounds hold
  unchanged.
* **The outstanding ledger is a CONCURRENCY_LEASE row** on a
  derived key (``name + "\\x00lease"``): acquires are ``hits = +N``
  (denied when Σ outstanding would pass the per-key cap), returns are
  ``hits = -N``, and because lease acquires refresh ``ExpireAt = now +
  TTL``, the table's TTL eviction IS the reclamation — a crashed client's
  ledger tokens flow back with no scan, no timer wheel, no tombstones.
* **Unreturned real-limit tokens stay consumed** until the limit's own
  window resets — the conservative direction (the daemon can't know how
  many of a dead client's tokens were really used). Returned tokens refund
  through ``hits = -N`` on the real key, bounded by the LEASE RECORD
  (``min(return_tokens, outstanding)``) — a refund can never exceed what
  this lease's grants consumed, whatever the algorithm's own negative-hit
  semantics (token buckets bank credit by reference rule; the extension
  lanes additionally clamp in the decision math — ops/math.py miss-safety;
  on the card that math runs inside the decide kernels).

Over-admission bound: at any instant, admissions across the fleet ≤
tokens consumed through the decide path + Σ outstanding leased tokens
(``/v1/debug/leases`` reports the live Σ). The in-memory lease records
here are bookkeeping only (ids, per-key totals, expiry accounting) — the
table's ledger row is the authority, so a daemon restart loses nothing
that matters: records vanish, the restored/reclaimed ledger still bounds
new grants, and late returns against vanished leases are miss-safe.
"""

from __future__ import annotations

import heapq
import logging
import uuid
from dataclasses import dataclass
from typing import Dict, List, Tuple

from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import (
    Behavior,
    PRIORITY_MASK,
    PRIORITY_SHIFT,
    PRIORITY_TIERS,
    priority_tier,
)

log = logging.getLogger("gubernator_tpu_torch.lease")

# ledger-key name suffix: NUL can't appear in a sane client namespace, so
# the per-key outstanding ledger can never collide with real traffic
LEDGER_SUFFIX = "\x00lease"

# behavior bits a lease grant forwards into the decide path — the client's
# routing/replication intent plus its priority tier (so the front door's
# overload plane sees leased consumption at the edge's tier), never
# RESET/DRAIN (a grant must consume honestly) and never Gregorian (lease
# windows are always milliseconds)
_GRANT_BEHAVIOR = int(
    Behavior.NO_BATCHING | Behavior.GLOBAL | Behavior.MULTI_REGION
) | (PRIORITY_MASK << PRIORITY_SHIFT)


@dataclass
class LeaseRecord:
    lease_id: str
    name: str
    unique_key: str
    hash_key: str
    outstanding: int  # granted - returned tokens still out at the edge
    expires_at: int  # epoch ms
    granted_total: int


class LeaseManager:
    def __init__(self, daemon):
        self.daemon = daemon
        conf = daemon.conf
        self.max_fraction = conf.lease_max_fraction
        self.min_ttl_ms = conf.lease_min_ttl_ms
        self.max_ttl_ms = conf.lease_max_ttl_ms
        self.max_outstanding = conf.lease_max_outstanding
        # tier-aware sizing (GUBER_PRIORITY_LEASE_SCALING, default off):
        # grants scale with the requester's priority tier and pressured
        # keys push shrink hints at low-tier edges
        self.priority_scaling = getattr(conf, "lease_priority_scaling", False)
        self.metrics = daemon.metrics
        self._leases: Dict[str, LeaseRecord] = {}
        self._by_key: Dict[str, int] = {}  # hash_key → Σ outstanding
        # (expires_at, lease_id) min-heap so pruning is O(expired · log n),
        # not a scan of every live lease per op
        self._expiry: List[Tuple[int, str]] = []
        # lifetime counters (debug plane; prometheus carries the same)
        self.acquires = 0
        self.renews = 0
        self.returns = 0
        self.denies = 0
        self.expirations = 0
        self.unknown_returns = 0
        self.shrink_hints = 0
        self.tokens_granted = 0
        self.tokens_returned = 0
        self.tokens_expired = 0

    # ------------------------------------------------------------- internals
    def _cap(self, limit: int) -> int:
        """Per-key ceiling on Σ outstanding leased tokens: a bounded
        fraction of the limit (GUBER_LEASE_MAX_FRACTION), optionally capped
        absolutely (GUBER_LEASE_MAX_OUTSTANDING) — the knob that sizes the
        documented over-admission bound."""
        cap = max(1, int(limit * self.max_fraction))
        if self.max_outstanding > 0:
            cap = min(cap, self.max_outstanding)
        return cap

    def _ttl(self, req_ttl_ms: int) -> int:
        if req_ttl_ms <= 0:
            req_ttl_ms = int(self.max_ttl_ms) // 4
        return int(min(max(req_ttl_ms, self.min_ttl_ms), self.max_ttl_ms))

    def _ledger_item(self, req, hits: int, ttl_ms: int) -> "pb.RateLimitReq":
        """The outstanding-ledger row: a CONCURRENCY_LEASE check whose limit
        is the per-key outstanding cap and whose duration is the lease TTL
        (acquires refresh ExpireAt, so TTL eviction reclaims a crashed
        client's ledger tokens)."""
        return pb.RateLimitReq(
            name=req.name + LEDGER_SUFFIX,
            unique_key=req.unique_key,
            hits=hits,
            limit=self._cap(req.limit),
            duration=ttl_ms,
            algorithm=int(pb.CONCURRENCY_LEASE),
            behavior=int(Behavior.NO_BATCHING),
        )

    def _grant_item(self, req, hits: int) -> "pb.RateLimitReq":
        """The real-limit consumption/refund row — plain hits through the
        normal decide path, with the client's routing behaviors intact."""
        return pb.RateLimitReq(
            name=req.name,
            unique_key=req.unique_key,
            hits=hits,
            limit=req.limit,
            duration=req.duration,
            algorithm=int(req.algorithm),
            behavior=(int(req.behavior) & _GRANT_BEHAVIOR)
            | int(Behavior.NO_BATCHING),
            burst=req.burst,
        )

    async def _check(self, item) -> "pb.RateLimitResp":
        resps = await self.daemon.get_rate_limits([item])
        return resps[0]

    def _prune(self, now_ms: int) -> None:
        """Expire in-memory records past their TTL. The table's ledger
        reclaims itself (TTL eviction); this keeps the Σ-outstanding gauge
        and the per-key map honest without any background task."""
        while self._expiry and self._expiry[0][0] <= now_ms:
            exp_at, lease_id = heapq.heappop(self._expiry)
            rec = self._leases.get(lease_id)
            if rec is None or rec.expires_at != exp_at:
                continue  # renewed (re-pushed under the new deadline) or gone
            del self._leases[lease_id]
            self._drop_outstanding(rec.hash_key, rec.outstanding)
            self.expirations += 1
            self.tokens_expired += rec.outstanding
            self.metrics.lease_ops.labels(op="expire").inc()
            self.metrics.lease_tokens.labels(kind="expired").inc(
                rec.outstanding
            )
        self._observe()

    def _drop_outstanding(self, hash_key: str, n: int) -> None:
        left = self._by_key.get(hash_key, 0) - n
        if left > 0:
            self._by_key[hash_key] = left
        else:
            self._by_key.pop(hash_key, None)

    def _observe(self) -> None:
        self.metrics.lease_outstanding.set(sum(self._by_key.values()))
        self.metrics.lease_active.set(len(self._leases))

    @staticmethod
    def _retry_after(resp: "pb.RateLimitResp", now_ms: int) -> int:
        raw = resp.metadata.get("retry_after_ms", "")
        if raw:
            try:
                return max(0, int(raw))
            except ValueError:
                pass
        return max(0, int(resp.reset_time) - now_ms)

    # ------------------------------------------------------------- the RPC
    async def lease_quota(self, req: "pb.LeaseQuotaReq") -> "pb.LeaseQuotaResp":
        """One acquire / renew / return operation (proto/gubernator.proto
        LeaseQuotaReq). Order of effects: returns first (they free budget),
        then the ledger acquire (caps Σ outstanding), then the real-limit
        grant — a denied grant releases its ledger acquisition so the two
        rows can never drift apart by more than one in-flight op."""
        if req.unique_key == "":
            return pb.LeaseQuotaResp(error="field 'unique_key' cannot be empty")
        if req.name == "":
            return pb.LeaseQuotaResp(error="field 'namespace' cannot be empty")
        if req.limit <= 0 or req.duration <= 0:
            return pb.LeaseQuotaResp(
                error="lease quota requires a positive limit and duration"
            )
        if req.tokens < 0 or req.return_tokens < 0:
            return pb.LeaseQuotaResp(
                error="tokens/return_tokens must be >= 0 (returns travel in "
                "return_tokens, not negative grants)"
            )
        now = self.daemon.now_ms()
        self._prune(now)
        ttl = self._ttl(int(req.ttl_ms))
        hash_key = req.name + "_" + req.unique_key
        rec = self._leases.get(req.lease_id) if req.lease_id else None
        if rec is not None and rec.hash_key != hash_key:
            # a lease id minted for a DIFFERENT key: honoring it would
            # refund/attribute tokens across keys — treat as unknown (the
            # renew becomes a fresh acquire, the return refunds nothing)
            rec = None

        # ---- 1. return unused tokens (early return, renewal shrink, close).
        # The refund is clamped by the LEASE RECORD, not the request: a
        # return may only give back tokens this daemon granted this lease —
        # otherwise a forged/duplicated return would refund tokens other
        # traffic legitimately consumed (token buckets BANK negative hits
        # past the limit by reference rule, so the record clamp is the
        # load-bearing bound here). After a daemon restart the records are
        # gone, so late returns refund nothing (conservative: the tokens
        # stay consumed until the window resets; the table's ledger
        # reclaims its side by TTL regardless, miss-safely — ops/math.py).
        remaining = -1
        if req.return_tokens > 0:
            give = 0
            if rec is not None:
                give = min(int(req.return_tokens), rec.outstanding)
            elif req.lease_id:
                self.unknown_returns += 1
                self.metrics.lease_ops.labels(op="unknown_return").inc()
            if give > 0:
                await self._check(self._ledger_item(req, -give, ttl))
                r = await self._check(self._grant_item(req, -give))
                remaining = int(r.remaining)
                rec.outstanding -= give
                self._drop_outstanding(hash_key, give)
                self.returns += 1
                self.tokens_returned += give
                self.metrics.lease_ops.labels(op="return").inc()
                self.metrics.lease_tokens.labels(kind="returned").inc(give)

        # ---- 2. the new grant, ledger first
        want = int(req.tokens)
        granted = 0
        retry_after = 0
        error = ""
        if want > 0:
            want = min(want, self._cap(int(req.limit)))
            if self.priority_scaling:
                # tier-aware sizing: tier 3 keeps the full slice, each tier
                # below loses a quarter (tier 0 → 25%) — high-priority
                # edges find budget first when every edge is asking
                tier = priority_tier(req.behavior)
                want = max(1, (want * (tier + 1)) // PRIORITY_TIERS)
            lr = await self._check(self._ledger_item(req, want, ttl))
            if lr.error:
                error = lr.error
            elif lr.status == pb.OVER_LIMIT:
                # partial: re-try at whatever the ledger still allows
                avail = int(lr.remaining)
                if avail > 0:
                    lr2 = await self._check(
                        self._ledger_item(req, avail, ttl)
                    )
                    if lr2.status == pb.UNDER_LIMIT and not lr2.error:
                        want = avail
                    else:
                        want = 0
                else:
                    want = 0
                if want == 0:
                    retry_after = self._retry_after(lr, now)
            if not error and want > 0:
                gr = await self._check(self._grant_item(req, want))
                if gr.error:
                    error = gr.error
                    granted = 0
                elif gr.status == pb.UNDER_LIMIT:
                    granted = want
                else:
                    # real limit can't cover the slice — shrink to what's
                    # left (one retry), like the adaptive client would
                    avail = max(0, int(gr.remaining))
                    if avail > 0:
                        gr2 = await self._check(self._grant_item(req, avail))
                        if gr2.status == pb.UNDER_LIMIT and not gr2.error:
                            granted = avail
                            gr = gr2
                    if granted == 0:
                        retry_after = self._retry_after(gr, now)
                remaining = int(gr.remaining)
                if granted < want:
                    # release the ledger slack so Σ outstanding matches the
                    # tokens actually out at the edge
                    await self._check(
                        self._ledger_item(req, granted - want, ttl)
                    )

        # ---- 3. bookkeeping + response
        expires_at = now + ttl
        if granted > 0:
            if rec is None:
                # ALWAYS mint a fresh id: adopting a caller-supplied one
                # (a stale/foreign lease_id on a renew-after-restart)
                # would overwrite whatever record that id still names —
                # the client adopts the returned id (LocalLimiter does)
                rec = LeaseRecord(
                    lease_id=uuid.uuid4().hex,
                    name=req.name,
                    unique_key=req.unique_key,
                    hash_key=hash_key,
                    outstanding=0,
                    expires_at=expires_at,
                    granted_total=0,
                )
                self._leases[rec.lease_id] = rec
                self.acquires += 1
                self.metrics.lease_ops.labels(op="acquire").inc()
            else:
                self.renews += 1
                self.metrics.lease_ops.labels(op="renew").inc()
            rec.outstanding += granted
            rec.granted_total += granted
            rec.expires_at = expires_at
            heapq.heappush(self._expiry, (expires_at, rec.lease_id))
            self._by_key[hash_key] = self._by_key.get(hash_key, 0) + granted
            self.tokens_granted += granted
            self.metrics.lease_tokens.labels(kind="granted").inc(granted)
        elif want >= 0 and req.tokens > 0:
            self.denies += 1
            self.metrics.lease_ops.labels(op="deny").inc()
        self._observe()
        # push-shrink hint: when the key is pressured (Σ outstanding ≥ 80%
        # of the cap), ask lower-tier edges to cut their local grant ahead
        # of the TTL so high-tier traffic finds budget; tier 3 never
        # shrinks, and the hint is advisory (an edge that ignores it is
        # still bounded by TTL reclamation)
        shrink_to = 0
        if (
            self.priority_scaling
            and rec is not None
            and rec.outstanding > 0
        ):
            tier = priority_tier(req.behavior)
            cap = self._cap(int(req.limit))
            pressured = self._by_key.get(hash_key, 0) * 5 >= cap * 4
            if pressured and tier < PRIORITY_TIERS - 1:
                target = (rec.outstanding * (tier + 1)) // PRIORITY_TIERS
                if target < rec.outstanding:
                    shrink_to = max(1, target)
                    self.shrink_hints += 1
                    self.metrics.lease_ops.labels(op="shrink_hint").inc()
        return pb.LeaseQuotaResp(
            lease_id=rec.lease_id if rec is not None else "",
            granted=granted,
            expires_at=rec.expires_at if rec is not None else 0,
            limit=req.limit,
            remaining=max(0, remaining) if remaining >= 0 else 0,
            retry_after_ms=retry_after,
            outstanding=self._by_key.get(hash_key, 0),
            error=error,
            shrink_to=shrink_to,
        )

    # -------------------------------------------------------- introspection
    def outstanding_total(self) -> int:
        """Σ outstanding leased tokens on this daemon — the live
        over-admission bound contribution."""
        return sum(self._by_key.values())

    def debug(self) -> dict:
        """Live lease-plane state for /v1/debug/leases."""
        self._prune(self.daemon.now_ms())
        keys = sorted(
            self._by_key.items(), key=lambda kv: -kv[1]
        )[:64]
        return {
            "active_leases": len(self._leases),
            # Σ outstanding tokens = the proven over-admission bound the
            # delegation adds on top of the limits themselves
            "outstanding_tokens_total": self.outstanding_total(),
            "over_admission_bound": self.outstanding_total(),
            "outstanding_by_key": {k: v for k, v in keys},
            "ops": {
                "acquires": self.acquires,
                "renews": self.renews,
                "returns": self.returns,
                "denies": self.denies,
                "expirations": self.expirations,
                "unknown_returns": self.unknown_returns,
                "shrink_hints": self.shrink_hints,
            },
            "tokens": {
                "granted": self.tokens_granted,
                "returned": self.tokens_returned,
                "expired": self.tokens_expired,
            },
            "knobs": {
                "max_fraction": self.max_fraction,
                "min_ttl_ms": self.min_ttl_ms,
                "max_ttl_ms": self.max_ttl_ms,
                "max_outstanding": self.max_outstanding,
                "priority_scaling": self.priority_scaling,
            },
        }

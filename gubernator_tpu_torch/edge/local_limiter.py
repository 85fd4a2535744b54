"""LocalLimiter — admit at memory speed from a leased slice of a limit.

The client half of the edge quota-lease plane (the port of
``gubernator_tpu/edge/local_limiter.py``; service/lease_manager.py is the
server half). Host code with no tensors. One LocalLimiter guards one
(name, unique_key) limit:

* ``allow(hits)`` is the SYNCHRONOUS hot path: a lock-guarded counter
  decrement against the leased budget — no RPC, no event loop, safe from
  any thread. This is what cuts the per-check RPC fan-in into the daemon
  by the grant size (chip_smoke.py's ``leases`` phase measures the cut on
  the card).
* A background task renews ahead of expiry with ADAPTIVE grant sizing:
  exhaustion before renewal doubles the next grant; a mostly-unused grant
  (returned-unused fraction above ``waste_fraction``) halves it — so a hot
  key converges to few, fat grants and an idle key gives its tokens back.
* ``check(hits)`` is the graceful-degradation path: local first, then a
  per-check GetRateLimits RPC when the lease lane is exhausted — honoring
  the server's ``retry_after_ms`` (denials short-circuit locally until the
  conforming instant, so a denied edge never hammers the daemon).

Honesty bounds (asserted by tests/test_torch_leases.py and chip_smoke.py's
``leases`` phase): local admissions never exceed tokens granted; a limiter
stops admitting the instant its lease expires (an unreachable daemon
degrades, never over-admits); across a daemon crash + restart, total
admissions ≤ limit + outstanding-at-crash.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Union

from gubernator_tpu_torch.client import V1Client, response_retry_after_ms
from gubernator_tpu_torch.proto import gubernator_pb2 as pb

log = logging.getLogger("gubernator_tpu_torch.edge")


def _now_ms() -> int:
    return int(time.time() * 1000)


@dataclass
class LimiterStats:
    """Lifetime counters — the edge-side mirror of the daemon's lease
    metric families."""

    local_admits: int = 0
    local_denies: int = 0  # no budget AND no RPC fallback taken
    rpc_checks: int = 0
    rpc_admits: int = 0
    rpc_denies: int = 0
    backoff_denies: int = 0  # denied locally inside a retry_after window
    grants: int = 0
    tokens_granted: int = 0
    tokens_returned: int = 0
    renew_errors: int = 0
    exhaustions: int = 0
    shrinks: int = 0  # push-shrink hints honored
    grant_sizes: list = field(default_factory=list)


class LocalLimiter:
    """Client-side admission against one leased limit. Use::

        lim = LocalLimiter("host:port", "requests", "tenant-1",
                           limit=10_000, duration=60_000)
        await lim.start()
        ...
        if lim.allow():          # sync hot path (any thread)
            handle_request()
        ...
        ok, retry_ms = await lim.check()   # local-then-RPC path
        ...
        await lim.close()        # returns unused tokens

    ``behavior`` may carry GLOBAL / MULTI_REGION — leased consumption then
    replicates exactly like ordinary hits (a grant IS hits to the daemon).
    """

    def __init__(
        self,
        target: Union[str, V1Client],
        name: str,
        unique_key: str,
        limit: int,
        duration: int,
        algorithm: int = 0,
        behavior: int = 0,
        burst: int = 0,
        *,
        ttl_ms: int = 2_000,
        initial_grant: int = 0,  # 0 = max(min_grant, limit // 16)
        min_grant: int = 1,
        max_grant: int = 0,  # 0 = no client-side ceiling (server caps)
        renew_fraction: float = 0.6,  # renew at this fraction of the TTL
        waste_fraction: float = 0.5,  # unused/grant above this shrinks
        timeout_s: float = 5.0,
    ):
        if limit <= 0 or duration <= 0:
            raise ValueError("limit and duration must be positive")
        if isinstance(target, V1Client):
            self._client = target
            self._own_client = False
        else:
            self._client = V1Client(target, timeout_s=timeout_s)
            self._own_client = True
        self.name = name
        self.unique_key = unique_key
        self.limit = int(limit)
        self.duration = int(duration)
        self.algorithm = int(algorithm)
        self.behavior = int(behavior)
        self.burst = int(burst)
        self.ttl_ms = int(ttl_ms)
        self.min_grant = max(1, int(min_grant))
        self.max_grant = int(max_grant) or self.limit
        self.renew_fraction = renew_fraction
        self.waste_fraction = waste_fraction
        self.timeout_s = timeout_s
        self._grant = int(initial_grant) or max(
            self.min_grant, self.limit // 16
        )
        self._grant = min(self._grant, self.max_grant)
        self.stats = LimiterStats()
        # the admission-hot state, guarded by a plain lock: allow() must be
        # callable from any thread while the renewal task runs on the loop
        self._lock = threading.Lock()
        self._budget = 0
        self._expires_at = 0  # epoch ms; 0 = no live lease
        self._exhausted = False  # budget hit 0 since the last renewal
        self._lease_id = ""
        self._backoff_until = 0  # epoch ms gate on the RPC fallback
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._renew_task: Optional[asyncio.Task] = None
        self._closed = False

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> "LocalLimiter":
        """Acquire the first grant and start the background renewal task.
        A daemon that is unreachable or out of lease budget does NOT fail
        start(): the limiter comes up budget-less and serves through the
        per-check fallback until a later renewal succeeds."""
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        try:
            await self._renew_once()
        except Exception as exc:
            self.stats.renew_errors += 1
            log.warning("initial lease acquire failed: %s", exc)
        self._renew_task = self._loop.create_task(
            self._renew_loop(), name=f"lease-renew:{self.name}"
        )
        return self

    async def close(self) -> None:
        """Stop renewing and return every unused token to the limit."""
        self._closed = True
        if self._renew_task is not None:
            self._renew_task.cancel()
            try:
                await self._renew_task
            except asyncio.CancelledError:
                pass
        with self._lock:
            give, self._budget = self._budget, 0
            lease_id, self._lease_id = self._lease_id, ""
            self._expires_at = 0
        if give > 0 and lease_id:
            try:
                await self._client.lease_quota(
                    self._req(tokens=0, return_tokens=give, lease_id=lease_id),
                    timeout_s=self.timeout_s,
                )
                self.stats.tokens_returned += give
            except Exception as exc:
                log.warning("final token return failed: %s", exc)
        if self._own_client:
            await self._client.close()

    # ------------------------------------------------------------ hot path
    def allow(self, hits: int = 1) -> bool:
        """Admit `hits` from the leased budget — the memory-speed path.
        Returns False when the budget is exhausted OR the lease has
        expired (never over-admits on a dead lease); exhaustion wakes the
        renewal task so the next grant is already in flight while callers
        fall back to check()."""
        if hits <= 0:
            return True
        now = _now_ms()
        with self._lock:
            if self._budget >= hits and now < self._expires_at:
                self._budget -= hits
                self.stats.local_admits += hits
                if self._budget == 0:
                    self._exhausted = True
                    self._signal()
                return True
            self._exhausted = True
            self.stats.local_denies += 1
        self._signal()
        return False

    @property
    def budget(self) -> int:
        with self._lock:
            return self._budget

    @property
    def lease_expires_at(self) -> int:
        return self._expires_at

    def _signal(self) -> None:
        """Wake the renewal task from any thread (lock may be held)."""
        loop, wake = self._loop, self._wake
        if loop is None or wake is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # loop shut down mid-signal

    # -------------------------------------------------- degradation path
    async def check(self, hits: int = 1) -> "tuple[bool, int]":
        """Local-first admission with per-check RPC fallback. Returns
        (admitted, retry_after_ms). Honors the server's retry_after: a
        denial short-circuits further RPCs locally until its conforming
        instant, so a saturated edge backs off instead of turning the
        fan-in reduction back into RPC load."""
        if self.allow(hits):
            return True, 0
        now = _now_ms()
        if now < self._backoff_until:
            self.stats.backoff_denies += 1
            return False, self._backoff_until - now
        self.stats.rpc_checks += 1
        try:
            resp = (
                await self._client.get_rate_limits([
                    pb.RateLimitReq(
                        name=self.name,
                        unique_key=self.unique_key,
                        hits=hits,
                        limit=self.limit,
                        duration=self.duration,
                        algorithm=self.algorithm,
                        behavior=self.behavior,
                        burst=self.burst,
                    )
                ], timeout_s=self.timeout_s)
            ).responses[0]
        except Exception:
            # unreachable daemon: fail closed (the lease plane already
            # bounds what an edge may admit while partitioned)
            self.stats.rpc_denies += 1
            return False, 0
        if resp.status == pb.UNDER_LIMIT and not resp.error:
            self.stats.rpc_admits += 1
            return True, 0
        retry = response_retry_after_ms(resp)
        if retry > 0:
            self._backoff_until = max(self._backoff_until, now + retry)
        self.stats.rpc_denies += 1
        return False, retry

    # ------------------------------------------------------------- renewal
    def _req(self, tokens: int, return_tokens: int, lease_id: str):
        return pb.LeaseQuotaReq(
            name=self.name,
            unique_key=self.unique_key,
            tokens=tokens,
            limit=self.limit,
            duration=self.duration,
            algorithm=self.algorithm,
            behavior=self.behavior,
            burst=self.burst,
            ttl_ms=self.ttl_ms,
            lease_id=lease_id,
            return_tokens=return_tokens,
        )

    def _next_deadline_s(self) -> float:
        """Seconds until the renewal should fire: renew_fraction through
        the TTL, or soon-ish when no lease is live (retry cadence)."""
        if self._expires_at <= 0:
            return max(self.ttl_ms / 1e3 / 4, 0.05)
        lead = self._expires_at - self.ttl_ms * (1.0 - self.renew_fraction)
        return max((lead - _now_ms()) / 1e3, 0.01)

    async def _renew_loop(self) -> None:
        while not self._closed:
            try:
                await asyncio.wait_for(
                    self._wake.wait(), timeout=self._next_deadline_s()
                )
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            if self._closed:
                return
            try:
                await self._renew_once()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # daemon unreachable: keep serving the remaining local
                # budget until lease expiry (bounded by outstanding), then
                # allow() fails closed; the loop keeps retrying
                self.stats.renew_errors += 1
                log.debug("lease renewal failed: %s", exc)
                await asyncio.sleep(
                    min(0.25, self.ttl_ms / 1e3 / 4)
                )

    async def _renew_once(self) -> None:
        """One renewal round: adapt the grant size, return excess budget,
        acquire the next slice. The budget decrement for returned tokens
        happens BEFORE the RPC (restored on failure), so a token can never
        be both returned and locally admitted."""
        with self._lock:
            b = self._budget
            exhausted, self._exhausted = self._exhausted, False
        if exhausted:
            self._grant = min(self._grant * 2, self.max_grant)
        elif b >= self._grant * self.waste_fraction and self.stats.grants:
            self._grant = max(self.min_grant, self._grant // 2)
        give = 0
        if b > self._grant:
            with self._lock:
                give = max(0, self._budget - self._grant)
                self._budget -= give
        ask = max(self.min_grant, self._grant - (b - give))
        try:
            resp = await self._client.lease_quota(
                self._req(
                    tokens=ask, return_tokens=give, lease_id=self._lease_id
                ),
                timeout_s=self.timeout_s,
            )
        except Exception:
            if give:
                with self._lock:
                    self._budget += give  # nothing was returned
            raise
        if resp.error:
            if give:
                with self._lock:
                    self._budget += give
            raise RuntimeError(f"lease denied: {resp.error}")
        if give:
            self.stats.tokens_returned += give
        granted = int(resp.granted)
        with self._lock:
            if granted > 0:
                self._budget += granted
                self._lease_id = resp.lease_id
                self._expires_at = int(resp.expires_at)
            elif resp.lease_id and resp.lease_id == self._lease_id:
                # returns against a live lease still refresh its deadline
                self._expires_at = max(
                    self._expires_at, int(resp.expires_at)
                )
        # push-shrink hint (LeaseQuotaResp.shrink_to): the daemon is asking
        # this edge to run on a smaller slice — clamp the adaptive grant
        # target BEFORE the next admission burst, so the following renewal
        # round returns the excess (the b > _grant giveback above) instead
        # of holding pressured quota until the TTL
        shrink = int(getattr(resp, "shrink_to", 0))
        if shrink > 0 and shrink < self._grant:
            self._grant = max(self.min_grant, shrink)
            self.stats.shrinks += 1
            self._wake.set()  # return the excess promptly, not at the TTL
        if granted > 0:
            self.stats.grants += 1
            self.stats.tokens_granted += granted
            self.stats.grant_sizes.append(granted)
        else:
            # lease lane exhausted: honor the hint before asking again
            retry = int(resp.retry_after_ms)
            if retry > 0:
                self._backoff_until = max(
                    self._backoff_until, _now_ms() + retry
                )

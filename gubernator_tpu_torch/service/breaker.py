"""Per-peer circuit breaker — closed → open → half-open with jittered backoff.

The peer plane's fault-tolerance primitive (Nygard, *Release It!*; Dean &
Barroso, *The Tail at Scale*). Each PeerClient owns one breaker; every unary
RPC consults it. Consecutive failures trip the breaker OPEN; while open,
calls fail fast (no RPC, no timeout wait) until a jittered exponential
cooldown elapses. The first call after the cooldown becomes a HALF_OPEN
probe (bounded by `probe_budget` concurrent probes); a probe success closes
the breaker, a probe failure re-opens it with a doubled cooldown.

Backoff uses *equal jitter*: half the exponential delay is deterministic,
half uniform-random — spreading reconnect storms across peers without the
near-zero sleeps full jitter allows (which would turn the open state into a
busy retry loop).
"""

from __future__ import annotations

import enum
import random
import time
from typing import Callable, Optional


class BreakerState(enum.IntEnum):
    # gauge values: the metric (gubernator_circuit_breaker_state) exports the
    # integer, so order is meaning: 0 healthy → 2 tripped
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


_STATE_NAMES = {
    BreakerState.CLOSED: "closed",
    BreakerState.HALF_OPEN: "half-open",
    BreakerState.OPEN: "open",
}


class CircuitBreaker:
    """Single-threaded (asyncio) circuit breaker for one peer.

    allow()           — reserve the right to attempt an RPC now (may
                        transition OPEN → HALF_OPEN and consume a probe slot)
    record_success()  — RPC completed; closes the breaker, resets backoff
    record_failure()  — RPC failed; counts toward the trip threshold, or
                        re-opens from HALF_OPEN with a doubled cooldown
    record_discard()  — RPC neither succeeded nor failed (cancellation);
                        releases a probe slot without a verdict
    blocked           — side-effect-free "would allow() refuse right now?"
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        backoff_base_ms: float = 200.0,
        backoff_cap_ms: float = 30_000.0,
        probe_budget: int = 1,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        on_state: Optional[Callable[[BreakerState], None]] = None,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.backoff_base_s = backoff_base_ms / 1e3
        self.backoff_cap_s = max(backoff_cap_ms, backoff_base_ms) / 1e3
        self.probe_budget = max(1, int(probe_budget))
        self._clock = clock
        self._rng = rng or random
        self._on_state = on_state
        self._state = BreakerState.CLOSED
        self._failures = 0  # consecutive failures while CLOSED
        self._openings = 0  # consecutive open cycles (backoff exponent)
        self._open_until = 0.0
        self._probes = 0  # in-flight HALF_OPEN probes

    # ---------------------------------------------------------------- state
    @property
    def state(self) -> BreakerState:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    def _set_state(self, s: BreakerState) -> None:
        if s is not self._state:
            self._state = s
            if self._on_state is not None:
                self._on_state(s)

    @property
    def blocked(self) -> bool:
        """True when an attempt right now would be refused — open and still
        cooling down, or half-open with the probe budget exhausted."""
        if self._state is BreakerState.OPEN:
            return self._clock() < self._open_until
        if self._state is BreakerState.HALF_OPEN:
            return self._probes >= self.probe_budget
        return False

    def retry_after_s(self) -> float:
        """Remaining cooldown (0 when an attempt is allowed)."""
        if self._state is BreakerState.OPEN:
            return max(0.0, self._open_until - self._clock())
        return 0.0

    # ------------------------------------------------------------- protocol
    def allow(self) -> bool:
        if self._state is BreakerState.CLOSED:
            return True
        if self._state is BreakerState.OPEN:
            if self._clock() < self._open_until:
                return False
            # cooldown elapsed: this caller becomes the first probe
            self._set_state(BreakerState.HALF_OPEN)
            self._probes = 1
            return True
        # HALF_OPEN: bounded concurrent probes
        if self._probes < self.probe_budget:
            self._probes += 1
            return True
        return False

    def record_success(self) -> None:
        if self._state is BreakerState.HALF_OPEN:
            self._probes = max(0, self._probes - 1)
        # any completed RPC is proof of life — also closes from OPEN when a
        # long pre-trip call finishes late
        self._failures = 0
        self._openings = 0
        self._set_state(BreakerState.CLOSED)

    def record_failure(self) -> None:
        if self._state is BreakerState.HALF_OPEN:
            self._probes = max(0, self._probes - 1)
            self._trip()
        elif self._state is BreakerState.CLOSED:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()
        # OPEN: a stale in-flight failure must not extend the cooldown

    def record_discard(self) -> None:
        if self._state is BreakerState.HALF_OPEN:
            self._probes = max(0, self._probes - 1)

    def _trip(self) -> None:
        self._failures = 0
        self._openings += 1
        exp = min(self._openings - 1, 32)  # bound 2**n
        ceiling = min(self.backoff_cap_s, self.backoff_base_s * (2**exp))
        # equal jitter: [ceiling/2, ceiling)
        delay = ceiling / 2 + self._rng.uniform(0, ceiling / 2)
        self._open_until = self._clock() + delay
        self._set_state(BreakerState.OPEN)

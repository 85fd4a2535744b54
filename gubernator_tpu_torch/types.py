"""Core enums and request/response types.

The port's own copy of ``gubernator_tpu/types.py``: the same enum values,
field names and semantics (reference gubernator.proto:63-210), kept here so
the port never imports the JAX package. Only the request/response surface
the single-device engine needs is carried over.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class Algorithm(enum.IntEnum):
    # reference gubernator.proto:64-68
    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1
    # extensions beyond the reference enum (docs/algorithms.md)
    GCRA = 2
    SLIDING_WINDOW = 3
    CONCURRENCY_LEASE = 4


# highest algorithm value the kernel speaks — anything above is a per-item
# validation error (ops/batch.ERR_ALGORITHM)
MAX_ALGORITHM = int(Algorithm.CONCURRENCY_LEASE)


class Behavior(enum.IntFlag):
    """Bitflag behaviors (reference gubernator.proto:71-142)."""

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16
    DRAIN_OVER_LIMIT = 32


class Status(enum.IntEnum):
    # reference gubernator.proto:192-195
    UNDER_LIMIT = 0
    OVER_LIMIT = 1


class Gregorian(enum.IntEnum):
    """Valid `duration` values when DURATION_IS_GREGORIAN is set
    (reference interval.go:74-81)."""

    MINUTES = 0
    HOURS = 1
    DAYS = 2
    WEEKS = 3  # rejected, like the reference
    MONTHS = 4
    YEARS = 5


def has_behavior(behavior: int, flag: int) -> bool:
    """reference behavior.go HasBehavior equivalent."""
    return (int(behavior) & int(flag)) != 0


# millisecond duration helpers (reference gubernator.proto:157-162)
SECOND = 1000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE


@dataclass
class RateLimitRequest:
    """One rate-limit check (reference RateLimitReq, gubernator.proto:144-190)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 1
    limit: int = 0
    duration: int = 0  # milliseconds, or a Gregorian enum when flagged
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = 0
    burst: int = 0  # leaky/GCRA burst; 0 → defaults to limit
    metadata: Optional[Dict[str, str]] = None
    created_at: Optional[int] = None  # epoch ms; stamped at ingress if unset
    # cascade levels ride the behavior word's bits 8-15 at the engine
    # surface; callers expand a cascade into one row per level
    cascade: Optional[list] = None

    def hash_key(self) -> str:
        # reference client.go:39-41 — cache key is name + "_" + unique_key
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResponse:
    """One decision (reference RateLimitResp, gubernator.proto:197-210),
    plus the retry_after extension."""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0  # epoch ms when the limit is reset
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)
    retry_after_ms: int = 0


def retry_after_ms(status: int, reset_time: int, now_ms: int) -> int:
    """Denied rows report the ms until their reset/conforming instant
    (clamped at 0), allowed rows 0."""
    if status != Status.OVER_LIMIT:
        return 0
    return max(0, int(reset_time) - int(now_ms))

"""Core enums and request/response types.

The port's own copy of ``gubernator_tpu/types.py``: the same enum values,
field names and semantics (reference gubernator.proto:63-210), kept here so
the port never imports the JAX package: the request/response surface, the
behavior-word fields (cascade level, priority tier), and the peer and
audit-event records of the service layer.
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

# ---- cascaded multi-limit checks (docs/algorithms.md "Cascades").
# A cascade request expands into one engine row per limit level sharing a
# request carrier; the level rides the behavior word's bits 8-15. Level 0 =
# the carrier (or any standalone request); levels >= 1 are member rows that
# immediately follow their carrier in batch order.
CASCADE_LEVEL_SHIFT = 8
CASCADE_LEVEL_MASK = 0xFF
# deepest level the compact wire can carry (2 spare lane bits — ops/wire.py);
# deeper cascades ride the full-width grids with identical semantics
CASCADE_WIRE_MAX_LEVEL = 3


def cascade_level(behavior: int) -> int:
    """The cascade level encoded in a behavior word (0 = carrier/standalone)."""
    return (int(behavior) >> CASCADE_LEVEL_SHIFT) & CASCADE_LEVEL_MASK


def with_cascade_level(behavior: int, level: int) -> int:
    """Behavior word with the cascade level field set."""
    if not (0 <= level <= CASCADE_LEVEL_MASK):
        raise ValueError(f"cascade level {level} out of range")
    return (int(behavior) & ~(CASCADE_LEVEL_MASK << CASCADE_LEVEL_SHIFT)) | (
        level << CASCADE_LEVEL_SHIFT
    )


# ---- priority tiers (docs/robustness.md "Overload & QoS").
# A 2-bit priority field rides the behavior word's bits 6-7, below the
# cascade-level field. Tier 0 is the default (best-effort); higher tiers are
# shed last under overload (service/batcher.py). The compact wire carries it
# in dedicated lane bits (ops/wire.py) and the kernel echoes it in the
# egress flags.
PRIORITY_SHIFT = 6
PRIORITY_MASK = 0x3
PRIORITY_TIERS = 4  # tiers 0..3; 3 = most important, shed last


def priority_tier(behavior: int) -> int:
    """The priority tier encoded in a behavior word (0 = best-effort)."""
    return (int(behavior) >> PRIORITY_SHIFT) & PRIORITY_MASK


def with_priority(behavior: int, tier: int) -> int:
    """Behavior word with the priority tier field set."""
    if not (0 <= tier <= PRIORITY_MASK):
        raise ValueError(f"priority tier {tier} out of range")
    return (int(behavior) & ~(PRIORITY_MASK << PRIORITY_SHIFT)) | (
        tier << PRIORITY_SHIFT
    )


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
class CascadeLevel:
    """One additional limit level of a cascaded multi-limit check
    (proto CascadeLevel — docs/algorithms.md "Cascades")."""

    name: str = ""
    unique_key: str = ""
    limit: int = 0
    duration: int = 0  # milliseconds (never Gregorian)
    algorithm: int = Algorithm.TOKEN_BUCKET
    burst: int = 0


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


@dataclass
class PeerInfo:
    """reference peers.go PeerInfo equivalent."""

    grpc_address: str = ""
    http_address: str = ""
    data_center: str = ""
    is_owner: bool = False

    def hash_key(self) -> str:
        return self.grpc_address


@dataclass
class HitEvent:
    """One owner-side hit: the request and the response it produced — the
    audit hook payload (reference config.go:128-135, gubernator.go:676-688),
    delivered on the daemon's event channel when one is configured; fields
    are pb messages (RateLimitReq / RateLimitResp)."""

    request: object
    response: object

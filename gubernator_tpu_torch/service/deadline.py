"""Inbound-deadline propagation for the serving path.

gRPC carries the caller's deadline on every call; the work it gates —
batch-window queueing (service/batcher.py) and peer forwarding
(service/peer_client.py) — happens in asyncio tasks far from the handler.
This module carries the deadline to them as a contextvar: the server
handler stamps the call's absolute expiry once (`set_inbound_deadline`),
and because asyncio tasks inherit the contextvars of their creator, every
await downstream can ask `remaining()` for the budget left and fail fast
instead of doing work whose answer nobody is waiting for.

The value is an ABSOLUTE time.monotonic() instant (not a duration), so it
survives any number of hops without accumulating read-time drift. None
means "no deadline" — direct embedded-engine callers and tests that never
touch gRPC see the legacy unbounded behavior.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "guber_inbound_deadline", default=None
)


def set_inbound_deadline(remaining_s: Optional[float]) -> None:
    """Stamp the current call's deadline from its remaining seconds
    (gRPC `context.time_remaining()`); None / non-positive∞ clears it."""
    if remaining_s is None or remaining_s <= 0 or remaining_s == float("inf"):
        _deadline.set(None)
    else:
        _deadline.set(time.monotonic() + remaining_s)


def inbound_deadline() -> Optional[float]:
    """The absolute monotonic deadline of the inbound call, or None."""
    return _deadline.get()


def remaining(default: Optional[float] = None) -> Optional[float]:
    """Seconds left until the inbound deadline (may be negative once
    past it), or `default` when no deadline is set."""
    d = _deadline.get()
    if d is None:
        return default
    return d - time.monotonic()

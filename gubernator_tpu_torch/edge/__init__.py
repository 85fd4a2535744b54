"""Edge admission library — client-side quota leases (the port of
``gubernator_tpu/edge``; host code, no tensors).

The first subsystem that lives OUTSIDE the daemon: a ``LocalLimiter``
acquires a bounded slice of a limit over the V1 ``LeaseQuota`` RPC and then
admits at memory speed from its local budget — renewing in the background
ahead of expiry with adaptive grant sizing, returning unused tokens early,
and degrading to per-check RPCs (honoring ``retry_after_ms``) when the
lease lane is exhausted or the daemon is unreachable.
"""

from gubernator_tpu_torch.edge.local_limiter import LocalLimiter, LimiterStats

__all__ = ["LocalLimiter", "LimiterStats"]

"""Sanity guards between a timing loop and a published rate (the port's own
copy of ``gubernator_tpu/bench_guard.py``; pure Python, no JAX).

Two failure modes of timing arithmetic are refused here rather than
published: a rate from a time difference that host-clock jitter can make
zero or negative, and a rate from a window dominated by a per-run constant
(launch, fetch) instead of the iterations. The work gates (``check_work``,
``check_dropped``) hold a timed loop's device counters to the decisions its
rate claims, and ``check_transport`` holds a window's transfer share to its
bytes at a plausible bandwidth.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

# The JAX package's ceiling, kept so both copies refuse the same rates: a
# decision reads a 512 B bucket row, writes a slot and sorts with its batch,
# and a rate above 2e9/s is taken for a timing artifact. (On an H100 the
# row reads alone, at 3.35 TB/s, would take 0.31 of the time such a rate
# leaves; the sorts and launches of a dispatch take more.)
MAX_SANE_RATE = 2e9


class WorkMismatchError(Exception):
    """A timed window's device counters did not reconcile with the decisions
    its rate would claim (check_work refusal). Deliberately NOT a
    RuntimeError: torch's CUDA errors are RuntimeErrors, and a catch broad
    enough to take both would mislabel device failures as guard refusals."""


class Slope(NamedTuple):
    rate: Optional[float]  # decisions/s, None if rejected
    per_iter_ms: Optional[float]
    reason: Optional[str]  # rejection reason, None if accepted


def slope(
    t_short: float,
    t_long: float,
    n_short: int,
    n_long: int,
    rows_per_iter: int,
    *,
    min_dt: float = 0.050,
    min_ratio: float = 1.4,
    max_rate: float = MAX_SANE_RATE,
) -> Slope:
    """Validate a two-point slope timing and derive a rate.

    t_short/t_long: wall time of a run of n_short/n_long iterations (each
    run is one replay sequence of ops/loop.decide_loop and one fetch, so
    the per-run constant — launch + fetch — cancels in the difference).

    Rejections:
      * dt under `min_dt` — the difference is smaller than host clock +
        launch jitter can resolve (a dt floored at 1e-9 instead of
        rejected turns two noisy timings into an absurd rate).
      * t_long < min_ratio * t_short — the run time is dominated by the
        per-run constant, not the iterations: the slope would measure
        transport weather, not compute. The caller's remedy is a longer
        window (bigger n_long), not a retry of the same one.
      * rate > max_rate — physically impossible for this hardware
        regardless of how plausible the arithmetic looked.
    """
    if n_long <= n_short:
        return Slope(None, None, f"n_long {n_long} <= n_short {n_short}")
    dt = t_long - t_short
    if dt < min_dt:
        return Slope(
            None, None,
            f"dt {dt*1e3:.1f}ms under {min_dt*1e3:.0f}ms floor "
            "(jitter-resolvable only)",
        )
    if t_long < min_ratio * t_short:
        return Slope(
            None, None,
            f"t_long {t_long:.3f}s < {min_ratio}x t_short {t_short:.3f}s: "
            "per-run constant dominates; grow the window",
        )
    rate = (n_long - n_short) * rows_per_iter / dt
    if rate > max_rate:
        return Slope(
            None, None,
            f"rate {rate:.3e}/s exceeds physical ceiling {max_rate:.0e}/s",
        )
    return Slope(rate, dt / (n_long - n_short) * 1e3, None)


def check_work(
    counted: int, expected: int, *, label: str = "decisions"
) -> Optional[str]:
    """Proof-of-work cross-check: the device-side counters accumulated by
    the timed loop must equal the decisions the window claims to have made.
    Returns a refusal reason, or None if the work is accounted for."""
    if counted != expected:
        return (
            f"{label} counted {counted} != expected {expected}: "
            "timed window did not do the work its rate claims"
        )
    return None


# Transfer-bandwidth plausibility band for the transport-dominance gate.
# Upper bound: no host<->device link this code runs over beats PCIe gen5
# x16-class speed; a timed window whose bytes/second exceed it did NOT move
# the bytes it reports (the win is timing drift, not wire engineering).
# Lower bound: a "transfer" phase moving under ~1 MB/s isn't transfer at
# all — the window's transport share is dominated by something the byte
# count can't account for (a stall, host jitter), so attributing a wire win
# to it would publish drift as engineering.
MAX_SANE_BANDWIDTH = 64e9  # bytes/s
MIN_SANE_BANDWIDTH = 1e6  # bytes/s


def check_transport(
    transfer_s: float,
    bytes_on_wire: int,
    *,
    min_bandwidth: float = MIN_SANE_BANDWIDTH,
    max_bandwidth: float = MAX_SANE_BANDWIDTH,
    label: str = "window",
) -> Optional[str]:
    """Transport-dominance gate: a timed window's transfer share must be
    accountable against its reported bytes at a physically plausible
    bandwidth. `transfer_s` is the wall time the window attributes to
    host<->device transfers; `bytes_on_wire` the bytes its wire counters
    say crossed the boundary in that time (ShardedEngine.take_wire_deltas).

    The compact-wire work makes dispatch claims byte-denominated, which
    cuts both ways: a 'win' can be faked by a window whose timing happens
    to shrink for reasons unrelated to bytes. The implied bandwidth
    (bytes / transfer_s) exposes both failure modes — too fast means the
    bytes were never moved in the measured time, too slow means the
    measured time wasn't transfer. Returns a refusal reason, or None."""
    if bytes_on_wire < 0:
        return f"{label}: negative byte count {bytes_on_wire}"
    if bytes_on_wire == 0:
        return None  # nothing claimed against the wire
    if transfer_s <= 0:
        return (
            f"{label}: {bytes_on_wire} bytes claimed against a "
            f"{transfer_s * 1e3:.3f}ms transfer share — no time in which "
            "to move them"
        )
    implied = bytes_on_wire / transfer_s
    if implied > max_bandwidth:
        return (
            f"{label}: implied transfer bandwidth {implied:.3e} B/s exceeds "
            f"the physical ceiling {max_bandwidth:.0e} B/s — the window did "
            "not move the bytes its rate claims"
        )
    if implied < min_bandwidth:
        return (
            f"{label}: implied transfer bandwidth {implied:.3e} B/s is under "
            f"{min_bandwidth:.0e} B/s — the transfer share is not explained "
            "by bytes on the wire (measurement drift, not transport)"
        )
    return None


def check_dropped(
    dropped: int,
    decisions: int,
    *,
    max_frac: float = 0.01,
    label: str = "decisions",
) -> Optional[str]:
    """Write-path proof of work. hit/miss reconciliation (check_work) cannot
    see a write path that probes rows but fails to persist them — dropped
    rows still count as probed — so a broken write (e.g. a sparse grid
    mapping updates into the wrong blocks, or a window geometry that
    overflows every run) would sail through check_work while the timed loop
    'serves' decisions nobody could ever re-read. Such failures surface as a
    drop storm in the loop's own dropped counter; legitimate drops (claim
    dedup under contention, the rare window-overflow tail) stay far under
    `max_frac` for the bench's unique-fingerprint batches. Returns a refusal
    reason, or None if drops are within tolerance."""
    if decisions <= 0:
        return None
    if dropped > max_frac * decisions:
        return (
            f"{dropped} of {decisions} {label} dropped "
            f"(> {max_frac:.1%} tolerance): the write path did not persist "
            "the work its rate claims"
        )
    return None

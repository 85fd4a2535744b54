"""Gregorian-calendar expiration, host-side.

The port's copy of ``gubernator_tpu/gregorian.py`` (reference
interval.go:84-148): the front door resolves DURATION_IS_GREGORIAN requests
into absolute expiry timestamps and interval lengths before the batch
reaches the device. Expiration is the last whole millisecond inside the
current minute/hour/day/month/year in the host's local timezone; weeks are
rejected.
"""

from __future__ import annotations

import datetime as _dt

from gubernator_tpu_torch.types import Gregorian


class GregorianError(ValueError):
    pass


def _local(now_ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(now_ms / 1000.0).astimezone()


def _to_ms(d: _dt.datetime) -> int:
    return int(d.timestamp() * 1000)


def _add_months(d: _dt.datetime, months: int) -> _dt.datetime:
    month = d.month - 1 + months
    year = d.year + month // 12
    month = month % 12 + 1
    return d.replace(year=year, month=month)


def _invalid(d: int) -> GregorianError:
    if d == Gregorian.WEEKS:
        return GregorianError("`duration = GregorianWeeks` not supported")
    return GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `duration` is not a valid "
        "gregorian interval"
    )


def gregorian_duration(now_ms: int, d: int) -> int:
    """Full length of the calendar interval containing `now`, in ms."""
    if d == Gregorian.MINUTES:
        return 60_000
    if d == Gregorian.HOURS:
        return 3_600_000
    if d == Gregorian.DAYS:
        return 86_400_000
    if d == Gregorian.MONTHS:
        n = _local(now_ms)
        begin = n.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(_add_months(begin, 1)) - _to_ms(begin)
    if d == Gregorian.YEARS:
        n = _local(now_ms)
        begin = n.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(begin.replace(year=begin.year + 1)) - _to_ms(begin)
    raise _invalid(d)


def gregorian_expiration(now_ms: int, d: int) -> int:
    """Epoch-ms expiry = the last whole millisecond of the calendar interval
    containing `now`."""
    n = _local(now_ms)
    if d == Gregorian.MINUTES:
        return _to_ms(n.replace(second=0, microsecond=0)) + 60_000 - 1
    if d == Gregorian.HOURS:
        return _to_ms(n.replace(minute=0, second=0, microsecond=0)) + 3_600_000 - 1
    if d == Gregorian.DAYS:
        begin = n.replace(hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(begin) + 86_400_000 - 1
    if d == Gregorian.MONTHS:
        begin = n.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(_add_months(begin, 1)) - 1
    if d == Gregorian.YEARS:
        begin = n.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(begin.replace(year=begin.year + 1)) - 1
    raise _invalid(d)

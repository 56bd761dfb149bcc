"""Time quantum views.

Writes carrying a timestamp land in one view per granularity of the
field's quantum (reference: time.go:143 viewsByTime — e.g. quantum "YMDH"
and t=2010-01-02T03:00 yields standard_2010, standard_201001,
standard_20100102, standard_2010010203). Range reads select the minimal
covering set of views (reference: time.go:158 viewsByTimeRange).
"""

from __future__ import annotations

import datetime as dt
from typing import List

VIEW_STANDARD = "standard"
VIEW_EXISTENCE = "existence"

_UNITS = "YMDH"
_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def validate_quantum(q: str) -> None:
    """A quantum is a contiguous subset of 'YMDH' (reference: time.go:19
    TimeQuantum.Valid)."""
    if q and q not in ("Y", "M", "D", "H", "YM", "MD", "DH", "YMD", "MDH", "YMDH"):
        raise ValueError(f"invalid time quantum {q!r}")


def view_by_time_unit(t: dt.datetime, unit: str) -> str:
    return f"{VIEW_STANDARD}_{t.strftime(_FMT[unit])}"


def views_by_time(t: dt.datetime, quantum: str) -> List[str]:
    """View names a timestamped write lands in (one per quantum unit)."""
    validate_quantum(quantum)
    return [view_by_time_unit(t, u) for u in quantum]


def _floor(t: dt.datetime, unit: str) -> dt.datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _next(t: dt.datetime, unit: str) -> dt.datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        return t.replace(year=t.year + (t.month == 12), month=t.month % 12 + 1)
    if unit == "D":
        return t + dt.timedelta(days=1)
    return t + dt.timedelta(hours=1)


def _ceil(t: dt.datetime, unit: str) -> dt.datetime:
    f = _floor(t, unit)
    return f if f == t else _next(f, unit)


def views_by_time_range(from_t: dt.datetime, to_t: dt.datetime, quantum: str) -> List[str]:
    """Minimal set of views covering [from_t, to_t) — coarse units span the
    middle, finer units trim the edges (reference: time.go:158).

    Boundaries are snapped outward to the finest unit of the quantum
    (data only exists at quantum resolution).
    """
    validate_quantum(quantum)
    if not quantum:
        return []
    units = [u for u in _UNITS if u in quantum]  # coarse -> fine
    finest = units[-1]
    lo = _floor(from_t, finest)
    hi = _ceil(to_t, finest)

    def cover(lo: dt.datetime, hi: dt.datetime, level: int) -> List[str]:
        if lo >= hi or level >= len(units):
            return []
        unit = units[level]
        start, end = _ceil(lo, unit), _floor(hi, unit)
        if start >= end:
            return cover(lo, hi, level + 1)
        out = cover(lo, start, level + 1)
        t = start
        while t < end:
            out.append(view_by_time_unit(t, unit))
            t = _next(t, unit)
        out.extend(cover(end, hi, level + 1))
        return out

    return cover(lo, hi, 0)

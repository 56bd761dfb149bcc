"""Cross-layer per-query deadline budget.

The scheduler (sched/scheduler.py) enforces deadlines while a query is
*queued*; once it dispatches, the remaining budget must keep bounding
the work that runs on its behalf — in particular the cluster fan-out's
remote legs, whose retries and hedges must never outlive the query that
spawned them (cluster/resilience.py budgets every per-leg timeout
against this scope).

A :class:`Deadline` pairs the absolute expiry with the clock that minted
it, so a ManualClock-driven scheduler and a MonotonicClock-driven
transport layer can share one scope without comparing incompatible
timebases. The scope rides a ``contextvars.ContextVar``: it is visible
down the synchronous call chain that provisions remote legs (the
coordinator thread or the scheduler worker), which is exactly where leg
timeouts are computed.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Optional


class Deadline:
    """Absolute expiry bound to the clock that produced it."""

    __slots__ = ("at", "_now")

    def __init__(self, at: float, now: Callable[[], float] = time.monotonic):
        self.at = float(at)
        self._now = now

    def remaining(self) -> float:
        """Seconds left; <= 0 once expired."""
        return self.at - self._now()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


_CURRENT: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "pilosa_query_deadline", default=None)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Install ``deadline`` for the duration of the block (None is a
    valid scope: it clears any outer deadline, e.g. for background
    work kicked off inside a deadlined query)."""
    token = _CURRENT.set(deadline)
    try:
        yield deadline
    finally:
        _CURRENT.reset(token)


def current_deadline() -> Optional[Deadline]:
    return _CURRENT.get()


def remaining_budget_s() -> Optional[float]:
    """Seconds left in the innermost deadline scope, or None when the
    query is unbounded."""
    d = _CURRENT.get()
    return None if d is None else d.remaining()

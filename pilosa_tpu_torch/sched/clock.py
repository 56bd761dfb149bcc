"""Injectable time sources for the scheduler.

The batching window and per-query deadlines are pure functions of a
clock, so tests swap in :class:`ManualClock` and drive windows /
expiries by ``advance()`` — no real-time sleeps, fully deterministic.
Port of ``pilosa_tpu/sched/clock.py``.
"""

from __future__ import annotations

import time


class MonotonicClock:
    """Production clock: real monotonic time, real condition timeouts."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cv, timeout: float) -> None:
        """Block on ``cv`` (held) until notified or ``timeout`` elapses."""
        cv.wait(max(0.0, timeout))

    def attach(self, cv) -> None:  # ManualClock needs the cv; we don't
        pass


class ManualClock:
    """Deterministic test clock: time moves only via :meth:`advance`.

    The scheduler attaches its condition variable so an advance wakes a
    worker parked on a window timeout; ``wait`` ignores the requested
    timeout entirely (only submits / advances / control transitions can
    make progress, which is exactly what makes tests deterministic).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._cv = None

    def attach(self, cv) -> None:
        self._cv = cv

    def now(self) -> float:
        return self._t

    def wait(self, cv, timeout: float) -> None:
        cv.wait()

    def advance(self, seconds: float) -> None:
        cv = self._cv
        if cv is None:
            self._t += seconds
            return
        with cv:
            self._t += seconds
            cv.notify_all()

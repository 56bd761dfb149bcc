"""Shared adaptive batching-window policy.

One small piece of math used by two coalescers: the local micro-batch
scheduler (sched/scheduler.py) and the cluster fan-out leg batcher
(cluster/batch.py). Both face the same trade: a batching window long
enough to coalesce a burst, short enough that a solo arrival is not
parked behind an empty window.

The policy: EWMA the inter-arrival gap, then size the window so it
earns its full length exactly when a ``max_batch``-sized cohort is
expected to arrive within ``window_max`` (gap <= window_max /
max_batch); an idle stream collapses to ``window_min`` so lone
arrivals dispatch promptly.
"""

from __future__ import annotations

from typing import Optional


class ArrivalWindow:
    """EWMA inter-arrival tracker + adaptive window sizing.

    Pure math, no locking: callers observe/read under their own lock
    (both consumers already hold one at the call sites).
    """

    # EWMA smoothing for arrival gaps; ~universal "last ≈ 5 samples"
    EWMA_ALPHA = 0.2

    def __init__(self, window_s: float, *, adaptive: bool = False,
                 window_min_s: float = 0.0, window_max_s: float = 0.0,
                 max_batch: int = 1):
        self.fixed_window_s = max(0.0, float(window_s))
        self.adaptive = bool(adaptive)
        self.window_min_s = max(0.0, float(window_min_s))
        self.window_max_s = max(self.window_min_s, float(window_max_s))
        self.max_batch = max(1, int(max_batch))
        self._gap_ewma: Optional[float] = None
        self._last_arrival: Optional[float] = None

    def observe(self, now: float) -> None:
        """Fold one arrival timestamp into the gap EWMA."""
        last = self._last_arrival
        self._last_arrival = now
        if last is None:
            return
        gap = max(now - last, 1e-6)
        if self._gap_ewma is None:
            self._gap_ewma = gap
        else:
            self._gap_ewma += self.EWMA_ALPHA * (gap - self._gap_ewma)

    def drain_s(self, backlog: int) -> Optional[float]:
        """Estimated seconds for ``backlog`` queued arrivals to clear,
        from the live gap EWMA: under sustained overload service pace
        roughly tracks arrival pace, so the honest back-off is the time
        the backlog took to accumulate (backlog * gap). None until an
        arrival gap has been observed."""
        gap = self._gap_ewma
        if gap is None:
            return None
        return max(1, int(backlog)) * gap

    def window_s(self) -> float:
        """Effective batching window right now. Non-adaptive returns the
        fixed window; adaptive scales with the observed arrival rate and
        collapses to window_min when idle (no gap observed yet)."""
        if not self.adaptive:
            return self.fixed_window_s
        gap = self._gap_ewma
        if gap is None:
            return self.window_min_s
        w = self.window_max_s ** 2 / (gap * self.max_batch)
        return min(max(w, self.window_min_s), self.window_max_s)

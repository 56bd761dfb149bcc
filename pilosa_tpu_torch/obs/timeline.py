"""Timeline sampler: a bounded in-memory time series of cluster health.

Port of ``pilosa_tpu/obs/timeline.py``, unchanged in behaviour.

Point-in-time `/metrics` answers "what is the counter NOW"; the question
an operator actually asks after a p99 spike is "what was happening over
the last 30 seconds". The sampler walks the live MetricsRegistry at a
fixed cadence and appends one compact sample to a ring:

- counters  -> per-second rates (delta vs the previous sample)
- gauges    -> copied as-is
- histograms -> p50/p99 estimates over the observations that arrived
  since the previous sample (linear interpolation inside the bucket)
- probes    -> direct reads of live subsystems (scheduler queue depth,
  device-resident bytes, cache hit ratio, breaker states, WAL flush
  lag, gossip staleness) registered by obs/health.py

Read through ``HealthPlane.timeline_json`` (the HTTP routes
/internal/stats/timeline and /internal/stats/cluster wait for the
port's server and cluster slices). The clock is injectable (sched/clock.py
ManualClock) so tests drive cadence deterministically; production can
run a daemon thread, while the env-flag mode piggybacks sampling on
request accounting (`maybe_sample`) so the full test suite exercises
the sampler with zero background threads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import metrics as obs_metrics

from pilosa_tpu_torch.analysis import locktrace


class WallClock:
    """Default monotonic time source. Any object with ``now()`` works
    (sched.clock.ManualClock in tests) — defined here rather than
    imported from sched/ because obs must not pull in the scheduler
    package at import time (sched -> pql -> core -> obs is the existing
    direction)."""

    def now(self) -> float:
        return time.monotonic()


def estimate_quantile(bounds: List[float], counts: List[int],
                      q: float) -> float:
    """Quantile estimate from cumulative-style bucket counts (``counts``
    has one overflow slot past ``bounds``). Linear interpolation inside
    the winning bucket; the overflow bucket clamps to the last bound
    (nothing sane can be interpolated past +Inf)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):
                return float(bounds[-1]) if bounds else 0.0
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
    return float(bounds[-1]) if bounds else 0.0


class TimelineSampler:
    """Fixed-cadence registry sampler with a bounded ring of samples."""

    def __init__(self, interval_ms: float = 1000.0, capacity: int = 300,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=None):
        self.interval_s = max(0.001, float(interval_ms) / 1e3)
        self.registry = registry or obs_metrics.REGISTRY
        self.clock = clock or WallClock()
        self._lock = locktrace.tracked_lock("obs.timeline")
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._observers: List[Callable[[dict], None]] = []
        self._prev: Optional[dict] = None  # {"t", "counters", "histograms"}
        self._last_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring ------------------------------------------------------------

    def add_probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Register (or replace) a named live-subsystem read. Probes run
        inside sample(); one raising probe degrades to an error entry
        rather than killing the cadence."""
        with self._lock:
            self._probes[name] = fn

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """Called with each new sample (the flight recorder's trigger
        evaluation hook)."""
        with self._lock:
            self._observers.append(fn)

    # -- sampling ----------------------------------------------------------

    def sample(self) -> dict:
        """Take one sample now: diff the registry against the previous
        snapshot, run every probe, append to the ring, notify observers."""
        now = self.clock.now()
        snap = self.registry.snapshot()
        with self._lock:
            prev = self._prev
            dt = (now - prev["t"]) if prev is not None else 0.0
            rates: Dict[str, float] = {}
            if prev is not None and dt > 0:
                for series, v in snap["counters"].items():
                    delta = v - prev["counters"].get(series, 0.0)
                    rates[series] = delta / dt
            quantiles: Dict[str, dict] = {}
            for series, h in snap["histograms"].items():
                prev_h = (prev or {}).get("histograms", {}).get(series)
                if prev_h is not None and prev_h["bounds"] == h["bounds"]:
                    delta_counts = [c - p for c, p in
                                    zip(h["counts"], prev_h["counts"])]
                else:
                    delta_counts = list(h["counts"])
                n = sum(delta_counts)
                if n <= 0:
                    continue
                quantiles[series] = {
                    "count": n,
                    "p50": estimate_quantile(h["bounds"], delta_counts, 0.5),
                    "p99": estimate_quantile(h["bounds"], delta_counts, 0.99),
                }
            probes = dict(self._probes)
            observers = list(self._observers)
            self._prev = {"t": now, "counters": snap["counters"],
                          "histograms": snap["histograms"]}
            self._last_t = now
        probe_out: Dict[str, Any] = {}
        for name, fn in probes.items():
            try:
                probe_out[name] = fn()
            except Exception as e:  # one sick probe must not stop sampling
                probe_out[name] = {"error": str(e)}
        samp = {"t": now, "rates": rates, "gauges": snap["gauges"],
                "quantiles": quantiles, "probes": probe_out}
        with self._lock:
            self._ring.append(samp)
        self.registry.count(obs_metrics.METRIC_TIMELINE_SAMPLES)
        for fn in observers:
            try:
                fn(samp)
            except Exception:
                pass
        return samp

    def maybe_sample(self) -> Optional[dict]:
        """Piggyback cadence: sample only if a full interval elapsed since
        the last one (the zero-thread mode request accounting calls into)."""
        now = self.clock.now()
        with self._lock:
            due = self._last_t is None or (now - self._last_t
                                           >= self.interval_s)
        return self.sample() if due else None

    # -- reads -------------------------------------------------------------

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def window(self, seconds: Optional[float] = None) -> List[dict]:
        """Samples from the trailing ``seconds`` (all retained if None)."""
        with self._lock:
            samples = list(self._ring)
        if seconds is None or not samples:
            return samples
        cutoff = self.clock.now() - max(0.0, float(seconds))
        return [s for s in samples if s["t"] >= cutoff]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- background thread (production mode) -------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name="timeline-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None

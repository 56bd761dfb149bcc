"""Autoscaler: elastic Computer-pool sizing from serving-pressure probes.

The DAX promise is that compute is disposable — so the pool SIZE should
follow load, not a config constant. The autoscaler reads the same
timeline probes the health plane publishes (queryer queue depth, leg
p99, device residency pressure) and decides up/down/hold each tick:

- scale UP when the serving path is saturated (scheduler queue deep or
  leg p99 past the target) — one node per decision, never a burst;
- scale DOWN only after ``settle_ticks`` consecutive cold ticks (a
  single idle sample must not shed capacity a burst will want back);
- every decision starts a cooldown during which the autoscaler holds,
  letting rebalance + warm handoff finish before the next read (the
  freshly directed node's replay latency would otherwise read as
  pressure and trigger a second, spurious scale-up).

Pure decision logic with injectable clock: ``tick()`` computes, the
caller (harness / operator loop) performs the actual spawn/retire via
the ``scale_up`` / ``scale_down`` callbacks, which return the new pool
size (so bounds stay enforced even if a callback declines to act).

Port of ``pilosa_tpu/dax/autoscale.py``: the same decisions on the same
probes and clock.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.sched.clock import MonotonicClock


class Autoscaler:
    def __init__(self, *, probes_fn: Callable[[], dict],
                 scale_up: Callable[[], int],
                 scale_down: Callable[[], int],
                 pool_size: Callable[[], int],
                 min_nodes: int = 1, max_nodes: int = 8,
                 cooldown_s: float = 30.0,
                 queue_high: int = 16, p99_high_ms: float = 250.0,
                 settle_ticks: int = 3,
                 clock=None, registry=None):
        self.probes_fn = probes_fn
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.pool_size = pool_size
        self.min_nodes = max(1, int(min_nodes))
        self.max_nodes = max(self.min_nodes, int(max_nodes))
        self.cooldown_s = float(cooldown_s)
        self.queue_high = int(queue_high)
        self.p99_high_ms = float(p99_high_ms)
        self.settle_ticks = max(1, int(settle_ticks))
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self._last_event_at: Optional[float] = None
        self._cold_streak = 0
        self._events: deque = deque(maxlen=64)

    def _hot(self, probes: dict) -> bool:
        depth = float(probes.get("queue_depth", 0) or 0)
        p99 = float(probes.get("leg_p99_ms", 0.0) or 0.0)
        return depth >= self.queue_high or p99 >= self.p99_high_ms

    def tick(self) -> Optional[str]:
        """One decision: returns "up", "down", or None (hold)."""
        now = self.clock.now()
        if self._last_event_at is not None \
                and now - self._last_event_at < self.cooldown_s:
            return None
        probes = self.probes_fn()
        size = self.pool_size()
        if self._hot(probes):
            self._cold_streak = 0
            if size < self.max_nodes:
                return self._fire("up", now, probes)
            return None
        self._cold_streak += 1
        if self._cold_streak >= self.settle_ticks \
                and size > self.min_nodes:
            return self._fire("down", now, probes)
        return None

    def _fire(self, direction: str, now: float, probes: dict) -> str:
        new_size = (self.scale_up if direction == "up"
                    else self.scale_down)()
        self._last_event_at = now
        self._cold_streak = 0
        self._events.append({"at": now, "direction": direction,
                             "pool": new_size,
                             "queue_depth": probes.get("queue_depth"),
                             "leg_p99_ms": probes.get("leg_p99_ms")})
        self.registry.count(obs_metrics.METRIC_DAX_AUTOSCALE_EVENTS,
                            direction=direction)
        return direction

    def events(self) -> List[dict]:
        return list(self._events)

    def probe(self) -> dict:
        return {
            "pool": self.pool_size(),
            "cold_streak": self._cold_streak,
            "events": len(self._events),
            "last_direction": (self._events[-1]["direction"]
                               if self._events else None),
        }

"""Chaos + membership-churn schedules for soak runs.

A ChaosSchedule is a sorted list of (offset_s, action) events over an
existing ``FaultPlan`` (drops / delays / partitions on the op scopes
the cluster client already routes through) and a ``LocalCluster``
(pause/unpause membership churn). The driver calls ``step(elapsed)``
from its dispatch loop — real-time or ManualClock — and every event
whose offset has passed fires exactly once, in order. Nothing here is
random at fire time: the schedule is fixed up front, and whatever
probabilistic behavior the FaultPlan rules have is governed by the
FaultPlan's own seed, so a (schedule, fault-seed) pair replays.

Port of ``pilosa_tpu/loadgen/chaos.py``; the same seed gives the same
schedule, mix and tenant picks in both packages.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


class ChaosSchedule:
    """Deterministic timed fault + churn script.

    Convenience methods mirror the FaultPlan/LocalCluster surfaces and
    are chainable::

        chaos = (ChaosSchedule(plan=plan, cluster=cluster)
                 .delay(2.0, "node1", 0.005, prob=0.3, op="query")
                 .partition(5.0, ["node0"], ["node2"], op="gossip")
                 .pause(8.0, 2)
                 .unpause(12.0, 2)
                 .heal(15.0))
    """

    def __init__(self, plan=None, cluster=None):
        self.plan = plan
        self.cluster = cluster
        self._events: List[Tuple[float, str, Callable[[], None]]] = []
        self._fired: List[str] = []
        self._next = 0

    # -- schedule building -------------------------------------------------

    def at(self, at_s: float, fn: Callable[[], None],
           label: str = "") -> "ChaosSchedule":
        """Arbitrary event at ``at_s`` seconds from run start."""
        self._events.append((float(at_s), label or fn.__name__, fn))
        self._events.sort(key=lambda e: e[0])
        return self

    def _need_plan(self):
        if self.plan is None:
            raise ValueError("ChaosSchedule needs a FaultPlan for "
                             "drop/delay/partition/heal events")
        return self.plan

    def _need_cluster(self):
        if self.cluster is None:
            raise ValueError("ChaosSchedule needs a LocalCluster for "
                             "pause/unpause events")
        return self.cluster

    def drop(self, at_s: float, node: str, **kw) -> "ChaosSchedule":
        plan = self._need_plan()
        return self.at(at_s, lambda: plan.drop(node, **kw),
                       f"drop:{node}")

    def delay(self, at_s: float, node: str, seconds: float,
              **kw) -> "ChaosSchedule":
        plan = self._need_plan()
        return self.at(at_s, lambda: plan.delay(node, seconds, **kw),
                       f"delay:{node}")

    def partition(self, at_s: float, nodes_a, nodes_b,
                  **kw) -> "ChaosSchedule":
        plan = self._need_plan()
        return self.at(
            at_s, lambda: plan.partition(nodes_a, nodes_b, **kw),
            f"partition:{','.join(nodes_a)}|{','.join(nodes_b)}")

    def heal(self, at_s: float) -> "ChaosSchedule":
        plan = self._need_plan()
        return self.at(at_s, plan.heal, "heal")

    def clear(self, at_s: float,
              node_id: Optional[str] = None) -> "ChaosSchedule":
        plan = self._need_plan()
        return self.at(at_s, lambda: plan.clear(node_id), "clear")

    def pause(self, at_s: float, i: int) -> "ChaosSchedule":
        cluster = self._need_cluster()
        return self.at(at_s, lambda: cluster.pause(i), f"pause:{i}")

    def unpause(self, at_s: float, i: int) -> "ChaosSchedule":
        cluster = self._need_cluster()
        return self.at(at_s, lambda: cluster.unpause(i), f"unpause:{i}")

    # -- execution ---------------------------------------------------------

    def step(self, elapsed_s: float) -> List[str]:
        """Fire every not-yet-fired event with offset <= ``elapsed_s``,
        in schedule order; returns the labels fired this step. An event
        callback that raises still counts as fired (chaos must never
        kill the driver loop) and its label is recorded with a ``!``
        suffix."""
        fired_now: List[str] = []
        while self._next < len(self._events) \
                and self._events[self._next][0] <= elapsed_s:
            _, label, fn = self._events[self._next]
            self._next += 1
            try:
                fn()
            except Exception:
                label += "!"
            self._fired.append(label)
            fired_now.append(label)
        return fired_now

    def fired(self) -> List[str]:
        return list(self._fired)

    def pending(self) -> int:
        return len(self._events) - self._next

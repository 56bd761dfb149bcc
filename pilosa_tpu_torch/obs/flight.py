"""Flight recorder: anomaly-triggered diagnostic bundles.

Port of ``pilosa_tpu/obs/flight.py``, unchanged in behaviour. The
``breaker_open``, ``membership_flap`` and ``directive_churn`` triggers
read probes that only the cluster and serverless planes register (not
ported yet); they fire from any sample that carries those probes.

The whole point of the health plane is answering "what was happening in
the 30 seconds BEFORE it went wrong" without anyone having been
watching. The recorder watches each timeline sample for anomaly
signatures and, when one fires, freezes a diagnostic bundle into a
bounded ring (optionally dumped to disk for postmortems):

triggers
- ``slo_fast_burn``    an SLO's fast-window burn rate crossed the alert
                       threshold (obs/slo.py)
- ``breaker_open``     a circuit breaker is open in the breaker probe
- ``eviction_storm``   device-resident stacks evicting faster than the
                       configured rate (HBM thrash)
- ``wal_stall``        a WAL has held unflushed records longer than the
                       stall threshold (a stuck group commit)
- ``slow_query_burst`` slow-query log rate above threshold
- ``ingest_stall``     the streaming ingest pipeline is saturated or its
                       consumer has been paused past the stall threshold
                       (device stages not keeping up — stream/pipeline.py)
- ``membership_flap`` membership status transitions inside the flap
                      window crossed the threshold (a link or node
                      oscillating alive<->suspect — gossip/membership.py)
- ``lock_violation``  the lock tracer's violation count grew: a
                      lock-order cycle or a lock held across device
                      dispatch / blocking I/O (analysis/locktrace.py;
                      only fires under PILOSA_TPU_LOCKCHECK=1)
- ``directive_churn`` the DAX control plane bumped the directive
                      version past the threshold inside the probe
                      window — assignment thrash from a flapping
                      computer or a rebalance loop (dax/controller.py)

bundle contents: the trailing timeline window, SLO status, slow traces
from the trace store (IDs resolve at /internal/traces/{id}), the
triggering sample's probe snapshot (scheduler queue, residency, gossip
digest, breaker states), and the recent event ring (e.g. breaker
transitions recorded by the cluster listener).

Per-trigger cooldowns stop a sustained anomaly from flooding the ring.
Read through ``bundles()`` / ``get(id)`` (the /internal/debug/bundles
routes wait for the port's server slice). Clock injectable; the
breaker listener only appends to the event ring (never captures
synchronously — CircuitBreaker now fires listeners outside its lock,
but a synchronous capture would still read breaker state back from
inside the transition path).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from . import metrics as obs_metrics
from .timeline import WallClock

from pilosa_tpu_torch.analysis import locktrace


class FlightRecorder:
    """Bounded ring of anomaly-stamped diagnostic bundles."""

    def __init__(self, capacity: int = 16, cooldown_s: float = 30.0,
                 bundle_window_s: float = 60.0,
                 eviction_rate: float = 10.0,
                 wal_stall_s: float = 5.0,
                 ingest_stall_s: float = 5.0,
                 slow_burst_per_s: float = 5.0,
                 flap_transitions: float = 6.0,
                 directive_churn_bumps: float = 8.0,
                 dump_dir: str = "",
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=None):
        self.cooldown_s = float(cooldown_s)
        self.bundle_window_s = float(bundle_window_s)
        self.eviction_rate = float(eviction_rate)
        self.wal_stall_s = float(wal_stall_s)
        self.ingest_stall_s = float(ingest_stall_s)
        self.slow_burst_per_s = float(slow_burst_per_s)
        self.flap_transitions = float(flap_transitions)
        self.directive_churn_bumps = float(directive_churn_bumps)
        self.dump_dir = dump_dir or ""
        self.registry = registry or obs_metrics.REGISTRY
        self.clock = clock or WallClock()
        self._lock = locktrace.tracked_lock("obs.flight")
        self._bundles: deque = deque(maxlen=max(1, int(capacity)))
        self._events: deque = deque(maxlen=64)
        self._last_fire: Dict[str, float] = {}
        self._seq = 0
        self._plane = None
        # high-water mark of tracer violations already bundled, so a
        # sustained count only fires when it GROWS (cooldown still caps
        # a fast-growing one)
        self._lock_violations_seen = 0

    def bind(self, plane) -> None:
        """Attach the owning HealthPlane (timeline/slo/trace access for
        captures)."""
        self._plane = plane

    # -- events ------------------------------------------------------------

    def record_event(self, kind: str, **info) -> None:
        """Append to the recent-events ring (cheap, lock-safe from any
        callback — e.g. the breaker-transition listener)."""
        ev = {"t": self.clock.now(), "kind": kind}
        ev.update(info)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # -- trigger evaluation ------------------------------------------------

    def observe(self, sample: dict) -> List[dict]:
        """Evaluate every trigger against one timeline sample; capture a
        bundle per fired trigger (cooldown permitting)."""
        plane = self._plane
        fired = []
        probes = sample.get("probes", {})
        rates = sample.get("rates", {})

        if plane is not None and plane.slo is not None:
            alerting = plane.slo.alerting(sample.get("t"))
            if alerting:
                names = ",".join(r["name"] for r in alerting)
                burns = max(r["fast_burn"] for r in alerting)
                b = self.trigger(
                    "slo_fast_burn",
                    f"fast burn {burns:.1f}x budget on {names}",
                    sample)
                if b:
                    fired.append(b)
            # per-tenant budget burn: names the burning tenant so the
            # bundle answers "who" as well as "what" (returns [] with
            # zero bucket work when no tenant-tagged event exists)
            t_alert = plane.slo.tenant_alerting(sample.get("t"))
            if t_alert:
                who = ",".join(sorted({r["tenant"] for r in t_alert}))
                burns = max(r["fast_burn"] for r in t_alert)
                b = self.trigger(
                    "tenant_burn",
                    f"tenant {who} fast burn {burns:.1f}x budget",
                    sample)
                if b:
                    fired.append(b)

        breakers = probes.get("breakers")
        if isinstance(breakers, dict):
            states = breakers.get("states") or {}
            opened = sorted(n for n, s in states.items() if s == "open")
            if opened:
                b = self.trigger(
                    "breaker_open",
                    f"breaker open for {','.join(opened)}", sample)
                if b:
                    fired.append(b)

        ev_rate = rates.get(
            obs_metrics.METRIC_DEVICE_STACK_EVICTIONS, 0.0)
        if ev_rate >= self.eviction_rate:
            b = self.trigger(
                "eviction_storm",
                f"device stack evictions at {ev_rate:.1f}/s", sample)
            if b:
                fired.append(b)

        wal = probes.get("wal")
        if isinstance(wal, dict):
            lag = wal.get("flush_lag_s", 0.0) or 0.0
            if lag >= self.wal_stall_s:
                b = self.trigger(
                    "wal_stall",
                    f"WAL unflushed for {lag:.1f}s", sample)
                if b:
                    fired.append(b)

        stream = probes.get("stream")
        if isinstance(stream, dict) and stream.get("enabled"):
            paused = stream.get("paused_s", 0.0) or 0.0
            if stream.get("saturated") or paused >= self.ingest_stall_s:
                why = ("backlog saturated" if stream.get("saturated")
                       else f"consumer paused {paused:.1f}s")
                b = self.trigger(
                    "ingest_stall",
                    f"streaming ingest stalled: {why}", sample)
                if b:
                    fired.append(b)

        locks = probes.get("locks")
        if isinstance(locks, dict) and locks.get("enabled"):
            seen = locks.get("violations", 0) or 0
            if seen > self._lock_violations_seen:
                self._lock_violations_seen = seen
                b = self.trigger(
                    "lock_violation",
                    f"{seen} lock-discipline violations "
                    f"({locks.get('cycles', 0)} cycles)", sample)
                if b:
                    fired.append(b)

        mem = probes.get("membership")
        if isinstance(mem, dict):
            flaps = mem.get("recent_transitions", 0) or 0
            if flaps >= self.flap_transitions:
                b = self.trigger(
                    "membership_flap",
                    f"{flaps} membership transitions in window", sample)
                if b:
                    fired.append(b)

        dax = probes.get("dax")
        if isinstance(dax, dict):
            bumps = dax.get("recent_directive_bumps", 0) or 0
            if bumps >= self.directive_churn_bumps:
                # a control plane rewriting the assignment this fast is
                # thrashing (flapping node, rebalance loop) — capture
                # before the churn's cause ages out of the ring
                b = self.trigger(
                    "directive_churn",
                    f"{bumps} directive bumps in window", sample)
                if b:
                    fired.append(b)

        # slow-query counter carries a kind= label; sum the series
        slow_rate = sum(
            v for series, v in rates.items()
            if series.startswith(obs_metrics.METRIC_TRACE_SLOW_QUERIES))
        if slow_rate >= self.slow_burst_per_s:
            b = self.trigger(
                "slow_query_burst",
                f"slow queries at {slow_rate:.1f}/s", sample)
            if b:
                fired.append(b)
        return fired

    def trigger(self, name: str, reason: str,
                sample: Optional[dict] = None) -> Optional[dict]:
        """Fire one named trigger (cooldown-gated) and capture a bundle."""
        now = self.clock.now()
        with self._lock:
            last = self._last_fire.get(name)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_fire[name] = now
            self._seq += 1
            bundle_id = f"fb-{self._seq:04d}"
        bundle = self._capture(bundle_id, now, name, reason, sample)
        with self._lock:
            self._bundles.append(bundle)
        self.registry.count(obs_metrics.METRIC_FLIGHT_BUNDLES,
                            trigger=name)
        self._maybe_dump(bundle)
        return bundle

    # -- capture -----------------------------------------------------------

    def _capture(self, bundle_id: str, now: float, name: str,
                 reason: str, sample: Optional[dict]) -> dict:
        plane = self._plane
        bundle = {
            "id": bundle_id, "t": now, "trigger": name, "reason": reason,
            "events": self.events(),
        }
        if sample is not None:
            bundle["sample"] = sample
        if plane is not None:
            try:
                bundle["timeline"] = plane.timeline.window(
                    self.bundle_window_s)
            except Exception as e:
                bundle["timeline"] = {"error": str(e)}
            try:
                bundle["slo"] = plane.slo.status(now)
            except Exception as e:
                bundle["slo"] = {"error": str(e)}
            try:
                bundle["slow_traces"] = plane.slow_traces()
            except Exception as e:
                bundle["slow_traces"] = [{"error": str(e)}]
        return bundle

    def _maybe_dump(self, bundle: dict) -> None:
        if not self.dump_dir:
            return
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir, f"{bundle['id']}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
        except OSError:
            pass  # postmortem dump is best-effort; the ring still has it

    # -- reads -------------------------------------------------------------

    def bundles(self) -> List[dict]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._bundles))

    def get(self, bundle_id: str) -> dict:
        with self._lock:
            for b in self._bundles:
                if b["id"] == bundle_id:
                    return b
        raise KeyError(bundle_id)

    def summaries(self) -> List[dict]:
        return [{"id": b["id"], "t": b["t"], "trigger": b["trigger"],
                 "reason": b["reason"]} for b in self.bundles()]

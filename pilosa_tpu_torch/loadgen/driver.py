"""Open-loop, coordinated-omission-free load driver.

The schedule is generated up front from a seed: op ``i`` has a fixed
**intended** send time, a scenario kind, and a tenant. In real-time
mode a dispatcher thread fires each op at its intended time into a
bounded worker pool *whether or not earlier ops finished* — if the
system (or the pool) is backed up, the op starts late and its latency,
measured from the intended send time, honestly includes that queueing
delay. A closed-loop generator would instead slow down and silently
drop the delayed sends from the distribution (coordinated omission).

``run_virtual`` is the deterministic-CI twin: under a shared
``ManualClock`` the ops execute sequentially, advancing the clock to
each intended tick, so a fault seed + schedule seed replays the exact
same interleaving of load, chaos, and control-plane sampling every
run. Virtual mode proves *behavior* (the degradation ladder engages,
caps hold); it does not measure wall latency.

Port of ``pilosa_tpu/loadgen/driver.py``; the same seed gives the same
schedule, mix and tenant picks in both packages.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from pilosa_tpu_torch.errors import AdmissionError
from pilosa_tpu_torch.loadgen.scenarios import ScenarioMix
from pilosa_tpu_torch.loadgen.tenants import SyntheticTenants


@dataclasses.dataclass
class Op:
    """One scheduled virtual-user operation."""
    op_id: int
    kind: str
    tenant: str
    intended_t: float  # offset from run start, seconds


@dataclasses.dataclass
class _Done:
    op: Op
    outcome: str  # "ok" | "shed" | "error"
    stale: bool
    latency_s: float  # completion - INTENDED send (open-loop honest)


class LoadReport:
    """Aggregated soak results; latencies are from intended send."""

    def __init__(self, duration_s: float):
        self.duration_s = duration_s
        self._done: List[_Done] = []
        self._lock = threading.Lock()

    def add(self, d: _Done) -> None:
        with self._lock:
            self._done.append(d)

    # -- reads (post-run; no locking needed once workers joined) -------

    def count(self, outcome: Optional[str] = None,
              kind: Optional[str] = None) -> int:
        return sum(1 for d in self._done
                   if (outcome is None or d.outcome == outcome)
                   and (kind is None or d.op.kind == kind))

    @property
    def total(self) -> int:
        return len(self._done)

    @property
    def ok(self) -> int:
        return self.count("ok")

    @property
    def shed(self) -> int:
        return self.count("shed")

    @property
    def errors(self) -> int:
        return self.count("error")

    @property
    def stale(self) -> int:
        return sum(1 for d in self._done if d.stale)

    def latency_quantile(self, q: float,
                         kind: Optional[str] = None) -> float:
        """Seconds-from-intended-send quantile over completed ("ok")
        ops; sheds/errors are excluded (they have their own counters)."""
        lat = sorted(d.latency_s for d in self._done
                     if d.outcome == "ok"
                     and (kind is None or d.op.kind == kind))
        if not lat:
            return 0.0
        idx = min(len(lat) - 1, int(q * len(lat)))
        return lat[idx]

    def goodput_per_s(self, bucket_s: float = 1.0) -> List[float]:
        """Completed-ok ops per second, bucketed by INTENDED send time
        (so a stall shows as a good-put hole at the moment users were
        actually sending, not smeared to when responses drained)."""
        if bucket_s <= 0:
            raise ValueError("bucket_s must be > 0")
        n = max(1, int(self.duration_s / bucket_s + 0.999))
        buckets = [0] * n
        for d in self._done:
            if d.outcome == "ok":
                i = min(n - 1, int(d.op.intended_t / bucket_s))
                buckets[i] += 1
        return [b / bucket_s for b in buckets]

    def summary(self) -> Dict[str, Any]:
        return {
            "total": self.total, "ok": self.ok, "shed": self.shed,
            "errors": self.errors, "stale": self.stale,
            "p50_ms": round(self.latency_quantile(0.50) * 1e3, 3),
            "p99_ms": round(self.latency_quantile(0.99) * 1e3, 3),
        }


class OpenLoopDriver:
    """Fixed-schedule virtual users against a caller-supplied executor.

    ``execute(op) -> outcome`` performs one operation and returns one
    of: None/"ok", "shed", "error", or a dict
    ``{"outcome": ..., "stale": bool}``. Raised ``AdmissionError`` (and
    subclasses — tenant quota sheds) count as "shed"; any other
    exception counts as "error". The driver never retries: an op is
    one intended send, and its fate is recorded exactly once.
    """

    def __init__(self, execute: Callable[[Op], Any], *,
                 rate_per_s: float, duration_s: float,
                 mix: Optional[ScenarioMix] = None,
                 tenants: Optional[SyntheticTenants] = None,
                 seed: int = 0, arrivals: str = "uniform",
                 max_workers: int = 32, chaos=None):
        if rate_per_s <= 0 or duration_s <= 0:
            raise ValueError("rate_per_s and duration_s must be > 0")
        if arrivals not in ("uniform", "poisson"):
            raise ValueError(f"unknown arrival process: {arrivals!r}")
        self.execute = execute
        self.rate_per_s = float(rate_per_s)
        self.duration_s = float(duration_s)
        self.mix = mix if mix is not None else ScenarioMix()
        self.tenants = (tenants if tenants is not None
                        else SyntheticTenants(10_000, seed=seed))
        self.seed = int(seed)
        self.arrivals = arrivals
        self.max_workers = max(1, int(max_workers))
        self.chaos = chaos
        self.schedule: List[Op] = self._build_schedule()

    def _build_schedule(self) -> List[Op]:
        rng = random.Random(self.seed)
        ops: List[Op] = []
        t = 0.0
        i = 0
        mean_gap = 1.0 / self.rate_per_s
        while True:
            if self.arrivals == "uniform":
                t = i * mean_gap
            else:
                t += rng.expovariate(self.rate_per_s)
            if t >= self.duration_s:
                break
            ops.append(Op(op_id=i, kind=self.mix.pick(rng),
                          tenant=self.tenants.pick(rng), intended_t=t))
            i += 1
        return ops

    # -- execution ---------------------------------------------------------

    def _classify(self, op: Op, raw: Any) -> _Done:
        stale = False
        if isinstance(raw, dict):
            stale = bool(raw.get("stale"))
            outcome = str(raw.get("outcome", "ok"))
        elif raw is None:
            outcome = "ok"
        else:
            outcome = str(raw)
        if outcome not in ("ok", "shed", "error"):
            outcome = "ok"
        return _Done(op, outcome, stale, 0.0)

    def _run_one(self, op: Op, intended_abs: float,
                 report: LoadReport) -> None:
        try:
            raw = self.execute(op)
            done = self._classify(op, raw)
        except AdmissionError:
            done = _Done(op, "shed", False, 0.0)
        except Exception:
            done = _Done(op, "error", False, 0.0)
        done.latency_s = max(0.0, time.monotonic() - intended_abs)
        report.add(done)

    def run(self) -> LoadReport:
        """Real-time open loop: fire every op at its intended wall
        time; a late dispatcher (or saturated pool) shows up as
        latency, never as a dropped measurement."""
        report = LoadReport(self.duration_s)
        start = time.monotonic()
        with ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="loadgen") as pool:
            for op in self.schedule:
                intended_abs = start + op.intended_t
                delay = intended_abs - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if self.chaos is not None:
                    self.chaos.step(time.monotonic() - start)
                pool.submit(self._run_one, op, intended_abs, report)
        if self.chaos is not None:
            self.chaos.step(self.duration_s)
        return report

    def run_virtual(self, clock) -> LoadReport:
        """Deterministic twin: ops execute sequentially under a shared
        ``ManualClock``, advancing it to each intended tick (plus one
        final tick to duration_s). Behavior — admissions, ladder
        transitions, chaos windows — replays exactly per seed; the
        recorded latencies are clock deltas (usually 0) and are NOT a
        latency measurement."""
        report = LoadReport(self.duration_s)
        start = clock.now()
        for op in self.schedule:
            target = start + op.intended_t
            gap = target - clock.now()
            if gap > 0:
                clock.advance(gap)
            if self.chaos is not None:
                self.chaos.step(clock.now() - start)
            try:
                raw = self.execute(op)
                done = self._classify(op, raw)
            except AdmissionError:
                done = _Done(op, "shed", False, 0.0)
            except Exception:
                done = _Done(op, "error", False, 0.0)
            done.latency_s = max(0.0, clock.now() - target)
            report.add(done)
        tail = (start + self.duration_s) - clock.now()
        if tail > 0:
            clock.advance(tail)
        if self.chaos is not None:
            self.chaos.step(clock.now() - start)
        return report

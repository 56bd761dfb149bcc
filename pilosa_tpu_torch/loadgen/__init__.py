"""Load generation: the Star Schema Benchmark's data, queries and oracle
(:mod:`.ssb`), and the open-loop standing-load soak harness.

Port of ``pilosa_tpu/loadgen``. Closed-loop load generators (fire,
wait, fire again) lie under overload: when the system slows down the
generator slows with it, so the measured latency distribution silently
drops every request the generator *would* have sent — coordinated
omission. The open-loop harness fires virtual users on a fixed schedule
regardless of completion, and measures every operation's latency from
its **intended** send time, so queueing delay shows up as latency
instead of vanishing.

Layout:
    ssb.py        the Star Schema Benchmark's data, queries and oracle
    driver.py     OpenLoopDriver — schedule generation, real-time and
                  ManualClock (deterministic) execution, LoadReport
    scenarios.py  ScenarioMix — weighted scenario kinds (interactive
                  PQL, SQL SELECT, stream push, bulk import, quota
                  churn) picked per-op from a seeded RNG
    tenants.py    SyntheticTenants — 10^4..10^6 seeded tenant IDs with
                  a skewed (Zipf-ish) pick distribution
    chaos.py      ChaosSchedule — FaultPlan chaos + membership churn
                  events applied at schedule offsets

The driver is agnostic about *how* an operation executes: the caller
supplies ``execute(op) -> outcome`` (HTTP against a LocalCluster,
in-process API calls, ...).
"""

from pilosa_tpu_torch.loadgen import ssb
from pilosa_tpu_torch.loadgen.chaos import ChaosSchedule
from pilosa_tpu_torch.loadgen.driver import LoadReport, OpenLoopDriver, Op
from pilosa_tpu_torch.loadgen.scenarios import (
    KIND_BULK_IMPORT, KIND_INTERACTIVE, KIND_QUOTA_CHURN, KIND_SQL,
    KIND_STREAM_PUSH, ScenarioMix,
)
from pilosa_tpu_torch.loadgen.tenants import SyntheticTenants

__all__ = [
    "ChaosSchedule", "KIND_BULK_IMPORT", "KIND_INTERACTIVE",
    "KIND_QUOTA_CHURN", "KIND_SQL", "KIND_STREAM_PUSH", "LoadReport",
    "Op", "OpenLoopDriver", "ScenarioMix", "SyntheticTenants", "ssb",
]

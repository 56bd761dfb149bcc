"""Query admission & micro-batching scheduler.

Port of ``pilosa_tpu/sched/``. Every query pays a fixed host and launch
cost per dispatch that dwarfs the bitmap math of a small query. This
package amortizes it across *concurrent queries*: reads queue in a
bounded admission queue, a worker groups arrivals by compatible shape
(same index / shard set / op family) within a short window, and each
group executes as ONE fused executor dispatch (``execute_many``: every
launch enqueued, then one wait on the card) whose results scatter back
to the waiting callers (the continuous-batching insight of
arXiv:2112.09017, applied to bulk-bitwise analytics, arXiv:2302.01675).

Layout:
    scheduler.py  admission queue, priorities, deadlines, worker loop
    batch.py      shape keys + fused batch execution / result scatter
    clock.py      injectable time sources (deterministic tests)
    deadline.py   the per-query deadline scope
    window.py     the adaptive batching window
    degrade.py    graceful-degradation (brownout) ladder
"""

from pilosa_tpu_torch.sched.batch import GroupKey, execute_batch, group_key
from pilosa_tpu_torch.sched.clock import ManualClock, MonotonicClock
from pilosa_tpu_torch.sched.deadline import (
    Deadline, current_deadline, deadline_scope, remaining_budget_s,
)
from pilosa_tpu_torch.sched.degrade import (
    BROWNOUT, NORMAL, SATURATED, SHED_BATCH, DegradeController,
)
from pilosa_tpu_torch.sched.scheduler import (
    PRIORITY_BATCH, PRIORITY_INTERACTIVE, QueryScheduler, ScheduledQuery,
    SchedulingExecutor,
)

__all__ = [
    "BROWNOUT", "Deadline", "DegradeController", "GroupKey",
    "ManualClock", "MonotonicClock", "NORMAL", "PRIORITY_BATCH",
    "PRIORITY_INTERACTIVE", "QueryScheduler", "SATURATED",
    "ScheduledQuery", "SchedulingExecutor", "SHED_BATCH",
    "current_deadline", "deadline_scope", "execute_batch", "group_key",
    "remaining_budget_s",
]

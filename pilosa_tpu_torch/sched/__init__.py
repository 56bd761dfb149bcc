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

The degradation ladder (``sched/degrade.py``), with the scheduler's
hooks into it (deadline tightening and shedding at admission) and the
public ``retry_after_s`` read that it and stream backpressure take,
waits for the distributed-planes slice.
"""

from pilosa_tpu_torch.sched.batch import GroupKey, execute_batch, group_key
from pilosa_tpu_torch.sched.clock import ManualClock, MonotonicClock
from pilosa_tpu_torch.sched.deadline import (
    Deadline, current_deadline, deadline_scope, remaining_budget_s,
)
from pilosa_tpu_torch.sched.scheduler import (
    PRIORITY_BATCH, PRIORITY_INTERACTIVE, QueryScheduler, ScheduledQuery,
    SchedulingExecutor,
)

__all__ = [
    "Deadline", "GroupKey", "ManualClock", "MonotonicClock",
    "PRIORITY_BATCH", "PRIORITY_INTERACTIVE", "QueryScheduler",
    "ScheduledQuery", "SchedulingExecutor", "current_deadline",
    "deadline_scope", "execute_batch", "group_key", "remaining_budget_s",
]

"""Query-history ring: every PQL/SQL request, newest first.

Reference: tracker.go:191 + systemlayer/systemlayer.go — an in-memory
ring of ExecutionRequests served at /query-history (http_handler.go:540)
and as the ``fb_exec_requests`` SQL system table.

Port of ``pilosa_tpu/obs/history.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import random
import uuid
from typing import Deque, List, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs.metrics import EpochClock

# request ids are random version-4 UUIDs, as uuid4() gives, drawn from a
# generator seeded from the OS at import and again in a forked child:
# uuid4() reads os.urandom on every request
_IDS = random.Random(os.urandom(16))


def _reseed_ids() -> None:
    _IDS.seed(os.urandom(16))


os.register_at_fork(after_in_child=_reseed_ids)


@dataclasses.dataclass
class ExecutionRecord:
    request_id: str
    index: str
    query: str
    language: str  # "pql" | "sql"
    start_time: float
    runtime_ns: int = 0
    status: str = "running"
    error: str = ""
    trace_id: str = ""  # links /query-history to /internal/traces/{id}

    def to_json(self) -> dict:
        return {
            "requestID": self.request_id,
            "index": self.index,
            "query": self.query,
            "language": self.language,
            "startTime": self.start_time,
            "runtimeNs": self.runtime_ns,
            "status": self.status,
            "error": self.error,
            "traceID": self.trace_id,
        }


class ExecutionRequestsAPI:
    """Fixed-capacity ring (reference: systemlayer.go 100-entry ring)."""

    def __init__(self, capacity: int = 100, clock=None):
        self.capacity = capacity
        self._clock = clock or EpochClock()
        self._lock = locktrace.tracked_lock("obs.history.ring")
        # deque(maxlen) evicts the oldest record in O(1) on append; the
        # old list.pop(0) shifted the whole ring on every eviction
        self._ring: Deque[ExecutionRecord] = collections.deque(
            maxlen=max(1, capacity))

    def begin(self, index: str, query: str, language: str) -> ExecutionRecord:
        rec = ExecutionRecord(
            request_id=str(uuid.UUID(int=_IDS.getrandbits(128),
                                     version=4)),
            index=index, query=query,
            language=language, start_time=self._clock.now())
        with self._lock:
            self._ring.append(rec)
        return rec

    def end(self, rec: ExecutionRecord, error: Optional[str] = None) -> None:
        with self._lock:  # readers copy under the same lock
            rec.runtime_ns = int(
                (self._clock.now() - rec.start_time) * 1e9)
            rec.error = error or ""
            rec.status = "error" if error else "complete"

    def list(self, limit: Optional[int] = None) -> List[ExecutionRecord]:
        """Newest first; ``limit`` caps how many records serialize (the
        ``?n=`` parameter on /query-history)."""
        with self._lock:  # copies: no torn reads of in-flight records
            recs = [dataclasses.replace(r) for r in reversed(self._ring)]
        if limit is not None:
            recs = recs[:max(0, int(limit))]
        return recs

    def get(self, request_id: str) -> Optional[ExecutionRecord]:
        with self._lock:
            for r in self._ring:
                if r.request_id == request_id:
                    return dataclasses.replace(r)
        return None

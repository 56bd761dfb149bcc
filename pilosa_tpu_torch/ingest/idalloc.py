"""Auto-ID allocation: monotonic reservation with sessions and crash-safe
commit.

Port of ``pilosa_tpu/ingest/idalloc.py``, with the same journal format.

Reference: idalloc.go:43 (idAllocator), :127 (reserve), :238 (commit) —
BoltDB-backed there; an append-only journal here (same durability model
as the translate store). Semantics preserved:

- a session reserves a contiguous range [base, base+count)
- re-reserving with the same session+offset returns the SAME range
  (crash retry idempotence, reference: idalloc.go reserve's offset check)
- commit(session, count) finalizes; a later reserve from a new session
  starts after the highest reserved id
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace


class IDRange:
    def __init__(self, base: int, count: int):
        self.base = base
        self.count = count

    @property
    def end(self) -> int:  # exclusive
        return self.base + self.count

    def to_json(self) -> dict:
        return {"base": self.base, "count": self.count}


class IDAllocator:
    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = locktrace.tracked_lock("ingest.idalloc")
        self._next = 1  # id 0 reserved (reference: idalloc starts at 1)
        # session key -> (offset, IDRange): the last reservation per session
        self._sessions: Dict[str, Tuple[int, IDRange]] = {}
        if path and os.path.exists(path):
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self):
        with open(self._path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec["op"] == "reserve":
                    rng = IDRange(rec["base"], rec["count"])
                    self._sessions[rec["session"]] = (rec["offset"], rng)
                    self._next = max(self._next, rng.end)
                elif rec["op"] == "commit":
                    prev = self._sessions.pop(rec["session"], None)
                    used = rec.get("used")
                    if prev is not None and used is not None:
                        _, rng = prev
                        if rng.end == self._next:
                            self._next = rng.base + used

    def _journal(self, rec: dict):
        if not self._path:
            return
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- API (reference: idalloc.go reserve/commit/reset) --------------------

    def reserve(self, session: str, count: int, offset: int = 0) -> IDRange:
        """Reserve ``count`` ids. Replaying the same (session, offset)
        returns the previous range so a crashed client can retry without
        burning ids (reference: idalloc.go:127)."""
        if count <= 0:
            raise ValueError("count must be positive")
        with self._lock:
            prev = self._sessions.get(session)
            if prev is not None and prev[0] == offset:
                return prev[1]
            rng = IDRange(self._next, count)
            self._next = rng.end
            self._sessions[session] = (offset, rng)
            self._journal({"op": "reserve", "session": session,
                           "offset": offset, "base": rng.base,
                           "count": rng.count})
            return rng

    def commit(self, session: str, count: Optional[int] = None) -> None:
        """Finalize a session's reservation; unused tail ids (when count <
        reserved) are returned only if they are still the newest
        (reference: idalloc.go:238 commit)."""
        with self._lock:
            prev = self._sessions.pop(session, None)
            if prev is None:
                return
            _, rng = prev
            used = None
            if count is not None and 0 <= count < rng.count and \
                    rng.end == self._next:
                self._next = rng.base + count
                used = count
            # `used` makes the tail-ID rollback replayable on reload.
            self._journal({"op": "commit", "session": session, "used": used})

    def reset(self, session: str) -> None:
        """Abandon a session without committing."""
        self.commit(session, count=0)

    @property
    def next_id(self) -> int:
        return self._next

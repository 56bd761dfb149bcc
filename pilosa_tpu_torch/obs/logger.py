"""Leveled logger + query logger.

Reference: logger/ (leveled Logger interface with Printf/Debugf levels
and a CaptureLogger for tests) and the query logger wired at
server/server.go:792 (every query appends one structured line: time,
index, query, duration, error). Python's logging module provides the
transport; this module provides the reference-shaped surface plus the
query log itself.

Port of ``pilosa_tpu/obs/logger.py``: the query log's lines have the JAX
package's keys and format; the leveled loggers hang under
``pilosa_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs.metrics import EpochClock

_ROOT = "pilosa_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def configure(level: str = "info", path: Optional[str] = None) -> None:
    """Process-wide logging setup (reference: logger.NewStandardLogger
    wiring in server/server.go). ``path`` appends to a file; default
    stderr."""
    logger = get_logger()
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    handler: logging.Handler
    handler = (logging.FileHandler(path) if path
               else logging.StreamHandler())
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.handlers = [handler]


class CaptureLogger(logging.Handler):
    """Test logger capturing records (reference: logger/logger.go
    CaptureLogger). Use as a context manager around the code under
    test."""

    def __init__(self, name: str = ""):
        super().__init__()
        self._logger = get_logger(name)
        self.lines: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())

    def __enter__(self) -> "CaptureLogger":
        self._logger.addHandler(self)
        self._logger.setLevel(logging.DEBUG)
        return self

    def __exit__(self, *exc) -> None:
        self._logger.removeHandler(self)


class QueryLogger:
    """Append-only structured query log (reference: server/server.go:792
    query logger — one line per query with timing and outcome)."""

    def __init__(self, path: str, clock=None):
        self.path = path
        self._clock = clock or EpochClock()
        self._lock = locktrace.tracked_lock("obs.logger.query_log")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, kind: str, index: str, query: str, duration_s: float,
            error: Optional[str] = None, trace_id: str = "",
            request_id: str = "") -> None:
        rec = {
            "ts": self._clock.now(),
            "kind": kind,  # pql | sql | slow
            "index": index,
            "query": query[:4096],
            "duration_ms": round(duration_s * 1e3, 3),
        }
        if trace_id:
            rec["traceID"] = trace_id
        if request_id:
            rec["requestID"] = request_id
        if error:
            rec["error"] = str(error)[:1024]
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)

    def tail(self, n: int = 100) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            lines = f.readlines()
        return [json.loads(x) for x in lines[-n:] if x.strip()]

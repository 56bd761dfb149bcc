"""Qcx / TxFactory: per-request transaction contexts.

Port of ``pilosa_tpu/storage/txn.py`` (reference: txfactory.go:84 Qcx,
:384 TxFactory). Reads need no transaction: they run against stacks
validated by fragment versions (core/stacked.py). What remains is the
write half. A request with write calls runs as one :class:`Qcx` under
the holder's write lock: its WAL records buffer in each index's log, and
``finish()`` issues ONE write barrier per dirty index, takes the commit
LSN and checkpoints once the logs pass the holder's threshold — the
group commit that makes a multi-call PQL write request durable as a
unit (the analog of StartAtomicWriteTx, txfactory.go:344).

While a Qcx is open, :func:`in_write_qcx` is true on its thread, and
core/stacked.py does not publish the stacks the request builds or
advances: a lock-free reader could otherwise see the request's
intermediate states (``Set(a)Set(b)Count()`` caching a stack after only
``Set(a)``).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

from pilosa_tpu_torch.obs.tracing import get_tracer

if TYPE_CHECKING:
    from pilosa_tpu_torch.core.holder import Holder

_WRITE_CTX = threading.local()


def in_write_qcx() -> bool:
    """True while the calling thread is inside a write request."""
    return getattr(_WRITE_CTX, "depth", 0) > 0


class Qcx:
    """One write request. Use as a context manager:

        with txf.qcx() as qcx:
            ... writes ...
        # exit -> finish() -> WAL flush (fsync per dirty index)
    """

    def __init__(self, holder: "Holder"):
        self.holder = holder
        self._done = False
        # LSN of the last record this commit made durable (set by
        # finish; 0 for path-less holders and requests that logged none)
        self.lsn = 0
        # excludes concurrent writers AND checkpoints for the request: a
        # checkpoint racing a half-applied multi-call write would snapshot
        # and prune records it never persisted. Re-entrant, so nested
        # requests (query -> import helpers) are fine
        self.holder.write_lock.acquire()
        _WRITE_CTX.depth = getattr(_WRITE_CTX, "depth", 0) + 1

    def finish(self) -> int:
        """Group commit. Returns the commit LSN: every WAL record up to
        it is flushed (and fsynced per the sync mode)."""
        if self._done:
            return self.lsn
        self._done = True
        try:
            with get_tracer().start_span("storage.wal.commit"):
                self.holder.flush_wals()
                self.lsn = self.holder.last_lsn()
                self.holder.maybe_checkpoint()
        finally:
            _WRITE_CTX.depth -= 1
            self.holder.write_lock.release()
        return self.lsn

    def __enter__(self) -> "Qcx":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class TxFactory:
    """Reference: txfactory.go:384. Mints write requests for a holder."""

    def __init__(self, holder: "Holder"):
        self.holder = holder

    def qcx(self) -> Qcx:
        return Qcx(self.holder)


def write_qcx(holder: "Holder") -> Qcx:
    """A write request on ``holder`` (a :class:`Qcx`)."""
    return Qcx(holder)

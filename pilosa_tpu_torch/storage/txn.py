"""Write requests: the in-memory half of ``pilosa_tpu/storage/txn.py``.

A PQL query with write calls runs as one request under the holder's
write lock. While it runs, :func:`in_write_qcx` is true on its thread,
and core/stacked.py does not publish the stacks the request builds or
advances: a lock-free reader could otherwise see the request's
intermediate states (``Set(a)Set(b)Count()`` caching a stack after only
``Set(a)``). The WAL and its group commit (``Qcx.finish``) come with the
durability slice.
"""

from __future__ import annotations

import contextlib
import threading

_WRITE_CTX = threading.local()


def in_write_qcx() -> bool:
    """True while the calling thread is inside a write request."""
    return getattr(_WRITE_CTX, "depth", 0) > 0


@contextlib.contextmanager
def write_qcx(holder):
    """Run a write request: the holder's write lock (re-entrant) held and
    the thread's write depth raised for its duration."""
    with holder.write_lock:
        _WRITE_CTX.depth = getattr(_WRITE_CTX, "depth", 0) + 1
        try:
            yield
        finally:
            _WRITE_CTX.depth -= 1

"""Background maintenance: TTL view removal and mutex integrity checks.

Port of ``pilosa_tpu/server/maintenance.py``. A removed view's stacks
leave the card and the ``DeviceBudget`` through
``core.stacked.release_field_cache``.

Reference: server.go:902-920 (viewsRemoval loop deleting time-quantum
views older than field TTL, plus noStandardView cleanup) and
view.go:449 / fragment.go:273 mutexCheck (+ /internal/mutex-check
endpoints, http_handler.go:518,567).
"""

from __future__ import annotations

import datetime as dt
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.core.stacked import release_field_cache

_UNIT_SPAN = {  # covered duration of one view at each granularity
    "Y": 366 * 86400, "M": 31 * 86400, "D": 86400, "H": 3600,
}


def _view_end(name: str) -> Optional[dt.datetime]:
    """End of the time range a view covers, or None for non-time views
    (view name layout: standard_YYYYMMDDHH prefixes, view.go:26-33)."""
    if not name.startswith(timeq.VIEW_STANDARD + "_"):
        return None
    stamp = name[len(timeq.VIEW_STANDARD) + 1:]
    forms = {4: "%Y", 6: "%Y%m", 8: "%Y%m%d", 10: "%Y%m%d%H"}
    fmt = forms.get(len(stamp))
    if fmt is None:
        return None
    try:
        start = dt.datetime.strptime(stamp, fmt)
    except ValueError:
        return None
    unit = {4: "Y", 6: "M", 8: "D", 10: "H"}[len(stamp)]
    return start + dt.timedelta(seconds=_UNIT_SPAN[unit])


def remove_expired_views(holder: Holder, now: Optional[dt.datetime] = None
                         ) -> List[str]:
    """One TTL sweep; returns removed view names (reference:
    server.go:920 ViewsRemoval).

    Holds the holder write lock (the sweep runs on a background thread
    while request threads query the same view dicts), WAL-logs a
    delete_view tombstone per removal so replay doesn't resurrect the
    view, and removes its checkpoint files for the same reason.
    """
    now = now or dt.datetime.utcnow()
    removed: List[str] = []
    with holder.write_lock:
        for idx in holder.indexes.values():
            for field in idx.fields.values():
                if (field.options.type != FieldType.TIME
                        or field.options.ttl_seconds <= 0):
                    continue
                cutoff = now - dt.timedelta(seconds=field.options.ttl_seconds)
                for view in list(field.views):
                    end = _view_end(view)
                    if end is not None and end < cutoff:
                        del field.views[view]
                        release_field_cache(field)
                        if field.wal is not None:
                            field.wal.append(
                                ("delete_view", field.name, view))
                        if field.path:
                            vdir = os.path.join(field.path, "views", view)
                            if os.path.isdir(vdir):
                                shutil.rmtree(vdir)
                        removed.append(f"{idx.name}/{field.name}/{view}")
        if removed:
            holder.flush_wals()
    return removed


def mutex_check(holder: Holder, index: str) -> Dict[str, Dict[int, List[int]]]:
    """Columns violating mutex single-row invariants, per field
    (reference: fragment.go:273 mutexCheck)."""
    out: Dict[str, Dict[int, List[int]]] = {}
    idx = holder.index(index)
    for field in idx.fields.values():
        if field.options.type not in (FieldType.MUTEX, FieldType.BOOL):
            continue
        bad: Dict[int, List[int]] = {}
        for shard in sorted(field.shards()):
            frag = field.fragment(shard)
            if frag is None or not frag.row_ids:
                continue
            n = len(frag.row_ids)
            planes = frag.planes[:n]
            # per column: number of rows with the bit set (one vectorized
            # unpack over all rows, not a per-row Python loop)
            counts = np.unpackbits(
                np.ascontiguousarray(planes).view(np.uint8),
                bitorder="little").reshape(n, -1).sum(axis=0, dtype=np.int64)
            for pos in np.nonzero(counts > 1)[0]:
                col = shard * (planes.shape[1] * 32) + int(pos)
                w, b = divmod(int(pos), 32)
                rows = [frag.row_ids[s] for s in range(n)
                        if planes[s, w] & (1 << b)]
                bad[col] = rows
        if bad:
            out[field.name] = bad
    return out


class MaintenanceLoop:
    """Periodic TTL sweeps on a daemon thread (reference: the
    ViewsRemoval ticker in server.Open)."""

    def __init__(self, holder: Holder, interval_s: float = 3600.0):
        self.holder = holder
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            remove_expired_views(self.holder)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1)
            self._thread = None

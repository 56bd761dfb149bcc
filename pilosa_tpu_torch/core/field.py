"""Field: a typed attribute of an index.

Port of ``pilosa_tpu/core/field.py`` for set, mutex, bool, time, int,
decimal and timestamp fields: a field owns views (the standard view plus
a ``time`` field's time-quantum views, reference: view.go:26-33), each
holding one fragment per shard, plus the row-key store when ``keys`` is
on (reference: field.go:73, :449). Int-like fields store one BSI fragment
per shard and map external values to stored integers through their base,
decimal scale or time unit (reference: field.go bsiGroup). The write
calls (set and clear a bit, set and clear a value, write, clear or zero a
row plane, clear columns) are the single logging funnel: each appends the
JAX package's WAL record (numpy arrays and Python scalars only) to the
index's log, when the holder is durable, before it changes a fragment;
fragment methods never log. A timestamped set lands in the standard view
and one view per unit of the quantum.
"""

from __future__ import annotations

import datetime as dt
import os
import time
from typing import Dict, Iterable, List, Optional, Set

import numpy as np
import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.fragment import (BSIFragment, SetFragment,
                                            group_sorted)
from pilosa_tpu_torch.core.schema import (BOOL_FALSE_ROW, BOOL_TRUE_ROW,
                                          FieldOptions, FieldType)
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP
from pilosa_tpu_torch.storage.wal import pack_plane

_PORTED_TYPES = (FieldType.SET, FieldType.MUTEX, FieldType.BOOL,
                 FieldType.TIME, FieldType.INT, FieldType.DECIMAL, FieldType.TIMESTAMP)

_TIME_UNITS_PER_S = {"s": 1, "ms": 1000, "us": 1_000_000, "ns": 1_000_000_000}


def _int64(xs) -> np.ndarray:
    if not isinstance(xs, (list, tuple, np.ndarray)):
        xs = list(xs)  # generators/iterators per the signature
    return np.asarray(xs, dtype=np.int64).ravel()


class Field:
    def __init__(self, name: str, options: FieldOptions,
                 device: torch.device, write_lock=None,
                 path: Optional[str] = None):
        if options.type not in _PORTED_TYPES:
            raise NotImplementedError(
                f"not ported yet: {options.type.value} fields")
        if options.type == FieldType.TIME:
            timeq.validate_quantum(options.time_quantum)
        self.name = name
        self.options = options
        self.device = device
        self.path = path
        # the holder-wide writer lock (core/stacked.py build serialization)
        self.write_lock = write_lock
        # view name -> shard -> fragment
        self.views: Dict[str, Dict[int, SetFragment]] = {}
        # BSI storage (int/decimal/timestamp): shard -> BSIFragment
        self.bsi: Dict[int, BSIFragment] = {}
        self.translate = (
            TranslateStore(os.path.join(path, "keys.jsonl") if path else None,
                           start=1)
            if options.keys else None)
        # the index's write-ahead log (storage/wal.py), attached by the
        # owning Index when the holder is durable
        self.wal = None

    # -- value <-> stored mapping (BSI) -------------------------------------

    def to_stored(self, value) -> int:
        """External value -> stored integer (reference: field.go bsiGroup
        base/scale handling; decimal scale field.go:293)."""
        t = self.options.type
        if t == FieldType.DECIMAL:
            scaled = round(float(value) * (10 ** self.options.scale))
            return int(scaled) - self.options.base
        if t == FieldType.TIMESTAMP:
            if isinstance(value, str):
                value = dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
            if isinstance(value, dt.datetime):
                if value.tzinfo is None:
                    value = value.replace(tzinfo=dt.timezone.utc)
                value = (value.timestamp()
                         * _TIME_UNITS_PER_S[self.options.time_unit])
            return int(round(value)) - self.options.base
        if self.options.min is not None and value < self.options.min:
            raise ValueError(f"value {value} < field min {self.options.min}")
        if self.options.max is not None and value > self.options.max:
            raise ValueError(f"value {value} > field max {self.options.max}")
        return int(value) - self.options.base

    def from_stored(self, stored: int):
        raw = stored + self.options.base
        if self.options.type == FieldType.DECIMAL:
            return raw / (10 ** self.options.scale)
        return raw

    def _to_stored_bulk(self, values) -> np.ndarray:
        """Vectorized :meth:`to_stored` for int and decimal values,
        element-wise otherwise (timestamps, mixed types); min/max bounds
        raise here exactly as in ``to_stored``."""
        t = self.options.type
        try:
            if t == FieldType.INT:
                out = np.asarray(values, dtype=np.int64)
            elif t == FieldType.DECIMAL:
                out = np.round(np.asarray(values, dtype=np.float64)
                               * (10 ** self.options.scale)).astype(np.int64)
                return out - self.options.base
            else:
                raise TypeError
        except (TypeError, ValueError, OverflowError):
            return np.array([self.to_stored(v) for v in values],
                            dtype=np.int64)
        if self.options.min is not None and (out < self.options.min).any():
            bad = int(out[out < self.options.min][0])
            raise ValueError(f"value {bad} < field min {self.options.min}")
        if self.options.max is not None and (out > self.options.max).any():
            bad = int(out[out > self.options.max][0])
            raise ValueError(f"value {bad} > field max {self.options.max}")
        return out - self.options.base

    # -- fragment accessors --------------------------------------------------

    def fragment(self, shard: int, view: str = timeq.VIEW_STANDARD,
                 create: bool = False) -> Optional[SetFragment]:
        frags = self.views.get(view)
        if frags is None:
            if not create:
                return None
            frags = self.views[view] = {}
        frag = frags.get(shard)
        if frag is None and create:
            frag = frags[shard] = SetFragment(shard, self.device)
        return frag

    def bsi_fragment(self, shard: int, create: bool = False
                     ) -> Optional[BSIFragment]:
        frag = self.bsi.get(shard)
        if frag is None and create:
            frag = self.bsi[shard] = BSIFragment(shard)
        return frag

    def shards(self) -> Set[int]:
        out: Set[int] = set(self.bsi)
        for frags in self.views.values():
            out.update(frags)
        return out

    def view_names(self) -> List[str]:
        return sorted(self.views)

    # -- write path ----------------------------------------------------------

    def _write_views(self, timestamp: Optional[dt.datetime]) -> List[str]:
        """The views a write lands in: the standard view, and with a
        timestamp one view per unit of the quantum (reference: time.go:143
        viewsByTime)."""
        views = [timeq.VIEW_STANDARD]
        if timestamp is not None:
            if self.options.type != FieldType.TIME:
                raise ValueError(
                    f"field {self.name} does not support timestamps")
            views += timeq.views_by_time(timestamp, self.options.time_quantum)
        return views

    def _log(self, *record) -> None:
        if self.wal is not None:
            self.wal.append(record)

    def set_bit(self, row: int, col: int,
                timestamp: Optional[dt.datetime] = None) -> bool:
        """Set (row, col) in every view of the write; mutex/bool clear the
        column's other rows first (reference: fragment.go setBit +
        fragment.go:1787)."""
        views = self._write_views(timestamp)  # validates before logging
        self._log("set_bit", self.name, row, col,
                  timestamp.isoformat() if timestamp else None)
        shard, pos = divmod(col, SHARD_WIDTH)
        changed = False
        for view in views:
            frag = self.fragment(shard, view, create=True)
            if self.options.type in (FieldType.MUTEX, FieldType.BOOL):
                changed |= frag.clear_column(pos, except_row=row)
            changed |= frag.set_bit(row, pos)
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        """Clear (row, col) in every view (reference: fragment clearBit
        per view)."""
        self._log("clear_bit", self.name, row, col)
        shard, pos = divmod(col, SHARD_WIDTH)
        changed = False
        for view in list(self.views):
            frag = self.fragment(shard, view)
            if frag is not None:
                changed |= frag.clear_bit(row, pos)
        return changed

    def set_bool(self, col: int, value: bool) -> bool:
        return self.set_bit(BOOL_TRUE_ROW if value else BOOL_FALSE_ROW, col)

    def set_value(self, col: int, value) -> None:
        self.set_values([col], [value])

    def clear_value(self, col: int) -> bool:
        self._log("clear_value", self.name, col)
        shard, pos = divmod(col, SHARD_WIDTH)
        frag = self.bsi_fragment(shard)
        return frag.clear_value(pos) if frag else False

    def write_row_plane(self, shard: int, row: int, plane,
                        clear: bool = False,
                        view: str = timeq.VIEW_STANDARD) -> None:
        """Merge (OR) or replace one row plane (the Store path;
        reference: fragment.go:2038 importRoaring, executor.go
        executeSetRow)."""
        self._log("row_plane", self.name, view, shard, row,
                  pack_plane(plane), clear)
        frag = self.fragment(shard, view, create=True)
        frag.import_row_plane(row, plane, clear=clear)

    def clear_row_plane_bits(self, shard: int, row: int, plane,
                             view: str = timeq.VIEW_STANDARD) -> bool:
        """Clear the bits of ``plane`` from one row (reference:
        fragment.go:2053 ImportRoaringClearAndSet)."""
        self._log("clear_row_bits", self.name, view, shard, row,
                  pack_plane(plane))
        frag = self.fragment(shard, view)
        if frag is None:
            return False
        return frag.clear_row_plane_bits(row, plane)

    def clear_row(self, row: int) -> bool:
        """Zero a row across all views and shards (reference:
        executor.go executeClearRow)."""
        self._log("clear_row", self.name, row)
        changed = False
        for view in list(self.views):
            for frag in self.views[view].values():
                if frag.has_row(row):
                    frag.import_row_plane(
                        row, np.zeros(frag.words, dtype=np.uint32),
                        clear=True)
                    changed = True
        return changed

    def clear_columns(self, shard: int, plane, log: bool = True) -> None:
        """Clear the columns of ``plane`` from every view fragment and
        the BSI planes of this shard (record deletion, reference:
        executor.go:9050 executeDeleteRecords). ``log=False`` when the
        owning Index already logged one index-level delete record."""
        if log:
            self._log("clear_cols", self.name, shard, pack_plane(plane))
        for view_frags in self.views.values():
            frag = view_frags.get(shard)
            if frag is not None:
                frag.clear_plane(plane)
        bsi = self.bsi.get(shard)
        if bsi is not None:
            bsi.clear_plane(plane)

    def import_bits(self, rows: Iterable[int], cols: Iterable[int],
                    clear: bool = False) -> int:
        """Bulk (row, col) import with IDs already translated (reference:
        fragment.go:1498 bulkImport; mutex variant :1787). Returns the
        changed bit count. One bulk WAL record replaces per-bit logging;
        ``clear`` clears bit by bit, every view, each clear logged. With
        the device profiler on, the call is the ``fragment_advance``
        ingest stage."""
        if not devprof.ENABLED:
            return self._import_bits(rows, cols, clear)
        rows, cols = _int64(rows), _int64(cols)
        t0 = time.perf_counter()
        changed = self._import_bits(rows, cols, clear)
        devprof.record_stage("fragment_advance", time.perf_counter() - t0,
                             rows=len(cols))
        return changed

    def _import_bits(self, rows: Iterable[int], cols: Iterable[int],
                     clear: bool) -> int:
        rows, cols = _int64(rows), _int64(cols)
        if rows.size != cols.size:
            raise ValueError("rows and cols must be the same length")
        changed = 0
        if clear:
            for r, c in zip(rows, cols):
                changed += self.clear_bit(int(r), int(c))
            return changed
        mutex = self.options.type in (FieldType.MUTEX, FieldType.BOOL)
        if mutex and rows.size < 256:
            # small batches: per-bit, as the JAX package does
            for r, c in zip(rows, cols):
                changed += self.set_bit(int(r), int(c))
            return changed
        if mutex:
            # later duplicates win per column, then one vectorized
            # clear-and-set per shard
            _, last = np.unique(cols[::-1], return_index=True)
            idx = cols.size - 1 - last
            rows, cols = rows[idx], cols[idx]
        self._log("import_bits", self.name, rows, cols)
        shards = cols >> SHARD_WIDTH_EXP
        pos = cols & (SHARD_WIDTH - 1)
        for shard, (r, p) in group_sorted(shards, rows, pos):
            frag = self.fragment(shard, create=True)
            changed += (frag.set_mutex_many(r, p) if mutex
                        else frag.set_many(r, p))
        return changed

    def set_values(self, cols: Iterable[int], values: Iterable) -> None:
        """Bulk BSI write of external values (reference: api.go
        ImportValue -> fragment.importValue); converts and validates all
        values before any fragment changes. With the device profiler on,
        the call is the ``fragment_advance`` ingest stage."""
        cols = _int64(cols)
        if not devprof.ENABLED:
            return self._set_values(cols, values)
        t0 = time.perf_counter()
        self._set_values(cols, values)
        devprof.record_stage("fragment_advance", time.perf_counter() - t0,
                             rows=len(cols))

    def _set_values(self, cols: np.ndarray, values: Iterable) -> None:
        if not isinstance(values, (list, tuple, np.ndarray)):
            values = list(values)
        stored = self._to_stored_bulk(values)
        if cols.size != stored.size:
            raise ValueError("cols and values must be the same length")
        # external values, so replay converts them again through the
        # field's options (decimal and timestamp conversion in one place)
        self._log("set_values", self.name, cols, np.asarray(values))
        shards = cols >> SHARD_WIDTH_EXP
        pos = cols & (SHARD_WIDTH - 1)
        for shard, (p, v) in group_sorted(shards, pos, stored):
            self.bsi_fragment(shard, create=True).set_values(p, v)

    def value(self, col: int):
        """Point read of one column's external value, or None."""
        shard, pos = divmod(col, SHARD_WIDTH)
        frag = self.bsi_fragment(shard)
        stored = frag.value(pos) if frag is not None else None
        return None if stored is None else self.from_stored(stored)

    # -- read helpers ----------------------------------------------------------

    def range_views(self, from_t: Optional[dt.datetime],
                    to_t: Optional[dt.datetime]) -> List[str]:
        """The views holding data that cover a time range (reference:
        field.go:1001 viewsByTimeRange dispatch); no bounds means the
        standard view."""
        if from_t is None and to_t is None:
            return [timeq.VIEW_STANDARD]
        if self.options.type != FieldType.TIME:
            raise ValueError(f"field {self.name} is not a time field")
        # an open side takes the other side's tzinfo: comparing a naive
        # with an aware time raises in the cover recursion
        tz = (from_t or to_t).tzinfo
        lo = from_t or dt.datetime(1, 1, 1, tzinfo=tz)
        hi = to_t or dt.datetime(9999, 1, 1, tzinfo=tz)
        views = timeq.views_by_time_range(lo, hi, self.options.time_quantum)
        # an open range names millennia of views; only views that exist
        # can hold bits
        return [v for v in views if v in self.views]

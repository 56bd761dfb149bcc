"""Field: a typed attribute of an index.

Port of ``pilosa_tpu/core/field.py`` for set, mutex and bool fields: a
field owns views (the standard view in this slice), each holding one
fragment per shard, plus the row-key store when ``keys`` is on
(reference: field.go:73, :449). BSI fields, time views and the WAL wait
for later slices.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

import numpy as np
import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.fragment import SetFragment, group_sorted
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP

_PORTED_TYPES = (FieldType.SET, FieldType.MUTEX, FieldType.BOOL)


def _int64(xs) -> np.ndarray:
    if not isinstance(xs, (list, tuple, np.ndarray)):
        xs = list(xs)  # generators/iterators per the signature
    return np.asarray(xs, dtype=np.int64).ravel()


class Field:
    def __init__(self, name: str, options: FieldOptions,
                 device: torch.device, write_lock=None):
        if options.type not in _PORTED_TYPES:
            raise NotImplementedError(
                f"not ported yet: {options.type.value} fields")
        self.name = name
        self.options = options
        self.device = device
        # the holder-wide writer lock (core/stacked.py build serialization)
        self.write_lock = write_lock
        # view name -> shard -> fragment
        self.views: Dict[str, Dict[int, SetFragment]] = {}
        self.translate = TranslateStore(start=1) if options.keys else None

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

    def shards(self) -> Set[int]:
        out: Set[int] = set()
        for frags in self.views.values():
            out.update(frags)
        return out

    # -- write path ----------------------------------------------------------

    def set_bit(self, row: int, col: int) -> bool:
        """Set (row, col); mutex/bool clear the column's other rows first
        (reference: fragment.go setBit + fragment.go:1787)."""
        shard, pos = divmod(col, SHARD_WIDTH)
        frag = self.fragment(shard, create=True)
        changed = False
        if self.options.type in (FieldType.MUTEX, FieldType.BOOL):
            changed |= frag.clear_column(pos, except_row=row)
        changed |= frag.set_bit(row, pos)
        return changed

    def import_bits(self, rows: Iterable[int], cols: Iterable[int]) -> int:
        """Bulk (row, col) import with IDs already translated (reference:
        fragment.go:1498 bulkImport; mutex variant :1787). Returns the
        changed bit count."""
        rows, cols = _int64(rows), _int64(cols)
        if rows.size != cols.size:
            raise ValueError("rows and cols must be the same length")
        changed = 0
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
        shards = cols >> SHARD_WIDTH_EXP
        pos = cols & (SHARD_WIDTH - 1)
        for shard, (r, p) in group_sorted(shards, rows, pos):
            frag = self.fragment(shard, create=True)
            changed += (frag.set_mutex_many(r, p) if mutex
                        else frag.set_many(r, p))
        return changed

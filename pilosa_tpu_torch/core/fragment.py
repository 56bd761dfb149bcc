"""Fragments: per-(field, view, shard) bitmap storage.

Port of ``SetFragment`` and ``BSIFragment`` from
``pilosa_tpu/core/fragment.py``. A set fragment is a mutable host
``np.uint32[capacity, WORDS]`` plane matrix plus a row-id -> plane-slot
map; a BSI fragment is the ``np.uint32[2+depth, WORDS]`` bit-plane stack
of an int-like field. Every write lands here and bumps ``version``.
Device views are built from the host planes by core/stacked.py, which
rebuilds a stack whose fragments changed. Row capacity grows in powers
of two, BSI depth as values need it. The write-delta log that feeds the
stack advance paths, and BSI clears (PQL writes), wait for later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.ops import bsi as bsiops
from pilosa_tpu_torch.ops import scatter as scatterops
from pilosa_tpu_torch.ops.bitmap import bits_to_plane
from pilosa_tpu_torch.shardwidth import BITS_PER_WORD, WORDS_PER_SHARD

_MIN_CAPACITY = 8


def group_sorted(keys: np.ndarray, *arrays: np.ndarray):
    """Stable-sort ``arrays`` by ``keys`` and return ``(key, (slice, ...))``
    per distinct key — the group-and-slice idiom of every bulk write."""
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    sorted_arrays = [a[order] for a in arrays]
    uk, starts = np.unique(keys_s, return_index=True)
    bounds = np.append(starts[1:], keys_s.size)
    return [(int(k), tuple(a[lo:hi] for a in sorted_arrays))
            for k, lo, hi in zip(uk, starts, bounds)]


def _grow_rows(planes: np.ndarray, need: int) -> np.ndarray:
    cap = max(_MIN_CAPACITY, planes.shape[0])
    while cap < need:
        cap *= 2
    if cap == planes.shape[0]:
        return planes
    out = np.zeros((cap, planes.shape[1]), dtype=np.uint32)
    out[: planes.shape[0]] = planes
    return out


class SetFragment:
    """Bitmap rows for set/mutex/bool fields (one per view+shard).
    ``device`` is where bulk imports run their scatter-merge."""

    def __init__(self, shard: int, device: torch.device,
                 words: int = WORDS_PER_SHARD):
        self.shard = shard
        self.words = words
        self.device = device
        self.row_index: Dict[int, int] = {}  # row id -> plane slot
        self.row_ids: List[int] = []  # plane slot -> row id
        self.planes = np.zeros((0, words), dtype=np.uint32)
        self.version = 0

    # -- host write path ---------------------------------------------------

    def _slot(self, row: int) -> int:
        s = self.row_index.get(row)
        if s is None:
            s = len(self.row_ids)
            self.planes = _grow_rows(self.planes, s + 1)
            self.row_index[row] = s
            self.row_ids.append(row)
        return s

    def set_bit(self, row: int, col: int) -> bool:
        """Set bit; returns True if it changed."""
        s = self._slot(row)
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        old = self.planes[s, w]
        if old & mask:
            return False
        self.planes[s, w] = old | mask
        self.version += 1
        return True

    def clear_column(self, col: int, except_row=None) -> bool:
        """Clear a column across all rows (mutex semantics, reference:
        fragment.go:1787)."""
        if not self.row_ids:
            return False
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        col_words = self.planes[: len(self.row_ids), w]
        to_clear = (col_words & mask) != 0
        if except_row is not None and except_row in self.row_index:
            to_clear[self.row_index[except_row]] = False
        if not to_clear.any():
            return False
        col_words[to_clear] &= ~mask
        self.version += 1
        return True

    def set_many(self, rows: Sequence[int], cols: Sequence[int]) -> int:
        """Bulk import of (row, col) pairs through the scatter-merge kernel
        on ``self.device`` (reference: fragment.go:1498 bulkImport).
        Returns the number of changed bits."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size == 0:
            return 0
        groups = group_sorted(rows, cols)
        # one capacity grow for the whole import, not one per new row
        n_new = sum(1 for r, _ in groups if r not in self.row_index)
        if n_new:
            self.planes = _grow_rows(self.planes, len(self.row_ids) + n_new)
        slots = np.array([self._slot(row) for row, _ in groups],
                         dtype=np.int64)
        sizes = [sel.size for _, (sel,) in groups]
        changed = scatterops.scatter_new_bits_bulk(
            self.planes, np.repeat(slots, sizes),
            np.concatenate([sel for _, (sel,) in groups]), self.device)
        self.version += 1
        return changed

    def set_mutex_many(self, rows: np.ndarray, cols: np.ndarray) -> int:
        """Bulk mutex/bool import: each column ends up in exactly its new
        row, cleared from every other (reference: fragment.go:1787
        bulkImportMutex). Inputs are deduped last-wins per column by the
        caller. Returns the bits newly set in their target row."""
        touched = bits_to_plane(cols, self.words)
        n = len(self.row_ids)
        old = self.planes[:n] & touched[None, :] if n else None
        if n:
            self.planes[:n] &= ~touched[None, :]
        changed = 0
        for row, (sel,) in group_sorted(rows, cols):
            s = self._slot(row)
            plane = bits_to_plane(sel, self.words)
            if old is not None and s < old.shape[0]:
                changed += native.popcount(plane & ~old[s])
            else:
                changed += int(sel.size)
            self.planes[s] |= plane
        self.version += 1
        return changed


class BSIFragment:
    """Bit-sliced integer storage for int/decimal/timestamp fields: plane
    stack ``[exists, sign, magnitude...]`` (reference: fragment.go:62-66)
    whose bit depth grows on demand like the reference's importValue
    (fragment.go:1947)."""

    def __init__(self, shard: int, words: int = WORDS_PER_SHARD,
                 depth: int = 1):
        self.shard = shard
        self.words = words
        self.depth = depth
        self.planes = np.zeros((bsiops.OFFSET + depth, words), dtype=np.uint32)
        self.version = 0

    def _ensure_depth(self, depth: int) -> None:
        if depth <= self.depth:
            return
        out = np.zeros((bsiops.OFFSET + depth, self.words), dtype=np.uint32)
        out[: self.planes.shape[0]] = self.planes
        self.planes = out
        self.depth = depth

    def set_values(self, cols: Sequence[int], values: Sequence[int]) -> None:
        """Write (col, stored value) pairs; later duplicates win and a
        written column is cleared before it is set (reference:
        fragment.go:1947 importValue)."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        _, last = np.unique(cols[::-1], return_index=True)
        idx = cols.size - 1 - last
        cols, values = cols[idx], values[idx]
        self._ensure_depth(max(bsiops.bits_needed(int(values.min())),
                               bsiops.bits_needed(int(values.max()))))
        self.planes &= ~bits_to_plane(cols, self.words)[None, :]
        self.planes |= bsiops.encode_values(cols, values, self.depth,
                                            self.words)
        self.version += 1

    def value(self, col: int) -> Optional[int]:
        """Point read (host): the stored value of a column, or None."""
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        if not (self.planes[bsiops.EXISTS, w] & mask):
            return None
        mag = 0
        for k in range(self.depth):
            if self.planes[bsiops.OFFSET + k, w] & mask:
                mag |= 1 << k
        return -mag if self.planes[bsiops.SIGN, w] & mask else mag

    def exists_plane(self) -> np.ndarray:
        return self.planes[bsiops.EXISTS]

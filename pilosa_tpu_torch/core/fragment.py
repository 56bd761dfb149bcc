"""Fragments: per-(field, view, shard) bitmap storage.

Port of ``SetFragment`` and ``BSIFragment`` from
``pilosa_tpu/core/fragment.py``. A set fragment is a mutable host
``np.uint32[capacity, WORDS]`` plane matrix plus a row-id -> plane-slot
map; a BSI fragment is the ``np.uint32[2+depth, WORDS]`` bit-plane stack
of an int-like field. Every write lands here and bumps ``version``.
Row capacity grows in powers of two, BSI depth as values need it.

Device views are built from the host planes by core/stacked.py. Each
fragment keeps a write-delta log (:class:`_DeltaLog`) of its small
writes since a version, so core/stacked.py can advance a cached stack by
a masked scatter instead of rebuilding it; a bulk or structural write
resets the log, and the next read rebuilds.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.config import env_bool as _env_bool
from pilosa_tpu_torch.ops import bsi as bsiops
from pilosa_tpu_torch.ops import scatter as scatterops
from pilosa_tpu_torch.ops.bitmap import bits_to_plane
from pilosa_tpu_torch.shardwidth import BITS_PER_WORD, WORDS_PER_SHARD

_MIN_CAPACITY = 8

# Paranoia mode (reference: roaring/roaring_paranoia.go build tag): opt-in
# re-validation of the fragment invariants after every mutation, read from
# PILOSA_TPU_PARANOIA at import, as the JAX package reads it.
PARANOIA = _env_bool("PILOSA_TPU_PARANOIA")


def _paranoia_set(frag: "SetFragment") -> None:
    assert len(frag.row_ids) == len(frag.row_index), \
        "row_ids/row_index length mismatch"
    for slot, row in enumerate(frag.row_ids):
        assert frag.row_index[row] == slot, f"slot map broken for row {row}"
    assert frag.planes.shape[0] >= len(frag.row_ids), "capacity underflow"
    assert frag.planes.dtype == np.uint32
    # padding slots must stay zero (stacks rely on it for gather fill)
    if frag.planes.shape[0] > len(frag.row_ids):
        assert not frag.planes[len(frag.row_ids):].any(), \
            "dirty padding slot"


def _paranoia_bsi(frag: "BSIFragment") -> None:
    assert frag.planes.shape[0] == bsiops.OFFSET + frag.depth, \
        "plane count != 2 + depth"
    exists = frag.planes[bsiops.EXISTS]
    # sign and magnitude bits only where a value exists
    for k in range(frag.planes.shape[0]):
        if k == bsiops.EXISTS:
            continue
        assert not (frag.planes[k] & ~exists).any(), \
            f"plane {k} has bits outside the existence plane"


# Write-delta log bounds: more pending ops (or more columns of replay)
# than this and a full re-stack is cheaper than scattering, so the log
# resets and the next stack build re-uploads (reference: the RBF WAL ->
# checkpoint transition, rbf/db.go:149-230).
_DELTA_MAX_OPS = 512
_DELTA_MAX_COLS = 4096


class _DeltaLog:
    """Ordered log of representable writes since a fragment version.

    An op is *representable* when it can be replayed onto a stacked
    device tensor as per-(row, word) OR/ANDNOT masks: no bulk plane
    replacement, no BSI depth growth. ``base`` is the version the log is
    complete since; a stack built at version v can advance iff
    ``v >= base``."""

    def __init__(self):
        self.base = 0
        self.head = 0  # version after the last logged or reset write
        self.cost = 0  # replay cost (columns) of the pending ops
        self.ops: deque = deque()

    def record(self, version: int, payload, cost: int = 1) -> None:
        # a version gap means a write bumped the version without logging:
        # the log cannot bridge it. version == head continues the current
        # bump (set_many logs one payload per row under one version)
        if version not in (self.head, self.head + 1):
            self.reset(version)
            return
        if (len(self.ops) >= _DELTA_MAX_OPS
                or self.cost + cost > _DELTA_MAX_COLS):
            self.reset(version)
            return
        self.ops.append((version, payload))
        self.head = version
        self.cost += cost

    def reset(self, version: int) -> None:
        """A non-representable write (or overflow): no stack built before
        ``version`` can advance past it."""
        self.ops.clear()
        self.base = version
        self.head = version
        self.cost = 0

    def since(self, base_version: int, current_version: int):
        """Payloads after ``base_version``, or None when the log cannot
        bridge from there: a base before the log's, a base past its head
        (a stack of another fragment object), or a current version past
        its head (an unlogged bump)."""
        if (base_version < self.base or base_version > self.head
                or current_version > self.head):
            return None
        return [p for v, p in self.ops if v > base_version]


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
        # (row, set_cols, clear_cols) payloads for the stack advance
        self.deltas = _DeltaLog()

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
        """Set bit; returns True if it changed. A new row is
        representable too: the stack advance appends its slot."""
        s = self._slot(row)
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        old = self.planes[s, w]
        if old & mask:
            return False
        self.planes[s, w] = old | mask
        self.version += 1
        self.deltas.record(self.version, (row, (col,), ()))
        if PARANOIA:
            _paranoia_set(self)
        return True

    def clear_bit(self, row: int, col: int) -> bool:
        s = self.row_index.get(row)
        if s is None:
            return False
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        old = self.planes[s, w]
        if not (old & mask):
            return False
        self.planes[s, w] = old & ~mask
        self.version += 1
        self.deltas.record(self.version, (row, (), (col,)))
        if PARANOIA:
            _paranoia_set(self)
        return True

    def clear_column(self, col: int, except_row=None) -> bool:
        """Clear a column across all rows (mutex semantics, reference:
        fragment.go:1787), logging a clear for each row it left."""
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
        for slot in np.nonzero(to_clear)[0]:
            self.deltas.record(self.version, (self.row_ids[slot], (), (col,)))
        if PARANOIA:
            _paranoia_set(self)
        return True

    def set_many(self, rows: Sequence[int], cols: Sequence[int]) -> int:
        """Bulk import of (row, col) pairs through the scatter-merge kernel
        on ``self.device`` (reference: fragment.go:1498 bulkImport).
        Returns the number of changed bits. An import of at most
        ``_DELTA_MAX_COLS`` pairs logs one payload per row; a larger one
        resets the log."""
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
        if PARANOIA:
            _paranoia_set(self)
        if cols.size > _DELTA_MAX_COLS:
            self.deltas.reset(self.version)
            return changed
        for row, (sel,) in groups:
            p = (row, tuple(int(c) for c in np.unique(sel)), ())
            self.deltas.record(self.version, p, cost=len(p[1]))
            if self.deltas.base == self.version and not self.deltas.ops:
                # record() overflowed and reset: the rest of this import
                # can never be replayed, so it must not fill the new log
                break
        return changed

    def set_mutex_many(self, rows: np.ndarray, cols: np.ndarray) -> int:
        """Bulk mutex/bool import: each column ends up in exactly its new
        row, cleared from every other (reference: fragment.go:1787
        bulkImportMutex). Inputs are deduped last-wins per column by the
        caller. Returns the bits newly set in their target row. A bulk
        write of many rows: the log resets.

        The work follows the words the batch touches, not the field's
        rows: every read, clear and OR runs on the sorted distinct words
        ``W`` of ``cols`` (a 500-row batch of consecutive ids touches
        about 16 of a shard's 32,768), all rows of the batch at once,
        with the JAX package's planes, slots and count as the result."""
        cols = np.asarray(cols, dtype=np.int64)
        word = cols >> 5
        W = np.unique(word)
        local = np.searchsorted(W, word)  # each column's word in W
        # one run of words (consecutive ids) as a slice: a view, ~5x
        # cheaper than the gather and scatter of a fancy index
        win = slice(int(W[0]), int(W[-1]) + 1) \
            if W.size and W[-1] - W[0] + 1 == W.size else W
        bit = np.left_shift(np.uint32(1), (cols & 31).astype(np.uint32))
        touched = np.zeros(W.size, dtype=np.uint32)
        np.bitwise_or.at(touched, local, bit)
        n = len(self.row_ids)
        if n and W.size:
            sub = self.planes[:n, win]
            old = sub & touched
            self.planes[:n, win] = sub & ~touched
        # the batch's rows in sorted order, each with its len(W)-word
        # slice; new rows take their slots in that order, as _slot would
        uk, inv = np.unique(np.asarray(rows, dtype=np.int64),
                            return_inverse=True)
        n_new = sum(1 for r in uk.tolist() if r not in self.row_index)
        if n_new:  # one capacity grow for the batch
            self.planes = _grow_rows(self.planes, len(self.row_ids) + n_new)
        slots = np.array([self._slot(r) for r in uk.tolist()],
                         dtype=np.int64)
        planes = np.zeros((uk.size, W.size), dtype=np.uint32)
        np.bitwise_or.at(planes, (inv, local), bit)
        was = slots < n
        changed = int(np.bincount(inv, minlength=uk.size)[~was].sum())
        if was.any():
            changed += native.popcount(planes[was] & ~old[slots[was]])
        if isinstance(win, slice):
            self.planes[slots, win] |= planes
        elif uk.size:
            self.planes[slots[:, None], W[None, :]] |= planes
        self.version += 1
        self.deltas.reset(self.version)
        if PARANOIA:
            _paranoia_set(self)
        return changed

    def import_row_plane(self, row: int, plane: np.ndarray,
                         clear: bool = False) -> None:
        """Merge (OR) or replace a whole row plane (reference:
        fragment.go:2038 importRoaring, :2053 ImportRoaringClearAndSet)."""
        s = self._slot(row)
        if clear:
            self.planes[s] = plane
        else:
            self.planes[s] |= plane
        self.version += 1
        self.deltas.reset(self.version)
        if PARANOIA:
            _paranoia_set(self)

    def clear_row_plane_bits(self, row: int, plane: np.ndarray) -> bool:
        """Clear the bits of ``plane`` from a row; a no-op (no slot) when
        the row does not exist."""
        s = self.row_index.get(row)
        if s is None:
            return False
        self.planes[s] &= ~plane
        self.version += 1
        self.deltas.reset(self.version)
        if PARANOIA:
            _paranoia_set(self)
        return True

    def clear_plane(self, plane: np.ndarray) -> None:
        """Clear the columns of ``plane`` from every row (record
        deletion, reference: executor.go:9050 executeDeleteRecords)."""
        n = len(self.row_ids)
        if n == 0:
            return
        self.planes[:n] &= ~plane
        self.version += 1
        self.deltas.reset(self.version)
        if PARANOIA:
            _paranoia_set(self)

    # -- host read path ----------------------------------------------------

    def row_plane(self, row: int) -> np.ndarray:
        s = self.row_index.get(row)
        if s is None:
            return np.zeros(self.words, dtype=np.uint32)
        return self.planes[s]

    def has_row(self, row: int) -> bool:
        return row in self.row_index

    def existing_rows(self) -> List[int]:
        return sorted(self.row_index)


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
        # ("set", cols, values) / ("clear", col) payloads for the stack
        # advance; depth growth resets (the plane count changed)
        self.deltas = _DeltaLog()

    def _ensure_depth(self, depth: int) -> None:
        if depth <= self.depth:
            return
        out = np.zeros((bsiops.OFFSET + depth, self.words), dtype=np.uint32)
        out[: self.planes.shape[0]] = self.planes
        self.planes = out
        self.depth = depth

    def set_value(self, col: int, value: int) -> None:
        self.set_values([col], [value])

    def set_values(self, cols: Sequence[int], values: Sequence[int]) -> None:
        """Write (col, stored value) pairs; later duplicates win and a
        written column is cleared before it is set (reference:
        fragment.go:1947 importValue). Logged unless the depth grew or
        the replay cost ``cols x (OFFSET + depth)`` passes
        ``_DELTA_MAX_COLS``."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        _, last = np.unique(cols[::-1], return_index=True)
        idx = cols.size - 1 - last
        cols, values = cols[idx], values[idx]
        need = max(bsiops.bits_needed(int(values.min())),
                   bsiops.bits_needed(int(values.max())))
        grew = need > self.depth
        self._ensure_depth(need)
        self.planes &= ~bits_to_plane(cols, self.words)[None, :]
        self.planes |= bsiops.encode_values(cols, values, self.depth,
                                            self.words)
        self.version += 1
        if PARANOIA:
            _paranoia_bsi(self)
        cost = cols.size * (bsiops.OFFSET + self.depth)
        if grew or cost > _DELTA_MAX_COLS:
            self.deltas.reset(self.version)
        else:
            self.deltas.record(
                self.version,
                ("set", tuple(int(c) for c in cols),
                 tuple(int(v) for v in values)),
                cost=cost)

    def clear_value(self, col: int) -> bool:
        w, b = divmod(col, BITS_PER_WORD)
        mask = np.uint32(1) << np.uint32(b)
        if not (self.planes[bsiops.EXISTS, w] & mask):
            return False
        self.planes[:, w] &= ~mask
        self.version += 1
        self.deltas.record(self.version, ("clear", col),
                           cost=bsiops.OFFSET + self.depth)
        if PARANOIA:
            _paranoia_bsi(self)
        return True

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

    def clear_plane(self, plane: np.ndarray) -> None:
        """Clear the columns of ``plane`` from every BSI plane (record
        deletion, reference: executor.go:9050 executeDeleteRecords)."""
        self.planes &= ~plane[None, :]
        self.version += 1
        self.deltas.reset(self.version)
        if PARANOIA:
            _paranoia_bsi(self)

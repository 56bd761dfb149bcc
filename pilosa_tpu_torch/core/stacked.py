"""Stacked device views: a field's fragments across shards as ONE tensor,
paged into row blocks under a device-memory budget.

Port of the dense ``StackedSet`` of ``pilosa_tpu/core/stacked.py``. Every
read kernel reduces over columns and never mixes them, so concatenating
the per-shard word axes

    shard planes  uint32[R, W]  x S shards  ->  int32[R, S*W] on the device

makes every single-shard kernel multi-shard with no change: one launch
per query step instead of one per shard. Row slots are the union of row
IDs across the stacked fragments.

**Row-block paging.** A stack whose full tensor exceeds one block is cut
into fixed-shape ``[block_rows, S*W]`` blocks (same ``_BLOCK_BYTES`` and
``_pow2`` rules as the JAX package), each built lazily from the host
fragments on first touch and LRU-evicted by the global
:class:`DeviceBudget`. A lazy build that finds a member fragment newer
than the stack's snapshot raises :class:`StackStale`, and the executor
retries the read on a fresh stack.

Caches hang on the owning Field keyed by (view, shard tuple) and are
validated against the fragment version vector: a stack whose fragments
changed is rebuilt. The JAX package's in-place advance paths
(``_advance_set``) and compressed blocks (``ops/ctiles.py``) wait for
later slices.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.ops import bitmap as bitops
from pilosa_tpu_torch.ops import topk as topkops
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

_MIN_SLOTS = 8


class StackStale(RuntimeError):
    """A lazy block build found its member fragments newer than the
    stack's snapshot version; the read must restart on a fresh stack."""


def _pow2(n: int) -> int:
    cap = _MIN_SLOTS
    while cap < n:
        cap *= 2
    return cap


def _env_mb(name: str, default_mb: int) -> int:
    try:
        return int(os.environ.get(name, default_mb))
    except ValueError:
        return default_mb


def _budget_bytes() -> int:
    """Budget in bytes. ``PILOSA_TPU_DEVICE_BUDGET`` (bytes) wins over
    ``PILOSA_TPU_HBM_BUDGET_MB`` (the JAX package's names and default)."""
    raw = os.environ.get("PILOSA_TPU_DEVICE_BUDGET")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return _env_mb("PILOSA_TPU_HBM_BUDGET_MB", 6144) << 20


class DeviceBudget:
    """Byte-capped LRU of evictable device tensors (stack blocks).

    Eviction drops the owner's *reference*; a tensor still used by a
    kernel in flight stays alive through PyTorch's refcounts and the
    stream-ordered caching allocator, so no pinning protocol is needed."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.used = 0
        self._lock = threading.Lock()
        self._lru: "OrderedDict[Tuple, Tuple[int, object]]" = OrderedDict()

    def charge(self, key: Tuple, nbytes: int, evict_cb) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self.used -= old[0]
            self._lru[key] = (nbytes, evict_cb)
            self.used += nbytes
            while self.used > self.cap and len(self._lru) > 1:
                k, (b, cb) = self._lru.popitem(last=False)
                if k == key:  # never evict the entry being inserted
                    self._lru[k] = (b, cb)
                    self._lru.move_to_end(k, last=False)
                    if len(self._lru) == 1:
                        break
                    continue
                self.used -= b
                cb()

    def touch(self, key: Tuple) -> None:
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)

    def release(self, key: Tuple) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self.used -= old[0]

    def audit(self) -> None:
        """The byte counter must equal the sum of resident entries — a
        drift means a leak or double release."""
        with self._lock:
            total = sum(b for b, _ in self._lru.values())
            if total != self.used:
                raise AssertionError(
                    f"DeviceBudget drift: used={self.used} entries={total}")


BUDGET = DeviceBudget(_budget_bytes())

#: target bytes per row block; a stack pages when its full tensor would
#: exceed one block
_BLOCK_BYTES = _env_mb("PILOSA_TPU_BLOCK_BYTES_MB", 256) << 20

_stack_serial = itertools.count()


class StackedSet:
    """Union-row view of set fragments: ``int32[cap, S*W]`` in row blocks.

    Unpaged stacks (cap fits one block) upload eagerly as one tensor;
    paged stacks build blocks lazily and stream them."""

    def __init__(self, shards: Sequence[int], fragments,
                 device: torch.device, words: int = WORDS_PER_SHARD,
                 write_lock=None):
        self.shards = tuple(shards)
        self.words = words
        self.device = device
        self.total_words = len(self.shards) * words
        self.serial = next(_stack_serial)
        self._write_lock = (write_lock if write_lock is not None
                            else contextlib.nullcontext())
        rows: set = set()
        for frag in fragments:
            if frag is not None:
                rows.update(frag.row_index)
        self.row_ids: List[int] = sorted(rows)
        self.row_index: Dict[int, int] = {
            r: i for i, r in enumerate(self.row_ids)}
        row_bytes = self.total_words * 4
        per_block = max(_MIN_SLOTS, _BLOCK_BYTES // max(row_bytes, 1))
        self.block_rows = min(_pow2(len(self.row_ids)),
                              _pow2(per_block) // 2 or _MIN_SLOTS)
        if self.block_rows * row_bytes > _BLOCK_BYTES:
            self.block_rows = max(_MIN_SLOTS, self.block_rows // 2)
        self.cap = max(self.block_rows,
                       -(-len(self.row_ids) // self.block_rows)
                       * self.block_rows)
        self.paged = self.cap > self.block_rows
        self._fragments = list(fragments)
        self._built_vers = tuple(
            -1 if f is None else f.version for f in fragments)
        self._blocks: List[Optional[torch.Tensor]] = (
            [None] * (self.cap // self.block_rows))
        self._lock = threading.Lock()
        if not self.paged:
            # the single block is resident and charged like any block; an
            # evicted block 0 rebuilds lazily with the version check
            blk = self._build_block_host(0)
            self._blocks[0] = blk
            BUDGET.charge((self.serial, 0), _nbytes(blk),
                          lambda s=self: s._drop_block(0))

    # -- block machinery ----------------------------------------------------

    @property
    def n_blocks(self) -> int:
        return len(self._blocks)

    def _build_block_host(self, bi: int) -> torch.Tensor:
        """Assemble block ``bi`` from the host fragment planes and upload
        it. Caller has validated the version snapshot or holds the writer
        lock through the build."""
        lo_slot = bi * self.block_rows
        hi_slot = min(lo_slot + self.block_rows, len(self.row_ids))
        host = np.zeros((self.block_rows, self.total_words), dtype=np.uint32)
        for si, frag in enumerate(self._fragments):
            if frag is None:
                continue
            lo = si * self.words
            pairs = [(slot - lo_slot, frag.row_index.get(self.row_ids[slot]))
                     for slot in range(lo_slot, hi_slot)]
            pairs = [(d, s) for d, s in pairs if s is not None]
            if pairs:
                dst, src = (list(x) for x in zip(*pairs))
                host[dst, lo:lo + self.words] = frag.planes[src]
        return platform.h2d_copy(host, self.device)

    def _ensure_block(self, bi: int) -> torch.Tensor:
        blk = self._blocks[bi]
        if blk is not None:
            BUDGET.touch((self.serial, bi))
            return blk
        # the writer lock spans the version check AND the host copy, so a
        # bulk import cannot tear the block
        with self._write_lock, self._lock:
            blk = self._blocks[bi]
            if blk is not None:
                return blk
            for frag, built_v in zip(self._fragments, self._built_vers):
                if (frag.version if frag is not None else -1) != built_v:
                    raise StackStale(
                        "fragment advanced past the stack snapshot")
            blk = self._build_block_host(bi)
            self._blocks[bi] = blk
        BUDGET.charge((self.serial, bi), _nbytes(blk),
                      lambda s=self, i=bi: s._drop_block(i))
        return blk

    def release_device(self) -> None:
        """Drop this stack's budget entries (it left the field cache)."""
        for bi in range(self.n_blocks):
            BUDGET.release((self.serial, bi))

    def _drop_block(self, bi: int) -> None:
        self._blocks[bi] = None  # eviction: the next touch rebuilds

    def iter_blocks(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(start_slot, device block) over all blocks, built on demand."""
        for bi in range(self.n_blocks):
            yield bi * self.block_rows, self._ensure_block(bi)

    @property
    def planes(self) -> torch.Tensor:
        """The full ``[cap, S*W]`` tensor; only unpaged stacks have one."""
        if self.paged:
            raise AssertionError(
                "paged stack has no single tensor; use iter_blocks()")
        return self._ensure_block(0)

    # -- reads ----------------------------------------------------------------

    def zero_plane(self) -> torch.Tensor:
        return bitops.device_zeros(self.total_words, self.device)

    def row_plane(self, row: int) -> torch.Tensor:
        """Device ``[S*W]`` plane of one row id (zeros when absent); a
        point read touches exactly one block."""
        slot = self.row_index.get(row)
        if slot is None:
            return self.zero_plane()
        blk = self._ensure_block(slot // self.block_rows)
        return blk[slot % self.block_rows]

    def row_counts(self, filt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Device ``[cap]`` per-slot popcounts (optionally filtered),
        streamed per block through the pair_counts kernel (reference:
        fragment.go:1317 top counts)."""
        parts = [topkops.row_counts(blk, filt) for _, blk in self.iter_blocks()]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _versions(fragments) -> Tuple:
    return tuple(-1 if f is None else f.version for f in fragments)


# Cache layout: field._stacked_cache maps a group (kind, view) to an
# OrderedDict of shard-subset -> (versions, stack). Subsets are LRU-bounded
# because each one is a full duplicate device copy of its member planes.
_MAX_SUBSETS_PER_GROUP = 4
_LOCK = threading.Lock()


def _cache_get(field, group, subset, vers):
    with _LOCK:
        cache = getattr(field, "_stacked_cache", None)
        if cache is None:
            cache = field._stacked_cache = {}
        inner = cache.get(group)
        if inner is None:
            return None
        hit = inner.get(subset)
        if hit is not None and hit[0] == vers:
            inner.move_to_end(subset)
            return hit[1]
        return None


def _cache_put(field, group, subset, vers, built) -> None:
    dropped = []
    with _LOCK:
        cache = getattr(field, "_stacked_cache", None)
        if cache is None:
            cache = field._stacked_cache = {}
        inner = cache.setdefault(group, OrderedDict())
        old = inner.get(subset)
        if old is not None and old[1] is not built:
            dropped.append(old[1])
        inner[subset] = (vers, built)
        inner.move_to_end(subset)
        while len(inner) > _MAX_SUBSETS_PER_GROUP:
            dropped.append(inner.popitem(last=False)[1][1])
    for stack in dropped:  # outside the cache lock; BUDGET has its own
        stack.release_device()


def _writer_lock(field):
    lock = getattr(field, "write_lock", None)
    return lock if lock is not None else contextlib.nullcontext()


def stacked_set(field, shards: Sequence[int], view: str) -> StackedSet:
    """Build-or-reuse the stacked view of ``field``'s ``view`` fragments.

    A cache hit is lock-free (a cached stack is never written); a miss
    walks live host planes, so the fetch, version snapshot and build run
    under the writer lock."""
    group, subset = ("set", view), tuple(shards)
    fragments = [field.fragment(s, view) for s in shards]
    hit = _cache_get(field, group, subset, _versions(fragments))
    if hit is not None:
        return hit
    with _writer_lock(field):
        fragments = [field.fragment(s, view) for s in shards]
        vers = _versions(fragments)
        hit = _cache_get(field, group, subset, vers)
        if hit is None:
            hit = StackedSet(shards, fragments, field.device,
                             write_lock=_writer_lock(field))
            _cache_put(field, group, subset, vers, hit)
    return hit

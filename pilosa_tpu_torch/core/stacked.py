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

**BSI stacks** (:class:`StackedBSI`) hold an int-like field's plane
stacks across shards as one ``int32[2+depth, S*W]``; bit depth is
bounded, so they never page, but they are charged and evicted like any
block.

**Compressed residency.** A resident block (or BSI stack) is a dense
tensor *or* an ``ops/ctiles.py`` :class:`~ctiles.CompressedBlock`, as the
build's ``ctiles.maybe_compress`` decides (``PILOSA_TPU_COMPRESS``, the
JAX package's rules). The budget is charged the stored bytes. Readers
that need dense words (``iter_blocks``, ``planes``) get the block
decoded on the device, uncached, so the budget sees all the residency;
``row_plane`` decodes its one row, ``row_counts`` takes the
tile-skipping scan (one launch for a stack's compressed blocks) and
``StackedBSI.compare`` the active-tile compare.

Ranged reads gather rows across a time field's view stacks:
``take_rows`` (zero planes for absent rows) and ``rows_plane`` (an OR
over selected rows), block by block. The JAX package blocks on each
block's part on the CPU (``sync_part``, a workaround for XLA's CPU
collectives); PyTorch has no such hazard, so the port has no
counterpart and issues no sync.

Caches hang on the owning Field keyed by (kind, view) and shard tuple and
are validated against the fragment version vector. A stack whose
fragments changed **advances** when their write-delta logs
(``core/fragment.py`` ``_DeltaLog``) bridge the change: bit flips
collapse on the host into per-(slot, word) OR/ANDNOT masks that one
scatter applies to a copy of each touched block (16 bytes per touched
(slot, word) cross PCIe, not the stack), and new rows append slots in
place. A
touched compressed block decays to dense on the device. Otherwise the
stack is **rebuilt** from the host planes. ``UPLOAD_STATS`` counts every
stack upload, ``ADVANCE_STATS`` the advances, builds and mask bytes.
Stacks built or advanced inside a write request are not published
(``storage/txn.py``).

**The engine mesh** (``parallel/mesh.py``). When the stack's device is
the engine mesh's first position and the mesh has more positions, every
block and BSI stack is uploaded by ``engine_put`` as a
:class:`~pilosa_tpu_torch.parallel.split.Split` of one block per
position along ``S*W``, and stays dense (the ``mesh`` rule of
``ctiles``; forced compression yields to the placement here). The budget
charges the summed bytes of the blocks; an advance scatters a touched
word into the block that holds it, at its local offset, and copies only
the touched blocks. The mesh epoch leads every version vector.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.tracing import get_tracer
from pilosa_tpu_torch.ops import bitmap as bitops
from pilosa_tpu_torch.ops import bsi as bsiops
from pilosa_tpu_torch.ops import ctiles
from pilosa_tpu_torch.ops import topk as topkops
from pilosa_tpu_torch.parallel import mesh as meshmod
from pilosa_tpu_torch.parallel.split import Split
from pilosa_tpu_torch.shardwidth import BITS_PER_WORD, WORDS_PER_SHARD
from pilosa_tpu_torch.storage.txn import in_write_qcx

_MIN_SLOTS = 8

#: host -> device uploads of whole stacks or blocks (count, bytes); the
#: advance path must not bump these
UPLOAD_STATS = {"count": 0, "bytes": 0}
#: version misses served by an advance or by a (re)build, and the mask
#: scatters of the advances with the bytes they moved to the device
ADVANCE_STATS = {"advanced": 0, "built": 0, "scatters": 0, "mask_bytes": 0}
#: set-block builds from the host planes (BSI stacks are not counted, as
#: in the JAX package), budget evictions, and lazy builds that found their
#: fragments newer than the stack's snapshot (``Holder.residency_stats`` reads them, as in the JAX package)
PAGING_STATS = {"block_builds": 0, "evictions": 0, "stale_retries": 0}

#: a resident entry: a dense device tensor (split over the engine mesh
#: or not) or a compressed-tile block
Block = Union[torch.Tensor, Split, ctiles.CompressedBlock]


def _dense(blk: Block) -> torch.Tensor:
    """A resident entry as a dense device tensor (decoded when
    compressed)."""
    if isinstance(blk, ctiles.CompressedBlock):
        return blk.decode()
    return blk


def _row(blk: Block, i: int) -> torch.Tensor:
    """Row ``i`` of a resident entry (only that row decoded when
    compressed)."""
    if isinstance(blk, ctiles.CompressedBlock):
        return blk.decode(rows=[i])[0]
    return blk[i]


def _take(blk: Block, slots: Sequence[int]) -> torch.Tensor:
    """Rows ``slots`` of a resident entry as a new dense ``[len, S*W]``
    tensor (only those rows decoded when compressed)."""
    if isinstance(blk, ctiles.CompressedBlock):
        return blk.decode(rows=slots)
    idx = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                          device=blk.device)
    return blk.index_select(0, idx)


def _upload(host: np.ndarray, device: torch.device, kind: str) -> Block:
    """Upload an assembled block, compressed when the policy says so,
    else in the engine placement (split over the engine mesh or on
    ``device``), counted in ``UPLOAD_STATS`` (the stored bytes of a
    compressed one). ``kind`` (``set`` | ``bsi``) labels the compression
    metrics."""
    sharding = meshmod.engine_sharding(host.ndim, host.shape[-1], device)
    blk = None
    if sharding is None or not ctiles.forced():
        blk = ctiles.maybe_compress(host, device, kind)
    if blk is None:
        blk = meshmod.engine_put(host, device, sharding)
    UPLOAD_STATS["count"] += 1
    UPLOAD_STATS["bytes"] += _nbytes(blk)
    return blk


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
        self._lock = locktrace.tracked_lock("core.stacked.budget")
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
                PAGING_STATS["evictions"] += 1
                M.REGISTRY.count(M.METRIC_DEVICE_STACK_EVICTIONS)
                M.REGISTRY.count(M.METRIC_DEVICE_BUDGET_EVICTIONS)
                cb()
            self._publish()

    def touch(self, key: Tuple) -> None:
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)

    def release(self, key: Tuple) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self.used -= old[0]
                self._publish()

    def _publish(self) -> None:
        """The resident-bytes gauges, set on every charge and release as
        the JAX package sets them (``self._lock`` held)."""
        M.REGISTRY.gauge(M.METRIC_DEVICE_HBM_RESIDENT_BYTES, self.used)
        M.REGISTRY.gauge(M.METRIC_DEVICE_BUDGET_RESIDENT_BYTES, self.used)

    def bytes_of(self, serials) -> int:
        """Resident bytes of the entries of the stacks ``serials``."""
        serials = set(serials)
        with self._lock:
            return sum(b for (serial, _bi), (b, _) in self._lru.items()
                       if serial in serials)

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

    Unpaged stacks (cap fits one block) build eagerly; paged stacks build
    blocks lazily and stream them. Each block is resident dense or
    compressed."""

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
        self._built_vers = _frag_versions(fragments)
        self._blocks: List[Optional[Block]] = (
            [None] * (self.cap // self.block_rows))
        self._lock = _stack_lock()
        # a stack of a write request is never published: it charges no
        # budget entry (storage/txn.py)
        self.ephemeral = False
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

    def _build_block_host(self, bi: int) -> Block:
        """Assemble block ``bi`` from the host fragment planes and upload
        it (compressed when the policy says so, dense otherwise). Caller
        has validated the version snapshot or holds the writer lock
        through the build. The ``stack.build`` span covers the host
        assembly and the upload: a warm resident query has none."""
        lo_slot = bi * self.block_rows
        with get_tracer().start_span(
                "stack.build", block=bi,
                rows=min(self.block_rows, len(self.row_ids) - lo_slot),
                words=self.total_words):
            PAGING_STATS["block_builds"] += 1
            return _upload(self._assemble_host(bi), self.device, "set")

    def _assemble_host(self, bi: int) -> np.ndarray:
        """Block ``bi`` as the host fragment planes hold it now, in this
        stack's slot order: what a rebuild would upload."""
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
        return host

    def _ensure_block(self, bi: int) -> Block:
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
                    PAGING_STATS["stale_retries"] += 1
                    raise StackStale(
                        "fragment advanced past the stack snapshot")
            blk = self._build_block_host(bi)
            self._blocks[bi] = blk
        if not self.ephemeral:
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
        """(start_slot, dense device block) over all blocks, built on
        demand; compressed blocks decode on the device, one at a time."""
        for bi in range(self.n_blocks):
            yield bi * self.block_rows, _dense(self._ensure_block(bi))

    @property
    def planes(self) -> torch.Tensor:
        """The full dense ``[cap, S*W]`` tensor; only unpaged stacks have
        one."""
        if self.paged:
            raise AssertionError(
                "paged stack has no single tensor; use iter_blocks()")
        return _dense(self._ensure_block(0))

    # -- reads ----------------------------------------------------------------

    def zero_plane(self) -> torch.Tensor:
        return meshmod.engine_zeros(self.total_words, self.device)

    def row_plane(self, row: int) -> torch.Tensor:
        """Device ``[S*W]`` plane of one row id (zeros when absent); a
        point read touches exactly one block."""
        slot = self.row_index.get(row)
        if slot is None:
            return self.zero_plane()
        return _row(self._ensure_block(slot // self.block_rows),
                    slot % self.block_rows)

    def take_rows(self, rows: Sequence[int]) -> torch.Tensor:
        """Device ``[len(rows), S*W]`` gather of the given row ids (zero
        planes for absent rows), assembled block by block."""
        by_block: Dict[int, Tuple[List[int], List[int]]] = {}
        missing = False
        for i, r in enumerate(rows):
            slot = self.row_index.get(r)
            if slot is None:
                missing = True
                continue
            dst, src = by_block.setdefault(slot // self.block_rows, ([], []))
            dst.append(i)
            src.append(slot % self.block_rows)
        if len(by_block) == 1 and not missing:
            bi, (dst, src) = next(iter(by_block.items()))
            order = np.argsort(dst)
            return _take(self._ensure_block(bi), np.asarray(src)[order])
        out = _zeros_rows(len(rows), self.total_words, self.device)
        for bi, (dst, src) in by_block.items():
            idx = torch.as_tensor(np.asarray(dst, dtype=np.int64),
                                  device=self.device)
            out.index_copy_(0, idx, _take(self._ensure_block(bi), src))
        return out

    def rows_plane(self, rows: Sequence[int]) -> torch.Tensor:
        """OR of several rows' planes (UnionRows), streamed per block;
        rows without a slot add nothing."""
        by_block: Dict[int, List[int]] = {}
        for r in rows:
            slot = self.row_index.get(r)
            if slot is not None:
                by_block.setdefault(slot // self.block_rows, []).append(
                    slot % self.block_rows)
        acc = None
        for bi, slots in sorted(by_block.items()):
            part = bitops.rows_or(_take(self._ensure_block(bi), slots))
            acc = part if acc is None else acc | part
        return self.zero_plane() if acc is None else acc

    def row_counts(self, filt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Device ``[cap]`` per-slot popcounts (optionally filtered),
        streamed per block: a dense block through the pair_counts kernel,
        the compressed ones through the tile-skipping ctile_count scan
        (reference: fragment.go:1317 top counts).

        Compressed blocks are gathered and counted together into one
        zeroed output by one ``ctiles.ctile_count_blocks`` call, which
        splits them into launches. Building a block may evict an earlier
        one of this stack from the budget; the gathered group, which
        still holds it, is then counted first, so no evicted block stays
        alive past the next count."""
        out: Optional[torch.Tensor] = None
        group: List[ctiles.CompressedBlock] = []
        slots: List[int] = []  # the group's block indices
        dense: List[Tuple[int, torch.Tensor]] = []

        def launch() -> None:
            nonlocal out
            if not group:
                return
            if out is None:
                out = torch.zeros(self.cap, dtype=torch.int32,
                                  device=self.device)
            ctiles.ctile_count_blocks(
                group, filt, out, [bi * self.block_rows for bi in slots])
            group.clear()
            slots.clear()

        for bi in range(self.n_blocks):
            blk = self._ensure_block(bi)
            if any(self._blocks[gi] is not g for gi, g in zip(slots, group)):
                launch()  # a gathered block was evicted meanwhile
            if isinstance(blk, ctiles.CompressedBlock):
                group.append(blk)
                slots.append(bi)
            else:
                dense.append((bi, topkops.row_counts(blk, filt)))
        launch()
        if out is None:  # every block dense
            parts = [c for _, c in dense]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        for bi, counts in dense:
            out[bi * self.block_rows:(bi + 1) * self.block_rows] = counts
        return out


class StackedBSI:
    """BSI plane stacks across shards: ``int32[2+depth, S*W]`` on the device.

    Shards shallower than the deepest member are zero-padded (a zero
    magnitude plane adds nothing to a compare or a sum). The stack is
    resident dense or compressed, budget-charged and evictable: an
    evicted one rebuilds lazily on the next touch with the same version
    check as a set block (a write since the snapshot raises
    :class:`StackStale`)."""

    def __init__(self, shards: Sequence[int], fragments,
                 device: torch.device, words: int = WORDS_PER_SHARD,
                 write_lock=None):
        self.shards = tuple(shards)
        self.words = words
        self.device = device
        self.total_words = len(self.shards) * words
        self.depth = max([f.depth for f in fragments if f is not None]
                         or [1])
        self.serial = next(_stack_serial)
        self._write_lock = (write_lock if write_lock is not None
                            else contextlib.nullcontext())
        self._lock = _stack_lock()
        self.ephemeral = False
        self._fragments = list(fragments)
        self._built_vers = _frag_versions(fragments)
        self._planes: Optional[Block] = self._build_host()
        self._charge()

    def _build_host(self) -> Block:
        with get_tracer().start_span(
                "stack.build", kind="bsi", planes=bsiops.OFFSET + self.depth,
                words=self.total_words):
            return _upload(self._assemble_host(), self.device, "bsi")

    def _assemble_host(self) -> np.ndarray:
        """The stack as the host fragment planes hold it now."""
        host = np.zeros((bsiops.OFFSET + self.depth, self.total_words),
                        dtype=np.uint32)
        for si, frag in enumerate(self._fragments):
            if frag is not None:
                lo = si * self.words
                host[: frag.planes.shape[0], lo:lo + self.words] = frag.planes
        return host

    def _charge(self) -> None:
        blk = self._planes
        if blk is not None and not self.ephemeral:
            BUDGET.charge((self.serial, 0), _nbytes(blk),
                          lambda s=self: s._drop())

    def _drop(self) -> None:
        self._planes = None

    def release_device(self) -> None:
        BUDGET.release((self.serial, 0))

    def _entry(self) -> Block:
        """The resident entry (dense tensor or compressed block), rebuilt
        under the writer lock with the version check when it was
        evicted."""
        blk = self._planes
        if blk is not None:
            BUDGET.touch((self.serial, 0))
            return blk
        with self._write_lock, self._lock:
            blk = self._planes
            if blk is None:
                if _frag_versions(self._fragments) != self._built_vers:
                    PAGING_STATS["stale_retries"] += 1
                    raise StackStale(
                        "fragment advanced past the stack snapshot")
                blk = self._planes = self._build_host()
        self._charge()
        return blk

    @property
    def planes(self) -> torch.Tensor:
        """The dense ``[2+depth, S*W]`` tensor (decoded, uncached, when
        the stack is resident compressed)."""
        return _dense(self._entry())

    def compare(self, op: str, value: int,
                value2: Optional[int] = None) -> torch.Tensor:
        """Range compare over the stack (stored-space constants). A
        compressed stack narrows the scan to its active tiles."""
        blk = self._entry()
        if isinstance(blk, ctiles.CompressedBlock):
            return ctiles.bsi_compare_compressed(blk, op, value, value2)
        return bsiops.bsi_compare(blk, op, value, value2)

    def exists_plane(self) -> torch.Tensor:
        return _row(self._entry(), bsiops.EXISTS)


def _nbytes(blk: Block) -> int:
    """Bytes a resident entry holds: the stored bytes of a compressed
    block (the JAX package's ``nbytes``) plus its list of non-zero
    constants, never its decoded size; a split block's summed over its
    blocks."""
    if isinstance(blk, ctiles.CompressedBlock):
        return blk.nbytes + blk.nz_nbytes
    return blk.numel() * blk.element_size()


def _zeros_rows(rows: int, words: int, device: torch.device):
    """A new zeroed ``int32[rows, words]`` in the engine placement of
    ``device``'s stacks."""
    sh = meshmod.placement(words, device)
    if sh is None:
        return torch.zeros((rows, words), dtype=torch.int32, device=device)
    return Split([torch.zeros((rows, sh.width), dtype=torch.int32, device=d)
                  for d in sh.devices], sh.mesh)


def _stack_lock():
    """A stack's own lock. A block evicted from the budget is rebuilt
    under it, upload included, so that two readers build it once
    (dispatch_ok)."""
    return locktrace.tracked_lock("core.stacked.stack", dispatch_ok=True)


def _frag_versions(fragments) -> Tuple:
    """Each fragment's version, -1 when absent: a stack's snapshot."""
    return tuple(-1 if f is None else f.version for f in fragments)


def _versions(fragments) -> Tuple:
    """The cache key's versions: the mesh epoch, then the snapshot. A
    mesh switch misses every cached stack and rebuilds it under the new
    placement, as in the JAX package
    (``pilosa_tpu/core/stacked.py:588-594``)."""
    return (meshmod.mesh_epoch(),) + _frag_versions(fragments)


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
            M.REGISTRY.count(M.METRIC_DEVICE_RESIDENT_HITS)
            return hit[1]
        return None


def _cache_peek(field, group, subset):
    """The latest (versions, stack) of a subset whatever its versions:
    the base an advance replays the write deltas onto."""
    with _LOCK:
        inner = getattr(field, "_stacked_cache", {}).get(group)
        return None if inner is None else inner.get(subset)


def _cache_put(field, group, subset, vers, built) -> None:
    if in_write_qcx():
        # built or advanced inside a write request: not published, or a
        # lock-free reader could see the request's intermediate state.
        # The stack dies with the request, so it gives back its budget
        # entries and charges no more
        built.ephemeral = True
        built.release_device()
        return
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


def release_field_cache(field) -> None:
    """Drop a field's cached stacks and their budget entries (the next
    read rebuilds from the host planes)."""
    with _LOCK:
        cache = getattr(field, "_stacked_cache", None)
        field._stacked_cache = {}
    for inner in (cache or {}).values():
        for _, stack in inner.values():
            stack.release_device()


def holder_resident_bytes(holder) -> int:
    """Device bytes the budget holds for a holder's cached stacks."""
    serials = set()
    with _LOCK:
        for idx in holder.indexes.values():
            for field in idx.fields.values():
                for inner in getattr(field, "_stacked_cache", {}).values():
                    serials.update(st.serial for _, st in inner.values())
    return BUDGET.bytes_of(serials)


# ---------------------------------------------------------------------------
# The advance: replay the fragments' write deltas onto a cached stack
# (reference: SURVEY.md section 7, "Mutability on device").
# ---------------------------------------------------------------------------


def _apply_bit_deltas(planes: torch.Tensor, slots: torch.Tensor,
                      words: torch.Tensor, orm: torch.Tensor,
                      anm: torch.Tensor, fresh: bool = False
                      ) -> torch.Tensor:
    """``planes[slots, words] = (cur & ~anm) | orm`` on a **new** tensor:
    a lock-free reader may still hold the old stack, whose tensor must
    keep its answers. ``fresh`` says ``planes`` is already a private copy
    (decoded or grown) and may be written. Index and mask tensors are
    ``int32`` (masks with the host ``uint32`` bit patterns), on the
    planes' device; each (slot, word) appears once."""
    out = planes if fresh else planes.clone()
    cur = out[slots, words]
    out.index_put_((slots, words), (cur & ~anm) | orm)
    return out


def _grow_rows_device(planes, new_rows: int):
    """``planes`` with ``new_rows`` zero slots appended, on the device
    (on each block of a split)."""
    def grow(p):
        return torch.nn.functional.pad(p, (0, 0, 0, new_rows))

    if isinstance(planes, Split):
        return planes.map(grow)
    return grow(planes)


class _MaskAccum:
    """Ordered collapse of bit writes into per-(slot, word) masks: a set
    then a clear of one bit leaves it clear, and the reverse set."""

    def __init__(self):
        self.masks: Dict[Tuple[int, int], List[int]] = {}

    def set(self, slot: int, word: int, bit: int) -> None:
        e = self.masks.setdefault((slot, word), [0, 0])
        m = 1 << bit
        e[0] |= m
        e[1] &= ~m

    def clear(self, slot: int, word: int, bit: int) -> None:
        e = self.masks.setdefault((slot, word), [0, 0])
        m = 1 << bit
        e[1] |= m
        e[0] &= ~m

    def touches(self, lo_slot: int, hi_slot: int) -> bool:
        return any(lo_slot <= k[0] < hi_slot for k in self.masks)

    def apply(self, planes, lo_slot: int = 0,
              hi_slot: Optional[int] = None, fresh: bool = False):
        """Scatter the masks whose slot lies in [lo_slot, hi_slot) onto
        ``planes`` (slots rebased by lo_slot): one H2D copy of the packed
        slots, words and masks, then :func:`_apply_bit_deltas`.
        ``planes`` itself comes back when no mask falls in the range. On
        a split, each word goes to the block that holds it, at its local
        offset: one scatter per touched block, and the untouched blocks
        are shared with ``planes`` (no copy)."""
        if hi_slot is None:
            hi_slot = lo_slot + planes.shape[0]
        keys = [k for k in self.masks if lo_slot <= k[0] < hi_slot]
        if not keys:
            return planes
        if isinstance(planes, Split):
            blocks = list(planes.blocks)
            for bi, (off, blk) in enumerate(zip(planes.offsets(), blocks)):
                mine = [k for k in keys if off <= k[1] < off + blk.shape[-1]]
                if mine:
                    blocks[bi] = self._scatter(blk, mine, lo_slot, off,
                                               fresh)
            return planes.like(blocks)
        return self._scatter(planes, keys, lo_slot, 0, fresh)

    def _scatter(self, planes: torch.Tensor, keys, lo_slot: int,
                 lo_word: int, fresh: bool) -> torch.Tensor:
        packed = np.empty((4, len(keys)), dtype=np.uint32)
        for i, k in enumerate(keys):
            packed[0, i] = k[0] - lo_slot
            packed[1, i] = k[1] - lo_word
            packed[2, i], packed[3, i] = self.masks[k]
        dev = platform.h2d_copy(packed, planes.device)
        ADVANCE_STATS["scatters"] += 1
        ADVANCE_STATS["mask_bytes"] += packed.nbytes
        return _apply_bit_deltas(planes, dev[0], dev[1], dev[2], dev[3],
                                 fresh=fresh)


def _restamp(stack, fragments) -> None:
    """The versions moved with no net delta: take the new versions as
    the stack's snapshot (caller holds the writer lock), so a lazy
    rebuild of an evicted block raises no spurious StackStale."""
    stack._fragments = list(fragments)
    stack._built_vers = _frag_versions(fragments)


def _advance_set(stack: StackedSet, fragments, built_vers
                 ) -> Optional[StackedSet]:
    """Replay the pending writes onto a cached StackedSet; None means
    rebuild. Caller holds the writer lock (fragment versions are still)."""
    acc = _MaskAccum()
    new_rows: List[int] = []
    new_index: Dict[int, int] = {}

    def slot_of(row: int) -> int:
        s = stack.row_index.get(row)
        if s is None:
            s = new_index.get(row)
        if s is None:  # an appended row takes the next slot in place
            s = new_index[row] = len(stack.row_ids) + len(new_rows)
            new_rows.append(row)
        return s

    for si, (frag, built_v) in enumerate(zip(fragments, built_vers)):
        if frag is None:
            if built_v != -1:
                return None  # the fragment vanished
            continue
        if built_v == frag.version:
            continue
        if built_v < 0:
            return None  # the fragment appeared after the build
        ops = frag.deltas.since(built_v, frag.version)
        if ops is None:
            return None
        lo = si * stack.words
        for row, set_cols, clear_cols in ops:
            slot = slot_of(row)
            for col in set_cols:
                w, b = divmod(col, BITS_PER_WORD)
                acc.set(slot, lo + w, b)
            for col in clear_cols:
                w, b = divmod(col, BITS_PER_WORD)
                acc.clear(slot, lo + w, b)
    if not acc.masks and not new_rows:
        _restamp(stack, fragments)
        return stack
    new = StackedSet.__new__(StackedSet)
    new.shards, new.words, new.device = stack.shards, stack.words, stack.device
    new.total_words = stack.total_words
    new.serial = next(_stack_serial)
    new.block_rows = stack.block_rows
    new._lock = _stack_lock()
    new._write_lock = stack._write_lock
    new.ephemeral = False
    _restamp(new, fragments)
    new.row_ids = stack.row_ids + new_rows if new_rows else stack.row_ids
    new.row_index = stack.row_index
    if new_rows:
        new.row_index = dict(stack.row_index)
        new.row_index.update(new_index)
    if not stack.paged:
        # grow the one block on the device while it fits; outgrowing it
        # means a rebuild in paged form
        need = _pow2(len(new.row_ids))
        if need * stack.total_words * 4 > _BLOCK_BYTES:
            return None
        new.block_rows = max(stack.block_rows, need)
        new.cap = new.block_rows
        new.paged = False
        blk = stack._blocks[0]
        if blk is None:
            return None  # evicted: rebuild from the host
        # a written compressed block decays to dense (decoded on the
        # device, a fresh tensor); the next rebuild recompresses
        fresh = isinstance(blk, ctiles.CompressedBlock)
        blk = _dense(blk)
        if new.cap > stack.cap:
            blk = _grow_rows_device(blk, new.cap - stack.cap)
            fresh = True
        blk = acc.apply(blk, 0, new.cap, fresh=fresh)
        # assign before the charge: an eviction cascade may call new's
        # own callback, which reads _blocks
        new._blocks = [blk]
        BUDGET.charge((new.serial, 0), _nbytes(blk),
                      lambda s=new: s._drop_block(0))
        return new
    # paged: block_rows is fixed and appends extend the lazy block list.
    # Only resident blocks take the masks: a block built later reads the
    # host planes at new's versions
    new.cap = max(stack.cap, -(-len(new.row_ids) // stack.block_rows)
                  * stack.block_rows)
    new.paged = True
    blocks = list(stack._blocks)
    blocks.extend([None] * (new.cap // new.block_rows - len(blocks)))
    for bi, blk in enumerate(blocks):
        if blk is None:
            continue
        lo_slot = bi * new.block_rows
        hi_slot = lo_slot + new.block_rows
        fresh = False
        if isinstance(blk, ctiles.CompressedBlock):
            if not acc.touches(lo_slot, hi_slot):
                continue  # untouched: stays compressed
            blk, fresh = blk.decode(), True  # touched: decays to dense
        blocks[bi] = acc.apply(blk, lo_slot, hi_slot, fresh=fresh)
    new._blocks = blocks  # before any charge, as above
    for bi, blk in enumerate(blocks):
        if blk is not None:
            BUDGET.charge((new.serial, bi), _nbytes(blk),
                          lambda s=new, i=bi: s._drop_block(i))
    return new


def _advance_bsi(stack: StackedBSI, fragments, built_vers
                 ) -> Optional[StackedBSI]:
    """Replay the pending BSI writes onto a cached StackedBSI; None means
    rebuild. A set clears every plane of its column, then sets EXISTS,
    SIGN and the magnitude bits; a clear clears every plane."""
    # the raw entry: ``planes`` would rebuild an evicted one at the old
    # snapshot and raise StackStale; evicted means rebuild
    base = stack._planes
    if base is None:
        return None
    n_planes = bsiops.OFFSET + stack.depth
    acc = _MaskAccum()
    for si, (frag, built_v) in enumerate(zip(fragments, built_vers)):
        if frag is None:
            if built_v != -1:
                return None
            continue
        if built_v == frag.version:
            continue
        if built_v < 0:
            return None
        if frag.planes.shape[0] > n_planes:
            return None  # deeper than the stack: a rebuild widens it
        ops = frag.deltas.since(built_v, frag.version)
        if ops is None:
            return None
        lo = si * stack.words
        for op in ops:
            if op[0] == "set":
                _, cols, values = op
            else:
                cols, values = (op[1],), (None,)
            for col, val in zip(cols, values):
                w, b = divmod(col, BITS_PER_WORD)
                for p in range(n_planes):  # the old value, cleared
                    acc.clear(p, lo + w, b)
                if val is None:
                    continue
                acc.set(bsiops.EXISTS, lo + w, b)
                if val < 0:
                    acc.set(bsiops.SIGN, lo + w, b)
                mag, k = abs(val), 0
                while mag:
                    if mag & 1:
                        acc.set(bsiops.OFFSET + k, lo + w, b)
                    mag >>= 1
                    k += 1
    if not acc.masks:
        _restamp(stack, fragments)
        return stack
    new = StackedBSI.__new__(StackedBSI)
    new.shards, new.words, new.device = stack.shards, stack.words, stack.device
    new.total_words = stack.total_words
    new.depth = stack.depth
    new.serial = next(_stack_serial)
    new._write_lock = stack._write_lock
    new._lock = _stack_lock()
    new.ephemeral = False
    _restamp(new, fragments)
    # a compressed stack decays to dense: decoded on the device, fresh
    fresh = isinstance(base, ctiles.CompressedBlock)
    new._planes = acc.apply(_dense(base), fresh=fresh)
    new._charge()
    return new


def _writer_lock(field):
    lock = getattr(field, "write_lock", None)
    return lock if lock is not None else contextlib.nullcontext()


def _advance_or_rebuild(field, group, subset, vers, fragments, advance,
                        rebuild):
    """On a version miss: replay the write deltas onto the latest cached
    stack of the subset, else build it from the host planes. Caller
    holds the writer lock."""
    stale = _cache_peek(field, group, subset)
    built = None
    if stale is not None and stale[0][0] == vers[0]:  # same mesh epoch
        built = advance(stale[1], fragments, stale[0][1:])
        if built is stale[1] and in_write_qcx():
            ADVANCE_STATS["advanced"] += 1
            return built  # re-stamped, and still the published stack
    if built is None:
        built = rebuild()
        ADVANCE_STATS["built"] += 1
    else:
        ADVANCE_STATS["advanced"] += 1
    _cache_put(field, group, subset, vers, built)
    return built


def stacked_set(field, shards: Sequence[int], view: str) -> StackedSet:
    """Build, advance or reuse the stacked view of ``field``'s ``view``
    fragments.

    A cache hit is lock-free (a cached stack is never written); a miss
    walks live host planes, so the fetch, version snapshot and advance or
    build run under the writer lock."""
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
            hit = _advance_or_rebuild(
                field, group, subset, vers, fragments, _advance_set,
                lambda: StackedSet(shards, fragments, field.device,
                                   write_lock=_writer_lock(field)))
    return hit


def stacked_bsi(field, shards: Sequence[int]) -> StackedBSI:
    """Build, advance or reuse the BSI stack of ``field`` over
    ``shards``, cached like :func:`stacked_set` (a field without BSI
    fragments stacks as one all-zero plane of depth 1, as in the JAX
    package)."""
    group, subset = ("bsi",), tuple(shards)
    fragments = [field.bsi_fragment(s) for s in shards]
    hit = _cache_get(field, group, subset, _versions(fragments))
    if hit is not None:
        return hit
    with _writer_lock(field):
        fragments = [field.bsi_fragment(s) for s in shards]
        vers = _versions(fragments)
        hit = _cache_get(field, group, subset, vers)
        if hit is None:
            hit = _advance_or_rebuild(
                field, group, subset, vers, fragments, _advance_bsi,
                lambda: StackedBSI(shards, fragments, field.device,
                                   write_lock=_writer_lock(field)))
    return hit

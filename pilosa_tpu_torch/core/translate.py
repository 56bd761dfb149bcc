"""Key translation: string keys <-> uint64 IDs, host-side.

Port of ``pilosa_tpu/core/translate.py``: strings never reach the device
— IDs flow in, IDs flow out, translation happens on the host around
kernel launches (reference: executor.go:6814 preTranslate / :7519
translateResults). A store with a path keeps an append-only journal of
``[key, id]`` JSON lines (the BoltDB analog), in the JAX package's
format, and replays it on open. The partitioned record-key allocator
keeps the same ID scheme as the JAX package, so both packages hand out
identical IDs for the same keys.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.hashing import key_to_partition, shard_to_partition
from pilosa_tpu_torch.shardwidth import DEFAULT_PARTITION_N, SHARD_WIDTH


def _read_journal(path: Optional[str]):
    """The ``(key, id)`` pairs of a journal, in file order."""
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        return [tuple(json.loads(line)) for line in f if line.strip()]


def _append_journal(path: Optional[str], pairs: List) -> None:
    if not path or not pairs:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        for key, id_ in pairs:
            f.write(json.dumps([key, id_]) + "\n")


def _rewrite_journal(path: Optional[str], key_to_id: Dict[str, int]) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for key, id_ in sorted(key_to_id.items(), key=lambda kv: kv[1]):
            f.write(json.dumps([key, id_]) + "\n")


class TranslateStore:
    """One key<->id namespace (an index's record keys, or a field's row
    keys). IDs are allocated sequentially from ``start``; field stores
    pass start=1 because the reference reserves row id 0 as invalid."""

    def __init__(self, path: Optional[str] = None, start: int = 0):
        self._path = path
        self._start = start
        self._next = start
        self._lock = threading.Lock()
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}
        for key, id_ in _read_journal(path):
            self.key_to_id[key] = id_
            self.id_to_key[id_] = key
            self._next = max(self._next, id_ + 1)

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return self.create_entries(keys)[0]

    def create_entries(self, keys: Iterable[str]
                       ) -> Tuple[Dict[str, int], List]:
        """Find-or-create ids; also returns the newly allocated (key, id)
        pairs, the replication stream's payload (reference:
        cluster.go:233 createIndexKeys + translate.go EntryReader)."""
        out: Dict[str, int] = {}
        new: List = []
        with self._lock:
            for k in keys:
                id_ = self.key_to_id.get(k)
                if id_ is None:
                    id_ = self._next
                    self._next += 1
                    self.key_to_id[k] = id_
                    self.id_to_key[id_] = k
                    new.append((k, id_))
                out[k] = id_
            _append_journal(self._path, new)
        return out, new

    def apply_entries(self, entries: Iterable) -> None:
        """Apply replicated (key, id) pairs from the primary (reference:
        the follower side of TranslationSyncer / EntryReader,
        translate.go). Idempotent; advances the allocator past every
        applied id, so a promoted replica allocates ids that do not
        conflict."""
        with self._lock:
            fresh = []
            for k, id_ in entries:
                id_ = int(id_)
                if self.key_to_id.get(k) == id_:
                    continue
                self.key_to_id[k] = id_
                self.id_to_key[id_] = k
                self._next = max(self._next, id_ + 1)
                fresh.append((k, id_))
            _append_journal(self._path, fresh)

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return {k: self.key_to_id[k] for k in keys if k in self.key_to_id}

    def translate_ids(self, ids: Iterable[int]) -> Dict[int, str]:
        return {i: self.id_to_key[i] for i in ids if i in self.id_to_key}

    def replace_all(self, key_to_id: Dict[str, int]) -> None:
        """Replace the whole mapping and rewrite the journal (restore,
        state loading)."""
        with self._lock:
            self.key_to_id = {k: int(i) for k, i in key_to_id.items()}
            self.id_to_key = {i: k for k, i in self.key_to_id.items()}
            self._next = max([i + 1 for i in self.id_to_key] + [self._start])
            _rewrite_journal(self._path, self.key_to_id)


class PartitionedTranslateStore:
    """Record-key store partitioned as the reference partitions its
    stores (translate_boltdb.go:69 + disco/snapshot.go:87): a key belongs
    to partition fnv64a(index||key)%N, and its ID is chosen so the ID's
    *shard* hashes back to the same partition (reference: translate.go:103
    GenerateNextPartitionedID)."""

    def __init__(self, index: str, path: Optional[str] = None,
                 partition_n: int = DEFAULT_PARTITION_N):
        self._index = index
        self._path = path
        self._partition_n = partition_n
        self._lock = threading.Lock()
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}
        self._max_id: Dict[int, int] = {}  # partition -> max allocated id
        for key, id_ in _read_journal(path):
            self.key_to_id[key] = id_
            self.id_to_key[id_] = key
            p = self.partition(key)
            self._max_id[p] = max(self._max_id.get(p, 0), id_)

    def partition(self, key: str) -> int:
        return key_to_partition(self._index, key, self._partition_n)

    def _next_partitioned_id(self, partition: int) -> int:
        """Reference: translate.go:111 — walk forward by shard until the
        shard's partition matches; IDs start at 1 (0 stays invalid)."""
        id_ = self._max_id.get(partition, 0) + 1
        while True:
            if shard_to_partition(self._index, id_ // SHARD_WIDTH,
                                  self._partition_n) != partition:
                id_ += SHARD_WIDTH
            elif id_ in self.id_to_key:
                id_ += 1
            else:
                return id_

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return self.create_entries(keys)[0]

    def create_entries(self, keys: Iterable[str]
                       ) -> Tuple[Dict[str, int], List]:
        """Find-or-create with the new (key, id) pairs for the
        replication stream (see TranslateStore.create_entries)."""
        out: Dict[str, int] = {}
        new: List = []
        with self._lock:
            for k in keys:
                id_ = self.key_to_id.get(k)
                if id_ is None:
                    p = self.partition(k)
                    id_ = self._next_partitioned_id(p)
                    self._max_id[p] = id_
                    self.key_to_id[k] = id_
                    self.id_to_key[id_] = k
                    new.append((k, id_))
                out[k] = id_
            _append_journal(self._path, new)
        return out, new

    def apply_entries(self, entries: Iterable) -> None:
        """Follower side of the replication stream (see
        TranslateStore.apply_entries); advances the per-partition max ids
        so a promoted replica keeps the partitioned-id invariant."""
        with self._lock:
            fresh = []
            for k, id_ in entries:
                id_ = int(id_)
                if self.key_to_id.get(k) == id_:
                    continue
                self.key_to_id[k] = id_
                self.id_to_key[id_] = k
                p = self.partition(k)
                self._max_id[p] = max(self._max_id.get(p, 0), id_)
                fresh.append((k, id_))
            _append_journal(self._path, fresh)

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return {k: self.key_to_id[k] for k in keys if k in self.key_to_id}

    def translate_ids(self, ids: Iterable[int]) -> Dict[int, str]:
        return {i: self.id_to_key[i] for i in ids if i in self.id_to_key}

    def replace_all(self, key_to_id: Dict[str, int]) -> None:
        """Replace the whole mapping and rewrite the journal (restore,
        state loading)."""
        with self._lock:
            self.key_to_id = {k: int(i) for k, i in key_to_id.items()}
            self.id_to_key = {i: k for k, i in self.key_to_id.items()}
            self._max_id = {}
            for k, id_ in self.key_to_id.items():
                p = self.partition(k)
                self._max_id[p] = max(self._max_id.get(p, 0), id_)
            _rewrite_journal(self._path, self.key_to_id)


def bulk_translate_ids(store, keys) -> np.ndarray:
    """Vectorized find-or-create: ONE create_keys round on the unique
    keys, mapped back through a lookup table (reference: batch.go:860
    doTranslation). Returns an ``np.int64`` array aligned with ``keys``."""
    arr = np.asarray(keys)
    uniq, inverse = np.unique(arr, return_inverse=True)
    uniq_l = [str(k) for k in uniq.tolist()]
    m = store.create_keys(uniq_l)
    lut = np.array([m[k] for k in uniq_l], dtype=np.int64)
    return lut[inverse]

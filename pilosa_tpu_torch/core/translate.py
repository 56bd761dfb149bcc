"""Key translation: string keys <-> uint64 IDs, host-side, in memory.

Port of ``pilosa_tpu/core/translate.py`` without the journal: strings
never reach the device — IDs flow in, IDs flow out, translation happens
on the host around kernel launches (reference: executor.go:6814
preTranslate / :7519 translateResults). The partitioned record-key
allocator keeps the same ID scheme as the JAX package, so both packages
hand out identical IDs for the same keys.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Iterable

import numpy as np

from pilosa_tpu_torch.shardwidth import DEFAULT_PARTITION_N, SHARD_WIDTH

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def fnv64a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def shard_to_partition(index: str, shard: int,
                       partition_n: int = DEFAULT_PARTITION_N) -> int:
    """Reference: disco/snapshot.go:70 (fnv64a(index || be64(shard)) % N)."""
    return fnv64a(index.encode() + struct.pack(">Q", shard)) % partition_n


def key_to_partition(index: str, key: str,
                     partition_n: int = DEFAULT_PARTITION_N) -> int:
    """Reference: disco/snapshot.go:88 (fnv64a(index || key) % N)."""
    return fnv64a(index.encode() + key.encode()) % partition_n


class TranslateStore:
    """One key<->id namespace (an index's record keys, or a field's row
    keys). IDs are allocated sequentially from ``start``; field stores
    pass start=1 because the reference reserves row id 0 as invalid."""

    def __init__(self, start: int = 0):
        self._start = start
        self._next = start
        self._lock = threading.Lock()
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for k in keys:
                id_ = self.key_to_id.get(k)
                if id_ is None:
                    id_ = self._next
                    self._next += 1
                    self.key_to_id[k] = id_
                    self.id_to_key[id_] = k
                out[k] = id_
        return out

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return {k: self.key_to_id[k] for k in keys if k in self.key_to_id}

    def translate_ids(self, ids: Iterable[int]) -> Dict[int, str]:
        return {i: self.id_to_key[i] for i in ids if i in self.id_to_key}

    def replace_all(self, key_to_id: Dict[str, int]) -> None:
        """Replace the whole mapping (state loading, convert.py)."""
        with self._lock:
            self.key_to_id = {k: int(i) for k, i in key_to_id.items()}
            self.id_to_key = {i: k for k, i in self.key_to_id.items()}
            self._next = max([i + 1 for i in self.id_to_key] + [self._start])


class PartitionedTranslateStore:
    """Record-key store partitioned as the reference partitions its
    stores (translate_boltdb.go:69 + disco/snapshot.go:87): a key belongs
    to partition fnv64a(index||key)%N, and its ID is chosen so the ID's
    *shard* hashes back to the same partition (reference: translate.go:103
    GenerateNextPartitionedID)."""

    def __init__(self, index: str, partition_n: int = DEFAULT_PARTITION_N):
        self._index = index
        self._partition_n = partition_n
        self._lock = threading.Lock()
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}
        self._max_id: Dict[int, int] = {}  # partition -> max allocated id

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
        out: Dict[str, int] = {}
        with self._lock:
            for k in keys:
                id_ = self.key_to_id.get(k)
                if id_ is None:
                    p = self.partition(k)
                    id_ = self._next_partitioned_id(p)
                    self._max_id[p] = id_
                    self.key_to_id[k] = id_
                    self.id_to_key[id_] = k
                out[k] = id_
        return out

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        return {k: self.key_to_id[k] for k in keys if k in self.key_to_id}

    def translate_ids(self, ids: Iterable[int]) -> Dict[int, str]:
        return {i: self.id_to_key[i] for i in ids if i in self.id_to_key}

    def replace_all(self, key_to_id: Dict[str, int]) -> None:
        """Replace the whole mapping (state loading, convert.py)."""
        with self._lock:
            self.key_to_id = {k: int(i) for k, i in key_to_id.items()}
            self.id_to_key = {i: k for k, i in self.key_to_id.items()}
            self._max_id = {}
            for k, id_ in self.key_to_id.items():
                p = self.partition(k)
                self._max_id[p] = max(self._max_id.get(p, 0), id_)


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

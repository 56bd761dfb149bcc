"""Placement hashing: fnv64a partitioning + jump consistent hash.

Port of ``pilosa_tpu/hashing.py`` (reference: disco/snapshot.go:69
ShardToShardPartition, fnv64a over the index name's bytes then the
big-endian shard; :87 KeyToKeyPartition; disco/hasher.go:13 Jmphasher,
the Lamping-Veach jump consistent hash). Python ints masked to 64 bits,
as the JAX package computes them, so a cluster of either package places
every shard, partition and key on the same node. The one home of these
functions in the port: ``core/translate.py`` and ``cluster/`` import
them from here.
"""

from __future__ import annotations

import struct

from pilosa_tpu_torch.shardwidth import DEFAULT_PARTITION_N

__all__ = ["DEFAULT_PARTITION_N", "fnv64a", "jump_hash",
           "shard_to_partition", "key_to_partition"]

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def fnv64a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash: key -> bucket in [0, n) (reference:
    disco/hasher.go:16 Jmphasher.Hash; the float math is Go's 64-bit
    doubles, as Python's floats are)."""
    if n <= 0:
        return -1
    b, j = -1, 0
    key &= _MASK64
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def shard_to_partition(index: str, shard: int,
                       partition_n: int = DEFAULT_PARTITION_N) -> int:
    """Reference: disco/snapshot.go:70 (fnv64a(index || be64(shard)) % N)."""
    return fnv64a(index.encode() + struct.pack(">Q", shard)) % partition_n


def key_to_partition(index: str, key: str,
                     partition_n: int = DEFAULT_PARTITION_N) -> int:
    """Reference: disco/snapshot.go:88 (fnv64a(index || key) % N)."""
    return fnv64a(index.encode() + key.encode()) % partition_n

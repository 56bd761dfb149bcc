"""Re-export of the placement hashes (pilosa_tpu_torch/hashing.py).

Port of ``pilosa_tpu/cluster/hash.py``. The implementations live below
the core layer because the data model's partitioned key translation
needs them without dragging in the cluster package (core -> cluster
would invert the layering)."""

from pilosa_tpu_torch.hashing import (  # noqa: F401
    DEFAULT_PARTITION_N, fnv64a, jump_hash, key_to_partition,
    shard_to_partition,
)

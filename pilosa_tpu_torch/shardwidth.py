"""Shard geometry constants.

The column space is split into fixed-width shards of 2^20 columns
(reference: shardwidth/helper.go:14 ``ShardWidth = 1 << shardwidth.Exponent``
with Exponent=20). Every per-shard bitmap row ("row plane") is therefore
2^20 bits = 32768 32-bit words = 128 KiB. Copied from
``pilosa_tpu/shardwidth.py``: the port imports nothing of the JAX package.
"""

SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP  # 1_048_576 columns per shard

BITS_PER_WORD = 32
WORDS_PER_SHARD = SHARD_WIDTH // BITS_PER_WORD  # 32768 uint32 words per row plane

# Row-key partitioning for translation stores (reference: disco/snapshot.go:24
# DefaultPartitionN = 256).
DEFAULT_PARTITION_N = 256


def shard_of(col: int) -> int:
    """Shard containing absolute column id (reference: col / ShardWidth)."""
    return col >> SHARD_WIDTH_EXP


def pos_in_shard(col: int) -> int:
    """Offset of absolute column id within its shard."""
    return col & (SHARD_WIDTH - 1)

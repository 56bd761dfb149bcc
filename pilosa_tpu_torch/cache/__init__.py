"""Version-keyed query result cache with single-flight dedup.

Port of ``pilosa_tpu/cache/``. Repeated reads of unchanged fragments
skip the card entirely: a hit copies a host result and launches nothing.
Entries are keyed on (index, canonical PQL, frozen shard set, fragment
version fingerprint) so writes self-invalidate them — see keys.py for
the key scheme and result_cache.py for the LRU + single-flight core.
"""

from pilosa_tpu_torch.cache.keys import (is_cacheable, query_cache_key,
                                   shard_key, version_fingerprint)
from pilosa_tpu_torch.cache.result_cache import ResultCache, estimate_cost

__all__ = [
    "ResultCache",
    "estimate_cost",
    "is_cacheable",
    "query_cache_key",
    "shard_key",
    "version_fingerprint",
]

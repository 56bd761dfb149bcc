"""Cache key construction: canonical shard sets + fragment-version
fingerprints.

A result-cache entry is valid exactly as long as none of the fragments a
query could have read were written. Fragment versions
(core/fragment.py: every write path bumps ``fragment.version``) give
that for free — the key embeds a fingerprint of (field, view, shard,
version) tuples over the query's resolved shard list, so a write to any
covered fragment changes the fingerprint and the stale entry simply
never matches again. No write-path hooks, no invalidation queues: stale
reads are structurally impossible.

``shard_key`` is shared with the scheduler's grouping key
(sched/batch.py) so the two canonicalizations can never drift.

Port of ``pilosa_tpu/cache/keys.py``; the port's fragments, BSI
fragments and dataframe frames carry the same ``version`` counters.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

# Fingerprint slot markers: views never start with "@" (core/timeq view
# names are "standard"/"standard_YYYY..."), so these cannot collide.
_BSI_VIEW = "@bsi"
_DF_FIELD = "@dataframe"

# Mirrors pql/executor.py _WRITE_CALLS (importing it would cycle:
# executor imports this module for query_cache_key).
_WRITE_NAMES = frozenset({"Set", "Clear", "ClearRow", "Store", "Delete"})


def shard_key(shards: Optional[Sequence[int]],
              all_shards: Optional[Iterable[int]] = None
              ) -> Optional[Tuple[int, ...]]:
    """Canonical frozen shard set: a sorted int tuple. ``None`` expands
    to ``all_shards`` when the caller can resolve it (the cache key
    must pin the concrete shards a query read); without ``all_shards``
    it stays None (the scheduler's GroupKey has no holder access, and
    "all shards at dispatch time" is itself a stable grouping)."""
    if shards is None:
        if all_shards is None:
            return None
        return tuple(sorted(int(s) for s in all_shards))
    return tuple(sorted(int(s) for s in shards))


def union_shards(shard_sets: Iterable[Optional[Sequence[int]]]
                 ) -> Optional[Tuple[int, ...]]:
    """Sorted union of canonical shard sets — the superset layout a
    fused cross-shard-set dispatch stacks over (sched/ superset
    fusion). Any unresolved set (None = "all shards at dispatch time")
    poisons the union: the caller has no holder access to expand it, so
    such groups never merge with explicit ones."""
    out: set = set()
    for s in shard_sets:
        if s is None:
            return None
        out.update(int(x) for x in s)
    return tuple(sorted(out))


def version_fingerprint(idx, shard_list: Sequence[int]) -> Tuple:
    """Tuple of (field, view, shard, version) for every fragment of the
    index over ``shard_list`` — a conservative superset of the fragments
    the query touched (a write to an un-queried field of a covered shard
    invalidates too; over-invalidation costs a re-dispatch, never a
    stale result). Dataframe frames carry their own version and join the
    fingerprint so Apply/Arrow results invalidate the same way.

    Iteration is sorted everywhere so the fingerprint is byte-identical
    across interpreter runs (PYTHONHASHSEED must not matter)."""
    shard_set = frozenset(int(s) for s in shard_list)
    parts = []
    for fname in sorted(idx.fields):
        field = idx.fields[fname]
        for view in sorted(field.views):
            frags = field.views[view]
            for shard in sorted(shard_set & frags.keys()):
                parts.append((fname, view, shard, frags[shard].version))
        for shard in sorted(shard_set & field.bsi.keys()):
            parts.append((fname, _BSI_VIEW, shard, field.bsi[shard].version))
    frames = idx.dataframe.frames
    for shard in sorted(shard_set & frames.keys()):
        parts.append((_DF_FIELD, "", shard, frames[shard].version))
    return tuple(parts)


def is_cacheable(query) -> bool:
    """False for queries whose results the version fingerprint cannot
    pin: writes mutate state, ExternalLookup reads an
    operator-configured external backend (no local versions), and a
    per-call Options(shards=...) override makes the call read a
    different shard set than the query-level one the key was
    fingerprinted over."""
    def walk(call) -> bool:
        if call.name in _WRITE_NAMES or call.name == "ExternalLookup":
            return False
        if call.name == "Options" and call.arg("shards") is not None:
            return False
        return all(walk(c) for c in call.children)

    calls = getattr(query, "calls", None)
    if calls is None:
        calls = [query]
    return all(walk(c) for c in calls)


def query_cache_key(idx, query, shard_list: Sequence[int],
                    namespace: str = "local") -> Optional[Tuple]:
    """The full result-cache key ``(namespace, index, canonical PQL,
    frozen shard set, version fingerprint)`` — or None when the query is
    not cacheable. ``namespace`` separates result dialects that would
    otherwise collide (a remote=True executor returns untranslated,
    untruncated partials for the same PQL text).

    ``shard_list`` is the query's OWN resolved shard set even when it
    executes masked over a superset stack (executor per_query_shards):
    a superset-fused dispatch fills exact per-query entries, keyed and
    version-fingerprinted over just the shards the result depends on —
    so partially-overlapping workloads warm each other, and a write to
    a union-only shard never invalidates a subset query's entry."""
    if not is_cacheable(query):
        return None
    pql = query.to_pql()
    return (namespace, idx.name, pql, shard_key(shard_list),
            version_fingerprint(idx, shard_list))

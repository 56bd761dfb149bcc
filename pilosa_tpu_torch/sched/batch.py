"""Shape grouping + fused batch execution.

A batch is a set of read queries that agree on (index, shard set, op
family). A compatible group goes to the executor's ``execute_many``
fusion primitive (pql/executor.py): every call of every query
dispatches asynchronously, all device->host copies overlap, and the
batch blocks ONCE, so N queries pay one dispatch floor instead of N.
Executors without ``execute_many`` fall back to concatenating the
top-level calls into one merged ``Query`` and scattering results back
by call-offset span.

The op-family split keeps batches shape-compatible (the reference for a
later fully-vmapped fast path: a "count" batch is N identical
plane-reduce kernels over the same stacked planes, ideal for stacking
into one [N, words] reduce) and keeps latency classes apart — a cheap
Count never waits behind a 100-row Extract scan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

from pilosa_tpu_torch.cache.keys import shard_key
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.tracing import NOP_SPAN, get_tracer, span_scope
from pilosa_tpu_torch.pql.ast import Call, Query, unwrap_options

# Top-level call name -> op family. Families batch together; anything
# unlisted (Extract/Apply/Arrow/Sort/... — wide, host-heavy results)
# rides the catch-all "scan" family so it cannot stall cheap scalar
# queries in the same window.
_FAMILY = {
    "Count": "count",
    "Row": "bitmap", "Union": "bitmap", "Intersect": "bitmap",
    "Difference": "bitmap", "Xor": "bitmap", "Not": "bitmap",
    "All": "bitmap", "ConstRow": "bitmap", "UnionRows": "bitmap",
    "Shift": "bitmap", "Distinct": "bitmap", "Limit": "bitmap",
    "Sum": "agg", "Min": "agg", "Max": "agg", "Percentile": "agg",
    "TopN": "rank", "TopK": "rank", "Rows": "rank", "GroupBy": "rank",
}

# Families eligible for cross-shard-set (superset) fusion: their results
# stay exact under the executor's per-query shard mask. "scan" families
# walk fragments host-side and never merge across shard sets.
FUSIBLE_FAMILIES = frozenset({"count", "bitmap", "agg", "rank"})


def fusible_family(family: str) -> bool:
    """True when every part of a (possibly composite "a+b") family is
    superset-fusible."""
    return all(part in FUSIBLE_FAMILIES for part in family.split("+"))


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Everything two queries must agree on to share a dispatch. The
    shard-width axis is a build-time constant (shardwidth.py), so index +
    explicit shard set pin the stacked-plane shapes; the family pins the
    kernel mix."""

    index: str
    shards: Optional[Tuple[int, ...]]
    family: str


def family_of(query: Query) -> str:
    """Coarse op family of a (possibly multi-call) query; a mixed-family
    query gets a composite key so identical mixes still batch."""
    fams = []
    for call in query.calls:
        # shared unwrap (pql/ast.py) — keeps this classification in
        # lockstep with the executor's maskability check
        f = _FAMILY.get(unwrap_options(call).name, "scan")
        if f not in fams:
            fams.append(f)
    return "+".join(sorted(fams)) or "scan"


def group_key(index: str, query: Query,
              shards: Optional[Sequence[int]] = None) -> GroupKey:
    # shard canonicalization is shared with the result-cache key
    # (cache/keys.py shard_key) so the two can never drift; here None
    # stays None — "all shards at dispatch time" is a stable group.
    return GroupKey(
        index=index,
        shards=shard_key(shards),
        family=family_of(query),
    )


def execute_batch(executor, entries: List) -> None:
    """Run one compatible group as a single fused dispatch and scatter
    results. Each entry carries ``index``/``query``/``shards`` (equal
    under the group key) and a ``future`` to complete.

    Error isolation: a failing call inside a merged query would fail the
    whole executor call, so on any batch-level exception the entries
    re-run individually — a malformed query costs its batch-mates the
    amortization on that one batch, never their results.
    """
    if not entries:
        return
    first = entries[0]
    if len(entries) == 1:
        _run_single(executor, first)
        return
    many = getattr(executor, "execute_many", None)
    canon = shard_key(first.shards)
    hetero = any(shard_key(e.shards) != canon for e in entries)
    if hetero and (many is None
                   or not getattr(executor, "supports_shard_masks", False)):
        # superset-merged batch against an executor that cannot mask —
        # should not happen (the scheduler gates merging on this same
        # probe), but degrade to solo runs rather than corrupt results
        for e in entries:
            _run_single(executor, e)
        return
    t0 = time.perf_counter()
    # resident-stack hits across the whole fused dispatch: a fully warm
    # batch shows resident_hits > 0 and no stack.build/h2d stages — the
    # observable proof that superset fusion rode the resident programs
    hits0 = M.REGISTRY.value(M.METRIC_DEVICE_RESIDENT_HITS)
    try:
        # the fused dispatch runs under the head entry's span scope —
        # device spans land on the query that "paid" for the dispatch;
        # every batch-mate gets a post-hoc sched.fuse record below
        with span_scope(_entry_span(first)), \
                get_tracer().start_span("sched.fuse", fused=len(entries)) as sp:
            if hetero:
                # cross-shard-set fusion: one dispatch over the union
                # layout, each query masked to its own subset
                per_query = many(first.index, [e.query for e in entries],
                                 per_query_shards=[e.shards for e in entries])
            elif many is not None:
                # native fusion primitive (pql/executor.py execute_many):
                # per-query call lists stay intact, one blocking sync
                per_query = many(first.index, [e.query for e in entries],
                                 shards=first.shards)
            else:
                # plain executors: concatenate calls into one merged Query
                # and scatter by offset span
                calls: List[Call] = []
                spans: List[Tuple[int, int]] = []
                for e in entries:
                    spans.append((len(calls), len(e.query.calls)))
                    calls.extend(e.query.calls)
                results = executor.execute(first.index, Query(calls),
                                           shards=first.shards)
                per_query = [results[off:off + n] for off, n in spans]
            resident_hits = (
                M.REGISTRY.value(M.METRIC_DEVICE_RESIDENT_HITS) - hits0)
            sp.set_tag("resident_hits", resident_hits)
    except Exception:
        for e in entries:
            _run_single(executor, e)
        return
    fuse_s = time.perf_counter() - t0
    for e, res in zip(entries, per_query):
        if e is not first:
            _entry_span(e).record("sched.fuse", fuse_s, fused=len(entries),
                                  resident_hits=resident_hits)
        e.future.set_result(res)


def _entry_span(entry):
    # entries normally carry the submitter's span (sched/scheduler.py
    # _Pending), but batch tests construct bare entry objects
    return getattr(entry, "span", None) or NOP_SPAN


def _run_single(executor, entry) -> None:
    try:
        with span_scope(_entry_span(entry)):
            res = executor.execute(entry.index, entry.query,
                                   shards=entry.shards)
        entry.future.set_result(res)
    except Exception as exc:
        entry.future.set_exception(exc)

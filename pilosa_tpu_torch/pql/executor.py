"""PQL executor: lowers the call tree to launches over stacked shard
tensors, with one device->host copy per result.

Port of the read path of ``pilosa_tpu/pql/executor.py`` (reference:
executor.go, dispatch :679-841): ``Count`` over bitmap trees, the bitmap
calls Row / Intersect / Union / Difference / Xor / Not / All (with Range
rows of int-like fields, and ``from=``/``to=`` time ranges over a
``time`` field's quantum views), the row-set calls ConstRow / UnionRows /
Shift / Limit / Distinct / Rows / IncludesColumn, ``Sum`` / ``Min`` /
``Max`` / ``Percentile``, ``TopN`` (ranged too), ``GroupBy`` over any
number of ``Rows`` with an optional ``filter=`` and ``aggregate=Sum(...)``
or ``Count(...)`` (dense up to 2^24 cells over one or two fields, a
pruning fold past that), the host-scan calls ``Extract`` / ``Sort`` /
``FieldValue``, the dataframe calls ``Apply`` / ``Arrow``,
``ExternalLookup``, ``Options(shards=)``, and the ``StackStale`` retry;
``execute_many``, which resolves the deferred results of several reads
with one wait on the card, each under its own ``ShardMask`` over a
shared union layout when their shard sets differ (``per_query_shards``);
the result cache branch
(``cache/``); and the write calls ``Set`` (with a timestamp too) / ``Clear`` /
``ClearRow`` / ``Store`` / ``Delete``, run once under the holder's write
lock (reference: executor.go executeSet / executeClear / executeClearRow
/ executeSetRow / executeDeleteRecords).

Key translation happens host-side around the kernels (reference:
executor.go:6814 preTranslate, :7519 translateResults). Every deferred
result tensor of a query (or of a fused batch of queries) is copied to
pinned host memory without blocking, then the host waits once, on one
CUDA event recorded after the last copy (``_start_copies``). A call that
must read the card before it can go on (a restricted ``Rows``,
``Distinct`` or ``UnionRows``, the GroupBy fold, a host scan) also waits
inside itself.
"""

from __future__ import annotations

import copy
import datetime as dt
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.cache.keys import query_cache_key
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_ROW, Index
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.core.stacked import (StackedBSI, StackStale,
                                           stacked_bsi, stacked_set)
from pilosa_tpu_torch.dataframe.expr import compile_expr
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import topk as T
from pilosa_tpu_torch.ops.groupby import (masked_pair_counts, pair_counts,
                                          pair_sums)
from pilosa_tpu_torch.parallel import mesh as meshmod
from pilosa_tpu_torch.parallel import split as SP
from pilosa_tpu_torch.pql import programs
from pilosa_tpu_torch.pql import result as R
from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

__all__ = ["Executor", "PQLError", "ShardMask", "has_write_calls",
           "query_maskable"]

_BITMAP_CALLS = {"Row", "Union", "Intersect", "Difference", "Xor", "Not",
                 "All", "ConstRow", "UnionRows", "Shift", "Distinct", "Limit"}

_WRITE_CALLS = {"Set", "Clear", "ClearRow", "Store", "Delete"}

# Calls whose results stay exact under a per-query shard mask over a
# union stacked layout (superset fusion). Every shard's segment of a
# bitmap expression depends only on that shard's fragments (all plane
# algebra is column-local; Shift carries stop at shard boundaries), so
# masking the columns a reduction sees equals evaluating over the
# subset's own stack. Host-scan calls (Extract/Apply/Arrow/Sort/...)
# walk fragments directly and run with their own shard list instead.
_MASKABLE_CALLS = (_BITMAP_CALLS
                   | {"Count", "Sum", "Min", "Max", "Percentile",
                      "TopN", "TopK", "Rows", "GroupBy"})

#: compiled Apply expressions an executor keeps, oldest dropped first
_APPLY_CACHE_ENTRIES = 64

_COND_TO_BSI = {"==": S.EQ, "!=": S.NE, "<": S.LT, "<=": S.LE,
                ">": S.GT, ">=": S.GE, "between": S.BETWEEN}


def has_write_calls(query) -> bool:
    """True if any call in the (parsed) query mutates data."""

    def walk(call) -> bool:
        if call.name in _WRITE_CALLS:
            return True
        if call.name == "ExternalLookup" and call.arg("write"):
            return True  # write-mode lookups keep single-writer ordering
        return any(walk(c) for c in call.children)

    calls = query.calls if isinstance(query, Query) else [query]
    return any(walk(c) for c in calls)


def query_maskable(query) -> bool:
    """True when every top-level call of ``query`` can execute under a
    per-query shard mask (see _MASKABLE_CALLS). ``Options`` wrappers are
    transparent UNLESS they carry a ``shards=`` override: that re-scopes
    the call away from the union layout the mask indexes, so such
    queries keep their own shard list (the result cache excludes them
    for the same reason, cache/keys.py is_cacheable)."""
    calls = query.calls if isinstance(query, Query) else [query]
    for call in calls:
        while call.name == "Options" and call.children:
            if call.arg("shards") is not None:
                return False
            call = call.children[0]
        if call.name not in _MASKABLE_CALLS:
            return False
    return True


# Device-resident ShardMask planes, LRU-bounded and keyed by (mesh
# epoch, device, union layout, subset): masks depend only on shard lists,
# never data, so warm fused dispatches (sched/batch.py) find their mask
# already on the card instead of staging a host plane per ShardMask. They
# are placed like the stacks (``engine_put``: split over the engine
# mesh), and a mesh switch misses them. As in the JAX package they are
# not charged to the DeviceBudget: at 256 shards one plane is
# 33,554,432 B, so the cap bounds them at 1 GiB.
_MASK_CAP = 32
_MASK_PLANES: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
_MASK_LOCK = threading.Lock()


def _mask_plane(shard_list: Tuple[int, ...], subset, device: torch.device
                ) -> torch.Tensor:
    key = (meshmod.mesh_epoch(), str(device), shard_list, subset)
    with _MASK_LOCK:
        hit = _MASK_PLANES.get(key)
        if hit is not None:
            _MASK_PLANES.move_to_end(key)
    if hit is not None:
        M.REGISTRY.count(M.METRIC_DEVICE_RESIDENT_HITS)
        return hit
    plane = meshmod.engine_put(B.shard_mask_plane(shard_list, subset), device)
    with _MASK_LOCK:
        plane = _MASK_PLANES.setdefault(key, plane)
        _MASK_PLANES.move_to_end(key)
        while len(_MASK_PLANES) > _MASK_CAP:
            _MASK_PLANES.popitem(last=False)
    return plane


def mask_plane_bytes() -> int:
    """Device bytes the ShardMask LRU holds."""
    with _MASK_LOCK:
        return sum(t.numel() * t.element_size()
                   for t in _MASK_PLANES.values())


class ShardMask:
    """Per-query shard-subset mask over a union stacked layout (superset
    fusion, sched/batch.py): an ``int32[S*W]`` word plane with all-ones
    words (-1) on the query's own shards and zeros elsewhere
    (ops/bitmap.py shard_mask_plane).

    Applied at materialization/aggregation points only — bitmap algebra
    (AND/OR/XOR/ANDNOT) distributes over a per-column mask, so masking
    the final plane equals masking every leaf, and the intermediate
    evaluation stays shared across the whole fused batch."""

    __slots__ = ("shard_list", "subset", "plane")

    def __init__(self, shard_list: Sequence[int], subset,
                 device: torch.device):
        self.shard_list = [int(s) for s in shard_list]
        self.subset = frozenset(int(s) for s in subset)
        self.plane = _mask_plane(tuple(self.shard_list), self.subset, device)


def _parse_ts(v) -> dt.datetime:
    if isinstance(v, dt.datetime):
        return v
    return dt.datetime.fromisoformat(str(v).replace("Z", "+00:00"))


class _Deferred:
    """A query result whose device tensors haven't been copied back yet:
    every call of a query launches before any result is fetched.
    :func:`_start_copies` fills ``host`` (a list of block copies for a
    split result), and :meth:`resolve` finalizes from it after the one
    wait."""

    __slots__ = ("arrays", "finalize", "host")

    def __init__(self, arrays: Sequence[torch.Tensor], finalize: Callable):
        self.arrays = list(arrays)
        self.finalize = finalize
        self.host: Optional[List[torch.Tensor]] = None

    def resolve(self):
        return self.finalize(*[
            np.concatenate([b.numpy() for b in h], axis=-1)
            if isinstance(h, list) else h.numpy() for h in self.host])


def _copy_back(a: torch.Tensor, devices: Dict) -> torch.Tensor:
    """Start the host copy of one device tensor (pinned, non_blocking),
    noting its device; a CPU tensor is read where it is."""
    if not a.is_cuda:
        return a
    h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    h.copy_(a, non_blocking=True)
    devices[a.device] = True
    return h


def _start_copies(raw) -> List[torch.cuda.Event]:
    """Start the host copy of every deferred tensor of ``raw`` and return
    the CUDA events to wait on: one per card the copies ran on (none
    when nothing is on a card). A card tensor is copied ``non_blocking``
    into pinned memory from torch's caching host allocator, a split one
    block by block; a CPU tensor is read where it is. Each event is
    recorded on its card's current stream after the last copy, so one
    wait covers every copy of a query or a fused batch (the JAX
    package's ``copy_to_host_async`` then one block,
    pilosa_tpu/pql/executor.py:193-200)."""
    devices: Dict[torch.device, bool] = {}
    for r in raw:
        if not isinstance(r, _Deferred):
            continue
        r.host = [[_copy_back(b, devices) for b in a.blocks]
                  if isinstance(a, SP.Split) else _copy_back(a, devices)
                  for a in r.arrays]
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return events


def _wait_copies(events: Sequence[torch.cuda.Event]) -> None:
    """The host's one blocking wait per query or fused batch: every
    card's event."""
    for event in events:
        event.synchronize()


def _resolve_all(raw) -> List[Any]:
    """Every result of ``raw`` on the host, after one wait."""
    _wait_copies(_start_copies(raw))
    return [r.resolve() if isinstance(r, _Deferred) else r for r in raw]


def _concat(parts, dim=0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _bsi_values(frag, pos: np.ndarray) -> np.ndarray:
    """The signed stored values of a BSI fragment at the shard-local
    columns ``pos``, decoded on the host one magnitude plane at a time
    (the pivot analog, reference: bsi.go:18 PivotDescending)."""
    w = (pos // 32).astype(np.int64)
    b = (pos % 32).astype(np.uint32)
    raw = np.zeros(pos.size, dtype=np.int64)
    for k in range(frag.depth):
        raw |= ((frag.planes[S.OFFSET + k][w] >> b) & 1).astype(np.int64) << k
    sgn = ((frag.planes[S.SIGN][w] >> b) & 1).astype(bool)
    raw[sgn] = -raw[sgn]
    return raw


class Executor:
    """Reference: executor.go:55.

    ``remote=True`` is peer-serving mode (the reference's Remote:true
    query flag, executor.go:6392): results keep raw IDs (no key
    translation, which happens once at the coordinator, executor.go:7519)
    and rankings and limits are not cut, so a coordinator's merge stays
    exact."""

    #: plug point for ExternalLookup: fn(query: str, write: bool) -> Any
    external_lookup = None

    def __init__(self, holder: Holder, remote: bool = False):
        self.holder = holder
        self.remote = remote
        # source text -> (fn, columns used, is reduction)
        self._apply_cache: Dict[str, Tuple[Callable, List[str], bool]] = {}
        # result cache (cache/), attached by API.enable_cache(); None
        # keeps the read path as it is without one
        self.cache = None
        # tenant-scoped cache namespaces: each tenant's results key under
        # its own namespace (set once the tenant registry is ported)
        self.tenant_namespaces = False

    # -- public entry (reference: executor.go:183 Execute) --------------------

    def execute(self, index: str, query,
                shards: Optional[Sequence[int]] = None) -> List[Any]:
        idx = self.holder.index(index)
        if isinstance(query, str):
            query = parse(query)
        if isinstance(query, Call):
            query = Query([query])
        if has_write_calls(query):
            # once, with no StackStale retry: re-running a Set would
            # change its changed-flags, and the lock excludes other
            # writers, so no lazy build can go stale
            with self.holder.write_lock:
                return self._execute_query(idx, query, shards)
        cache = self.cache
        if cache is not None:
            key = self.cache_key(idx, query, shards)
            if key is None:
                cache.bypass()
            else:
                return cache.run(
                    key, lambda: self._execute_read(idx, query, shards),
                    allow_stale=not self.remote)
        return self._execute_read(idx, query, shards)

    def cache_key(self, index, query,
                  shards: Optional[Sequence[int]] = None) -> Optional[Tuple]:
        """Result-cache key for a read query against this executor (None
        when uncacheable: writes, ExternalLookup, per-call shard
        overrides). Accepts an Index or a name, str/Call queries like
        ``execute``. The namespace pins the result dialect: a
        remote=True executor returns untranslated, uncut partials for
        the same PQL text."""
        idx = index if isinstance(index, Index) else self.holder.index(index)
        if isinstance(query, str):
            query = parse(query)
        if isinstance(query, Call):
            query = Query([query])
        if has_write_calls(query):
            return None
        return query_cache_key(idx, query, self._shards(idx, shards),
                               namespace=self._namespace())

    def _namespace(self) -> str:
        """Cache-key namespace: the result dialect (local/remote), plus
        the current tenant when tenant-scoped namespaces are on."""
        ns = "remote" if self.remote else "local"
        if self.tenant_namespaces:
            from pilosa_tpu_torch.obs.tenants import current_tenant_id

            t = current_tenant_id()
            if t is not None:
                return f"{ns}|{t}"
        return ns

    def _execute_read(self, idx: Index, query: Query, shards) -> List[Any]:
        # Paged stacks build blocks lazily; a write landing mid-stream
        # makes the remaining builds StackStale. Reads are pure, so retry
        # on a fresh stack; the last attempt runs under the writer lock.
        for _ in range(3):
            try:
                return self._execute_query(idx, query, shards)
            except StackStale:
                continue
        with self.holder.write_lock:
            return self._execute_query(idx, query, shards)

    def _execute_query(self, idx: Index, query: Query, shards) -> List[Any]:
        raw = [self._execute_call(idx, call, shards) for call in query.calls]
        return _resolve_all(raw)

    #: capability flag for the scheduler's superset fusion (sched/batch.py
    #: probes it before routing heterogeneous shard sets here)
    supports_shard_masks = True

    def execute_many(self, index: str, queries: Sequence,
                     shards: Optional[Sequence[int]] = None,
                     per_query_shards: Optional[Sequence] = None
                     ) -> List[List[Any]]:
        """Resolve several read queries' deferred results with ONE
        blocking wait — the fusion primitive behind the micro-batcher
        (sched/): every call of every query launches, all device->host
        copies are enqueued, and the host waits once, so N concurrent
        Counts pay one round trip exactly like N top-level calls of a
        single ``execute``. Calls that read the card mid-evaluation (see
        the module docstring) add their own waits.

        ``per_query_shards`` (one shard set per query, overriding
        ``shards``) enables CROSS-shard-set fusion: maskable queries
        evaluate over ONE stacked layout covering the union of all sets,
        each restricted to its own subset by a per-query word-lane mask
        (ShardMask) — still one wait. Queries the mask cannot cover
        exactly (host-scan calls, Options shards= overrides) keep their
        own shard list within the same fused round."""
        idx = self.holder.index(index)
        qs: List[Query] = []
        for q in queries:
            if isinstance(q, str):
                q = parse(q)
            if isinstance(q, Call):
                q = Query([q])
            if has_write_calls(q):
                raise ValueError("execute_many is read-only")
            qs.append(q)
        if per_query_shards is None:
            if self.cache is None:
                return self._execute_many_retry(idx, qs, shards)
            return self._execute_many_cached(idx, qs, shards)
        if len(per_query_shards) != len(qs):
            raise ValueError("per_query_shards must match queries")
        shard_lists = [self._shards(idx, s) for s in per_query_shards]
        if self.cache is None:
            plans = self._fusion_plans(idx, qs, shard_lists)
            return self._execute_many_retry(idx, qs, shards, plans)
        return self._execute_many_cached(idx, qs, shards, shard_lists)

    def _fusion_plans(self, idx: Index, qs: Sequence[Query],
                      shard_lists: Sequence[List[int]]
                      ) -> List[Tuple[List[int], Optional[ShardMask]]]:
        """Per-query (shard_list, mask) execution plans over the union
        layout. Plans are host data and a mask plane never changes, so
        they are safe to reuse across StackStale retries. Queries with
        the same subset share one mask."""
        union = sorted(set().union(*map(set, shard_lists))) \
            if shard_lists else []
        union_set = set(union)
        masks: Dict[frozenset, ShardMask] = {}
        plans: List[Tuple[List[int], Optional[ShardMask]]] = []
        for q, sl in zip(qs, shard_lists):
            sub = frozenset(sl)
            if sub == union_set:
                plans.append((union, None))
            elif query_maskable(q):
                mask = masks.get(sub)
                if mask is None:
                    mask = masks[sub] = ShardMask(union, sub, idx.device)
                plans.append((union, mask))
            else:
                plans.append((sl, None))
        return plans

    def _execute_many_retry(self, idx: Index, qs: Sequence[Query],
                            shards, plans=None) -> List[List[Any]]:
        # the StackStale retry contract of _execute_read
        for _ in range(3):
            try:
                return self._execute_many(idx, qs, shards, plans)
            except StackStale:
                continue
        with self.holder.write_lock:
            return self._execute_many(idx, qs, shards, plans)

    def _execute_many_cached(self, idx: Index, qs: Sequence[Query],
                             shards, shard_lists=None) -> List[List[Any]]:
        """Per-query cache fill around ONE fused dispatch: hits and
        single-flight followers drop out of the batch; all remaining
        queries (miss leaders + uncacheable bypasses) still go through
        a single ``_execute_many`` so the fusion amortization is kept.

        With ``shard_lists`` (superset fusion), each query's key uses its
        OWN shard set — a masked execution over the union stack fills
        exact per-query entries, and the fusion plan for the residual
        misses is recomputed over just their (possibly tighter) union."""
        cache = self.cache
        if shard_lists is None:
            key_lists = [self._shards(idx, shards)] * len(qs)
        else:
            key_lists = shard_lists
        ns = self._namespace()
        results: List[Optional[List[Any]]] = [None] * len(qs)
        to_run: List[Tuple[int, Optional[Tuple]]] = []  # (slot, key|None)
        followers = []  # (slot, future)
        for i, q in enumerate(qs):
            key = query_cache_key(idx, q, key_lists[i], namespace=ns)
            if key is None:
                cache.bypass()
                to_run.append((i, None))
                continue
            state, payload = cache.fetch(key)
            if state == "hit":
                results[i] = payload
            elif state == "leader":
                to_run.append((i, key))
            else:
                followers.append((i, payload))
        if to_run:
            run_qs = [qs[i] for i, _ in to_run]
            plans = None
            if shard_lists is not None:
                plans = self._fusion_plans(
                    idx, run_qs, [key_lists[i] for i, _ in to_run])
            t0 = time.perf_counter()
            try:
                out = self._execute_many_retry(idx, run_qs, shards, plans)
            except BaseException as exc:
                for _, key in to_run:
                    if key is not None:
                        cache.fail(key, exc)
                raise
            cache.observe_dispatch(time.perf_counter() - t0)
            for (i, key), res in zip(to_run, out):
                results[i] = res
                if key is not None:
                    cache.complete(key, res)
        for i, fut in followers:
            results[i] = copy.deepcopy(fut.result())
        return results

    def _execute_many(self, idx: Index, qs: Sequence[Query],
                      shards, plans=None) -> List[List[Any]]:
        if plans is None:
            plans = [(shards, None)] * len(qs)
        raw = [[self._execute_call(idx, call, s, mask) for call in q.calls]
               for q, (s, mask) in zip(qs, plans)]
        flat = _resolve_all([r for rq in raw for r in rq])
        out, pos = [], 0
        for rq in raw:
            out.append(flat[pos:pos + len(rq)])
            pos += len(rq)
        return out

    # -- dispatch (reference: executor.go:679 executeCall) --------------------

    def _execute_call(self, idx: Index, call: Call, shards=None,
                      mask: Optional[ShardMask] = None) -> Any:
        name = call.name
        if name == "Options":
            if call.arg("shards") is not None:
                if mask is not None:
                    # query_maskable excludes these before planning; a
                    # mask sized for the union layout cannot index an
                    # arbitrary override set
                    raise PQLError(
                        "Options(shards=) cannot execute under a shard mask")
                shards = [int(s) for s in call.arg("shards")]
            return self._execute_call(idx, call.children[0], shards, mask)
        if name in _WRITE_CALLS:
            return self._execute_write(idx, call, shards)
        if name == "Count":
            return self._execute_count(idx, call, shards, mask)
        if name in ("Sum", "Min", "Max"):
            return self._execute_bsi_agg(idx, call, shards, mask)
        if name == "Percentile":
            return self._execute_percentile(idx, call, shards, mask)
        if name in ("TopN", "TopK"):
            return self._execute_topn(idx, call, shards, mask)
        if name == "Rows":
            return self._execute_rows(idx, call, shards, mask)
        if name == "GroupBy":
            return self._execute_groupby(idx, call, shards, mask)
        if name in _BITMAP_CALLS:
            return self._materialize_row(idx, call, shards, mask)
        if mask is not None:
            # host-scan calls walk fragments directly; _MASKABLE_CALLS
            # keeps them out of masked plans, so reaching here means a
            # caller bypassed query_maskable
            raise PQLError(f"{name} cannot execute under a shard mask")
        if name == "IncludesColumn":
            return self._execute_includes_column(idx, call)
        if name == "Extract":
            return self._execute_extract(idx, call, shards)
        if name == "Apply":
            return self._execute_apply(idx, call, shards)
        if name == "Arrow":
            return self._execute_arrow(idx, call, shards)
        if name == "Sort":
            return self._execute_sort(idx, call, shards)
        if name == "FieldValue":
            return self._execute_field_value(idx, call)
        if name == "ExternalLookup":
            return self._execute_external_lookup(call)
        raise PQLError(f"unknown call {name!r}")

    # -- shard helpers ---------------------------------------------------------

    def _shards(self, idx: Index, shards) -> List[int]:
        if shards is not None:
            return sorted(shards)
        return sorted(idx.shards())

    def _existence_all(self, idx: Index, shard_list: List[int]
                       ) -> torch.Tensor:
        ex = idx.existence
        if ex is None:
            raise PQLError(f"index {idx.name!r} does not track existence; "
                           "Not/All need it")
        st = stacked_set(ex, shard_list, timeq.VIEW_STANDARD)
        return st.row_plane(EXISTENCE_ROW)

    # -- row key resolution ----------------------------------------------------

    def _row_id(self, field: Field, value, create: bool = False
                ) -> Optional[int]:
        if field.options.type == FieldType.BOOL:
            if isinstance(value, bool):
                return 1 if value else 0
            return int(value)
        if isinstance(value, str):
            if not field.options.keys:
                raise PQLError(
                    f"field {field.name!r} does not use string keys")
            if create:
                return field.translate.create_keys([value])[value]
            return field.translate.find_keys([value]).get(value)
        if isinstance(value, bool):
            raise PQLError(f"field {field.name!r} is not bool")
        return int(value)

    def _col_id(self, idx: Index, value, create: bool = False
                ) -> Optional[int]:
        if isinstance(value, str):
            if not idx.options.keys:
                raise PQLError(f"index {idx.name!r} does not use string keys")
            if create:
                return idx.translate.create_keys([value])[value]
            return idx.translate.find_keys([value]).get(value)
        return int(value)

    # -- bitmap evaluation -------------------------------------------------------

    def _eval_all(self, idx: Index, call: Call, shard_list: List[int],
                  mask: Optional[ShardMask] = None) -> torch.Tensor:
        """The device plane of a bitmap call over all shards at once.
        ``mask`` does NOT restrict the plane: bitmap algebra is
        column-local, so callers mask once at their materialization or
        aggregation point. It threads through only for the row selection
        of a restricted ``Rows`` (limit / previous / column pick other
        rows depending on which columns count)."""
        return programs.run_plane(self, idx, call, shard_list, mask,
                                  apply_mask=False)

    def _eval_bsi_row(self, field: Field, value, shard_list: List[int]
                      ) -> torch.Tensor:
        """BSI range predicate: one bsi_compare launch over the field's
        stack (reference: executor.go executeRowShard BSI branch ->
        fragment.rangeOp, fragment.go:937)."""
        if not field.options.type.is_bsi:
            raise PQLError(f"field {field.name!r} is not an int-like field")
        st = stacked_bsi(field, shard_list)
        if not isinstance(value, Condition):
            value = Condition("==", value)
        op = _COND_TO_BSI[value.op]
        if value.op == "between":
            lo, hi = value.value
            return st.compare(op, field.to_stored(lo), field.to_stored(hi))
        if value.value is None:
            # `!= null` = exists; `== null` = not exists (needs existence)
            if value.op == "!=":
                return st.exists_plane()
            raise PQLError("== null is not supported; use Not(Row(f != null))")
        return st.compare(op, field.to_stored(value.value))

    @staticmethod
    def _range_views(field: Field, call: Call) -> Optional[List[str]]:
        """The views covering a call's ``from=``/``to=`` range, or None
        when it has neither (reference: field.go:1001)."""
        from_a, to_a = call.arg("from"), call.arg("to")
        if from_a is None and to_a is None:
            return None
        return field.range_views(
            _parse_ts(from_a) if from_a is not None else None,
            _parse_ts(to_a) if to_a is not None else None)

    def _eval_row_set(self, idx: Index, call: Call, shard_list: List[int],
                      mask: Optional[ShardMask] = None) -> torch.Tensor:
        """The device plane of ConstRow, UnionRows or Shift, which the
        lowering composes as a leaf (reference: executor.go
        executeConstRow, executeUnionRows, executeShiftShard)."""
        name = call.name
        if name == "ConstRow":
            plane = np.zeros((len(shard_list), WORDS_PER_SHARD),
                             dtype=np.uint32)
            pos = {s: i for i, s in enumerate(shard_list)}
            by_shard: Dict[int, List[int]] = {}
            for value in call.arg("columns", []):
                c = self._col_id(idx, value)
                if c is None:
                    continue
                si = pos.get(c // SHARD_WIDTH)
                if si is not None:
                    by_shard.setdefault(si, []).append(c % SHARD_WIDTH)
            for si, cols in by_shard.items():
                plane[si] = B.bits_to_plane(cols)
            return meshmod.engine_put(plane.reshape(-1), idx.device)
        if name == "UnionRows":
            return self._union_rows(idx, call, shard_list, mask)
        if len(call.children) != 1:
            raise PQLError("Shift requires exactly one child")
        plane = self._eval_all(idx, call.children[0], shard_list, mask)
        if isinstance(plane, SP.Split):
            # blocks may cut a shard: the carry crosses a block edge
            # inside a shard and stops at a shard's end
            for _ in range(int(call.arg("n", 1))):
                plane = SP.shift(plane, WORDS_PER_SHARD)
            return plane
        shaped = plane.reshape(len(shard_list), WORDS_PER_SHARD)
        for _ in range(int(call.arg("n", 1))):
            # carries stop at shard boundaries, as the reference's
            # per-shard executeShiftShard
            shaped = B.plane_shift(shaped)
        return shaped.reshape(-1)

    def _union_rows(self, idx: Index, call: Call, shard_list: List[int],
                    mask: Optional[ShardMask] = None) -> torch.Tensor:
        """OR of the rows each ``Rows`` child selects; a ranged child ORs
        them across its covering time views (the lowering of SQL
        ``rangeq()``)."""
        out = None
        for c in call.children:
            if c.name != "Rows":
                raise PQLError("UnionRows children must be Rows calls")
            field = idx.field(self._field_name(c))
            in_a = c.arg("in")
            restricted = (c.arg("limit") is not None
                          or c.arg("previous") is not None
                          or c.arg("column") is not None)
            if restricted:  # honors from/to with the other options
                rows = self._rows_list(idx, c, shard_list, mask)
            elif in_a is not None:  # a bare in= list needs no device trip
                rows = self._in_row_ids(field, in_a)
            else:
                rows = None
            views = self._range_views(field, c)
            for v in views if views is not None else [timeq.VIEW_STANDARD]:
                st = stacked_set(field, shard_list, v)
                part = st.rows_plane(st.row_ids if rows is None else rows)
                # out of place: a part may be the shared zeros plane
                out = part if out is None else out | part
        if out is None:
            return meshmod.engine_zeros(len(shard_list) * WORDS_PER_SHARD,
                                        idx.device)
        return out

    def _materialize_row(self, idx: Index, call: Call, shards,
                         mask: Optional[ShardMask] = None) -> Any:
        limit, offset = None, 0
        if call.name == "Limit":
            if len(call.children) != 1:
                raise PQLError("Limit requires exactly one child")
            limit = call.arg("limit")
            offset = int(call.arg("offset", 0))
            call = call.children[0]
            if self.remote:  # the coordinator cuts after its merge
                limit, offset = None, 0
        if call.name == "Distinct":
            return self._execute_distinct(idx, call, shards, mask)
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return self._row_result(idx, [])
        # the mask restricts the materialized columns to the query's own
        # shards, ANDed in the plane terminal
        plane = programs.run_plane(self, idx, call, shard_list, mask)

        def finalize(plane_np: np.ndarray):
            shaped = plane_np.view(np.uint32).reshape(len(shard_list),
                                                      WORDS_PER_SHARD)
            cols: List[int] = []
            for si, shard in enumerate(shard_list):
                base = shard * SHARD_WIDTH
                cols.extend(int(base + c) for c in B.plane_to_bits(shaped[si]))
            if offset:
                cols = cols[offset:]
            if limit is not None:
                cols = cols[: int(limit)]
            return self._row_result(idx, cols)

        return _Deferred([plane], finalize)

    def _row_result(self, idx: Index, cols: List[int]) -> R.RowResult:
        if idx.options.keys and not self.remote:
            m = idx.translate.translate_ids(cols)
            return R.RowResult(columns=[],
                               keys=[m.get(c, str(c)) for c in cols])
        return R.RowResult(columns=cols)

    # -- Count (reference: executor.go:5839 executeCount) ---------------------

    def _execute_count(self, idx: Index, call: Call, shards,
                       mask: Optional[ShardMask] = None) -> Any:
        if len(call.children) != 1:
            raise PQLError("Count requires a single child call")
        child = call.children[0]
        if child.name == "Distinct":
            res = self._execute_distinct(idx, child, shards, mask)
            if isinstance(res, R.RowResult):
                return len(res.columns or res.keys or [])
            return len(res)
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return 0
        # ops + popcount in ONE tape_count launch over resident planes,
        # the shard mask as the kernel's mask operand
        count = programs.run_count(self, idx, child, shard_list, mask)
        return _Deferred([count], lambda c: int(c))

    # -- BSI aggregates (reference: executor.go executeSum/Min/Max) -----------

    def _agg_filter(self, idx: Index, call: Call, shard_list: List[int],
                    st: StackedBSI, mask: Optional[ShardMask] = None
                    ) -> torch.Tensor:
        if call.children:
            filt = self._eval_all(idx, call.children[0], shard_list, mask)
        else:
            filt = st.exists_plane()
        return S.mask_filter(filt, mask.plane if mask is not None else None)

    def _execute_bsi_agg(self, idx: Index, call: Call, shards,
                         mask: Optional[ShardMask] = None) -> Any:
        fname = call.arg("field") or call.arg("_field")
        if fname is None:
            raise PQLError(f"{call.name} requires field=")
        field = idx.field(fname)
        if not field.options.type.is_bsi:
            raise PQLError(f"field {fname!r} is not an int-like field")
        shard_list = self._shards(idx, shards)
        if call.name == "Sum":
            if not shard_list:
                return R.ValCount(val=0, count=0)
            st = stacked_bsi(field, shard_list)
            filt = self._agg_filter(idx, call, shard_list, st, mask)
            count, pos, neg = S.bsi_plane_popcounts(st.planes, filt)

            def fin_sum(count_np, pos_np, neg_np):
                stored, n = S.finish_sum(count_np, pos_np, neg_np)
                # stored = actual - base => sum(actual) = sum(stored)+base*n
                val = stored + field.options.base * n
                if field.options.type == FieldType.DECIMAL:
                    val = val / (10 ** field.options.scale)
                return R.ValCount(val=val, count=n)

            return _Deferred([count, pos, neg], fin_sum)
        # Min / Max (reference: executor.go executeMinShard/MaxShard); the
        # stacked layout makes the cross-shard merge implicit
        if not shard_list:
            return R.ValCount(val=None, count=0)
        st = stacked_bsi(field, shard_list)
        filt = self._agg_filter(idx, call, shard_list, st, mask)
        return _Deferred(S.bsi_minmax(st.planes, filt, call.name == "Max"),
                         self._value_finalizer(field))

    @staticmethod
    def _value_finalizer(field: Field) -> Callable:
        """Finalize (bits, negative, count, total) of a Min/Max/Percentile
        walk into a ValCount of the field's external value."""

        def finalize(*walk_np):
            stored, count, total = S.finish_value(*walk_np)
            if total == 0:
                return R.ValCount(val=None, count=0)
            return R.ValCount(val=field.from_stored(stored), count=count)

        return finalize

    # -- Percentile (reference: executor.go:1310) ------------------------------

    def _execute_percentile(self, idx: Index, call: Call, shards,
                            mask: Optional[ShardMask] = None) -> Any:
        field = idx.field(call.arg("field") or call.arg("_field"))
        nth = call.arg("nth")
        if nth is None:
            raise PQLError("Percentile requires nth=")
        nth = float(nth)
        if not 0 <= nth <= 100:
            raise PQLError("nth must be within [0, 100]")
        filter_call = call.arg("filter")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return R.ValCount(val=None, count=0)
        st = stacked_bsi(field, shard_list)
        filt = (self._eval_all(idx, filter_call, shard_list, mask)
                if filter_call is not None else st.exists_plane())
        if mask is not None:
            filt = S.mask_filter(filt, mask.plane)
        return _Deferred(S.bsi_kth(st.planes, filt, round(nth * 100)),
                         self._value_finalizer(field))

    # -- TopN / TopK (reference: executor.go:2357/2535) ------------------------

    def _field_name(self, call: Call) -> str:
        fname = call.arg("_field") or call.arg("field")
        if fname is None:
            raise PQLError(f"{call.name} requires a field")
        return fname

    def _execute_topn(self, idx: Index, call: Call, shards,
                      mask: Optional[ShardMask] = None) -> Any:
        field = idx.field(self._field_name(call))
        n = call.arg("n") or call.arg("k")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return self._pairs_field(field, [])
        filt = (self._eval_all(idx, call.children[0], shard_list, mask)
                if call.children else None)
        if mask is not None:
            # rank only the subset's columns; zero-count rows drop in
            # finalize, matching a solo run over the subset
            filt = S.mask_filter(filt, mask.plane)
        row_ids, counts = self._ranged_row_counts(field, call, shard_list,
                                                  filt)
        if not row_ids:
            return self._pairs_field(field, [])

        def finalize(counts_np: np.ndarray):
            ranked = [(row, int(counts_np[slot]))
                      for slot, row in enumerate(row_ids) if counts_np[slot]]
            ranked.sort(key=lambda kv: (-kv[1], kv[0]))
            if n is not None and not self.remote:
                ranked = ranked[: int(n)]
            return self._pairs_field(field, ranked)

        return _Deferred([counts], finalize)

    #: union-row chunk of a multi-view merge: bounds the transient
    #: ``[chunk, S*W]`` merged tensor as row blocks bound stacks
    _MERGE_CHUNK = 1024

    def _ranged_row_counts(self, field: Field, call: Call,
                           shard_list: List[int], filt):
        """(row_ids, device per-row counts) honoring the call's from/to
        range: each row's bits in the covering time views are OR-merged
        before they are counted, one chunk of rows at a time, as the
        reference's per-view union (executor.go executeTopNShard). None
        counts with no row ids."""
        views = self._range_views(field, call)
        if views is None:
            st = stacked_set(field, shard_list, timeq.VIEW_STANDARD)
            return st.row_ids, st.row_counts(filt)
        stacks = [stacked_set(field, shard_list, v) for v in views]
        stacks = [s for s in stacks if s.row_ids]
        if not stacks:
            return [], None
        if len(stacks) == 1:
            return stacks[0].row_ids, stacks[0].row_counts(filt)
        row_ids = sorted(set().union(*[s.row_index for s in stacks]))
        parts = []
        for lo in range(0, len(row_ids), self._MERGE_CHUNK):
            chunk = row_ids[lo:lo + self._MERGE_CHUNK]
            merged = None
            for s in stacks:
                sel = s.take_rows(chunk)  # a new tensor: OR in place
                merged = sel if merged is None else merged.bitwise_or_(sel)
            parts.append(T.row_counts(merged, filt))
        return row_ids, _concat(parts)

    def _pairs_field(self, field: Field, ranked) -> R.PairsField:
        if field.options.keys and not self.remote:
            keys = field.translate.translate_ids([r for r, _ in ranked])
            pairs = [R.Pair(id=None, key=keys.get(r, str(r)), count=c)
                     for r, c in ranked]
        else:
            pairs = [R.Pair(id=r, key=None, count=c) for r, c in ranked]
        return R.PairsField(pairs=pairs, field=field.name)

    # -- Rows (reference: executor.go executeRows) -----------------------------

    def _in_row_ids(self, field: Field, values) -> List[int]:
        """Row ids of a ``Rows(f, in=[...])`` selection; string members go
        through the field's translator in one batch, and unknown keys drop
        out (as ``Row(f="missing")`` is empty)."""
        strs = [v for v in values if isinstance(v, str)]
        if strs and not field.options.keys:
            raise PQLError(f"field {field.name!r} does not use string keys")
        found = field.translate.find_keys(strs) if strs else {}
        out = set()
        for v in values:
            if isinstance(v, str):
                r = found.get(v)
                if r is not None:
                    out.add(r)
            elif isinstance(v, bool):
                out.add(1 if v else 0)
            else:
                out.add(int(v))
        return sorted(out)

    def _rows_list(self, idx: Index, call: Call, shards=None,
                   mask: Optional[ShardMask] = None) -> List[int]:
        field = idx.field(self._field_name(call))
        col = call.arg("column")
        shard_list = self._shards(idx, shards)
        rows: set = set()
        if col is not None:
            # point lookup on the host planes of the standard view
            c = self._col_id(idx, col)
            if (c is not None and c // SHARD_WIDTH in shard_list
                    and (mask is None or c // SHARD_WIDTH in mask.subset)):
                frag = field.fragment(c // SHARD_WIDTH)
                if frag is not None:
                    pos = c % SHARD_WIDTH
                    bit = np.uint32(1) << np.uint32(pos % 32)
                    for row in frag.existing_rows():
                        if frag.row_plane(row)[pos // 32] & bit:
                            rows.add(row)
        elif shard_list:
            # honors from/to (reference: executor.go:4108). A shard mask
            # rides in as the count filter: rows present only outside
            # the subset count zero and drop out, so the listing (and the
            # limit/previous cut below) matches a solo run
            row_ids, counts = self._ranged_row_counts(
                field, call, shard_list,
                mask.plane if mask is not None else None)
            if row_ids:
                counts = counts.cpu().numpy()
                rows = {row for slot, row in enumerate(row_ids)
                        if counts[slot]}
        out = sorted(rows)
        in_a = call.arg("in")
        if in_a is not None:
            want = set(self._in_row_ids(field, in_a))
            out = [r for r in out if r in want]
        prev = call.arg("previous")
        if prev is not None:
            prev_id = self._row_id(field, prev)
            out = [r for r in out if prev_id is None or r > prev_id]
        limit = call.arg("limit")
        if limit is not None and not self.remote:
            out = out[: int(limit)]
        return out

    def _execute_rows(self, idx: Index, call: Call, shards,
                      mask: Optional[ShardMask] = None) -> List[Any]:
        field = idx.field(self._field_name(call))
        rows = self._rows_list(idx, call, shards, mask)
        if field.options.keys and not self.remote:
            m = field.translate.translate_ids(rows)
            return [m.get(r, str(r)) for r in rows]
        return rows

    # -- Distinct (reference: executor.go:1952-2153) ---------------------------

    def _execute_distinct(self, idx: Index, call: Call, shards,
                          mask: Optional[ShardMask] = None):
        field = idx.field(self._field_name(call))
        if not field.options.type.is_bsi:
            # set-like: the distinct values are the row ids present
            rows = self._rows_list(idx, call, shards, mask)
            if field.options.keys and not self.remote:
                m = field.translate.translate_ids(rows)
                return R.RowResult(columns=[],
                                   keys=[m.get(r, str(r)) for r in rows])
            return R.RowResult(columns=rows)
        shard_list = self._shards(idx, shards)
        filt_np = None
        if call.children and shard_list:
            filt_np = self._host_planes(
                self._eval_all(idx, call.children[0], shard_list, mask),
                len(shard_list))
        vals: set = set()
        for si, shard in enumerate(shard_list):
            if mask is not None and shard not in mask.subset:
                continue  # the host loop skips non-subset shards outright
            frag = field.bsi_fragment(shard)
            if frag is not None:
                vals.update(self._decode_distinct(
                    frag, filt_np[si] if filt_np is not None else None))
        return sorted(field.from_stored(v) for v in vals)

    @staticmethod
    def _decode_distinct(frag, filt: Optional[np.ndarray]) -> set:
        """The unique stored values of a BSI fragment, decoded on the
        host."""
        exists = frag.planes[S.EXISTS]
        if filt is not None:
            exists = exists & filt
        return set(int(v) for v in _bsi_values(frag, B.plane_to_bits(exists)))

    # -- IncludesColumn (reference: executor.go executeIncludesColumnCall) -----

    def _execute_includes_column(self, idx: Index, call: Call) -> bool:
        col = call.arg("column")
        if col is None:
            raise PQLError("IncludesColumn requires column=")
        if len(call.children) != 1:
            raise PQLError("IncludesColumn requires a bitmap child")
        c = self._col_id(idx, col)
        if c is None:
            return False
        shard, pos = divmod(c, SHARD_WIDTH)
        # over the full shard list, so the probe reuses the stacks every
        # other query caches (one-shard stacks would churn the subset LRU)
        shard_list = self._shards(idx, None)
        if shard not in shard_list:
            return False
        word = shard_list.index(shard) * WORDS_PER_SHARD + pos // 32
        plane = self._eval_all(idx, call.children[0], shard_list)
        bits = (plane.at(word) if isinstance(plane, SP.Split)
                else int(plane[word]))
        return bool((bits >> (pos % 32)) & 1)

    # -- GroupBy (reference: executor.go:3918 executeGroupByShard) -------------

    def _execute_groupby(self, idx: Index, call: Call, shards,
                         mask: Optional[ShardMask] = None) -> Any:
        if not call.children:
            raise PQLError("GroupBy requires at least one Rows child")
        if any(c.name != "Rows" for c in call.children):
            raise PQLError("GroupBy children must be Rows calls")
        agg_call = call.arg("aggregate")
        agg_field = None
        if agg_call is not None:
            if (not isinstance(agg_call, Call)
                    or agg_call.name not in ("Sum", "Count")):
                raise PQLError(
                    "GroupBy aggregate must be Sum(...) or Count(...)")
            if agg_call.name == "Sum":
                agg_field = idx.field(agg_call.arg("field")
                                      or agg_call.arg("_field"))
        fields = [idx.field(self._field_name(c)) for c in call.children]
        limit = call.arg("limit")
        if self.remote:
            limit = None
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return []
        sts = [stacked_set(f, shard_list, timeq.VIEW_STANDARD)
               for f in fields]
        if any(not st.row_ids for st in sts):
            return []
        agg_st = (stacked_bsi(agg_field, shard_list)
                  if agg_field is not None else None)
        filter_call = call.arg("filter")
        filt = (self._eval_all(idx, filter_call, shard_list, mask)
                if filter_call is not None else None)
        if mask is not None:
            # the mask folds into the group filter: level-0 planes are
            # ANDed with it, the fold keeps it, and _groupby_emit drops
            # the count==0 groups, as a solo run over the subset would
            filt = S.mask_filter(filt, mask.plane)
        if len(sts) <= 2 and self._groupby_dense_ok(sts, agg_st):
            return self._groupby_dense(fields, sts, filt, agg_st, limit)
        return self._groupby_fold(fields, sts, filt, agg_st, limit)

    @staticmethod
    def _groupby_dense_ok(sts, agg_st) -> bool:
        """The dense path holds the whole ``[capA, capB]`` count tensor
        (and ``[D, capA, capB]`` sum tensors with a Sum aggregate); past
        2^24 cells the GroupBy folds instead, since paging bounds the
        input blocks but not the dense output."""
        cells = 1
        for st in sts:
            cells *= st.cap
        if agg_st is not None:  # its plane count, without a decode
            cells *= S.OFFSET + agg_st.depth
        return cells <= 1 << 24

    def _field_row(self, field: Field, row: int) -> R.FieldRow:
        if field.options.keys and not self.remote:
            key = field.translate.translate_ids([row]).get(row, str(row))
            return R.FieldRow(field=field.name, row_key=key)
        return R.FieldRow(field=field.name, row_id=row)

    def _groupby_emit(self, fields, keyed, limit) -> List[R.GroupCount]:
        """GroupCounts of the nonzero groups in key order, cut at
        ``limit`` before any row is translated. ``keyed`` holds (key,
        count, agg) with agg None when there is no Sum aggregate."""
        out = []
        for key, count, agg in keyed:
            if limit is not None and len(out) >= int(limit):
                break
            if count == 0:
                continue
            group = [self._field_row(f, r) for f, r in zip(fields, key)]
            out.append(R.GroupCount(group=group, count=count, agg=agg))
        return out

    def _groupby_dense(self, fields, sts, filt, agg_st, limit):
        """1- and 2-field GroupBy: the whole result is a dense count
        tensor (plus per-plane signed counts with a Sum aggregate; ``agg``
        is the raw stored sum, as in the JAX package), streamed per row
        block through the pair_counts kernel (reference: executor.go:3176
        per-pair container walk)."""
        if agg_st is not None:
            planes = agg_st.planes
            exists, sign, mags = (planes[S.EXISTS], planes[S.SIGN],
                                  planes[S.OFFSET:])
            # the filter goes into the two sign classes once, not into
            # every row block
            pos_m = S.mask_filter(exists & ~sign, filt)
            neg_m = S.mask_filter(exists & sign, filt)

        if len(sts) == 1:
            arrays = [_concat([T.row_counts(blk, filt)
                               for _, blk in sts[0].iter_blocks()])]
            if agg_st is not None:
                # one launch per block: the block's rows against the
                # magnitude planes of each (filtered) sign class
                signed = torch.cat([mags & pos_m[None, :],
                                    mags & neg_m[None, :]])
                arrays.append(_concat([pair_counts(blk, signed)
                                       for _, blk in sts[0].iter_blocks()]))

            def fin1(counts_np, signed_np=None):
                depth = None if signed_np is None else signed_np.shape[1] // 2
                keyed = [((row,), int(counts_np[slot]),
                          None if depth is None else S.assemble_sum(
                              signed_np[slot, :depth],
                              signed_np[slot, depth:]))
                         for slot, row in enumerate(sts[0].row_ids)]
                return self._groupby_emit(fields, keyed, limit)

            return _Deferred(arrays, fin1)

        count_rows, p_rows, n_rows = [], [], []
        for _, a_blk in sts[0].iter_blocks():
            c_cols, p_cols, n_cols = [], [], []
            for _, b_blk in sts[1].iter_blocks():
                c_cols.append(masked_pair_counts(a_blk, b_blk, filt))
                if agg_st is not None:
                    p, ng = pair_sums(a_blk, b_blk, mags, pos_m, neg_m)
                    p_cols.append(p)
                    n_cols.append(ng)
            count_rows.append(_concat(c_cols, dim=1))
            if agg_st is not None:
                p_rows.append(_concat(p_cols, dim=2))
                n_rows.append(_concat(n_cols, dim=2))
        arrays = [_concat(count_rows, dim=0)]  # [capA, capB]
        if agg_st is not None:  # [D, capA, capB] each
            arrays += [_concat(p_rows, dim=1), _concat(n_rows, dim=1)]

        def fin2(counts_np, p_np=None, n_np=None):
            ra, rb = len(sts[0].row_ids), len(sts[1].row_ids)
            # row-major nonzero order IS key order (slots follow sorted
            # row ids), so the limit cuts before any tuple is built
            gi, gj = np.nonzero(counts_np[:ra, :rb])
            if limit is not None:
                gi, gj = gi[: int(limit)], gj[: int(limit)]
            keyed = [((sts[0].row_ids[i], sts[1].row_ids[j]),
                      int(counts_np[i, j]),
                      None if p_np is None else S.assemble_sum(
                          p_np[:, i, j], n_np[:, i, j]))
                     for i, j in zip(gi, gj)]
            return self._groupby_emit(fields, keyed, limit)

        return _Deferred(arrays, fin2)

    def _groupby_fold(self, fields, sts, filt, agg_st, limit):
        """GroupBy over 3+ fields or past the dense cap: fold left to
        right with the group planes on the device, pruning the empty
        groups between levels (one copy to the host per level and block
        of the first field; the reference walks nested iterators per
        shard, executor.go:3918).
        The first field streams per row block; deeper levels hold the
        nonzero groups only, as many as the data has."""
        keyed_all: List[Tuple] = []
        n0 = len(sts[0].row_ids)
        for lo, blk in sts[0].iter_blocks():
            hi = min(lo + sts[0].block_rows, n0)
            if hi <= lo:
                break
            group_planes = blk[: hi - lo]
            if filt is not None:
                group_planes = group_planes & filt[None, :]
            keys = [(r,) for r in sts[0].row_ids[lo:hi]]
            keyed_all.extend(self._fold_levels(sts, group_planes, keys,
                                               agg_st))
        keyed_all.sort(key=lambda kv: kv[0])
        return self._groupby_emit(fields, keyed_all, limit)

    @staticmethod
    def _fold_levels(sts, group_planes, keys, agg_st) -> List[Tuple]:
        """Fold one batch of level-0 group planes through the remaining
        fields: per level one pair_counts launch per row block of the
        next field, then a gather of the nonzero groups' planes. Returns
        (key, count, agg) of the nonzero groups, agg None without a Sum
        aggregate."""
        for level, st in enumerate(sts[1:], start=1):
            counts = _concat([pair_counts(group_planes, blk)
                              for _, blk in st.iter_blocks()], dim=1)
            counts = counts[:, :len(st.row_ids)].cpu().numpy()
            gi, gj = np.nonzero(counts)
            if level == len(sts) - 1 and agg_st is None:
                return [(keys[g] + (st.row_ids[r],), int(counts[g, r]), None)
                        for g, r in zip(gi, gj)]
            if gi.size == 0:
                return []
            sel = torch.as_tensor(gi, device=group_planes.device)
            group_planes = group_planes[sel] & st.take_rows(
                [st.row_ids[r] for r in gj])
            keys = [keys[g] + (st.row_ids[r],) for g, r in zip(gi, gj)]
        # each group's count, and with a Sum aggregate its per-plane
        # signed counts, in one launch
        side = B.ones_like_plane(group_planes)[None]
        if agg_st is not None:
            planes = agg_st.planes
            mags = planes[S.OFFSET:]
            side = torch.cat([side,
                              mags & (planes[S.EXISTS] & ~planes[S.SIGN]),
                              mags & (planes[S.EXISTS] & planes[S.SIGN])])
        cols = pair_counts(group_planes, side).cpu().numpy()
        depth = (cols.shape[1] - 1) // 2
        return [(keys[g], int(cols[g, 0]),
                 None if agg_st is None else S.assemble_sum(
                     cols[g, 1:1 + depth], cols[g, 1 + depth:]))
                for g in range(len(keys))]

    # -- Extract (reference: executor.go:4711 executeExtract) ------------------

    def _execute_extract(self, idx: Index, call: Call, shards
                         ) -> R.ExtractedTable:
        """Extract(bitmap, Rows(f)...): per column of the bitmap, each
        field's value (BSI), its rows (set, mutex) or its bool, walked on
        the host after one copy of the bitmap's plane."""
        if not call.children:
            raise PQLError("Extract requires a bitmap child")
        fields = [idx.field(self._field_name(c)) for c in call.children[1:]]
        efields = [R.ExtractedField(name=f.name, type=f.options.type.value)
                   for f in fields]
        columns: List[R.ExtractedColumn] = []
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return R.ExtractedTable(fields=efields, columns=columns)
        planes_np = self._host_planes(
            self._eval_all(idx, call.children[0], shard_list),
            len(shard_list))
        for si, shard in enumerate(shard_list):
            local = B.plane_to_bits(planes_np[si])
            if local.size == 0:
                continue
            base = shard * SHARD_WIDTH
            w = (local // 32).astype(np.int64)
            b = (local % 32).astype(np.uint32)
            per_field_vals: List[List[Any]] = []
            for f in fields:
                if f.options.type.is_bsi:
                    frag = f.bsi_fragment(shard)
                    vals: List[Any] = [None] * local.size
                    if frag is not None:
                        exists = ((frag.planes[S.EXISTS][w] >> b) & 1
                                  ).astype(bool)
                        vals = [f.from_stored(int(v)) if e else None
                                for v, e in zip(_bsi_values(frag, local),
                                                exists)]
                    per_field_vals.append(vals)
                    continue
                frag = f.fragment(shard)
                rows_per_col: List[Any] = [[] for _ in range(local.size)]
                if frag is not None:
                    for row in frag.existing_rows():
                        hit = ((frag.row_plane(row)[w] >> b) & 1).astype(bool)
                        for i in np.nonzero(hit)[0]:
                            rows_per_col[i].append(row)
                    if f.options.keys and not self.remote:
                        m = f.translate.translate_ids(
                            {r for rs in rows_per_col for r in rs})
                        rows_per_col = [[m.get(r, str(r)) for r in rs]
                                        for rs in rows_per_col]
                    if f.options.type == FieldType.BOOL:
                        rows_per_col = [bool(rs and rs[-1] == 1)
                                        for rs in rows_per_col]
                per_field_vals.append(rows_per_col)
            key_map = {}
            if idx.options.keys and not self.remote:
                key_map = idx.translate.translate_ids(
                    [int(base + c) for c in local])
            for i, c in enumerate(local):
                col_id = int(base + c)
                columns.append(R.ExtractedColumn(
                    column=col_id,
                    key=key_map.get(col_id) if idx.options.keys else None,
                    rows=[pv[i] for pv in per_field_vals]))
        return R.ExtractedTable(fields=efields, columns=columns)

    # -- Sort (reference: executor.go:9321 executeSort) ------------------------

    def _execute_sort(self, idx: Index, call: Call, shards) -> R.SortedRow:
        """Sort(filter?, field=f, sort-desc=bool, limit=n): record ids
        ordered by (value, column) of a bool or int-like field, decoded
        on the host (reference: executor.go:9387 executeSortShard +
        SortedRow.Merge)."""
        field = idx.field(self._field_name(call))
        desc = bool(call.arg("sort-desc", False))
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return R.SortedRow(columns=[], values=[])
        filt_np = None
        if call.children:
            filt_np = self._host_planes(
                self._eval_all(idx, call.children[0], shard_list),
                len(shard_list))
        cols: List[int] = []
        vals: List[Any] = []
        if field.options.type == FieldType.BOOL:
            for si, shard in enumerate(shard_list):
                frag = field.fragment(shard)
                if frag is None:
                    continue
                base = shard * SHARD_WIDTH
                for row, v in ((0, False), (1, True)):
                    plane = frag.row_plane(row)
                    if filt_np is not None:
                        plane = plane & filt_np[si]
                    for c in B.plane_to_bits(plane):
                        cols.append(int(base + c))
                        vals.append(v)
        elif field.options.type.is_bsi:
            for si, shard in enumerate(shard_list):
                frag = field.bsi_fragment(shard)
                if frag is None:
                    continue
                exists = frag.planes[S.EXISTS]
                if filt_np is not None:
                    exists = exists & filt_np[si]
                pos = B.plane_to_bits(exists)
                base = shard * SHARD_WIDTH
                cols.extend(int(base + p) for p in pos)
                vals.extend(field.from_stored(int(v))
                            for v in _bsi_values(frag, pos))
        else:
            raise PQLError(
                f"Sort supports bool and int-like fields, not "
                f"{field.options.type.value}")
        order = sorted(range(len(cols)),
                       key=lambda i: (vals[i], cols[i]), reverse=desc)
        limit = call.arg("limit")
        if limit is not None and not self.remote:
            order = order[: int(limit)]
        sorted_cols = [cols[i] for i in order]
        keys = None
        if idx.options.keys and not self.remote:
            m = idx.translate.translate_ids(sorted_cols)
            keys = [m.get(c, str(c)) for c in sorted_cols]
        return R.SortedRow(columns=sorted_cols,
                           values=[vals[i] for i in order], keys=keys)

    # -- FieldValue (reference: executor.go:942 executeFieldValueCall) ---------

    def _execute_field_value(self, idx: Index, call: Call) -> R.ValCount:
        fname = call.arg("field") or call.arg("_field")
        if not fname:
            raise PQLError("FieldValue requires field=")
        col = call.arg("column")
        if col is None:
            raise PQLError("FieldValue requires column=")
        field = idx.field(fname)
        c = self._col_id(idx, col)
        if c is None:
            return R.ValCount(val=None, count=0)
        if field.options.type == FieldType.BOOL:
            shard, pos = divmod(c, SHARD_WIDTH)
            frag = field.fragment(shard)
            if frag is None:
                return R.ValCount(val=None, count=0)
            w, b = divmod(pos, 32)
            for row in (1, 0):
                if frag.row_plane(row)[w] & (np.uint32(1) << np.uint32(b)):
                    return R.ValCount(val=bool(row), count=1)
            return R.ValCount(val=None, count=0)
        if not field.options.type.is_bsi:
            raise PQLError("FieldValue requires an int-like or bool field")
        v = field.value(c)
        if v is None:
            return R.ValCount(val=None, count=0)
        return R.ValCount(val=v, count=1)

    # -- ExternalLookup (reference: executor.go executeExternalLookup, a
    #    pass-through to an operator-configured external database) -------------

    def _execute_external_lookup(self, call: Call) -> Any:
        if self.external_lookup is None:
            raise PQLError(
                "ExternalLookup requires an external lookup backend "
                "(reference: server --lookup-db-dsn); none is configured")
        return self.external_lookup(call.arg("query"),
                                    bool(call.arg("write", False)))

    # -- Apply / Arrow (dataframe; reference: apply.go:121 executeApply,
    #    arrow.go:36 executeArrow) ---------------------------------------------

    def _execute_apply(self, idx: Index, call: Call, shards) -> Any:
        """Apply(filter?, "expr"): the expression (dataframe/expr.py)
        compiles once per source text and runs as eager torch ops over
        the shard-stacked columns on the device, the map and the
        cross-shard reduce together; a reduction comes back as one
        scalar."""
        # the expression string lands in _ivy (the reference's reserved
        # arg), in _args (after a filter child), or in _col (no filter)
        src = call.arg("_ivy") or call.arg("_args", [None])[0]
        if not isinstance(src, str):
            src = call.arg("_col")
        if not isinstance(src, str):
            raise PQLError("Apply requires an expression string argument")
        if len(call.children) > 1:
            raise PQLError("Apply() accepts a single bitmap filter")
        shard_list = self._shards(idx, shards)
        df_shards = [s for s in shard_list if s in idx.dataframe.frames]
        compiled = self._apply_cache.get(src)
        if compiled is None:
            fn, cols_used, is_red = compile_expr(src)
            compiled = self._apply_cache[src] = (fn, sorted(cols_used),
                                                 is_red)
            while len(self._apply_cache) > _APPLY_CACHE_ENTRIES:
                self._apply_cache.pop(next(iter(self._apply_cache)))
        fn, cols_used, is_red = compiled
        if not df_shards:
            return R.ApplyResult(value=0 if is_red else [])
        cols, valid, cap = idx.dataframe.device_columns(cols_used, df_shards)
        mask = valid
        if call.children:
            plane = self._eval_all(idx, call.children[0], df_shards)
            mask = mask & self._plane_to_mask(plane, len(df_shards), cap)
        out = fn(cols, mask)
        if is_red:
            return _Deferred([out], lambda v: R.ApplyResult(value=v.item()))
        return _Deferred([out[mask]], lambda v: R.ApplyResult(
            value=[float(x) for x in v]))

    @staticmethod
    def _plane_to_mask(plane: torch.Tensor, n_shards: int, cap: int
                       ) -> torch.Tensor:
        """Expand an ``int32[S*W]`` bitmap plane into ``bool[S, cap]``
        positions, LSB first. The shift is arithmetic on int32, and
        ``(w >> s) & 1`` is still bit ``s`` for every s in 0..31."""
        need_words = (cap + 31) // 32
        if isinstance(plane, SP.Split):
            # the dataframe's columns sit on one device (ROADMAP: a gather
            # left to run block by block)
            plane = plane.gather(plane.device)
        words = plane.reshape(n_shards, WORDS_PER_SHARD)[:, :need_words]
        shifts = torch.arange(32, dtype=torch.int32, device=plane.device)
        bits = (words[:, :, None] >> shifts) & 1
        return bits.reshape(n_shards, need_words * 32)[:, :cap] != 0

    def _execute_arrow(self, idx: Index, call: Call, shards) -> R.ArrowTable:
        """Arrow(filter?, header=[...]): the dataframe's values of the
        filtered records, walked on the host (reference: arrow.go:366
        executeArrowShard + header filterColumns)."""
        header = call.arg("header")
        shard_list = self._shards(idx, shards)
        df_shards = [s for s in shard_list if s in idx.dataframe.frames]
        schema = idx.dataframe.schema()
        if header:
            schema = [c for c in schema if c["name"] in set(header)]
        names = [c["name"] for c in schema]
        fields = [R.ExtractedField(name=c["name"], type=c["type"])
                  for c in schema]
        if not df_shards or not names:
            return R.ArrowTable(fields=fields, columns=[[] for _ in names])
        filt_np = None
        if call.children:
            filt_np = self._host_planes(
                self._eval_all(idx, call.children[0], df_shards),
                len(df_shards))
        ids: List[int] = []
        out_cols: List[List[Any]] = [[] for _ in names]
        for si, shard in enumerate(df_shards):
            frame = idx.dataframe.frames[shard]
            n = frame.length()
            present = np.zeros(n, dtype=bool)
            for name in names:
                v = frame.valid.get(name)
                if v is not None:
                    present[: v.size] |= v[:n]
            if filt_np is not None:
                fbits = np.unpackbits(
                    filt_np[si].view(np.uint8), bitorder="little")[:n]
                present &= fbits.astype(bool)
            pos = np.nonzero(present)[0]
            base = shard * SHARD_WIDTH
            ids.extend(int(base + p) for p in pos)
            for ci, name in enumerate(names):
                col = frame.columns.get(name)
                v = frame.valid.get(name)
                for p in pos:
                    if col is not None and p < col.size and v[p]:
                        x = col[p]
                        out_cols[ci].append(
                            int(x) if col.dtype.kind == "i" else float(x))
                    else:
                        out_cols[ci].append(None)
        return R.ArrowTable(fields=fields, columns=out_cols, ids=ids)

    # -- writes (reference: executor.go executeSet/Clear/Store) ----------------

    def _execute_write(self, idx: Index, call: Call, shards=None) -> Any:
        name = call.name
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "ClearRow":
            return self._execute_clear_row(idx, call, shards)
        if name == "Store":
            return self._execute_store(idx, call, shards)
        return self._execute_delete(idx, call, shards)

    def _host_planes(self, plane: torch.Tensor, n_shards: int) -> np.ndarray:
        """A device plane over the stacked shards as host ``uint32[S, W]``."""
        return plane.cpu().numpy().view(np.uint32).reshape(n_shards,
                                                           WORDS_PER_SHARD)

    def _execute_delete(self, idx: Index, call: Call, shards=None) -> int:
        """Delete the records the child bitmap selects that exist: clear
        their columns from every fragment of every field, existence and
        BSI planes included (reference: executor.go:9050
        executeDeleteRecords). Returns the number deleted."""
        if not call.children:
            raise PQLError("Delete requires a bitmap child")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return 0
        plane = self._eval_all(idx, call.children[0], shard_list)
        if idx.existence is not None:
            plane = B.plane_and(plane, self._existence_all(idx, shard_list))
        deleted = 0
        for shard, shard_plane in zip(
                shard_list, self._host_planes(plane, len(shard_list))):
            n = int(B.plane_to_bits(shard_plane).size)
            if n:
                deleted += n
                idx.delete_columns(shard, shard_plane)
        return deleted

    def _execute_set(self, idx: Index, call: Call) -> bool:
        col = call.arg("_col")
        if col is None:
            raise PQLError("Set requires a column")
        col = self._col_id(idx, col, create=True)
        fa = call.field_arg()
        if fa is None:
            raise PQLError("Set requires field=value")
        fname, value = fa
        field = idx.field(fname)
        if field.options.type.is_bsi:
            field.set_value(col, value)
            idx.add_exists(col)
            return True
        row = self._row_id(field, value, create=True)
        ts = call.arg("_timestamp")
        changed = field.set_bit(row, col,
                                timestamp=_parse_ts(ts) if ts else None)
        idx.add_exists(col)
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        col = self._col_id(idx, call.arg("_col"))
        if col is None:
            return False
        fa = call.field_arg()
        if fa is None:
            raise PQLError("Clear requires field=value")
        fname, value = fa
        field = idx.field(fname)
        if field.options.type.is_bsi:
            return field.clear_value(col)
        row = self._row_id(field, value)
        if row is None:
            return False
        return field.clear_bit(row, col)

    def _execute_clear_row(self, idx: Index, call: Call, shards=None) -> bool:
        fa = call.field_arg()
        if fa is None:
            raise PQLError("ClearRow requires field=row")
        fname, value = fa
        field = idx.field(fname)
        row = self._row_id(field, value)
        if row is None:
            return False
        if shards is None:
            return field.clear_row(row)
        changed = False
        for shard in sorted(set(shards) & field.shards()):
            for view in list(field.views):
                frag = field.fragment(shard, view)
                if frag is not None and frag.has_row(row):
                    field.write_row_plane(
                        shard, row, np.zeros(frag.words, dtype=np.uint32),
                        clear=True, view=view)
                    changed = True
        return changed

    def _execute_store(self, idx: Index, call: Call, shards=None) -> bool:
        """Store(bitmap, field=row): write the result as a row (reference:
        executor.go executeSetRow)."""
        fa = call.field_arg()
        if fa is None:
            raise PQLError("Store requires field=row")
        fname, value = fa
        field = idx.field(fname)
        if field.options.type.is_bsi:
            raise PQLError("Store targets a set field row")
        row = self._row_id(field, value, create=True)
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return True
        planes = self._host_planes(
            self._eval_all(idx, call.children[0], shard_list),
            len(shard_list))
        for shard, plane in zip(shard_list, planes):
            field.write_row_plane(shard, row, plane, clear=True)
        return True

"""PQL executor: lowers the call tree to launches over stacked shard
tensors, with one device->host copy per result.

Port of the read path of ``pilosa_tpu/pql/executor.py`` (reference:
executor.go, dispatch :679-841): ``Count`` over bitmap trees, the bitmap
calls Row / Intersect / Union / Difference / Xor / Not / All, ``TopN``
without ``from``/``to``, ``GroupBy`` over one or two ``Rows`` with an
optional ``filter=`` and no ``aggregate``, ``Options(shards=)``, and the
``StackStale`` retry. Every other call raises ``PQLError("not ported
yet: ...")``.

Key translation happens host-side around the kernels (reference:
executor.go:6814 preTranslate, :7519 translateResults).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_ROW, Index
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.core.stacked import StackStale, stacked_set
from pilosa_tpu_torch.errors import PQLError, not_ported
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import topk as T
from pilosa_tpu_torch.ops.groupby import masked_pair_counts, pair_counts
from pilosa_tpu_torch.pql import programs
from pilosa_tpu_torch.pql import result as R
from pilosa_tpu_torch.pql.ast import Call, Query
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

__all__ = ["Executor", "PQLError", "has_write_calls"]

_BITMAP_CALLS = {"Row", "Union", "Intersect", "Difference", "Xor", "Not",
                 "All"}

_WRITE_CALLS = {"Set", "Clear", "ClearRow", "Store", "Delete"}

#: calls of the JAX executor that later slices port
_LATER_CALLS = {"Sum", "Min", "Max", "Percentile", "Rows", "ConstRow",
                "UnionRows", "Shift", "Distinct", "Limit", "IncludesColumn",
                "Extract", "Apply", "Arrow", "Sort", "FieldValue",
                "ExternalLookup"} | _WRITE_CALLS


def has_write_calls(query) -> bool:
    """True if any call in the (parsed) query mutates data."""

    def walk(call) -> bool:
        if call.name in _WRITE_CALLS:
            return True
        return any(walk(c) for c in call.children)

    calls = query.calls if isinstance(query, Query) else [query]
    return any(walk(c) for c in calls)


class _Deferred:
    """A query result whose device tensors haven't been copied back yet:
    every call of a query launches before any result is fetched."""

    __slots__ = ("arrays", "finalize")

    def __init__(self, arrays: Sequence[torch.Tensor], finalize: Callable):
        self.arrays = list(arrays)
        self.finalize = finalize

    def resolve(self):
        return self.finalize(*[a.cpu().numpy() for a in self.arrays])


def _resolve(value):
    return value.resolve() if isinstance(value, _Deferred) else value


def _concat(parts, dim=0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class Executor:
    """Reference: executor.go:55."""

    def __init__(self, holder: Holder):
        self.holder = holder

    # -- public entry (reference: executor.go:183 Execute) --------------------

    def execute(self, index: str, query,
                shards: Optional[Sequence[int]] = None) -> List[Any]:
        idx = self.holder.index(index)
        if isinstance(query, str):
            query = parse(query)
        if isinstance(query, Call):
            query = Query([query])
        if has_write_calls(query):
            raise not_ported("PQL write calls (use API.import_bits)")
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
        return [_resolve(r) for r in raw]

    # -- dispatch (reference: executor.go:679 executeCall) --------------------

    def _execute_call(self, idx: Index, call: Call, shards=None) -> Any:
        name = call.name
        if name == "Options":
            if call.arg("shards") is not None:
                shards = [int(s) for s in call.arg("shards")]
            return self._execute_call(idx, call.children[0], shards)
        if name == "Count":
            return self._execute_count(idx, call, shards)
        if name in ("TopN", "TopK"):
            return self._execute_topn(idx, call, shards)
        if name == "GroupBy":
            return self._execute_groupby(idx, call, shards)
        if name in _BITMAP_CALLS:
            return self._materialize_row(idx, call, shards)
        if name in _LATER_CALLS:
            raise not_ported(name)
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

    def _row_id(self, field: Field, value) -> Optional[int]:
        if field.options.type == FieldType.BOOL:
            if isinstance(value, bool):
                return 1 if value else 0
            return int(value)
        if isinstance(value, str):
            if not field.options.keys:
                raise PQLError(
                    f"field {field.name!r} does not use string keys")
            return field.translate.find_keys([value]).get(value)
        if isinstance(value, bool):
            raise PQLError(f"field {field.name!r} is not bool")
        return int(value)

    # -- bitmap evaluation -------------------------------------------------------

    def _eval_all(self, idx: Index, call: Call, shard_list: List[int]
                  ) -> torch.Tensor:
        """The device plane of a bitmap call over all shards at once."""
        plane = programs.run_plane(self, idx, call, shard_list)
        if plane is None:
            raise not_ported("BSI range rows")
        return plane

    def _materialize_row(self, idx: Index, call: Call, shards) -> Any:
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return self._row_result(idx, [])
        plane = self._eval_all(idx, call, shard_list)

        def finalize(plane_np: np.ndarray):
            shaped = plane_np.view(np.uint32).reshape(len(shard_list),
                                                      WORDS_PER_SHARD)
            cols: List[int] = []
            for si, shard in enumerate(shard_list):
                base = shard * SHARD_WIDTH
                cols.extend(int(base + c) for c in B.plane_to_bits(shaped[si]))
            return self._row_result(idx, cols)

        return _Deferred([plane], finalize)

    def _row_result(self, idx: Index, cols: List[int]) -> R.RowResult:
        if idx.options.keys:
            m = idx.translate.translate_ids(cols)
            return R.RowResult(columns=[],
                               keys=[m.get(c, str(c)) for c in cols])
        return R.RowResult(columns=cols)

    # -- Count (reference: executor.go:5839 executeCount) ---------------------

    def _execute_count(self, idx: Index, call: Call, shards) -> Any:
        if len(call.children) != 1:
            raise PQLError("Count requires a single child call")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return 0
        # ops + popcount in ONE tape_count launch over resident planes
        count = programs.run_count(self, idx, call.children[0], shard_list)
        if count is None:
            raise not_ported("BSI range rows")
        return _Deferred([count], lambda c: int(c))

    # -- TopN / TopK (reference: executor.go:2357/2535) ------------------------

    def _field_name(self, call: Call) -> str:
        fname = call.arg("_field") or call.arg("field")
        if fname is None:
            raise PQLError(f"{call.name} requires a field")
        return fname

    def _execute_topn(self, idx: Index, call: Call, shards) -> Any:
        field = idx.field(self._field_name(call))
        if call.arg("from") is not None or call.arg("to") is not None:
            raise not_ported(f"{call.name} with from=/to= time ranges")
        n = call.arg("n") or call.arg("k")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return self._pairs_field(field, [])
        filt = (self._eval_all(idx, call.children[0], shard_list)
                if call.children else None)
        st = stacked_set(field, shard_list, timeq.VIEW_STANDARD)
        if not st.row_ids:
            return self._pairs_field(field, [])
        row_ids = st.row_ids
        counts = st.row_counts(filt)

        def finalize(counts_np: np.ndarray):
            ranked = [(row, int(counts_np[slot]))
                      for slot, row in enumerate(row_ids) if counts_np[slot]]
            ranked.sort(key=lambda kv: (-kv[1], kv[0]))
            if n is not None:
                ranked = ranked[: int(n)]
            return self._pairs_field(field, ranked)

        return _Deferred([counts], finalize)

    def _pairs_field(self, field: Field, ranked) -> R.PairsField:
        if field.options.keys:
            keys = field.translate.translate_ids([r for r, _ in ranked])
            pairs = [R.Pair(id=None, key=keys.get(r, str(r)), count=c)
                     for r, c in ranked]
        else:
            pairs = [R.Pair(id=r, key=None, count=c) for r, c in ranked]
        return R.PairsField(pairs=pairs, field=field.name)

    # -- GroupBy (reference: executor.go:3918 executeGroupByShard) -------------

    def _execute_groupby(self, idx: Index, call: Call, shards) -> Any:
        if not call.children:
            raise PQLError("GroupBy requires at least one Rows child")
        if any(c.name != "Rows" for c in call.children):
            raise PQLError("GroupBy children must be Rows calls")
        if call.arg("aggregate") is not None:
            raise not_ported("GroupBy aggregate")
        if len(call.children) > 2:
            raise not_ported("GroupBy over more than two fields")
        fields = [idx.field(self._field_name(c)) for c in call.children]
        limit = call.arg("limit")
        shard_list = self._shards(idx, shards)
        if not shard_list:
            return []
        sts = [stacked_set(f, shard_list, timeq.VIEW_STANDARD)
               for f in fields]
        if any(not st.row_ids for st in sts):
            return []
        cells = 1
        for st in sts:
            cells *= st.cap
        if cells > 1 << 24:  # the JAX package folds here instead
            raise not_ported("GroupBy over more than 2^24 dense cells")
        filter_call = call.arg("filter")
        filt = (self._eval_all(idx, filter_call, shard_list)
                if filter_call is not None else None)
        return self._groupby_dense(fields, sts, filt, limit)

    def _field_row(self, field: Field, row: int) -> R.FieldRow:
        if field.options.keys:
            key = field.translate.translate_ids([row]).get(row, str(row))
            return R.FieldRow(field=field.name, row_key=key)
        return R.FieldRow(field=field.name, row_id=row)

    def _groupby_emit(self, fields, keyed_counts, limit) -> List[R.GroupCount]:
        """GroupCounts of the nonzero groups in key order, cut at
        ``limit`` before any row is translated."""
        out = []
        for key, count in keyed_counts:
            if limit is not None and len(out) >= int(limit):
                break
            if count == 0:
                continue
            group = [self._field_row(f, r) for f, r in zip(fields, key)]
            out.append(R.GroupCount(group=group, count=count))
        return out

    def _groupby_dense(self, fields, sts, filt, limit):
        """1- and 2-field GroupBy: the whole result is a dense count
        tensor, streamed per row block through the pair_counts kernel
        (reference: executor.go:3176 per-pair container walk)."""
        if len(sts) == 1:
            counts = _concat([T.row_counts(blk, filt)
                              for _, blk in sts[0].iter_blocks()])

            def fin1(counts_np):
                keyed = [((row,), int(counts_np[slot]))
                         for slot, row in enumerate(sts[0].row_ids)]
                return self._groupby_emit(fields, keyed, limit)

            return _Deferred([counts], fin1)

        count_rows = []
        for _, a_blk in sts[0].iter_blocks():
            count_rows.append(_concat(
                [pair_counts(a_blk, b_blk) if filt is None
                 else masked_pair_counts(a_blk, b_blk, filt)
                 for _, b_blk in sts[1].iter_blocks()], dim=1))
        counts = _concat(count_rows, dim=0)  # [capA, capB]

        def fin2(counts_np):
            ra, rb = len(sts[0].row_ids), len(sts[1].row_ids)
            # row-major nonzero order IS key order (slots follow sorted
            # row ids), so the limit cuts before any tuple is built
            gi, gj = np.nonzero(counts_np[:ra, :rb])
            if limit is not None:
                gi, gj = gi[: int(limit)], gj[: int(limit)]
            keyed = [((sts[0].row_ids[i], sts[1].row_ids[j]),
                      int(counts_np[i, j])) for i, j in zip(gi, gj)]
            return self._groupby_emit(fields, keyed, limit)

        return _Deferred([counts], fin2)

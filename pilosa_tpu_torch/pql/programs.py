"""Per-query-family programs over resident device planes.

Port of ``pilosa_tpu/pql/programs.py``. A bitmap call tree lowers to an
*op tape* (a register machine whose initial registers are resident leaf
planes and whose ops are the four bitmap combinators); the tape plus its
terminal runs as one program from parallel/tape.py. ``Count`` is then ONE
launch of the tape_count kernel. Programs are cached per (kind, tape,
leaf count, masked, width) in a bounded LRU, so query *families* share
one checked program with different leaf planes.

Lowering never re-stages data: leaves are rows of the budget-managed
resident stacks (core/stacked.py), and a Range row (a ``Condition``, or
any row of an int-like field) is the output plane of one ``bsi_compare``
launch, composed as a leaf. A ``Row`` with ``from=``/``to=`` lowers, as
in the JAX package, to a zero leaf OR-chained with the row's plane in
each covering time view. ``ConstRow``, ``UnionRows`` and ``Shift``, which
the JAX package leaves to its per-op path, are evaluated by the executor
into one plane each and composed as a leaf, so a ``Count`` over them is
still one ``tape_count`` launch. The port has no classic per-op path
behind the tape: a malformed tree raises ``PQLError``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Tuple

import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.stacked import stacked_set
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.parallel import tape as T
from pilosa_tpu_torch.pql.ast import Condition, ROW_OPTIONS
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD


_PROGRAMS_CAP = 64
_PROGRAMS: "OrderedDict[Tuple, Callable]" = OrderedDict()
_PROGRAMS_LOCK = threading.Lock()


def _program(kind: str, tape: Tuple, n_leaves: int, masked: bool,
             total_words: int) -> Callable:
    key = (kind, tape, n_leaves, masked, total_words)
    with _PROGRAMS_LOCK:
        fn = _PROGRAMS.get(key)
        if fn is not None:
            _PROGRAMS.move_to_end(key)
            return fn
    if kind == "count":
        fn = T.compile_tape_count(tape, n_leaves, masked, total_words)
    else:
        fn = T.compile_tape_plane(tape, masked)
    with _PROGRAMS_LOCK:
        fn = _PROGRAMS.setdefault(key, fn)
        _PROGRAMS.move_to_end(key)
        while len(_PROGRAMS) > _PROGRAMS_CAP:
            _PROGRAMS.popitem(last=False)
    return fn


def program_cache_len() -> int:
    with _PROGRAMS_LOCK:
        return len(_PROGRAMS)


# ---------------------------------------------------------------------------
# Lowering: call tree -> (tape, leaves). Leaf refs are ("L", i) and op refs
# ("O", j) during lowering, remapped to flat register indices afterwards
# (leaves occupy registers [0, n); op j lands at n + j).
# ---------------------------------------------------------------------------


def _lower_root(ex, idx, call, shard_list: List[int], mask=None):
    """(tape, leaves) of a bitmap call. ``mask`` (a ShardMask) does not
    restrict the leaves, since bitmap algebra is column-local and the
    terminal ANDs the mask once; it reaches only the row-set leaves whose
    row selection depends on which columns count (a restricted ``Rows``
    inside ``UnionRows``, ``Shift``'s child), as in the JAX package's
    ``_eval_all``."""
    total_words = len(shard_list) * WORDS_PER_SHARD
    device = idx.device
    leaves: List[torch.Tensor] = []
    tape_raw: List[Tuple] = []

    def leaf(plane):
        leaves.append(plane)
        return ("L", len(leaves) - 1)

    def emit(op, a, b):
        tape_raw.append((op, a, b))
        return ("O", len(tape_raw) - 1)

    def lower_row(c):
        fa = c.field_arg(exclude=ROW_OPTIONS)
        if fa is None:
            raise PQLError("Row requires a field argument")
        fname, value = fa
        field = idx.field(fname)
        if isinstance(value, Condition) or field.options.type.is_bsi:
            # the compare kernel's output plane composes as a leaf
            return leaf(ex._eval_bsi_row(field, value, shard_list))
        row = ex._row_id(field, value)
        if row is None:  # unknown key -> empty row
            return leaf(B.device_zeros(total_words, device))
        views = ex._range_views(field, c)
        if views is not None:
            # the row's planes in the covering time views, OR-chained
            out = leaf(B.device_zeros(total_words, device))
            for v in views:
                st = stacked_set(field, shard_list, v)
                out = emit("or", out, leaf(st.row_plane(row)))
            return out
        st = stacked_set(field, shard_list, timeq.VIEW_STANDARD)
        return leaf(st.row_plane(row))

    def lower(c):
        name = c.name
        if name == "Row":
            return lower_row(c)
        if name in ("Union", "Xor"):
            if not c.children:
                return leaf(B.device_zeros(total_words, device))
            refs = [lower(ch) for ch in c.children]
            out = refs[0]
            opn = "or" if name == "Union" else "xor"
            for r in refs[1:]:
                out = emit(opn, out, r)
            return out
        if name == "Intersect":
            if not c.children:
                raise PQLError("Intersect requires at least one child")
            refs = [lower(ch) for ch in c.children]
            out = refs[0]
            for r in refs[1:]:
                out = emit("and", out, r)
            return out
        if name == "Difference":
            if not c.children:
                raise PQLError("Difference requires at least one child")
            out = lower(c.children[0])
            for ch in c.children[1:]:
                out = emit("andnot", out, lower(ch))
            return out
        if name == "Not":
            if len(c.children) != 1:
                raise PQLError("Not requires exactly one child")
            ex_ref = leaf(ex._existence_all(idx, shard_list))
            return emit("andnot", ex_ref, lower(c.children[0]))
        if name == "All":
            return leaf(ex._existence_all(idx, shard_list))
        if name in ("ConstRow", "UnionRows", "Shift"):
            return leaf(ex._eval_row_set(idx, c, shard_list, mask))
        if name == "Distinct":
            raise PQLError("Distinct cannot be nested inside bitmap calls yet")
        if name == "Limit":
            raise PQLError("Limit is only valid at the top level of a query")
        raise PQLError(f"call {name!r} does not return a bitmap")

    root = lower(call)
    n = len(leaves)

    def remap(ref):
        return ref[1] if ref[0] == "L" else n + ref[1]

    tape = tuple((op, remap(a), remap(b)) for op, a, b in tape_raw)
    root_idx = remap(root)
    if not tape or root_idx != n + len(tape) - 1:
        # the program returns the LAST register; or(x, x) == x pins the
        # root there when it isn't already (bare-leaf roots), and gives
        # the kernel the one op it needs
        tape = tape + (("or", root_idx, root_idx),)
    return tape, leaves


def _invoke(kind: str, tape: Tuple, n_leaves: int, masked: bool,
            total_words: int, fn, *args):
    """Run one program, attributing its launches (and, for a plane
    program, its eager op chain) to the tape's kernel family when the
    device profiler is on. The flag check is the whole disabled cost
    (``pilosa_tpu/pql/programs.py:219-227``)."""
    if not devprof.ENABLED:
        return fn(*args)
    with devprof.kernel_scope(kind, tape, n_leaves, masked, total_words):
        return fn(*args)


def run_count(ex, idx, call, shard_list: List[int], mask=None
              ) -> torch.Tensor:
    """Device count scalar for ``Count(call)``: one tape_count launch,
    with a ShardMask's plane as the kernel's mask operand."""
    tape, leaves = _lower_root(ex, idx, call, shard_list, mask)
    total_words = len(shard_list) * WORDS_PER_SHARD
    masked = mask is not None
    fn = _program("count", tape, len(leaves), masked, total_words)
    args = (*leaves, mask.plane) if masked else tuple(leaves)
    return _invoke("count", tape, len(leaves), masked, total_words, fn,
                   *args)


def run_plane(ex, idx, call, shard_list: List[int], mask=None,
              apply_mask: bool = True) -> torch.Tensor:
    """Materialized plane for a bitmap call, ANDed with a ShardMask's
    plane when one is given. ``apply_mask=False`` leaves the plane
    unmasked (a filter that its caller masks once at its aggregation
    point) and threads the mask only into row selection."""
    tape, leaves = _lower_root(ex, idx, call, shard_list, mask)
    total_words = len(shard_list) * WORDS_PER_SHARD
    masked = mask is not None and apply_mask
    fn = _program("plane", tape, len(leaves), masked, total_words)
    args = (*leaves, mask.plane) if masked else tuple(leaves)
    return _invoke("plane", tape, len(leaves), masked, total_words, fn,
                   *args)

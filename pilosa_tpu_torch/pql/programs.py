"""Per-query-family programs over resident device planes.

Port of ``pilosa_tpu/pql/programs.py``. A bitmap call tree lowers to an
*op tape* (a register machine whose initial registers are resident leaf
planes and whose ops are the four bitmap combinators); the tape plus its
terminal runs as one program from parallel/tape.py. ``Count`` is then ONE
launch of the tape_count kernel. Programs are cached per (kind, tape,
leaf count, masked, width) in a bounded LRU, so query *families* share
one checked program with different leaf planes.

Lowering never re-stages data: leaves are rows of the budget-managed
resident stacks (core/stacked.py). The port has no classic per-op path
behind the tape: a malformed tree raises ``PQLError``, calls of later
slices raise ``not ported yet``, and a BSI leaf bails (``None``) for the
executor to report.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.stacked import stacked_set
from pilosa_tpu_torch.errors import PQLError, not_ported
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.parallel import tape as T
from pilosa_tpu_torch.pql.ast import Condition, ROW_OPTIONS
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD


class _Bail(Exception):
    """Call tree holds a leaf the tape cannot express yet (a BSI range
    row); the executor reports it as not ported."""


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


# ---------------------------------------------------------------------------
# Lowering: call tree -> (tape, leaves). Leaf refs are ("L", i) and op refs
# ("O", j) during lowering, remapped to flat register indices afterwards
# (leaves occupy registers [0, n); op j lands at n + j).
# ---------------------------------------------------------------------------


def _lower_root(ex, idx, call, shard_list: List[int]):
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
        if isinstance(value, Condition):
            raise _Bail  # BSI compare leaf: the BSI slice lowers it
        if c.arg("from") is not None or c.arg("to") is not None:
            raise not_ported("Row with from=/to= time ranges")
        row = ex._row_id(field, value)
        if row is None:  # unknown key -> empty row
            return leaf(B.device_zeros(total_words, device))
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
        if name in ("ConstRow", "UnionRows", "Shift", "Distinct", "Limit"):
            raise not_ported(f"{name} inside a bitmap call")
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


def run_count(ex, idx, call, shard_list: List[int],
              mask: Optional[torch.Tensor] = None
              ) -> Optional[torch.Tensor]:
    """Device count scalar for ``Count(call)``: one tape_count launch;
    None when lowering bailed."""
    try:
        tape, leaves = _lower_root(ex, idx, call, shard_list)
    except _Bail:
        return None
    total_words = len(shard_list) * WORDS_PER_SHARD
    masked = mask is not None
    fn = _program("count", tape, len(leaves), masked, total_words)
    return fn(*leaves, mask) if masked else fn(*leaves)


def run_plane(ex, idx, call, shard_list: List[int],
              mask: Optional[torch.Tensor] = None
              ) -> Optional[torch.Tensor]:
    """Materialized (masked) plane for a bitmap call; None when
    lowering bailed."""
    try:
        tape, leaves = _lower_root(ex, idx, call, shard_list)
    except _Bail:
        return None
    total_words = len(shard_list) * WORDS_PER_SHARD
    masked = mask is not None
    fn = _program("plane", tape, len(leaves), masked, total_words)
    return fn(*leaves, mask) if masked else fn(*leaves)

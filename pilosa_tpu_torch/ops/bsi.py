"""Bit-sliced index (BSI) operations, and the ``bsi_compare`` kernel wrapper.

Port of ``pilosa_tpu/ops/bsi.py``. Integer, decimal and timestamp values
are stored as bit planes over the columns of a shard (reference:
fragment.go:62-66): ``planes[0]`` exists, ``planes[1]`` sign,
``planes[2 + k]`` magnitude bit k; values are sign-magnitude relative to
the field's base. On the device a stack is ``int32[2 + depth, W]``.

- Range predicates are one launch of the hand-written kernel in
  ``csrc/bsi_compare.cu`` on a CUDA tensor (the Pallas compare walk on the
  TPU), its plain PyTorch version on a CPU tensor.
- Sum is one ``pair_counts`` launch (the two sign classes against the
  magnitude planes) plus one ``tape_count`` of the filtered rows; the host
  assembles the exact sum with Python ints.
- Min, Max and Percentile walk the planes MSB->LSB with device tensors
  only: 0-d tensors carry every decision, popcounts go through
  ``tape_count``, and nothing is copied to the host inside a walk.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.groupby import pair_counts
from pilosa_tpu_torch.parallel import split as SP

EXISTS = 0
SIGN = 1
OFFSET = 2  # first magnitude plane (reference: fragment.go:66 bsiOffsetBit)

# Comparison ops (reference: pql/ast.go condition tokens; executor rangeOp
# dispatch fragment.go:937).
EQ, NE, LT, LE, GT, GE, BETWEEN = "eq", "ne", "lt", "le", "gt", "ge", "between"

#: op codes of csrc/bsi_compare.cu
_OPCODES = {EQ: 0, NE: 1, LT: 2, LE: 3, GT: 4, GE: 5, BETWEEN: 6}

#: the kernel's depth limit (one uint64 of constant bits per side)
MAX_DEPTH = 64


def value_bits(value: int, depth: int):
    """Host-side: split |value| into (bool[depth] LSB-first, overflow, neg).

    ``overflow`` means |value| >= 2^depth, beyond the representable
    magnitude (reference: fragment.go:963 rangeOp value clamping)."""
    neg = value < 0
    mag = -value if neg else value
    bits = np.array([(mag >> k) & 1 for k in range(depth)], dtype=bool)
    overflow = (mag >> depth) != 0
    return bits, overflow, neg


# ---------------------------------------------------------------------------
# Host-side encode (ingest path)
# ---------------------------------------------------------------------------


def bits_needed(value: int) -> int:
    """Magnitude bit-depth needed to store |value| (reference: roaring
    bitDepth calc in fragment.go importValue)."""
    return max(1, abs(int(value)).bit_length())


def encode_values(cols, values, depth: int, words: int) -> np.ndarray:
    """Host-side: a BSI plane stack ``uint32[2+depth, words]`` from (column
    offset, stored value) pairs (reference: fragment.go:1947 importValue).
    Callers dedupe columns; a magnitude past ``depth`` raises."""
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    mags = np.abs(values)
    if values.size and int(mags.max()) >> depth != 0:
        raise ValueError(
            f"value magnitude {int(mags.max())} exceeds bit depth {depth}")
    planes = np.zeros((OFFSET + depth, words), dtype=np.uint32)
    planes[EXISTS] = B.bits_to_plane(cols, words)
    planes[SIGN] = B.bits_to_plane(cols[values < 0], words)
    for k in range(depth):
        sel = (mags >> k) & 1 == 1
        if sel.any():
            planes[OFFSET + k] = B.bits_to_plane(cols[sel], words)
    return planes


def mask_filter(filt, mask_plane):
    """``filt & mask_plane`` where either may be None (the JAX package's
    superset fusion threads a shard mask through every aggregate this
    way)."""
    if mask_plane is None:
        return filt
    if filt is None:
        return mask_plane
    return filt & mask_plane


# ---------------------------------------------------------------------------
# The compare
# ---------------------------------------------------------------------------


def _sides(op: str, value: int, value2: Optional[int], depth: int):
    if op not in _OPCODES:
        raise ValueError(f"unknown op {op!r}")
    first = value_bits(int(value), depth)
    second = first if value2 is None else value_bits(int(value2), depth)
    return first, second


def _mag_compare(mags: torch.Tensor, cand: torch.Tensor, cbits, cover):
    """(lt, eq, gt) of the candidates' magnitudes against |c|, MSB->LSB
    (reference: fragment.go:1035 rangeLT et al.). The constant's bits are
    host values, so each step is one branch, as in the kernel."""
    zeros = torch.zeros_like(cand)
    if cover:  # |c| past the depth: every candidate is below it
        return cand, zeros, zeros
    eq, lt, gt = cand, zeros, zeros
    for k in range(mags.shape[0] - 1, -1, -1):
        pk = mags[k]
        if cbits[k]:
            lt = lt | (eq & ~pk)
            eq = eq & pk
        else:
            gt = gt | (eq & pk)
            eq = eq & ~pk
    return lt, eq, gt


def bsi_compare_plain(planes: torch.Tensor, op: str, value: int,
                      value2: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the circuit of
    ``pilosa_tpu/ops/bsi.py:93-135`` ``_compare_kernel``, one eager op per
    plane and class."""
    depth = planes.shape[0] - OFFSET
    (cb, co, cn), (cb2, co2, cn2) = _sides(op, value, value2, depth)
    exists, sign, mags = planes[EXISTS], planes[SIGN], planes[OFFSET:]
    neg_rows = exists & sign
    pos_rows = exists & ~sign

    def signed_partition(cbits, cover, cneg):
        plt, peq, pgt = _mag_compare(mags, pos_rows, cbits, cover)
        nlt, neq, ngt = _mag_compare(mags, neg_rows, cbits, cover)
        if cneg:  # positives all > c; negatives by reversed magnitude
            return ngt, neq, pos_rows | nlt
        return neg_rows | plt, peq, pgt

    lt, eq, gt = signed_partition(cb, co, cn)
    if op == EQ:
        return eq
    if op == NE:
        return exists & ~eq
    if op == LT:
        return lt
    if op == LE:
        return lt | eq
    if op == GT:
        return gt
    if op == GE:
        return gt | eq
    lt2, eq2, _ = signed_partition(cb2, co2, cn2)
    return (gt | eq) & (lt2 | eq2)


bsi_compare_launches = KU.LaunchCounter("bsi_compare")


def _side_struct(side, bits, overflow, neg) -> None:
    side.bits = int(sum(1 << k for k, b in enumerate(bits) if b))
    side.overflow = int(bool(overflow))
    side.neg = int(bool(neg))


def bsi_compare(planes: torch.Tensor, op: str, value: int,
                value2: Optional[int] = None) -> torch.Tensor:
    """Columns of a BSI stack ``int32[2+depth, W]`` whose stored value
    satisfies ``op`` against ``value`` (``[value, value2]`` for BETWEEN),
    as an EXISTS-masked plane ``int32[W]``. Values are in stored space
    (the caller subtracts the field base).

    CUDA tensors: one launch of csrc/bsi_compare.cu (replaces
    pilosa_tpu/ops/bsi.py:138/:197). CPU tensors:
    :func:`bsi_compare_plain`. A split stack (the engine mesh): one of
    those per block, the planes split alike."""
    if isinstance(planes, SP.Split):
        return SP.map_split(
            lambda p: bsi_compare(p, op, value, value2), planes)
    depth = planes.shape[0] - OFFSET
    with KU.kernel_scope("cmp", depth, 2 if op == BETWEEN else 1,
                         OFFSET + depth, planes.shape[-1], planes) as prof:
        if not KU.on_card("bsi_compare", planes):
            return bsi_compare_plain(planes, op, value, value2)
        KU.check_words("bsi_compare", "planes", planes, 2)
        if not 1 <= depth <= MAX_DEPTH:
            raise ValueError(f"bsi_compare: depth {depth} outside "
                             f"1..{MAX_DEPTH}")
        w = planes.shape[1]
        if w == 0:
            raise ValueError("bsi_compare: empty stack")
        first, second = _sides(op, value, value2, depth)
        out = torch.empty(w, dtype=torch.int32, device=planes.device)
        desc = KU.BsiDesc()
        desc.planes, desc.out, desc.w = planes.data_ptr(), out.data_ptr(), w
        desc.depth, desc.op = depth, _OPCODES[op]
        _side_struct(desc.side[0], *first)
        _side_struct(desc.side[1], *second)
        with torch.cuda.device(planes.device):
            rc = KU.lib().pk_bsi_compare(ctypes.byref(desc),
                                         KU.stream(planes), prof.timing)
        KU.check(rc, "bsi_compare")
    bsi_compare_launches.bump()
    return out


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------


def _count(plane: torch.Tensor) -> torch.Tensor:
    """Popcount of one plane (0-d int32) through the tape_count kernel."""
    return B.tape_count((("or", 0, 0),), [plane])


def _count_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return B.tape_count((("and", 0, 1),), [a, b])


def _count_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return B.tape_count((("andnot", 0, 1),), [a, b])


def _any(t: torch.Tensor) -> torch.Tensor:
    """0-d bool: any bit set (stays on the device)."""
    return (t != 0).any()


def bsi_plane_popcounts(planes: torch.Tensor, filt: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, pos_counts[depth], neg_counts[depth]) of the filtered
    columns: one pair_counts launch with A = the two sign classes and B =
    the magnitude planes (a view of the stack), and one one-leaf
    tape_count of the filtered rows. int32 device tensors; the host
    finishes the exact sum with :func:`finish_sum` (reference:
    fragment.go:724 sum)."""
    rows = planes[EXISTS] & filt
    sign = planes[SIGN]
    a = torch.stack([rows & ~sign, rows & sign])
    c = pair_counts(a, planes[OFFSET:])
    return _count(rows), c[0], c[1]


def assemble_sum(pos_counts, neg_counts) -> int:
    """Exact ``Σ (pos[k] - neg[k]) << k`` with Python ints."""
    total = 0
    for k in range(len(pos_counts)):
        total += (int(pos_counts[k]) - int(neg_counts[k])) << k
    return total


def finish_sum(count, pos_counts, neg_counts) -> Tuple[int, int]:
    """Exact (stored sum, count) from host copies of
    :func:`bsi_plane_popcounts`' results."""
    return assemble_sum(pos_counts, neg_counts), int(count)


def _walk_max_mag(S: torch.Tensor, mags: torch.Tensor):
    """Narrow ``S`` to its columns of maximal magnitude; (bits bool[depth]
    LSB-first, final set)."""
    depth = mags.shape[0]
    bits = [None] * depth
    for k in range(depth - 1, -1, -1):
        t = S & mags[k]
        ne = _any(t)
        S = torch.where(ne, t, S)
        bits[k] = ne
    return torch.stack(bits), S


def _walk_min_mag(S: torch.Tensor, mags: torch.Tensor):
    """Narrow ``S`` to its columns of minimal magnitude."""
    depth = mags.shape[0]
    bits = [None] * depth
    for k in range(depth - 1, -1, -1):
        t = S & ~mags[k]
        ne = _any(t)
        S = torch.where(ne, t, S)
        bits[k] = ~ne  # no candidate with the bit clear: all have it set
    return torch.stack(bits), S


def bsi_minmax(planes: torch.Tensor, filt: torch.Tensor, want_max: bool):
    """(bits bool[depth] LSB-first, negative, count at the extreme, total)
    of the filtered columns, all device tensors: the port of
    ``pilosa_tpu/ops/bsi.py:427`` ``_minmax_kernel`` (reference:
    fragment.go:754-857)."""
    exists, sign, mags = planes[EXISTS], planes[SIGN], planes[OFFSET:]
    rows = exists & filt
    neg = rows & sign
    pos = rows & ~sign
    if want_max:
        # max: largest positive if any, else least-magnitude negative
        has_pos = _any(pos)
        pbits, pS = _walk_max_mag(pos, mags)
        nbits, nS = _walk_min_mag(neg, mags)
        bits = torch.where(has_pos, pbits, nbits)
        final = torch.where(has_pos, pS, nS)
        negative = ~has_pos
    else:
        # min: largest-magnitude negative if any, else smallest positive
        has_neg = _any(neg)
        nbits, nS = _walk_max_mag(neg, mags)
        pbits, pS = _walk_min_mag(pos, mags)
        bits = torch.where(has_neg, nbits, pbits)
        final = torch.where(has_neg, nS, pS)
        negative = has_neg
    return bits, negative, _count(final), _count(rows)


def bsi_kth(planes: torch.Tensor, filt: torch.Tensor, nth_times_100: int):
    """The value at percentile ``nth`` (scaled x100) of the filtered
    columns, on the device: the port of ``pilosa_tpu/ops/bsi.py:466``
    ``_kth_kernel``. Ascending order is negatives by descending magnitude,
    then positives by ascending magnitude; rank r = max(1, ceil(nth/100 *
    total)), clipped to total. Each result bit costs two fused popcounts.

    Returns (bits bool[depth] LSB-first, negative, count of the value,
    total), device tensors."""
    exists = planes[EXISTS] & filt
    sign, mags = planes[SIGN], planes[OFFSET:]
    neg = exists & sign
    pos = exists & ~sign
    neg_n = _count(neg).long()
    total = neg_n + _count(pos).long()
    # ceil(nth/100 * total) exactly, as the JAX package splits it
    q, rem = total // 10000, total % 10000
    rank = nth_times_100 * q + (nth_times_100 * rem + 9999) // 10000
    rank = torch.minimum(torch.clamp(rank, min=1), total)
    is_neg = rank <= neg_n
    S = torch.where(is_neg, neg, pos)
    # within-class rank, from the large-magnitude end for negatives and
    # the small-magnitude end for positives
    k = torch.where(is_neg, rank, rank - neg_n)
    bits = []
    for d in range(mags.shape[0] - 1, -1, -1):
        m = mags[d]
        c_hi = _count_and(S, m).long()
        c_lo = _count_andnot(S, m).long()
        take_hi = torch.where(is_neg, c_hi >= k, c_lo < k)
        k = torch.where(take_hi, torch.where(is_neg, k, k - c_lo),
                        torch.where(is_neg, k - c_hi, k))
        S = S & torch.where(take_hi, m, ~m)
        bits.append(take_hi)
    bits.reverse()
    return torch.stack(bits), is_neg, _count(S), total.to(torch.int32)


def assemble(bits, negative) -> int:
    """Signed stored value from LSB-first magnitude bits."""
    v = 0
    for k, b in enumerate(np.asarray(bits)):
        if b:
            v |= 1 << k
    return -v if negative else v


def finish_value(bits, negative, count, total) -> Tuple[int, int, int]:
    """(stored value, count achieving it, total filtered count) from host
    copies of a :func:`bsi_minmax` or :func:`bsi_kth` walk; (0, 0, 0)
    over an empty set, as the JAX package's ``bsi_min``/``bsi_max``."""
    if int(total) == 0:
        return 0, 0, 0
    return assemble(bits, bool(negative)), int(count), int(total)

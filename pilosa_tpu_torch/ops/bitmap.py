"""Dense bitmap-plane algebra, and the ``tape_count`` kernel wrapper.

Port of ``pilosa_tpu/ops/bitmap.py``. A *plane* is one bitmap row of one
shard: ``WORDS_PER_SHARD`` words where bit ``b`` of word ``w`` is column
``w*32 + b`` of the shard (LSB-first). On the host a plane is
``np.uint32``; on a device it is ``torch.int32`` with the same bits, so
right shifts are masked to act as logical shifts.

``tape_count`` is the count terminal of every ``Count`` over a bitmap
tree: one launch of the hand-written kernel in ``csrc/tape_count.cu`` on a
CUDA tensor, its plain PyTorch version below on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

# ---------------------------------------------------------------------------
# Construction / conversion (host-side helpers, numpy)
# ---------------------------------------------------------------------------


def bits_to_plane(cols, words: int = WORDS_PER_SHARD) -> np.ndarray:
    """Build a plane from column offsets (host-side, used by ingest;
    reference: roaring/roaring.go:2380 ImportRoaringBits)."""
    plane = np.zeros(words, dtype=np.uint32)
    cols = np.asarray(cols, dtype=np.int64)
    if cols.size:
        native.scatter_bits(plane, cols)
    return plane


def plane_to_bits(plane) -> np.ndarray:
    """Column offsets set in a host plane (result materialization)."""
    return native.plane_to_bits(np.asarray(plane, dtype=np.uint32))


def shard_mask_plane(shard_list, subset, words: int = WORDS_PER_SHARD
                     ) -> np.ndarray:
    """Word-lane mask over a stacked layout: ``uint32[S*W]`` with
    0xFFFFFFFF on the words of shards in ``subset`` and 0 elsewhere."""
    sel = np.fromiter((s in subset for s in shard_list), dtype=bool,
                      count=len(shard_list))
    full = np.where(sel, np.uint32(0xFFFFFFFF), np.uint32(0))
    return np.repeat(full, words).astype(np.uint32)


# One shared all-zeros / all-ones device plane per (device, words),
# LRU-bounded. Callers never write to them.
_CONST_CAP = 8
_CONST: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
_CONST_LOCK = threading.Lock()


def _const_plane(words: int, device: torch.device, fill: int) -> torch.Tensor:
    key = (str(device), words, fill)
    with _CONST_LOCK:
        t = _CONST.get(key)
        if t is not None:
            _CONST.move_to_end(key)
            return t
    t = torch.full((words,), fill, dtype=torch.int32, device=device)
    with _CONST_LOCK:
        t = _CONST.setdefault(key, t)
        while len(_CONST) > _CONST_CAP:
            _CONST.popitem(last=False)
    return t


def device_zeros(words: int, device: torch.device) -> torch.Tensor:
    """Shared device zeros plane (bounded cache)."""
    return _const_plane(words, device, 0)


def device_ones(words: int, device: torch.device) -> torch.Tensor:
    """Shared device all-ones plane (every bit set)."""
    return _const_plane(words, device, -1)


# ---------------------------------------------------------------------------
# Boolean algebra (device; reference roaring/roaring.go:711-1629)
# ---------------------------------------------------------------------------


def plane_and(a, b):
    return torch.bitwise_and(a, b)


def plane_or(a, b):
    return torch.bitwise_or(a, b)


def plane_xor(a, b):
    return torch.bitwise_xor(a, b)


def plane_andnot(a, b):
    """a AND NOT b (reference: roaring/roaring.go:1564 Difference)."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


def plane_not(a, existence):
    """NOT within an index: existence ANDNOT a (reference: executor.go
    executeNot)."""
    return plane_andnot(existence, a)


def plane_shift(a: torch.Tensor) -> torch.Tensor:
    """Shift all columns by +1 along the last axis (reference:
    roaring/roaring.go:1629 Shift). The top bit of each word carries into
    the next word; the bit shifted past the end of a row is dropped, so
    ``[S, W]`` shifts each shard on its own, as the JAX package's
    ``vmap`` does. ``>> 31`` on int32 fills with the sign, so the carry
    is masked to one bit."""
    zero = torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    carry = torch.cat([zero, (a[..., :-1] >> 31) & 1], dim=-1)
    return (a << 1) | carry


def rows_or(planes: torch.Tensor) -> torch.Tensor:
    """OR of the rows of ``[R, W]`` (R >= 1) into one ``[W]`` plane: a
    fold in halves, ceil(log2 R) ops (torch has no OR reduction)."""
    while planes.shape[0] > 1:
        half = planes.shape[0] // 2
        folded = planes[:half] | planes[half:2 * half]
        if planes.shape[0] % 2:
            folded[0] |= planes[-1]
        planes = folded
    return planes[0]


# ---------------------------------------------------------------------------
# Popcount reductions (plain PyTorch)
# ---------------------------------------------------------------------------


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of an int32 tensor (torch has no popcount op).
    SWAR on the words widened to int64, so no step can overflow or carry
    the sign; returns int32 counts of the same shape."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def plane_count(a: torch.Tensor) -> torch.Tensor:
    """Total set bits (reference: roaring Count)."""
    return popcount(a).sum()


def plane_intersection_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b) (reference: roaring/roaring.go:711): on CUDA
    tensors one ``tape_count`` launch of the one-op tape ``("and", 0,
    1)``, as the JAX package fuses the AND into one reduce; on CPU
    tensors :func:`plane_intersection_count_plain`."""
    if not KU.on_card("plane_intersection_count", a, b):
        return plane_intersection_count_plain(a, b)
    return tape_count(_AND_TAPE, (a, b))


def plane_intersection_count_plain(a: torch.Tensor, b: torch.Tensor
                                   ) -> torch.Tensor:
    """Plain PyTorch ``popcount(a AND b)``, the reference the card's
    path is held to."""
    return popcount(a & b).sum()


# ---------------------------------------------------------------------------
# Op tapes and the tape_count kernel
# ---------------------------------------------------------------------------

_OPCODES = {"and": 0, "or": 1, "xor": 2, "andnot": 3}

#: the one-op tape of an intersection count
_AND_TAPE = (("and", 0, 1),)


def tape_eval(tape: Sequence[Tuple[str, int, int]], leaves):
    """Run an op tape over leaf planes. regs[0..n-1] are the leaves; each
    ("and"|"or"|"xor"|"andnot", i, j) op appends a register; the last
    register is the result (pilosa_tpu/parallel/mesh.py:250)."""
    return tape_registers(tape, leaves)[-1]


def tape_registers(tape: Sequence[Tuple[str, int, int]], leaves) -> list:
    """Every register of :func:`tape_eval`: the leaves, then one plane
    per op."""
    regs = list(leaves)
    for op, i, j in tape:
        a, b = regs[i], regs[j]
        if op == "and":
            regs.append(a & b)
        elif op == "or":
            regs.append(a | b)
        elif op == "xor":
            regs.append(a ^ b)
        elif op == "andnot":
            regs.append(a & ~b)
        else:  # an unknown op is a compiler bug, not data
            raise ValueError(f"unknown tape op {op!r}")
    return regs


def tape_fits(tape, n_leaves: int) -> bool:
    """Whether a tape is within the kernel's size limits (TapeOps)."""
    return 1 <= n_leaves <= KU.MAX_LEAVES and len(tape) <= KU.MAX_OPS


def check_tape(tape, n_leaves: int) -> None:
    """Reject tapes the kernel cannot take (limits of TapeOps)."""
    if not tape:
        raise ValueError("tape must hold at least one op")
    if not 1 <= n_leaves <= KU.MAX_LEAVES:
        raise ValueError(f"tape takes 1..{KU.MAX_LEAVES} leaves, "
                         f"got {n_leaves}")
    if len(tape) > KU.MAX_OPS:
        raise ValueError(f"tape longer than {KU.MAX_OPS} ops")
    for k, (op, i, j) in enumerate(tape):
        if op not in _OPCODES:
            raise ValueError(f"unknown tape op {op!r}")
        if not (0 <= i < n_leaves + k and 0 <= j < n_leaves + k):
            raise ValueError(f"tape op {k} reads an unwritten register")


@functools.lru_cache(maxsize=4096)
def encode_tape(tape, n_leaves: int) -> "KU.TapeOps":
    """The op list as the kernel reads it, checked by :func:`check_tape`
    and encoded once per (tape, leaf count); a tape is a tuple of (op, i,
    j) tuples. The kernel sends a one-op tape down its one-op path, any
    other down its general path."""
    check_tape(tape, n_leaves)
    ops = KU.TapeOps()
    ops.n_leaves, ops.n_ops = n_leaves, len(tape)
    for k, (op, i, j) in enumerate(tape):
        ops.op[k], ops.a[k], ops.b[k] = _OPCODES[op], i, j
    return ops


tape_count_launches = KU.LaunchCounter("tape_count")


def tape_count_plain(tape, leaves, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version of the tape_count kernel: one eager op per
    tape op, then the popcount reduce. 0-d int32."""
    out = tape_eval(tape, leaves)
    if mask is not None:
        out = out & mask
    return plane_count(out).to(torch.int32)


def tape_count(tape, leaves: Sequence[torch.Tensor],
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``popcount(tape(leaves) [& mask])`` as a 0-d int32 tensor.

    CUDA tensors: one launch of csrc/tape_count.cu, which replaces
    pilosa_tpu/ops/bitmap.py:209/:224 with the tape fused in, and no
    other device operation (the output is not zeroed first). CPU
    tensors: :func:`tape_count_plain`."""
    ops = encode_tape(tape, len(leaves))
    operands = list(leaves) if mask is None else [*leaves, mask]
    # a launch of the calling thread's tape family (pql/programs.py)
    with KU.launch_scope(operands[0]) as prof:
        if not KU.on_card("tape_count", *operands):
            return tape_count_plain(tape, leaves, mask)
        n = operands[0].numel()
        for t in operands:
            KU.check_words("tape_count", "leaf", t, 1)
            if t.numel() != n:
                raise ValueError("tape_count: leaves differ in length")
        dev = operands[0].device
        out = torch.empty((), dtype=torch.int32, device=dev)
        ptrs = (ctypes.c_void_p * len(leaves))(*[t.data_ptr()
                                                 for t in leaves])
        stream = KU.stream(out)
        rc = KU.lib().pk_tape_count(
            ctypes.byref(ops), ptrs,
            None if mask is None else mask.data_ptr(), n, out.data_ptr(),
            KU.tape_scratch(dev, stream), dev.index, stream, prof.timing)
        KU.check(rc, "tape_count")
    tape_count_launches.bump()
    return out

"""A tensor split over the engine mesh: its last axis in contiguous blocks.

The JAX package places every stacked tensor ``[..., S*W]`` of the engine
with ``P((shards, cols))`` on its last axis: position ``k`` of the mesh,
in row-major order, holds words ``[k*L, (k+1)*L)``. XLA then partitions
each jitted kernel from those shardings. PyTorch has no partitioner, so
the port carries the placement in a value of its own, :class:`Split`,
and every operation the engine runs on a plane maps over its blocks:

* the bitwise operators, comparisons with a scalar, ``torch.where``,
  ``torch.cat`` / ``torch.stack`` of planes along a leading axis, and
  indexing, ``index_select`` / ``index_copy_`` and reshapes of the
  leading axes run block by block, each under its block's device;
* a kernel wrapper given split operands launches once per block and
  sums the ``int32`` partials on the first position (:func:`psum`), as
  the JAX mesh sums its ``lax.psum``;
* :meth:`Split.cpu` (and :func:`d2h`) read the blocks back to the host
  and concatenate them there; :meth:`Split.gather` puts the whole tensor
  on one device and counts the bytes in :data:`GATHER_STATS`, so a test
  can show that a path never gathers.

An operation that would mix the blocks along the split axis (a reduce
over it, a slice of it, a reshape that cuts it) raises ``TypeError``
instead of gathering. A plain tensor operand must be a 0-d scalar (moved
to each block's device); a whole plane on one device never meets a split
one. The module imports nothing of the port's ops, so the kernel
wrappers can import it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import numpy as np
import torch

from pilosa_tpu_torch import platform

#: whole tensors put on one device by :meth:`Split.gather` (calls, bytes)
GATHER_STATS = {"calls": 0, "bytes": 0}


def on(device: torch.device):
    """Launch context of a block: its card as the current device (the
    launchers use the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to(x, device: torch.device):
    """A per-block operand: 0-d tensors move to the block's device,
    Python scalars pass; a plain tensor with a word axis never mixes with
    blocks."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0:
            raise TypeError(
                "a plane on one device cannot meet a split plane; place it "
                "with parallel.mesh.engine_put")
        return x.to(device)
    return x


class Split:
    """A tensor ``[..., N]`` whose last axis lies in ``len(blocks)``
    contiguous blocks, block ``k`` on the ``k``-th device of ``mesh`` in
    row-major order. Every block has the same leading shape and width."""

    __slots__ = ("blocks", "mesh", "shape")

    def __init__(self, blocks: Sequence[torch.Tensor], mesh):
        self.blocks = list(blocks)
        self.mesh = mesh
        lead = tuple(self.blocks[0].shape[:-1])
        width = 0
        for b in self.blocks:
            if tuple(b.shape[:-1]) != lead:
                raise ValueError("split blocks differ in leading shape")
            width += b.shape[-1]
        self.shape = torch.Size(lead + (width,))

    # -- tensor surface ---------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first position's device: where partial sums land."""
        return self.blocks[0].device

    @property
    def is_cuda(self) -> bool:
        return self.blocks[0].is_cuda

    @property
    def n(self) -> int:
        return len(self.blocks)

    @property
    def widths(self) -> List[int]:
        return [b.shape[-1] for b in self.blocks]

    def offsets(self) -> List[int]:
        """Global start of each block on the split axis."""
        out, o = [], 0
        for b in self.blocks:
            out.append(o)
            o += b.shape[-1]
        return out

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks)

    def __repr__(self) -> str:
        return (f"Split(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"blocks={self.n}, devices="
                f"{[str(b.device) for b in self.blocks]})")

    # -- block maps ---------------------------------------------------------

    def like(self, blocks: Sequence[torch.Tensor]) -> "Split":
        return Split(blocks, self.mesh)

    def map(self, fn: Callable, *others) -> "Split":
        """``fn(block, *others' blocks)`` per block, under the block's
        device; ``others`` are splits of this layout or scalars."""
        return self.like(self.each(fn, *others))

    def each(self, fn: Callable, *others) -> list:
        """The list of ``fn(block, *others' blocks)``, one per block."""
        for o in others:
            if isinstance(o, Split):
                self.check_aligned(o)
        out = []
        for k, b in enumerate(self.blocks):
            args = [o.blocks[k] if isinstance(o, Split) else _to(o, b.device)
                    for o in others]
            with on(b.device):
                out.append(fn(b, *args))
        return out

    def check_aligned(self, other: "Split") -> None:
        if (other.n != self.n or other.widths != self.widths
                or any(a.device != b.device
                       for a, b in zip(self.blocks, other.blocks))):
            raise ValueError(f"split layouts differ: {self!r} vs {other!r}")

    # -- elementwise --------------------------------------------------------

    def __and__(self, o):
        return self.map(torch.bitwise_and, o)

    def __or__(self, o):
        return self.map(torch.bitwise_or, o)

    def __xor__(self, o):
        return self.map(torch.bitwise_xor, o)

    def __invert__(self):
        return self.map(torch.bitwise_not)

    def __ne__(self, o):  # type: ignore[override]
        return self.map(lambda b, s: b != s, o)

    def __ior__(self, o):
        self.each(lambda b, x: b.bitwise_or_(x), o)
        return self

    bitwise_or_ = __ior__

    def any(self) -> torch.Tensor:
        """0-d bool on the first device: any element set."""
        parts = self.each(lambda b: b.any())
        return torch.stack([p.to(self.device) for p in parts]).any()

    def contiguous(self) -> "Split":
        return self.map(lambda b: b.contiguous())

    # -- the leading axes ---------------------------------------------------

    def _lead_key(self, key):
        """``key`` for one block: it must leave the split (last) axis
        whole. Index tensors move to each block's device."""
        parts = key if isinstance(key, tuple) else (key,)
        if any(p is Ellipsis for p in parts):
            raise TypeError("a split takes no Ellipsis index")
        real = [p for p in parts if p is not None]
        whole = (isinstance(real[-1], slice) and real[-1] == slice(None)
                 if real else True)
        if len(real) > self.ndim or (len(real) == self.ndim and not whole):
            raise TypeError(
                f"index {key!r} cuts the split axis of {self!r}; read it "
                "with cpu() or gather()")
        return parts

    def _block_key(self, parts, device):
        out = tuple(p.to(device) if isinstance(p, torch.Tensor)
                    else (torch.as_tensor(p, device=device)
                          if isinstance(p, (np.ndarray, list)) else p)
                    for p in parts)
        return out if len(out) != 1 else out[0]

    def __getitem__(self, key) -> "Split":
        parts = self._lead_key(key)
        return self.map(lambda b: b[self._block_key(parts, b.device)])

    def __setitem__(self, key, value) -> None:
        parts = self._lead_key(key)

        def put(b, v):
            b[self._block_key(parts, b.device)] = v

        self.each(put, value)

    def index_select(self, dim: int, index) -> "Split":
        dim = self._lead_dim(dim)
        return self.map(lambda b: b.index_select(
            dim, torch.as_tensor(index, device=b.device)))

    def index_copy_(self, dim: int, index, src: "Split") -> "Split":
        dim = self._lead_dim(dim)
        self.each(lambda b, s: b.index_copy_(
            dim, torch.as_tensor(index, device=b.device), s), src)
        return self

    def _lead_dim(self, dim: int) -> int:
        d = dim % self.ndim
        if d == self.ndim - 1:
            raise TypeError(f"dim {dim} is the split axis of {self!r}")
        return d

    def reshape(self, *shape) -> "Split":
        """A reshape of the leading axes; the last axis must stay whole
        (given as -1 or its length)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if shape[-1] not in (-1, self.shape[-1]) or -1 in shape[:-1]:
            raise TypeError(f"reshape {shape} cuts the split axis of "
                            f"{self!r}; read it with cpu() or gather()")
        lead = tuple(shape[:-1])
        return self.map(lambda b: b.reshape(*lead, -1))

    # -- leaving the mesh -----------------------------------------------------

    def cpu(self) -> torch.Tensor:
        """A host read: every block copied back and concatenated on the
        host (no device holds the whole tensor)."""
        return torch.cat([b.cpu() for b in self.blocks], dim=-1)

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole tensor on ``device``, counted in
        :data:`GATHER_STATS`: for the calls that need one plane on one
        device (ROADMAP lists them)."""
        GATHER_STATS["calls"] += 1
        GATHER_STATS["bytes"] += self.nbytes
        with on(device):
            return torch.cat([b.to(device) for b in self.blocks], dim=-1)

    def at(self, i: int) -> int:
        """Element ``i`` of a 1-D split, read from its block."""
        if self.ndim != 1:
            raise TypeError("at() reads a 1-D split")
        for off, b in zip(self.offsets(), self.blocks):
            if off <= i < off + b.shape[0]:
                return int(b[i - off])
        raise IndexError(i)

    # -- torch functions ------------------------------------------------------

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func)
        if handler is None:
            raise TypeError(
                f"{getattr(func, '__name__', func)} has no block-wise form "
                "on a split tensor")
        return handler(*args, **kwargs)


def _first_split(xs) -> Split:
    for x in xs:
        if isinstance(x, Split):
            return x
    raise TypeError("no split operand")


def _cat(tensors, dim: int = 0) -> Split:
    first = _first_split(tensors)
    for t in tensors:
        if not isinstance(t, Split):
            raise TypeError("torch.cat mixes split and plain planes")
        first.check_aligned(t)
    d = first._lead_dim(dim)
    return first.like([torch.cat(list(bs), dim=d) for bs in
                       zip(*(t.blocks for t in tensors))])


def _stack(tensors, dim: int = 0) -> Split:
    first = _first_split(tensors)
    for t in tensors:
        if not isinstance(t, Split):
            raise TypeError("torch.stack mixes split and plain planes")
        first.check_aligned(t)
    d = dim % (first.ndim + 1)
    if d == first.ndim:
        raise TypeError("torch.stack after the split axis")
    return first.like([torch.stack(list(bs), dim=d) for bs in
                       zip(*(t.blocks for t in tensors))])


def _where(cond, a, b) -> Split:
    """``torch.where`` per block; a 0-d condition (a walk's decision)
    moves to each block's device."""
    first = _first_split((cond, a, b))
    out = []
    for k, blk in enumerate(first.blocks):
        dev = blk.device
        pick = [o.blocks[k] if isinstance(o, Split) else _to(o, dev)
                for o in (cond, a, b)]
        with on(dev):
            out.append(torch.where(*pick))
    return first.like(out)


_HANDLERS = {
    torch.cat: _cat,
    torch.stack: _stack,
    torch.where: _where,
}


# ---------------------------------------------------------------------------
# Kernel dispatch over blocks
# ---------------------------------------------------------------------------


def any_split(*xs) -> bool:
    return any(isinstance(x, Split) for x in xs)


def aligned_blocks(*xs) -> List[tuple]:
    """The blocks of ``xs`` position by position; every operand must be
    a split of one layout (a kernel never mixes placements)."""
    first = _first_split(xs)
    for x in xs:
        if not isinstance(x, Split):
            raise TypeError("a kernel's operands mix split and plain "
                            "planes")
        first.check_aligned(x)
    return list(zip(*(x.blocks for x in xs)))


def psum(parts: List[torch.Tensor], first: torch.device) -> torch.Tensor:
    """Sum the blocks' int32 partials on the first position (the JAX
    mesh's ``lax.psum``)."""
    if len(parts) == 1:
        return parts[0]
    with on(first):
        return torch.stack([p.to(first) for p in parts]).sum(
            0, dtype=torch.int32)


def map_sum(fn: Callable, *xs) -> torch.Tensor:
    """``fn`` over the aligned blocks of ``xs`` (one launch each, under
    the block's device), the partials summed on the first position."""
    rows = aligned_blocks(*xs)
    parts = []
    for blocks in rows:
        with on(blocks[0].device):
            parts.append(fn(*blocks))
    return psum(parts, rows[0][0].device)


def map_split(fn: Callable, *xs) -> Split:
    """``fn`` over the aligned blocks of ``xs``, each result a block of
    the returned split."""
    first = _first_split(xs)
    rows = aligned_blocks(*xs)
    out = []
    for blocks in rows:
        with on(blocks[0].device):
            out.append(fn(*blocks))
    return first.like(out)


def shift(plane: Split, words_per_shard: int) -> Split:
    """Every column of a 1-D plane over stacked shards moved up by one,
    each shard on its own (the carry stops at a shard's end), over
    blocks that may cut a shard: the carry into a block's first word is
    the top bit of the previous block's last word, unless a shard starts
    there."""
    if plane.ndim != 1:
        raise TypeError("shift takes a 1-D split plane")
    out = []
    prev_top = None
    for off, b in zip(plane.offsets(), plane.blocks):
        with on(b.device):
            first = (torch.zeros(1, dtype=b.dtype, device=b.device)
                     if prev_top is None else prev_top.to(b.device))
            carry = torch.cat([first, (b[:-1] >> 31) & 1])
            carry[(-off) % words_per_shard::words_per_shard] = 0
            out.append((b << 1) | carry)
            prev_top = (b[-1:] >> 31) & 1
    return plane.like(out)


def d2h(t) -> np.ndarray:
    """A device plane (split or not) as host uint32 bits."""
    if isinstance(t, Split):
        return np.concatenate([platform.d2h(b) for b in t.blocks], axis=-1)
    return platform.d2h(t)

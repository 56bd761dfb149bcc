"""Device mesh, shard placement and the mesh reduces.

Port of the non-tape half of ``pilosa_tpu/parallel/mesh.py`` (the op
tapes are ``parallel/tape.py``). The mapping from the reference's
cluster model is the JAX package's (SURVEY.md §5.7/§5.8):

- shard ``i`` of a stacked fragment tensor ``[S, ..., W]`` lives on mesh
  row ``i // (S / rows)`` (block placement: dense, so no hash), and the
  word axis can also be split over the mesh's ``cols`` axis;
- a reduce is one kernel per block, then a sum of the blocks' partials
  on the mesh's first device, where the JAX package runs one
  ``shard_map``-ped program and ``lax.psum``.

**Block layout.** A block holds the shard-major words of its
``[local_shards, ..., local_words]`` slice fused into one last axis,
``[..., local_shards * local_words]``: the layout the port's kernels read
(``tape_count`` over one plane, ``pair_counts`` over rows of planes).
Summing a count over shards is contracting over that fused axis, so each
reduce is one launch per block where the JAX package scans one
``pair_counts`` per local shard, and the integers are the same. The
partial sums are ``int32``, as the JAX psums are.

**Devices.** A mesh holds ``torch.device``s. Tests use a virtual mesh of
one device repeated (``[torch.device("cpu")] * 8``, the counterpart of
the JAX suite's 8 virtual CPU devices); each block then runs the plain
versions. A block on a card launches under ``torch.cuda.device`` of that
card, since the launchers use the current device's stream.

**The engine mesh.** The JAX package's ``engine_mesh`` /
``set_engine_mesh`` / ``engine_sharding`` and the mesh epoch that keys
its caches wait for the engine over several cards (ROADMAP A.7h), the
first code that would place a stack by them; the port's engine runs on
one device.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import topk as T

SHARD_AXIS = "shards"
COL_AXIS = "cols"


class Mesh:
    """A 2D (shards, cols) grid of devices: the surface of the JAX
    ``Mesh`` that callers read. ``devices`` is a numpy object array of
    ``torch.device``s."""

    def __init__(self, devices: np.ndarray,
                 axis_names: Tuple[str, ...] = (SHARD_AXIS, COL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)


def analytics_mesh(devices: Optional[Sequence] = None,
                   col_parallel: int = 1) -> Mesh:
    """Build the 2D (shards, cols) mesh. ``None`` means every visible
    CUDA device (and raises without one). ``col_parallel`` > 1 splits the
    column/word axis: for when single-shard latency matters more than
    shard throughput (few big shards)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass the mesh's devices "
                "(e.g. [torch.device('cpu')] * 8) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [platform.resolve_device(d) for d in devices]
    n = len(devs)
    if n % col_parallel:
        raise ValueError(
            f"{n} devices not divisible by col_parallel={col_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // col_parallel, col_parallel))


# ---------------------------------------------------------------------------
# Shard placement and the mesh reduces (pilosa_tpu/parallel/mesh.py:144-236,
# :355-371)
# ---------------------------------------------------------------------------

#: one-leaf and two-leaf count tapes
_ONE = (("or", 0, 0),)
_AND = (("and", 0, 1),)


class Placed:
    """A stacked tensor ``[S, ..., W]`` placed on a mesh: ``blocks[i][j]``
    holds mesh position (i, j)'s slice as ``[..., local_shards *
    local_words]`` int32 on that position's device."""

    __slots__ = ("shape", "blocks", "nbytes")

    def __init__(self, shape: Tuple[int, ...], blocks, nbytes: int):
        self.shape = shape
        self.blocks = blocks
        self.nbytes = nbytes

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def flat(self) -> List[torch.Tensor]:
        return [b for row in self.blocks for b in row]


def _on(device: torch.device):
    """Launch context of a block: its card as the current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardPlacement:
    """Places stacked fragment tensors onto the mesh and runs the mesh
    reduces: the object that stands for the reference's
    cluster + InternalClient pair in a query's fan-out."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def spec(self, ndim: int) -> Tuple:
        """[S, ..., W]: shards on axis 0, words on the last axis."""
        return (SHARD_AXIS,) + (None,) * (ndim - 2) + (COL_AXIS,)

    def place(self, arr) -> Placed:
        """Split ``arr`` (uint32 planes ``[S, ..., W]``) into the mesh's
        blocks, each copied to its device in the block layout. Raises
        ``ValueError`` where the JAX placement does: fewer than 2 axes,
        or S or W that does not divide over the mesh's rows or cols."""
        arr = np.asarray(arr)
        rows, cols = self.mesh.devices.shape
        if arr.ndim < 2:
            raise ValueError(f"placement needs [S, ..., W] planes, got "
                             f"shape {arr.shape}")
        s, w = arr.shape[0], arr.shape[-1]
        if s % rows or w % cols:
            raise ValueError(
                f"shape {arr.shape} does not divide over the "
                f"{rows} x {cols} mesh ({SHARD_AXIS} x {COL_AXIS})")
        ls, lw = s // rows, w // cols
        middle = arr.shape[1:-1]
        blocks, nbytes = [], 0
        for i in range(rows):
            row = []
            for j in range(cols):
                part = arr[i * ls:(i + 1) * ls, ..., j * lw:(j + 1) * lw]
                fused = np.moveaxis(part, 0, -2).reshape(*middle, ls * lw)
                blk = platform.h2d_copy(fused, self.mesh.devices[i, j])
                nbytes += blk.numel() * blk.element_size()
                row.append(blk)
            blocks.append(row)
        return Placed(tuple(arr.shape), blocks, nbytes)

    def _placed(self, x, ndim: int) -> Placed:
        p = x if isinstance(x, Placed) else self.place(x)
        if p.ndim != ndim:
            raise ValueError(f"expected a {ndim}-D placement, got shape "
                             f"{p.shape}")
        return p

    def _map(self, fn, *placed: Placed) -> List[torch.Tensor]:
        """``fn`` over the aligned blocks of ``placed``, one launch
        context per block."""
        out = []
        for blocks in zip(*(p.flat() for p in placed)):
            with _on(blocks[0].device):
                out.append(fn(*blocks))
        return out

    def _psum(self, parts: List[torch.Tensor]) -> np.ndarray:
        """Sum the blocks' int32 partials on the mesh's first device."""
        if len(parts) == 1:
            total = parts[0]
        else:
            first = self.mesh.devices.flat[0]
            with _on(first):
                total = torch.stack([p.to(first) for p in parts]).sum(
                    0, dtype=torch.int32)
        return total.cpu().numpy()

    # -- collective kernels ------------------------------------------------

    def count(self, planes) -> int:
        """Global popcount of [S, W] (reference: executeCount reduce):
        one ``tape_count`` launch per block."""
        p = self._placed(planes, 2)
        return int(self._psum(self._map(
            lambda b: B.tape_count(_ONE, [b]), p)))

    def intersect_count(self, a, b) -> int:
        pa, pb = self._placed(a, 2), self._placed(b, 2)
        return int(self._psum(self._map(
            lambda x, y: B.tape_count(_AND, [x, y]), pa, pb)))

    def row_counts(self, planes) -> np.ndarray:
        """[S, R, W] -> global per-row counts int32[R] (feeds TopN/TopK):
        one ``pair_counts`` launch per block."""
        p = self._placed(planes, 3)
        return self._psum(self._map(T.row_counts, p))

    def groupby_counts(self, a, b) -> np.ndarray:
        """[S, G, W] x [S, R, W] -> global pairwise counts int32[G, R]:
        one ``pair_counts`` launch per block."""
        pa, pb = self._placed(a, 3), self._placed(b, 3)
        return self._psum(self._map(G.pair_counts, pa, pb))

    def bsi_sum_counts(self, planes, filt) -> Tuple[int, np.ndarray]:
        """[S, P, W] BSI stacks + [S, W] filter -> (count, per-plane
        popcounts pos - neg, int32[P - OFFSET]) summed over all shards;
        the host assembles the exact sum as in ops/bsi.py. One
        ``pair_counts`` and one ``tape_count`` launch per block."""
        pp, pf = self._placed(planes, 3), self._placed(filt, 2)

        def one(blk, f):
            c, pos, neg = S.bsi_plane_popcounts(blk, f)
            return torch.cat([c.reshape(1), pos - neg])

        total = self._psum(self._map(one, pp, pf))
        return int(total[0]), total[1:]

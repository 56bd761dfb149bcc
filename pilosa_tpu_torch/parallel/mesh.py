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

**The engine mesh** (``pilosa_tpu/parallel/mesh.py:45-127``). The PQL
engine places every stacked tensor by one process-wide mesh:
:func:`engine_put` splits the fused ``(shard, word)`` last axis into one
contiguous block per position (row-major), a
:class:`~pilosa_tpu_torch.parallel.split.Split`, which is what the JAX
``P((shards, cols))`` on that axis places. A block may cut a shard in
two. This is not :meth:`ShardPlacement.place`'s 2-D layout (shards over
rows, words over columns), which stays for the mesh reduces. Unset, the
mesh is every visible card (the JAX default, ``jax.devices()``), and on
a machine without one the CPU alone. A stack is placed by the mesh only
when its own device (its API's) is the mesh's first position: a
``device="cpu"`` API on a machine with cards stays on the CPU, and a
test installs a virtual CPU mesh (``[torch.device("cpu")] * 8``) to
split it. :func:`set_engine_mesh` bumps :func:`mesh_epoch`, which keys
the stacks' versions, the programs, the mask planes and the device
profiler's entries, so a switch rebuilds every placement.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import topk as T
from pilosa_tpu_torch.parallel.split import Split, on

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
# The engine mesh (pilosa_tpu/parallel/mesh.py:45-127)
# ---------------------------------------------------------------------------

_ENGINE_MESH: Optional[Mesh] = None
_MESH_EPOCH = 0


def mesh_epoch() -> int:
    """Bumped on every :func:`set_engine_mesh` call. The stacks, programs,
    mask planes and profile entries fold it into their keys, so a mesh
    switch invalidates everything placed under the old mesh."""
    return _MESH_EPOCH


def engine_mesh() -> Mesh:
    """The process-wide mesh queries execute over: every visible card
    unless :func:`set_engine_mesh` installed another (the CPU alone on a
    machine without a card)."""
    global _ENGINE_MESH
    if _ENGINE_MESH is None:
        _ENGINE_MESH = analytics_mesh(
            None if torch.cuda.is_available() else [torch.device("cpu")])
    return _ENGINE_MESH


def set_engine_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or with None, reset to the default on next use) the
    engine mesh, bumping the epoch."""
    global _ENGINE_MESH, _MESH_EPOCH
    _ENGINE_MESH = mesh
    _MESH_EPOCH += 1


class EngineSharding(NamedTuple):
    """The engine placement of a tensor: ``width`` words of the last axis
    on each of ``devices`` (the mesh's, row-major)."""
    mesh: Mesh
    devices: Tuple[torch.device, ...]
    width: int


def placement(last_dim: int, device: Optional[torch.device] = None
              ) -> Optional[EngineSharding]:
    """The engine placement of a last axis of ``last_dim`` words owned by
    ``device`` (None: the mesh's first position), quietly: None on a
    one-position mesh, for a device that is not the first position, or
    when the axis does not divide over the positions."""
    mesh = engine_mesh()
    n = mesh.devices.size
    devs = tuple(mesh.devices.flat)
    if n <= 1 or last_dim % n:
        return None
    if device is not None and torch.device(device) != devs[0]:
        return None
    return EngineSharding(mesh, devs, last_dim // n)


_FALLBACK_WARNED: set = set()


def engine_sharding(ndim: int, last_dim: int,
                    device: Optional[torch.device] = None
                    ) -> Optional[EngineSharding]:
    """Placement of a stacked engine tensor whose LAST axis is the fused
    (shard, word) space. None when the mesh has one position, when
    ``device`` is not its first position, or when that axis does not
    divide over it (callers place on one device). The last fallback is
    LOUD, as in the JAX package: a warning per (positions, words) and a
    metric on every call."""
    del ndim  # every leading axis stays whole on each block
    mesh = engine_mesh()
    n = mesh.devices.size
    mine = device is None or torch.device(device) == mesh.devices.flat[0]
    if n > 1 and mine and last_dim % n:
        key = (n, last_dim)
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            logging.getLogger("pilosa_tpu_torch.mesh").warning(
                "stacked tensor word axis %d does not divide over the "
                "%d-device engine mesh; falling back to SINGLE-DEVICE "
                "placement (no query parallelism for this stack)",
                last_dim, n)
        M.REGISTRY.count(M.METRIC_MESH_FALLBACK)
    return placement(last_dim, device)


def engine_put(host: np.ndarray, device: Optional[torch.device] = None,
               sharding="engine"):
    """Copy a stacked tensor to the engine placement: a :class:`Split`
    of one block per mesh position, words ``[k*L, (k+1)*L)`` of the last
    axis on position ``k``, each through ``platform.h2d_copy`` (so the
    ``device.h2d_copy`` span and the profiler's h2d hook see every
    byte); or one tensor on ``device`` when :func:`engine_sharding` says
    so. A caller that already asked :func:`engine_sharding` passes its
    answer as ``sharding``."""
    host = np.asarray(host)
    if sharding == "engine":
        sharding = engine_sharding(host.ndim, host.shape[-1], device)
    if sharding is None:
        return platform.h2d_copy(
            host, device if device is not None
            else engine_mesh().devices.flat[0])
    w = sharding.width
    return Split([platform.h2d_copy(host[..., k * w:(k + 1) * w], d)
                  for k, d in enumerate(sharding.devices)], sharding.mesh)


def engine_zeros(words: int, device: torch.device):
    """The shared zero plane of ``words`` in the engine placement of
    ``device``'s stacks: blocks of the per-device shared zeros
    (``B.device_zeros``), or one of them."""
    sh = placement(words, device)
    if sh is None:
        return B.device_zeros(words, device)
    return Split([B.device_zeros(sh.width, d) for d in sh.devices], sh.mesh)


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
            with on(blocks[0].device):
                out.append(fn(*blocks))
        return out

    def _psum(self, parts: List[torch.Tensor]) -> np.ndarray:
        """Sum the blocks' int32 partials on the mesh's first device."""
        if len(parts) == 1:
            total = parts[0]
        else:
            first = self.mesh.devices.flat[0]
            with on(first):
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

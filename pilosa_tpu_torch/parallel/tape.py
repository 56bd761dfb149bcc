"""Op-tape programs, on one device or over the engine mesh.

Port of ``pilosa_tpu/parallel/mesh.py:250-352``. A query family lowers to
an op tape (pql/programs.py): a register machine whose registers start as
the leaf planes and whose ops are the four bitmap combinators. On the TPU
the tape plus its terminal compiled to one XLA executable; here there is
no compiler, so a "program" is the checked tape bound to its terminal:

* the count terminal is ONE launch of the ``tape_count`` kernel, which
  takes the tape as data (ops/bitmap.py); when the leaves are split over
  the engine mesh (the mesh branch, ``mesh.py:293-309``), one launch per
  block and the int32 partials summed on the first position, where the
  JAX mesh branch runs a ``shard_map`` of plain popcounts and a
  ``lax.psum``;
* the plane terminal was never a Pallas kernel (``mesh.py:338-352``) and
  stays plain PyTorch: one eager op per tape op (per block when split).

The mesh reduces (``mesh.py:144-236``) are ``parallel/mesh.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.ops import bitmap as B

_tape_eval = B.tape_eval


def _tape_result(tape, masked: bool, args):
    if masked:
        mask, leaves = args[-1], args[:-1]
    else:
        mask, leaves = None, args
    out = _tape_eval(tape, leaves)
    if masked:
        out = out & mask
    return out


def compile_tape_count(tape, n_leaves: int, masked: bool,
                       total_words: int) -> Callable:
    """``fn(*leaves[, mask])`` -> 0-d int32 ``popcount(tape [& mask])``,
    one tape_count launch per call on the card. Over leaves split by the
    engine mesh (the mesh branch, ``mesh.py:293-309``) ``B.tape_count``
    launches once a block and sums the partials on the first position.

    A tape over the kernel's limits (more than ``MAX_LEAVES`` leaves or
    ``MAX_OPS`` ops; the JAX package has none) first reduces the root's
    two operand sub-trees to one plane each with the plane terminal; the
    count is then one launch over those two leaves (per block)."""
    del total_words  # the leaves' placement picks the branch
    if B.tape_fits(tape, n_leaves):
        run_tape, pre = tape, None
    else:
        op, i, j = tape[-1]
        run_tape, pre = ((op, 0, 1),), (tape[:-1], i, j)

    def fn(*args: torch.Tensor) -> torch.Tensor:
        mask, leaves = (args[-1], args[:-1]) if masked else (None, args)
        if pre is not None:
            regs = B.tape_registers(pre[0], leaves)
            leaves = (regs[pre[1]], regs[pre[2]])
        return B.tape_count(run_tape, leaves, mask)

    return fn


def compile_tape_plane(tape, masked: bool) -> Callable:
    """``fn(*leaves[, mask])`` -> the materialized (masked) result plane.
    With the device profiler on, the eager op chain is timed under the
    calling tape family."""

    def fn(*args: torch.Tensor) -> torch.Tensor:
        if not devprof.ENABLED:
            return _tape_result(tape, masked, args)
        with devprof.time_body(args[0].device):
            return _tape_result(tape, masked, args)

    return fn

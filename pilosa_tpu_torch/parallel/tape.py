"""Op-tape programs on one device.

Port of ``pilosa_tpu/parallel/mesh.py:250-352``. A query family lowers to
an op tape (pql/programs.py): a register machine whose registers start as
the leaf planes and whose ops are the four bitmap combinators. On the TPU
the tape plus its terminal compiled to one XLA executable; here there is
no compiler, so a "program" is the checked tape bound to its terminal:

* the count terminal is ONE launch of the ``tape_count`` kernel, which
  takes the tape as data (ops/bitmap.py);
* the plane terminal was never a Pallas kernel (``mesh.py:338-352``) and
  stays plain PyTorch: one eager op per tape op.

The multi-device mesh reduces (``mesh.py:164-236``) wait for the
distributed slice.
"""

from __future__ import annotations

from typing import Callable

import torch

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
    one tape_count launch per call on the card.

    A tape over the kernel's limits (more than ``MAX_LEAVES`` leaves or
    ``MAX_OPS`` ops; the JAX package has none) first reduces the root's
    two operand sub-trees to one plane each with the plane terminal; the
    count is then one launch over those two leaves."""
    del total_words  # one device: every width is one launch
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
    """``fn(*leaves[, mask])`` -> the materialized (masked) result plane."""

    def fn(*args: torch.Tensor) -> torch.Tensor:
        return _tape_result(tape, masked, args)

    return fn

"""GroupBy pair counts: ``C[i, j] = popcount(A_i AND B_j)``.

Port of ``pilosa_tpu/ops/groupby.py``. The TPU computed this as an int8
matmul on the MXU after expanding every word into 32 bit lanes; on the
H100 the hand-written kernel in ``csrc/pair_counts.cu`` feeds the packed
words to the tensor cores' 1-bit ``mma`` (AND, then popcount), and
:func:`_plan` picks its tile and grid from the shapes (the source's
header says what bounds it). ``pair_sums`` (GroupBy over two fields with
a Sum aggregate) is one pair_counts launch per magnitude plane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.bitmap import popcount

pair_counts_launches = KU.LaunchCounter("pair_counts")

#: the kernel counts in int32: a count reaches 32 * w, so w < 2^26
MAX_WORDS = (1 << 26) - 1
#: words a block's 8 warps take per step (csrc/pair_counts.cu)
_STEP = 256


class Plan(NamedTuple):
    """One pair_counts launch: the shape regime, whether A and B trade
    places (the kernel computes C^T and writes it transposed), rows of A
    and of B per block, 4 for 16-byte loads or 1 for scalar ones, words
    per block, and the number of blocks."""
    variant: str
    swap: bool
    ta: int
    tb: int
    vec: int
    slice: int
    blocks: int


def _plan(r1: int, r2: int, w: int, aligned: bool = True,
          sms: int = 132) -> Plan:
    """The launch for an ``[r1, w] x [r2, w]`` pair count on a card of
    ``sms`` SMs; ``aligned``: both operands start on 16 bytes.

    A is made the narrower side (``swap`` when r1 > r2), then one of
    three regimes, each with the tile and blocks per SM measured best at
    its main-path shape (PERF.md): ``row``, one row of A against a wide B
    (TopN); ``narrow``, both sides of at most 32 rows (BSI Sum), where a
    small grid suits a small transfer; ``wide``, several rows of A
    against a wide B (GroupBy; 16 rows of B per block for one group of 8
    A rows, 32 for more). The word axis is cut into slices until the
    card holds that many blocks per SM."""
    if r1 < 1 or r2 < 1 or w < 1:
        raise ValueError(f"pair_counts: empty operand {r1}x{r2}x{w}")
    if w > MAX_WORDS:
        raise ValueError(f"pair_counts: {w} words per row; the int32 "
                         f"counts hold at most {MAX_WORDS}")
    swap = r1 > r2
    if swap:
        r1, r2 = r2, r1
    groups = min(8, -(-r1 // 8))  # groups of 8 rows of A per block
    if r1 == 1:
        variant, tb, per_sm = "row", 16, 4
    elif r2 <= 32:
        variant, tb, per_sm = "narrow", 16, 2
    else:
        variant = "wide"
        tb, per_sm = (16, 4) if groups == 1 else (32, 2)
    ta = 8 * groups
    tiles = -(-r1 // ta) * -(-r2 // tb)
    slices = max(1, min(-(-per_sm * sms // tiles), -(-w // _STEP)))
    size = -(-(-(-w // slices)) // _STEP) * _STEP
    slices = -(-w // size)
    vec = 4 if aligned and w % 4 == 0 else 1
    return Plan(variant, swap, ta, tb, vec, size, tiles * slices)


def pair_counts_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one row of A at a time against all of B
    (bounds the int64 popcount temporaries to ``[R2, W]``)."""
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for i in range(a.shape[0]):
        out[i] = popcount(a[i][None, :] & b).sum(dim=-1, dtype=torch.int32)
    return out


def pair_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``int32[R1, R2]`` of pairwise intersection popcounts of two row
    sets ``int32[R1, W]`` x ``int32[R2, W]`` (GroupBy: rows of field 1 x
    rows of field 2; TopN: one filter row x the field's rows).

    CUDA tensors launch csrc/pair_counts.cu as :func:`_plan` says
    (replaces pilosa_tpu/ops/groupby.py:98/:116/:153); CPU tensors take
    :func:`pair_counts_plain`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"pair_counts: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not share a word axis")
    with KU.kernel_scope("mm", a.shape[0], b.shape[0], 2, a.shape[1],
                         a) as prof:
        if not KU.on_card("pair_counts", a, b):
            return pair_counts_plain(a, b)
        KU.check_words("pair_counts", "a", a, 2)
        KU.check_words("pair_counts", "b", b, 2)
        aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
        plan = _plan(a.shape[0], b.shape[0], a.shape[1], aligned,
                     KU.sm_count(a.device))
        return launch(a, b, plan, prof.timing)


def launch(a: torch.Tensor, b: torch.Tensor, plan: Plan,
           timing=None) -> torch.Tensor:
    """Run one pair_counts kernel on checked CUDA operands as ``plan``
    says (:func:`pair_counts` makes the plan; a probe may pass its own).
    ``timing``: the device profiler's ``KU.PkTiming``, or None."""
    r1, w = a.shape
    r2 = b.shape[0]
    out = torch.zeros((r1, r2), dtype=torch.int32, device=a.device)
    if plan.swap:  # the kernel's C^T[j, i] lands at out[i, j]
        x, y, n1, n2, si, sj = b, a, r2, r1, 1, r2
    else:
        x, y, n1, n2, si, sj = a, b, r1, r2, r2, 1
    with torch.cuda.device(a.device):
        rc = KU.lib().pk_pair_counts(
            x.data_ptr(), y.data_ptr(), n1, n2, w, plan.ta, plan.tb,
            plan.vec, plan.slice, si, sj, out.data_ptr(), KU.stream(a),
            timing)
    KU.check(rc, f"pair_counts ({plan.variant})")
    pair_counts_launches.bump()
    return out


def masked_pair_counts(a: torch.Tensor, b: torch.Tensor,
                       filt: Optional[torch.Tensor]) -> torch.Tensor:
    """pair_counts under a filter plane, or none (reference: GroupBy's
    optional filter argument, executor.go:3277). ``popcount(A_i & F &
    B_j)`` needs the filter on one side only, so B is read as it is."""
    if filt is None:
        return pair_counts(a, b)
    return pair_counts((a & filt[None, :]).contiguous(), b)


def pair_sums(a: torch.Tensor, b: torch.Tensor, mags: torch.Tensor,
              pos: torch.Tensor, neg: torch.Tensor):
    """Per-magnitude-plane pair counts for two-field GroupBy with a Sum
    aggregate (port of ``pilosa_tpu/ops/groupby.py:207``):

        pos_k[i, j] = popcount(A_i & B_j & M_k & pos)

    and the same with ``neg``. The two sign-masked A sides stack into one
    A, so each plane is ONE pair_counts launch; the host assembles the
    exact per-group sum ``Σ_k 2^k (pos_k - neg_k)``.

    Returns (pos int32[D, R1, R2], neg int32[D, R1, R2])."""
    r1 = a.shape[0]
    a2 = torch.cat([a & pos[None, :], a & neg[None, :]])
    parts = [pair_counts(a2, (b & mags[k][None, :]).contiguous())
             for k in range(mags.shape[0])]
    both = torch.stack(parts)  # [D, 2*R1, R2]
    return both[:, :r1], both[:, r1:]

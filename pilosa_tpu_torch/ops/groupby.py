"""GroupBy pair counts: ``C[i, j] = popcount(A_i AND B_j)``.

Port of ``pilosa_tpu/ops/groupby.py``. The TPU computed this as an int8
matmul on the MXU after expanding every word into 32 bit lanes; on the
H100 the hand-written kernel in ``csrc/pair_counts.cu`` ANDs packed words
and counts them with ``__popc`` (its header says what bounds it and how
it splits the work). ``pair_sums`` (GroupBy with a Sum aggregate) waits
for the BSI slice.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.bitmap import popcount

pair_counts_launches = KU.LaunchCounter("pair_counts")


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

    CUDA tensors launch csrc/pair_counts.cu (replaces
    pilosa_tpu/ops/groupby.py:98/:116/:153); CPU tensors take
    :func:`pair_counts_plain`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"pair_counts: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not share a word axis")
    if not KU.on_card("pair_counts", a, b):
        return pair_counts_plain(a, b)
    KU.check_words("pair_counts", "a", a, 2)
    KU.check_words("pair_counts", "b", b, 2)
    r1, w = a.shape
    r2 = b.shape[0]
    if r1 == 0 or r2 == 0 or w == 0:
        raise ValueError(f"pair_counts: empty operand {r1}x{r2}x{w}")
    out = torch.zeros((r1, r2), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        rc = KU.lib().pk_pair_counts(a.data_ptr(), b.data_ptr(), r1, r2, w,
                                     out.data_ptr(), KU.stream(a))
    KU.check(rc, "pair_counts")
    pair_counts_launches.bump()
    return out


def masked_pair_counts(a: torch.Tensor, b: torch.Tensor,
                       filt: torch.Tensor) -> torch.Tensor:
    """pair_counts under a filter plane (reference: GroupBy's optional
    filter argument, executor.go:3277). ``popcount(A_i & F & B_j)`` needs
    the filter on one side only, so B is read as it is."""
    return pair_counts((a & filt[None, :]).contiguous(), b)

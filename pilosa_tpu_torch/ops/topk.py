"""Top-N over row counts.

Port of ``pilosa_tpu/ops/topk.py``: counting every row is one pass over
the field's planes, and ranking happens on the device
(``torch.topk`` for ``lax.top_k``). The per-row masked popcount is one
row of the pair-count kernel — A = the filter plane (or all-ones), B =
the row planes — as in ``topk.py:39,56-61``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops.bitmap import ones_like_plane


def row_counts(planes: torch.Tensor, filt: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """``int32[R]`` per-row popcounts of ``int32[R, W]``, optionally
    intersected with ``filt`` first, through :func:`G.pair_counts`."""
    f = filt if filt is not None else ones_like_plane(planes)
    return G.pair_counts(f.reshape(1, -1).contiguous(), planes)[0]


def top_rows(planes: torch.Tensor, k: int,
             filt: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, plane indices) of the k highest-count rows (reference:
    executor.go:2357 executeTopK reduce)."""
    k = min(int(k), planes.shape[0])
    return torch.topk(row_counts(planes, filt), k)

"""Ingest sort + device scatter-merge.

Port of ``pilosa_tpu/ops/scatter.py``. ``SetFragment.set_many`` splits a
bulk import in two:

1. **sort** (host, numpy): collapse every (plane slot, column) pair into
   a sorted *unique* flat word address plus an OR-mask of its bits;
2. **scatter-merge** (device): the kernel in ``csrc/scatter_merge.cu``
   ORs the masks into the touched rows and counts the newly set bits.

Rows stream through the device in chunks of at most
:data:`MAX_FLAT_WORDS` words, and the host planes are written back only
after every chunk succeeded, as in ``scatter.py:171-205``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.bitmap import popcount

#: gathered sub-plane words per device round trip
MAX_FLAT_WORDS = 1 << 15


def sort_updates(slots, cols, words: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host half: (plane slot, column) pairs -> (sorted unique flat word
    addresses int64[M], uint32 OR-masks[M]). Duplicate bits collapse into
    one mask, so the device count never double-counts."""
    slots = np.asarray(slots, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if slots.size == 0:
        return slots, np.zeros(0, dtype=np.uint32)
    addr = slots * words + (cols >> 5)
    mask = np.uint32(1) << (cols & 31).astype(np.uint32)
    order = np.argsort(addr, kind="stable")
    addr = addr[order]
    mask = mask[order]
    uaddr, starts = np.unique(addr, return_index=True)
    return uaddr, np.bitwise_or.reduceat(mask, starts)


scatter_merge_launches = KU.LaunchCounter("scatter_merge")


def scatter_merge_plain(flat: torch.Tensor, addr: torch.Tensor,
                        masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, OR, write back, count
    ``popcount(mask & ~old)``. Updates ``flat`` in place; 0-d int32."""
    idx = addr.long()
    old = flat[idx]
    flat[idx] = old | masks
    return popcount(masks & ~old).sum().to(torch.int32)


def scatter_merge_(flat: torch.Tensor, addr: torch.Tensor,
                   masks: torch.Tensor) -> torch.Tensor:
    """OR ``masks`` into ``flat`` at the unique word addresses ``addr``,
    IN PLACE, and return the number of newly set bits (0-d int32).

    CUDA tensors launch csrc/scatter_merge.cu (replaces
    pilosa_tpu/ops/scatter.py:91/:111); CPU tensors take
    :func:`scatter_merge_plain`. Addresses must be unique."""
    if addr.shape != masks.shape:
        raise ValueError("scatter_merge: addr and masks differ in shape")
    if not KU.on_card("scatter_merge", flat, addr, masks):
        return scatter_merge_plain(flat, addr, masks)
    for name, t in (("flat", flat), ("addr", addr), ("masks", masks)):
        KU.check_words("scatter_merge", name, t, 1)
    count = torch.zeros(1, dtype=torch.int32, device=flat.device)
    with torch.cuda.device(flat.device):
        rc = KU.lib().pk_scatter_merge(
            flat.data_ptr(), flat.numel(), addr.data_ptr(), masks.data_ptr(),
            addr.numel(), count.data_ptr(), KU.stream(flat))
    KU.check(rc, "scatter_merge")
    scatter_merge_launches.bump()
    return count[0]


def _scatter_chunk(planes: np.ndarray, uslots: np.ndarray, addr: np.ndarray,
                   masks: np.ndarray, device: torch.device
                   ) -> Tuple[int, np.ndarray]:
    """One device round trip over the rows ``uslots`` with chunk-rebased
    unique addresses; returns (newly set bits, merged sub-plane). The
    caller writes back, so a failing later chunk leaves ``planes``
    untouched."""
    sub = np.ascontiguousarray(planes[uslots])
    flat = platform.h2d_copy(sub.reshape(-1), device)
    changed = scatter_merge_(
        flat, torch.from_numpy(addr.astype(np.int32)).to(device),
        platform.h2d_copy(masks, device))
    return int(changed), platform.d2h(flat).reshape(sub.shape)


def scatter_new_bits_bulk(planes: np.ndarray, slots, cols,
                          device: torch.device) -> int:
    """OR (plane slot, column) updates into host ``planes`` rows through
    the scatter-merge kernel; returns the number of newly set bits — the
    same contract as summing ``native.scatter_new_bits`` over rows.
    Mutates the touched ``planes`` rows in place, after every chunk has
    come back."""
    slots = np.asarray(slots, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    words = planes.shape[1]
    if cols.size and (int(cols.min()) < 0
                      or int(cols.max()) >= words * 32):
        raise IndexError(f"column out of range for plane of {words} words")
    uslots = np.unique(slots)
    addr, masks = sort_updates(np.searchsorted(uslots, slots), cols, words)
    rows_per_chunk = max(1, MAX_FLAT_WORDS // words)
    changed = 0
    results = []
    for lo in range(0, uslots.size, rows_per_chunk):
        hi = min(lo + rows_per_chunk, uslots.size)
        a0, a1 = np.searchsorted(addr, (lo * words, hi * words))
        got, merged = _scatter_chunk(planes, uslots[lo:hi],
                                     addr[a0:a1] - lo * words, masks[a0:a1],
                                     device)
        changed += got
        results.append((uslots[lo:hi], merged))
    for chunk_slots, merged in results:
        planes[chunk_slots] = merged
    return changed

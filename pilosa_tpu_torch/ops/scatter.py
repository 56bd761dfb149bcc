"""Ingest sort + device scatter-merge.

Port of ``pilosa_tpu/ops/scatter.py``. ``SetFragment.set_many`` splits a
bulk import in two:

1. **sort** (host, numpy): collapse every (plane slot, column) pair into
   a sorted *unique* flat word address plus an OR-mask of its bits;
2. **scatter-merge** (device): only the tiles of :data:`TILE_WORDS` words
   that the updates touch cross PCIe. The host gathers them, packed, into
   one pinned staging buffer beside the addresses rebased to the packed
   tiles and the masks; one H2D copy, one launch of the kernel in
   ``csrc/scatter_merge.cu`` (OR the masks in, count the newly set bits),
   one D2H copy of the tiles and the count, one sync, and a vectorized put
   of the tiles back into the host planes.

A bulk call stages at most :data:`MAX_STAGED_BYTES` at a time: a larger
one goes in chunks of whole tiles, and the host planes are written back
only after every chunk has come back, as in ``scatter.py:171-205``. On the
CPU the staging buffer is the working buffer and the kernel's plain
version runs on it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.bitmap import popcount

#: words per staged tile: one 32-byte sector. The fewest bytes cross
#: PCIe; on an H100 the import of BASELINE.json config 1 varied less
#: across 8-512 words than between runs, and at a sparse shape 8 and 16
#: words tied as the fastest (import_probe's sweep, PERF.md). Flats whose
#: size it does not divide take the largest power of two that does.
TILE_WORDS = 8
#: most bytes staged for one round trip (tiles, addresses and masks)
MAX_STAGED_BYTES = 64 << 20


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
    ``popcount(mask & ~old)``, dropping addresses outside ``flat``.
    Updates ``flat`` in place; 0-d int32."""
    idx = addr.long()
    keep = (idx >= 0) & (idx < flat.numel())
    if not bool(keep.all()):
        idx, masks = idx[keep], masks[keep]
    old = flat[idx]
    flat[idx] = old | masks
    return popcount(masks & ~old).sum().to(torch.int32)


def scatter_merge_(flat: torch.Tensor, addr: torch.Tensor,
                   masks: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OR ``masks`` into ``flat`` at the unique word addresses ``addr``,
    IN PLACE, and return the number of newly set bits as a 0-d int32,
    written into ``out`` (a 0-d int32 view) when given.

    CUDA tensors: one launch of csrc/scatter_merge.cu, which replaces
    pilosa_tpu/ops/scatter.py:91/:111, and no other device operation.
    CPU tensors: :func:`scatter_merge_plain`. Addresses must be unique;
    one outside ``flat`` is dropped."""
    if addr.shape != masks.shape:
        raise ValueError("scatter_merge: addr and masks differ in shape")
    operands = (flat, addr, masks) if out is None else (flat, addr, masks,
                                                        out)
    if out is not None and (out.dtype != torch.int32 or out.dim() != 0):
        raise ValueError("scatter_merge: out must be a 0-d int32 tensor")
    # the cost family's words are those the kernel moves: an address, a
    # mask and a read and a write of the addressed word an update, 16 B,
    # which the JAX formula's 12 B a word gives at 4/3 words an update
    # (the JAX package counts its padded sub-planes)
    m = addr.numel()
    with KU.kernel_scope("scatter", m, 1, 2, 4 * m // 3, flat) as prof:
        if not KU.on_card("scatter_merge", *operands):
            count = scatter_merge_plain(flat, addr, masks)
            return count if out is None else out.copy_(count)
        for name, t in (("flat", flat), ("addr", addr), ("masks", masks)):
            KU.check_words("scatter_merge", name, t, 1)
        dev = flat.device
        if out is None:
            out = torch.empty((), dtype=torch.int32, device=dev)
        stream = KU.stream(flat)
        rc = KU.lib().pk_scatter_merge(
            flat.data_ptr(), flat.numel(), addr.data_ptr(),
            masks.data_ptr(), m, out.data_ptr(),
            KU.tape_scratch(dev, stream), dev.index, stream, prof.timing)
        KU.check(rc, "scatter_merge")
    scatter_merge_launches.bump()
    return out


# ---------------------------------------------------------------------------
# The bulk import: touched tiles through one pinned staging buffer
# ---------------------------------------------------------------------------

#: (device, stream) -> (host staging buffer, device buffer); on the CPU
#: both are one tensor. Grown on demand, never shrunk.
_STAGING: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: held while a bulk call uses its staging buffers
_STAGING_LOCK = threading.Lock()


def _staging(device: torch.device, words: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 staging buffers of ``device``'s current stream, at least
    ``words`` long: pinned host memory and a device buffer on a card, one
    plain tensor on the CPU."""
    card = device.type == "cuda"
    key = (str(device), torch._C._cuda_getCurrentRawStream(device.index)
           if card else 0)
    bufs = _STAGING.get(key)
    if bufs is None or bufs[0].numel() < words:
        size = -(-words // (1 << 18)) << 18  # whole MiB
        host = torch.empty(size, dtype=torch.int32, pin_memory=card)
        dev = torch.empty(size, dtype=torch.int32, device=device) \
            if card else host
        bufs = _STAGING[key] = (host, dev)
    return bufs


def _tile_words(n_words: int) -> int:
    """:data:`TILE_WORDS`, halved until it divides ``n_words``."""
    t = TILE_WORDS
    while n_words % t:
        t //= 2
    return t


def _gather_tiles(tiles: np.ndarray, which: np.ndarray, out: np.ndarray
                  ) -> None:
    """Copy the host tiles ``which`` (checked in range) into ``out``."""
    np.take(tiles, which, axis=0, out=out, mode="clip")


def _put_tiles(tiles: np.ndarray, which: np.ndarray, merged: np.ndarray
               ) -> None:
    """Write merged tiles back into the host planes."""
    tiles[which] = merged


def _h2d(host: torch.Tensor, dev: torch.Tensor, words: int) -> None:
    """Enqueue the copy of the staged prefix to the card (none on the
    CPU, where ``dev`` is ``host``)."""
    if dev is not host:
        dev[:words].copy_(host[:words], non_blocking=True)


def _d2h(host: torch.Tensor, dev: torch.Tensor, words: int) -> None:
    """Copy the merged prefix back into pinned memory and wait for it."""
    if dev is not host:
        host[:words].copy_(dev[:words], non_blocking=True)
        torch.cuda.current_stream(dev.device).synchronize()


def _merge_chunk(tiles: np.ndarray, which: np.ndarray, addr: np.ndarray,
                 masks: np.ndarray, device: torch.device
                 ) -> Tuple[int, np.ndarray]:
    """One round trip: stage the host tiles ``which`` with the updates
    (addresses already rebased to the packed tiles), merge on
    ``device``, and return (newly set bits, merged tiles). The merged
    tiles are a view of the staging buffer, valid until the next call.

    Staging layout, in words: tiles [0, n), the count at n (then 3 pad
    words), addresses from n + 4, masks from n + 4 + m4 (m4 = m rounded up
    to 4), so every region starts on 16 bytes when T >= 4."""
    t = tiles.shape[1]
    n, m = which.size * t, addr.size
    m4 = -(-m // 4) * 4
    a0, k0 = n + 4, n + 4 + m4
    host, dev = _staging(device, k0 + m4)
    h = host.numpy().view(np.uint32)
    _gather_tiles(tiles, which, h[:n].reshape(-1, t))
    h[a0:a0 + m] = addr
    h[k0:k0 + m] = masks
    _h2d(host, dev, k0 + m)
    scatter_merge_(dev[:n], dev[a0:a0 + m], dev[k0:k0 + m], out=dev[n])
    _d2h(host, dev, n + 1)
    return int(h[n]), h[:n].reshape(-1, t)


def pack_tiles(addr: np.ndarray, t: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted unique flat addresses -> (the touched tiles of ``t`` words,
    in order; each address rebased to the packed tiles, ``rank * t + addr
    mod t``; the index of each tile's first address)."""
    shift = t.bit_length() - 1
    tile = addr >> shift
    first = np.empty(tile.size, dtype=bool)
    first[:1] = True
    np.not_equal(tile[1:], tile[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    packed = ((np.cumsum(first) - 1) << shift) | (addr & (t - 1))
    return tile[starts], packed, starts


def _chunks(cost: np.ndarray, cap: int):
    """[lo, hi) ranges of consecutive items whose ``cost`` sums to at most
    ``cap`` (an item over ``cap`` alone)."""
    cum = np.cumsum(cost)
    lo = 0
    while lo < cost.size:
        base = int(cum[lo - 1]) if lo else 0
        hi = max(int(np.searchsorted(cum, base + cap, side="right")), lo + 1)
        yield lo, hi
        lo = hi


def scatter_new_bits_bulk(planes: np.ndarray, slots, cols,
                          device: torch.device) -> int:
    """OR (plane slot, column) updates into host ``planes`` rows through
    the scatter-merge kernel; returns the number of newly set bits — the
    same contract as summing ``native.scatter_new_bits`` over rows.
    Mutates the touched ``planes`` words in place, after every chunk has
    come back."""
    slots = np.asarray(slots, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    n_rows, words = planes.shape
    if cols.size and (int(cols.min()) < 0
                      or int(cols.max()) >= words * 32):
        raise IndexError(f"column out of range for plane of {words} words")
    if slots.size and (int(slots.min()) < 0
                       or int(slots.max()) >= n_rows):
        raise IndexError(f"slot out of range for {n_rows} planes")
    if not planes.flags.c_contiguous:
        raise ValueError("planes must be C-contiguous")
    addr, masks = sort_updates(slots, cols, words)
    if addr.size == 0:
        return 0
    t = _tile_words(planes.size)
    tiles = planes.reshape(-1, t)
    which, packed, starts = pack_tiles(addr, t)
    per_tile = np.diff(np.append(starts, addr.size))
    changed = 0
    with _STAGING_LOCK:
        merged = []
        for lo, hi in _chunks(t + 2 * per_tile, MAX_STAGED_BYTES // 4):
            u0 = starts[lo]
            u1 = starts[hi] if hi < starts.size else addr.size
            got, out = _merge_chunk(tiles, which[lo:hi],
                                    packed[u0:u1] - lo * t, masks[u0:u1],
                                    device)
            changed += got
            # every chunk but the last must leave the staging buffer
            merged.append((which[lo:hi],
                           out if hi == starts.size else out.copy()))
        for w, out in merged:
            _put_tiles(tiles, w, out)
    return changed

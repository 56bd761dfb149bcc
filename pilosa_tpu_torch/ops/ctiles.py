"""Block-compressed device-resident bitmap tiles, and the ``ctile_count``
kernel wrapper.

Port of ``pilosa_tpu/ops/ctiles.py``. Each row block of a stack is cut
into fixed-size **word tiles** and every (row, tile) gets a roaring-style
container tag:

* ``zero``  -- all words 0: no payload, skipped by every scan;
* ``run``   -- all words equal to one non-zero constant (0xFFFFFFFF runs
  are dense ranges): one word of storage;
* ``dense`` -- anything else: the tile's words go verbatim into a packed
  payload.

Device layout (one :class:`CompressedBlock` per row block), all int32
tensors with the host arrays' bit patterns::

    payload      [P, T]    dense-tile words, packed, row-major
    slot         [R, NT]   payload index per (row, tile); -1 = constant
    const        [R, NT]   the constant word of zero/run tiles
    payload_row  [P]       owning row of each payload entry (pads: R)
    payload_tile [P]       tile column of each payload entry

``payload_row``/``payload_tile`` are the skip index: a per-row count
touches exactly the P dense tiles, and the constant tiles count by a
closed form, in one launch of the hand-written kernel in
``csrc/ctile_count.cu`` on a CUDA tensor (its plain PyTorch version on a
CPU tensor).
Decode is a gather on the device, plain PyTorch, as the JAX package left
it to XLA.

Classification runs on the host where the dense block already exists, so
only the compressed arrays are uploaded. Policy (``PILOSA_TPU_COMPRESS``,
the JAX package's meanings): unset -- compress a block of at least
:data:`MIN_BYTES` whose stored form is at most :data:`MAX_RATIO` of
dense; ``0`` -- every block stays dense; ``1`` -- compress every block.
The variable chooses the residency format only: a compressed block on
the card always counts through the kernel. The JAX package's ``mesh``
rule is dropped (the port runs on one card) and so are its metric ticks.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops.bitmap import device_zeros, popcount

#: words per tile: 2 KiB, 16,384 columns. Narrow blocks shrink the tile
#: to the block width (power of two, floor 8).
TILE_WORDS = 512

#: dense blocks below this stay dense unless compression is forced
MIN_BYTES = 1 << 16

#: keep the compressed form only when stored bytes are at most this
#: fraction of dense
MAX_RATIO = 0.9

_OFF = ("0", "false", "no", "off")
_ON = ("1", "true", "yes", "on", "force")


def _env() -> str:
    return os.environ.get("PILOSA_TPU_COMPRESS", "").strip().lower()


def disabled() -> bool:
    """``PILOSA_TPU_COMPRESS=0``: every block stays dense, no work done."""
    return _env() in _OFF and _env() != ""


def forced() -> bool:
    """``PILOSA_TPU_COMPRESS=1``: compress regardless of size and ratio."""
    return _env() in _ON


def tile_words(width: int) -> int:
    """Tile size for a block of ``width`` words: :data:`TILE_WORDS`,
    shrunk (power of two, floor 8) for blocks narrower than one tile."""
    if width >= TILE_WORDS:
        return TILE_WORDS
    p = 8
    while p < width:
        p <<= 1
    return p


def why_not_compress(dense_nbytes: int) -> Optional[str]:
    """``None`` when a block of ``dense_nbytes`` should be classified,
    else why it stays dense: ``disabled`` | ``small``. The ratio rule
    comes after classification, which gives the stored size."""
    if disabled():
        return "disabled"
    if forced():
        return None
    if MIN_BYTES > dense_nbytes:
        return "small"
    return None


class CompressedBlock:
    """One row block in compressed-tile form: device tensors plus host
    metadata. Immutable once built."""

    __slots__ = ("rows", "words", "tile_words", "n_tiles", "payload",
                 "slot", "const", "payload_row", "payload_tile",
                 "n_payload", "nbytes", "dense_nbytes", "zero_tiles",
                 "run_tiles", "dense_tiles", "active_tiles", "device")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.words)

    def decode(self, rows: Optional[Sequence] = None) -> torch.Tensor:
        """Dense ``int32[R, words]`` (or a row subset), rebuilt on the
        device."""
        if rows is None:
            return _decode(self.payload, self.slot, self.const, self.words)
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                              device=self.device)
        return _decode(self.payload, self.slot[idx], self.const[idx],
                       self.words)

    def row_counts(self, filt: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """``int32[R]`` per-row popcounts (of ``row & filt`` when given)
        that touch only the dense payload tiles plus a closed form for
        the constant tiles, in one ``ctile_count`` launch, whatever the
        constant words. Equal to ``topk.row_counts(self.decode(), filt)``."""
        ft = (None if filt is None
              else _filt_tiles(filt, self.n_tiles, self.tile_words))
        return ctile_count(self.payload, self.payload_row, self.payload_tile,
                           self.const, ft)


def _tag(host: np.ndarray, t: int):
    """``host`` cut into ``[R, NT, t]`` tiles (the last one zero-padded
    when the width is not a whole number of tiles, so a full row's last
    tile is dense), which tiles are constant, and their constant word."""
    rows, width = host.shape
    n_tiles = -(-width // t)
    if width == n_tiles * t:
        tiles = np.ascontiguousarray(host).reshape(rows, n_tiles, t)
    else:
        tiles = np.zeros((rows, n_tiles * t), dtype=np.uint32)
        tiles[:, :width] = host
        tiles = tiles.reshape(rows, n_tiles, t)
    const_ok = np.all(tiles == tiles[..., :1], axis=-1)
    const = np.where(const_ok, tiles[..., 0], np.uint32(0)).astype(np.uint32)
    return tiles, const_ok, const


def _pack(tiles: np.ndarray, const_ok: np.ndarray, const: np.ndarray):
    """The packed payload of the tagged tiles and its skip index."""
    dense_mask = ~const_ok
    payload_row, payload_tile = np.nonzero(dense_mask)
    payload = tiles[payload_row, payload_tile]
    slot = np.full(const.shape, -1, dtype=np.int32)
    slot[dense_mask] = np.arange(payload_row.size, dtype=np.int32)
    return (payload, slot, payload_row.astype(np.int32),
            payload_tile.astype(np.int32))


def classify(host: np.ndarray, t: Optional[int] = None):
    """Host half: tile and tag a dense ``uint32[R, W]`` block. Returns
    (payload, slot, const, payload_row, payload_tile, t, n_tiles, zero
    tiles, run tiles, payload count), the arrays and counts of the JAX
    package's ``classify``."""
    t = t or tile_words(host.shape[1])
    tiles, const_ok, const = _tag(host, t)
    payload, slot, payload_row, payload_tile = _pack(tiles, const_ok, const)
    zero = int(np.count_nonzero(const_ok & (const == 0)))
    run = int(np.count_nonzero(const_ok) - zero)
    return (payload, slot, const, payload_row, payload_tile,
            t, const.shape[1], zero, run, int(payload_row.size))


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def maybe_compress(host: np.ndarray, device: torch.device
                   ) -> Optional[CompressedBlock]:
    """Classify ``host`` and upload it to ``device`` as a
    :class:`CompressedBlock`, or ``None`` when the block stays dense (by
    policy or by the ratio rule). The JAX package's ``kind`` argument
    labels its metrics, which the port does not keep yet."""
    if why_not_compress(host.nbytes) is not None:
        return None
    rows = host.shape[0]
    t = tile_words(host.shape[1])
    tiles, const_ok, const = _tag(host, t)
    n_tiles = const.shape[1]
    n_const = int(np.count_nonzero(const_ok))
    n_payload = rows * n_tiles - n_const
    # the payload row count is padded to a power of two (floor 8), as the
    # JAX package pads it for jit; the stored size, and so the ratio rule
    # and the budget charge, follow the padded count. The rule runs before
    # the payload is gathered, so a block that stays dense copies nothing.
    cap = 8
    while cap < n_payload:
        cap <<= 1
    stored = (cap * t + 2 * rows * n_tiles) * 4 + cap * 8
    if not forced() and stored > MAX_RATIO * host.nbytes:
        return None
    payload, slot, payload_row, payload_tile = _pack(tiles, const_ok, const)
    cb = CompressedBlock()
    cb.rows, cb.words = host.shape
    cb.tile_words, cb.n_tiles = t, n_tiles
    cb.n_payload = n_payload
    cb.zero_tiles = int(np.count_nonzero(const_ok & (const == 0)))
    cb.run_tiles = n_const - cb.zero_tiles
    cb.dense_tiles = n_payload
    cb.dense_nbytes = host.nbytes
    cb.nbytes = stored
    cb.active_tiles = np.flatnonzero(
        (slot >= 0).any(axis=0) | (const != 0).any(axis=0)).astype(np.int32)
    cb.device = device
    cb.payload = platform.h2d_copy(_pad_rows(payload, cap), device)
    cb.slot = platform.h2d_copy(slot, device)
    cb.const = platform.h2d_copy(const, device)
    # padded skip-index entries point one past the last row: the count
    # drops them
    prow = np.full(cap, rows, dtype=np.int32)
    prow[:n_payload] = payload_row
    ptile = np.zeros(cap, dtype=np.int32)
    ptile[:n_payload] = payload_tile
    cb.payload_row = platform.h2d_copy(prow, device)
    cb.payload_tile = platform.h2d_copy(ptile, device)
    return cb


# ---------------------------------------------------------------------------
# Decode (a gather on the device)
# ---------------------------------------------------------------------------


def _decode(payload: torch.Tensor, slot: torch.Tensor, const: torch.Tensor,
            words: int) -> torch.Tensor:
    cap = payload.shape[0]
    gathered = payload[slot.clamp(0, cap - 1).long()]
    tiles = torch.where((slot >= 0)[..., None], gathered, const[..., None])
    return tiles.reshape(slot.shape[0], -1)[:, :words].contiguous()


# ---------------------------------------------------------------------------
# The ctile_count kernel: per-row popcounts of a compressed block
# ---------------------------------------------------------------------------

ctile_count_launches = KU.LaunchCounter("ctile_count")


def ctile_count_plain(payload: torch.Tensor, payload_row: torch.Tensor,
                      payload_tile: torch.Tensor, const: torch.Tensor,
                      filt_tiles: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: mask each payload entry with
    its filter tile, popcount and sum it, ``index_add_`` the sums into
    their rows, then the same for the non-zero constants (a constant word
    ``c`` counts ``popcount(c) * T`` unfiltered, ``popcount(c & filter
    tile)`` filtered). Payload entries whose row is outside ``[0, R)``
    (the padding), or whose tile is outside ``[0, NT)`` under a filter,
    are dropped."""
    rows, n_tiles = const.shape
    keep = (payload_row >= 0) & (payload_row < rows)
    x = payload
    if filt_tiles is not None:
        keep &= (payload_tile >= 0) & (payload_tile < n_tiles)
        x = payload & filt_tiles[payload_tile.clamp(0, n_tiles - 1).long()]
    out = torch.zeros(rows, dtype=torch.int32, device=payload.device)
    out.index_add_(0, payload_row[keep].long(),
                   popcount(x).sum(dim=1, dtype=torch.int32)[keep])
    r, j = torch.nonzero(const, as_tuple=True)
    c = const[r, j]
    if filt_tiles is None:
        per_const = popcount(c) * payload.shape[1]
    else:
        per_const = popcount(filt_tiles[j] & c[:, None]).sum(
            dim=1, dtype=torch.int32)
    out.index_add_(0, r, per_const)
    return out


def ctile_count(payload: torch.Tensor, payload_row: torch.Tensor,
                payload_tile: torch.Tensor, const: torch.Tensor,
                filt_tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``int32[R]`` per-row popcounts of a compressed block, with
    ``payload int32[P, T]``, its skip index ``payload_row`` /
    ``payload_tile`` ``int32[P]`` and the constant table ``const
    int32[R, NT]``:

        out[payload_row[p]] += popcount(payload[p] & filt_tiles[tile_p])
        out[r] += popcount(const[r, j] & filt_tiles[j])

    with ``tile_p = payload_tile[p]``.

    Without a filter the payload counts alone and a constant word ``c``
    counts ``popcount(c) * T``. Payload entries whose row is outside
    ``[0, R)`` (the padding), or whose tile is outside ``[0, NT)`` under
    a filter, are dropped.

    CUDA tensors: one launch of csrc/ctile_count.cu, which replaces
    pilosa_tpu/ops/ctiles.py:291/:301 with the mask (:342), the
    scatter-add (:348) and the constant tiles' counts (:355/:362) fused
    in. CPU tensors: :func:`ctile_count_plain`."""
    if payload.dim() != 2 or const.dim() != 2:
        raise ValueError(f"ctile_count: payload {tuple(payload.shape)} and "
                         f"constants {tuple(const.shape)} must be 2-D")
    p, t = payload.shape
    rows, n_tiles = const.shape
    if payload_row.shape != (p,) or payload_tile.shape != (p,):
        raise ValueError("ctile_count: payload_row and payload_tile must "
                         f"hold one entry per payload row ({p})")
    if filt_tiles is not None and tuple(filt_tiles.shape) != (n_tiles, t):
        raise ValueError(f"ctile_count: filter tiles {tuple(filt_tiles.shape)}"
                         f" are not {n_tiles} tiles of {t} words")
    operands = [payload, payload_row, payload_tile, const] + (
        [] if filt_tiles is None else [filt_tiles])
    if not KU.on_card("ctile_count", *operands):
        return ctile_count_plain(payload, payload_row, payload_tile, const,
                                 filt_tiles)
    KU.check_words("ctile_count", "payload", payload, 2)
    KU.check_words("ctile_count", "payload_row", payload_row, 1)
    KU.check_words("ctile_count", "payload_tile", payload_tile, 1)
    KU.check_words("ctile_count", "const", const, 2)
    if filt_tiles is not None:
        KU.check_words("ctile_count", "filt_tiles", filt_tiles, 2)
    out = torch.zeros(rows, dtype=torch.int32, device=payload.device)
    if t == 0 or rows == 0:
        return out
    with torch.cuda.device(payload.device):
        rc = KU.lib().pk_ctile_count(
            payload.data_ptr(), payload_row.data_ptr(),
            payload_tile.data_ptr(),
            filt_tiles.data_ptr() if filt_tiles is not None else None,
            const.data_ptr(), p, t, n_tiles, rows, out.data_ptr(),
            KU.stream(payload))
    KU.check(rc, "ctile_count")
    ctile_count_launches.bump()
    return out


def _filt_tiles(filt: torch.Tensor, n_tiles: int, t: int) -> torch.Tensor:
    pad = n_tiles * t - filt.shape[0]
    if pad:
        filt = torch.cat([filt, torch.zeros(pad, dtype=filt.dtype,
                                            device=filt.device)])
    return filt.reshape(n_tiles, t).contiguous()


# ---------------------------------------------------------------------------
# Compressed BSI compare: narrow to the active tiles, reuse the dense kernel
# ---------------------------------------------------------------------------


def bsi_compare_compressed(cb: CompressedBlock, op: str, value: int,
                           value2: Optional[int] = None) -> torch.Tensor:
    """Range compare over a compressed BSI plane stack: gather the active
    tile columns (any plane dense or non-zero constant) into a narrow
    dense tensor, run the ``bsi_compare`` kernel there, and scatter the
    result plane back to full width.

    Sound because every ``bsi_compare`` output is EXISTS-masked: where
    all planes are zero, EXISTS is 0 and every op's result is 0, which is
    what the scatter leaves. Equal to ``bsi_compare(cb.decode(), ...)``."""
    from pilosa_tpu_torch.ops import bsi as bsiops

    active = cb.active_tiles
    if active.size == 0:
        return device_zeros(cb.words, cb.device)
    idx = torch.as_tensor(active.astype(np.int64), device=cb.device)
    narrow = _decode(cb.payload, cb.slot[:, idx], cb.const[:, idx],
                     active.size * cb.tile_words)
    res = bsiops.bsi_compare(narrow, op, value, value2)
    return _scatter_tiles(res, idx, cb.n_tiles, cb.tile_words, cb.words)


def _scatter_tiles(res: torch.Tensor, idx: torch.Tensor, n_tiles: int,
                   t: int, words: int) -> torch.Tensor:
    full = torch.zeros((n_tiles, t), dtype=res.dtype, device=res.device)
    full[idx] = res.reshape(-1, t)
    return full.reshape(-1)[:words]

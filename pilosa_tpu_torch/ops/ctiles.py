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
    nz           [3, Z]    the non-zero constants: row, tile, word

``payload_row``/``payload_tile`` are the skip index: a per-row count
touches exactly the P dense tiles, and the Z non-zero constant tiles
count by a closed form (zero tiles cost nothing), in one launch of the
hand-written kernel in ``csrc/ctile_count.cu`` for up to
:data:`MAX_BLOCKS` blocks of a stack on a CUDA tensor
(:func:`ctile_count_blocks`; its plain PyTorch version on a CPU tensor).
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

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.obs import devprof
from pilosa_tpu_torch.obs import metrics as M
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


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def tile_words(width: int) -> int:
    """Tile size for a block of ``width`` words: :data:`TILE_WORDS` (or
    ``PILOSA_TPU_COMPRESS_TILE_WORDS``), shrunk (power of two, floor 8)
    for blocks narrower than one tile."""
    t = _env_int("PILOSA_TPU_COMPRESS_TILE_WORDS", TILE_WORDS)
    if width >= t:
        return t
    p = 8
    while p < width:
        p <<= 1
    return min(p, t)


def why_not_compress(dense_nbytes: int) -> Optional[str]:
    """``None`` when a block of ``dense_nbytes`` should be classified,
    else why it stays dense: ``disabled`` | ``small``. The ratio rule
    comes after classification, which gives the stored size."""
    if disabled():
        return "disabled"
    if forced():
        return None
    if _env_int("PILOSA_TPU_COMPRESS_MIN_BYTES", MIN_BYTES) > dense_nbytes:
        return "small"
    return None


class CompressedBlock:
    """One row block in compressed-tile form: device tensors plus host
    metadata. Immutable once built."""

    __slots__ = ("rows", "words", "tile_words", "n_tiles", "payload",
                 "slot", "const", "payload_row", "payload_tile",
                 "n_payload", "nbytes", "dense_nbytes", "zero_tiles",
                 "run_tiles", "dense_tiles", "active_tiles", "device",
                 "nz", "n_nz", "nz_nbytes", "kernel_desc")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.words)

    def decode(self, rows: Optional[Sequence] = None) -> torch.Tensor:
        """Dense ``int32[R, words]`` (or a row subset), rebuilt on the
        device."""
        if rows is None:
            return _decode(self.payload, self.slot, self.const, self.words)
        idx = _device_index(rows, self.device)
        return _decode(self.payload, self.slot[idx], self.const[idx],
                       self.words)

    @classmethod
    def from_parts(cls, payload: torch.Tensor, payload_row: torch.Tensor,
                   payload_tile: torch.Tensor, const: torch.Tensor
                   ) -> "CompressedBlock":
        """A block to count over given parts (``payload [P, T]``, its skip
        index and the constant table ``[R, NT]``): every one of the P
        entries is counted, and the non-zero constants are listed on the
        device (which waits for it: the length depends on the data)."""
        cb = cls()
        cb.rows, cb.n_tiles = const.shape
        cb.tile_words = payload.shape[1]
        cb.words = cb.n_tiles * cb.tile_words
        cb.payload, cb.payload_row, cb.payload_tile = (
            payload, payload_row, payload_tile)
        cb.const = const
        cb.n_payload = payload.shape[0]
        cb.nz = _nonzero_list(const)
        cb.n_nz = cb.nz.shape[1]
        cb.nz_nbytes = cb.n_nz * 12
        cb.device = payload.device
        cb.kernel_desc = (payload.data_ptr(), payload_row.data_ptr(),
                          payload_tile.data_ptr(), cb.nz.data_ptr(),
                          cb.n_payload, cb.n_nz, cb.rows)
        return cb

    def row_counts(self, filt: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """``int32[R]`` per-row popcounts (of ``row & filt`` when given)
        that touch only the dense payload tiles plus a closed form for
        the non-zero constant tiles, in one ``ctile_count`` launch,
        whatever the constant words. Equal to
        ``topk.row_counts(self.decode(), filt)``."""
        return ctile_count_blocks([self], filt)


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


def nonzero_constants(const: np.ndarray) -> np.ndarray:
    """``uint32[3, Z]``: row, tile and word of each non-zero constant of
    a ``[R, NT]`` constant table, row-major (``np.nonzero`` order). Dense
    tiles hold 0 in the table, so these are the non-zero run tiles."""
    r, j = np.nonzero(const)
    out = np.empty((3, r.size), dtype=np.uint32)
    out[0], out[1], out[2] = r, j, const[r, j]
    return out


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _fallback(why: str, kind: str) -> None:
    # as in the JAX package, the kill switch costs nothing, not a tick
    if why != "disabled":
        M.REGISTRY.count(M.METRIC_COMPRESS_FALLBACK, why=why, kind=kind)


def maybe_compress(host: np.ndarray, device: torch.device,
                   kind: str = "set") -> Optional[CompressedBlock]:
    """Classify ``host`` and upload it to ``device`` as a
    :class:`CompressedBlock`, or ``None`` when the block stays dense (by
    policy or by the ratio rule). ``kind`` labels the ``METRIC_COMPRESS_*``
    series (``set`` | ``bsi``), which count what the JAX package's
    count."""
    why = why_not_compress(host.nbytes)
    if why is not None:
        _fallback(why, kind)
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
        _fallback("ratio", kind)
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
    # the kernel's constant list, charged to the budget beside nbytes
    # (core/stacked.py _nbytes); nbytes keeps the JAX package's formula
    nz = nonzero_constants(const)
    cb.nz = platform.h2d_copy(nz, device)
    cb.n_nz = nz.shape[1]
    cb.nz_nbytes = nz.nbytes
    cb.kernel_desc = (cb.payload.data_ptr(), cb.payload_row.data_ptr(),
                      cb.payload_tile.data_ptr(), cb.nz.data_ptr(),
                      n_payload, cb.n_nz, rows)
    M.REGISTRY.count(M.METRIC_COMPRESS_BLOCKS, kind=kind)
    M.REGISTRY.count(M.METRIC_COMPRESS_DENSE_BYTES, host.nbytes)
    M.REGISTRY.count(M.METRIC_COMPRESS_STORED_BYTES, stored)
    M.REGISTRY.gauge(M.METRIC_COMPRESS_RATIO, host.nbytes / max(stored, 1))
    return cb


# ---------------------------------------------------------------------------
# Decode (a gather on the device)
# ---------------------------------------------------------------------------


def _device_index(values, device) -> torch.Tensor:
    """``int64`` index tensor on ``device`` from host values. To the card
    it goes ``non_blocking`` from pinned memory: a pageable copy would
    wait for all the card's queued work, once per decoded leaf of a
    fused batch."""
    host = torch.as_tensor(np.asarray(values, dtype=np.int64))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


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

#: compressed blocks one launch counts (csrc/ctile_count.cu CT_MAX_BLOCKS)
MAX_BLOCKS = 16


def _nonzero_list(const: torch.Tensor) -> torch.Tensor:
    """The device form of :func:`nonzero_constants` for a constant table
    given as a tensor (a host sync: the length depends on the data)."""
    r, j = torch.nonzero(const, as_tuple=True)
    return torch.stack([r.to(torch.int32), j.to(torch.int32), const[r, j]])


def _counts_plain(payload: torch.Tensor, payload_row: torch.Tensor,
                  payload_tile: torch.Tensor, n_payload: int,
                  nz: torch.Tensor, rows: int,
                  filt_tiles: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel for one block: mask each of
    the first ``n_payload`` entries with its filter tile, popcount and
    sum it, ``index_add_`` the sums into their rows, then the same for
    the non-zero constants ``nz`` (a word ``c`` counts ``popcount(c) *
    T`` unfiltered, ``popcount(c & filter tile)`` filtered). Entries
    whose row is outside ``[0, rows)``, or whose tile is outside ``[0,
    NT)`` under a filter, are dropped."""
    t = payload.shape[1]
    prow = payload_row[:n_payload]
    keep = (prow >= 0) & (prow < rows)
    x = payload[:n_payload]
    if filt_tiles is not None:
        n_tiles = filt_tiles.shape[0]
        ptile = payload_tile[:n_payload]
        keep &= (ptile >= 0) & (ptile < n_tiles)
        x = x & filt_tiles[ptile.clamp(0, n_tiles - 1).long()]
    out = torch.zeros(rows, dtype=torch.int32, device=payload.device)
    out.index_add_(0, prow[keep].long(),
                   popcount(x).sum(dim=1, dtype=torch.int32)[keep])
    r, j, c = nz[0].long(), nz[1].long(), nz[2]
    if filt_tiles is None:
        per_const = popcount(c) * t
    else:
        per_const = popcount(filt_tiles[j] & c[:, None]).sum(
            dim=1, dtype=torch.int32)
    out.index_add_(0, r, per_const)
    return out


def ctile_count_plain(payload: torch.Tensor, payload_row: torch.Tensor,
                      payload_tile: torch.Tensor, const: torch.Tensor,
                      filt_tiles: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ctile_count`: every payload entry
    and the non-zero constants of ``const``, as :func:`_counts_plain`
    counts them."""
    return _counts_plain(payload, payload_row, payload_tile,
                         payload.shape[0], _nonzero_list(const),
                         const.shape[0], filt_tiles)


def _launch(descs, offsets, filt_tiles: Optional[torch.Tensor], t: int,
            n_tiles: int, out: torch.Tensor, timing=None) -> None:
    """One kernel launch over at most MAX_BLOCKS blocks, each given as
    (payload, payload_row, payload_tile, nz pointers, n_payload, n_nz,
    rows) and counted into ``out`` from its offset. ``timing``: the
    device profiler's ``KU.PkTiming``, or None."""
    flat = []
    for d, off in zip(descs, offsets):
        flat.extend(d)
        flat.append(off)
    dev = out.device
    rc = KU.lib().pk_ctile_count(
        (ctypes.c_longlong * len(flat))(*flat), len(descs),
        None if filt_tiles is None else filt_tiles.data_ptr(), t, n_tiles,
        out.data_ptr(), dev.index, KU.stream(out), timing)
    KU.check(rc, "ctile_count")
    ctile_count_launches.bump()


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

    CUDA tensors: the one-block case of :func:`ctile_count_blocks`' kernel
    (csrc/ctile_count.cu, which replaces pilosa_tpu/ops/ctiles.py:291/:301
    with the mask (:342), the scatter-add (:348) and the constant tiles'
    counts (:355/:362) fused in), over all P entries of
    :meth:`CompressedBlock.from_parts` (whose constant list waits for the
    card; the stack path passes lists built with the blocks). CPU
    tensors: :func:`ctile_count_plain`."""
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
    if t == 0 or rows == 0:
        return torch.zeros(rows, dtype=torch.int32, device=payload.device)
    return ctile_count_blocks(
        [CompressedBlock.from_parts(payload, payload_row, payload_tile,
                                    const)], filt_tiles)


def _blocks_args(blocks: Sequence[CompressedBlock],
                 filt: Optional[torch.Tensor],
                 out: Optional[torch.Tensor], offsets):
    """Checked (out, offsets, filter tiles) of a many-block count."""
    if not blocks:
        raise ValueError("ctile_count_blocks: no blocks")
    first = blocks[0]
    shape = (first.words, first.tile_words, first.n_tiles)
    for cb in blocks:
        if (cb.words, cb.tile_words, cb.n_tiles) != shape:
            raise ValueError("ctile_count_blocks: blocks of one width and "
                             "tile size only")
    if out is None:
        offsets, total = [], 0
        for cb in blocks:
            offsets.append(total)
            total += cb.rows
        out = torch.zeros(total, dtype=torch.int32, device=first.device)
    else:
        if offsets is None or len(offsets) != len(blocks):
            raise ValueError("ctile_count_blocks: one offset per block")
        KU.check_words("ctile_count_blocks", "out", out, 1)
        for cb, off in zip(blocks, offsets):
            if off < 0 or off + cb.rows > out.numel():
                raise ValueError(f"ctile_count_blocks: rows [{off}, "
                                 f"{off + cb.rows}) outside the output")
    ft = filt
    if filt is not None and filt.dim() == 1:
        ft = _filt_tiles(filt, first.n_tiles, first.tile_words)
    if ft is not None and tuple(ft.shape) != (first.n_tiles,
                                              first.tile_words):
        raise ValueError(f"ctile_count_blocks: filter tiles "
                         f"{tuple(ft.shape)} are not {first.n_tiles} tiles "
                         f"of {first.tile_words} words")
    return out, offsets, ft


def ctile_count_blocks_plain(blocks: Sequence[CompressedBlock],
                             filt: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None,
                             offsets: Optional[Sequence[int]] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ctile_count_blocks`, block by
    block."""
    out, offsets, ft = _blocks_args(blocks, filt, out, offsets)
    for cb, off in zip(blocks, offsets):
        out[off:off + cb.rows] += _counts_plain(
            cb.payload, cb.payload_row, cb.payload_tile, cb.n_payload,
            cb.nz, cb.rows, ft)
    return out


def ctile_count_blocks(blocks: Sequence[CompressedBlock],
                       filt: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None,
                       offsets: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """Per-row popcounts of compressed blocks of one width (the blocks of
    a stack), each as :meth:`CompressedBlock.row_counts` counts it.

    ``filt`` is a filter plane ``[words]`` (cut into tiles once here) or
    its tiles ``[NT, T]``. Without ``out`` the counts come back
    concatenated, ``int32[sum of rows]``; with it, block ``i``'s rows are
    added into ``out[offsets[i]:]``, which the caller zeroed.

    CUDA tensors: one launch of csrc/ctile_count.cu per
    :data:`MAX_BLOCKS` blocks, over each block's real payload entries
    and its list of non-zero constants. CPU tensors:
    :func:`ctile_count_blocks_plain`."""
    out, offsets, ft = _blocks_args(blocks, filt, out, offsets)
    first = blocks[0]
    card = KU.on_card("ctile_count", first.payload, out,
                      *([] if ft is None else [ft]))
    if card and ft is not None:
        KU.check_words("ctile_count", "filt_tiles", ft, 2)
    M.REGISTRY.count(M.METRIC_COMPRESS_TILES_SKIPPED, sum(
        cb.rows * cb.n_tiles - cb.n_payload for cb in blocks))
    for lo in range(0, len(blocks), MAX_BLOCKS):
        group = blocks[lo:lo + MAX_BLOCKS]
        offs = offsets[lo:lo + MAX_BLOCKS]
        with _count_scope(group, out) as prof:
            if card:
                _launch([cb.kernel_desc for cb in group], offs, ft,
                        first.tile_words, first.n_tiles, out, prof.timing)
            else:
                ctile_count_blocks_plain(group, ft, out, offs)
    return out


def _count_scope(group: Sequence[CompressedBlock], out: torch.Tensor):
    """Profiler scope of one launch over ``group``: the JAX package's
    ``pop`` family over the payload entries it counts, of one tile
    each."""
    if not devprof.ENABLED:
        return devprof.NULL_SCOPE
    return KU.kernel_scope("pop", sum(cb.n_payload for cb in group), 1, 1,
                           group[0].tile_words, out)


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
    M.REGISTRY.count(M.METRIC_COMPRESS_TILES_SKIPPED,
                     cb.rows * (cb.n_tiles - active.size))
    idx = _device_index(active, cb.device)
    narrow = _decode(cb.payload, cb.slot[:, idx], cb.const[:, idx],
                     active.size * cb.tile_words)
    res = bsiops.bsi_compare(narrow, op, value, value2)
    return _scatter_tiles(res, idx, cb.n_tiles, cb.tile_words, cb.words)


def _scatter_tiles(res: torch.Tensor, idx: torch.Tensor, n_tiles: int,
                   t: int, words: int) -> torch.Tensor:
    full = torch.zeros((n_tiles, t), dtype=res.dtype, device=res.device)
    full[idx] = res.reshape(-1, t)
    return full.reshape(-1)[:words]

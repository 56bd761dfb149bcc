"""Pilosa roaring wire codec (clean-room from the format spec).

Port of ``pilosa_tpu/storage/roaring.py``: the same bytes both ways, so
a blob either package encodes decodes in the other.

The reference serializes fragment bitmaps in its own roaring file format
(reference: roaring/roaring.go:19-50 constants, :1730 WriteTo, :1986
newPilosaRoaringIterator):

    byte 0-1   magic 12348 (LE u16 within a u32 cookie)
    byte 2     storage version (0)
    byte 3     user flags
    byte 4-7   container count (LE u32)
    per container, 12 bytes interleaved:
        key (LE u64)         -- bit-position >> 16
        type (LE u16)        -- 1=array, 2=bitmap, 3=run
        cardinality-1 (LE u16)
    per container, 4 bytes: absolute file offset of its data (LE u32)
    container data:
        array:  N x u16 LE sorted low-bits
        bitmap: 1024 x u64 LE
        run:    run count (LE u16), then (first, last) u16 pairs

This codec exists for wire parity: the reference's import-roaring payloads
and backup files are in this format. The engine itself stays dense — the
decoder inflates straight into plane words, the encoder picks the smallest
container encoding like the reference's Optimize().
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 12348
STORAGE_VERSION = 0

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

CONTAINER_BITS = 1 << 16
_ARRAY_MAX = 4096  # reference: array containers hold <= 4096 values


class RoaringError(ValueError):
    pass


def decode(data: bytes) -> Dict[int, np.ndarray]:
    """Parse a pilosa-format roaring blob into {container key:
    sorted uint16 low-bit values}."""
    if len(data) < 8:
        raise RoaringError("data too short for roaring header")
    magic = struct.unpack_from("<H", data, 0)[0]
    if magic != MAGIC:
        raise RoaringError(
            f"unknown roaring magic {magic} (official-format files are not "
            "supported yet; re-export with the pilosa writer)")
    version = data[2]
    if version != STORAGE_VERSION:
        raise RoaringError(f"unsupported roaring version {version}")
    n = struct.unpack_from("<I", data, 4)[0]
    header_end = 8 + 12 * n
    offset_end = header_end + 4 * n
    if len(data) < offset_end:
        raise RoaringError("data too short for container headers")
    out: Dict[int, np.ndarray] = {}
    for i in range(n):
        key, typ, nm1 = struct.unpack_from("<QHH", data, 8 + 12 * i)
        card = nm1 + 1
        off = struct.unpack_from("<I", data, header_end + 4 * i)[0]

        def need(nbytes: int, what: str):
            if off + nbytes > len(data):
                raise RoaringError(
                    f"container {key}: truncated {what} (need {nbytes} bytes "
                    f"at offset {off}, blob is {len(data)})")

        if typ == TYPE_ARRAY:
            need(2 * card, "array body")
            vals = np.frombuffer(data, dtype="<u2", count=card, offset=off).copy()
        elif typ == TYPE_BITMAP:
            need(8192, "bitmap body")
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=off)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            vals = np.nonzero(bits)[0].astype(np.uint16)
            if vals.size != card:
                raise RoaringError(
                    f"bitmap container {key}: cardinality {vals.size} != header {card}")
        elif typ == TYPE_RUN:
            need(2, "run count")
            run_n = struct.unpack_from("<H", data, off)[0]
            need(2 + 4 * run_n, "run body")
            runs = np.frombuffer(data, dtype="<u2", count=run_n * 2,
                                 offset=off + 2).reshape(run_n, 2)
            vals = np.concatenate([
                np.arange(int(a), int(b) + 1, dtype=np.uint32)
                for a, b in runs
            ]) if run_n else np.empty(0, np.uint32)
            vals = vals.astype(np.uint16)
        else:
            raise RoaringError(f"unknown container type {typ}")
        out[int(key)] = vals
    return out


def decode_to_positions(data: bytes) -> np.ndarray:
    """Absolute sorted bit positions (uint64) of a roaring blob."""
    containers = decode(data)
    if not containers:
        return np.empty(0, dtype=np.uint64)
    parts = [
        (np.uint64(key) << np.uint64(16)) + vals.astype(np.uint64)
        for key, vals in sorted(containers.items())
    ]
    return np.concatenate(parts)


def _runs_of(vals: np.ndarray) -> List[Tuple[int, int]]:
    if vals.size == 0:
        return []
    breaks = np.nonzero(np.diff(vals.astype(np.int64)) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [vals.size - 1]])
    return [(int(vals[s]), int(vals[e])) for s, e in zip(starts, ends)]


def encode(containers: Dict[int, np.ndarray], flags: int = 0) -> bytes:
    """Serialize {container key: sorted uint16 values} choosing the
    smallest encoding per container (the reference's Optimize(),
    roaring/roaring.go container size comparison)."""
    keys = sorted(k for k, v in containers.items() if len(v))
    bodies: List[bytes] = []
    headers: List[bytes] = []
    for key in keys:
        vals = np.asarray(containers[key], dtype=np.uint16)
        card = int(vals.size)
        runs = _runs_of(vals)
        array_size = 2 * card
        run_size = 2 + 4 * len(runs)
        bitmap_size = 8192
        best = min(array_size if card <= _ARRAY_MAX else 1 << 30,
                   run_size, bitmap_size)
        if best == run_size:
            typ = TYPE_RUN
            body = struct.pack("<H", len(runs)) + b"".join(
                struct.pack("<HH", a, b) for a, b in runs)
        elif best == array_size:
            typ = TYPE_ARRAY
            body = vals.astype("<u2").tobytes()
        else:
            typ = TYPE_BITMAP
            bits = np.zeros(CONTAINER_BITS, dtype=np.uint8)
            bits[vals] = 1
            body = np.packbits(bits, bitorder="little").tobytes()
        bodies.append(body)
        headers.append(struct.pack("<QHH", key, typ, card - 1))
    cookie = MAGIC | (STORAGE_VERSION << 16) | (flags << 24)
    out = [struct.pack("<II", cookie, len(keys))]
    out.extend(headers)
    offset = 8 + 16 * len(keys)
    for body in bodies:
        out.append(struct.pack("<I", offset))
        offset += len(body)
    out.extend(bodies)
    return b"".join(out)


def encode_positions(positions) -> bytes:
    """Serialize absolute bit positions into the pilosa roaring format."""
    pos = np.unique(np.asarray(positions, dtype=np.uint64))
    keys = (pos >> np.uint64(16)).astype(np.uint64)
    # the positions are sorted: each container is one slice between the
    # key changes (one pass, not a pass a key)
    cuts = np.concatenate([[0], np.flatnonzero(np.diff(keys)) + 1,
                           [pos.size]]) if pos.size else np.zeros(1, int)
    containers: Dict[int, np.ndarray] = {}
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        containers[int(keys[lo])] = (pos[lo:hi] & np.uint64(0xFFFF)
                                     ).astype(np.uint16)
    return encode(containers)

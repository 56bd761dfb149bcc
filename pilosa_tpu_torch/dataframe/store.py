"""Per-shard columnar store backing Apply() and Arrow().

Port of ``pilosa_tpu/dataframe/store.py`` (reference: one Arrow/Parquet
file per shard next to the bitmap data, index.go:1035, apply.go:347,
ingested as changesets of shard-local row ids and typed column slices,
apply.go:278): host-canonical numpy columns per shard (float64 or int64,
with a validity mask), uploaded to the store's device as ``float32[S,
cap]`` stacks under a versioned cache that Apply's expression reads
(dataframe/expr.py). The stacks are not charged to the ``DeviceBudget``,
as in the JAX package. A changeset and a delete are logged to the
index's WAL (``df_changeset`` / ``df_delete``, the JAX package's
records), and a checkpoint saves one npz per shard under the index's
``dataframe`` directory in the JAX package's layout.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

_FRAME_RE = re.compile(r"shard\.(\d+)\.npz$")
_MIN_CAP = 1024
#: device stacks kept, oldest dropped first
_CACHE_ENTRIES = 8


def _pow2(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


class ShardFrame:
    """Columns of one shard, keyed by shard-local position."""

    def __init__(self, shard: int):
        self.shard = shard
        self.columns: Dict[str, np.ndarray] = {}  # float64 or int64
        self.valid: Dict[str, np.ndarray] = {}  # bool, same length
        self.version = 0

    def _grow(self, name: str, need: int, dtype) -> None:
        col = self.columns.get(name)
        cap = _pow2(need)
        if col is None:
            self.columns[name] = np.zeros(cap, dtype=dtype)
            self.valid[name] = np.zeros(cap, dtype=bool)
        elif col.size < need:
            self.columns[name] = np.resize(col, cap)
            self.columns[name][col.size:] = 0
            v = self.valid[name]
            self.valid[name] = np.resize(v, cap)
            self.valid[name][v.size:] = False

    def set_column(self, name: str, positions: Sequence[int],
                   values: Sequence) -> None:
        positions = np.asarray(positions, dtype=np.int64)
        if positions.size == 0:
            return
        if positions.max() >= SHARD_WIDTH or positions.min() < 0:
            raise ValueError("dataframe positions must be shard-local")
        vals = np.asarray(values)
        dtype = np.int64 if vals.dtype.kind in "iub" else np.float64
        vals = vals.astype(dtype)
        self._grow(name, int(positions.max()) + 1, dtype)
        if self.columns[name].dtype != dtype:
            # an int column receiving floats (or the reverse) turns float
            self.columns[name] = self.columns[name].astype(np.float64)
            vals = vals.astype(np.float64)
        self.columns[name][positions] = vals
        self.valid[name][positions] = True
        self.version += 1

    def length(self) -> int:
        return max((c.size for c in self.columns.values()), default=0)


class DataframeStore:
    """All shard frames of one index, and the stacked device cache."""

    def __init__(self, index_name: str, device: torch.device,
                 path: Optional[str] = None, wal=None):
        self.index_name = index_name
        self.device = device
        self.path = path  # <index dir>/dataframe
        self.wal = wal
        self.frames: Dict[int, ShardFrame] = {}
        self._device_cache: Dict[Tuple, Tuple] = {}
        self._lock = threading.Lock()

    # -- write path --------------------------------------------------------

    def apply_changeset(self, shard: int, shard_ids: Sequence[int],
                        columns: Dict[str, Sequence],
                        log: bool = True) -> None:
        """Reference: apply.go:400 ShardFile.Process: one changeset sets
        several columns at the same shard-local row ids. Validated before
        it is logged, so a rejected changeset never reaches the WAL."""
        ids = [int(i) for i in shard_ids]
        for name, values in columns.items():
            if len(values) != len(ids):
                raise ValueError(
                    f"column {name!r} length {len(values)} != ids {len(ids)}")
        frame = self.frames.get(shard)
        if frame is None:
            frame = self.frames[shard] = ShardFrame(shard)
        if log and self.wal is not None:
            self.wal.append(("df_changeset", "", shard, ids,
                             {k: list(map(float, v)) if _is_float(v)
                              else [int(x) for x in v]
                              for k, v in columns.items()}))
        for name, values in columns.items():
            frame.set_column(name, ids, values)

    def delete(self, log: bool = True) -> None:
        """Drop all frames, their device stacks and their checkpoint
        files; logged as a tombstone, so replaying earlier changesets on
        reopen does not resurrect them."""
        if log and self.wal is not None:
            self.wal.append(("df_delete", ""))
        self.frames.clear()
        self.release_device()
        if self.path and os.path.isdir(self.path):
            shutil.rmtree(self.path)

    def release_device(self) -> None:
        """Drop the device stacks (the next Apply restacks)."""
        with self._lock:
            self._device_cache.clear()

    # -- schema / read -----------------------------------------------------

    def schema(self) -> List[dict]:
        cols: Dict[str, str] = {}
        for frame in self.frames.values():
            for name, arr in frame.columns.items():
                kind = "int64" if arr.dtype.kind == "i" else "float64"
                prev = cols.get(name)
                cols[name] = "float64" if prev == "float64" else kind
        return [{"name": n, "type": t} for n, t in sorted(cols.items())]

    def shards(self) -> List[int]:
        return sorted(self.frames)

    # -- persistence (checkpoint files; reference: parquet per shard) ------

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(self.path, exist_ok=True)
        for shard, frame in self.frames.items():
            arrays = {}
            for name, col in frame.columns.items():
                arrays[f"c:{name}"] = col
                arrays[f"v:{name}"] = frame.valid[name]
            tmp = os.path.join(self.path, f"shard.{shard}.npz.tmp")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **arrays)
            os.replace(tmp, os.path.join(self.path, f"shard.{shard}.npz"))

    def load(self) -> None:
        if not self.path or not os.path.isdir(self.path):
            return
        for fp in glob.glob(os.path.join(self.path, "shard.*.npz")):
            m = _FRAME_RE.search(fp)
            if not m:
                continue
            shard = int(m.group(1))
            frame = self.frames.setdefault(shard, ShardFrame(shard))
            with np.load(fp) as z:
                for key in z.files:
                    kind, name = key.split(":", 1)
                    if kind == "c":
                        frame.columns[name] = z[key]
                    else:
                        frame.valid[name] = z[key]
            frame.version += 1

    # -- device path -------------------------------------------------------

    def device_columns(self, names: Sequence[str], shard_list: Sequence[int]
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, int]:
        """Stacked ``float32[S, cap]`` columns and their combined validity
        ``bool[S, cap]`` on the store's device, for the columns an Apply
        expression reads; cap is the pow2 of the longest frame. A row is
        usable where every named column has a value (with no names: where
        any column has one). Cached by (names, shards) and checked
        against the frames' versions."""
        key = (tuple(sorted(names)), tuple(shard_list))
        vers = tuple(
            self.frames[s].version if s in self.frames else -1
            for s in shard_list)
        with self._lock:
            hit = self._device_cache.get(key)
            if hit is not None and hit[0] == vers:
                return hit[1], hit[2], hit[3]
        cap = _pow2(max((self.frames[s].length() for s in shard_list
                         if s in self.frames), default=_MIN_CAP))
        S = len(shard_list)
        cols: Dict[str, torch.Tensor] = {}
        dev = self.device
        if names:
            valid_t = platform.staging((S, cap), torch.bool, dev, fill=1)
            valid_np = valid_t.numpy()
            for name in names:
                host_t = platform.staging((S, cap), torch.float32, dev)
                host = host_t.numpy()
                vmask = np.zeros((S, cap), dtype=bool)
                for si, shard in enumerate(shard_list):
                    frame = self.frames.get(shard)
                    if frame is None or name not in frame.columns:
                        continue
                    col = frame.columns[name]
                    host[si, : col.size] = col
                    vmask[si, : col.size] = frame.valid[name][: col.size]
                cols[name] = platform.h2d_copy(host_t, dev, non_blocking=True)
                valid_np &= vmask
        else:
            valid_t = platform.staging((S, cap), torch.bool, dev)
            valid_np = valid_t.numpy()
            for si, shard in enumerate(shard_list):
                frame = self.frames.get(shard)
                if frame is None:
                    continue
                for v in frame.valid.values():
                    valid_np[si, : v.size] |= v
        valid = platform.h2d_copy(valid_t, dev, non_blocking=True)
        with self._lock:
            self._device_cache[key] = (vers, cols, valid, cap)
            while len(self._device_cache) > _CACHE_ENTRIES:
                self._device_cache.pop(next(iter(self._device_cache)))
        return cols, valid, cap


def _is_float(values) -> bool:
    return np.asarray(values).dtype.kind == "f"

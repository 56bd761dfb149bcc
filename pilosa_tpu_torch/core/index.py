"""Index: a table of records (columns) with typed fields.

Port of ``pilosa_tpu/core/index.py``: maintains the existence field
``_exists`` (reference: index.go:384) so Not/All have a universe to
complement against, deletes records from every field with one WAL
record, deletes fields with a WAL tombstone, keeps the partitioned
record-key store when ``keys=True``, and holds the index's dataframe
store (Apply / Arrow) on the index's device. A durable index has a data
directory and a WAL (storage/wal.py) shared by its fields and its
dataframe.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional, Set

import torch

from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.core.stacked import release_field_cache
from pilosa_tpu_torch.core.translate import PartitionedTranslateStore
from pilosa_tpu_torch.dataframe.store import DataframeStore
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.wal import pack_plane

EXISTENCE_FIELD = "_exists"
EXISTENCE_ROW = 0


class Index:
    def __init__(self, name: str, device: torch.device,
                 options: Optional[IndexOptions] = None, lock=None,
                 path: Optional[str] = None, wal=None):
        if not name or not name[0].isalpha() or name != name.lower():
            raise ValueError(f"invalid index name {name!r}")
        self.name = name
        self.device = device
        self.options = options or IndexOptions()
        self.path = path
        self.wal = wal  # per-index write-ahead log (storage/wal.py)
        # one writer lock shared down the ownership tree: stack builds
        # hold it so lock-free readers never see a half-applied write
        self.write_lock = lock if lock is not None else threading.RLock()
        self.fields: Dict[str, Field] = {}
        self.translate = (
            PartitionedTranslateStore(
                name, os.path.join(path, "keys.jsonl") if path else None)
            if self.options.keys else None)
        if self.options.track_existence:
            self._create_field_object(EXISTENCE_FIELD,
                                      FieldOptions(type=FieldType.SET))
        # per-consumer-group stream watermarks ({group: {"topic:partition"
        # -> next offset}}), kept by ``stream_offsets`` WAL records and
        # stamped into checkpoint.json; not part of checksum()
        self.stream_offsets: Dict[str, Dict[str, int]] = {}
        self.dataframe = DataframeStore(
            name, device, os.path.join(path, "dataframe") if path else None,
            wal=wal)

    def _field_path(self, name: str) -> Optional[str]:
        return os.path.join(self.path, "fields", name) if self.path else None

    def _create_field_object(self, name: str, options: FieldOptions) -> Field:
        field = Field(name, options, self.device,
                      write_lock=self.write_lock,
                      path=self._field_path(name))
        field.wal = self.wal
        self.fields[name] = field
        return field

    def create_field(self, name: str,
                     options: Optional[FieldOptions] = None) -> Field:
        if name in self.fields:
            raise ValueError(f"field {name!r} already exists")
        if not name or name != name.lower():
            raise ValueError(f"invalid field name {name!r}")
        return self._create_field_object(name, options or FieldOptions())

    def field(self, name: str) -> Field:
        f = self.fields.get(name)
        if f is None:
            raise KeyError(f"field {name!r} not found in index {self.name!r}")
        return f

    def delete_field(self, name: str) -> None:
        """Drop a field, its device stacks and its checkpoint files, and
        log a tombstone, so neither WAL replay nor the npz loader
        resurrects its data into a re-created field of the same name."""
        if name == EXISTENCE_FIELD:
            raise ValueError("cannot delete the existence field")
        release_field_cache(self.fields[name])
        del self.fields[name]
        if self.wal is not None:
            self.wal.append(("delete_field", name))
        fpath = self._field_path(name)
        if fpath and os.path.isdir(fpath):
            shutil.rmtree(fpath)

    def public_fields(self) -> List[Field]:
        return [f for n, f in sorted(self.fields.items())
                if n != EXISTENCE_FIELD]

    @property
    def existence(self) -> Optional[Field]:
        return self.fields.get(EXISTENCE_FIELD)

    def add_exists(self, col: int) -> None:
        """Record that a column exists (every write, when the index
        tracks existence)."""
        if self.options.track_existence:
            self.fields[EXISTENCE_FIELD].set_bit(EXISTENCE_ROW, col)

    def delete_columns(self, shard: int, plane) -> None:
        """Delete records: clear the columns of ``plane`` from every
        field of this shard, every view and the BSI planes included, with
        ONE WAL record (reference: executor.go:9050
        executeDeleteRecords)."""
        if self.wal is not None:
            self.wal.append(("delete_cols", "", shard, pack_plane(plane)))
        for field in self.fields.values():
            field.clear_columns(shard, plane, log=False)

    def existence_plane(self, shard: int):
        """The existence row of a shard (host), or None if untracked."""
        ex = self.existence
        if ex is None:
            return None
        frag = ex.fragment(shard)
        if frag is None:
            return None
        return frag.row_plane(EXISTENCE_ROW)

    def shards(self) -> Set[int]:
        """All shards holding data in any field or the dataframe
        (reference: field.go:454 available shards, unioned; dataframe
        shard files, index.go:1035)."""
        out: Set[int] = set()
        for f in self.fields.values():
            out |= f.shards()
        out.update(self.dataframe.frames)
        return out or {0}

    def max_column(self) -> int:
        return (max(self.shards()) + 1) * SHARD_WIDTH

"""Index: a table of records (columns) with typed fields.

Port of ``pilosa_tpu/core/index.py``: maintains the existence field
``_exists`` (reference: index.go:384) so Not/All have a universe to
complement against, deletes records from every field, keeps the
partitioned record-key store when ``keys=True``, and holds the index's
dataframe store (Apply / Arrow) on the index's device.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

import torch

from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.core.translate import PartitionedTranslateStore
from pilosa_tpu_torch.dataframe.store import DataframeStore

EXISTENCE_FIELD = "_exists"
EXISTENCE_ROW = 0


class Index:
    def __init__(self, name: str, device: torch.device,
                 options: Optional[IndexOptions] = None, lock=None):
        if not name or not name[0].isalpha() or name != name.lower():
            raise ValueError(f"invalid index name {name!r}")
        self.name = name
        self.device = device
        self.options = options or IndexOptions()
        # one writer lock shared down the ownership tree: stack builds
        # hold it so lock-free readers never see a half-applied write
        self.write_lock = lock if lock is not None else threading.RLock()
        self.fields: Dict[str, Field] = {}
        self.translate = (PartitionedTranslateStore(name)
                          if self.options.keys else None)
        if self.options.track_existence:
            self._create_field_object(EXISTENCE_FIELD,
                                      FieldOptions(type=FieldType.SET))
        self.dataframe = DataframeStore(name, device)

    def _create_field_object(self, name: str, options: FieldOptions) -> Field:
        field = Field(name, options, self.device,
                      write_lock=self.write_lock)
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
        field of this shard, every view and the BSI planes included
        (reference: executor.go:9050 executeDeleteRecords)."""
        for field in self.fields.values():
            field.clear_columns(shard, plane)

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

"""API facade: the programmatic surface over holder + executor.

Port of the core of ``pilosa_tpu/api.py`` (reference: api.go:209): create
indexes and fields, bulk-import bits (by row id or row key, with the
``_exists`` field kept up to date) and run PQL reads. ``API()`` runs on
the card, ``cuda:0``; ``API(device="cpu")`` runs every kernel's plain
PyTorch version on the CPU. Without a card, ``API()`` raises.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.core.translate import bulk_translate_ids
from pilosa_tpu_torch.pql.executor import Executor


class API:
    def __init__(self, device: platform.DeviceLike = None):
        self.device = platform.resolve_device(device)
        self.holder = Holder(self.device)
        self.executor = Executor(self.holder)

    # -- schema (reference: api.go CreateIndex/CreateField) -----------------

    def create_index(self, name: str, options: Optional[dict] = None) -> Index:
        opts = IndexOptions(
            keys=bool((options or {}).get("keys", False)),
            track_existence=bool((options or {}).get("trackExistence", True)),
        )
        return self.holder.create_index(name, opts)

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None) -> None:
        o = dict(options or {})
        fo = FieldOptions(
            type=FieldType(o.pop("type", "set")),
            keys=bool(o.pop("keys", False)),
            cache_type=o.pop("cacheType", "ranked"),
            cache_size=int(o.pop("cacheSize", 50000)),
        )
        if o:
            raise ValueError(f"not ported yet: field options {sorted(o)}")
        self.holder.index(index).create_field(field, fo)

    # -- query (reference: api.go:209 Query) -------------------------------

    def query(self, index: str, pql: str,
              shards: Optional[Sequence[int]] = None) -> List[Any]:
        return self.executor.execute(index, pql, shards=shards)

    # -- bulk import (reference: api.go:1438 Import) -------------------------

    def import_bits(self, index: str, field: str,
                    rows: Sequence[int] = (),
                    cols: Optional[Sequence[int]] = None,
                    row_keys: Optional[Sequence[str]] = None,
                    col_keys: Optional[Sequence[str]] = None) -> int:
        """Bulk (row, col) import, translating keys when given; marks
        every column in ``_exists`` when the index tracks existence."""
        idx = self.holder.index(index)
        fld = idx.field(field)
        if row_keys is not None:
            if fld.translate is None:
                raise ValueError(f"field {field!r} does not use string keys")
            rows = bulk_translate_ids(fld.translate, row_keys)
        if col_keys is not None:
            if idx.translate is None:
                raise ValueError(f"index {index!r} does not use string keys")
            cols = bulk_translate_ids(idx.translate, col_keys)
        if cols is None or len(rows) != len(cols):
            raise ValueError("rows and cols must be the same length")
        with self.holder.write_lock:
            changed = fld.import_bits(rows, cols)
            if idx.options.track_existence:
                idx.field(EXISTENCE_FIELD).import_bits(
                    np.zeros(len(cols), dtype=np.int64), cols)
        return changed

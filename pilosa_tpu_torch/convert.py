"""Load plain state into a port ``API``.

``state`` is plain Python and numpy, so any holder can be carried over —
including the JAX package's, by code that reads it (the port itself never
imports that package):

    {"indexes": [{
        "name": "ssb",
        "options": {"keys": False, "track_existence": True},
        "column_keys": {"key": id, ...},            # keyed indexes only
        "fields": [{
            "name": "brand",                          # "_exists" included
            "options": {"type": "mutex", "keys": True, ...},
            "row_keys": {"MFGR#1000": 1, ...},        # keyed fields only
            "shards": {0: {"row_ids": [1, 2, ...],
                           "planes": np.uint32[n_rows, WORDS_PER_SHARD]}},
            "views": {"standard_2010": {0: {"row_ids": [...],  # time
                                            "planes": ...}}},
            "bsi": {0: np.uint32[2 + depth, WORDS_PER_SHARD]},  # int-like
        }, ...],
        "dataframe": {0: {"columns": {"fare": np.float64[cap], ...},
                          "valid": {"fare": np.bool_[cap], ...}}},
    }, ...]}

Row ``i`` of ``planes`` holds the bits of ``row_ids[i]``: ``shards``
holds the standard view, and ``views`` any other view by name (a
``time`` field's quantum views), shard by shard in the same form. A
``bsi`` stack is an int-like field's [exists, sign, magnitude bits
LSB-first] planes of one shard. Any of the three keys may be absent.
An index's ``dataframe`` (absent when it has none) holds, per shard,
each column's values (int64 or float64) and validity as the source's
frame holds them. After loading, the port answers what the source
answered.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.fragment import _grow_rows
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD
from pilosa_tpu_torch.ops.bsi import OFFSET
from pilosa_tpu_torch.core.schema import FieldOptions, IndexOptions
from pilosa_tpu_torch.dataframe.store import ShardFrame
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD


def load_state(api, state: dict) -> None:
    for idx_state in state["indexes"]:
        idx = api.holder.create_index(
            idx_state["name"], IndexOptions.from_json(idx_state["options"]))
        if idx.translate is not None:
            idx.translate.replace_all(idx_state.get("column_keys", {}))
        for f_state in idx_state["fields"]:
            name = f_state["name"]
            opts = FieldOptions.from_json(f_state["options"])
            fld = (idx.field(name) if name == EXISTENCE_FIELD
                   else idx.create_field(name, opts))
            if fld.translate is not None:
                fld.translate.replace_all(f_state.get("row_keys", {}))
            for shard, planes in f_state.get("bsi", {}).items():
                planes = np.asarray(planes, dtype=np.uint32)
                if (planes.ndim != 2 or planes.shape[0] <= OFFSET
                        or planes.shape[1] != WORDS_PER_SHARD):
                    raise ValueError(f"{name} shard {shard}: BSI planes "
                                     f"{planes.shape} are not a stack")
                frag = fld.bsi_fragment(int(shard), create=True)
                frag.planes = planes.copy()
                frag.depth = planes.shape[0] - OFFSET
                frag.version += 1
            views = dict(f_state.get("views", {}))
            if "shards" in f_state:
                views[timeq.VIEW_STANDARD] = f_state["shards"]
            for view, shards in views.items():
                for shard, sh in shards.items():
                    _load_rows(fld, name, view, int(shard), sh)
        for shard, fr in idx_state.get("dataframe", {}).items():
            _load_frame(idx, int(shard), fr)


def _load_rows(fld, name: str, view: str, shard: int, sh: dict) -> None:
    row_ids = [int(r) for r in sh["row_ids"]]
    planes = np.asarray(sh["planes"], dtype=np.uint32)
    if planes.shape != (len(row_ids), WORDS_PER_SHARD):
        raise ValueError(f"{name} view {view} shard {shard}: planes "
                         f"{planes.shape} do not match {len(row_ids)} rows")
    frag = fld.fragment(shard, view, create=True)
    frag.planes = _grow_rows(planes.copy(), len(row_ids))
    frag.row_ids = row_ids
    frag.row_index = {r: i for i, r in enumerate(row_ids)}
    frag.version += 1


def _load_frame(idx, shard: int, fr: dict) -> None:
    frame = ShardFrame(shard)
    for name, col in fr["columns"].items():
        col = np.array(col)
        valid = np.array(fr["valid"][name], dtype=bool)
        if col.dtype.kind not in "if" or valid.shape != col.shape:
            raise ValueError(f"dataframe shard {shard} column {name}: "
                             f"{col.dtype} values and {valid.shape} validity "
                             f"do not form a column")
        frame.columns[name] = col.astype(
            np.int64 if col.dtype.kind == "i" else np.float64)
        frame.valid[name] = valid
    frame.version += 1
    idx.dataframe.frames[shard] = frame

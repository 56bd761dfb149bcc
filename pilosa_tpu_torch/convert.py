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
        }, ...],
    }, ...]}

Row ``i`` of ``planes`` holds the bits of ``row_ids[i]`` in the standard
view. After loading, the port answers what the source answered.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.fragment import _grow_rows
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD
from pilosa_tpu_torch.core.schema import FieldOptions, IndexOptions
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
            for shard, sh in f_state["shards"].items():
                row_ids = [int(r) for r in sh["row_ids"]]
                planes = np.asarray(sh["planes"], dtype=np.uint32)
                if planes.shape != (len(row_ids), WORDS_PER_SHARD):
                    raise ValueError(
                        f"{name} shard {shard}: planes {planes.shape} do "
                        f"not match {len(row_ids)} rows")
                frag = fld.fragment(int(shard), timeq.VIEW_STANDARD,
                                    create=True)
                frag.planes = _grow_rows(planes.copy(), len(row_ids))
                frag.row_ids = row_ids
                frag.row_index = {r: i for i, r in enumerate(row_ids)}
                frag.version += 1


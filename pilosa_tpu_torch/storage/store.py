"""Fragment persistence: one compressed npz per (field, view, shard).

Port of ``pilosa_tpu/storage/store.py`` with the same npz layout, so a
data directory or a backup written by either package loads in the
other. Loading writes only host planes; device stacks build on the next
read.

Layout under the holder path (mirrors the reference's
``indexes/<idx>/backends/rbf/shard.NNNN`` per-shard DB files,
reference: dbshard.go:123):

    indexes/<index>/fields/<field>/views/<view>/frag.<shard>.npz
    indexes/<index>/fields/<field>/bsi/frag.<shard>.npz

Dense planes compress well (zlib of zero runs), and load is a single
read per fragment — no B-tree walk on the query path.
"""

from __future__ import annotations

import glob
import os
import re
from typing import TYPE_CHECKING

import numpy as np

from pilosa_tpu_torch.core.fragment import _grow_rows
from pilosa_tpu_torch.ops import bsi as bsiops
from pilosa_tpu_torch.storage.recovery import scoped_plan
from pilosa_tpu_torch.storage.wal import fsync_dir

if TYPE_CHECKING:
    from pilosa_tpu_torch.core.holder import Holder

_FRAG_RE = re.compile(r"frag\.(\d+)\.npz$")


def _views_dir(idx_path: str, field: str) -> str:
    return os.path.join(idx_path, "fields", field, "views")


def _bsi_dir(idx_path: str, field: str) -> str:
    return os.path.join(idx_path, "fields", field, "bsi")


def save_holder_data(holder: "Holder") -> None:
    """Persist every fragment (plus schema). Atomic per-file via tmp+rename
    (the coarse analog of the reference's RBF checkpoint, rbf/db.go:149)."""
    if not holder.path:
        raise ValueError("holder has no data dir")
    holder.save_schema()
    for idx in holder.indexes.values():
        idx_path = holder._index_path(idx.name)
        for field in idx.fields.values():
            for view, frags in field.views.items():
                for shard, frag in frags.items():
                    n = len(frag.row_ids)
                    _atomic_savez(
                        os.path.join(_views_dir(idx_path, field.name), view,
                                     f"frag.{shard}.npz"),
                        planes=frag.planes[:n],
                        row_ids=np.asarray(frag.row_ids, dtype=np.uint64),
                    )
            for shard, bfrag in field.bsi.items():
                _atomic_savez(
                    os.path.join(_bsi_dir(idx_path, field.name),
                                 f"frag.{shard}.npz"),
                    planes=bfrag.planes,
                )
        idx.dataframe.save()


def load_holder_data(holder: "Holder") -> None:
    """Discover and load fragment files for all schema-known fields
    (reference: dbshard.go:241 LoadExistingDBs + view.openWithShardSet)."""
    if not holder.path:
        return
    for idx in holder.indexes.values():
        idx_path = holder._index_path(idx.name)
        for field in idx.fields.values():
            vdir = _views_dir(idx_path, field.name)
            if os.path.isdir(vdir):
                for view in sorted(os.listdir(vdir)):
                    for path in glob.glob(os.path.join(vdir, view, "frag.*.npz")):
                        m = _FRAG_RE.search(path)
                        if not m:
                            continue
                        shard = int(m.group(1))
                        with np.load(path) as z:
                            planes, row_ids = z["planes"], z["row_ids"]
                        frag = field.fragment(shard, view, create=True)
                        for slot, row in enumerate(row_ids.tolist()):
                            frag.import_row_plane(int(row), planes[slot], clear=True)
            for path in glob.glob(os.path.join(_bsi_dir(idx_path, field.name),
                                               "frag.*.npz")):
                m = _FRAG_RE.search(path)
                if not m:
                    continue
                shard = int(m.group(1))
                with np.load(path) as z:
                    planes = z["planes"]
                bfrag = field.bsi_fragment(shard, create=True)
                bfrag.depth = planes.shape[0] - bsiops.OFFSET
                bfrag.planes = planes.copy()
                bfrag.version += 1
        idx.dataframe.load()


def export_holder(holder: "Holder", root: str) -> None:
    """Write a complete, self-contained snapshot tree under ``root`` —
    schema + fragments + BSI + dataframe + translate journals — the
    payload of `backup` (reference: ctl/backup.go streaming schema,
    shard snapshots, translate partitions). Works for path-less holders
    too (translate stores are dumped from memory)."""
    import json as _json

    os.makedirs(root, exist_ok=True)
    schema = {
        "indexes": [
            {
                "name": idx.name,
                "options": idx.options.to_json(),
                "fields": [
                    {"name": f.name, "options": f.options.to_json()}
                    for f in idx.public_fields()
                ],
            }
            for idx in sorted(holder.indexes.values(), key=lambda i: i.name)
        ]
    }
    with open(os.path.join(root, "schema.json"), "w") as f:
        _json.dump(schema, f, indent=1)
    for idx in holder.indexes.values():
        idx_path = os.path.join(root, "indexes", idx.name)
        for field in idx.fields.values():
            for view, frags in field.views.items():
                for shard, frag in frags.items():
                    n = len(frag.row_ids)
                    _atomic_savez(
                        os.path.join(_views_dir(idx_path, field.name), view,
                                     f"frag.{shard}.npz"),
                        planes=frag.planes[:n],
                        row_ids=np.asarray(frag.row_ids, dtype=np.uint64),
                    )
            for shard, bfrag in field.bsi.items():
                _atomic_savez(
                    os.path.join(_bsi_dir(idx_path, field.name),
                                 f"frag.{shard}.npz"),
                    planes=bfrag.planes,
                )
            if field.translate is not None:
                _dump_translate(
                    field.translate.key_to_id,
                    os.path.join(idx_path, "fields", field.name, "keys.jsonl"))
        if idx.translate is not None:
            _dump_translate(idx.translate.key_to_id,
                            os.path.join(idx_path, "keys.jsonl"))
        df = idx.dataframe
        for shard, frame in df.frames.items():
            arrays = {}
            for name, col in frame.columns.items():
                arrays[f"c:{name}"] = col
                arrays[f"v:{name}"] = frame.valid[name]
            _atomic_savez(
                os.path.join(idx_path, "dataframe", f"shard.{shard}.npz"),
                **arrays)


def _dump_translate(key_to_id, path: str) -> None:
    import json as _json

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for key, id_ in sorted(key_to_id.items(), key=lambda kv: kv[1]):
            f.write(_json.dumps([key, id_]) + "\n")


def _atomic_savez(path: str, **arrays) -> None:
    """tmp + fsync + rename + dir-fsync: the snapshot survives power
    loss, not just process death (rename alone only orders metadata on
    some filesystems). Kill sites bracket the rename — the atomicity
    claim under test is exactly "crash on either side leaves a complete
    old or complete new file" (storage/recovery.py CrashPlan; the plan
    arrives thread-locally because array names own the kwargs)."""
    plan = scoped_plan()
    if plan is not None and plan.dead:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    if plan is not None and not plan.fire("savez.pre_replace"):
        return
    os.replace(tmp, path)
    if plan is not None and not plan.fire("savez.post_replace"):
        return
    fsync_dir(os.path.dirname(path))


def export_shard_arrays(idx, shard: int) -> dict:
    """One shard's planes as named arrays (the shard-snapshot payload;
    reference: api.go:1265 IndexShardSnapshot streams the RBF pages —
    here the dense planes). Keys: set|field|view + rows|field|view for
    bitmap fragments, bsi|field for BSI stacks."""
    out = {}
    for fname, field in idx.fields.items():
        for view, frags in field.views.items():
            frag = frags.get(shard)
            if frag is not None and frag.row_ids:
                n = len(frag.row_ids)
                out[f"set|{fname}|{view}"] = frag.planes[:n]
                out[f"rows|{fname}|{view}"] = np.asarray(
                    frag.row_ids, dtype=np.int64)
        bfrag = field.bsi.get(shard)
        if bfrag is not None:
            out[f"bsi|{fname}"] = bfrag.planes
    return out


def install_shard_arrays(idx, shard: int, arrays: dict) -> None:
    """Inverse of export_shard_arrays: plane-level install (restore /
    DAX snapshot resume)."""
    for key, arr in arrays.items():
        parts = key.split("|")
        if parts[0] == "set":
            _, fname, view = parts
            frag = idx.field(fname).fragment(shard, view, create=True)
            rows = arrays[f"rows|{fname}|{view}"]
            frag.row_ids = [int(r) for r in rows]
            frag.row_index = {int(r): i for i, r in enumerate(rows)}
            frag.planes = _grow_rows(
                np.ascontiguousarray(arr, dtype=np.uint32), len(rows))
            frag.version += 1
            frag.deltas.reset(frag.version)
        elif parts[0] == "bsi":
            _, fname = parts
            bfrag = idx.field(fname).bsi_fragment(shard, create=True)
            bfrag.planes = np.ascontiguousarray(arr, dtype=np.uint32)
            bfrag.depth = bfrag.planes.shape[0] - 2
            bfrag.version += 1
            bfrag.deltas.reset(bfrag.version)

"""Directives: the controller -> computer assignment protocol.

Port of ``pilosa_tpu/dax/directive.py``: the same fields and the same
JSON wire form, so a directive either package builds applies in the
other's computer.

Reference: dax/directive.go:8 (Directive with method full/diff/reset),
applied by computers at api_directive.go:21 ApplyDirective. A FULL
directive carries the whole schema plus THIS node's shard assignment; a
DIFF carries only the delta (shards added/removed, schema only when it
changed) on top of ``base_version`` — the directive version the
controller last saw this node ack. A computer whose current version is
not ``base_version`` missed a push and answers ``resync``; the
controller falls back to FULL. Versions are monotonic and a computer
rejects regressions (api_directive.go:26-41).

``hot`` names (table, field) pairs the queryer has recently served —
the warm-handoff prewarm set a newly directed owner builds device
planes for BEFORE advertising ready.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

METHOD_FULL = "full"
METHOD_DIFF = "diff"
METHOD_RESET = "reset"


@dataclasses.dataclass
class Directive:
    version: int
    method: str = METHOD_FULL
    # full schema snapshot: [{"index": name, "options": {...},
    #   "fields": [{"name": n, "options": {...}}, ...]}, ...]
    schema: List[dict] = dataclasses.field(default_factory=list)
    # THIS computer's assignment: [(table, shard), ...] (FULL/RESET)
    assigned: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    # DIFF only: the acked version this delta applies on top of, the
    # shards to load/drop, and whether ``schema`` is meaningful (an
    # unchanged schema is omitted from the wire entirely)
    base_version: int = -1
    add: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    remove: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    schema_changed: bool = True
    # recently queried (table, field) pairs — the prewarm set
    hot: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        out = {
            "version": self.version,
            "method": self.method,
            "schema": self.schema if self.schema_changed else [],
            "assigned": [[t, s] for t, s in self.assigned],
            "schemaChanged": bool(self.schema_changed),
            "hot": [[t, f] for t, f in self.hot],
        }
        if self.method == METHOD_DIFF:
            out["baseVersion"] = self.base_version
            out["add"] = [[t, s] for t, s in self.add]
            out["remove"] = [[t, s] for t, s in self.remove]
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Directive":
        return cls(version=int(d["version"]),
                   method=d.get("method", METHOD_FULL),
                   schema=list(d.get("schema", [])),
                   assigned=[(t, int(s)) for t, s in d.get("assigned", [])],
                   base_version=int(d.get("baseVersion", -1)),
                   add=[(t, int(s)) for t, s in d.get("add", [])],
                   remove=[(t, int(s)) for t, s in d.get("remove", [])],
                   schema_changed=bool(d.get("schemaChanged", True)),
                   hot=[(t, f) for t, f in d.get("hot", [])])

    def assigned_by_table(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for t, s in self.assigned:
            out.setdefault(t, []).append(s)
        return out

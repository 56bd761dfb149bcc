"""Record sources for the ingester.

Port of ``pilosa_tpu/ingest/source.py``: the same sources, header
type suffixes and column coercion, host code only.

Reference: idk/interfaces.go (Source yields Records; fields carry typed
schema), idk/csv/ (CSV source with header-driven typing). A header cell
may carry a type suffix like ``age__I`` (int), ``name__S`` (string),
``tags__SS`` (string set), ``ts__T`` (timestamp), ``ok__B`` (bool),
``price__F2`` (decimal scale 2) — the analog of idk's header type
annotations; untyped columns default to string.
"""

from __future__ import annotations

import csv
import io
import re
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from pilosa_tpu_torch.core.schema import FieldOptions, FieldType

Record = Dict[str, Any]

_TYPE_RE = re.compile(r"^(.*?)__([A-Z]+)(\d*)$")

_SUFFIX_TYPES = {
    "I": FieldType.INT,
    "S": FieldType.MUTEX,    # scalar string (keyed mutex)
    "SS": FieldType.SET,     # string set
    "IS": FieldType.SET,     # id set (unkeyed)
    "ID": FieldType.MUTEX,   # scalar id (unkeyed mutex)
    "B": FieldType.BOOL,
    "T": FieldType.TIMESTAMP,
    "F": FieldType.DECIMAL,
}


class Source:
    """Iterable of Records plus a field schema."""

    def schema(self) -> List[Tuple[str, FieldOptions]]:
        raise NotImplementedError

    def records(self) -> Iterator[Record]:
        raise NotImplementedError

    def id_column(self) -> Optional[str]:
        """Column holding the record id/key, or None for auto-id."""
        return None


class ListSource(Source):
    """In-memory records with an explicit schema (tests, programmatic)."""

    def __init__(self, schema: List[Tuple[str, FieldOptions]],
                 records: Iterable[Record], id_col: Optional[str] = "id"):
        self._schema = list(schema)
        self._records = list(records)
        self._id_col = id_col

    def schema(self):
        return self._schema

    def records(self):
        return iter(self._records)

    def id_column(self):
        return self._id_col


def _parse_header(cells: List[str]) -> List[Tuple[str, FieldOptions]]:
    out: List[Tuple[str, FieldOptions]] = []
    for cell in cells:
        m = _TYPE_RE.match(cell)
        if not m:
            out.append((cell, FieldOptions(type=FieldType.MUTEX, keys=True)))
            continue
        name, code, arg = m.groups()
        t = _SUFFIX_TYPES.get(code)
        if t is None:
            raise ValueError(f"unknown type suffix {code!r} in {cell!r}")
        keys = code in ("S", "SS")
        opts = FieldOptions(type=t, keys=keys)
        if t == FieldType.DECIMAL:
            opts.scale = int(arg or 2)
        out.append((name, opts))
    return out


def _coerce(raw: str, opts: FieldOptions):
    if raw == "":
        return None
    t = opts.type
    if t == FieldType.INT:
        return int(raw)
    if t == FieldType.DECIMAL:
        return float(raw)
    if t == FieldType.BOOL:
        return raw.strip().lower() in ("1", "true", "t", "yes")
    if t == FieldType.TIMESTAMP:
        return raw
    if t == FieldType.SET:
        parts = [p for p in raw.split(";") if p]
        return parts if opts.keys else [int(p) for p in parts]
    if t == FieldType.MUTEX and not opts.keys:
        return int(raw)
    return raw


def coerce_column(raw: Sequence[str], opts: FieldOptions):
    """Vectorized column coercion: raw string cells -> (values, valid).

    ``values`` is a numpy array (int64/float64/bool rows) or the raw
    string sequence for keyed fields; ``valid`` is None when every cell
    parsed, else a bool mask (empty cells = missing, like _coerce's None).
    Set cells holding ``;``-joined lists fall back to per-cell parsing in
    the caller (signalled by returning None).
    """
    t = opts.type
    if t in (FieldType.INT, FieldType.DECIMAL) or \
            (t in (FieldType.SET, FieldType.MUTEX) and not opts.keys):
        dtype = np.float64 if t == FieldType.DECIMAL else np.int64
        try:
            return np.asarray(raw, dtype=dtype), None
        except (TypeError, ValueError):
            arr = np.asarray(raw, dtype=object)
            valid = arr != ""
            try:
                vals = np.asarray(arr[valid].tolist(), dtype=dtype)
            except (TypeError, ValueError):
                return None, None  # ';'-lists / unparseable: slow path
            out = np.zeros(len(raw), dtype=dtype)
            out[valid] = vals
            return out, valid
    if t == FieldType.BOOL:
        # strip + lower to match _coerce's raw.strip().lower(); but
        # missing-vs-false must match too: only a truly EMPTY cell is
        # missing (a whitespace-only cell coerces to False, as in the
        # per-record path)
        arr = np.asarray(raw, dtype=str)
        valid = arr != ""
        norm = np.char.lower(np.char.strip(arr))
        vals = np.isin(norm, ("1", "true", "t", "yes")).astype(np.int64)
        return vals, (None if valid.all() else valid)
    # keyed set/mutex, timestamps: return raw strings; caller translates
    return None, None


class CSVSource(Source):
    """CSV with a typed header row (reference: idk/csv/csvsrc.go).

    The id column is the one named ``id`` (auto-detected) or the
    ``id_col`` argument; when absent, records get auto-ids downstream.
    """

    def __init__(self, path_or_text: str, id_col: Optional[str] = None,
                 inline: bool = False):
        self._f = io.StringIO(path_or_text) if inline \
            else open(path_or_text, newline="")
        reader = csv.reader(self._f)
        header = next(reader)
        self._reader = reader
        self._all_cols = _parse_header(header)
        names = [n for n, _ in self._all_cols]
        if id_col is None and "id" in names:
            id_col = "id"
        self._id_col = id_col

    def schema(self):
        return [(n, o) for n, o in self._all_cols if n != self._id_col]

    def id_column(self):
        return self._id_col

    def records(self):
        names = [n for n, _ in self._all_cols]
        opts = {n: o for n, o in self._all_cols}
        id_col = self._id_col
        try:
            for row in self._reader:
                rec: Record = {}
                for name, raw in zip(names, row):
                    if name == id_col:
                        # ids pass through uncoerced-ish: int when numeric
                        rec[name] = int(raw) if raw.isdigit() else raw
                    else:
                        rec[name] = _coerce(raw, opts[name])
                yield rec
        finally:
            self._f.close()

    def columns(self):
        """Columnar read: tokenize the whole remaining file at C speed,
        hand whole raw-string columns to the ingester (reference:
        batch/batch.go:459 columnar accumulate — the reference batches
        records into columns; here the source reads columns outright).
        Returns (n_rows, {name: (FieldOptions, raw_cells)}).

        Fast path for quote-free CSV: one str.split over the flattened
        text + strided list slices per column — several times faster than
        building a row list through csv.reader. Quoted files keep the
        csv.reader tokenizer.
        """
        ncols = len(self._all_cols)
        try:
            text = self._f.read()
            if text and '"' not in text and "\n\n" not in text:
                body = text.replace("\r", "").strip("\n")
                if not body:
                    return 0, {n: (o, ()) for n, o in self._all_cols}
                # Every line must have exactly ncols cells — ragged rows
                # whose extra/missing cells cancel out would otherwise
                # silently shift every later column (total-count checks
                # can't catch that). Verified exactly at C speed: the
                # cumulative comma count at the k-th newline must be
                # k * (ncols - 1).
                want = ncols - 1
                raw = np.frombuffer(body.encode(), dtype=np.uint8)
                commas_cum = np.cumsum(raw == ord(","))
                at_nl = commas_cum[raw == ord("\n")]
                n_lines = at_nl.size + 1
                total = int(commas_cum[-1]) if raw.size else 0
                rect = total == n_lines * want and bool(
                    (at_nl == np.arange(1, at_nl.size + 1) * want).all())
                if rect:
                    flat = body.replace("\n", ",").split(",")
                    return n_lines, {
                        name: (opts, flat[i::ncols])
                        for i, (name, opts) in enumerate(self._all_cols)}
            # quoted/ragged/blank-line files: the csv tokenizer
            table = list(csv.reader(io.StringIO(text)))
        finally:
            self._f.close()
        if not table:
            return 0, {n: (o, ()) for n, o in self._all_cols}
        # zip_longest, not zip: a single short row must not truncate
        # whole columns; missing cells read as "" (= absent), extra
        # cells beyond the header are dropped — matching records().
        from itertools import zip_longest

        cells = list(zip_longest(*table, fillvalue=""))[:ncols]
        out = {}
        for (name, opts), col in zip(self._all_cols, cells):
            out[name] = (opts, col)
        return len(table), out

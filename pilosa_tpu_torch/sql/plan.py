"""Plan operators: row-stream iterators over kernel-backed scans.

Reference: sql3/planner op*.go — each operator is an iterator with a
schema; PQL-bridging operators (oppqltablescan.go, oppqlgroupby.go,
oppqlaggregate.go, oppqldistinctscan.go) launch engine queries, host
operators (opfilter, opproject, oporderby, optop, opdistinct) transform
the stream. Here the PQL-bridging ops launch the executor's kernels;
host ops are plain Python over the (small) result stream.

Port of ``pilosa_tpu/sql/plan.py``: the same operators, expression
evaluator, casts and date functions, with the same values and the same
``SQLError`` texts.
"""

from __future__ import annotations

import datetime as dt_
import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError

Schema = List[Tuple[str, str]]  # (column name, SQL type)
Row = List[Any]


class PlanOp:
    schema: Schema = []

    def rows(self) -> Iterator[Row]:
        raise NotImplementedError

    def child_ops(self) -> List["PlanOp"]:
        return []

    def plan_json(self) -> dict:
        return {"op": type(self).__name__,
                "schema": [{"name": n, "type": t} for n, t in self.schema],
                "children": [c.plan_json() for c in self.child_ops()]}


class StaticOp(PlanOp):
    """Fixed row set (SHOW ..., DDL acks)."""

    def __init__(self, schema: Schema, data: Sequence[Row]):
        self.schema = schema
        self._data = list(data)

    def rows(self) -> Iterator[Row]:
        return iter(self._data)


class CallbackOp(PlanOp):
    """Rows produced by a thunk at iteration time (PQL-bridging ops use
    this to defer kernel launches until the plan actually runs)."""

    def __init__(self, schema: Schema, thunk: Callable[[], Iterator[Row]],
                 name: str = "CallbackOp"):
        self.schema = schema
        self._thunk = thunk
        self._name = name

    def rows(self) -> Iterator[Row]:
        return iter(self._thunk())

    def plan_json(self) -> dict:
        d = super().plan_json()
        d["op"] = self._name
        return d


# -- host-side expression evaluation ----------------------------------------

def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.IGNORECASE)


class QuantumSet:
    """A {timestamp, set} insert value for a time-quantum field
    (reference: sql3 tuple(stringset) literals, defs_timequantum.go)."""

    def __init__(self, ts: str, values: list):
        self.ts = ts
        self.values = values

    def __repr__(self):
        return f"QuantumSet({self.ts!r}, {self.values!r})"


def eval_expr(expr: ast.Expr, env: Dict[str, Any]) -> Any:
    """Evaluate an expression against a row environment (column -> value).

    Mirrors the reference's host-side expression ops (sql3/planner
    expression.go); used for projections and the non-lowerable WHERE
    fallback."""
    if isinstance(expr, ast.Literal):
        return expr.value
    if isinstance(expr, ast.ColumnRef):
        if expr.table is not None:
            key = f"{expr.table}.{expr.name}"
            if key not in env:
                raise SQLError(f"unknown column {key!r}")
            return env[key]
        if expr.name not in env:
            raise SQLError(f"unknown column {expr.name!r}")
        return env[expr.name]
    if isinstance(expr, ast.Unary):
        v = eval_expr(expr.operand, env)
        if expr.op == "NOT":
            return None if v is None else (not _truthy(v))
        if expr.op == "-":
            return None if v is None else -v
        raise SQLError(f"bad unary op {expr.op}")
    if isinstance(expr, ast.Binary):
        if expr.op == "AND":
            l = eval_expr(expr.left, env)
            if l is not None and not _truthy(l):
                return False
            r = eval_expr(expr.right, env)
            return _truthy(l) and _truthy(r) if None not in (l, r) else None
        if expr.op == "OR":
            l = eval_expr(expr.left, env)
            if l is not None and _truthy(l):
                return True
            r = eval_expr(expr.right, env)
            return _truthy(l) or _truthy(r) if None not in (l, r) else None
        l = eval_expr(expr.left, env)
        r = eval_expr(expr.right, env)
        if expr.op in ("=", "!=", "<", "<=", ">", ">="):
            if l is None or r is None:
                return None
            if isinstance(l, list) or isinstance(r, list):
                eq = set(l if isinstance(l, list) else [l]) == set(
                    r if isinstance(r, list) else [r])
                return eq if expr.op == "=" else (not eq)
            return {"=": l == r, "!=": l != r, "<": l < r, "<=": l <= r,
                    ">": l > r, ">=": l >= r}[expr.op]
        if l is None or r is None:
            return None
        if expr.op == "+":
            return l + r
        if expr.op == "-":
            return l - r
        if expr.op == "*":
            return l * r
        if expr.op == "/":
            return l // r if isinstance(l, int) and isinstance(r, int) else l / r
        if expr.op == "%":
            return l % r
        raise SQLError(f"bad binary op {expr.op}")
    if isinstance(expr, ast.InList):
        v = eval_expr(expr.operand, env)
        if v is None:
            return None
        hit = v in [eval_expr(it, env) for it in expr.items]
        return (not hit) if expr.negated else hit
    if isinstance(expr, ast.Between):
        v = eval_expr(expr.operand, env)
        if v is None:
            return None
        lo, hi = eval_expr(expr.low, env), eval_expr(expr.high, env)
        hit = lo <= v <= hi
        return (not hit) if expr.negated else hit
    if isinstance(expr, ast.IsNull):
        v = eval_expr(expr.operand, env)
        isnull = v is None or v == []
        return (not isnull) if expr.negated else isnull
    if isinstance(expr, ast.Like):
        v = eval_expr(expr.operand, env)
        if v is None:
            return None
        hit = bool(_like_to_regex(expr.pattern).match(str(v)))
        return (not hit) if expr.negated else hit
    if isinstance(expr, ast.FuncCall):
        return _eval_func(expr, env)
    if isinstance(expr, ast.TupleLiteral):
        vals = [eval_expr(i, env) for i in expr.items]
        if len(vals) == 2 and isinstance(vals[0], str) \
                and isinstance(vals[1], list):
            return QuantumSet(vals[0], vals[1])
        raise SQLError(
            "a tuple literal must be {timestamp, set} (quantum value); "
            f"got {len(vals)} element(s)")
    raise SQLError(f"cannot evaluate {type(expr).__name__} on the host")


def _truthy(v) -> bool:
    return bool(v)


def _eval_func(f: ast.FuncCall, env: Dict[str, Any]) -> Any:
    name = f.name
    if name in ("SETCONTAINS", "SETCONTAINSANY", "SETCONTAINSALL"):
        target = eval_expr(f.args[0], env)
        if target is None:
            return False
        target = set(target if isinstance(target, list) else [target])
        probe = eval_expr(f.args[1], env)
        probe = set(probe if isinstance(probe, list) else [probe])
        if name == "SETCONTAINSALL":
            return probe <= target
        return bool(probe & target)  # CONTAINS(single) == ANY(singleton)
    try:
        if name == "CAST":
            return _eval_cast(eval_expr(f.args[0], env), f.args[1].value)
        args = [eval_expr(a, env) for a in f.args]
        if name == "UPPER":
            return None if args[0] is None else str(args[0]).upper()
        if name == "LOWER":
            return None if args[0] is None else str(args[0]).lower()
        if name == "LEN":
            return None if args[0] is None else len(args[0])
        if name == "ABS":
            return None if args[0] is None else abs(args[0])
        if name in _STRING_FUNCS:
            return _STRING_FUNCS[name](args)
        if name in _DATE_FUNCS:
            return _DATE_FUNCS[name](args)
    except SQLError:
        raise
    except (TypeError, ValueError, OverflowError, IndexError) as e:
        # every bad-argument path (incl. wrong arity -> IndexError)
        # surfaces as a SQL error, never a bare Python exception (HTTP
        # would 500 on those)
        raise SQLError(f"{name.lower()}: {e}")
    if name == "RANGEQ":
        raise SQLError(
            "rangeq() is only supported as a WHERE predicate")
    raise SQLError(f"unknown function {name}")


# -- CAST (reference: sql3 coerceValue + defs_cast.go) -----------------------

def _eval_cast(v, typ: str):
    base = typ.split("(")[0]
    if v is None:
        return None
    if base in ("INT", "ID"):
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                raise SQLError(f"cannot cast {v!r} to {base}")
        return int(v)
    if base == "BOOL":
        if isinstance(v, str):
            if v.lower() in ("true", "1"):
                return True
            if v.lower() in ("false", "0"):
                return False
            raise SQLError(f"cannot cast {v!r} to BOOL")
        return bool(v)
    if base == "DECIMAL":
        # DECIMAL(scale) or DECIMAL(precision, scale): scale is last
        scale = int(typ[len("DECIMAL("):-1].split(",")[-1]) \
            if "(" in typ else 0
        try:
            return round(float(v), scale)
        except (TypeError, ValueError):
            raise SQLError(f"cannot cast {v!r} to DECIMAL")
    if base in ("STRING", "VARCHAR"):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, list):
            raise SQLError("cannot cast set to STRING")
        return str(v)
    if base in ("IDSET", "STRINGSET"):
        items = v if isinstance(v, list) else [v]
        return [str(x) if base == "STRINGSET" else int(x) for x in items]
    if base == "TIMESTAMP":
        # integer epoch seconds -> ISO (reference: cast(1000 as timestamp))
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            ts = dt_.datetime.fromtimestamp(v, tz=dt_.timezone.utc)
            return ts.isoformat().replace("+00:00", "Z")
        try:
            return _iso(_parse_ts(v))  # validate, normalize
        except ValueError:
            raise SQLError(f"cannot cast {v!r} to TIMESTAMP")
    raise SQLError(f"cannot cast to {typ}")


# -- string functions (reference: inbuiltfunctionsstring.go;
#    semantics pinned by defs_string_functions.go) ---------------------------

def _s_reverse(a):
    return None if a[0] is None else str(a[0])[::-1]


def _s_substring(a):
    if any(x is None for x in a):
        return None
    s, start = str(a[0]), int(a[1])
    if start < 0 or start >= len(s):
        raise SQLError(f"value {start} out of range")
    end = len(s)
    if len(a) > 2:
        end = start + int(a[2])
    if end < start or end > len(s):
        raise SQLError(f"value {end} out of range")
    return s[start:end]


def _s_replaceall(a):
    if any(x is None for x in a):
        return None
    return str(a[0]).replace(str(a[1]), str(a[2]))


def _s_charindex(a):
    if any(x is None for x in a):
        return None
    sub, s = str(a[0]), str(a[1])
    pos = int(a[2]) if len(a) > 2 else 0
    if pos < 0 or pos > len(s):
        return None
    return s.find(sub, pos)


def _s_trim(a, how="both"):
    if a[0] is None:
        return None
    s = str(a[0])
    return {"both": s.strip, "l": s.lstrip, "r": s.rstrip}[how]()


def _s_space(a):
    if a[0] is None:
        return None
    n = int(a[0])
    if n < 0:
        raise SQLError(f"value {n} out of range")
    return " " * n


def _s_str(a):
    """SQL-Server-style STR(num[, length[, decimals]]): right-justified
    in ``length`` (default 10), all '*' when it does not fit."""
    if a[0] is None:
        return None
    length = int(a[1]) if len(a) > 1 else 10
    decimals = int(a[2]) if len(a) > 2 else 0
    v = a[0]
    text = f"{v:.{decimals}f}" if decimals > 0 else str(int(round(float(v))))
    if len(text) > length:
        return "*" * length
    return text.rjust(length)


def _s_ascii(a):
    if a[0] is None:
        return None
    s = str(a[0])
    if len(s) != 1:
        raise SQLError("ascii() requires a single character")
    return ord(s)


def _s_char(a):
    if a[0] is None:
        return None
    return chr(int(a[0]))


def _s_format(a):
    """Go-verb format (%s/%d/%t/%f...; reference EvaluateFormat)."""
    if a[0] is None:
        return None
    fmt = str(a[0])
    out, ai = [], 1
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            verb = fmt[i + 1]
            i += 2
            if verb == "%":
                out.append("%")
                continue
            if ai >= len(a):
                raise SQLError("format: missing argument")
            v = a[ai]
            ai += 1
            try:
                if verb == "t":
                    out.append("true" if v else "false")
                elif verb == "d":
                    out.append(str(int(v)))
                elif verb == "f":
                    out.append(str(float(v)))
                else:
                    out.append(str(v))
            except (TypeError, ValueError):
                raise SQLError(
                    f"format: %{verb} needs a numeric argument, got {v!r}")
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_STRING_FUNCS = {
    "REVERSE": _s_reverse,
    "SUBSTRING": _s_substring,
    "REPLACEALL": _s_replaceall,
    "CHARINDEX": _s_charindex,
    "TRIM": lambda a: _s_trim(a, "both"),
    "LTRIM": lambda a: _s_trim(a, "l"),
    "RTRIM": lambda a: _s_trim(a, "r"),
    "SPACE": _s_space,
    "STR": _s_str,
    "ASCII": _s_ascii,
    "CHAR": _s_char,
    "FORMAT": _s_format,
}


# -- date functions (reference: inbuiltfunctionsdate.go; interval names
#    YY/YD/M/D/W/WK/HH/MI/S/MS/US/NS) ---------------------------------------

def _parse_ts(v) -> "dt_.datetime":
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return dt_.datetime.fromtimestamp(v, tz=dt_.timezone.utc)
    t = dt_.datetime.fromisoformat(str(v).replace("Z", "+00:00"))
    return t if t.tzinfo else t.replace(tzinfo=dt_.timezone.utc)


def _iso(t: "dt_.datetime") -> str:
    return t.isoformat().replace("+00:00", "Z")


def _d_part(a):
    if any(x is None for x in a):
        return None
    part, t = str(a[0]).upper(), _parse_ts(a[1])
    if part == "YY":
        return t.year
    if part == "YD":
        return t.timetuple().tm_yday
    if part == "M":
        return t.month
    if part == "D":
        return t.day
    if part == "W":
        return (t.weekday() + 1) % 7  # Go: Sunday=0
    if part == "WK":
        return t.isocalendar()[1]
    if part == "HH":
        return t.hour
    if part == "MI":
        return t.minute
    if part == "S":
        return t.second
    if part == "MS":
        return t.microsecond // 1000
    if part == "US":
        return t.microsecond
    if part == "NS":
        return t.microsecond * 1000
    raise SQLError(f"invalid interval {part!r}")


def _d_add(a):
    if any(x is None for x in a):
        return None
    part, n, t = str(a[0]).upper(), int(a[1]), _parse_ts(a[2])
    if part in ("YY", "M"):
        # normalize day overflow like Go's time.AddDate (the reference's
        # engine): Jan 31 + 1 month = Mar 3, Feb 29 + 1 year = Mar 1
        years, months = (n, 0) if part == "YY" else (0, n)
        mo = t.month - 1 + months
        y = t.year + years + mo // 12
        first = t.replace(year=y, month=mo % 12 + 1, day=1)
        return _iso(first + dt_.timedelta(days=t.day - 1))
    delta = {"D": dt_.timedelta(days=n), "HH": dt_.timedelta(hours=n),
             "MI": dt_.timedelta(minutes=n), "S": dt_.timedelta(seconds=n),
             "MS": dt_.timedelta(milliseconds=n),
             "US": dt_.timedelta(microseconds=n),
             "NS": dt_.timedelta(microseconds=n // 1000)}.get(part)
    if delta is None:
        raise SQLError(f"invalid interval {part!r}")
    return _iso(t + delta)


def _d_diff(a):
    if any(x is None for x in a):
        return None
    part = str(a[0]).upper()
    t1, t2 = _parse_ts(a[1]), _parse_ts(a[2])
    if part == "YY":
        return t2.year - t1.year
    if part == "M":
        return (t2.year - t1.year) * 12 + (t2.month - t1.month)
    # exact integer arithmetic from the timedelta's integer fields —
    # float seconds lose precision past 2^53 for ns/us spans
    delta = t2 - t1
    total_us = (delta.days * 86400 + delta.seconds) * 1_000_000 \
        + delta.microseconds
    div_us = {"D": 86_400_000_000, "HH": 3_600_000_000,
              "MI": 60_000_000, "S": 1_000_000, "MS": 1_000, "US": 1}
    if part == "NS":
        return total_us * 1000
    if part not in div_us:
        raise SQLError(f"invalid interval {part!r}")
    d = div_us[part]
    return total_us // d if total_us >= 0 else -((-total_us) // d)


def _d_totimestamp(a):
    """int -> timestamp at a given unit (reference: toTimestamp(val,
    'ms'|'s'|...))."""
    if a[0] is None:
        return None
    unit = str(a[1]).lower() if len(a) > 1 else "s"
    per_s = {"s": 1, "ms": 10**3, "us": 10**6, "µs": 10**6, "ns": 10**9}
    if unit not in per_s:
        raise SQLError(f"invalid timestamp unit {unit!r}")
    # exact integer split: float multiplication loses sub-second digits
    # for large us/ns epochs (same reasoning as _d_diff)
    sec, frac = divmod(int(a[0]), per_s[unit])
    us = frac * 10**6 // per_s[unit]
    t = dt_.datetime.fromtimestamp(sec, tz=dt_.timezone.utc) \
        + dt_.timedelta(microseconds=us)
    return _iso(t)


def _d_name(a):
    out = _d_part(a)
    if out is None:
        return None
    part = str(a[0]).upper()
    t = _parse_ts(a[1])
    if part == "M":
        return t.strftime("%B")
    if part == "W":
        return t.strftime("%A")
    return str(out)


_DATE_FUNCS = {
    "DATETIMEPART": _d_part,
    "DATEPART": _d_part,
    "DATETIMEADD": _d_add,
    "DATETIMEDIFF": _d_diff,
    "DATETIMENAME": _d_name,
    "TOTIMESTAMP": _d_totimestamp,
}


# -- host operators ----------------------------------------------------------

class FilterOp(PlanOp):
    def __init__(self, child: PlanOp, predicate: ast.Expr):
        self.child, self.predicate = child, predicate
        self.schema = child.schema

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        names = [n for n, _ in self.child.schema]
        for row in self.child.rows():
            env = dict(zip(names, row))
            if _truthy(eval_expr(self.predicate, env) or False):
                yield row


class ProjectOp(PlanOp):
    def __init__(self, child: PlanOp, items: List[Tuple[str, str, ast.Expr]]):
        """items: (output name, output sql type, expr over child columns)."""
        self.child = child
        self._items = items
        self.schema = [(n, t) for n, t, _ in items]

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        names = [n for n, _ in self.child.schema]
        for row in self.child.rows():
            env = dict(zip(names, row))
            yield [eval_expr(e, env) for _, _, e in self._items]


class OrderByOp(PlanOp):
    def __init__(self, child: PlanOp, terms: List[Tuple[ast.Expr, bool]]):
        self.child, self._terms = child, terms
        self.schema = child.schema

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        names = [n for n, _ in self.child.schema]
        data = list(self.child.rows())
        # stable multi-key sort: apply terms right-to-left
        for expr, desc in reversed(self._terms):
            def key(row, expr=expr):
                v = eval_expr(expr, dict(zip(names, row)))
                if isinstance(v, list):
                    v = tuple(v)
                return (v is None, v)  # NULLs last
            data.sort(key=key, reverse=desc)
        return iter(data)


class LimitOp(PlanOp):
    def __init__(self, child: PlanOp, limit: Optional[int],
                 offset: Optional[int] = None):
        self.child, self._limit, self._offset = child, limit, offset or 0
        self.schema = child.schema

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        n = 0
        skipped = 0
        for row in self.child.rows():
            if skipped < self._offset:
                skipped += 1
                continue
            if self._limit is not None and n >= self._limit:
                return
            n += 1
            yield row


class DistinctOp(PlanOp):
    """Host dedupe (reference: sql3/planner/opdistinct.go, which uses an
    extendible hash table; result streams here are post-reduction and
    small, so a set suffices)."""

    def __init__(self, child: PlanOp):
        self.child = child
        self.schema = child.schema

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        seen = set()
        for row in self.child.rows():
            key = tuple(tuple(v) if isinstance(v, list) else v for v in row)
            if key not in seen:
                seen.add(key)
                yield row


class AliasOp(PlanOp):
    """Qualify a scan's schema names with a table alias ('a.col') so
    joined streams have unambiguous env keys."""

    def __init__(self, child: PlanOp, alias: str):
        self.child = child
        self.schema = [(f"{alias}.{n}", t) for n, t in child.schema]

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        return self.child.rows()


class JoinOp(PlanOp):
    """Hash equi-join of two row streams (reference:
    sql3/planner/opnestedloops.go — the reference nest-loops; a hash
    build over the equi keys is strictly better on the same host rows).

    ``equi`` pairs (left column, right column) drive the hash build;
    ``residual`` is the non-equi remainder of the ON condition, evaluated
    per candidate pair. LEFT joins emit unmatched left rows null-padded
    (standard semantics)."""

    def __init__(self, left: PlanOp, right: PlanOp,
                 equi: List[Tuple[str, str]],
                 residual: Optional[ast.Expr], kind: str = "INNER"):
        self.left, self.right = left, right
        self._equi = equi
        self._residual = residual
        self._kind = kind
        self.schema = left.schema + right.schema

    def child_ops(self):
        return [self.left, self.right]

    def rows(self) -> Iterator[Row]:
        lnames = [n for n, _ in self.left.schema]
        rnames = [n for n, _ in self.right.schema]
        lkeys = [lnames.index(lc) for lc, _ in self._equi]
        rkeys = [rnames.index(rc) for _, rc in self._equi]
        # build side: right (probe left in order, preserving left order)
        table: Dict[tuple, List[Row]] = {}
        for row in self.right.rows():
            key = tuple(_hashable(row[i]) for i in rkeys)
            if any(k is None for k in key):
                continue  # NULL never equi-matches
            table.setdefault(key, []).append(row)
        null_right = [None] * len(rnames)
        for lrow in self.left.rows():
            key = tuple(_hashable(lrow[i]) for i in lkeys)
            matched = False
            for rrow in table.get(key, ()) if not any(
                    k is None for k in key) else ():
                if self._residual is not None:
                    env = dict(zip(lnames, lrow))
                    env.update(zip(rnames, rrow))
                    if not _truthy(eval_expr(self._residual, env) or False):
                        continue
                matched = True
                yield lrow + rrow
            if not matched and self._kind == "LEFT":
                yield lrow + null_right


class GroupByOp(PlanOp):
    """Host-side grouping fallback for shapes the PQL GroupBy kernel
    doesn't cover (grouping by INT columns, MIN/MAX/AVG aggregates).
    Reference: sql3/planner/opgroupby.go."""

    def __init__(self, child: PlanOp, group_names: List[str],
                 aggs: List[Tuple[str, str, "AggSpec"]]):
        self.child = child
        self._groups = group_names
        self._aggs = aggs
        types = dict(child.schema)
        gschema = [(n, types[n]) for n in group_names]  # GROUP BY order
        self.schema = gschema + [(n, t) for n, t, _ in aggs]

    def child_ops(self):
        return [self.child]

    def rows(self) -> Iterator[Row]:
        names = [n for n, _ in self.child.schema]
        groups: Dict[tuple, List[AggState]] = {}
        order: List[tuple] = []
        for row in self.child.rows():
            env = dict(zip(names, row))
            key = tuple(_hashable(env[g]) for g in self._groups)
            if key not in groups:
                groups[key] = [spec.new_state() for _, _, spec in self._aggs]
                order.append(key)
            for st, (_, _, spec) in zip(groups[key], self._aggs):
                st.add(env)
        if not order and not self._groups:
            # ungrouped aggregate over empty input still yields one row
            # (COUNT=0, SUM/AVG/MIN/MAX NULL), per SQL semantics
            yield [spec.new_state().result() for _, _, spec in self._aggs]
            return
        for key in order:
            yield list(key) + [st.result() for st in groups[key]]


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


class AggState:
    def __init__(self, spec: "AggSpec"):
        self.spec = spec
        self.count = 0
        self.total = 0
        self.mn = None
        self.mx = None
        self.distinct = set()

    def add(self, env: Dict[str, Any]):
        f = self.spec
        if f.func == "COUNT" and f.expr is None:
            self.count += 1
            return
        v = eval_expr(f.expr, env)
        if v is None or v == []:
            return
        if f.distinct:
            self.distinct.add(_hashable(v))
            return
        self.count += 1
        if isinstance(v, (int, float)):
            self.total += v
            self.mn = v if self.mn is None else min(self.mn, v)
            self.mx = v if self.mx is None else max(self.mx, v)

    def result(self):
        f = self.spec
        if f.func == "COUNT":
            return len(self.distinct) if f.distinct else self.count
        if f.distinct:
            # numeric distinct aggregates reduce over the value set
            vals = [v for v in self.distinct if isinstance(v, (int, float))]
            if not vals:
                return None
            if f.func == "SUM":
                return sum(vals)
            if f.func == "AVG":
                return sum(vals) / len(vals)
            if f.func == "MIN":
                return min(vals)
            if f.func == "MAX":
                return max(vals)
        if f.func == "SUM":
            return self.total if self.count else None
        if f.func == "AVG":
            return (self.total / self.count) if self.count else None
        if f.func == "MIN":
            return self.mn
        if f.func == "MAX":
            return self.mx
        raise SQLError(f"aggregate {f.func} not supported in host group-by")


class AggSpec:
    def __init__(self, func: str, expr: Optional[ast.Expr], distinct=False):
        self.func, self.expr, self.distinct = func, expr, distinct

    def new_state(self) -> AggState:
        return AggState(self)

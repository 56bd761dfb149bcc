"""The port's PQL parser against the JAX package's, tree for tree.

The case list is every query string of tests/test_pql_parser.py plus the
queries the port's slice answers; both parsers must give the same call
tree (compared as plain nested tuples), the same ``repr`` and the same
``to_pql`` text, and reject the same malformed inputs with the same
message.
"""

import pytest

from pilosa_tpu.pql import parser as jparser
from pilosa_tpu_torch.pql import ast as tast
from pilosa_tpu_torch.pql import parser as tparser

QUERIES = [
    "Row(f=1)",
    "Set(1, f=1)Set(2, f=2)",
    "Count(Intersect(Row(a=1), Row(b=2)))",
    'Row(f="it\\"s")',
    "Row(f='single')",
    "Row(n > 5)",
    "Row(n <= -3)",
    "Row(3 < n < 7)",
    "Row(3 <= n <= 7)",
    "Row(n != null)",
    "TopN(myfield, n=5)",
    "Set(2, f=1, 2010-01-02T03:04)",
    "Row(f=1, from='2010-01-01T00:00', to='2011-01-01T00:00')",
    "ConstRow(columns=[1, 2, 'x'])",
    "Set(1, b=true)",
    "GroupBy(Rows(a), aggregate=Sum(field=v), limit=10)",
    "Row(price > 1.5)",
    "Set(1, n=-42)",
    "Row(f=1,)",
    "GroupBy(Rows(a), Rows(b), limit=2)",
    # the slice's own queries
    "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)",
    "GroupBy(Rows(brand), filter=Row(year=2))",
    'TopN(brand, Row(year=3), n=5)',
    'Count(Intersect(Row(year=1), Row(brand="MFGR#1003")))',
    "Count(Not(Row(year=0)))",
    "Count(All())",
    "Options(Count(Row(year=1)), shards=[1])",
]

BAD = ["Row(f=", "row(f=1)", "Row(f=1))", "Row(@)", "Row(f==)"]


def _plain(v):
    """A parse tree as nested tuples, independent of either package's
    classes."""
    if hasattr(v, "calls"):
        return ("query", tuple(_plain(c) for c in v.calls))
    if hasattr(v, "children"):
        return ("call", v.name,
                tuple((k, _plain(x)) for k, x in v.args.items()),
                tuple(_plain(c) for c in v.children))
    if hasattr(v, "op") and hasattr(v, "value"):
        return ("cond", v.op, _plain(v.value))
    if isinstance(v, list):
        return ("list", tuple(_plain(x) for x in v))
    return (type(v).__name__, v)


@pytest.mark.parametrize("src", QUERIES)
def test_same_tree(src):
    want, got = jparser.parse(src), tparser.parse(src)
    assert isinstance(got, tast.Query)
    assert _plain(got) == _plain(want)
    assert repr(got) == repr(want)
    assert got.to_pql() == want.to_pql()
    assert _plain(tparser.parse(got.to_pql())) == _plain(got)


@pytest.mark.parametrize("src", BAD)
def test_same_errors(src):
    with pytest.raises(jparser.ParseError) as want:
        jparser.parse(src)
    with pytest.raises(tparser.ParseError) as got:
        tparser.parse(src)
    assert str(got.value) == str(want.value)

"""Star Schema Benchmark: seeded datagen, the 13 queries, and an
independent numpy oracle.

Reference: O'Neil et al., "The Star Schema Benchmark" (the standard
join workload derived from TPC-H) — lineorder fact plus date /
customer / supplier / part dimensions, four query flights Q1–Q4. Sizes
here are scale-factor-ish, parameterized by the lineorder row count so
tier-1 smoke (tiny) and bench.py --configs 23 share one generator.

Dialect notes against the classic text:

* joins are written ``JOIN ... ON`` (this engine has no comma-join),
* Q2.2's ``p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228'`` is spelled
  as the equivalent 8-member IN list — string ranges have no bitmap
  form and would force the hash-join fallback this workload exists to
  measure against,
* d_datekey is a compact surrogate id (queries never compare its
  value, only join on it).

The oracle computes every answer from the raw numpy arrays — no PQL,
no planner — so engine results are checked bit-for-bit against an
independent evaluation. ``verify`` compares row MULTISETS exactly and
checks the engine's row order satisfies the query's ORDER BY keys
(Q3's ``revenue DESC`` admits ties, so exact order is not unique).

Port of ``pilosa_tpu/loadgen/ssb.py``: the same generator, DDL, queries,
oracle and check, so a seed gives the same tables and answers in either
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

REGIONS = {
    "AMERICA": ["UNITED STATES", "CANADA", "BRAZIL"],
    "ASIA": ["CHINA", "JAPAN", "INDIA"],
    "EUROPE": ["UNITED KINGDOM", "FRANCE", "GERMANY"],
    "AFRICA": ["ETHIOPIA", "KENYA", "MOROCCO"],
}
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
_MONTH_DAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
YEARS = list(range(1992, 1999))

#: preset scales: lineorder rows (dimension sizes derive from this)
SCALES = {"tiny": 600, "small": 6000, "medium": 30000}


@dataclasses.dataclass
class SSBData:
    """Generated tables as column dicts (dimension values are python
    lists, lineorder columns are numpy arrays)."""
    date: Dict[str, list]
    customer: Dict[str, list]
    supplier: Dict[str, list]
    part: Dict[str, list]
    lineorder: Dict[str, np.ndarray]


def _nation_city(rng, nations: List[str]) -> Tuple[str, str]:
    n = nations[rng.randint(len(nations))]
    return n, f"{n[:9]}{rng.randint(10)}"


def _gen_dates() -> Dict[str, list]:
    """One row per 7th day of each year 1992–1998: every week number
    and every month of every year is represented (Q1.2/Q1.3/Q3.4
    predicates all hit) at ~52 rows/year."""
    cols: Dict[str, list] = {c: [] for c in (
        "_id", "d_year", "d_yearmonthnum", "d_yearmonth",
        "d_weeknuminyear")}
    rid = 0
    for year in YEARS:
        for doy in range(1, 365, 7):
            rid += 1
            month, rem = 1, doy
            for md in _MONTH_DAYS:
                if rem <= md:
                    break
                rem -= md
                month += 1
            cols["_id"].append(rid)
            cols["d_year"].append(year)
            cols["d_yearmonthnum"].append(year * 100 + month)
            cols["d_yearmonth"].append(f"{_MONTHS[month - 1]}{year}")
            cols["d_weeknuminyear"].append((doy - 1) // 7 + 1)
    return cols


def generate(scale="tiny", seed: int = 7) -> SSBData:
    """Seeded dataset; ``scale`` is a preset name or a lineorder row
    count. Deterministic for a (scale, seed) pair."""
    n_lo = SCALES.get(scale, scale) if isinstance(scale, str) else int(scale)
    rng = np.random.RandomState(seed)
    date = _gen_dates()

    n_cust = max(20, n_lo // 20)
    customer: Dict[str, list] = {c: [] for c in (
        "_id", "c_city", "c_nation", "c_region")}
    for i in range(n_cust):
        region = list(REGIONS)[rng.randint(len(REGIONS))]
        nation, city = _nation_city(rng, REGIONS[region])
        customer["_id"].append(i + 1)
        customer["c_city"].append(city)
        customer["c_nation"].append(nation)
        customer["c_region"].append(region)

    n_supp = max(10, n_lo // 40)
    supplier: Dict[str, list] = {c: [] for c in (
        "_id", "s_city", "s_nation", "s_region")}
    for i in range(n_supp):
        region = list(REGIONS)[rng.randint(len(REGIONS))]
        nation, city = _nation_city(rng, REGIONS[region])
        supplier["_id"].append(i + 1)
        supplier["s_city"].append(city)
        supplier["s_nation"].append(nation)
        supplier["s_region"].append(region)

    n_part = max(40, n_lo // 15)
    part: Dict[str, list] = {c: [] for c in (
        "_id", "p_mfgr", "p_category", "p_brand1")}
    for i in range(n_part):
        mfgr = rng.randint(1, 6)           # MFGR#1..5
        cat = rng.randint(1, 6)            # MFGR#m1..m5
        brand = rng.randint(1, 41)         # category + 1..40
        part["_id"].append(i + 1)
        part["p_mfgr"].append(f"MFGR#{mfgr}")
        part["p_category"].append(f"MFGR#{mfgr}{cat}")
        part["p_brand1"].append(f"MFGR#{mfgr}{cat}{brand}")

    n_date = len(date["_id"])
    lineorder = {
        "_id": np.arange(1, n_lo + 1),
        "lo_orderdate": rng.randint(1, n_date + 1, n_lo),
        "lo_custkey": rng.randint(1, n_cust + 1, n_lo),
        "lo_suppkey": rng.randint(1, n_supp + 1, n_lo),
        "lo_partkey": rng.randint(1, n_part + 1, n_lo),
        "lo_quantity": rng.randint(1, 51, n_lo),
        "lo_extendedprice": rng.randint(100, 10000, n_lo),
        "lo_discount": rng.randint(0, 11, n_lo),
        "lo_revenue": rng.randint(1000, 100000, n_lo),
        "lo_supplycost": rng.randint(500, 60000, n_lo),
    }
    return SSBData(date, customer, supplier, part, lineorder)


# -- loading -----------------------------------------------------------------

_DDL = [
    "CREATE TABLE ssb_date (_id ID, d_year INT MIN 1990 MAX 2000, "
    "d_yearmonthnum INT MIN 199000 MAX 200100, d_yearmonth STRING, "
    "d_weeknuminyear INT MIN 0 MAX 54)",
    "CREATE TABLE customer (_id ID, c_city STRING, c_nation STRING, "
    "c_region STRING)",
    "CREATE TABLE supplier (_id ID, s_city STRING, s_nation STRING, "
    "s_region STRING)",
    "CREATE TABLE part (_id ID, p_mfgr STRING, p_category STRING, "
    "p_brand1 STRING)",
    "CREATE TABLE lineorder (_id ID, lo_orderdate ID, lo_custkey ID, "
    "lo_suppkey ID, lo_partkey ID, lo_quantity INT MIN 0 MAX 100, "
    "lo_extendedprice INT MIN 0 MAX 20000, lo_discount INT MIN 0 MAX 20, "
    "lo_revenue INT MIN 0 MAX 200000, lo_supplycost INT MIN 0 MAX 200000)",
]


def _sql_val(v) -> str:
    return f"'{v}'" if isinstance(v, str) else str(int(v))


def load(run_sql: Callable[[str], Any], data: SSBData,
         batch: int = 500) -> None:
    """Create the five tables and insert ``data`` through ``run_sql``
    (an engine.query or an HTTP /sql POST — transport-agnostic so the
    cluster bench reuses it)."""
    for ddl in _DDL:
        run_sql(ddl)
    tables = [("ssb_date", data.date), ("customer", data.customer),
              ("supplier", data.supplier), ("part", data.part),
              ("lineorder", data.lineorder)]
    for name, cols in tables:
        names = list(cols)
        n = len(cols[names[0]])
        for lo in range(0, n, batch):
            rows = []
            for i in range(lo, min(lo + batch, n)):
                rows.append("(" + ", ".join(
                    _sql_val(cols[c][i]) for c in names) + ")")
            run_sql(f"INSERT INTO {name} ({', '.join(names)}) VALUES " +
                    ", ".join(rows))


# -- the 13 queries ----------------------------------------------------------

_Q22_BRANDS = ", ".join(f"'MFGR#22{b}'" for b in range(21, 29))
_CITIES = "('UNITED KI1', 'UNITED KI5')"

QUERIES: Dict[str, str] = {
    "Q1.1": (
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 "
        "AND lo_quantity < 25"),
    "Q1.2": (
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "WHERE d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6 "
        "AND lo_quantity BETWEEN 26 AND 35"),
    "Q1.3": (
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "WHERE d_weeknuminyear = 6 AND d_year = 1994 "
        "AND lo_discount BETWEEN 5 AND 7 AND lo_quantity BETWEEN 26 AND 35"),
    "Q2.1": (
        "SELECT SUM(lo_revenue) AS revenue, d_year, p_brand1 "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN part ON lo_partkey = part._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA' "
        "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1"),
    "Q2.2": (
        "SELECT SUM(lo_revenue) AS revenue, d_year, p_brand1 "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN part ON lo_partkey = part._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        f"WHERE p_brand1 IN ({_Q22_BRANDS}) AND s_region = 'ASIA' "
        "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1"),
    "Q2.3": (
        "SELECT SUM(lo_revenue) AS revenue, d_year, p_brand1 "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN part ON lo_partkey = part._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "WHERE p_brand1 = 'MFGR#2239' AND s_region = 'EUROPE' "
        "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1"),
    "Q3.1": (
        "SELECT c_nation, s_nation, d_year, SUM(lo_revenue) AS revenue "
        "FROM lineorder JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "WHERE c_region = 'ASIA' AND s_region = 'ASIA' "
        "AND d_year BETWEEN 1992 AND 1997 "
        "GROUP BY c_nation, s_nation, d_year "
        "ORDER BY d_year ASC, revenue DESC"),
    "Q3.2": (
        "SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue "
        "FROM lineorder JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "WHERE c_nation = 'UNITED STATES' AND s_nation = 'UNITED STATES' "
        "AND d_year BETWEEN 1992 AND 1997 "
        "GROUP BY c_city, s_city, d_year ORDER BY d_year ASC, revenue DESC"),
    "Q3.3": (
        "SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue "
        "FROM lineorder JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN ssb_date ON lo_orderdate = ssb_date._id "
        f"WHERE c_city IN {_CITIES} AND s_city IN {_CITIES} "
        "AND d_year BETWEEN 1992 AND 1997 "
        "GROUP BY c_city, s_city, d_year ORDER BY d_year ASC, revenue DESC"),
    "Q3.4": (
        "SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue "
        "FROM lineorder JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN ssb_date ON lo_orderdate = ssb_date._id "
        f"WHERE c_city IN {_CITIES} AND s_city IN {_CITIES} "
        "AND d_yearmonth = 'Dec1997' "
        "GROUP BY c_city, s_city, d_year ORDER BY d_year ASC, revenue DESC"),
    "Q4.1": (
        "SELECT d_year, c_nation, "
        "SUM(lo_revenue - lo_supplycost) AS profit "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN part ON lo_partkey = part._id "
        "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' "
        "AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2') "
        "GROUP BY d_year, c_nation ORDER BY d_year, c_nation"),
    "Q4.2": (
        "SELECT d_year, s_nation, p_category, "
        "SUM(lo_revenue - lo_supplycost) AS profit "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN part ON lo_partkey = part._id "
        "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' "
        "AND (d_year = 1997 OR d_year = 1998) "
        "AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2') "
        "GROUP BY d_year, s_nation, p_category "
        "ORDER BY d_year, s_nation, p_category"),
    "Q4.3": (
        "SELECT d_year, s_city, p_brand1, "
        "SUM(lo_revenue - lo_supplycost) AS profit "
        "FROM lineorder JOIN ssb_date ON lo_orderdate = ssb_date._id "
        "JOIN customer ON lo_custkey = customer._id "
        "JOIN supplier ON lo_suppkey = supplier._id "
        "JOIN part ON lo_partkey = part._id "
        "WHERE c_region = 'AMERICA' AND s_nation = 'UNITED STATES' "
        "AND (d_year = 1997 OR d_year = 1998) "
        "AND p_category = 'MFGR#14' "
        "GROUP BY d_year, s_city, p_brand1 "
        "ORDER BY d_year, s_city, p_brand1"),
}

#: ORDER BY key positions (output column index, descending?) per query,
#: used by verify() to check the engine's ordering without demanding a
#: unique total order where the benchmark doesn't define one
ORDER_KEYS: Dict[str, List[Tuple[int, bool]]] = {
    "Q2.1": [(1, False), (2, False)],
    "Q2.2": [(1, False), (2, False)],
    "Q2.3": [(1, False), (2, False)],
    "Q3.1": [(2, False), (3, True)],
    "Q3.2": [(2, False), (3, True)],
    "Q3.3": [(2, False), (3, True)],
    "Q3.4": [(2, False), (3, True)],
    "Q4.1": [(0, False), (1, False)],
    "Q4.2": [(0, False), (1, False), (2, False)],
    "Q4.3": [(0, False), (1, False), (2, False)],
}


# -- the oracle --------------------------------------------------------------

def _dim_lookup(cols: Dict[str, list], name: str) -> Dict[int, Any]:
    return dict(zip(cols["_id"], cols[name]))


def _dim_col(data: SSBData, table: Dict[str, list], fk: str,
             name: str) -> np.ndarray:
    """Per-lineorder dimension attribute, via the FK arrays."""
    lut = _dim_lookup(table, name)
    return np.array([lut[k] for k in data.lineorder[fk].tolist()])


def _groupsum(keys: List[np.ndarray], val: np.ndarray,
              mask: np.ndarray) -> Dict[tuple, int]:
    out: Dict[tuple, int] = {}
    idx = np.nonzero(mask)[0]
    cols = [k[idx] for k in keys]
    v = val[idx]
    for i in range(len(idx)):
        key = tuple(c[i].item() if hasattr(c[i], "item") else c[i]
                    for c in cols)
        out[key] = out.get(key, 0) + int(v[i])
    return out


def oracle(data: SSBData, qid: str) -> List[list]:
    """Independent answer for ``qid`` from the raw arrays."""
    lo = data.lineorder
    d_year = _dim_col(data, data.date, "lo_orderdate", "d_year")
    if qid.startswith("Q1"):
        if qid == "Q1.1":
            dm = d_year == 1993
            lm = ((lo["lo_discount"] >= 1) & (lo["lo_discount"] <= 3)
                  & (lo["lo_quantity"] < 25))
        elif qid == "Q1.2":
            ymn = _dim_col(data, data.date, "lo_orderdate",
                           "d_yearmonthnum")
            dm = ymn == 199401
            lm = ((lo["lo_discount"] >= 4) & (lo["lo_discount"] <= 6)
                  & (lo["lo_quantity"] >= 26) & (lo["lo_quantity"] <= 35))
        else:
            wk = _dim_col(data, data.date, "lo_orderdate",
                          "d_weeknuminyear")
            dm = (wk == 6) & (d_year == 1994)
            lm = ((lo["lo_discount"] >= 5) & (lo["lo_discount"] <= 7)
                  & (lo["lo_quantity"] >= 26) & (lo["lo_quantity"] <= 35))
        mask = dm & lm
        if not mask.any():
            return [[None]]
        return [[int((lo["lo_extendedprice"][mask]
                      * lo["lo_discount"][mask]).sum())]]

    if qid.startswith("Q2"):
        brand = _dim_col(data, data.part, "lo_partkey", "p_brand1")
        sregion = _dim_col(data, data.supplier, "lo_suppkey", "s_region")
        if qid == "Q2.1":
            cat = _dim_col(data, data.part, "lo_partkey", "p_category")
            mask = (cat == "MFGR#12") & (sregion == "AMERICA")
        elif qid == "Q2.2":
            brands = {f"MFGR#22{b}" for b in range(21, 29)}
            mask = np.isin(brand, sorted(brands)) & (sregion == "ASIA")
        else:
            mask = (brand == "MFGR#2239") & (sregion == "EUROPE")
        g = _groupsum([d_year, brand], lo["lo_revenue"], mask)
        return [[v, y, b] for (y, b), v in
                sorted(g.items(), key=lambda kv: kv[0])]

    if qid.startswith("Q3"):
        c_nation = _dim_col(data, data.customer, "lo_custkey", "c_nation")
        s_nation = _dim_col(data, data.supplier, "lo_suppkey", "s_nation")
        c_city = _dim_col(data, data.customer, "lo_custkey", "c_city")
        s_city = _dim_col(data, data.supplier, "lo_suppkey", "s_city")
        yr_mask = (d_year >= 1992) & (d_year <= 1997)
        if qid == "Q3.1":
            cregion = _dim_col(data, data.customer, "lo_custkey",
                               "c_region")
            sregion = _dim_col(data, data.supplier, "lo_suppkey",
                               "s_region")
            mask = (cregion == "ASIA") & (sregion == "ASIA") & yr_mask
            keys = [c_nation, s_nation, d_year]
        elif qid == "Q3.2":
            mask = ((c_nation == "UNITED STATES")
                    & (s_nation == "UNITED STATES") & yr_mask)
            keys = [c_city, s_city, d_year]
        else:
            cities = ["UNITED KI1", "UNITED KI5"]
            cm = np.isin(c_city, cities) & np.isin(s_city, cities)
            if qid == "Q3.3":
                mask = cm & yr_mask
            else:
                ym = _dim_col(data, data.date, "lo_orderdate",
                              "d_yearmonth")
                mask = cm & (ym == "Dec1997")
            keys = [c_city, s_city, d_year]
        g = _groupsum(keys, lo["lo_revenue"], mask)
        rows = [[a, b, y, v] for (a, b, y), v in g.items()]
        rows.sort(key=lambda r: (r[2], -r[3], r[0], r[1]))
        return rows

    # Q4 flight: profit = revenue - supplycost
    profit = lo["lo_revenue"].astype(np.int64) - lo["lo_supplycost"]
    cregion = _dim_col(data, data.customer, "lo_custkey", "c_region")
    mfgr = _dim_col(data, data.part, "lo_partkey", "p_mfgr")
    if qid == "Q4.1":
        sregion = _dim_col(data, data.supplier, "lo_suppkey", "s_region")
        c_nation = _dim_col(data, data.customer, "lo_custkey", "c_nation")
        mask = ((cregion == "AMERICA") & (sregion == "AMERICA")
                & np.isin(mfgr, ["MFGR#1", "MFGR#2"]))
        g = _groupsum([d_year, c_nation], profit, mask)
    elif qid == "Q4.2":
        sregion = _dim_col(data, data.supplier, "lo_suppkey", "s_region")
        s_nation = _dim_col(data, data.supplier, "lo_suppkey", "s_nation")
        cat = _dim_col(data, data.part, "lo_partkey", "p_category")
        mask = ((cregion == "AMERICA") & (sregion == "AMERICA")
                & np.isin(d_year, [1997, 1998])
                & np.isin(mfgr, ["MFGR#1", "MFGR#2"]))
        g = _groupsum([d_year, s_nation, cat], profit, mask)
    else:
        s_nation = _dim_col(data, data.supplier, "lo_suppkey", "s_nation")
        s_city = _dim_col(data, data.supplier, "lo_suppkey", "s_city")
        brand = _dim_col(data, data.part, "lo_partkey", "p_brand1")
        cat = _dim_col(data, data.part, "lo_partkey", "p_category")
        mask = ((cregion == "AMERICA") & (s_nation == "UNITED STATES")
                & np.isin(d_year, [1997, 1998]) & (cat == "MFGR#14"))
        g = _groupsum([d_year, s_city, brand], profit, mask)
    return [list(k) + [v] for k, v in sorted(g.items(), key=lambda kv: kv[0])]


def verify(data: SSBData, qid: str, got: List[list],
           expected: Optional[List[list]] = None) -> Optional[str]:
    """None when ``got`` matches the oracle bit-for-bit (as a row
    multiset, plus the query's ORDER BY keys hold over the engine's
    ordering); else a diagnostic string."""
    want = expected if expected is not None else oracle(data, qid)
    a = sorted(tuple(r) for r in got)
    b = sorted(tuple(r) for r in want)
    if a != b:
        return (f"{qid}: rows differ: engine={len(got)} oracle={len(want)}; "
                f"first engine-only={next((r for r in a if r not in b), None)} "
                f"first oracle-only={next((r for r in b if r not in a), None)}")
    keys = ORDER_KEYS.get(qid, [])
    for r1, r2 in zip(got, got[1:]):
        for pos, desc in keys:
            if r1[pos] == r2[pos]:
                continue
            ok = r1[pos] > r2[pos] if desc else r1[pos] < r2[pos]
            if not ok:
                return (f"{qid}: ORDER BY key {pos} (desc={desc}) "
                        f"violated: {r1} before {r2}")
            break
    return None

"""Every scalar function on the port's device allowlist
(executor/fragment.DEVICE_OPS) evaluated on the port's device path
(torch on the CPU) against the JAX package's device branch (jax.numpy on
the CPU), through the same SQL on the same seeded table: arithmetic on
DECIMAL / INT / DOUBLE, comparisons (DATE and dictionary-string
included), AND/OR/XOR/NOT, IS NULL, BETWEEN, IN, CASE/IF/IFNULL/COALESCE,
LIKE and REGEXP through the prepared dictionary LUT, CAST between
numeric types, the math functions, and the date and time functions over
DATE and DATETIME (the calendar family through ops/calendar, K20's plain
version here). Both engines must run each op inside a device fragment
with no fallback. DECIMAL, integer, date and string results exactly
equal; DOUBLE results within rel 1e-12.

Shapes the device branch cannot evaluate stay on the CPU at plan time
and equal the port's host engine; CAST between DATE and DATETIME, where
the reference returns the value unconverted, is held to a `datetime`
oracle on both of the port's engines."""

import datetime

import numpy as np
import pytest

from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        fragment_ops, run_jax, run_port, run_port_frags,
                        twin_sessions)
from tidb_tpu_torch.executor.fragment import DEVICE_OPS

DDL = ("CREATE TABLE x (i BIGINT, j INT, f DOUBLE, d DECIMAL(12,2), "
       "g DECIMAL(10,4), e DATE, s VARCHAR(8), t DATETIME)")
N = 3000

#: op → SQL projections exercising it on every argument type it takes
OPS = {
    "plus": ["i + j", "d + g", "f + d", "d + i", "e + 0"],
    "minus": ["i - j", "d - g", "f - i", "g - 1"],
    "mul": ["i * j", "d * g", "f * d", "d * 3"],
    "div": ["i / j", "d / g", "f / d", "d / 4"],
    "intdiv": ["i DIV j", "d DIV g"],
    "mod": ["i % j", "f % 3"],
    "unary_minus": ["-i", "-d", "-f"],
    "eq": ["i = j", "d = 12.5", "s = 'bb'", "e = '2021-03-04'"],
    "ne": ["i <> j", "s <> 'aa'", "f <> 0"],
    "lt": ["i < j", "d < g", "s < 'bz'", "e < '2021-06-01'"],
    "le": ["f <= 0.5", "s <= 'cc'", "d <= 250"],
    "gt": ["j > 3", "e > '2021-02-01'", "s > 'b'"],
    "ge": ["g >= 0.5", "s >= 'bb'", "e >= '2021-09-09'"],
    "nulleq": ["i <=> j", "d <=> g"],
    "and": ["i > 0 AND j > 0", "s = 'aa' AND d > 100"],
    "or": ["i > 0 OR j < 0", "f > 1 OR s = 'dd'"],
    "xor": ["i > 0 XOR j > 0"],
    "not": ["NOT (i > 0)", "NOT (s = 'cc')"],
    "isnull": ["i IS NULL", "s IS NOT NULL", "f IS NULL"],
    "if": ["IF(i > 0, d, g)", "IF(f > 0, i, j)"],
    "ifnull": ["IFNULL(i, j)", "IFNULL(d, 0)", "IFNULL(f, 1.5)"],
    "coalesce": ["COALESCE(i, j, 7)", "COALESCE(d, g)"],
    "case": ["CASE WHEN i > 3 THEN d WHEN i > 0 THEN g ELSE 0 END",
             "CASE WHEN f > 0 THEN 1 END"],
    "in": ["i IN (1, 3, 5)", "s IN ('aa', 'cc')", "j IN (2, 4)"],
    "like": ["s LIKE 'b%'", "s LIKE '%c'", "s NOT LIKE 'a_'"],
    "abs": ["ABS(i)", "ABS(d)", "ABS(f)"],
    "ceil": ["CEIL(f)", "CEIL(d)"],
    "floor": ["FLOOR(f)", "FLOOR(g)"],
    "round": ["ROUND(f)", "ROUND(d)", "ROUND(g, 2)"],
    "sign": ["SIGN(i)", "SIGN(f)", "SIGN(d)"],
    "year": ["YEAR(e)", "YEAR(t)"],
    "month": ["MONTH(e)", "MONTH(t)"],
    "dayofmonth": ["DAYOFMONTH(e)", "DAY(e)", "DAY(t)"],
    "regexp_like": ["s REGEXP '^b'", "REGEXP_LIKE(s, 'c$')"],
    "sqrt": ["SQRT(f)", "SQRT(d)", "SQRT(i)"],
    "pow": ["POW(f, 2)", "POWER(d, 2)", "POW(ABS(g), 0.5)", "POW(j, i)"],
    "exp": ["EXP(f)", "EXP(j)", "EXP(g)"],
    "ln": ["LN(f)", "LN(d)"],
    "log": ["LOG(f)", "LOG(2, d)", "LOG(g, f)"],
    "log2": ["LOG2(i)", "LOG2(f)"],
    "log10": ["LOG10(d)", "LOG10(f)"],
    "sin": ["SIN(f)", "SIN(d)"],
    "cos": ["COS(f)", "COS(i)"],
    "tan": ["TAN(f)", "TAN(g)"],
    "cot": ["COT(f)", "COT(j)"],
    "asin": ["ASIN(f / 5)", "ASIN(g)"],
    "acos": ["ACOS(f / 5)", "ACOS(g)"],
    "atan": ["ATAN(f)", "ATAN(d)"],
    "atan2": ["ATAN2(f, i)", "ATAN(j, d)"],
    "degrees": ["DEGREES(f)", "DEGREES(i)"],
    "radians": ["RADIANS(d)", "RADIANS(f)"],
    "pi": ["PI()", "f * PI()"],
    "truncate": ["TRUNCATE(f, 1)", "TRUNCATE(d, 1)", "TRUNCATE(g, -1)",
                 "TRUNCATE(f, j)"],
    "greatest": ["GREATEST(i, j)", "GREATEST(d, g)", "GREATEST(f, i, 0)"],
    "least": ["LEAST(i, j, 3)", "LEAST(d, f)", "LEAST(g, d)"],
    "cast": ["CAST(i AS DOUBLE)", "CAST(f AS BIGINT)",
             "CAST(d AS DECIMAL(14,4))", "CAST(g AS INT)",
             "CAST(f AS DECIMAL(10,2))", "CAST(j AS DECIMAL(8,1))",
             "CAST(d AS DOUBLE)"],
    "date": ["DATE(t)", "DATE(e)"],
    "datediff": ["DATEDIFF(e, '2020-01-01')", "DATEDIFF(t, e)"],
    "date_add_day": ["DATE_ADD(e, INTERVAL 1 DAY)",
                     "DATE_SUB(t, INTERVAL j DAY)"],
    "date_add_week": ["DATE_ADD(e, INTERVAL i WEEK)",
                      "DATE_ADD(t, INTERVAL 2 WEEK)"],
    "date_add_month": ["DATE_ADD(e, INTERVAL j MONTH)",
                       "DATE_ADD(t, INTERVAL 1 MONTH)",
                       "DATE_SUB(e, INTERVAL 13 MONTH)"],
    "date_add_quarter": ["DATE_ADD(e, INTERVAL 1 QUARTER)",
                         "DATE_ADD(t, INTERVAL i QUARTER)"],
    "date_add_year": ["DATE_ADD(e, INTERVAL i YEAR)",
                      "DATE_SUB(t, INTERVAL 1 YEAR)"],
    "date_add_hour": ["DATE_ADD(t, INTERVAL j HOUR)",
                      "DATE_ADD(e, INTERVAL 5 HOUR)"],
    "date_add_minute": ["DATE_ADD(t, INTERVAL 90 MINUTE)"],
    "date_add_second": ["DATE_ADD(t, INTERVAL i SECOND)"],
    "date_add_microsecond": ["DATE_ADD(t, INTERVAL 7 MICROSECOND)"],
    "to_days": ["TO_DAYS(e)", "TO_DAYS(t)"],
    "from_days": ["FROM_DAYS(i + 738000)"],
    "dayofweek": ["DAYOFWEEK(e)", "DAYOFWEEK(t)"],
    "weekday": ["WEEKDAY(e)", "WEEKDAY(t)"],
    "dayofyear": ["DAYOFYEAR(e)", "DAYOFYEAR(t)"],
    "quarter": ["QUARTER(e)", "QUARTER(t)"],
    "week": ["WEEK(e)", "WEEK(t)"],
    "last_day": ["LAST_DAY(e)", "LAST_DAY(t)"],
    "hour": ["HOUR(t)", "HOUR(e)"],
    "minute": ["MINUTE(t)"],
    "second": ["SECOND(t)"],
    "microsecond": ["MICROSECOND(t)"],
    "timestamp": ["TIMESTAMP(e)", "TIMESTAMP(t)"],
    "unix_timestamp": ["UNIX_TIMESTAMP(t)", "UNIX_TIMESTAMP(e)"],
    "from_unixtime": ["FROM_UNIXTIME(i * 1000 + 1600000000)"],
    "time_to_sec": ["TIME_TO_SEC(t)"],
    "sec_to_time": ["SEC_TO_TIME(i * 100)"],
    "to_seconds": ["TO_SECONDS(t)", "TO_SECONDS(e)"],
    "time": ["TIME(t)"],
    "timediff": ["TIMEDIFF(t, TIMESTAMP(e))"],
}


#: ops whose OPS statement evaluates them outside the device fragment:
#: PI() is a constant the planner folds (planner/rules.fold_expr), and
#: `d * g` is a wide DECIMAL(22,6), whose row root the port keeps on the
#: CPU (fragment._row_root_ok; ROADMAP §3); mul runs on the device
#: in every arithmetic aggregate (tests/test_torch_session.py's Q1)
NOT_IN_FRAGMENT = {"pi", "mul"}


def _table():
    rng = np.random.default_rng(23)
    valid = {k: rng.random(N) > 0.08 for k in "ijfdges"}
    s = np.array(["aa", "ab", "bb", "bc", "cc", "dd", "zz"],
                 dtype=object)[rng.integers(0, 7, N)]
    cols = {
        "i": rng.integers(-9, 10, N),
        "j": rng.integers(-3, 8, N),
        "f": np.round(rng.normal(size=N) * 3, 3),
        "d": rng.integers(-50_000, 50_000, N),
        "g": rng.integers(-20_000, 20_000, N),
        "e": rng.integers(18500, 19000, N).astype(np.int32),
        "s": np.where(valid["s"], s, ""),
    }
    # 1900-01-01 .. 2100-01-01 in µs, both sides of the epoch
    valid["t"] = rng.random(N) > 0.08
    cols["t"] = rng.integers(-2_208_988_800_000_000, 4_102_444_800_000_000, N)
    return cols, valid


@pytest.fixture(scope="module")
def twins():
    return twin_sessions([DDL], {"x": _table()})


def test_every_allowlisted_op_is_tested():
    """DEVICE_OPS is exactly the ops held here and the dictionary string
    functions held in tests/test_torch_string.py."""
    from test_torch_string import OPS as STRING_OPS
    assert set(OPS) | set(STRING_OPS) == set(DEVICE_OPS)


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax_device_branch(twins, op):
    """Both engines evaluate `op` inside a device fragment that ran with
    no fallback (the port admits nothing the reference does not run on
    its device), and their rows agree."""
    js, ts = twins
    sql = f"SELECT i, {', '.join(OPS[op])} FROM x WHERE i IS NOT NULL " \
          f"OR j IS NOT NULL"
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags), \
        [(f.used_device, f.fallback_code) for f in jfrags]
    rows, frags = run_port_frags(ts, sql)
    if op not in NOT_IN_FRAGMENT:
        assert op in fragment_ops(jfrags)
        assert op in fragment_ops(frags), fragment_ops(frags)
    assert_same(rows, jrows, ordered=True, rel=1e-12)


def test_between_lowers_to_allowlisted_ops(twins):
    js, ts = twins
    sql = ("SELECT COUNT(*), SUM(d) FROM x WHERE d BETWEEN -100 AND 300 "
           "AND e BETWEEN '2021-01-01' AND '2021-06-30' "
           "AND s BETWEEN 'ab' AND 'cc'")
    jrows, _ = run_jax(js, sql)
    assert_same(run_port(ts, sql), jrows)


def test_unlisted_function_stays_on_cpu_at_plan_time(twins):
    """A scalar function outside DEVICE_OPS keeps its chain on the CPU
    engine: EXPLAIN shows no device fragment, and the result is the host
    engine's."""
    _js, ts = twins
    ts.vars["tidb_tpu_engine"] = "on"
    ts.vars["tidb_tpu_row_threshold"] = 1
    try:
        sql = "SELECT i, SUM(BIT_COUNT(i)) FROM x GROUP BY i"
        rows = ts.query("EXPLAIN " + sql).rows
        dev = ts.query(sql).rows
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    assert not any("TpuFragment" in str(r) for r in rows), rows
    assert_same(dev, ts.query(sql).rows, rel=0)


@pytest.mark.parametrize("where", [
    # a string-typed GREATEST / LEAST: the JAX device branch raises
    # ("string comparison missing host preparation")
    "GREATEST(e, '2021-01-01') > '2021-06-01'",
    "LEAST(s, 'bb') = 'aa'",
    # CAST to a string: a computed string, as the string functions
    "CAST(i AS CHAR) = '3'",
    # a string argument of a temporal or math op reaches the device as a
    # dictionary code: the JAX device branch computes on the code (every
    # TIMESTAMP(s) is non-NULL there, NULL on the host)
    "TIMESTAMP(s) IS NULL",
    "TO_SECONDS(s) > 0",
    # REGEXP is a prepared per-dictionary LUT: column against a constant
    "REGEXP_LIKE(s, s)",
])
def test_device_branch_shape_stays_on_cpu_at_plan_time(twins, where):
    """Shapes of admitted ops that the device branch cannot evaluate:
    no device fragment, and the rows are the host engine's."""
    _js, ts = twins
    sql = f"SELECT i, COUNT(*) FROM x WHERE {where} GROUP BY i"
    ts.vars["tidb_tpu_engine"] = "on"
    ts.vars["tidb_tpu_row_threshold"] = 1
    ts.vars["tidb_tpu_strict"] = 1
    try:
        plan = ts.query("EXPLAIN " + sql).rows
        dev = ts.query(sql).rows
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
        ts.vars.pop("tidb_tpu_strict", None)
    assert not any("TpuFragment" in str(r) for r in plan), plan
    assert_same(dev, ts.query(sql).rows, rel=0)


def test_cast_between_date_and_datetime_is_converted(twins):
    """CAST(DATE AS DATETIME) is midnight of that day and CAST(DATETIME
    AS DATE) its day, on both of the port's engines (a `datetime`
    oracle). The JAX package returns the physical value unconverted (the
    day count read as µs), on its host and its device."""
    js, ts = twins
    cols, valid = _table()
    sql = ("SELECT i, e, t, CAST(e AS DATETIME), CAST(t AS DATE), "
           "CAST(t AS TIMESTAMP) FROM x WHERE e IS NOT NULL "
           "AND t IS NOT NULL")
    epoch = datetime.datetime(1970, 1, 1)
    want = []
    for k in range(N):
        if not (valid["e"][k] and valid["t"][k] and
                (valid["i"][k] or valid["j"][k])):
            continue
        day = datetime.date(1970, 1, 1) + \
            datetime.timedelta(days=int(cols["e"][k]))
        ts_ = epoch + datetime.timedelta(microseconds=int(cols["t"][k]))
        want.append((day, ts_, datetime.datetime(day.year, day.month,
                                                 day.day), ts_.date(), ts_))
    full = sql + " AND (i IS NOT NULL OR j IS NOT NULL)"
    dev = run_port(ts, full)
    host = ts.query(full).rows
    for rows in (dev, host):
        assert sorted(r[1:] for r in rows) == sorted(want)
    n_before = sum(1 for w in want if w[3] < datetime.date(2000, 1, 1))
    count = ("SELECT COUNT(*) FROM x WHERE e IS NOT NULL AND "
             "t IS NOT NULL AND (i IS NOT NULL OR j IS NOT NULL) AND "
             "CAST(t AS DATE) < '2000-01-01'")
    assert run_port(ts, count) == [(n_before,)]
    assert ts.query(count).rows == [(n_before,)]
    # the reference: the day count comes back as µs since the epoch
    jrows, _ = run_jax(js, "SELECT e, CAST(e AS DATETIME) FROM x "
                           "WHERE e IS NOT NULL")
    for day, dt in jrows:
        assert dt == epoch + datetime.timedelta(
            microseconds=(day - datetime.date(1970, 1, 1)).days)


def test_casts_of_one_column_keep_their_target_types(twins):
    """Two CASTs of one column to different types are different
    expressions: the device program cache and GROUP BY matching key on
    an expression's repr, which names the cast's target type. (The JAX
    package's repr omits it: its second statement reuses the first
    one's program, and its GROUP BY merges the two casts.)"""
    _js, ts = twins
    for sql in ("SELECT i, CAST(f AS BIGINT) FROM x",
                "SELECT i, CAST(f AS DECIMAL(10,2)) FROM x",
                "SELECT i, CAST(d AS DECIMAL(14,4)) FROM x",
                "SELECT i, CAST(d AS DOUBLE) FROM x"):
        sql += " WHERE i IS NOT NULL OR j IS NOT NULL"
        assert_same(run_port(ts, sql), ts.query(sql).rows, ordered=True,
                    rel=0)
    rows = ts.query("SELECT CAST(f AS BIGINT) AS a, CAST(f AS DOUBLE) AS b "
                    "FROM x WHERE f IS NOT NULL GROUP BY CAST(f AS BIGINT), "
                    "CAST(f AS DOUBLE)").rows
    cols, valid = _table()
    fs = {float(v) for v, ok in zip(cols["f"], valid["f"]) if ok}
    assert sorted(b for _a, b in rows) == sorted(fs)


def test_timediff_of_a_date_equals_the_host_engine(twins):
    """TIMEDIFF with a DATE argument reads the date as midnight, on the
    port's device as on its host. The JAX package's device branch
    subtracts the day count from the µs unconverted."""
    js, ts = twins
    sql = ("SELECT i, TIMEDIFF(t, e) FROM x WHERE i IS NOT NULL "
           "OR j IS NOT NULL")
    host = ts.query(sql).rows
    assert_same(run_port(ts, sql), host, ordered=True, rel=0)
    jrows, _ = run_jax(js, sql)
    assert any(a != b for a, b in zip(jrows, host))


# -- the slice as a whole: chip_smoke's phase-17 statements -----------------

TPCH_DDL = [
    "CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
    "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
    "l_tax DECIMAL(15,2), l_returnflag CHAR(1), l_linestatus CHAR(1), "
    "l_shipdate DATE, l_orderkey BIGINT)",
    "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_orderdate DATE, "
    "o_orderpriority CHAR(1), o_custkey BIGINT)",
]
_TS = "DATE_ADD(TIMESTAMP(l_shipdate), INTERVAL l_orderkey % 86400 SECOND)"
STATEMENTS = {
    "e1": "SELECT YEAR(l_shipdate), QUARTER(l_shipdate), COUNT(*), "
          "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
          "GROUP BY YEAR(l_shipdate), QUARTER(l_shipdate) "
          "ORDER BY YEAR(l_shipdate), QUARTER(l_shipdate)",
    "e2": "SELECT DAYOFWEEK(l_shipdate), WEEK(l_shipdate), COUNT(*), "
          "SUM(l_quantity) FROM lineitem WHERE DATE_ADD(l_shipdate, "
          "INTERVAL 3 MONTH) < '1998-01-31' AND DAYOFYEAR(l_shipdate) "
          "BETWEEN 32 AND 300 AND WEEKDAY(l_shipdate) < 5 "
          "GROUP BY DAYOFWEEK(l_shipdate), WEEK(l_shipdate)",
    "e3": "SELECT o_orderpriority, COUNT(*), SUM(DATEDIFF(l_shipdate, "
          "o_orderdate)), MAX(LAST_DAY(o_orderdate)), MIN(DATE_ADD("
          "o_orderdate, INTERVAL 1 QUARTER)) FROM lineitem JOIN orders "
          "ON l_orderkey = o_orderkey WHERE l_shipdate > DATE_ADD("
          "o_orderdate, INTERVAL 1 MONTH) GROUP BY o_orderpriority "
          "ORDER BY o_orderpriority",
    "e4": f"SELECT HOUR({_TS}), COUNT(*), SUM(MINUTE({_TS})), "
          f"MAX(UNIX_TIMESTAMP({_TS})), MIN(DAYOFMONTH(DATE_ADD("
          f"TIMESTAMP(l_shipdate), INTERVAL 1 YEAR))) FROM lineitem "
          f"GROUP BY HOUR({_TS})",
    "e5": "SELECT l_returnflag, COUNT(*), SUM(SQRT(l_extendedprice)), "
          "SUM(LN(l_quantity)), SUM(POW(l_discount, 2)), "
          "MAX(GREATEST(l_tax, l_discount)), "
          "SUM(TRUNCATE(l_extendedprice * l_discount, 1)), "
          "SUM(CAST(l_quantity AS DOUBLE)) FROM lineitem "
          "GROUP BY l_returnflag ORDER BY l_returnflag",
    "e6": "SELECT COUNT(*), SUM(l_extendedprice) FROM lineitem "
          "WHERE SIN(RADIANS(l_discount * 100)) > 0.1 "
          "AND LOG10(l_extendedprice) > 5 AND EXP(l_tax) < 1.05 "
          "AND l_shipdate < LAST_DAY('1996-02-10')",
}


def _tpch():
    rng = np.random.default_rng(17)
    n, no = 6000, 1500
    lineitem = {
        "l_quantity": rng.integers(100, 5001, n),
        "l_extendedprice": rng.integers(90_000, 10_500_001, n),
        "l_discount": rng.integers(0, 11, n),
        "l_tax": rng.integers(0, 9, n),
        "l_returnflag": np.array(["A", "N", "R"], dtype=object)[
            rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"], dtype=object)[
            rng.integers(0, 2, n)],
        "l_shipdate": rng.integers(8036, 10590, n).astype(np.int32),
        # keys 61 apart: l_orderkey % 86400 spreads E4 over every hour
        "l_orderkey": 61 * rng.integers(0, no, n)}
    orders = {
        "o_orderkey": 61 * np.arange(no),
        "o_orderdate": rng.integers(8036, 10590, no).astype(np.int32),
        "o_orderpriority": np.array(["1", "2", "3", "4", "5"],
                                    dtype=object)[rng.integers(0, 5, no)],
        "o_custkey": rng.integers(0, 150, no)}
    return {"lineitem": (lineitem, None), "orders": (orders, None)}


@pytest.fixture(scope="module")
def tpch():
    return twin_sessions(TPCH_DDL, _tpch())


@pytest.mark.parametrize("max_slab", [None, 1000])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_jax(tpch, name, max_slab):
    """chip_smoke's E1-E6 on both engines' devices (one slab, and 1,000-row
    slabs merged): every fragment on the device with no fallback, the
    port's calendar ops through ops/calendar, rows equal."""
    js, ts = tpch
    sql = STATEMENTS[name]
    jrows, jfrags = run_jax(js, sql, max_slab=max_slab)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags)
    rows, _frags = run_port_frags(ts, sql, max_slab=max_slab)
    assert_same(rows, jrows, ordered="ORDER BY" in sql)

"""The whole port slice against the JAX package: TPC-H Q1, Q6, a TopN
scan, multi-slab merges, the group-capacity retry and the
tests/test_fragment.py query shapes the port's gate admits, on 50k
seeded lineitem rows loaded into tidb_tpu's Engine() (device engine on,
row threshold 1; JAX on the CPU) and tidb_tpu_torch's
Engine(device="cpu"). DECIMAL, integer and string results must be
exactly equal; DOUBLE results within rel 1e-5 (test_fragment's rule: the
engines sum in different orders). Every port fragment must report
used_device."""

import numpy as np
import pytest

from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        run_jax, run_port, twin_sessions)

Q1 = """SELECT l_returnflag, l_linestatus, SUM(l_quantity),
 SUM(l_extendedprice), SUM(l_extendedprice * (1 - l_discount)),
 SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
 AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(*)
 FROM lineitem WHERE l_shipdate <= '1998-09-02'
 GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""

Q6 = """SELECT COUNT(*), SUM(l_extendedprice * l_discount)
 FROM lineitem WHERE l_shipdate >= '1994-01-01'
 AND l_shipdate < '1995-01-01'
 AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""

TOPN = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
        "WHERE l_shipdate > '1998-11-01' "
        "ORDER BY l_extendedprice DESC, l_orderkey LIMIT 10")

LINEITEM = ("CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
            "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
            "l_tax DECIMAL(15,2), l_returnflag CHAR(1), "
            "l_linestatus CHAR(1), l_shipdate DATE, l_orderkey BIGINT)")
T_DDL = ("CREATE TABLE t (a BIGINT, b DOUBLE, c VARCHAR(10), "
         "d DECIMAL(10,2), e DATE)")


def _lineitem(n):
    rng = np.random.default_rng(42)
    ship = rng.integers(8036, 10590, n).astype(np.int32)
    order = np.argsort(ship, kind="stable")
    cols = {
        "l_quantity": rng.integers(100, 5001, n),
        "l_extendedprice": rng.integers(90_000, 10_500_001, n),
        "l_discount": rng.integers(0, 11, n),
        "l_tax": rng.integers(0, 9, n),
        "l_returnflag": np.array(["A", "N", "R"],
                                 dtype=object)[rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"],
                                 dtype=object)[rng.integers(0, 2, n)],
        "l_shipdate": ship,
        "l_orderkey": rng.integers(0, n // 4, n),
    }
    return {k: (v[order] if k != "l_orderkey" else v)
            for k, v in cols.items()}


def _t(n):
    """test_fragment.py's table t: a BIGINT, b DOUBLE, c VARCHAR,
    d DECIMAL(10,2), e DATE — with NULL rows."""
    rng = np.random.default_rng(7)
    valid = {k: rng.random(n) > 0.05 for k in "abcde"}
    cols = {
        "a": rng.integers(0, 9, n),
        "b": np.round(rng.normal(size=n), 6),
        "c": np.array(["ant", "bee", "cow", "dog"],
                      dtype=object)[rng.integers(0, 4, n)],
        "d": rng.integers(0, 50_000, n),
        "e": rng.integers(18628, 18993, n).astype(np.int32),
    }
    cols["c"] = np.where(valid["c"], cols["c"], "")
    return cols, valid


@pytest.fixture(scope="module")
def twins():
    return twin_sessions([LINEITEM, T_DDL],
                         {"lineitem": (_lineitem(50_000), None),
                          "t": _t(6000)})


@pytest.mark.parametrize("sql,ordered", [(Q1, True), (Q6, False),
                                         (TOPN, True)])
def test_tpch_main_path(twins, sql, ordered):
    js, ts = twins
    jrows, _ = run_jax(js, sql)
    assert_same(run_port(ts, sql), jrows, ordered=ordered)


@pytest.mark.parametrize("sql,ordered", [(Q1, True), (Q6, False),
                                         (TOPN, True)])
def test_tpch_multi_slab(twins, sql, ordered):
    js, ts = twins
    jrows, _ = run_jax(js, sql, max_slab=8192)
    assert_same(run_port(ts, sql, max_slab=8192), jrows, ordered=ordered)


def test_q1_equals_port_host_engine(twins):
    _js, ts = twins
    ts.vars["tidb_tpu_engine"] = "off"
    host = ts.query(Q1).rows
    assert run_port(ts, Q1) == host
    assert run_port(ts, Q1, max_slab=8192) == host


FRAGMENT_QUERIES = [
    "SELECT c, a, COUNT(*), SUM(d), AVG(b), MIN(b), MAX(a) FROM t "
    "WHERE a < 6 GROUP BY c, a",
    "SELECT COUNT(*), SUM(a), MIN(b), MAX(d), AVG(d) FROM t WHERE c = 'ant'",
    "SELECT a, COUNT(*), COUNT(b), SUM(b) FROM t GROUP BY a",
    "SELECT e, COUNT(*) FROM t GROUP BY e",
    "SELECT c, VAR_POP(b), STDDEV(b) FROM t GROUP BY c",
    "SELECT a, SUM(d * 2 + 1) FROM t WHERE b > 0 GROUP BY a",
]


@pytest.mark.parametrize("sql", FRAGMENT_QUERIES)
def test_fragment_agg_shapes(twins, sql):
    js, ts = twins
    jrows, _ = run_jax(js, sql)
    assert_same(run_port(ts, sql), jrows)


@pytest.mark.parametrize("sql", FRAGMENT_QUERIES[:2])
def test_fragment_multi_slab_merge(twins, sql):
    js, ts = twins
    jrows, _ = run_jax(js, sql, max_slab=1024)
    assert_same(run_port(ts, sql, max_slab=1024), jrows)


@pytest.mark.parametrize("sql,max_slab", [
    ("SELECT a, b, c FROM t ORDER BY b DESC LIMIT 9", None),
    ("SELECT c, a FROM t ORDER BY c, a LIMIT 5", None),
    ("SELECT a, d FROM t ORDER BY d DESC, a LIMIT 11", 1024),
    ("SELECT a, b FROM t WHERE a IS NOT NULL ORDER BY a, b DESC", None),
])
def test_fragment_order_shapes(twins, sql, max_slab):
    js, ts = twins
    jrows, _ = run_jax(js, sql, max_slab=max_slab)
    assert_same(run_port(ts, sql, max_slab=max_slab), jrows, ordered=True)


@pytest.mark.parametrize("sql", [
    "SELECT a, b, c FROM t WHERE b > 1.2 AND a >= 4",
    "SELECT c, d FROM t WHERE c >= 'bee' AND d < 100",
])
def test_fragment_filter_shapes(twins, sql):
    js, ts = twins
    jrows, _ = run_jax(js, sql)
    assert_same(run_port(ts, sql), jrows)


@pytest.mark.parametrize("sql,max_slab", [
    ("SELECT d, COUNT(*) FROM t GROUP BY d", None),
    ("SELECT b, COUNT(*) FROM t WHERE b IS NOT NULL GROUP BY b", 2048),
])
def test_group_cap_overflow_retry(twins, sql, max_slab):
    """A tiny starting capacity forces the ladder: per-slab and merged
    overflows resize and re-run, never conflating groups."""
    js, ts = twins
    extra = {"tidb_tpu_group_cap": 64}
    jrows, _ = run_jax(js, sql, max_slab=max_slab, extra=extra)
    assert_same(run_port(ts, sql, max_slab=max_slab, extra=extra), jrows)


def test_warm_repeat_builds_and_uploads_nothing(twins):
    """A repeated statement reuses the cached program and the resident
    slabs: no program build, no host→device bytes (the port's analogue
    of tests/test_perf_smoke.py's zero-retrace check)."""
    from tidb_tpu_torch.executor import fragment as F
    _js, ts = twins
    first = run_port(ts, Q1)
    builds = F.PROGRAM_TRACES
    assert run_port(ts, Q1) == first
    assert F.PROGRAM_TRACES == builds
    assert F.LAST_PHASES.h2d_bytes == 0
    assert F.LAST_PHASES.scan_bytes > 0

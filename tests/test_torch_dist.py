"""Distributed fragments on the port (tidb_tpu_torch/executor/
dist_fragment.py: the staged paths, and the monolithic program for
what they do not take) against the JAX package's, with
`tidb_tpu_dist_devices = 4` on both sides: the JAX package runs 4 of its
8 virtual XLA CPU devices, the port 4 ranks on `cpu`.

Both engines are filled from the same seed-made numpy columns
(tests/torch_diff.twin_sessions). For every statement of
tests/test_dist_sql.py's and tests/test_staged_exchange.py's shapes
(the Q1 chain, ungrouped and high-cardinality aggregates; the Q3 join
aggregate, joins filtered on both sides, a left join, a non-unique build,
a varchar join key; DISTINCT grouped and global, a window root, a
row-root join, a partitioned pruned scan) every port fragment is
distributed (`dist == 4`), ran on its device with no fallback, and the
rows equal the JAX package's by tests/test_fragment.py's rule.

Also pinned: EXPLAIN shows the Exchange and `shards:4`; a skewed
exchange resizes once, at the exact need of the one skewed rank, with
the reference's escalation counts; the per-rank failpoint ladder (one
`shard-step` fault heals, a persistent one degrades the mesh with one
warning, a rank dead everywhere is one typed ShardFailure); the shapes
no staged path takes (a TopN over a join, an exchange over a join) and
fragments under the staged flags off are distributed too, through the
monolithic program, with the JAX package's rows; and the two plan-time
refusals (a wide-decimal scan column, a ci-collated string join key)
keep a fragment single-device with the same rows."""

import numpy as np
import pytest

from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        run_jax, run_port_frags, twin_sessions)
from tidb_tpu_torch.errors import ShardFailure
from tidb_tpu_torch.util import failpoint

DIST = {"tidb_tpu_dist_devices": 4}

DDL = [
    "CREATE TABLE orders (o_id BIGINT, o_prio BIGINT, o_seg VARCHAR(12))",
    "CREATE TABLE li (l_oid BIGINT, l_price DECIMAL(12,2), "
    "l_disc DECIMAL(12,2), l_flag VARCHAR(4), l_ship DATE)",
    "CREATE TABLE dup_orders (d_id BIGINT, d_prio BIGINT, "
    "d_seg VARCHAR(12))",
    "CREATE TABLE segs (s_name VARCHAR(12), s_rank BIGINT)",
    "CREATE TABLE pt (id BIGINT, g BIGINT, v BIGINT) "
    "PARTITION BY RANGE (id) (PARTITION p0 VALUES LESS THAN (2000), "
    "PARTITION p1 VALUES LESS THAN (4000), "
    "PARTITION p2 VALUES LESS THAN (MAXVALUE))",
    "CREATE TABLE xsk (k BIGINT, v BIGINT)",
    "CREATE TABLE xd (id BIGINT, w BIGINT)",
    "CREATE TABLE wdec (k BIGINT, w DECIMAL(30,2))",
    "CREATE TABLE cia (k VARCHAR(8) COLLATE utf8mb4_general_ci, v BIGINT)",
    "CREATE TABLE cib (k VARCHAR(8) COLLATE utf8mb4_general_ci, w BIGINT)",
]


def _tables():
    rng = np.random.default_rng(23)
    n_orders, n_li = 400, 4000
    segs3 = np.array(["BUILDING", "AUTO", "STEEL"], dtype=object)
    orders = {"o_id": np.arange(n_orders),
              "o_prio": rng.integers(0, 5, n_orders),
              "o_seg": segs3[rng.integers(0, 3, n_orders)]}
    li = {"l_oid": rng.integers(0, n_orders + 50, n_li),
          "l_price": rng.integers(100, 90_000, n_li),
          "l_disc": rng.integers(0, 11, n_li),
          "l_flag": np.array(["A", "N", "R"], dtype=object)[
              rng.integers(0, 3, n_li)],
          "l_ship": rng.integers(9131, 10592, n_li).astype(np.int32)}
    li_valid = {"l_oid": rng.random(n_li) > 0.02}
    # each id 1-3 times → a NON-unique join build side
    reps = rng.integers(1, 4, n_orders)
    dup = {"d_id": np.repeat(np.arange(n_orders), reps),
           "d_prio": rng.integers(0, 5, int(reps.sum())),
           "d_seg": np.repeat(orders["o_seg"], reps)}
    segtab = {"s_name": np.array(["BUILDING", "AUTO", "STEEL"],
                                 dtype=object),
              "s_rank": np.arange(1, 4)}
    pt = {"id": rng.integers(0, 6000, 6000), "g": rng.integers(0, 7, 6000),
          "v": rng.integers(0, 100, 6000)}
    # rank 0's slice is all one key (its bucket needs ~1,000 rows), the
    # other ranks stay under a 512-row cap
    i = np.arange(4000)
    xsk = {"k": np.where(i < 1000, 7, i % 89), "v": i % 13}
    xd = {"id": np.arange(3000), "w": np.arange(3000) ** 2}
    wdec = {"k": rng.integers(0, 9, 2000),
            "w": rng.integers(0, 10 ** 6, 2000)}
    words = np.array(["ab", "AB", "cd", "Ef", "ef"], dtype=object)
    cia = {"k": words[rng.integers(0, 5, 1500)],
           "v": rng.integers(0, 100, 1500)}
    cib = {"k": np.array(["ab", "cd", "ef"], dtype=object),
           "w": np.arange(3)}
    return {"orders": (orders, None), "li": (li, li_valid),
            "dup_orders": (dup, None), "segs": (segtab, None),
            "pt": (pt, None), "xsk": (xsk, None), "xd": (xd, None),
            "wdec": (wdec, None), "cia": (cia, None), "cib": (cib, None)}


@pytest.fixture(scope="module")
def twins():
    return twin_sessions(DDL, _tables())


Q1 = ("SELECT l_flag, COUNT(*), SUM(l_price), AVG(l_disc), MIN(l_price), "
      "MAX(l_price) FROM li WHERE l_ship <= '1998-09-02' GROUP BY l_flag")
Q3 = ("SELECT o_prio, COUNT(*), SUM(l_price * (1 - l_disc)) FROM li "
      "JOIN orders ON l_oid = o_id GROUP BY o_prio")
TOPN_JOIN = ("SELECT l_oid, l_price, o_prio FROM li JOIN orders "
             "ON l_oid = o_id ORDER BY l_price DESC, l_oid LIMIT 9")
# the planner builds segs ⋈ orders first: the exchange above it has a
# join for its child, which no staged path takes (the monolithic program
# runs it)
JOIN3 = ("SELECT s_rank, COUNT(*) FROM li JOIN orders ON l_oid = o_id "
         "JOIN segs ON o_seg = s_name GROUP BY s_rank")
SKEW = ("SELECT xsk.k, COUNT(*), SUM(xd.w) FROM xsk JOIN xd "
        "ON xsk.k = xd.id GROUP BY xsk.k ORDER BY xsk.k")

SHAPES = {
    "q1_chain": Q1,
    "ungrouped": "SELECT COUNT(*), SUM(l_price), MIN(l_disc) FROM li",
    "high_cardinality": ("SELECT l_oid, COUNT(*), SUM(l_price) FROM li "
                         "GROUP BY l_oid"),
    "q3_join_agg": Q3,
    "join_filters_both_sides": (
        "SELECT o_seg, COUNT(*), SUM(l_price) FROM li "
        "JOIN orders ON l_oid = o_id "
        "WHERE o_prio < 3 AND l_ship < '1998-01-01' GROUP BY o_seg"),
    "left_join": ("SELECT o_prio, COUNT(*), COUNT(o_id) FROM li "
                  "LEFT JOIN orders ON l_oid = o_id GROUP BY o_prio"),
    "nonunique_build": ("SELECT d_prio, COUNT(*), SUM(l_price) FROM li "
                        "JOIN dup_orders ON l_oid = d_id GROUP BY d_prio"),
    "varchar_join_key": ("SELECT o_seg, s_rank, COUNT(*), SUM(o_prio) "
                         "FROM orders JOIN segs ON o_seg = s_name "
                         "GROUP BY o_seg, s_rank"),
    "distinct_grouped": ("SELECT l_flag, COUNT(DISTINCT l_oid), COUNT(*) "
                         "FROM li GROUP BY l_flag"),
    "distinct_global": "SELECT COUNT(DISTINCT l_oid) FROM li",
    "window_root": (
        "SELECT l_flag, l_price, "
        "SUM(l_price) OVER (PARTITION BY l_flag ORDER BY l_price), "
        "ROW_NUMBER() OVER (PARTITION BY l_flag ORDER BY l_price DESC) "
        "FROM li"),
    "row_root_join": ("SELECT l_oid, l_price, o_prio FROM li "
                      "JOIN orders ON l_oid = o_id WHERE l_price > 85000"),
    "partitioned_pruned_scan": ("SELECT g, COUNT(*), SUM(v) FROM pt "
                                "WHERE id < 4000 GROUP BY g ORDER BY g"),
}


def _dist_pair(twins, sql):
    """(JAX rows, port rows, port fragments) with 4 ranks on both sides;
    every fragment of both is distributed."""
    js, ts = twins
    want, jfrags = run_jax(js, sql, extra=DIST)
    got, frags = run_port_frags(ts, sql, extra=DIST)
    assert jfrags and all(f.plan.dist == 4 for f in jfrags), sql
    assert all(f.plan.dist == 4 for f in frags), sql
    return want, got, frags


@pytest.mark.parametrize("name", list(SHAPES))
def test_dist_shape_matches_jax(twins, name):
    sql = SHAPES[name]
    want, got, _ = _dist_pair(twins, sql)
    assert_same(want, got, ordered="ORDER BY" in sql.split("OVER")[-1])


def _explain(s, sql, extra=DIST):
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   **extra})
    try:
        return "\n".join(str(r) for r in s.query("EXPLAIN " + sql).rows)
    finally:
        s.vars["tidb_tpu_engine"] = "off"
        for k in extra:
            s.vars.pop(k, None)


@pytest.mark.parametrize("sql,kind", [(Q3, "Exchange["),
                                      (SHAPES["distinct_grouped"],
                                       "Exchange[hash]")])
def test_exchange_in_explain(twins, sql, kind):
    txt = _explain(twins[1], sql)
    assert kind in txt and "shards:4" in txt, txt
    # the chain aggregate needs no exchange
    txt = _explain(twins[1], Q1)
    assert "shards:4" in txt and "Exchange" not in txt, txt


def _query(s, sql, extra):
    """Rows through Session.query with the device engine on and `extra`
    set, then restored: the statement's guard (escalation, warnings)
    stays on s.last_guard."""
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   **DIST, **extra})
    try:
        return s.query(sql).rows
    finally:
        s.vars["tidb_tpu_engine"] = "off"
        for k in list(DIST) + list(extra):
            s.vars.pop(k, None)


def _esc(s):
    e = s.last_guard.escalation
    return {"by_kind": dict(e.by_kind), "recompiles": e.recompiles,
            "exact_resizes": e.exact_resizes, "slabs_rerun": e.slabs_rerun,
            "slabs_reused": e.slabs_reused}


def test_skewed_exchange_resizes_once_like_the_reference(twins):
    """One skewed rank's bucket overflows a forced 512-row cap: only that
    rank re-runs, at its exact need, one ladder charge — the same
    escalation counts as the JAX package's staged exchange."""
    js, ts = twins
    cap = {"tidb_tpu_exchange_bucket_cap": 512}
    want = _query(js, SKEW, cap)
    jesc = _esc(js)
    got = _query(ts, SKEW, cap)
    tesc = _esc(ts)
    assert got == want
    assert tesc == jesc, (tesc, jesc)
    assert tesc["by_kind"].get("exchange:exact") == 1
    assert tesc["recompiles"] == 1
    assert tesc["slabs_rerun"] == 1 and tesc["slabs_reused"] == 3


@pytest.fixture
def clean_failpoints():
    yield
    failpoint.disable_all()
    failpoint.reset_counters()


@pytest.mark.parametrize("sql", [Q1, Q3], ids=["agg", "exchange"])
def test_one_shard_fault_heals(twins, sql, clean_failpoints):
    js, ts = twins
    want = _query(js, sql, {})
    with failpoint.enabled("shard-step",
                           raise_=ShardFailure("chaos: rank down"),
                           times=1):
        got = _query(ts, sql, {})
    assert_same(want, got)
    e = ts.last_guard.escalation
    assert e.shard_retries == 1
    assert e.shards_rerun == 1 and e.shards_reused == 3
    assert e.degraded_mesh == 0


@pytest.mark.parametrize("sql,sites", [
    (Q1, ("degraded-mesh-replan", "shard-redispatch")),
    (Q3, ("exchange-degraded-replan", "exchange-redispatch"))],
    ids=["agg", "exchange"])
def test_persistent_fault_degrades_with_one_warning(twins, sql, sites,
                                                    clean_failpoints):
    js, ts = twins
    want = _query(js, sql, {})
    failpoint.reset_counters()
    with failpoint.counting():
        with failpoint.enabled("shard-step",
                               raise_=ShardFailure("chaos: device bad"),
                               after_hits=2, times=2):
            got = _query(ts, sql, {})
        hits = failpoint.counters()
    assert_same(want, got)
    assert hits.get(sites[0], 0) == 1 and hits.get(sites[1], 0) == 1
    e = ts.last_guard.escalation
    assert e.degraded_mesh == 1
    assert e.shards_rerun == 1 and e.shards_reused == 3
    warns = ts.query("SHOW WARNINGS").rows
    assert len(warns) == 1, warns
    level, code, msg = warns[0]
    assert level == "Warning" and int(code) == ShardFailure.code
    assert "degraded mesh" in msg and "re-dispatched" in msg


@pytest.mark.parametrize("sql,redispatch", [
    (Q1, "shard-redispatch"), (Q3, "exchange-redispatch")],
    ids=["agg", "exchange"])
def test_fully_dead_rank_is_one_typed_error(twins, sql, redispatch,
                                            clean_failpoints):
    js, ts = twins
    with failpoint.enabled("shard-step",
                           raise_=ShardFailure("chaos: device down"),
                           after_hits=2):
        with failpoint.enabled(redispatch,
                               raise_=ShardFailure("chaos: spare down")):
            with pytest.raises(ShardFailure) as ei:
                _query(ts, sql, {})
    assert ei.value.code == 1105 and ei.value.retryable
    assert "re-dispatch" in str(ei.value)
    # the session stays usable
    assert_same(_query(js, sql, {}), _query(ts, sql, {}))


@pytest.mark.parametrize("sql,extra,exchange", [
    (TOPN_JOIN, {}, True),
    (JOIN3, {}, True),
    (Q1, {"tidb_tpu_dist_staged": "off"}, False),
    (Q3, {"tidb_tpu_dist_staged_exchange": "off"}, True),
    (SHAPES["distinct_global"], {"tidb_tpu_dist_staged": "off",
                                 "tidb_tpu_dist_staged_exchange": "off"},
     True)],
    ids=["topn_over_join", "exchange_over_join", "staged_agg_off",
         "staged_exchange_off",
         "both_off"])
def test_monolithic_shape_matches_jax(twins, sql, extra, exchange):
    """What no staged path runs (a TopN over a join, an exchange over a
    join, anything with the path's flag off) is distributed all the same:
    the monolithic program runs it on 4 ranks, EXPLAIN shows shards:4
    and the Exchange, and the rows are the JAX package's."""
    js, ts = twins
    txt = _explain(ts, sql, {**DIST, **extra})
    assert "TpuFragment" in txt and "shards:4" in txt, txt
    assert ("Exchange[" in txt) == exchange, txt
    want, _ = run_jax(js, sql, extra={**DIST, **extra})
    got, frags = run_port_frags(ts, sql, extra={**DIST, **extra})
    assert frags and all(f.plan.dist == 4 for f in frags)
    assert_same(want, got, ordered="ORDER BY" in sql)


@pytest.mark.parametrize("sql", [
    "SELECT k, COUNT(*), SUM(w) FROM wdec GROUP BY k",
    "SELECT cib.w, COUNT(*), SUM(cia.v) FROM cia JOIN cib "
    "ON cia.k = cib.k GROUP BY cib.w"],
    ids=["wide_decimal_scan_column", "ci_string_join_key"])
def test_plan_time_refusals_stay_single_device(twins, sql):
    """The two shapes the port keeps single-device at plan time: a scan
    reading a wide-decimal column (its (limbs, rows) values are not
    sliced over ranks) and a string join key no dictionary unification
    serves (ci-collated). No shards and no Exchange in EXPLAIN, and the
    rows of the JAX engine's single-device run."""
    js, ts = twins
    txt = _explain(ts, sql)
    assert "TpuFragment" in txt and "shards:" not in txt and \
        "Exchange" not in txt, txt
    want, _ = run_jax(js, sql)
    got, frags = run_port_frags(ts, sql, extra=DIST)
    assert frags and all(f.plan.dist == 0 for f in frags)
    assert_same(want, got)


def test_auto_on_the_cpu_is_one_rank(twins):
    """'auto' counts the devices of the engine's type: the CPU is one,
    so nothing distributes."""
    txt = _explain(twins[1], Q3, {"tidb_tpu_dist_devices": "auto"})
    assert "TpuFragment" in txt and "shards:" not in txt, txt

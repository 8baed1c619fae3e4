"""Join-tree device fragments of the port (tidb_tpu_torch/executor/
tree_fragment.py and the tree executors of executor/fragment.py) against the
JAX package's engine on the CPU.

Both engines are filled from the same seed-made numpy columns
(tests/torch_diff.twin_sessions) and run each statement with the device
engine on; every port fragment must report used_device with no fallback,
and one of them must hold the join. Rows compare by tests/test_fragment.py's
rule (multisets unless ORDER BY; floats within 1e-5 relative).

Shapes mirror tests/test_tree_fragment.py, tests/test_fused_pipeline.py and
tests/test_aligned_join.py at a few thousand rows: bench.py's Q3 and Q5,
every join kind with and without other conditions, a lost unique bet, an
expand resize, blocked passes, the aligned and fused paths on and off, a
multi-slab probe, joins on keys with no bounded domain (DOUBLE keys, 62-bit
surrogate keys, five key columns — the sort formulation), TPC-H Q3, and
TopN / Sort / LIMIT roots directly over a join."""

import numpy as np
import pytest

from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        run_jax, run_port_tree, twin_sessions)

Q3 = """SELECT o_orderpriority, COUNT(*),
 SUM(l_extendedprice * (1 - l_discount))
 FROM lineitem JOIN orders ON l_orderkey = o_orderkey
 WHERE l_shipdate <= '1998-09-02' AND o_orderdate < '1998-01-01'
 GROUP BY o_orderpriority ORDER BY o_orderpriority"""

Q5 = """SELECT c_mktsegment, COUNT(*),
 SUM(l_extendedprice * (1 - l_discount))
 FROM lineitem JOIN orders ON l_orderkey = o_orderkey
 JOIN customer ON o_custkey = c_custkey
 WHERE l_shipdate <= '1998-09-02'
 GROUP BY c_mktsegment ORDER BY c_mktsegment"""

#: TPC-H Q3 (spec §2.4.3) without o_shippriority, which these tables lack
TPCH_Q3 = """SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount))
 AS revenue, o_orderdate
 FROM customer JOIN orders ON c_custkey = o_custkey
 JOIN lineitem ON l_orderkey = o_orderkey
 WHERE c_mktsegment = 'BUILDING' AND o_orderdate < '1995-03-15'
 AND l_shipdate > '1995-03-15'
 GROUP BY l_orderkey, o_orderdate ORDER BY revenue DESC, o_orderdate
 LIMIT 10"""

#: bench.py's Q3 over the same rows keyed by sparse 62-bit surrogate keys
Q3_SK = """SELECT o_orderpriority, COUNT(*),
 SUM(l_extendedprice * (1 - l_discount))
 FROM lineitem_sk JOIN orders_sk ON l_okey = o_okey
 WHERE l_shipdate <= '1998-09-02' AND o_orderdate < '1998-01-01'
 GROUP BY o_orderpriority ORDER BY o_orderpriority"""

#: build = filtered orders, not unique on o_custkey: the unique bet is lost
EXPAND = ("SELECT c_mktsegment, COUNT(*) FROM customer JOIN orders "
          "ON c_custkey = o_custkey WHERE o_orderdate < '1992-03-01' "
          "GROUP BY c_mktsegment")

DDL = [
    "CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
    "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
    "l_tax DECIMAL(15,2), l_returnflag CHAR(1), l_linestatus CHAR(1), "
    "l_shipdate DATE, l_orderkey BIGINT)",
    "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_orderdate DATE, "
    "o_orderpriority CHAR(1), o_custkey BIGINT)",
    "CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, "
    "c_mktsegment CHAR(10))",
    "CREATE TABLE od (o_id BIGINT, o_date DATE, o_prio BIGINT, "
    "o_seg VARCHAR(12))",
    "CREATE TABLE li (l_oid BIGINT, l_price DECIMAL(12,2), "
    "l_disc DECIMAL(12,2), l_ship DATE)",
    "CREATE TABLE segs (s_name VARCHAR(12), s_rank BIGINT)",
    "CREATE TABLE prio_names (p_id BIGINT, p_name VARCHAR(8))",
    "CREATE TABLE fa (a_k BIGINT, a_v BIGINT)",
    "CREATE TABLE fb (b_k BIGINT, b_w BIGINT)",
    "CREATE TABLE dx (x_d DOUBLE, x_v BIGINT)",
    "CREATE TABLE dy (y_d DOUBLE, y_w BIGINT)",
    "CREATE TABLE k5a (a1 BIGINT, a2 BIGINT, a3 BIGINT, a4 BIGINT, "
    "a5 BIGINT, av BIGINT)",
    "CREATE TABLE k5b (b1 BIGINT, b2 BIGINT, b3 BIGINT, b4 BIGINT, "
    "b5 BIGINT, bw BIGINT)",
    "CREATE TABLE orders_sk (o_okey BIGINT, o_orderdate DATE, "
    "o_orderpriority CHAR(1))",
    "CREATE TABLE lineitem_sk (l_extendedprice DECIMAL(15,2), "
    "l_discount DECIMAL(15,2), l_shipdate DATE, l_okey BIGINT)",
    "CREATE TABLE od_sk (o_ok BIGINT, o_prio BIGINT)",
    "CREATE TABLE li_sk (l_ok BIGINT, l_price DECIMAL(12,2))",
]


def sparse_key(k):
    """The injective map k ↦ k·0x9E3779B97F4A7C15 mod 2^62 (an odd
    multiplier is a bijection mod 2^62): dense ids become 62-bit
    surrogate keys with no small domain."""
    k = np.asarray(k).astype(np.uint64)
    return ((k * np.uint64(0x9E3779B97F4A7C15)) &
            np.uint64((1 << 62) - 1)).astype(np.int64)


def _tables():
    rng = np.random.default_rng(20)
    n = 4000
    no, nc = n // 4, n // 40
    segs = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                     "HOUSEHOLD"], dtype=object)
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
        "l_orderkey": rng.integers(0, no, n)}
    orders = {
        "o_orderkey": np.arange(no),
        "o_orderdate": rng.integers(8036, 10590, no).astype(np.int32),
        "o_orderpriority": np.array(["1", "2", "3", "4", "5"],
                                    dtype=object)[rng.integers(0, 5, no)],
        "o_custkey": rng.integers(0, nc, no)}
    customer = {"c_custkey": np.arange(nc),
                "c_mktsegment": segs[rng.integers(0, 5, nc)]}
    # od: unique o_id; li: FK with misses beyond the key range and NULLs
    n_od, n_li = 500, 5000
    od = {"o_id": np.arange(n_od),
          "o_date": rng.integers(9131, 10400, n_od).astype(np.int32),
          "o_prio": rng.integers(0, 5, n_od),
          "o_seg": np.array(["BUILDING", "AUTO", "STEEL"], dtype=object)[
              rng.integers(0, 3, n_od)]}
    li = {"l_oid": rng.integers(0, n_od + 60, n_li),
          "l_price": rng.integers(100, 90_000, n_li),
          "l_disc": rng.integers(0, 11, n_li),
          "l_ship": rng.integers(9131, 10400, n_li).astype(np.int32)}
    li_valid = {"l_oid": rng.random(n_li) > 0.02}
    segtab = {"s_name": np.array(["BUILDING", "AUTO", "STEEL", "GHOST"],
                                 dtype=object),
              "s_rank": np.arange(1, 5)}
    prio = {"p_id": np.arange(5),
            "p_name": np.array([f"p{i}" for i in range(5)], dtype=object)}
    # fa ⋈ fb on a 50-value key with key 0 hot on both sides: ~60,000
    # output rows where the uniform estimate says 12,000 (many-to-many)
    fa = {"a_k": np.where(rng.random(2000) < 0.3, 0,
                          rng.integers(0, 50, 2000)),
          "a_v": rng.integers(0, 100, 2000)}
    fb = {"b_k": np.where(rng.random(300) < 0.3, 0,
                          rng.integers(0, 50, 300)),
          "b_w": rng.integers(0, 100, 300)}
    dx = {"x_d": rng.integers(0, 40, 1500).astype(np.float64),
          "x_v": rng.integers(0, 100, 1500)}
    dy = {"y_d": rng.integers(0, 40, 60).astype(np.float64),
          "y_w": np.arange(60)}
    # five bounded key columns (4 values each, a packed domain of 1,024)
    k5a = {f"a{i}": rng.integers(0, 4, 1200) for i in range(1, 6)}
    k5a["av"] = rng.integers(0, 100, 1200)
    k5b = {f"b{i}": rng.integers(0, 4, 80) for i in range(1, 6)}
    k5b["bw"] = np.arange(80)
    orders_sk = {"o_okey": sparse_key(orders["o_orderkey"]),
                 "o_orderdate": orders["o_orderdate"],
                 "o_orderpriority": orders["o_orderpriority"]}
    lineitem_sk = {c: lineitem[c] for c in ("l_extendedprice", "l_discount",
                                            "l_shipdate")}
    lineitem_sk["l_okey"] = sparse_key(lineitem["l_orderkey"])
    # 5,000 orders on sparse ids; lineitems with misses and NULL keys
    od_sk = {"o_ok": sparse_key(np.arange(5000)),
             "o_prio": rng.integers(0, 5, 5000)}
    li_sk = {"l_ok": sparse_key(rng.integers(0, 5300, 20000)),
             "l_price": rng.integers(100, 90_000, 20000)}
    li_sk_valid = {"l_ok": rng.random(20000) > 0.02}
    return {"lineitem": (lineitem, None), "orders": (orders, None),
            "customer": (customer, None), "od": (od, None),
            "li": (li, li_valid), "segs": (segtab, None),
            "prio_names": (prio, None), "fa": (fa, None), "fb": (fb, None),
            "dx": (dx, None), "dy": (dy, None), "k5a": (k5a, None),
            "k5b": (k5b, None), "orders_sk": (orders_sk, None),
            "lineitem_sk": (lineitem_sk, None), "od_sk": (od_sk, None),
            "li_sk": (li_sk, li_sk_valid)}


@pytest.fixture(scope="module")
def twins():
    return twin_sessions(DDL, _tables())


def _check(twins, sql, max_slab=None, extra=None):
    js, ts = twins
    want, _ = run_jax(js, sql, max_slab=max_slab, extra=extra)
    got, frags = run_port_tree(ts, sql, max_slab=max_slab, extra=extra)
    assert_same(want, got, ordered="ORDER BY" in sql)
    return frags


def _escalation(frags):
    return " ".join(" ".join(f.ctx.escalation.by_kind) for f in frags)


@pytest.mark.parametrize("sql", [Q3, Q5], ids=["q3", "q5"])
@pytest.mark.parametrize("extra", [
    {}, {"tidb_tpu_aligned_join": 0}, {"tidb_tpu_fused_pipeline": 0},
    {"tidb_tpu_aligned_join": 0, "tidb_tpu_fused_pipeline": 0}],
    ids=["default", "unaligned", "unfused", "unaligned-unfused"])
def test_bench_shapes_match_jax(twins, sql, extra):
    _check(twins, sql, extra=extra)


@pytest.mark.parametrize("sql", [Q3, Q5], ids=["q3", "q5"])
@pytest.mark.parametrize("aligned", [1, 0])
def test_multi_slab_probe_matches_jax(twins, sql, aligned):
    # 1,000-row slabs: lineitem (4,000 rows) runs as 4 probe slabs
    _check(twins, sql, max_slab=1000,
           extra={"tidb_tpu_aligned_join": aligned})


KINDS = {
    "inner": "SELECT o_prio, COUNT(*), SUM(l_price) FROM li JOIN od "
             "ON l_oid = o_id GROUP BY o_prio",
    "inner-cond": "SELECT o_prio, COUNT(*), SUM(l_price) FROM li JOIN od "
                  "ON l_oid = o_id AND l_price > o_prio * 10000 "
                  "GROUP BY o_prio",
    "left": "SELECT o_prio, COUNT(*), COUNT(o_id), SUM(l_price) FROM li "
            "LEFT JOIN od ON l_oid = o_id GROUP BY o_prio",
    "left-cond": "SELECT o_prio, COUNT(*), COUNT(o_id), SUM(l_price) "
                 "FROM li LEFT JOIN od ON l_oid = o_id "
                 "AND l_price > o_prio * 10000 GROUP BY o_prio",
    "right": "SELECT o_prio, COUNT(*), COUNT(o_id), SUM(l_price) FROM od "
             "RIGHT JOIN li ON l_oid = o_id GROUP BY o_prio",
    "right-cond": "SELECT o_prio, COUNT(*), COUNT(o_id) FROM od "
                  "RIGHT JOIN li ON l_oid = o_id "
                  "AND l_price > o_prio * 10000 GROUP BY o_prio",
    "semi": "SELECT COUNT(*), SUM(l_price) FROM li WHERE EXISTS "
            "(SELECT 1 FROM od WHERE o_id = l_oid AND o_prio = 1)",
    "semi-cond": "SELECT COUNT(*), SUM(l_price) FROM li WHERE EXISTS "
                 "(SELECT 1 FROM od WHERE o_id = l_oid "
                 "AND o_prio * 10000 < l_price)",
    "anti": "SELECT COUNT(*), SUM(l_price) FROM li WHERE NOT EXISTS "
            "(SELECT 1 FROM od WHERE o_id = l_oid AND o_prio = 1)",
    "anti-cond": "SELECT COUNT(*), SUM(l_price) FROM li WHERE NOT EXISTS "
                 "(SELECT 1 FROM od WHERE o_id = l_oid "
                 "AND o_prio * 10000 < l_price)",
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("aligned", [1, 0])
def test_join_kinds_match_jax(twins, kind, aligned):
    _check(twins, KINDS[kind], extra={"tidb_tpu_aligned_join": aligned})


@pytest.mark.parametrize("sql", [
    # non-unique build (o_prio ~100 rows per key): expansion on the device
    "SELECT COUNT(*), SUM(l_price) FROM li JOIN od ON l_oid = o_prio",
    # duplicate build keys + null-extended misses + NULL probe keys
    "SELECT COUNT(*), COUNT(o_id), SUM(o_date) FROM li "
    "LEFT JOIN od ON l_oid = o_prio",
    # string equi key: probe codes remap into the build dictionary
    "SELECT s_rank, COUNT(*) FROM od JOIN segs ON o_seg = s_name "
    "GROUP BY s_rank",
    # three tables, both builds unique
    "SELECT p_name, COUNT(*) FROM li JOIN od ON l_oid = o_id "
    "JOIN prio_names ON o_prio = p_id GROUP BY p_name",
    # a join root: rows come back compacted on the device
    "SELECT l_oid, l_price, o_prio FROM li JOIN od ON l_oid = o_id "
    "WHERE l_price > 89000",
    # computed keys: no bounds, the sort formulation
    "SELECT o_prio, COUNT(*), SUM(l_price) FROM li JOIN od "
    "ON l_oid + 1 = o_id + 1 GROUP BY o_prio",
], ids=["non-unique", "non-unique-left", "string-key", "three-tables",
        "join-root", "computed-key"])
def test_tree_shapes_match_jax(twins, sql):
    _check(twins, sql)


def test_lost_unique_bet_flips_to_expand(twins):
    frags = _check(twins, EXPAND, extra={"tidb_tpu_aligned_join": 0})
    esc = _escalation(frags)
    assert "join:flip" in esc, esc


def test_expand_resize_to_exact_total(twins):
    # ~60,000 output rows against an expand start sized for 12,000
    sql = "SELECT COUNT(*), SUM(a_v + b_w) FROM fa JOIN fb ON a_k = b_k"
    frags = _check(twins, sql)
    assert "join:exact" in _escalation(frags)


@pytest.mark.parametrize("fused", [1, 0])
def test_blocked_passes_match_jax(twins, fused):
    sql = ("SELECT a_k, COUNT(*), SUM(a_v + b_w) FROM fa JOIN fb "
           "ON a_k = b_k GROUP BY a_k")
    frags = _check(twins, sql, extra={"tidb_tpu_join_out_cap": 8192,
                                      "tidb_tpu_fused_pipeline": fused})
    assert "join:over-max" in _escalation(frags)


def test_repeat_reuses_program(twins):
    from tidb_tpu_torch.executor import fragment as F
    _check(twins, Q5)
    before = F.PROGRAM_TRACES
    _check(twins, Q5)
    assert F.PROGRAM_TRACES == before


def test_unbounded_key_falls_back_visibly(twins):
    """A DOUBLE key has no cached bounds. It used to decline as
    `fallback(shape)`; it now runs the sort formulation on the device
    (no fallback code, no error under strict) and equals the JAX engine."""
    _runs_sort_join(twins, "SELECT COUNT(*), SUM(x_v + y_w) FROM dx "
                           "JOIN dy ON x_d = y_d")


def test_too_many_key_columns_fall_back_visibly(twins):
    """Five bounded key columns: more than K4/K5 pack. The join used to
    decline at plan time; it now takes the sort formulation on the
    device and equals the JAX engine."""
    _runs_sort_join(twins, "SELECT COUNT(*), SUM(av + bw) FROM k5a "
                           "JOIN k5b ON a1 = b1 AND a2 = b2 AND "
                           "a3 = b3 AND a4 = b4 AND a5 = b5")


def _runs_sort_join(twins, sql, extra=None):
    """The join runs in the device fragment under tidb_tpu_strict (any
    fallback would raise) with the sort formulation's kernel entry points
    (K4/K5's wrappers never called) and equals the JAX engine."""
    from unittest import mock

    from tidb_tpu_torch.ops import join as J
    js, ts = twins
    strict = dict(extra or {}, tidb_tpu_strict=1)
    with mock.patch.object(J, "lut_build", side_effect=AssertionError(
            "LUT build on a sort-formulation join")), \
            mock.patch.object(J, "sorted_probe_unique",
                              wraps=J.sorted_probe_unique) as su, \
            mock.patch.object(J, "sorted_probe_multi",
                              wraps=J.sorted_probe_multi) as sm:
        got, frags = run_port_tree(ts, sql, extra=strict)
    assert su.call_count + sm.call_count > 0
    for f in frags:
        assert "fallback" not in f.runtime_info()
    want, _ = run_jax(js, sql, extra=extra)
    assert_same(want, got, ordered="ORDER BY" in sql)
    return got


@pytest.mark.parametrize("aligned", [1, 0])
def test_sparse_key_q3_matches_jax_and_dense_q3(twins, aligned):
    """bench.py's Q3 over 62-bit surrogate keys: the sort formulation on
    the device equals the JAX engine and the dense-key Q3's rows."""
    extra = {"tidb_tpu_aligned_join": aligned}
    got = _runs_sort_join(twins, Q3_SK, extra=extra)
    dense, _ = run_jax(twins[0], Q3, extra=extra)
    assert_same(dense, got, ordered=True)


@pytest.mark.parametrize("fused", [1, 0])
def test_sparse_key_join_kinds_match_jax(twins, fused):
    extra = {"tidb_tpu_fused_pipeline": fused}
    _runs_sort_join(twins, "SELECT o_prio, COUNT(*), SUM(l_price) FROM "
                           "li_sk JOIN od_sk ON l_ok = o_ok GROUP BY o_prio",
                    extra=extra)
    _runs_sort_join(twins, "SELECT o_prio, COUNT(*), COUNT(o_ok), "
                           "SUM(l_price) FROM li_sk LEFT JOIN od_sk "
                           "ON l_ok = o_ok GROUP BY o_prio", extra=extra)


@pytest.mark.parametrize("extra", [{}, {"tidb_tpu_fused_pipeline": 0},
                                   {"tidb_tpu_aligned_join": 0}],
                         ids=["default", "unfused", "unaligned"])
def test_tpch_q3_matches_jax(twins, extra):
    """TPC-H Q3: GROUP BY l_orderkey, o_orderdate has no perfect-hash
    domain, so every slab runs the sort factorize."""
    _check(twins, TPCH_Q3, extra=extra)


def _walk_exec(e):
    yield e
    for c in getattr(e, "children", []):
        yield from _walk_exec(c)


def _fragment_roots(plan):
    from tidb_tpu_torch.planner.physical import PhysTpuFragment
    if isinstance(plan, PhysTpuFragment):
        return [plan.root]
    return [r for c in plan.children for r in _fragment_roots(c)]


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


@pytest.mark.parametrize("sql,excluded", [
    ("SELECT l_oid, ROW_NUMBER() OVER (PARTITION BY o_prio ORDER BY l_oid) "
     "FROM li JOIN od ON l_oid = o_id", "PhysWindow"),
    ("SELECT o_prio, COUNT(DISTINCT l_oid) FROM li JOIN od ON l_oid = o_id "
     "GROUP BY o_prio", "distinct"),
], ids=["window", "distinct"])
def test_unported_shapes_stay_off_the_device(twins, sql, excluded):
    """Both shapes that once stayed off the device are ported now: the
    window over the join runs inside the device fragment (EXPLAIN's top
    operator is the TpuFragment), and so does the DISTINCT aggregate over
    the join (the HashAgg under the TpuFragment in EXPLAIN); each equals
    the JAX engine."""
    from tidb_tpu_torch.parser import parse
    js, ts = twins
    ts.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1})
    try:
        plan = ts._plan(parse(sql)[0])
        explain = ts.query("EXPLAIN " + sql).rows
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    nodes = [type(node).__name__ for root in _fragment_roots(plan)
             for node in _walk(root)]
    distinct_inside = any(d.distinct for root in _fragment_roots(plan)
                          for node in _walk(root)
                          for d in getattr(node, "aggs", []))
    top = explain[0][0].strip()
    want, _ = run_jax(js, sql)
    if excluded == "PhysWindow":
        assert "PhysWindow" in nodes and "PhysHashJoin" in nodes, nodes
        assert "TpuFragment" in top, explain
        got, _ = run_port_tree(ts, sql, extra={"tidb_tpu_strict": 1})
        # row numbers over tied keys may pick other rows, but (l_oid, rn)
        # pairs of tied rows are the same multiset
        assert_same(want, got)
    else:
        assert distinct_inside, nodes
        text = "\n".join(str(r[0]) for r in explain)
        assert "HashAgg" in text[text.index("TpuFragment"):], explain
        got, _ = run_port_tree(ts, sql, extra={"tidb_tpu_strict": 1})
        assert_same(want, got, ordered="ORDER BY" in sql)


JOIN_ROWS = ("SELECT l_oid, l_price, o_prio FROM li JOIN od "
             "ON l_oid = o_id")


@pytest.mark.parametrize("tail,root", [
    ("LIMIT 5", "PhysLimit"),
    ("LIMIT 3, 40", "PhysLimit"),
    ("LIMIT 100000", "PhysLimit"),
    ("ORDER BY l_price DESC, l_oid LIMIT 7", "PhysTopN"),
    ("ORDER BY o_prio, l_price DESC, l_oid LIMIT 2, 30", "PhysTopN"),
    ("ORDER BY l_price, l_oid", "PhysSort"),
], ids=["limit", "limit-offset", "limit-over-all", "topn-over-join",
        "topn-offset-3-keys", "sort-over-join"])
def test_order_and_limit_roots_run_on_the_device(twins, tail, root):
    """TopN / Sort and LIMIT directly over a join run inside the join-tree
    fragment (it is EXPLAIN's top operator) and answer as the JAX engine:
    ordered roots row for row; an unordered LIMIT by its count and by
    membership in the host engine's unlimited join (it may pick other
    rows, as the JAX package's own test allows)."""
    from collections import Counter

    from tidb_tpu_torch.parser import parse
    js, ts = twins
    sql = f"{JOIN_ROWS} {tail}"
    ts.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1})
    try:
        plan = ts._plan(parse(sql)[0])
        explain = ts.query("EXPLAIN " + sql).rows
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    assert [type(r).__name__ for r in _fragment_roots(plan)] == [root]
    assert "TpuFragment" in explain[0][0], explain
    want, _ = run_jax(js, sql)
    got, _ = run_port_tree(ts, sql, extra={"tidb_tpu_strict": 1})
    if root != "PhysLimit":
        assert_same(want, got, ordered=True)
        return
    assert len(got) == len(want)
    full = Counter(tuple(r) for r in ts.query(JOIN_ROWS).rows)
    assert not Counter(tuple(r) for r in got) - full


@pytest.mark.parametrize("sql", [
    "SELECT w, x FROM wa JOIN wb ON wa.k = wb.k WHERE x > 50",
    "SELECT w, x FROM wa JOIN wb ON wa.k = wb.k ORDER BY x, wa.k LIMIT 5",
    "SELECT w, x FROM wa JOIN wb ON wa.k = wb.k LIMIT 5",
    "SELECT w, k FROM wa WHERE k > 40",
], ids=["join-root", "topn-over-join", "limit-over-join", "chain-root"])
def test_wide_decimal_row_roots_stay_on_the_host(sql):
    """A row root that returns a wide-decimal column (limb planes on the
    device) stays on the CPU engine at plan time: the JAX package's device
    run fails on it and reruns on the CPU (ROADMAP queue 3). The answer
    equals the JAX engine's."""
    from tidb_tpu_torch.parser import parse
    rng = np.random.default_rng(31)
    js, ts = twin_sessions(
        ["CREATE TABLE wa (k BIGINT, w DECIMAL(30,2))",
         "CREATE TABLE wb (k BIGINT PRIMARY KEY, x BIGINT)"],
        {"wa": ({"k": rng.integers(0, 50, 300),
                 "w": rng.integers(0, 10 ** 6, 300)}, None),
         "wb": ({"k": np.arange(50), "x": rng.integers(0, 100, 50)},
                None)})
    ts.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                    "tidb_tpu_strict": 1})
    try:
        for root in _fragment_roots(ts._plan(parse(sql)[0])):
            assert not any(ft.is_wide_decimal
                           for ft in root.schema.field_types), sql
        got = [tuple(r) for r in ts.query(sql).rows]
    finally:
        ts.vars.update({"tidb_tpu_engine": "off", "tidb_tpu_strict": 0})
    want, _ = run_jax(js, sql)
    if "LIMIT" in sql and "ORDER BY" not in sql:
        assert len(got) == len(want)
    else:
        assert_same(want, got, ordered="ORDER BY" in sql)

"""Record what K1 segment_reduce is given on the main path: the cap and the
spread of the group ids of every call that chip_smoke's statements make.

    python tidb_tpu_torch/tools/segment_caps.py [--rows N] [--out FILE]

runs chip_smoke's tables (made by its own generators at N lineitem rows,
200,000 by default) and statements (Q1, Q6, TopN, the joins, W1-W6,
D1-D4, R1-R2, E1-E6, S1-S7, X2-X3) on a CPU engine with the device
engine on, so every aggregate goes through `ops.segment.segment_reduce`
(its plain version on the CPU) with the caps the planner gives it. Caps
come from the plan (a hash capacity is `_pow2(estimate, lo=1024)`, a
perfect-hash domain the product of the key domains), not from the row
count. Prints one line per (statement, op, input dtype, rows, cap,
occupied slots, largest slot's share of the in-range rows) with its
number of calls, then one JSON line of the calls by K1 path (small: cap
<= 32, mid: <= 4,096, large: above).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tables(s, cs, n: int) -> None:
    from tidb_tpu_torch.testing import load_numpy_columns
    ddl = [
        "CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
        "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
        "l_tax DECIMAL(15,2), l_returnflag CHAR(1), l_linestatus CHAR(1), "
        "l_shipdate DATE, l_orderkey BIGINT)",
        "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, "
        "o_orderdate DATE, o_orderpriority CHAR(1), o_custkey BIGINT)",
        "CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, "
        "c_mktsegment CHAR(10))",
        "CREATE TABLE skew_fact (k BIGINT, v BIGINT)",
        "CREATE TABLE skew_dim (k BIGINT, w BIGINT)",
        "CREATE TABLE lineitem_str (l_orderkey BIGINT, "
        "l_quantity DECIMAL(15,2), l_extendedprice DECIMAL(15,2), "
        "l_shipmode CHAR(10), l_shipinstruct CHAR(25))",
        "CREATE TABLE orders_str (o_orderkey BIGINT PRIMARY KEY, "
        "o_orderpriority CHAR(15), o_clerk CHAR(15), o_comment VARCHAR(79))",
        "CREATE TABLE shipmode (sm_name CHAR(10), sm_cost INT)"]
    for stmt in ddl:
        s.execute(stmt)
    orders, customer = cs.make_orders_customer(n)
    fact, dim = cs.make_skew()
    tables = [("lineitem", cs.make_lineitem(n)), ("orders", orders),
              ("customer", customer), ("skew_fact", fact),
              ("skew_dim", dim)]
    tables += zip(("lineitem_str", "orders_str", "shipmode"),
                  cs.make_string_tables(n))
    for name, cols in tables:
        load_numpy_columns(s, name, cols)
        s.execute(f"ANALYZE TABLE {name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--out", help="append the JSON line to this file too")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.ops import segment as seg
    from tidb_tpu_torch.session import Engine

    calls = collections.Counter()
    stmt = ["-"]
    plain = seg.segment_reduce

    def recorder(op, data, gids, cap, out_dtype=None):
        g = gids.to(torch.int64)
        g = g[(g >= 0) & (g < cap)]
        occupied, top = 0, 0.0
        if g.numel():
            per = torch.bincount(g, minlength=cap)
            occupied = int((per > 0).sum())
            top = round(float(per.max()) / g.numel(), 3)
        calls[(stmt[0], op, str(data.dtype).replace("torch.", ""),
               int(data.shape[0]), cap, occupied, top)] += 1
        return plain(op, data, gids, cap, out_dtype)

    seg.segment_reduce = recorder
    s = Engine(device="cpu").new_session()
    _tables(s, cs, args.rows)
    s.vars["tidb_tpu_engine"] = "on"
    s.vars["tidb_tpu_row_threshold"] = 1
    stmts = {"q1": cs.Q1, "q6": cs.Q6, "topn": cs.TOPN, "q3": cs.Q3,
             "q5": cs.Q5, "expand": cs.EXPAND, "blocked": cs.BLOCKED,
             "tpch_q3": cs.TPCH_Q3, "w1": cs.W1, "w2": cs.W2, "w3": cs.W3,
             "w4": cs.W4, "w6": cs.W6, "d1": cs.D1, "d3": cs.D3,
             "d4": cs.D4, "r1": cs.R1, "r2": cs.R2, **cs.EXPR_STMTS,
             **cs.STRING_STMTS, "x2": cs.X2, "x3": cs.X3}
    for name, sql in stmts.items():
        stmt[0] = name
        s.query(sql)
    seg.segment_reduce = plain
    print("statement op dtype rows cap occupied top_share: calls")
    paths = collections.Counter()
    for key, n in sorted(calls.items(), key=lambda kv: (kv[0][4], kv[0])):
        print(*key, ":", n)
        cap = key[4]
        paths["small" if cap <= seg.SMALL_CAP else
              "mid" if cap <= seg.MID_CAP else "large"] += n
    line = json.dumps({"rows": args.rows, "calls_by_path": dict(paths)})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

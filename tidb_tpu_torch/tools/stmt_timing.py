"""Time chip_smoke's statements end to end on one checkout, cold and many
times warm, and the nvcc build of chosen kernel sources, for comparing two
checkouts in one machine's run.

    python tidb_tpu_torch/tools/stmt_timing.py --tree DIR
        [--statements e1,e2] [--warm 30] [--sf 1.0]
        [--nvcc civil_date,window_frame] [--phase3] [--profile RUNS]
        [--out FILE]

The statements: E1, E2, E4, E5, E6 over lineitem; bench.py's Q3
(`q3`), TPC-H Q3 (`tpch_q3`) over lineitem, orders and customer (made
as chip_smoke makes them); the windows W1 (inside the device fragment)
and W6 (WindowExec's device path over a device aggregate).

imports `tidb_tpu_torch` from DIR (a checkout of the repo, which builds
its own kernels into DIR/build/) and chip_smoke's lineitem generator and
statements from this checkout, so both checkouts run the same rows and
the same SQL. `--nvcc` first builds each named csrc source alone, one
after the other, with the build's flags into a temporary directory, and
records its wall seconds. `--phase3` then runs DIR's own chip_smoke
phase 3 (every kernel against its plain version, as its main runs it)
and records its seconds, so what the statements meet next is the
process state chip_smoke's statements meet. Then it loads lineitem at scale factor --sf
(make_lineitem, ANALYZEd; orders and customer too when a join statement
is chosen), sets the device engine on under
tidb_tpu_strict=1 as chip_smoke phase 17 does, and runs each statement
once cold and --warm times warm as chip_smoke's `_run_plan` runs it
(plan, build, run to completion, the card synchronized), with each run's
compute_s (the statement's device phase), the cold run's encode_s and
upload_s, and K20 launches; `--profile`
runs some more warm under torch.profiler (device µs a run, by kernel,
the CUDA kernels launched a run, and the profiled operators' host µs).
Prints one JSON line: the card,
the build seconds, and per statement its cold wall, its warm walls in
order, their median and minimum, the median compute_s, and its K20
launches a run.

Run two checkouts in turns (A, B, B, A), one process each, within one run
of the machine: warm walls are host-bound and the host differs between
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: chip_smoke's statements this tool runs → the name of the chip_smoke
#: constant that holds each (E1-E6 are in its EXPR_STMTS)
STATEMENTS = {"e1": None, "e2": None, "e4": None, "e5": None, "e6": None,
              "q3": "Q3", "tpch_q3": "TPCH_Q3", "w1": "W1", "w6": "W6"}
#: the statements that join orders (and customer)
JOINS = ("q3", "tpch_q3")


def _nvcc_seconds(tree: str, sources) -> dict:
    """{source: wall seconds of its nvcc build alone, with the build's
    flags}, one source after the other."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            t0 = time.perf_counter()
            subprocess.run(
                [ck.nvcc(), *ck.NVCC_FLAGS, "-o",
                 os.path.join(tmp, src + ".so"),
                 os.path.join(tree, "tidb_tpu_torch", "csrc", src + ".cu")],
                capture_output=True, text=True, check=True)
            out[src] = time.perf_counter() - t0
    return out


#: chip_smoke's phase 3, in its main's order
PHASE3 = ("check_k1", "check_k2", "check_k3", "check_join_kernels",
          "check_sort_kernels", "check_window_kernels",
          "check_distinct_kernels", "check_delta_kernels",
          "check_calendar_kernels", "check_dict_lut_kernels",
          "check_member_compact_kernels", "check_hash_partition_kernels",
          "check_rank_kernels")


def _phase3(tree: str) -> None:
    """DIR's own chip_smoke phase 3 on card 0."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    tcs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tcs)
    dev = torch.device("cuda", 0)
    for name in PHASE3:
        getattr(tcs, name)(dev)


def _session(cs, dev: str, sf: float, joins: bool = False):
    from tidb_tpu_torch.session import Engine
    from tidb_tpu_torch.testing import load_numpy_columns
    s = Engine(device=dev).new_session()
    s.execute("CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
              "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
              "l_tax DECIMAL(15,2), l_returnflag CHAR(1), "
              "l_linestatus CHAR(1), l_shipdate DATE, l_orderkey BIGINT)")
    n = int(round(cs.SF1_ROWS * sf))
    load_numpy_columns(s, "lineitem", cs.make_lineitem(n))
    s.execute("ANALYZE TABLE lineitem")
    if joins:
        # chip_smoke's join_sql_phase tables
        s.execute("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, "
                  "o_orderdate DATE, o_orderpriority CHAR(1), "
                  "o_custkey BIGINT)")
        s.execute("CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, "
                  "c_mktsegment CHAR(10))")
        orders, customer = cs.make_orders_customer(n)
        for name, cols in (("orders", orders), ("customer", customer)):
            load_numpy_columns(s, name, cols)
            s.execute(f"ANALYZE TABLE {name}")
    s.vars.update({"tidb_tpu_strict": 1, "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_engine": "on"})
    return s


def _run(s, sql):
    """One run as chip_smoke's `_run_plan` makes it: plan, build, run to
    completion, the card synchronized → (rows, wall s, PhaseTimer dict)."""
    import torch
    from tidb_tpu_torch.executor import build, run_to_completion
    from tidb_tpu_torch.parser import parse
    t0 = time.perf_counter()
    root = build(s._plan(parse(sql)[0]))
    ctx = s._exec_ctx()
    rows = sum(c.num_rows for c in run_to_completion(root, ctx))
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, ctx.phases.as_dict()


def _profile(s, sql, runs: int) -> dict:
    """`runs` warm runs under torch.profiler → the device µs a run, all
    kernels and each kernel (name cut to 60 characters: [launches a run,
    µs a run]), and the host µs a run of the profiled operators' own
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            _run(s, sql)
    kernels, dev, host, launched = {}, 0.0, 0.0, 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type.name == "CUDA":
            if dev_us:
                kernels[e.key[:60]] = [e.count / runs, dev_us / runs]
                dev += dev_us / runs
                launched += e.count / runs
        else:
            host += e.self_cpu_time_total / runs
    torch.cuda.synchronize()
    return {"device_us": dev, "launches": launched, "host_op_us": host,
            "kernels": kernels}


def run_statements(s, stmts, warm: int, prof: int) -> dict:
    """Each statement cold, then `warm` times warm → {name: walls,
    compute_s and K20 launches}, with `prof` > 0 also that many warm runs
    profiled."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    out = {}
    for name, sql in stmts:
        walls, comp, k20 = [], [], []
        for _ in range(warm + 1):
            before = ck.launches()["civil_date"]
            rows, wall, ph = _run(s, sql)
            walls.append(wall)
            comp.append(ph)
            k20.append(ck.launches()["civil_date"] - before)
        out[name] = {"rows": rows, "cold_s": walls[0],
                     "cold_encode_s": comp[0]["encode_s"],
                     "cold_upload_s": comp[0]["upload_s"],
                     "warm_s": walls[1:],
                     "warm_median_s": statistics.median(walls[1:]),
                     "warm_min_s": min(walls[1:]),
                     "warm_compute_median_s": statistics.median(
                         c["compute_s"] for c in comp[1:]),
                     "k20_launches": sorted(set(k20))}
        if prof:
            out[name]["profile"] = _profile(s, sql, prof)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose package to run")
    ap.add_argument("--statements", default="e1,e2",
                    help=f"comma-separated, of {','.join(STATEMENTS)}")
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--nvcc", default="",
                    help="comma-separated csrc sources to build alone")
    ap.add_argument("--phase3", action="store_true",
                    help="run DIR's chip_smoke phase 3 first")
    ap.add_argument("--profile", type=int, default=0,
                    help="profile this many more warm runs a statement")
    ap.add_argument("--out", help="append the JSON line to this file too")
    args = ap.parse_args()
    names = [x for x in args.statements.split(",") if x]
    if not set(names) <= set(STATEMENTS) or args.warm < 1:
        print(f"stmt_timing: statements of {tuple(STATEMENTS)}, --warm "
              f">= 1", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("stmt_timing: no CUDA device", file=sys.stderr)
        return 2
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    line = {"tree": tree, "card": smi.splitlines()[0] if smi else None}
    srcs = [x for x in args.nvcc.split(",") if x]
    if srcs:
        line["nvcc_s"] = _nvcc_seconds(tree, srcs)
    if args.phase3:
        t0 = time.perf_counter()
        _phase3(tree)
        line["phase3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = _session(cs, "cuda:0", args.sf, any(x in JOINS for x in names))
    line["load_s"] = time.perf_counter() - t0
    stmts = [(x, cs.EXPR_STMTS[x] if STATEMENTS[x] is None
              else getattr(cs, STATEMENTS[x])) for x in names]
    line.update(run_statements(s, stmts, args.warm, args.profile))
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

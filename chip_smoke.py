#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tidb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0]

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc`
(CUDA_HOME or /usr/local/cuda) and PyTorch built for CUDA. Phases, each of
which must pass:

  1. device line — the card's name and power limit (nvidia-smi), torch and
     CUDA versions;
  2. build — compiles the hand-written kernels (tidb_tpu_torch/csrc/*.cu,
     one nvcc each, in parallel) and times the build;
  3. kernel checks — K1 segment_reduce, K2 unpack_decode and K3
     perfect_group_ids against their plain torch versions on the card:
     integer and bool results exactly equal; f64 sums within the
     recursive-summation bound (n-1)·eps·sum|x| per slot, because the
     kernel adds in another order than the plain version;
  4. SQL on the card — TPC-H lineitem at scale factor --sf (1.0 =
     6,001,215 rows; the repo's bench defaults to SF=10, cut here so the
     host-side generation and the cold encode fit a smoke run), ANALYZE,
     then Q1 cold and three times warm, Q1 over 2,097,152-row slabs (a
     multi-slab merge), Q6 and a TopN scan, each through Session.query
     with tidb_tpu_strict=1 and held EXACTLY equal to the port's own host
     engine (tidb_tpu_engine='off'); every device fragment must report
     used_device, no fallback, and the K1, K2 and K3 launch counters must
     move;
  5. kernel timing at the main path's shapes (CUDA events, median of
     repeated launches after warm-up), beside the plain version, one
     PyTorch library call where one computes the same function, and the
     card's bound for the same work;
  6. wire protocol — Q1 through the port's MySQL Server on a free
     localhost port and its client, equal to phase 4's rows;
  7. join trees on the card — `orders` (n/4 rows) and `customer` (n/40)
     in bench.py's shapes and distributions, ANALYZEd; bench.py's Q3 and
     Q5 verbatim, cold and twice warm, on the default path (fused per-slab
     pipeline over FK-aligned joins) and with tidb_tpu_aligned_join=0 (LUT
     unique mode inside the fused pipeline); a join whose unique bet is
     lost and runs in expand mode; and a skewed many-to-many join under a
     small tidb_tpu_join_out_cap that runs as blocked row-range passes.
     Each under tidb_tpu_strict=1, exactly equal to the host engine; the
     launch counters are zeroed before the phase and all seven kernels
     must move in it;
  8. join kernel timing at those shapes: K4 over the orders build, K5 over
     one lineitem slab, K6 and K7 at the expand statement's build and
     probe;
  9. the sort formulation on the card, over phase 7's tables and two
     sparse-key copies (`orders_sk`, `lineitem_sk`: the same rows keyed by
     the injective map k -> k*0x9E3779B97F4A7C15 mod 2^62, a domain no
     LUT or aligned join takes): TPC-H Q3 (spec 2.4.3 without
     o_shippriority) cold and twice warm, TopN and LIMIT directly over a
     join (EXPLAIN shows both inside the device fragment; LIMIT is held
     by its count and by membership in the host's unlimited join), and
     bench.py's Q3 over the sparse keys (equal to the host engine and to
     the dense Q3). Counters are zeroed before the phase; K8-K11 must
     move, and in the sparse-key statement K11 but not K4/K5;
 10. sort kernel timing at the main path's shapes: K8 over 8,388,608
     full-range int64 keys and over the sparse join's 10,485,760 keys,
     K9 over 8,388,608 float64 and int64 values, K10 at 8,388,608 rows
     and ~10^5 groups, K11 with 2,097,152 build codes and 8,388,608
     probes;
 11. window functions on the card, over lineitem and phase 7's tables:
     W1 a chain window root over a filtered scan (every rank function, a
     running SUM with ties, LAG, FIRST_VALUE, NTILE, CUME_DIST over ~1.5M
     small partitions), W2 top-10 per (returnflag, linestatus) through an
     interior ROW_NUMBER, W3 a RANGE frame over the DATE key and a bounded
     ROWS MAX under an outer aggregate, W4 RANK over customer ⋈ orders
     filtered to rank 1, W5 = W2 over 2,097,152-row slabs (one program
     over the concatenated slabs), W6 RANK over a device aggregate's rows
     (WindowExec's device path), each cold and twice warm under
     tidb_tpu_strict=1, held against the host engine column by column as
     numpy arrays (float columns within 2·n·eps·|x|); EXPLAIN shows
     W1-W5's windows inside a TpuFragment and W6's outside. Counters are
     zeroed before the phase; K12-K15, K8 and K9 must move (K12-K15 in
     W6 itself);
 12. window kernel timing at phase 11's shapes (8,388,608 rows): K12
     over W1's and W2's layouts, K13's int64 prefix (beside torch.cumsum)
     and segmented max, K14 over W3's RANGE key, K15's bounded MIN and
     prefix-difference SUM;
 13. DISTINCT and ROLLUP aggregates on the card, over lineitem and
     phase 7's tables: D1 three DISTINCT aggregates (one of two columns)
     and an AVG by (returnflag, linestatus), D2 = D1 over 2,097,152-row
     slabs (per-slab pair sets through the pair ladder, merged on the
     host; its "pairs" rungs are logged), D3 two DISTINCT counts over
     lineitem ⋈ orders, D4 scalar DISTINCT counts (one of two columns),
     R1 Q1's keys WITH ROLLUP, R2 a ROLLUP over lineitem ⋈ orders ⋈
     customer, R3 = R1 over 2,097,152-row slabs; each cold and twice
     warm under tidb_tpu_strict=1, exactly equal to the host engine
     (rows sorted where the statement has no ORDER BY), EXPLAIN showing
     its HashAgg inside a TpuFragment. Counters are zeroed before the
     phase; K16-K18 and K8-K10 must move (K16 in every D run, K17 and
     K18 in every R run);
 14. DISTINCT/ROLLUP kernel timing at phase 13's shapes, each held
     exactly to its plain version there: K16's two entries at
     n = 8,388,608 (beside `gids*(n+1)+vid` and `rep[pg] == arange`),
     K17 tiling R1's read columns to 3 x 8,388,608 rows and writing the
     levels of its two key masks (beside torch.cat, repeat_interleave
     and &), K18 through D2's pair cap (beside per-column index_select);
 15. the delta write path on the lineitem entry phase 13 left resident
     (R3's 2,097,152-row slabs, 3 base slabs), tidb_tpu_compaction off:
     a 2-row INSERT its base layouts cannot carry (l_shipdate going back
     in time against its difference layout; an l_extendedprice past its
     32-bit pack) declines to a rebuild, which leaves l_extendedprice
     raw; Q1 and bench.py's Q3 warm as the starting point; an INSERT of
     1,000 copied rows, a DELETE that tombstones base slab 0 and some
     delta rows, and a second one on top (the cumulative re-diff), each
     read back through Q1 twice; bench.py's Q3 over the delta
     generation; delta.run_pending_compactions() timed (the rebuild
     every write costs without the delta path) and Q1 after it. Every
     statement exactly equal to the host engine; after each write the
     entry is a delta generation with the right delta_rows, the base
     tensors of untouched slabs are the same objects, and the DELETEs'
     reads launch K19 and K18 (the INSERT's none). Counters are zeroed
     before the phase;
 16. K19 at phase 15's shapes: DELETE A's merge of base slab 0, every
     column held exactly to delta_merge_plain and to the slab phase 15
     wrote; delta_perm beside torch.argsort(~keep, stable=True), the
     repack of every packed column and of random codes at widths 1 and
     32, K18 through the permutation for the raw column.

Phase 3 also holds K4 lut_build, K5 lut_probe, K6 lut_order and K7
join_expand, and K8 radix_sort, K9 sort_encode, K10 group_ids and K11
sorted_search against their plain versions, exactly; the sort functions
built on K8-K10 (factorize, sort_perm, topn, pack_codes) equal the same
functions over CPU copies of the inputs; and K12 window_bounds, K13
window_scan, K14 frame_bounds and K15 frame_eval against theirs, every
entry, exactly except K13's float64 prefixes (within 2·i·eps·Σ|x|);
and K16 distinct_pairs, K17 rollup_tile and K18 gather_columns against
theirs exactly (random gids with dead rows, value ranks with ties,
1/2/4/8-byte columns and a 2-D limb plane, n_valid below and at the
cap), with the pair factorize on K8-K10 + K16 equal to its CPU run;
and K19 delta_merge against delta_merge_plain exactly (its partition,
every packed width, dict, raw and wide columns through K18, four
tombstone sets). Phase 4's TopN scan must launch K8-K10.

It prints one JSON `kernels` line and then, last, the JSON device line. It
exits non-zero, printing neither, when no CUDA device is available, when
the package is missing, or when any phase fails. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and
# the non-tensor-core fp32 rate, used as the rate of the scalar integer
# and f64 operations these kernels do
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
EPS64 = 2.0 ** -52

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

# the build side is the filtered orders (smaller than customer), not
# unique on o_custkey: the unique bet is lost and the join runs expanded
EXPAND = ("SELECT c_mktsegment, COUNT(*) FROM customer JOIN orders "
          "ON c_custkey = o_custkey WHERE o_orderdate < '1992-03-01' "
          "GROUP BY c_mktsegment")
EXPAND_DAY = 8096            # '1992-03-01' as days since 1970-01-01

# a many-to-many join with a hot key on both sides: the planner's uniform
# estimate is about a third of the true fan-out, so the first expansion
# overflows, and past tidb_tpu_join_out_cap it runs as row-range passes
BLOCKED = ("SELECT w, COUNT(*), SUM(v) FROM skew_fact JOIN skew_dim "
           "ON skew_fact.k = skew_dim.k GROUP BY w ORDER BY w")
BLOCKED_OUT_CAP = 1 << 20

# TPC-H Q3 (spec 2.4.3) without o_shippriority, which bench.py's orders
# lack (dbgen sets it to 0): GROUP BY l_orderkey, o_orderdate has no
# perfect-hash domain, so every lineitem slab runs the sort factorize
TPCH_Q3 = """SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount))
 AS revenue, o_orderdate
 FROM customer JOIN orders ON c_custkey = o_custkey
 JOIN lineitem ON l_orderkey = o_orderkey
 WHERE c_mktsegment = 'BUILDING' AND o_orderdate < '1995-03-15'
 AND l_shipdate > '1995-03-15'
 GROUP BY l_orderkey, o_orderdate ORDER BY revenue DESC, o_orderdate
 LIMIT 10"""

JOIN_ROWS = ("SELECT l_orderkey, l_extendedprice, o_orderdate FROM lineitem "
             "JOIN orders ON l_orderkey = o_orderkey "
             "WHERE o_orderdate < '1992-02-01'")
TOPN_JOIN = JOIN_ROWS + " ORDER BY l_extendedprice DESC, l_orderkey LIMIT 10"
LIMIT_JOIN = JOIN_ROWS + " LIMIT 100"

# bench.py's Q3 text over the sparse-key copies
Q3_SK = """SELECT o_orderpriority, COUNT(*),
 SUM(l_extendedprice * (1 - l_discount))
 FROM lineitem_sk JOIN orders_sk ON l_okey = o_okey
 WHERE l_shipdate <= '1998-09-02' AND o_orderdate < '1998-01-01'
 GROUP BY o_orderpriority ORDER BY o_orderpriority"""

SF1_ROWS = 6_001_215
KERNELS = ("segment_reduce", "unpack_decode", "perfect_groups",
           "lut_build", "lut_probe", "lut_order", "join_expand",
           "radix_sort", "sort_encode", "group_ids", "sorted_search")
# the first slice's path (Q1/Q6/TopN) runs these; the join path the first
# seven; the sort formulation the last four (the windows' K12-K15 are
# WINDOW_KERNELS, with phase 11)
Q1_KERNELS = KERNELS[:3]
JOIN_KERNELS = KERNELS[:7]
SORT_KERNELS = KERNELS[7:]


def log(msg: str) -> None:
    print(msg, flush=True)


def make_lineitem(n: int):
    """Lineitem Q1 columns with TPC-H-like value distributions, sorted by
    shipdate (lineitem arrives in order-date order), plus l_orderkey."""
    import numpy as np
    rng = np.random.default_rng(42)
    qty = rng.integers(100, 5001, n).astype(np.int64)          # 1.00..50.00
    price = rng.integers(90_000, 10_500_001, n).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)             # 0.00..0.10
    tax = rng.integers(0, 9, n).astype(np.int64)               # 0.00..0.08
    rflag = np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)]
    lstatus = np.array(["F", "O"], dtype=object)[rng.integers(0, 2, n)]
    shipdate = rng.integers(8036, 10590, n).astype(np.int32)   # 1992..1998
    order = np.argsort(shipdate)
    okey = np.random.default_rng(7).integers(0, max(n // 4, 1),
                                             n).astype(np.int64)
    return {"l_quantity": qty[order], "l_extendedprice": price[order],
            "l_discount": disc[order], "l_tax": tax[order],
            "l_returnflag": rflag[order], "l_linestatus": lstatus[order],
            "l_shipdate": shipdate[order], "l_orderkey": okey}


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float):
    tb = n_bytes / PEAK_BYTES_PER_S * 1e3
    to = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------


def check_k1(dev):
    import torch
    from tidb_tpu_torch.ops import segment as seg
    n = 8_388_608
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    for cap in (1, 20, 1024, 65536):
        gids = torch.randint(-1, cap + 1, (n,), generator=g,
                             dtype=torch.int32).to(dev)
        for dt in (torch.int64, torch.int32, torch.float64):
            if dt == torch.float64:
                data = torch.randn(n, generator=g,
                                   dtype=torch.float64).to(dev)
            else:
                data = torch.randint(-10 ** 6, 10 ** 6, (n,), generator=g,
                                     dtype=dt).to(dev)
            for op in ("sum", "min", "max"):
                got = seg.segment_reduce(op, data, gids, cap)
                want = seg.segment_reduce_plain(op, data, gids, cap)
                torch.cuda.synchronize()
                if dt == torch.float64 and op == "sum":
                    ok_ids = (gids >= 0) & (gids < cap)
                    idx = torch.where(ok_ids, gids.long(),
                                      torch.full_like(gids, cap).long())
                    cnt = torch.zeros(cap + 1, dtype=torch.float64,
                                      device=dev).index_add_(
                        0, idx, torch.ones_like(data))[:cap]
                    sabs = torch.zeros(cap + 1, dtype=torch.float64,
                                       device=dev).index_add_(
                        0, idx, data.abs())[:cap]
                    tol = (cnt - 1).clamp(min=0) * EPS64 * sabs
                    err = (got - want).abs()
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"K1 f64 sum cap={cap}: error over bound")
                    worst = max(worst, float(err.max()))
                elif not torch.equal(got, want):
                    raise AssertionError(f"K1 {op} {dt} cap={cap}: "
                                         f"kernel != plain")
    # bool counts arrive as int32 / int64 (segment_count / segment_any)
    mask = torch.rand(n, generator=g).to(dev) < 0.5
    gids = torch.randint(0, 20, (n,), generator=g,
                         dtype=torch.int32).to(dev)
    for dt in (torch.int32, torch.int64):
        if not torch.equal(seg.segment_reduce("sum", mask.to(dt), gids, 20),
                           seg.segment_reduce_plain("sum", mask.to(dt),
                                                    gids, 20)):
            raise AssertionError("K1 bool count: kernel != plain")
    log(f"K1 segment_reduce: exact on int64/int32/bool, f64 sum within "
        f"(n-1)*eps*sum|x| (max abs err {worst:.3e}), caps 1/20/1024/65536")
    return worst


def check_k2(dev):
    import numpy as np
    import torch
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.executor.device_cache import _upload
    rng = np.random.default_rng(3)
    cases = 0
    for cap, n in ((1 << 20, 1 << 20), (1 << 20, (1 << 20) - 777)):
        for dt in (np.int64, np.int32):
            for kind, widths in (("pack", (0, 1, 2, 4, 8, 16, 32)),
                                 ("dict", (1, 2, 4, 8, 16)),
                                 ("delta", (1, 2, 4, 8, 16, 32))):
                for w in widths:
                    lay, vals, mask, dv = _layout_case(rng, kind, w, dt, cap,
                                                       n)
                    host = C.pack_slab(lay, vals, mask, dv)
                    slab = tuple(_upload(a, dev) for a in host)
                    if kind == "dict":
                        slab = slab + (_upload(dv, dev),)
                    gv, gm = C.decode_slab_torch(lay, slab, cap)
                    pv, pm = C.decode_slab_plain(lay, slab, cap)
                    torch.cuda.synchronize()
                    if not torch.equal(gm, pm):
                        raise AssertionError(f"K2 mask {kind} w{w}")
                    if not torch.equal(gv[pm], pv[pm]):
                        raise AssertionError(f"K2 values {kind} w{w} {dt}")
                    # and byte-equal to the numpy decode on valid slots
                    nv, nm = C.decode_slab(lay, host + ((dv,) if kind ==
                                           "dict" else ()), cap, np)
                    if not (np.array_equal(nm, gm.cpu().numpy()) and
                            np.array_equal(nv[nm], gv.cpu().numpy()[nm])):
                        raise AssertionError(f"K2 vs numpy {kind} w{w}")
                    cases += 1
    log(f"K2 unpack_decode: {cases} layout/width/dtype cases byte-equal "
        f"(values on valid slots, mask everywhere)")


def _layout_case(rng, kind, w, dt, cap, n):
    import numpy as np
    from tidb_tpu_torch.chunk import compress as C
    dt = np.dtype(dt)
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    if kind != "delta":
        mask[:n] &= rng.random(n) > 0.1         # NULLs
    if kind == "pack":
        ref = -12345
        hi = (1 << w) - 1 if w else 0
        hi = min(hi, np.iinfo(dt).max - 12345 - 1)
        vals = (rng.integers(0, hi + 1, cap) + ref).astype(dt)
        return C.ColLayout("pack", w, ref, dt.name), vals, mask, None
    if kind == "dict":
        card = min(1 << w, 3000)
        dv = np.unique(rng.integers(-10 ** 6, 10 ** 6, card * 2)
                       .astype(dt))[:card]
        vals = dv[rng.integers(0, len(dv), cap)]
        return C.ColLayout("dict", w, 0, dt.name, len(dv)), vals, mask, dv
    gap = min((1 << w) - 1, 1000)
    vals = (np.cumsum(rng.integers(0, gap + 1, cap)) + 500).astype(dt)
    return C.ColLayout("delta", w, 0, dt.name), vals, mask, None


def check_k3(dev):
    import torch
    from tidb_tpu_torch.executor import device_emit as E
    n = 8_388_608
    g = torch.Generator(device="cpu").manual_seed(5)
    keys = [(torch.randint(-1, 4, (n,), generator=g, dtype=torch.int32),
             torch.rand(n, generator=g) < 0.95),
            (torch.randint(0, 2, (n,), generator=g, dtype=torch.int64),
             torch.rand(n, generator=g) < 0.9)]
    keys = [(v.to(dev), m.to(dev)) for v, m in keys]
    live = (torch.rand(n, generator=g) < 0.97).to(dev)
    bounds, strides, cap = [(0, 2), (0, 1)], [1, 4], 12
    got = E.perfect_group_ids(keys, live, bounds, strides, cap)
    want = E.perfect_group_ids_plain(keys, live, bounds, strides, cap)
    inv = torch.randperm(cap, generator=g).to(torch.int32).to(dev)
    rg = E.remap_group_ids(got, inv, cap)
    rw = E.remap_group_ids_plain(want, inv, cap)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(rg, rw):
        raise AssertionError("K3: kernel != plain")
    log("K3 perfect_group_ids: packed ids and remap exactly equal "
        "(2 keys, NULLs, out-of-bounds values, dead rows)")


# ---------------------------------------------------------------------------
# phase 4: SQL on the card
# ---------------------------------------------------------------------------


def fragments_of(root):
    from tidb_tpu_torch.executor.fragment import TpuFragmentExec
    out = []

    def walk(e):
        if isinstance(e, TpuFragmentExec):
            out.append(e)
        for c in getattr(e, "children", []):
            walk(c)

    walk(root)
    return out


def _run_plan(s, sql, device: bool, max_slab=None):
    """→ (non-empty result chunks, wall seconds, execution context)
    through the session's own planner/executor; on the device, every
    fragment must have run there."""
    import torch
    from tidb_tpu_torch.executor import build, run_to_completion
    from tidb_tpu_torch.parser import parse
    s.vars["tidb_tpu_engine"] = "on" if device else "off"
    if max_slab is None:
        s.vars.pop("tidb_tpu_max_slab_rows", None)
    else:
        s.vars["tidb_tpu_max_slab_rows"] = max_slab
    t0 = time.perf_counter()
    plan = s._plan(parse(sql)[0])
    root = build(plan)
    ctx = s._exec_ctx()
    chunks = [c for c in run_to_completion(root, ctx) if c.num_rows]
    if device:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if device:
        frags = fragments_of(root)
        if not frags:
            raise AssertionError(f"no device fragment for: {sql}")
        for f in frags:
            if not f.used_device or f.fallback_code is not None:
                raise AssertionError(f"fragment did not run on the device "
                                     f"({f.fallback_reason}): {sql}")
    return chunks, wall, ctx


def run_sql(s, sql, device: bool, max_slab=None):
    """→ (rows, wall seconds, phases dict, escalation rungs) through the
    session's own planner/executor, checking every fragment ran on the
    device."""
    if not device:
        s.vars["tidb_tpu_engine"] = "off"
        if max_slab is None:
            s.vars.pop("tidb_tpu_max_slab_rows", None)
        else:
            s.vars["tidb_tpu_max_slab_rows"] = max_slab
        t0 = time.perf_counter()
        rows = s.query(sql).rows
        return rows, time.perf_counter() - t0, {}, {}
    chunks, wall, ctx = _run_plan(s, sql, True, max_slab)
    rows = [r for ch in chunks for r in ch.rows()]
    return rows, wall, ctx.phases.as_dict(), dict(ctx.escalation.by_kind)


def sql_phase(dev, sf: float):
    import numpy as np  # noqa: F401 — make_lineitem
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.session import Engine
    from tidb_tpu_torch.testing import load_numpy_columns
    n = int(round(SF1_ROWS * sf))
    t0 = time.perf_counter()
    eng = Engine(device=str(dev))
    s = eng.new_session()
    s.execute("CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
              "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
              "l_tax DECIMAL(15,2), l_returnflag CHAR(1), "
              "l_linestatus CHAR(1), l_shipdate DATE, l_orderkey BIGINT)")
    load_numpy_columns(s, "lineitem", make_lineitem(n))
    s.execute("ANALYZE TABLE lineitem")
    log(f"lineitem: {n} rows (SF={sf}) generated, loaded and analyzed in "
        f"{time.perf_counter() - t0:.1f} s")
    s.vars["tidb_tpu_strict"] = 1
    s.vars["tidb_tpu_row_threshold"] = 1
    host = {}
    for name, sql in (("q1", Q1), ("q6", Q6), ("topn", TOPN)):
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = rows
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    runs = [("q1_cold", Q1, None, "q1"), ("q1_warm1", Q1, None, "q1"),
            ("q1_warm2", Q1, None, "q1"), ("q1_warm3", Q1, None, "q1"),
            ("q1_multislab", Q1, 2_097_152, "q1"), ("q6", Q6, None, "q6"),
            ("topn", TOPN, None, "topn")]
    ck.reset_launches()
    per_query = {}
    walls = {}
    for name, sql, max_slab, ref in runs:
        before = ck.launches()
        rows, wall, phases, _ = run_sql(s, sql, device=True,
                                        max_slab=max_slab)
        after = ck.launches()
        moved = {k: after[k] - before[k] for k in after}
        if rows != host[ref]:
            raise AssertionError(f"{name}: device rows != host rows\n"
                                 f"{rows[:3]}\n{host[ref][:3]}")
        per_query[name] = moved
        walls[name] = wall
        if name == "q1_warm3":
            q1_slab = _q1_slab_snapshot(dev)
        log(f"{name}: {len(rows)} rows, exact match, wall {wall:.4f} s, "
            f"launches {moved}, phases {phases}")
    launches = ck.launches()
    for k in Q1_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"main path")
    for k in ("radix_sort", "sort_encode", "group_ids"):
        if per_query["topn"][k] == 0:
            raise AssertionError(f"the TopN scan did not launch {k}")
    return eng, s, host, launches, walls, q1_slab


def _q1_slab_snapshot(dev):
    """The first cached slab of every lineitem column Q1 read (layout,
    device tuple, dictionary), kept for the timing phase: later runs at
    another slab size rebuild the cache entry."""
    from tidb_tpu_torch.executor import device_cache as DC
    ent = next(e for e in DC._CACHE.values() if e.device == dev)
    return {"slab_cap": ent.slab_cap, "rows": ent.slab_rows(0),
            "cols": {i: (ent.layouts.get(i), ent.dev[i][0],
                         ent.dicts.get(i)) for i in sorted(ent.dev)}}


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's shapes
# ---------------------------------------------------------------------------


def timing_phase(dev, q1_slab, k1_err):
    import torch
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.executor import device_emit as E
    from tidb_tpu_torch.ops import segment as seg
    out = []
    n = q1_slab["slab_cap"]
    rows = q1_slab["rows"]
    cols = q1_slab["cols"]
    g = torch.Generator(device="cpu").manual_seed(11)

    # K1: one int64 SUM of a Q1 slab into Q1's perfect-hash cap
    cap = 12
    data = torch.randint(0, 10 ** 7, (n,), generator=g,
                         dtype=torch.int64).to(dev)
    gids = torch.randint(0, cap + 1, (n,), generator=g,
                         dtype=torch.int32).to(dev)
    ms = time_cuda(lambda: seg.segment_reduce("sum", data, gids, cap))
    plain = time_cuda(lambda: seg.segment_reduce_plain("sum", data, gids,
                                                       cap))
    idx = gids.to(torch.int64)
    acc = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    lib = time_cuda(lambda: acc.zero_().index_add_(0, idx, data))
    b, by = bound_ms(n * (8 + 4) + cap * 8, n)
    out.append({"name": "segment_reduce", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/segment_reduce.cu",
                "replaces": "tidb_tpu/ops/segment.py:79",
                "max_abs_err": k1_err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K1 n={n} cap={cap} int64 sum: {ms:.4f} ms (plain {plain:.4f}, "
        f"index_add_ {lib:.4f}, bound {b:.4f} by {by})")

    # K2: decode every packed column slab the Q1 run cached, as Q1 does
    slabs = [(lay, t) for lay, t, _d in cols.values() if lay is not None]
    ms = time_cuda(lambda: [C.decode_slab_torch(l, t, n) for l, t in slabs])
    plain = time_cuda(lambda: [C.decode_slab_plain(l, t, n)
                               for l, t in slabs], reps=5)
    nbytes = 0
    for lay, t in slabs:
        nbytes += sum(a.nbytes for a in t) + n * (
            lay.np_dtype.itemsize + 1)
    err = 0
    for lay, t in slabs:
        gv, gm = C.decode_slab_torch(lay, t, n)
        pv, pm = C.decode_slab_plain(lay, t, n)
        if not torch.equal(gm, pm) or not torch.equal(gv[pm], pv[pm]):
            raise AssertionError(f"K2 main-path slab {lay.sig()} differs")
    b, by = bound_ms(nbytes, n * len(slabs))
    out.append({"name": "unpack_decode", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/unpack_decode.cu",
                "replaces": "tidb_tpu/chunk/compress.py:227",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None})
    log(f"K2 {len(slabs)} Q1 column slabs of {n} ({rows} live) "
        f"[{', '.join(l.sig() for l, _ in slabs)}]: {ms:.4f} ms "
        f"(plain {plain:.4f}, bound {b:.4f} by {by})")

    # K3: Q1's two group keys (returnflag / linestatus dictionary codes)
    rf = next(c for c in cols.values() if c[2] is not None and
              len(c[2]) == 3)
    ls = next(c for c in cols.values() if c[2] is not None and
              len(c[2]) == 2)
    k_rf = C.decode_slab_torch(rf[0], rf[1], n)
    k_ls = C.decode_slab_torch(ls[0], ls[1], n)
    live = torch.arange(n, device=dev) < rows
    keys = [k_rf, k_ls]
    bounds, strides = [(0, 2), (0, 1)], [1, 4]
    ms = time_cuda(lambda: E.perfect_group_ids(keys, live, bounds, strides,
                                               12))
    plain = time_cuda(lambda: E.perfect_group_ids_plain(
        keys, live, bounds, strides, 12))
    if not torch.equal(E.perfect_group_ids(keys, live, bounds, strides, 12),
                       E.perfect_group_ids_plain(keys, live, bounds,
                                                 strides, 12)):
        raise AssertionError("K3 main-path keys differ")
    b, by = bound_ms(n * (4 + 1) * 2 + n + n * 4, n * 8)
    out.append({"name": "perfect_group_ids", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/perfect_groups.cu",
                "replaces": "tidb_tpu/executor/device_emit.py:284",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None})
    log(f"K3 n={n} 2 keys: {ms:.4f} ms (plain {plain:.4f}, bound {b:.4f} "
        f"by {by})")
    return out


# ---------------------------------------------------------------------------
# phase 3 (joins): K4-K7 against their plain versions
# ---------------------------------------------------------------------------


def _join_keys(rng, n, bounds, null_p, spill, dev):
    import numpy as np
    import torch
    out = []
    for lo, hi in bounds:
        v = rng.integers(lo - spill, hi + spill + 1, n).astype(np.int64)
        out.append((torch.from_numpy(v).to(dev),
                    torch.from_numpy(rng.random(n) > null_p).to(dev)))
    return out


def check_join_kernels(dev):
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import join as J
    rng = np.random.default_rng(13)
    cases = 0
    # K4 + K5: 1, 2 and 3 key columns; unique and duplicated builds; NULL
    # and out-of-domain probe keys; a live mask and an n_live prefix
    for bounds in ([(0, 199_999)], [(0, 499), (-3, 396)],
                   [(0, 63), (10, 73), (5, 68)]):
        domain = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
        for unique in (True, False):
            nb = 150_000
            if unique:
                cells = rng.permutation(domain)[:nb]
                bkeys = []
                for lo, hi in bounds:
                    span = hi - lo + 1
                    bkeys.append((torch.from_numpy(cells % span + lo).to(dev),
                                  torch.ones(nb, dtype=torch.bool,
                                             device=dev)))
                    cells = cells // span
            else:
                bkeys = _join_keys(rng, nb, bounds, 0.05, 0, dev)
            pkeys = _join_keys(rng, 2_000_000, bounds, 0.1, 3, dev)
            blive = torch.from_numpy(rng.random(nb) > 0.1).to(dev)
            plive = torch.from_numpy(rng.random(2_000_000) > 0.1).to(dev)
            for n_live in (None, nb - 777):
                got = J.lut_build(bkeys, bounds, domain, live=blive,
                                  n_live=n_live, want_codes=True)
                want = J.lut_build_plain(bkeys, bounds, domain, live=blive,
                                         n_live=n_live, want_codes=True)
                cnt, lut, maxcnt, codes = got
                torch.cuda.synchronize()
                if not (torch.equal(cnt, want[0]) and
                        torch.equal(codes, want[3]) and
                        int(maxcnt) == int(want[2])):
                    raise AssertionError(f"K4 {bounds} unique={unique}: "
                                         f"kernel != plain")
                single = cnt[:domain] <= 1
                if not torch.equal(lut[:domain][single],
                                   want[1][:domain][single]):
                    raise AssertionError("K4 lut differs on a code of "
                                         "count <= 1")
                hit = lut[:domain][~single].long()
                if not torch.equal(codes[hit].long(),
                                   torch.nonzero(~single).reshape(-1)):
                    raise AssertionError("K4 lut of a duplicated code is "
                                         "not one of its rows")
                if (int(maxcnt) <= 1) != unique:
                    raise AssertionError("K4 uniqueness flag")
                starts, _ = J.lut_order_plain(codes, cnt)
                for table, uq in ((lut, True), (starts, False)):
                    a = J.lut_probe(pkeys, bounds, cnt, table, plive, nb, uq)
                    b = J.lut_probe_plain(pkeys, bounds, cnt, table, plive,
                                          nb, uq)
                    torch.cuda.synchronize()
                    if not (torch.equal(a[0], b[0]) and
                            torch.equal(a[1], b[1])):
                        raise AssertionError(f"K5 {bounds} unique={uq}: "
                                             f"kernel != plain")
                cases += 1
    # K6: unique, duplicated, skewed (runs past the long-run cutoff) and
    # sentinel-heavy builds, and a one-row build
    for nb, dom, kind in ((1, 1, "uniform"), (1_500_000, 1_500_000, "perm"),
                          (2_000_000, 150_000, "uniform"),
                          (300_000, 64, "zipf"), (2_097_152, 150_000,
                                                   "filtered")):
        if kind == "perm":
            vals = rng.permutation(nb)
        elif kind == "zipf":
            vals = rng.zipf(1.3, nb) % dom
        else:
            vals = rng.integers(0, dom, nb)
        keep = 0.02 if kind == "filtered" else 0.9
        keys = [(torch.from_numpy(vals.astype(np.int64)).to(dev),
                 torch.from_numpy(rng.random(nb) < keep).to(dev))]
        cnt, _, _, codes = J.lut_build(keys, [(0, dom - 1)], dom,
                                       want_lut=False, want_codes=True)
        s1, o1 = J.lut_order(codes, cnt)
        s2, o2 = J.lut_order_plain(codes, cnt)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(o1, o2)):
            raise AssertionError(f"K6 {kind} nb={nb}: kernel != plain")
        cases += 1
    # K7: inner and outer; out_cap below the total (the total stays
    # exact); an empty probe; a one-row build
    for P, nb, dom, out_cap in ((200_000, 150_000, 40_000, 1 << 20),
                                (200_000, 150_000, 40_000, 1 << 16),
                                (0, 1, 1, 1024), (5000, 1, 1, 8192)):
        for outer in (False, True):
            keys_b = [(torch.from_numpy(rng.integers(0, dom, nb)).to(dev),
                       torch.ones(nb, dtype=torch.bool, device=dev))]
            keys_p = _join_keys(rng, P, [(0, dom - 1)], 0.1, 2, dev)
            plive = torch.from_numpy(rng.random(P) > 0.05).to(dev)
            cnt, _, _, codes = J.lut_build_plain(keys_b, [(0, dom - 1)], dom,
                                                 want_lut=False,
                                                 want_codes=True)
            starts, order = J.lut_order_plain(codes, cnt)
            start, count = J.lut_probe_plain(keys_p, [(0, dom - 1)], cnt,
                                             starts, plive, nb, False)
            got = J.expand(start, count, order, out_cap, outer, plive)
            want = J.expand_plain(start, count, order, out_cap, outer, plive)
            torch.cuda.synchronize()
            live = want[3]
            ok = int(got[5]) == int(want[5]) and torch.equal(got[3], live)
            for a, b in zip(got[:3] + got[4:5], want[:3] + want[4:5]):
                ok = ok and torch.equal(a[live], b[live])
            ok = ok and bool(((got[1] >= 0) & (got[1] < nb)).all())
            if P:
                ok = ok and bool(((got[0] >= 0) & (got[0] < P)).all())
            if not ok:
                raise AssertionError(f"K7 P={P} out_cap={out_cap} "
                                     f"outer={outer}: kernel != plain")
            cases += 1
    log(f"K4-K7 lut_build/lut_probe/lut_order/join_expand: {cases} cases "
        f"exactly equal to the plain versions (1-3 key columns, NULL and "
        f"out-of-domain keys, n_live, unique/duplicated/skewed builds, "
        f"outer/inner, out_cap < total, P=0, nb=1)")


# ---------------------------------------------------------------------------
# phase 7: join trees on the card
# ---------------------------------------------------------------------------


def make_orders_customer(n: int):
    """orders and customer as bench.py builds them: the same generator,
    advanced past lineitem's l_orderkey draw (make_lineitem makes it)."""
    import numpy as np
    rng = np.random.default_rng(7)
    n_orders = max(n // 4, 1)
    n_cust = max(n // 40, 1)
    rng.integers(0, n_orders, n)                     # l_orderkey
    segs = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                     "HOUSEHOLD"], dtype=object)
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_orderdate": rng.integers(8036, 10590, n_orders).astype(np.int32),
        "o_orderpriority": np.array(["1", "2", "3", "4", "5"],
                                    dtype=object)[rng.integers(0, 5,
                                                               n_orders)],
        "o_custkey": rng.integers(0, n_cust, n_orders).astype(np.int64)}
    customer = {"c_custkey": np.arange(n_cust, dtype=np.int64),
                "c_mktsegment": segs[rng.integers(0, 5, n_cust)]}
    return orders, customer


def make_skew(n_fact: int = 500_000, n_dim: int = 2000, keys: int = 1000):
    import numpy as np
    rng = np.random.default_rng(17)
    fact = {"k": np.where(rng.random(n_fact) < 0.04, 0,
                          rng.integers(0, keys, n_fact)).astype(np.int64),
            "v": rng.integers(0, 100, n_fact).astype(np.int64)}
    dim = {"k": np.where(rng.random(n_dim) < 0.05, 0,
                         rng.integers(0, keys, n_dim)).astype(np.int64),
           "w": rng.integers(0, 9, n_dim).astype(np.int64)}
    return fact, dim


def join_sql_phase(s, n: int):
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.testing import load_numpy_columns
    t0 = time.perf_counter()
    s.execute("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, "
              "o_orderdate DATE, o_orderpriority CHAR(1), o_custkey BIGINT)")
    s.execute("CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, "
              "c_mktsegment CHAR(10))")
    s.execute("CREATE TABLE skew_fact (k BIGINT, v BIGINT)")
    s.execute("CREATE TABLE skew_dim (k BIGINT, w BIGINT)")
    orders, customer = make_orders_customer(n)
    fact, dim = make_skew()
    for name, cols in (("orders", orders), ("customer", customer),
                       ("skew_fact", fact), ("skew_dim", dim)):
        load_numpy_columns(s, name, cols)
        s.execute(f"ANALYZE TABLE {name}")
    log(f"orders {len(orders['o_orderkey'])} rows, customer "
        f"{len(customer['c_custkey'])} rows, skew_fact {len(fact['k'])}, "
        f"skew_dim {len(dim['k'])}: generated, loaded and analyzed in "
        f"{time.perf_counter() - t0:.1f} s")
    host = {}
    walls = {}
    for name, sql in (("q3", Q3), ("q5", Q5), ("expand", EXPAND),
                      ("blocked", BLOCKED)):
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = rows
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    unaligned = {"tidb_tpu_aligned_join": 0}
    blocked = {"tidb_tpu_join_out_cap": BLOCKED_OUT_CAP,
               "tidb_tpu_specialization_cache": 0}
    runs = [("q3_cold", Q3, "q3", {}), ("q3_warm1", Q3, "q3", {}),
            ("q3_warm2", Q3, "q3", {}), ("q5_cold", Q5, "q5", {}),
            ("q5_warm1", Q5, "q5", {}), ("q5_warm2", Q5, "q5", {}),
            ("q3_unaligned1", Q3, "q3", unaligned),
            ("q3_unaligned2", Q3, "q3", unaligned),
            ("q5_unaligned1", Q5, "q5", unaligned),
            ("q5_unaligned2", Q5, "q5", unaligned),
            ("expand", EXPAND, "expand", {}),
            ("blocked", BLOCKED, "blocked", blocked)]
    t_phase = time.perf_counter()
    ck.reset_launches()
    per_query = {}
    for name, sql, ref, extra in runs:
        s.vars.update(extra)
        try:
            before = ck.launches()
            rows, wall, phases, esc = run_sql(s, sql, device=True)
            after = ck.launches()
        finally:
            for k in extra:
                s.vars.pop(k, None)
        moved = {k: after[k] - before[k] for k in after if after[k] !=
                 before[k]}
        if rows != host[ref]:
            raise AssertionError(f"{name}: device rows != host rows\n"
                                 f"{rows[:3]}\n{host[ref][:3]}")
        per_query[name] = moved
        walls[name] = wall
        log(f"{name}: {len(rows)} rows, exact match, wall {wall:.4f} s, "
            f"launches {moved}, escalation {esc}, phases {phases}")
        # the cold runs build the aligned cache; without it every run
        # builds and probes a LUT per join
        if name.endswith("_cold") or "_unaligned" in name:
            if not (moved.get("lut_build") and moved.get("lut_probe")):
                raise AssertionError(f"{name}: K4/K5 did not move")
        if name == "expand" and not (moved.get("lut_order") and
                                     moved.get("join_expand")):
            raise AssertionError("expand: K6/K7 did not move (the join "
                                 "did not run in expand mode)")
        if name == "blocked" and "join:over-max" not in esc:
            raise AssertionError(f"blocked: no row-range passes ({esc})")
    launches = ck.launches()
    walls["join_phase"] = time.perf_counter() - t_phase
    for k in JOIN_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"join path")
    log(f"join phase: {walls['join_phase']:.1f} s, launches {launches}")
    return launches, walls, orders, customer, host


# ---------------------------------------------------------------------------
# phase 8: join kernel timing
# ---------------------------------------------------------------------------


def join_timing_phase(dev, n: int, orders, customer):
    import numpy as np
    import torch
    from tidb_tpu_torch.executor.device_cache import _pow2
    from tidb_tpu_torch.ops import join as J
    out = []
    n_orders = len(orders["o_orderkey"])
    n_cust = len(customer["c_custkey"])

    def padded(a, cap, dtype=torch.int64):
        t = torch.zeros(cap, dtype=dtype)
        t[:len(a)] = torch.from_numpy(np.asarray(a))
        return t.to(dev)

    def mask(nlive, cap):
        return torch.arange(cap, device=dev) < nlive

    def max_err(what, pairs):
        """Largest |kernel - plain| over the compared tensors; raises on
        any difference (the join kernels are exact)."""
        err = max((int((a.long() - b.long()).abs().max()) if a.numel()
                   else 0) for a, b in pairs)
        if err or any(a.shape != b.shape for a, b in pairs):
            raise AssertionError(f"{what} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    # K4: the orders build of Q3/Q5's first join (the unaligned path)
    nb = _pow2(n_orders)
    bkeys = [(padded(orders["o_orderkey"], nb), mask(n_orders, nb))]
    bounds, domain = [(0, n_orders - 1)], n_orders
    blive = mask(n_orders, nb)
    ms = time_cuda(lambda: J.lut_build(bkeys, bounds, domain, live=blive))
    plain = time_cuda(lambda: J.lut_build_plain(bkeys, bounds, domain,
                                                live=blive), reps=5)
    code = torch.where(blive & bkeys[0][1], bkeys[0][0],
                       torch.full_like(bkeys[0][0], domain))
    lib = time_cuda(lambda: torch.bincount(code, minlength=domain + 1))
    cnt, lut, maxcnt, _ = J.lut_build(bkeys, bounds, domain, live=blive)
    w_cnt, w_lut, w_max, _ = J.lut_build_plain(bkeys, bounds, domain,
                                               live=blive)
    # lut is compared where a code has at most one row: a duplicated
    # code's entry is any one of its rows (check_join_kernels holds it so)
    single = w_cnt[:domain] <= 1
    err = max_err("K4 at the orders build", [
        (cnt, w_cnt), (maxcnt, w_max),
        (lut[:domain][single], w_lut[:domain][single])])
    b, by = bound_ms(nb * (8 + 1 + 1) + (domain + 1) * 8, nb * 8)
    out.append({"name": "lut_build", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/lut_join.cu",
                "replaces": "tidb_tpu/ops/join.py:93",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K4 orders build nb={nb} ({n_orders} live) D={domain}: "
        f"{ms:.4f} ms (plain {plain:.4f}, bincount {lib:.4f}, bound "
        f"{b:.4f} by {by})")

    # K5: one lineitem slab probing that build (unique mode)
    okey = np.random.default_rng(7).integers(0, n_orders, n)
    P = min(_pow2(n), 1 << 23)
    pkeys = [(padded(okey[:P], P), mask(min(n, P), P))]
    plive = mask(min(n, P), P)
    ms = time_cuda(lambda: J.lut_probe(pkeys, bounds, cnt, lut, plive, nb,
                                       True))
    plain = time_cuda(lambda: J.lut_probe_plain(pkeys, bounds, cnt, lut,
                                                plive, nb, True), reps=5)
    pc = pkeys[0][0].clamp(0, domain - 1)
    lib = time_cuda(lambda: torch.take(lut, pc))
    err = max_err("K5 at the lineitem slab", list(zip(
        J.lut_probe(pkeys, bounds, cnt, lut, plive, nb, True),
        J.lut_probe_plain(pkeys, bounds, cnt, lut, plive, nb, True))))
    b, by = bound_ms(P * (8 + 1 + 1) + (domain + 1) * 8 + P * (4 + 1),
                     P * 8)
    out.append({"name": "lut_probe", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/lut_join.cu",
                "replaces": "tidb_tpu/ops/join.py:93",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K5 lineitem slab P={P} into D={domain}: {ms:.4f} ms (plain "
        f"{plain:.4f}, take {lib:.4f}, bound {b:.4f} by {by})")

    # K6: the expand statement's build — orders filtered on o_orderdate,
    # keyed on o_custkey
    okeep = orders["o_orderdate"] < EXPAND_DAY
    ekeys = [(padded(orders["o_custkey"], nb), mask(n_orders, nb))]
    elive = padded(okeep, nb, torch.bool)
    ebounds, edom = [(0, n_cust - 1)], n_cust
    ecnt, _, _, ecodes = J.lut_build(ekeys, ebounds, edom, live=elive,
                                     want_lut=False, want_codes=True)
    ms = time_cuda(lambda: J.lut_order(ecodes, ecnt))
    plain = time_cuda(lambda: J.lut_order_plain(ecodes, ecnt), reps=5)
    lib = time_cuda(lambda: torch.argsort(ecodes, stable=True))
    s1, o1 = J.lut_order(ecodes, ecnt)
    s2, o2 = J.lut_order_plain(ecodes, ecnt)
    err = max_err("K6 at the expand build", [(s1, s2), (o1, o2)])
    b, by = bound_ms(nb * 4 * 2 + (edom + 1) * 4 * 2, nb * 4)
    out.append({"name": "lut_order", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/join_expand.cu",
                "replaces": "tidb_tpu/ops/join.py:114",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K6 expand build nb={nb} ({int(okeep.sum())} live) D={edom}: "
        f"{ms:.4f} ms (plain {plain:.4f}, argsort {lib:.4f}, bound "
        f"{b:.4f} by {by})")

    # K7: its probe — every customer row
    Pc = _pow2(n_cust)
    ckeys = [(padded(customer["c_custkey"], Pc), mask(n_cust, Pc))]
    clive = mask(n_cust, Pc)
    start, count = J.lut_probe(ckeys, ebounds, ecnt, s1, clive, nb, False)
    total = int(count.sum())
    out_cap = _pow2(total)
    ms = time_cuda(lambda: J.expand(start, count, o1, out_cap, False,
                                         clive))
    plain = time_cuda(lambda: J.expand_plain(start, count, o1, out_cap,
                                             False, clive), reps=5)
    ar = torch.arange(Pc, device=dev)
    lib = time_cuda(lambda: torch.repeat_interleave(ar, count,
                                                    output_size=total))
    got = J.expand(start, count, o1, out_cap, False, clive)
    want = J.expand_plain(start, count, o1, out_cap, False, clive)
    live = want[3]
    err = max_err("K7 at the expand probe", [
        (got[5], want[5]), (got[3], live)] + [
        (a[live], b_[live]) for a, b_ in zip(got[:3] + got[4:5],
                                            want[:3] + want[4:5])])
    # bytes: start, count and live per probe row in, one gather of `order`
    # per filled slot, and the five slot outputs plus total out
    b, by = bound_ms(Pc * (4 + 4 + 1) + min(total, out_cap) * 4 +
                     out_cap * 14 + 8, out_cap * 24)
    out.append({"name": "join_expand", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/join_expand.cu",
                "replaces": "tidb_tpu/ops/join.py:192",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K7 expand probe P={Pc} total={total} out_cap={out_cap}: "
        f"{ms:.4f} ms (plain {plain:.4f}, repeat_interleave {lib:.4f}, "
        f"bound {b:.4f} by {by})")
    return out


# ---------------------------------------------------------------------------
# phase 3 (sort): K8-K11 against their plain versions
# ---------------------------------------------------------------------------


def _values(rng, kind, n):
    """Sort-key values of one kind: float64 with ±0.0, ±inf and NaN,
    full-range int32 / int64, bool, dictionary codes."""
    import numpy as np
    if kind == "f64":
        v = np.round(rng.normal(size=n), 2)
        pick = rng.random(n) < 0.3
        v[pick] = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan]),
                             int(pick.sum()))
        return v
    if kind == "i32":
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    if kind == "i64":
        return rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    if kind == "bool":
        return rng.random(n) > 0.5
    return rng.integers(0, 9, n).astype(np.int32)             # dict codes


def _words(rng, kind, n):
    """K8 input words (uint64 bit patterns in int64) and their bit range."""
    import numpy as np
    full = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    if kind == "full":
        return full, 64
    if kind == "narrow":
        return full & ((1 << 21) - 1), 21
    if kind == "equal":
        return np.full(n, 12345, dtype=np.int64), 14
    if kind == "sorted":
        return np.sort(full & ((1 << 40) - 1)), 40
    if kind == "reversed":
        return np.sort(full & ((1 << 40) - 1))[::-1].copy(), 40
    return full & 1, 1                                        # "bit"


def check_sort_kernels(dev):
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import join as J
    rng = np.random.default_rng(23)
    cases = 0

    def same(what, got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                a = a.cpu()
            if isinstance(b, torch.Tensor):
                b = b.cpu()
            if not torch.equal(torch.as_tensor(a), torch.as_tensor(b)):
                raise AssertionError(f"{what}: kernel != plain")

    for n in (1, 1000, 4097, 1_000_003):
        perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        # K8: full-range, narrow, all-equal, sorted and reversed keys, and
        # a 1-bit partition; row ids from the kernel (None) and given
        for kind in ("full", "narrow", "equal", "sorted", "reversed", "bit"):
            w, bits = _words(rng, kind, n)
            w = torch.from_numpy(w).to(dev)
            for vals in (None, perm):
                same(f"K8 {kind} n={n}", F.radix_sort(w, vals, bits),
                     F.radix_sort_plain(w, vals, bits))
                cases += 1
        # K9: every operand type, ASC and DESC, NULL slots, through a
        # permutation, stats and a shifted OR into a word
        m = torch.from_numpy(rng.random(n) > 0.15).to(dev)
        for kind in ("f64", "i32", "i64", "bool", "code"):
            v, code = F._k9_operand(torch.from_numpy(
                np.asarray(_values(rng, kind, n))).to(dev))
            for desc in (False, True):
                st = torch.tensor([-1, 0], dtype=torch.int64, device=dev)
                F.sort_encode(v, code, None, m, desc, 0, 0, stats=st)
                _, (lo, hi) = F.sort_encode_plain(v, code, None, m, desc, 0,
                                                  0)
                if [x & ((1 << 64) - 1) for x in st.tolist()] != [lo, hi]:
                    raise AssertionError(f"K9 stats {kind} desc={desc}")
                base = torch.full((n,), 3, dtype=torch.int64, device=dev)
                got = F.sort_encode(v, code, perm, m, desc, lo, 2,
                                    base.clone(), accumulate=True)
                want, _ = F.sort_encode_plain(v, code, perm, m, desc, lo, 2,
                                              base, accumulate=True)
                same(f"K9 {kind} desc={desc} n={n}", got, want)
                cases += 1
        # K10 over the kernel's own sort: factorize (cap above and below
        # the group count) and _dense1 modes, with NULLs and dead rows
        live = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        for kind in ("f64", "i64", "code"):
            v = torch.from_numpy(np.asarray(_values(rng, kind, n))).to(dev)
            if kind == "i64":
                v = v % 997
            sidx = F.lexsort(F._key_operands([(v, m)], live))
            for cap in (0, 5, n + 1):
                same(f"K10 {kind} cap={cap} n={n}",
                     F.group_ids(sidx, v, m, live, cap),
                     F.group_ids_plain(sidx, v, m, live, cap))
                cases += 1
        # the functions over K8-K10 against the same functions on CPU
        # copies of the inputs (the plain versions): 1-3 key columns
        if n != 1000:
            for spec in (["f64"], ["i32"], ["bool"], ["code", "i64"],
                         ["i64", "f64", "bool"]):
                keys = [(torch.from_numpy(np.asarray(_values(rng, k, n))),
                         torch.from_numpy(rng.random(n) > 0.1))
                        for k in spec]
                hl = torch.from_numpy(rng.random(n) > 0.2)
                dk = [(v.to(dev), mm.to(dev)) for v, mm in keys]
                dl = hl.to(dev)
                for cap in (4, n + 1):
                    same(f"factorize {spec} cap={cap} n={n}",
                         F.factorize(dk, dl, cap), F.factorize(keys, hl, cap))
                descs = [i % 2 == 1 for i in range(len(spec))]
                for ds in (descs, [not d for d in descs]):
                    same(f"sort_perm {spec} {ds} n={n}",
                         F.sort_perm(dk, ds, dl), F.sort_perm(keys, ds, hl))
                    same(f"topn {spec} {ds} n={n}", F.topn(dk, ds, dl, 10),
                         F.topn(keys, ds, hl, 10))
                same(f"pack_codes {spec} n={n}", F.pack_codes(dk, dl),
                     F.pack_codes(keys, hl))
                cases += 5
    # K11: duplicated and unique builds, missing probe keys, sentinel
    # (dead / NULL) build rows, nb = 1 and P = 0
    for nb, P, dup in ((1, 50, False), (1, 0, False), (5000, 0, True),
                       (200_000, 1_000_003, False),
                       (200_000, 1_000_003, True)):
        pool = np.sort(rng.choice(1 << 40, max(nb, 2), replace=False))
        bc = pool[rng.integers(0, max(nb // 3, 1), nb)] if dup else pool[:nb]
        codes = torch.from_numpy(rng.permutation(bc)).to(dev)
        ok_b = torch.from_numpy(rng.random(nb) > 0.1).to(dev)
        probe = torch.from_numpy(np.where(
            rng.random(P) < 0.7, pool[rng.integers(0, len(pool), P)],
            rng.integers(0, 1 << 40, P))).to(dev)
        ok_p = torch.from_numpy(rng.random(P) > 0.1).to(dev)
        sc, order = J.sorted_build(codes, ok_b)
        same(f"K8+K9 build nb={nb}", (sc, order),
             J.sorted_build(codes.cpu(), ok_b.cpu()))
        same(f"K11 unique nb={nb} P={P} dup={dup}",
             J.sorted_search_unique(sc, order, probe, ok_p),
             J.sorted_search_unique_plain(sc, order, probe, ok_p))
        same(f"K11 multi nb={nb} P={P} dup={dup}",
             J.sorted_search_multi(sc, probe, ok_p),
             J.sorted_search_multi_plain(sc, probe, ok_p))
        table = torch.from_numpy(pool).to(dev)
        for right in (False, True):
            same(f"K11 search right={right}",
                 J.searchsorted(table, probe, right),
                 torch.searchsorted(table, probe, right=right))
        cases += 5
    torch.cuda.synchronize()
    log(f"K8-K11 radix_sort/sort_encode/group_ids/sorted_search: {cases} "
        f"cases exactly equal to the plain versions (n = 1, 1000, 4097, "
        f"1,000,003; int32/int64/float64 with ±0.0, ±inf, NaN/bool/dict "
        f"codes; ASC/DESC, NULLs, dead rows; all-equal, sorted, reversed "
        f"keys; a 1-bit partition; 1-3 key columns through factorize/"
        f"sort_perm/topn/pack_codes; cap below n_groups; K11 with "
        f"duplicates, missing keys, sentinels, nb = 1, P = 0)")


# ---------------------------------------------------------------------------
# phase 3 (windows): K12-K15 against their plain versions
# ---------------------------------------------------------------------------


def _window_layout(rng, n: int, big: int):
    """Window test rows: a partition key (int64) whose first `big` rows
    form one partition and the rest partitions of 1 to 50 rows (single
    rows among them), shuffled, with 5% dead rows; ORDER BY key columns
    of each kind with 10% NULLs: int32 dates with ties, float64 with
    ±0.0 and NaN, int64 scaled DECIMALs."""
    import numpy as np
    sizes = [big]
    while sum(sizes) < n:
        sizes.append(int(rng.choice([1, 1, 2, 7, 30, 50])))
    sizes[-1] -= sum(sizes) - n
    pid = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    order = rng.permutation(n)
    f64 = np.round(rng.normal(size=n) * 100, 1)
    pick = rng.random(n) < 0.05
    f64[pick] = rng.choice(np.array([0.0, -0.0, np.nan]), int(pick.sum()))
    cols = {"pid": pid[order],
            "i32": rng.integers(8036, 10590, n).astype(np.int32),
            "f64": f64,
            "dec": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)}
    masks = {k: rng.random(n) > 0.1 for k in ("i32", "f64", "dec")}
    return cols, masks, rng.random(n) > 0.05


def _same_nan(a, b) -> bool:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def check_window_kernels(dev):
    """K12-K15 against their plain versions on the card → the largest
    float64 prefix error seen (every other result exactly equal)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    rng = np.random.default_rng(31)
    cases = 0
    f64_err = 0.0

    def same(what, got, want):
        nonlocal cases
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if a is None and b is None:
                continue
            if not _same_nan(a, b):
                raise AssertionError(f"{what}: kernel != plain")
        cases += 1

    for n, big in ((1, 1), (5000, 100), (2_000_000, 1_000_000)):
        cols, masks, live = _window_layout(rng, n, big)
        t = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        tm = {k: torch.from_numpy(v).to(dev) for k, v in masks.items()}
        tl = torch.from_numpy(live).to(dev)
        pkey = (t["pid"], torch.ones_like(tl))
        for okind, desc in (("i32", False), ("i32", True), ("f64", False),
                            ("dec", True), (None, False)):
            okeys = [] if okind is None else [(t[okind], tm[okind])]
            perm, _ = F.sort_perm([pkey] + okeys, [False, desc][:1 +
                                                                 len(okeys)],
                                  tl)
            keys = [pkey] + okeys
            tag = f"n={n} order={okind} desc={desc}"
            # K12: flags (int64 and int32 permutations), positions
            flags = W.window_flags(perm, tl, keys, 1)
            same(f"K12 flags {tag}", flags,
                 W.window_flags_plain(perm, tl, keys, 1))
            same(f"K12 flags int32 perm {tag}",
                 W.window_flags(perm.to(torch.int32), tl, keys, 1), flags)
            ps, qs = flags
            pos = W.window_positions(ps, qs)
            same(f"K12 positions {tag}", pos,
                 W.window_positions_plain(ps, qs))
            # K13: prefixes of DECIMAL / int32 / float64 values, count only;
            # segmented min/max forward and backward
            valid = tm["dec"][perm] & tl[perm]
            for vk in ("dec", "i32", "f64"):
                v = t[vk][perm]
                got = W.window_prefix(v, valid)
                want = W.window_prefix_plain(v, valid)
                same(f"K13 count {vk} {tag}", got[1], want[1])
                if vk == "f64":
                    x = torch.where(valid & ~torch.isnan(v), v.abs(),
                                    torch.zeros_like(v))
                    idx = torch.arange(n, dtype=torch.float64, device=dev)
                    bound = 2 * idx * EPS64 * torch.cumsum(x, 0)
                    d = (got[0] - want[0]).abs()
                    fin = torch.isfinite(want[0])
                    if not bool((d[fin] <= bound[fin] + 1e-300).all()) or \
                            not _same_nan(got[0][~fin], want[0][~fin]):
                        raise AssertionError(f"K13 f64 prefix {tag}: "
                                             f"outside its bound")
                    f64_err = max(f64_err, float(d[fin].max()) if n else 0.0)
                else:
                    same(f"K13 prefix {vk} {tag}", got[0], want[0])
                for is_max in (False, True):
                    for rev in (False, True):
                        same(f"K13 segscan {vk} max={is_max} rev={rev} "
                             f"{tag}",
                             W.window_segscan(v, valid, ps, is_max, rev),
                             W.window_segscan_plain(v, valid, ps, is_max,
                                                    rev))
            same(f"K13 count only {tag}", W.window_prefix(None, valid),
                 W.window_prefix_plain(None, valid))
            # K14: ROWS frames, bounded and unbounded sides; RANGE frames
            # over this layout's ORDER BY key
            rows_frames = [(None, None), (3, 3), (None, 2), (5, None),
                           (-2, 3), (1, -1), (0, 0), (100, 100)]
            bounds = {}
            for pre, post in rows_frames:
                lh = W.frame_bounds(pos, pre, post)
                same(f"K14 rows {pre},{post} {tag}", lh,
                     W.frame_bounds_plain(pos, pre, post))
                bounds[("rows", pre, post)] = lh
            if okind is not None:
                rk = (t[okind][perm], (tm[okind] & tl)[perm], desc)
                offs = (6, 0) if okind != "f64" else (2.5, 0.5)
                for pre, post in ((offs[0], offs[1]), (None, 3), (2, None),
                                  (0, 0), (-1, 5)):
                    lh = W.frame_bounds(pos, pre, post, rk)
                    same(f"K14 range {pre},{post} {tag}", lh,
                         W.frame_bounds_plain(pos, pre, post, rk))
                    bounds[("range", pre, post)] = lh
            # K15: the rank family; COUNT/SUM/AVG over every frame; the
            # gathers; bounded MIN/MAX direct and through the sparse table
            for name in ("row_number", "rank", "dense_rank", "percent_rank",
                         "cume_dist", "ntile"):
                for b in ((4, 1000) if name == "ntile" else (1,)):
                    same(f"K15 {name}({b}) {tag}", W.frame_rank(name, pos, b),
                         W.frame_rank_plain(name, pos, b))
            v = t["dec"][perm]
            cum, ccnt = W.window_prefix(v, valid)
            fcum, _ = W.window_prefix(t["f64"][perm], valid)
            for fr, (lo, hi) in bounds.items():
                for what, c in (("count", None), ("sum", cum), ("avg", cum),
                                ("sum", fcum), ("nonempty", None)):
                    same(f"K15 {what} {fr} {tag}",
                         W.frame_agg(what, c, ccnt, lo, hi),
                         W.frame_agg_plain(what, c, ccnt, lo, hi))
                same(f"K15 first {fr} {tag}",
                     W.frame_gather(v, valid, lo, 0, None, hi),
                     W.frame_gather_plain(v, valid, lo, 0, None, hi))
                same(f"K15 nth(3) {fr} {tag}",
                     W.frame_gather(t["f64"][perm], valid, lo, 2, None, hi),
                     W.frame_gather_plain(t["f64"][perm], valid, lo, 2,
                                          None, hi))
                same(f"K15 last {fr} {tag}",
                     W.frame_gather(t["i32"][perm], valid, hi, 0, lo, None),
                     W.frame_gather_plain(t["i32"][perm], valid, hi, 0, lo,
                                          None))
                if fr[0] == "rows" and fr[1] is not None and \
                        fr[2] is not None:
                    width = fr[1] + fr[2] + 1
                    for vk in ("dec", "f64", "i32"):
                        for is_max in (False, True):
                            same(f"K15 minmax {vk} {fr} {tag}",
                                 W.frame_minmax(t[vk][perm], valid, is_max,
                                                lo, hi, width),
                                 W.frame_minmax_plain(t[vk][perm], valid,
                                                      is_max, lo, hi, width))
            fills = [None, (torch.tensor(7, device=dev),
                            torch.tensor(True, device=dev)),
                     (t["dec"][perm], valid)]
            for off in (1, 3, 0, -2):
                for fill in fills:
                    lim = (pos.ppos, None) if off > 0 else (None, pos.plast)
                    same(f"K15 shift {off} {tag}",
                         W.frame_gather(v, valid, None, -off, *lim, fill),
                         W.frame_gather_plain(v, valid, None, -off, *lim,
                                              fill))
            same(f"K15 bool gather {tag}",
                 W.frame_gather(tl[perm], valid, pos.ppos, 0, None, None),
                 W.frame_gather_plain(tl[perm], valid, pos.ppos, 0, None,
                                      None))
    torch.cuda.synchronize()
    log(f"K12-K15 window_bounds/window_scan/frame_bounds/frame_eval: "
        f"{cases} cases equal to the plain versions (n = 1, 5,000, "
        f"2,000,000 with one 10^6-row partition and 1-50-row ones; int32 / "
        f"float64 (±0.0, NaN) / DECIMAL ORDER BY keys ASC and DESC with "
        f"NULLs, dead rows, int32 and int64 permutations; ROWS and RANGE "
        f"frames with unbounded sides; bounded MIN/MAX direct and through "
        f"the sparse table); float64 prefixes within 2·i·eps·Σ|x|, "
        f"largest error {f64_err:.3e}, every other result exact")
    return f64_err


# ---------------------------------------------------------------------------
# phase 9: the sort formulation in SQL
# ---------------------------------------------------------------------------


def sparse_key(k):
    """The injective map k -> k * 0x9E3779B97F4A7C15 mod 2^62 (an odd
    multiplier is a bijection mod 2^62)."""
    import numpy as np
    k = np.asarray(k).astype(np.uint64)
    return ((k * np.uint64(0x9E3779B97F4A7C15)) &
            np.uint64((1 << 62) - 1)).astype(np.int64)


def fragment_roots(s, sql):
    """Class names of the device fragments' root operators in the plan."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import PhysTpuFragment
    s.vars["tidb_tpu_engine"] = "on"
    plan = s._plan(parse(sql)[0])
    out = []

    def walk(p):
        if isinstance(p, PhysTpuFragment):
            out.append(type(p.root).__name__)
            return
        for c in p.children:
            walk(c)

    walk(plan)
    return out


def sort_sql_phase(s, n: int, orders, dense_q3_host):
    from collections import Counter

    import numpy as np
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.testing import load_numpy_columns
    t0 = time.perf_counter()
    li = make_lineitem(n)
    s.execute("CREATE TABLE orders_sk (o_okey BIGINT, o_orderdate DATE, "
              "o_orderpriority CHAR(1))")
    s.execute("CREATE TABLE lineitem_sk (l_extendedprice DECIMAL(15,2), "
              "l_discount DECIMAL(15,2), l_shipdate DATE, l_okey BIGINT)")
    orders_sk = {"o_okey": sparse_key(orders["o_orderkey"]),
                 "o_orderdate": orders["o_orderdate"],
                 "o_orderpriority": orders["o_orderpriority"]}
    lineitem_sk = {c: li[c] for c in ("l_extendedprice", "l_discount",
                                      "l_shipdate")}
    lineitem_sk["l_okey"] = sparse_key(li["l_orderkey"])
    for name, cols in (("orders_sk", orders_sk),
                       ("lineitem_sk", lineitem_sk)):
        load_numpy_columns(s, name, cols)
        s.execute(f"ANALYZE TABLE {name}")
    log(f"orders_sk {len(orders_sk['o_okey'])} rows, lineitem_sk "
        f"{len(lineitem_sk['l_okey'])} rows (62-bit keys): generated, "
        f"loaded and analyzed in {time.perf_counter() - t0:.1f} s")
    for sql, want in ((TOPN_JOIN, "PhysTopN"), (LIMIT_JOIN, "PhysLimit")):
        roots = fragment_roots(s, sql)
        explain = s.query("EXPLAIN " + sql).rows
        if roots != [want] or "TpuFragment" not in explain[0][0]:
            raise AssertionError(f"{want} is not inside the device "
                                 f"fragment: {roots}\n{explain[:3]}")
    log("EXPLAIN: TopN and Limit over the join are the device fragment's "
        "root")
    host = {}
    walls = {}
    for name, sql in (("tpch_q3", TPCH_Q3), ("topn_join", TOPN_JOIN),
                      ("join_rows", JOIN_ROWS), ("q3_sk", Q3_SK)):
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = rows
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    if host["q3_sk"] != dense_q3_host:
        raise AssertionError("host engine: sparse-key Q3 != dense Q3")
    runs = [("tpch_q3_cold", TPCH_Q3, "tpch_q3"),
            ("tpch_q3_warm1", TPCH_Q3, "tpch_q3"),
            ("tpch_q3_warm2", TPCH_Q3, "tpch_q3"),
            ("topn_join", TOPN_JOIN, "topn_join"),
            ("limit_join", LIMIT_JOIN, None),
            ("q3_sk_cold", Q3_SK, "q3_sk"), ("q3_sk_warm", Q3_SK, "q3_sk")]
    t_phase = time.perf_counter()
    ck.reset_launches()
    for name, sql, ref in runs:
        before = ck.launches()
        rows, wall, phases, esc = run_sql(s, sql, device=True)
        after = ck.launches()
        moved = {k: after[k] - before[k] for k in after if after[k] !=
                 before[k]}
        if ref is not None and rows != host[ref]:
            raise AssertionError(f"{name}: device rows != host rows\n"
                                 f"{rows[:3]}\n{host[ref][:3]}")
        if ref is None:
            # an unordered LIMIT may pick other rows than the host's: its
            # count, and membership in the host's unlimited join
            total = len(host["join_rows"])
            extra = Counter(map(tuple, rows)) - \
                Counter(map(tuple, host["join_rows"]))
            if len(rows) != min(100, total) or extra:
                raise AssertionError(f"{name}: {len(rows)} rows of "
                                     f"min(100, {total}); {len(extra)} not "
                                     f"in the host's join")
        if name.startswith("q3_sk"):
            if rows != dense_q3_host:
                raise AssertionError(f"{name}: != the dense Q3's rows")
            if moved.get("lut_build") or moved.get("lut_probe") or \
                    not moved.get("sorted_search"):
                raise AssertionError(f"{name}: not the sort formulation "
                                     f"({moved})")
        walls[name] = wall
        log(f"{name}: {len(rows)} rows, "
            f"{'count + membership' if ref is None else 'exact match'}, "
            f"wall {wall:.4f} s, launches {moved}, escalation {esc}, "
            f"phases {phases}")
    launches = ck.launches()
    walls["sort_phase"] = time.perf_counter() - t_phase
    for k in SORT_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"sort path")
    log(f"sort phase: {walls['sort_phase']:.1f} s, launches {launches}")
    sparse = (np.concatenate([orders_sk["o_okey"],
                              lineitem_sk["l_okey"]]),
              len(orders_sk["o_okey"]), len(lineitem_sk["l_okey"]))
    return launches, walls, sparse


# ---------------------------------------------------------------------------
# phase 10: sort kernel timing
# ---------------------------------------------------------------------------


def sort_timing_phase(dev, sparse):
    import numpy as np
    import torch
    from tidb_tpu_torch.executor.device_cache import _pow2
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import join as J
    rng = np.random.default_rng(29)
    out = []
    n = 8_388_608

    def exact(what, pairs):
        for a, b in pairs:
            if not torch.equal(a, b):
                raise AssertionError(f"{what} differs from its plain "
                                     f"version")
        return 0

    # K8: a lineitem slab of full-range int64 keys, all 64 bits (8 passes)
    keys = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                         dtype=np.int64)).to(dev)
    ms = time_cuda(lambda: F.radix_sort(keys, None, 64), reps=10)
    plain = time_cuda(lambda: F.radix_sort_plain(keys, None, 64), reps=5)
    lib = time_cuda(lambda: torch.sort(keys, stable=True), reps=10)
    err = exact("K8 full-range", zip(F.radix_sort(keys, None, 64),
                                     F.radix_sort_plain(keys, None, 64)))
    b, by = bound_ms(n * (8 + 4), n * 8)
    out.append({"name": "radix_sort", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/radix_sort.cu",
                "replaces": "tidb_tpu/ops/factorize.py:96",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K8 n={n} full-range int64 (8 passes): {ms:.4f} ms (plain "
        f"{plain:.4f}, torch.sort(stable) {lib:.4f}, bound {b:.4f} by {by})")

    # K8 on the sparse join's word: orders_sk's build rows (a 2,097,152-row
    # capacity) ++ one lineitem_sk slab (8,388,608), as combine_keys sorts
    # them: the dead flag, the NULL flag and the 62-bit key in one word
    okeys, n_o, n_l = sparse
    nb, P = _pow2(n_o), min(_pow2(n_l), 1 << 23)
    v = torch.zeros(nb + P, dtype=torch.int64)
    v[:n_o] = torch.from_numpy(okeys[:n_o])
    v[nb:nb + min(n_l, P)] = torch.from_numpy(okeys[n_o:n_o + min(n_l, P)])
    live = torch.zeros(nb + P, dtype=torch.bool)
    live[:n_o] = True
    live[nb:nb + min(n_l, P)] = True
    v, live = v.to(dev), live.to(dev)
    valid = torch.ones_like(live)
    words = []
    for op in reversed(F._key_operands([(v, valid)], live)):
        vv, code = F._k9_operand(op.v)
        words.append((op, vv, code) + F._field(op, vv, code, nb + P))
    word = torch.empty(nb + P, dtype=torch.int64, device=dev)
    shift = 0
    for j, (op, vv, code, base, width) in enumerate(words):
        F.sort_encode(vv, code, None, op.m, op.desc, base, shift, word,
                      accumulate=j > 0)
        shift += width
    ms2 = time_cuda(lambda: F.radix_sort(word, None, shift), reps=10)
    plain2 = time_cuda(lambda: F.radix_sort_plain(word, None, shift),
                       reps=5)
    lib2 = time_cuda(lambda: torch.sort(word, stable=True), reps=10)
    exact("K8 sparse-join word", zip(F.radix_sort(word, None, shift),
                                     F.radix_sort_plain(word, None, shift)))
    b2, _ = bound_ms((nb + P) * (8 + 4), (nb + P) * 8)
    log(f"K8 sparse join N={nb + P} ({shift} bits): {ms2:.4f} ms (plain "
        f"{plain2:.4f}, torch.sort(stable) {lib2:.4f}, bound {b2:.4f})")

    # K9: 8,388,608 float64 and int64 values with NULL slots
    m = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    f64 = torch.from_numpy(rng.normal(size=n)).to(dev)
    i64 = keys
    dst = torch.empty(n, dtype=torch.int64, device=dev)
    timed = {}
    for name, vals, code in (("float64", f64, 3), ("int64", i64, 2)):
        timed[name] = (
            time_cuda(lambda: F.sort_encode(vals, code, None, m, False, 0, 0,
                                            dst), reps=10),
            time_cuda(lambda: F.sort_encode_plain(vals, code, None, m, False,
                                                  0, 0), reps=5))
        F.sort_encode(vals, code, None, m, False, 0, 0, dst)
        exact(f"K9 {name}", [(dst, F.sort_encode_plain(
            vals, code, None, m, False, 0, 0)[0])])
    b, by = bound_ms(n * (8 + 1 + 8), n * 4)
    out.append({"name": "sort_encode", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/radix_sort.cu",
                "replaces": "tidb_tpu/ops/factorize.py:43",
                "max_abs_err": 0, "ms": timed["float64"][0],
                "plain_ms": timed["float64"][1], "bound_ms": b,
                "bound_by": by, "library_ms": None})
    log(f"K9 n={n} float64: {timed['float64'][0]:.4f} ms (plain "
        f"{timed['float64'][1]:.4f}); int64: {timed['int64'][0]:.4f} ms "
        f"(plain {timed['int64'][1]:.4f}); bound {b:.4f} by {by}")

    # K10: 8,388,608 rows in ~10^5 groups, over the kernel's own sort
    gk = torch.from_numpy(rng.integers(0, 100_000, n)).to(dev)
    glive = torch.from_numpy(rng.random(n) > 0.02).to(dev)
    sidx = F.lexsort(F._key_operands([(gk, None)], glive))
    cap = 131_072
    ms = time_cuda(lambda: F.group_ids(sidx, gk, None, glive, cap),
                   reps=10)
    plain = time_cuda(lambda: F.group_ids_plain(sidx, gk, None, glive, cap),
                      reps=5)
    sorted_keys = gk[sidx.long()]
    lib = time_cuda(lambda: torch.unique_consecutive(sorted_keys,
                                                     return_inverse=True),
                    reps=10)
    got = F.group_ids(sidx, gk, None, glive, cap)
    want = F.group_ids_plain(sidx, gk, None, glive, cap)
    exact("K10", zip(got, want))
    b, by = bound_ms(n * (4 + 8 + 1 + 4) + cap * 4, n * 4)
    out.append({"name": "group_ids", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/sorted_groups.cu",
                "replaces": "tidb_tpu/ops/factorize.py:96",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K10 n={n} groups={int(got[1])} cap={cap}: {ms:.4f} ms (plain "
        f"{plain:.4f}, unique_consecutive {lib:.4f}, bound {b:.4f} by {by})")

    # K11: 2,097,152 sorted build codes, 8,388,608 probes (unique mode)
    nb = 2_097_152
    sc = torch.from_numpy(np.sort(rng.choice(1 << 40, nb,
                                             replace=False))).to(dev)
    order = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(dev)
    pool = sc.cpu().numpy()
    probe = torch.from_numpy(np.where(
        rng.random(n) < 0.8, pool[rng.integers(0, nb, n)],
        rng.integers(0, 1 << 40, n))).to(dev)
    ok = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    ms = time_cuda(lambda: J.sorted_search_unique(sc, order, probe, ok),
                   reps=10)
    plain = time_cuda(lambda: J.sorted_search_unique_plain(sc, order, probe,
                                                           ok), reps=5)
    lib = time_cuda(lambda: torch.searchsorted(sc, probe), reps=10)
    exact("K11", zip(J.sorted_search_unique(sc, order, probe, ok),
                     J.sorted_search_unique_plain(sc, order, probe, ok)))
    b, by = bound_ms(n * (8 + 1) + n * (4 + 1), n * 2 * 21)
    out.append({"name": "sorted_search", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/sorted_groups.cu",
                "replaces": "tidb_tpu/ops/join.py:139",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K11 nb={nb} P={n} unique: {ms:.4f} ms (plain {plain:.4f}, "
        f"searchsorted {lib:.4f}, bound {b:.4f} by {by})")
    return out


# ---------------------------------------------------------------------------
# phase 11: window functions in SQL
# ---------------------------------------------------------------------------

# W1: a chain window root over a filtered scan (about 6% live): many small
# partitions, every rank function, a running SUM with ties, LAG,
# FIRST_VALUE, NTILE and CUME_DIST
W1 = """SELECT l_orderkey, l_shipdate, l_extendedprice,
 ROW_NUMBER() OVER (PARTITION BY l_orderkey
                    ORDER BY l_shipdate, l_extendedprice),
 RANK() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 DENSE_RANK() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 SUM(l_extendedprice) OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 LAG(l_extendedprice) OVER (PARTITION BY l_orderkey
                            ORDER BY l_shipdate, l_extendedprice),
 FIRST_VALUE(l_extendedprice) OVER (PARTITION BY l_orderkey
                                    ORDER BY l_shipdate, l_extendedprice),
 NTILE(4) OVER (PARTITION BY l_orderkey ORDER BY l_shipdate, l_extendedprice),
 CUME_DIST() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate)
 FROM lineitem WHERE l_shipdate >= '1998-08-01'"""

# W2: top-k per group, an interior window over the whole table (6
# partitions of about 1M rows, 60 rows out)
W2 = """SELECT * FROM (SELECT l_returnflag, l_linestatus, l_orderkey,
 l_extendedprice, ROW_NUMBER() OVER (PARTITION BY l_returnflag,
 l_linestatus ORDER BY l_extendedprice DESC, l_orderkey) AS rn
 FROM lineitem) t WHERE rn <= 10"""

# W3: moving-window frames under an outer aggregate: a RANGE frame over the
# DATE key (the repaired sentinel) and a bounded ROWS MAX
W3 = """SELECT l_returnflag, l_linestatus, SUM(s), MAX(m), COUNT(*)
 FROM (SELECT l_returnflag, l_linestatus,
 SUM(l_quantity) OVER (PARTITION BY l_returnflag, l_linestatus
   ORDER BY l_shipdate RANGE BETWEEN 6 PRECEDING AND CURRENT ROW) AS s,
 MAX(l_extendedprice) OVER (PARTITION BY l_returnflag, l_linestatus
   ORDER BY l_shipdate ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS m
 FROM lineitem) t GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""

# W4: a window over a join — each BUILDING customer's latest order
W4 = """SELECT * FROM (SELECT c_custkey, o_orderkey, o_orderdate,
 RANK() OVER (PARTITION BY o_custkey ORDER BY o_orderdate DESC,
 o_orderkey) AS rk FROM customer JOIN orders ON c_custkey = o_custkey
 WHERE c_mktsegment = 'BUILDING') t WHERE rk = 1"""

# W6: a window over a host operator (the grouped rows of a device
# aggregate): WindowExec's device path
W6 = """SELECT l_orderkey, l_returnflag, rev,
 RANK() OVER (PARTITION BY l_returnflag ORDER BY rev DESC) AS rk,
 SUM(n) OVER (PARTITION BY l_returnflag ORDER BY rev DESC, l_orderkey
   ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS n3,
 COUNT(*) OVER (PARTITION BY l_returnflag ORDER BY n
   RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS near
 FROM (SELECT l_orderkey, l_returnflag, SUM(l_extendedprice) AS rev,
 COUNT(*) AS n
 FROM lineitem WHERE l_shipdate >= '1998-01-01'
 GROUP BY l_orderkey, l_returnflag) t"""

WINDOW_KERNELS = ("window_bounds", "window_scan", "frame_bounds",
                  "frame_eval")


def run_cols(s, sql, device: bool, max_slab=None):
    """→ (columns [(values, valid)], wall seconds, phases dict) — run_sql
    with the result kept as numpy columns (a large result compares as
    arrays, not as Python tuples)."""
    import numpy as np
    from tidb_tpu_torch.chunk import Chunk
    chunks, wall, ctx = _run_plan(s, sql, device, max_slab)
    if not chunks:
        return [], wall, ctx.phases.as_dict()
    ch = Chunk.concat(chunks) if len(chunks) > 1 else chunks[0]
    cols = [(np.asarray(c.values), np.asarray(c.valid_mask(), dtype=bool))
            for c in ch.columns]
    return cols, wall, ctx.phases.as_dict()


def _canonical(cols):
    """The rows of numpy columns [(values, valid)] in one canonical order
    (a lexsort over every column, NULL flag first): two results holding
    the same rows in other orders come out equal."""
    import numpy as np
    keys = []
    for v, m in cols:
        if v.dtype == object:
            v = np.unique(np.asarray([str(x) for x in v], dtype=object),
                          return_inverse=True)[1]
        keys += [np.where(m, v, np.zeros((), dtype=v.dtype)), m]
    order = np.lexsort(keys[::-1])
    return [(v[order], m[order]) for v, m in cols]


def same_cols(what, got, want, ordered: bool = False) -> float:
    """Hold device columns against the host engine's: validity exactly,
    values exactly where valid — except float columns, within
    2·n·eps·|x| of the host value (the kernels sum in another order) →
    the largest float difference seen. An unordered result that differs
    in row order is compared again in a canonical order."""
    import numpy as np
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} columns != {len(want)}")
    if not ordered:
        try:
            return same_cols(what, got, want, ordered=True)
        except AssertionError:
            got, want = _canonical(got), _canonical(want)
    err = 0.0
    for ci, ((gv, gm), (hv, hm)) in enumerate(zip(got, want)):
        if gv.shape != hv.shape or not np.array_equal(gm, hm):
            raise AssertionError(f"{what}: column {ci} rows/NULLs differ")
        gv, hv = gv[hm], hv[hm]
        if hv.dtype.kind == "f":
            d = np.abs(gv - hv)
            tol = 2 * max(len(hv), 1) * EPS64 * np.maximum(np.abs(hv), 1.0)
            if not bool(((d <= tol) | (np.isnan(gv) & np.isnan(hv))).all()):
                raise AssertionError(f"{what}: float column {ci} outside "
                                     f"its bound")
            if len(d):
                err = max(err, float(np.nanmax(d)))
        elif not np.array_equal(gv, hv):
            raise AssertionError(f"{what}: column {ci} values differ")
    return err


def window_in_fragment(s, sql):
    """(window inside a device fragment, window anywhere in the plan)."""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import PhysTpuFragment, PhysWindow
    s.vars["tidb_tpu_engine"] = "on"
    plan = s._plan(parse(sql)[0])
    found = {"in": False, "any": False}

    def walk(p, inside):
        inside = inside or isinstance(p, PhysTpuFragment)
        if isinstance(p, PhysTpuFragment):
            walk(p.root, True)
        if isinstance(p, PhysWindow):
            found["any"] = True
            found["in"] = found["in"] or inside
        for c in p.children:
            walk(c, inside)

    walk(plan, False)
    return found["in"], found["any"]


def window_sql_phase(s):
    from tidb_tpu_torch.ops import cuda_kernels as ck
    stmts = {"w1": W1, "w2": W2, "w3": W3, "w4": W4, "w6": W6}
    for name, sql in stmts.items():
        inside, anywhere = window_in_fragment(s, sql)
        explain = s.query("EXPLAIN " + sql).rows
        text = "\n".join(str(r[0]) for r in explain)
        if name == "w6":
            if inside or not anywhere:
                raise AssertionError(f"W6: the Window is not a host operator"
                                     f"\n{text}")
        elif not inside or "TpuFragment" not in text:
            raise AssertionError(f"{name}: the Window is not inside the "
                                 f"device fragment\n{text}")
    log("EXPLAIN: W1-W5's windows inside a TpuFragment, W6's Window a host "
        "operator over one")
    host = {}
    walls = {}
    for name, sql in stmts.items():
        cols, wall, _ = run_cols(s, sql, device=False)
        host[name] = cols
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(cols[0][0]) if cols else 0} rows in "
            f"{wall:.3f} s")
    runs = []
    for name in ("w1", "w2", "w3", "w4", "w5", "w6"):
        for k in ("cold", "warm1", "warm2"):
            runs.append((f"{name}_{k}", name))
    t_phase = time.perf_counter()
    ck.reset_launches()
    float_err = 0.0
    for run, name in runs:
        sql = stmts.get(name, W2)
        ref = "w2" if name == "w5" else name
        before = ck.launches()
        cols, wall, phases = run_cols(
            s, sql, device=True,
            max_slab=2_097_152 if name == "w5" else None)
        after = ck.launches()
        moved = {k: after[k] - before[k] for k in after if after[k] !=
                 before[k]}
        float_err = max(float_err, same_cols(run, cols, host[ref]))
        if name == "w6" and not all(moved.get(k) for k in WINDOW_KERNELS):
            raise AssertionError(f"{run}: WindowExec's device path did not "
                                 f"launch K12-K15 ({moved})")
        walls[run] = wall
        log(f"{run}: {len(cols[0][0]) if cols else 0} rows, equal to the "
            f"host engine, wall {wall:.4f} s, launches {moved}, phases "
            f"{phases}")
    s.vars.pop("tidb_tpu_max_slab_rows", None)
    launches = ck.launches()
    walls["window_phase"] = time.perf_counter() - t_phase
    for k in WINDOW_KERNELS + ("radix_sort", "sort_encode"):
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"window path")
    log(f"window phase: {walls['window_phase']:.1f} s, largest float "
        f"difference from the host engine {float_err:.3e}, launches "
        f"{launches}")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 12: window kernel timing
# ---------------------------------------------------------------------------


def window_timing_phase(dev, n: int, f64_err: float):
    """K12-K15 at phase 11's shapes: lineitem's columns in one
    8,388,608-row slab (make_lineitem's rows, padded as the device cache
    pads them)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    li = make_lineitem(n)
    cap = 1 << 23
    out = []

    def col(a, dtype):
        t = torch.zeros(cap, dtype=dtype)
        t[:n] = torch.from_numpy(np.asarray(a).astype(
            np.dtype(str(dtype).replace("torch.", ""))))
        return t.to(dev)

    rows = torch.arange(cap, device=dev) < n
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    okey = col(li["l_orderkey"], torch.int64)
    ship = col(li["l_shipdate"], torch.int32)
    price = col(li["l_extendedprice"], torch.int64)
    qty = col(li["l_quantity"], torch.int64)
    codes = {c: col(np.unique(li[c], return_inverse=True)[1], torch.int32)
             for c in ("l_returnflag", "l_linestatus")}

    def exact(what, got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if a is not None and not _same_nan(a, b):
                raise AssertionError(f"{what} differs from its plain "
                                     f"version")

    def k12(perm, live, keys, np_):
        return W.window_positions(*W.window_flags(perm, live, keys, np_))

    def k12_plain(perm, live, keys, np_):
        return W.window_positions_plain(
            *W.window_flags_plain(perm, live, keys, np_))

    # K12 over W1's layout (l_shipdate >= 1998-08-01 live; one partition
    # key, two order keys) and W2's (two dictionary-code partition keys,
    # two order keys)
    live1 = rows & (ship >= 10439)
    k1 = [(okey, ones), (ship, ones), (price, ones)]
    perm1, _ = F.sort_perm(k1, [False] * 3, live1)
    k2 = [(codes["l_returnflag"], ones), (codes["l_linestatus"], ones),
          (price, ones), (okey, ones)]
    perm2, _ = F.sort_perm(k2, [False, False, True, False], rows)
    timed = {}
    for tag, perm, live, keys, np_ in (("W1", perm1, live1, k1, 1),
                                       ("W2", perm2, rows, k2, 2)):
        timed[tag] = (time_cuda(lambda: k12(perm, live, keys, np_), reps=10),
                      time_cuda(lambda: k12_plain(perm, live, keys, np_),
                                reps=3))
        exact(f"K12 {tag}", k12(perm, live, keys, np_),
              k12_plain(perm, live, keys, np_))
    # inputs read once (perm, live, keys and masks), outputs written once
    # (the two flags, five int64 positions)
    b, by = bound_ms(cap * (8 + 1 + 20 + 3 + 2 + 40), cap * 16)
    out.append({"name": "window_bounds", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/window_scan.cu",
                "replaces": "tidb_tpu/executor/device_emit.py:452",
                "max_abs_err": 0, "ms": timed["W1"][0],
                "plain_ms": timed["W1"][1], "bound_ms": b, "bound_by": by,
                "library_ms": None})
    log(f"K12 flags + positions n={cap}: W1 layout {timed['W1'][0]:.4f} ms "
        f"(plain {timed['W1'][1]:.4f}), W2 layout {timed['W2'][0]:.4f} ms "
        f"(plain {timed['W2'][1]:.4f}); bound {b:.4f} by {by}")

    # K13: the int64 prefix of W1's running SUM (masked l_extendedprice in
    # W1's sorted order) and a segmented max over W2's layout
    ps1, qs1 = W.window_flags(perm1, live1, k1, 1)
    valid1 = live1[perm1]
    v1 = price[perm1]
    ms = time_cuda(lambda: W.window_prefix(v1, valid1), reps=10)
    plain = time_cuda(lambda: W.window_prefix_plain(v1, valid1), reps=5)
    z = torch.where(valid1, v1, torch.zeros_like(v1))
    lib = time_cuda(lambda: torch.cumsum(z, 0), reps=10)
    exact("K13 prefix", W.window_prefix(v1, valid1),
          W.window_prefix_plain(v1, valid1))
    ps2, _ = W.window_flags(perm2, rows, k2, 2)
    v2 = price[perm2]
    valid2 = rows[perm2]
    seg_ms = time_cuda(lambda: W.window_segscan(v2, valid2, ps2, True),
                       reps=10)
    seg_plain = time_cuda(lambda: W.window_segscan_plain(v2, valid2, ps2,
                                                         True), reps=3)
    exact("K13 segscan", W.window_segscan(v2, valid2, ps2, True),
          W.window_segscan_plain(v2, valid2, ps2, True))
    b, by = bound_ms(cap * (8 + 1 + 8 + 8), cap * 2)
    bs, _ = bound_ms(cap * (8 + 1 + 1 + 8), cap * 2)
    out.append({"name": "window_scan", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/window_scan.cu",
                "replaces": "tidb_tpu/ops/window.py:93",
                "max_abs_err": f64_err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K13 int64 prefix n={cap}: {ms:.4f} ms (plain {plain:.4f}, "
        f"torch.cumsum {lib:.4f}, bound {b:.4f} by {by}); segmented max over "
        f"W2's 6 partitions: {seg_ms:.4f} ms (plain Hillis-Steele "
        f"{seg_plain:.4f}, bound {bs:.4f})")

    # K14 over W3's RANGE key: l_shipdate (int32 DATE) within (returnflag,
    # linestatus), RANGE BETWEEN 6 PRECEDING AND CURRENT ROW
    k3 = [(codes["l_returnflag"], ones), (codes["l_linestatus"], ones),
          (ship, ones)]
    perm3, _ = F.sort_perm(k3, [False] * 3, rows)
    ps3, qs3 = W.window_flags(perm3, rows, k3, 2)
    pos3 = W.window_positions(ps3, qs3)
    rk = (ship[perm3], rows[perm3], False)
    ms = time_cuda(lambda: W.frame_bounds(pos3, 6, 0, rk), reps=10)
    plain = time_cuda(lambda: W.frame_bounds_plain(pos3, 6, 0, rk), reps=3)
    lo3, hi3 = W.frame_bounds(pos3, 6, 0, rk)
    exact("K14 range", (lo3, hi3), W.frame_bounds_plain(pos3, 6, 0, rk))
    rounds = max(cap - 1, 1).bit_length()
    b, by = bound_ms(cap * (32 + 4 + 1 + 16), cap * rounds * 4)
    out.append({"name": "frame_bounds", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/window_frame.cu",
                "replaces": "tidb_tpu/ops/window.py:248",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None})
    log(f"K14 RANGE 6 PRECEDING over an int32 DATE key n={cap} in 6 "
        f"partitions: {ms:.4f} ms (plain {plain:.4f}, bound {b:.4f} by "
        f"{by})")

    # K15: W3's bounded MAX (ROWS 3 PRECEDING AND 3 FOLLOWING; MIN timed
    # the same) and its prefix-difference SUM over the RANGE bounds
    lo7, hi7 = W.frame_bounds(pos3, 3, 3)
    vp = price[perm3]
    valid3 = rows[perm3]
    ms = time_cuda(lambda: W.frame_minmax(vp, valid3, False, lo7, hi7, 7),
                   reps=10)
    plain = time_cuda(lambda: W.frame_minmax_plain(vp, valid3, False, lo7,
                                                   hi7, 7), reps=5)
    exact("K15 bounded MIN", W.frame_minmax(vp, valid3, False, lo7, hi7, 7),
          W.frame_minmax_plain(vp, valid3, False, lo7, hi7, 7))
    cum, ccnt = W.window_prefix(qty[perm3], valid3)
    sum_ms = time_cuda(lambda: W.frame_agg("sum", cum, ccnt, lo3, hi3),
                       reps=10)
    sum_plain = time_cuda(lambda: W.frame_agg_plain("sum", cum, ccnt, lo3,
                                                    hi3), reps=5)
    exact("K15 SUM", W.frame_agg("sum", cum, ccnt, lo3, hi3),
          W.frame_agg_plain("sum", cum, ccnt, lo3, hi3))
    b, by = bound_ms(cap * (8 + 1 + 16 + 8), cap * 7 * 2)
    bsum, _ = bound_ms(cap * (8 + 8 + 16 + 8 + 1), cap * 4)
    out.append({"name": "frame_eval", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/window_frame.cu",
                "replaces": "tidb_tpu/ops/window.py:167",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None})
    log(f"K15 n={cap}: bounded MIN over 7 rows {ms:.4f} ms (plain sparse "
        f"table {plain:.4f}, bound {b:.4f} by {by}); prefix-difference SUM "
        f"over the RANGE bounds {sum_ms:.4f} ms (plain {sum_plain:.4f}, "
        f"bound {bsum:.4f})")
    return out


# ---------------------------------------------------------------------------
# phase 3 (DISTINCT / ROLLUP): K16-K18 against their plain versions
# ---------------------------------------------------------------------------


def check_distinct_kernels(dev):
    """K16 distinct_pairs, K17 rollup_tile and K18 gather_columns against
    their plain versions on the card, exactly; and the pair factorize
    built on K8-K10 and K16 against the same function over CPU copies."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor import device_emit as E
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import gather as G
    rng = np.random.default_rng(37)
    cases = 0

    def same(what, got, want):
        nonlocal cases
        if not _same_nan(got, want):
            raise AssertionError(f"{what} differs from its plain version")
        cases += 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for n, cap in ((1, 1), (1000, 7), (300_001, 4096)):
        # K16: random gids with dead rows (= cap), value ranks with ties
        live = rng.random(n) > 0.2
        gids = np.where(live, rng.integers(0, cap, n), cap).astype(np.int32)
        vid = rng.integers(0, max(n // 3, 1), n).astype(np.int32)
        same(f"K16 pair_code n={n}", F.pair_code(t(gids), t(vid), cap),
             F.pair_code_plain(t(gids), t(vid)))
        rep = rng.integers(0, n, cap).astype(np.int32)
        pg = rng.integers(0, cap, n).astype(np.int32)
        rep[pg[: cap // 2]] = np.arange(min(cap // 2, n))
        same(f"K16 first_mask n={n}", F.first_mask(t(rep), t(pg)),
             F.first_mask_plain(t(rep), t(pg)))
        # the pair factorize over K9 + K8 + K10 + K16 vs over CPU copies
        vals = rng.integers(-50, 50, n).astype(np.int64)
        valid = rng.random(n) > 0.1
        got = F.distinct_pair_factorize(t(gids), t(vals), t(valid), t(live),
                                        n, gid_cap=cap)
        want = F.distinct_pair_factorize(*(torch.from_numpy(a) for a in
                                           (gids, vals, valid, live)), n,
                                         gid_cap=cap)
        pl = t(live & valid)
        same(f"pair factorize first n={n}", got[0][pl],
             want[0].to(dev)[pl])
        same(f"pair factorize pg n={n}", got[1][pl], want[1].to(dev)[pl])
        k = int(want[2])
        if int(got[2]) != k:
            raise AssertionError("pair factorize: n_pairs differs")
        same(f"pair factorize rep n={n}", got[3][:k], want[3].to(dev)[:k])
        # K17: 1/2/4/8-byte columns and a 2-D limb plane, reps 2..4
        cols = [t(rng.random(n) > 0.5),
                t(rng.integers(-9, 9, n).astype(np.int16)),
                t(rng.integers(0, 7, n).astype(np.int32)),
                t(rng.normal(size=n)),
                t(rng.integers(0, 1 << 40, (3, n)).astype(np.int64))]
        for reps in (2, 3, 4):
            for a, b in zip(E.rollup_tile(cols, reps),
                            E.rollup_tile_plain(cols, reps)):
                same(f"K17 tile n={n} reps={reps}", a, b)
            masks = [t(np.tile(rng.random(n) > 0.2, reps))
                     for _ in range(reps - 1)]
            lev, got_m = E.rollup_levels(masks, n)
            wlev, want_m = E.rollup_levels_plain(masks, n)
            same(f"K17 levels n={n}", lev, wlev)
            for a, b in zip(got_m, want_m):
                same(f"K17 level masks n={n}", a, b)
        # K18: 1/4/8-byte columns, masks and none, int32 and int64
        # indices, n_valid below and at the cap
        gcols = [(cols[0], t(rng.random(n) > 0.3)), (cols[2], None),
                 (cols[3], t(rng.random(n) > 0.3)),
                 (t(rng.integers(-2 ** 62, 2 ** 62, n)), None)]
        m_out = max(n // 2, 1)
        for idx_dt in (np.int32, np.int64):
            idx = t(rng.integers(0, n, m_out).astype(idx_dt))
            for nv in (m_out // 3, m_out):
                n_valid = torch.tensor(nv, dtype=torch.int32, device=dev)
                for (a, am), (b, bm) in zip(
                        G.gather_columns(gcols, idx, n_valid),
                        G.gather_columns_plain(gcols, idx, n_valid)):
                    same(f"K18 values n={n}", a, b)
                    same(f"K18 masks n={n}", am, bm)
    torch.cuda.synchronize()
    log(f"K16/K17/K18 exactly equal to their plain versions ({cases} "
        f"cases); the pair factorize on K8-K10 + K16 equal to its CPU run")


# ---------------------------------------------------------------------------
# phase 13: DISTINCT and ROLLUP aggregates in SQL
# ---------------------------------------------------------------------------

D1 = """SELECT l_returnflag, l_linestatus, COUNT(DISTINCT l_orderkey),
 COUNT(DISTINCT l_shipdate, l_discount), SUM(DISTINCT l_quantity),
 AVG(l_extendedprice) FROM lineitem GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""

D3 = """SELECT o_orderpriority, COUNT(DISTINCT l_orderkey),
 COUNT(DISTINCT o_custkey) FROM lineitem JOIN orders ON l_orderkey =
 o_orderkey WHERE l_shipdate <= '1998-09-02' GROUP BY o_orderpriority
 ORDER BY o_orderpriority"""

D4 = """SELECT COUNT(DISTINCT l_orderkey), COUNT(DISTINCT l_orderkey,
 l_returnflag) FROM lineitem WHERE l_shipdate >= '1995-01-01'"""

R1 = """SELECT l_returnflag, l_linestatus, SUM(l_quantity),
 SUM(l_extendedprice), AVG(l_discount), COUNT(*) FROM lineitem
 WHERE l_shipdate <= '1998-09-02'
 GROUP BY l_returnflag, l_linestatus WITH ROLLUP"""

R2 = """SELECT c_mktsegment, o_orderpriority, COUNT(*), SUM(l_extendedprice)
 FROM lineitem JOIN orders ON l_orderkey = o_orderkey
 JOIN customer ON o_custkey = c_custkey
 GROUP BY c_mktsegment, o_orderpriority WITH ROLLUP"""

DISTINCT_KERNELS = ("distinct_pairs", "rollup_tile", "gather_columns")
MULTI_SLAB = 2_097_152       # D2's and R3's slabs
FULL_SLAB = 8_388_608        # the device cache's slab at SF=1


def agg_in_fragment(s, sql) -> bool:
    """Is a HashAgg inside a device fragment of the statement's plan?"""
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import PhysHashAgg, PhysTpuFragment
    s.vars["tidb_tpu_engine"] = "on"
    plan = s._plan(parse(sql)[0])
    found = []

    def walk(p, inside):
        inside = inside or isinstance(p, PhysTpuFragment)
        if isinstance(p, PhysTpuFragment):
            walk(p.root, True)
        if isinstance(p, PhysHashAgg) and inside:
            found.append(p)
        for c in p.children:
            walk(c, inside)

    walk(plan, False)
    return bool(found)


def distinct_sql_phase(s):
    """D1-D4 and R1-R3 cold and twice warm under tidb_tpu_strict=1, each
    exactly equal to the host engine (rows sorted where the statement
    has no ORDER BY) → (launches, walls)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    stmts = {"d1": (D1, None), "d2": (D1, MULTI_SLAB), "d3": (D3, None),
             "d4": (D4, None), "r1": (R1, None), "r2": (R2, None),
             "r3": (R1, MULTI_SLAB)}
    for name, (sql, _slab) in stmts.items():
        explain = "\n".join(str(r[0]) for r in
                            s.query("EXPLAIN " + sql).rows)
        if not agg_in_fragment(s, sql) or "TpuFragment" not in explain:
            raise AssertionError(f"{name}: the HashAgg is not inside the "
                                 f"device fragment\n{explain}")
    log("EXPLAIN: D1-D4's and R1-R3's HashAgg inside a TpuFragment")
    host = {}
    walls = {}
    for name in ("d1", "d3", "d4", "r1", "r2"):
        sql = stmts[name][0]
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = rows if "ORDER BY" in sql else sorted(rows, key=repr)
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s"
            + (" (over 30 s)" if wall > 30 else ""))
    t_phase = time.perf_counter()
    ck.reset_launches()
    esc_all = {}
    for name, (sql, slab) in stmts.items():
        ref = {"d2": "d1", "r3": "r1"}.get(name, name)
        for k in ("cold", "warm1", "warm2"):
            run = f"{name}_{k}"
            before = ck.launches()
            rows, wall, phases, esc = run_sql(s, sql, device=True,
                                              max_slab=slab)
            after = ck.launches()
            moved = {c: after[c] - before[c] for c in after
                     if after[c] != before[c]}
            if "ORDER BY" not in sql:
                rows = sorted(rows, key=repr)
            if rows != host[ref]:
                raise AssertionError(f"{run}: device rows != host rows\n"
                                     f"{rows[:3]}\n{host[ref][:3]}")
            for kind, c in esc.items():
                esc_all[f"{name}:{kind}"] = esc_all.get(f"{name}:{kind}",
                                                        0) + c
            walls[run] = wall
            log(f"{run}: {len(rows)} rows, exact match, wall {wall:.4f} s, "
                f"launches {moved}, escalation {esc}, phases {phases}")
            if name.startswith("d") and not moved.get("distinct_pairs"):
                raise AssertionError(f"{run}: K16 did not move ({moved})")
            if name.startswith("r") and not (moved.get("rollup_tile") and
                                             moved.get("gather_columns")):
                raise AssertionError(f"{run}: K17/K18 did not move "
                                     f"({moved})")
    s.vars.pop("tidb_tpu_max_slab_rows", None)
    launches = ck.launches()
    walls["distinct_phase"] = time.perf_counter() - t_phase
    for k in DISTINCT_KERNELS + ("radix_sort", "sort_encode", "group_ids"):
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"DISTINCT/ROLLUP path")
    if not any(k.startswith("d2:pairs") for k in esc_all):
        raise AssertionError(f"D2 climbed no pairs rung ({esc_all})")
    log(f"escalation rungs: {json.dumps(esc_all)}")
    log(f"DISTINCT/ROLLUP phase: {walls['distinct_phase']:.1f} s, launches "
        f"{launches}")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 14: DISTINCT / ROLLUP kernel timing
# ---------------------------------------------------------------------------


def distinct_timing_phase(dev, n: int):
    """K16-K18 at phase 13's shapes: K16 over one 8,388,608-row lineitem
    slab (D1's COUNT(DISTINCT l_orderkey) in (returnflag, linestatus)
    groups), K17 tiling R1's read columns 3x, K18 gathering D2's pair
    output (its two key columns and l_orderkey through rep[:pair_cap]
    over its largest 2,097,152-row slab, at the pair cap D2's ladder
    settles on: the power of two over the largest per-slab pair count,
    at most the slab)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor import device_emit as E
    from tidb_tpu_torch.executor.device_cache import _pow2
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import gather as G
    li = make_lineitem(n)
    out = []

    def col(a, dtype, cap):
        t = torch.zeros(cap, dtype=dtype)
        m = min(n, cap)
        t[:m] = torch.from_numpy(np.asarray(a[:m]).astype(
            np.dtype(str(dtype).replace("torch.", ""))))
        return t.to(dev)

    def exact(what, a, b):
        if not _same_nan(a, b):
            raise AssertionError(f"{what} differs from its plain version")

    cap = FULL_SLAB
    rows = torch.arange(cap, device=dev) < n
    codes = {c: col(np.unique(li[c], return_inverse=True)[1], torch.int32,
                    cap) for c in ("l_returnflag", "l_linestatus")}
    gids = torch.where(rows, codes["l_returnflag"] * 2 +
                       codes["l_linestatus"], torch.full_like(
                           codes["l_returnflag"], 6)).contiguous()
    okey = col(li["l_orderkey"], torch.int64, cap)
    vid = F._dense1(okey, None, rows)
    # K16 pair_code and first_mask at n = 8,388,608
    ms_code = time_cuda(lambda: F.pair_code(gids, vid, 6), reps=10)
    plain_code = time_cuda(lambda: F.pair_code_plain(gids, vid), reps=5)
    exact("K16 pair_code", F.pair_code(gids, vid, 6),
          F.pair_code_plain(gids, vid))
    code = F.pair_code(gids, vid, 6)
    pg, n_pairs, rep = F.factorize([(code, None)], rows, cap,
                                   hi=7 * (cap + 1))
    k = int(n_pairs)
    ms_first = time_cuda(lambda: F.first_mask(rep, pg), reps=10)
    plain_first = time_cuda(lambda: F.first_mask_plain(rep, pg), reps=5)
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    lib_code = time_cuda(lambda: gids.long() * (cap + 1) + vid.long(),
                         reps=10)
    lib_first = time_cuda(lambda: rep[pg.long()] == iota, reps=10)
    exact("K16 first_mask", F.first_mask(rep, pg),
          F.first_mask_plain(rep, pg))
    # inputs read once, outputs written once: the gids and ranks (4 B
    # each) → the code (8 B); pg (4 B) and the k rep entries the pairs
    # need → one flag byte
    b, by = bound_ms(cap * 16 + cap * 5 + k * 4, cap * 3)
    out.append({"name": "distinct_pairs", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/distinct_pairs.cu",
                "replaces": "tidb_tpu/ops/factorize.py:206",
                "max_abs_err": 0, "ms": ms_code + ms_first,
                "plain_ms": plain_code + plain_first, "bound_ms": b,
                "bound_by": by, "library_ms": lib_code + lib_first})
    log(f"K16 n={cap}, {k} pairs: pair_code {ms_code:.4f} ms (plain "
        f"{plain_code:.4f}, gids*(n+1)+vid {lib_code:.4f}, bound "
        f"{bound_ms(cap * 16, 0)[0]:.4f}), first_mask {ms_first:.4f} ms "
        f"(plain {plain_first:.4f}, rep[pg] == arange {lib_first:.4f}, "
        f"bound {bound_ms(cap * 5 + k * 4, 0)[0]:.4f}); bound of both "
        f"{b:.4f} by {by}")

    # K17: R1's read columns (live, returnflag/linestatus codes and masks,
    # l_quantity, l_extendedprice, l_discount and masks) tiled 3x
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    r1 = [rows & (col(li["l_shipdate"], torch.int32, cap) <= 10471)]
    for c in ("l_returnflag", "l_linestatus"):
        r1 += [codes[c], ones]
    for c in ("l_quantity", "l_extendedprice", "l_discount"):
        r1 += [col(li[c], torch.int64, cap), ones]
    ms = time_cuda(lambda: E.rollup_tile(r1, 3), reps=10)
    plain = time_cuda(lambda: E.rollup_tile_plain(r1, 3), reps=5)
    lib = time_cuda(lambda: [torch.cat([c] * 3) for c in r1], reps=10)
    for a, c in zip(E.rollup_tile(r1, 3), E.rollup_tile_plain(r1, 3)):
        exact("K17 tile", a, c)
    in_bytes = sum(c.numel() * c.element_size() for c in r1)
    b_tile = bound_ms(in_bytes * 4, 0)[0]
    # the levels entry over R1's two key masks with NULLs, as tiled
    g = torch.Generator(device=dev).manual_seed(17)
    masks = [torch.cat([torch.rand(cap, generator=g, device=dev) < 0.9]
                       * 3) for _ in range(2)]
    lev, got_m = E.rollup_levels(masks, cap)
    wlev, want_m = E.rollup_levels_plain(masks, cap)
    exact("K17 levels", lev, wlev)
    for a, c in zip(got_m, want_m):
        exact("K17 level masks", a, c)
    ms_lev = time_cuda(lambda: E.rollup_levels(masks, cap), reps=10)
    plain_lev = time_cuda(lambda: E.rollup_levels_plain(masks, cap), reps=5)

    def lib_levels():
        lv = torch.arange(3, device=dev).repeat_interleave(cap)
        return lv, [m & (lv < 2 - i) for i, m in enumerate(masks)]
    lib_lev = time_cuda(lib_levels, reps=10)
    # levels: two masks read, the int64 level column and two masks
    # written, over 3 x cap rows
    b, by = bound_ms(in_bytes * 4 + 3 * cap * (2 + 8 + 2), 0)
    out.append({"name": "rollup_tile", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/rollup_tile.cu",
                "replaces": "tidb_tpu/executor/device_emit.py:332",
                "max_abs_err": 0, "ms": ms + ms_lev,
                "plain_ms": plain + plain_lev, "bound_ms": b,
                "bound_by": by, "library_ms": lib + lib_lev})
    log(f"K17 tile of R1's {len(r1)} read columns to 3 x {cap} rows: "
        f"{ms:.4f} ms (plain {plain:.4f}, torch.cat {lib:.4f}, bound "
        f"{b_tile:.4f}); levels of 2 keys {ms_lev:.4f} ms (plain "
        f"{plain_lev:.4f}, repeat_interleave + & {lib_lev:.4f}, bound "
        f"{bound_ms(3 * cap * 12, 0)[0]:.4f}); bound of both {b:.4f} "
        f"by {by}")

    # K18: D2's pair output over one 2,097,152-row slab — two key columns
    # (dictionary codes and masks) and l_orderkey through rep[:pair_cap]
    sc = MULTI_SLAB
    best = None
    for lo in range(0, min(n, cap), sc):
        srows = torch.arange(sc, device=dev) < min(n - lo, sc)
        part = slice(lo, lo + sc)
        sg = torch.full((sc,), 6, dtype=torch.int32, device=dev)
        so = torch.zeros(sc, dtype=torch.int64, device=dev)
        m = min(n - lo, sc)
        sg[:m] = gids[part][:m]
        so[:m] = okey[part][:m]
        _f, _p, s_pairs, s_rep = F.distinct_pair_factorize(
            sg, so, srows, srows, sc, gid_cap=6)
        if best is None or int(s_pairs) > int(best[0]):
            best = (s_pairs, s_rep, lo, so)
    s_pairs, s_rep, lo, so = best
    pc = min(_pow2(int(s_pairs)) if int(s_pairs) > 65_536 else 65_536, sc)
    idx = s_rep[:pc]
    gcols = [(codes["l_returnflag"][lo:lo + sc].contiguous(), ones[:sc]),
             (codes["l_linestatus"][lo:lo + sc].contiguous(), ones[:sc]),
             (so, None)]
    ms = time_cuda(lambda: G.gather_columns(gcols, idx, s_pairs), reps=10)
    plain = time_cuda(lambda: G.gather_columns_plain(gcols, idx, s_pairs),
                      reps=5)
    il = idx.long()
    lib = time_cuda(lambda: [(torch.index_select(v, 0, il),
                              None if m is None else
                              torch.index_select(m, 0, il))
                             for v, m in gcols], reps=10)
    for (a, am), (c, cm) in zip(G.gather_columns(gcols, idx, s_pairs),
                                G.gather_columns_plain(gcols, idx,
                                                       s_pairs)):
        exact("K18 values", a, c)
        exact("K18 masks", am, cm)
    per_slot = 4 + (4 + 1 + 4 + 1) + (4 + 1 + 4 + 1) + (8 + 8 + 1)
    b, by = bound_ms(pc * per_slot, 0)
    out.append({"name": "gather_columns", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/gather_columns.cu",
                "replaces": "tidb_tpu/executor/device_emit.py:53",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K18 3 columns through rep[:{pc}] ({int(s_pairs)} pairs) of a "
        f"{sc}-row slab: {ms:.4f} ms (plain {plain:.4f}, index_select "
        f"{lib:.4f}, bound {b:.4f} by {by})")
    return out


# ---------------------------------------------------------------------------
# phase 3 (delta): K19 against its plain version
# ---------------------------------------------------------------------------


def _delta_case(rng, kind, width, cap, n_cur):
    """(layout or None, host slab tuple) of one column as the cache
    stores it: raw int64, a raw (3, cap) wide decimal, dict, or pack at
    `width` (chunk/compress.pack_slab pads the codes and the mask)."""
    import numpy as np
    from tidb_tpu_torch.chunk import compress as C
    mask = (rng.random(cap) < 0.8) & (np.arange(cap) < n_cur)
    if kind == "raw":
        return None, (rng.integers(-(1 << 50), 1 << 50, cap), mask)
    if kind == "wide":
        return None, (rng.integers(-(1 << 40), 1 << 40, (3, cap)), mask)
    if kind == "dict":
        dv = np.unique(rng.integers(-999, 999, 300)).astype(np.int64)
        lay = C.ColLayout("dict", width, 0, "int64", len(dv))
        return lay, C.pack_slab(lay, dv[rng.integers(0, len(dv), cap)],
                                mask, dv) + (dv,)
    lay = C.ColLayout("pack", width, 7, "int64")
    codes = rng.integers(0, 1 << width, cap) if width else np.zeros(cap)
    return lay, C.pack_slab(lay, codes.astype(np.int64) + 7, mask)


def _keep_mask(rng, tombs, cap, n_cur):
    import numpy as np
    keep = np.zeros(cap, dtype=bool)
    keep[:n_cur] = True
    if tombs == "few":
        keep[rng.choice(n_cur, min(9, n_cur), replace=False)] = False
    elif tombs == "half":
        keep &= rng.random(cap) < 0.5
    elif tombs == "all":
        keep[:] = False
    return keep


def check_delta_kernels(dev):
    """K19 delta_merge against delta_merge_plain on the card, exactly:
    the partition and, through it, every packed width (0 included), a
    dict column, and raw int64 and wide columns (K18 with the same
    permutation), over four tombstone sets and three slab shapes."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor import device_emit as E
    from tidb_tpu_torch.executor.device_cache import _upload
    rng = np.random.default_rng(43)
    layouts = [("raw", 0), ("wide", 0), ("dict", 16)] + \
        [("pack", w) for w in (0, 1, 2, 4, 8, 16, 32)]
    cases = 0
    for cap, n_cur in ((1024, 1024), (1024, 1), (65_536, 60_001)):
        for tombs in ("none", "few", "half", "all"):
            keep = torch.from_numpy(_keep_mask(rng, tombs, cap,
                                               n_cur)).to(dev)
            n_new = int(keep.sum())
            perm = E.delta_perm(keep)
            if not torch.equal(perm, E.delta_perm_plain(keep)):
                raise AssertionError(f"K19 delta_perm cap={cap} {tombs}")
            n_valid = torch.tensor(n_new, dtype=torch.int32, device=dev)
            for kind, width in layouts:
                lay, host = _delta_case(rng, kind, width, cap, n_cur)
                slab = tuple(_upload(a, dev) for a in host)
                got = E.emit_delta_merge(lay, slab, keep, n_new, cap,
                                         perm=perm, n_valid=n_valid)
                want = E.delta_merge_plain(lay, slab, keep, n_new, cap)
                if len(got) != len(want) or not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"K19 {kind} w{width} cap={cap} "
                                         f"{tombs} differs from its plain "
                                         f"version")
                cases += 1
    torch.cuda.synchronize()
    log(f"K19 exactly equal to its plain version ({cases} cases: partition, "
        f"widths 0-32, dict, raw and wide through K18)")


# ---------------------------------------------------------------------------
# phase 15: the delta write path in SQL
# ---------------------------------------------------------------------------

DELTA_ROWS = 1000            # the INSERT of step 2
# DELETE A tombstones the rows shipped before 1992-02-01 (base slab 0 of
# a shipdate-sorted lineitem, and the copies among the inserted rows);
# DELETE B those before 1992-03-01 with l_linestatus 'F' (slab 0 again,
# through its applied tombstones, and more inserted copies)
DELETE_A = "DELETE FROM lineitem WHERE l_shipdate < '1992-02-01'"
DELETE_B = ("DELETE FROM lineitem WHERE l_shipdate < '1992-03-01' "
            "AND l_linestatus = 'F'")
DAY_A, DAY_B = 8066, 8095    # '1992-02-01', '1992-03-01' in days


def _dec(v) -> str:
    v = int(v)
    return f"{v // 100}.{v % 100:02d}"


def _li_row(li, k, shipdate=None, price=None) -> str:
    """One lineitem row of make_lineitem's arrays as SQL VALUES text,
    optionally with another l_shipdate (days) or l_extendedprice."""
    import datetime
    day = int(li["l_shipdate"][k] if shipdate is None else shipdate)
    date = datetime.date(1970, 1, 1) + datetime.timedelta(days=day)
    return (f"({_dec(li['l_quantity'][k])}, "
            f"{_dec(li['l_extendedprice'][k] if price is None else price)}, "
            f"{_dec(li['l_discount'][k])}, {_dec(li['l_tax'][k])}, "
            f"'{li['l_returnflag'][k]}', '{li['l_linestatus'][k]}', "
            f"'{date.isoformat()}', {int(li['l_orderkey'][k])})")


def _lineitem_entry(s):
    from tidb_tpu_torch.executor import device_cache as DC
    eng = s.engine
    tid = eng.catalog.info_schema.table("lineitem").id
    for (_dev, sid, t, _parts), e in DC._CACHE.items():
        if sid == id(eng.store) and t == tid:
            return e
    return None


def _slab_tensor_ids(ent, slabs):
    return {i: [tuple(id(a) for a in ent.dev[i][s]) for s in slabs]
            for i in sorted(ent.dev)}


def delta_sql_phase(s, n: int, host_q1, host_q3):
    """Writes that extend the cached lineitem into new generations,
    each read back through Q1 (and bench.py's Q3) against the host
    engine exactly, then the compaction a user pays today on every
    write → (launches, walls, timing inputs). `host_q1` / `host_q3` are
    phase 4's and phase 7's host rows, which step 0's write (two rows
    shipped after Q1's and Q3's cutoff) leaves unchanged."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor import delta as D
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ent = _lineitem_entry(s)
    if ent is None:
        raise AssertionError("no cached lineitem entry after phase 13")
    slab = ent.max_slab
    cols = [c.name for c in
            s.engine.catalog.info_schema.table("lineitem").columns]
    ship, price = cols.index("l_shipdate"), cols.index("l_extendedprice")
    log(f"delta phase on the resident lineitem: {ent.n_slabs} slabs of "
        f"{ent.slab_cap} (tidb_tpu_max_slab_rows {slab}); layouts "
        + ", ".join(f"{cols[i]} {'raw' if l is None else l.sig()}"
                    for i, l in sorted(ent.layouts.items())))
    li = make_lineitem(n)
    s.vars["tidb_tpu_compaction"] = "off"      # drained by hand, step 5
    walls = {}
    t_phase = time.perf_counter()
    ck.reset_launches()

    def write(name, sql):
        s.vars["tidb_tpu_engine"] = "off"
        t0 = time.perf_counter()
        done = s.query(sql).affected_rows
        walls[name] = time.perf_counter() - t0
        log(f"{name}: {done} rows in {walls[name]:.3f} s")
        return done

    def host(name, sql):
        rows, wall, _, _ = run_sql(s, sql, device=False)
        walls[f"host_{name}"] = wall
        return rows

    def read(name, sql, ref):
        before = ck.launches()
        rows, wall, phases, _ = run_sql(s, sql, device=True, max_slab=slab)
        after = ck.launches()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        if rows != ref:
            raise AssertionError(f"{name}: device rows != host rows\n"
                                 f"{rows[:3]}\n{ref[:3]}")
        walls[name] = wall
        log(f"{name}: {len(rows)} rows, exact match, wall {wall:.4f} s, "
            f"launches {moved}, phases {phases}")
        return moved

    # step 0: a write the base layouts cannot carry — l_shipdate is
    # stored as differences (sorted), and these two rows go back in
    # time (1998-12-01, then 1998-10-01: both past Q1's and Q3's cutoff,
    # so neither result moves); the second one's l_extendedprice needs
    # 33 bits — so the extension declines and the read rebuilds,
    # re-choosing l_shipdate's layout and leaving l_extendedprice raw
    # (the merge's K18 half)
    k1, k2 = n // 3, n // 2
    write("insert_decline", "INSERT INTO lineitem VALUES " +
          _li_row(li, k1, shipdate=10561) + ", " +
          _li_row(li, k2, shipdate=10500, price=5_000_000_000))
    q1, q3 = host_q1, host_q3
    read("q1_rebuild", Q1, q1)
    ent = _lineitem_entry(s)
    lay_ship = ent.layouts.get(ship)
    if ent.is_delta or lay_ship is None or lay_ship.kind == "delta" or \
            ent.layouts.get(price) is not None:
        raise AssertionError("the out-of-layout write did not rebuild "
                             "into non-delta l_shipdate and raw "
                             "l_extendedprice")
    # step 1: the starting point, Q1 and bench Q3 warm (Q3 streams
    # l_orderkey into the entry, so every column is resident)
    read("q3_start_cold", Q3, q3)
    read("q1_start", Q1, q1)
    read("q3_start", Q3, q3)
    ent0 = _lineitem_entry(s)
    base = range(ent0.n_slabs)
    ids0 = _slab_tensor_ids(ent0, base)
    if len(ids0) != len(cols):
        raise AssertionError(f"not every lineitem column is resident "
                             f"({sorted(ids0)})")

    def check(what, ent, rows, untouched, moved, merged):
        if not ent.is_delta or ent.delta_rows != rows:
            raise AssertionError(f"{what}: is_delta {ent.is_delta}, "
                                 f"delta_rows {ent.delta_rows} != {rows}")
        if ent.base_slabs != ent0.n_slabs or \
                ent.slab_rows(ent.base_slabs) != rows:
            raise AssertionError(f"{what}: delta slab geometry")
        if _slab_tensor_ids(ent, untouched) != \
                _slab_tensor_ids(ent0, untouched):
            raise AssertionError(f"{what}: base slabs {list(untouched)} "
                                 f"were not shared")
        k19 = moved.get("delta_merge", 0)
        k18 = moved.get("gather_columns", 0)
        if merged and not (k19 and k18):
            raise AssertionError(f"{what}: K19/K18 did not launch ({moved})")
        if not merged and k19:
            raise AssertionError(f"{what}: K19 launched with no tombstone")
        log(f"{what}: generation {ent.delta_version}, {ent.delta_rows} "
            f"delta rows, tombstones per slab "
            f"{ {s: len(v) for s, v in ent.tomb.items()} }, slabs "
            f"{list(untouched)} shared, K19 {k19} / K18 {k18} launches")

    # step 2: 1,000 rows copied from existing ones (every gate passes)
    idx = np.arange(DELTA_ROWS) * (n // DELTA_ROWS) + 11
    write("insert", "INSERT INTO lineitem VALUES " +
          ", ".join(_li_row(li, k) for k in idx))
    q1 = host("q1_insert", Q1)
    moved = read("q1_ext_insert", Q1, q1)
    read("q1_delta_warm", Q1, q1)
    ent1 = _lineitem_entry(s)
    check("insert", ent1, DELTA_ROWS, base, moved, merged=False)
    # slab 0 as DELETE A finds it, for the timing phase
    snap = {i: (ent1.layouts.get(i), ent1.dev[i][0]) for i in ent1.dev}
    cap, n_cur0 = ent1.slab_cap, ent1.slab_rows(0)
    # step 3: tombstones in base slab 0 (slabs 1.. stay shared) and in
    # the delta slab; then those of DELETE B on top (the re-diff)
    sd, ls = li["l_shipdate"][idx], li["l_linestatus"][idx]
    alive = sd >= DAY_A
    write("delete_a", DELETE_A)
    q1 = host("q1_delete_a", Q1)
    moved = read("q1_ext_delete_a", Q1, q1)
    read("q1_delete_a_warm", Q1, q1)
    ent2 = _lineitem_entry(s)
    check("delete A", ent2, int(alive.sum()), base[1:], moved, merged=True)
    if set(ent2.tomb) != {0}:
        raise AssertionError(f"DELETE A hit slabs {sorted(ent2.tomb)}")
    after = {i: ent2.dev[i][0] for i in ent2.dev}
    alive &= ~((sd < DAY_B) & (ls == "F"))
    write("delete_b", DELETE_B)
    q1 = host("q1_delete_b", Q1)
    moved = read("q1_ext_delete_b", Q1, q1)
    read("q1_delete_b_warm", Q1, q1)
    ent3 = _lineitem_entry(s)
    check("delete B", ent3, int(alive.sum()), base[1:], moved, merged=True)
    # step 4: bench Q3 over the delta generation (the fused pipeline; its
    # FK-aligned join rebuilds for the new lineitem generation)
    q3 = host("q3_delta", Q3)
    read("q3_delta", Q3, q3)
    read("q3_delta_warm", Q3, q3)
    if _lineitem_entry(s) is not ent3:
        raise AssertionError("Q3 did not read the delta generation")
    # step 5: the compaction — the rebuild every write costs without the
    # delta path — then Q1 on the compacted generation
    if D.pending_compactions() < 1:
        raise AssertionError("no compaction was scheduled")
    t0 = time.perf_counter()
    done = D.run_pending_compactions()
    torch.cuda.synchronize()
    walls["compaction"] = time.perf_counter() - t0
    ent4 = _lineitem_entry(s)
    if done != 1 or ent4.is_delta or ent4.n_slabs != ent0.n_slabs:
        raise AssertionError(f"compaction: {done} jobs, is_delta "
                             f"{ent4.is_delta}")
    log(f"compaction: {walls['compaction']:.4f} s, {ent4.n_slabs} slabs of "
        f"{ent4.slab_cap}, {ent4.total} rows")
    read("q1_compacted", Q1, q1)
    read("q1_compacted_warm", Q1, q1)
    s.vars.pop("tidb_tpu_compaction", None)
    s.vars.pop("tidb_tpu_max_slab_rows", None)
    launches = ck.launches()
    walls["delta_phase"] = time.perf_counter() - t_phase
    for k in ("delta_merge", "gather_columns"):
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"delta path")
    log(f"delta phase: {walls['delta_phase']:.1f} s, launches {launches}")
    keep = np.zeros(cap, dtype=bool)
    keep[:n_cur0] = True
    keep[:min(n_cur0, n)] &= li["l_shipdate"][:min(n_cur0, n)] >= DAY_A
    return launches, walls, {"snap": snap, "after": after, "keep": keep,
                             "cap": cap}


# ---------------------------------------------------------------------------
# phase 16: delta merge kernel timing
# ---------------------------------------------------------------------------


def delta_timing_phase(dev, inputs):
    """K19 at phase 15's shapes: DELETE A's merge of base slab 0 (every
    resident lineitem column, as the extension ran it), each column held
    exactly to delta_merge_plain and to the slab the SQL phase wrote;
    delta_perm beside torch.argsort(~keep, stable=True); delta_repack for
    every packed layout of the slab (values and masks), plus widths 1 and
    32 over random codes; K18 through perm for the raw l_extendedprice."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor import device_emit as E
    cap = inputs["cap"]
    keep = torch.from_numpy(inputs["keep"]).to(dev)
    n_new = int(keep.sum())
    perm = E.delta_perm(keep)
    if not torch.equal(perm, E.delta_perm_plain(keep)):
        raise AssertionError("K19 delta_perm differs from its plain version")
    n_valid = torch.tensor(n_new, dtype=torch.int32, device=dev)
    ms_perm = time_cuda(lambda: E.delta_perm(keep), reps=10)
    plain_perm = time_cuda(lambda: E.delta_perm_plain(keep), reps=5)
    lib = time_cuda(lambda: torch.argsort(~keep, stable=True), reps=10)
    # bytes: keep read, perm written; per packed column its words and
    # mask words read once and their rewrites written once
    n_bytes = cap + 4 * cap
    ms = ms_perm
    plain = plain_perm
    widths = set()
    for i, (lay, t) in sorted(inputs["snap"].items()):
        got = E.emit_delta_merge(lay, t, keep, n_new, cap, perm=perm,
                                 n_valid=n_valid)
        want = E.delta_merge_plain(lay, t, keep, n_new, cap)
        main = inputs["after"][i]
        for a, b, c in zip(got, want, main):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"K19 column {i} differs from its "
                                     f"plain version or the SQL phase")
        if lay is None:
            v, m = t
            k18 = time_cuda(lambda: E.emit_delta_merge(
                None, t, keep, n_new, cap, perm=perm, n_valid=n_valid),
                reps=10)
            il = perm.long()
            idx_sel = time_cuda(lambda: (torch.index_select(v, 0, il),
                                         torch.index_select(m, 0, il)),
                                reps=10)
            log(f"K18 through perm, column {i} ({v.dtype}): {k18:.4f} ms "
                f"(index_select {idx_sel:.4f}, bound "
                f"{bound_ms(cap * (4 + 2 * (v.element_size() + 1)), 0)[0]:.4f})")
            continue

        def repack(fn, lay=lay, t=t):
            out = [fn(t[1], 1, perm, n_new, cap)]
            if lay.width:
                out.append(fn(t[0], lay.width, perm, n_new, cap))
            return out
        c_ms = time_cuda(lambda: repack(E.delta_repack), reps=10)
        c_plain = time_cuda(lambda: repack(E.delta_repack_plain), reps=5)
        c_bytes = 2 * (t[1].nbytes + (t[0].nbytes if lay.width else 0))
        ms += c_ms
        plain += c_plain
        n_bytes += c_bytes
        widths.add(lay.width)
        log(f"K19 repack column {i} ({lay.sig()} + mask): {c_ms:.4f} ms "
            f"(plain {c_plain:.4f}, bound {bound_ms(c_bytes, 0)[0]:.4f})")
    rng = np.random.default_rng(47)
    for w in (1, 32):
        codes = torch.from_numpy(rng.integers(0, 1 << w, cap)).to(dev)
        words = E.pack_codes_plain(codes, w, cap)
        a = E.delta_repack(words, w, perm, n_new, cap)
        if not torch.equal(a, E.delta_repack_plain(words, w, perm, n_new,
                                                   cap)):
            raise AssertionError(f"K19 repack width {w} differs")
        w_ms = time_cuda(lambda: E.delta_repack(words, w, perm, n_new, cap),
                         reps=10)
        w_plain = time_cuda(lambda: E.delta_repack_plain(words, w, perm,
                                                         n_new, cap),
                            reps=5)
        log(f"K19 repack of random codes at width {w}: {w_ms:.4f} ms "
            f"(plain {w_plain:.4f}, bound "
            f"{bound_ms(2 * words.nbytes, 0)[0]:.4f})")
    b, by = bound_ms(n_bytes, 0)
    log(f"K19 over slab 0 ({cap} rows, {n_new} kept, packed widths "
        f"{sorted(widths)}): delta_perm {ms_perm:.4f} ms (plain "
        f"{plain_perm:.4f}, torch.argsort(~keep, stable=True) {lib:.4f}), "
        f"perm + every repack {ms:.4f} ms (plain {plain:.4f}, bound "
        f"{b:.4f} by {by})")
    return [{"name": "delta_merge", "route": "cuda",
             "source": "tidb_tpu_torch/csrc/delta_merge.cu",
             "replaces": "tidb_tpu/executor/device_emit.py:597",
             "max_abs_err": 0, "ms": ms, "plain_ms": plain, "bound_ms": b,
             "bound_by": by, "library_ms": lib}]


# ---------------------------------------------------------------------------
# phase 6: the MySQL wire protocol
# ---------------------------------------------------------------------------


def wire_phase(eng, host_q1):
    from tidb_tpu_torch.client import Client
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.server import Server
    eng.global_vars["tidb_tpu_strict"] = 1
    eng.global_vars["tidb_tpu_row_threshold"] = 1
    eng.global_vars["tidb_tpu_engine"] = "on"
    srv = Server(eng, port=0).start()
    try:
        c = Client(port=srv.port)
        try:
            before = ck.launches()
            _names, dev_rows = c.query(Q1)
            moved = {k: ck.launches()[k] - before[k] for k in before}
            c.query("SET tidb_tpu_engine = 'off'")
            _names, host_rows = c.query(Q1)
        finally:
            c.close()
    finally:
        srv.stop()
    if dev_rows != host_rows or len(dev_rows) != len(host_q1):
        raise AssertionError("Q1 over the wire differs from the host engine")
    if moved["segment_reduce"] == 0:
        raise AssertionError("Q1 over the wire did not launch K1")
    log(f"wire: Q1 {len(dev_rows)} rows over the MySQL protocol on port "
        f"{srv.port}, equal to the host engine, launches {moved}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of lineitem (1.0 = 6,001,215 "
                         "rows)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from tidb_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: tidb_tpu_torch not found next to this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | python "
        f"{sys.version.split()[0]} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = ck.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(ck.NVCC_FLAGS)})")
    for name in ck.SOURCES:
        ck.library(name)

    k1_err = check_k1(dev)
    check_k2(dev)
    check_k3(dev)
    check_join_kernels(dev)
    check_sort_kernels(dev)
    f64_err = check_window_kernels(dev)
    check_distinct_kernels(dev)
    check_delta_kernels(dev)

    eng, s, host, launches, walls, q1_slab = sql_phase(dev, args.sf)
    kernels = timing_phase(dev, q1_slab, k1_err)
    names = {"segment_reduce": "segment_reduce",
             "unpack_decode": "unpack_decode",
             "perfect_group_ids": "perfect_groups"}
    for k in kernels:
        k["launches"] = launches[names[k["name"]]]
    wire_phase(eng, host["q1"])
    n = int(round(SF1_ROWS * args.sf))
    join_launches, join_walls, orders, customer, join_host = \
        join_sql_phase(s, n)
    join_kernels = join_timing_phase(dev, n, orders, customer)
    for k in join_kernels:
        k["launches"] = join_launches[k["name"]]
    kernels += join_kernels
    walls.update(join_walls)
    sort_launches, sort_walls, sparse = sort_sql_phase(s, n, orders,
                                                      join_host["q3"])
    sort_kernels = sort_timing_phase(dev, sparse)
    for k in sort_kernels:
        k["launches"] = sort_launches[k["name"]]
    kernels += sort_kernels
    walls.update(sort_walls)
    window_launches, window_walls = window_sql_phase(s)
    window_kernels = window_timing_phase(dev, n, f64_err)
    for k in window_kernels:
        k["launches"] = window_launches[k["name"]]
    kernels += window_kernels
    walls.update(window_walls)
    distinct_launches, distinct_walls = distinct_sql_phase(s)
    distinct_kernels = distinct_timing_phase(dev, n)
    for k in distinct_kernels:
        k["launches"] = distinct_launches[k["name"]]
    kernels += distinct_kernels
    walls.update(distinct_walls)
    delta_launches, delta_walls, delta_inputs = delta_sql_phase(
        s, n, host["q1"], join_host["q3"])
    delta_kernels = delta_timing_phase(dev, delta_inputs)
    for k in delta_kernels:
        k["launches"] = delta_launches[k["name"]]
    kernels += delta_kernels
    walls.update(delta_walls)
    log("walls: " + json.dumps({k: round(v, 4) for k, v in walls.items()}))
    log("join-path launches of the first slice's kernels: " + json.dumps(
        {k: join_launches[k] for k in Q1_KERNELS}))
    log("sort-phase launches of every kernel: " + json.dumps(sort_launches))
    log("window-phase launches of every kernel: " +
        json.dumps(window_launches))
    log("DISTINCT/ROLLUP-phase launches of every kernel: " +
        json.dumps(distinct_launches))
    log("delta-phase launches of every kernel: " +
        json.dumps(delta_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

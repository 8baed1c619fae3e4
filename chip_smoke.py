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
     one lineitem slab (its call profiled once after phase 26: host time
     against the card's), K6 and K7 at the expand statement's build and
     probe;
  9. the sort formulation on the card, over phase 7's tables and two
     sparse-key copies (`orders_sk`, `lineitem_sk`: the same rows keyed by
     the injective map k -> k*0x9E3779B97F4A7C15 mod 2^62, a domain no
     LUT or aligned join takes): TPC-H Q3 (spec 2.4.3 without
     o_shippriority) cold and twice warm, TopN and LIMIT directly over a
     join (EXPLAIN shows both inside the device fragment; LIMIT is held
     by its count and by membership in the host's unlimited join), and
     bench.py's Q3 over the sparse keys (equal to the dense Q3's host
     rows: the key map is injective), and a GROUP BY over a full-range BIGINT token with
     NULLs (`orders_sk.o_ref`: a sort of two radix words, K10's gather
     entry). Counters are zeroed before the phase; K8-K11 must move (K10
     through both its entries), and in the sparse-key statement K11 but
     not K4/K5;
 10. sort kernel timing at the main path's shapes: K8 over 8,388,608
     full-range int64 keys and over the sparse join's 10,485,760 keys
     (each beside torch.sort(stable=True)), K9 over 8,388,608 float64 and
     int64 values, K10's word and gather entries at 8,388,608 rows and
     ~10^5 groups (the word entry beside unique_consecutive; no PyTorch
     call computes the gather entry's function), K11 with 2,097,152 build
     codes and 8,388,608 probes, and on a skewed table (2,097,151 codes in
     [0, 2^21) and one at 2^62) under the same probes, each beside
     torch.searchsorted (K11's call profiled once after phase 26);
 11. window functions on the card, over lineitem and phase 7's tables:
     W1 a chain window root over a filtered scan (every rank function, a
     running SUM with ties, LAG, FIRST_VALUE, NTILE, CUME_DIST over ~1.5M
     small partitions), W2 top-10 per (returnflag, linestatus) through an
     interior ROW_NUMBER, W3 a RANGE frame over the DATE key and a bounded
     ROWS MAX under an outer aggregate, W4 RANK over customer ⋈ orders
     filtered to rank 1, W5 = W2 over 2,097,152-row slabs (one program
     over the concatenated slabs), W6 RANK over a device aggregate's rows
     (WindowExec's device path), each cold (W1, W2, W4, W5 and W6 warm
     once too) under tidb_tpu_strict=1, held against the host engine
     column by column as numpy arrays (float columns within 2·n·eps·|x|); EXPLAIN shows
     W1-W5's windows inside a TpuFragment and W6's outside. Counters are
     zeroed before the phase; K12-K15, K8 and K9 must move (K12-K15 in
     W6 itself);
 12. window kernel timing at phase 11's shapes (8,388,608 rows): K12
     over W1's and W2's layouts, K13's int64 prefix (beside torch.cumsum)
     and segmented max (its time in K13's record as `seg_ms`), K14 over
     W3's RANGE key, K15's bounded MIN and prefix-difference SUM;
 13. DISTINCT and ROLLUP aggregates on the card, over lineitem and
     phase 7's tables: D1 three DISTINCT aggregates (one of two columns)
     and an AVG by (returnflag, linestatus), D2 = D1 over 2,097,152-row
     slabs (per-slab pair sets through the pair ladder, merged on the
     host; its "pairs" rungs are logged), D3 two DISTINCT counts over
     lineitem ⋈ orders, D4 scalar DISTINCT counts (one of two columns),
     R1 Q1's keys WITH ROLLUP, R2 a ROLLUP over lineitem ⋈ orders ⋈
     customer, R3 = R1 over 2,097,152-row slabs; each cold and warm
     once under tidb_tpu_strict=1, exactly equal to the host engine
     (rows sorted where the statement has no ORDER BY), EXPLAIN showing
     its HashAgg inside a TpuFragment. Counters are zeroed before the
     phase; K16-K18 and K8-K10 must move (K16 in every D run, K17 and
     K18 in every R run);
 14. DISTINCT/ROLLUP kernel timing at phase 13's shapes, each held
     exactly to its plain version there: K16's two entries at
     n = 8,388,608 (beside `gids*(n+1)+vid` and `rep[pg] == arange`),
     K17 tiling R1's read columns to 3 x 8,388,608 rows and writing the
     levels of its two key masks (beside torch.cat, repeat_interleave
     and &), K18 through D2's pair cap (beside per-column index_select;
     its call profiled once after phase 26);
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
     32, K18 through the permutation for the raw column;
 17. date, time, CAST and math functions on the card, over the lineitem
     and orders that stand after phase 16: E1 YEAR/QUARTER groups, E2
     DAYOFWEEK/WEEK groups under DATE_ADD(.., 3 MONTH), DAYOFYEAR and
     WEEKDAY filters, E3 DATEDIFF/LAST_DAY/DATE_ADD over lineitem ⋈
     orders, E4 HOUR/MINUTE/UNIX_TIMESTAMP/DAYOFMONTH of DATETIME values
     built by TIMESTAMP and DATE_ADD, E5 SQRT/LN/POW/GREATEST/TRUNCATE/
     CAST aggregates, E6 a SIN/RADIANS/LOG10/EXP/LAST_DAY filter; each
     cold and twice warm under tidb_tpu_strict=1, held against the host
     engine column by column (floats within 2·n·eps·|x|), EXPLAIN
     showing its HashAgg inside a TpuFragment. Counters are zeroed
     before the phase; K20 must move in every run of E1-E4;
 18. K20 at 8,388,608 rows: civil_part for year, week and last_day over
     DATE days and hour over µs, date_add_months over the days, each
     held exactly to its plain version there and timed beside it;
 19. the dictionary string functions on the card, over three tables
     made here from their own seeds: lineitem_str (n rows: l_orderkey,
     l_quantity, l_extendedprice, TPC-H's 7 ship modes and 4 ship
     instructions), orders_str (n/4 rows: TPC-H's 5 order priorities,
     1,000 clerks, 19-78-character comments of a fixed word list, nearly
     all distinct, 1% of them with "special requests") and shipmode (7
     rows): S1 INSTR/CHAR_LENGTH filters, S2 LENGTH/ASCII group keys, S3
     TPC-H Q13's NOT LIKE '%special%requests%' with SUM(LENGTH), S4
     LOCATE/INSTR/CHAR_LENGTH over the comments, S5 FIND_IN_SET and LIKE
     over lineitem_str ⋈ orders_str, S6 UPPER/SUBSTR under IS NOT NULL,
     S7 a string equi-join (KeyRemap); each cold and warm once under
     tidb_tpu_strict=1, exactly equal to the host engine, EXPLAIN showing
     its aggregate inside a TpuFragment, the host preparation and upload
     of its dictionary tables (collect_preps) timed with their bytes.
     Counters are zeroed before the phase; K21 must move in every run.
     Two refused shapes (UPPER(o_comment) = 'X', LOCATE(l_shipmode,
     'REG AIR')) show no TpuFragment and launch nothing (the host engine
     runs them);
 20. K21 at 8,388,608 rows: 7-entry int64 and bool tables, o_comment's
     1,500,303-entry int64 table over random codes, and fill mode, each
     held exactly to its plain version there and timed beside it and
     beside torch.take of the clamped codes;
 21. same-plan micro-batching on the card, over lineitem as the earlier
     phases left it (one 8,388,608-row slab; l_orderkey is random, so
     zone maps keep it for every key): M1, 16 point reads of three
     columns by l_orderkey (about 4 rows each), and M2, 5 range reads
     with three DECIMAL parameters (l_extendedprice in a 20.00-wide
     range, l_discount equal; about 100 rows each). Each batch: every
     member once solo (the individual oracle, equal to the host
     engine), then all of them piled up behind the held scheduler (the
     leader queued, the followers parked) and released; twice. Under
     tidb_tpu_strict=1 every member equals its solo run, the members'
     launches sum to one per surviving slab, K22 and K18 launch once
     per slab, and the batch counters move by 1 and by the member
     count; the batch wall, the solo walls and the leader's compute,
     fetch, decode and d2h bytes are logged;
 22. K22 at B = 16, cap = 8,388,608 over M1's own live mask and over a
     half-live one, each held exactly to its plain version there and
     timed beside it and beside torch.nonzero, each call profiled once
     after phase 26 (host time against the card's);
 23. distributed SQL with tidb_tpu_dist_devices = 4 (four ranks, all on
     the one card) over lineitem as phases 15-22 left it and phase 7's
     orders: X1 = Q1 on the staged agg path (rank partials, host merge),
     twice; X2 = lineitem ⋈ orders on the order key with a GROUP BY
     through StagedDistExchange on hash exchanges (K23); X2B = bench.py's
     Q3 text, whose planner picks a broadcast exchange; X3 = a COUNT
     DISTINCT re-key exchange. Every dist statement encodes on the host,
     so each run is cold. Under tidb_tpu_strict=1 each equals the host
     engine exactly, EXPLAIN shows shards:4 (and the Exchange and its
     kind for X2, X2B, X3), K23 moves on X2 and X3; each run's wall,
     PhaseTimer phases, d2h bytes and K23/K18 launches are logged.
     Counters are zeroed before the phase;
 24. K23 on X2's first exchange call's own inputs (one rank's slab,
     2,097,152 rows at SF=1), held exactly to its plain version there and
     timed beside it and beside torch.argsort + index_copy_;
 25. the monolithic distributed program (DistTreeProgram: 4 ranks on the
     card, the collectives device-side copies) under tidb_tpu_strict=1:
     X1 with tidb_tpu_dist_staged off (gather of partials, K25 + K26),
     X2, X2B and X3 with tidb_tpu_dist_staged_exchange off (hash
     exchanges through K24, a broadcast through K25), X4 = a TopN over a
     join's rows and X5 = bench.py's Q5 (lineitem ⋈ orders ⋈ customer by
     c_mktsegment: an Exchange over a join) with both off. Each equals
     the host engine exactly (phase 23's host rows for X1-X3 and X2B),
     EXPLAIN shows shards:4 and the expected Exchange kinds, the expected
     kernels' counters move; wall, PhaseTimer phases, h2d/d2h bytes and
     escalation counts are logged. Counters are zeroed before the phase;
 26. K24 at X2's first monolithic exchange, K25 at X2B's broadcast and
     K26 at X1's and X3's gathered partials, on the inputs those calls
     had, each held exactly to its plain version there and timed beside
     it and beside a yardstick the port never calls (argsort +
     index_copy_; torch.cat; the plain torch hash); K24 with its K26
     routing pass also beside K23 + torch.cat of the bucket slices, and
     K25's call profiled once (host time against the card's).

Phase 3 also holds K4 lut_build, K5 lut_probe (also at n = 4k ± 1
over key, mask and live views off their vector boundaries), K6
lut_order and K7 join_expand, and K8 radix_sort, K9 sort_encode, K10
group_ids (both entries: the word entry over K8's sorted word and the
gather entry for two-word sorts, with NaN, ±0.0, ±inf, NULLs, dead rows,
a dead row keyed like the last live one, cap overflow) and K11
sorted_search (every entry, also on negative, full-range, sentinel-only,
equal-run and skewed tables with INT64_MAX and INT64_MIN probes)
against their plain versions, exactly; the sort functions
built on K8-K10 (factorize, sort_perm, topn, pack_codes) equal the same
functions over CPU copies of the inputs; and K12 window_bounds, K13
window_scan, K14 frame_bounds and K15 frame_eval against theirs, every
entry, exactly except K13's float64 prefixes (within 2·i·eps·Σ|x|);
and K16 distinct_pairs, K17 rollup_tile and K18 gather_columns against
theirs exactly (random gids with dead rows, value ranks with ties,
1/2/4/8-byte columns and a 2-D limb plane, n_valid below and at the
cap; K18 also at 1-65 columns over odd-offset views and out-of-range
indices), with the pair factorize on K8-K10 + K16 equal to its CPU run;
and K19 delta_merge against delta_merge_plain exactly (its partition,
every packed width, dict, raw and wide columns through K18, four
tombstone sets); and K20 civil_date against its plain version exactly
(every part over every day of 0001-9999, the int32 extremes, int64 days
and µs; DATE_ADD by months for constant and per-row counts); and K21
dict_lut against its plain version exactly (bool/int32/int64 tables from
empty to 1,500,303 entries, across the shared-memory edge, int32/int64
codes out of range, n up to a full slab, clip and fill); and K22
member_compact against its plain version exactly (B = 1, 3, 16; cap =
1, 1,000, 8,388,608; no, all and random live rows; cap at the 128 KB
tile ± 1 over mask views 0-15 bytes off, one live row in the last
member); and K23
hash_partition against its plain version exactly (1, 4, 64
destinations; n = 1, 1,025, 2,097,152; int64, int32 + bool and float
keys; an overflowing cap); and K24 rank_exchange, K25 rank_gather and
K26 hash_dest against theirs exactly (n = 1, 1,025, 2,097,152 rows over
1, 4, 64 ranks; K26 over keys and an int64 code; K24 routed by K26's
destinations and by destinations outside the ranks, its need shared by
every source; mixed itemsizes, dead rows, an overflowing cap). Phase 4's TopN scan must launch K8-K10.

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

# a GROUP BY over a full-range BIGINT with NULLs (orders_sk.o_ref, a
# 64-bit token such as a hashed external id): its sort (dead flag, NULL
# flag, 64 value bits) takes two radix words, so K10 runs its gather entry
REF_GROUPS = """SELECT o_ref, COUNT(*), MIN(o_orderdate) FROM orders_sk
 GROUP BY o_ref ORDER BY o_ref"""

SF1_ROWS = 6_001_215
KERNELS = ("segment_reduce", "unpack_decode", "perfect_groups",
           "lut_build", "lut_probe", "lut_order", "join_expand",
           "radix_sort", "sort_encode", "group_ids", "group_ids_words",
           "sorted_search")
# the first slice's path (Q1/Q6/TopN) runs these; the join path the first
# seven; the sort formulation the last five, K10 as two entries (the
# windows' K12-K15 are WINDOW_KERNELS, with phase 11)
Q1_KERNELS = KERNELS[:3]
JOIN_KERNELS = KERNELS[:7]
SORT_KERNELS = KERNELS[7:]
K10_ENTRIES = ("group_ids", "group_ids_words")


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
    g = torch.Generator(device=dev).manual_seed(1)   # made on the card
    worst = 0.0
    # the path edges (lane-private columns up to 32, a block accumulator
    # up to 4096, global atomics above) and a column all in one slot (at
    # 1024 as a scalar aggregate's calls, Q6's, make it)
    for cap in (1, 12, 20, 32, 33, 1024, 4096, 4097, 65536, -12, -1024,
                -4097):
        skew = cap < 0
        cap = abs(cap)
        gids = torch.randint(-1, cap + 1, (n,), generator=g,
                             dtype=torch.int32, device=dev)
        if skew:
            gids = torch.where((gids < 0) | (gids >= cap), gids,
                               torch.full_like(gids, cap - 1))
        for dt in (torch.int64, torch.int32, torch.float64):
            if dt == torch.float64:
                data = torch.randn(n, generator=g, dtype=torch.float64,
                                   device=dev)
            else:
                data = torch.randint(-10 ** 6, 10 ** 6, (n,), generator=g,
                                     dtype=dt, device=dev)
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
    # bool masks reduce natively: COUNT in int32 / int64, ANY as an int32
    # max (segment_count / segment_any), from aligned tensors and from
    # views one row in (the scalar loads)
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    for cap in (1, 12, 33, 4097):
        gids = torch.randint(-1, cap + 1, (n,), generator=g,
                             dtype=torch.int32, device=dev)
        for off in (0, 1):
            m, gi = mask[off:], gids[off:]
            for op, dt in (("sum", torch.int32), ("sum", torch.int64),
                           ("max", torch.int32)):
                if not torch.equal(seg.segment_reduce(op, m, gi, cap, dt),
                                   seg.segment_reduce_plain(op, m, gi, cap,
                                                            dt)):
                    raise AssertionError(f"K1 bool {op} {dt} cap={cap}: "
                                         f"kernel != plain")
    # the small path's f64 sums are one fixed order: the same bits twice
    data = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    for cap in (1, 12, 32):
        gids = torch.randint(-1, cap + 1, (n,), generator=g,
                             dtype=torch.int32, device=dev)
        a = seg.segment_reduce("sum", data, gids, cap)
        b = seg.segment_reduce("sum", data, gids, cap)
        if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
            raise AssertionError(f"K1 f64 sum cap={cap}: two calls differ")
    torch.cuda.synchronize()
    log(f"K1 segment_reduce: exact on int64/int32/bool, f64 sum within "
        f"(n-1)*eps*sum|x| (max abs err {worst:.3e}), caps 1/12/20/32/33/"
        f"1024/4096/4097/65536 and all rows in one slot at 12, 1024 and "
        f"4097; bool COUNT/ANY native, aligned and one row in; small-cap f64 "
        f"sums bit-equal call to call")
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
    for k in ("radix_sort", "sort_encode"):
        if per_query["topn"][k] == 0:
            raise AssertionError(f"the TopN scan did not launch {k}")
    if not any(per_query["topn"][k] for k in K10_ENTRIES):
        raise AssertionError("the TopN scan launched neither K10 entry")
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
    # K5's vector steps at their edges: n at multiples of 4 ± 1, key views
    # 1-3 elements and mask / live views 1-15 bytes off their boundaries,
    # int32 and int64 keys, all-dead and all-live probes, both modes
    t_edges = time.perf_counter()
    ebounds = [(0, 999), (-5, 4)]
    edom = 10_000
    ebkeys = _join_keys(rng, 7_000, ebounds, 0.05, 0, dev)
    ecnt, elut, _, ecodes = J.lut_build(ebkeys, ebounds, edom,
                                        want_codes=True)
    estarts, _ = J.lut_order(ecodes, ecnt)
    for n in (1, 3, 4, 5, 1023, 1025, 1_048_577):
        for off in (0, 1, 3, 15):
            keys = []
            for q, (v, m) in enumerate(_join_keys(rng, n + 16, ebounds, 0.1,
                                                  3, dev)):
                dt = torch.int32 if (q + off) % 2 else torch.int64
                keys.append((v.to(dt)[off % 4:off % 4 + n], m[off:off + n]))
            for kind in ("random", "dead", "live"):
                lv = torch.from_numpy(rng.random(n + 16) > 0.1).to(dev) \
                    if kind == "random" else \
                    torch.full((n + 16,), kind == "live", device=dev)
                live = lv[15 - off:15 - off + n]
                for table, uq in ((elut, True), (estarts, False)):
                    a = J.lut_probe(keys, ebounds, ecnt, table, live, 7_000,
                                    uq)
                    b = J.lut_probe_plain(keys, ebounds, ecnt, table, live,
                                          7_000, uq)
                    torch.cuda.synchronize()
                    if not (torch.equal(a[0], b[0]) and
                            torch.equal(a[1], b[1])):
                        raise AssertionError(f"K5 n={n} off={off} {kind} "
                                             f"unique={uq}: kernel != plain")
                    cases += 1
    log(f"K4-K7 lut_build/lut_probe/lut_order/join_expand: {cases} cases "
        f"exactly equal to the plain versions (1-3 key columns, NULL and "
        f"out-of-domain keys, n_live, unique/duplicated/skewed builds, "
        f"outer/inner, out_cap < total, P=0, nb=1; K5 at n = 4k ± 1 over "
        f"key, mask and live views off their boundaries, int32 and int64 "
        f"keys, all-dead and all-live probes, both modes, in "
        f"{time.perf_counter() - t_edges:.1f} s)")


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
    # the probe keys, mask and live read once, the lut (one entry a code)
    # read once, match_idx and matched written once
    b, by = bound_ms(P * (8 + 1 + 1) + (domain + 1) * 4 + P * (4 + 1),
                     P * 8)
    out.append({"name": "lut_probe", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/lut_join.cu",
                "replaces": "tidb_tpu/ops/join.py:93",
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K5 lineitem slab P={P} into D={domain}: {ms:.4f} ms (plain "
        f"{plain:.4f}, take {lib:.4f}, bound {b:.4f} by {by})")
    DEFERRED_PROFILES.append((
        "K5 at the lineitem slab",
        lambda: J.lut_probe(pkeys, bounds, cnt, lut, plive, nb, True),
        ("lut_probe",)))

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


def _k10_case(rng, case, n):
    """→ (key values, NULL mask or None, live, radix words of its sort)
    for K10's cases: NaNs (each its own group) beside +inf, -0.0 beside
    +0.0, -inf, all NaN (a value field of no bits), NULLs, a dead row
    keyed like the last live one, all rows dead; and two sorts of two
    words (NaN and ±0.0 with NULLs; a full-range int64 with NULLs)."""
    import numpy as np
    live = rng.random(n) > 0.2
    m = rng.random(n) > 0.15
    if case == "nan":
        v = rng.choice(np.array([2.0, 3.5, 4.0, 1e300, np.inf, np.nan]), n)
        return v, None, live, 1
    if case == "signed_zero":
        return rng.choice(np.array([-0.0, 0.0, 0.5, 3.0]), n), None, live, 1
    if case == "neg_inf":
        v = rng.choice(np.array([-np.inf, -1e300, -2.0, -3.5]), n)
        return v, None, live, 1
    if case == "all_nan":
        return np.full(n, np.nan), None, live, 1
    if case == "nulls":
        return rng.integers(-40, 40, n).astype(np.int64), m, live, 1
    if case == "dead_equal":
        v = rng.integers(0, 9, n).astype(np.int64)
        k = min(n, 5)
        v[:k] = 9
        live[:k] = [True, False, True, False, False][:k]
        return v, None, live, 1
    if case == "all_dead":
        return rng.integers(0, 30, n).astype(np.int32), m, \
            np.zeros(n, dtype=bool), 1
    if case == "nan_two_words":
        v = rng.choice(np.array([0.0, -0.0, -np.inf, np.inf, 1.5, np.nan]),
                       n)
        return v, m, live, 2
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)  # two_words
    v[:n // 3] = rng.integers(-3, 3, n // 3)
    return v, m, live, 2


K10_CASES = ("nan", "signed_zero", "neg_inf", "all_nan", "nulls",
             "dead_equal", "all_dead", "nan_two_words", "two_words")


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
        # the group count) and _dense1 modes, with NULLs and dead rows;
        # the gather entry on every sort, the word entry (and its plain
        # version) on the one-word sorts, and the route the word count
        # picks against the plain route on CPU copies
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
        for case in K10_CASES:
            hv, hm, hl, n_words = _k10_case(rng, case, n)
            hv, hl = torch.from_numpy(hv), torch.from_numpy(hl)
            hm = None if hm is None else torch.from_numpy(hm)
            dv, dl = hv.to(dev), hl.to(dev)
            dm = None if hm is None else hm.to(dev)
            ops = F._key_operands([(dv, dm)], dl)
            sidx, words = F._lexsort_kernel(ops)
            if n > 1 and words.count != n_words:
                raise AssertionError(f"K10 {case}: {words.count} words, "
                                     f"{n_words} expected")
            n_words = words.count       # one row: no operand takes bits
            for cap in (0, 3, n + 1):
                want = F.group_ids_plain(sidx, dv, dm, dl, cap)
                same(f"K10 gather {case} cap={cap} n={n}",
                     F.group_ids(sidx, dv, dm, dl, cap), want)
                if n_words == 1:
                    key = F._word_key(words)
                    same(f"K10 words {case} cap={cap} n={n}",
                         F.group_ids_words(words.last, sidx, *key, cap),
                         want)
                    same(f"K10 words plain {case} cap={cap} n={n}",
                         F.group_ids_words_plain(words.last, sidx, *key,
                                                 cap), want)
                same(f"K10 route {case} cap={cap} n={n}",
                     F._sort_groups_kernel(ops, dv, dm, dl, cap),
                     F._sort_groups(F._key_operands([(hv, hm)], hl), hv,
                                    hm, hl, cap))
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
    cases += check_k11_edges(dev, rng, same)
    torch.cuda.synchronize()
    log(f"K8-K11 radix_sort/sort_encode/group_ids(_words)/sorted_search: "
        f"{cases} cases exactly equal to the plain versions (n = 1, 1000, "
        f"4097, 1,000,003; int32/int64/float64 with ±0.0, ±inf, NaN/bool/"
        f"dict codes; ASC/DESC, NULLs, dead rows; all-equal, sorted, "
        f"reversed keys; a 1-bit partition; K10's word entry and its "
        f"gather entry on one- and two-word sorts ({', '.join(K10_CASES)}); "
        f"1-3 key columns through factorize/sort_perm/topn/pack_codes; cap "
        f"below n_groups; K11 with duplicates, missing keys, sentinels, "
        f"nb = 1, P = 0, and its three entries on negative, full-range, "
        f"sentinel-only, equal-run and skewed tables with probes equal to "
        f"INT64_MAX and INT64_MIN)")


I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


def _k11_table(rng, kind, nb):
    """(build codes, ok_b, the values probes draw from) of one edge table:
    negative codes; the full int64 range INT64_MIN .. INT64_MAX - 1; dead
    rows only (a table of sentinels); runs of five equal codes (spaced
    3 apart, so runs cross the directory's bucket edges); the skewed table
    (nb - 1 codes in [0, nb) and one at 2^62)."""
    import numpy as np
    ok = np.ones(nb, dtype=bool)
    if kind == "negative":
        pool = np.sort(rng.integers(-(1 << 40), -5, nb))
    elif kind == "full-range":
        pool = np.sort(np.concatenate([
            rng.integers(I64_MIN, I64_MAX, max(nb - 2, 0), dtype=np.int64),
            [I64_MIN, I64_MAX - 1]]))[:nb]
    elif kind == "sentinels":
        pool = rng.integers(0, 1 << 40, nb)
        ok[:] = False
    elif kind == "runs":
        pool = np.repeat(np.arange(0, nb, 3, dtype=np.int64), 5)[:nb]
    else:
        pool = np.concatenate([np.arange(nb - 1, dtype=np.int64),
                               [1 << 62]])
    return rng.permutation(pool), ok, pool


def _k11_probes(rng, pool, P):
    """Probes: pool values, their neighbours, INT64_MAX, INT64_MIN and
    the whole int64 range."""
    import numpy as np
    base = pool[rng.integers(0, len(pool), P)]
    pick = rng.random(P)
    with np.errstate(over="ignore"):
        near = base + rng.integers(-1, 2, P)
    return np.where(pick < 0.6, base, np.where(
        pick < 0.75, near, np.where(pick < 0.8, I64_MAX, np.where(
            pick < 0.85, I64_MIN,
            rng.integers(I64_MIN, I64_MAX, P, dtype=np.int64)))))


def check_k11_edges(dev, rng, same) -> int:
    """K11's three entries (unique, multi, searchsorted left and right)
    exactly against their plain versions on the directory's edge tables,
    with probes equal to INT64_MAX and INT64_MIN, and on a probe view off
    its 16-byte alignment."""
    import torch
    from tidb_tpu_torch.ops import join as J
    cases = 0
    for kind, nb, P in (("negative", 70_001, 300_001),
                        ("full-range", 70_001, 300_001),
                        ("full-range", 1, 1_000),
                        ("sentinels", 4_097, 100_003),
                        ("sentinels", 1, 1_000),
                        ("runs", 300_000, 1_000_001),
                        ("skewed", 2_097_152, 1_000_000)):
        bc, okb, pool = _k11_table(rng, kind, nb)
        codes = torch.from_numpy(bc).to(dev)
        ok_b = torch.from_numpy(okb).to(dev)
        probe = torch.from_numpy(_k11_probes(rng, pool, P)).to(dev)
        ok_p = torch.from_numpy(rng.random(P) > 0.1).to(dev)
        sc, order = J.sorted_build(codes, ok_b)
        for pv, okv in ((probe, ok_p), (probe[1:], ok_p[1:])):
            same(f"K11 unique {kind} nb={nb}",
                 J.sorted_search_unique(sc, order, pv, okv),
                 J.sorted_search_unique_plain(sc, order, pv, okv))
            same(f"K11 multi {kind} nb={nb}",
                 J.sorted_search_multi(sc, pv, okv),
                 J.sorted_search_multi_plain(sc, pv, okv))
            for right in (False, True):
                same(f"K11 search {kind} nb={nb} right={right}",
                     J.searchsorted(sc, pv, right),
                     torch.searchsorted(sc, pv, right=right))
            cases += 4
    return cases


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
            perm, n_live = F.sort_perm([pkey] + okeys,
                                       [False, desc][:1 + len(okeys)], tl)
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
            # window_bounds (its own flags launch, then the positions)
            # against its two halves: with sort_perm's n_live (the
            # window emit's call) and without, with and without `live`,
            # int64 and int32 permutations
            for pm in (perm, perm.to(torch.int32)):
                for nl in (n_live, None):
                    b = W.window_bounds(pm, tl, keys, 1, nl)
                    same(f"K12 bounds {tag}", b[:2] + tuple(b[2]),
                         flags + tuple(pos))
            b = W.window_bounds(perm, None, keys, 1)
            same(f"K12 bounds no live {tag}", b[:2] + tuple(b[2]),
                 W.window_flags_plain(perm, None, keys, 1) +
                 tuple(W.window_positions_plain(b[0], b[1])))
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
        # 9 keys: window_bounds takes the chunked flags entry
        keys9 = [pkey] + ([(t[k], tm[k]) for k in ("i32", "f64", "dec")]
                          * 3)[:8]
        perm, n_live = F.sort_perm(keys9, [False] * 9, tl)
        b = W.window_bounds(perm, tl, keys9, 2, n_live)
        want = W.window_flags_plain(perm, tl, keys9, 2)
        same(f"K12 bounds 9 keys n={n}", b[:2] + tuple(b[2]),
             want + tuple(W.window_positions_plain(*want)))
    torch.cuda.synchronize()
    log(f"K12-K15 window_bounds/window_scan/frame_bounds/frame_eval: "
        f"{cases} cases equal to the plain versions (n = 1, 5,000, "
        f"2,000,000 with one 10^6-row partition and 1-50-row ones; int32 / "
        f"float64 (±0.0, NaN) / DECIMAL ORDER BY keys ASC and DESC with "
        f"NULLs, dead rows, int32 and int64 permutations; K12's "
        f"window_bounds against its two halves, with and without live, "
        f"and at 9 keys; ROWS and RANGE "
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
              "o_orderpriority CHAR(1), o_ref BIGINT)")
    s.execute("CREATE TABLE lineitem_sk (l_extendedprice DECIMAL(15,2), "
              "l_discount DECIMAL(15,2), l_shipdate DATE, l_okey BIGINT)")
    n_o = len(orders["o_orderkey"])
    rng = np.random.default_rng(31)
    tokens = rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, dtype=np.int64)
    orders_sk = {"o_okey": sparse_key(orders["o_orderkey"]),
                 "o_orderdate": orders["o_orderdate"],
                 "o_orderpriority": orders["o_orderpriority"],
                 "o_ref": tokens[rng.integers(0, 4096, n_o)]}
    valid = {"orders_sk": {"o_ref": rng.random(n_o) > 0.05}}
    lineitem_sk = {c: li[c] for c in ("l_extendedprice", "l_discount",
                                      "l_shipdate")}
    lineitem_sk["l_okey"] = sparse_key(li["l_orderkey"])
    for name, cols in (("orders_sk", orders_sk),
                       ("lineitem_sk", lineitem_sk)):
        load_numpy_columns(s, name, cols, valid.get(name))
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
                      ("join_rows", JOIN_ROWS), ("ref_groups", REF_GROUPS)):
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = rows
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    # the sparse keys are an injective map of the dense ones: the sparse
    # Q3's rows are phase 7's host Q3 rows (its host run, 13-16 s, was a
    # second reference for the same rows)
    host["q3_sk"] = dense_q3_host
    runs = [("tpch_q3_cold", TPCH_Q3, "tpch_q3"),
            ("tpch_q3_warm1", TPCH_Q3, "tpch_q3"),
            ("tpch_q3_warm2", TPCH_Q3, "tpch_q3"),
            ("topn_join", TOPN_JOIN, "topn_join"),
            ("limit_join", LIMIT_JOIN, None),
            ("q3_sk_cold", Q3_SK, "q3_sk"), ("q3_sk_warm", Q3_SK, "q3_sk"),
            ("ref_groups", REF_GROUPS, "ref_groups")]
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
        if name == "ref_groups" and not moved.get("group_ids"):
            raise AssertionError(f"{name}: K10's gather entry did not run "
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
    # each key read once; the sorted words and their row ids written once
    b, by = bound_ms(n * (8 + 8 + 4), n * 8)
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
    ops = F._key_operands([(v, valid)], live)
    fields = F._fields(ops, nb + P)
    word = torch.empty(nb + P, dtype=torch.int64, device=dev)
    shift = 0
    for j in reversed(range(len(ops))):
        vv, code, base, width, _nan = fields[j]
        F.sort_encode(vv, code, None, ops[j].m, ops[j].desc, base, shift,
                      word, accumulate=shift > 0)
        shift += width
    ms2 = time_cuda(lambda: F.radix_sort(word, None, shift), reps=10)
    plain2 = time_cuda(lambda: F.radix_sort_plain(word, None, shift),
                       reps=5)
    lib2 = time_cuda(lambda: torch.sort(word, stable=True), reps=10)
    exact("K8 sparse-join word", zip(F.radix_sort(word, None, shift),
                                     F.radix_sort_plain(word, None, shift)))
    b2, _ = bound_ms((nb + P) * (8 + 8 + 4), (nb + P) * 8)
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

    # K10: 8,388,608 rows in ~10^5 groups, over the kernel's own sort (one
    # word: the dead flag and 17 value bits): the word entry over K8's
    # sorted word, and the gather entry on the same sort
    gk = torch.from_numpy(rng.integers(0, 100_000, n)).to(dev)
    glive = torch.from_numpy(rng.random(n) > 0.02).to(dev)
    sidx, words = F._lexsort_kernel(F._key_operands([(gk, None)], glive))
    if words.count != 1:
        raise AssertionError(f"K10's sort took {words.count} words")
    key = F._word_key(words)
    cap = 131_072
    sorted_keys = gk[sidx.long()]
    lib = time_cuda(lambda: torch.unique_consecutive(sorted_keys,
                                                     return_inverse=True),
                    reps=10)
    want = F.group_ids_plain(sidx, gk, None, glive, cap)
    ms_w = time_cuda(lambda: F.group_ids_words(words.last, sidx, *key, cap),
                     reps=10)
    plain_w = time_cuda(lambda: F.group_ids_words_plain(words.last, sidx,
                                                        *key, cap), reps=5)
    exact("K10 words", zip(F.group_ids_words(words.last, sidx, *key, cap),
                           want))
    exact("K10 words plain", zip(F.group_ids_words_plain(
        words.last, sidx, *key, cap), want))
    ms = time_cuda(lambda: F.group_ids(sidx, gk, None, glive, cap),
                   reps=10)
    plain = time_cuda(lambda: F.group_ids_plain(sidx, gk, None, glive, cap),
                      reps=5)
    exact("K10 gather", zip(F.group_ids(sidx, gk, None, glive, cap), want))
    fact = time_cuda(lambda: F.factorize([(gk, None)], glive, cap), reps=10)
    # words: the sorted word and the row ids read, the gids written, rep
    b_w, by_w = bound_ms(n * (8 + 4 + 4) + cap * 4, n * 4)
    out.append({"name": "group_ids_words", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/sorted_groups.cu",
                "replaces": "tidb_tpu/ops/factorize.py:96",
                "max_abs_err": 0, "ms": ms_w, "plain_ms": plain_w,
                "bound_ms": b_w, "bound_by": by_w, "library_ms": lib})
    # gather: the permutation, the key and the live mask read, the gids
    # written, rep. No one PyTorch call computes it (unique_consecutive
    # numbers one sorted key in sorted order; the gather entry gathers
    # its words through the permutation and numbers rows in row order)
    b, by = bound_ms(n * (4 + 8 + 1 + 4) + cap * 4, n * 4)
    out.append({"name": "group_ids", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/sorted_groups.cu",
                "replaces": "tidb_tpu/ops/factorize.py:96",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None})
    log(f"K10 n={n} groups={int(want[1])} cap={cap}: word entry "
        f"{ms_w:.4f} ms (plain {plain_w:.4f}, bound {b_w:.4f} by {by_w}); "
        f"gather entry {ms:.4f} ms (plain {plain:.4f}, bound {b:.4f} by "
        f"{by}); unique_consecutive {lib:.4f}; factorize (K9 + K8 + K10) "
        f"{fact:.4f} ms")

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
    # inputs read once (the codes, the build order, each probe key and
    # mask), outputs written once; a bucket's few compares a row
    b, by = bound_ms(nb * (8 + 4) + n * (8 + 1) + n * (4 + 1), n * 8)
    out.append({"name": "sorted_search", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/sorted_groups.cu",
                "replaces": "tidb_tpu/ops/join.py:139",
                "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"K11 nb={nb} P={n} unique: {ms:.4f} ms (plain {plain:.4f}, "
        f"searchsorted {lib:.4f}, bound {b:.4f} by {by})")
    DEFERRED_PROFILES.append((
        "K11 at phase 10's shape",
        lambda: J.sorted_search_unique(sc, order, probe, ok),
        ("dir_build", "dir_probe")))
    # the skewed table: 2,097,151 codes in [0, 2^21) and one at 2^62,
    # which would put nearly every code into one bucket of an untrimmed
    # range; the same probes
    sk = torch.cat([torch.arange(nb - 1, dtype=torch.int64, device=dev),
                    torch.full((1,), 1 << 62, dtype=torch.int64,
                               device=dev)])
    exact("K11 skewed", zip(J.sorted_search_unique(sk, order, probe, ok),
                            J.sorted_search_unique_plain(sk, order, probe,
                                                         ok)))
    ms_sk = time_cuda(lambda: J.sorted_search_unique(sk, order, probe, ok),
                      reps=10)
    lib_sk = time_cuda(lambda: torch.searchsorted(sk, probe), reps=10)
    log(f"K11 skewed table nb={nb} P={n} unique: {ms_sk:.4f} ms "
        f"(searchsorted {lib_sk:.4f}, bound {b:.4f} by {by})")
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


def same_cols(what, got, want, ordered: bool = False,
              n_terms=None) -> float:
    """Hold device columns against the host engine's: validity exactly,
    values exactly where valid — except float columns, within
    2·n·eps·|x| of the host value (the kernels sum in another order),
    n the number of terms a value may sum: the result's rows (a window's
    partition), or `n_terms` → the largest float difference seen. An
    unordered result that differs in row order is compared again in a
    canonical order."""
    import numpy as np
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} columns != {len(want)}")
    if not ordered:
        try:
            return same_cols(what, got, want, ordered=True,
                             n_terms=n_terms)
        except AssertionError:
            got, want = _canonical(got), _canonical(want)
    err = 0.0
    for ci, ((gv, gm), (hv, hm)) in enumerate(zip(got, want)):
        if gv.shape != hv.shape or not np.array_equal(gm, hm):
            raise AssertionError(f"{what}: column {ci} rows/NULLs differ")
        gv, hv = gv[hm], hv[hm]
        if hv.dtype.kind == "f":
            d = np.abs(gv - hv)
            tol = 2 * max(n_terms or len(hv), 1) * EPS64 * \
                np.maximum(np.abs(hv), 1.0)
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
        # W3's warm run (4 s of host work) cut for time
        for k in ("cold",) if name == "w3" else ("cold", "warm1"):
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
        # as the window emit calls it, with sort_perm's count of live rows
        return W.window_bounds(perm, live, keys, np_, n_lives[id(perm)])

    def k12_plain(perm, live, keys, np_):
        return W.window_bounds_plain(perm, live, keys, np_)

    # K12 over W1's layout (l_shipdate >= 1998-08-01 live; one partition
    # key, two order keys) and W2's (two dictionary-code partition keys,
    # two order keys)
    live1 = rows & (ship >= 10439)
    k1 = [(okey, ones), (ship, ones), (price, ones)]
    perm1, nl1 = F.sort_perm(k1, [False] * 3, live1)
    k2 = [(codes["l_returnflag"], ones), (codes["l_linestatus"], ones),
          (price, ones), (okey, ones)]
    perm2, nl2 = F.sort_perm(k2, [False, False, True, False], rows)
    n_lives = {id(perm1): nl1, id(perm2): nl2}
    timed = {}
    for tag, perm, live, keys, np_ in (("W1", perm1, live1, k1, 1),
                                       ("W2", perm2, rows, k2, 2)):
        timed[tag] = (time_cuda(lambda: k12(perm, live, keys, np_), reps=10),
                      time_cuda(lambda: k12_plain(perm, live, keys, np_),
                                reps=3))
        got, want = k12(perm, live, keys, np_), k12_plain(perm, live, keys,
                                                           np_)
        exact(f"K12 {tag}", got[:2] + tuple(got[2]),
              want[:2] + tuple(want[2]))
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
                "bound_ms": b, "bound_by": by, "library_ms": lib,
                "seg_ms": seg_ms})
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
    cases += check_k18_edges(dev, rng)
    torch.cuda.synchronize()
    log(f"K16/K17/K18 exactly equal to their plain versions ({cases} "
        f"cases; K18 also at 1, 3, 64 and 65 columns over views at odd "
        f"byte offsets, out-of-range int32/int64 indices, an index off "
        f"its 16-byte alignment, n_valid 0 and m, m = 1-5 and 40,001-"
        f"40,003); the pair factorize on K8-K10 + K16 equal to its CPU "
        f"run")


def check_k18_edges(dev, rng) -> int:
    """K18 at the edges of its design, exactly against its plain version
    (through clamped indices, then zero values and false masks where an
    index lies outside [0, n_src)): 1, 3, 64 and 65 columns (65: two
    launches) of 1/2/4/8-byte dtypes, every third column and its mask a
    view one element into its buffer (odd byte offsets), int32 and int64
    indices with out-of-range ones, an index view off its 16-byte
    alignment, n_valid 0, below m and m, and m not a multiple of the four
    slots a thread takes."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import gather as G
    dts = [np.bool_, np.int16, np.int32, np.float64, np.uint8, np.int64,
           np.float32]
    cases = 0
    for ncols in (1, 3, 64, 65):
        n = 90_000 if ncols < 64 else 5_000
        cols = []
        for c in range(ncols):
            dt = dts[c % len(dts)]
            off = 1 if c % 3 == 2 else 0
            if dt == np.bool_:
                a = rng.random(n + off) < 0.5
            elif dt in (np.float64, np.float32):
                a = rng.normal(size=n + off).astype(dt)
            else:
                a = rng.integers(-100, 100, n + off).astype(dt)
            v = torch.from_numpy(a).to(dev)[off:]
            m = None
            if c % 2 == 0:
                m = torch.from_numpy(rng.random(n + off) < 0.7).to(dev)[off:]
            cols.append((v, m))
        for idx_dt in (np.int32, np.int64):
            for m_out in (1, 3, 4, 5, 40_001, 40_002, 40_003):
                full = torch.from_numpy(rng.integers(
                    -3, n + 3, m_out + 1).astype(idx_dt)).to(dev)
                for off in (0, 1):
                    ix = full[off:off + m_out]
                    inside = (ix >= 0) & (ix < n)
                    for nv in (0, m_out // 3, m_out):
                        n_valid = torch.tensor(nv, dtype=torch.int32,
                                               device=dev)
                        got = G.gather_columns(cols, ix, n_valid)
                        want = G.gather_columns_plain(
                            cols, ix.clamp(0, n - 1), n_valid)
                        for (a, am), (b, bm) in zip(got, want):
                            b = torch.where(inside, b, torch.zeros_like(b))
                            if not (torch.equal(a, b) and
                                    torch.equal(am, bm & inside)):
                                raise AssertionError(
                                    f"K18 at {ncols} columns, m = {m_out}, "
                                    f"n_valid = {nv}, index offset {off} "
                                    f"differs from its plain version")
                        cases += 1
    return cases


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
    """D1-D4 and R1-R3 cold and warm once under tidb_tpu_strict=1, each
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
        for k in ("cold", "warm1"):
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
    # the pair codes carry their bound, so their sort is one word: K10's
    # word entry
    for k in DISTINCT_KERNELS + ("radix_sort", "sort_encode",
                                 "group_ids_words"):
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
    DEFERRED_PROFILES.append((
        "K18 at phase 14's shape",
        lambda: G.gather_columns(gcols, idx, s_pairs), ("gather_kernel",)))
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
# phase 3 (calendar): K20 against its plain version
# ---------------------------------------------------------------------------

DAY_US = 86_400_000_000
DAY_0001 = -719162           # 0001-01-01 in days since 1970-01-01
DAY_9999 = 2932896           # 9999-12-31


def _calendar_inputs(dev):
    """Every day of 0001-9999 plus the int32 extremes and days beyond
    MySQL's range (int32), and µs at random times of day on both sides of
    the epoch plus the int64 extremes."""
    import numpy as np
    import torch
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
    days = np.concatenate([
        np.arange(DAY_0001, DAY_9999 + 1),
        [i32.min, i32.min + 1, -10**9, DAY_0001 - 1, -719468, -719469, -1,
         DAY_9999 + 1, 10**9, i32.max - 719468, i32.max - 1, i32.max]])
    rng = np.random.default_rng(20)
    us = np.concatenate([
        rng.integers(DAY_0001, DAY_9999 + 1, 1 << 21) * DAY_US
        + rng.integers(0, DAY_US, 1 << 21),
        rng.integers(i64.min, i64.max, 1 << 16, endpoint=True),
        [i64.min, i64.min + 1, -DAY_US - 1, -1, 0, DAY_US - 1, i64.max]])
    return (torch.from_numpy(days.astype(np.int32)).to(dev),
            torch.from_numpy(us.astype(np.int64)).to(dev))


def check_calendar_kernels(dev):
    """K20 civil_date against its plain version on the same CUDA tensors,
    exactly (values and dtypes): every part over every day of 0001-9999,
    the int32 extremes and negative days (as int32 and as int64 days),
    and over µs at random times of day before and after the epoch;
    date_add_months for n in {-1200, -13, -1, 0, 1, 11, 12, 13, 1200}
    and a per-row n over the same days and µs, with months, quarters and
    years, and the month-end cases spelled out."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import calendar as CAL
    days, us = _calendar_inputs(dev)
    cases = 0

    def same(what, got, want):
        nonlocal cases
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got != want).nonzero()[:3].flatten().tolist()
            raise AssertionError(f"K20 {what} differs from its plain "
                                 f"version (rows {bad})")
        cases += 1

    for part in CAL.PARTS:
        for v, micros in ((days, False), (days.long(), False), (us, True)):
            same(f"{part} {v.dtype} micros={micros}",
                 CAL.civil_part(v, part, micros),
                 CAL.civil_part_plain(v, part, micros))
    rng = np.random.default_rng(21)
    for mult in (1, 3, 12):
        for v, micros in ((days, False), (us, True)):
            n = torch.from_numpy(rng.integers(-1200, 1201, v.shape[0])).to(
                dev)
            for k in (n, -1200, -13, -1, 0, 1, 11, 12, 13, 1200):
                same(f"date_add_months x{mult} micros={micros} "
                     f"n={'tensor' if isinstance(k, torch.Tensor) else k}",
                     CAL.date_add_months(v, micros, k, mult),
                     CAL.date_add_months_plain(v, micros, k, mult))
    # Jan 31 + 1 month, Feb 29 ± 1 year, 1900 / 2000 / 2100 leap rules
    spot = torch.tensor([18292, 18321, 18321, -25537, 10987, 47512],
                        dtype=torch.int32, device=dev)
    got = CAL.date_add_months(spot, False, torch.tensor(
        [1, 12, -12, 1, 1, 1], device=dev), 1)
    want = [18321, 18686, 17955, -25509, 11016, 47540]
    if got.tolist() != want:
        raise AssertionError(f"K20 month-end cases {got.tolist()} != "
                             f"{want}")
    torch.cuda.synchronize()
    log(f"K20 exactly equal to its plain version ({cases} cases: "
        f"{days.shape[0]} days, {us.shape[0]} µs values, every part and "
        f"DATE_ADD by months)")


# ---------------------------------------------------------------------------
# phase 3 (dictionary LUTs): K21 against its plain version
# ---------------------------------------------------------------------------

#: table sizes: empty, one entry, l_shipmode's 7, the largest table staged
#: in shared memory and the smallest one above it (per entry width), and
#: o_comment's dictionary at SF=1
K21_SIZES = ("0", "1", "7", "edge", "edge+1", "1500303")


def _k21_size(size: str, dtype) -> int:
    from tidb_tpu_torch.ops import dict_lut as DL
    import torch
    edge = DL.SMEM_BYTES // torch.tensor([], dtype=dtype).element_size()
    return {"edge": edge, "edge+1": edge + 1}.get(size) or int(size)


def check_dict_lut_kernels(dev):
    """K21 dict_lut against its plain version on the same CUDA tensors,
    exactly (values and dtypes): bool, int32 and int64 tables of every
    K21_SIZES size, int32 and int64 codes with negatives, codes at and
    past the table's end, the NULL code (0) and the int32 extremes, n of
    0, 1, an odd count and a full slab (8,388,608), clip and fill modes;
    an empty table raises IndexError in clip mode, as its plain version
    and jnp.take do."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import dict_lut as DL
    smem = ck.library("dict_lut").tt_dict_lut_smem_bytes()
    if smem != DL.SMEM_BYTES:
        raise AssertionError(f"K21 stages {smem} bytes in shared memory, "
                             f"ops/dict_lut.py says {DL.SMEM_BYTES}")
    g = torch.Generator(device=dev).manual_seed(21)
    cases = 0
    for dtype in (torch.bool, torch.int32, torch.int64):
        for size in K21_SIZES:
            n_lut = _k21_size(size, dtype)
            raw = torch.randint(-(1 << 40), 1 << 40, (n_lut,), device=dev,
                                generator=g)
            table = (raw & 1).bool() if dtype == torch.bool else \
                raw.to(dtype)
            for code_dtype in (torch.int32, torch.int64):
                for n in (0, 1, 100_003, FULL_SLAB):
                    codes = torch.randint(-3, n_lut + 3, (n,), device=dev,
                                          generator=g, dtype=code_dtype)
                    special = torch.tensor(
                        [0, -1, n_lut, n_lut + 1, -(1 << 31),
                         (1 << 31) - 1, max(n_lut - 1, 0)],
                        dtype=code_dtype, device=dev)[:n]
                    codes[:special.shape[0]] = special
                    for mode in DL.MODES:
                        if mode == "clip" and n_lut == 0 and n > 0:
                            for fn in (DL.dict_lut, DL.dict_lut_plain):
                                try:
                                    fn(table, codes, mode)
                                except IndexError:
                                    continue
                                raise AssertionError(
                                    "K21 clip over an empty table did not "
                                    "raise IndexError")
                            cases += 1
                            continue
                        got = DL.dict_lut(table, codes, mode, -1)
                        want = DL.dict_lut_plain(table, codes, mode, -1)
                        if got.dtype != want.dtype or \
                                not torch.equal(got, want):
                            raise AssertionError(
                                f"K21 {mode} differs from its plain version "
                                f"({dtype} table of {n_lut}, {code_dtype} "
                                f"codes, n={n})")
                        cases += 1
    torch.cuda.synchronize()
    log(f"K21 exactly equal to its plain version ({cases} cases: bool, "
        f"int32 and int64 tables of {list(K21_SIZES)} entries, int32/int64 "
        f"codes, n up to {FULL_SLAB}, clip and fill; shared-memory edge "
        f"{smem} bytes)")


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
                             "cap": cap}, {"q1": q1, "q3": q3}


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
# phase 17: date, time, CAST and math functions in SQL
# ---------------------------------------------------------------------------

E1 = """SELECT YEAR(l_shipdate), QUARTER(l_shipdate), COUNT(*),
 SUM(l_extendedprice * (1 - l_discount)) FROM lineitem
 GROUP BY YEAR(l_shipdate), QUARTER(l_shipdate)
 ORDER BY YEAR(l_shipdate), QUARTER(l_shipdate)"""

E2 = """SELECT DAYOFWEEK(l_shipdate), WEEK(l_shipdate), COUNT(*),
 SUM(l_quantity) FROM lineitem
 WHERE DATE_ADD(l_shipdate, INTERVAL 3 MONTH) < '1998-01-31'
 AND DAYOFYEAR(l_shipdate) BETWEEN 32 AND 300 AND WEEKDAY(l_shipdate) < 5
 GROUP BY DAYOFWEEK(l_shipdate), WEEK(l_shipdate)"""

E3 = """SELECT o_orderpriority, COUNT(*),
 SUM(DATEDIFF(l_shipdate, o_orderdate)), MAX(LAST_DAY(o_orderdate)),
 MIN(DATE_ADD(o_orderdate, INTERVAL 1 QUARTER))
 FROM lineitem JOIN orders ON l_orderkey = o_orderkey
 WHERE l_shipdate > DATE_ADD(o_orderdate, INTERVAL 1 MONTH)
 GROUP BY o_orderpriority ORDER BY o_orderpriority"""

# E4: the DATETIME branch, ts = l_shipdate at a time of day from the key
_TS = ("DATE_ADD(TIMESTAMP(l_shipdate), "
       "INTERVAL l_orderkey % 86400 SECOND)")
E4 = (f"SELECT HOUR({_TS}), COUNT(*), SUM(MINUTE({_TS})), "
      f"MAX(UNIX_TIMESTAMP({_TS})), MIN(DAYOFMONTH(DATE_ADD("
      f"TIMESTAMP(l_shipdate), INTERVAL 1 YEAR))) FROM lineitem "
      f"GROUP BY HOUR({_TS})")

E5 = """SELECT l_returnflag, COUNT(*), SUM(SQRT(l_extendedprice)),
 SUM(LN(l_quantity)), SUM(POW(l_discount, 2)),
 MAX(GREATEST(l_tax, l_discount)),
 SUM(TRUNCATE(l_extendedprice * l_discount, 1)),
 SUM(CAST(l_quantity AS DOUBLE)) FROM lineitem
 GROUP BY l_returnflag ORDER BY l_returnflag"""

E6 = """SELECT COUNT(*), SUM(l_extendedprice) FROM lineitem
 WHERE SIN(RADIANS(l_discount * 100)) > 0.1 AND LOG10(l_extendedprice) > 5
 AND EXP(l_tax) < 1.05 AND l_shipdate < LAST_DAY('1996-02-10')"""

EXPR_STMTS = {"e1": E1, "e2": E2, "e3": E3, "e4": E4, "e5": E5, "e6": E6}


def expression_sql_phase(s):
    """E1-E6 over the lineitem and orders that stand after phase 16, cold
    and twice warm under tidb_tpu_strict=1, each held against the host
    engine column by column (ints, DECIMALs and dates exactly, float
    columns within phase 11's 2·n·eps·|x|, n lineitem's row count: E5's
    float SUMs add that many non-negative terms at most, so |x| is their
    Σ|x|); EXPLAIN shows each aggregate inside a TpuFragment, and K20
    moves in every run of E1-E4 → (launches, walls)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    for name, sql in EXPR_STMTS.items():
        explain = "\n".join(str(r[0]) for r in
                            s.query("EXPLAIN " + sql).rows)
        if not agg_in_fragment(s, sql) or "TpuFragment" not in explain:
            raise AssertionError(f"{name}: the HashAgg is not inside the "
                                 f"device fragment\n{explain}")
    log("EXPLAIN: E1-E6's HashAgg inside a TpuFragment")
    host = {}
    walls = {}
    for name, sql in EXPR_STMTS.items():
        host[name], walls[f"host_{name}"], _ = run_cols(s, sql, device=False)
        log(f"host {name}: {len(host[name][0][0]) if host[name] else 0} "
            f"rows in {walls[f'host_{name}']:.3f} s")
    n_rows = s.query("SELECT COUNT(*) FROM lineitem").rows[0][0]
    t_phase = time.perf_counter()
    ck.reset_launches()
    err = 0.0
    for name, sql in EXPR_STMTS.items():
        for k in ("cold", "warm1", "warm2"):
            run = f"{name}_{k}"
            before = ck.launches()
            cols, wall, phases = run_cols(s, sql, device=True)
            after = ck.launches()
            moved = {c: after[c] - before[c] for c in after
                     if after[c] != before[c]}
            e = same_cols(run, cols, host[name],
                          ordered="ORDER BY" in sql, n_terms=n_rows)
            err = max(err, e)
            walls[run] = wall
            log(f"{run}: {len(cols[0][0]) if cols else 0} rows, equal to "
                f"the host (largest float difference {e:.3g}), wall "
                f"{wall:.4f} s, launches {moved}, phases {phases}")
            if name in ("e1", "e2", "e3", "e4") and \
                    not moved.get("civil_date"):
                raise AssertionError(f"{run}: K20 did not move ({moved})")
    launches = ck.launches()
    walls["expression_phase"] = time.perf_counter() - t_phase
    log(f"expression phase: {walls['expression_phase']:.1f} s, largest "
        f"float difference {err:.3g}, launches {launches}")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 18: calendar kernel timing
# ---------------------------------------------------------------------------

#: integer operations a row of each timed K20 call does (the civil
#: decomposition is about 30, the inverse about 15, a floor division or
#: floor modulo 3), for the operations half of its bound
K20_OPS = {"year": 30, "week": 60, "last_day": 50, "hour": 8,
           "date_add_months": 95}


def calendar_timing_phase(dev):
    """K20 at 8,388,608 rows (one full slab): civil_part for year, week
    and last_day over DATE days in lineitem's shipdate range, hour over
    µs at random times of day, date_add_months (+3 months, E2's) over
    the same days; each held exactly to its plain version there and timed
    beside it. No single PyTorch call computes these functions."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import calendar as CAL
    n = FULL_SLAB
    rng = np.random.default_rng(18)
    days = torch.from_numpy(rng.integers(8036, 10590, n).astype(
        np.int32)).to(dev)
    us = days.long() * DAY_US + torch.from_numpy(
        rng.integers(0, DAY_US, n)).to(dev)
    calls = [(part, (lambda v=v, p=part, mc=mc: CAL.civil_part(v, p, mc)),
              (lambda v=v, p=part, mc=mc: CAL.civil_part_plain(v, p, mc)),
              v) for part, v, mc in (("year", days, False),
                                     ("week", days, False),
                                     ("last_day", days, False),
                                     ("hour", us, True))]
    calls.append(("date_add_months",
                  lambda: CAL.date_add_months(days, False, 3, 1),
                  lambda: CAL.date_add_months_plain(days, False, 3, 1),
                  days))
    ms = plain = bound = 0.0
    bound_by = set()
    for name, kern, ref, v in calls:
        got = kern()
        want = ref()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"K20 {name} differs from its plain "
                                 f"version at {n} rows")
        k_ms = time_cuda(kern, reps=20)
        p_ms = time_cuda(ref, reps=10)
        b, by = bound_ms(v.nbytes + got.nbytes, n * K20_OPS[name])
        ms, plain, bound = ms + k_ms, plain + p_ms, bound + b
        bound_by.add(by)
        log(f"K20 {name} over {n} {'µs' if v is us else 'days'}: "
            f"{k_ms:.4f} ms (plain {p_ms:.4f}, bound {b:.4f} by {by})")
    by = "bytes" if bound_by == {"bytes"} else "operations"
    log(f"K20 over its five timed calls: {ms:.4f} ms (plain {plain:.4f}, "
        f"bound {bound:.4f} by {by})")
    return [{"name": "civil_date", "route": "cuda",
             "source": "tidb_tpu_torch/csrc/civil_date.cu",
             "replaces": "tidb_tpu/expression/__init__.py:1408",
             "max_abs_err": 0, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": by, "library_ms": None}]


# ---------------------------------------------------------------------------
# phase 19: the dictionary string functions in SQL
# ---------------------------------------------------------------------------

SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
N_CLERKS = 1000
#: o_comment's words, in the spirit of dbgen's text grammar (TPC-H
#: 4.2.2.10: adverbs, adjectives, nouns, verbs, prepositions). "special"
#: is left out: it opens the phrase "special requests", written into 1% of
#: the comments so that Q13's predicate matches about that share
COMMENT_WORDS = (
    "furiously", "slyly", "carefully", "blithely", "quickly", "fluffily",
    "slowly", "quietly", "ruthlessly", "thinly", "closely", "doggedly",
    "daringly", "bravely", "stealthily", "permanently", "enticingly",
    "idly", "busily", "regularly", "finally", "ironically", "evenly",
    "boldly", "silently", "final", "regular", "ironic", "express", "even",
    "bold", "pending", "unusual", "careful", "quick", "fluffy", "silent",
    "foxes", "ideas", "theodolites", "pinto", "beans", "instructions",
    "dependencies", "excuses", "platelets", "asymptotes", "courts",
    "dolphins", "multipliers", "sauternes", "warthogs", "frets", "dinos",
    "attainments", "somas", "patterns", "forges", "braids", "frays",
    "warhorses", "dugouts", "epitaphs", "pearls", "tithes", "waters",
    "orbits", "gifts", "sheaves", "depths", "sentiments", "decoys",
    "realms", "pains", "grouches", "escapades", "packages", "requests",
    "accounts", "deposits", "sleep", "wake", "are", "cajole", "haggle",
    "nag", "use", "boost", "affix", "detect", "integrate", "maintain",
    "nod", "was", "lose", "sublate", "solve", "thrash", "promise",
    "engage", "hinder", "print", "breach", "eat", "grow", "impress",
    "mold", "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
    "kindle", "play", "hang", "believe", "doubt", "about", "above",
    "across", "after", "against", "along", "among", "around", "at",
    "atop", "before", "behind", "beneath", "beside", "between", "beyond",
    "by", "despite", "during", "except", "for", "from", "inside", "into",
    "near", "of", "on", "outside", "over", "past", "since", "through",
    "to", "toward", "under", "until", "up", "upon", "without", "with",
    "within", "the")

S1 = """SELECT l_shipmode, COUNT(*), SUM(l_quantity) FROM lineitem_str
 WHERE INSTR(l_shipmode, 'AIR') > 0 OR CHAR_LENGTH(l_shipinstruct) > 12
 GROUP BY l_shipmode"""
S2 = """SELECT LENGTH(l_shipinstruct), ASCII(l_shipmode), COUNT(*),
 SUM(l_extendedprice) FROM lineitem_str
 GROUP BY LENGTH(l_shipinstruct), ASCII(l_shipmode)"""
# TPC-H Q13's predicate
S3 = """SELECT o_orderpriority, COUNT(*), SUM(LENGTH(o_comment))
 FROM orders_str WHERE o_comment NOT LIKE '%special%requests%'
 GROUP BY o_orderpriority"""
S4 = """SELECT CHAR_LENGTH(o_comment) DIV 10, COUNT(*),
 MAX(INSTR(o_comment, 'the')) FROM orders_str
 WHERE LOCATE('deposits', o_comment, 5) > 0
 GROUP BY CHAR_LENGTH(o_comment) DIV 10"""
S5 = """SELECT l_shipmode, COUNT(*),
 SUM(FIND_IN_SET('Clerk#000000042', o_clerk))
 FROM lineitem_str JOIN orders_str ON l_orderkey = o_orderkey
 WHERE o_comment LIKE '%pending%' GROUP BY l_shipmode"""
S6 = """SELECT COUNT(*) FROM lineitem_str WHERE UPPER(l_shipmode) IS NOT NULL
 AND SUBSTR(l_shipinstruct, 1, 4) IS NOT NULL"""
# a string equi-join: l_shipmode's codes remapped into shipmode's
# dictionary (KeyRemap, K21's fill mode)
S7 = """SELECT sm_cost, COUNT(*) FROM lineitem_str JOIN shipmode
 ON l_shipmode = sm_name GROUP BY sm_cost"""
STRING_STMTS = {"s1": S1, "s2": S2, "s3": S3, "s4": S4, "s5": S5,
                "s6": S6, "s7": S7}
#: refused at plan time: a computed string under a comparison, and the
#: string column passed where the function takes a constant
STRING_REFUSED = {
    "upper_eq": "SELECT COUNT(*) FROM orders_str "
                "WHERE UPPER(o_comment) = 'X'",
    "locate_col": "SELECT COUNT(*) FROM lineitem_str "
                  "WHERE LOCATE(l_shipmode, 'REG AIR') > 0"}


def make_comments(rng, n: int):
    """n TPC-H-shaped comments: 19-78 characters of COMMENT_WORDS (cut at
    the length drawn, as dbgen cuts its text), nearly all distinct; 1%
    open with "special requests"."""
    import numpy as np
    words = np.array(COMMENT_WORDS, dtype=object)
    idx = rng.integers(0, len(words), (n, 14))
    lens = rng.integers(19, 79, n)
    special = rng.random(n) < 0.01
    out = np.empty(n, dtype=object)
    for k, (row, ln, sp) in enumerate(zip(words[idx].tolist(),
                                          lens.tolist(), special.tolist())):
        text = " ".join(row)
        if sp:
            text = "special requests " + text
        out[k] = text[:ln].rstrip()
    return out


def make_string_tables(n: int):
    """lineitem_str (n rows), orders_str (n/4) and shipmode (7), each from
    its own seed: l_orderkey drawn as lineitem's, TPC-H's ship modes,
    ship instructions and order priorities, 1,000 clerks, comments from
    make_comments."""
    import numpy as np
    rng = np.random.default_rng(1901)
    n_orders = max(n // 4, 1)
    lineitem = {
        "l_orderkey": rng.integers(0, n_orders, n).astype(np.int64),
        "l_quantity": rng.integers(100, 5001, n).astype(np.int64),
        "l_extendedprice": rng.integers(90_000, 10_500_001, n).astype(
            np.int64),
        "l_shipmode": np.array(SHIPMODES, dtype=object)[
            rng.integers(0, len(SHIPMODES), n)],
        "l_shipinstruct": np.array(SHIPINSTRUCT, dtype=object)[
            rng.integers(0, len(SHIPINSTRUCT), n)]}
    rng = np.random.default_rng(1902)
    clerks = np.array([f"Clerk#{k:09d}" for k in range(1, N_CLERKS + 1)],
                      dtype=object)
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_orderpriority": np.array(PRIORITIES, dtype=object)[
            rng.integers(0, len(PRIORITIES), n_orders)],
        "o_clerk": clerks[rng.integers(0, N_CLERKS, n_orders)],
        "o_comment": make_comments(rng, n_orders)}
    shipmode = {"sm_name": np.array(SHIPMODES, dtype=object),
                "sm_cost": np.array([5, 7, 3, 2, 4, 1, 6], dtype=np.int64)}
    return lineitem, orders, shipmode


def _prep_meter():
    """Wrap both program kinds' collect_preps (the host preparation of
    every dictionary table and its upload) to total their seconds and the
    bytes the prepared tensors hold → (meter dict, restore function)."""
    import torch
    from tidb_tpu_torch.executor.fragment import _FragmentProgram
    from tidb_tpu_torch.executor.tree_fragment import TreeProgram
    meter = {"s": 0.0, "bytes": 0, "calls": 0}

    def nbytes(tree):
        if isinstance(tree, torch.Tensor):
            return tree.nbytes
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(t) for t in tree)
        return 0

    saved = []
    for cls in (_FragmentProgram, TreeProgram):
        orig = cls.collect_preps

        def timed(self, *a, _orig=orig, **k):
            t0 = time.perf_counter()
            out = _orig(self, *a, **k)
            torch.cuda.synchronize()
            meter["s"] += time.perf_counter() - t0
            meter["bytes"] += nbytes(out)
            meter["calls"] += 1
            return out

        saved.append((cls, orig))
        cls.collect_preps = timed

    def restore():
        for cls, orig in saved:
            cls.collect_preps = orig

    return meter, restore


def string_sql_phase(s, n: int):
    """S1-S7 over lineitem_str, orders_str and shipmode, made here: each
    cold and warm once under tidb_tpu_strict=1, rows exactly equal to
    the host engine (sorted where the statement has no ORDER BY),
    EXPLAIN showing the aggregate inside a TpuFragment, K21 launched in
    every run; the host preparation and upload of the dictionary tables
    timed per run (collect_preps) with their bytes. Then the two refused
    shapes: no TpuFragment and no kernel launched (the host engine runs
    them). → (launches, walls)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.testing import load_numpy_columns
    t0 = time.perf_counter()
    s.execute("CREATE TABLE lineitem_str (l_orderkey BIGINT, "
              "l_quantity DECIMAL(15,2), l_extendedprice DECIMAL(15,2), "
              "l_shipmode CHAR(10), l_shipinstruct CHAR(25))")
    s.execute("CREATE TABLE orders_str (o_orderkey BIGINT PRIMARY KEY, "
              "o_orderpriority CHAR(15), o_clerk CHAR(15), "
              "o_comment VARCHAR(79))")
    s.execute("CREATE TABLE shipmode (sm_name CHAR(10), sm_cost INT)")
    lineitem, orders, shipmode = make_string_tables(n)
    t_gen = time.perf_counter() - t0
    for name, cols in (("lineitem_str", lineitem), ("orders_str", orders),
                       ("shipmode", shipmode)):
        load_numpy_columns(s, name, cols)
        s.execute(f"ANALYZE TABLE {name}")
    n_comments = len(set(orders["o_comment"].tolist()))
    n_special = sum(1 for c in orders["o_comment"].tolist()
                    if "special" in c and "requests" in
                    c[c.index("special"):])
    log(f"lineitem_str {n} rows, orders_str {len(orders['o_orderkey'])} "
        f"rows ({n_comments} distinct comments, {n_special} with "
        f"'special…requests'), shipmode 7: generated in {t_gen:.1f} s, "
        f"loaded and analyzed in {time.perf_counter() - t0 - t_gen:.1f} s")
    del lineitem, orders
    for name, sql in STRING_STMTS.items():
        explain = "\n".join(str(r[0]) for r in
                            s.query("EXPLAIN " + sql).rows)
        if not agg_in_fragment(s, sql) or "TpuFragment" not in explain:
            raise AssertionError(f"{name}: the aggregate is not inside the "
                                 f"device fragment\n{explain}")
    log("EXPLAIN: S1-S7's aggregate inside a TpuFragment")
    host = {}
    walls = {}
    for name, sql in STRING_STMTS.items():
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = sorted(rows, key=str)
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    t_phase = time.perf_counter()
    ck.reset_launches()
    meter, restore = _prep_meter()
    try:
        for name, sql in STRING_STMTS.items():
            for k in ("cold", "warm1"):
                run = f"{name}_{k}"
                before = ck.launches()
                s0, b0 = meter["s"], meter["bytes"]
                rows, wall, phases, _ = run_sql(s, sql, device=True)
                after = ck.launches()
                moved = {c: after[c] - before[c] for c in after
                         if after[c] != before[c]}
                if sorted(rows, key=str) != host[name]:
                    raise AssertionError(f"{run}: device rows != host "
                                         f"rows\n{rows[:3]}\n"
                                         f"{host[name][:3]}")
                if not moved.get("dict_lut"):
                    raise AssertionError(f"{run}: K21 did not move "
                                         f"({moved})")
                walls[run] = wall
                walls[f"{run}_prep"] = meter["s"] - s0
                log(f"{run}: {len(rows)} rows, exact match, wall "
                    f"{wall:.4f} s, collect_preps {meter['s'] - s0:.4f} s "
                    f"for {meter['bytes'] - b0} bytes of prepared "
                    f"tables, launches {moved}, phases {phases}")
    finally:
        restore()
    launches = ck.launches()
    walls["string_phase"] = time.perf_counter() - t_phase
    for name, sql in STRING_REFUSED.items():
        explain = "\n".join(str(r[0]) for r in
                            s.query("EXPLAIN " + sql).rows)
        if "TpuFragment" in explain:
            raise AssertionError(f"{name}: refused shape planned on the "
                                 f"device\n{explain}")
        s.vars["tidb_tpu_engine"] = "on"
        before = ck.launches()
        t0 = time.perf_counter()
        rows = s.query(sql).rows
        wall = time.perf_counter() - t0
        if ck.launches() != before:
            raise AssertionError(f"{name}: a kernel launched")
        # refused at plan time, the statement ran on the host engine: a
        # second run with the device engine off would take the same path
        # (locate_col's 15 s) and compare it with itself
        log(f"refused {name}: no TpuFragment, no kernel launched, {rows} "
            f"from the host engine ({wall:.3f} s)")
    log(f"string phase: {walls['string_phase']:.1f} s, launches "
        f"{launches}")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 20: dictionary LUT kernel timing
# ---------------------------------------------------------------------------


def dict_lut_timing_phase(dev):
    """K21 at n = 8,388,608 (one full slab) over int32 codes: a 7-entry
    int64 table (l_shipmode's, in shared memory), a 7-entry bool table
    (a LIKE's), the 1,500,303-entry int64 table of o_comment's
    dictionary over uniformly random codes (read through L2) and fill
    mode (KeyRemap's, codes in [-1, 8) over 7 entries); each held
    exactly to its plain version there and timed beside it and beside
    torch.take of the clamped codes. The bound counts the codes read and
    the output written once a row and the table once."""
    import torch
    from tidb_tpu_torch.ops import dict_lut as DL
    n = FULL_SLAB
    g = torch.Generator(device=dev).manual_seed(20)

    def table(n_lut, dtype):
        raw = torch.randint(0, 1 << 40, (n_lut,), device=dev, generator=g)
        return (raw & 1).bool() if dtype == torch.bool else raw.to(dtype)

    small = torch.randint(0, 7, (n,), device=dev, generator=g,
                          dtype=torch.int32)
    big = torch.randint(0, 1_500_303, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    remap = torch.randint(-1, 8, (n,), device=dev, generator=g,
                          dtype=torch.int32)
    cases = [("7 int64", table(7, torch.int64), small, "clip"),
             ("7 bool", table(7, torch.bool), small, "clip"),
             ("1500303 int64", table(1_500_303, torch.int64), big, "clip"),
             ("7 int64 fill", table(7, torch.int64), remap, "fill")]
    ms = plain = lib = bound = 0.0
    for name, tab, codes, mode in cases:
        got = DL.dict_lut(tab, codes, mode, -1)
        want = DL.dict_lut_plain(tab, codes, mode, -1)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"K21 {name} differs from its plain "
                                 f"version at {n} rows")
        # torch.take indexes with int64 only: the widened clamped codes
        # are made outside the timed call
        clamped = torch.clamp(codes, 0, tab.shape[0] - 1).long()
        k_ms = time_cuda(lambda: DL.dict_lut(tab, codes, mode, -1), reps=30)
        p_ms = time_cuda(lambda: DL.dict_lut_plain(tab, codes, mode, -1),
                         reps=30)
        l_ms = time_cuda(lambda: torch.take(tab, clamped), reps=30)
        b, by = bound_ms(codes.nbytes + got.nbytes + tab.nbytes, 3 * n)
        ms, plain, lib, bound = ms + k_ms, plain + p_ms, lib + l_ms, \
            bound + b
        log(f"K21 {name} ({mode}) at {n} rows: {k_ms:.4f} ms (plain "
            f"{p_ms:.4f}, torch.take {l_ms:.4f}, bound {b:.4f} by {by})")
    log(f"K21 over its four timed calls: {ms:.4f} ms (plain {plain:.4f}, "
        f"torch.take {lib:.4f}, bound {bound:.4f} by bytes)")
    return [{"name": "dict_lut", "route": "cuda",
             "source": "tidb_tpu_torch/csrc/dict_lut.cu",
             "replaces": "tidb_tpu/expression/__init__.py:858",
             "max_abs_err": 0, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}]


# ---------------------------------------------------------------------------
# phase 3 (K22) and phases 21-22: same-plan micro-batching
# ---------------------------------------------------------------------------


def check_member_compact_kernels(dev):
    """K22 member_compact against its plain version on the card: B in
    {1, 3, 16}, cap in {1, 1,000, 8,388,608}, with no live rows, every
    row live and a random mask; then at the 128 KB tiles' edges (cap at
    multiples of the tile ± 1, and past its first 16 KB round) over mask
    views 1-15 bytes off their 16-byte boundary whose neighbouring bytes
    hold the opposite value: all-dead, all-live, one live row at the last
    member's first or last row, random; counts, offsets and ids exactly
    equal."""
    import torch
    from tidb_tpu_torch.ops import compact as MC
    g = torch.Generator(device=dev).manual_seed(22)
    t0 = time.perf_counter()

    def same(live, what):
        got = MC.member_compact(live)
        want = MC.member_compact_plain(live)
        for name, x, y in zip(("counts", "offsets", "ids"), got, want):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"K22 {name} differs from its plain "
                                     f"version at {what}")

    for b in (1, 3, 16):
        for cap in (1, 1000, FULL_SLAB):
            for kind in ("none", "all", "random"):
                if kind == "random":
                    live = torch.rand((b, cap), device=dev, generator=g) < 0.3
                else:
                    live = torch.full((b, cap), kind == "all",
                                      dtype=torch.bool, device=dev)
                same(live, f"B={b}, cap={cap}, {kind}")
                del live
    edges = 0
    for b in (1, 3, 16):
        for cap in (MC.TILE // MC.ROUNDS + 1, MC.TILE - 1, MC.TILE,
                    MC.TILE + 1, 2 * MC.TILE + 1):
            n = b * cap
            for off in (0, 1, 7, 15):
                for kind in ("dead", "live", "last row", "first of last",
                             "random"):
                    flat = torch.full((n + 32,), kind == "dead",
                                      dtype=torch.bool, device=dev)
                    inside = flat[off:off + n]
                    if kind == "live":
                        inside.fill_(True)
                    elif kind == "dead":
                        inside.fill_(False)
                    elif kind == "last row":
                        inside[n - 1] = True
                    elif kind == "first of last":
                        inside[n - cap] = True
                    else:
                        inside.copy_(torch.rand(n, device=dev,
                                                generator=g) < 0.3)
                    same(inside.view(b, cap),
                         f"B={b}, cap={cap}, offset {off}, {kind}")
                    edges += 1
    torch.cuda.synchronize()
    log(f"K22 member_compact: exactly equal to its plain version at B in "
        f"{{1, 3, 16}} x cap in {{1, 1000, 8388608}} x {{no, all, random}} "
        f"live rows, and in {edges} cases at the tiles' edges (cap = "
        f"{MC.TILE // MC.ROUNDS + 1}, {MC.TILE} ± 1, {2 * MC.TILE + 1}; "
        f"views 0-15 bytes off; dead, live, one row in the last member, "
        f"random), {time.perf_counter() - t0:.1f} s in all")


MB_MAX = 16
# M1: 16 point reads; every l_orderkey appears about 4 times
M1 = ("SELECT l_quantity, l_extendedprice, l_shipdate FROM lineitem "
      "WHERE l_orderkey = {k}")
M1_KEYS = [1_000 + 93_751 * i for i in range(MB_MAX)]
# M2: 5 range reads with three parameters each (two DECIMAL bounds 20.00
# apart and a DECIMAL discount): about 100 rows each, and a member count
# that is not a power of two
M2 = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
      "WHERE l_extendedprice >= {p} AND l_extendedprice < {q} "
      "AND l_discount = {d}")
M2_ARGS = [(1_000_000 + 1_700_000 * i, 1 + i) for i in range(5)]


def _m2_sql(p_cents: int, d: int) -> str:
    return M2.format(p=_dec(p_cents), q=_dec(p_cents + 2000), d=_dec(d))


def _mb_session(eng):
    s = eng.new_session()
    s.vars["tidb_tpu_engine"] = "on"
    s.vars["tidb_tpu_row_threshold"] = 1
    s.vars["tidb_tpu_strict"] = 1
    s.vars["tidb_tpu_microbatch_max"] = MB_MAX
    return s


def _wait_for(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting: {what}")
        time.sleep(0.002)


def _batch_run(eng, name: str, sqls, host_rows, capture=None):
    """One batch: each member once solo (the individual oracle, which
    also warms the program), then all of them piled up behind the held
    scheduler — the first queued as the leader, the others parked — and
    released. → (launch counts of the batched run, log record)."""
    import threading
    from tidb_tpu_torch.executor import fragment
    from tidb_tpu_torch.executor import microbatch
    from tidb_tpu_torch.executor.scheduler import SCHEDULER
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.util.observability import REGISTRY
    sessions = [_mb_session(eng) for _ in sqls]
    solo, solo_walls, solo_launches = [], [], []
    for s, sql in zip(sessions, sqls):
        t0 = time.perf_counter()
        rows = s.query(sql).rows
        solo_walls.append(time.perf_counter() - t0)
        solo.append(rows)
        solo_launches.append(s.last_guard.phases.programs_launched)
    for i, rows in enumerate(solo):
        if sorted(rows, key=str) != host_rows[i]:
            raise AssertionError(f"{name} member {i}: solo device rows != "
                                 f"host rows\n{rows[:3]}\n{host_rows[i][:3]}")
    n_slabs = solo_launches[0]
    if any(x != n_slabs for x in solo_launches):
        raise AssertionError(f"{name}: members' surviving slabs differ "
                             f"{solo_launches}")

    def counter(c):
        return REGISTRY.counters.get((c, ()), 0)

    b0 = counter("tidb_tpu_microbatch_batches_total")
    m0 = counter("tidb_tpu_microbatch_members_total")
    results, errors = {}, {}

    def worker(i):
        try:
            results[i] = sessions[i].query(sqls[i]).rows
        except BaseException as e:      # reported below, per member
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(sqls))]
    real_compact = fragment.compact_rows

    def spy(cols, live):
        if capture is not None and live.shape[0] == len(sqls):
            capture["live"] = live
        return real_compact(cols, live)

    ck.reset_launches()
    SCHEDULER.acquire(conn_id=-1)
    released = False
    try:
        fragment.compact_rows = spy
        base = microbatch.queued_members()
        threads[0].start()
        _wait_for(lambda: SCHEDULER.queue_depth() >= 2,
                  f"{name}: the leader never queued")
        for i in range(1, len(sqls)):
            threads[i].start()
        _wait_for(lambda: microbatch.queued_members() >= base + len(sqls)
                  - 1, f"{name}: the followers never parked")
        t0 = time.perf_counter()
        SCHEDULER.release()
        released = True
        for t in threads:
            t.join(timeout=120.0)
        wall = time.perf_counter() - t0
    finally:
        if not released:
            SCHEDULER.release()
        fragment.compact_rows = real_compact
    launches = ck.launches()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{name}: members failed {errors}")
    for i in range(len(sqls)):
        if results[i] != solo[i]:
            raise AssertionError(f"{name} member {i}: batched rows != its "
                                 f"solo run\n{results[i][:3]}\n{solo[i][:3]}")
    summed = sum(s.last_guard.phases.programs_launched for s in sessions)
    if summed != n_slabs:
        raise AssertionError(f"{name}: {summed} launches summed over the "
                             f"members, {n_slabs} surviving slabs")
    for k in ("member_compact", "gather_columns"):
        if launches[k] != n_slabs:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"for {n_slabs} slabs")
    if counter("tidb_tpu_microbatch_batches_total") - b0 != 1 or \
            counter("tidb_tpu_microbatch_members_total") - m0 != len(sqls):
        raise AssertionError(f"{name}: the batch counters did not move by "
                             f"1 and {len(sqls)}")
    ph = sessions[0].last_guard.phases.as_dict()
    rec = {"members": len(sqls), "slabs": n_slabs,
           "rows": [len(r) for r in solo], "batch_wall_s": wall,
           "solo_warm_mean_s": sum(solo_walls) / len(solo_walls),
           "solo_sum_s": sum(solo_walls),
           "leader_compute_s": ph["compute_s"],
           "leader_fetch_s": ph["fetch_s"],
           "leader_decode_s": ph["decode_s"],
           "leader_d2h_bytes": ph["d2h_bytes"],
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"{name}: {len(sqls)} members, {n_slabs} slab(s), rows "
        f"{rec['rows']}, each equal to its solo run and to the host engine; "
        f"one launch per slab; batch wall {wall:.4f} s (solo warm mean "
        f"{rec['solo_warm_mean_s']:.4f} s, sum of {len(sqls)} solo walls "
        f"{rec['solo_sum_s']:.4f} s); leader compute {ph['compute_s']} s, "
        f"fetch {ph['fetch_s']} s, decode {ph['decode_s']} s, d2h "
        f"{ph['d2h_bytes']} bytes; launches {rec['launches']}")
    return launches, rec


def microbatch_sql_phase(eng, s):
    """M1 (16 point reads) and M2 (5 range reads) over lineitem as the
    earlier phases left it, each piled up twice. → (K22/K18 launches of
    the batched runs, walls, the M1 live mask of the last run)."""
    import torch
    m1 = [M1.format(k=k) for k in M1_KEYS]
    m2 = [_m2_sql(p, d) for p, d in M2_ARGS]
    t0 = time.perf_counter()
    host = {}
    for name, sqls in (("M1", m1), ("M2", m2)):
        host[name] = []
        for sql in sqls:
            rows, _, _, _ = run_sql(s, sql, device=False)
            host[name].append(sorted(rows, key=str))
    t_host = time.perf_counter() - t0
    log(f"host engine: M1's 16 and M2's 5 statements in {t_host:.1f} s")
    totals = {"member_compact": 0, "gather_columns": 0}
    walls = {"mb_host": t_host}
    capture = {}
    t_phase = time.perf_counter()
    for run in (1, 2):
        for name, sqls in (("M1", m1), ("M2", m2)):
            launches, rec = _batch_run(eng, f"{name} run {run}", sqls,
                                       host[name], capture if name == "M1"
                                       else None)
            for k in totals:
                totals[k] += launches[k]
            walls[f"{name}_run{run}_batch"] = rec["batch_wall_s"]
            walls[f"{name}_run{run}_solo_mean"] = rec["solo_warm_mean_s"]
            walls[f"{name}_run{run}_solo_sum"] = rec["solo_sum_s"]
    walls["microbatch_phase"] = time.perf_counter() - t_phase
    live = capture["live"]
    if tuple(live.shape) != (MB_MAX, FULL_SLAB) or live.dtype != torch.bool:
        raise AssertionError(f"M1's live mask is {tuple(live.shape)}")
    log(f"micro-batch phase: {walls['microbatch_phase']:.1f} s after the "
        f"host runs; K22/K18 launches of the batched runs {totals}")
    return totals, walls, live


def member_compact_timing_phase(dev, m1_live):
    """K22 at B = 16, cap = 8,388,608: over M1's own live mask (a few rows
    a member) and over a random half-live mask, each held exactly to its
    plain version there and timed beside it and beside torch.nonzero (the
    library call: the (member, row) pairs of the same rows). The bound
    counts the mask read once and each id, count and offset written
    once."""
    import torch
    from tidb_tpu_torch.ops import compact as MC
    g = torch.Generator(device=dev).manual_seed(21)
    half = torch.rand(m1_live.shape, device=dev, generator=g) < 0.5
    ms = plain = lib = bound = 0.0
    for name, live in (("M1", m1_live.contiguous()), ("50% live", half)):
        got = MC.member_compact(live)
        want = MC.member_compact_plain(live)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K22 over {name} differs from its plain "
                                 f"version")
        b, cap = live.shape
        total = int(got[1][-1])
        k_ms = time_cuda(lambda: MC.member_compact(live), reps=20)
        p_ms = time_cuda(lambda: MC.member_compact_plain(live), reps=5,
                         warmup=1)
        l_ms = time_cuda(lambda: torch.nonzero(live), reps=20)
        bb, by = bound_ms(live.numel() + 4 * total + 8 * (2 * b + 1),
                          live.numel())
        ms, plain, lib, bound = ms + k_ms, plain + p_ms, lib + l_ms, \
            bound + bb
        log(f"K22 over {name} (B={b}, cap={cap}, {total} live rows): "
            f"{k_ms:.4f} ms (plain {p_ms:.4f}, torch.nonzero {l_ms:.4f}, "
            f"bound {bb:.4f} by {by})")
        DEFERRED_PROFILES.append((
            f"K22 over {name}", lambda live=live: MC.member_compact(live),
            ("mc_count", "mc_scatter", "Memset")))
    log(f"K22 over its two timed masks: {ms:.4f} ms (plain {plain:.4f}, "
        f"torch.nonzero {lib:.4f}, bound {bound:.4f} by bytes)")
    return [{"name": "member_compact", "route": "cuda",
             "source": "tidb_tpu_torch/csrc/member_compact.cu",
             "replaces": "tidb_tpu/executor/microbatch.py:294",
             "max_abs_err": 0, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}]


# ---------------------------------------------------------------------------
# phase 3 (K23) and phases 23-24: distributed fragments
# ---------------------------------------------------------------------------


def check_hash_partition_kernels(dev):
    """K23 hash_partition against its plain version on the card: every
    bucket buffer, sent_live, counts and need exactly equal, for 1, 4 and
    64 destinations, at n = 1, 1,025 and 2,097,152 rows, with an int64,
    an int32 + bool and a float key (NaN and ±inf included), dead rows,
    NULL keys, payload columns of 1, 2, 4 and 8 bytes, and a cap that
    overflows (need > bucket_cap)."""
    import torch
    from tidb_tpu_torch.ops import partition as P
    g = torch.Generator(device=dev).manual_seed(23)

    def key(kind, n):
        if kind == "float":
            v = torch.randn(n, device=dev, generator=g,
                            dtype=torch.float64) * 1e6
            v[:min(n, 3)] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf")],
                                         device=dev)[:min(n, 3)]
        elif kind == "bool":
            v = torch.rand(n, device=dev, generator=g) < 0.5
        elif kind == "int32":
            v = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), device=dev,
                              generator=g, dtype=torch.int32)
        else:
            v = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev,
                              generator=g)
        return v, torch.rand(n, device=dev, generator=g) < 0.9

    for n in (1, 1025, 2_097_152):
        for n_shards in (1, 4, 64):
            for kinds, cap in ((("int64",), n), (("int32", "bool"), n),
                               (("float",), max(n // 256, 1))):
                keys = [key(k, n) for k in kinds]
                live = torch.rand(n, device=dev, generator=g) < 0.8
                arrays = [torch.randint(0, 1 << 40, (n,), device=dev,
                                        generator=g),
                          torch.rand(n, device=dev, generator=g) < 0.5,
                          torch.randint(0, 1000, (n,), device=dev,
                                        generator=g, dtype=torch.int32),
                          torch.randint(0, 1000, (n,), device=dev,
                                        generator=g, dtype=torch.int16)]
                got = P.hash_partition(keys, live, arrays, n_shards, cap)
                want = P.hash_partition_plain(keys, live, arrays, n_shards,
                                              cap)
                for x, y in zip(list(got[0]) + list(got[1:]),
                                list(want[0]) + list(want[1:])):
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        raise AssertionError(
                            f"K23 differs from its plain version at n={n}, "
                            f"n_shards={n_shards}, keys {kinds}, cap {cap}")
    torch.cuda.synchronize()
    log("K23 hash_partition: exactly equal to its plain version at n in "
        "{1, 1025, 2097152} x n_shards in {1, 4, 64} x {int64, int32+bool, "
        "float (NaN, inf) with an overflowing cap} keys")


DIST_RANKS = 4
# X2: bench.py's Q3 shape (lineitem ⋈ orders on the order key, its
# o_orderdate filter, GROUP BY o_orderpriority) with l_shipdate cut to
# mid-1994, so the two filtered sides are within a factor of two and
# insert_exchanges picks a hash exchange on both; X2B is bench.py's Q3
# text itself, whose filtered orders (~1.38M of 1.5M) are under half the
# filtered lineitem (~5.9M): a broadcast exchange of the orders side
X2 = """SELECT o_orderpriority, COUNT(*),
 SUM(l_extendedprice * (1 - l_discount))
 FROM lineitem JOIN orders ON l_orderkey = o_orderkey
 WHERE l_shipdate <= '1994-06-30' AND o_orderdate < '1998-01-01'
 GROUP BY o_orderpriority"""
# X3: the DISTINCT re-key exchange (on the group key). This lineitem has
# no l_suppkey: l_orderkey stands in as the counted column
X3 = ("SELECT l_returnflag, COUNT(DISTINCT l_orderkey) FROM lineitem "
      "GROUP BY l_returnflag")
DIST_STMTS = {"X1": Q1, "X2": X2, "X2B": Q3, "X3": X3}
DIST_RUNS = ("X1", "X2", "X2B", "X3")


def dist_sql_phase(s, known):
    """X1-X3 (and X2B) with tidb_tpu_dist_devices = 4 over lineitem as
    the earlier phases left it and phase 7's orders: 4 ranks, all on the
    one card. Each statement equals the host engine exactly (rows sorted:
    none has an ORDER BY the ranks keep), EXPLAIN shows shards:4 and, for
    the joins and the DISTINCT, the Exchange (its kind logged), K23 moves
    on X2 and X3. Every dist statement encodes its columns on the host
    (the reference's _dist_exec), so every run is cold. `known` holds the
    host rows phase 15 already made on the same rows (X1 is Q1 and X2B
    bench.py's Q3, over lineitem as the writes left it; nothing writes
    lineitem or orders after phase 15), so only X2 and X3 run on the
    host here. → (launches of the phase, walls, X2's first K23 call's
    inputs, the host rows)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import partition as P
    host, walls = {}, {}
    t0 = time.perf_counter()
    for name, sql in DIST_STMTS.items():
        if name in known:
            host[name] = sorted(known[name], key=str)
            log(f"host {name}: {len(host[name])} rows from phase 15")
            continue
        rows, wall, _, _ = run_sql(s, sql, device=False)
        host[name] = sorted(rows, key=str)
        walls[f"host_{name}"] = wall
        log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    s.vars["tidb_tpu_dist_devices"] = DIST_RANKS
    real = P.hash_partition
    capture = {}

    def spy(keys, live, arrays, n_shards, bucket_cap):
        if capture.get("armed") and "keys" not in capture:
            capture.update(keys=keys, live=live, arrays=list(arrays),
                           n_shards=n_shards, bucket_cap=bucket_cap)
        return real(keys, live, arrays, n_shards, bucket_cap)

    try:
        for name, sql in DIST_STMTS.items():
            s.vars["tidb_tpu_engine"] = "on"
            explain = "\n".join(str(r[0]) + " " + str(r[2]) for r in
                                s.query("EXPLAIN " + sql).rows)
            kinds = sorted({k for k in ("hash", "broadcast")
                            if f"Exchange[{k}]" in explain})
            if "shards:4" not in explain or \
                    (name != "X1") != bool(kinds):
                raise AssertionError(f"{name}: not distributed as "
                                     f"expected\n{explain}")
            log(f"EXPLAIN {name}: shards:4, exchanges {kinds or 'none'}")
        P.hash_partition = spy
        t_phase = time.perf_counter()
        ck.reset_launches()
        for name in DIST_RUNS:
            capture["armed"] = name == "X2"
            before = ck.launches()
            rows, wall, phases, esc = run_sql(s, DIST_STMTS[name],
                                              device=True)
            after = ck.launches()
            moved = {c: after[c] - before[c] for c in after
                     if after[c] != before[c]}
            if sorted(rows, key=str) != host[name]:
                raise AssertionError(f"{name}: device rows != host rows\n"
                                     f"{rows[:3]}\n{host[name][:3]}")
            # a rank that zone maps prove empty runs no program
            if phases["programs_launched"] + phases["slabs_skipped"] < \
                    DIST_RANKS:
                raise AssertionError(f"{name}: {phases['programs_launched']}"
                                     f" programs and {phases['slabs_skipped']}"
                                     f" pruned ranks for {DIST_RANKS} ranks")
            if name in ("X2", "X3") and not moved.get("hash_partition"):
                raise AssertionError(f"{name}: K23 did not move ({moved})")
            walls[name] = wall
            log(f"{name}: {len(rows)} rows, exact match, wall {wall:.4f} s, "
                f"encode {phases['encode_s']} s, upload "
                f"{phases['upload_s']} s, compute {phases['compute_s']} s, "
                f"fetch {phases['fetch_s']} s, decode {phases['decode_s']} "
                f"s, h2d {phases['h2d_bytes']} bytes, d2h "
                f"{phases['d2h_bytes']} bytes, programs "
                f"{phases['programs_launched']}, pruned ranks "
                f"{phases['slabs_skipped']}, escalation {esc}, K23 "
                f"{moved.get('hash_partition', 0)}, K18 "
                f"{moved.get('gather_columns', 0)}, launches {moved}")
        launches = ck.launches()
        walls["dist_phase"] = time.perf_counter() - t_phase
    finally:
        P.hash_partition = real
        s.vars.pop("tidb_tpu_dist_devices", None)
    if "keys" not in capture:
        raise AssertionError("X2 made no K23 call")
    log(f"dist phase: {walls['dist_phase']:.1f} s after the host runs "
        f"({time.perf_counter() - t0:.1f} s in all); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches, walls, capture, host


def hash_partition_timing_phase(dev, x2):
    """K23 at X2's first exchange: one rank's stage-1 inputs as X2 gave
    them (n = the rank slab, X2's key and payload columns, 4
    destinations, X2's bucket_cap), held exactly to its plain version
    there and timed beside it and beside a library yardstick the port
    never calls: torch.argsort of the destinations (stable) and one
    index_copy_ per column into zeros. The bound counts each key, mask,
    live and payload byte read once and every one of the n_shards *
    bucket_cap slots of each output written once."""
    import torch
    from tidb_tpu_torch.ops import partition as P
    from tidb_tpu_torch.parallel import collective as C
    keys, live, arrays = x2["keys"], x2["live"], x2["arrays"]
    ns, cap = x2["n_shards"], x2["bucket_cap"]
    n = live.shape[0]
    got = P.hash_partition(keys, live, arrays, ns, cap)
    want = P.hash_partition_plain(keys, live, arrays, ns, cap)
    for x, y in zip(list(got[0]) + list(got[1:]),
                    list(want[0]) + list(want[1:])):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError("K23 at X2's shape differs from its plain "
                                 "version")
    need = int(got[3])
    d = torch.where(live, C.shard_of(C.mix_key_code(keys), ns).long(),
                    torch.full((n,), ns, dtype=torch.int64, device=dev))
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    def library():
        order = torch.argsort(d, stable=True)
        per = torch.bincount(d, minlength=ns + 1)
        first = torch.cumsum(per, 0) - per
        sd = d[order]
        keep = sd < ns
        slot = (sd * cap + iota - first[sd])[keep]
        src = order[keep]
        sent = torch.zeros(ns * cap, dtype=torch.bool, device=dev)
        sent[slot] = True
        for a in arrays:
            torch.zeros(ns * cap, dtype=a.dtype, device=dev).index_copy_(
                0, slot, a[src])

    k_ms = time_cuda(lambda: P.hash_partition(keys, live, arrays, ns, cap),
                     reps=20)
    p_ms = time_cuda(lambda: P.hash_partition_plain(keys, live, arrays, ns,
                                                    cap), reps=10)
    l_ms = time_cuda(library, reps=20)
    read = sum(v.nbytes + m.nbytes for v, m in keys) + live.nbytes + \
        sum(a.nbytes for a in arrays)
    written = ns * cap * (sum(a.element_size() for a in arrays) + 1) + \
        4 * ns + 4
    b, by = bound_ms(read + written, 40 * n * len(keys))
    log(f"K23 at X2's first exchange (n={n}, {len(keys)} key(s) "
        f"{[str(v.dtype) for v, _ in keys]}, {len(arrays)} payload columns "
        f"{[str(a.dtype) for a in arrays]}, n_shards={ns}, bucket_cap="
        f"{cap}, need={need}, live={int(live.sum())}): {k_ms:.4f} ms (plain "
        f"{p_ms:.4f}, argsort + index_copy_ {l_ms:.4f}, bound {b:.4f} by "
        f"{by}: {read} bytes read, {written} written)")
    return [{"name": "hash_partition", "route": "cuda",
             "source": "tidb_tpu_torch/csrc/hash_partition.cu",
             "replaces": "tidb_tpu/executor/device_emit.py:516",
             "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b, "bound_by": by, "library_ms": l_ms}]


# ---------------------------------------------------------------------------
# phase 3 (K24-K26) and phases 25-26: the monolithic distributed program
# ---------------------------------------------------------------------------


def check_rank_kernels(dev):
    """K24 rank_exchange, K25 rank_gather and K26 hash_dest against their
    plain versions on the card, exactly: n = 1, 1,025 and 2,097,152 rows
    spread over 1, 4 and 64 ranks (the last rank shorter); K26 over an
    int64, an int32 + bool and a float key (NaN and ±inf) with NULLs,
    and over an int64 code; K24 routed by K26's destinations (the code
    one for the int64 key; for the int32 + bool key with a tenth of the
    rows sent outside the ranks, which are dead), with dead rows,
    payload columns of 1, 2, 4 and 8 bytes, a roomy and an overflowing
    cap, and its need shared by every source's call; K25 over pieces of
    1, 2, 4 and 8 bytes (unaligned ones too) and a limb plane."""
    import torch
    from tidb_tpu_torch.ops import partition as P
    from tidb_tpu_torch.ops.rank_gather import (rank_gather,
                                                rank_gather_plain)
    g = torch.Generator(device=dev).manual_seed(24)

    def key(kind, n):
        if kind == "float":
            v = torch.randn(n, device=dev, generator=g,
                            dtype=torch.float64) * 1e6
            v[:min(n, 3)] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf")],
                                         device=dev)[:min(n, 3)]
        elif kind == "bool":
            v = torch.rand(n, device=dev, generator=g) < 0.5
        elif kind == "int32":
            v = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), device=dev,
                              generator=g, dtype=torch.int32)
        else:
            v = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev,
                              generator=g)
        return v, torch.rand(n, device=dev, generator=g) < 0.9

    def payload(n):
        return [torch.randint(0, 1 << 40, (n,), device=dev, generator=g),
                torch.rand(n, device=dev, generator=g) < 0.5,
                torch.randint(0, 1000, (n,), device=dev, generator=g,
                              dtype=torch.int32),
                torch.randint(0, 1000, (n,), device=dev, generator=g,
                              dtype=torch.int16)]

    def same(xs, ys, what):
        for x, y in zip(xs, ys):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{what} differs from its plain "
                                     f"version")

    for n in (1, 1025, 2_097_152):
        for nd in (1, 4, 64):
            per = -(-n // nd)
            sizes = [max(min(per, n - r * per), 0) for r in range(nd)]
            roomy = 2 * -(-per // nd) + 16
            for kinds, cap in ((("int64",), roomy),
                               (("int32", "bool"), roomy),
                               (("float",), max(per // (4 * nd), 1))):
                keys = [[key(k, m) for k in kinds] for m in sizes]
                live = [torch.rand(m, device=dev, generator=g) < 0.8
                        for m in sizes]
                arrays = [payload(m) for m in sizes]
                dest = [P.hash_dest(k, nd) for k in keys]
                same(dest, [P.hash_dest_plain(k, nd) for k in keys],
                     f"K26 at n={n}, shards={nd}, keys {kinds}")
                if kinds == ("int64",):
                    codes = [k[0][0] for k in keys]
                    dest = [P.hash_dest(None, nd, code=c) for c in codes]
                    same(dest, [P.hash_dest_plain(None, nd, code=c)
                                for c in codes],
                         f"K26 at n={n}, shards={nd}, an int64 code")
                elif kinds == ("int32", "bool"):
                    dest = [torch.where(
                        torch.rand(m, device=dev, generator=g) < 0.1,
                        torch.full_like(d, nd) if r % 2 else
                        torch.full_like(d, -1), d)
                        for r, (d, m) in enumerate(zip(dest, sizes))]
                got = P.rank_exchange(arrays, dest, live, nd, cap)
                want = P.rank_exchange_plain(arrays, dest, live, nd, cap)
                what = f"K24 at n={n}, ranks={nd}, keys {kinds}, cap {cap}"
                for d in range(nd):
                    same(got[0][d] + [got[1][d]], want[0][d] + [want[1][d]],
                         what)
                same([got[2]], [want[2]], what)
            cols = [[a[j] for a in arrays] for j in range(4)]
            cols.append([torch.randint(0, 1 << 30, (3, m + 1), device=dev,
                                       generator=g) for m in sizes])
            cols.append([a[2][:max(m - 1, 0)].to(torch.uint8)
                         for a, m in zip(arrays, sizes)])
            same(rank_gather(cols), rank_gather_plain(cols),
                 f"K25 at n={n}, ranks={nd}")
    torch.cuda.synchronize()
    log("K24 rank_exchange, K25 rank_gather, K26 hash_dest: exactly equal "
        "to their plain versions at n in {1, 1025, 2097152} over {1, 4, 64} "
        "ranks; K26 over {int64, int32+bool, float (NaN, inf)} keys and an "
        "int64 code; K24 routed by K26's destinations and by destinations "
        "outside the ranks, with an overflowing cap")


# X4: a TopN directly over a join's rows (a broadcast of the filtered
# orders); X5 is bench.py's Q5 text, whose planner broadcasts the
# customer ⋈ orders join: an Exchange over a join
X4 = ("SELECT l_orderkey, l_extendedprice, o_orderpriority FROM lineitem "
      "JOIN orders ON l_orderkey = o_orderkey "
      "WHERE o_orderdate < '1995-03-15' "
      "ORDER BY l_extendedprice DESC, l_orderkey LIMIT 10")
_NO_AGG = {"tidb_tpu_dist_staged": "off"}
_NO_EXCH = {"tidb_tpu_dist_staged_exchange": "off"}
_NO_STAGED = {**_NO_AGG, **_NO_EXCH}
# name, text, flags, exchange kinds EXPLAIN must show, kernels that must
# move, whether the rows keep their order
MONO_RUNS = (
    ("X1", Q1, _NO_AGG, [], ("rank_gather", "hash_dest"), False),
    ("X2", X2, _NO_EXCH, ["hash"], ("rank_exchange", "rank_gather",
                                    "hash_dest"), False),
    ("X2B", Q3, _NO_EXCH, ["broadcast"], ("rank_gather", "hash_dest"),
     False),
    ("X3", X3, _NO_EXCH, ["hash"], ("rank_exchange", "rank_gather",
                                    "hash_dest"), False),
    ("X4", X4, _NO_STAGED, ["broadcast"], ("rank_gather",), True),
    ("X5", Q5, _NO_STAGED, ["broadcast"], ("rank_gather", "hash_dest"),
     True),
)
MONO_KERNELS = ("rank_exchange", "rank_gather", "hash_dest")


def _exchange_over_join(explain_rows) -> bool:
    """Does some Exchange of an EXPLAIN have a join for its child?"""
    names = [str(r[0]) for r in explain_rows]
    return any("Exchange" in a and "HashJoin" in b
               for a, b in zip(names, names[1:]))


def mono_sql_phase(s, host):
    """X1-X5 through the monolithic program: 4 ranks on the card,
    tidb_tpu_strict = 1, the staged flags as MONO_RUNS sets them. Phase
    23's host rows serve X1-X3 and X2B (phase 23 writes nothing); X4 and
    X5 get one host run each. → (launches of the phase, walls, the
    inputs of K24's first call on X2 with the keys K26 routed it by,
    K25's first call on X2B and K26's first call on X1 and last on X3)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import partition as P
    from tidb_tpu_torch.ops import rank_gather as RG
    from tidb_tpu_torch.parallel import collective as C
    walls = {}
    host = dict(host)
    for name, sql, _flags, _kinds, _ks, ordered in MONO_RUNS:
        if name not in host:
            rows, wall, _, _ = run_sql(s, sql, device=False)
            host[name] = rows if ordered else sorted(rows, key=str)
            walls[f"host_{name}"] = wall
            log(f"host {name}: {len(rows)} rows in {wall:.3f} s")
    capture = {}
    real = {"ex": C.exchange, "rg": RG.rank_gather, "hd": P.hash_dest}

    def spy_ex(arrays, dest, live, n_shards, bucket_cap):
        if capture.get("run") == "X2" and "ex" not in capture:
            # the keys of the last n_shards K26 calls routed this exchange
            capture["ex"] = ([list(a) for a in arrays], list(dest),
                             list(live), n_shards, bucket_cap,
                             capture.pop("x2_keys", [])[-n_shards:])
        return real["ex"](arrays, dest, live, n_shards, bucket_cap)

    def spy_rg(columns):
        if capture.get("run") == "X2B" and "rg" not in capture:
            capture["rg"] = [list(c) for c in columns]
        return real["rg"](columns)

    def spy_hd(keys, n_shards, **kw):
        run = capture.get("run")
        if run == "X1" and "hd" not in capture:
            capture["hd"] = (keys, n_shards, kw)
        elif run == "X2" and "ex" not in capture:
            capture.setdefault("x2_keys", []).append(keys)
        elif run == "X3":
            # the last call of X3 is the owner hash of its partials
            capture["hd3"] = (keys, n_shards, kw)
        return real["hd"](keys, n_shards, **kw)

    s.vars["tidb_tpu_dist_devices"] = DIST_RANKS
    C.exchange, RG.rank_gather, P.hash_dest = spy_ex, spy_rg, spy_hd
    try:
        t_phase = time.perf_counter()
        ck.reset_launches()
        for name, sql, flags, kinds, kernels, ordered in MONO_RUNS:
            s.vars.update(flags)
            try:
                s.vars["tidb_tpu_engine"] = "on"
                ex_rows = s.query("EXPLAIN " + sql).rows
                explain = "\n".join(str(r[0]) + " " + str(r[2])
                                    for r in ex_rows)
                got_kinds = sorted({k for k in ("hash", "broadcast")
                                    if f"Exchange[{k}]" in explain})
                if "shards:4" not in explain or got_kinds != kinds:
                    raise AssertionError(f"{name}: not distributed as "
                                         f"expected\n{explain}")
                if name == "X5" and not _exchange_over_join(ex_rows):
                    raise AssertionError(f"X5: no Exchange over a join\n"
                                         f"{explain}")
                capture["run"] = name
                before = ck.launches()
                rows, wall, phases, esc = run_sql(s, sql, device=True)
                after = ck.launches()
            finally:
                capture["run"] = None
                for k in flags:
                    s.vars.pop(k, None)
            moved = {c: after[c] - before[c] for c in after
                     if after[c] != before[c]}
            if (rows if ordered else sorted(rows, key=str)) != host[name]:
                raise AssertionError(f"{name}: device rows != host rows\n"
                                     f"{rows[:3]}\n{host[name][:3]}")
            missing = [k for k in kernels if not moved.get(k)]
            if missing:
                raise AssertionError(f"{name}: {missing} did not move "
                                     f"({moved})")
            walls[f"mono_{name}"] = wall
            log(f"mono {name}: {len(rows)} rows, exact match, exchanges "
                f"{kinds or 'none'}, wall {wall:.4f} s, encode "
                f"{phases['encode_s']} s, upload {phases['upload_s']} s, "
                f"compute {phases['compute_s']} s, fetch "
                f"{phases['fetch_s']} s, decode {phases['decode_s']} s, h2d "
                f"{phases['h2d_bytes']} bytes, d2h {phases['d2h_bytes']} "
                f"bytes, programs {phases['programs_launched']}, "
                f"escalation {esc}, K24 {moved.get('rank_exchange', 0)}, "
                f"K25 {moved.get('rank_gather', 0)}, K26 "
                f"{moved.get('hash_dest', 0)}, launches {moved}")
        launches = ck.launches()
        walls["mono_phase"] = time.perf_counter() - t_phase
    finally:
        C.exchange, RG.rank_gather, P.hash_dest = (real["ex"], real["rg"],
                                                   real["hd"])
        s.vars.pop("tidb_tpu_dist_devices", None)
    for k in MONO_KERNELS:
        if not launches[k]:
            raise AssertionError(f"kernel {k} was never launched by the "
                                 f"monolithic path")
    for k in ("ex", "rg", "hd", "hd3"):
        if k not in capture:
            raise AssertionError(f"phase 25 captured no {k} call")
    log(f"monolithic phase: {walls['mono_phase']:.1f} s after the host "
        f"runs; launches { {k: v for k, v in launches.items() if v} }")
    return launches, walls, capture


def rank_timing_phase(dev, capture):
    """K24 at X2's first monolithic exchange, K25 at X2B's broadcast and
    K26 at X1's and X3's gathered partials, on the inputs those calls
    had: each held exactly to its plain version there, timed beside it
    and beside a yardstick the port never calls (K24: a stable argsort
    and one index_copy_ per column per source into the receive buffers;
    K25: torch.cat; K26: the plain torch hash), with a byte bound that
    reads every input once and writes every output once (K24's
    n_shards² · bucket_cap slots of each column included). K24 is also
    timed with its K26 routing pass beside K23 + torch.cat of the bucket
    slices, which hashes in its own pass; K25's call is profiled once
    to split its time between the host and the card."""
    import torch
    from tidb_tpu_torch.ops import partition as P
    from tidb_tpu_torch.ops import rank_gather as RG
    from tidb_tpu_torch.parallel import collective as C
    out = []
    # ---- K24
    arrays, dest, live, nd, cap, keys = capture["ex"]
    if len(keys) != nd or not all(
            torch.equal(P.hash_dest_plain(k, nd), d)
            for k, d in zip(keys, dest)):
        raise AssertionError("X2's exchange keys were not captured")
    got = P.rank_exchange(arrays, dest, live, nd, cap)
    want = P.rank_exchange_plain(arrays, dest, live, nd, cap)
    for d in range(nd):
        for x, y in zip(got[0][d] + [got[1][d]], want[0][d] + [want[1][d]]):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError("K24 at X2's exchange differs from its "
                                     "plain version")
    need = int(got[2])
    if need != int(want[2]):
        raise AssertionError("K24's need differs from its plain version")
    del got, want
    iotas = [torch.arange(lv.shape[0], dtype=torch.int64, device=dev)
             for lv in live]

    def library():
        recv = [torch.zeros(nd * nd * cap, dtype=a.dtype, device=dev)
                for a in arrays[0]]
        recv_live = torch.zeros(nd * nd * cap, dtype=torch.bool,
                                device=dev)
        for s_ in range(nd):
            d = dest[s_].long()
            d = torch.where(live[s_] & (d >= 0) & (d < nd), d,
                            torch.full_like(d, nd))
            order = torch.argsort(d, stable=True)
            per = torch.bincount(d, minlength=nd + 1)
            sd = d[order]
            rank = iotas[s_] - (torch.cumsum(per, 0) - per)[sd]
            keep = (sd < nd) & (rank < cap)
            slot = (sd * (nd * cap) + s_ * cap + rank)[keep]
            src = order[keep]
            recv_live[slot] = True
            for r, a in zip(recv, arrays[s_]):
                r.index_copy_(0, slot, a[src])

    def k23_cat():
        sent = [P.hash_partition(keys[s_], live[s_], arrays[s_], nd, cap)
                for s_ in range(nd)]
        for d in range(nd):
            for j in range(len(arrays[0])):
                torch.cat([b[0][j].view(nd, cap)[d] for b in sent])
            torch.cat([b[1].view(nd, cap)[d] for b in sent])

    k_ms = time_cuda(lambda: P.rank_exchange(arrays, dest, live, nd, cap),
                     reps=10)
    r_ms = time_cuda(lambda: P.rank_exchange(
        arrays, [P.hash_dest(k, nd) for k in keys], live, nd, cap), reps=10)
    p_ms = time_cuda(lambda: P.rank_exchange_plain(arrays, dest, live, nd,
                                                   cap), reps=5)
    l_ms = time_cuda(library, reps=5)
    c_ms = time_cuda(k23_cat, reps=10)
    n_rows = sum(lv.shape[0] for lv in live)
    read = sum(d.nbytes for d in dest) + sum(lv.nbytes for lv in live) + \
        sum(a.nbytes for arr in arrays for a in arr)
    written = nd * nd * cap * (sum(a.element_size() for a in arrays[0]) + 1)
    # a row's rank: its histogram, the scan and the in-block rank
    b, by = bound_ms(read + written, 16 * n_rows)
    log(f"K24 at X2's first monolithic exchange ({nd} sources of "
        f"{[lv.shape[0] for lv in live]} rows, {len(arrays[0])} payload "
        f"columns {[str(a.dtype) for a in arrays[0]]}, bucket_cap {cap}, "
        f"need {need}, live {sum(int(lv.sum()) for lv in live)}): "
        f"{k_ms:.4f} ms (plain {p_ms:.4f}, argsort + index_copy_ "
        f"{l_ms:.4f}, bound {b:.4f} by {by}: {read} bytes read, {written} "
        f"written); with its K26 routing over {len(keys[0])} key(s) "
        f"{r_ms:.4f} ms, K23 + torch.cat {c_ms:.4f} ms")
    out.append({"name": "rank_exchange", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/hash_partition.cu",
                "replaces": "tidb_tpu/parallel/collective.py:46",
                "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b, "bound_by": by, "library_ms": l_ms})
    del arrays, dest, live, keys, iotas, capture["ex"]
    torch.cuda.empty_cache()
    # ---- K25
    cols = capture["rg"]
    got = RG.rank_gather(cols)
    want = RG.rank_gather_plain(cols)
    for x, y in zip(got, want):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError("K25 at X2B's broadcast differs from its "
                                 "plain version")
    del got, want
    k_ms = time_cuda(lambda: RG.rank_gather(cols), reps=20)
    p_ms = time_cuda(lambda: RG.rank_gather_plain(cols), reps=20)
    l_ms = time_cuda(lambda: [torch.cat(c, dim=-1) for c in cols], reps=20)
    nbytes = sum(p.nbytes for c in cols for p in c)
    b, by = bound_ms(2 * nbytes, 0)
    log(f"K25 at X2B's broadcast ({len(cols)} columns x {len(cols[0])} "
        f"ranks, {[p.shape[-1] for p in cols[0]]} rows a rank, "
        f"{[str(c[0].dtype) for c in cols]}): {k_ms:.4f} ms (plain "
        f"{p_ms:.4f}, torch.cat {l_ms:.4f}, bound {b:.4f} by {by}: "
        f"{nbytes} bytes read and written)")
    out.append({"name": "rank_gather", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/rank_gather.cu",
                "replaces": "tidb_tpu/parallel/collective.py:151",
                "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b, "bound_by": by, "library_ms": l_ms})
    profile_rank_gather(cols)
    del cols, capture["rg"]
    # ---- K26 (the kernels line keeps the last: X1's)
    for run, tag in (("X3", "hd3"), ("X1", "hd")):
        keys, nd, kw = capture.pop(tag)
        got = P.hash_dest(keys, nd, **kw)
        want = P.hash_dest_plain(keys, nd, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"K26 at {run}'s partials differs from "
                                 f"its plain version")
        n = got.shape[0]
        k_ms = time_cuda(lambda: P.hash_dest(keys, nd, **kw), reps=20)
        p_ms = time_cuda(lambda: P.hash_dest_plain(keys, nd, **kw), reps=20)
        l_ms = time_cuda(lambda: C.shard_of(C.mix_key_code(keys), nd),
                         reps=20)
        read = sum(v.nbytes + m.nbytes for v, m in keys)
        b, by = bound_ms(read + 4 * n, 40 * n * len(keys))
        log(f"K26 at {run}'s gathered partials (n = {n} slots, {len(keys)} "
            f"keys {[str(v.dtype) for v, _ in keys]}, {nd} shards): "
            f"{k_ms:.4f} ms (plain {p_ms:.4f}, shard_of(mix_key_code) "
            f"{l_ms:.4f}, bound {b:.4f} by {by})")
    out.append({"name": "hash_dest", "route": "cuda",
                "source": "tidb_tpu_torch/csrc/hash_partition.cu",
                "replaces": "tidb_tpu/executor/dist_fragment.py:245",
                "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b, "bound_by": by, "library_ms": l_ms})
    return out


#: (what, call, kernel names) of the calls whose host and device time
#: main splits after phase 26's K25 profile (the run's first profiler
#: session, so phase 26 reads its kernel as before)
DEFERRED_PROFILES: list = []


def profile_split(what, fn, kernels, reps: int = 20):
    """One look at where a wrapper's call goes: its host time (the mean
    over `reps` calls on the host clock; the card is not waited for
    unless the wrapper itself waits, as K22's read-back of its total
    does) and the card's time a call in the kernels (and memsets) whose
    names contain one of `kernels`, from torch.profiler over 5 calls."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    parts = {}
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            if t and e.device_type.name == "CUDA" and \
                    any(k in e.key for k in kernels):
                parts[e.key[:40]] = t / 1e3 / 5
        how = "torch.profiler"
    except Exception as e:              # the profiler is a measurement aid
        how = f"no profile ({type(e).__name__}: {e})"
    dev_ms = sum(parts.values()) if parts else None
    log(f"{what} profile: host time of a call {host_ms:.4f} ms, the card's "
        f"time a call "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
        f"({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; {how})")


def profile_rank_gather(cols):
    """One look at where K25's time goes at X2B's broadcast: the host
    time of a call (the wrapper's pointer tables, its checks and the
    launch, with the card not waited for) and the card's time in the
    kernel, from torch.profiler (CUDA events around the kernel alone
    where the profiler sees no device time)."""
    import torch
    from tidb_tpu_torch.ops import rank_gather as RG
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        RG.rank_gather(cols)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    kernel_ms = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                RG.rank_gather(cols)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0))
            if "rg_copy" in e.key and t:
                kernel_ms = t / 1e3 / 5
        how = "torch.profiler"
    except Exception as e:              # the profiler is a measurement aid
        how = f"no profile ({type(e).__name__}: {e})"
    log(f"K25 profile at X2B's broadcast: host time of a call "
        f"{host_ms:.4f} ms (wrapper and launch, not waiting for the "
        f"card), the card's time in rg_copy "
        f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f} ms'}"
        f" ({how})")


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

    def mark(what: str) -> None:
        log(f"[{time.perf_counter() - t0:.1f} s] {what} done")

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
    check_calendar_kernels(dev)
    check_dict_lut_kernels(dev)
    check_member_compact_kernels(dev)
    check_hash_partition_kernels(dev)
    check_rank_kernels(dev)
    mark("phase 3 (every kernel against its plain version)")

    eng, s, host, launches, walls, q1_slab = sql_phase(dev, args.sf)
    kernels = timing_phase(dev, q1_slab, k1_err)
    names = {"segment_reduce": "segment_reduce",
             "unpack_decode": "unpack_decode",
             "perfect_group_ids": "perfect_groups"}
    for k in kernels:
        k["launches"] = launches[names[k["name"]]]
    wire_phase(eng, host["q1"])
    mark("phases 4-6")
    n = int(round(SF1_ROWS * args.sf))
    join_launches, join_walls, orders, customer, join_host = \
        join_sql_phase(s, n)
    join_kernels = join_timing_phase(dev, n, orders, customer)
    for k in join_kernels:
        k["launches"] = join_launches[k["name"]]
    kernels += join_kernels
    walls.update(join_walls)
    mark("phases 7-8")
    sort_launches, sort_walls, sparse = sort_sql_phase(s, n, orders,
                                                      join_host["q3"])
    sort_kernels = sort_timing_phase(dev, sparse)
    for k in sort_kernels:
        k["launches"] = sort_launches[k["name"]]
    kernels += sort_kernels
    walls.update(sort_walls)
    mark("phases 9-10")
    window_launches, window_walls = window_sql_phase(s)
    window_kernels = window_timing_phase(dev, n, f64_err)
    for k in window_kernels:
        k["launches"] = window_launches[k["name"]]
    kernels += window_kernels
    walls.update(window_walls)
    mark("phases 11-12")
    distinct_launches, distinct_walls = distinct_sql_phase(s)
    distinct_kernels = distinct_timing_phase(dev, n)
    for k in distinct_kernels:
        k["launches"] = distinct_launches[k["name"]]
    kernels += distinct_kernels
    walls.update(distinct_walls)
    mark("phases 13-14")
    delta_launches, delta_walls, delta_inputs, written_host = \
        delta_sql_phase(s, n, host["q1"], join_host["q3"])
    delta_kernels = delta_timing_phase(dev, delta_inputs)
    for k in delta_kernels:
        k["launches"] = delta_launches[k["name"]]
    kernels += delta_kernels
    walls.update(delta_walls)
    mark("phases 15-16")
    expr_launches, expr_walls = expression_sql_phase(s)
    calendar_kernels = calendar_timing_phase(dev)
    for k in calendar_kernels:
        k["launches"] = expr_launches[k["name"]]
    kernels += calendar_kernels
    walls.update(expr_walls)
    mark("phases 17-18")
    string_launches, string_walls = string_sql_phase(s, n)
    lut_kernels = dict_lut_timing_phase(dev)
    for k in lut_kernels:
        k["launches"] = string_launches[k["name"]]
    kernels += lut_kernels
    walls.update(string_walls)
    mark("phases 19-20")
    mb_launches, mb_walls, m1_live = microbatch_sql_phase(eng, s)
    mb_kernels = member_compact_timing_phase(dev, m1_live)
    del m1_live
    for k in mb_kernels:
        k["launches"] = mb_launches[k["name"]]
    kernels += mb_kernels
    walls.update(mb_walls)
    mark("phases 21-22")
    dist_launches, dist_walls, x2_part, dist_host = dist_sql_phase(
        s, {"X1": written_host["q1"], "X2B": written_host["q3"]})
    part_kernels = hash_partition_timing_phase(dev, x2_part)
    del x2_part
    for k in part_kernels:
        k["launches"] = dist_launches[k["name"]]
    kernels += part_kernels
    walls.update(dist_walls)
    mark("phases 23-24")
    mono_launches, mono_walls, mono_capture = mono_sql_phase(s, dist_host)
    rank_kernels = rank_timing_phase(dev, mono_capture)
    del mono_capture
    for k in rank_kernels:
        k["launches"] = mono_launches[k["name"]]
    kernels += rank_kernels
    walls.update(mono_walls)
    mark("phases 25-26")
    for what, fn, names_ in DEFERRED_PROFILES:
        profile_split(what, fn, names_)
    DEFERRED_PROFILES.clear()
    mark("the deferred profiles")
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
    log("expression-phase launches of every kernel: " +
        json.dumps(expr_launches))
    log("string-phase launches of every kernel: " +
        json.dumps(string_launches))
    log("micro-batch launches of K22 and K18: " + json.dumps(mb_launches))
    log("dist-phase launches of every kernel: " + json.dumps(dist_launches))
    log("monolithic-phase launches of every kernel: " +
        json.dumps(mono_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the window scans, the rank gather, the LUT build and probe, the
member compaction, the column gather, the sorted search, the segment reduction,
the window bounds, the join expansion, the slab decode, the dictionary
LUT, the DISTINCT pair factorize, the calendar parts and the RANGE frame
bounds of one checkout on the card, for comparing two checkouts in one
machine's run.

    python tidb_tpu_torch/tools/scan_timing.py --tree DIR [--out FILE]
        [--kernels scan,gather,build,probe,compact,columns,search,segment,
                   bounds,expand,decode,lut,pairs,civil,frame]
        [--profile] [--ptxas] [--host-steps]

imports `tidb_tpu_torch` from DIR (a checkout of the repo, which builds
its own kernels into DIR/build/) and prints one JSON line of median
milliseconds (CUDA events) at chip_smoke's shapes (phase 12's lineitem
layouts in one 8,388,608-row slab, phase 26's X2B broadcast, phase 8's
join, phase 22's masks):

  * scan: K13's int64 prefix + count of W1's running SUM (masked
    l_extendedprice in W1's sorted order) beside torch.cumsum of the
    pre-masked values, K13's segmented max over W2's layout (6
    partitions), and K12 (flags + positions) over W1's layout;
  * gather: K25 at an X2B-shaped broadcast (7 columns: int64, int32 x 2
    and 4 bool masks, x 4 ranks of 524,288 rows) beside torch.cat per
    column;
  * build: K4 at phase 8's orders build (nb = 2,097,152, D = 1,500,303,
    unique mode) beside torch.bincount of the codes, and in multi mode
    (counts and codes);
  * probe: K5 in unique mode, one lineitem slab (8,388,608 rows, 6,001,215
    live) of l_orderkey into K4's lut of the orders build (D =
    1,500,303), beside torch.take of the clamped codes;
  * compact: K22 at B = 16, cap = 8,388,608 over an M1-shaped mask (each
    member the rows of one l_orderkey, M1's keys) and a random half-live
    mask (seed 21), each beside torch.nonzero;
  * columns: K18 at phase 14's shape (D2's pair output: the two key
    codes with masks and l_orderkey of the 2,097,152-row lineitem slab
    with the most (group, l_orderkey) pairs, through rep[:pair_cap])
    beside five index_select, with its host time a call at 1-4 columns;
    where the checkout's K18 takes a keep mask and makes inverses, at the
    moved sites' shapes beside the torch indexing they replace: the join
    finish (4 int64 columns with masks of a 2,097,152-row build through
    an int32 index of 8,388,608 slots with a keep mask, and 1 column),
    LIMIT's 8 columns through 100 slots, and the window scatter back of
    one int64 over 6,001,215 rows (the inverse permutation and the
    gather through it);
  * search: K11 in unique mode at phase 10's shape (2,097,152 distinct
    sorted codes in [0, 2^40), 8,388,608 probes, 80% of them build codes)
    and on the skewed table (2,097,151 codes in [0, 2^21) and one at
    2^62) with the same probes, each beside torch.searchsorted;
  * segment: K1 at phase 5's shape (int64 SUM, 8,388,608 rows, cap 12)
    beside index_add_, and at cap 1, as an f64 SUM (with whether two
    calls give the same bits), a bool COUNT, caps 1,024 and 65,536;
  * bounds: K12 over phase 12's W1 and W2 layouts (`window_bounds`, or
    flags then positions in a checkout without it), and its flags
    entry alone;
  * expand: K7 at phase 8's expand probe (262,144 customer rows probing
    the filtered orders build, out_cap 65,536) and at a skewed shape
    (2^22 probe rows, one with 2^20 matches), each beside
    torch.repeat_interleave;
  * decode: K2 over Q1's seven packed slabs of one 8,388,608-row slab
    (phase 5's layouts), in one call where the checkout has
    `decode_slabs_torch` and one call a column, each column alone, and
    a dict column (3,000 int64 values at width 16);
  * lut: K21 over phase 20's four cases and a 16,384-entry int64 table
    (128 KB), each beside torch.take of the clamped codes and profiled
    alone, the large table beside its random-load floor;
  * pairs: the DISTINCT pair factorize after the value ranks at phase
    14's shape (D1's slab: 8,388,608 rows, 4,380,410 pairs) with its
    launches, K16's entries alone, and K10's word entry over the pair
    sort's word with and without the first mask;
  * civil: K20 over phase 18's five calls (year, week, last_day over
    8,388,608 int32 DATE days, hour over µs, date_add_months +3) and
    `year` over a DATE column below the 32-bit path's range (every warp
    on the 64-bit path);
  * frame: K14 at phase 12's W3 call (RANGE 6 PRECEDING over the int32
    l_shipdate within (l_returnflag, l_linestatus)), with `sorted_key`
    (the main path's call) where the checkout has it and without, and
    over an int64 and a float64 RANGE key on the same rows.

Each kernel is held to its plain version first (exactly; the f64
prefix is not timed). Run two checkouts in turns (A, B, B, A), one
process each, within one run of the machine: cards and power limits
differ between runs. `--profile` adds each CUDA kernel's mean device
time over one call of each timed entry (torch.profiler), under
"kernels_<entry>"; `--ptxas` adds what `nvcc -Xptxas -v` reports for the
chosen kernels' sources (registers, shared memory, spills);
`--host-steps` adds each chosen wrapper's host time split step by step
(under "<kernel>_host_steps"): K25's (checks and contiguity, pointers,
tables, allocation, the ctypes call and launch), K13 prefix's, K4's,
K5's, K18's, K11's, K1's, K12's, K7's, K2's and K21's with the card not
waited for, and K22's, whose read-back of the total waits for its count
pass; the pair factorize's, K20's and K14's host time a call.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

N_ROWS = 6_001_215          # lineitem at SF=1
CAP = 1 << 23               # one slab
X2B_RANK_ROWS = 524_288     # one rank's piece of X2B's filtered orders
N_ORDERS = N_ROWS // 4      # orders at SF=1 (chip_smoke's generator)
M1_KEYS = [1_000 + 93_751 * i for i in range(16)]   # chip_smoke's M1


def _lineitem_columns(dev):
    """chip_smoke's make_lineitem columns that phase 12 sorts by (the
    same seeds and distributions), padded to one slab: l_orderkey,
    l_shipdate, l_extendedprice and the dictionary codes of
    l_returnflag and l_linestatus."""
    import numpy as np
    import torch
    rng = np.random.default_rng(42)
    n = N_ROWS
    rng.integers(100, 5001, n)                                  # qty
    price = rng.integers(90_000, 10_500_001, n).astype(np.int64)
    rng.integers(0, 11, n)                                      # disc
    rng.integers(0, 9, n)                                       # tax
    rflag = rng.integers(0, 3, n).astype(np.int32)
    lstatus = rng.integers(0, 2, n).astype(np.int32)
    ship = rng.integers(8036, 10590, n).astype(np.int32)
    order = np.argsort(ship)
    okey = np.random.default_rng(7).integers(0, n // 4, n).astype(np.int64)

    def col(a, dtype):
        t = torch.zeros(CAP, dtype=dtype)
        t[:n] = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev)

    return {"okey": col(okey, torch.int64),
            "ship": col(ship[order], torch.int32),
            "price": col(price[order], torch.int64),
            "rflag": col(rflag[order], torch.int32),
            "lstatus": col(lstatus[order], torch.int32)}


def _same(what, got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    import torch
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel != plain version")


def _prefix_host_steps(v, valid, reps: int = 50) -> dict:
    """K13 prefix's host time a call, step by step (mean µs, the card not
    waited for): the wrapper's checks, its outputs, its scratch and
    stream, and the ctypes call (the status memset and the launch)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import window as W
    lib = ck.library("window_scan")
    n = v.shape[0]
    steps = {}

    def tick(name, t0):
        t1 = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + (t1 - t0)
        return t1

    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        W._check("window_prefix", n, valid, dtype=torch.bool)
        vals = W._wide(v).contiguous()
        W._check("window_prefix", n, vals)
        t = tick("checks", t)
        cum, ccnt = vals.new_empty((2, n)).unbind(0)
        t = tick("outputs", t)
        stream = ck.stream_ptr(v.device)
        held = W._scan_scratch(n, v.device, stream)
        if isinstance(held, int):           # a checkout without the lock
            held = contextlib.nullcontext(held)
        with held as scratch:
            t = tick("scratch, stream and lock", t)
            rc = lib.tt_window_prefix(vals.data_ptr(), 2, valid.data_ptr(),
                                      n, cum.data_ptr(), ccnt.data_ptr(),
                                      scratch, stream)
            ck.check(rc, "window_prefix")
            t = tick("ctypes call, memset and launch", t)
        tick("lock release", t)
        torch.cuda.synchronize()
    out = {k: val * 1e6 / reps for k, val in steps.items()}
    out["sum of steps"] = sum(steps.values()) * 1e6 / reps
    return out


def run_scan(reps: int, prof: bool, dev, steps: bool = False) -> dict:
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    li = _lineitem_columns(dev)
    rows = torch.arange(CAP, device=dev) < N_ROWS
    ones = torch.ones(CAP, dtype=torch.bool, device=dev)
    live1 = rows & (li["ship"] >= 10439)
    k1 = [(li["okey"], ones), (li["ship"], ones), (li["price"], ones)]
    perm1, _ = F.sort_perm(k1, [False] * 3, live1)
    k2 = [(li["rflag"], ones), (li["lstatus"], ones), (li["price"], ones),
          (li["okey"], ones)]
    perm2, _ = F.sort_perm(k2, [False, False, True, False], rows)
    out = {}

    def k12():
        return W.window_positions(*W.window_flags(perm1, live1, k1, 1))

    def k12_plain():
        return W.window_positions_plain(
            *W.window_flags_plain(perm1, live1, k1, 1))

    _same("K12 W1", k12(), k12_plain())
    valid1 = live1[perm1]
    v1 = li["price"][perm1]
    _same("K13 prefix", W.window_prefix(v1, valid1),
          W.window_prefix_plain(v1, valid1))
    ps2, _ = W.window_flags(perm2, rows, k2, 2)
    v2 = li["price"][perm2]
    valid2 = rows[perm2]
    _same("K13 segmented max", W.window_segscan(v2, valid2, ps2, True),
          W.window_segscan_plain(v2, valid2, ps2, True))
    z = torch.where(valid1, v1, torch.zeros_like(v1))
    out["k13_prefix_ms"] = _median_ms(lambda: W.window_prefix(v1, valid1),
                                      reps)
    out["k13_cumsum_ms"] = _median_ms(lambda: torch.cumsum(z, 0), reps)
    out["k13_segmax_ms"] = _median_ms(
        lambda: W.window_segscan(v2, valid2, ps2, True), reps)
    out["k12_w1_ms"] = _median_ms(k12, reps)
    ps1, qs1 = W.window_flags(perm1, live1, k1, 1)
    out["k12_positions_ms"] = _median_ms(
        lambda: W.window_positions(ps1, qs1), reps)
    if steps and hasattr(W, "scan_scratch_bytes"):
        out["k13_host_steps"] = _prefix_host_steps(v1, valid1)
    if prof:
        out["kernels_k13_prefix"] = _profile(
            [lambda: W.window_prefix(v1, valid1)])
        out["kernels_k13_segmax"] = _profile(
            [lambda: W.window_segscan(v2, valid2, ps2, True)])
        out["kernels_k12_w1"] = _profile([k12])
    return out


def _x2b_columns(dev):
    """Seven columns of four 524,288-row pieces, X2B's broadcast of the
    filtered orders: int64, int32 x 2 and four bool masks."""
    import torch
    g = torch.Generator(device=dev).manual_seed(25)
    cols = []
    for dt in (torch.int64, torch.int32, torch.int32, torch.bool,
               torch.bool, torch.bool, torch.bool):
        pieces = []
        for _r in range(4):
            if dt == torch.bool:
                p = torch.rand(X2B_RANK_ROWS, device=dev, generator=g) < 0.5
            else:
                p = torch.randint(0, 1 << 30, (X2B_RANK_ROWS,), device=dev,
                                  generator=g, dtype=dt)
            pieces.append(p)
        cols.append(pieces)
    return cols


def _host_steps(cols, reps: int = 50) -> dict:
    """K25's host time a call, step by step (mean µs, the card not waited
    for), over the checkout's own wrapper: the steps of the per-piece
    wrapper (a checkout without `gather_plan`) or of the per-column one."""
    import ctypes
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import rank_gather as RG
    dev = cols[0][0].device
    lib = ck.library("rank_gather")
    steps = {}

    def tick(name, t0):
        t1 = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + (t1 - t0)
        return t1

    torch.cuda.synchronize()
    total0 = time.perf_counter()
    for _ in range(reps):
        t = time.perf_counter()
        if hasattr(RG, "gather_plan"):
            plan, src, keep = RG._describe(cols, dev)
            t = tick("checks, pointers and the cached plan", t)
            outs = RG._allocate(plan, [pieces[0] for pieces in keep])
            t = tick("allocation", t)
            RG._launch(plan, src, outs, dev)
            tick("tables, ctypes call and launch", t)
        else:
            outs, src, dst, nbytes, keep = [], [], [], [], []
            contig = [[p.contiguous() for p in pieces] for pieces in cols]
            t = tick("contiguity", t)
            for pieces in contig:
                RG._check_pieces(pieces, dev)
            t = tick("checks", t)
            for pieces in contig:
                total = sum(p.shape[-1] for p in pieces)
                outs.append(torch.empty((total,), dtype=pieces[0].dtype,
                                        device=dev))
            t = tick("allocation", t)
            for pieces, out in zip(contig, outs):
                size = pieces[0].element_size()
                off = 0
                for p in pieces:
                    n = p.shape[-1]
                    src.append(p.data_ptr())
                    dst.append(out.data_ptr() + off * size)
                    nbytes.append(n * size)
                    off += n
            t = tick("pointer lists", t)
            k = len(src)
            src_t = (ctypes.c_uint64 * k)(*src)
            dst_t = (ctypes.c_uint64 * k)(*dst)
            nb_t = (ctypes.c_int64 * k)(*nbytes)
            t = tick("ctypes arrays", t)
            stream = ck.stream_ptr(dev)
            t = tick("stream", t)
            rc = lib.tt_rank_gather(k, ctypes.addressof(src_t),
                                    ctypes.addressof(dst_t),
                                    ctypes.addressof(nb_t), stream)
            ck.check(rc, "rank_gather")
            tick("ctypes call and launch", t)
    total = time.perf_counter() - total0
    torch.cuda.synchronize()
    out = {k: v * 1e6 / reps for k, v in steps.items()}
    out["sum of steps"] = sum(v for v in steps.values()) * 1e6 / reps
    out["loop"] = total * 1e6 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        RG.rank_gather(cols)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    out["unit costs"] = _unit_costs(cols, reps)
    if hasattr(RG, "gather_plan"):
        key = tuple((c[0].dtype, tuple(c[0].shape[:-1]),
                     tuple(p.shape[-1] for p in c)) for c in cols)
        t0 = time.perf_counter()
        for _ in range(reps):
            RG.gather_plan(key)
        out["plan lookup (cached)"] = (time.perf_counter() - t0) * 1e6 / reps
    return out


def _unit_costs(cols, reps: int) -> dict:
    """Mean µs of the host operations a gather wrapper is made of, on
    X2B's pieces: tensor attributes a piece, allocations a column (one
    torch.empty each, or one arena split into typed views), the
    current stream's handle."""
    import torch
    dev = cols[0][0].device
    p = cols[0][0]
    attrs = {"p.device": lambda: p.device, "p.get_device()": p.get_device,
             "p.dtype": lambda: p.dtype, "p.shape": lambda: p.shape,
             "p.is_contiguous()": p.is_contiguous,
             "p.data_ptr()": p.data_ptr,
             "p.element_size()": p.element_size,
             "torch.cuda.current_stream(dev).cuda_stream":
                 lambda: torch.cuda.current_stream(dev).cuda_stream,
             "torch._C._cuda_getCurrentRawStream(0)":
                 lambda: torch._C._cuda_getCurrentRawStream(0)}
    out = {}
    for name, fn in attrs.items():
        t0 = time.perf_counter()
        for _ in range(reps * 20):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / (reps * 20)
    sizes = [4 * X2B_RANK_ROWS * c[0].element_size() for c in cols]
    dtypes = [c[0].dtype for c in cols]

    def per_column():
        return [torch.empty((s // d.itemsize,), dtype=d, device=dev)
                for s, d in zip(sizes, dtypes)]

    def new_empty():
        return [c[0].new_empty((s // d.itemsize,))
                for c, s, d in zip(cols, sizes, dtypes)]

    def arena():
        parts = torch.empty((sum(sizes),), dtype=torch.uint8,
                            device=dev).split_with_sizes(sizes)
        return [t.view(d) for t, d in zip(parts, dtypes)]

    def grouped():
        outs = []
        for d in sorted(set(dtypes), key=str):
            k = dtypes.count(d)
            buf = torch.empty((k, 4 * X2B_RANK_ROWS), dtype=d, device=dev)
            outs += buf.unbind(0) if k > 1 else [buf[0]]
        return outs

    for name, fn in (("alloc: torch.empty a column", per_column),
                     ("alloc: new_empty a column", new_empty),
                     ("alloc: one arena, split, view(dtype)", arena),
                     ("alloc: torch.empty a dtype, unbind", grouped)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / reps
    return out


def run_gather(reps: int, prof: bool, steps: bool, dev) -> dict:
    import torch
    from tidb_tpu_torch.ops import rank_gather as RG
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    cols = _x2b_columns(dev)
    _same("K25 X2B", RG.rank_gather(cols), RG.rank_gather_plain(cols))
    out = {"k25_ms": _median_ms(lambda: RG.rank_gather(cols), reps),
           "k25_cat_ms": _median_ms(
               lambda: [torch.cat(c, dim=-1) for c in cols], reps)}
    if prof:
        out["kernels_k25"] = _profile([lambda: RG.rank_gather(cols)])
    if steps:
        out["k25_host_steps"] = _host_steps(cols)
    return out


def _ticker(steps: dict):
    def tick(name, t0):
        t1 = time.perf_counter()
        steps[name] = steps.get(name, 0.0) + (t1 - t0)
        return t1
    return tick


def _mean_us(steps: dict, reps: int) -> dict:
    out = {k: v * 1e6 / reps for k, v in steps.items()}
    out["sum of steps"] = sum(steps.values()) * 1e6 / reps
    return out


def _probe_inputs(dev):
    """Phase 8's K5 call: the orders build (o_orderkey = 0..D-1 in a
    2,097,152-row buffer) through K4, and one lineitem slab of
    l_orderkey (the generator chip_smoke and bench.py share)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import join as J
    nb = 1 << 21
    bkey = torch.zeros(nb, dtype=torch.int64)
    bkey[:N_ORDERS] = torch.arange(N_ORDERS)
    blive = torch.arange(nb) < N_ORDERS
    bkeys = [(bkey.to(dev), blive.to(dev))]
    bounds = [(0, N_ORDERS - 1)]
    cnt, lut, _, _ = J.lut_build(bkeys, bounds, N_ORDERS,
                                 live=blive.to(dev))
    okey = np.random.default_rng(7).integers(0, N_ORDERS, N_ROWS)
    pkey = torch.zeros(CAP, dtype=torch.int64)
    pkey[:N_ROWS] = torch.from_numpy(okey)
    plive = (torch.arange(CAP) < N_ROWS).to(dev)
    return [(pkey.to(dev), plive)], bounds, cnt, lut, plive, nb


def _probe_host_steps(args, reps: int = 50) -> dict:
    """K5's host time a call, step by step (mean µs, the card not waited
    for), over the checkout's own wrapper: the argument block cached per
    key signature (`probe_plan`) or the ctypes arrays of every call."""
    import ctypes
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import join as J
    keys, bounds, cnt, table, live, nb = args
    lib = ck.library("lut_join")
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        domain = cnt.shape[0] - 1
        bt = J._check_domain(domain, bounds, "lut_probe")
        if hasattr(J, "probe_plan"):
            cols, n = J._key_cols(keys, bt, "lut_probe")
            ck.require_cuda(cnt, table, live, what="lut_probe")
            t = tick("checks", t)
            a = J._ProbeArgs.from_buffer_copy(J.probe_plan(
                tuple(v.dtype == torch.int64 for v, _ in cols), bt, nb,
                True))
            for q, (v, m) in enumerate(cols):
                a.vals[q] = v.data_ptr()
                a.masks[q] = m.data_ptr()
            t = tick("cached plan and key pointers", t)
            out_a = torch.empty(n, dtype=torch.int32, device=live.device)
            out_b = torch.empty(n, dtype=torch.bool, device=live.device)
            t = tick("allocation", t)
            a.live = live.data_ptr()
            a.table = table.data_ptr()
            a.out_a = out_a.data_ptr()
            a.out_b = out_b.data_ptr()
            a.n = n
            stream = ck.stream_ptr(live.device)
            t = tick("other pointers and stream", t)
            rc = lib.tt_lut_probe(ctypes.addressof(a), stream)
        else:
            args_c, cols, n = J._key_args(keys, bounds, "lut_probe")
            ck.require_cuda(cnt, table, live, what="lut_probe")
            t = tick("checks and ctypes arrays", t)
            out_a = torch.empty(n, dtype=torch.int32, device=live.device)
            out_b = torch.empty(n, dtype=torch.bool, device=live.device)
            t = tick("allocation", t)
            stream = ck.stream_ptr(live.device)
            t = tick("other pointers and stream", t)
            rc = lib.tt_lut_probe(len(cols), *args_c, live.data_ptr(), n,
                                  domain, cnt.data_ptr(), table.data_ptr(),
                                  1, nb, out_a.data_ptr(), out_b.data_ptr(),
                                  stream)
        ck.check(rc, "lut_probe")
        tick("ctypes call and launch", t)
    torch.cuda.synchronize()
    out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        J.lut_probe(keys, bounds, cnt, table, live, nb, True)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_probe(reps: int, prof: bool, steps: bool, dev) -> dict:
    import torch
    from tidb_tpu_torch.ops import join as J
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    args = _probe_inputs(dev)
    keys, bounds, cnt, lut, plive, nb = args
    _same("K5 phase 8", J.lut_probe(keys, bounds, cnt, lut, plive, nb, True),
          J.lut_probe_plain(keys, bounds, cnt, lut, plive, nb, True))
    pc = keys[0][0].clamp(0, N_ORDERS - 1)
    out = {"k5_ms": _median_ms(
        lambda: J.lut_probe(keys, bounds, cnt, lut, plive, nb, True), reps),
        "k5_take_ms": _median_ms(lambda: torch.take(lut, pc), reps)}
    if prof:
        out["kernels_k5"] = _profile(
            [lambda: J.lut_probe(keys, bounds, cnt, lut, plive, nb, True)])
        out["kernels_take"] = _profile([lambda: torch.take(lut, pc)])
    if steps:
        out["k5_host_steps"] = _probe_host_steps(args)
    return out


def _build_inputs(dev):
    """Phase 8's K4 call: the orders build (o_orderkey = 0..D-1 in a
    2,097,152-row buffer, live over its first D rows)."""
    import torch
    nb = 1 << 21
    bkey = torch.zeros(nb, dtype=torch.int64)
    bkey[:N_ORDERS] = torch.arange(N_ORDERS)
    blive = (torch.arange(nb) < N_ORDERS).to(dev)
    return [(bkey.to(dev), blive)], [(0, N_ORDERS - 1)], N_ORDERS, blive


def _build_host_steps(args, reps: int = 50) -> dict:
    """K4's host time a call, step by step (mean µs, the card not waited
    for), over the checkout's own wrapper: one allocation and a cached
    argument block (`build_plan`), or the ctypes arrays and the four
    allocations and three torch fills of every call."""
    import ctypes
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import join as J
    keys, bounds, domain, live = args
    lib = ck.library("lut_join")
    steps = {}
    tick = _ticker(steps)
    dev = live.device
    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        if hasattr(J, "build_plan"):
            bt = J._check_domain(domain, bounds, "lut_build")
            cols, nb = J._key_cols(keys, bt, "lut_build")
            ck.require_cuda(live, what="lut_build")
            t = tick("checks", t)
            lut_at, _, words = J.build_layout(domain, nb, True, False)
            buf = torch.empty(words, dtype=torch.int32, device=dev)
            t = tick("allocation", t)
            a = J._BuildArgs.from_buffer_copy(J.build_plan(
                tuple(v.dtype == torch.int64 for v, _ in cols), bt, True,
                False))
            for q, (v, m) in enumerate(cols):
                a.vals[q] = v.data_ptr()
                a.masks[q] = m.data_ptr()
            a.live = live.data_ptr()
            a.out = buf.data_ptr()
            a.nb = nb
            a.n_live = nb
            stream = ck.stream_ptr(dev)
            t = tick("cached plan, pointers and stream", t)
            rc = lib.tt_lut_build(ctypes.addressof(a), stream)
            ck.check(rc, "lut_build")
            t = tick("ctypes call, memsets and launch", t)
            (buf[1:domain + 2], buf[lut_at:lut_at + domain + 1], buf[0])
            tick("views", t)
        else:
            J._check_domain(domain, bounds, "lut_build")
            args_c, cols, nb = J._key_args(keys, bounds, "lut_build")
            ck.require_cuda(live, what="lut_build")
            t = tick("checks and ctypes arrays", t)
            cnt = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
            lut = torch.full((domain + 1,), -1, dtype=torch.int32,
                             device=dev)
            maxcnt = torch.zeros((), dtype=torch.int32, device=dev)
            t = tick("allocation and torch fills", t)
            stream = ck.stream_ptr(dev)
            t = tick("stream", t)
            rc = lib.tt_lut_build(len(cols), *args_c, live.data_ptr(), nb,
                                  nb, domain, cnt.data_ptr(), lut.data_ptr(),
                                  None, maxcnt.data_ptr(), stream)
            ck.check(rc, "lut_build")
            tick("ctypes call and launch", t)
    torch.cuda.synchronize()
    out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        J.lut_build(keys, bounds, domain, live=live)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_build(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K4 at phase 8's orders build (unique mode, as Q3/Q5's first join
    calls it), held to its plain version (cnt, maxcnt, and lut where a
    code has one row), beside torch.bincount of the codes with the
    sentinel; and in multi mode (counts and codes, no lut)."""
    import torch
    from tidb_tpu_torch.ops import join as J
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    args = _build_inputs(dev)
    keys, bounds, domain, live = args
    got = J.lut_build(keys, bounds, domain, live=live, want_codes=True)
    want = J.lut_build_plain(keys, bounds, domain, live=live,
                             want_codes=True)
    single = want[0][:domain] <= 1
    _same("K4 phase 8", (got[0], got[2], got[3], got[1][:domain][single]),
          (want[0], want[2], want[3], want[1][:domain][single]))
    code = torch.where(live & keys[0][1], keys[0][0],
                       torch.full_like(keys[0][0], domain))
    out = {"k4_ms": _median_ms(
        lambda: J.lut_build(keys, bounds, domain, live=live), reps),
        "k4_multi_ms": _median_ms(
        lambda: J.lut_build(keys, bounds, domain, live=live, want_lut=False,
                            want_codes=True), reps),
        "k4_bincount_ms": _median_ms(
        lambda: torch.bincount(code, minlength=domain + 1), reps)}
    if prof:
        out["kernels_k4"] = _profile(
            [lambda: J.lut_build(keys, bounds, domain, live=live)])
        out["kernels_k4_multi"] = _profile(
            [lambda: J.lut_build(keys, bounds, domain, live=live,
                                 want_lut=False, want_codes=True)])
    if steps:
        out["k4_host_steps"] = _build_host_steps(args)
    return out


def _compact_masks(dev):
    """Phase 22's two [16, 8,388,608] masks: M1's shape (member k live
    where l_orderkey is M1's k-th key, about 4 rows a member) and a
    random half-live mask (seed 21, as chip_smoke)."""
    import numpy as np
    import torch
    okey = np.random.default_rng(7).integers(0, N_ORDERS, N_ROWS)
    m1 = torch.zeros((len(M1_KEYS), CAP), dtype=torch.bool)
    for k, key in enumerate(M1_KEYS):
        m1[k, :N_ROWS] = torch.from_numpy(okey == key)
    g = torch.Generator(device=dev).manual_seed(21)
    half = torch.rand((len(M1_KEYS), CAP), device=dev, generator=g) < 0.5
    return {"m1": m1.to(dev), "half": half}


def _compact_host_steps(live, reps: int = 20) -> dict:
    """K22's host time a call, step by step (mean µs): checks, the
    outputs, the scratch (the per-stream scratch, or the parent's tile
    counts), the count pass's call with the read-back of the total (which
    waits for the count pass: inside the entry, or the parent's
    int(offsets[B])), ids and the scatter's call."""
    import torch
    from tidb_tpu_torch.ops import compact as MC
    from tidb_tpu_torch.ops import cuda_kernels as ck
    lib = ck.library("member_compact")
    dev = live.device
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        ck.require_cuda(live, what="member_compact")
        b, cap = live.shape
        t = tick("checks", t)
        stream = ck.stream_ptr(dev)
        if hasattr(MC, "scratch_bytes"):
            offsets = torch.empty(b + 1, dtype=torch.int64, device=dev)
            counts = torch.empty(b, dtype=torch.int64, device=dev)
            t = tick("offsets and counts", t)
            ent = MC._stream_scratch(dev, stream)
            if ent.buf is None or ent.buf.numel() < MC.scratch_bytes(b, cap):
                ent.buf = torch.empty(MC.scratch_bytes(b, cap),
                                      dtype=torch.uint8, device=dev)
            scratch = ent.buf.data_ptr()
            tot = ctypes.c_longlong()
            t = tick("stream and scratch", t)
            rc = lib.tt_member_count(live.data_ptr(), b, cap, scratch,
                                     offsets.data_ptr(), counts.data_ptr(),
                                     ctypes.addressof(tot), stream)
            ck.check(rc, "member_compact")
            total = tot.value
            t = tick("count call, launch and read-back of the total "
                     "(waits for the count pass)", t)
        else:
            ntiles = -(-cap // MC.TILE)
            tiles = torch.empty(max(b * ntiles, 1), dtype=torch.int64,
                                device=dev)
            scratch = tiles.data_ptr()
            offsets = torch.empty(b + 1, dtype=torch.int64, device=dev)
            counts = torch.empty(b, dtype=torch.int64, device=dev)
            t = tick("offsets and counts", t)
            t = tick("stream and scratch", t)
            rc = lib.tt_member_count(live.data_ptr(), b, cap, scratch,
                                     offsets.data_ptr(), counts.data_ptr(),
                                     stream)
            ck.check(rc, "member_compact")
            total = int(offsets[b])
            t = tick("count call, launch and read-back of the total "
                     "(waits for the count pass)", t)
        ids = torch.empty(total, dtype=torch.int32, device=dev)
        t = tick("ids", t)
        if total:
            rc = lib.tt_member_scatter(live.data_ptr(), b, cap, scratch,
                                       ids.data_ptr(), stream)
            ck.check(rc, "member_compact")
        tick("scatter call and launch", t)
        torch.cuda.synchronize()
    return _mean_us(steps, reps)


def run_compact(reps: int, prof: bool, steps: bool, dev) -> dict:
    import torch
    from tidb_tpu_torch.ops import compact as MC
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {}
    for name, live in _compact_masks(dev).items():
        _same(f"K22 {name}", MC.member_compact(live),
              MC.member_compact_plain(live))
        out[f"k22_{name}_ms"] = _median_ms(lambda: MC.member_compact(live),
                                           reps)
        out[f"k22_{name}_nonzero_ms"] = _median_ms(
            lambda: torch.nonzero(live), reps)
        out[f"k22_{name}_live_rows"] = int(live.sum())
        if prof:
            out[f"kernels_k22_{name}"] = _profile(
                [lambda: MC.member_compact(live)])
        if steps:
            out[f"k22_{name}_host_steps"] = _compact_host_steps(live)
    return out


def _pair_output(dev):
    """Phase 14's K18 call: D2's pair output over the 2,097,152-row slab
    of lineitem with the most (group, l_orderkey) pairs, as chip_smoke
    builds it (`distinct_pair_factorize` of the checkout) → (columns,
    idx = rep[:pair_cap], n_pairs)."""
    import torch
    from tidb_tpu_torch.ops import factorize as F
    li = _lineitem_columns(dev)
    rows = torch.arange(CAP, device=dev) < N_ROWS
    ones = torch.ones(CAP, dtype=torch.bool, device=dev)
    gids = torch.where(rows, li["rflag"] * 2 + li["lstatus"],
                       torch.full_like(li["rflag"], 6)).contiguous()
    sc = 1 << 21
    best = None
    for lo in range(0, N_ROWS, sc):
        m = min(N_ROWS - lo, sc)
        srows = torch.arange(sc, device=dev) < m
        sg = torch.full((sc,), 6, dtype=torch.int32, device=dev)
        so = torch.zeros(sc, dtype=torch.int64, device=dev)
        sg[:m] = gids[lo:lo + m]
        so[:m] = li["okey"][lo:lo + m]
        _f, _p, pairs, rep = F.distinct_pair_factorize(
            sg, so, srows, srows, sc, gid_cap=6)
        if best is None or int(pairs) > int(best[0]):
            best = (pairs, rep, lo, so)
    pairs, rep, lo, so = best
    k = int(pairs)
    pc = min(1 << max(16, (k - 1).bit_length()), sc)
    cols = [(li["rflag"][lo:lo + sc].contiguous(), ones[:sc]),
            (li["lstatus"][lo:lo + sc].contiguous(), ones[:sc]),
            (so, None)]
    return cols, rep[:pc], pairs


def _columns_host_steps(cols, idx, n_valid, reps: int = 50) -> dict:
    """K18's host time a call (mean µs, the card not waited for): the
    wrapper call, and its steps — for a checkout with one packed argument
    block a call (the checks and output kinds, the outputs and their
    views, the block's `struct.pack`, the ctypes call and launch), for one
    with the cached plan (signature and plan lookup, the one allocation,
    the argument block's pointers, the ctypes call and launch, the output
    views made while the kernel runs)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import gather as G
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    out = {}
    m = idx.shape[0]
    if hasattr(G, "_pack"):
        dev = idx.get_device()
        for _ in range(reps):
            t = time.perf_counter()
            G._check_index(idx, n_valid, None)
            kinds, dtypes, shapes = [], [], []
            for v, mk in cols:
                w, planes = G._kind(v, dev, cols[0][0].shape[-1])
                if mk is not None:
                    G._check_mask(mk, dev, v.shape[-1])
                kinds.append((w, planes, True))
                dtypes.append(v.dtype)
                shapes.append((m,))
            t = tick("checks and kinds", t)
            _vals, _masks, vptrs, mptrs = G._outputs(
                tuple(kinds), dtypes, shapes, m, idx.device, False)
            t = tick("outputs and views", t)
            planes = []
            for (v, mk), (w, _p, _wm), vp, mp in zip(cols, kinds, vptrs,
                                                    mptrs):
                planes += (v.data_ptr(), 0 if mk is None else mk.data_ptr(),
                           vp, mp, w)
            block = G._pack(idx, n_valid, None, m, cols[0][0].shape[-1],
                            planes)
            t = tick("argument block", t)
            G._call(block, len(cols), dev)
            tick("ctypes call and launch", t)
        torch.cuda.synchronize()
        out = _mean_us(steps, reps)
    elif hasattr(G, "_views"):
        lib = ck.library("gather_columns")
        for _ in range(reps):
            t = time.perf_counter()
            blocks, widths, dtypes = G._checked_plan(
                G._signature(cols, idx, n_valid))
            t = tick("signature and cached plan", t)
            vals, masks, total = G.out_layout(widths, m)
            buf = torch.empty(total, dtype=torch.bool, device=idx.device)
            t = tick("one allocation", t)
            base = buf.data_ptr()
            k = len(cols)
            a = G._GatherArgs.from_buffer_copy(blocks[0])
            a.src[:k] = [v.data_ptr() for v, _m in cols]
            a.msrc[:k] = [None if mk is None else mk.data_ptr()
                          for _v, mk in cols]
            a.dst[:k] = [base + o for o in vals]
            a.mdst[:k] = [base + o for o in masks]
            a.idx = idx.data_ptr()
            a.n_valid = n_valid.data_ptr()
            a.m = m
            stream = ck.stream_ptr(idx.device)
            t = tick("argument block and stream", t)
            rc = lib.tt_gather_columns(ctypes.addressof(a), stream)
            ck.check(rc, "gather_columns")
            t = tick("ctypes call and launch", t)
            G._views(buf, widths, dtypes, m)
            tick("output views (the kernel running)", t)
        torch.cuda.synchronize()
        out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        G.gather_columns(cols, idx, n_valid)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def _host_us(fn, reps: int = 200) -> float:
    """Median µs of host time a call (the card not waited for; synchronized
    every 20 calls so the launch queue never fills)."""
    import statistics
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _output_ways(dev) -> dict:
    """Median host µs of making a call's k (value, mask) outputs, int64
    values of 2,097,152 slots, k = 1..4, four ways: one allocation cut by
    `split_with_sizes` (values viewed as int64), one allocation cut by
    Python slices, one `torch.empty` an output, and one allocation a
    dtype (values, masks) with `unbind` rows."""
    import torch
    m = 1 << 21
    out = {}
    for k in (1, 2, 3, 4):
        sizes = [8 * m] * k + [m] * k

        def split():
            b = torch.empty(9 * m * k, dtype=torch.bool, device=dev)
            p = b.split_with_sizes(sizes)
            return [p[i].view(torch.int64) for i in range(k)], p[k:]

        def slices():
            b = torch.empty(9 * m * k, dtype=torch.bool, device=dev)
            return ([b[8 * m * i:8 * m * (i + 1)].view(torch.int64)
                     for i in range(k)],
                    [b[8 * m * k + m * i:8 * m * k + m * (i + 1)]
                     for i in range(k)])

        def empties():
            return ([torch.empty(m, dtype=torch.int64, device=dev)
                     for _ in range(k)],
                    [torch.empty(m, dtype=torch.bool, device=dev)
                     for _ in range(k)])

        def rows():
            return (torch.empty((k, m), dtype=torch.int64,
                                device=dev).unbind(0),
                    torch.empty((k, m), dtype=torch.bool,
                                device=dev).unbind(0))

        out[str(k)] = {name: _host_us(fn) for name, fn in
                       (("split", split), ("slices", slices),
                        ("empties", empties), ("rows", rows))}
    return out


JOIN_P = CAP                # the join finish's probe slab
JOIN_B = 1 << 21            # its build rows
WINDOW_N = N_ROWS           # the window scatter back's rows
LIMIT_K = 100               # LIMIT's slots (chip_smoke's LIMIT_JOIN)


def _join_finish_inputs(dev, ncols: int):
    """The join finish's shape: `ncols` int64 build columns with masks of
    JOIN_B rows, gathered through an int32 index of JOIN_P slots (0 on
    the unmatched ones, as K5 leaves them) with the match as the keep
    mask."""
    import torch
    g = torch.Generator(device=dev).manual_seed(71)
    cols = [(torch.randint(-(1 << 40), 1 << 40, (JOIN_B,), device=dev,
                           generator=g),
             torch.rand(JOIN_B, device=dev, generator=g) < 0.95)
            for _ in range(ncols)]
    keep = torch.rand(JOIN_P, device=dev, generator=g) < 0.8
    idx = torch.where(keep, torch.randint(0, JOIN_B, (JOIN_P,), device=dev,
                                          generator=g),
                      torch.zeros((), dtype=torch.int64, device=dev)
                      ).to(torch.int32)
    return cols, idx, keep


def _torch_join_finish(cols, idx, keep):
    """The parent's join finish: per column `v[idx]`, `m[idx]`, `& keep`."""
    return [(v[idx], m[idx] & keep) for v, m in cols]


def _window_inputs(dev):
    """The window scatter back's shape: one int64 result and its mask over
    WINDOW_N rows in a sort permutation's order (int64, live rows first),
    and the live mask."""
    import torch
    g = torch.Generator(device=dev).manual_seed(72)
    live = torch.rand(WINDOW_N, device=dev, generator=g) < 0.9
    key = torch.randint(0, 1 << 30, (WINDOW_N,), device=dev, generator=g)
    perm = torch.argsort(torch.where(live, key, key + (1 << 31)))
    v = torch.randint(-(1 << 40), 1 << 40, (WINDOW_N,), device=dev,
                      generator=g)
    m = torch.rand(WINDOW_N, device=dev, generator=g) < 0.97
    return v, m, perm, live


def _torch_scatter_back(v, m, perm, live):
    """The parent's scatter back: two `index_put_`s and `& live`."""
    import torch
    back_v = torch.empty_like(v)
    back_v[perm] = v
    back_m = torch.empty_like(m)
    back_m[perm] = m
    return back_v, back_m & live


def _bytes_ms(n_bytes: float) -> float:
    return n_bytes / 3.35e12 * 1e3


def run_columns(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K18 at phase 14's pair output, then (where the checkout's K18 takes
    a keep mask and makes inverses) at each moved site's shape beside the
    torch indexing it replaces: the join finish (4 columns and 1), the
    window scatter back (the inverse permutation and a gather through it)
    and LIMIT's 8 columns; with the host time a call at 1-4 columns and
    the pass budget's sweep at the join finish and the pair output."""
    import torch
    from tidb_tpu_torch.ops import gather as G
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    cols, idx, pairs = _pair_output(dev)
    got = G.gather_columns(cols, idx, pairs)
    want = G.gather_columns_plain(cols, idx, pairs)
    for (a, am), (b, bm) in zip(got, want):
        _same("K18 phase 14", (a, am), (b, bm))
    il = idx.long()

    def lib():
        return [(torch.index_select(v, 0, il),
                 None if m is None else torch.index_select(m, 0, il))
                for v, m in cols]

    out = {"k18_slots": idx.shape[0], "k18_pairs": int(pairs),
           "k18_ms": _median_ms(lambda: G.gather_columns(cols, idx, pairs),
                                reps),
           "k18_index_select_ms": _median_ms(lib, reps)}
    one = [(cols[2][0], cols[0][1])]
    out["k18_host_us"] = {
        str(k): _host_us(lambda k=k: G.gather_columns((cols + one)[:k], idx,
                                                      pairs))
        for k in (1, 2, 3, 4)}
    if prof:
        out["kernels_k18"] = _profile(
            [lambda: G.gather_columns(cols, idx, pairs)])
        out["kernels_index_select"] = _profile([lib])
    if steps:
        out["k18_host_steps"] = _columns_host_steps(cols, idx, pairs)
        out["k18_output_ways_us"] = _output_ways(dev)
    pcols, pidx = cols, idx
    # the moved sites' shapes; the torch indexing they replace runs in
    # every checkout
    new = hasattr(G, "inverse_permutation")
    jcols, jidx, keep = _join_finish_inputs(dev, 4)
    out["join_torch_ms"] = _median_ms(
        lambda: _torch_join_finish(jcols, jidx, keep), reps)
    out["join1_torch_ms"] = _median_ms(
        lambda: _torch_join_finish(jcols[:1], jidx, keep), reps)
    out["join_bound_ms"] = _bytes_ms(JOIN_P * (4 + 1 + 4 * (8 + 1 + 8 + 1)))
    out["join1_bound_ms"] = _bytes_ms(JOIN_P * (4 + 1 + 8 + 1 + 8 + 1))
    if new:
        got = G.gather_columns(jcols, jidx, keep=keep)
        for (a, am), (b, bm) in zip(got, _torch_join_finish(jcols, jidx,
                                                            keep)):
            _same("K18 join finish", (a, am), (b, bm))
        out["join_k18_ms"] = _median_ms(
            lambda: G.gather_columns(jcols, jidx, keep=keep), reps)
        out["join1_k18_ms"] = _median_ms(
            lambda: G.gather_columns(jcols[:1], jidx, keep=keep), reps)
        if prof:
            out["kernels_join_k18"] = _profile(
                [lambda: G.gather_columns(jcols, jidx, keep=keep)])
            out["kernels_join_torch"] = _profile(
                [lambda: _torch_join_finish(jcols, jidx, keep)])
        # the pass budget: one pass, and passes of 8, 24 and 40 MB, at the
        # join finish and at phase 14's pair output
        default = G.PASS_BYTES
        sweep = {}
        try:
            for G.PASS_BYTES in (0, 8 << 20, 24 << 20, 40 << 20):
                sweep[str(G.PASS_BYTES)] = {
                    "join_ms": _median_ms(lambda: G.gather_columns(
                        jcols, jidx, keep=keep), reps),
                    "pairs_ms": _median_ms(lambda: G.gather_columns(
                        pcols, pidx, pairs), reps)}
        finally:
            G.PASS_BYTES = default
        out["k18_pass_sweep"] = sweep
    # LIMIT's 8 columns (4 values and their masks of each width) through
    # LIMIT_K slots
    lcols = jcols + [(v.to(torch.int32), m) for v, m in jcols]
    lidx = jidx[:LIMIT_K].to(torch.int64)
    out["limit_torch_ms"] = _median_ms(
        lambda: [(v[lidx], m[lidx]) for v, m in lcols], reps)
    out["limit_torch_host_us"] = _host_us(
        lambda: [(v[lidx], m[lidx]) for v, m in lcols])
    if new:
        out["limit_k18_ms"] = _median_ms(
            lambda: G.gather_columns(lcols, lidx), reps)
        out["limit_k18_host_us"] = _host_us(
            lambda: G.gather_columns(lcols, lidx))
    del jcols, jidx, keep, lcols, pcols, pidx
    v, m, perm, live = _window_inputs(dev)
    out["scatter_torch_ms"] = _median_ms(
        lambda: _torch_scatter_back(v, m, perm, live), reps)
    out["scatter_bound_ms"] = _bytes_ms(WINDOW_N * (8 + 1 + 8 + 1 + 8 + 1))
    if new:
        def inverse():
            inv = G.inverse_permutation(perm, WINDOW_N)
            return G.gather_columns([(v, m)], inv, keep=live)

        (b, bm), = inverse()
        _same("K18 inverse gather", (b, bm),
              _torch_scatter_back(v, m, perm, live))
        out["inverse_k18_ms"] = _median_ms(inverse, reps)
        out["inverse_only_ms"] = _median_ms(
            lambda: G.inverse_permutation(perm, WINDOW_N), reps)
        inv = G.inverse_permutation(perm, WINDOW_N)
        out["inverse_gather_only_ms"] = _median_ms(
            lambda: G.gather_columns([(v, m)], inv, keep=live), reps)
        # a layout's four results (W1's spec shares its layout with three
        # others): the inverse once and one gather
        four = [(v, m), (v + 1, m), (v + 2, ~m), (v + 3, m)]
        out["inverse_k18_4_ms"] = _median_ms(
            lambda: G.gather_columns(
                four, G.inverse_permutation(perm, WINDOW_N), keep=live),
            reps)
        out["scatter_torch_4_ms"] = _median_ms(
            lambda: [_torch_scatter_back(a, b, perm, live)
                     for a, b in four], reps)
        if prof:
            out["kernels_inverse_k18"] = _profile([inverse])
            out["kernels_scatter_torch"] = _profile(
                [lambda: _torch_scatter_back(v, m, perm, live)])
    return out


def _search_inputs(dev, skewed: bool):
    """Phase 10's K11 call (2,097,152 distinct sorted codes in [0, 2^40),
    a random build order, 8,388,608 probes: 80% build codes, the rest in
    [0, 2^40), 5% not ok), or the skewed table (2,097,151 codes in
    [0, 2^21) and one at 2^62) under the same probes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(29)
    nb, n = 1 << 21, 1 << 23
    pool = np.sort(rng.choice(1 << 40, nb, replace=False))
    probe = np.where(rng.random(n) < 0.8, pool[rng.integers(0, nb, n)],
                     rng.integers(0, 1 << 40, n))
    ok = rng.random(n) > 0.05
    if skewed:
        pool = np.concatenate([np.arange(nb - 1, dtype=np.int64),
                               [1 << 62]])
    order = rng.permutation(nb).astype(np.int32)
    return (torch.from_numpy(pool).to(dev), torch.from_numpy(order).to(dev),
            torch.from_numpy(probe).to(dev), torch.from_numpy(ok).to(dev))


def _search_host_steps(sc, order, probe, ok, reps: int = 50) -> dict:
    """K11's host time a call in unique mode (mean µs, the card not
    waited for): the wrapper call, and for a checkout with the directory
    its steps (checks, the outputs' allocations, the directory's scratch,
    the ctypes call and its two launches, the output views)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import join as J
    out = {}
    if hasattr(J, "directory_params"):
        lib = ck.library("sorted_groups")
        steps = {}
        tick = _ticker(steps)
        torch.cuda.synchronize()
        for _ in range(reps):
            t = time.perf_counter()
            nb, P = J._search_args(sc, probe, ok)
            ck.require_cuda(order, what="sorted_search")
            t = tick("checks", t)
            dev = sc.device
            at_m = J._round16(4 * P)
            buf = torch.empty(at_m + P, dtype=torch.bool, device=dev)
            un = torch.empty((), dtype=torch.bool, device=dev)
            t = tick("outputs' allocations", t)
            k, scratch = J._dir_scratch(nb, dev)
            stream = ck.stream_ptr(dev)
            t = tick("directory scratch and stream", t)
            base = buf.data_ptr()
            rc = lib.tt_sorted_probe_unique(
                sc.data_ptr(), order.data_ptr(), nb, probe.data_ptr(),
                ok.data_ptr(), P, k, scratch.data_ptr(), base, base + at_m,
                un.data_ptr(), stream)
            ck.check(rc, "sorted_search")
            t = tick("ctypes call and two launches", t)
            (buf[:4 * P].view(torch.int32), buf[at_m:])
            tick("output views", t)
        torch.cuda.synchronize()
        out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        J.sorted_search_unique(sc, order, probe, ok)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_search(reps: int, prof: bool, steps: bool, dev) -> dict:
    import torch
    from tidb_tpu_torch.ops import join as J
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {}
    for name, skewed in (("phase10", False), ("skewed", True)):
        sc, order, probe, ok = _search_inputs(dev, skewed)
        _same(f"K11 {name}", J.sorted_search_unique(sc, order, probe, ok),
              J.sorted_search_unique_plain(sc, order, probe, ok))
        _same(f"K11 {name} multi", J.sorted_search_multi(sc, probe, ok),
              J.sorted_search_multi_plain(sc, probe, ok))
        out[f"k11_{name}_ms"] = _median_ms(
            lambda: J.sorted_search_unique(sc, order, probe, ok), reps)
        out[f"k11_{name}_multi_ms"] = _median_ms(
            lambda: J.sorted_search_multi(sc, probe, ok), reps)
        out[f"k11_{name}_searchsorted_ms"] = _median_ms(
            lambda: torch.searchsorted(sc, probe), reps)
        if prof:
            out[f"kernels_k11_{name}"] = _profile(
                [lambda: J.sorted_search_unique(sc, order, probe, ok)])
            out[f"kernels_searchsorted_{name}"] = _profile(
                [lambda: torch.searchsorted(sc, probe)])
        if steps:
            out[f"k11_{name}_host_steps"] = _search_host_steps(
                sc, order, probe, ok)
        del sc, order, probe, ok
    return out



def _k1_inputs(dev):
    """chip_smoke phase 5's K1 call (an int64 SUM of a Q1 slab into Q1's
    cap of 12, gids in [0, 12]: one value in 13 drops) and its f64 and
    bool variants on the same gids."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(11)
    data = torch.randint(0, 10 ** 7, (CAP,), generator=g,
                         dtype=torch.int64).to(dev)
    gids = torch.randint(0, 13, (CAP,), generator=g,
                         dtype=torch.int32).to(dev)
    f64 = torch.randn(CAP, generator=g, dtype=torch.float64).to(dev)
    mask = (torch.rand(CAP, generator=g) < 0.5).to(dev)
    return data, gids, f64, mask


def _k1_call(seg, op, data, gids, cap, out_dtype=None):
    """One K1 call through the checkout's wrapper (a checkout without
    bool input takes its own conversion first, as its callers did)."""
    import torch
    if data.dtype == torch.bool and not hasattr(seg, "segment_plan"):
        return seg.segment_reduce(op, data.to(out_dtype), gids, cap)
    if out_dtype is None:
        return seg.segment_reduce(op, data, gids, cap)
    return seg.segment_reduce(op, data, gids, cap, out_dtype)


def _segment_host_steps(data, gids, reps: int = 50) -> dict:
    """K1's host time a call (mean µs, the card not waited for): the
    wrapper call, and for a checkout with the cached plan its steps
    (checks, the plan lookup, the output, the scratch and its lock, the
    ctypes call and launch, the count)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import segment as seg
    out = {}
    cap, n = 12, data.shape[0]
    if hasattr(seg, "_SegPlan"):
        lib = ck.library("segment_reduce")
        steps = {}
        tick = _ticker(steps)
        torch.cuda.synchronize()
        for _ in range(reps):
            t = time.perf_counter()
            ck.require_cuda(data, gids, what="segment_reduce")
            dt = seg._out_dtype(data, None)
            codes = (seg._K1_IN[data.dtype], seg._K1_OUT[dt],
                     seg._K1_OPS["sum"])
            t = tick("checks", t)
            _p, _g, nbytes, block = seg.segment_plan(*codes, n, cap,
                                                     data.device.index)
            t = tick("cached plan", t)
            res = torch.empty(cap, dtype=dt, device=data.device)
            t = tick("output", t)
            stream = ck.stream_ptr(data.device)
            ent = ck.stream_scratch("segment_reduce", data.device, stream)
            with ent.lock:
                scratch = ent.ensure(nbytes, data.device, zeroed=True)
                t = tick("stream, scratch and lock", t)
                rc = lib.tt_segment_reduce(ctypes.byref(block),
                                           data.data_ptr(),
                                           gids.data_ptr(), res.data_ptr(),
                                           scratch, stream)
                t = tick("ctypes call and launch", t)
            ck.count("segment_reduce")
            ck.check(rc, "segment_reduce")
            tick("lock release, count and check", t)
        torch.cuda.synchronize()
        out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        seg.segment_reduce("sum", data, gids, cap)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_segment(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K1 at chip_smoke's shape (int64 SUM, n = 8,388,608, cap 12) beside
    index_add_, a cap of 1, an f64 SUM (and whether two calls give the
    same bits), a bool COUNT, the mid cap (1,024) with uniform gids and
    as the main path calls it (every row in one slot; ROLLUP's 31 slots)
    and the large cap (65,536); each held to its plain version first."""
    import torch
    from tidb_tpu_torch.ops import segment as seg
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    data, gids, f64, mask = _k1_inputs(dev)
    wide = torch.randint(0, 1 << 16, (CAP,), device=dev,
                         dtype=torch.int32)
    # the main path's mid-cap calls: a scalar aggregate's (Q6, E6, D4, S6:
    # every live row in slot 0 of the 1,024-slot hash capacity, the dead
    # rows dropped) and ROLLUP's (R2: 31 of 1,024 slots, one of them a
    # third of the rows)
    one_slot = torch.where(gids < 12, 0, -1).to(torch.int32)
    r = torch.randint(0, 45, (CAP,), device=dev, dtype=torch.int32)
    rollup = torch.where(r < 15, 0, r - 14).clamp(max=30).to(torch.int32)
    cases = {"k1": ("sum", data, gids, 12, None),
             "k1_cap1": ("sum", data, gids.clamp(max=1), 1, None),
             "k1_f64": ("sum", f64, gids, 12, None),
             "k1_bool_count": ("sum", mask, gids, 12, torch.int64),
             "k1_cap1024": ("sum", data, wide % 1025, 1024, None),
             "k1_cap1024_one_slot": ("sum", data, one_slot, 1024, None),
             "k1_cap1024_one_slot_bool": ("sum", mask, one_slot, 1024,
                                          torch.int64),
             "k1_cap1024_rollup": ("sum", data, rollup, 1024, None),
             "k1_cap65536": ("sum", data, wide, 65536, None)}
    out = {}
    for name, (op, d, g, cap, odt) in cases.items():
        got = _k1_call(seg, op, d, g, cap, odt)
        want = seg.segment_reduce_plain(op, d.to(odt) if odt else d, g, cap)
        if d.dtype == torch.float64:
            err = float((got - want).abs().max())
            out[f"{name}_max_abs_err"] = err
        elif not torch.equal(got, want):
            raise AssertionError(f"K1 {name}: kernel != plain version")
        out[f"{name}_ms"] = _median_ms(
            lambda: _k1_call(seg, op, d, g, cap, odt), reps)
    a = _k1_call(seg, "sum", f64, gids, 12)
    b = _k1_call(seg, "sum", f64, gids, 12)
    out["k1_f64_bit_equal"] = bool(torch.equal(a.view(torch.int64),
                                               b.view(torch.int64)))
    idx = gids.to(torch.int64)
    acc = torch.zeros(13, dtype=torch.int64, device=dev)
    out["k1_index_add_ms"] = _median_ms(
        lambda: acc.zero_().index_add_(0, idx, data), reps)
    out["k1_plain_ms"] = _median_ms(
        lambda: seg.segment_reduce_plain("sum", data, gids, 12), 5)
    if hasattr(seg, "segment_plan"):
        out["k1_plan"] = list(seg.segment_plan(0, 0, 0, CAP, 12,
                                               dev.index or 0)[:3])
    if prof:
        out["kernels_k1"] = _profile(
            [lambda: seg.segment_reduce("sum", data, gids, 12)])
        out["kernels_k1_bool_count"] = _profile(
            [lambda: _k1_call(seg, "sum", mask, gids, 12, torch.int64)])
        out["kernels_index_add"] = _profile(
            [lambda: acc.zero_().index_add_(0, idx, data)])
    if steps:
        out["k1_host_steps"] = _segment_host_steps(data, gids)
    return out


def _bounds_call(W, perm, live, keys, n_part, n_live=None):
    """K12 of one checkout as the window emit calls it: `window_bounds`
    (with sort_perm's n_live), or flags then positions."""
    if hasattr(W, "window_bounds"):
        return W.window_bounds(perm, live, keys, n_part, n_live)
    ps, qs = W.window_flags(perm, live, keys, n_part)
    return ps, qs, W.window_positions(ps, qs)


def _bounds_host_steps(perm, live, keys, n_part, n_live,
                       reps: int = 50) -> dict:
    """K12's host time a call (mean µs, the card not waited for): the
    wrapper call, and for a checkout with window_bounds' flags launch its
    steps (the checks and key columns, the flags' output, the ctypes
    arrays and the flags launch, the positions' outputs, the scratch and
    the ctypes call with its memset and two launches)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import window as W
    out = {}
    lib = ck.library("window_scan")
    if hasattr(lib, "tt_window_bounds_flags"):
        steps = {}
        tick = _ticker(steps)
        n = perm.shape[0]
        dev = perm.device
        torch.cuda.synchronize()
        for _ in range(reps):
            t = time.perf_counter()
            cols = W._flag_cols("window_bounds", perm, live, keys, n)
            t = tick("checks and key columns", t)
            a = -(-n // 16) * 16
            flags = torch.empty(2 * a, dtype=torch.bool, device=dev)
            ps, qs = flags[:n], flags[a:a + n]
            t = tick("flags' output", t)
            P = ctypes.c_void_p * W._FLAG_KEYS
            stream = ck.stream_ptr(dev)
            rc = lib.tt_window_bounds_flags(
                perm.data_ptr(), int(perm.dtype == torch.int64),
                W._ptr(live), W._ptr(n_live),
                P(*[v.data_ptr() for v, _m in cols]),
                P(*[W._ptr(m) for _v, m in cols]),
                (ctypes.c_int * W._FLAG_KEYS)(*[W._KDT[v.dtype]
                                                for v, _m in cols]),
                len(cols), min(n_part, len(cols)), n, 0, ps.data_ptr(),
                qs.data_ptr(), stream)
            ck.check(rc, "window_bounds")
            t = tick("ctypes arrays and the flags launch", t)
            pos = W.Positions(*torch.empty((5, n), dtype=torch.int64,
                                           device=dev).unbind(0))
            t = tick("positions' outputs", t)
            with W._scan_scratch(n, dev, stream, 2) as scratch:
                t = tick("scratch and lock", t)
                rc = lib.tt_window_positions(
                    ps.data_ptr(), qs.data_ptr(), n, pos.ppos.data_ptr(),
                    pos.plast.data_ptr(), pos.peer_lo.data_ptr(),
                    pos.peer_hi.data_ptr(), pos.dense.data_ptr(), scratch,
                    stream)
                t = tick("ctypes call, memset and two launches", t)
            ck.check(rc, "window_bounds")
            tick("lock release and check", t)
            del pos, flags
        torch.cuda.synchronize()
        out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        _bounds_call(W, perm, live, keys, n_part, n_live)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_bounds(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K12 over phase 12's W1 layout (l_shipdate >= 1998-08-01 live; one
    partition key, two order keys, all-true masks) and W2's (two
    dictionary-code partition keys, two order keys), as the window emit
    calls it (with sort_perm's n_live), each held to its plain version
    first."""
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    li = _lineitem_columns(dev)
    rows = torch.arange(CAP, device=dev) < N_ROWS
    ones = torch.ones(CAP, dtype=torch.bool, device=dev)
    live1 = rows & (li["ship"] >= 10439)
    k1 = [(li["okey"], ones), (li["ship"], ones), (li["price"], ones)]
    perm1, nl1 = F.sort_perm(k1, [False] * 3, live1)
    k2 = [(li["rflag"], ones), (li["lstatus"], ones), (li["price"], ones),
          (li["okey"], ones)]
    perm2, nl2 = F.sort_perm(k2, [False, False, True, False], rows)
    out = {}
    for tag, perm, live, keys, n_part, nl in (
            ("w1", perm1, live1, k1, 1, nl1), ("w2", perm2, rows, k2, 2, nl2)):
        got = _bounds_call(W, perm, live, keys, n_part, nl)
        want = W.window_positions_plain(
            *W.window_flags_plain(perm, live, keys, n_part))
        _same(f"K12 {tag} flags", got[:2],
              W.window_flags_plain(perm, live, keys, n_part))
        _same(f"K12 {tag} positions", tuple(got[2]), tuple(want))
        out[f"k12_{tag}_ms"] = _median_ms(
            lambda: _bounds_call(W, perm, live, keys, n_part, nl), reps)
        out[f"k12_{tag}_flags_ms"] = _median_ms(
            lambda: W.window_flags(perm, live, keys, n_part), reps)
        if prof:
            out[f"kernels_k12_{tag}"] = _profile(
                [lambda: _bounds_call(W, perm, live, keys, n_part, nl)])
        if steps:
            out[f"k12_{tag}_host_steps"] = _bounds_host_steps(
                perm, live, keys, n_part, nl)
    return out


EXPAND_DAY = 8096          # chip_smoke's expand statement: '1992-03-01'


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _expand_inputs(dev):
    """Phase 8's K7 call: the orders build keyed on o_custkey and filtered
    on o_orderdate < EXPAND_DAY (K4, K6), probed by every customer row
    (K5 in multi mode), with the generator chip_smoke and bench.py share
    → (start, count, order, out_cap, live)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import join as J
    rng = np.random.default_rng(7)
    n_orders, n_cust = N_ROWS // 4, N_ROWS // 40
    rng.integers(0, n_orders, N_ROWS)                       # l_orderkey
    odate = rng.integers(8036, 10590, n_orders).astype(np.int32)
    rng.integers(0, 5, n_orders)                            # priority
    ocust = rng.integers(0, n_cust, n_orders).astype(np.int64)

    def padded(a, cap, dtype=torch.int64):
        t = torch.zeros(cap, dtype=dtype)
        t[:len(a)] = torch.from_numpy(np.asarray(a))
        return t.to(dev)

    nb = _pow2(n_orders)
    ekeys = [(padded(ocust, nb), torch.arange(nb, device=dev) < n_orders)]
    elive = padded(odate < EXPAND_DAY, nb, torch.bool)
    bounds = [(0, n_cust - 1)]
    cnt, _, _, codes = J.lut_build(ekeys, bounds, n_cust, live=elive,
                                   want_lut=False, want_codes=True)
    starts, order = J.lut_order(codes, cnt)
    P = _pow2(n_cust)
    clive = torch.arange(P, device=dev) < n_cust
    ckeys = [(padded(np.arange(n_cust), P), clive)]
    start, count = J.lut_probe(ckeys, bounds, cnt, starts, clive, nb, False)
    return start, count, order, _pow2(int(count.sum())), clive


def _skewed_expand_inputs(dev):
    """P = 2^22 probe rows, one of them (row 1,000) with 2^20 matches and
    the others 0-2 (a fifth of them live), over an identity order."""
    import torch
    g = torch.Generator().manual_seed(17)
    P, hot = 1 << 22, 1 << 20
    count = torch.randint(0, 3, (P,), generator=g, dtype=torch.int32)
    live = torch.rand(P, generator=g) < 0.2
    count[1000] = hot
    live[1000] = True
    nb = hot + 4
    start = torch.randint(0, 4, (P,), generator=g, dtype=torch.int32)
    start[1000] = 0
    order = torch.arange(nb, dtype=torch.int32)
    total = int(torch.where(live, count, 0).sum())
    return (start.to(dev), count.to(dev), order.to(dev), _pow2(total),
            live.to(dev))


def _expand_same(J, args):
    start, count, order, out_cap, live = args
    got = J.expand(start, count, order, out_cap, False, live)
    want = J.expand_plain(start, count, order, out_cap, False, live)
    lv = want[3]
    _same("K7 total and live", (got[5], got[3]), (want[5], lv))
    _same("K7 live slots", tuple(a[lv] for a in got[:3] + got[4:5]),
          tuple(b[lv] for b in want[:3] + want[4:5]))


def _expand_host_steps(args, reps: int = 50) -> dict:
    """K7's host time a call, step by step (mean µs, the card not waited
    for), over the checkout's own wrapper: one allocation carved into
    views and one launch (`expand_layout`), or eight allocations and
    five launches."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import join as J
    start, count, order, out_cap, live = args
    lib = ck.library("join_expand")
    dev = count.device
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        ck.require_cuda(start, count, order, live, what="join_expand")
        P, nb = count.shape[0], order.shape[0]
        t = tick("checks", t)
        if hasattr(J, "expand_layout"):
            buf = torch.empty(J.expand_layout(out_cap), dtype=torch.int32,
                              device=dev)
            t = tick("allocation", t)
            base = buf.data_ptr()
            stream = ck.stream_ptr(dev)
            need = J.expand_scratch_bytes(P, out_cap)
            ent = ck.stream_scratch("join_expand", dev, stream)
            with ent.lock:
                sc = ent.ensure(need, dev)
                t = tick("stream, scratch and lock", t)
                rc = lib.tt_join_expand(
                    start.data_ptr(), count.data_ptr(), order.data_ptr(),
                    live.data_ptr(), P, nb, 0, out_cap, base + 8,
                    base + 8 + 4 * out_cap, base + 8 + 8 * out_cap,
                    base + 8 + 12 * out_cap, base + 8 + 13 * out_cap, base,
                    sc, need, stream)
                t = tick("ctypes call, memset and launch", t)
            # the same ctypes call refused at once (P < 0): its own cost
            lib.tt_join_expand(
                start.data_ptr(), count.data_ptr(), order.data_ptr(),
                live.data_ptr(), -1, nb, 0, out_cap, base + 8,
                base + 8 + 4 * out_cap, base + 8 + 8 * out_cap,
                base + 8 + 12 * out_cap, base + 8 + 13 * out_cap, base, sc,
                need, stream)
            t = tick("a refused ctypes call (no memset, no launch)", t)
            tt, p_idx, b_idx, k, flags = buf.split_with_sizes(
                (2, out_cap, out_cap, out_cap, buf.shape[0] - 2 - 3 * out_cap))
            flags = flags.view(torch.bool)
            matched, out_live = flags[:out_cap], flags[out_cap:2 * out_cap]
            total = tt.view(torch.int64).view(())
            t = tick("views (while the kernel runs)", t)
            del total, p_idx, b_idx, k, matched, out_live
        else:
            cum = torch.empty(P, dtype=torch.int64, device=dev)
            block = torch.empty(max(1, -(-P // 1024)), dtype=torch.int64,
                                device=dev)
            outs = [torch.empty(out_cap, dtype=dt, device=dev)
                    for dt in (torch.int32,) * 3 + (torch.bool,) * 2]
            total = torch.empty((), dtype=torch.int64, device=dev)
            t = tick("allocation", t)
            stream = ck.stream_ptr(dev)
            t = tick("stream", t)
            rc = lib.tt_join_expand(
                start.data_ptr(), count.data_ptr(), order.data_ptr(),
                live.data_ptr(), P, nb, 0, out_cap, cum.data_ptr(),
                block.data_ptr(), *[o.data_ptr() for o in outs],
                total.data_ptr(), stream)
            t = tick("ctypes call and five launches", t)
        ck.check(rc, "join_expand")
        tick("check", t)
    torch.cuda.synchronize()
    out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        J.expand(start, count, order, out_cap, False, live)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_expand(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K7 at phase 8's expand probe and at the skewed shape, each beside
    torch.repeat_interleave of the probe rows by their counts, each held
    to its plain version first (live slots and the total)."""
    import torch
    from tidb_tpu_torch.ops import join as J
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {}
    for tag, args in (("k7", _expand_inputs(dev)),
                      ("k7_skew", _skewed_expand_inputs(dev))):
        start, count, order, out_cap, live = args
        _expand_same(J, args)
        total = int(torch.where(live, count, 0).sum())
        rows = torch.arange(count.shape[0], device=dev)
        cl = torch.where(live, count, torch.zeros_like(count))
        out[f"{tag}_shape"] = [count.shape[0], total, out_cap]
        out[f"{tag}_ms"] = _median_ms(
            lambda: J.expand(start, count, order, out_cap, False, live),
            reps)
        out[f"{tag}_repeat_interleave_ms"] = _median_ms(
            lambda: torch.repeat_interleave(rows, cl, output_size=total),
            reps)
        if prof:
            out[f"kernels_{tag}"] = _profile(
                [lambda: J.expand(start, count, order, out_cap, False,
                                  live)])
        if steps and tag == "k7":
            out["k7_host_steps"] = _expand_host_steps(args)
    return out


def _q1_slabs(dev):
    """Q1's seven packed column slabs of one 8,388,608-row slab, as phase
    5 decodes them: chip_smoke's make_lineitem columns (the same seed and
    distributions, sorted by l_shipdate) under the layouts the device
    cache picks for them (l_returnflag and l_linestatus as their
    dictionary codes), padded with NULLs → [(layout, slab)]; and a dict
    column (3,000 int64 values at width 16) as the eighth item."""
    import numpy as np
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.executor.device_cache import _upload
    rng = np.random.default_rng(42)
    n = N_ROWS
    cols = [rng.integers(100, 5001, n), rng.integers(90_000, 10_500_001, n),
            rng.integers(0, 11, n), rng.integers(0, 9, n)]
    cols = [c.astype(np.int64) for c in cols]
    cols += [rng.integers(0, 3, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32)]
    ship = rng.integers(8036, 10590, n).astype(np.int32)
    order = np.argsort(ship)
    cols = [c[order] for c in cols] + [ship[order]]
    mask = np.zeros(CAP, dtype=bool)
    mask[:n] = True
    out = []
    for c in cols:
        lay, _ = C.choose_layout(c, mask[:n], allow_dict=False)
        vals = np.zeros(CAP, dtype=c.dtype)
        vals[:n] = c
        out.append((lay, tuple(_upload(a, dev) for a in
                               C.pack_slab(lay, vals, mask))))
    dv = np.unique(rng.integers(-10 ** 12, 10 ** 12, 3000))
    vals = np.zeros(CAP, dtype=np.int64)
    vals[:n] = dv[rng.integers(0, len(dv), n)]
    lay = C.ColLayout("dict", 16, 0, "int64", len(dv))
    out.append((lay, tuple(_upload(a, dev) for a in
                           C.pack_slab(lay, vals, mask, dv) + (dv,))))
    return out


def _decode_call(C, items):
    """The checkout's decode of `items` in one call where it has one, else
    one call a column."""
    if hasattr(C, "decode_slabs_torch"):
        return C.decode_slabs_torch(items, CAP)
    return [C.decode_slab_torch(lay, s, CAP) for lay, s in items]


def _decode_host_steps(items, reps: int = 20) -> dict:
    """K2's host time over Q1's seven slabs, step by step (mean µs, the
    card not waited for): the cached plan, checks and outputs of every
    column and one ctypes call (`decode_plan`), or the checks, three
    allocations and a ctypes call of every column."""
    import ctypes
    import torch
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.ops import cuda_kernels as ck
    lib = ck.library("unpack_decode")
    dev = items[0][1][0].device
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    for _ in range(reps):
        t = time.perf_counter()
        stream = ck.stream_ptr(dev)
        if hasattr(C, "decode_plan"):
            ((blob, cols, need),) = C.decode_plan(
                tuple(lay for lay, _ in items), CAP)
            a = C._DecodeArgs.from_buffer_copy(blob)
            t = tick("cached plan and stream", t)
            outs = []
            for q, ((lay, slab), cp) in enumerate(zip(items, cols)):
                ck.require_cuda(slab[0], slab[1], what="unpack_decode")
                if cp.aux is not None:
                    a.aux[q] = slab[2].data_ptr()
                a.words[q] = slab[0].data_ptr()
                a.mask_words[q] = slab[1].data_ptr()
            t = tick("checks and input pointers", t)
            for q, cp in enumerate(cols):
                vals = torch.empty(CAP, dtype=cp.dtype, device=dev)
                mask = torch.empty(CAP, dtype=torch.bool, device=dev)
                a.vals[q] = vals.data_ptr()
                a.mask[q] = mask.data_ptr()
                outs.append((vals, mask))
            t = tick("allocation and output pointers", t)
            ent = ck.stream_scratch("unpack_decode", dev, stream)
            with ent.lock:
                sc = ent.ensure(need, dev) if need else None
                t = tick("scratch and lock", t)
                rc = lib.tt_unpack_decode(ctypes.addressof(a), sc, need,
                                          stream)
                t = tick("ctypes call, memset and launch", t)
            ck.check(rc, "unpack_decode")
            # the same ctypes call refused at once (too little scratch)
            lib.tt_unpack_decode(ctypes.addressof(a), sc, -1, stream)
            tick("a refused ctypes call (no memset, no launch)", t)
        else:
            t = tick("stream", t)
            outs = []
            for lay, slab in items:
                C.validate(lay)
                ck.require_cuda(slab[0], slab[1], what="unpack_decode")
                dt = torch.int64 if lay.dtype == "int64" else torch.int32
                n_words = -(-CAP // (32 // lay.width)) if lay.width else 0
                t = tick("checks", t)
                vals = torch.empty(CAP, dtype=dt, device=dev)
                mask = torch.empty(CAP, dtype=torch.bool, device=dev)
                nblk = -(-n_words // lib.tt_unpack_block_words())
                scratch = torch.empty(2 * nblk if lay.kind == "delta"
                                      else 0, dtype=torch.int64, device=dev)
                t = tick("allocation", t)
                aux = slab[2] if lay.kind in ("dict", "delta") else None
                rc = lib.tt_unpack_decode(
                    C._K2_KINDS[lay.kind], lay.width,
                    0 if dt == torch.int64 else 1, slab[0].data_ptr(),
                    n_words, slab[1].data_ptr(), CAP, lay.ref,
                    aux.data_ptr() if lay.kind == "dict" else None,
                    lay.card, aux.data_ptr() if lay.kind == "delta"
                    else None, vals.data_ptr(), mask.data_ptr(),
                    scratch.data_ptr(), stream)
                ck.check(rc, "unpack_decode")
                t = tick("ctypes calls and launches", t)
                outs.append((vals, mask))
        del outs
    torch.cuda.synchronize()
    out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        _decode_call(C, items)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_decode(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K2 over Q1's seven slabs (in one call where the checkout has one,
    and one call a column), each column alone, and a dict column, each
    held to its plain version first in every slot."""
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    slabs = _q1_slabs(dev)
    q1, dict_item = slabs[:7], slabs[7:]
    for (lay, s), got in zip(slabs, _decode_call(C, slabs)):
        _same(f"K2 {lay.sig()}", got, C.decode_slab_plain(lay, s, CAP))
    out = {"k2_layouts": [lay.sig() for lay, _ in slabs],
           "k2_q1_ms": _median_ms(lambda: _decode_call(C, q1), reps),
           "k2_q1_per_column_ms": _median_ms(
               lambda: [C.decode_slab_torch(lay, s, CAP) for lay, s in q1],
               reps),
           "k2_dict_ms": _median_ms(lambda: _decode_call(C, dict_item),
                                    reps)}
    for lay, s in q1:
        out[f"k2_{lay.kind}_w{lay.width}_{lay.dtype}_ms"] = _median_ms(
            lambda: C.decode_slab_torch(lay, s, CAP), reps)
    if prof:
        out["kernels_k2_q1"] = _profile([lambda: _decode_call(C, q1)])
    if steps:
        out["k2_host_steps"] = _decode_host_steps(q1)
    return out


LUT_MID = 16_384            # a 128 KB int64 table: above 48 KB, below 200


def _lut_cases(dev):
    """Phase 20's four K21 calls (n = 8,388,608 int32 codes: a 7-entry
    int64 and a 7-entry bool table, o_comment's 1,500,303-entry int64
    table over uniformly random codes, KeyRemap's fill mode over codes in
    [-1, 8)) and a LUT_MID-entry int64 table over random codes, made on
    the card from phase 20's seed → [(name, table, codes, mode)]."""
    import torch
    g = torch.Generator(device=dev).manual_seed(20)

    def table(n_lut, dtype):
        raw = torch.randint(0, 1 << 40, (n_lut,), device=dev, generator=g)
        return (raw & 1).bool() if dtype == torch.bool else raw.to(dtype)

    def codes(lo, hi):
        return torch.randint(lo, hi, (CAP,), device=dev, generator=g,
                             dtype=torch.int32)

    small, big, remap = codes(0, 7), codes(0, 1_500_303), codes(-1, 8)
    return [("7_int64", table(7, torch.int64), small, "clip"),
            ("7_bool", table(7, torch.bool), small, "clip"),
            ("1500303_int64", table(1_500_303, torch.int64), big, "clip"),
            ("7_int64_fill", table(7, torch.int64), remap, "fill"),
            (f"{LUT_MID}_int64", table(LUT_MID, torch.int64),
             codes(0, LUT_MID), "clip")]


def _lut_host_steps(table, codes, reps: int = 50) -> dict:
    """K21's host time a call over the checkout's own wrapper, step by
    step (mean µs, the card not waited for): the checks, the row plan,
    the allocation, the ctypes call and launch, the count and check (or
    the parent's import and require_cuda, checks, allocation, ctypes call
    and launch, count and check)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import dict_lut as DL
    dev = codes.device
    lib = ck.library("dict_lut")
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    n, n_lut = codes.shape[0], table.shape[0]
    for _ in range(reps):
        t = time.perf_counter()
        if hasattr(DL, "lut_plan"):
            fn = DL._KERNEL or DL._bind()
            if not (table.is_cuda and codes.is_cuda) or \
                    table.dim() != 1 or codes.dim() != 1 or \
                    table.dtype not in DL._LUT_DTYPES or \
                    codes.dtype not in DL._CODE_DTYPES or \
                    not (table.is_contiguous() and codes.is_contiguous()):
                raise AssertionError("K21 inputs")
            lb = table.element_size()
            cp = codes.data_ptr()
            t = tick("checks and pointers", t)
            plan = DL.lut_plan(cp & 15, codes.element_size(), lb, n, 0)
            t = tick("cached row plan", t)
            out = torch.empty(n + plan.pad, dtype=table.dtype, device=dev)
            t = tick("allocation", t)
            rc = fn(cp, table.data_ptr(), n_lut, -1,
                    out.data_ptr() + plan.pad * lb, n, plan.flags,
                    ck.stream_ptr(dev))
            t = tick("stream, ctypes call and launch", t)
        else:
            ck.require_cuda(table, codes, what="dict_lut")
            if table.dim() != 1 or codes.dim() != 1:
                raise AssertionError("K21 inputs")
            t = tick("checks and pointers", t)
            out = torch.empty(n, dtype=table.dtype, device=dev)
            t = tick("allocation", t)
            rc = lib.tt_dict_lut(
                codes.data_ptr(), codes.element_size(), table.data_ptr(),
                table.element_size(), n_lut, 0, -1, out.data_ptr(), n,
                ck.stream_ptr(dev))
            t = tick("stream, ctypes call and launch", t)
        ck.count("dict_lut")
        ck.check(rc, "dict_lut")
        tick("count and check", t)
    torch.cuda.synchronize()
    out = _mean_us(steps, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        DL.dict_lut(table, codes)
    out["wrapper call"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def run_lut(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K21 over phase 20's four cases and a table between 48 KB and 200
    KB, each held exactly to its plain version, timed beside torch.take
    of the clamped (int64) codes and, with `prof`, profiled alone
    (`kernels_k21_<case>`: the two L2-gathered tables of a checkout that
    stages neither share one kernel); the 1,500,303-entry table's
    random-load floor at 87-100 G loads a second (PERF.md §6-§7)."""
    import torch
    from tidb_tpu_torch.ops import dict_lut as DL
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {"k21_smem_bytes": getattr(DL, "SMEM_BYTES", None)}
    for name, tab, codes, mode in _lut_cases(dev):
        _same(f"K21 {name}", DL.dict_lut(tab, codes, mode, -1),
              DL.dict_lut_plain(tab, codes, mode, -1))
        clamped = torch.clamp(codes, 0, tab.shape[0] - 1).long()
        out[f"k21_{name}_ms"] = _median_ms(
            lambda: DL.dict_lut(tab, codes, mode, -1), reps)
        out[f"k21_{name}_take_ms"] = _median_ms(
            lambda: torch.take(tab, clamped), reps)
        if prof:
            out[f"kernels_k21_{name}"] = _profile(
                [lambda: DL.dict_lut(tab, codes, mode, -1)])
        if name == "1500303_int64":
            out["k21_random_load_floor_ms"] = [CAP / 100e9 * 1e3,
                                               CAP / 87e9 * 1e3]
        if steps and name == "7_bool":
            out["k21_host_steps"] = _lut_host_steps(tab, codes)
    out["k21_four_ms"] = sum(out[f"k21_{k}_ms"] for k in (
        "7_int64", "7_bool", "1500303_int64", "7_int64_fill"))
    out["k21_four_take_ms"] = sum(out[f"k21_{k}_take_ms"] for k in (
        "7_int64", "7_bool", "1500303_int64", "7_int64_fill"))
    return out


def _pair_inputs(dev):
    """Phase 14's K16 call: D1's COUNT(DISTINCT l_orderkey) over
    (l_returnflag, l_linestatus) groups in one 8,388,608-row slab of
    chip_smoke's lineitem (its generator and seeds): group ids 0-5 (6 for
    the padding rows), every row's pair live where the row is, and the
    value ranks of l_orderkey (`_dense1`) → (gids, vid, pair_live)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import factorize as F
    n = N_ROWS
    rng = np.random.default_rng(42)
    for lo, hi in ((100, 5001), (90_000, 10_500_001), (0, 11), (0, 9)):
        rng.integers(lo, hi, n)
    rflag = rng.integers(0, 3, n)
    lstatus = rng.integers(0, 2, n)
    order = np.argsort(rng.integers(8036, 10590, n).astype(np.int32))
    okey = np.random.default_rng(7).integers(0, n // 4, n).astype(np.int64)
    gids = np.full(CAP, 6, dtype=np.int32)
    gids[:n] = (rflag[order] * 2 + lstatus[order]).astype(np.int32)
    key = np.zeros(CAP, dtype=np.int64)
    key[:n] = okey
    live = torch.arange(CAP, device=dev) < n
    vid = F._dense1(torch.from_numpy(key).to(dev), None, live)
    return torch.from_numpy(gids).to(dev), vid, live


def _pair_call(F, gids, vid, pl, want_pg=True):
    """The checkout's pair factorize after the value ranks → (first, pg,
    n_pairs, rep): K16's word, K8 and K10 with the first mask where the
    checkout has `pair_factorize`, else K16's code, K9 + K8 + K10 and K16's
    first mask."""
    if hasattr(F, "pair_factorize"):
        return F.pair_factorize(gids, vid, pl, CAP, 6, want_pg)
    code = F.pair_code(gids, vid, 6)
    pg, k, rep = F.factorize([(code, None)], pl, CAP, hi=7 * (CAP + 1))
    return F.first_mask(rep, pg), pg, k, rep


def _launches(fn) -> dict:
    from tidb_tpu_torch.ops import cuda_kernels as ck
    before = ck.launches()
    fn()
    after = ck.launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def run_pairs(reps: int, prof: bool, steps: bool, dev) -> dict:
    """The DISTINCT pair factorize at phase 14's shape (D1's slab):
    after the value ranks, from (gids, vid, pair_live) to (first, pg,
    n_pairs, rep), with its counted launches; K16's entries alone; K10's
    word entry over the pair sort's word with and without the first mask
    (and, where the checkout has it, with the mask and without the ids).
    Each checkout's
    result is held exactly to its own run on CPU copies (first, pg,
    n_pairs, rep[:n_pairs])."""
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    gids, vid, pl = _pair_inputs(dev)
    got = _pair_call(F, gids, vid, pl)
    want = _pair_call(F, gids.cpu(), vid.cpu(), pl.cpu())
    k = int(want[2])
    _same("pair factorize first, pg", (got[0].cpu(), got[1].cpu()),
          (want[0], want[1]))
    _same("pair factorize n_pairs, rep", (got[2].cpu(), got[3].cpu()[:k]),
          (want[2], want[3][:k]))
    out = {"pairs_n_pairs": k,
           "pairs_ms": _median_ms(lambda: _pair_call(F, gids, vid, pl),
                                  reps),
           "pairs_launches": _launches(lambda: _pair_call(F, gids, vid,
                                                          pl))}
    calls = {"pairs": lambda: _pair_call(F, gids, vid, pl)}
    if hasattr(F, "pair_factorize"):
        out["pairs_no_pg_ms"] = _median_ms(
            lambda: _pair_call(F, gids, vid, pl, False), reps)
        out["k16_pair_word_ms"] = _median_ms(
            lambda: F.pair_word(gids, vid, pl, 6), reps)
        calls["k16"] = lambda: F.pair_word(gids, vid, pl, 6)
        sidx, words = F.pair_sort(gids, vid, pl, 6)
    else:
        code = F.pair_code(gids, vid, 6)
        pg, _k, rep = F.factorize([(code, None)], pl, CAP,
                                  hi=7 * (CAP + 1))
        out["k16_pair_code_ms"] = _median_ms(
            lambda: F.pair_code(gids, vid, 6), reps)
        out["k16_first_mask_ms"] = _median_ms(
            lambda: F.first_mask(rep, pg), reps)
        calls["k16"] = lambda: (F.pair_code(gids, vid, 6),
                                F.first_mask(rep, pg))
        sidx, words = F._lexsort_kernel(
            [F.SortOp(pl, desc=True), F.SortOp(code, hi=7 * (CAP + 1))])
    key = F._word_key(words)
    k10 = lambda: F.group_ids_words(words.last, sidx, *key, CAP)  # noqa
    out["k10_words_ms"] = _median_ms(k10, reps)
    calls["k10"] = k10
    if hasattr(F, "pair_factorize"):
        k10f = lambda: F.group_ids_words(  # noqa: E731
            words.last, sidx, *key, CAP, first=True)
        k10n = lambda: F.group_ids_words(  # noqa: E731
            words.last, sidx, *key, CAP, first=True, want_gids=False)
        base = F.group_ids_words(words.last, sidx, *key, CAP)
        with_first = k10f()
        _same("K10 with first", with_first[:3], base)
        _same("K10 first", with_first[3],
              F.first_mask_plain(base[2], base[0]))
        out["k10_words_first_ms"] = _median_ms(k10f, reps)
        out["k10_words_first_no_gids_ms"] = _median_ms(k10n, reps)
        calls["k10_first"] = k10f
        calls["k10_first_no_gids"] = k10n
    if prof:
        for name, fn in calls.items():
            out[f"kernels_{name}"] = _profile([fn])
    if steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            _pair_call(F, gids, vid, pl)
        out["pairs_host_us"] = (time.perf_counter() - t0) * 1e6 / 20
        torch.cuda.synchronize()
    return out


DAY_US = 86_400_000_000
#: csrc/civil_date.cu's 32-bit range starts at LO = -Z0
K20_LO = -(719468 + 146097 * 800)


def _civil_cases(dev):
    """Phase 18's five K20 calls (n = 8,388,608: year, week and last_day
    over int32 DATE days in lineitem's shipdate range, hour over µs at
    random times of day, date_add_months +3 over the days; its seed) and
    `year` over a DATE column below the 32-bit path's range (every warp
    on the 64-bit path) → [(name, kernel call, plain call)]."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import calendar as CAL
    rng = np.random.default_rng(18)
    days = torch.from_numpy(rng.integers(8036, 10590, CAP).astype(
        np.int32)).to(dev)
    us = days.long() * DAY_US + torch.from_numpy(
        rng.integers(0, DAY_US, CAP)).to(dev)
    low = torch.from_numpy(rng.integers(np.iinfo(np.int32).min, K20_LO,
                                        CAP).astype(np.int32)).to(dev)
    cases = [(part, v, mc) for part, v, mc in (
        ("year", days, False), ("week", days, False),
        ("last_day", days, False), ("hour", us, True),
        ("year_out_of_range", low, False))]
    out = [(name, (lambda v=v, p=name.split("_out")[0], mc=mc:
                   CAL.civil_part(v, p, mc)),
            (lambda v=v, p=name.split("_out")[0], mc=mc:
             CAL.civil_part_plain(v, p, mc))) for name, v, mc in cases]
    out.insert(4, ("date_add_months",
                   lambda: CAL.date_add_months(days, False, 3, 1),
                   lambda: CAL.date_add_months_plain(days, False, 3, 1)))
    return out


def run_civil(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K20 over phase 18's five calls and a DATE column out of the 32-bit
    range, each held exactly to its plain version, timed, with `prof`
    profiled alone (`kernels_k20_<case>`), with `steps` its host time a
    call (the wrapper, the card not waited for)."""
    import torch
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {}
    five = 0.0
    for name, kern, plain in _civil_cases(dev):
        _same(f"K20 {name}", kern(), plain())
        out[f"k20_{name}_ms"] = _median_ms(kern, reps)
        if name != "year_out_of_range":
            five += out[f"k20_{name}_ms"]
        if prof:
            out[f"kernels_k20_{name}"] = _profile([kern])
        if steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                kern()
            out[f"k20_{name}_host_us"] = (time.perf_counter() - t0) * 1e6 / 50
            torch.cuda.synchronize()
    out["k20_five_ms"] = five
    return out


def _frame_cases(dev):
    """K14 at phase 12's W3 shape (l_shipdate within (l_returnflag,
    l_linestatus), RANGE BETWEEN 6 PRECEDING AND CURRENT ROW, one
    8,388,608-row slab), with and without `sorted_key` where the
    checkout has it, and the same layout ordered by an int64 key
    (l_extendedprice, RANGE 100000 PRECEDING) and a float64 one
    (l_extendedprice / 100, RANGE 1000.5 PRECEDING) → [(name, kernel
    call, plain call)]."""
    import inspect
    import torch
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    li = _lineitem_columns(dev)
    rows = torch.arange(CAP, device=dev) < N_ROWS
    ones = torch.ones(CAP, dtype=torch.bool, device=dev)
    out = []
    has_sorted = "sorted_key" in inspect.signature(W.frame_bounds).parameters
    for name, key, pre in (("w3", li["ship"], 6),
                           ("int64", li["price"], 100_000),
                           ("float64", li["price"].double() / 100, 1000.5)):
        k = [(li["rflag"], ones), (li["lstatus"], ones), (key, ones)]
        perm, _ = F.sort_perm(k, [False] * 3, rows)
        pos = W.window_positions(*W.window_flags(perm, rows, k, 2))
        rk = (key[perm], rows[perm], False)
        calls = [(name, (lambda pos=pos, rk=rk, pre=pre:
                         W.frame_bounds(pos, pre, 0, rk)))]
        if has_sorted:
            calls.insert(0, (f"{name}_sorted", (
                lambda pos=pos, rk=rk, pre=pre:
                W.frame_bounds(pos, pre, 0, rk, sorted_key=True))))
        for tag, fn in calls:
            out.append((tag, fn, (lambda pos=pos, rk=rk, pre=pre:
                                  W.frame_bounds_plain(pos, pre, 0, rk))))
    return out


def run_frame(reps: int, prof: bool, steps: bool, dev) -> dict:
    """K14 at W3's shape with and without `sorted_key` and over an int64
    and a float64 RANGE key, each held exactly to its plain version,
    timed, with `prof` profiled alone (`kernels_k14_<case>`), with
    `steps` its host time a call."""
    import torch
    from tidb_tpu_torch.tools.sort_timing import _median_ms, _profile
    out = {}
    for name, kern, plain in _frame_cases(dev):
        _same(f"K14 {name}", kern(), plain())
        out[f"k14_{name}_ms"] = _median_ms(kern, reps)
        if prof:
            out[f"kernels_k14_{name}"] = _profile([kern])
        if steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                kern()
            out[f"k14_{name}_host_us"] = (time.perf_counter() - t0) * 1e6 / 20
            torch.cuda.synchronize()
    return out


def _ptxas(tree: str, sources) -> dict:
    """{kernel: {registers, smem, stack, spill_stores}} of the kernels of
    `sources` (csrc file names), from `nvcc -Xptxas -v` with the build's
    flags (mangled names, cut to 90 characters)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            res = subprocess.run(
                [ck.nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, src + ".so"),
                 os.path.join(tree, "tidb_tpu_torch", "csrc", src + ".cu")],
                capture_output=True, text=True, check=True)
            name = None
            for line in (res.stdout + res.stderr).splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    name = m.group(1)[:90]
                    continue
                if name is None:
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", line)
                if m:
                    out.setdefault(name, {}).update(
                        stack=int(m.group(1)), spill_stores=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    smem = re.search(r"(\d+) bytes smem", line)
                    out.setdefault(name, {}).update(
                        registers=int(m.group(1)),
                        smem=int(smem.group(1)) if smem else 0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels to time")
    ap.add_argument("--kernels", default="scan,gather",
                    help="comma-separated: scan (K12, K13), gather (K25), "
                         "build (K4), probe (K5), compact (K22), columns "
                         "(K18), search (K11), segment (K1), bounds (K12), "
                         "expand (K7), decode (K2), lut (K21), pairs "
                         "(K16 with K8 and K10), civil (K20), frame (K14)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="append the JSON line to this file too")
    ap.add_argument("--profile", action="store_true",
                    help="add each kernel's device time (torch.profiler)")
    ap.add_argument("--ptxas", action="store_true",
                    help="add the chosen kernels' registers, shared "
                         "memory and spills (nvcc -Xptxas -v)")
    ap.add_argument("--host-steps", action="store_true",
                    help="add the chosen wrappers' host time split step "
                         "by step")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_timing: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    kernels = set(args.kernels.split(","))
    sources = {"scan": "window_scan", "gather": "rank_gather",
               "build": "lut_join", "probe": "lut_join",
               "compact": "member_compact",
               "columns": "gather_columns", "search": "sorted_groups",
               "segment": "segment_reduce", "bounds": "window_scan",
               "expand": "join_expand", "decode": "unpack_decode",
               "lut": "dict_lut", "pairs": "distinct_pairs",
               "civil": "civil_date", "frame": "window_frame"}
    if not kernels <= set(sources):
        print(f"scan_timing: unknown kernels {args.kernels}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    line = {"tree": tree, "card": smi.splitlines()[0] if smi else None}
    if "scan" in kernels:
        line.update(run_scan(args.reps, args.profile, dev, args.host_steps))
    if "gather" in kernels:
        line.update(run_gather(args.reps, args.profile, args.host_steps,
                               dev))
    if "build" in kernels:
        line.update(run_build(args.reps, args.profile, args.host_steps, dev))
    if "probe" in kernels:
        line.update(run_probe(args.reps, args.profile, args.host_steps, dev))
    if "compact" in kernels:
        line.update(run_compact(args.reps, args.profile, args.host_steps,
                                dev))
    if "columns" in kernels:
        line.update(run_columns(args.reps, args.profile, args.host_steps,
                                dev))
    if "search" in kernels:
        line.update(run_search(args.reps, args.profile, args.host_steps,
                               dev))
    if "segment" in kernels:
        line.update(run_segment(args.reps, args.profile, args.host_steps,
                                dev))
    if "bounds" in kernels:
        line.update(run_bounds(args.reps, args.profile, args.host_steps,
                               dev))
    if "expand" in kernels:
        line.update(run_expand(args.reps, args.profile, args.host_steps,
                               dev))
    if "decode" in kernels:
        line.update(run_decode(args.reps, args.profile, args.host_steps,
                               dev))
    if "lut" in kernels:
        line.update(run_lut(args.reps, args.profile, args.host_steps, dev))
    if "pairs" in kernels:
        line.update(run_pairs(args.reps, args.profile, args.host_steps,
                              dev))
    if "civil" in kernels:
        line.update(run_civil(args.reps, args.profile, args.host_steps,
                              dev))
    if "frame" in kernels:
        line.update(run_frame(args.reps, args.profile, args.host_steps,
                              dev))
    if args.ptxas:
        srcs = {sources[k] for k in kernels}
        if "pairs" in kernels:
            srcs.add("sorted_groups")
        line["ptxas"] = _ptxas(tree, sorted(srcs))
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

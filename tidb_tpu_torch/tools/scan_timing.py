"""Time the window scans, the rank gather, the LUT probe, the member
compaction, the column gather, the sorted search, the segment reduction
and the window bounds of one checkout on the card, for comparing two
checkouts in one machine's run.

    python tidb_tpu_torch/tools/scan_timing.py --tree DIR [--out FILE]
        [--kernels scan,gather,probe,compact,columns,search,segment,bounds]
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
  * probe: K5 in unique mode, one lineitem slab (8,388,608 rows, 6,001,215
    live) of l_orderkey into K4's lut of the orders build (D =
    1,500,303), beside torch.take of the clamped codes;
  * compact: K22 at B = 16, cap = 8,388,608 over an M1-shaped mask (each
    member the rows of one l_orderkey, M1's keys) and a random half-live
    mask (seed 21), each beside torch.nonzero;
  * columns: K18 at phase 14's shape (D2's pair output: the two key
    codes with masks and l_orderkey of the 2,097,152-row lineitem slab
    with the most (group, l_orderkey) pairs, through rep[:pair_cap])
    beside five index_select;
  * search: K11 in unique mode at phase 10's shape (2,097,152 distinct
    sorted codes in [0, 2^40), 8,388,608 probes, 80% of them build codes)
    and on the skewed table (2,097,151 codes in [0, 2^21) and one at
    2^62) with the same probes, each beside torch.searchsorted;
  * segment: K1 at phase 5's shape (int64 SUM, 8,388,608 rows, cap 12)
    beside index_add_, and at cap 1, as an f64 SUM (with whether two
    calls give the same bits), a bool COUNT, caps 1,024 and 65,536;
  * bounds: K12 over phase 12's W1 and W2 layouts (`window_bounds`, or
    flags then positions in a checkout without it), and its flags
    entry alone.

Each kernel is held to its plain version first (exactly; the f64
prefix is not timed). Run two checkouts in turns (A, B, B, A), one
process each, within one run of the machine: cards and power limits
differ between runs. `--profile` adds each CUDA kernel's mean device
time over one call of each timed entry (torch.profiler), under
"kernels_<entry>"; `--ptxas` adds what `nvcc -Xptxas -v` reports for the
chosen kernels' sources (registers, shared memory, spills);
`--host-steps` adds each chosen wrapper's host time split step by step
(under "<kernel>_host_steps"): K25's (checks and contiguity, pointers,
tables, allocation, the ctypes call and launch), K13 prefix's, K5's,
K18's, K11's, K1's and K12's with the card not waited for, and K22's,
whose read-back of the total waits for its count pass.
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
    wrapper call, and for a checkout with the cached plan its steps
    (signature and plan lookup, the one allocation, the argument block's
    pointers, the ctypes call and launch, the output views made while the
    kernel runs)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import gather as G
    steps = {}
    tick = _ticker(steps)
    torch.cuda.synchronize()
    out = {}
    if hasattr(G, "_views"):
        lib = ck.library("gather_columns")
        m = idx.shape[0]
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


def run_columns(reps: int, prof: bool, steps: bool, dev) -> dict:
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
    if prof:
        out["kernels_k18"] = _profile(
            [lambda: G.gather_columns(cols, idx, pairs)])
        out["kernels_index_select"] = _profile([lib])
    if steps:
        out["k18_host_steps"] = _columns_host_steps(cols, idx, pairs)
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
                         "probe (K5), compact (K22), columns (K18), "
                         "search (K11), segment (K1), bounds (K12)")
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
               "probe": "lut_join", "compact": "member_compact",
               "columns": "gather_columns", "search": "sorted_groups",
               "segment": "segment_reduce", "bounds": "window_scan"}
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
    if args.ptxas:
        line["ptxas"] = _ptxas(tree, [sources[k] for k in sorted(kernels)])
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the window scans, the rank gather, the LUT probe and the member
compaction of one checkout on the card, for comparing two checkouts in
one machine's run.

    python tidb_tpu_torch/tools/scan_timing.py --tree DIR [--out FILE]
        [--kernels scan,gather,probe,compact] [--profile] [--ptxas]
        [--host-steps]

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
    mask (seed 21), each beside torch.nonzero.

Each kernel is held to its plain version first (exactly; the f64
prefix is not timed). Run two checkouts in turns (A, B, B, A), one
process each, within one run of the machine: cards and power limits
differ between runs. `--profile` adds each CUDA kernel's mean device
time over one call of each timed entry (torch.profiler), under
"kernels_<entry>"; `--ptxas` adds what `nvcc -Xptxas -v` reports for the
chosen kernels' sources (registers, shared memory, spills);
`--host-steps` adds each chosen wrapper's host time split step by step
(under "<kernel>_host_steps"): K25's (checks and contiguity, pointers,
tables, allocation, the ctypes call and launch), K13 prefix's and K5's
with the card not waited for, and K22's, whose read-back of the total
waits for its count pass.
"""

from __future__ import annotations

import argparse
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
        scratch = W._scan_scratch(n, v.device, stream)
        t = tick("scratch and stream", t)
        rc = lib.tt_window_prefix(vals.data_ptr(), 2, valid.data_ptr(), n,
                                  cum.data_ptr(), ccnt.data_ptr(), scratch,
                                  stream)
        ck.check(rc, "window_prefix")
        tick("ctypes call, memset and launch", t)
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
                         "probe (K5), compact (K22)")
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
               "probe": "lut_join", "compact": "member_compact"}
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

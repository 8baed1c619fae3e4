"""Window-function computation over sorted partitions.

Ref: executor/window.go:31 + executor/aggfuncs window functions. The
reference streams partition groups through per-function slide/accumulate
state machines; the TPU-first formulation is whole-column: ONE sort by
(partition, order) keys, then every window function is a composition of
cumulative/segment primitives over the sorted layout — no per-row state,
no Python loop. `xp` is numpy on the host engine; with a TorchXP every
function takes its torch branch (below), whose row-scale work runs in
four hand-written CUDA kernels for CUDA tensors (csrc/window_scan.cu,
csrc/window_frame.cu) and in their plain torch versions for CPU tensors:

  K12 `window_bounds` (and its two halves `window_flags` /
      `window_positions`)  boundary flags over the sorted keys; per-row
      partition and peer positions, dense-rank counts;
  K13 `window_prefix` / `window_segscan`  whole-column prefix of the
      masked value and the valid count; segmented min/max scans;
  K14 `frame_bounds`  ROWS and RANGE frame [lo, hi] per row;
  K15 `frame_rank` / `frame_agg` / `frame_gather` / `frame_minmax`  the
      rank family, COUNT/SUM/AVG by prefix differences, FIRST/LAST/
      NTH_VALUE and LAG/LEAD, bounded MIN/MAX.

A wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises. Positions are int64 (the reference's
dtype) on both.

All helpers take the SORTED layout:
  pstart (n,) bool — True at the first row of each partition;
  peerstart (n,) bool — True at the first row of each peer group (rows
  equal on partition + order keys); pstart ⊆ peerstart.
Results are aligned to the sorted layout; callers scatter back through
the sort permutation.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tidb_tpu_torch.ops import cuda_kernels as _cuda_kernels


def _iota(xp, n):
    return xp.arange(n, dtype=xp.int64)


def _cummax(xp, a):
    return np.maximum.accumulate(a)


def _pstart_pos(xp, pstart):
    """Index of the owning partition's first row, per row."""
    if xp is not np:
        return window_positions(pstart, pstart).ppos
    n = pstart.shape[0]
    return _cummax(xp, xp.where(pstart, _iota(xp, n), xp.int64(0)))


def row_number(xp, pstart):
    if xp is not np:
        return frame_rank("row_number", window_positions(pstart, pstart))
    n = pstart.shape[0]
    return _iota(xp, n) - _pstart_pos(xp, pstart) + 1


def rank(xp, pstart, peerstart):
    if xp is not np:
        return frame_rank("rank", window_positions(pstart, peerstart))
    n = pstart.shape[0]
    peer_pos = _cummax(xp, xp.where(peerstart, _iota(xp, n), xp.int64(0)))
    return peer_pos - _pstart_pos(xp, pstart) + 1


def dense_rank(xp, pstart, peerstart):
    if xp is not np:
        return frame_rank("dense_rank", window_positions(pstart, peerstart))
    cp = xp.cumsum(peerstart.astype(xp.int64))
    pp = _pstart_pos(xp, pstart)
    cp_at_pstart = xp.take(cp, pp)
    return cp - cp_at_pstart + 1


def partition_ids(xp, pstart):
    if xp is not np:
        return window_prefix(None, pstart)[1] - 1
    return xp.cumsum(pstart.astype(xp.int64)) - 1


def full_frame_agg(xp, name, vals, valid, pstart, num_partitions: int):
    """Whole-partition aggregate broadcast back to every row
    (OVER (PARTITION BY …) without ORDER BY)."""
    if xp is not np:
        return _compute_torch(name, vals, valid, pstart, pstart, False)
    from tidb_tpu_torch.ops import segment as seg
    pid = partition_ids(xp, pstart)
    if name == "count":
        per = seg.segment_count(xp, valid, pid, num_partitions)
        return xp.take(per, pid), xp.ones_like(valid)
    z = xp.where(valid, vals, xp.zeros_like(vals))
    if name in ("sum", "avg"):
        s = seg.segment_sum(xp, z, pid, num_partitions)
        c = seg.segment_count(xp, valid, pid, num_partitions)
        sv = xp.take(s, pid)
        cv = xp.take(c, pid)
        if name == "sum":
            return sv, cv > 0
        safe = xp.where(cv > 0, cv, xp.ones_like(cv))
        return sv / safe.astype(sv.dtype) if sv.dtype.kind == "f" \
            else sv / safe, cv > 0
    if name in ("min", "max"):
        fn = seg.segment_min if name == "min" else seg.segment_max
        ident = seg._max_identity(vals.dtype) if name == "min" \
            else seg._min_identity(vals.dtype)
        masked = xp.where(valid, vals, xp.asarray(ident, dtype=vals.dtype))
        per = fn(xp, masked, pid, num_partitions)
        c = seg.segment_count(xp, valid, pid, num_partitions)
        return xp.take(per, pid), xp.take(c, pid) > 0
    raise AssertionError(f"unsupported window aggregate {name}")


def _segmented_scan(xp, vals, pstart, op):
    """Inclusive per-partition prefix scan (Hillis–Steele with a segment
    guard): log₂(n) vectorized passes, identical host/device."""
    if xp is not np:
        return window_segscan(vals, None, pstart, op.__name__ == "maximum")
    n = vals.shape[0]
    pos = _pstart_pos(xp, pstart)
    iota = _iota(xp, n)
    out = vals
    k = 1
    while k < n:
        idx = iota - k
        ok = idx >= pos
        prev = xp.take(out, xp.clip(idx, 0, n - 1))
        out = xp.where(ok, op(out, prev), out)
        k <<= 1
    return out


def running_agg(xp, name, vals, valid, pstart, peerstart):
    """Default frame with ORDER BY: RANGE UNBOUNDED PRECEDING..CURRENT ROW
    — cumulative including the whole current peer group (ties share)."""
    if xp is not np:
        return _compute_torch(name, vals, valid, pstart, peerstart, True)
    from tidb_tpu_torch.ops import segment as seg
    n = vals.shape[0]
    ccnt = xp.cumsum(valid.astype(xp.int64))
    pp = _pstart_pos(xp, pstart)
    base_c = xp.where(pp > 0, xp.take(ccnt, xp.maximum(pp - 1, 0)),
                      xp.int64(0))
    # frame end = last row of the current peer group
    nxt = _next_peerstart_pos(xp, peerstart)
    c = xp.take(ccnt, nxt) - base_c
    if name == "count":
        return c, xp.ones(n, dtype=bool)
    if name in ("min", "max"):
        ident = seg._max_identity(vals.dtype) if name == "min" \
            else seg._min_identity(vals.dtype)
        masked = xp.where(valid, vals, xp.asarray(ident, dtype=vals.dtype))
        op = xp.minimum if name == "min" else xp.maximum
        scan = _segmented_scan(xp, masked, pstart, op)
        return xp.take(scan, nxt), c > 0
    z = xp.where(valid, vals, xp.zeros_like(vals))
    # host promotes float cumsum to f64; the device keeps its float dtype
    # (TPU has no native f64 — error stays bounded by partition size)
    acc_dt = (xp.float64 if xp is np else z.dtype) \
        if z.dtype.kind == "f" else xp.int64
    cum = xp.cumsum(z.astype(acc_dt))
    # exclusive prefix before the partition start
    base = xp.where(pp > 0, xp.take(cum, xp.maximum(pp - 1, 0)),
                    xp.zeros((), dtype=cum.dtype))
    s = xp.take(cum, nxt) - base
    if name == "sum":
        return s, c > 0
    if name == "avg":
        safe = xp.where(c > 0, c, xp.ones_like(c))
        return s / safe.astype(s.dtype) if s.dtype.kind == "f" else s / safe, \
            c > 0
    raise AssertionError(f"running {name} is not supported")


def _frame_bounds(xp, pstart, pre, post):
    """Per-row ([lo, hi] ROWS-frame positions clamped to the partition,
    plast) — None offset = unbounded on that side."""
    if xp is not np:
        pos = window_positions(pstart, pstart)
        return frame_bounds(pos, pre, post) + (pos.plast,)
    from tidb_tpu_torch.ops import segment as seg
    n = pstart.shape[0]
    iota = _iota(xp, n)
    ppos = _pstart_pos(xp, pstart)
    pid = partition_ids(xp, pstart)
    last = seg.segment_max(xp, iota, pid, n)
    plast = xp.take(last, pid)
    lo = ppos if pre is None else \
        xp.clip(iota - pre, ppos, plast + 1)      # +1 ⇒ empty, in range
    hi = plast if post is None else xp.minimum(iota + post, plast)
    return lo, hi, plast


def rows_frame_agg(xp, name, vals, valid, pstart, pre, post):
    """Aggregate over an explicit ROWS frame (ref: executor/window.go
    slide frames; here prefix sums / a doubling sparse table instead of
    per-row slide state)."""
    if xp is not np:
        return _compute_torch(name, vals, valid, pstart, pstart, False,
                              frame=("rows", pre, post))
    n = pstart.shape[0]
    lo, hi, plast = _frame_bounds(xp, pstart, pre, post)
    empty = hi < lo
    lo_c = xp.clip(lo, 0, n - 1)
    hi_c = xp.clip(hi, 0, n - 1)
    ccnt = xp.cumsum(valid.astype(xp.int64))
    base_c = xp.where(lo > 0, xp.take(ccnt, xp.clip(lo - 1, 0, n - 1)),
                      xp.int64(0))
    c = xp.where(empty, xp.int64(0), xp.take(ccnt, hi_c) - base_c)
    if name == "count":
        return c, xp.ones(n, dtype=bool)
    if name in ("sum", "avg"):
        z = xp.where(valid, vals, xp.zeros_like(vals))
        acc_dt = (xp.float64 if xp is np else z.dtype) \
            if z.dtype.kind == "f" else xp.int64
        cum = xp.cumsum(z.astype(acc_dt))
        base = xp.where(lo > 0, xp.take(cum, xp.clip(lo - 1, 0, n - 1)),
                        xp.zeros((), dtype=cum.dtype))
        s = xp.take(cum, hi_c) - base
        if name == "sum":
            return s, (c > 0) & ~empty
        safe = xp.where(c > 0, c, xp.ones_like(c))
        out = s / safe.astype(s.dtype) if s.dtype.kind == "f" else s / safe
        return out, (c > 0) & ~empty
    if name in ("min", "max"):
        from tidb_tpu_torch.ops import segment as seg
        op = xp.minimum if name == "min" else xp.maximum
        ident = seg._max_identity(vals.dtype) if name == "min" \
            else seg._min_identity(vals.dtype)
        masked = xp.where(valid, vals, xp.asarray(ident, dtype=vals.dtype))
        ok = (c > 0) & ~empty
        if pre is None:
            # [partition start, hi]: inclusive prefix scan
            scan = _segmented_scan(xp, masked, pstart, op)
            return xp.take(scan, hi_c), ok
        if post is None:
            # [lo, partition end]: suffix scan via the flipped layout
            iota = _iota(xp, n)
            pstart_r = xp.flip(iota == plast)
            scan_r = _segmented_scan(xp, xp.flip(masked), pstart_r, op)
            suffix = xp.flip(scan_r)
            return xp.take(suffix, lo_c), ok
        # sparse table: level k = reduce over [i, i+2^k); static K from
        # the static frame width, so this traces under jit
        width = pre + post + 1
        K = max(int(width).bit_length() - 1, 0)
        tables = [masked]
        for k in range(K):
            step = 1 << k
            shiftd = xp.concatenate(
                [tables[-1][step:],
                 xp.full(min(step, n), ident, dtype=masked.dtype)])[:n]
            tables.append(op(tables[-1], shiftd))
        stack = xp.stack(tables)                     # (K+1, n)
        w = xp.maximum(hi - lo + 1, 1)
        # floor(log2(w)) without float logs (exact for small ints)
        kk = xp.zeros(n, dtype=xp.int64)
        for k in range(1, K + 1):
            kk = xp.where(w >= (1 << k), xp.int64(k), kk)
        flat = stack.reshape(-1)
        a = xp.take(flat, kk * n + lo_c)
        b = xp.take(flat, kk * n +
                    xp.clip(hi - (xp.int64(1) << kk) + 1, 0, n - 1))
        return op(a, b), ok
    raise AssertionError(f"unsupported framed window aggregate {name}")


def _partition_last(xp, pstart):
    if xp is not np:
        return window_positions(pstart, pstart).plast
    from tidb_tpu_torch.ops import segment as seg
    n = pstart.shape[0]
    iota = _iota(xp, n)
    pid = partition_ids(xp, pstart)
    last = seg.segment_max(xp, iota, pid, n)
    return xp.take(last, pid)


def range_frame_bounds(xp, pstart, peerstart, okey, ovalid, desc: bool,
                       pre, post):
    """[lo, hi] positions of a RANGE value frame on the sorted layout
    (ref: executor/window.go slide frames; MySQL RANGE offset semantics).

    okey/ovalid: the single ORDER BY key, sorted layout. DESC negates it
    into ascending m-space, so the frame is uniformly [m−pre, m+post]
    ("n PRECEDING" means key+n under DESC). A 0 offset is CURRENT ROW —
    in RANGE terms the current PEER edge, where the searches land
    naturally. NULL keys are each other's peers: an offset bound gives a
    NULL row exactly its NULL block; an unbounded side still reaches the
    partition edge; non-NULL frames never include NULLs.

    Vectorized in-partition binary search: log2(n) static rounds of
    take+where — no extra lax.sort (whose compile cost is the device
    budget, ops/factorize.py docstring). Comparisons run in int64 for an
    integer key (exact for int/decimal/date keys) and in float64 for a
    float key."""
    if xp is not np:
        return frame_bounds(window_positions(pstart, peerstart), pre, post,
                            (okey, ovalid, desc))
    n = pstart.shape[0]
    ppos = _pstart_pos(xp, pstart)
    plast = _partition_last(xp, pstart)
    # integer keys work in int64, float keys in float64: a DATE (int32)
    # key's NULL sentinel below and its +-offset arithmetic overflow its
    # own dtype
    m = xp.asarray(okey)
    m = m.astype(np.float64 if m.dtype.kind == "f" else np.int64)
    if desc:
        m = -m
    if m.dtype.kind == "f":
        sent = xp.asarray(np.inf if desc else -np.inf, dtype=m.dtype)
    else:
        big = np.iinfo(np.int64).max // 2
        sent = xp.asarray(big if desc else -big, dtype=m.dtype)
    # NULL placement matches the sort order: ASC first, DESC last
    m = xp.where(ovalid, m, sent)
    k_rounds = max(int(max(n - 1, 1)).bit_length(), 1)

    def first_pos(target, strict: bool):
        lo_b = ppos
        hi_b = plast + 1
        for _ in range(k_rounds):
            mid = (lo_b + hi_b) // 2
            v = xp.take(m, xp.clip(mid, 0, n - 1))
            hit = (v > target) if strict else (v >= target)
            hit = hit | (mid > plast)
            hi_b = xp.where(hit, mid, hi_b)
            lo_b = xp.where(hit, lo_b, mid + 1)
        return lo_b

    peer_lo = _pstart_pos(xp, peerstart)
    peer_hi = _next_peerstart_pos(xp, peerstart)
    if pre is None:
        lo = ppos
    else:
        off = xp.asarray(pre, dtype=m.dtype)
        lo = xp.where(ovalid, first_pos(m - off, strict=False), peer_lo)
    if post is None:
        hi = plast
    else:
        off = xp.asarray(post, dtype=m.dtype)
        hi = xp.where(ovalid, first_pos(m + off, strict=True) - 1,
                      peer_hi)
    return lo, hi


def range_frame_agg(xp, name, vals, valid, lo, hi):
    """COUNT/SUM/AVG over precomputed [lo, hi] frame positions (the
    prefix-sum formulation of rows_frame_agg, bounds supplied)."""
    if xp is not np:
        return _frame_agg_torch(name, vals, valid, lo, hi)
    n = vals.shape[0] if vals is not None else lo.shape[0]
    empty = hi < lo
    hi_c = xp.clip(hi, 0, n - 1)
    ccnt = xp.cumsum(valid.astype(xp.int64))
    base_c = xp.where(lo > 0, xp.take(ccnt, xp.clip(lo - 1, 0, n - 1)),
                      xp.int64(0))
    c = xp.where(empty, xp.int64(0), xp.take(ccnt, hi_c) - base_c)
    if name == "count":
        return c, xp.ones(n, dtype=bool)
    if name not in ("sum", "avg"):
        raise AssertionError(
            f"unsupported RANGE-framed window aggregate {name}")
    z = xp.where(valid, vals, xp.zeros_like(vals))
    acc_dt = (xp.float64 if xp is np else z.dtype) \
        if z.dtype.kind == "f" else xp.int64
    cum = xp.cumsum(z.astype(acc_dt))
    base = xp.where(lo > 0, xp.take(cum, xp.clip(lo - 1, 0, n - 1)),
                    xp.zeros((), dtype=cum.dtype))
    st = xp.where(empty, xp.zeros((), dtype=cum.dtype),
                  xp.take(cum, hi_c) - base)
    if name == "sum":
        return st, (c > 0) & ~empty
    safe = xp.where(c > 0, c, xp.ones_like(c))
    out = st / safe.astype(st.dtype) if st.dtype.kind == "f" else st / safe
    return out, (c > 0) & ~empty


def frame_value(xp, name, vals, valid, pstart, peerstart, has_order: bool,
                frame, range_bounds=None):
    """FIRST_VALUE / LAST_VALUE: a gather at the frame edge. The default
    frame with ORDER BY ends at the current PEER group (the classic
    last_value gotcha — MySQL semantics preserved)."""
    if xp is not np:
        return _value_torch(name, vals, valid,
                            window_positions(pstart, peerstart), has_order,
                            frame, range_bounds)
    n = pstart.shape[0]
    if range_bounds is not None:
        lo, hi = range_bounds
        empty = hi < lo
        pos = lo if name == "first_value" else hi
        pos = xp.clip(pos, 0, n - 1)
        return xp.take(vals, pos), xp.take(valid, pos) & ~empty
    if frame is not None:
        pre, post = frame
        lo, hi, _plast = _frame_bounds(xp, pstart, pre, post)
        empty = hi < lo
        pos = lo if name == "first_value" else hi
        pos = xp.clip(pos, 0, n - 1)
        return xp.take(vals, pos), xp.take(valid, pos) & ~empty
    if name == "first_value":
        pos = _pstart_pos(xp, pstart)
    elif has_order:
        pos = _next_peerstart_pos(xp, peerstart)
    else:
        from tidb_tpu_torch.ops import segment as seg
        iota = _iota(xp, n)
        pid = partition_ids(xp, pstart)
        last = seg.segment_max(xp, iota, pid, n)
        pos = xp.take(last, pid)
    return xp.take(vals, pos), xp.take(valid, pos)


def percent_rank(xp, pstart, peerstart):
    """(rank-1)/(rows-1), 0 for single-row partitions."""
    if xp is not np:
        return frame_rank("percent_rank", window_positions(pstart, peerstart))
    n = pstart.shape[0]
    r = rank(xp, pstart, peerstart).astype(np.float64)
    rows = _partition_rows(xp, pstart)
    denom = xp.maximum(rows - 1, 1).astype(r.dtype)
    return xp.where(rows > 1, (r - 1) / denom, xp.zeros_like(r))


def cume_dist(xp, pstart, peerstart):
    """peers-inclusive cumulative distribution."""
    if xp is not np:
        return frame_rank("cume_dist", window_positions(pstart, peerstart))
    n = pstart.shape[0]
    nxt = _next_peerstart_pos(xp, peerstart)
    pp = _pstart_pos(xp, pstart)
    rows = _partition_rows(xp, pstart)
    fdt = np.float64
    return (nxt - pp + 1).astype(fdt) / rows.astype(fdt)


def ntile(xp, pstart, n_buckets: int):
    """MySQL NTILE: earlier buckets absorb the remainder."""
    if xp is not np:
        return frame_rank("ntile", window_positions(pstart, pstart), n_buckets)
    k = row_number(xp, pstart) - 1
    rows = _partition_rows(xp, pstart)
    q = rows // n_buckets
    r = rows % n_buckets
    big = r * (q + 1)
    in_big = k < big
    safe_q = xp.maximum(q, 1)
    bucket = xp.where(in_big, k // xp.maximum(q + 1, 1) + 1,
                      r + (k - big) // safe_q + 1)
    # more buckets than rows: bucket = row_number
    return xp.where(q > 0, bucket, k + 1)


def nth_value(xp, vals, valid, pstart, peerstart, has_order: bool,
              frame, nth: int, range_bounds=None):
    """NTH_VALUE(v, n): the frame's n-th row, NULL when the frame is
    shorter (frame-aware like first/last value)."""
    if xp is not np:
        return _value_torch("nth_value", vals, valid,
                            window_positions(pstart, peerstart), has_order,
                            frame, range_bounds, nth)
    n = pstart.shape[0]
    if range_bounds is not None:
        lo, hi = range_bounds
    elif frame is not None:
        pre, post = frame
        lo, hi, _plast = _frame_bounds(xp, pstart, pre, post)
    else:
        lo = _pstart_pos(xp, pstart)
        hi = _next_peerstart_pos(xp, peerstart) if has_order else None
        if hi is None:
            from tidb_tpu_torch.ops import segment as seg
            iota = _iota(xp, n)
            pid = partition_ids(xp, pstart)
            last = seg.segment_max(xp, iota, pid, n)
            hi = xp.take(last, pid)
    pos = lo + (nth - 1)
    ok = pos <= hi
    pos = xp.clip(pos, 0, n - 1)
    return xp.take(vals, pos), xp.take(valid, pos) & ok


def _partition_rows(xp, pstart):
    if xp is not np:
        pos = window_positions(pstart, pstart)
        return pos.plast - pos.ppos + 1
    from tidb_tpu_torch.ops import segment as seg
    n = pstart.shape[0]
    pid = partition_ids(xp, pstart)
    cnt = seg.segment_count(xp, xp.ones(n, dtype=bool),
                            pid,
                            n)
    return xp.take(cnt, pid)


def compute(xp, name, vals, valid, pstart, peerstart, has_order: bool,
            offset: int = 1, fill=None, frame=None, range_key=None,
            positions=None, sorted_key: bool = False):
    """Shared dispatch for host (numpy) and device (torch) window columns.
    vals/valid are the function argument in SORTED layout (None for the
    rank family); fill = (fill_vals, fill_valid) for lag/lead; frame =
    ('rows'|'range', pre, post) (None side = unbounded) or None for the
    default frame; range_key = (okey, ovalid, desc) in sorted layout —
    required for RANGE offset frames. `positions` (torch only): the
    layout's K12 `window_positions`, when the caller already has them;
    `sorted_key` (torch only): K14's promise about range_key
    (`frame_bounds`)."""
    if xp is not np:
        return _compute_torch(name, vals, valid, pstart, peerstart,
                              has_order, offset, fill, frame, range_key,
                              positions, sorted_key)
    n = pstart.shape[0]
    ones = xp.ones(n, dtype=bool)
    rows_fr = None
    range_bounds = None
    if frame is not None:
        tag, pre, post = frame
        if tag == "range":
            okey, ovalid, desc = range_key
            range_bounds = range_frame_bounds(xp, pstart, peerstart,
                                              okey, ovalid, desc,
                                              pre, post)
        else:
            rows_fr = (pre, post)
    if name == "row_number":
        return row_number(xp, pstart), ones
    if name == "rank":
        return rank(xp, pstart, peerstart), ones
    if name == "dense_rank":
        return dense_rank(xp, pstart, peerstart), ones
    if name in ("lag", "lead"):
        off = offset if name == "lag" else -offset
        return shifted(xp, vals, valid, pstart, off, fill[0], fill[1])
    if name in ("first_value", "last_value"):
        return frame_value(xp, name, vals, valid, pstart, peerstart,
                           has_order, rows_fr, range_bounds)
    if name == "percent_rank":
        return percent_rank(xp, pstart, peerstart), ones
    if name == "cume_dist":
        return cume_dist(xp, pstart, peerstart), ones
    if name == "ntile":
        return ntile(xp, pstart, offset), ones
    if name == "nth_value":
        return nth_value(xp, vals, valid, pstart, peerstart, has_order,
                         rows_fr, offset, range_bounds)
    if range_bounds is not None:
        return range_frame_agg(xp, name, vals, valid, *range_bounds)
    if rows_fr is not None:
        return rows_frame_agg(xp, name, vals, valid, pstart, *rows_fr)
    if has_order:
        return running_agg(xp, name, vals, valid, pstart, peerstart)
    return full_frame_agg(xp, name, vals, valid, pstart, n)


def _next_peerstart_pos(xp, peerstart):
    """Index of the LAST row of each row's peer group."""
    if xp is not np:
        return window_positions(peerstart, peerstart).peer_hi
    from tidb_tpu_torch.ops import segment as seg
    n = peerstart.shape[0]
    iota = _iota(xp, n)
    peer_id = xp.cumsum(peerstart.astype(xp.int64)) - 1
    last = seg.segment_max(xp, iota, peer_id, n)
    return xp.take(last, peer_id)


def shifted(xp, vals, valid, pstart, offset: int, fill_vals, fill_valid):
    """LAG (offset>0) / LEAD (offset<0) within partitions, sorted layout."""
    if xp is not np:
        return _shifted_torch(vals, valid, window_positions(pstart, pstart),
                              offset, (fill_vals, fill_valid))
    from tidb_tpu_torch.ops import segment as seg
    n = vals.shape[0]
    iota = _iota(xp, n)
    src = iota - offset
    if offset > 0:
        ok = src >= _pstart_pos(xp, pstart)    # same partition, in range
    else:
        pid = partition_ids(xp, pstart)
        last = seg.segment_max(xp, iota, pid, n)
        ok = src <= xp.take(last, pid)
    safe = xp.clip(src, 0, n - 1)
    out_v = xp.where(ok, xp.take(vals, safe), fill_vals)
    out_m = xp.where(ok, xp.take(valid, safe), fill_valid)
    return out_v, out_m


# ---------------------------------------------------------------------------
# The torch branch: K12-K15, each beside its plain torch version
# ---------------------------------------------------------------------------

class Positions(NamedTuple):
    """K12's per-row positions of one sorted layout (int64 (n,) each)."""
    ppos: torch.Tensor      # first row of the row's partition
    plast: torch.Tensor     # last row of the partition
    peer_lo: torch.Tensor   # first row of the row's peer group
    peer_hi: torch.Tensor   # last row of the peer group
    dense: torch.Tensor     # inclusive count of peer starts


#: K12's key types: 0 bool, 1 int32, 2 int64, 3 float64
_KDT = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
_RANKS = {"row_number": 0, "rank": 1, "dense_rank": 2, "percent_rank": 3,
          "cume_dist": 4, "ntile": 5}
_AGGS = {"count": 0, "sum": 1, "avg": 2, "nonempty": 3}
#: keys one K12 flags launch compares (more run as further launches)
_FLAG_KEYS = 8
_I64 = torch.int64
_F64 = torch.float64


def _ck():
    return _cuda_kernels


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what: str, n: int, *tensors, dtype=None):
    """Raise unless every tensor is a contiguous 1-D CUDA tensor of n
    elements (and of `dtype`, when given)."""
    ck = _ck()
    for t in tensors:
        if t is None:
            continue
        ck.require_cuda(t, what=what)
        if t.dim() != 1 or t.shape[0] != n:
            raise ck.KernelError(f"{what}: expected 1-D tensors of {n}")
        if dtype is not None and t.dtype != dtype:
            raise ck.KernelError(f"{what}: expected {dtype}, got {t.dtype}")
    if n >= 2 ** 31:
        raise ck.KernelError(f"{what}: {n} rows (< 2^31 taken)")


#: a payload slot of a scan's look-back status (csrc/window_scan.cu)
_SCAN_STATE_BYTES = 32


def scan_scratch_bytes(n: int, tile: int, scans: int = 1) -> int:
    """Bytes of scratch K12/K13's single-pass scan takes for `scans` scans
    over n rows in tiles of `tile` rows (csrc/window_scan.cu's layout):
    every scan's zeroed part (a 16-byte tile counter and a 4-byte flag a
    tile, rounded up to 16 bytes), then every scan's two payload slots a
    tile (the tile's aggregate and its inclusive prefix)."""
    nb = max(1, -(-n // tile))
    zeroed = 16 + -(-4 * nb // 16) * 16
    return scans * (zeroed + 2 * _SCAN_STATE_BYTES * nb)


@functools.lru_cache(maxsize=None)
def _scan_tile() -> int:
    return _ck().library("window_scan").tt_window_tile()


@contextlib.contextmanager
def _scan_scratch(n: int, device, stream: int, scans: int = 1):
    """Hold `stream`'s scan scratch (its raw handle on `device`), grown to
    fit n rows and `scans` scans, for one C call that zeroes its status
    and launches: → its data pointer. Every call zeroes the status it
    uses and calls on one stream run in order, so one buffer a stream
    serves them all once each call's enqueue holds the lock."""
    ent = _ck().stream_scratch("window_scan", device, stream)
    with ent.lock:      # from the call's status memset to its launch
        yield ent.ensure(scan_scratch_bytes(n, _scan_tile(), scans), device)


def _wide(v: torch.Tensor) -> torch.Tensor:
    """int32 / int64 / float64 as they are; other integers and bools →
    int64, float32 → float64 (exact, order- and equality-preserving)."""
    if v.dtype in (torch.int32, _I64, _F64):
        return v
    return v.to(_F64 if v.dtype.is_floating_point else _I64)


def _ident(is_max: bool, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


# -- K12 window_bounds -------------------------------------------------------

def window_flags_plain(perm, live, keys, n_part: int):
    """Plain torch version of K12's flags (the reference's `flags`
    closure of emit_window_cols): over the sorted layout `perm`, pstart
    is set at row 0, where `live` (None: all live) changes, and where a
    partition key (the first n_part of `keys`, [(values, mask-or-None)]
    row-indexed) changes; peerstart also where an order key changes.
    NULL slots are neutralized: all NULLs are one group."""
    n = perm.shape[0]
    base = torch.zeros(n, dtype=torch.bool, device=perm.device)
    if n:
        base[0] = True
    if live is not None:
        ls = live[perm]
        base[1:] |= ls[1:] != ls[:-1]

    def flags(cols, out):
        out = out.clone()
        for v, m in cols:
            vs = v[perm]
            if m is None:
                out[1:] |= vs[1:] != vs[:-1]
                continue
            ms = m[perm]
            vs = torch.where(ms, vs, torch.zeros_like(vs))
            out[1:] |= (vs[1:] != vs[:-1]) | (ms[1:] != ms[:-1])
        return out

    pstart = flags(keys[:n_part], base)
    return pstart, flags(keys[n_part:], pstart)


def _flag_cols(what, perm, live, keys, n):
    """The checks of K12's flag entries → the key columns as the kernel
    reads them: bool, int32, int64 or float64 (`_wide`), contiguous."""
    ck = _ck()
    if perm.dtype not in (torch.int32, _I64):
        raise ck.KernelError(f"{what}: int32/int64 permutation expected")
    _check(what, n, perm)
    _check(what, n, live, dtype=torch.bool)
    cols = []
    for v, m in keys:
        v = (v if v.dtype == torch.bool else _wide(v)).contiguous()
        _check(what, n, v)
        _check(what, n, m, dtype=torch.bool)
        cols.append((v, m))
    return cols


def window_flags(perm, live, keys, n_part: int):
    """K12 flags wrapper → (pstart, peerstart) bool, as
    `window_flags_plain` (perm int32 or int64): `window_bounds`' flags
    launch, once a chunk of _FLAG_KEYS keys, each chunk after the first
    keeping the flags the earlier ones wrote."""
    if _on_cpu(perm):
        return window_flags_plain(perm, live, keys, n_part)
    ck = _ck()
    n = perm.shape[0]
    cols = _flag_cols("window_flags", perm, live, keys, n)
    pstart = torch.empty(n, dtype=torch.bool, device=perm.device)
    peerstart = torch.empty_like(pstart)
    lib = ck.library("window_scan")
    P = ctypes.c_void_p * _FLAG_KEYS
    for c0 in range(0, max(len(cols), 1), _FLAG_KEYS):
        chunk = cols[c0:c0 + _FLAG_KEYS]
        nk = len(chunk)
        np_c = min(max(n_part - c0, 0), nk)
        rc = lib.tt_window_bounds_flags(
            perm.data_ptr(), int(perm.dtype == _I64),
            _ptr(live) if c0 == 0 else None, None,
            P(*[v.data_ptr() for v, _m in chunk]),
            P(*[_ptr(m) for _v, m in chunk]),
            (ctypes.c_int * _FLAG_KEYS)(*[_KDT[v.dtype] for v, _m in chunk]),
            nk, np_c, n, int(c0 > 0), pstart.data_ptr(),
            peerstart.data_ptr(), ck.stream_ptr(perm.device))
        if n > 0:
            ck.count("window_bounds")
        ck.check(rc, "window_flags")
    return pstart, peerstart


def window_positions_plain(pstart, peerstart) -> Positions:
    """Plain torch version of K12's positions: the reference's formulas
    (_pstart_pos's running max of start indices; _partition_last and
    _next_peerstart_pos as segment maxima of the row index over
    partition / peer ids; dense_rank's cumsum of peerstart)."""
    n = pstart.shape[0]
    iota = torch.arange(n, dtype=_I64, device=pstart.device)
    zero = torch.zeros_like(iota)

    def start_pos(flags):
        return torch.cummax(torch.where(flags, iota, zero), 0).values \
            if n else iota

    def last_pos(ids):
        last = torch.zeros(n, dtype=_I64, device=pstart.device)
        last.scatter_reduce_(0, ids.clamp(min=0), iota, reduce="amax",
                             include_self=False)
        return last[ids.clamp(min=0)]

    dense = torch.cumsum(peerstart.to(_I64), 0)
    pid = torch.cumsum(pstart.to(_I64), 0) - 1
    return Positions(start_pos(pstart), last_pos(pid),
                     start_pos(peerstart), last_pos(dense - 1), dense)


def window_positions(pstart, peerstart) -> Positions:
    """K12 positions wrapper (pstart[0] set, pstart ⊆ peerstart), as
    `window_positions_plain`."""
    if _on_cpu(pstart):
        return window_positions_plain(pstart, peerstart)
    ck = _ck()
    n = pstart.shape[0]
    _check("window_positions", n, pstart, peerstart, dtype=torch.bool)
    out = [torch.empty(n, dtype=_I64, device=pstart.device)
           for _ in range(5)]
    ppos, plast, peer_lo, peer_hi, dense = out
    stream = ck.stream_ptr(pstart.device)
    with _scan_scratch(n, pstart.device, stream, 2) as scratch:
        rc = ck.library("window_scan").tt_window_positions(
            pstart.data_ptr(), peerstart.data_ptr(), n, ppos.data_ptr(),
            plast.data_ptr(), peer_lo.data_ptr(), peer_hi.data_ptr(),
            dense.data_ptr(), scratch, stream)
    if n > 0:
        ck.count("window_bounds")
    ck.check(rc, "window_positions")
    return Positions(ppos, plast, peer_lo, peer_hi, dense)


def window_bounds_plain(perm, live, keys, n_part: int):
    """Plain torch version of `window_bounds`: `window_flags_plain`,
    then `window_positions_plain` over its flags."""
    pstart, peerstart = window_flags_plain(perm, live, keys, n_part)
    return pstart, peerstart, window_positions_plain(pstart, peerstart)


def window_bounds(perm, live, keys, n_part: int, n_live=None):
    """K12 wrapper, the entry both window layouts call → (pstart,
    peerstart, Positions), as `window_bounds_plain`: the flags launch
    (`bounds_flags`: a warp a run of sorted rows, each row's keys read
    once, the predecessor's by shuffle), then the positions scans, whose
    outputs and scratch are made while the flags run; each C call counts
    one launch. More than _FLAG_KEYS keys take the chunked flags entry. `n_live` (a 0-d int32
    on the card, as sort_perm returns it) says that `perm` lists every
    live row first: the kernel then reads `live` as `i < n_live` and
    gathers nothing for it (the plain version reads `live` as always)."""
    if _on_cpu(perm):
        return window_bounds_plain(perm, live, keys, n_part)
    if len(keys) > _FLAG_KEYS:
        pstart, peerstart = window_flags(perm, live, keys, n_part)
        return pstart, peerstart, window_positions(pstart, peerstart)
    ck = _ck()
    n = perm.shape[0]
    cols = _flag_cols("window_bounds", perm, live, keys, n)
    dev = perm.device
    if n_live is not None and (n_live.device != dev or n_live.numel() != 1
                               or n_live.dtype != torch.int32):
        raise ck.KernelError("window_bounds: n_live must be one int32 on "
                             "the permutation's device")
    a = -(-n // 16) * 16          # the flags' 8-byte stores need alignment
    flags = torch.empty(2 * a, dtype=torch.bool, device=dev)
    pstart, peerstart = flags[:n], flags[a:a + n]
    P = ctypes.c_void_p * _FLAG_KEYS
    lib = ck.library("window_scan")
    stream = ck.stream_ptr(dev)
    rc = lib.tt_window_bounds_flags(
        perm.data_ptr(), int(perm.dtype == _I64), _ptr(live), _ptr(n_live),
        P(*[v.data_ptr() for v, _m in cols]), P(*[_ptr(m) for _v, m in cols]),
        (ctypes.c_int * _FLAG_KEYS)(*[_KDT[v.dtype] for v, _m in cols]),
        len(cols), min(n_part, len(cols)), n, 0, pstart.data_ptr(),
        peerstart.data_ptr(), stream)
    if n > 0:
        ck.count("window_bounds")
    ck.check(rc, "window_bounds")
    pos = Positions(*torch.empty((5, n), dtype=_I64, device=dev).unbind(0))
    with _scan_scratch(n, dev, stream, 2) as scratch:
        rc = lib.tt_window_positions(
            pstart.data_ptr(), peerstart.data_ptr(), n, pos.ppos.data_ptr(),
            pos.plast.data_ptr(), pos.peer_lo.data_ptr(),
            pos.peer_hi.data_ptr(), pos.dense.data_ptr(), scratch, stream)
    if n > 0:
        ck.count("window_bounds")
    ck.check(rc, "window_bounds")
    return pstart, peerstart, pos


# -- K13 window_scan ---------------------------------------------------------

def window_prefix_plain(vals, valid):
    """Plain torch version of K13's prefix: (cum, ccnt) — the inclusive
    cumsum of valid ? vals : 0 in int64 (float64 for a float column;
    None when vals is None) and of the valid count (int64). valid None:
    every row valid."""
    if valid is None:
        n = vals.shape[0]
        ccnt = torch.arange(1, n + 1, dtype=_I64, device=vals.device)
    else:
        ccnt = torch.cumsum(valid.to(_I64), 0)
    if vals is None:
        return None, ccnt
    z = vals.to(_F64 if vals.dtype.is_floating_point else _I64)
    if valid is not None:
        z = torch.where(valid, z, torch.zeros_like(z))
    return torch.cumsum(z, 0), ccnt


def window_prefix(vals, valid):
    """K13 prefix wrapper, as `window_prefix_plain`."""
    lead = vals if vals is not None else valid
    if _on_cpu(lead):
        return window_prefix_plain(vals, valid)
    ck = _ck()
    n = lead.shape[0]
    _check("window_prefix", n, valid, dtype=torch.bool)
    cum = None
    vdt = 0
    if vals is not None:
        vals = _wide(vals).contiguous()
        _check("window_prefix", n, vals)
        vdt = _KDT[vals.dtype]
    if vdt == 3:
        cum = lead.new_empty(n, dtype=_F64)
        ccnt = lead.new_empty(n, dtype=_I64)
    elif vdt:
        cum, ccnt = lead.new_empty((2, n), dtype=_I64).unbind(0)
    else:
        ccnt = lead.new_empty(n, dtype=_I64)
    stream = ck.stream_ptr(lead.device)
    with _scan_scratch(n, lead.device, stream) as scratch:
        rc = ck.library("window_scan").tt_window_prefix(
            _ptr(vals), vdt, _ptr(valid), n, _ptr(cum), ccnt.data_ptr(),
            scratch, stream)
    if n > 0:
        ck.count("window_scan")
    ck.check(rc, "window_prefix")
    return cum, ccnt


def window_segscan_plain(vals, valid, pstart, is_max: bool,
                         reverse: bool = False):
    """Plain torch version of K13's segmented scan — the reference's
    Hillis–Steele _segmented_scan over valid ? vals : identity, inside
    the partitions pstart marks; `reverse` scans from each partition's
    end backwards (rows_frame_agg's flipped layout)."""
    n = vals.shape[0]
    masked = vals if valid is None else torch.where(
        valid, vals, torch.full_like(vals, _ident(is_max, vals.dtype)))
    flags = pstart
    if reverse:
        last = torch.ones_like(pstart)
        last[:-1] = pstart[1:]
        masked, flags = torch.flip(masked, (0,)), torch.flip(last, (0,))
    op = torch.maximum if is_max else torch.minimum
    iota = torch.arange(n, dtype=_I64, device=vals.device)
    pos = torch.cummax(torch.where(flags, iota, torch.zeros_like(iota)),
                       0).values if n else iota
    out = masked
    k = 1
    while k < n:
        idx = iota - k
        prev = out[idx.clamp(0, n - 1)]
        out = torch.where(idx >= pos, op(out, prev), out)
        k <<= 1
    return torch.flip(out, (0,)) if reverse else out


def window_segscan(vals, valid, pstart, is_max: bool, reverse: bool = False):
    """K13 segmented-scan wrapper, as `window_segscan_plain` (int32, int64
    and float64 values)."""
    if _on_cpu(vals):
        return window_segscan_plain(vals, valid, pstart, is_max, reverse)
    ck = _ck()
    n = vals.shape[0]
    if vals.dtype not in (torch.int32, _I64, _F64):
        raise ck.KernelError(f"window_segscan: dtype {vals.dtype}")
    _check("window_segscan", n, vals)
    _check("window_segscan", n, valid, pstart, dtype=torch.bool)
    ident = _ident(is_max, vals.dtype)
    out = torch.empty_like(vals)
    stream = ck.stream_ptr(vals.device)
    with _scan_scratch(n, vals.device, stream) as scratch:
        rc = ck.library("window_scan").tt_window_segscan(
            vals.data_ptr(), _KDT[vals.dtype], _ptr(valid),
            pstart.data_ptr(), n, int(is_max), int(reverse),
            0 if vals.dtype == _F64 else int(ident), float(ident),
            out.data_ptr(), scratch, stream)
    if n > 0:
        ck.count("window_scan")
    ck.check(rc, "window_segscan")
    return out


# -- K14 frame_bounds --------------------------------------------------------

def _range_offset(off, dtype):
    # the reference's xp.asarray(off, dtype=m.dtype): an integer key
    # truncates a fractional offset toward zero
    return float(off) if dtype == _F64 else int(off)


def frame_bounds_plain(pos: Positions, pre, post, range_key=None):
    """Plain torch version of K14 → (lo, hi) int64: the reference's
    _frame_bounds for a ROWS frame (range_key None), or its
    range_frame_bounds over range_key = (okey, ovalid, desc), the sorted
    ORDER BY key, in int64 (integer keys) or float64 (float keys)."""
    n = pos.ppos.shape[0]
    dev = pos.ppos.device
    iota = torch.arange(n, dtype=_I64, device=dev)
    if range_key is None:
        lo = pos.ppos if pre is None else \
            torch.clamp(iota - int(pre), pos.ppos, pos.plast + 1)
        hi = pos.plast if post is None else \
            torch.minimum(iota + int(post), pos.plast)
        return lo, hi
    okey, ovalid, desc = range_key
    m = okey.to(_F64 if okey.dtype.is_floating_point else _I64)
    if desc:
        m = -m
    if m.dtype == _F64:
        sent = float("inf") if desc else float("-inf")
    else:
        big = np.iinfo(np.int64).max // 2
        sent = big if desc else -big
    m = torch.where(ovalid, m, torch.full_like(m, sent))
    rounds = max(int(max(n - 1, 1)).bit_length(), 1)

    def first_pos(target, strict: bool):
        lo_b = pos.ppos
        hi_b = pos.plast + 1
        for _ in range(rounds):
            mid = (lo_b + hi_b) // 2
            v = m[mid.clamp(0, n - 1)]
            hit = (v > target) if strict else (v >= target)
            hit = hit | (mid > pos.plast)
            hi_b = torch.where(hit, mid, hi_b)
            lo_b = torch.where(hit, lo_b, mid + 1)
        return lo_b

    if pre is None:
        lo = pos.ppos
    else:
        lo = torch.where(ovalid, first_pos(
            m - _range_offset(pre, m.dtype), strict=False), pos.peer_lo)
    if post is None:
        hi = pos.plast
    else:
        hi = torch.where(ovalid, first_pos(
            m + _range_offset(post, m.dtype), strict=True) - 1, pos.peer_hi)
    return lo, hi


#: csrc/window_frame.cu tt_frame_bounds, bound at the first CUDA call
_FRAME_BOUNDS = None


def _bind_frame_bounds():
    global _FRAME_BOUNDS
    _FRAME_BOUNDS = _ck().library("window_frame").tt_frame_bounds
    return _FRAME_BOUNDS


def frame_bounds(pos: Positions, pre, post, range_key=None,
                 sorted_key: bool = False):
    """K14 wrapper, as `frame_bounds_plain`. `sorted_key` is the caller's
    promise about a RANGE frame's key: within each partition of `pos` it
    does not decrease in m-space (DESC negated, NULLs where the sort put
    them) and the peers of `pos` are its runs of equal keys, as the
    window layout's sort gives them. An int32 key then searches per
    warp (a 0 offset takes the peer edge); the result is the same
    either way."""
    if _on_cpu(pos.ppos):
        return frame_bounds_plain(pos, pre, post, range_key)
    ck = _ck()
    n = pos.ppos.shape[0]
    _check("frame_bounds", n, *pos[:4], dtype=_I64)
    key = kvalid = None
    desc = 0
    kdt = 2
    if range_key is not None:
        okey, kvalid, desc = range_key
        key = _wide(okey).contiguous()
        _check("frame_bounds", n, key)
        _check("frame_bounds", n, kvalid, dtype=torch.bool)
        kdt = _KDT[key.dtype]
    as_f = key is not None and key.dtype == _F64
    pre_i = 0 if pre is None or as_f else int(pre)
    post_i = 0 if post is None or as_f else int(post)
    lo, hi = pos.ppos.new_empty((2, n))   # one allocation, two rows
    rc = (_FRAME_BOUNDS or _bind_frame_bounds())(
        pos.ppos.data_ptr(), pos.plast.data_ptr(), pos.peer_lo.data_ptr(),
        pos.peer_hi.data_ptr(), n, _ptr(key), kdt, _ptr(kvalid),
        int(bool(desc)), int(pre is not None), pre_i,
        float(pre) if as_f and pre is not None else 0.0,
        int(post is not None), post_i,
        float(post) if as_f and post is not None else 0.0,
        max(int(max(n - 1, 1)).bit_length(), 1), int(bool(sorted_key)),
        lo.data_ptr(), hi.data_ptr(), ck.stream_ptr(lo.device))
    if n > 0:
        ck.count("frame_bounds")
    if rc:
        ck.check(rc, "frame_bounds")
    return lo, hi


# -- K15 frame_eval ----------------------------------------------------------

def frame_rank_plain(name: str, pos: Positions, buckets: int = 1):
    """Plain torch version of K15's rank entry: the reference's
    row_number, rank, dense_rank, percent_rank, cume_dist and ntile over
    the positions (int64; float64 for percent_rank / cume_dist)."""
    n = pos.ppos.shape[0]
    iota = torch.arange(n, dtype=_I64, device=pos.ppos.device)
    rows = pos.plast - pos.ppos + 1
    if name == "row_number":
        return iota - pos.ppos + 1
    if name == "rank":
        return pos.peer_lo - pos.ppos + 1
    if name == "dense_rank":
        return pos.dense - pos.dense[pos.ppos] + 1
    if name == "percent_rank":
        r = (pos.peer_lo - pos.ppos + 1).to(_F64)
        denom = torch.clamp(rows - 1, min=1).to(_F64)
        return torch.where(rows > 1, (r - 1) / denom, torch.zeros_like(r))
    if name == "cume_dist":
        return (pos.peer_hi - pos.ppos + 1).to(_F64) / rows.to(_F64)
    if name == "ntile":
        k = iota - pos.ppos
        q = rows // buckets
        r = rows % buckets
        big = r * (q + 1)
        bucket = torch.where(
            k < big, k // torch.clamp(q + 1, min=1) + 1,
            r + (k - big) // torch.clamp(q, min=1) + 1)
        return torch.where(q > 0, bucket, k + 1)
    raise AssertionError(f"not a rank function: {name}")


def frame_rank(name: str, pos: Positions, buckets: int = 1):
    """K15 rank-entry wrapper, as `frame_rank_plain`."""
    if _on_cpu(pos.ppos):
        return frame_rank_plain(name, pos, buckets)
    ck = _ck()
    n = pos.ppos.shape[0]
    _check("frame_rank", n, *pos, dtype=_I64)
    if name == "ntile" and buckets <= 0:
        raise ck.KernelError("frame_rank: NTILE needs a positive bucket "
                             "count")
    out = torch.empty(n, dtype=_F64 if name in ("percent_rank",
                                                "cume_dist") else _I64,
                      device=pos.ppos.device)
    rc = ck.library("window_frame").tt_frame_rank(
        *[t.data_ptr() for t in pos], n, _RANKS[name], int(buckets),
        out.data_ptr(), ck.stream_ptr(out.device))
    if n > 0:
        ck.count("frame_eval")
    ck.check(rc, "frame_rank")
    return out


def frame_agg_plain(what: str, cum, ccnt, lo, hi):
    """Plain torch version of K15's aggregate entry → (out, ok): over
    [lo, hi] by prefix differences (the reference's range_frame_agg),
    c = ccnt[hi] - ccnt[lo - 1] (0 for an empty frame); count → (c, all
    True); sum → (cum[hi] - cum[lo - 1], c > 0 and not empty), 0 for an
    empty frame; avg → (sum / max(c, 1) as float64, same); nonempty →
    (None, same)."""
    n = lo.shape[0]
    empty = hi < lo
    hi_c = hi.clamp(0, n - 1)
    lo_c = (lo - 1).clamp(0, n - 1)
    zero = torch.zeros_like(lo)
    c = torch.where(empty, zero, ccnt[hi_c] - torch.where(lo > 0, ccnt[lo_c],
                                                          zero))
    if what == "count":
        return c, torch.ones(n, dtype=torch.bool, device=lo.device)
    ok = (c > 0) & ~empty
    if what == "nonempty":
        return None, ok
    z = torch.zeros((), dtype=cum.dtype, device=cum.device)
    s = torch.where(empty, z, cum[hi_c] - torch.where(lo > 0, cum[lo_c], z))
    if what == "sum":
        return s, ok
    return s.to(_F64) / torch.clamp(c, min=1).to(_F64), ok


def frame_agg(what: str, cum, ccnt, lo, hi):
    """K15 aggregate-entry wrapper, as `frame_agg_plain`."""
    if _on_cpu(lo):
        return frame_agg_plain(what, cum, ccnt, lo, hi)
    ck = _ck()
    n = lo.shape[0]
    _check("frame_agg", n, ccnt, lo, hi, dtype=_I64)
    if what in ("sum", "avg"):
        if cum is None or cum.dtype not in (_I64, _F64):
            raise ck.KernelError("frame_agg: an int64/float64 prefix "
                                 "expected")
        _check("frame_agg", n, cum)
    else:
        cum = None
    out = None
    if what != "nonempty":
        dt = _F64 if what == "avg" else (cum.dtype if what == "sum"
                                         else _I64)
        out = torch.empty(n, dtype=dt, device=lo.device)
    ok = torch.empty(n, dtype=torch.bool, device=lo.device)
    rc = ck.library("window_frame").tt_frame_agg(
        _ptr(cum), int(cum is not None and cum.dtype == _F64),
        ccnt.data_ptr(), lo.data_ptr(), hi.data_ptr(), n, _AGGS[what],
        _ptr(out), ok.data_ptr(), ck.stream_ptr(lo.device))
    if n > 0:
        ck.count("frame_eval")
    ck.check(rc, "frame_agg")
    return out, ok


def frame_gather_plain(vals, valid, base, d: int, lo_lim, hi_lim,
                       fill=None):
    """Plain torch version of K15's gather entry → (out, out_valid):
    pos = (base, or the row index when None) + d, in bounds where
    lo_lim <= pos <= hi_lim (a None limit: no test). With fill =
    (fill_vals, fill_valid) (columns or 0-d): out-of-bounds rows take the
    fill (the reference's shifted); without: every row gathers at
    clip(pos) and its validity is valid[clip(pos)] & in-bounds (frame_value,
    nth_value). valid None: every row valid."""
    n = vals.shape[0]
    pos = torch.arange(n, dtype=_I64, device=vals.device) if base is None \
        else base
    pos = pos + int(d)
    ok = torch.ones(n, dtype=torch.bool, device=vals.device)
    if lo_lim is not None:
        ok &= pos >= lo_lim
    if hi_lim is not None:
        ok &= pos <= hi_lim
    pc = pos.clamp(0, n - 1)
    v = vals[pc]
    m = torch.ones_like(ok) if valid is None else valid[pc]
    if fill is None:
        return v, m & ok
    fv, fm = fill
    return torch.where(ok, v, fv.to(v.dtype)), torch.where(ok, m, fm)


def frame_gather(vals, valid, base, d: int, lo_lim, hi_lim, fill=None):
    """K15 gather-entry wrapper, as `frame_gather_plain` (values of any
    1/2/4/8-byte dtype)."""
    if _on_cpu(vals):
        return frame_gather_plain(vals, valid, base, d, lo_lim, hi_lim, fill)
    ck = _ck()
    n = vals.shape[0]
    _check("frame_gather", n, vals)
    _check("frame_gather", n, valid, dtype=torch.bool)
    _check("frame_gather", n, base, lo_lim, hi_lim, dtype=_I64)
    es = vals.element_size()
    fv = fm = None
    if fill is not None:
        fv = fill[0].to(vals.dtype).contiguous()
        fm = fill[1].to(torch.bool).contiguous()
        for t in (fv, fm):
            ck.require_cuda(t, what="frame_gather")
            if t.dim() > 1 or t.numel() not in (1, n):
                raise ck.KernelError("frame_gather: a fill is a scalar or "
                                     "a column")
    out_v = torch.empty_like(vals)
    out_m = torch.empty(n, dtype=torch.bool, device=vals.device)
    rc = ck.library("window_frame").tt_frame_gather(
        vals.data_ptr(), es, _ptr(valid), _ptr(base), int(d), _ptr(lo_lim),
        _ptr(hi_lim), n, _ptr(fv), int(fv is not None and fv.numel() > 1),
        _ptr(fm), int(fm is not None and fm.numel() > 1), out_v.data_ptr(),
        out_m.data_ptr(), ck.stream_ptr(vals.device))
    if n > 0:
        ck.count("frame_eval")
    ck.check(rc, "frame_gather")
    return out_v, out_m


def frame_minmax_plain(vals, valid, is_max: bool, lo, hi, width: int):
    """Plain torch version of K15's bounded MIN/MAX: the reference's
    doubling sparse table over valid ? vals : identity (levels up to
    floor(log2 width), two overlapping lookups per row); the identity for
    an empty frame."""
    n = vals.shape[0]
    ident = _ident(is_max, vals.dtype)
    masked = torch.where(valid, vals, torch.full_like(vals, ident))
    op = torch.maximum if is_max else torch.minimum
    K = max(int(width).bit_length() - 1, 0)
    tables = [masked]
    for k in range(K):
        step = 1 << k
        shifted_ = torch.cat([tables[-1][step:], torch.full(
            (min(step, n),), ident, dtype=vals.dtype, device=vals.device)])
        tables.append(op(tables[-1], shifted_[:n]))
    w = torch.clamp(hi - lo + 1, min=1)
    kk = torch.zeros(n, dtype=_I64, device=vals.device)
    for k in range(1, K + 1):
        kk = torch.where(w >= (1 << k), torch.full_like(kk, k), kk)
    flat = torch.stack(tables).reshape(-1)
    a = flat[kk * n + lo.clamp(0, n - 1)]
    b = flat[kk * n + (hi - (1 << kk) + 1).clamp(0, n - 1)]
    return torch.where(hi < lo, torch.full_like(vals, ident), op(a, b))


def frame_minmax(vals, valid, is_max: bool, lo, hi, width: int):
    """K15 bounded MIN/MAX wrapper, as `frame_minmax_plain` (int32, int64
    and float64 values): a frame of at most tt_frame_direct_width() rows
    loops over its rows, a wider one builds the sparse table."""
    if _on_cpu(vals):
        return frame_minmax_plain(vals, valid, is_max, lo, hi, width)
    ck = _ck()
    n = vals.shape[0]
    if vals.dtype not in (torch.int32, _I64, _F64):
        raise ck.KernelError(f"frame_minmax: dtype {vals.dtype}")
    _check("frame_minmax", n, vals)
    _check("frame_minmax", n, valid, dtype=torch.bool)
    _check("frame_minmax", n, lo, hi, dtype=_I64)
    lib = ck.library("window_frame")
    table = None
    if width > lib.tt_frame_direct_width():
        table = torch.empty((int(width).bit_length(), n), dtype=vals.dtype,
                            device=vals.device)
    ident = _ident(is_max, vals.dtype)
    out = torch.empty_like(vals)
    rc = lib.tt_frame_minmax(
        vals.data_ptr(), _KDT[vals.dtype], valid.data_ptr(), int(is_max),
        0 if vals.dtype == _F64 else int(ident), float(ident), lo.data_ptr(),
        hi.data_ptr(), n, int(width), _ptr(table), out.data_ptr(),
        ck.stream_ptr(vals.device))
    if n > 0:
        ck.count("frame_eval")
    ck.check(rc, "frame_minmax")
    return out


# -- compute over the kernels ------------------------------------------------

def _default_bounds(pos: Positions, has_order: bool):
    """The default frame: the partition start to the current peer
    group's end with ORDER BY, the whole partition without."""
    return pos.ppos, (pos.peer_hi if has_order else pos.plast)


def _frame_agg_torch(name, vals, valid, lo, hi):
    if name not in ("count", "sum", "avg"):
        raise AssertionError(f"unsupported framed window aggregate {name}")
    cum, ccnt = window_prefix(None if name == "count" else vals, valid)
    return frame_agg(name, cum, ccnt, lo, hi)


def _minmax_torch(name, vals, valid, pstart, lo, hi, pre, post,
                  rows_frame: bool):
    is_max = name == "max"
    dt = vals.dtype
    v = _wide(vals)
    _, ok = frame_agg("nonempty", None, window_prefix(None, valid)[1],
                      lo, hi)
    if rows_frame and pre is not None and post is not None:
        out = frame_minmax(v, valid, is_max, lo, hi, int(pre) + int(post) + 1)
    elif rows_frame and pre is not None:
        # [lo, partition end]: the backward scan, read at lo
        scan = window_segscan(v, valid, pstart, is_max, reverse=True)
        out = frame_gather(scan, None, lo, 0, None, None)[0]
    else:
        # [partition start, hi]: the forward scan, read at hi
        scan = window_segscan(v, valid, pstart, is_max)
        out = frame_gather(scan, None, hi, 0, None, None)[0]
    return (out if out.dtype == dt else out.to(dt)), ok


def _value_torch(name, vals, valid, pos: Positions, has_order: bool,
                 frame, range_bounds, nth: int = 1):
    """FIRST_VALUE / LAST_VALUE / NTH_VALUE: K15 gathers at the frame
    edge ((pre, post) of a ROWS frame or RANGE bounds (lo, hi); neither:
    the default frame)."""
    if range_bounds is not None:
        lo, hi = range_bounds
    elif frame is not None:
        lo, hi = frame_bounds(pos, *frame)
    else:
        lo, hi = _default_bounds(pos, has_order)
        if name != "nth_value":
            base = lo if name == "first_value" else hi
            return frame_gather(vals, valid, base, 0, None, None)
    if name == "nth_value":
        return frame_gather(vals, valid, lo, nth - 1, None, hi)
    if name == "first_value":
        return frame_gather(vals, valid, lo, 0, None, hi)
    return frame_gather(vals, valid, hi, 0, lo, None)


def _shifted_torch(vals, valid, pos: Positions, offset: int, fill):
    """LAG (offset > 0) / LEAD (offset <= 0) within partitions."""
    if offset > 0:
        return frame_gather(vals, valid, None, -offset, pos.ppos, None, fill)
    return frame_gather(vals, valid, None, -offset, None, pos.plast, fill)


def _compute_torch(name, vals, valid, pstart, peerstart, has_order: bool,
                   offset: int = 1, fill=None, frame=None, range_key=None,
                   positions=None, sorted_key: bool = False):
    """compute's torch branch: K12 positions once, then K13-K15."""
    pos = positions if positions is not None else \
        window_positions(pstart, peerstart)
    n = pos.ppos.shape[0]
    if name in _RANKS:
        ones = torch.ones(n, dtype=torch.bool, device=pos.ppos.device)
        return frame_rank(name, pos, offset), ones
    if name in ("lag", "lead"):
        return _shifted_torch(vals, valid, pos,
                              offset if name == "lag" else -offset, fill)
    rows_fr = range_bounds = None
    pre = post = None
    if frame is not None:
        tag, pre, post = frame
        if tag == "range":
            okey, ovalid, desc = range_key
            range_bounds = frame_bounds(pos, pre, post, (okey, ovalid, desc),
                                        sorted_key)
        else:
            rows_fr = (pre, post)
    if name in ("first_value", "last_value", "nth_value"):
        return _value_torch(name, vals, valid, pos, has_order, rows_fr,
                            range_bounds, offset)
    if range_bounds is not None:
        lo, hi = range_bounds
    elif rows_fr is not None:
        lo, hi = frame_bounds(pos, pre, post)
    else:
        lo, hi = _default_bounds(pos, has_order)
    if name in ("min", "max"):
        if range_bounds is not None:
            raise AssertionError(
                f"unsupported RANGE-framed window aggregate {name}")
        return _minmax_torch(name, vals, valid, pstart, lo, hi, pre, post,
                             rows_fr is not None)
    return _frame_agg_torch(name, vals, valid, lo, hi)

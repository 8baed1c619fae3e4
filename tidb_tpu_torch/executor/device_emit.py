"""Device emission helpers for the fragment programs.

One implementation of the root reductions — grouped aggregation (sort-
factorize or stats-informed perfect-hash), ORDER BY / TopN, window
evaluation and row roots — used by the linear-chain fragment programs
(executor/fragment.py) and the join-tree programs
(executor/tree_fragment.py).
The reference splits the same logic between executor/aggregate.go and
unistore's cophandler/mpp_exec.go.

All helpers are functions of (ctx, live, plan node) over torch tensors on
the fragment's device: `ctx` is an expression EvalContext whose namespace
is ops/xp.TorchXP, `live` the row-liveness mask (the sel vector analog).
They run eagerly; the hot row-scale loops are hand-written CUDA kernels
(K1 segment_reduce under every aggregate state update, K2 unpack_decode
in emit_decode, K3 perfect_group_ids in _perfect_groups, the sort
kernels K8-K10 under factorize / sort_perm / topn and the LIMIT
partition, ops/factorize.py, and the window kernels K12-K15 under
emit_window_cols, ops/window.py).
"""

from __future__ import annotations

from typing import List

import torch

from tidb_tpu_torch.expression import EvalContext
from tidb_tpu_torch.expression.aggfuncs import AggFunc
from tidb_tpu_torch.ops.xp import TorchXP


def emit_decode(layout, slab, cap: int):
    """Decode of one compressed column slab on the device:
    (words, mask_words[, dictvals | delta base]) → (vals, valid) in the
    logical dtype, through the K2 kernel (chunk/compress.py)."""
    from tidb_tpu_torch.chunk import compress
    return compress.decode_slab_torch(layout, slab, cap)


def emit_sort(keys, descs, live):
    """Full-sort permutation under ORDER BY semantics → (perm, n_live).
    Thin named wrapper over ops/factorize.sort_perm: direction + MySQL
    NULL ordering (NULLs first ASC, last DESC) behave identically on
    device and host."""
    from tidb_tpu_torch.ops import factorize as F
    return F.sort_perm(keys, descs, live)


def emit_topk(keys, descs, live, k: int):
    """Top-k row selection → (idx (k,), n_out)."""
    from tidb_tpu_torch.ops import factorize as F
    return F.topn(keys, descs, live, k)


def emit_root(ctx: EvalContext, live, root, aggs=None, group_cap: int = 0,
              key_bounds=None, slab_cap: int = 0):
    """Root reduction dispatch for one slab.

    → HashAgg: emit_agg's {keys, states, n_groups, slot_live};
      Limit/TopN/Sort: {cols, n_out} (gathered in output order, truncated
      to k for Limit/TopN); Window: emit_window's {cols, live}; any row
      root (Selection/Projection/Scan/Join): padded {cols, live}. Only
      the join-tree programs reach the LIMIT branch (the chain gate admits
      no LIMIT root), as in the JAX package."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.planner.physical import (PhysHashAgg, PhysLimit,
                                                 PhysSort, PhysTopN,
                                                 PhysWindow)
    if isinstance(root, PhysHashAgg):
        return emit_agg(ctx, live, root, aggs, group_cap, key_bounds)
    if isinstance(root, PhysLimit):
        # LIMIT pushdown (no ORDER BY): the first offset+count live rows
        # in row order — a stable partition of the live mask (one 1-bit
        # K8 pass), the degenerate keyless emit_topk
        n = live.shape[0]
        k = min(root.count + root.offset, slab_cap or n)
        idx = F.partition_perm(live)[:k]
        n_out = torch.clamp(live.sum().to(torch.int32), max=k)
        out_cols = [ctx.column(i) for i in range(len(root.schema))]
        return {"cols": [(v[idx], m[idx]) for v, m in out_cols],
                "n_out": n_out}
    if isinstance(root, (PhysTopN, PhysSort)):
        keys = [e.eval(ctx) for e in root.by]
        out_cols = [ctx.column(i) for i in range(len(root.schema))]
        if isinstance(root, PhysTopN):
            k = min(root.count + root.offset, slab_cap or live.shape[0])
            idx, n_out = emit_topk(keys, root.descs, live, k)
        else:
            idx, n_out = emit_sort(keys, root.descs, live)
        return {"cols": [(v[idx], m[idx]) for v, m in out_cols],
                "n_out": n_out}
    if isinstance(root, PhysWindow):
        return emit_window(ctx, live, root)
    out_cols = [ctx.column(i) for i in range(len(root.schema))]
    return {"cols": list(out_cols), "live": live}


def _xp_of(t: torch.Tensor) -> TorchXP:
    return TorchXP(t.device)


def emit_merge(root, aggs: List[AggFunc], group_cap: int, key_cols,
               states, slot_live):
    """Merge of stacked per-slab agg partials: re-factorize the
    concatenated partial keys under their slot_live masks (ragged caps
    are fine — dead slots map past the cap), sanitize dead slots to
    identities, scatter-merge states (AggFunc.merge is the same segment
    op as update — SURVEY A.4)."""
    from tidb_tpu_torch.ops import factorize as F
    xp = _xp_of(slot_live)
    cap = group_cap
    dev = slot_live.device
    if root.group_exprs:
        gids, n_final, rep = F.factorize(key_cols, slot_live, cap)
        gids = torch.where(slot_live, gids, torch.full_like(gids, cap))
        in_range = torch.arange(cap, device=dev) < n_final
        key_out = [(v[rep], m[rep] & in_range) for v, m in key_cols]
    else:
        gids = torch.where(slot_live,
                           torch.zeros_like(slot_live, dtype=torch.int32),
                           torch.full_like(slot_live, cap,
                                           dtype=torch.int32))
        n_final = torch.tensor(1, dtype=torch.int32, device=dev)
        key_out = []
    out_states = []
    for agg, partial in zip(aggs, states):
        clean = tuple(torch.where(slot_live, arr, torch.zeros_like(arr))
                      for arr in partial)
        st = agg.init(xp, cap)
        out_states.append(agg.merge(xp, st, gids, cap, clean))
    return {"keys": key_out, "states": out_states, "n_groups": n_final}


def emit_finalize(root, order_root, aggs: List[AggFunc], group_cap: int,
                  key_cols, states, slot_live):
    """Fused finalize: agg merge → finalize expressions → root ORDER BY /
    TopN on the device. Order keys referencing group keys read the merged
    key slots; keys referencing aggregate outputs evaluate AggFunc.final
    on the device (the fragment gate only admits count/sum/avg/min/max
    over narrow results).

    → {keys, states, n_groups, n_out}: keys/states gathered in output
    order (truncated to k for TopN); n_groups is the TRUE merged group
    count for the caller's capacity-ladder validation."""
    from tidb_tpu_torch.planner.physical import PhysTopN
    xp = _xp_of(slot_live)
    merged = emit_merge(root, aggs, group_cap, key_cols, states, slot_live)
    cap = group_cap
    live = torch.arange(cap, dtype=torch.int32,
                        device=slot_live.device) < merged["n_groups"]
    nk = len(root.group_exprs)
    okeys = []
    for e in order_root.by:
        if e.index < nk:
            v, m = merged["keys"][e.index]
        else:
            v, m = aggs[e.index - nk].final(
                xp, tuple(merged["states"][e.index - nk]))
        okeys.append((v, m & live))
    if isinstance(order_root, PhysTopN):
        k = min(order_root.count + order_root.offset, cap)
        idx, n_out = emit_topk(okeys, order_root.descs, live, k)
    else:
        idx, n_out = emit_sort(okeys, order_root.descs, live)
    keys_o = [(v[idx], m[idx]) for v, m in merged["keys"]]
    states_o = [tuple(a[idx] for a in st) for st in merged["states"]]
    return {"keys": keys_o, "states": states_o,
            "n_groups": merged["n_groups"], "n_out": n_out}


def emit_agg(ctx: EvalContext, live, root, aggs: List[AggFunc],
             group_cap: int, key_bounds=None):
    """Grouped-aggregation partial over one slab → {keys, states,
    n_groups, slot_live}. With `key_bounds` (per-group-key (lo, hi)
    domains) grouping is a direct packed code + segment ops — no sort
    (the perfect-hash path); otherwise sort-based factorize. ROLLUP and
    DISTINCT aggregates never reach the device (fragment gate)."""
    from tidb_tpu_torch.ops import factorize as F
    n = live.shape[0]
    cap = group_cap
    dev = live.device
    if root.group_exprs and key_bounds is not None:
        gids, n_groups, key_out, slot_live = _perfect_groups(
            ctx, live, root, cap, key_bounds)
    elif root.group_exprs:
        keys = [e.eval(ctx) for e in root.group_exprs]
        gids, n_groups, rep = F.factorize(keys, live, cap)
        # dead rows → out-of-range id: segment ops drop them, which is
        # required for order-sensitive states (first_row)
        gids = torch.where(live, gids, torch.full_like(gids, cap))
        slot_live = torch.arange(cap, dtype=torch.int32,
                                 device=dev) < n_groups
        key_out = [(v[rep], m[rep] & slot_live) for v, m in keys]
    else:
        gids = torch.where(live, torch.zeros(n, dtype=torch.int32,
                                             device=dev),
                           torch.full((n,), cap, dtype=torch.int32,
                                      device=dev))
        n_groups = torch.tensor(1, dtype=torch.int32, device=dev)
        key_out = []
        slot_live = torch.arange(cap, dtype=torch.int32, device=dev) < 1
    states = agg_states(ctx, live, root, aggs, gids, cap, n)
    return {"keys": key_out, "states": states, "n_groups": n_groups,
            "slot_live": slot_live}


# ---------------------------------------------------------------------------
# K3 perfect_group_ids: the per-row half of the perfect-hash grouping
# ---------------------------------------------------------------------------

MAX_PERFECT_KEYS = 4


def perfect_group_ids_plain(keys, live, bounds, strides, cap: int):
    """Plain torch version of K3's first entry: per key 0 for NULL else
    1 + clip(v, lo, hi) - lo, times its stride, summed → (n,) int32; cap
    for dead rows."""
    gid = torch.zeros(live.shape[0], dtype=torch.int64, device=live.device)
    for (v, m), (lo, hi), stride in zip(keys, bounds, strides):
        code = torch.where(m, v.to(torch.int64).clamp(lo, hi) - lo + 1,
                           torch.zeros_like(gid))
        gid = gid + code * stride
    return torch.where(live, gid, torch.full_like(gid, cap)).to(torch.int32)


def remap_group_ids_plain(raw, inv, cap: int):
    """Plain torch version of K3's second entry: inv[raw] for raw in
    [0, cap), else cap."""
    ok = (raw >= 0) & (raw < cap)
    safe = torch.where(ok, raw, torch.zeros_like(raw)).to(torch.int64)
    return torch.where(ok, inv[safe], torch.full_like(raw, cap))


def perfect_group_ids(keys, live, bounds, strides, cap: int):
    """K3 wrapper (packed ids): CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise on anything it does not take)."""
    if live.device.type == "cpu":
        return perfect_group_ids_plain(keys, live, bounds, strides, cap)
    import ctypes
    from tidb_tpu_torch.ops import cuda_kernels as ck
    k = len(keys)
    if not 1 <= k <= MAX_PERFECT_KEYS:
        raise ck.KernelError(f"perfect_group_ids: {k} keys (1..4 taken)")
    if not 0 < cap < 2 ** 31:
        raise ck.KernelError(f"perfect_group_ids: cap {cap} out of range")
    n = live.shape[0]
    flat = [t for v, m in keys for t in (v, m)]
    ck.require_cuda(live, *flat, what="perfect_group_ids")
    if live.dtype != torch.bool:
        raise ck.KernelError("perfect_group_ids: live must be bool")
    for v, m in keys:
        if v.dtype not in (torch.int64, torch.int32) or m.dtype != torch.bool:
            raise ck.KernelError("perfect_group_ids: keys must be int32/"
                                 "int64 values with bool masks")
        if v.shape != (n,) or m.shape != (n,) or v.device != live.device:
            raise ck.KernelError("perfect_group_ids: key shape/device "
                                 "mismatch")
    out = torch.empty(n, dtype=torch.int32, device=live.device)
    P4 = ctypes.c_void_p * k
    L4 = ctypes.c_longlong * k
    rc = ck.library("perfect_groups").tt_perfect_group_ids(
        k, P4(*[v.data_ptr() for v, _ in keys]),
        P4(*[m.data_ptr() for _, m in keys]),
        (ctypes.c_int * k)(*[int(v.dtype == torch.int64) for v, _ in keys]),
        L4(*[int(lo) for lo, _ in bounds]),
        L4(*[int(hi) for _, hi in bounds]),
        L4(*[int(s) for s in strides]), live.data_ptr(), n, cap,
        out.data_ptr(), ck.stream_ptr(live.device))
    ck.count("perfect_groups")
    ck.check(rc, "perfect_group_ids")
    return out


def remap_group_ids(raw, inv, cap: int):
    """K3 wrapper (remap through the compaction table)."""
    if raw.device.type == "cpu":
        return remap_group_ids_plain(raw, inv, cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(raw, inv, what="remap_group_ids")
    if raw.dtype != torch.int32 or inv.dtype != torch.int32:
        raise ck.KernelError("remap_group_ids: int32 tensors expected")
    if inv.shape[0] < cap or raw.device != inv.device:
        raise ck.KernelError("remap_group_ids: inv shorter than cap")
    out = torch.empty_like(raw)
    rc = ck.library("perfect_groups").tt_remap_group_ids(
        raw.data_ptr(), inv.data_ptr(), raw.shape[0], cap, out.data_ptr(),
        ck.stream_ptr(raw.device))
    ck.count("perfect_groups")
    ck.check(rc, "remap_group_ids")
    return out


def _perfect_groups(ctx: EvalContext, live, root, cap: int, key_bounds):
    """Stats-informed grouping without sorting: group-key domains are
    known small bounds (dictionary sizes / cached min-max), so the group
    id is a direct packed code and aggregation is pure segment ops — the
    device analog of the reference's hash table when NDV is low
    (executor/aggregate.go getGroupKey). cap == the packed key domain.
    Per row: K3 packs the codes, K1 counts slot occupancy, K3 remaps the
    codes through the compaction of the occupied slots (torch, over cap
    slots, not rows)."""
    from tidb_tpu_torch.ops import segment as seg
    dev = live.device
    keys = [e.eval(ctx) for e in root.group_exprs]
    strides, cards = [], []
    stride = 1
    for lo, hi in key_bounds:
        card = hi - lo + 2
        strides.append(stride)
        cards.append(card)
        stride *= card
    gids_raw = perfect_group_ids(keys, live, key_bounds, strides, cap)
    occupied = seg.segment_reduce("sum", live.to(torch.int32), gids_raw,
                                  cap) > 0
    # compact occupied slots to the front (a 1-bit sort over cap, not rows)
    from tidb_tpu_torch.ops.factorize import partition_perm
    perm = partition_perm(occupied)
    n_groups = occupied.sum().to(torch.int32)
    inv = torch.empty(cap, dtype=torch.int32, device=dev)
    inv[perm] = torch.arange(cap, dtype=torch.int32, device=dev)
    gids = remap_group_ids(gids_raw, inv, cap)
    slot_live = torch.arange(cap, dtype=torch.int32, device=dev) < n_groups
    # reconstruct key values from the packed slot code — no row gathers
    key_out = []
    for (v, m), (lo, hi), card, stride in zip(keys, key_bounds, cards,
                                              strides):
        c = (perm // stride) % card
        vals = (c - 1 + lo).to(v.dtype)
        key_out.append((vals, (c != 0) & slot_live))
    return gids, n_groups, key_out, slot_live


def agg_states(ctx, live, root, aggs, gids, cap: int, n: int):
    """Per-aggregate partial states over one slab."""
    xp = ctx.xp
    states = []
    for agg, desc in zip(aggs, root.aggs):
        if desc.args:
            v, m = desc.args[0].eval(ctx)
            v = xp.asarray(v)
            m = xp.asarray(m) & live
        else:
            v = torch.zeros(n, dtype=torch.int64, device=live.device)
            m = live
        st = agg.init(xp, cap)
        states.append(agg.update(xp, st, gids, cap, v, m))
    return states


# ---------------------------------------------------------------------------
# Window root
# ---------------------------------------------------------------------------


def emit_window(ctx: EvalContext, live, root):
    """Window root on the device: one sort per distinct (partition, order)
    spec, then the window kernels of ops/window.py (the whole-column
    reformulation of executor/window.go). → {cols, live} with the window
    outputs appended to the child columns."""
    n_child = len(root.children[0].schema)
    in_cols = [ctx.column(i) for i in range(n_child)]
    return {"cols": emit_window_cols(ctx, live, root, in_cols),
            "live": live}


def emit_window_cols(ctx: EvalContext, live, root, in_cols):
    """The window computation proper → the child's column list (None
    placeholders preserved) with one appended (value, mask) column per
    window spec. Shared by the window-ROOT emit above and the interior
    window of tree_fragment._TreeRun.emit, where the appended columns
    feed the operator above. Per distinct spec: sort_perm (K9 + K8) with
    `live` as an operand, K12's boundary flags over the sorted keys (a
    change of `live` starts a partition, so a filtered slab's dead rows
    never join a live partition) and K12's positions, kept for every
    window function of the spec; each value scatters back to row order
    through the permutation (a permutation: no two rows collide)."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    n = live.shape[0]
    out_cols = list(in_cols)
    layouts = {}
    for d in root.wdescs:
        lkey = repr((d.partition, d.order, d.descs))
        layout = layouts.get(lkey)
        if layout is None:
            pkeys = [e.eval(ctx) for e in d.partition]
            okeys = [e.eval(ctx) for e in d.order]
            perm, _ = F.sort_perm(pkeys + okeys,
                                  [False] * len(pkeys) + list(d.descs),
                                  live)
            pstart, peerstart = W.window_flags(perm, live, pkeys + okeys,
                                               len(pkeys))
            layout = (perm, pstart, peerstart,
                      W.window_positions(pstart, peerstart))
            layouts[lkey] = layout
        perm, pstart, peerstart, pos = layout
        v, m = _window_value(ctx, live, d, n, perm, pstart, peerstart, pos)
        back_v = torch.empty(n, dtype=v.dtype, device=v.device)
        back_v[perm] = v
        back_m = torch.empty(n, dtype=torch.bool, device=m.device)
        back_m[perm] = m
        out_cols.append((back_v, back_m & live))
    return out_cols


def _window_value(ctx, live, d, n, perm, pstart, peerstart, pos):
    """One window function over the sorted layout: its argument gathered
    through `perm` (NULLs and dead rows masked), then ops/window.compute."""
    from tidb_tpu_torch.ops import window as W
    from tidb_tpu_torch.types import TypeKind
    dev = live.device
    vals = valid = fill = None
    if d.args:
        v, m = d.args[0].eval(ctx)
        vals = v[perm]
        valid = (m & live)[perm]
    elif d.name not in ("row_number", "rank", "dense_rank"):
        vals = torch.zeros(n, dtype=torch.int64, device=dev)   # COUNT(*)
        valid = live[perm]
    if d.name in ("lag", "lead"):
        if d.default is not None and d.default.value is not None:
            fv = d.args[0].ftype.encode_value(d.default.value)
            fill = (torch.tensor(fv, dtype=vals.dtype, device=dev),
                    torch.tensor(True, device=dev))
        else:
            fill = (torch.zeros((), dtype=vals.dtype, device=dev),
                    torch.tensor(False, device=dev))
    if d.name == "avg" and d.args and \
            d.args[0].ftype.kind is TypeKind.DECIMAL:
        vals = vals.to(torch.float64) / d.args[0].ftype.decimal_multiplier
    frame = getattr(d, "frame", None)
    range_key = None
    if frame is not None and frame[0] == "range":
        kv, km = d.order[0].eval(ctx)
        range_key = (kv[perm], (km & live)[perm], bool(d.descs[0]))
    return W.compute(ctx.xp, d.name, vals, valid, pstart, peerstart,
                     bool(d.order), d.offset, fill, frame=frame,
                     range_key=range_key, positions=pos)

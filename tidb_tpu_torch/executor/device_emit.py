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
in emit_decode_many, K3 perfect_group_ids in _perfect_groups, the sort
kernels K8-K10 under factorize / sort_perm / topn and the LIMIT
partition, ops/factorize.py, the window kernels K12-K15 under
emit_window_cols, ops/window.py, K19 delta_merge under
emit_delta_merge, the tombstone rewrite of executor/delta.py, and K23
hash_partition under emit_partition, the staged exchange's scatter).
"""

from __future__ import annotations

from typing import List

import torch

from tidb_tpu_torch.expression import EvalContext
from tidb_tpu_torch.expression.aggfuncs import AggFunc
from tidb_tpu_torch.ops.xp import TorchXP


def emit_decode_many(items, cap: int):
    """Decode of compressed column slabs of one cap on the device, in one
    K2 call (chunk/compress.py): [(layout, (words, mask_words[, dictvals
    | delta base]))] → [(vals, valid)] in each logical dtype."""
    from tidb_tpu_torch.chunk import compress
    return compress.decode_slabs_torch(items, cap)


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


def emit_distinct(gids, v, m, live, n: int, keys, pairs_out: bool,
                  pair_cap: int = 0, vcols=None, group_cap=None):
    """Per-slab DISTINCT dedup for one aggregate argument tuple →
    (first_mask, pairs). `first_mask` marks the first live occurrence of
    each (group, value) pair — the state-update mask. With `pairs_out`,
    `pairs` is (cols, n_pairs): the deduped (group-keys, args...) tuples
    for the cross-slab host merge, truncated to `pair_cap` output slots
    (0 = no truncation). `vcols` is the raw per-arg (value, mask) column
    list shipped in the pair output — for multi-arg DISTINCT, `v` is a
    slab-local combined code that means nothing across slabs, so the
    pairs carry real values instead. The factorize itself ALWAYS runs at
    the full slab capacity so first_mask stays exact; only the pair
    OUTPUT arrays shrink — n_pairs reports the TRUE count, so the caller
    can detect a truncated pair set and resize through the capacity
    ladder. `group_cap` bounds `gids` (dead rows carry it). The pair
    output is one K18 gather of the key and argument columns through
    rep[:pc], cut to the slots below n_pairs."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops.gather import gather_columns
    first, _pg, n_pairs, rep = F.distinct_pair_factorize(
        gids, v, m, live, n, gid_cap=group_cap, want_pg=False)
    if not pairs_out:
        return first, None
    pc = min(pair_cap, n) if pair_cap else n
    cols = [(kv, km) for kv, km in keys]
    cols += [(av, None) for av, _am in (vcols if vcols is not None
                                        else [(v, m)])]
    return first, (gather_columns(cols, rep[:pc], n_pairs), n_pairs)


def emit_root(ctx: EvalContext, live, root, aggs=None, group_cap: int = 0,
              key_bounds=None, slab_cap: int = 0, pairs_out: bool = False,
              pair_cap: int = 0):
    """Root reduction dispatch for one slab.

    → HashAgg: emit_agg's {keys, states, n_groups, slot_live[, pairs]};
      Limit/TopN/Sort: {cols, n_out} (gathered in output order, truncated
      to k for Limit/TopN); Window: emit_window's {cols, live}; any row
      root (Selection/Projection/Scan/Join): padded {cols, live}. Only
      the join-tree programs reach the LIMIT branch (the chain gate admits
      no LIMIT root), as in the JAX package."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops.gather import gather_columns
    from tidb_tpu_torch.planner.physical import (PhysHashAgg, PhysLimit,
                                                 PhysSort, PhysTopN,
                                                 PhysWindow)
    if isinstance(root, PhysHashAgg):
        return emit_agg(ctx, live, root, aggs, group_cap, key_bounds,
                        pairs_out=pairs_out, pair_cap=pair_cap)
    if isinstance(root, PhysLimit):
        # LIMIT pushdown (no ORDER BY): the first offset+count live rows
        # in row order — a stable partition of the live mask (one 1-bit
        # K8 pass), the degenerate keyless emit_topk
        n = live.shape[0]
        k = min(root.count + root.offset, slab_cap or n)
        idx = F.partition_perm(live)[:k]
        n_out = torch.clamp(live.sum().to(torch.int32), max=k)
        return {"cols": gather_columns(_out_cols(ctx, root), idx),
                "n_out": n_out}
    if isinstance(root, (PhysTopN, PhysSort)):
        keys = [e.eval(ctx) for e in root.by]
        if isinstance(root, PhysTopN):
            k = min(root.count + root.offset, slab_cap or live.shape[0])
            idx, n_out = emit_topk(keys, root.descs, live, k)
        else:
            idx, n_out = emit_sort(keys, root.descs, live)
        return {"cols": gather_columns(_out_cols(ctx, root), idx),
                "n_out": n_out}
    if isinstance(root, PhysWindow):
        return emit_window(ctx, live, root)
    out_cols = [ctx.column(i) for i in range(len(root.schema))]
    return {"cols": list(out_cols), "live": live}


def _out_cols(ctx: EvalContext, root):
    """A row root's output columns as contiguous (value, mask) pairs, as
    K18 takes them."""
    return [tuple(t.contiguous() for t in ctx.column(i))
            for i in range(len(root.schema))]


def emit_batched(prog, b: int, cols, n_rows: int, stacked_preps):
    """Same-plan micro-batching: one filter-rooted program's per-slab
    partial for `b` queued statements at once. The reference vmaps the
    traced partial over a leading member axis of the stacked prepared
    inputs; here the chain runs ONCE over the slab (decode, and so K2,
    shared by every member) and the members' stacked ParamExpr values,
    `[b, 1]` each, broadcast through the comparisons and the logical ops
    to a `[b, cap]` live mask. Only filters are parametrized, so every
    output column stays `[cap]`, shared by the members.
    → {"cols": [(v, m)] each [cap], "live": [b, cap]}."""
    ctx, live = prog._eval_chain(cols, n_rows, stacked_preps)
    out = emit_root(ctx, live, prog.root, slab_cap=prog.slab_cap)
    for v, m in out["cols"]:
        assert v.dim() == 1 and m.dim() == 1, \
            "a batched output column carries a member axis"
    live = out["live"]
    assert tuple(live.shape) == (b, prog.slab_cap), tuple(live.shape)
    return {"cols": out["cols"], "live": live}


def emit_partition(keys, arrays, live, n_shards: int, bucket_cap: int):
    """Per-rank bucket scatter — stage 1 of the staged exchange.

    ONE rank's rows land in `n_shards` fixed-capacity destination
    buckets, ready for a device→host checkpoint and host routing
    (parallel/collective.route_buckets). The destination is the hash of
    the exchange keys (collective.shard_of(mix_key_code(keys))), computed
    with the scatter in one kernel (K23, ops/partition.py). Rows are
    ranked densely and stably per destination; rows past bucket_cap are
    dropped and `need` (= counts.max()) reports the true per-bucket
    requirement for the capacity ladder's ONE exact resize.

    keys: [(values, validity)]; arrays: per-row payload [(N,)...];
    live: (N,) bool. → (bufs [(n_shards*bucket_cap,)...], sent_live,
    counts (n_shards,), need ()). Within bucket d the prefix
    [0:counts[d]] is contiguous live rows in source order."""
    from tidb_tpu_torch.ops.partition import hash_partition
    return hash_partition(keys, live, arrays, n_shards, bucket_cap)


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
    from tidb_tpu_torch.ops.gather import gather_columns
    xp = _xp_of(slot_live)
    cap = group_cap
    dev = slot_live.device
    if root.group_exprs:
        gids, n_final, rep = F.factorize(key_cols, slot_live, cap)
        gids = torch.where(slot_live, gids, torch.full_like(gids, cap))
        key_out = gather_columns(key_cols, rep, n_final)
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
    from tidb_tpu_torch.ops.gather import gather
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
    # one K18 call: the keys with their masks, the states without
    flat = [a for st in merged["states"] for a in st]
    keys_o, flat_o = gather(merged["keys"], idx, values=flat)
    it = iter(flat_o)
    states_o = [tuple(next(it) for _a in st) for st in merged["states"]]
    return {"keys": keys_o, "states": states_o,
            "n_groups": merged["n_groups"], "n_out": n_out}


def _rows(col, n: int):
    """A (value, mask) pair as two contiguous (n,) tensors (a constant
    expression evaluates to 0-d ones)."""
    return tuple(torch.broadcast_to(t, (n,)).contiguous() for t in col)


def emit_agg(ctx: EvalContext, live, root, aggs: List[AggFunc],
             group_cap: int, key_bounds=None, pairs_out: bool = False,
             pair_cap: int = 0):
    """Grouped-aggregation partial over one slab → {keys, states,
    n_groups, slot_live}. With `key_bounds` (per-group-key (lo, hi)
    domains) grouping is a direct packed code + segment ops — no sort
    (the perfect-hash path); otherwise sort-based factorize.

    WITH ROLLUP tiles the columns the aggregate reads (nk+1)x (K17) and
    groups over the keys plus a trailing grouping-level key column.
    DISTINCT aggregates keep only each (group, value) pair's first row
    (emit_distinct). With `pairs_out`, the result gains "pairs": {agg_idx:
    (cols, n_pairs)} — the deduped (group-keys, value) tuples of every
    DISTINCT agg, for the cross-slab host merge
    (fragment._merge_distinct_states). The pair factorize runs ONCE per
    distinct agg and serves both the state mask and the pair output."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops.gather import gather_columns
    n = live.shape[0]
    cap = group_cap
    dev = live.device
    if root.group_exprs and getattr(root, "rollup", False):
        # WITH ROLLUP: copy l of the tiled slab rolls up the LAST l group
        # keys (validity masked off, so the rolled-up key is NULL for
        # free) and a grouping-level column joins the factorize keys
        # LAST, keeping a genuinely-NULL key group apart from the
        # super-aggregate over it. key_out carries the level column as a
        # trailing internal column: emit_merge and the host merges group
        # over ALL key columns, and the result decode reads only the first nk.
        ctx, live = _rollup_tile(ctx, live, root)
        n = live.shape[0]
        nk = len(root.group_exprs)
        keys = [_rows(e.eval(ctx), n) for e in root.group_exprs]
        lev, masks = rollup_levels([m for _v, m in keys], n // (nk + 1))
        keys = [(v, mm) for (v, _m), mm in zip(keys, masks)]
        fkeys = keys + [(lev, None)]
        gids, n_groups, rep = F.factorize(fkeys, live, cap)
        gids = torch.where(live, gids, torch.full_like(gids, cap))
        key_out = gather_columns(fkeys, rep, n_groups)
        slot_live = torch.arange(cap, dtype=torch.int32,
                                 device=dev) < n_groups
    elif root.group_exprs and key_bounds is not None:
        keys, gids, n_groups, key_out, slot_live = _perfect_groups(
            ctx, live, root, cap, key_bounds)
    elif root.group_exprs:
        keys = [_rows(e.eval(ctx), n) for e in root.group_exprs]
        gids, n_groups, rep = F.factorize(keys, live, cap)
        # dead rows → out-of-range id: segment ops drop them, which is
        # required for order-sensitive states (first_row)
        gids = torch.where(live, gids, torch.full_like(gids, cap))
        slot_live = torch.arange(cap, dtype=torch.int32,
                                 device=dev) < n_groups
        key_out = gather_columns(keys, rep, n_groups)
    else:
        keys = []
        gids = torch.where(live, torch.zeros(n, dtype=torch.int32,
                                             device=dev),
                           torch.full((n,), cap, dtype=torch.int32,
                                      device=dev))
        n_groups = torch.tensor(1, dtype=torch.int32, device=dev)
        key_out = []
        slot_live = torch.arange(cap, dtype=torch.int32, device=dev) < 1
    dvals, dfirst, dpairs = {}, {}, {}
    for ai, desc in enumerate(root.aggs):
        if not (desc.distinct and desc.args):
            continue
        v, m, vcols = _distinct_arg(ctx, live, desc)
        dvals[ai] = (v, m)
        first, pairs = emit_distinct(gids, v, m, live, n, keys, pairs_out,
                                     pair_cap, vcols=vcols, group_cap=cap)
        dfirst[ai] = first
        if pairs is not None:
            dpairs[ai] = pairs
    states = agg_states(ctx, live, root, aggs, gids, cap, n,
                        distinct_first=dfirst, distinct_vals=dvals)
    out = {"keys": key_out, "states": states, "n_groups": n_groups,
           "slot_live": slot_live}
    if pairs_out:
        out["pairs"] = dpairs
    return out


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
    occupied = seg.segment_reduce("sum", live, gids_raw, cap,
                                  torch.int32) > 0
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
    return keys, gids, n_groups, key_out, slot_live


# ---------------------------------------------------------------------------
# K17 rollup_tile: WITH ROLLUP level replication
# ---------------------------------------------------------------------------

#: columns per tile launch / keys per levels launch (csrc/rollup_tile.cu)
MAX_TILE_COLS = 64
MAX_ROLLUP_KEYS = 32


def rollup_tile_plain(cols, reps: int):
    """Plain torch version of K17's tile entry: each column (1-D, or 2-D
    limb planes) concatenated `reps` times along its last axis."""
    return [torch.cat([c] * reps, dim=-1) for c in cols]


def rollup_levels_plain(masks, n0: int):
    """Plain torch version of K17's levels entry → (lev int64 (nk+1)·n0,
    [m & (lev < nk - i)])."""
    nk = len(masks)
    dev = masks[0].device if masks else torch.device("cpu")
    lev = torch.arange(nk + 1, dtype=torch.int64,
                       device=dev).repeat_interleave(n0)
    return lev, [m & (lev < nk - i) for i, m in enumerate(masks)]


def rollup_tile(cols, reps: int):
    """K17 wrapper (tile): CPU tensors take the plain version; CUDA
    tensors launch the kernel over the whole column table (or raise on
    anything it does not take)."""
    if not cols or cols[0].device.type == "cpu":
        return rollup_tile_plain(cols, reps)
    import ctypes
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(*cols, what="rollup_tile")
    n = cols[0].shape[-1]
    for c in cols:
        if c.dim() not in (1, 2) or c.shape[-1] != n or \
                c.element_size() not in (1, 2, 4, 8) or \
                c.device != cols[0].device:
            raise ck.KernelError("rollup_tile: 1-D or 2-D columns of one "
                                 "row count and 1/2/4/8-byte elements "
                                 "expected")
    if reps < 1:
        raise ck.KernelError("rollup_tile: reps >= 1 expected")
    dev = cols[0].device
    out = [torch.empty(c.shape[:-1] + (reps * n,), dtype=c.dtype,
                       device=dev) for c in cols]
    lib = ck.library("rollup_tile")
    for lo in range(0, len(cols), MAX_TILE_COLS):
        src, dst = cols[lo:lo + MAX_TILE_COLS], out[lo:lo + MAX_TILE_COLS]
        k = len(src)
        P = ctypes.c_void_p * k
        rc = lib.tt_rollup_tile(
            k, P(*[c.data_ptr() for c in src]),
            P(*[c.data_ptr() for c in dst]),
            (ctypes.c_longlong * k)(*[c.numel() // max(n, 1) if n else 0
                                      for c in src]),
            (ctypes.c_int * k)(*[c.element_size() for c in src]), n, reps,
            ck.stream_ptr(dev))
        if n > 0:
            ck.count("rollup_tile")
        ck.check(rc, "rollup_tile")
    return out


def rollup_levels(masks, n0: int):
    """K17 wrapper (levels), as `rollup_levels_plain`."""
    if not masks or masks[0].device.type == "cpu":
        return rollup_levels_plain(masks, n0)
    import ctypes
    from tidb_tpu_torch.ops import cuda_kernels as ck
    nk = len(masks)
    if nk > MAX_ROLLUP_KEYS:
        raise ck.KernelError(f"rollup_levels: {nk} keys (at most "
                             f"{MAX_ROLLUP_KEYS})")
    ck.require_cuda(*masks, what="rollup_levels")
    total = (nk + 1) * n0
    for m in masks:
        if m.dtype != torch.bool or m.shape != (total,):
            raise ck.KernelError("rollup_levels: bool masks over the tiled "
                                 "rows expected")
    dev = masks[0].device
    lev = torch.empty(total, dtype=torch.int64, device=dev)
    out = [torch.empty(total, dtype=torch.bool, device=dev) for _ in masks]
    P = ctypes.c_void_p * nk
    rc = ck.library("rollup_tile").tt_rollup_levels(
        nk, P(*[m.data_ptr() for m in masks]),
        P(*[m.data_ptr() for m in out]), n0, lev.data_ptr(),
        ck.stream_ptr(dev))
    if total > 0:
        ck.count("rollup_tile")
    ck.check(rc, "rollup_levels")
    return lev, out


def _rollup_tile(ctx: EvalContext, live, root):
    """Tile the slab (nk+1)x along the row axis for WITH ROLLUP level
    replication: `live` and the columns the group keys and the aggregate
    arguments read, in one K17 launch (wide-decimal limb planes are 2-D
    (limbs, rows) and tile along the last axis). The columns nothing
    reads stay None in the tiled context: expressions are row-wise, so
    the results are the reference's over fewer bytes."""
    reps = len(root.group_exprs) + 1
    read = set()
    for e in list(root.group_exprs) + [a for d in root.aggs
                                        for a in d.args]:
        read.update(e.references())
    n_cols = len(ctx._columns)
    idx = [i for i in sorted(read) if i < n_cols and
           ctx._columns[i] is not None]
    flat = [live]
    for i in idx:
        v, m = ctx._columns[i]
        flat += [v, m]
    tiled = rollup_tile([t.contiguous() for t in flat], reps)
    cols = [None] * n_cols
    for j, i in enumerate(idx):
        cols[i] = (tiled[1 + 2 * j], tiled[2 + 2 * j])
    ctx_t = EvalContext(ctx.xp, cols, dictionaries=ctx.dictionaries,
                        prepared=ctx.prepared, on_device=ctx.on_device,
                        n_rows=live.shape[0] * reps)
    return ctx_t, tiled[0]


def _distinct_arg(ctx: EvalContext, live, desc):
    """Evaluate a DISTINCT aggregate's argument tuple → (v, m, vcols).
    Single-arg: the value itself. Multi-arg (COUNT-only — the eligibility
    gates reject anything else): `v` is one combined dense code per row
    via factorize.dense_codes, so equal tuples dedup as one value within
    the slab, and `m` is the AND of the per-arg masks (MySQL skips rows
    where ANY DISTINCT argument is NULL). `vcols` keeps the raw per-arg
    (value, mask) columns for the cross-slab pair output — the combined
    code is slab-local and cannot be compared across slabs."""
    from tidb_tpu_torch.ops import factorize as F
    xp = ctx.xp
    vcols = []
    m = live
    for a in desc.args:
        av, am = _rows((xp.asarray(t) for t in a.eval(ctx)), live.shape[0])
        am = am & live
        vcols.append((av, am))
        m = m & am
    if len(vcols) == 1:
        return vcols[0][0], m, vcols
    return F.dense_codes(vcols, live), m, vcols


def agg_states(ctx, live, root, aggs, gids, cap: int, n: int,
               distinct_first, distinct_vals):
    """Per-aggregate partial states over one slab. A DISTINCT aggregate
    updates only at each (group, value) pair's first row: emit_agg
    evaluated its argument once (`distinct_vals[ai]` = (v, m)) and
    computed that mask (`distinct_first[ai]`)."""
    xp = ctx.xp
    states = []
    for ai, (agg, desc) in enumerate(zip(aggs, root.aggs)):
        if desc.distinct and desc.args:
            # keep only the first (group, value) occurrence
            v, m = distinct_vals[ai]
            m = m & distinct_first[ai]
        elif desc.args:
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
    `live` as an operand, then K12's `window_bounds`: the boundary
    flags over the sorted keys (a change of `live` starts a partition, so
    a filtered slab's dead rows never join a live partition; sort_perm
    lists the live rows first, so `n_live` marks that change) and the
    positions, kept for every
    window function of the spec. Every value of a layout goes back to row
    order in one K18 gather through the layout's inverse permutation (one
    K18 scatter of the slot numbers), the masks AND-ed with `live`."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import window as W
    from tidb_tpu_torch.ops.gather import gather_columns, inverse_permutation
    n = live.shape[0]
    out_cols = list(in_cols)
    layouts = {}
    results = {}            # layout key → [(output position, (v, m))]
    for d in root.wdescs:
        lkey = repr((d.partition, d.order, d.descs))
        layout = layouts.get(lkey)
        if layout is None:
            pkeys = [e.eval(ctx) for e in d.partition]
            okeys = [e.eval(ctx) for e in d.order]
            perm, n_live = F.sort_perm(pkeys + okeys,
                                       [False] * len(pkeys) + list(d.descs),
                                       live)
            pstart, peerstart, pos = W.window_bounds(
                perm, live, pkeys + okeys, len(pkeys), n_live)
            layout = (perm, n_live, pstart, peerstart, pos)
            layouts[lkey] = layout
        v, m = _window_value(ctx, live, d, n, *layout)
        results.setdefault(lkey, []).append(
            (len(out_cols), (v.contiguous(), m.contiguous())))
        out_cols.append(None)
    for lkey, got in results.items():
        inv = inverse_permutation(layouts[lkey][0], n)
        back = gather_columns([c for _at, c in got], inv, keep=live)
        for (at, _c), col in zip(got, back):
            out_cols[at] = col
    return out_cols


def _window_value(ctx, live, d, n, perm, n_live, pstart, peerstart, pos):
    """One window function over the sorted layout: its argument (and a
    RANGE frame's key) gathered through `perm` in one K18 call, NULLs and
    dead rows masked (the slots past n_live are the dead rows), then
    ops/window.compute."""
    from tidb_tpu_torch.ops import window as W
    from tidb_tpu_torch.ops.gather import gather_columns
    from tidb_tpu_torch.types import TypeKind
    dev = live.device
    vals = valid = fill = None
    frame = getattr(d, "frame", None)
    ranged = frame is not None and frame[0] == "range"
    cols = [_rows(d.args[0].eval(ctx), n)] if d.args else []
    if ranged:
        cols.append(_rows(d.order[0].eval(ctx), n))
    got = gather_columns(cols, perm, n_live) if cols else []
    if d.args:
        vals, valid = got[0]
    elif d.name not in ("row_number", "rank", "dense_rank"):
        vals = torch.zeros(n, dtype=torch.int64, device=dev)   # COUNT(*)
        valid = torch.arange(n, device=dev) < n_live
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
    range_key = (got[-1] + (bool(d.descs[0]),)) if ranged else None
    # K14's `sorted_key`: the layout sorts by the partition keys, then by
    # the ORDER BY key in its direction with NULLs first (ASC) or last
    # (DESC), with the dead rows last in partitions of their own; with
    # one ORDER BY key its peers are the runs of equal keys
    return W.compute(ctx.xp, d.name, vals, valid, pstart, peerstart,
                     bool(d.order), d.offset, fill, frame=frame,
                     range_key=range_key, positions=pos,
                     sorted_key=len(d.order) == 1)


# ---------------------------------------------------------------------------
# delta merge — tombstone compaction of one resident slab (K19)
# ---------------------------------------------------------------------------
# A delta extension (executor/delta.py) rewrites each base slab that new
# tombstones hit: the surviving rows stable-permute to the front (base
# row order is kept, so every column of the slab stays aligned) and the
# slab's live prefix shrinks to n_new. The permutation is computed ONCE
# per slab (K19 delta_perm) and every column reuses it: packed columns
# and packed validity masks repack through it (K19 delta_repack), raw
# columns gather through it (K18 gather_columns). Packed words live as
# their int32 view (chunk/compress.words_for_device).


def _int32_words(w):
    """int64 word values in [0, 2^32) → the int32 view of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_codes_plain(codes, width: int, cap: int):
    """Plain torch version of the reference's _emit_pack_codes: codes
    below 2^width (any integer dtype, `cap` of them) → the packed words,
    byte-identical to the host encoder (compress._pack_codes). Codes sit
    in disjoint bit ranges of their word, so the reduction is a plain
    sum with no carries. On the card this stage is fused into K19's
    delta_repack."""
    per = 32 // width
    n_words = -(-cap // per)
    c = codes.to(torch.int64)
    if n_words * per != cap:
        c = torch.cat([c, c.new_zeros(n_words * per - cap)])
    shifts = torch.arange(per, dtype=torch.int64, device=c.device) * width
    return _int32_words((c.reshape(n_words, per) << shifts).sum(dim=1))


def delta_perm_plain(keep):
    """Plain torch version of K19's delta_perm: argsort(~keep, stable)
    as int32 — kept rows first in row order, then the rest in order."""
    return torch.argsort((~keep).to(torch.int8), stable=True).to(torch.int32)


def delta_repack_plain(words, width: int, perm, n_new: int, cap: int):
    """Plain torch version of K19's delta_repack: the codes of a column
    packed at `width` bits, gathered through `perm`, zeroed at slots at
    or past n_new, and packed again."""
    from tidb_tpu_torch.chunk import compress
    codes = compress._unpack_codes_torch(words, width, cap)
    live = torch.arange(cap, device=codes.device) < n_new
    picked = torch.where(live, codes[perm.to(torch.int64)],
                         torch.zeros((), dtype=codes.dtype,
                                     device=codes.device))
    return pack_codes_plain(picked, width, cap)


def _refuse_diff_codes(layout) -> None:
    if layout is not None and layout.kind == "delta":
        from tidb_tpu_torch.errors import LayoutError
        raise LayoutError("delta-kind layouts cannot be rewritten in place "
                          "(their codes are successive differences)")


def delta_merge_plain(layout, slab, keep, n_new: int, cap: int):
    """Plain torch version of emit_delta_merge (the reference's
    device_emit.emit_delta_merge, value for value): `slab` is the
    resident device tuple of one column, `keep` bool (cap,), False at
    and past the slab's current row count, `n_new` = keep.sum(). → the
    rewritten tuple; a dict column's dictvals ride along as the same
    tensor, width 0 keeps its one-word stub."""
    _refuse_diff_codes(layout)
    perm = delta_perm_plain(keep).to(torch.int64)
    if layout is None:
        v, m = slab[0], slab[1]
        live = torch.arange(cap, device=m.device) < n_new
        return (v[..., perm], m[perm] & live)
    mwords = delta_repack_plain(slab[1], 1, perm, n_new, cap)
    vwords = slab[0] if layout.width == 0 else \
        delta_repack_plain(slab[0], layout.width, perm, n_new, cap)
    return (vwords, mwords) + tuple(slab[2:3] if layout.kind == "dict"
                                    else ())


def delta_perm(keep):
    """K19 wrapper (perm): CPU tensors take the plain version; a CUDA
    bool (cap,) launches the three-pass partition (or raises)."""
    if keep.device.type == "cpu":
        return delta_perm_plain(keep)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(keep, what="delta_perm")
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise ck.KernelError("delta_perm: a 1-D bool keep mask expected")
    n = keep.shape[0]
    dev = keep.device
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(-(-n // 1024) + 1, dtype=torch.int32, device=dev)
    rc = ck.library("delta_merge").tt_delta_perm(
        keep.data_ptr(), n, perm.data_ptr(), scratch.data_ptr(),
        ck.stream_ptr(dev))
    if n > 0:
        ck.count("delta_merge")
    ck.check(rc, "delta_perm")
    return perm


def delta_repack(words, width: int, perm, n_new: int, cap: int):
    """K19 wrapper (repack), as `delta_repack_plain`."""
    if words.device.type == "cpu":
        return delta_repack_plain(words, width, perm, n_new, cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(words, perm, what="delta_repack")
    if words.dtype != torch.int32 or perm.dtype != torch.int32 or \
            perm.shape != (cap,):
        raise ck.KernelError("delta_repack: int32 words and an int32 "
                             "permutation of the slab's capacity expected")
    n_out = -(-cap // (32 // width))
    if words.numel() < n_out:
        raise ck.KernelError("delta_repack: words shorter than the slab")
    out = torch.empty(n_out, dtype=torch.int32, device=words.device)
    rc = ck.library("delta_merge").tt_delta_repack(
        words.data_ptr(), words.numel(), width, perm.data_ptr(), cap,
        n_new, out.data_ptr(), n_out, ck.stream_ptr(words.device))
    if n_out > 0:
        ck.count("delta_merge")
    ck.check(rc, "delta_repack")
    return out


def emit_delta_merge(layout, slab, keep, n_new: int, cap: int, perm=None,
                     n_valid=None):
    """K19 wrapper: one column of one tombstoned slab, as
    `delta_merge_plain`. CPU slabs take the plain version; CUDA slabs
    reuse the slab's `perm` (delta_perm(keep), computed here when not
    given) and `n_valid` (n_new as a 0-d int32 tensor on the card):
    packed words and masks repack through K19, raw columns gather
    through K18 (`gather_slab`: a wide decimal's (n_limbs, cap) limb
    planes as 1-D columns of one launch), into tensors that own their
    storage, since the result is cached."""
    from tidb_tpu_torch.ops import gather as G
    if slab[1].device.type == "cpu":
        return delta_merge_plain(layout, slab, keep, n_new, cap)
    _refuse_diff_codes(layout)
    dev = slab[1].device
    if perm is None:
        perm = delta_perm(keep)
    if layout is None:
        if n_valid is None:
            n_valid = torch.tensor(n_new, dtype=torch.int32, device=dev)
        return G.gather_slab(slab[0], slab[1], perm, n_valid)
    mwords = delta_repack(slab[1], 1, perm, n_new, cap)
    vwords = slab[0] if layout.width == 0 else \
        delta_repack(slab[0], layout.width, perm, n_new, cap)
    return (vwords, mwords) + tuple(slab[2:3] if layout.kind == "dict"
                                    else ())

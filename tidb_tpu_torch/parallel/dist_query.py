"""Distributed query steps: a whole MPP task DAG over every rank at once.

The JAX package traces the fragment graph of a query — scan-filter, hash
exchange, join, two-phase aggregate — into one jitted shard_map program.
The port runs the same steps eagerly over rank lists (parallel/
collective.py): every rank's tensors live on one device, each collective
is one call over all ranks, and there is no program to trace.

`build_agg_join_step` is the flagship distributed step (the Q3 shape:
filter → hash-exchange join → grouped aggregate); `run_agg_join` drives
it through the exact-need capacity ladder.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tidb_tpu_torch.parallel import collective as C


def _xp(t: torch.Tensor):
    from tidb_tpu_torch.ops.xp import TorchXP
    return TorchXP(t.device)


def _local_grouped_sum(keys, live, values_list, cap: int):
    """One rank's partial aggregation: factorize + segment sums (the
    partial half of the reference's 2-phase HashAgg)."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import segment as seg
    xp = _xp(live)
    gids, n_groups, rep = F.factorize(keys, live, cap)
    gids = torch.where(live, gids, torch.full_like(gids, cap))
    sums = [seg.segment_sum(xp, torch.where(live, v, torch.zeros_like(v)),
                            gids, cap) for v in values_list]
    counts = seg.segment_sum(xp, live.to(torch.int64), gids, cap)
    slot_live = torch.arange(cap, dtype=torch.int32,
                             device=live.device) < n_groups
    key_out = [(v[rep], m[rep] & slot_live) for v, m in keys]
    # n_groups is the TRUE distinct count (factorize counts before
    # clamping) — the caller's ladder resizes to exact need in ONE step
    return key_out, sums, counts, slot_live, n_groups


def _owned_final_merge(gkeys, gsums, gcounts, gslot_live, cap: int,
                       n_shards: int, rank: int, owner=None):
    """Final phase on rank `rank`: merge the groups it owns (hash of the
    key VALUE, comparable across ranks — local factorize ids are not).
    `owner` is K26's owner of every gathered slot, the same for every
    rank, so the caller may compute it once."""
    from tidb_tpu_torch.ops import factorize as F
    from tidb_tpu_torch.ops import partition as P
    from tidb_tpu_torch.ops import segment as seg
    xp = _xp(gslot_live)
    if owner is None:
        owner = P.hash_dest(gkeys, n_shards)
    own = gslot_live & (owner == rank)
    gids, n_own, rep = F.factorize(gkeys, own, cap)
    gids = torch.where(own, gids, torch.full_like(gids, cap))
    f_sums = [seg.segment_sum(xp, torch.where(own, s, torch.zeros_like(s)),
                              gids, cap) for s in gsums]
    f_counts = seg.segment_sum(xp, torch.where(own, gcounts,
                                               torch.zeros_like(gcounts)),
                               gids, cap)
    out_live = torch.arange(cap, dtype=torch.int32,
                            device=own.device) < n_own
    f_keys = [(v[rep], m[rep] & out_live) for v, m in gkeys]
    return f_keys, f_sums, f_counts, out_live, n_own


def build_agg_join_step(mesh, bucket_cap: int, group_cap: int,
                        filter_limit: float):
    """The distributed step for the Q3 shape:

        SELECT b.g, SUM(p.x * b.w), COUNT(*)
        FROM probe p JOIN build b ON p.k = b.k
        WHERE p.q < filter_limit GROUP BY b.g

    → step(pk, px, pq, p_live, bk, bg, bw, b_live), each argument one
    tensor per rank (parallel.shard_rows): probe pk int64, px pq float,
    p_live bool; build bk bg int64, bw float, b_live bool. It returns,
    concatenated over the ranks in rank order, the group keys, their
    validity, sums, counts and live slots — each rank owns a disjoint
    subset of groups — plus two overflow flags: `need` (largest per-
    destination exchange row count; need > bucket_cap means rows were
    DROPPED) and `group_need` (largest per-rank true group count;
    group_need > group_cap means groups were conflated). run_agg_join is
    the ladder that re-executes with exact-need capacities.

    The steps: local filter, a hash exchange of BOTH sides on the key
    (K26 destinations, K24), a per-rank unique-build sort-probe join (J.combine_keys and
    sorted_probe_unique: K8-K11), the per-rank partial aggregate, the
    gather of partials (K25) and the value-owned final merge (K26, K1,
    K8-K10)."""
    from tidb_tpu_torch.ops import join as J
    from tidb_tpu_torch.ops import partition as P

    n_shards = len(mesh)

    def step(pk, px, pq, p_live, bk, bg, bw, b_live):
        nd = n_shards
        # 1. local scan filter (pushed-down selection)
        p_live2 = [p_live[r] & (pq[r] < filter_limit) for r in range(nd)]
        # 2. hash-exchange both sides so equal keys co-locate
        (rp, rp_live, p_over) = C.exchange(
            [[pk[r], px[r]] for r in range(nd)],
            [P.hash_dest(None, nd, code=pk[r]) for r in range(nd)],
            p_live2, nd, bucket_cap)
        (rb, rb_live, b_over) = C.exchange(
            [[bk[r], bg[r], bw[r]] for r in range(nd)],
            [P.hash_dest(None, nd, code=bk[r]) for r in range(nd)],
            b_live, nd, bucket_cap)
        part_keys, part_states, part_slot, p_ngs = [], [], [], []
        for r in range(nd):
            rpk, rpx = rp[r]
            rbk, rbg, rbw = rb[r]
            # 3. per-rank unique-build join via sort + binary search
            nb = rbk.shape[0]
            npr = rpk.shape[0]
            both = torch.cat([rbk, rpk])
            both_live = torch.cat([rb_live[r], rp_live[r]])
            codes, cvalid = J.combine_keys(
                [(both, torch.ones_like(both_live))], both_live)
            midx, matched, _uni = J.sorted_probe_unique(
                codes[:nb], cvalid[:nb], rb_live[r], codes[nb:],
                cvalid[nb:], rp_live[r],
                code_bound=(both_live.shape[0] + 1) ** 2)
            midx = midx.to(torch.int64)
            jg = rbg[midx]            # build-side group key per probe row
            jw = rbw[midx]            # build-side payload
            # 4. two-phase aggregate: partial by local groups…
            keys = [(jg, torch.ones(npr, dtype=torch.bool,
                                    device=jg.device))]
            pkeys, psums, pcounts, pslot, p_ng = _local_grouped_sum(
                keys, matched, [rpx * jw], group_cap)
            part_keys.append(pkeys)
            part_states.append([tuple(psums) + (pcounts,)])
            part_slot.append(pslot)
            p_ngs.append(p_ng)
        # …gather partials, merge owned groups
        gkeys, gstates, gslot = C.gather_partials(part_keys, part_states,
                                                  part_slot)
        gkeys, gstates, gslot = gkeys[0], gstates[0], gslot[0]
        owner = P.hash_dest(gkeys, nd)      # one owner hash for all ranks
        outs: List = []
        for r in range(nd):
            outs.append(_owned_final_merge(
                gkeys, [gstates[0][0]], gstates[0][1], gslot, group_cap,
                nd, r, owner=owner))
        need = torch.maximum(p_over, b_over).to(torch.int32)
        group_need = torch.stack(
            [torch.maximum(p_ngs[r].to(torch.int32),
                           outs[r][4].to(torch.int32))
             for r in range(nd)]).max()
        cat = torch.cat
        return (cat([o[0][0][0] for o in outs]),
                cat([o[0][0][1] for o in outs]),
                cat([o[1][0] for o in outs]), cat([o[2] for o in outs]),
                cat([o[3] for o in outs]), need, group_need)

    return step


def run_agg_join(mesh, pk, px, pq, bk, bg, bw, *, bucket_cap: int,
                 group_cap: int, filter_limit: float, p_live=None,
                 b_live=None, guard=None, max_bucket_cap: int = 1 << 22,
                 max_group_cap: int = 1 << 20):
    """Host-side escalation ladder around build_agg_join_step.

    Runs the distributed step and consumes its overflow flags: an
    exchange `need` or `group_need` past the current capacity triggers an
    exact-need resize + ONE re-execution per overflowed structure, each
    attempt charged against the ladder's backoff budget and
    guard-checkpointed between attempts. When a capacity limit is hit
    the ladder is exhausted and a typed CapacityError raises — truncated
    rows are never returned.

    → ({group_key: (sum, count)}, EscalationStats)."""
    from tidb_tpu_torch.errors import BackoffExhausted, CapacityError
    from tidb_tpu_torch.parallel import shard_rows
    from tidb_tpu_torch.util import failpoint
    from tidb_tpu_torch.util.escalation import CapacityLadder

    n, b = len(pk), len(bk)
    p_live = np.ones(n, dtype=bool) if p_live is None else p_live
    b_live = np.ones(b, dtype=bool) if b_live is None else b_live
    ladder = CapacityLadder(guard=guard)
    while True:
        if guard is not None:
            guard.check("device-dispatch")
        step = build_agg_join_step(mesh, bucket_cap=bucket_cap,
                                   group_cap=group_cap,
                                   filter_limit=filter_limit)
        args = shard_rows(mesh, [pk, px, pq, p_live, bk, bg, bw, b_live])
        kv, km, sums, counts, live, need, gneed = step(*args)
        flags = torch.stack([need.to(torch.int64),
                             gneed.to(torch.int64)]).cpu()
        need, gneed = int(flags[0]), int(flags[1])
        retry = False
        if need > bucket_cap:
            failpoint.inject("exchange-overflow")
            if bucket_cap >= max_bucket_cap:
                ladder.fallback("exchange")
                raise CapacityError(
                    f"exchange needs {need} rows/bucket but the ladder is "
                    f"exhausted (cap {bucket_cap}, limit {max_bucket_cap})")
            bucket_cap = ladder.resize("exchange", bucket_cap, need=need,
                                       max_cap=max_bucket_cap, lo=8)
            retry = True
        if gneed > group_cap:
            if group_cap >= max_group_cap:
                ladder.fallback("group")
                raise CapacityError(
                    f"aggregate needs {gneed} group slots but the ladder "
                    f"is exhausted (cap {group_cap}, "
                    f"limit {max_group_cap})")
            group_cap = ladder.resize("group", group_cap, need=gneed,
                                      max_cap=max_group_cap, lo=8)
            retry = True
        if not retry:
            break
        try:
            ladder.attempt("agg-join")
        except BackoffExhausted as e:
            ladder.fallback("budget")
            raise CapacityError(
                "distributed agg-join recompile budget exhausted") from e
    out = {}
    kv, km, sums, counts, live = (t.cpu().numpy()
                                  for t in (kv, km, sums, counts, live))
    for g, m, sv, c, lv in zip(kv, km, sums, counts, live):
        if lv and m:
            out[int(g)] = (float(sv), int(c))
    return out, ladder.stats


def reference_agg_join(pk, px, pq, bk, bg, bw, filter_limit):
    """Single-host numpy oracle for build_agg_join_step."""
    keep = pq < filter_limit
    bmap = {int(k): (int(g), float(w)) for k, g, w in zip(bk, bg, bw)}
    sums, counts = {}, {}
    for k, x, ok in zip(pk, px, keep):
        if not ok:
            continue
        hit = bmap.get(int(k))
        if hit is None:
            continue
        g, w = hit
        sums[g] = sums.get(g, 0.0) + float(x) * w
        counts[g] = counts.get(g, 0) + 1
    return sums, counts

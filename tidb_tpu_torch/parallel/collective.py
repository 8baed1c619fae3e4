"""The monolithic program's collectives, and the staged exchange's host
routing.

The collectives (`exchange`, `broadcast_build`, `gather_partials`) take
one entry per rank and return one entry per rank, with the reference's
shapes and contents (`tidb_tpu/parallel/collective.py`); every rank
lives in one process (executor/dist_fragment.DistTreeProgram), so a
collective is one function over every rank's tensors at once.
`lax.axis_index` is the position in the rank list and `lax.pmax` a max
over the ranks. On CUDA tensors the exchange is K24 and the all_gathers
K25; on CPU tensors their plain versions run. The exchange and the key
hash (`shard_of`, `mix_key_code`) live with their kernels in
ops/partition and are re-exported here.

`route_buckets` is the staged exchange's host routing, numpy as in the
JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tidb_tpu_torch.ops import rank_gather as RG
from tidb_tpu_torch.ops.partition import (  # noqa: F401 (re-exported)
    _mix64, key_canon, mix_key_code, shard_of)
from tidb_tpu_torch.ops.partition import (  # noqa: F401 (re-exported)
    rank_exchange as exchange, rank_exchange_plain as exchange_plain)


def broadcast_build(arrays, live):
    """Broadcast-join pattern: every rank receives the full build side —
    the ranks' columns and live masks concatenated in rank order (the
    tiled all_gather; K25 on CUDA tensors). arrays[r]: rank r's columns.
    → (columns, live), one entry per rank: every rank's entry is the
    same gathered tensors, which nothing may write in place."""
    nd = len(live)
    n_cols = len(arrays[0]) if nd else 0
    out = RG.rank_gather([[arrays[r][j] for r in range(nd)]
                       for j in range(n_cols)] + [list(live)])
    return [out[:-1]] * nd, [out[-1]] * nd


def gather_partials(key_cols, state_arrays, slot_live):
    """Two-phase aggregation exchange: every rank's partial keys
    [(values, validity)], states [tuple of arrays] and slot_live, each
    concatenated in rank order along the slot axis — ONE K25 launch for
    all of them on CUDA tensors. → (keys, states, slot_live), one entry
    per rank, every entry the same gathered tensors (read-only)."""
    nd = len(slot_live)
    flat_per_rank = []
    for r in range(nd):
        flat = [x for vm in key_cols[r] for x in vm]
        flat += [a for st in state_arrays[r] for a in st]
        flat.append(slot_live[r])
        flat_per_rank.append(flat)
    out = RG.rank_gather([[flat_per_rank[r][j] for r in range(nd)]
                       for j in range(len(flat_per_rank[0]))])
    nk = len(key_cols[0])
    keys = [(out[2 * k], out[2 * k + 1]) for k in range(nk)]
    states = []
    pos = 2 * nk
    for st in state_arrays[0]:
        states.append(tuple(out[pos:pos + len(st)]))
        pos += len(st)
    return [keys] * nd, [states] * nd, [out[-1]] * nd


def require_capacity(need: int, bucket_cap: int, what: str = "exchange"):
    """Host-side overflow guard for a bucket scatter WITHOUT a resize
    ladder: rows past bucket_cap were dropped, so ignoring the reported
    need silently loses rows. Raises a typed CapacityError instead."""
    from tidb_tpu_torch.errors import CapacityError
    if int(need) > int(bucket_cap):
        raise CapacityError(
            f"{what} needs {int(need)} rows/bucket but capacity is "
            f"{int(bucket_cap)}; rows would be silently dropped — resize "
            f"(escalation ladder) or raise the cap")


def route_buckets(checkpoints: Sequence[dict], n_shards: int):
    """Host-mediated bucket routing — the staged exchange's replacement
    for the monolithic program's all_to_all. `checkpoints[r]` is rank r's
    device→host checkpoint of its stage-1 partition output:

        {"bufs":   {col_idx: (values, validity)},   # n_shards*cap_r rows
         "counts": (n_shards,) int — live rows per destination bucket,
         "cap":    int — rank r's per-destination bucket capacity}

    Per-rank caps may differ (a skewed rank resizes alone — the exact-need
    ladder contract), so routing slices each source's buckets at ITS cap.
    Within bucket d the prefix [0:counts[d]] is contiguous live rows (the
    scatter ranks rows densely per destination), so the routed payload is
    front-packed by construction.

    Returns (routed, recv_rows): routed[d] = {col_idx: (values, validity)}
    concatenated over source ranks in rank order; recv_rows[d] = total live
    rows destined for rank d."""
    cols = list(checkpoints[0]["bufs"].keys()) if checkpoints else []
    routed = []
    recv_rows = []
    for d in range(n_shards):
        bufs = {}
        for i in cols:
            vs, ms = [], []
            for cp in checkpoints:
                cap = int(cp["cap"])
                k = int(cp["counts"][d])
                v, m = cp["bufs"][i]
                vs.append(np.asarray(v)[d * cap:d * cap + k])
                ms.append(np.asarray(m)[d * cap:d * cap + k])
            bufs[i] = (np.concatenate(vs) if vs else np.zeros(0),
                       np.concatenate(ms) if ms else np.zeros(0, bool))
        routed.append(bufs)
        recv_rows.append(int(sum(int(cp["counts"][d])
                              for cp in checkpoints)))
    return routed, recv_rows

"""Distributed device fragments over N ranks: the JAX package's staged
paths and its monolithic program.

The planner inserts PhysExchange boundaries (planner/physical.py
insert_exchanges — the fragmentation pass of planner/core/fragment.go:64)
and marks every `dist_ok` fragment `dist = N`. The staged paths take
what they take; DistTreeProgram, the monolithic program, runs the rest
(and everything when both staged flags are off).

In the staged paths every rank runs as an ordinary single-device program
on its device (parallel.make_mesh: on one GPU all ranks share `cuda:0`),
and the ranks meet only on the host, so no collective library is
involved:

  * Exchange-free agg fragments (a plain group-by) run via StagedDistAgg:
    each rank's local partial aggregation is dispatched as its own
    program, its result checkpointed device→host, and the final merge
    happens host-side over the checkpoints.
  * Exchange-carrying fragments (distributed joins, DISTINCT re-keys,
    windows) run via StagedDistExchange, cut at the exchange: stage 1
    runs each rank's scan→filter→partition as its own program producing
    per-destination bucket buffers (K23 hash_partition through
    device_emit.emit_partition); stage 2 checkpoints every rank's
    outgoing buckets device→host — committed before ANY rank's receive
    stage starts — and routes them host-side (collective.route_buckets);
    stage 3 runs each rank's receive/probe/dedup as ONE tree program over
    the routed buckets.

A shard fault re-executes ONLY the failed rank's stage: once on its own
device, then re-dispatched onto rank (r+1)'s device (degraded-mesh mode,
recorded as a retryable session warning; on one card that is the same
card) before one typed ShardFailure ends the ladder. Only a ShardFailure
(which a failpoint injects) is a shard fault: a CUDA, kernel or launch
error raises as it is (ROADMAP §3). Healthy ranks' checkpoints are never
recomputed (EscalationStats shards_rerun/shards_reused), and a bucket-cap
overflow resizes only the overflowed rank's buckets at the exact need.

DistTreeProgram is the JAX package's monolithic shard_map program, run
in one process: every rank lives on one device and runs its own
_TreeRun, an exchange is a barrier where all ranks meet, and the
collectives are device-side copies between the ranks' buffers (K24
rank_exchange, K25 rank_gather; K26 hash_dest computes an exchange's
destinations and the agg root's owners). Its
fault retry is full-step, as in the JAX package: the collectives
entangle every rank's state.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.executor.tree_fragment import (JOIN_OUT_CAP, TreeProgram,
                                                   _scans, _TreeRun,
                                                   _walk_nodes,
                                                   dictionary_flows,
                                                   escalate_join,
                                                   plan_join_configs,
                                                   tree_signature)
from tidb_tpu_torch.parallel import collective as C
from tidb_tpu_torch.planner.physical import (PhysExchange, PhysHashAgg,
                                             PhysHashJoin, PhysProjection,
                                             PhysSelection, PhysSort,
                                             PhysTableScan, PhysTopN,
                                             PhysicalPlan)


def _is_shard_fault(e: BaseException) -> bool:
    """Only an injected ShardFailure climbs the per-rank ladder; a real
    device error raises (the device rule: nothing hides the card)."""
    from tidb_tpu_torch.errors import ShardFailure
    return isinstance(e, ShardFailure)


def _upload_slab(t, dev):
    from tidb_tpu_torch.executor.device_cache import _upload
    return tuple(_upload(a, dev) for a in t)


def _warn_degraded(ctx, r: int, err: BaseException) -> None:
    """Degraded-mesh completion is a typed, retryable warning on the
    statement guard (surfaced by SHOW WARNINGS), NOT an error — the
    result is complete and exact; only the mesh shrank. One per
    RECOVERED rank."""
    from tidb_tpu_torch.errors import ShardFailure
    guard = getattr(ctx, "guard", None)
    if guard is not None and hasattr(guard, "warnings"):
        guard.warnings.append(
            ("Warning", ShardFailure.code,
             f"shard {r} persistently failed and was re-dispatched "
             f"onto a surviving device (degraded mesh, retryable): "
             f"{err}"))


def _run_rank(ctx, ladder, devices, r: int, attempt, degraded_site: str,
              redispatch_site: str):
    """One rank's stage through the per-shard recovery ladder.
    `attempt(device, site)` runs the stage once; only the failed rank
    climbs: retry on its device → re-dispatch onto rank (r+1)'s device →
    one typed ShardFailure."""
    from tidb_tpu_torch.errors import ShardFailure
    from tidb_tpu_torch.util import failpoint
    nd = len(devices)
    try:
        return attempt(devices[r], "shard-step")
    except Exception as e1:
        if not _is_shard_fault(e1):
            raise
        # rung 1: retry on the rank's own device. Healthy ranks'
        # checkpoints are untouched — only this rank re-runs.
        ctx.check_killed("shard-retry")
        ladder.shard_retry(e1)
        try:
            out = attempt(devices[r], "shard-step")
        except Exception as e2:
            if not _is_shard_fault(e2):
                raise
            # rung 2: the device is persistently bad — degraded-mesh mode:
            # re-plan this rank's slice onto a surviving device
            failpoint.inject(degraded_site)
            ctx.check_killed("shard-redispatch")
            ladder.redispatch(e2)
            spare = devices[(r + 1) % nd]
            try:
                out = attempt(spare, redispatch_site)
            except Exception as e3:
                if not _is_shard_fault(e3):
                    raise
                # ladder exhausted: ONE typed retryable error — the
                # store and session stay fully usable
                raise ShardFailure(
                    f"shard {r} failed on its device and on "
                    f"re-dispatch to a surviving device: {e3}") from e3
            _warn_degraded(ctx, r, e2)
        ladder.shard_resume(rerun=1, reused=nd - 1)
        return out


class StagedDistAgg:
    """Checkpointable staged execution of an exchange-free distributed
    agg fragment.

    Stages: per-rank local partial aggregation (one chain program per
    rank on the rank's device) → device-to-host checkpoint of each rank's
    (keys, states) partials → host-side final merge
    (fragment._merge_tree_agg_passes). The host slices in `rank_cols` are
    the recovery source of truth: on a shard fault only the failed rank's
    slice is re-uploaded and re-run (the ladder of `_run_rank`). Healthy
    ranks' checkpoints are reused untouched (shards_reused); a per-rank
    group-cap overflow re-runs only the overflowed ranks at the exact-need
    cap, like the single-device slab ladder. Every rank's device buffers
    are dropped before the next dispatch, so recovery never doubles
    device residency."""

    def __init__(self, root, chain, mesh, rank_cols, rank_rows, dicts,
                 used_cols, in_types, slab_cap: int, group_cap: int,
                 cap_limit: int, ctx, ladder, layouts=None,
                 skip_ranks=None):
        self.root = root
        self.chain = chain
        self.devices = list(mesh)
        self.nd = len(self.devices)
        self.rank_cols = rank_cols    # rank → {col: packed/raw arrays}
        self.rank_rows = rank_rows    # (nd,) int32 true per-rank rows
        self.dicts = dicts            # col → dictionary (collect_preps)
        self.used_cols = used_cols
        self.in_types = in_types
        self.slab_cap = slab_cap
        self.group_cap = group_cap
        self.cap_limit = cap_limit
        self.ctx = ctx
        self.ladder = ladder
        # col → ColLayout for compressed rank slabs (decoded by K2 inside
        # the per-rank chain partial)
        self.layouts = dict(layouts) if layouts else {}
        # rank ids zone-map pruning proved empty under the scan's
        # conjuncts: never uploaded, never dispatched — their
        # checkpoints are pre-filled with the ng=0 merge identity
        self.skip_ranks = frozenset(skip_ranks or ())

    def execute(self) -> List[dict]:
        """→ per-rank host checkpoints in rank order, each a pass_out
        {"ng", "keys", "states"} ready for _merge_tree_agg_passes.
        Pruned ranks carry the ng=0 identity checkpoint (the merge
        skips ng==0 passes)."""
        from tidb_tpu_torch.executor.fragment import (FragmentFallback,
                                                      _GroupCapOverflow)
        ckpts: List[Optional[dict]] = [None] * self.nd
        ng_true = [0] * self.nd
        caps_ran = [0] * self.nd
        for r in self.skip_ranks:
            ckpts[r] = {"ng": 0, "keys": [], "states": []}
        to_run = [r for r in range(self.nd) if r not in self.skip_ranks]
        while True:
            # between dispatch rounds is a guard checkpoint: a killed
            # query must not queue another per-rank program
            self.ctx.check_killed("device-dispatch")
            progs: Dict = {}
            for r in to_run:
                ckpts[r], ng_true[r] = _run_rank(
                    self.ctx, self.ladder, self.devices, r,
                    lambda dev, site, r=r: self._attempt(r, dev, progs,
                                                         site),
                    "degraded-mesh-replan", "shard-redispatch")
                caps_ran[r] = self.group_cap
            # overflow iff a rank's TRUE group count exceeded the cap IT
            # ran at (factorize counts before clamping); there is no
            # merged-count rung — the final merge is host-side, uncapped
            over = [r for r in range(self.nd) if ng_true[r] > caps_ran[r]]
            if not over:
                return ckpts
            if self.group_cap >= self.cap_limit:
                self.ladder.fallback("group")
                raise FragmentFallback("group cap overflow",
                                       reason="group-cap")
            need = max(ng_true[r] for r in over)
            self.group_cap = self.ladder.resize(
                "group", self.group_cap, need=need, max_cap=self.cap_limit)
            self.ladder.attempt("group", _GroupCapOverflow(need))
            self.ladder.partial_resume("group", rerun=len(over),
                                       reused=self.nd - len(over))
            to_run = over

    def _program(self, dev, progs: Dict):
        """The chain program on `dev` and its prepared inputs there, once
        per device per dispatch round."""
        from tidb_tpu_torch.executor.fragment import get_program
        got = progs.get(dev)
        if got is None:
            prog = get_program(self.chain, self.used_cols, self.in_types,
                               self.slab_cap, self.group_cap, dev,
                               layouts=self.layouts or None)
            got = progs[dev] = (prog, prog.collect_preps(self.dicts))
        return got

    def _attempt(self, r: int, dev, progs: Dict, site: str):
        """Upload rank r's host slice onto `dev`, run the partial there,
        fetch its checkpoint → ({"ng", "keys", "states"}, true_count)."""
        from tidb_tpu_torch.chunk import compress as _compress
        from tidb_tpu_torch.executor.fragment import _sync
        from tidb_tpu_torch.util import failpoint
        from tidb_tpu_torch.util.phases import to_host, tree_nbytes
        ph = self.ctx.phases
        dcols = None
        out = None
        try:
            failpoint.inject(site)
            prog, prep_vals = self._program(dev, progs)
            with ph.phase("upload"):
                dcols = {i: _upload_slab(self.rank_cols[r][i], dev)
                         for i in prog.used_cols}
            _rank_b = sum(a.nbytes for i in prog.used_cols
                          for a in self.rank_cols[r][i])
            _rank_lb = sum(
                (_compress.raw_slab_bytes(self.layouts[i], self.slab_cap)
                 if self.layouts.get(i) is not None
                 else sum(a.nbytes for a in self.rank_cols[r][i]))
                for i in prog.used_cols)
            ph.add_h2d(_rank_b, logical=_rank_lb)
            # the rank's partial streams these slabs
            ph.add_scan(_rank_b, logical=_rank_lb)
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    out = prog.partial(dcols, int(self.rank_rows[r]),
                                       prep_vals)
            ph.note_launch()
            ph.note_fused()   # per-rank chain partial = fused local stage
            with ph.phase("compute"):
                # drain outside the scheduler slot: sibling statements
                # dispatch while this rank executes
                _sync(dev)
            failpoint.inject("shard-checkpoint-write")
            with ph.phase("fetch"):
                ngt = int(out["n_groups"])
                live_n = ngt if self.root.group_exprs else 1
                # factorize packs live groups into slots 0..ng-1, so the
                # checkpoint is the sliced prefix — exactly a pass_out
                k = min(live_n, prog.group_cap)
                got = to_host(
                    {"keys": [(v[:k], m[:k]) for v, m in out["keys"]],
                     "states": [tuple(a[:k] for a in st)
                                for st in out["states"]]})
            ph.add_d2h(tree_nbytes(got) + 4)
            return ({"ng": k, "keys": got["keys"],
                     "states": got["states"]}, ngt)
        finally:
            # drop the rank's device buffers: on success the host
            # checkpoint is now authoritative, on a fault the abandoned
            # buffers must go BEFORE the retry / re-dispatch uploads its
            # generation (the traceback would otherwise hold them)
            dcols = out = None


# ---------------------------------------------------------------------------
# The monolithic program: every rank in one process, collectives on device
# ---------------------------------------------------------------------------


class DistTreeProgram(TreeProgram):
    """The JAX package's shard_map-compiled fragment, run eagerly over
    every rank at once on one device. Per-rank emission is TreeProgram's
    (_TreeRun, one per rank: scans read the rank's slab and row count,
    compressed columns decode through K2), plus the Exchange barrier and
    the distributed root reduction. Join modes are the tree engine's
    (unique bet, expand with per-rank out caps); lost bets and capacity
    overflows come back as flags reduced over the ranks, so the executor
    re-runs once at the exact need (never a CPU fallback).

    `bucket_caps` holds one bucket cap per HASH exchange in _walk_nodes
    order. Everything per call lives in the runs and the call's shared
    state, so a cached program serves fresh plan objects."""

    def __init__(self, plan: PhysicalPlan, caps, group_cap: int,
                 n_shards: int, bucket_caps, join_cfgs=None,
                 scan_layouts=None, *, device):
        super().__init__(plan, caps, group_cap, join_cfgs,
                         scan_layouts=scan_layouts, device=device)
        self.n_shards = int(n_shards)
        self.bucket_caps = [int(c) for c in bucket_caps]
        exchanges = [n for n in _walk_nodes(plan)
                     if isinstance(n, PhysExchange)]
        # the exchange barrier's memo key: position in _walk_nodes order
        self.exchange_pos = {id(n): k for k, n in enumerate(exchanges)}
        hashes = [n for n in exchanges if n.kind == "hash"]
        self.hash_pos = {id(n): k for k, n in enumerate(hashes)}
        self.n_joins = sum(isinstance(n, PhysHashJoin)
                           for n in _walk_nodes(plan))

    def __call__(self, rank_inputs, rank_rows, prep_vals):
        """rank_inputs[r]: per scan slot {col: [slab tuple]} of rank r's
        slab; rank_rows[r]: per scan slot, rank r's row count. → {"ranks":
        per-rank root outputs, the flags reduced over the ranks}."""
        from tidb_tpu_torch.util import failpoint
        nd = self.n_shards
        # the per-rank dispatch seam of the JAX package: a shard fault
        # fires once per rank before the step (after_hits=K picks the
        # rank); the executor retries the WHOLE step once
        for _rank in range(nd):
            failpoint.inject("shard-step")
        shared = {"memo": {}, "needs": {}}
        runs = [_DistRun(self, prep_vals, r, rank_inputs[r], rank_rows[r],
                         shared) for r in range(nd)]
        shared["runs"] = runs
        locals_ = []
        for run in runs:
            cols, live = run.emit(self.plan, run.scan_inputs,
                                  run.scan_rows)
            run.order_join_flags()
            locals_.append(run.finish(cols, live))
            cols = live = None
        dev = self.device
        nj = self.n_joins
        if nj:
            ju = torch.stack([loc["join_unique"] for loc in locals_]
                             ).all(dim=0)
            jn = torch.stack([loc["join_totals"] for loc in locals_]
                             ).max(dim=0).values
        else:
            ju = torch.zeros(0, dtype=torch.bool, device=dev)
            jn = torch.zeros(0, dtype=torch.int64, device=dev)
        needs = shared["needs"]
        xneed = (torch.stack([needs[k].to(torch.int64)
                              for k in range(len(self.hash_pos))])
                 if self.hash_pos else
                 torch.zeros(0, dtype=torch.int64, device=dev))
        root = self.plan
        if isinstance(root, PhysHashAgg):
            ranks, gneed = self._merge_partials(locals_)
            rank_n = torch.stack([o["out_live"].sum() for o in ranks])
        else:
            ranks = locals_
            gneed = torch.zeros((), dtype=torch.int64, device=dev)
            rank_n = torch.stack([o["n_out"].to(torch.int64).reshape(())
                                  if "n_out" in o else o["live"].sum()
                                  for o in ranks])
        return {"ranks": ranks, "join_unique": ju, "join_need": jn,
                "group_need": gneed, "exchange_need": xneed,
                "rank_n": rank_n}

    def read_flags(self, out) -> dict:
        """The reduced flags in ONE device→host read → numpy arrays."""
        nj = out["join_unique"].shape[0]
        nx = out["exchange_need"].shape[0]
        flat = torch.cat([out["join_unique"].to(torch.int64),
                          out["join_need"].to(torch.int64),
                          out["group_need"].to(torch.int64).reshape(1),
                          out["exchange_need"].to(torch.int64),
                          out["rank_n"].to(torch.int64)]).cpu().numpy()
        return {"join_unique": flat[:nj].astype(bool),
                "join_need": flat[nj:2 * nj],
                "group_need": int(flat[2 * nj]),
                "exchange_need": flat[2 * nj + 1:2 * nj + 1 + nx],
                "rank_n": flat[2 * nj + 1 + nx:]}

    # -- the exchange barrier -------------------------------------------------
    def exchange_step(self, node: PhysExchange, shared) -> List:
        """Emit the exchange's child on every rank of the call's shared
        state, run the collective once, → one (cols, live) per rank. The
        senders' columns go out of scope as the collective returns."""
        from tidb_tpu_torch.executor.device_emit import _rows
        nd = self.n_shards
        runs = shared["runs"]
        sent = [run.emit(node.children[0], run.scan_inputs, run.scan_rows)
                for run in runs]
        lives = [live for _c, live in sent]
        flats, meta = [], None
        for cols, live in sent:
            flat, meta = _flatten_rows(cols, live.shape[0])
            flats.append(flat)
        dests = None
        if node.kind == "hash":
            from tidb_tpu_torch.ops import partition as P
            dests = [P.hash_dest([_rows((v, m.to(torch.bool)),
                                        live.shape[0])
                                  for v, m in (e.eval(run.ctx(cols))
                                               for e in node.keys)], nd)
                     for run, (cols, live) in zip(runs, sent)]
        sent = None
        if node.kind == "broadcast":
            out_flat, out_live = C.broadcast_build(flats, lives)
            return [(_unflatten_rows(out_flat[r], meta), out_live[r])
                    for r in range(nd)]
        hk = self.hash_pos[id(node)]
        recv, recv_live, need = C.exchange(flats, dests, lives, nd,
                                           self.bucket_caps[hk])
        shared["needs"][hk] = need
        return [(_unflatten_rows(recv[d], meta), recv_live[d])
                for d in range(nd)]

    # -- the distributed agg root ----------------------------------------------
    def _merge_partials(self, locals_):
        """Gather every rank's partial (K25), then each rank merges the
        groups it owns (the owner hash of the key VALUE, K26, computed
        once: it is the same on every rank). An ungrouped agg's one slot
        belongs to rank 0. → (per-rank {keys, states, out_live}, the
        largest true group count of any partial or owned merge)."""
        from tidb_tpu_torch.ops import factorize as F
        from tidb_tpu_torch.ops import partition as P
        from tidb_tpu_torch.ops.gather import gather_columns
        root = self.plan
        cap = self.group_cap
        nd = self.n_shards
        xp = self.xp
        dev = self.device
        gk, gs, gsl = C.gather_partials(
            [loc["keys"] for loc in locals_],
            [[tuple(st) for st in loc["states"]] for loc in locals_],
            [loc["slot_live"] for loc in locals_])
        gkeys, gstates, gslot = gk[0], gs[0], gsl[0]
        grouped = bool(root.group_exprs)
        needs = [loc["n_groups"].to(torch.int64).reshape(()) if grouped
                 else torch.zeros((), dtype=torch.int64, device=dev)
                 for loc in locals_]
        locals_.clear()
        owner = P.hash_dest(gkeys, nd) if grouped else None
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        ranks = []
        for r in range(nd):
            if grouped:
                own = gslot & (owner == r)
                fgids, n_own, frep = F.factorize(gkeys, own, cap)
                fgids = torch.where(own, fgids, torch.full_like(fgids, cap))
                out_live = iota < n_own
                f_keys = gather_columns(gkeys, frep, n_own)
                needs.append(n_own.to(torch.int64).reshape(()))
            else:
                own = gslot if r == 0 else torch.zeros_like(gslot)
                fgids = torch.where(own, torch.zeros_like(gslot,
                                                          dtype=torch.int32),
                                    torch.full(gslot.shape, cap,
                                               dtype=torch.int32,
                                               device=dev))
                out_live = (iota < 1) & (r == 0)
                f_keys = []
            f_states = []
            for agg, gstate in zip(self.aggs, gstates):
                clean = tuple(torch.where(own, a, torch.zeros_like(a))
                              for a in gstate)
                st = agg.init(xp, cap)
                f_states.append(agg.merge(xp, st, fgids, cap, clean))
            ranks.append({"keys": f_keys, "states": f_states,
                          "out_live": out_live})
        return ranks, torch.stack(needs).max()


class _DistRun(_TreeRun):
    """One rank's run of a DistTreeProgram. Scans are _TreeRun's over the
    rank's slab; an Exchange is the barrier of the call's shared state:
    the first rank to reach it emits the exchange's child on EVERY
    rank's run, calls the collective once and leaves each rank its
    slice; nested exchanges follow from the recursion."""

    def __init__(self, prog: DistTreeProgram, prep_vals, rank: int,
                 scan_inputs, scan_rows, shared):
        super().__init__(prog, prep_vals, (), None)
        self.rank = rank
        self.scan_inputs = scan_inputs
        self.scan_rows = scan_rows
        self.shared = shared
        self.join_ids: List[int] = []

    def emit(self, node: PhysicalPlan, scan_inputs, scan_rows):
        if isinstance(node, PhysExchange):
            memo = self.shared["memo"]
            pos = self.prog.exchange_pos[id(node)]
            if pos not in memo:
                memo[pos] = self.prog.exchange_step(node, self.shared)
            got = memo[pos]
            # hand the slice over: the memo keeps no reference to it
            out, got[self.rank] = got[self.rank], None
            return out
        return super().emit(node, scan_inputs, scan_rows)

    def _emit_join(self, node, scan_inputs, scan_rows):
        out = super()._emit_join(node, scan_inputs, scan_rows)
        self.join_ids.append(self.prog.join_order[id(node)])
        return out

    def order_join_flags(self) -> None:
        """A join under an exchange completes during another rank's
        barrier, so the flags arrive in a rank-dependent order: put them
        in join order."""
        order = sorted(range(len(self.join_ids)),
                       key=lambda i: self.join_ids[i])
        self.unique_flags = [self.unique_flags[i] for i in order]
        self.totals = [self.totals[i] for i in order]


def _flatten_rows(cols, n: int):
    """[(v, m) or None...] → (1-D row columns for a collective, meta): a
    constant broadcasts to the rows, a wide-decimal (limbs, n) value
    becomes one column a limb."""
    flat: List = []
    meta: List = []
    for c in cols:
        if c is None:
            meta.append(None)
            continue
        v, m = c
        limbs = v.shape[0] if v.dim() == 2 else 0
        meta.append((len(flat), limbs))
        if limbs:
            flat.extend(v[k].contiguous() for k in range(limbs))
        else:
            flat.append(torch.broadcast_to(v, (n,)).contiguous())
        flat.append(torch.broadcast_to(m, (n,)).contiguous())
    return flat, meta


def _unflatten_rows(flat, meta):
    out = []
    for mt in meta:
        if mt is None:
            out.append(None)
            continue
        pos, limbs = mt
        if limbs:
            out.append((torch.stack(flat[pos:pos + limbs]),
                        flat[pos + limbs]))
        else:
            out.append((flat[pos], flat[pos + 1]))
    return out


# ---------------------------------------------------------------------------
# Staged (checkpointable) exchanges — StagedDistAgg's story cut at the
# exchange boundary, covering distributed joins, DISTINCT re-keys, windows
# ---------------------------------------------------------------------------


def _exchange_scan_chain(node: PhysicalPlan) -> Optional[PhysTableScan]:
    """The scan at the bottom of an exchange child when the child is a
    plain Scan/Selection/Projection chain — the shape whose stage-1
    partition program is one single-device TreeProgram per rank. A join,
    agg or nested exchange below an exchange has no per-rank cut BEFORE
    the exchange, so such plans are not staged."""
    while isinstance(node, (PhysSelection, PhysProjection)):
        node = node.children[0]
    return node if isinstance(node, PhysTableScan) else None


def _has_exchange(node: PhysicalPlan) -> bool:
    return any(isinstance(n, PhysExchange) for n in _walk_nodes(node))


class _ExchangeLeaf(PhysTableScan):
    """Stage-3 stand-in scan for a checkpointed exchange: the upper plan
    runs with each PhysExchange replaced by one of these, so every rank's
    receive/probe/dedup stage is ONE tree program whose 'table' is the
    routed bucket payload uploaded for that rank. The synthetic table id
    keeps program-cache signatures distinct per exchange position; no
    filters/partitions — stage 1 already applied the pushed-down
    conjuncts before partitioning."""

    def __init__(self, exch: PhysExchange, tag: int):
        import types as pytypes
        PhysicalPlan.__init__(self, exch.schema)
        self.table = pytypes.SimpleNamespace(id=f"staged-exch:{tag}")
        self.alias = None
        self.filters = []
        self.used_columns = None
        self.partitions = None
        self.est_rows = exch.est_rows


def staged_exchange_plan(root: PhysicalPlan):
    """Eligibility + stage-3 rewrite for the staged exchange path.

    → None when the staged path cannot run the fragment (no exchange; a
    TopN/Sort root, whose per-shard candidate emission + host k-way merge
    is the monolithic root reduction; or an exchange whose child is not a
    plain scan chain), else (new_root, grafts) where grafts pairs each
    PhysExchange with its stage-3 _ExchangeLeaf in _walk_nodes order.
    new_root is a CLONE of the upper plan — ancestors of an exchange are
    copy.copy'd with fresh children lists, never mutated, because cached
    programs hold references into the original plan. Exchange-free
    subtrees (e.g. a broadcast join's probe side) are reused as-is so
    their scan/prep identities survive into the rewritten plan."""
    exchanges = [n for n in _walk_nodes(root) if isinstance(n, PhysExchange)]
    if not exchanges:
        return None
    if isinstance(root, (PhysTopN, PhysSort)):
        return None
    for exch in exchanges:
        if _exchange_scan_chain(exch.children[0]) is None:
            return None
    grafts = [(exch, _ExchangeLeaf(exch, k))
              for k, exch in enumerate(exchanges)]
    by_id = {id(exch): leaf for exch, leaf in grafts}

    def graft(node: PhysicalPlan) -> PhysicalPlan:
        leaf = by_id.get(id(node))
        if leaf is not None:
            return leaf
        if not _has_exchange(node):
            return node
        clone = copy.copy(node)
        clone.children = [graft(c) for c in node.children]
        return clone

    return graft(root), grafts


class _PartitionProgram(TreeProgram):
    """Stage 1 of a staged exchange: ONE rank's scan→filter→project→
    partition as a single-device program. The plan is the PhysExchange
    node itself (so prep collection and the program-cache signature see
    the exchange keys); the root replaces the monolithic path's
    all_to_all with fixed-capacity per-destination bucket buffers ready
    for a device→host checkpoint — the host does the routing
    (collective.route_buckets). Within each bucket the live prefix keeps
    source row order."""

    def __init__(self, exch: PhysExchange, caps, n_shards: int,
                 bucket_cap: int, scan_layouts=None, *, device):
        self.n_shards = n_shards
        self.bucket_cap = bucket_cap
        super().__init__(exch, caps, 0, scan_layouts=scan_layouts,
                         device=device)

    def __call__(self, scan_inputs, scan_rows, prep_vals,
                 aligned_inputs=(), ranges=None):
        from tidb_tpu_torch.executor import device_emit
        run = _TreeRun(self, prep_vals, aligned_inputs, ranges)
        exch = self.plan
        cols, live = run.emit(exch.children[0], scan_inputs, scan_rows)
        present = [i for i, c in enumerate(cols) if c is not None]
        if exch.kind != "hash":
            # broadcast: no partitioning — the checkpoint carries the
            # rank's filtered rows; the host replicates the concatenation
            # of every rank's rows to every destination
            return {"bufs": {i: cols[i] for i in present}, "live": live}
        ctx = run.ctx(cols)
        keys = [e.eval(ctx) for e in exch.keys]
        flat, meta = _flatten_cols(cols)
        bufs, _sent, counts, need = device_emit.emit_partition(
            keys, flat, live, self.n_shards, self.bucket_cap)
        out_cols = _unflatten_cols(bufs, meta)
        return {"bufs": {i: out_cols[i] for i in present},
                "counts": counts, "need": need}


class StagedDistExchange:
    """Checkpointable staged execution of an exchange-carrying
    distributed fragment (see the module docstring):

      stage 1  per rank: one _PartitionProgram dispatch producing that
               rank's per-destination bucket buffers;
      stage 2  every rank's outgoing buckets checkpoint device→host —
               all committed before ANY rank's receive stage starts —
               then collective.route_buckets routes them host-side;
      stage 3  per rank: receive/probe/dedup over the routed buckets
               (plus this rank's slices of any non-exchanged scans,
               e.g. a broadcast join's probe side) as ONE tree program.

    Any stage's shard fault rides the per-rank ladder and re-executes
    ONLY the failed rank's stage; healthy ranks' checkpoints are never
    recomputed. A stage-1 bucket-cap overflow resizes ONLY the overflowed
    rank's buckets at the exact reported need (the per-rank cap is part
    of the program-cache signature, so the other ranks keep their
    program). Stage-3 group overflows rerun only the overflowed ranks; a
    lost join bet reruns all ranks (unique-mode checkpoints under the old
    cfg are not trustworthy)."""

    def __init__(self, root, new_root, grafts, mesh, host_cols, scan_meta,
                 ctx, ladder):
        from dataclasses import replace as d_replace

        from tidb_tpu_torch.chunk import compress as _compress
        from tidb_tpu_torch.executor.device_cache import _col_bounds, _pow2
        from tidb_tpu_torch.executor.fragment import _var_bool
        self.root = root
        self.new_root = new_root
        self.devices = list(mesh)
        self.nd = len(self.devices)
        self.ctx = ctx
        self.ladder = ladder
        nd = self.nd
        vars_ = ctx.vars
        comp_on = _var_bool(vars_.get("tidb_tpu_compression", "on"))
        meta = {id(s): (s, u, t) for s, u, t in scan_meta}
        scan_dicts_all = {id(s): {i: host_cols[(id(s), i)][2] for i in u}
                          for s, u, t in scan_meta}
        flows1, _ = dictionary_flows(root, scan_dicts_all)

        def prep_scan(scan, used, total, zone_prune):
            """Per-rank host slices of one scan (the checkpoint story's
            source of truth: a retry or re-dispatch re-uploads ONLY its
            rank's slice), compressed per rank like StagedDistAgg's —
            each rank packs its own slab, so no word-alignment
            constraint applies and layouts are chosen globally."""
            cap = _pow2((total + nd - 1) // nd, lo=8)
            layouts = {}
            if comp_on:
                for i in used:
                    vals, valid, _d = host_cols[(id(scan), i)]
                    if vals.ndim != 1:
                        continue
                    lay, _dv = _compress.choose_layout(vals, valid,
                                                       allow_dict=False)
                    if lay is not None and lay.width > 0:
                        layouts[i] = lay
            dicts = {i: host_cols[(id(scan), i)][2] for i in used}
            skip: frozenset = frozenset()
            if zone_prune and comp_on and getattr(scan, "filters", None):
                from tidb_tpu_torch.executor import zonemap
                from tidb_tpu_torch.executor.fragment import _RankZoneEnt
                zmaps = {}
                for i in used:
                    vals, valid, _d = host_cols[(id(scan), i)]
                    if vals.ndim != 1:
                        continue
                    kind = "code" if _d is not None else \
                        ("float" if vals.dtype.kind == "f" else "num")
                    zmaps[i] = zonemap.column_stats(vals, valid, cap,
                                                    total, kind=kind)
                skip = zonemap.prune_slabs(_RankZoneEnt(nd, zmaps, dicts),
                                           scan)
                if len(skip) >= nd:
                    skip = frozenset()
                if skip:
                    zonemap.note_skipped(ctx.phases, len(skip))
            rank_cols = []
            for r in range(nd):
                if r in skip:
                    rank_cols.append(None)
                    continue
                lo = r * cap
                cols = {}
                for i in used:
                    vals, valid, _d = host_cols[(id(scan), i)]
                    pv = np.zeros(cap, dtype=vals.dtype)
                    pm = np.zeros(cap, dtype=bool)
                    seg = vals[lo:lo + cap]
                    pv[:seg.shape[0]] = seg
                    segm = valid[lo:lo + cap]
                    pm[:segm.shape[0]] = segm
                    lay = layouts.get(i)
                    cols[i] = _compress.pack_slab(lay, pv, pm) \
                        if lay is not None else (pv, pm)
                rank_cols.append(cols)
            rank_rows = np.clip(total - np.arange(nd) * cap, 0,
                                cap).astype(np.int32)
            return {"scan": scan, "used": list(used), "cap": cap,
                    "layouts": layouts,
                    "lay_pairs": tuple(sorted(layouts.items())),
                    "dicts": dicts, "rank_cols": rank_cols,
                    "rank_rows": rank_rows, "skip": skip}

        # stage-1 sources: one per exchange, zone-map rank pruning on (a
        # pruned rank partitions nothing — its checkpoint is the empty-
        # buckets identity, filled after a real checkpoint fixes dtypes)
        cap_override = int(vars_.get("tidb_tpu_exchange_bucket_cap", 0)
                           or 0)
        self.exchanges: List[dict] = []
        for tag, (exch, leaf) in enumerate(grafts):
            scan = _exchange_scan_chain(exch.children[0])
            _s, used, total = meta[id(scan)]
            info = prep_scan(scan, used, total, zone_prune=True)
            est = max(int(exch.est_rows), 1)
            info.update({
                "exch": exch, "leaf": leaf, "tag": tag,
                "bcaps": [cap_override
                          or _pow2(4 * ((est + nd - 1) // nd), lo=64)] * nd,
            })
            fl, _ = dictionary_flows(exch, {id(scan): info["dicts"]})
            info["flow_list"] = [fl.get(id(n), [])
                                 for n in _walk_nodes(exch)]
            # the exchange's dictionary_flows entry IS its output dict
            # list — the leaf's scan dictionaries for the stage-3 flows
            info["leaf_dicts"] = {i: d for i, d in
                                  enumerate(flows1.get(id(exch), []))}
            self.exchanges.append(info)

        # direct (non-exchanged) scans surviving into the stage-3 plan
        self.direct: Dict[int, dict] = {}
        for scan in _scans(new_root):
            if isinstance(scan, _ExchangeLeaf):
                continue
            _s, used, total = meta[id(scan)]
            self.direct[id(scan)] = prep_scan(scan, used, total,
                                              zone_prune=False)

        scan_dicts3 = {id(i["leaf"]): i["leaf_dicts"]
                       for i in self.exchanges}
        for sid, d in self.direct.items():
            scan_dicts3[sid] = d["dicts"]
        self.flows2, self.root_dicts2 = dictionary_flows(new_root,
                                                         scan_dicts3)
        self.flow_list2 = [self.flows2.get(id(n), [])
                           for n in _walk_nodes(new_root)]

        scan_bounds = {}
        for sid, d in self.direct.items():
            b = {}
            for i in d["used"]:
                vals, valid, dictionary = host_cols[(sid, i)]
                bb = _col_bounds(vals, valid, dictionary)
                if bb is not None:
                    b[i] = bb
            scan_bounds[sid] = b
        self.join_cfgs = plan_join_configs(new_root, scan_bounds)
        self.join_cfgs = [d_replace(c, out_cap=self._shard_out_cap(c))
                          if c.mode == "expand" else c
                          for c in self.join_cfgs]
        self.out_cap_max = int(vars_.get("tidb_tpu_join_out_cap",
                                         JOIN_OUT_CAP))

        from tidb_tpu_torch.executor.fragment import (DEFAULT_GROUP_CAP,
                                                      _initial_group_cap)
        caps_all = [d["cap"] for d in self.direct.values()] + \
            [i["cap"] for i in self.exchanges]
        self.cap_limit = max(caps_all) * nd
        if isinstance(new_root, PhysHashAgg):
            self.gcap = _initial_group_cap(
                new_root, int(vars_.get("tidb_tpu_group_cap",
                                        DEFAULT_GROUP_CAP)),
                self.cap_limit)
        else:
            self.gcap = 1
        self.stage3_order: List[dict] = []

    def _shard_out_cap(self, cfg) -> int:
        # expand caps are PER RANK: the balanced share of the global
        # estimate; skew comes back as join_need → 1 retry
        from tidb_tpu_torch.executor.device_cache import _pow2
        return _pow2(int(cfg.est * 1.3 / self.nd) + 16, lo=1024)

    def _run_rank(self, r: int, attempt):
        return _run_rank(self.ctx, self.ladder, self.devices, r, attempt,
                         "exchange-degraded-replan", "exchange-redispatch")

    @staticmethod
    def _upload_sources(sources, r: int, dev, ph):
        """Rank r's slices of `sources` (stage-1 or stage-3 scan inputs)
        on `dev`, one slab each, with their h2d and scan bytes charged."""
        from tidb_tpu_torch.chunk import compress as _compress
        with ph.phase("upload"):
            dcols = tuple({i: [_upload_slab(t, dev)]
                           for i, t in src["rank_cols"][r].items()}
                          for src in sources)
        phys_b = logi_b = 0
        for src in sources:
            for i, t in src["rank_cols"][r].items():
                b = sum(a.nbytes for a in t)
                phys_b += b
                lay = src["layouts"].get(i)
                logi_b += _compress.raw_slab_bytes(lay, src["cap"]) \
                    if lay is not None else b
        ph.add_h2d(phys_b, logical=logi_b)
        ph.add_scan(phys_b, logical=logi_b)
        return dcols

    # -- stage 1: partition programs + bucket checkpoints -------------------

    def _stage1_program(self, info: dict, bcap: int, dev):
        from tidb_tpu_torch.executor.fragment import (_build_lock,
                                                      _cache_get,
                                                      _cache_put,
                                                      _charge_compile)
        exch, scan = info["exch"], info["scan"]
        caps = {id(scan): (info["cap"], 1)}
        # the PER-RANK bucket cap is part of the signature: a skewed
        # rank's exact-need resize builds one fresh program while every
        # other rank keeps hitting this cache — one rebuild per skew
        sig = (f"stagedx1|nd={self.nd}|bcap={bcap}|" +
               tree_signature(exch, caps, 0,
                              scan_layouts=(info["lay_pairs"],)) +
               f"|dev={torch.device(dev)}")
        prog = _cache_get(sig)
        if prog is None:
            with _build_lock(sig):
                prog = _cache_get(sig)
                if prog is None:
                    t0 = time.perf_counter()
                    prog = _PartitionProgram(
                        exch, caps, self.nd, bcap,
                        scan_layouts=(info["lay_pairs"],), device=dev)
                    _cache_put(sig, prog)
                    _charge_compile("dist", t0)
        return prog

    def _attempt_stage1(self, r: int, dev, progs: Dict, info: dict,
                        bcap: int, site: str):
        from tidb_tpu_torch.executor.fragment import _sync, compact_rows
        from tidb_tpu_torch.util import failpoint, timeline
        from tidb_tpu_torch.util.phases import to_host, tree_nbytes
        ph = self.ctx.phases
        dcols = None
        out = None
        t0 = timeline.now_us() if timeline.ENABLED else 0.0
        try:
            failpoint.inject(site)
            key = (bcap, torch.device(dev))
            if key not in progs:
                prog = self._stage1_program(info, bcap, dev)
                progs[key] = (prog, prog.collect_preps(info["flow_list"]))
            prog, prep_vals = progs[key]
            dcols = self._upload_sources([info], r, dev, ph)
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    out = prog(dcols, (int(info["rank_rows"][r]),),
                               prep_vals)
            ph.note_launch()
            ph.note_fused()
            with ph.phase("compute"):
                _sync(dev)
            # commit point of the rank's partition output: a fault here
            # loses ONLY this rank's buckets — the retry re-runs stage 1
            # for this rank alone
            failpoint.inject("exchange-checkpoint-write")
            with ph.phase("fetch"):
                if info["exch"].kind == "hash":
                    need = int(out["need"])
                    if need > bcap:
                        # rows past the cap were dropped in the scatter —
                        # don't checkpoint; report exact need instead
                        return {"overflow": need}
                    # route_buckets reads only each bucket's live prefix
                    # [d*cap, d*cap + counts[d]): fetch every bucket's
                    # first `need` slots, a layout with cap = need
                    nd = self.nd
                    got = to_host({
                        "bufs": {i: (v.view(nd, bcap)[:, :need].reshape(-1),
                                     m.view(nd, bcap)[:, :need].reshape(-1))
                                 for i, (v, m) in out["bufs"].items()},
                        "counts": out["counts"]})
                    ck = {"bufs": got["bufs"],
                          "counts": np.asarray(got["counts"]),
                          "cap": need}
                else:
                    # the rank's filtered rows, compacted on the device
                    rows, _offsets = compact_rows(
                        list(out["bufs"].values()),
                        out["live"].reshape(1, -1))
                    got = to_host({"bufs": dict(zip(out["bufs"], rows))})
                    ck = {"rows": got["bufs"]}
            ph.add_d2h(tree_nbytes(got) + 4)
            if timeline.ENABLED:
                timeline.record("partition", "partition",
                                dur_us=timeline.now_us() - t0,
                                pid=getattr(ph, "conn_id", 0),
                                args={"rank": r,
                                      "exchange": info["tag"]})
            return ck
        finally:
            # abandoned buffers must go BEFORE a retry / re-dispatch
            # uploads its generation — never 2× device residency
            dcols = out = None

    def _run_stage1(self, info: dict) -> List[dict]:
        """All ranks' bucket checkpoints for one exchange. Faults climb
        the per-rank ladder; a bucket-cap overflow resizes ONLY the
        overflowed rank at its exact reported need and re-runs it."""
        from tidb_tpu_torch.executor.fragment import FragmentFallback
        from tidb_tpu_torch.util import failpoint
        nd = self.nd
        ckpts: List[Optional[dict]] = [None] * nd
        to_run = [r for r in range(nd) if r not in info["skip"]]
        rounds = 0
        progs: Dict = {}
        while to_run:
            self.ctx.check_killed("device-dispatch")
            over = []
            for r in to_run:
                bcap = info["bcaps"][r]
                ck = self._run_rank(
                    r, lambda dev, site, r=r, bcap=bcap:
                    self._attempt_stage1(r, dev, progs, info, bcap, site))
                if "overflow" in ck:
                    over.append((r, ck["overflow"]))
                else:
                    ckpts[r] = ck
            if not over:
                break
            rounds += 1
            if rounds > 8:
                self.ladder.fallback("exchange")
                raise FragmentFallback(
                    "staged exchange: bucket resize did not converge",
                    reason="group-cap")
            for r, need in over:
                failpoint.inject("exchange-overflow")
                info["bcaps"][r] = self.ladder.resize(
                    "exchange", info["bcaps"][r], need=int(need), lo=64)
            self.ladder.attempt("exchange")
            self.ladder.partial_resume("exchange", rerun=len(over),
                                       reused=nd - len(over))
            to_run = [r for r, _ in over]
        # pruned ranks: empty-bucket identity (dtypes from a real rank's
        # checkpoint — route_buckets concatenates per column)
        ref = next(c for c in ckpts if c is not None)
        for r in range(nd):
            if ckpts[r] is not None:
                continue
            if info["exch"].kind == "hash":
                ckpts[r] = {"bufs": {i: (np.zeros(0, v.dtype),
                                         np.zeros(0, bool))
                                     for i, (v, m) in ref["bufs"].items()},
                            "counts": np.zeros(nd, np.int32), "cap": 0}
            else:
                ckpts[r] = {"rows": {i: (np.zeros(0, v.dtype),
                                         np.zeros(0, bool))
                                     for i, (v, m) in ref["rows"].items()}}
        return ckpts

    # -- stage 2: host routing + stage-3 source construction ----------------

    def _route(self, info: dict, ckpts: List[dict]) -> dict:
        """Route one exchange's committed checkpoints to their
        destination ranks and zero-pad each rank's receive payload to a
        shared power-of-two capacity — the stage-3 leaf's slab. The
        shared cap keeps stage 3 ONE program for all ranks (skew shows
        up as padding, not as per-rank programs)."""
        from tidb_tpu_torch.executor.device_cache import _pow2
        from tidb_tpu_torch.util import timeline
        nd = self.nd
        t0 = timeline.now_us() if timeline.ENABLED else 0.0
        if info["exch"].kind == "hash":
            routed, recv_rows = C.route_buckets(ckpts, nd)
        else:
            cols = list(ckpts[0]["rows"].keys())
            full = {i: (np.concatenate([ck["rows"][i][0] for ck in ckpts]),
                        np.concatenate([ck["rows"][i][1] for ck in ckpts]))
                    for i in cols}
            n = full[cols[0]][0].shape[0] if cols else 0
            routed = [full] * nd
            recv_rows = [n] * nd
        recv_cap = _pow2(max(max(recv_rows), 1), lo=64)

        def pad(bufs):
            cols = {}
            for i, (v, m) in bufs.items():
                pv = np.zeros(recv_cap, dtype=v.dtype)
                pm = np.zeros(recv_cap, dtype=bool)
                pv[:v.shape[0]] = v
                pm[:m.shape[0]] = m
                cols[i] = (pv, pm)
            return cols

        if info["exch"].kind == "hash":
            rank_cols = [pad(routed[r]) for r in range(nd)]
        else:
            shared = pad(routed[0])      # replicated build: pad once
            rank_cols = [shared] * nd
        if timeline.ENABLED:
            timeline.record("checkpoint", "checkpoint",
                            dur_us=timeline.now_us() - t0,
                            pid=getattr(self.ctx.phases, "conn_id", 0),
                            args={"exchange": info["tag"],
                                  "recv_rows": [int(x)
                                                for x in recv_rows]})
        return {"rank_cols": rank_cols,
                "rank_rows": np.asarray(recv_rows, dtype=np.int32),
                "cap": recv_cap, "layouts": {}, "lay_pairs": ()}

    # -- stage 3: per-rank receive/probe/dedup programs ----------------------

    def _attempt_stage3(self, r: int, dev, progs: Dict, site: str):
        from tidb_tpu_torch.executor.fragment import (_sync, compact_rows,
                                                      get_tree_program)
        from tidb_tpu_torch.util import failpoint, timeline
        from tidb_tpu_torch.util.phases import to_host, tree_nbytes
        ph = self.ctx.phases
        root = self.new_root
        dcols = None
        out = None
        t0 = timeline.now_us() if timeline.ENABLED else 0.0
        try:
            failpoint.inject(site)
            key = torch.device(dev)
            if key not in progs:
                caps3 = {id(src["scan"]): (src["cap"], 1)
                         for src in self.stage3_order}
                lays3 = tuple(src["lay_pairs"] for src in self.stage3_order)
                prog = get_tree_program(self.new_root, caps3, self.gcap,
                                        dev, join_cfgs=list(self.join_cfgs),
                                        scan_layouts=lays3)
                progs[key] = (prog, prog.collect_preps(self.flow_list2))
            prog, prep_vals = progs[key]
            dcols = self._upload_sources(self.stage3_order, r, dev, ph)
            rows = tuple(int(src["rank_rows"][r])
                         for src in self.stage3_order)
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    out = prog(dcols, rows, prep_vals)
            ph.note_launch()
            ph.note_fused()
            with ph.phase("compute"):
                _sync(dev)
            failpoint.inject("shard-checkpoint-write")
            with ph.phase("fetch"):
                flags = to_host({"ju": out["join_unique"],
                                 "jt": out["join_totals"]})
                ju = np.asarray(flags["ju"], dtype=bool)
                jt = np.asarray(flags["jt"])
                if isinstance(root, PhysHashAgg):
                    ngt = int(out["n_groups"])
                    live_n = ngt if root.group_exprs else 1
                    k = min(live_n, prog.group_cap)
                    got = to_host(
                        {"keys": [(v[:k], m[:k]) for v, m in out["keys"]],
                         "states": [tuple(a[:k] for a in st)
                                    for st in out["states"]]})
                    ck = {"ng": k, "keys": got["keys"],
                          "states": got["states"]}
                else:
                    # the rank's live rows, compacted on the device
                    got = to_host({"cols": compact_rows(
                        out["cols"], out["live"].reshape(1, -1))[0]})
                    ck = got
                    ngt = 0
            ph.add_d2h(tree_nbytes(got) + tree_nbytes(flags) + 4)
            if timeline.ENABLED:
                timeline.record("probe", "probe",
                                dur_us=timeline.now_us() - t0,
                                pid=getattr(ph, "conn_id", 0),
                                args={"rank": r})
            return ck, ngt, ju, jt
        finally:
            dcols = out = None

    def _run_stage3(self) -> List[dict]:
        from tidb_tpu_torch.executor.fragment import FragmentFallback
        nd = self.nd
        outs: List[Optional[dict]] = [None] * nd
        ng_true = [0] * nd
        caps_ran = [0] * nd
        n_joins = len(self.join_cfgs)
        rank_ju = np.ones((nd, max(n_joins, 1)), dtype=bool)
        rank_jt = np.zeros((nd, max(n_joins, 1)), dtype=np.int64)
        to_run = list(range(nd))
        rounds = 0
        while True:
            self.ctx.check_killed("device-dispatch")
            progs: Dict = {}
            for r in to_run:
                ck, ngt, ju, jt = self._run_rank(
                    r, lambda dev, site, r=r:
                    self._attempt_stage3(r, dev, progs, site))
                outs[r] = ck
                ng_true[r] = ngt
                caps_ran[r] = self.gcap
                if n_joins:
                    rank_ju[r, :n_joins] = ju
                    rank_jt[r, :n_joins] = jt
            rounds += 1
            if rounds > 8:
                self.ladder.fallback("dist")
                raise FragmentFallback(
                    "staged exchange: escalation did not converge",
                    reason="group-cap")
            # lost join bets / out-cap overflows first: a changed cfg
            # invalidates EVERY rank's checkpoint (unique-mode results
            # under the old bet are not trustworthy) — rerun all
            retry_all = False
            for ji, cfg in enumerate(self.join_cfgs):
                new_cfg, action = escalate_join(
                    cfg, bool(rank_ju[:, ji].all()),
                    int(rank_jt[:, ji].max()), self.out_cap_max,
                    flip_out_cap=self._shard_out_cap(cfg),
                    ladder=self.ladder)
                if action == "over-max":
                    self.ladder.fallback("join")
                    raise FragmentFallback(
                        f"join fan-out {int(rank_jt[:, ji].max())} "
                        f"exceeds the per-shard device cap",
                        reason="join-cap")
                if new_cfg is not None:
                    self.join_cfgs[ji] = new_cfg
                    retry_all = True
            if retry_all:
                self.ladder.attempt("dist")
                to_run = list(range(nd))
                continue
            over = [r for r in range(nd) if ng_true[r] > caps_ran[r]]
            if not over:
                return outs
            if self.gcap >= self.cap_limit:
                self.ladder.fallback("group")
                raise FragmentFallback("group cap overflow",
                                       reason="group-cap")
            self.gcap = self.ladder.resize(
                "group", self.gcap, need=max(ng_true[r] for r in over),
                max_cap=self.cap_limit)
            self.ladder.attempt("group")
            self.ladder.partial_resume("group", rerun=len(over),
                                       reused=nd - len(over))
            to_run = over

    # -- driver ---------------------------------------------------------------

    def execute(self) -> List[dict]:
        """Stages 1→2→3 across every exchange; → per-rank stage-3
        checkpoints ({ng, keys, states} for an agg root, {cols} of the
        live rows for window/row roots) for the caller's host merge or
        decode."""
        stage3_srcs = {}
        for info in self.exchanges:
            ckpts = self._run_stage1(info)
            stage3_srcs[id(info["leaf"])] = \
                dict(self._route(info, ckpts), scan=info["leaf"])
        self.stage3_order = []
        for scan in _scans(self.new_root):
            if isinstance(scan, _ExchangeLeaf):
                self.stage3_order.append(stage3_srcs[id(scan)])
            else:
                self.stage3_order.append(self.direct[id(scan)])
        return self._run_stage3()


def _string_join_key_pairs(root: PhysicalPlan):
    """The (id(scan), col) pairs every string equi-join of `root` links,
    or None when a string key is ci-collated or not a bare scan column
    (no dictionary unification can serve it)."""
    from tidb_tpu_torch.executor.tree_fragment import _trace_scan_col
    from tidb_tpu_torch.expression import ColumnRef
    from tidb_tpu_torch.planner.physical import PhysHashJoin
    pairs = []
    for node in _walk_nodes(root):
        if not isinstance(node, PhysHashJoin):
            continue
        for l, r in node.equi or []:
            if not (l.ftype.kind.is_string or r.ftype.kind.is_string):
                continue
            if l.ftype.is_ci or r.ftype.is_ci:
                return None
            lh = _trace_scan_col(node.children[0], l.index) \
                if isinstance(l, ColumnRef) else None
            rh = _trace_scan_col(node.children[1], r.index) \
                if isinstance(r, ColumnRef) else None
            if lh is None or rh is None:
                return None
            pairs.append(((id(lh[0]), lh[1]), (id(rh[0]), rh[1])))
    return pairs


def string_join_keys_unifiable(root: PhysicalPlan) -> bool:
    """Plan-time gate: every string equi-join key can share one
    dictionary (unify_string_join_dicts)."""
    return _string_join_key_pairs(root) is not None


def unify_string_join_dicts(root: PhysicalPlan, host_cols) -> None:
    """Exchange-side dictionary unification for string equi-join keys.

    Each class of scan columns transitively connected by string equi
    joins is re-encoded into ONE shared sorted dictionary host-side,
    before slicing. Equal strings then carry equal codes on every side,
    so hash exchanges co-locate them (the repartition invariant of
    cophandler/mpp_exec.go:158-173) and the probe-side KeyRemap LUT
    degenerates to identity. host_cols: (id(scan), col_idx) →
    [codes, valid, dictionary], mutated in place. The planner admits only
    plans this can unify (string_join_keys_unifiable), so a refusal here
    is a bug and raises."""
    from tidb_tpu_torch.errors import ExecutionError
    pairs = _string_join_key_pairs(root)
    if pairs is None:
        raise ExecutionError("distributed fragment with a string join key "
                             "no dictionary unification serves: the "
                             "plan-time gate admits none")
    parent: Dict = {}

    def find(x):
        root_ = x
        while parent.get(root_, root_) != root_:
            root_ = parent[root_]
        while parent.get(x, x) != x:
            parent[x], x = root_, parent[x]
        return root_

    def union(a, b):
        parent.setdefault(a, a)
        parent.setdefault(b, b)
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for a, b in pairs:
        union(a, b)

    groups: Dict = {}
    for m in parent:
        groups.setdefault(find(m), []).append(m)
    for members in groups.values():
        if len(members) < 2:
            continue
        dicts = [host_cols[m][2] for m in members
                 if m in host_cols and host_cols[m][2] is not None]
        if len(dicts) < len(members):
            raise ExecutionError("distributed string join key without a "
                                 "dictionary")
        union_d = np.unique(np.concatenate(dicts))
        for m in members:
            codes, _valid, d = host_cols[m]
            remap = np.searchsorted(union_d, d).astype(np.int32)
            host_cols[m][0] = remap[codes]
            host_cols[m][2] = union_d


def _flatten_cols(cols):
    """[(v,m) or None...] → (flat arrays for the bucket scatter, meta)."""
    flat: List = []
    meta: List[Optional[int]] = []
    for c in cols:
        if c is None:
            meta.append(None)
        else:
            meta.append(len(flat))
            flat.append(c[0])
            flat.append(c[1])
    return flat, meta


def _unflatten_cols(flat, meta):
    out = []
    for m in meta:
        out.append(None if m is None else (flat[m], flat[m + 1]))
    return out

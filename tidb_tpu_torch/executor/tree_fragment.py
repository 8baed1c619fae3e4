"""Join-tree device fragments: scan→filter→join*→aggregate on the device.

Extends the linear-chain fragments (executor/fragment.py) to plan subtrees
containing equi hash joins — the TPC-H Q3/Q5 shape. Every table is lifted
to the device once as padded slabs (executor/device_cache.py; multi-slab
tables concatenate inside the program), each join runs the LUT or the
sort formulation of ops/join.py, and the root reduction reuses the segment
and sort machinery of executor/device_emit.py. Programs run eagerly; a
cached TreeProgram keeps the tree's structure, its join configurations
and the prepared-input order of its expression nodes.

Join formulations, as in the JAX package:
  * **LUT (bounded keys)**: the build keys trace to scan columns with
    cached (lo, hi) bounds, at most ops.join.MAX_JOIN_KEYS of them, in a
    packed domain of at most JOIN_DOMAIN_CAP — true for every TPC-H PK-FK
    key and for every dictionary-encoded string column. Build = one
    scatter (K4), probe = one gather (K5).
  * **sort (any other key)**: build and probe keys are concatenated and
    reduced to one dense code per row (`combine_keys`: the sort factorize,
    K9 + K8 + K10), the build codes sort (K9 + K8) and every probe row
    binary-searches them (K11).

  * **unique mode** (PK-FK bet): probe-shaped output, no expansion. The
    bet is placed from table metadata (single-column primary key / unique
    index on the build key) or the planner's join-size estimate, and
    guarded by the build's largest code count — a lost bet re-runs that
    join in expand mode, never on the CPU.
  * **expand mode**: duplicate build keys materialize through the stable
    build order (K6) and the expansion (K7) into a static `out_cap`-shaped
    batch; the true total comes back with the result, so a capacity
    overflow retries once at the exact size.
  * **aligned mode**: the build columns arrive pre-gathered into the fact
    row space (device_cache.AlignedJoin); the join is the build side's
    filters over them.

Outer joins must preserve the PROBE side (kind='left' requires
build_right, 'right' requires build-left): every mode emits probe-anchored
output, so build rows that match nothing cannot be null-extended. String
equi keys remap the probe side's dictionary codes into the build side's
dictionary space host-side (`KeyRemap`, a prepared LUT input).

Roots: an aggregate (with its ORDER BY / TopN fused into the finalize),
TopN / Sort directly over the join's rows (`sort_perm` / `topn`), a LIMIT
(the first offset+count live rows, a stable partition), a window, or the
rows themselves. A window may also sit inside the tree (under a TopN,
an aggregate, a selection on its output, or over a join): its columns
are computed in the program (device_emit.emit_window_cols, the K12-K15
kernels) and feed the operator above. Joinless trees are admitted when
they hold a window, since a mid-chain window has no linear-chain
lowering; a multi-slab window root runs here too, as one program over
the concatenated slabs (partitions span slabs). A root aggregate may be
DISTINCT (per-slab pair sets, merged on the host across slabs) or WITH
ROLLUP (levels tiled into the program, K17); DISTINCT under ROLLUP stays
on the host, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tidb_tpu_torch.expression import ColumnRef, EvalContext, Expression
from tidb_tpu_torch.expression.aggfuncs import build_agg
from tidb_tpu_torch.planner.physical import (PhysExchange, PhysHashAgg,
                                             PhysHashJoin, PhysLimit,
                                             PhysProjection, PhysSelection,
                                             PhysSort, PhysTableScan,
                                             PhysTopN, PhysWindow,
                                             PhysicalPlan)

JOIN_KINDS = ("inner", "left", "right", "semi", "anti")
JOIN_DOMAIN_CAP = 1 << 25      # max packed build-key domain for LUT joins
JOIN_OUT_CAP = 1 << 26         # max expand-mode output rows (memory guard)


def has_join(plan: PhysicalPlan) -> bool:
    if isinstance(plan, PhysHashJoin):
        return True
    return any(has_join(c) for c in plan.children)


def has_window(plan: PhysicalPlan) -> bool:
    if isinstance(plan, PhysWindow):
        return True
    return any(has_window(c) for c in plan.children)


def _string_key_ok(l: Expression, r: Expression) -> bool:
    """String equi keys must be bare ColumnRefs (so the probe side's codes
    can be dictionary-remapped into the build side's space) with MATCHING
    collation classes — a mixed ci/binary pair would fold one side's
    dictionary out of sorted order (and can merge two binary codes into
    one fold class), so it runs on the CPU engine instead."""
    if not (l.ftype.kind.is_string or r.ftype.kind.is_string):
        return True
    if l.ftype.is_ci != r.ftype.is_ci:
        return False
    return isinstance(l, ColumnRef) and isinstance(r, ColumnRef)


def tree_ok(plan: PhysicalPlan, threshold: int) -> bool:
    """Static eligibility of a join tree (runtime checks catch the rest)."""
    from tidb_tpu_torch.executor.fragment import (_exprs_device_ok,
                                                  _identity_projection,
                                                  _order_over_agg_ok,
                                                  _row_root_ok,
                                                  _string_exprs_are_refs,
                                                  _window_device_ok)

    max_scan = [0.0]

    def walk(node: PhysicalPlan, is_root: bool) -> bool:
        if not _exprs_device_ok(_stage_exprs(node)):
            return False
        if isinstance(node, PhysTableScan):
            max_scan[0] = max(max_scan[0], getattr(node, "est_rows", 0.0))
            return True
        if isinstance(node, PhysSelection):
            return walk(node.children[0], False)
        if isinstance(node, PhysProjection):
            if not _string_exprs_are_refs(node.exprs):
                return False
            return walk(node.children[0], False)
        if isinstance(node, PhysHashJoin):
            if node.kind not in JOIN_KINDS or not node.equi:
                return False
            # probe-anchored output ⇒ the preserved side must be the probe
            if node.kind in ("left", "semi", "anti") and not node.build_right:
                return False
            if node.kind == "right" and node.build_right:
                return False
            for le, re in node.equi:
                if not _string_key_ok(le, re):
                    return False
            return walk(node.children[0], False) and \
                walk(node.children[1], False)
        if is_root and isinstance(node, PhysHashAgg):
            if getattr(node, "rollup", False) and \
                    any(d.distinct for d in node.aggs):
                return False    # DISTINCT+ROLLUP stays on the host oracle
            for desc in node.aggs:
                if desc.distinct and len(desc.args) > 1 and \
                        desc.name != "count":
                    return False    # multi-arg DISTINCT is COUNT-only
                try:
                    if not build_agg(desc).device_capable:
                        return False
                except Exception:
                    return False
                if any(a.ftype.kind.is_string for a in desc.args) \
                        and desc.name != "count":
                    return False
                if not _string_exprs_are_refs(desc.args):
                    return False    # string agg args read dict codes
            if not _string_exprs_are_refs(node.group_exprs):
                return False
            return walk(node.children[0], False)
        if is_root and isinstance(node, (PhysTopN, PhysSort)):
            if not _string_exprs_are_refs(node.by):
                return False
            child = node.children[0]
            while _identity_projection(child) and child.children:
                child = child.children[0]
            if isinstance(child, PhysHashAgg):
                # ORDER BY / TopN over the agg (identity projections are
                # transparent): the executor strips the order root and
                # runs it as the agg's fused device finalize
                if not _order_over_agg_ok(node, child):
                    return False
                return walk(child, True)
            # over the join's rows: sort_perm / topn in the program root
            return walk(node.children[0], False)
        if isinstance(node, PhysWindow):
            # root OR interior: an interior window computes its columns in
            # the program (_TreeRun.emit) and feeds the operator above —
            # the TopN-over-ROW_NUMBER / agg-over-window shapes
            return _window_device_ok(node) and walk(node.children[0], False)
        if is_root and isinstance(node, PhysLimit):
            # LIMIT over a join: the program emits the first offset+count
            # live rows in probe row order (device_emit.emit_root)
            return node.count is not None and walk(node.children[0], False)
        return False

    # joinless trees are admitted when a window makes the tree program
    # worthwhile (mid-chain windows have no linear-chain lowering)
    return _row_root_ok(plan) and walk(plan, True) and \
        (has_join(plan) or has_window(plan)) and max_scan[0] >= threshold


def dist_ok(plan: PhysicalPlan, threshold: int) -> bool:
    """Eligibility for distribution over ranks: the same operator
    allowlist as tree_ok, but joins are optional (a linear Q1 chain
    distributes as per-rank partials + a host merge). Reducible roots
    (agg/TopN/Sort) merge across ranks; window roots repartition on their
    partition keys; selection/projection/join roots emit per-rank rows
    the host concatenates. String join keys work because the dist
    executor unifies the key dictionaries host-side before slicing, so
    equal strings hash equal on every rank (the mpp repartition invariant
    of cophandler/mpp_exec.go:158-173). The planner's second gate
    (planner/physical._dist_refused) keeps two shapes single-device."""
    if isinstance(plan, PhysExchange):
        return False               # already fragmented
    if isinstance(plan, (PhysTopN, PhysSort)) and plan.children:
        from tidb_tpu_torch.executor.fragment import _identity_projection
        below = plan.children[0]
        while _identity_projection(below) and below.children:
            below = below.children[0]
        if isinstance(below, PhysHashAgg):
            # ORDER-over-agg: _run_device_dist strips the order root
            # before running (the ranks compute the agg; the host orders
            # after the merge) — eligibility is the agg's
            return dist_ok(below, threshold)
    if isinstance(plan, PhysHashAgg):
        if getattr(plan, "rollup", False):
            return False    # super-aggregate levels don't rank-merge yet
        if any(d.distinct for d in plan.aggs):
            # DISTINCT distributes by re-keying the exchange so every
            # group (or every distinct value, for global aggs) is wholly
            # on one rank (the repartition trick of cophandler/
            # mpp_exec.go); a global agg needs all distinct args equal to
            # pick ONE key
            if not plan.group_exprs:
                if any(d.distinct and len(d.args) != 1
                       for d in plan.aggs):
                    return False    # tuple re-key has no single column
                dargs = {repr(d.args[0]) for d in plan.aggs
                         if d.distinct and d.args}
                if len(dargs) != 1:
                    return False
    elif isinstance(plan, PhysWindow):
        pass        # the per-window spec check below covers the root too
    elif not isinstance(plan, (PhysTopN, PhysSort, PhysSelection,
                               PhysProjection, PhysHashJoin)):
        return False

    # per-rank windows need every partition wholly on one rank: all specs
    # must share ONE non-empty bare-ColumnRef partition list so a single
    # hash exchange directly below the window co-locates them
    # (insert_exchanges). Above the window only row-wise projections are
    # distributable (window root, or the select list over it) — a
    # reducing ancestor (agg/TopN/join) would need its own repartition
    # point mid-tree
    def _windows_ok(n, proj_chain):
        if isinstance(n, PhysWindow):
            if not proj_chain:
                return False
            parts = {repr(d.partition) for d in n.wdescs}
            if len(parts) != 1 or not n.wdescs[0].partition:
                return False
            if not all(isinstance(e, ColumnRef)
                       for e in n.wdescs[0].partition):
                return False
            proj_chain = False       # no second window below the first
        elif not isinstance(n, PhysProjection):
            proj_chain = False
        return all(_windows_ok(c, proj_chain) for c in n.children)

    if not _windows_ok(plan, True):
        return False
    # wide-decimal COLUMNS can't be sliced (the dist scan encoder is 1-D);
    # wide RESULTS over narrow/computed args are fine
    if isinstance(plan, PhysHashAgg) and any(
            isinstance(sub, ColumnRef) and sub.ftype.is_wide_decimal
            for d in plan.aggs for a in d.args for sub in a.walk()):
        return False
    if has_join(plan) or has_window(plan):
        # windowed shapes run as tree programs (mirrors the single-device
        # dispatch in fragment.py)
        return tree_ok(plan, threshold)
    from tidb_tpu_torch.executor.fragment import _fragment_ok
    return _fragment_ok(plan, threshold)


def _scans(plan: PhysicalPlan) -> List[PhysTableScan]:
    if isinstance(plan, PhysTableScan):
        return [plan]
    out: List[PhysTableScan] = []
    for c in plan.children:
        out.extend(_scans(c))
    return out


# ---------------------------------------------------------------------------
# Join key preparation (string dictionary remap)
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class KeyRemap(Expression):
    """Remaps the probe side's dictionary codes into the build side's
    dictionary space so string equi keys compare as integers.

    prepare() receives the JOIN's input dictionary list (left ++ right
    children) and computes a probe-code → build-code LUT host-side
    (one searchsorted of two sorted dictionaries); codes absent from the
    build dictionary map to -1, which matches nothing. The LUT ships as a
    prepared input, so a dictionary change never rebuilds the program."""

    child: Expression            # side-local probe key (ColumnRef)
    my_flow_idx: int             # my column's index in the join flow (l++r)
    build_flow_idx: int          # build key column's index in the join flow
    ci: bool = False             # compare under a ci collation

    def __post_init__(self):
        self.ftype = self.child.ftype

    def children(self):
        return [self.child]

    def prepare(self, dictionaries):
        # int64, the remapped key's type: the device gather (K21, fill
        # mode) writes the table's type, so no widening pass follows it
        pdict = dictionaries[self.my_flow_idx] \
            if self.my_flow_idx < len(dictionaries) else None
        bdict = dictionaries[self.build_flow_idx] \
            if self.build_flow_idx < len(dictionaries) else None
        if pdict is None or bdict is None or len(bdict) == 0:
            return np.full(max(len(pdict) if pdict is not None else 0, 1),
                           -1, np.int64)
        if self.ci:
            # ci dictionaries are representatives sorted by fold
            # (chunk/device.encode_strings): match in fold space
            from tidb_tpu_torch.types import fold_ci_array
            pdict = fold_ci_array(np.asarray(pdict, dtype=object))
            bdict = fold_ci_array(np.asarray(bdict, dtype=object))
        pos = np.searchsorted(bdict, pdict)
        pos_c = np.clip(pos, 0, len(bdict) - 1)
        hit = bdict[pos_c] == pdict
        return np.where(hit, pos_c, -1).astype(np.int64)

    def eval(self, ctx: EvalContext):
        from tidb_tpu_torch.ops.dict_lut import dict_lut
        lut = ctx.prepared.get(id(self))
        if lut is None:
            raise AssertionError("KeyRemap without prepared LUT")
        v, m = self.child.eval(ctx)
        # a probe code outside the probe dictionary matches nothing (-1)
        return dict_lut(ctx.xp.asarray(lut), v, mode="fill", fill=-1), m

    def __repr__(self):
        return f"remap({self.child!r})"


def join_key_exprs(node: PhysHashJoin):
    """→ (build_keys, probe_keys) in equi order, coerced to a shared
    comparable domain, with probe-side string keys wrapped in KeyRemap.
    Memoized on the node (wrappers must be identical objects across the
    planner gate, prep collection, and the program)."""
    cached = getattr(node, "_dev_join_keys", None)
    if cached is not None:
        return cached
    from tidb_tpu_torch.executor.join import coerce_key_pair
    nl = len(node.children[0].schema)
    bkeys: List[Expression] = []
    pkeys: List[Expression] = []
    for l, r in node.equi:
        lc, rc = coerce_key_pair(l, r)
        b, p = (rc, lc) if node.build_right else (lc, rc)
        if b.ftype.kind.is_string and isinstance(b, ColumnRef) \
                and isinstance(p, ColumnRef):
            b_flow = (nl if node.build_right else 0) + b.index
            p_flow = (0 if node.build_right else nl) + p.index
            p = KeyRemap(p, p_flow, b_flow,
                         ci=b.ftype.is_ci or p.ftype.is_ci)
        bkeys.append(b)
        pkeys.append(p)
    node._dev_join_keys = (bkeys, pkeys)
    return bkeys, pkeys


def _stage_exprs(node: PhysicalPlan) -> List[Expression]:
    from tidb_tpu_torch.executor.fragment import _stage_exprs as chain_stage
    if isinstance(node, PhysHashJoin):
        bkeys, pkeys = join_key_exprs(node)
        return list(bkeys) + list(pkeys) + list(node.other_conditions or [])
    if isinstance(node, PhysExchange):
        return list(node.keys)
    return chain_stage(node)


def _walk_nodes(plan: PhysicalPlan) -> List[PhysicalPlan]:
    """Deterministic DFS (children first, left-to-right) — the structural
    order used for prep-value alignment across program cache hits."""
    out: List[PhysicalPlan] = []

    def rec(n):
        for c in n.children:
            rec(c)
        out.append(n)

    rec(plan)
    return out


def _walk_joins(plan: PhysicalPlan) -> List[PhysHashJoin]:
    return [n for n in _walk_nodes(plan) if isinstance(n, PhysHashJoin)]


def aligned_chain(build: PhysicalPlan
                  ) -> Tuple[Optional[PhysTableScan], List[PhysHashJoin]]:
    """The build subtree's probe-chain anchor scan — the scan an aligned
    join substitutes with FK-aligned fact-rowspace columns — plus every
    join crossed on the way (outermost first). Follows Sel/Proj and each
    nested join's PROBE child (the rowspace-preserving side). The ONE
    traversal both the planner (fragment._plan_aligned_joins) and the
    program (_emit_join_aligned) use, so they cannot disagree on the
    anchor."""
    node = build
    crossed: List[PhysHashJoin] = []
    while True:
        if isinstance(node, PhysTableScan):
            return node, crossed
        if isinstance(node, (PhysSelection, PhysProjection)):
            node = node.children[0]
            continue
        if isinstance(node, PhysHashJoin):
            crossed.append(node)
            node = node.children[0 if node.build_right else 1]
            continue
        return None, crossed


def aligned_anchor(build: PhysicalPlan) -> Optional[PhysTableScan]:
    return aligned_chain(build)[0]


# ---------------------------------------------------------------------------
# Per-join execution configuration (planner bet + runtime adaptation)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JoinCfg:
    mode: str                                # 'unique' | 'expand' | 'aligned'
    out_cap: int = 0                              # expand-mode output shape
    bounds: Optional[Tuple[Tuple[int, int], ...]] = None   # LUT key bounds
    domain: int = 0                               # LUT table size
    est: int = 0                                  # planner output estimate
    # aligned mode: build-scan columns arriving as FK-aligned device inputs
    # (executor/device_cache.AlignedJoin) — static, part of the signature
    aligned_cols: Optional[Tuple[int, ...]] = None
    # blocked expand: this join's probe anchor scan is row-range masked and
    # the tree runs in K passes whose root agg states merge host-side —
    # a many-to-many fan-out beyond JOIN_OUT_CAP never leaves the device
    blocked: bool = False


def escalate_join(cfg: JoinCfg, unique_ok: bool, total: int,
                  out_cap_max: int, flip_out_cap: int, ladder=None):
    """One rung of the join-capacity ladder of the tree loops
    (executor/fragment.py):

      * a lost unique bet flips the join to expand mode at `flip_out_cap`;
      * an expand overflow resizes to the EXACT reported total (one
        rebuild covers it) unless the total exceeds `out_cap_max`, where
        the caller escalates further (blocked multi-pass / fallback).

    → (new_cfg | None, action) with action in
      {None, "flip", "resize", "over-max"}; new_cfg is None unless the
    join must re-run. A util/escalation.CapacityLadder passed as `ladder`
    gets the rung recorded on its per-query stats."""
    from dataclasses import replace as d_replace

    from tidb_tpu_torch.executor.device_cache import _pow2
    if cfg.mode == "unique" and not unique_ok:
        if ladder is not None:
            ladder.flip("join")
        return d_replace(cfg, mode="expand", out_cap=flip_out_cap), "flip"
    if cfg.mode == "expand" and total > cfg.out_cap:
        if total > out_cap_max:
            if ladder is not None:
                ladder.stats.note("join", "over-max")
            return None, "over-max"
        if ladder is not None:
            ladder.stats.exact_resizes += 1
            ladder.stats.note("join", "exact")
        return d_replace(cfg, out_cap=_pow2(total)), "resize"
    return None, None


def _bounds_list(node: PhysicalPlan, scan_bounds
                 ) -> List[Optional[Tuple[int, int]]]:
    """Per output column (lo, hi) value bounds, traced from the device
    cache's per-scan-column stats; schema-length list, None = unbounded."""
    if isinstance(node, PhysTableScan):
        b = scan_bounds.get(id(node), {})
        return [b.get(i) for i in range(len(node.schema))]
    if isinstance(node, PhysSelection):
        return _bounds_list(node.children[0], scan_bounds)
    if isinstance(node, PhysProjection):
        inp = _bounds_list(node.children[0], scan_bounds)
        return [inp[e.index] if isinstance(e, ColumnRef)
                and e.index < len(inp) else None for e in node.exprs]
    if isinstance(node, PhysHashJoin):
        l = _bounds_list(node.children[0], scan_bounds)
        r = _bounds_list(node.children[1], scan_bounds)
        nl = len(node.children[0].schema)
        nr = len(node.children[1].schema)
        l = (l + [None] * nl)[:nl]
        r = (r + [None] * nr)[:nr]
        if node.kind in ("semi", "anti"):
            return l
        return l + r
    return [None] * len(node.schema)


def _trace_scan_col(node: PhysicalPlan, idx: int):
    """Trace a column through Sel/Proj down to (scan, col) WITHOUT crossing
    joins (a join can duplicate rows, breaking uniqueness)."""
    while True:
        if isinstance(node, PhysTableScan):
            return node, idx
        if isinstance(node, (PhysSelection, PhysExchange)):
            node = node.children[0]
            continue
        if isinstance(node, PhysProjection):
            e = node.exprs[idx] if idx < len(node.exprs) else None
            if not isinstance(e, ColumnRef):
                return None
            idx = e.index
            node = node.children[0]
            continue
        return None


def _build_unique_hint(node: PhysHashJoin) -> bool:
    """Is the build side unique on the join key? Exact when the key is a
    single-column primary key / unique index; otherwise bet on the
    planner's join-size estimate (which already folds NDV stats in) —
    wrong bets cost one re-run, never wrong results."""
    bi = 1 if node.build_right else 0
    build = node.children[bi]
    raw_keys = [(r if node.build_right else l) for l, r in node.equi]
    if len(raw_keys) == 1 and isinstance(raw_keys[0], ColumnRef):
        hit = _trace_scan_col(build, raw_keys[0].index)
        if hit is not None:
            scan, idx = hit
            table = scan.table
            cols = getattr(table, "columns", [])
            if idx < len(cols):
                name = cols[idx].name.lower()
                pk = [c.lower() for c in (getattr(table, "primary_key", None)
                                          or [])]
                if pk == [name]:
                    return True
                for ix in getattr(table, "indexes", []):
                    if ix.unique and len(ix.columns) == 1 and \
                            ix.columns[0].lower() == name and \
                            getattr(ix, "state", "public") == "public":
                        # write-only uniqueness is not yet VALIDATED —
                        # the PK-FK bet may only trust public indexes
                        return True
    probe = node.children[1 - bi]
    return node.est_rows <= probe.est_rows * 1.05 + 16


def plan_join_configs(root: PhysicalPlan, scan_bounds) -> List[JoinCfg]:
    """Initial per-join configs in _walk_nodes order (the runtime adapts
    mode/out_cap from the flags the program reports). A join whose build
    keys are unbounded, more than K4/K5 pack (MAX_JOIN_KEYS), or whose
    packed domain exceeds JOIN_DOMAIN_CAP, gets bounds None: it runs the
    sort formulation."""
    from tidb_tpu_torch.executor.device_cache import _pow2
    from tidb_tpu_torch.ops.join import MAX_JOIN_KEYS
    cfgs: List[JoinCfg] = []
    for node in _walk_joins(root):
        bi = 1 if node.build_right else 0
        build = node.children[bi]
        bkeys, _ = join_key_exprs(node)
        bb = _bounds_list(build, scan_bounds)
        bounds: Optional[List[Tuple[int, int]]] = []
        domain = 1
        for e in bkeys:
            if isinstance(e, ColumnRef) and e.index < len(bb) \
                    and bb[e.index] is not None:
                lo, hi = bb[e.index]
                domain *= (hi - lo + 1)
                if domain > JOIN_DOMAIN_CAP:
                    bounds = None
                    break
                bounds.append((lo, hi))
            else:
                bounds = None
                break
        if len(bkeys) > MAX_JOIN_KEYS:
            bounds = None
        est = max(int(node.est_rows), 1)
        mode = "unique" if _build_unique_hint(node) else "expand"
        out_cap = _pow2(int(est * 1.3), lo=1024) if mode == "expand" else 0
        cfgs.append(JoinCfg(mode, out_cap,
                            tuple(bounds) if bounds else None,
                            domain if bounds else 0, est))
    return cfgs


def tree_agg_key_bounds(root: PhysicalPlan, scan_bounds,
                        domain_cap: int) -> Optional[List[Tuple[int, int]]]:
    """Perfect-hash group-key domains for an agg root over a tree, when
    every group key is a bounded column and the packed domain is small."""
    if not isinstance(root, PhysHashAgg) or not root.group_exprs:
        return None
    if getattr(root, "rollup", False):
        return None     # level tiling needs the sort factorize
    inp = _bounds_list(root.children[0], scan_bounds)
    out: List[Tuple[int, int]] = []
    domain = 1
    for e in root.group_exprs:
        if not (isinstance(e, ColumnRef) and e.index < len(inp)
                and inp[e.index] is not None):
            return None
        lo, hi = inp[e.index]
        domain *= (hi - lo + 2)
        if domain > domain_cap:
            return None
        out.append((lo, hi))
    return out


# ---------------------------------------------------------------------------
# Signature (program cache key)
# ---------------------------------------------------------------------------


def tree_signature(plan: PhysicalPlan, caps: Dict[int, Tuple[int, int]],
                   group_cap: int, join_cfgs: Optional[Sequence[JoinCfg]] = None,
                   agg_key_bounds=None, scan_layouts=None) -> str:
    parts = ["tree", f"gcap={group_cap}", f"akb={agg_key_bounds}"]
    ji = 0
    si = 0
    for node in _walk_nodes(plan):
        if isinstance(node, PhysTableScan):
            cap = caps[id(node)]
            cap = cap if isinstance(cap, tuple) else (cap, 1)
            # compressed physical layouts change the scan's decode (and
            # its inputs), so they key the program cache
            lays = scan_layouts[si] if scan_layouts else ()
            si += 1
            parts.append(
                f"Scan(id={node.table.id}, cap={cap[0]}x{cap[1]}, "
                f"types={[str(ft) for ft in node.schema.field_types]}, "
                f"filters={node.filters!r}, "
                f"parts={getattr(node, 'partitions', None)}, "
                f"lay={[(i, l.sig()) for i, l in lays]})")
        elif isinstance(node, PhysHashJoin):
            cfg = join_cfgs[ji] if join_cfgs else None
            ji += 1
            # est is host-side-only (seeds the retry out_cap) — keep it out
            # of the cache key or estimate drift forces spurious rebuilds
            cfg_s = (f"{cfg.mode},{cfg.out_cap},{cfg.bounds},{cfg.domain},"
                     f"{cfg.aligned_cols},{cfg.blocked}" if cfg else None)
            parts.append(f"Join({node.kind}, build_right={node.build_right},"
                         f" equi={node.equi!r}, "
                         f"other={node.other_conditions!r}, cfg={cfg_s})")
        elif isinstance(node, PhysSelection):
            parts.append(f"Sel({node.conditions!r})")
        elif isinstance(node, PhysProjection):
            parts.append(f"Proj({node.exprs!r})")
        elif isinstance(node, PhysHashAgg):
            parts.append(
                f"Agg(g={node.group_exprs!r}, "
                f"a={[(d.name, repr(d.args), str(d.ftype), d.distinct) for d in node.aggs]}, "
                f"r={getattr(node, 'rollup', False)})")
        elif isinstance(node, (PhysTopN, PhysSort)):
            parts.append(f"{type(node).__name__}(by={node.by!r}, "
                         f"descs={node.descs}, "
                         f"k={getattr(node, 'count', None)}, "
                         f"off={getattr(node, 'offset', 0)})")
        elif isinstance(node, PhysLimit):
            parts.append(f"Limit(k={node.count}, off={node.offset})")
        elif isinstance(node, PhysWindow):
            parts.append(f"Window({node.wdescs!r})")
        elif isinstance(node, PhysExchange):
            parts.append(f"Exch({node.kind}, keys={node.keys!r})")
    return "|".join(parts)


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class TreeProgram:
    """One join tree on one device. Inputs: per-scan column dicts
    (original column index → list of per-slab device tuples) + per-scan
    per-slab row counts + positional prepared values (+ per-join aligned
    inputs, + a row range for blocked passes).

    Unique-mode joins emit probe-shaped output (build rows gathered
    through the per-probe-row match index); expand-mode joins emit
    out_cap-shaped output through the expansion. Downstream shapes stay
    static either way. The program object holds only what is fixed per
    signature; each call's state lives in a _TreeRun, so concurrent
    statements may share one program."""

    def __init__(self, plan: PhysicalPlan, caps: Dict[int, object],
                 group_cap: int,
                 join_cfgs: Optional[Sequence[JoinCfg]] = None,
                 agg_key_bounds=None, scan_layouts=None,
                 pairs_out: bool = False, pair_cap: int = 0, *, device):
        from tidb_tpu_torch.executor.fragment import _count_trace
        from tidb_tpu_torch.ops.xp import TorchXP
        _count_trace()
        self.plan = plan
        self.device = torch.device(device)
        self.xp = TorchXP(self.device)
        # id(scan-node) → (slab capacity, n_slabs); plain ints accepted
        self.caps = {k: (v if isinstance(v, tuple) else (v, 1))
                     for k, v in caps.items()}
        self.group_cap = group_cap
        self.agg_key_bounds = agg_key_bounds
        # the fused per-slab pipeline of a multi-slab DISTINCT aggregate:
        # per-slab (group, value) pair sets (capped at pair_cap) so the
        # host can dedup across slabs
        self.pairs_out = pairs_out
        self.pair_cap = pair_cap
        joins = _walk_joins(plan)
        if join_cfgs is None:
            join_cfgs = [JoinCfg("unique") for _ in joins]
        self.join_cfgs = {id(n): c for n, c in zip(joins, join_cfgs)}
        self.join_order = {id(n): i for i, n in enumerate(joins)}
        self.scan_order = _scans(plan)
        # per-scan-slot ((col, ColLayout), ...) pairs, parallel to
        # scan_order: compressed columns decode (K2) at the scan emit
        self.scan_layouts = tuple(scan_layouts) if scan_layouts \
            else tuple(() for _ in self.scan_order)
        # blocked expand: the probe anchor scans whose rows are range-
        # masked per pass (derived from plan structure — deterministic)
        self.ranged_scans = set()
        for n, c in zip(joins, join_cfgs):
            if c.blocked:
                bi = 1 if n.build_right else 0
                anchor = aligned_anchor(n.children[1 - bi])
                if anchor is not None:
                    self.ranged_scans.add(id(anchor))
        if isinstance(plan, PhysHashAgg):
            self.aggs = [build_agg(d) for d in plan.aggs]
        self.prep_nodes: List[Expression] = []
        for node in _walk_nodes(plan):
            for e in _stage_exprs(node):
                for sub in e.walk():
                    if type(sub).prepare is not Expression.prepare:
                        self.prep_nodes.append(sub)

    def collect_preps(self, flow_list: List[List]) -> List:
        """Prepared values in structural order, on the program's device.

        flow_list: per-node input dictionary lists in _walk_nodes order of
        the CALLER's (structurally identical) plan. Positional alignment —
        not node identity — because program cache hits reuse this program
        for fresh plan objects whose node ids differ."""
        from tidb_tpu_torch.ops.xp import to_device_tree
        vals = []
        for node, dicts in zip(_walk_nodes(self.plan), flow_list):
            for e in _stage_exprs(node):
                for sub in e.walk():
                    if type(sub).prepare is not Expression.prepare:
                        vals.append(to_device_tree(self.xp,
                                                   sub.prepare(dicts)))
        return vals

    def __call__(self, scan_inputs, scan_rows, prep_vals,
                 aligned_inputs=(), ranges=None):
        run = _TreeRun(self, prep_vals, aligned_inputs, ranges)
        cols, live = run.emit(self.plan, scan_inputs, scan_rows)
        return run.finish(cols, live)


class _TreeRun:
    """The per-call state of one TreeProgram run."""

    def __init__(self, prog: TreeProgram, prep_vals, aligned_inputs,
                 ranges):
        self.prog = prog
        self.xp = prog.xp
        self.prepared = {id(n): v for n, v in zip(prog.prep_nodes, prep_vals)
                         if v is not None}
        self.unique_flags: List = []
        self.totals: List = []
        self.aligned_inputs = aligned_inputs
        self.ranges = ranges            # (start, stop) for ranged scans
        self.scan_sub: Dict[int, tuple] = {}   # id(scan) → FK-aligned build

    def ctx(self, cols):
        return EvalContext(self.xp, cols, prepared=self.prepared,
                           on_device=True)

    def _filter(self, cols, live, conds):
        ctx = self.ctx(cols)
        for c in conds:
            v, m = c.eval(ctx)
            live = live & (v != 0) & m
        return live

    def emit(self, node: PhysicalPlan, scan_inputs, scan_rows):
        """→ (cols [(v,m) or None per schema position], live) for non-root
        nodes; root reductions are handled in finish. The column list is
        ALWAYS schema-length so join concatenation stays positionally
        aligned (unused columns ride as None)."""
        if isinstance(node, PhysTableScan):
            sub = self.scan_sub.get(id(node))
            if sub is not None:
                # FK-aligned build scan: columns already live in the fact
                # row space; live starts from the match mask
                col_list, live = sub
                return list(col_list), self._filter(col_list, live,
                                                    node.filters)
            return self._emit_scan(node, scan_inputs, scan_rows)
        if isinstance(node, PhysSelection):
            cols, live = self.emit(node.children[0], scan_inputs, scan_rows)
            return cols, self._filter(cols, live, node.conditions)
        if isinstance(node, PhysProjection):
            cols, live = self.emit(node.children[0], scan_inputs, scan_rows)
            ctx = self.ctx(cols)
            return [e.eval(ctx) for e in node.exprs], live
        if isinstance(node, PhysHashJoin):
            return self._emit_join(node, scan_inputs, scan_rows)
        if isinstance(node, PhysWindow) and node is not self.prog.plan:
            # interior window: compute the window columns here and hand
            # them to the operator above (a window ROOT is emitted by
            # finish through emit_root instead)
            from tidb_tpu_torch.executor import device_emit
            cols, live = self.emit(node.children[0], scan_inputs, scan_rows)
            return device_emit.emit_window_cols(self.ctx(cols), live, node,
                                                cols), live
        if isinstance(node, (PhysHashAgg, PhysTopN, PhysSort, PhysLimit,
                             PhysWindow)):
            return self.emit(node.children[0], scan_inputs, scan_rows)
        raise AssertionError(f"unexpected node {type(node).__name__}")

    def _emit_scan(self, node, scan_inputs, scan_rows):
        from tidb_tpu_torch.executor import device_emit
        prog = self.prog
        slot = next(i for i, s in enumerate(prog.scan_order) if s is node)
        in_cols = scan_inputs[slot]
        slab_cap, n_slabs = prog.caps[id(node)]
        lays = dict(prog.scan_layouts[slot]) \
            if slot < len(prog.scan_layouts) else {}
        # every packed slab of the scan's columns in one K2 call
        packed = [(lays[i], s) for i in range(len(node.schema))
                  if lays.get(i) is not None and in_cols.get(i) is not None
                  for s in in_cols[i]]
        decoded = iter(device_emit.emit_decode_many(packed, slab_cap)
                       if packed else ())
        col_list: List = []
        for i in range(len(node.schema)):
            c = in_cols.get(i)
            if c is None:
                col_list.append(None)
                continue
            if lays.get(i) is not None:
                c = [next(decoded) for _s in c]
            if len(c) == 1:
                col_list.append(c[0])
            else:
                # mega-slab: concatenate (rows are the LAST axis: wide-
                # decimal limb columns are (n_limbs, cap) planes)
                col_list.append((torch.cat([s[0] for s in c], dim=-1),
                                 torch.cat([s[1] for s in c])))
        rows = [int(r) for r in np.asarray(scan_rows[slot]).reshape(-1)]
        total_cap = slab_cap * n_slabs
        iota = torch.arange(total_cap, dtype=torch.int32,
                            device=prog.device)
        if len(rows) == 1:
            live = iota < rows[0]
        else:
            rows_t = torch.tensor(rows, dtype=torch.int32,
                                  device=prog.device)
            live = (iota % slab_cap) < rows_t[iota // slab_cap]
        if id(node) in prog.ranged_scans:
            start, stop = self.ranges
            live = live & (iota >= int(start)) & (iota < int(stop))
        return col_list, self._filter(col_list, live, node.filters)

    # -- join ---------------------------------------------------------------
    def _emit_join(self, node: PhysHashJoin, scan_inputs, scan_rows):
        from tidb_tpu_torch.ops import join as J
        cfg = self.prog.join_cfgs[id(node)]
        if cfg.mode == "aligned":
            return self._emit_join_aligned(node, scan_inputs, scan_rows)
        lcols, llive = self.emit(node.children[0], scan_inputs, scan_rows)
        rcols, rlive = self.emit(node.children[1], scan_inputs, scan_rows)
        if node.build_right:
            bcols, blive, pcols, plive = rcols, rlive, lcols, llive
        else:
            bcols, blive, pcols, plive = lcols, llive, rcols, rlive
        bkeys, pkeys = join_key_exprs(node)
        bk = [e.eval(self.ctx(bcols)) for e in bkeys]
        pk = [e.eval(self.ctx(pcols)) for e in pkeys]
        if cfg.bounds is not None:
            if cfg.mode == "unique":
                match_idx, matched, unique = J.lut_join_unique(
                    bk, pk, cfg.bounds, cfg.domain, blive, plive)
            else:
                start, count, order = J.lut_join_multi(
                    bk, pk, cfg.bounds, cfg.domain, blive, plive)
        else:
            # shared exact code space: factorize over build ++ probe
            nb = blive.shape[0]
            both = []
            for (bv, bm), (pv, pm) in zip(bk, pk):
                dt = torch.promote_types(bv.dtype, pv.dtype)
                both.append((torch.cat([bv.to(dt), pv.to(dt)]),
                             torch.cat([bm, pm])))
            both_live = torch.cat([blive, plive])
            codes, cvalid = J.combine_keys(both, both_live)
            bound = (both_live.shape[0] + 1) ** 2
            if cfg.mode == "unique":
                match_idx, matched, unique = J.sorted_probe_unique(
                    codes[:nb], cvalid[:nb], blive, codes[nb:],
                    cvalid[nb:], plive, code_bound=bound)
            else:
                start, count, order = J.sorted_probe_multi(
                    codes[:nb], cvalid[:nb] & blive, codes[nb:],
                    cvalid[nb:] & plive, code_bound=bound)
        if cfg.mode == "unique":
            self.unique_flags.append(unique)
            self.totals.append(torch.zeros((), dtype=torch.int64,
                                           device=plive.device))
            return self._finish_join_unique(node, bcols, pcols, plive,
                                            match_idx, matched)
        self.unique_flags.append(torch.ones((), dtype=torch.bool,
                                            device=plive.device))
        return self._finish_join_expand(node, cfg, bcols, pcols, plive,
                                        start, count, order)

    def _emit_join_aligned(self, node: PhysHashJoin, scan_inputs,
                           scan_rows):
        """FK-aligned join: the build side's columns arrive pre-gathered
        into the fact row space (device_cache.AlignedJoin), so the join is
        no device work beyond evaluating the build side's filters on the
        aligned columns. Probe rowspace is preserved exactly — unique-mode
        semantics with an identity gather."""
        bi = 1 if node.build_right else 0
        build, probe = node.children[bi], node.children[1 - bi]
        ji = self.prog.join_order[id(node)]
        matched_slabs, col_slabs = self.aligned_inputs[ji]
        matched = (matched_slabs[0] if len(matched_slabs) == 1
                   else torch.cat(list(matched_slabs)))
        bscan = aligned_anchor(build)
        sub_cols = []
        for i in range(len(bscan.schema)):
            c = col_slabs.get(i)
            if c is None:
                sub_cols.append(None)
            elif len(c) == 1:
                sub_cols.append(c[0])
            else:
                sub_cols.append((torch.cat([s[0] for s in c], dim=-1),
                                 torch.cat([s[1] for s in c])))
        pcols, plive = self.emit(probe, scan_inputs, scan_rows)
        self.scan_sub[id(bscan)] = (sub_cols, matched)
        try:
            bcols, bmatched = self.emit(build, scan_inputs, scan_rows)
        finally:
            del self.scan_sub[id(bscan)]
        self.unique_flags.append(torch.ones((), dtype=torch.bool,
                                            device=plive.device))
        self.totals.append(torch.zeros((), dtype=torch.int64,
                                       device=plive.device))
        joined = (list(pcols) + list(bcols) if node.build_right
                  else list(bcols) + list(pcols))
        if node.other_conditions:
            bmatched = self._filter(joined, bmatched, node.other_conditions)
        if node.kind == "semi":
            return list(pcols), plive & bmatched
        if node.kind == "anti":
            return list(pcols), plive & ~bmatched
        # null-extend build columns wherever the match (or its filters /
        # conditions) failed — correct for outer, harmless for inner
        bcols = [None if c is None else (c[0], c[1] & bmatched)
                 for c in bcols]
        joined = (list(pcols) + list(bcols) if node.build_right
                  else list(bcols) + list(pcols))
        if node.kind == "inner":
            return joined, plive & bmatched
        return joined, plive     # left/right outer: probe side preserved

    @staticmethod
    def _gather(cols, idx, keep):
        """Every present column's rows through `idx`, the masks AND-ed with
        `keep`: one K18 call (wide-decimal limb planes keep their axis);
        `None` entries keep their place."""
        from tidb_tpu_torch.ops.gather import gather_columns
        got = iter(gather_columns([c for c in cols if c is not None], idx,
                                  keep=keep))
        return [None if c is None else next(got) for c in cols]

    def _finish_join_unique(self, node, bcols, pcols, plive, match_idx,
                            matched):
        bgathered = self._gather(bcols, match_idx, matched)
        joined = (list(pcols) + bgathered if node.build_right
                  else bgathered + list(pcols))
        if node.other_conditions:
            matched = self._filter(joined, matched, node.other_conditions)
            if node.kind in ("left", "right"):
                # failed condition → unmatched: null-extend, keep the row
                bgathered = self._gather(bcols, match_idx, matched)
                joined = (list(pcols) + bgathered if node.build_right
                          else bgathered + list(pcols))
        if node.kind == "semi":
            return list(pcols), plive & matched
        if node.kind == "anti":
            return list(pcols), plive & ~matched
        if node.kind == "inner":
            return joined, plive & matched
        # left/right outer: tree_ok guarantees probe == preserved side, so
        # every live probe row survives (null-extended when unmatched)
        return joined, plive

    def _finish_join_expand(self, node, cfg: JoinCfg, bcols, pcols, plive,
                            start, count, order):
        from tidb_tpu_torch.ops import join as J
        from tidb_tpu_torch.ops import segment as seg
        P = plive.shape[0]
        if node.kind in ("semi", "anti") and not node.other_conditions:
            self.totals.append(torch.zeros((), dtype=torch.int64,
                                           device=plive.device))
            matched = count > 0
            live = plive & (matched if node.kind == "semi" else ~matched)
            return list(pcols), live
        outer = node.kind in ("left", "right")
        p_idx, b_idx, matched, out_live, k, total = J.expand(
            start, count, order, cfg.out_cap, outer, plive)
        self.totals.append(total)
        pcols_e = self._gather(pcols, p_idx, out_live)
        bcols_e = self._gather(bcols, b_idx, matched)
        joined = (pcols_e + bcols_e if node.build_right
                  else bcols_e + pcols_e)
        passing = matched
        if node.other_conditions:
            passing = self._filter(joined, matched, node.other_conditions)
        if node.kind in ("semi", "anti"):
            pass_any = seg.segment_any(self.xp, passing & out_live, p_idx, P)
            live = plive & (pass_any if node.kind == "semi" else ~pass_any)
            return list(pcols), live
        if node.kind == "inner":
            return joined, out_live & passing
        # outer: every live probe row keeps ≥1 slot; a probe row none of
        # whose matches pass emits ONE null-extended row (its first slot)
        pass_cnt = seg.segment_count(self.xp, passing & out_live, p_idx, P)
        keep_extended = (k == 0) & (pass_cnt[p_idx] == 0)
        live = out_live & (passing | keep_extended)
        if node.other_conditions:
            # null-extend build cols on slots whose condition failed
            bcols_e = self._gather(bcols, b_idx, passing)
            joined = (pcols_e + bcols_e if node.build_right
                      else bcols_e + pcols_e)
        return joined, live

    # -- root reductions ------------------------------------------------------
    def finish(self, cols, live):
        from tidb_tpu_torch.executor import device_emit
        prog = self.prog
        root = prog.plan
        dev = prog.device
        out_flags = {
            "join_unique": (torch.stack(self.unique_flags)
                            if self.unique_flags
                            else torch.zeros(0, dtype=torch.bool,
                                             device=dev)),
            "join_totals": (torch.stack(self.totals) if self.totals
                            else torch.zeros(0, dtype=torch.int64,
                                             device=dev)),
        }
        if isinstance(root, PhysHashAgg):
            out = device_emit.emit_root(self.ctx(cols), live, root,
                                        aggs=prog.aggs,
                                        group_cap=prog.group_cap,
                                        key_bounds=prog.agg_key_bounds,
                                        pairs_out=prog.pairs_out,
                                        pair_cap=prog.pair_cap)
            out.update(out_flags)
            return out
        # row roots emit every schema column; unused (None) positions
        # become all-NULL placeholders so output stays positionally aligned
        n = live.shape[0]
        cols = [(torch.zeros(n, dtype=torch.int64, device=dev),
                 torch.zeros(n, dtype=torch.bool, device=dev))
                if c is None else c for c in cols]
        out = device_emit.emit_root(self.ctx(cols), live, root)
        out.update(out_flags)
        return out


def dictionary_flows(plan: PhysicalPlan,
                     scan_dicts: Dict[int, Dict[int, Optional[np.ndarray]]]
                     ) -> Tuple[Dict[int, List], List]:
    """Host-side mirror of the program: per-node input dictionaries and the
    root's output dictionary list. scan_dicts: id(scan) → {col_idx: dict}.
    Lists are schema-length, mirroring emit's positional alignment."""
    flows: Dict[int, List] = {}

    def rec(node: PhysicalPlan) -> List:
        if isinstance(node, PhysTableScan):
            d = scan_dicts.get(id(node), {})
            out = [d.get(i) for i in range(len(node.schema))]
            flows[id(node)] = out
            return out
        child_flows = [rec(c) for c in node.children]
        if isinstance(node, PhysHashJoin):
            l, r = child_flows
            nl = len(node.children[0].schema)
            nr = len(node.children[1].schema)
            l = (l + [None] * nl)[:nl]
            r = (r + [None] * nr)[:nr]
            if node.kind in ("semi", "anti"):
                out = l       # semi/anti emit the left (probe) side
            else:
                out = l + r
            flows[id(node)] = l + r
            return out
        inp = child_flows[0]
        flows[id(node)] = inp
        if isinstance(node, PhysProjection):
            return [inp[e.index] if isinstance(e, ColumnRef)
                    and e.index < len(inp) else None for e in node.exprs]
        if isinstance(node, PhysHashAgg):
            out = []
            for e in node.group_exprs:
                out.append(inp[e.index] if isinstance(e, ColumnRef)
                           and e.index < len(inp) else None)
            out.extend([None] * len(node.aggs))
            return out
        if isinstance(node, PhysWindow):
            # window columns are numbers: no dictionary
            return inp + [None] * len(node.wdescs)
        return inp

    root_out = rec(plan)
    return flows, root_out

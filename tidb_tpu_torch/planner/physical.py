"""Physical planning (ref: planner/core/find_best_task.go, task_type.go).

The reference runs a cost-based search over root/cop/mpp task types; the
analytical subset here has essentially one good physical shape per logical
operator (hash agg, hash join, merged TopN), so physical planning is a
direct mapping plus two genuinely cost-based choices, the same two the
reference's MPP path makes:

  * join build-side selection by estimated cardinality
    (exhaust_physical_plans.go hash-join enumeration);
  * engine routing: subtrees whose operators are device-capable and whose
    estimated input rows clear `tpu_row_threshold` are tagged engine="tpu"
    and later fused into one jitted program — the TiFlash/MppTaskType
    precedent (planner/property/task_type.go:43).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from tidb_tpu_torch.expression import ColumnRef, Expression
from tidb_tpu_torch.expression.aggfuncs import AggDesc, build_agg
from tidb_tpu_torch.planner.logical import (LogicalAggregation, LogicalDataSource,
                                      LogicalDual, LogicalJoin, LogicalLimit,
                                      LogicalMemTable, LogicalPlan,
                                      LogicalProjection, LogicalSelection,
                                      LogicalSort, LogicalTopN,
                                      LogicalUnionAll, LogicalWindow,
                                      Schema)

DEFAULT_TPU_ROW_THRESHOLD = 32768


class PhysicalPlan:
    schema: Schema
    children: List["PhysicalPlan"]
    engine: str = "cpu"          # cpu | tpu (fragment-fused)
    est_rows: float = 0.0

    def __init__(self, schema: Schema, children=()):
        self.schema = schema
        self.children = list(children)

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Phys", "")

    def describe(self) -> str:
        return ""

    def explain_lines(self, indent: int = 0) -> List[Tuple[str, str, str]]:
        """rows of (operator, estRows, info) for EXPLAIN."""
        d = self.describe()
        rows = [("  " * indent + ("└─" if indent else "") + self.name,
                 f"{self.est_rows:.0f}", d)]
        for c in self.children:
            rows.extend(c.explain_lines(indent + 1))
        return rows


class PhysTableScan(PhysicalPlan):
    def __init__(self, ds: LogicalDataSource):
        super().__init__(ds.schema)
        self.table = ds.table
        self.alias = ds.alias
        self.filters = ds.filters
        self.used_columns = ds.used_columns
        # pruned partition ordinals (None = unpartitioned table); set by
        # _to_physical from the pushed-down filters
        self.partitions = None

    def describe(self):
        s = f"table:{self.table.name}"
        p = getattr(self.table, "partition", None)
        if p is not None and self.partitions is not None:
            if len(self.partitions) == p.n_parts:
                s += ", partition:all"
            else:
                s += ", partition:" + ",".join(
                    p.names[i] for i in self.partitions)
        if self.filters:
            s += f", filters:{self.filters}"
        return s


class PhysIndexScan(PhysicalPlan):
    """Point/range access through a sorted index view (ref:
    planner/core/point_get_plan.go + PhysicalIndexReader). Chosen over a
    full scan when ranger-derived ranges are selective; residual filters
    run after the gather."""

    def __init__(self, ds: LogicalDataSource, key_col: int,
                 index_name: str, ranges, residual,
                 key_cols=None, prefix_vals=()):
        super().__init__(ds.schema)
        self.table = ds.table
        self.alias = ds.alias
        self.key_col = key_col
        self.index_name = index_name
        self.ranges = ranges
        self.residual = residual
        # multi-column prefix access (util/ranger/detacher.go): leading
        # columns pinned to prefix_vals, ranges over key_cols[len(prefix)]
        self.key_cols = key_cols          # None → single-column index
        self.prefix_vals = list(prefix_vals)
        self.used_columns = ds.used_columns
        self.filters = []          # scan-compat (fragment gate reads this)

    def describe(self):
        s = (f"table:{self.table.name}, index:{self.index_name}, ")
        if self.key_cols and len(self.key_cols) > 1:
            s += f"prefix:{self.prefix_vals!r}, "
        s += f"ranges:{self.ranges!r}"
        if self.residual:
            s += f", residual:{self.residual!r}"
        return s


class PhysMemTable(PhysicalPlan):
    """Virtual-table scan (infoschema memtable)."""

    def __init__(self, mt: LogicalMemTable):
        super().__init__(mt.schema)
        self.mt_name = mt.mt_name
        self.rows_fn = mt.rows_fn

    def describe(self):
        return f"memtable:information_schema.{self.mt_name}"


class PhysDual(PhysicalPlan):
    def __init__(self, schema: Schema, n_rows: int):
        super().__init__(schema)
        self.n_rows = n_rows


class PhysSelection(PhysicalPlan):
    def __init__(self, conditions, child):
        super().__init__(child.schema, [child])
        self.conditions = conditions

    def describe(self):
        return f"{self.conditions}"


class PhysProjection(PhysicalPlan):
    def __init__(self, exprs, schema, child):
        super().__init__(schema, [child])
        self.exprs = exprs

    def describe(self):
        return f"{self.exprs}"


class PhysHashAgg(PhysicalPlan):
    """Two-phase segment-reduce aggregation (ref: executor/aggregate.go)."""

    def __init__(self, group_exprs, aggs: List[AggDesc], schema, child,
                 rollup: bool = False):
        super().__init__(schema, [child])
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.rollup = rollup       # GROUP BY ... WITH ROLLUP super-aggregates

    def describe(self):
        return (f"group:{self.group_exprs} "
                f"funcs:{[(a.name, a.args, a.distinct) for a in self.aggs]}"
                + (" rollup" if self.rollup else ""))


class PhysHashJoin(PhysicalPlan):
    """build_right: which child is the hash-table side (ref: join.go)."""

    def __init__(self, kind, left, right, equi, other_conditions, schema,
                 build_right: bool):
        super().__init__(schema, [left, right])
        self.kind = kind
        self.equi = equi
        self.other_conditions = other_conditions
        self.build_right = build_right

    def describe(self):
        return (f"{self.kind} join, build:{'right' if self.build_right else 'left'}, "
                f"equi:{self.equi}" +
                (f", other:{self.other_conditions}"
                 if self.other_conditions else ""))


class PhysIndexLookupJoin(PhysicalPlan):
    """Small-outer equi join probing the inner table's sorted index
    instead of scanning it (ref: executor/index_lookup_join.go:59).
    children[0] is the outer (probe, preserved) side; the inner table is
    accessed only at matched positions."""

    def __init__(self, kind, outer, inner_table, inner_key_col: int,
                 index_name: str, outer_key, inner_filters,
                 other_conditions, schema):
        super().__init__(schema, [outer])
        self.kind = kind                  # inner | left | semi | anti
        self.inner_table = inner_table
        self.inner_key_col = inner_key_col
        self.index_name = index_name
        self.outer_key = outer_key        # expr over the outer schema
        self.inner_filters = inner_filters
        self.other_conditions = other_conditions

    def describe(self):
        return (f"{self.kind} join, inner:{self.inner_table.name} "
                f"index:{self.index_name}, key:{self.outer_key!r}")


class PhysMergeJoin(PhysicalPlan):
    """Inner join merged over both sides' cached sorted-index views
    (ref: executor/merge_join.go; inputs arrive key-ordered from
    indexes, so no hash build and no per-query sort)."""

    def __init__(self, left_table, left_key: int, left_index: str,
                 right_table, right_key: int, right_index: str,
                 left_filters, right_filters, other_conditions, schema):
        super().__init__(schema)
        self.left_table = left_table
        self.left_key = left_key
        self.left_index = left_index
        self.right_table = right_table
        self.right_key = right_key
        self.right_index = right_index
        self.left_filters = left_filters
        self.right_filters = right_filters
        self.other_conditions = other_conditions

    def describe(self):
        return (f"inner merge join, {self.left_table.name}."
                f"{self.left_index} × {self.right_table.name}."
                f"{self.right_index}")


class PhysStreamAgg(PhysicalPlan):
    """Grouped aggregation streamed over a sorted-index view: the group
    key arrives in key order from the cached SortedIndex, so grouping is
    run-boundary detection — no hash table, no factorize sort (ref:
    executor/aggregate.go StreamAggExec over index readers; chosen by
    cost in exhaust_physical_plans.go when a child supplies the order).
    Cost-picked over hash agg when the group count is a large fraction of
    the input (planner/cost.py stream_agg vs hash_agg)."""

    def __init__(self, group_exprs, aggs, schema, table, key_col: int,
                 index_name: str, filters):
        super().__init__(schema)
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.table = table
        self.key_col = key_col
        self.index_name = index_name
        self.filters = filters          # scan-level filters, pre-agg

    def describe(self):
        return (f"stream over {self.table.name}.{self.index_name}, "
                f"group:[{self.group_exprs!r}] "
                f"funcs:{[(d.name, repr(d.args)) for d in self.aggs]}")


class PhysIndexOrderedScan(PhysicalPlan):
    """Full scan emitted in index-key order — ORDER BY elimination via an
    index supplying the order (ref: planner/core/find_best_task.go
    getOriginalPhysicalIndexScan keep-order path). NULLs first ascending,
    last descending (MySQL sort order)."""

    def __init__(self, table, key_col: int, index_name: str, desc: bool,
                 filters, schema):
        super().__init__(schema)
        self.table = table
        self.key_col = key_col
        self.index_name = index_name
        self.desc = desc
        self.filters = filters

    def describe(self):
        return (f"table:{self.table.name}, order:{self.index_name}"
                f"{' desc' if self.desc else ''}"
                + (f", filters:{self.filters}" if self.filters else ""))


class PhysWindow(PhysicalPlan):
    """Window functions over sorted partitions (ref: executor/window.go:31;
    computed whole-column via ops/window.py instead of streamed frames)."""

    def __init__(self, wdescs, schema, child):
        super().__init__(schema, [child])
        self.wdescs = wdescs

    def describe(self):
        return f"{self.wdescs!r}"


class PhysSort(PhysicalPlan):
    def __init__(self, by, descs, child):
        super().__init__(child.schema, [child])
        self.by = by
        self.descs = descs

    def describe(self):
        return f"by:{list(zip(self.by, self.descs))}"


class PhysTopN(PhysicalPlan):
    def __init__(self, by, descs, offset, count, child):
        super().__init__(child.schema, [child])
        self.by = by
        self.descs = descs
        self.offset = offset
        self.count = count

    def describe(self):
        return (f"by:{list(zip(self.by, self.descs))}, "
                f"offset:{self.offset}, count:{self.count}")


class PhysLimit(PhysicalPlan):
    def __init__(self, offset, count, child):
        super().__init__(child.schema, [child])
        self.offset = offset
        self.count = count

    def describe(self):
        return f"offset:{self.offset}, count:{self.count}"


class PhysUnionAll(PhysicalPlan):
    def __init__(self, schema, children):
        super().__init__(schema, children)


class PhysExchange(PhysicalPlan):
    """Data redistribution boundary inside a distributed fragment.

    The analog of PhysicalExchangeSender/Receiver with tipb.ExchangeType
    (planner/core/physical_plans.go:895-923): kind='hash' repartitions rows
    by key hash (all_to_all over ICI), kind='broadcast' replicates the
    child to every shard (all_gather). Inserted by insert_exchanges, the
    fragmentation pass (planner/core/fragment.go:64 analog); consumed by
    the shard_map compiler in executor/dist_fragment.py."""

    def __init__(self, child: PhysicalPlan, kind: str, keys=()):
        super().__init__(child.schema, [child])
        self.kind = kind           # hash | broadcast
        self.keys = list(keys)     # hash keys (exprs over child schema)
        self.est_rows = child.est_rows

    @property
    def name(self) -> str:
        return f"Exchange[{self.kind}]"

    def describe(self):
        return f"keys:{self.keys}" if self.kind == "hash" else ""


def insert_exchanges(node: PhysicalPlan, n_shards: int) -> PhysicalPlan:
    """Fragmentation pass for a device fragment subtree: choose and insert
    exchange boundaries under every join (the planner-side MPP decision —
    broadcast when replicating the build side is cheaper than
    repartitioning both sides, else hash on the equi keys). DISTINCT agg
    roots additionally re-key the exchange on their group keys (or the
    distinct value for global aggs) so per-shard dedup is globally exact
    (the repartition trick of cophandler/mpp_exec.go:158-173)."""
    node.children = [insert_exchanges(c, n_shards) for c in node.children]
    if isinstance(node, PhysWindow):
        # co-locate every window partition on one shard (dist_ok already
        # guaranteed all specs share one non-empty partition key list)
        keys = list(node.wdescs[0].partition)
        node.children[0] = PhysExchange(node.children[0], "hash", keys)
        return node
    if isinstance(node, PhysHashAgg) and \
            any(d.distinct for d in node.aggs):
        keys = list(node.group_exprs)
        if not keys:
            keys = [d.args[0] for d in node.aggs if d.distinct][:1]
        node.children[0] = PhysExchange(node.children[0], "hash", keys)
        return node
    if not isinstance(node, PhysHashJoin) or not node.equi:
        return node
    from tidb_tpu_torch.executor.join import coerce_key_pair
    coerced = [coerce_key_pair(l, r) for l, r in node.equi]
    lkeys = [c[0] for c in coerced]
    rkeys = [c[1] for c in coerced]
    bi = 1 if node.build_right else 0
    build, probe = node.children[bi], node.children[1 - bi]
    # broadcast moves build_est*(n-1) rows; hash moves ~build+probe rows
    if build.est_rows * (n_shards - 1) <= build.est_rows + probe.est_rows:
        node.children[bi] = PhysExchange(build, "broadcast")
    else:
        node.children[0] = PhysExchange(node.children[0], "hash", lkeys)
        node.children[1] = PhysExchange(node.children[1], "hash", rkeys)
    return node


class PhysTpuFragment(PhysicalPlan):
    """A fused subtree executed as one jitted device program.

    Ref precedent: the coprocessor/MPP DAG fragment pushed to storage
    (SURVEY §2.4.7, A.2 closure executor) — fusion at fragment granularity,
    one compiled program per fragment, not per operator.
    """

    engine = "tpu"

    def __init__(self, root: PhysicalPlan):
        super().__init__(root.schema)
        self.root = root
        self.dist = 0        # >1 → compiled as an n-shard shard_map program

    def describe(self):
        return f"fused:[{self.root.name}]"

    def explain_lines(self, indent: int = 0):
        info = "engine:tpu" + (f", shards:{self.dist}" if self.dist > 1
                               else "")
        rows = [("  " * indent + ("└─" if indent else "") + "TpuFragment",
                 f"{self.est_rows:.0f}", info)]
        rows.extend(self.root.explain_lines(indent + 1))
        return rows


# ---------------------------------------------------------------------------
# Cardinality estimation (ref: planner/core/find_best_task.go +
# statistics/selectivity.go; histogram/NDV stats from tidb_tpu_torch.statistics)
# ---------------------------------------------------------------------------

SELECTIVITY = 0.25       # default filter selectivity (ref: selectionFactor)
AGG_REDUCTION = 8.0      # fallback group reduction without stats


def _table_stats(table, ctx):
    fn = getattr(ctx, "table_stats", None)
    return fn(table.id) if fn is not None else None


def _scan_of(plan: PhysicalPlan, col_idx: int):
    """Trace a column index down to (scan, scan_col_idx), or None if the
    value is computed, crosses an aggregate, or the shape is unknown."""
    node, idx = plan, col_idx
    while True:
        if isinstance(node, PhysTableScan):
            return node, idx
        if isinstance(node, (PhysSelection, PhysSort, PhysTopN, PhysLimit)):
            node = node.children[0]
            continue
        if isinstance(node, PhysProjection):
            e = node.exprs[idx] if idx < len(node.exprs) else None
            if not isinstance(e, ColumnRef):
                return None
            idx = e.index
            node = node.children[0]
            continue
        if isinstance(node, PhysHashJoin):
            lw = len(node.children[0].schema)
            if node.kind in ("semi", "anti") or idx < lw:
                node = node.children[0]
            else:
                idx -= lw
                node = node.children[1]
            continue
        return None


def _expr_ndv(expr, plan: PhysicalPlan, ctx) -> Optional[float]:
    """NDV of an expression over `plan`'s output, when it is a column
    traceable to an ANALYZEd scan column."""
    from tidb_tpu_torch.statistics import column_ndv
    if not isinstance(expr, ColumnRef):
        return None
    hit = _scan_of(plan, expr.index)
    if hit is None:
        return None
    scan, idx = hit
    stats = _table_stats(scan.table, ctx)
    if stats is None or idx not in stats.columns:
        return None
    return column_ndv(stats, idx, -1.0)


def estimate(plan: PhysicalPlan, ctx) -> float:
    """Bottom-up cardinality; sets est_rows on every node. PhysHashAgg
    additionally gets est_reliable=True when every group key had stats —
    the device engine then trusts est_rows for its initial group cap."""
    if isinstance(plan, PhysIndexScan):
        n = plan.est_rows        # set by _try_index_access from ranges
        if plan.residual and not (plan.key_cols and
                                  len(plan.key_cols) > 1):
            # multi-column paths keep the FULL filter set as re-verify
            # residual; its selectivity is already in the range estimate
            from tidb_tpu_torch.statistics import filters_selectivity
            stats = _table_stats(plan.table, ctx)
            n *= filters_selectivity(plan.residual, stats)
        plan.est_rows = max(n, 1.0)
        return plan.est_rows
    if isinstance(plan, PhysTableScan):
        n = float(_table_rows(plan.table, ctx))
        p = getattr(plan.table, "partition", None)
        if p is not None and plan.partitions is not None and p.n_parts:
            # partition pruning removes whole region sets up front
            n *= len(plan.partitions) / p.n_parts
        if plan.filters:
            from tidb_tpu_torch.statistics import filters_selectivity
            stats = _table_stats(plan.table, ctx)
            n *= filters_selectivity(plan.filters, stats)
        plan.est_rows = max(n, 1.0)
        return plan.est_rows
    if isinstance(plan, PhysIndexOrderedScan):
        n = float(_table_rows(plan.table, ctx))
        if plan.filters:
            from tidb_tpu_torch.statistics import filters_selectivity
            stats = _table_stats(plan.table, ctx)
            n *= filters_selectivity(plan.filters, stats)
        plan.est_rows = max(n, 1.0)
        return plan.est_rows
    if isinstance(plan, PhysStreamAgg):
        from tidb_tpu_torch.statistics import column_ndv
        stats = _table_stats(plan.table, ctx)
        ndv = column_ndv(stats, plan.key_col, -1.0) \
            if stats is not None else -1.0
        n = float(_table_rows(plan.table, ctx))
        plan.est_rows = max(ndv if ndv and ndv > 0 else n / AGG_REDUCTION,
                            1.0)
        return plan.est_rows
    if isinstance(plan, PhysMemTable):
        plan.est_rows = 64.0
        return plan.est_rows
    if isinstance(plan, PhysDual):
        plan.est_rows = float(plan.n_rows)
        return plan.est_rows
    kids = [estimate(c, ctx) for c in plan.children]
    if isinstance(plan, PhysSelection):
        child = plan.children[0]
        n = kids[0]
        if isinstance(child, PhysTableScan):
            from tidb_tpu_torch.statistics import filters_selectivity
            stats = _table_stats(child.table, ctx)
            n *= filters_selectivity(plan.conditions, stats)
        else:
            n *= SELECTIVITY ** min(len(plan.conditions), 2)
        out = max(n, 1.0)
    elif isinstance(plan, PhysHashAgg):
        if not plan.group_exprs:
            out = 1.0
            plan.est_reliable = True
        else:
            child = plan.children[0]
            ndvs = [_expr_ndv(e, child, ctx) for e in plan.group_exprs]
            if all(v is not None and v > 0 for v in ndvs):
                groups = 1.0
                for v in ndvs:
                    groups *= v
                # group keys are rarely independent; cap by input rows
                out = max(min(groups, kids[0]), 1.0)
                plan.est_reliable = True
            else:
                out = max(kids[0] / AGG_REDUCTION, 1.0)
                plan.est_reliable = False
    elif isinstance(plan, PhysHashJoin):
        l, r = kids
        if plan.kind in ("semi", "anti"):
            out = max(l * 0.5, 1.0)
        else:
            # |L ⋈ R| ≈ |L||R| / max(ndv(keys)) (classic equi-join estimate)
            denom = 1.0
            for le, re in plan.equi or []:
                nl = _expr_ndv(le, plan.children[0], ctx)
                nr = _expr_ndv(re, plan.children[1], ctx)
                cand = max(v for v in (nl, nr, 1.0) if v is not None)
                denom = max(denom, cand)
            out = max(l * r / denom if plan.equi else max(l, r), 1.0)
            if plan.kind in ("left", "right"):
                out = max(out, l if plan.kind == "left" else r)
    elif isinstance(plan, PhysMergeJoin):
        from tidb_tpu_torch.statistics import column_ndv
        ln = float(_table_rows(plan.left_table, ctx))
        rn = float(_table_rows(plan.right_table, ctx))
        stats = _table_stats(plan.left_table, ctx)
        ndv = column_ndv(stats, plan.left_key, -1.0) \
            if stats is not None else -1.0
        denom = max(ndv, 1.0) if ndv and ndv > 0 else max(ln, rn, 1.0)
        out = max(ln * rn / denom, 1.0)
    elif isinstance(plan, PhysIndexLookupJoin):
        l = kids[0]
        if plan.kind in ("semi", "anti"):
            out = max(l * 0.5, 1.0)
        else:
            from tidb_tpu_torch.statistics import column_ndv, filters_selectivity
            inner_n = float(_table_rows(plan.inner_table, ctx))
            stats = _table_stats(plan.inner_table, ctx)
            if plan.inner_filters:
                inner_n *= filters_selectivity(plan.inner_filters, stats)
            ndv = column_ndv(stats, plan.inner_key_col, -1.0) \
                if stats is not None else -1.0
            per_key = inner_n / ndv if ndv and ndv > 0 else 1.0
            out = max(l * max(per_key, 0.001), 1.0)
            if plan.kind == "left":
                out = max(out, l)
    elif isinstance(plan, (PhysTopN, PhysLimit)):
        out = float(min(kids[0], plan.count + plan.offset))
    elif isinstance(plan, PhysUnionAll):
        out = float(sum(kids))
    else:
        out = kids[0] if kids else 1.0
    plan.est_rows = out
    return out


def _table_rows(table, ctx) -> int:
    fn = getattr(ctx, "table_row_count", None)
    if fn is None:
        return 100000
    return max(fn(table.id), 1)


# ---------------------------------------------------------------------------
# Logical → physical
# ---------------------------------------------------------------------------


def physical_optimize(plan: LogicalPlan, ctx) -> PhysicalPlan:
    phys = _to_physical(plan, ctx)
    phys.est_rows = estimate(phys, ctx)
    use_tpu = bool(getattr(ctx, "use_tpu", False))
    if use_tpu:
        from tidb_tpu_torch.executor.fragment import extract_fragments
        threshold = int(getattr(ctx, "tpu_row_threshold",
                                DEFAULT_TPU_ROW_THRESHOLD))
        phys = extract_fragments(phys, threshold)
        n_shards = int(getattr(ctx, "dist_devices", 0) or 0)
        if n_shards > 1:
            _distribute_fragments(phys, n_shards, threshold, ctx)
    return phys


def _distribute_fragments(plan: PhysicalPlan, n_shards: int,
                          threshold: int, ctx) -> None:
    """Turn eligible device fragments into n-rank distributed fragments:
    insert exchange boundaries (the fragmentation pass) into a copy of
    the fragment's tree and mark the fragment. Every dist_ok fragment is
    distributed — a staged path or the monolithic program runs it —
    except the two shapes _dist_refused names, which stay single-device
    fragments, unchanged."""
    if isinstance(plan, PhysTpuFragment):
        from tidb_tpu_torch.executor.tree_fragment import dist_ok
        if dist_ok(plan.root, threshold):
            root = insert_exchanges(_clone_tree(plan.root), n_shards)
            if not _dist_refused(root):
                plan.root = root
                plan.dist = n_shards
        return
    for c in plan.children:
        _distribute_fragments(c, n_shards, threshold, ctx)


def _clone_tree(node: PhysicalPlan) -> PhysicalPlan:
    """Shallow copies of every node with fresh children lists:
    insert_exchanges rewrites children in place."""
    clone = copy.copy(node)
    clone.children = [_clone_tree(c) for c in node.children]
    return clone


def _dist_refused(root: PhysicalPlan) -> bool:
    """The exchange-annotated fragments the port keeps single-device
    (with the ORDER BY over an agg stripped, as _run_device_dist strips
    it): a wide-decimal scan column, whose (limbs, rows) values the rank
    slicing does not take (the JAX package's monolithic scan encoder
    writes 1-D values), and a string join key no dictionary unification
    can serve (ci-collated, or not a bare scan column)."""
    from tidb_tpu_torch.executor.dist_fragment import \
        string_join_keys_unifiable
    from tidb_tpu_torch.executor.fragment import _strip_order_root
    from tidb_tpu_torch.executor.tree_fragment import _scans
    _order, root = _strip_order_root(root)
    for scan in _scans(root):
        fts = scan.schema.field_types
        used = scan.used_columns or range(len(fts))
        if any(fts[i].is_wide_decimal for i in used):
            return True
    return not string_join_keys_unifiable(root)


def _indexed_col(table, col_idx: int):
    """Index name covering exactly this column as its first key, or None.
    ci-collated columns report no index: the sorted views compare raw
    codepoints, which disagrees with the collation's fold order."""
    if col_idx >= len(table.columns):
        return None
    if table.columns[col_idx].ftype.is_ci:
        return None
    name = table.columns[col_idx].name.lower()
    if table.primary_key and table.primary_key[0].lower() == name:
        return "PRIMARY"
    for ix in getattr(table, "indexes", []):
        if ix.columns[0].lower() == name and \
                getattr(ix, "state", "public") == "public":
            return ix.name
    return None


def _try_merge_join(join: LogicalJoin, left: PhysicalPlan,
                    right: PhysicalPlan, lrows: float, rrows: float,
                    ctx, force: bool = False) -> Optional["PhysMergeJoin"]:
    """Merge join when BOTH sides are table scans indexed on their
    (uncast, non-string-mixed) join keys — the key-ordered-inputs case of
    exhaust_physical_plans.go's merge-join enumeration. Inner only; other
    kinds keep the hash path. Applicability only: the size trade-off is
    priced by planner/cost.py (the old MERGE_JOIN_MIN_ROWS hard gate is
    now the INDEX_STARTUP cost term)."""
    if getattr(ctx, "use_tpu", False) and not force:
        # large indexed joins fuse into device LUT-join trees instead;
        # the merge join is the CPU engine's answer to this shape
        # (a MERGE_JOIN hint overrides — the user's escape hatch)
        return None
    if join.kind != "inner" or len(join.equi) != 1:
        return None
    if not isinstance(left, PhysTableScan) or \
            not isinstance(right, PhysTableScan):
        return None
    from tidb_tpu_torch.executor.join import coerce_key_pair
    le, re = join.equi[0]
    if le.ftype.kind.is_string != re.ftype.kind.is_string:
        return None
    lc, rc = coerce_key_pair(le, re)
    if lc is not le or rc is not re:
        return None               # raw index values must be comparable
    if not (isinstance(le, ColumnRef) and isinstance(re, ColumnRef)):
        return None
    lix = _indexed_col(left.table, le.index)
    rix = _indexed_col(right.table, re.index)
    if lix is None or rix is None:
        return None
    schema = Schema.concat(left.schema, right.schema)
    return PhysMergeJoin(left.table, le.index, lix, right.table, re.index,
                         rix, list(left.filters), list(right.filters),
                         list(join.other_conditions or []), schema)


INDEX_JOIN_OUTER_CAP = 4096       # max outer rows for index-lookup join
INDEX_JOIN_RATIO = 16.0           # inner must be ≥ this × outer


def _try_index_join(join: LogicalJoin, left: PhysicalPlan,
                    right: PhysicalPlan, lrows: float, rrows: float,
                    ctx) -> Optional[PhysIndexLookupJoin]:
    """Index nested-loop join when the inner side is a scan with an index
    on the (uncast) join key — probing beats a full inner scan for small
    outers (find_best_task.go's index-join enumeration). Applicability
    only on the CPU path: the outer-size trade-off is priced by
    planner/cost.py index_join vs hash_join (the device path still
    applies the legacy hard gate at the call site)."""
    if join.kind not in ("inner", "left", "semi", "anti"):
        return None
    if len(join.equi) != 1 or join.other_conditions and \
            any(is_corr(c) for c in join.other_conditions or []):
        return None
    if not isinstance(right, PhysTableScan):
        return None
    from tidb_tpu_torch.executor.join import coerce_key_pair
    le, re = join.equi[0]
    # string vs numeric keys compare NUMERICALLY in MySQL; the raw index
    # probe can't serve that (coerce_key_pair passes strings through)
    if le.ftype.kind.is_string != re.ftype.kind.is_string:
        return None
    lc, rc = coerce_key_pair(le, re)
    # the index stores RAW values: the inner side must need no cast
    if rc is not re or not isinstance(re, ColumnRef):
        return None
    table = right.table
    idx_name = None
    col_name = table.columns[re.index].name.lower() \
        if re.index < len(table.columns) else None
    if col_name is None:
        return None
    if table.primary_key and table.primary_key[0].lower() == col_name:
        idx_name = "PRIMARY"
    else:
        for ix in getattr(table, "indexes", []):
            if ix.columns[0].lower() == col_name and \
                    getattr(ix, "state", "public") == "public":
                idx_name = ix.name
                break
    if idx_name is None:
        return None
    # other conditions index the concatenated (outer ++ inner) schema —
    # exactly the joined-chunk layout the executor evaluates them on
    if join.kind in ("semi", "anti"):
        schema = Schema(list(left.schema.columns))
    else:
        schema = Schema.concat(left.schema, right.schema)
    out = PhysIndexLookupJoin(join.kind, left, table, re.index, idx_name,
                              lc, list(right.filters),
                              list(join.other_conditions or []), schema)
    return out


def is_corr(e) -> bool:
    from tidb_tpu_torch.expression import CorrelatedRef
    return any(isinstance(s, CorrelatedRef) for s in e.walk())


# ---------------------------------------------------------------------------
# Optimizer hints (ref: planner/optimize.go:138, hint.ParseHintsSet at
# planbuilder.go:865) — the escape hatch when the cost model picks wrong
# ---------------------------------------------------------------------------

_JOIN_HINTS = {"hash_join": "hash", "merge_join": "merge",
               "sm_join": "merge", "inl_join": "inl",
               "index_join": "inl", "inl_lookup_join": "inl"}


def _subtree_names(p: PhysicalPlan) -> set:
    """Table names + aliases appearing under a physical subtree."""
    out = set()
    stack = [p]
    while stack:
        n = stack.pop()
        t = getattr(n, "table", None)
        if t is not None:
            out.add(t.name.lower())
            a = getattr(n, "alias", None)
            if a:
                out.add(str(a).lower())
        stack.extend(n.children)
    return out


def _join_hint(ctx, left: PhysicalPlan, right: PhysicalPlan):
    """→ 'hash' | 'merge' | 'inl' when a join hint names a table on
    either side of THIS join, else None. Last matching hint wins."""
    hints = getattr(ctx, "hints", None)
    if not hints:
        return None
    names = _subtree_names(left) | _subtree_names(right)
    forced = None
    for hname, args in hints:
        algo = _JOIN_HINTS.get(hname)
        if algo and (not args or names & set(args)):
            forced = algo
    return forced


def _agg_hint(ctx):
    hints = getattr(ctx, "hints", None)
    if not hints:
        return None
    forced = None
    for hname, _args in hints:
        if hname == "hash_agg":
            forced = "hash"
        elif hname == "stream_agg":
            forced = "stream"
    return forced


def _try_stream_agg(agg: LogicalAggregation, child: PhysicalPlan,
                    ctx) -> Optional[PhysStreamAgg]:
    """Stream-agg candidate: single bare-ColumnRef group key directly
    over a table scan with an index supplying the key order, no DISTINCT
    aggs (ref: exhaust_physical_plans.go getStreamAggs — property-driven
    there, index-view-driven here). Cost decides at the call site."""
    if getattr(ctx, "use_tpu", False):
        return None                 # device agg is the fused fragment
    if len(agg.group_exprs) != 1 or not isinstance(agg.group_exprs[0],
                                                   ColumnRef):
        return None
    if getattr(agg, "rollup", False):
        return None                 # super-aggregate rows need the hash path
    if any(d.distinct for d in agg.aggs):
        return None
    if not isinstance(child, PhysTableScan):
        return None
    key = agg.group_exprs[0]
    if child.table.columns[key.index].ftype.is_ci:
        return None     # raw-ordered index view ≠ collation order
    ix = _indexed_col(child.table, key.index)
    if ix is None:
        return None
    return PhysStreamAgg(agg.group_exprs, agg.aggs, agg.schema,
                         child.table, key.index, ix,
                         list(child.filters))


def _try_index_order(sort: LogicalSort, child: PhysicalPlan,
                     ctx) -> Optional[PhysIndexOrderedScan]:
    """Sort elimination: ORDER BY a single bare indexed column directly
    over a table scan — the index supplies the order (ref:
    find_best_task.go keep-order index paths / planner/core/
    rule_eliminate_sort). Cost decides at the call site."""
    if getattr(ctx, "use_tpu", False):
        return None                 # device sorts fuse into the fragment
    if len(sort.by) != 1 or not isinstance(sort.by[0], ColumnRef):
        return None
    # projections are 1:1 and order-preserving: trace the key through
    # them to the scan column, then rebuild them over the ordered scan
    idx = sort.by[0].index
    node = child
    wrappers: List[PhysProjection] = []
    while isinstance(node, PhysProjection):
        e = node.exprs[idx] if idx < len(node.exprs) else None
        if not isinstance(e, ColumnRef):
            return None
        idx = e.index
        wrappers.append(node)
        node = node.children[0]
    if not isinstance(node, PhysTableScan):
        return None
    if node.table.columns[idx].ftype.is_ci:
        return None     # raw-ordered index view ≠ collation order
    ix = _indexed_col(node.table, idx)
    if ix is None:
        return None
    out: PhysicalPlan = PhysIndexOrderedScan(
        node.table, idx, ix, bool(sort.descs[0]), list(node.filters),
        node.schema)
    for w in reversed(wrappers):
        out = PhysProjection(w.exprs, w.schema, out)
    return out


INDEX_SELECTIVITY_GATE = 0.15     # index path only below this fraction


def _index_candidates(table) -> List:
    """(col_name, index_name, unique) — PK first, then index prefixes."""
    out = []
    if table.primary_key:
        out.append((table.primary_key[0], "PRIMARY",
                    len(table.primary_key) == 1))
    for ix in table.indexes:
        if getattr(ix, "state", "public") != "public":
            continue               # write-only: invisible to readers
        out.append((ix.columns[0], ix.name,
                    ix.unique and len(ix.columns) == 1))
    return out


def _try_index_access(ds: LogicalDataSource, ctx) -> Optional[PhysIndexScan]:
    """Cost gate (find_best_task.go skyline-lite): point access on a
    unique key always wins; range access needs stats showing the ranges
    select under INDEX_SELECTIVITY_GATE of the table. Multi-column
    indexes try prefix derivation first (detacher.go) and re-verify the
    full filter set on the gathered rows."""
    if not ds.filters:
        return None
    from tidb_tpu_torch.planner.ranger import detach_ranges
    stats = _table_stats(ds.table, ctx)
    total = max(_table_rows(ds.table, ctx), 1)
    multi = _try_multi_col_index(ds, ctx, stats, total)
    best = None
    for col_name, index_name, unique in _index_candidates(ds.table):
        try:
            col_idx = next(i for i, c in enumerate(ds.table.columns)
                           if c.name.lower() == col_name.lower())
        except StopIteration:
            continue
        if ds.table.columns[col_idx].ftype.is_ci:
            continue     # raw-ordered index view ≠ collation order
        ranges, residual = detach_ranges(ds.filters, col_idx)
        if ranges is None:
            continue
        if not ranges:
            est = 0.0              # unsatisfiable → empty
        elif unique and all(r.lo == r.hi and r.lo is not None
                            for r in ranges):
            est = float(len(ranges))
        else:
            cs = stats.columns.get(col_idx) if stats is not None else None
            if cs is None:
                continue           # no stats → can't justify a range scan
            frac = 0.0
            for r in ranges:
                if r.include_null:
                    frac += cs.null_fraction()
                elif r.lo == r.hi and r.lo is not None:
                    frac += cs.eq_selectivity(r.lo)
                else:
                    frac += cs.range_selectivity(r.lo, r.hi, r.lo_incl,
                                                 r.hi_incl)
            if frac > INDEX_SELECTIVITY_GATE:
                continue
            est = frac * total
        if best is None or est < best[0]:
            best = (est, col_idx, index_name, ranges, residual)
    if best is not None and (multi is None or best[0] <= multi.est_rows):
        est, col_idx, index_name, ranges, residual = best
        scan = PhysIndexScan(ds, col_idx, index_name, ranges, residual)
        scan.est_rows = max(est, 1.0)
        return scan
    return multi


def _try_multi_col_index(ds: LogicalDataSource, ctx, stats,
                         total: int) -> Optional[PhysIndexScan]:
    from tidb_tpu_torch.planner.ranger import detach_prefix_ranges
    col_of = {c.name.lower(): i for i, c in enumerate(ds.table.columns)}
    cands = []
    if ds.table.primary_key and len(ds.table.primary_key) > 1:
        cands.append(("PRIMARY", ds.table.primary_key))
    for ix in getattr(ds.table, "indexes", []):
        if len(ix.columns) > 1:
            cands.append((ix.name, ix.columns))
    best = None
    for name, col_names in cands:
        try:
            idxs = [col_of[c.lower()] for c in col_names]
        except KeyError:
            continue
        if any(ds.table.columns[i].ftype.is_ci for i in idxs):
            continue     # raw-ordered index view ≠ collation order
        prefix, ranges, leftover = detach_prefix_ranges(ds.filters, idxs)
        if ranges is None or (not prefix and len(ranges) == 1
                              and ranges[0].lo is None
                              and ranges[0].hi is None):
            continue
        n_used = len(prefix) + 1
        if n_used < 2:
            continue               # single-col candidates handle this
        frac = 1.0
        for lev, v in enumerate(prefix):
            cs = stats.columns.get(idxs[lev]) if stats is not None else None
            frac *= cs.eq_selectivity(v) if cs is not None else 0.1
        range_frac = 0.0
        cs = stats.columns.get(idxs[len(prefix)]) if stats is not None \
            else None
        for r in ranges:
            if cs is None:
                range_frac += 0.1
            elif r.lo == r.hi and r.lo is not None:
                range_frac += cs.eq_selectivity(r.lo)
            else:
                range_frac += cs.range_selectivity(r.lo, r.hi, r.lo_incl,
                                                   r.hi_incl)
        frac *= min(range_frac, 1.0)
        if frac > INDEX_SELECTIVITY_GATE:
            continue
        # conjuncts the prefix didn't consume still narrow the estimate
        # (the re-verify residual is the FULL set; est must not skip them)
        if leftover:
            from tidb_tpu_torch.statistics import filters_selectivity
            frac *= filters_selectivity(leftover, stats)
        est = max(frac * total, 1.0)
        if best is None or est < best[0]:
            best = (est, idxs[:n_used], name, prefix, ranges)
    if best is None:
        return None
    est, key_cols, name, prefix, ranges = best
    # the prefix probe over-approximates (NULL-sentinel fill): the FULL
    # original filter set re-verifies on the gathered rows
    scan = PhysIndexScan(ds, key_cols[0], name, ranges,
                         list(ds.filters), key_cols=key_cols,
                         prefix_vals=prefix)
    scan.est_rows = est
    return scan


def _to_physical(plan: LogicalPlan, ctx) -> PhysicalPlan:
    if isinstance(plan, LogicalDataSource):
        idx = _try_index_access(plan, ctx)
        if idx is not None:
            return idx
        scan = PhysTableScan(plan)
        if getattr(plan.table, "partition", None) is not None:
            from tidb_tpu_torch.planner.partition import prune_partitions
            scan.partitions = prune_partitions(plan.table, plan.filters)
        return scan
    if isinstance(plan, LogicalMemTable):
        return PhysMemTable(plan)
    if isinstance(plan, LogicalDual):
        return PhysDual(plan.schema, plan.n_rows)
    kids = [_to_physical(c, ctx) for c in plan.children]
    if isinstance(plan, LogicalSelection):
        return PhysSelection(plan.conditions, kids[0])
    if isinstance(plan, LogicalProjection):
        return PhysProjection(plan.exprs, plan.schema, kids[0])
    if isinstance(plan, LogicalAggregation):
        ha = PhysHashAgg(plan.group_exprs, plan.aggs, plan.schema, kids[0],
                         rollup=getattr(plan, "rollup", False))
        sa = _try_stream_agg(plan, kids[0], ctx)
        if sa is None:
            return ha
        hint = _agg_hint(ctx)
        if hint is not None:
            return sa if hint == "stream" else ha
        from tidb_tpu_torch.planner import cost as C
        rows = estimate(kids[0], ctx)
        groups = estimate(ha, ctx)
        sa.est_rows = groups
        # the stream path gathers the WHOLE table through the index
        # permutation before filtering — price the full row count, while
        # the hash path streams only the filtered scan
        full = float(_table_rows(sa.table, ctx))
        if C.stream_agg(full, groups) < C.hash_agg(rows, groups):
            return sa
        return ha
    if isinstance(plan, LogicalJoin):
        left, right = kids
        lrows = estimate(left, ctx)
        rrows = estimate(right, ctx)
        if plan.kind in ("left", "semi", "anti"):
            build_right = True    # probe the outer side
        elif plan.kind == "right":
            build_right = False
        else:
            build_right = rrows <= lrows
        hj = PhysHashJoin(plan.kind, left, right, plan.equi,
                          plan.other_conditions, plan.schema, build_right)
        forced = _join_hint(ctx, left, right)
        if forced is not None:
            # the hint is the escape hatch: it overrides cost AND engine
            # steering (a hinted merge join comes off the device path)
            if forced == "merge":
                mj = _try_merge_join(plan, left, right, lrows, rrows, ctx,
                                     force=True)
                if mj is not None:
                    return mj
            elif forced == "inl":
                ilj = _try_index_join(plan, left, right, lrows, rrows,
                                      ctx)
                if ilj is not None:
                    return ilj
            else:
                return hj
            return hj              # hinted shape inapplicable: hash
        if getattr(ctx, "use_tpu", False):
            # large joins fuse into the device tree engine; the only
            # alternative shape worth taking off it is the tiny-outer
            # index probe (the old hard gate)
            ilj = _try_index_join(plan, left, right, lrows, rrows, ctx)
            if ilj is not None and lrows <= INDEX_JOIN_OUTER_CAP and \
                    rrows >= lrows * INDEX_JOIN_RATIO:
                return ilj
            return hj
        # CPU engine: enumerate applicable shapes, pick by cost
        # (find_best_task.go:285 / exhaust_physical_plans.go, collapsed
        # to a candidates-per-op comparison — no memo needed at this
        # operator count)
        from tidb_tpu_torch.planner import cost as C
        brows, prows = (rrows, lrows) if build_right else (lrows, rrows)
        cands = [(C.hash_join(brows, prows, estimate(hj, ctx)), hj)]
        ilj = _try_index_join(plan, left, right, lrows, rrows, ctx)
        if ilj is not None:
            inner_n = float(_table_rows(ilj.inner_table, ctx))
            cands.append((C.index_join(lrows, inner_n,
                                       estimate(ilj, ctx)), ilj))
        mj = _try_merge_join(plan, left, right, lrows, rrows, ctx)
        if mj is not None:
            ln = float(_table_rows(mj.left_table, ctx))
            rn = float(_table_rows(mj.right_table, ctx))
            cands.append((C.merge_join(ln, rn, estimate(mj, ctx)), mj))
        return min(cands, key=lambda t: t[0])[1]
    if isinstance(plan, LogicalWindow):
        return PhysWindow(plan.wdescs, plan.schema, kids[0])
    if isinstance(plan, LogicalSort):
        ps = PhysSort(plan.by, plan.descs, kids[0])
        alt = _try_index_order(plan, kids[0], ctx)
        if alt is not None:
            from tidb_tpu_torch.planner import cost as C
            rows = estimate(kids[0], ctx)
            # the ordered scan gathers the whole table pre-filter
            node = alt
            while not isinstance(node, PhysIndexOrderedScan):
                node = node.children[0]
            full = float(_table_rows(node.table, ctx))
            if C.index_ordered_scan(full) < C.sort(rows):
                return alt
        return ps
    if isinstance(plan, LogicalTopN):
        return PhysTopN(plan.by, plan.descs, plan.offset, plan.count, kids[0])
    if isinstance(plan, LogicalLimit):
        return PhysLimit(plan.offset, plan.count, kids[0])
    if isinstance(plan, LogicalUnionAll):
        return PhysUnionAll(plan.schema, kids)
    raise AssertionError(f"no physical mapping for {type(plan).__name__}")

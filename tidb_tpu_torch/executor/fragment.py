"""Device fragment extraction & execution (SURVEY §7 stages 3-5).

A fragment is a maximal device-capable chain `scan → selection* →
projection* → [hash-agg | topN | sort | window]`, or a join tree of such
chains under equi hash joins (executor/tree_fragment.py — the TPC-H Q3/Q5
shape; also a window inside a tree, over a join or under another operator),
run on the engine's torch device — the analog of the coprocessor DAG the
reference pushes to storage (SURVEY A.2: unistore's closure executor fuses
scan→selection→agg into a single callback, closure_exec.go; plan_to_pb.go
ships subtrees to TiFlash).

Execution model:
  * the scan side is materialized host-side (regions are already columnar),
    encoded ONCE into compressed power-of-two slabs and uploaded to the
    device cache (executor/device_cache.py); string columns become sorted-
    dictionary codes, so ORDER BY / range predicates work on codes;
  * each slab runs decode (K2) → filter/projection → root reduction
    eagerly on the device; grouped aggregation is perfect-hash grouping
    (K3) or sort-based factorize plus segment reductions (K1) with an
    explicit group capacity; capacity overflow is detected via the
    returned n_groups and retried through the capacity ladder;
  * filters never compact on device — they narrow the live mask that
    every downstream kernel consumes;
  * the gate below admits only shapes and scalar functions this port runs
    on the device; everything else runs on the CPU volcano engine, decided
    at PLAN time (EXPLAIN shows it). An unexpected device error RAISES —
    there is no silent CPU re-run. FragmentFallback keeps the
    data-dependent declines (empty input, exhausted capacity ladder),
    which run the embedded CPU subtree unless tidb_tpu_strict is set.

Programs are cached process-wide keyed by plan structure + dtypes + slab /
group capacities + layouts + device: a program holds the chain and the
prepared-input ordering of its expression nodes, so a repeated statement
skips the chain walk.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("tidb_tpu_torch.fragment")

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.expression import EvalContext, Expression, ColumnRef
from tidb_tpu_torch.expression.aggfuncs import AggFunc, build_agg
from tidb_tpu_torch.planner.physical import (PhysHashAgg, PhysHashJoin,
                                             PhysLimit,
                                             PhysProjection, PhysSelection,
                                             PhysSort, PhysTableScan,
                                             PhysTopN, PhysTpuFragment,
                                             PhysWindow, PhysicalPlan)
from tidb_tpu_torch.types import FieldType

DEFAULT_MAX_SLAB_ROWS = 1 << 23   # 8M rows per device slab
DEFAULT_GROUP_CAP = 1 << 16
# group caps at or below this ride the flag fetch (padded keys/states are
# a few MB) — the result then needs no second device→host round trip
SMALL_GROUP_CAP = 1 << 14


def _piggyback_agg(fetch: dict, out, group_cap: int) -> bool:
    if group_cap <= SMALL_GROUP_CAP:
        fetch["keys"] = out["keys"]
        fetch["states"] = out["states"]
        return True
    return False


# The closed fallback-reason taxonomy: every way a fragment can decline
# the device path maps to ONE of these stable codes. The code is what
# EXPLAIN ANALYZE prints as `device:fallback(code)` and the `reason`
# label on tidb_tpu_device_fallbacks_total — free-text detail rides
# along for logs but never reaches a metric label (bounded cardinality).
FALLBACK_REASONS = (
    "shape",          # plan not a device-eligible chain/tree
    "empty-input",    # zero-row scan: nothing to dispatch
    "group-cap",      # factorize cap overflow past the ladder ceiling
    "pair-cap",       # DISTINCT pair-set cap overflow past the ceiling
    "join-cap",       # join fan-out exceeds the device expansion cap
    "blocked-expand", # blocked multi-pass join can't serve this shape
    "mesh-size",      # dist plan wants more devices than are visible
    "string-dict",    # varlen column with no dictionary encoding
    "device-error",   # unexpected device/runtime failure
)


class FragmentFallback(Exception):
    """Raised when the device path cannot run this fragment.

    `reason` must be one of FALLBACK_REASONS (defaults to "shape"); the
    exception message keeps the free-text detail."""

    def __init__(self, detail: str = "", reason: str = "shape"):
        super().__init__(detail)
        self.reason = reason if reason in FALLBACK_REASONS else "shape"


def _var_bool(v) -> bool:
    """MySQL-ish boolean sysvar coercion: 'off'/'false'/'0'/0/'' are False."""
    if isinstance(v, str):
        return v.strip().lower() not in ("", "0", "off", "false")
    return bool(v)


def _sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Planner side: chain detection (the engine allowlist gate)
# ---------------------------------------------------------------------------


def _order_over_agg_ok(order: PhysicalPlan, agg: PhysicalPlan) -> bool:
    """Can this ORDER BY / TopN root fuse into the device finalize of the
    HashAgg beneath it (device_emit.emit_finalize)?  Every sort key must
    be a bare ColumnRef into the agg's output row; keys referencing
    aggregate outputs additionally require a final() that traces (the
    count/sum/avg/min/max allowlist — wide-decimal finals run host-side
    via numpy limb math) and a non-DISTINCT aggregate (device-merged
    DISTINCT states dedup per-slab only; the exact cross-slab counts
    exist solely in the host pair merge, AFTER ordering would run)."""
    if not isinstance(agg, PhysHashAgg):
        return False
    if isinstance(order, PhysTopN) and \
            getattr(order, "count", None) is None:
        return False
    nk = len(agg.group_exprs)
    for e in order.by:
        if not isinstance(e, ColumnRef):
            return False
        if e.index < nk:
            continue
        if e.index >= nk + len(agg.aggs):
            return False
        d = agg.aggs[e.index - nk]
        if d.distinct:
            return False
        if d.name not in ("count", "sum", "avg", "min", "max"):
            return False
        if d.ftype.is_wide_decimal or d.ftype.kind.is_string:
            return False
    return True


def _identity_projection(p: PhysicalPlan) -> bool:
    """A planner-inserted pass-through (col#i → i, in order, dropping
    nothing): transparent between an ORDER BY / TopN root and the agg it
    orders, because its output row IS the agg's output row."""
    return (isinstance(p, PhysProjection) and p.children and
            len(p.exprs) == len(p.children[0].schema.field_types) and
            all(isinstance(e, ColumnRef) and e.index == i
                for i, e in enumerate(p.exprs)))


def _strip_order_root(root: PhysicalPlan):
    """(order_root, agg) when `root` is an ORDER BY / TopN over the agg
    (identity projections between them are transparent), else (None,
    root)."""
    if isinstance(root, (PhysTopN, PhysSort)) and root.children:
        below = root.children[0]
        while _identity_projection(below) and below.children:
            below = below.children[0]
        if isinstance(below, PhysHashAgg):
            return root, below
    return None, root


def _linearize(root: PhysicalPlan) -> Optional[List[PhysicalPlan]]:
    """root→leaf chain [root, ..., scan], or None if the shape is wrong.
    An ORDER BY / TopN root directly over a fusable HashAgg linearizes as
    [order, agg, ..., scan] — the driver strips the order root and runs
    it as the agg's fused finalize (or a host re-order)."""
    nodes: List[PhysicalPlan] = []
    cur = root
    while True:
        nodes.append(cur)
        if isinstance(cur, PhysTableScan):
            return nodes
        mid_ok = isinstance(cur, (PhysSelection, PhysProjection))
        root_ok = cur is root and isinstance(cur, (PhysHashAgg, PhysTopN,
                                                   PhysSort, PhysWindow))
        order_agg = (isinstance(cur, PhysHashAgg)
                     and isinstance(root, (PhysTopN, PhysSort))
                     and all(_identity_projection(n) for n in nodes[1:-1])
                     and _order_over_agg_ok(root, cur))
        if not (mid_ok or root_ok or order_agg) or len(cur.children) != 1:
            return None
        cur = cur.children[0]


def _string_exprs_are_refs(exprs: Sequence[Expression]) -> bool:
    return all(isinstance(e, ColumnRef) or not e.ftype.kind.is_string
               for e in exprs)


_MATH_OPS = frozenset({
    "sqrt", "pow", "exp", "ln", "log", "log2", "log10",
    "sin", "cos", "tan", "cot", "asin", "acos", "atan", "atan2",
    "degrees", "radians", "pi", "truncate", "greatest", "least",
})
_TEMPORAL_OPS = frozenset({
    "date", "datediff", "date_add_day", "date_add_week", "date_add_month",
    "date_add_quarter", "date_add_year", "date_add_hour", "date_add_minute",
    "date_add_second", "date_add_microsecond", "to_days", "from_days",
    "dayofweek", "weekday", "dayofyear", "quarter", "week", "last_day",
    "hour", "minute", "second", "microsecond", "timestamp",
    "unix_timestamp", "from_unixtime", "time_to_sec", "sec_to_time",
    "to_seconds", "time", "timediff",
})
#: the dictionary string functions: the host applies the function to
#: every entry of the string column's dictionary once per statement, and
#: the device gathers the result by code (K21 dict_lut). An integer
#: result is an integer expression like any other.
_STRING_INT_OPS = frozenset({
    "length", "char_length", "ascii", "ord", "bit_length", "instr",
    "locate", "find_in_set",
})
#: a string result is a code into a dictionary derived at run time, which
#: no device consumer but IS NULL (the mask alone) can read
_STRING_RESULT_OPS = frozenset({
    "upper", "lower", "reverse", "ltrim", "rtrim", "trim", "hex", "substr",
    "left", "right", "repeat", "replace", "lpad", "rpad", "substring_index",
    "concat",
})
#: scalar functions the port evaluates on the device. Each one is held
#: against the JAX package's device branch by tests/test_torch_expression.py
#: or tests/test_torch_string.py; any other function keeps its fragment on
#: the CPU at plan time.
DEVICE_OPS = frozenset({
    "plus", "minus", "mul", "div", "intdiv", "mod", "unary_minus",
    "eq", "ne", "lt", "le", "gt", "ge", "nulleq",
    "and", "or", "xor", "not", "isnull",
    "if", "ifnull", "coalesce", "case", "in", "like", "regexp_like",
    "abs", "ceil", "floor", "round", "sign", "cast",
    "year", "month", "dayofmonth", "any_value",
}) | _MATH_OPS | _TEMPORAL_OPS | _STRING_INT_OPS | _STRING_RESULT_OPS

#: ops whose device branch reads its arguments as numbers, DATE days or
#: µs: a string argument (a dictionary code on the device) stays on the
#: CPU, where the host branches parse it
_NO_STRING_ARGS = _MATH_OPS | _TEMPORAL_OPS | {"cast"}


def _dict_string_shape_ok(f) -> bool:
    """A dictionary string function prepares its table over ONE string
    column's dictionary with every other argument folded in: the column
    at its position, every other argument a non-NULL constant (CONCAT:
    exactly one string column among constants). A ci column is refused:
    its dictionary holds one representative of each fold class, so a
    table built over it answers for the representative, not for the
    row's own string (the JAX package's device does so, and differs from
    its host)."""
    from tidb_tpu_torch.expression import (_HOST_STRING_FNS,
                                           _STRING_FNS_EXTRA, Constant)
    args = list(f.args)
    if f.op == "concat":
        cols = [a for a in args if isinstance(a, ColumnRef) and
                a.ftype.kind.is_string]
        if len(cols) != 1:
            return False
        col = cols[0]
    else:
        # the unary functions read argument 0; the others name the string
        # column's position (LOCATE and FIND_IN_SET take it second)
        k = 0 if f.op in _HOST_STRING_FNS else _STRING_FNS_EXTRA[f.op][1]
        if k >= len(args) or (f.op in _HOST_STRING_FNS and len(args) != 1):
            return False
        col = args[k]
        if not (isinstance(col, ColumnRef) and col.ftype.kind.is_string):
            return False
    if col.ftype.is_ci:
        return False
    return all(isinstance(a, Constant) and a.value is not None
               for a in args if a is not col)


def _string_results_reach_isnull(e, mask_only: bool = False) -> bool:
    """Every string-result function of `e` is read by IS NULL alone: as
    its direct argument, or as a result branch of IF / CASE whose own
    result is (`mask_only`: the value of `e` reaches no consumer but an
    IS NULL's mask; the branches' codes, from different derived
    dictionaries, are mixed and never read). Any other consumer (a
    comparison, IN, LIKE, COALESCE, an IF/CASE condition or a branch
    read as a value, another string function, a projection, a key, an
    aggregate) would read its derived-dictionary code as a string, which
    the device has no preparation for: such a shape stays on the CPU at
    plan time."""
    from tidb_tpu_torch.expression import Constant, ScalarFunc
    if not isinstance(e, ScalarFunc):
        return all(_string_results_reach_isnull(c) for c in e.children())
    if e.op in _STRING_RESULT_OPS and not mask_only:
        return False
    args = e.children()
    if e.op == "isnull":
        flags = [True] * len(args)
    elif e.op == "if":
        flags = [False] + [mask_only] * (len(args) - 1)
    elif e.op == "case":
        # WHEN, THEN pairs, then an optional ELSE: every THEN and the ELSE
        # are results
        flags = [mask_only and (i % 2 == 1 or i == len(args) - 1)
                 for i in range(len(args))]
    else:
        flags = [False] * len(args)
    if e.op != "isnull" and any(
            f and isinstance(c, Constant) and c.value is not None and
            c.ftype.kind.is_string for c, f in zip(args, flags)):
        return False    # a string constant branch has no device value
    return all(_string_results_reach_isnull(c, f)
               for c, f in zip(args, flags))


def _device_shape_ok(f) -> bool:
    """Shapes of DEVICE_OPS that the device branch cannot evaluate (the
    JAX package's raises on them, or would compute on dictionary codes),
    refused at plan time."""
    from tidb_tpu_torch.expression import Constant
    if f.op in _STRING_INT_OPS or f.op in _STRING_RESULT_OPS:
        return _dict_string_shape_ok(f)
    if f.op == "any_value":
        # identity; a string argument is a code no comparison can read
        return not f.args[0].ftype.kind.is_string
    if f.op in ("like", "regexp_like"):
        # the device lowering is a prepared per-dictionary LUT: only
        # column-vs-constant shapes can prepare
        return isinstance(f.args[0], ColumnRef) and \
            isinstance(f.args[1], Constant) and f.args[1].value is not None
    if f.op == "in" and f.args[0].ftype.kind.is_string:
        # string IN-lists prepare a per-dictionary codeset; a COMPUTED
        # string has no dictionary to prepare against
        return isinstance(f.args[0], ColumnRef)
    if f.op in ("greatest", "least", "cast") and \
            f.ftype.np_dtype == np.dtype(object):
        return False    # a computed string (JSON, wide decimal) result
    if f.op in _NO_STRING_ARGS and \
            any(a.ftype.kind.is_string for a in f.args):
        return False
    return True


def _exprs_device_ok(exprs: Sequence[Expression]) -> bool:
    """Admit an expression list to the device only when every scalar
    function is on DEVICE_OPS (quiet CPU routing at plan time). Wide
    decimals (limb-plane representation) are rejected here too: only the
    SUM/AVG/COUNT agg arguments handled by _fragment_ok's special case
    consume limbs."""
    from tidb_tpu_torch.expression import ScalarFunc
    for e in exprs:
        for sub in e.walk():
            if isinstance(sub, ScalarFunc) and type(sub) is not ScalarFunc:
                return False    # planner subclasses (apply subqueries)
            if isinstance(sub, ScalarFunc) and \
                    (sub.op not in DEVICE_OPS or not _device_shape_ok(sub)):
                return False
            if isinstance(sub, ColumnRef) and sub.ftype.is_wide_decimal:
                return False
        if not _string_results_reach_isnull(e):
            return False
    return True


def _row_root_ok(plan: PhysicalPlan) -> bool:
    """A row root (anything but an aggregate, or an ORDER BY / TopN over
    one) returns its columns as the device holds them. A wide decimal's
    limb planes have no row gather or decode there — the JAX package's
    device run fails on them and reruns on the CPU — so a row root with
    a wide-decimal output column stays on the CPU engine. A window root's
    own columns are exempt: the window kernels emit them as 1-D int64
    whatever their declared type (a SUM over a DECIMAL column is typed
    wide), and they decode like the host engine's."""
    _order, below = _strip_order_root(plan)
    if isinstance(below, PhysHashAgg):
        return True
    fts = plan.schema.field_types
    if isinstance(plan, PhysWindow):
        fts = fts[:len(plan.children[0].schema)]
    return not any(ft.is_wide_decimal for ft in fts)


def _fragment_ok(plan: PhysicalPlan, threshold: int) -> bool:
    if not _row_root_ok(plan):
        return False
    chain = _linearize(plan)
    if chain is None:
        return False
    scan = chain[-1]
    if getattr(scan, "est_rows", 0.0) < threshold:
        # route small inputs to CPU: launch+transfer dominates (SURVEY §7
        # cost-model honesty; the reference's TiFlash row-threshold gate)
        return False
    reduction = isinstance(plan, (PhysHashAgg, PhysTopN, PhysSort))
    worthwhile = reduction or bool(scan.filters)
    for node in chain:
        stage = _stage_exprs(node)
        if isinstance(node, PhysHashAgg):
            stage = list(node.group_exprs)   # agg args validated below
        if not _exprs_device_ok(stage):
            return False
        if isinstance(node, PhysHashAgg):
            if getattr(node, "rollup", False) and \
                    any(d.distinct for d in node.aggs):
                return False    # pair columns assume nk key cols; the
                # rollup level column breaks that layout → host oracle
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
                if any(isinstance(sub, ColumnRef) and
                       sub.ftype.is_wide_decimal
                       for a in desc.args for sub in a.walk()):
                    # a wide-decimal COLUMN (2-D limb planes) in the args:
                    # only plain SUM/AVG/COUNT over the bare column
                    # consumes limbs (SumAgg._update_wide)
                    if desc.name not in ("sum", "avg", "count") or \
                            desc.distinct or \
                            not isinstance(desc.args[0], ColumnRef):
                        return False
                elif not _exprs_device_ok(desc.args):
                    return False
            if not _string_exprs_are_refs(node.group_exprs):
                return False
        elif isinstance(node, (PhysTopN, PhysSort)):
            if not _string_exprs_are_refs(node.by):
                return False
        elif isinstance(node, PhysWindow):
            if not _window_device_ok(node):
                return False
            worthwhile = True
        elif isinstance(node, PhysSelection):
            worthwhile = True
        elif isinstance(node, PhysProjection):
            if not _string_exprs_are_refs(node.exprs):
                return False
            if any(not isinstance(e, ColumnRef) for e in node.exprs):
                worthwhile = True
    return worthwhile


_DEVICE_WINDOW_FUNCS = ("row_number", "rank", "dense_rank", "sum",
                        "count", "avg", "min", "max", "lag", "lead",
                        "first_value", "last_value", "percent_rank",
                        "cume_dist", "ntile", "nth_value")


def _window_device_ok(node: PhysWindow) -> bool:
    for d in node.wdescs:
        if d.name not in _DEVICE_WINDOW_FUNCS:
            return False
        if d.args and d.args[0].ftype.kind.is_string:
            return False            # string lag/lead needs dict passthrough
        if d.args and d.args[0].ftype.is_wide_decimal:
            return False            # limb planes: window kernels are 1-D
        fr = getattr(d, "frame", None)
        if fr is not None and fr[0] == "range" and (
                not d.order or d.order[0].ftype.kind.is_string):
            return False            # RANGE bounds need a numeric key
        if not _string_exprs_are_refs(list(d.partition) + list(d.order)):
            return False
    return True


def extract_fragments(plan: PhysicalPlan, threshold: int) -> PhysicalPlan:
    """Top-down maximal-chain extraction: try the largest fuse at each node
    first so HashAgg(Sel(Scan)) becomes one fragment, not a CPU agg over a
    fragment filter. Join trees (the Q3/Q5 shape), and windows with no
    linear-chain lowering (interior, over a join), fuse through
    tree_fragment when statically eligible. With tidb_tpu_dist_devices > 1
    the planner then distributes the fragments a staged path runs
    (planner/physical._distribute_fragments)."""
    if _fragment_ok(plan, threshold):
        frag = PhysTpuFragment(plan)
        frag.est_rows = plan.est_rows
        return frag
    from tidb_tpu_torch.executor.tree_fragment import tree_ok
    if tree_ok(plan, threshold):
        frag = PhysTpuFragment(plan)
        frag.est_rows = plan.est_rows
        return frag
    plan.children = [extract_fragments(c, threshold) for c in plan.children]
    return plan


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

# LRU of built programs: bounded because signatures can embed
# data-dependent key_bounds (moving min/max under writes would otherwise
# accumulate programs forever)
_COMPILE_CACHE: "OrderedDict[str, object]" = OrderedDict()
MAX_COMPILED_PROGRAMS = 64

# guards _COMPILE_CACHE / PROGRAM_TRACES / _BUILD_LOCKS — connection
# threads share one program cache
_CC_LOCK = threading.RLock()
# per-signature build locks: two threads building the SAME signature
# serialize (one build, the loser adopts it)
_BUILD_LOCKS: Dict[str, threading.Lock] = {}

# Incremented once per program BUILD — a repeated identical query must
# leave it unchanged (the warm-repeat check).
PROGRAM_TRACES = 0


def _count_trace() -> None:
    global PROGRAM_TRACES
    with _CC_LOCK:
        PROGRAM_TRACES += 1


def _build_lock(sig: str) -> threading.Lock:
    with _CC_LOCK:
        lk = _BUILD_LOCKS.get(sig)
        if lk is None:
            lk = _BUILD_LOCKS[sig] = threading.Lock()
            while len(_BUILD_LOCKS) > 4 * MAX_COMPILED_PROGRAMS:
                _BUILD_LOCKS.pop(next(iter(_BUILD_LOCKS)))
        return lk


def _cache_get(sig: str):
    with _CC_LOCK:
        prog = _COMPILE_CACHE.get(sig)
        if prog is not None:
            _COMPILE_CACHE.move_to_end(sig)
        return prog


def _cache_put(sig: str, prog) -> None:
    with _CC_LOCK:
        _COMPILE_CACHE[sig] = prog
        while len(_COMPILE_CACHE) > MAX_COMPILED_PROGRAMS:
            _COMPILE_CACHE.popitem(last=False)


def _chain_signature(chain: List[PhysicalPlan], used_cols: Sequence[int],
                     in_types: Sequence[FieldType], slab_cap: int,
                     group_cap: int, key_bounds=None,
                     layouts=None) -> str:
    parts = [f"slab={slab_cap}", f"gcap={group_cap}", f"kb={key_bounds}",
             "cols=" + ",".join(f"{i}:{ft}" for i, ft in
                                zip(used_cols, in_types)),
             # compressed physical layouts change the traced decode and
             # the input pytree, so they key the compile cache
             "lay=" + (",".join(f"{i}:{l.sig()}"
                                for i, l in sorted(layouts.items()))
                       if layouts else "-")]
    for node in chain:
        if isinstance(node, PhysTableScan):
            parts.append(f"Scan(filters={node.filters!r}, "
                         f"parts={getattr(node, 'partitions', None)})")
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
            k = getattr(node, "count", None)
            off = getattr(node, "offset", 0)
            parts.append(f"{type(node).__name__}(by={node.by!r}, "
                         f"descs={node.descs}, k={k}, off={off})")
        elif isinstance(node, PhysWindow):
            parts.append(f"Window({node.wdescs!r})")
    return "|".join(parts)


def _used_column_indices(chain: List[PhysicalPlan]) -> List[int]:
    """Scan-schema column indices referenced anywhere in the chain.

    Only expressions evaluated against the SCAN schema matter: once a
    Projection rebinds the column space, later refs point at projection
    outputs. We walk leaf-up and stop collecting at the first Projection.
    """
    used = set()
    for node in reversed(chain):
        if isinstance(node, PhysTableScan):
            for f in node.filters:
                used.update(f.references())
            if node is chain[0]:
                # a bare filtered-scan fragment emits EVERY column
                # (regression: a Scan-root chain uploaded only the filter
                # columns, then _partial's ctx.column(i) walked the full
                # schema → IndexError)
                used.update(range(len(node.schema)))
        elif isinstance(node, PhysSelection):
            for c in node.conditions:
                used.update(c.references())
            if node is chain[0]:
                # Selection-rooted fragment emits every child column
                used.update(range(len(node.schema)))
        elif isinstance(node, PhysProjection):
            for e in node.exprs:
                used.update(e.references())
            return sorted(used)
        elif isinstance(node, PhysHashAgg):
            for e in node.group_exprs:
                used.update(e.references())
            for d in node.aggs:
                for a in d.args:
                    used.update(a.references())
        elif isinstance(node, (PhysTopN, PhysSort)):
            for e in node.by:
                used.update(e.references())
            # sort/topn emit every child column
            n_cols = len(node.schema)
            used.update(range(n_cols))
        elif isinstance(node, PhysWindow):
            n_child = len(node.children[0].schema)
            used.update(range(n_child))   # window emits every child column
            for d in node.wdescs:
                for e in list(d.args) + list(d.partition) + list(d.order):
                    used.update(e.references())
    return sorted(used)


def _stage_exprs(node: PhysicalPlan) -> List[Expression]:
    """Expressions this node evaluates against its input columns."""
    if isinstance(node, PhysTableScan):
        return list(node.filters)
    if isinstance(node, PhysSelection):
        return list(node.conditions)
    if isinstance(node, PhysProjection):
        return list(node.exprs)
    if isinstance(node, PhysHashAgg):
        out = list(node.group_exprs)
        for d in node.aggs:
            out.extend(d.args)
        return out
    if isinstance(node, (PhysTopN, PhysSort)):
        return list(node.by)
    if isinstance(node, PhysWindow):
        out: List[Expression] = []
        for d in node.wdescs:
            out.extend(d.args)
            out.extend(d.partition)
            out.extend(d.order)
        return out
    return []


class _FragmentProgram:
    """One chain on one device: closures over the (first) plan's
    expression objects; later structurally-identical plans reuse it and
    only re-supply prepared host inputs positionally."""

    def __init__(self, chain: List[PhysicalPlan], used_cols: List[int],
                 in_types: List[FieldType], slab_cap: int, group_cap: int,
                 device, key_bounds=None, layouts=None,
                 want_pairs: bool = False, pair_cap: int = 0):
        from tidb_tpu_torch.ops.xp import TorchXP
        _count_trace()
        self.chain = chain
        self.used_cols = used_cols
        self.in_types = in_types
        self.slab_cap = slab_cap
        self.group_cap = group_cap
        self.pair_cap = pair_cap   # distinct pair-set output capacity
        self.device = torch.device(device)
        self.xp = TorchXP(self.device)
        self.key_bounds = key_bounds   # [(lo, hi)] → perfect-hash grouping
        # col → ColLayout for compressed input slabs: decoded (K2) ahead
        # of every other stage
        self.layouts = dict(layouts) if layouts else {}
        self.root = chain[0]
        if isinstance(self.root, PhysHashAgg):
            self.aggs: List[AggFunc] = [build_agg(d) for d in self.root.aggs]
        # emit distinct (group, value) pair sets only when a multi-slab
        # execution will merge them — single-slab dedup is already exact
        self.has_distinct = want_pairs and \
            isinstance(self.root, PhysHashAgg) and \
            any(d.distinct and d.args for d in self.root.aggs)
        self.prep_nodes: List[Expression] = []  # walk order, structural
        for node in reversed(chain):
            for e in _stage_exprs(node):
                for sub in e.walk():
                    if type(sub).prepare is not Expression.prepare:
                        self.prep_nodes.append(sub)

    # -- host-side per-execution preparation --------------------------------
    def collect_preps(self, dicts_by_index: Dict[int, Optional[np.ndarray]]):
        """Prepared inputs (dictionary ranks/LUTs) in structural order,
        uploaded to the program's device."""
        from tidb_tpu_torch.ops.xp import to_device_tree
        return [to_device_tree(self.xp, v)
                for v in collect_chain_preps(self.chain, dicts_by_index)]

    # -- device stages -------------------------------------------------------
    def _eval_chain(self, cols, n_rows: int, prep_vals):
        """cols: dict index→slab tuple; returns (ctx, live) after all
        mid-chain stages."""
        prepared = {id(node): v for node, v in zip(self.prep_nodes, prep_vals)
                    if v is not None}
        live = torch.arange(self.slab_cap, dtype=torch.int32,
                            device=self.device) < n_rows
        if self.layouts:
            # every packed column of the slab in one K2 call
            from tidb_tpu_torch.executor import device_emit
            packed = [i for i in cols if self.layouts.get(i) is not None]
            if packed:
                cols = dict(cols)
                cols.update(zip(packed, device_emit.emit_decode_many(
                    [(self.layouts[i], cols[i]) for i in packed],
                    self.slab_cap)))
        max_idx = max(cols) if cols else -1
        col_list: List = [cols.get(i) for i in range(max_idx + 1)]
        ctx = EvalContext(self.xp, col_list, prepared=prepared,
                          on_device=True, n_rows=self.slab_cap)
        for node in reversed(self.chain):
            if isinstance(node, PhysTableScan):
                for f in node.filters:
                    v, m = f.eval(ctx)
                    live = live & (v != 0) & m
            elif isinstance(node, PhysSelection):
                for c in node.conditions:
                    v, m = c.eval(ctx)
                    live = live & (v != 0) & m
            elif isinstance(node, PhysProjection):
                new_cols = [e.eval(ctx) for e in node.exprs]
                ctx = EvalContext(self.xp, new_cols, prepared=prepared,
                                  on_device=True, n_rows=self.slab_cap)
        return ctx, live

    def partial(self, cols, n_rows: int, prep_vals):
        """One slab: decode → filter/project → root reduction."""
        from tidb_tpu_torch.executor import device_emit
        ctx, live = self._eval_chain(cols, n_rows, prep_vals)
        return device_emit.emit_root(
            ctx, live, self.root, aggs=getattr(self, "aggs", None),
            group_cap=self.group_cap, key_bounds=self.key_bounds,
            slab_cap=self.slab_cap, pairs_out=self.has_distinct,
            pair_cap=self.pair_cap)

    def merge(self, key_cols, states, slot_live):
        """Merge stacked slab partials: re-factorize partial keys, sanitize
        dead slots to identities, scatter-merge states (AggFunc.merge is the
        same segment op as update — SURVEY A.4)."""
        from tidb_tpu_torch.executor import device_emit
        return device_emit.emit_merge(self.root, self.aggs, self.group_cap,
                                      key_cols, states, slot_live)


def _dict_list(dicts_by_index: Dict[int, Optional[np.ndarray]]) -> List:
    if not dicts_by_index:
        return []
    n = max(dicts_by_index) + 1
    return [dicts_by_index.get(i) for i in range(n)]


def collect_chain_preps(chain: List[PhysicalPlan],
                        dicts_by_index: Dict[int, Optional[np.ndarray]]):
    """Prepared host inputs for `chain`, positionally aligned with the
    prep_nodes of ANY structurally identical chain's program.

    Module-level on purpose: with parametrized chains the compile cache
    returns a program built from ANOTHER statement's chain (their
    value-free signatures collide — that's the point), so the parameter
    values must be collected from the CURRENT statement's own ParamExpr
    nodes. The traversal is purely structural (same walk as
    _FragmentProgram.__init__), so position k here is position k there.
    """
    vals = []
    dicts = _dict_list(dicts_by_index)
    stage_dicts = dicts
    for node in reversed(chain):
        for e in _stage_exprs(node):
            for sub in e.walk():
                if type(sub).prepare is not Expression.prepare:
                    vals.append(sub.prepare(stage_dicts))
        if isinstance(node, PhysProjection):
            stage_dicts = [
                stage_dicts[e.index] if isinstance(e, ColumnRef)
                and e.index < len(stage_dicts) else None
                for e in node.exprs]
    return vals


# comparison ops whose numeric literals are safe to parametrize: both
# sides evaluate as arrays with no host fast path keyed on the python
# value. "in" is deliberately excluded — its integer fast path builds a
# host-side sorted table from Constant values, and its string preparation
# is variable-length.
_PARAM_CMP_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
#: the only functions a parametrized comparison may sit under: their
#: device branches are elementwise and take a [B, n] operand beside [n]
#: masks. Under any other function (IF, CASE, arithmetic, a calendar or
#: dictionary function) the member axis would reach a kernel or wrapper
#: that takes one row axis, so such a comparison keeps its literal.
_PARAM_LOGIC_OPS = frozenset({"and", "or", "xor", "not"})


def _parametrize_expr(e: Expression):
    """→ (expr, changed): `expr` with the numeric literals of comparisons
    reached from the condition's root through logical ops alone replaced
    by ParamExpr leaves (the value rides the prepared inputs, the repr is
    value-free). Structure is cloned only where a child changed."""
    from tidb_tpu_torch.expression import Constant, ParamExpr, ScalarFunc
    if type(e) is not ScalarFunc:
        return e, False
    changed = False
    new_args: List[Expression] = []
    if e.op in _PARAM_CMP_OPS:
        for a in e.args:
            if (type(a) is Constant and a.value is not None
                    and not a.ftype.kind.is_string
                    and a.ftype.np_dtype != np.dtype(object)):
                new_args.append(ParamExpr(a.value, a.ftype))
                changed = True
            else:
                new_args.append(a)
    elif e.op in _PARAM_LOGIC_OPS:
        for a in e.args:
            na, ch = _parametrize_expr(a)
            new_args.append(na)
            changed = changed or ch
    if not changed:
        return e, False
    return e.rebuild(new_args), True


def _parametrize_chain(chain: List[PhysicalPlan]):
    """Clone the chain with scan-filter / selection comparison literals
    lifted into ParamExpr parameters, so `WHERE k = 17` and `= 42` share
    one program and can micro-batch. → the cloned chain, or None when
    nothing was parametrizable (the caller keeps the literal-baked path)
    or the chain holds a window (its kernels take one row axis). Nodes
    are shallow-copied; the original plan is never mutated."""
    import copy
    if any(isinstance(node, PhysWindow) for node in chain):
        return None
    out: List[PhysicalPlan] = []
    any_changed = False
    for node in chain:
        attr = "filters" if isinstance(node, PhysTableScan) else \
            "conditions" if isinstance(node, PhysSelection) else None
        if attr is not None and getattr(node, attr):
            new_c, ch = [], False
            for f in getattr(node, attr):
                nf, c = _parametrize_expr(f)
                new_c.append(nf)
                ch = ch or c
            if ch:
                node = copy.copy(node)
                setattr(node, attr, new_c)
                any_changed = True
        out.append(node)
    return out if any_changed else None


def _charge_compile(kind: str, t0: float) -> None:
    """Attribute one cold program build to the running statement: bump its
    PhaseTimer compile counter (thread-local — the single-flight builders
    have no ExecContext in reach) and emit a timeline compile event."""
    from tidb_tpu_torch.util import phases as _phases
    from tidb_tpu_torch.util import timeline
    cur = _phases.current()
    if cur is not None:
        cur.note_compile()
    if timeline.ENABLED:
        timeline.record(f"compile:{kind}", "compile",
                        dur_us=(time.perf_counter() - t0) * 1e6,
                        pid=cur.conn_id if cur is not None else 0)


def get_program(chain, used_cols, in_types, slab_cap, group_cap, device,
                key_bounds=None, layouts=None, sig=None, want_pairs=False,
                pair_cap=0) -> _FragmentProgram:
    """`sig` lets a specialization-cache hit skip signature construction
    entirely — valid because the spec key pins the same geometry, layout
    set and key bounds the signature would encode. The pair mode keys
    the cache: a single-slab program emits no pair sets."""
    if sig is None:
        sig = _chain_signature(chain, used_cols, in_types, slab_cap,
                               group_cap, key_bounds, layouts) + \
            f"|pairs={want_pairs},{pair_cap}|dev={torch.device(device)}"
    prog = _cache_get(sig)
    if prog is None:
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = _FragmentProgram(chain, used_cols, in_types,
                                        slab_cap, group_cap, device,
                                        key_bounds, layouts, want_pairs,
                                        pair_cap)
                _cache_put(sig, prog)
                _charge_compile("chain", t0)
    return prog


class _BatchedProgram:
    """A filter-rooted fragment program over a leading member axis: one
    launch per slab serves `b` statements whose ParamExpr values are
    stacked along axis 0 (executor/microbatch.py). Shares the program
    cache with the scalar programs under sig `batched[B]|<base sig>`."""

    __slots__ = ("base", "b")

    def __init__(self, base: _FragmentProgram, b: int):
        self.base = base
        self.b = b

    def partial(self, cols, n_rows: int, stacked_preps):
        from tidb_tpu_torch.executor import device_emit
        return device_emit.emit_batched(self.base, self.b, cols, n_rows,
                                        stacked_preps)


def get_batched_program(base: _FragmentProgram, b: int,
                        base_sig: str) -> _BatchedProgram:
    sig = f"batched[{b}]|{base_sig}"
    prog = _cache_get(sig)
    if prog is None:
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = _BatchedProgram(base, b)
                _cache_put(sig, prog)
                _charge_compile("batched", t0)
    return prog


def _order_sig(order_root) -> str:
    k = getattr(order_root, "count", None)
    off = getattr(order_root, "offset", 0)
    return (f"{type(order_root).__name__}(by={order_root.by!r}, "
            f"descs={order_root.descs}, k={k}, off={off})")


class _FusedFinalizeProgram:
    """Whole-query tail: agg merge → finalize expressions → root ORDER BY /
    TopN on the device (device_emit.emit_finalize)."""

    def __init__(self, agg_root, order_root, group_cap: int):
        _count_trace()
        self.agg_root = agg_root
        self.order_root = order_root
        self.group_cap = group_cap
        self.aggs = [build_agg(d) for d in agg_root.aggs]

    def run(self, key_cols, states, slot_live):
        from tidb_tpu_torch.executor import device_emit
        return device_emit.emit_finalize(self.agg_root, self.order_root,
                                         self.aggs, self.group_cap,
                                         key_cols, states, slot_live)


def get_finalize_program(agg_root, order_root, group_cap: int,
                         base_sig: str):
    """→ (program, sig). `base_sig` is the partial signature so the
    finalize specializes per upstream shape."""
    sig = "fusedfinal|" + _order_sig(order_root) + "|" + base_sig
    prog = _cache_get(sig)
    if prog is None:
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = _FusedFinalizeProgram(agg_root, order_root,
                                             group_cap)
                _cache_put(sig, prog)
                _charge_compile("finalize", t0)
    return prog, sig


def _tree_program(sig: str, kind: str, root, caps, group_cap, device,
                  join_cfgs, agg_key_bounds, scan_layouts, pairs_out=False,
                  pair_cap=0):
    prog = _cache_get(sig)
    if prog is None:
        from tidb_tpu_torch.executor.tree_fragment import TreeProgram
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = TreeProgram(root, caps, group_cap, join_cfgs,
                                   agg_key_bounds, scan_layouts, pairs_out,
                                   pair_cap, device=device)
                _cache_put(sig, prog)
                _charge_compile(kind, t0)
    return prog


def _get_dist_program(root, caps, group_cap, n_shards: int, bucket_caps,
                      device, join_cfgs=None, scan_layouts=None):
    """The monolithic distributed program, cached under the JAX
    package's key: `dist=N|bux=<hash exchanges' bucket caps>|` plus the
    tree signature (and the device, as every program of the port)."""
    from tidb_tpu_torch.executor.dist_fragment import DistTreeProgram
    from tidb_tpu_torch.executor.tree_fragment import tree_signature
    bux = ",".join(str(c) for c in bucket_caps)
    sig = (f"dist={n_shards}|bux={bux}|" +
           tree_signature(root, caps, group_cap, join_cfgs,
                          scan_layouts=scan_layouts) +
           f"|dev={torch.device(device)}")
    prog = _cache_get(sig)
    if prog is None:
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = DistTreeProgram(root, caps, group_cap, n_shards,
                                       bucket_caps, join_cfgs, scan_layouts,
                                       device=device)
                _cache_put(sig, prog)
                _charge_compile("dist", t0)
    return prog


def get_tree_program(root, caps, group_cap, device, join_cfgs=None,
                     agg_key_bounds=None, scan_layouts=None):
    """The join tree as one program over every scan's full capacity (the
    whole-tree loop and the blocked passes)."""
    from tidb_tpu_torch.executor.tree_fragment import tree_signature
    sig = tree_signature(root, caps, group_cap, join_cfgs, agg_key_bounds,
                         scan_layouts) + f"|dev={torch.device(device)}"
    return _tree_program(sig, "tree", root, caps, group_cap, device,
                         join_cfgs, agg_key_bounds, scan_layouts)


def get_pipeline_program(root, caps, group_cap, device, join_cfgs=None,
                         agg_key_bounds=None, scan_layouts=None,
                         pairs_out=False, pair_cap=0, sig=None):
    """Fused per-slab pipeline program: a TreeProgram whose probe-anchor
    scan capacity is ONE slab, so scan → filter → project → join-probe →
    partial-agg run over that slab with every build side at full size.
    The signature extends tree_signature — the per-scan `cap=CxN` term
    already distinguishes the per-slab anchor shape from the whole-tree
    program — and cold builds charge the `compile:fused` timeline lane.
    The pair mode (a multi-slab DISTINCT's per-slab pair sets) keys the
    cache too. → (program, sig)."""
    from tidb_tpu_torch.executor.tree_fragment import tree_signature
    if sig is None:
        sig = (f"fused|pairs={pairs_out},{pair_cap}|" +
               tree_signature(root, caps, group_cap, join_cfgs,
                              agg_key_bounds, scan_layouts)
               + f"|dev={torch.device(device)}")
    return _tree_program(sig, "fused", root, caps, group_cap, device,
                         join_cfgs, agg_key_bounds, scan_layouts, pairs_out,
                         pair_cap), sig


class _AggMergeProgram:
    """Root merge for fused-pipeline agg partials: the per-slab pipeline
    runs each emit a group_cap-slot partial, and this (cached) program
    re-factorizes the stacked keys and scatter-merges the states."""

    def __init__(self, root, group_cap: int):
        _count_trace()
        self.root = root
        self.group_cap = group_cap
        self.aggs = [build_agg(d) for d in root.aggs]

    def merge(self, key_cols, states, slot_live):
        from tidb_tpu_torch.executor import device_emit
        return device_emit.emit_merge(self.root, self.aggs, self.group_cap,
                                      key_cols, states, slot_live)


def get_merge_program(root, group_cap: int,
                      pipeline_sig: str) -> _AggMergeProgram:
    sig = "fusedmerge|" + pipeline_sig
    prog = _cache_get(sig)
    if prog is None:
        with _build_lock(sig):
            prog = _cache_get(sig)      # double-checked: one build per sig
            if prog is None:
                t0 = time.perf_counter()
                prog = _AggMergeProgram(root, group_cap)
                _cache_put(sig, prog)
                _charge_compile("fused", t0)
    return prog


# ---------------------------------------------------------------------------
# Per-digest specialization cache
# ---------------------------------------------------------------------------
# Sits IN FRONT of the program cache: keyed by the statement's
# normalize_sql digest plus everything the runtime otherwise re-derives per
# execution (slab geometry, compressed-layout set, cached key bounds), it
# remembers the FINAL group capacity a previous execution settled on and
# the exact program signature it ran with. A hit adopts that capacity
# (skipping the overflow ladder's discovery climb) and the stored
# signature (skipping signature construction).

_SPEC_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
MAX_SPECIALIZATIONS = 256


def _spec_key(guard, kind: str, extra: tuple):
    """None when the statement has no SQL text attached or the gate is
    off — ad-hoc plan executions don't specialize."""
    sql = getattr(guard, "sql", None) if guard is not None else None
    if not sql:
        return None
    from tidb_tpu_torch.util.observability import normalize_sql
    # Raw SQL rides along with the digest: literals are baked into the
    # traced programs (filter/projection exprs are trace constants), so
    # two statements sharing a digest but differing in literals must NOT
    # share a specialization entry.
    return (kind, normalize_sql(sql), sql) + extra


def _plan_fingerprint(node) -> str:
    """Cheap per-fragment plan identity for the specialization key: one
    statement can run SEVERAL fragments under the same guard.sql (a
    plan-time uncorrelated subquery, a derived table), and geometry
    alone can't tell them apart — without this, the subquery's entry
    shadows the outer fragment's and hands it the wrong compiled
    signature (wrong agg-state layout)."""
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        out.append(n.describe())
        stack.extend(getattr(n, "children", ()))
    return "|".join(out)


def _spec_lookup(key, lay_sig: Optional[str] = None) -> Optional[dict]:
    """`lay_sig` is the statement's CURRENT layout-set signature. It is
    deliberately NOT part of the key: a table re-encode (compression
    toggled, workload-adaptive re-choice) must EVICT the stale entry —
    its cached compile-cache signature names programs that decode the
    old layouts — not orphan it under a dead key while a lookup with
    the old signature could still hit it."""
    if key is None:
        return None
    with _CC_LOCK:
        ent = _SPEC_CACHE.get(key)
        if ent is not None and ent.get("lay_sig") != lay_sig:
            del _SPEC_CACHE[key]    # layout changed: stale, evict
            return None
        if ent is not None:
            _SPEC_CACHE.move_to_end(key)
        return ent


def _spec_store(key, ent: dict) -> None:
    if key is None:
        return
    with _CC_LOCK:
        _SPEC_CACHE[key] = ent
        while len(_SPEC_CACHE) > MAX_SPECIALIZATIONS:
            _SPEC_CACHE.popitem(last=False)


def _spec_note(ph, hit: bool) -> None:
    from tidb_tpu_torch.util.observability import REGISTRY
    if hit:
        if ph is not None:
            ph.note_spec_hit()
        REGISTRY.inc("tidb_tpu_specialization_hits_total",
                     {"engine": "device"})
    else:
        REGISTRY.inc("tidb_tpu_specialization_misses_total",
                     {"engine": "device"})


def _initial_group_cap(root: PhysHashAgg, default_cap: int,
                       max_cap: int) -> int:
    """Stats-informed factorize capacity: when the planner's group estimate
    came from real NDV stats (est_reliable, planner/physical.estimate), a
    1.5× headroom start avoids the overflow→retry recompile ladder both for
    high-cardinality keys (e.g. GROUP BY orderkey) and tiny ones."""
    if not getattr(root, "est_reliable", False):
        return default_cap
    from tidb_tpu_torch.executor.device_cache import _pow2
    want = int(root.est_rows * 1.5) + 16
    return min(_pow2(want), max_cap)


DOMAIN_CAP = 1 << 20    # max packed group-key domain for perfect hashing


def _trace_to_scan_col(chain: List[PhysicalPlan], expr) -> Optional[int]:
    """Follow a ColumnRef through the chain's projections down to a scan
    column index, or None if the value is computed."""
    if not isinstance(expr, ColumnRef):
        return None
    idx = expr.index
    for node in chain[1:]:
        if isinstance(node, PhysProjection):
            e = node.exprs[idx]
            if not isinstance(e, ColumnRef):
                return None
            idx = e.index
    return idx


def _agg_key_bounds(chain: List[PhysicalPlan], ent) -> Optional[List[Tuple[int, int]]]:
    """Per-group-key (lo, hi) domains when every key is a scan column with
    cached bounds and the packed domain stays small; None → sort factorize."""
    root = chain[0]
    if not isinstance(root, PhysHashAgg) or not root.group_exprs:
        return None
    if getattr(root, "rollup", False):
        return None     # level tiling needs the sort factorize
    bounds: List[Tuple[int, int]] = []
    domain = 1
    for e in root.group_exprs:
        idx = _trace_to_scan_col(chain, e)
        if idx is None:
            return None
        b = ent.bounds.get(idx)
        if b is None:
            return None
        lo, hi = b
        domain *= (hi - lo + 2)
        if domain > DOMAIN_CAP:
            return None
        bounds.append((lo, hi))
    return bounds


def _ent_layouts(ent, used):
    """col → ColLayout for the used columns that are stored compressed;
    None when every used column is raw (keeps signatures byte-identical
    to the pre-compression cache keys)."""
    lays = {i: ent.layouts.get(i) for i in used
            if ent.layouts.get(i) is not None}
    return lays or None


def _plan_aligned_joins(ctx, root, scans, ents):
    """Serve PK-FK joins from the FK-aligned device cache where possible
    (device_cache.AlignedJoin — the join-index/coprocessor-cache analog).

    Eligible: single equi key, both sides bare ColumnRefs, the build
    subtree anchored (through its probe chain) on a scan whose key column
    has cached (lo, hi) bounds, and the probe key resolving to the fact
    scan's row space. Chains compose BOTH ways: through earlier aligned
    joins in the probe subtree ((l⋈o)⋈c — Q5's o_custkey as an aligned
    column) and through joins nested in the build subtree ((c⋈o)⋈l, the
    dimensions-first order the join reorderer prefers) — in the latter
    case every inner join is recursively re-anchored to the fact row
    space, and the whole attempt aborts unless all of them align (a
    non-aligned inner join could flip to expand mode at runtime and break
    the row-space invariant). Build-key uniqueness is VERIFIED at cache
    build, so aligned joins never lose runtime bets; a non-unique build
    caches the negative result and keeps the standard LUT modes.

    → {id(join): {entry, build_scan, build_ent, cols}}"""
    from tidb_tpu_torch.executor import device_cache
    from tidb_tpu_torch.executor import tree_fragment as TF
    if getattr(ctx, "txn", None) is not None:
        return {}
    if not _var_bool(ctx.vars.get("tidb_tpu_aligned_join", True)):
        return {}
    store = getattr(ctx.snapshot, "store", None)
    if store is None:
        return {}
    ents_by_scan = {id(s): e for s, (e, _) in zip(scans, ents)}
    info_by_join: Dict[int, dict] = {}
    # id(anchor scan) → (entry, anchor ent): scans substituted by an outer
    # aligned join — references to their columns resolve to aligned arrays
    anchor_subs: Dict[int, tuple] = {}

    def aligned_ref(entry, a_ent, idx):
        """(entry, col) → resolve() result tuple, or None."""
        if a_ent.dicts.get(idx) is not None:
            return None
        slabs = device_cache.aligned_col(entry, a_ent, idx)
        if any(v.dim() != 1 for v, _ in slabs):
            return None
        return (lambda: ([v for v, _ in slabs], [m for _, m in slabs]),
                ("al", entry.key, idx), dict(entry.tds), entry.slab_cap,
                entry.n_slabs)

    def resolve(nodeP, idx):
        """Probe key column → (loader of its per-slab (codes, valid), sig,
        tds, slab_cap, n_slabs) in the fact scan's row space, or None."""
        while True:
            if isinstance(nodeP, PhysTableScan):
                sub = anchor_subs.get(id(nodeP))
                if sub is not None:
                    return aligned_ref(sub[0], sub[1], idx)
                ent = ents_by_scan.get(id(nodeP))
                if ent is None or idx not in ent.dev:
                    return None
                if ent.dicts.get(idx) is not None:
                    return None        # string probe key: KeyRemap path
                if nodeP.schema.field_types[idx].is_wide_decimal:
                    return None        # wide-decimal planes can't be keys

                def load(ent=ent, idx=idx):
                    slabs = device_cache._decoded_slabs(ent, idx)
                    return [v for v, _ in slabs], [m for _, m in slabs]
                return (load, ("col", nodeP.table.id, idx),
                        {nodeP.table.id:
                         ctx.snapshot.table_data(nodeP.table.id)},
                        ent.slab_cap, ent.n_slabs)
            if isinstance(nodeP, PhysSelection):
                nodeP = nodeP.children[0]
                continue
            if isinstance(nodeP, PhysProjection):
                e = nodeP.exprs[idx] if idx < len(nodeP.exprs) else None
                if not isinstance(e, ColumnRef):
                    return None
                idx = e.index
                nodeP = nodeP.children[0]
                continue
            if isinstance(nodeP, PhysHashJoin):
                j = nodeP
                bi = 1 if j.build_right else 0
                if j.kind in ("semi", "anti"):
                    # semi/anti preserve the probe row space in EVERY mode
                    nodeP = j.children[1 - bi]
                    continue
                if id(j) not in info_by_join:
                    # a non-aligned inner/outer join may flip to expand
                    # mode at runtime, breaking the row-space invariant —
                    # crossing it (either side) is only safe once aligned
                    return None
                nl = len(j.children[0].schema)
                if j.build_right:
                    if idx < nl:       # probe (left) side column
                        nodeP = j.children[0]
                        continue
                    b_out_idx = idx - nl
                else:
                    if idx >= nl:      # probe (right) side column
                        idx -= nl
                        nodeP = j.children[1]
                        continue
                    b_out_idx = idx
                info = info_by_join[id(j)]
                hit = TF._trace_scan_col(j.children[bi], b_out_idx)
                if hit is None:
                    return None
                bscan2, c2 = hit
                if bscan2 is not info["build_scan"]:
                    return None
                return aligned_ref(info["entry"], info["build_ent"], c2)
            return None

    def trace_col_probewise(node, idx):
        """Column index → (anchor scan, scan col), crossing joins via
        their probe side only (semi/anti emit the probe side verbatim)."""
        while True:
            if isinstance(node, PhysTableScan):
                return node, idx
            if isinstance(node, PhysSelection):
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
                bi = 1 if node.build_right else 0
                if node.kind in ("semi", "anti"):
                    node = node.children[1 - bi]
                    continue
                nl = len(node.children[0].schema)
                if node.build_right:
                    if idx >= nl:
                        return None    # build-side column: not probewise
                    node = node.children[0]
                else:
                    if idx < nl:
                        return None
                    idx -= nl
                    node = node.children[1]
                continue
            return None

    def try_align(jnode) -> bool:
        if len(jnode.equi) != 1:
            return False
        bkeys, pkeys = TF.join_key_exprs(jnode)
        bk, pk = bkeys[0], pkeys[0]
        if not (isinstance(bk, ColumnRef) and isinstance(pk, ColumnRef)):
            return False               # casts / KeyRemap: standard modes
        bi = 1 if jnode.build_right else 0
        build, probe = jnode.children[bi], jnode.children[1 - bi]
        # the SAME traversal _emit_join_aligned uses to find the scan to
        # substitute — planner and program cannot disagree on the anchor
        anchor, crossed = TF.aligned_chain(build)
        if anchor is None:
            return False
        bhit = trace_col_probewise(build, bk.index)
        if bhit is None or bhit[0] is not anchor:
            return False
        bcol = bhit[1]
        build_ent = ents_by_scan.get(id(anchor))
        if build_ent is None or build_ent.dicts.get(bcol) is not None:
            return False               # string build key: standard modes
        bounds = build_ent.bounds.get(bcol)
        if bounds is None:
            return False
        src = resolve(probe, pk.index)
        if src is None:
            return False
        load, sig, tds, slab_cap, n_slabs = src
        key = (id(store), sig, anchor.table.id, bcol, str(ctx.device))
        tds[anchor.table.id] = ctx.snapshot.table_data(anchor.table.id)
        entry = device_cache.get_aligned(
            ctx, key, tds, load, build_ent, bcol, bounds, slab_cap,
            n_slabs)
        if entry is None:
            return False
        used = anchor.used_columns or list(range(len(anchor.schema)))
        cols = {i: device_cache.aligned_col(entry, build_ent, i)
                for i in used}
        info_by_join[id(jnode)] = {"entry": entry, "build_scan": anchor,
                                   "build_ent": build_ent, "cols": cols}
        anchor_subs[id(anchor)] = (entry, build_ent)
        # every join inside the build subtree must re-anchor to the fact
        # row space (all-or-nothing: see docstring)
        for K in crossed:
            if not try_align(K):
                return False
        return True

    # parents first, iterated to a fixpoint: a build-side chain claims its
    # inner joins in one recursive attempt, while a probe-side chain's
    # outer join only becomes resolvable after its inner join aligns in a
    # previous pass
    changed = True
    while changed:
        changed = False
        for node in reversed(TF._walk_joins(root)):
            if id(node) in info_by_join:
                continue
            saved_info = dict(info_by_join)
            saved_subs = dict(anchor_subs)
            if try_align(node):
                changed = True
            else:
                info_by_join.clear()
                info_by_join.update(saved_info)
                anchor_subs.clear()
                anchor_subs.update(saved_subs)
    # unconditional: failed attempts may have left freshly built entries
    # resident; never evict what THIS query executes with (aligned entries
    # in use + every scan's CachedTable)
    device_cache.aligned_budget_check(
        ctx, {i["entry"].key for i in info_by_join.values()},
        keep_tables={(id(store), s.table.id) for s in scans})
    return info_by_join


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class TpuFragmentExec:
    """Volcano leaf running the fused device program (built by executor
    build(), the builder.go:144 seam)."""

    def __init__(self, plan: PhysTpuFragment):
        from tidb_tpu_torch.executor import OperatorStats
        self.plan = plan
        self.schema = plan.schema.field_types
        self.children: List = []
        self.ctx = None
        self.stats = OperatorStats()
        self.used_device = False
        self.fallback_reason: Optional[str] = None
        self.fallback_code: Optional[str] = None
        self._result: Optional[Chunk] = None
        self._cpu_root = None
        self._offset = 0

    def open(self, ctx) -> None:
        self.ctx = ctx
        self.stats.opens += 1
        self._result = None
        self._offset = 0
        self.used_device = False
        self.fallback_reason = None
        self.fallback_code = None

    def runtime_info(self) -> str:
        """Surfaced in EXPLAIN ANALYZE (ref: execdetails.go runtime stats)."""
        esc = getattr(self.ctx, "escalation", None)
        esc = f", escalation:{esc.summary()}" if esc is not None and \
            esc.total else ""
        ph = getattr(self.ctx, "phases", None)
        phs = f", phases:{{{ph.summary()}}}" if ph is not None and \
            ph.summary() else ""
        g = getattr(self.ctx, "guard", None)
        qw = (f", queue_wait:{g.queue_wait_s * 1000.0:.1f}ms"
              f"({g.queue_waits})"
              if g is not None and getattr(g, "queue_waits", 0) else "")
        # degraded-pod marker: how many times this statement was moved
        # off a lost/quarantined device before it completed
        mig = (f", migrated:{g.sched_migrated}"
               if g is not None and getattr(g, "sched_migrated", 0)
               else "")
        rf = ""
        if ph is not None and ph.scan_bytes and ph.wall_s > 0.0:
            from tidb_tpu_torch.util import roofline
            frac = roofline.fraction(ph.scan_bytes, ph.wall_s,
                                     device=self.ctx.device)
            if frac > 0.0:
                rf = f", roofline_fraction:{frac:.3f}"
            if ph.scan_logical_bytes != ph.scan_bytes:
                # compression active: the logical-bytes figure may
                # legitimately exceed 1.0 (that's the win)
                ef = roofline.effective_fraction(ph.scan_logical_bytes,
                                                 ph.wall_s,
                                                 device=self.ctx.device)
                if ef > 0.0:
                    rf += f", effective_roofline_fraction:{ef:.3f}"
        if self.used_device:
            return f"device:yes{esc}{phs}{qw}{mig}{rf}"
        if self.fallback_reason:
            # the parenthesized value is the STABLE taxonomy code — the
            # same string labels tidb_tpu_device_fallbacks_total{reason=}
            return f"device:fallback({self.fallback_code or 'shape'}){esc}"
        return ""

    def next(self) -> Optional[Chunk]:
        if self._cpu_root is not None:
            return self._cpu_root.next()
        if self._result is None:
            strict = _var_bool(self.ctx.vars.get("tidb_tpu_strict", False))
            # checkpoint BEFORE device dispatch: a killed/expired query
            # must not pay for upload + compute it will never use
            self.ctx.check_killed("device-dispatch")
            from tidb_tpu_torch.util.tracing import maybe_span
            _t0 = time.perf_counter()
            try:
                with maybe_span(getattr(self.ctx, "tracer", None),
                                "device.fragment",
                                root=self.plan.root.name):
                    # mark every table this fragment reads as in active
                    # use for the statement's WHOLE device run: sibling
                    # sessions' evictions never drop its slabs mid-compute
                    with self._protect_tables():
                        self._result = self._run_device()
            except FragmentFallback as e:
                # expected data-dependent decline (empty input, exhausted
                # capacity ladder) — quiet, recorded, strict raises.
                # Unexpected device errors are NOT caught: they raise.
                self._note_fallback(getattr(e, "reason", "shape"), str(e))
                if strict:
                    raise ExecutionError(
                        f"tidb_tpu_strict: device fragment fell "
                        f"back: {self.fallback_reason}") from e
                return self._fallback_next()
            global LAST_PHASES
            exec_s = time.perf_counter() - _t0
            self.used_device = True
            _ph = getattr(self.ctx, "phases", None)
            if _ph is not None:
                _ph.add_wall(exec_s)
                LAST_PHASES = _ph
            _tr = getattr(self.ctx, "tracer", None)
            _esc = getattr(self.ctx, "escalation", None)
            if _tr is not None and _esc is not None and _esc.total:
                _tr.event("device.escalation", summary=_esc.summary())
            if _tr is not None and _ph is not None and _ph.total:
                _tr.event("device.phases", duration_s=exec_s,
                          **_ph.as_dict())
            # checkpoint AFTER host fetch, before results flow upward
            from tidb_tpu_torch.util import failpoint
            failpoint.inject("host-fetch")
            self.ctx.check_killed("host-fetch")
        if self._offset >= self._result.num_rows:
            return None
        size = self.ctx.chunk_size
        out = self._result.slice(
            self._offset, min(self._offset + size, self._result.num_rows))
        self._offset += out.num_rows
        return out

    def _note_fallback(self, code: str, detail: str) -> None:
        """Stamp the normalized taxonomy code + free-text detail and move
        the per-reason counter (the coverage table, EXPLAIN ANALYZE, and
        metrics all read the SAME code)."""
        from tidb_tpu_torch.util.observability import REGISTRY
        self.fallback_code = code if code in FALLBACK_REASONS else "shape"
        detail = detail or self.fallback_code
        self.fallback_reason = f"{self.fallback_code}: {detail}" \
            if detail != self.fallback_code else self.fallback_code
        REGISTRY.inc("tidb_tpu_device_fallbacks_total",
                     {"reason": self.fallback_code})

    def _fallback_next(self) -> Optional[Chunk]:
        from tidb_tpu_torch.executor import build
        root = self.plan.root
        if getattr(self.plan, "dist", 0) > 1:
            # distributed plans carry Exchange nodes — pure repartitioning
            # boundaries with no single-node executor; strip them
            root = _strip_exchanges(root)
        self._cpu_root = build(root)
        self._cpu_root.open(self.ctx)
        return self._cpu_root.next()

    def close(self) -> None:
        if self._cpu_root is not None:
            self._cpu_root.close()
            self._cpu_root = None
        self._result = None

    def _protect_tables(self):
        """protect_tables() context over every scan in this fragment —
        per-THREAD registration (device_cache._PROTECT), so concurrent
        statements see each other's in-flight tables as unevictable."""
        from tidb_tpu_torch.executor import device_cache
        from tidb_tpu_torch.executor.tree_fragment import _scans
        store = getattr(self.ctx.snapshot, "store", None)
        return device_cache.protect_tables(
            (id(store), s.table.id) for s in _scans(self.plan.root))

    # ---- device pipeline ---------------------------------------------------
    def _run_device(self) -> Chunk:
        from tidb_tpu_torch.executor import device_cache
        from tidb_tpu_torch.util import failpoint
        failpoint.inject("device-fragment")
        if getattr(self.ctx, "device", None) is None:
            raise ExecutionError("device fragment without a device: the "
                                 "execution context carries none")
        if getattr(self.plan, "dist", 0) > 1:
            return self._run_device_dist()
        chain = _linearize(self.plan.root)
        if chain is None:
            from tidb_tpu_torch.executor.tree_fragment import (has_join,
                                                               has_window)
            if has_join(self.plan.root) or has_window(self.plan.root):
                # joins, and windowed shapes with no linear-chain lowering
                # (interior windows), run as tree programs
                return self._run_device_tree()
            raise ExecutionError("device fragment is neither a linear "
                                 "chain nor a tree (the plan-time gate "
                                 "admits no other shape)")
        # ORDER BY / TopN directly over the agg: strip the order root and
        # run the rest agg-rooted — the ordering becomes the agg's fused
        # device finalize (or a host re-order when the gate is off)
        order_root = None
        if len(chain) > 1 and isinstance(chain[0], (PhysTopN, PhysSort)):
            k = 1
            while k < len(chain) and _identity_projection(chain[k]):
                k += 1
            if k < len(chain) and isinstance(chain[k], PhysHashAgg):
                order_root, chain = chain[0], chain[k:]
        scan: PhysTableScan = chain[-1]
        vars_ = self.ctx.vars
        max_slab = int(vars_.get("tidb_tpu_max_slab_rows",
                                 DEFAULT_MAX_SLAB_ROWS))
        group_cap = int(vars_.get("tidb_tpu_group_cap", DEFAULT_GROUP_CAP))

        used = _used_column_indices(chain)
        in_types = [scan.schema.field_types[i] for i in used]

        # device-resident columnar replica: encoded + uploaded once per
        # table version, reused across queries. First touch STREAMS:
        # open_table returns a per-slab generator the executors drive, so
        # encode of slab k+1 pipelines behind the (async) upload/compute
        # of slab k.
        ent, stream = device_cache.open_table(self.ctx, scan, used,
                                              max_slab,
                                              phases=self.ctx.phases,
                                              prune=True)
        if ent.total == 0:
            raise FragmentFallback("empty input", reason="empty-input")
        dicts = {i: ent.dicts.get(i) for i in used}
        slab_cap, n_slabs = ent.slab_cap, ent.n_slabs

        # zone-map slab pruning: the scan's conjuncts evaluated host-side
        # against per-slab stats. A pruned slab costs NOTHING downstream.
        from tidb_tpu_torch.executor import zonemap
        skip = zonemap.prune_slabs(ent, scan)
        slab_ids = [s for s in range(n_slabs) if s not in skip]
        if skip:
            zonemap.note_skipped(self.ctx.phases, len(skip))

        root = chain[0]
        if n_slabs > 1 and isinstance(root, PhysWindow):
            # window partitions span slabs: per-slab results can't merge;
            # run the chain as ONE program over the concatenated slabs
            if stream is not None:
                for _ in stream:    # commit the upload; the tree path
                    pass            # re-opens the table warm
            return self._run_device_tree()
        if not slab_ids:
            # every slab pruned: ZERO launches. Drain the stream so the
            # skip accounting commits, then synthesize the result the
            # device would have produced: grouped agg → empty, global agg
            # → the CPU oracle's identity row, order/filter roots → empty.
            if stream is not None:
                for _ in stream:
                    pass
            if isinstance(root, PhysHashAgg):
                chunk = self._merge_tree_agg_passes(root, [], dicts)
                if order_root is not None:
                    chunk = _host_order(chunk, order_root, root.schema)
                    chunk = _topn_slice(chunk, order_root)
                return chunk
            from tidb_tpu_torch.executor import _empty_chunk
            return _empty_chunk(self.schema)

        # stats-informed grouping: small known key domains skip the sort
        # (open_table commits dictionaries/bounds EAGERLY — before the
        # stream runs — exactly so program construction can use them here)
        key_bounds = _agg_key_bounds(chain, ent)
        if key_bounds is not None:
            group_cap = 1
            for lo, hi in key_bounds:
                group_cap *= (hi - lo + 2)
        elif isinstance(root, PhysHashAgg):
            group_cap = _initial_group_cap(root, group_cap, slab_cap)

        layouts = _ent_layouts(ent, used)
        if isinstance(root, PhysHashAgg):
            # grouped aggregation owns its ladder loop: overflow retries
            # are RESUMABLE (only overflowed slab partials re-execute)
            return self._execute_agg(chain, root, ent, dicts, stream,
                                     used, in_types, slab_cap, group_cap,
                                     key_bounds, layouts, order_root,
                                     slab_ids=slab_ids)
        if isinstance(root, (PhysTopN, PhysSort)):
            prog = get_program(chain, used, in_types, slab_cap, group_cap,
                               self.ctx.device, layouts=layouts)
            prep_vals = prog.collect_preps(dicts)
            return self._execute_order(prog, root, ent, dicts, prep_vals,
                                       stream, slab_ids=slab_ids)
        # filter roots: lift comparison literals into prepared parameters
        # so `k = 17` and `k = 42` share one program — and, when several
        # such statements are queued at once, ONE batched launch per slab
        # (executor/microbatch.py). The literal-baked program runs when
        # nothing is parametrizable.
        mb_max = int(vars_.get("tidb_tpu_microbatch_max", 16) or 0)
        chain_p = _parametrize_chain(chain) if mb_max >= 1 else None
        if chain_p is None:
            prog = get_program(chain, used, in_types, slab_cap, group_cap,
                               self.ctx.device, layouts=layouts)
            prep_vals = prog.collect_preps(dicts)
        else:
            sig = _chain_signature(chain_p, used, in_types, slab_cap,
                                   group_cap, None, layouts) + \
                f"|pairs=False,0|dev={torch.device(self.ctx.device)}"
            prog = get_program(chain_p, used, in_types, slab_cap,
                               group_cap, self.ctx.device, layouts=layouts,
                               sig=sig)
            # prep values MUST come from THIS statement's chain: the
            # cached program may hold another statement's ParamExpr nodes
            host_preps = collect_chain_preps(chain_p, dicts)
            if mb_max >= 2 and stream is None:
                from tidb_tpu_torch.executor import microbatch
                res = microbatch.execute(self, prog, root, ent, dicts,
                                         host_preps, slab_ids, sig, mb_max)
                if res is not None:
                    return res
            from tidb_tpu_torch.ops.xp import to_device_tree
            prep_vals = [to_device_tree(prog.xp, v) for v in host_preps]
        return self._execute_filter(prog, root, ent, dicts, prep_vals,
                                    stream, slab_ids=slab_ids)

    @staticmethod
    def _slab(ent, slab_idx: int, used: Sequence[int]):
        # restrict to the program's used columns
        cols = {i: ent.dev[i][slab_idx] for i in used}
        return cols, ent.slab_rows(slab_idx)

    def _slab_iter(self, ent, stream, used: Sequence[int], slab_ids=None):
        """Per-slab (cols, n_rows) source: the open_table stream on a cold
        first touch (driving it between dispatches is what overlaps encode
        with device work), the resident cache otherwise. A consumed stream
        has committed its arrays to ent.dev, so ladder retries always take
        the warm branch. `slab_ids` restricts the warm branch to the
        zone-map survivors; the stream needs no restriction — it already
        skipped pruned slabs, and both sides enumerate survivors in the
        same ascending physical order, so positional consumers align."""
        if stream is None:
            ids = slab_ids if slab_ids is not None else range(ent.n_slabs)
            for s in ids:
                yield self._slab(ent, s, used)
        else:
            for s, cols in stream:
                yield {i: cols[i] for i in used}, ent.slab_rows(s)

    # -- hash agg ------------------------------------------------------------
    def _execute_agg(self, chain, root: PhysHashAgg, ent, dicts, stream,
                     used, in_types, slab_cap, group_cap,
                     key_bounds, layouts=None, order_root=None,
                     slab_ids=None) -> Chunk:
        """Grouped aggregation with RESUMABLE capacity escalation.

        Per-slab partials are the checkpoint: on a group-cap overflow,
        only the slabs whose true group count exceeded the cap they ran
        at are re-executed at the exact-need capacity — partials that fit
        merge back in untouched (ragged caps are fine: the merge
        re-factorizes under slot_live masks). A merged-count-only
        overflow re-runs ZERO slabs. A multi-slab DISTINCT aggregate
        also emits per-slab (group, value) pair sets, held to their own
        capacity through resumable "pairs" rungs (never truncated) and
        merged on the host. EscalationStats.slabs_rerun / slabs_reused
        make the reuse observable (EXPLAIN ANALYZE)."""
        from tidb_tpu_torch.util import failpoint
        from tidb_tpu_torch.util.escalation import CapacityLadder
        ph = self.ctx.phases
        vars_ = self.ctx.vars
        device = self.ctx.device
        ladder = CapacityLadder(guard=getattr(self.ctx, "guard", None),
                                stats=self.ctx.escalation)
        n_slabs = ent.n_slabs
        # zone-map survivors: partials/caps/pairs index POSITIONS in
        # slab_ids (ascending physical order — matches the cold stream's
        # yield order); n_slabs stays the table geometry
        slab_ids = list(slab_ids) if slab_ids is not None \
            else list(range(n_slabs))
        n_run = len(slab_ids)
        cap_limit = slab_cap * max(n_slabs, 1)
        has_distinct = any(d.distinct and d.args for d in root.aggs)
        want_pairs = n_slabs > 1 and has_distinct
        # pair-set output capacity: a slab can't emit more pairs than it
        # has rows, so slab_cap is both the default clamp and the ladder's
        # hard ceiling (resize through "pairs" rungs, never truncate)
        pair_cap = min(int(vars_.get("tidb_tpu_distinct_pair_cap", 65536)),
                       slab_cap) if want_pairs else 0
        use_fin = order_root is not None and \
            _var_bool(vars_.get("tidb_tpu_fused_finalize", "on"))
        skey = None
        lay_sig = ",".join(f"{i}:{l.sig()}"
                           for i, l in sorted(layouts.items())) \
            if layouts else "-"
        if _var_bool(vars_.get("tidb_tpu_specialization_cache", "on")):
            skey = _spec_key(
                getattr(self.ctx, "guard", None), "chain",
                (id(ent.td), ent.delta_version, slab_cap, n_slabs,
                 repr(key_bounds), want_pairs, use_fin,
                 _order_sig(order_root) if order_root is not None
                 else None, _plan_fingerprint(chain[0]), str(device)))
        spec = _spec_lookup(skey, lay_sig)
        if skey is not None:
            _spec_note(ph, spec is not None)
        spec_sig = None
        if spec is not None:
            group_cap = spec["group_cap"]
            pair_cap = spec["pair_cap"] if want_pairs else 0
            spec_sig = spec["sig"]
        partials: List = [None] * n_run
        caps = [0] * n_run              # group cap each partial ran at
        pcaps = [0] * n_run             # pair cap each partial ran at
        pairs_cache: List = [None] * n_run     # host distinct-pair sets
        to_run: Optional[List[int]] = None     # None = cold first pass
        while True:
            if spec_sig is not None:
                psig, spec_sig = spec_sig, None
            else:
                psig = _chain_signature(chain, used, in_types, slab_cap,
                                        group_cap, key_bounds, layouts) + \
                    f"|pairs={want_pairs},{pair_cap}|dev={device}"
            prog = get_program(chain, used, in_types, slab_cap, group_cap,
                               device, key_bounds, layouts, sig=psig,
                               want_pairs=want_pairs, pair_cap=pair_cap)
            prep_vals = prog.collect_preps(dicts)
            if to_run is None:
                runs = enumerate(self._slab_iter(ent, stream,
                                                 prog.used_cols, slab_ids))
            else:
                runs = ((s, self._slab(ent, slab_ids[s], prog.used_cols))
                        for s in to_run)
            for s, (cols, n) in runs:
                # slot per slab DISPATCH: the streamed encode of the next
                # slab (inside _slab_iter) runs slot-free
                with self.ctx.device_slot():
                    with ph.phase("compute"):
                        partials[s] = prog.partial(cols, n, prep_vals)
                ph.note_launch()
                ph.note_fused()
                caps[s] = group_cap
                pcaps[s] = pair_cap
                pairs_cache[s] = None
            if want_pairs:
                pover, pair_cap = self._fetch_pairs(
                    partials, pcaps, pairs_cache, ladder, pair_cap, slab_cap)
                if pover:
                    to_run = pover
                    continue
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    if use_fin or n_run > 1:
                        # len(partials[0]["keys"]), not nk: rollup
                        # partials carry a trailing grouping-level column
                        key_cols = [
                            (torch.cat([p["keys"][kc][0] for p in partials]),
                             torch.cat([p["keys"][kc][1] for p in partials]))
                            for kc in range(len(partials[0]["keys"]))]
                        states = [
                            tuple(torch.cat([p["states"][ai][f]
                                             for p in partials])
                                  for f in range(len(partials[0]["states"][ai])))
                            for ai in range(len(root.aggs))]
                        slot_live = torch.cat([p["slot_live"]
                                               for p in partials])
                    if use_fin:
                        fprog, _fsig = get_finalize_program(
                            root, order_root, group_cap, psig)
                        out = fprog.run(key_cols, states, slot_live)
                    elif n_run == 1:
                        out = partials[0]
                    else:
                        out = prog.merge(key_cols, states, slot_live)
                    if use_fin or n_run > 1:
                        ph.note_launch()
            with ph.phase("compute"):
                # drain inside "compute" so the fetch below measures pure
                # transfer, not the device finishing its work
                _sync(device)
            flags = [torch.stack([p["n_groups"].reshape(())
                                  for p in partials]),
                     out["n_groups"].reshape(())]
            if use_fin:
                flags.append(out["n_out"].reshape(()))
            got = ph.fetch(flags)
            if use_fin:
                failpoint.inject("fused-finalize-overflow")
            ngs = [int(x) for x in got[0]]
            # overflow iff a slab's TRUE count exceeded the cap IT ran at
            # (factorize counts before clamping, so per-slab ngs are true;
            # reused partials ran at an older, smaller cap and stay valid)
            over = [s for s in range(n_run) if ngs[s] > caps[s]]
            n_final = int(got[1])
            if over:
                if group_cap >= cap_limit:
                    ladder.fallback("group")
                    raise FragmentFallback("group cap overflow",
                                           reason="group-cap")
                need_cap = max(ngs[s] for s in over)
                group_cap = ladder.resize("group", group_cap,
                                          need=need_cap,
                                          max_cap=cap_limit)
                ladder.attempt("group", _GroupCapOverflow(need_cap))
                ladder.partial_resume("group", rerun=len(over),
                                      reused=n_run - len(over))
                to_run = over
                continue
            if n_final > prog.group_cap:
                # only the MERGED distinct count overflowed: every slab
                # partial is a valid checkpoint — re-run NOTHING, just
                # re-merge at the exact-need cap
                if group_cap >= cap_limit:
                    ladder.fallback("group")
                    raise FragmentFallback("group cap overflow",
                                           reason="group-cap")
                group_cap = ladder.resize("group", group_cap,
                                          need=n_final,
                                          max_cap=cap_limit)
                ladder.attempt("group", _GroupCapOverflow(n_final))
                ladder.partial_resume("group", rerun=0, reused=n_run)
                to_run = []
                continue
            break
        if skey is not None and (spec is None
                                 or spec["group_cap"] != group_cap
                                 or spec["pair_cap"] != pair_cap):
            _spec_store(skey, {"group_cap": group_cap,
                               "pair_cap": pair_cap, "sig": psig,
                               "lay_sig": lay_sig})
        if root.group_exprs and n_final == 0:
            from tidb_tpu_torch.executor import _empty_chunk
            return _empty_chunk(self.schema)
        n_rows = int(got[2]) if use_fin else n_final
        chunk = self._agg_chunk(root, out, dicts, max(n_rows, 1),
                                _host_pairs(pairs_cache) if want_pairs
                                else None)
        if order_root is not None:
            if not use_fin:
                # finalize gate off: device agg as before, then a host
                # re-order of the (small) final group rows
                chunk = _host_order(chunk, order_root, root.schema)
            chunk = _topn_slice(chunk, order_root)
        return chunk

    def _fetch_pairs(self, partials, pcaps, pairs_cache, ladder,
                     pair_cap: int, slab_cap: int):
        """Per-slab deduped (group, value) pair sets ride inside the
        partial outputs: fetch the true pair counts of the slabs not yet
        cached. Slabs whose count exceeded the pair cap they ran at climb
        one resumable "pairs" rung (exact need, at most a slab; past that
        the `pair-cap` fallback) → (those slabs, the new pair cap). When
        none did, slice each set to its count on the device and fetch it
        into `pairs_cache` (host-side per slab: a resumable retry
        refetches only re-run slabs) → ([], pair_cap)."""
        from tidb_tpu_torch.util import failpoint
        ph = self.ctx.phases
        need = [s for s in range(len(partials)) if pairs_cache[s] is None]
        if not need:
            return [], pair_cap
        counts = ph.fetch([{ai: partials[s]["pairs"][ai][1]
                            for ai in partials[s]["pairs"]} for s in need])
        # n_pairs reports the TRUE per-slab pair count, the output arrays
        # hold only pcaps[s] — a clipped slab must resize and re-run,
        # never silently truncate
        failpoint.inject("fused-finalize-overflow")
        pover = [s for si, s in enumerate(need)
                 if any(int(c) > pcaps[s] for c in counts[si].values())]
        if pover:
            if pair_cap >= slab_cap:
                ladder.fallback("pairs")
                raise FragmentFallback("distinct pair overflow",
                                       reason="pair-cap")
            worst = max(int(c) for si, s in enumerate(need) if s in pover
                        for c in counts[si].values())
            pair_cap = ladder.resize("pairs", pair_cap, need=worst,
                                     max_cap=slab_cap)
            ladder.attempt("pairs", _GroupCapOverflow(worst))
            ladder.partial_resume("pairs", rerun=len(pover),
                                  reused=len(partials) - len(pover))
            return pover, pair_cap
        per_slab = ph.fetch([
            {ai: [(v[:int(counts[si][ai])], m[:int(counts[si][ai])])
                  for v, m in partials[s]["pairs"][ai][0]]
             for ai in partials[s]["pairs"]}
            for si, s in enumerate(need)])
        for s, ps in zip(need, per_slab):
            pairs_cache[s] = ps
        return [], pair_cap

    def _agg_chunk(self, root: PhysHashAgg, out, dicts, n_final,
                   distinct_pairs=None, host_tree=None) -> Chunk:
        if host_tree is not None:
            # keys/states already came back WITH the flag fetch (small
            # group caps piggyback on the first round trip); slice the
            # padding off host-side
            hk, hs = host_tree
            host_keys = [(np.asarray(k)[:n_final], np.asarray(m)[:n_final])
                         for k, m in hk]
            host_states = [tuple(np.asarray(a)[:n_final] for a in st)
                           for st in hs]
        else:
            # slice ON DEVICE, fetch everything in one copy
            dev_tree = (
                [(k[:n_final], m[:n_final]) for k, m in out["keys"]],
                [tuple(a[:n_final] for a in st) for st in out["states"]],
            )
            host_keys, host_states = self.ctx.phases.fetch(dev_tree)
        with self.ctx.phases.phase("decode"):
            if distinct_pairs:
                # multi-slab DISTINCT: the device-merged distinct states
                # deduped only within each slab — recompute them from the
                # cross-slab-deduped pair sets
                over = _merge_distinct_states(root, host_keys,
                                              distinct_pairs, n_final)
                host_states = [over.get(ai, st)
                               for ai, st in enumerate(host_states)]
            cols: List[Column] = []
            for kc, e in enumerate(root.group_exprs):
                ft = self.schema[kc]
                v, m = host_keys[kc]
                cols.append(_decode_col(ft, v, m, _expr_dict(e, dicts)))
            for agg, st in zip([build_agg(d) for d in root.aggs],
                               host_states):
                v, m = agg.final(np, st)
                cols.append(_decode_col(agg.ftype, np.asarray(v),
                                        np.asarray(m, dtype=bool), None))
            return Chunk(cols)

    # -- topn / sort ---------------------------------------------------------
    def _execute_order(self, prog, root, ent, dicts, prep_vals,
                       stream=None, slab_ids=None) -> Chunk:
        ph = self.ctx.phases
        outs = []
        for cols, n in self._slab_iter(ent, stream, prog.used_cols,
                                       slab_ids):
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    outs.append(prog.partial(cols, n, prep_vals))
            ph.note_launch()
            ph.note_fused()
        with ph.phase("compute"):
            _sync(self.ctx.device)
        n_outs = [int(x) for x in ph.fetch(
            torch.stack([o["n_out"].reshape(()) for o in outs]))]
        # slice on device, fetch all slabs' candidates in one copy
        host_tree = ph.fetch([[(v[:n], m[:n]) for v, m in o["cols"]]
                              for o, n in zip(outs, n_outs)])
        with ph.phase("decode"):
            pieces = [self._cols_chunk(root, cols_host, dicts)
                      for cols_host in host_tree]
            if len(pieces) == 1:
                merged = pieces[0]
            else:
                # per-slab top-(k+off) candidates merged on host (small)
                merged = Chunk.concat(pieces)
                merged = _host_order(merged, root, self.plan.root.schema)
            return _topn_slice(merged, root)

    def _cols_chunk(self, root, host_cols, dicts) -> Chunk:
        child_types = [ft for ft in root.schema.field_types]
        out = []
        for ci, ((v, m), ft) in enumerate(zip(host_cols, child_types)):
            out.append(_decode_col(ft, np.asarray(v), np.asarray(m),
                                   _positional_dict(root, ci, dicts)))
        return Chunk(out)

    # -- selection / projection ----------------------------------------------
    def _execute_filter(self, prog, root, ent, dicts, prep_vals,
                        stream=None, slab_ids=None) -> Chunk:
        ph = self.ctx.phases
        outs = []
        for cols, n in self._slab_iter(ent, stream, prog.used_cols,
                                       slab_ids):
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    out = prog.partial(cols, n, prep_vals)
                    # compact the surviving rows on the device (K22 with
                    # one member, K18): only they cross back to the host
                    outs.append(compact_rows(out["cols"],
                                             out["live"].reshape(1, -1))[0])
            ph.note_launch()
            ph.note_fused()
        with ph.phase("compute"):
            _sync(self.ctx.device)
        host_outs = ph.fetch(outs)
        with ph.phase("decode"):
            pieces: List[Chunk] = []
            for host_cols in host_outs:
                pieces.append(Chunk([
                    _decode_col(ft, v, m, _positional_dict(root, ci, dicts))
                    for ci, ((v, m), ft) in enumerate(
                        zip(host_cols, root.schema.field_types))]))
            return Chunk.concat(pieces) if len(pieces) > 1 else pieces[0]

    # ---- join-tree device pipeline -----------------------------------------
    def _run_device_tree(self) -> Chunk:
        """Q3/Q5-shaped join trees. Agg-rooted trees run the fused per-slab
        pipeline (_run_fused_pipeline); other roots, and a fan-out the
        pipeline cannot hold, run the whole tree as one program over every
        table's full capacity. Join modes adapt at runtime (a lost
        uniqueness bet or an expansion-capacity overflow re-runs with the
        learned configuration, never on the CPU); a fan-out beyond
        tidb_tpu_join_out_cap runs as blocked row-range passes."""
        from tidb_tpu_torch.executor import device_cache
        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import _pow2
        from tidb_tpu_torch.util.escalation import CapacityLadder

        root = self.plan.root
        # ORDER BY / TopN over the agg runs as the agg's fused device
        # finalize (or a host re-order on the mega-slab path): everything
        # below — flows, signatures, key bounds — stays agg-rooted
        order_root, root = _strip_order_root(root)
        vars_ = self.ctx.vars
        device = self.ctx.device
        max_slab = int(vars_.get("tidb_tpu_max_slab_rows",
                                 DEFAULT_MAX_SLAB_ROWS))
        group_cap = int(vars_.get("tidb_tpu_group_cap", DEFAULT_GROUP_CAP))

        scans = TF._scans(root)
        ents = []
        # every scan of THIS statement is protected from sibling evictions
        # for the whole device run (next() wrapped _run_device in
        # _protect_tables)
        for scan in scans:
            used = scan.used_columns if scan.used_columns else \
                list(range(len(scan.schema)))
            ent = device_cache.get_table(self.ctx, scan, used, max_slab,
                                         phases=self.ctx.phases)
            if ent.total == 0:
                raise FragmentFallback("empty input", reason="empty-input")
            ents.append((ent, used))
        caps = {id(s): (e.slab_cap, e.n_slabs)
                for s, (e, _) in zip(scans, ents)}
        # per-scan-slot ((col, ColLayout), ...) for compressed columns —
        # parallel to TF._scans(root) order
        scan_layouts = tuple(
            tuple(sorted(((i, e.layouts[i]) for i in u
                          if e.layouts.get(i) is not None),
                         key=lambda t: t[0]))
            for e, u in ents)
        if not any(scan_layouts):
            scan_layouts = None
        scan_dicts = {id(s): {i: e.dicts.get(i) for i in u}
                      for s, (e, u) in zip(scans, ents)}
        scan_bounds = {id(s): e.bounds for s, (e, _) in zip(scans, ents)}
        join_cfgs = TF.plan_join_configs(root, scan_bounds)
        flows, root_dicts = TF.dictionary_flows(root, scan_dicts)
        scan_inputs = tuple({i: list(e.dev[i]) for i in u}
                            for e, u in ents)
        scan_rows = tuple(
            np.array([e.slab_rows(s) for s in range(e.n_slabs)],
                     dtype=np.int32) for e, _ in ents)
        # zone-map slab pruning, tree flavor: scan_rows is a runtime input
        # (the per-slab live mask reads it), so zeroing a pruned slab's
        # row count removes its rows with no signature change; the fused
        # per-slab pipeline skips those slabs' launches entirely
        from tidb_tpu_torch.executor import zonemap
        n_zeroed = 0
        for sc, (e, _u), rows in zip(scans, ents, scan_rows):
            for s in zonemap.prune_slabs(e, sc):
                rows[s] = 0
                n_zeroed += 1
        if n_zeroed:
            zonemap.note_skipped(self.ctx.phases, n_zeroed)
        max_cap = max(e.slab_cap * e.n_slabs for e, _ in ents)

        flow_list = [flows.get(id(n), []) for n in TF._walk_nodes(root)]
        is_agg = isinstance(root, PhysHashAgg)
        # FK-aligned joins: verified-unique PK-FK joins run as streams over
        # cached fact-rowspace build columns (no per-query gathers)
        aligned_info = _plan_aligned_joins(self.ctx, root, scans, ents)
        walk_joins = TF._walk_joins(root)
        aligned_inputs = []
        for ji, jn in enumerate(walk_joins):
            info = aligned_info.get(id(jn))
            if info is None:
                aligned_inputs.append(((), {}))
                continue
            join_cfgs[ji] = TF.JoinCfg(
                "aligned", aligned_cols=tuple(sorted(info["cols"])))
            aligned_inputs.append(
                (tuple(info["entry"].matched),
                 {c: tuple(sl) for c, sl in info["cols"].items()}))
        aligned_inputs = tuple(aligned_inputs)
        akb = TF.tree_agg_key_bounds(root, scan_bounds, DOMAIN_CAP) \
            if is_agg else None
        if akb is not None:
            gcap = 1
            for lo, hi in akb:
                gcap *= (hi - lo + 2)
        elif is_agg:
            gcap = _initial_group_cap(root, group_cap, max_cap)
        else:
            gcap = 1
        out_cap_max = int(vars_.get("tidb_tpu_join_out_cap",
                                    TF.JOIN_OUT_CAP))
        ladder = CapacityLadder(guard=getattr(self.ctx, "guard", None),
                                stats=self.ctx.escalation)
        ph = self.ctx.phases
        # ---- fused per-slab pipeline -----------------------------------
        # Agg-rooted trees run scan → filter → project → join-probe →
        # partial-agg once PER PROBE SLAB plus one root merge/finalize,
        # instead of one program over the whole probe table
        if is_agg and _var_bool(vars_.get("tidb_tpu_fused_pipeline", "on")):
            anchor = TF.aligned_chain(root.children[0])[0]
            anchor_i = next((i for i, s in enumerate(scans)
                             if s is anchor), None)
            if anchor_i is not None:
                res = self._run_fused_pipeline(
                    root, caps, scans, ents, scan_inputs, scan_rows,
                    flow_list, flows, aligned_inputs, join_cfgs,
                    walk_joins, akb, gcap, max_cap, out_cap_max, ladder,
                    anchor_i, scan_layouts, order_root)
                if res is not None:
                    return res
                # a join's fan-out exceeded out_cap_max inside the fused
                # pipeline: fall through to the whole-tree loop, whose own
                # over-max rung escalates to blocked multi-pass execution
                # (learned flips/resizes persist in join_cfgs)
        while True:
            prog = get_tree_program(root, caps, gcap, device, join_cfgs,
                                    akb, scan_layouts)
            prep_vals = prog.collect_preps(flow_list)
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    out = prog(scan_inputs, scan_rows, prep_vals,
                               aligned_inputs)
            ph.note_launch()
            fetch = {"ju": out["join_unique"], "jt": out["join_totals"]}
            if is_agg:
                fetch["ng"] = out["n_groups"]
                _piggyback_agg(fetch, out, gcap)
            elif isinstance(root, (PhysTopN, PhysSort, PhysLimit)):
                fetch["no"] = out["n_out"]
                if isinstance(root, (PhysTopN, PhysLimit)) and \
                        out["cols"] and \
                        out["cols"][0][0].shape[-1] <= SMALL_GROUP_CAP:
                    # the device result is ALREADY truncated to
                    # min(count+offset, rows): when that shape is small it
                    # rides the flag fetch — no second trip
                    fetch["cols"] = list(out["cols"])
            with ph.phase("compute"):
                _sync(device)
            flags = ph.fetch(fetch)
            retry = False
            for ji, cfg in enumerate(join_cfgs):
                uq = bool(np.asarray(flags["ju"])[ji])
                tot = int(np.asarray(flags["jt"])[ji])
                new_cfg, action = TF.escalate_join(
                    cfg, uq, tot, out_cap_max,
                    flip_out_cap=_pow2(int(cfg.est * 1.3), lo=1024),
                    ladder=ladder)
                if action == "over-max":
                    # runaway fan-out (many-to-many on a skewed key): too
                    # large to materialize in one batch — run the tree in
                    # K row-range passes over the probe anchor and merge
                    # root agg states host-side (the grace-hash
                    # partitioning analog, executor/hash_table.go)
                    return self._run_tree_blocked(
                        root, caps, join_cfgs, ji, walk_joins, akb,
                        gcap, max_cap, scans, ents, scan_inputs,
                        scan_rows, flow_list, aligned_inputs, flows,
                        tot, scan_layouts)
                if new_cfg is not None:
                    join_cfgs[ji] = new_cfg
                    retry = True
            if is_agg and akb is None and int(flags["ng"]) > gcap:
                if gcap >= max_cap:
                    ladder.fallback("group")
                    raise FragmentFallback("group cap overflow",
                                           reason="group-cap")
                # factorize reported the TRUE distinct count: resize to
                # exact need in one rebuild instead of blind doubling
                gcap = ladder.resize("group", gcap, need=int(flags["ng"]),
                                     max_cap=max_cap)
                retry = True
            if retry:
                # budget + guard checkpoint between rebuilds: a KILL or
                # deadline lands here, and a rebuild storm exhausts into a
                # typed error instead of looping
                ladder.attempt("tree")
                continue
            break

        dicts_root = {i: d for i, d in enumerate(root_dicts)}
        if is_agg:
            n_final = int(flags["ng"])
            if root.group_exprs and n_final == 0:
                from tidb_tpu_torch.executor import _empty_chunk
                return _empty_chunk(self.schema)
            inp_dicts = {i: d for i, d in
                         enumerate(flows.get(id(root), []))}
            host_tree = (flags["keys"], flags["states"]) \
                if "keys" in flags else None
            chunk = self._agg_chunk(root, out, inp_dicts, max(n_final, 1),
                                    host_tree=host_tree)
            if order_root is not None:
                # the (small) final group rows re-order on the host; the
                # fused per-slab path orders them on the device inside the
                # finalize instead
                chunk = _host_order(chunk, order_root, root.schema)
                chunk = _topn_slice(chunk, order_root)
            return chunk
        if isinstance(root, (PhysTopN, PhysSort, PhysLimit)):
            n_out = int(flags["no"])
            if "cols" in flags:
                host_cols = [(np.asarray(v)[..., :n_out],
                              np.asarray(m)[:n_out])
                             for v, m in flags["cols"]]
            else:
                host_cols = ph.fetch([(v[..., :n_out], m[:n_out])
                                      for v, m in out["cols"]])
            with ph.phase("decode"):
                cols = [_decode_col(ft, np.asarray(v), np.asarray(m),
                                    dicts_root.get(ci))
                        for ci, ((v, m), ft) in
                        enumerate(zip(host_cols, root.schema.field_types))]
            return _topn_slice(Chunk(cols), root)
        # join/selection/projection root: compact by live on the device
        return _compact_decode(ph, out["cols"], out["live"],
                               root.schema.field_types, dicts_root)

    def _run_fused_pipeline(self, root, caps, scans, ents, scan_inputs,
                            scan_rows, flow_list, flows, aligned_inputs,
                            join_cfgs, walk_joins, akb, gcap, max_cap,
                            out_cap_max, ladder, anchor_i,
                            scan_layouts=None,
                            order_root=None) -> Optional[Chunk]:
        """Whole-pipeline fusion: ONE program run per probe-anchor slab
        covering scan → filter → project → join-probe → partial-agg, plus
        one shared root merge (or fused finalize).

        Join build sides ride inside each per-slab run at their FULL
        capacities — dimension tables, or FK-aligned columns already in the
        anchor's row space — so every run joins a partition of the probe
        rows against complete build sides and the slab union of agg
        partials is exact for every join kind (tree_ok pins outer joins to
        preserve the probe side, the same argument that makes
        _run_tree_blocked's row-range passes exact).

        RESUMABLE: per-slab partials are checkpoints. A lost unique bet
        re-runs every slab (the join's program changed); an expand-
        capacity resize or a group-cap overflow re-runs ONLY the slabs that
        overflowed; a merged-count-only overflow re-runs zero slabs (a
        bigger-cap re-merge of the checkpoints). Returns None when a join's
        fan-out exceeds out_cap_max — the caller's whole-tree loop owns
        the blocked multi-pass escalation."""
        import hashlib

        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import _pow2
        from tidb_tpu_torch.util import failpoint

        ph = self.ctx.phases
        vars_ = self.ctx.vars
        device = self.ctx.device
        anchor = scans[anchor_i]
        a_ent = ents[anchor_i][0]
        n_slabs, slab_cap = a_ent.n_slabs, a_ent.slab_cap
        pipe_caps = dict(caps)
        pipe_caps[id(anchor)] = (slab_cap, 1)
        anchor_rows = scan_rows[anchor_i]
        # zone-map pruning: _run_device_tree already zeroed the scan_rows
        # entries of slabs the anchor scan's conjuncts prune, so a zero
        # row count IS the skip signal. run_ids are the surviving physical
        # slab ids; every per-slab list below indexes POSITIONS in run_ids
        run_ids = [s for s in range(n_slabs) if int(anchor_rows[s]) > 0]
        n_run = len(run_ids)
        if not run_ids:
            # every anchor slab pruned: zero launches — grouped agg →
            # empty, global agg → the merge-of-zero-passes identity row
            inp_dicts = {i: d
                         for i, d in enumerate(flows.get(id(root), []))}
            chunk = self._merge_tree_agg_passes(root, [], inp_dicts)
            if order_root is not None:
                chunk = _host_order(chunk, order_root, root.schema)
                chunk = _topn_slice(chunk, order_root)
            return chunk
        has_distinct = any(d.distinct and d.args for d in root.aggs)
        want_pairs = has_distinct and n_slabs > 1
        pair_cap = min(int(vars_.get("tidb_tpu_distinct_pair_cap", 65536)),
                       slab_cap) if want_pairs else 0
        use_fin = order_root is not None and \
            _var_bool(vars_.get("tidb_tpu_fused_finalize", "on"))
        # per-digest specialization (see _execute_agg): adopt the caps and
        # learned join configs a previous execution of this statement
        # shape settled on and reuse its exact pipeline signature
        skey = None
        lay_sig = ",".join(
            f"{si}/{i}:{l.sig()}"
            for si, slot in enumerate(scan_layouts or ())
            for i, l in slot) if scan_layouts else "-"
        if _var_bool(vars_.get("tidb_tpu_specialization_cache", "on")):
            skey = _spec_key(
                getattr(self.ctx, "guard", None), "tree",
                (tuple((id(e.td), e.delta_version, e.slab_cap, e.n_slabs)
                       for e, _ in ents),
                 anchor_i, repr(akb), want_pairs, use_fin,
                 _order_sig(order_root) if order_root is not None
                 else None, _plan_fingerprint(root), str(device)))
        spec = _spec_lookup(skey, lay_sig)
        if skey is not None:
            _spec_note(ph, spec is not None)
        spec_sig = None
        if spec is not None:
            gcap = spec["group_cap"]
            pair_cap = spec["pair_cap"] if want_pairs else 0
            join_cfgs[:] = list(spec["join_cfgs"])
            spec_sig = spec["sig"]

        # Joins whose aligned inputs live in the ANCHOR's row space — the
        # only ones whose matched/column slabs may be sliced per anchor
        # slab: the root's probe chain, plus recursively the build chains
        # of its ALIGNED joins (_plan_aligned_joins re-anchored those to
        # the fact row space). An aligned join hanging off a non-aligned
        # build subtree keeps its own fact scan's row space and passes its
        # inputs through whole.
        anchor_spaced: set = set()
        stack = list(TF.aligned_chain(root.children[0])[1])
        while stack:
            j = stack.pop()
            anchor_spaced.add(id(j))
            ji = walk_joins.index(j)
            if join_cfgs[ji].mode == "aligned":
                bi = 1 if j.build_right else 0
                stack.extend(TF.aligned_chain(j.children[bi])[1])

        def slab_args(s):
            si = list(scan_inputs)
            si[anchor_i] = {i: [scan_inputs[anchor_i][i][s]]
                            for i in scan_inputs[anchor_i]}
            sr = list(scan_rows)
            sr[anchor_i] = np.array([anchor_rows[s]], dtype=np.int32)
            ai = []
            for ji, jn in enumerate(walk_joins):
                matched, jcols = aligned_inputs[ji]
                if matched and id(jn) in anchor_spaced:
                    ai.append(((matched[s],),
                               {c: (sl[s],) for c, sl in jcols.items()}))
                else:
                    ai.append((matched, jcols))
            return tuple(si), tuple(sr), tuple(ai)

        partials: List = [None] * n_run
        caps_ran = [0] * n_run         # group cap each partial ran at
        pcaps = [0] * n_run            # pair cap each partial ran at
        pairs_cache: List = [None] * n_run     # host distinct-pair sets
        to_run: Optional[List[int]] = None     # None = cold first pass
        n_joins = len(walk_joins)
        while True:
            prog, pipe_sig = get_pipeline_program(root, pipe_caps, gcap,
                                                  device, join_cfgs, akb,
                                                  scan_layouts, want_pairs,
                                                  pair_cap, sig=spec_sig)
            spec_sig = None
            prep_vals = prog.collect_preps(flow_list)
            sig12 = hashlib.sha1(pipe_sig.encode()).hexdigest()[:12]
            for s in (range(n_run) if to_run is None else to_run):
                si, sr, ai = slab_args(run_ids[s])
                with self.ctx.device_slot():
                    with ph.phase("compute", sig=f"fused:{sig12}"):
                        partials[s] = prog(si, sr, prep_vals, ai)
                ph.note_launch()
                ph.note_fused()
                caps_ran[s] = gcap
                pcaps[s] = pair_cap
                pairs_cache[s] = None
            if want_pairs:
                # distinct (group, value) pair sets, as in _execute_agg
                pover, pair_cap = self._fetch_pairs(
                    partials, pcaps, pairs_cache, ladder, pair_cap, slab_cap)
                if pover:
                    to_run = pover
                    continue
            # per-slab partials + root merge/finalize queue first; every
            # control value returns in ONE batched fetch
            with self.ctx.device_slot():
                with ph.phase("compute"):
                    if use_fin or n_run > 1:
                        key_cols = [
                            tuple(torch.cat([p["keys"][kc][f]
                                             for p in partials])
                                  for f in range(2))
                            for kc in range(len(partials[0]["keys"]))]
                        states = [
                            tuple(torch.cat([p["states"][ai_][f]
                                             for p in partials])
                                  for f in range(
                                      len(partials[0]["states"][ai_])))
                            for ai_ in range(len(root.aggs))]
                        slot_live = torch.cat([p["slot_live"]
                                               for p in partials])
                    if use_fin:
                        # ONE program for the whole query tail: agg merge
                        # → finalize expressions → root ORDER BY / TopN
                        fprog, _fsig = get_finalize_program(
                            root, order_root, gcap, pipe_sig)
                        out = fprog.run(key_cols, states, slot_live)
                        ph.note_launch()
                    elif n_run == 1:
                        out = partials[0]
                    else:
                        mp = get_merge_program(root, gcap, pipe_sig)
                        out = mp.merge(key_cols, states, slot_live)
                        ph.note_launch()
                    fetch = {"ngs": [p["n_groups"] for p in partials],
                             "ng": out["n_groups"],
                             "jus": [p["join_unique"] for p in partials],
                             "jts": [p["join_totals"] for p in partials]}
                    if use_fin:
                        fetch["no"] = out["n_out"]
                    small = _piggyback_agg(fetch, out, gcap)
            with ph.phase("compute"):
                _sync(device)
            got = ph.fetch(fetch)
            # the fused-program capacity boundary: everything below
            # classifies this round's overflows into rerun sets
            failpoint.inject("fused-pipeline-overflow")
            if use_fin:
                failpoint.inject("fused-finalize-overflow")
            jts = np.asarray(got["jts"]).reshape(n_run, n_joins) \
                if n_joins else np.zeros((n_run, 0), dtype=np.int64)
            jus = np.asarray(got["jus"]).reshape(n_run, n_joins) \
                if n_joins else np.zeros((n_run, 0), dtype=bool)
            retry = False
            charged = False
            rerun: set = set()
            for ji, cfg in enumerate(join_cfgs):
                uq = bool(jus[:, ji].all())
                tot = int(jts[:, ji].max()) if n_run else 0
                new_cfg, action = TF.escalate_join(
                    cfg, uq, tot, out_cap_max,
                    flip_out_cap=_pow2(int(cfg.est * 1.3), lo=1024),
                    ladder=ladder)
                if action == "over-max":
                    return None
                if new_cfg is not None:
                    join_cfgs[ji] = new_cfg
                    retry = True
                    if action == "flip":
                        # the join's program changed: every checkpoint is
                        # from the wrong program — full re-run
                        rerun.update(range(n_run))
                    else:
                        # exact resize: only slabs whose OWN fan-out
                        # overflowed the old cap re-run
                        rerun.update(s for s in range(n_run)
                                     if int(jts[s, ji]) > cfg.out_cap)
            n_final = int(got["ng"])
            if akb is None:
                over = [s for s in range(n_run)
                        if int(got["ngs"][s]) > caps_ran[s]]
                if over or n_final > gcap:
                    if gcap >= max_cap:
                        ladder.fallback("group")
                        raise FragmentFallback("group cap overflow",
                                               reason="group-cap")
                    # clipped slabs understate the merged count, so the
                    # max overflowed per-slab count is the valid lower
                    # bound; merged-only overflow is exact (rerun=0)
                    need_cap = max([int(got["ngs"][s]) for s in over]
                                   + [n_final])
                    gcap = ladder.resize("group", gcap, need=need_cap,
                                         max_cap=max_cap)
                    ladder.attempt("group", _GroupCapOverflow(need_cap))
                    ladder.partial_resume("group", rerun=len(over),
                                          reused=n_run - len(over))
                    charged = True
                    rerun.update(over)
                    retry = True
            if retry:
                if not charged:
                    # budget + guard checkpoint between rebuilds (the
                    # join rungs above already recorded their own stats)
                    ladder.attempt("fused")
                to_run = sorted(rerun)
                continue
            break
        if skey is not None and (spec is None
                                 or spec["group_cap"] != gcap
                                 or spec["pair_cap"] != pair_cap
                                 or list(spec["join_cfgs"]) != join_cfgs):
            _spec_store(skey, {"group_cap": gcap, "pair_cap": pair_cap,
                               "join_cfgs": tuple(join_cfgs),
                               "sig": pipe_sig, "lay_sig": lay_sig})
        if root.group_exprs and n_final == 0:
            from tidb_tpu_torch.executor import _empty_chunk
            return _empty_chunk(self.schema)
        inp_dicts = {i: d for i, d in enumerate(flows.get(id(root), []))}
        host_tree = (got["keys"], got["states"]) if small else None
        n_rows = int(got["no"]) if use_fin else n_final
        with ph.phase("decode"):
            chunk = self._agg_chunk(root, out, inp_dicts, max(n_rows, 1),
                                    _host_pairs(pairs_cache) if want_pairs
                                    else None, host_tree=host_tree)
        if order_root is not None:
            if not use_fin:
                chunk = _host_order(chunk, order_root, root.schema)
            chunk = _topn_slice(chunk, order_root)
        return chunk

    def _run_tree_blocked(self, root, caps, join_cfgs, bji, walk_joins,
                          akb, gcap, max_cap, scans, ents, scan_inputs,
                          scan_rows, flow_list, aligned_inputs, flows,
                          est_total, scan_layouts=None) -> Chunk:
        """Blocked (multi-pass) expand: a many-to-many join whose fan-out
        exceeds tidb_tpu_join_out_cap runs as K row-range passes over its
        probe anchor scan, each pass expanding at most that many rows on
        the device; the root agg's partial states merge host-side. The
        device path never falls back to the CPU on skew.

        Ref: grace-hash partitioning (executor/hash_table.go, docs/design/
        2018-09-21-radix-hashjoin.md) — partitioning by probe row ranges
        instead of key radix because ranges keep every other operator in
        the program untouched."""
        import math
        from dataclasses import replace as d_replace

        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import _pow2

        out_cap_max = int(self.ctx.vars.get("tidb_tpu_join_out_cap",
                                            TF.JOIN_OUT_CAP))
        device = self.ctx.device
        ph = self.ctx.phases
        if not isinstance(root, PhysHashAgg):
            raise FragmentFallback(
                f"join fan-out {est_total} exceeds device cap "
                f"(non-agg root)", reason="join-cap")
        if any(d.distinct for d in root.aggs):
            raise FragmentFallback("blocked expand: DISTINCT aggs",
                                   reason="blocked-expand")
        if any(d.ftype.is_wide_decimal or
               any(a.ftype.is_wide_decimal for a in d.args)
               for d in root.aggs):
            raise FragmentFallback("blocked expand: wide-decimal aggs",
                                   reason="blocked-expand")
        bjoin = walk_joins[bji]
        # the blocked join must be reachable from the root agg via PROBE
        # sides only: each pass joins a slice of the probe rows against
        # FULL build sides, so the pass union is exactly the full result —
        # but if any ancestor held the blocked join in its BUILD subtree,
        # that ancestor would see a partial build side per pass
        # (double-counting semi matches, K-times-emitting anti rows)

        def probe_path_ok(node) -> bool:
            if node is bjoin:
                return True
            if isinstance(node, PhysHashJoin):
                return probe_path_ok(
                    node.children[0 if node.build_right else 1])
            if node.children:
                return probe_path_ok(node.children[0])
            return False

        if not probe_path_ok(root):
            raise FragmentFallback(
                "blocked expand: overflowing join is inside an ancestor's "
                "build subtree", reason="blocked-expand")
        bi = 1 if bjoin.build_right else 0
        anchor, crossed = TF.aligned_chain(bjoin.children[1 - bi])
        if anchor is None:
            raise FragmentFallback("blocked expand: no probe anchor",
                                   reason="blocked-expand")
        for j in crossed:
            jcfg = join_cfgs[walk_joins.index(j)]
            if not (jcfg.mode == "aligned" or j.kind in ("semi", "anti")):
                raise FragmentFallback(
                    "blocked expand: probe chain crosses a join that may "
                    "not preserve the row space", reason="blocked-expand")
        anchor_ent = next(e for s, (e, _) in zip(scans, ents)
                          if s is anchor)
        total_cap = anchor_ent.slab_cap * anchor_ent.n_slabs
        join_cfgs = list(join_cfgs)
        join_cfgs[bji] = d_replace(join_cfgs[bji], blocked=True,
                                   out_cap=out_cap_max)

        K = max(2, math.ceil(est_total * 1.2 / out_cap_max))
        while K <= 128:
            prog = get_tree_program(root, caps, gcap, device, join_cfgs,
                                    akb, scan_layouts)
            prep_vals = prog.collect_preps(flow_list)
            step = (total_cap + K - 1) // K
            pass_outs = []
            overflow = False
            restart = False
            for k in range(K):
                rng = (k * step, min((k + 1) * step, total_cap))
                with self.ctx.device_slot():
                    with ph.phase("compute"):
                        out = prog(scan_inputs, scan_rows, prep_vals,
                                   aligned_inputs, rng)
                ph.note_launch()
                # flags first: a restart/overflow pass never transfers its
                # (discarded) group arrays, and good passes transfer only
                # ng live slots instead of the full gcap padding
                got = ph.fetch({"ju": out["join_unique"],
                                "jt": out["join_totals"],
                                "ng": out["n_groups"]})
                for ji, cfg in enumerate(join_cfgs):
                    uq = bool(np.asarray(got["ju"])[ji])
                    tot = int(np.asarray(got["jt"])[ji])
                    if cfg.mode == "unique" and not uq:
                        join_cfgs[ji] = d_replace(
                            cfg, mode="expand",
                            out_cap=_pow2(int(cfg.est * 1.3), lo=1024))
                        restart = True
                    elif cfg.mode == "expand" and tot > cfg.out_cap:
                        if tot > out_cap_max or cfg.blocked:
                            overflow = True      # split finer
                        else:
                            join_cfgs[ji] = d_replace(cfg,
                                                      out_cap=_pow2(tot))
                            restart = True
                if akb is None and int(got["ng"]) > gcap:
                    if gcap >= max_cap:
                        raise FragmentFallback("group cap overflow",
                                               reason="group-cap")
                    gcap = min(gcap * 4, max_cap)
                    restart = True
                if overflow or restart:
                    break
                ng = int(np.asarray(got["ng"]))
                got.update(ph.fetch({
                    "keys": [(v[:ng], m[:ng]) for v, m in out["keys"]],
                    "states": [tuple(a[:ng] for a in st)
                               for st in out["states"]]}))
                pass_outs.append(got)
            if restart:
                continue
            if overflow:
                K *= 2
                continue
            inp_dicts = {i: d for i, d in
                         enumerate(flows.get(id(root), []))}
            return self._merge_tree_agg_passes(root, pass_outs, inp_dicts)
        raise FragmentFallback("blocked expand: skew beyond 128 passes",
                               reason="blocked-expand")

    # ---- distributed (multi-rank) pipeline ---------------------------------
    @staticmethod
    def _staged_dist_chain(root) -> Optional[List[PhysicalPlan]]:
        """Root→scan chain when this dist fragment is eligible for the
        staged agg path: an agg root over an exchange-free
        Scan/Selection/Projection chain (a PhysExchange anywhere breaks
        _linearize), no DISTINCT aggs (per-rank dedup cannot merge
        without key co-location), every stage device-capable for the
        single-device chain program, and the chain's columns among the
        scan's encoded ones."""
        if not isinstance(root, PhysHashAgg):
            return None
        if any(d.distinct and d.args for d in root.aggs):
            return None
        chain = _linearize(root)
        if chain is None or not _fragment_ok(root, 0):
            return None
        scan = chain[-1]
        if scan.used_columns and \
                not set(_used_column_indices(chain)) <= \
                set(scan.used_columns):
            return None
        return chain

    def _run_dist_agg_staged(self, root, mesh, host_cols,
                             scan_meta) -> Optional[Chunk]:
        """Staged checkpointable dist agg (dist_fragment.StagedDistAgg):
        per-rank partials → host checkpoints → host merge. Returns None
        when the fragment is not eligible."""
        chain = self._staged_dist_chain(root)
        if chain is None or len(scan_meta) != 1:
            return None
        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import _pow2
        from tidb_tpu_torch.executor.dist_fragment import StagedDistAgg
        from tidb_tpu_torch.util.escalation import CapacityLadder
        scan, used_enc, total = scan_meta[0]
        used_cols = _used_column_indices(chain)
        nd = len(mesh)
        cap = _pow2((total + nd - 1) // nd, lo=8)
        # per-column compressed layouts, chosen GLOBALLY (one layout must
        # serve every rank's slab — the per-rank chain partials share one
        # program). Each rank packs its own slab independently, so no
        # cap/word-alignment constraint applies here; dictionaries would
        # need per-device replication, so allow_dict=False.
        from tidb_tpu_torch.chunk import compress as _compress
        comp_on = _var_bool(self.ctx.vars.get("tidb_tpu_compression", "on"))
        layouts = {}
        if comp_on:
            for i in used_cols:
                vals, valid, _d = host_cols[(id(scan), i)]
                if vals.ndim != 1:
                    continue
                lay, _dv = _compress.choose_layout(vals, valid,
                                                   allow_dict=False)
                if lay is not None and lay.width > 0:
                    layouts[i] = lay
        dicts = {i: host_cols[(id(scan), i)][2] for i in used_cols}
        # rank-level zone maps: the per-rank slice is this path's
        # dispatch unit, so stats are built per rank (slab_cap=cap) and
        # the scan's conjuncts evaluate exactly as on the slab path. A
        # pruned rank packs nothing, uploads nothing and runs nothing —
        # its checkpoint is the ng=0 merge identity.
        skip_ranks: frozenset = frozenset()
        if comp_on and getattr(scan, "filters", None):
            from tidb_tpu_torch.executor import zonemap
            zmaps = {}
            for i in used_cols:
                vals, valid, _d = host_cols[(id(scan), i)]
                if vals.ndim != 1:
                    continue
                kind = "code" if _d is not None else \
                    ("float" if vals.dtype.kind == "f" else "num")
                zmaps[i] = zonemap.column_stats(vals, valid, cap, total,
                                                kind=kind)
            shim = _RankZoneEnt(nd, zmaps, dicts)
            skip_ranks = zonemap.prune_slabs(shim, scan)
            if skip_ranks:
                zonemap.note_skipped(self.ctx.phases, len(skip_ranks))
                phys_b = logi_b = 0
                for i in used_cols:
                    vals, valid, _d = host_cols[(id(scan), i)]
                    lay = layouts.get(i)
                    if lay is not None:
                        phys_b += _compress.packed_slab_bytes(lay, cap)
                        logi_b += _compress.raw_slab_bytes(lay, cap)
                    else:
                        b = cap * vals.dtype.itemsize + cap
                        phys_b += b
                        logi_b += b
                zonemap.note_h2d_skipped(self.ctx.phases,
                                         phys_b * len(skip_ranks))
                self.ctx.phases.add_scan(
                    0, logical=logi_b * len(skip_ranks))
        # per-rank host slices — the checkpoint story's source of truth:
        # a retry or re-dispatch re-uploads ONLY its rank's slice
        # (pruned ranks hold None: never packed, never touched)
        rank_cols = []
        for r in range(nd):
            if r in skip_ranks:
                rank_cols.append(None)
                continue
            lo = r * cap
            cols = {}
            for i in used_cols:
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
        in_types = [scan.schema.field_types[i] for i in used_cols]
        vars_ = self.ctx.vars
        group_cap = int(vars_.get("tidb_tpu_group_cap",
                                  DEFAULT_GROUP_CAP))
        cap_limit = cap * nd
        gcap = _initial_group_cap(root, group_cap, cap_limit)
        ladder = CapacityLadder(guard=getattr(self.ctx, "guard", None),
                                stats=self.ctx.escalation)
        runner = StagedDistAgg(root, chain, mesh, rank_cols, rank_rows,
                               dicts, used_cols, in_types, cap, gcap,
                               cap_limit, self.ctx, ladder,
                               layouts=layouts or None,
                               skip_ranks=skip_ranks)
        pass_outs = runner.execute()
        flows, _root_dicts = TF.dictionary_flows(root, {id(scan): dicts})
        inp_dicts = {i: d for i, d in
                     enumerate(flows.get(id(root), []))}
        with self.ctx.phases.phase("decode"):
            return self._merge_tree_agg_passes(root, pass_outs, inp_dicts)

    def _run_dist_exchange_staged(self, root, mesh, host_cols,
                                  scan_meta) -> Optional[Chunk]:
        """Staged checkpointable dist exchange (dist_fragment.
        StagedDistExchange): per-rank partition programs (K23) →
        device→host bucket checkpoints + host routing → per-rank probe
        programs over the rewritten (exchange→leaf) plan. Returns None
        when the plan is ineligible."""
        from tidb_tpu_torch.executor.dist_fragment import (
            StagedDistExchange, staged_exchange_plan)
        from tidb_tpu_torch.util.escalation import CapacityLadder
        grafted = staged_exchange_plan(root)
        if grafted is None:
            return None
        new_root, grafts = grafted
        ladder = CapacityLadder(guard=getattr(self.ctx, "guard", None),
                                stats=self.ctx.escalation)
        runner = StagedDistExchange(root, new_root, grafts, mesh,
                                    host_cols, scan_meta, self.ctx,
                                    ladder)
        outs = runner.execute()
        if isinstance(new_root, PhysHashAgg):
            # the exchange re-keyed on the group keys, so each group's
            # rows landed wholly on ONE rank: the host merge never
            # combines two partials of one group (DISTINCT states stay
            # exact)
            inp_dicts = {i: d for i, d in
                         enumerate(runner.flows2.get(id(new_root), []))}
            with self.ctx.phases.phase("decode"):
                return self._merge_tree_agg_passes(new_root, outs,
                                                   inp_dicts)
        # row roots: each rank's live rows, concatenated in rank order
        dicts_root = {i: d for i, d in enumerate(runner.root_dicts2)}
        with self.ctx.phases.phase("decode"):
            return Chunk([_decode_col(
                ft, np.concatenate([o["cols"][ci][0] for o in outs]),
                np.concatenate([o["cols"][ci][1] for o in outs]),
                dicts_root.get(ci))
                for ci, ft in enumerate(new_root.schema.field_types)])

    def _run_device_dist(self) -> Chunk:
        # ORDER BY / TopN over the agg: the ranks compute the agg only —
        # the ordering stays a host concern after the rank merge
        order_root, root = _strip_order_root(self.plan.root)
        chunk = self._dist_exec(root)
        if order_root is not None:
            chunk = _host_order(chunk, order_root, root.schema)
            chunk = _topn_slice(chunk, order_root)
        return chunk

    def _dist_exec(self, root) -> Chunk:
        """The planner-fragmented tree over `plan.dist` ranks on the
        engine's device type (parallel.make_mesh): the host encodes every
        scan, unifies string join dictionaries, and one of the two staged
        paths or the monolithic program runs it (the MPPGather role of
        executor/mpp_gather.go:42 lives here)."""
        import types as pytypes

        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import (_collect_parts,
                                                          _encode_col,
                                                          _materialize_col)
        from tidb_tpu_torch.executor.dist_fragment import \
            unify_string_join_dicts
        from tidb_tpu_torch.parallel import make_mesh

        mesh = make_mesh(self.plan.dist, self.ctx.device)
        host_cols: Dict[Tuple[int, int], list] = {}
        scan_meta = []
        ph = self.ctx.phases
        for scan in TF._scans(root):
            used = scan.used_columns if scan.used_columns else \
                list(range(len(scan.schema)))
            parts, total = _collect_parts(self.ctx, scan)
            if total == 0:
                raise FragmentFallback("empty input", reason="empty-input")
            shim = pytypes.SimpleNamespace(parts=parts)
            ftypes = scan.schema.field_types
            with ph.phase("encode"):
                for i in used:
                    vals, valid = _materialize_col(shim, i)
                    vals, dictionary = _encode_col(ftypes[i], vals, valid)
                    host_cols[(id(scan), i)] = [vals, valid, dictionary]
            scan_meta.append((scan, used, total))
        # string equi-join keys: unify dictionaries BEFORE slicing so
        # equal strings hash equal on every rank
        unify_string_join_dicts(root, host_cols)
        # an exchange-free agg chain runs as per-rank single-device
        # partials with device→host checkpoints (StagedDistAgg);
        # exchange-carrying plans (distributed joins, DISTINCT re-keys,
        # windows) cut at the exchange instead (StagedDistExchange).
        # Either way a shard fault re-executes ONLY the failed rank.
        if _var_bool(self.ctx.vars.get("tidb_tpu_dist_staged", "on")):
            staged = self._run_dist_agg_staged(root, mesh, host_cols,
                                               scan_meta)
            if staged is not None:
                return staged
        if _var_bool(self.ctx.vars.get("tidb_tpu_dist_staged_exchange",
                                       "on")):
            staged = self._run_dist_exchange_staged(root, mesh, host_cols,
                                                    scan_meta)
            if staged is not None:
                return staged
        # plans neither staged path accepts (TopN/Sort roots, non-scan-
        # chain exchange children), and every plan with both staged flags
        # off: the monolithic program, whose fault retry is full-step
        return self._run_dist_monolithic(root, len(mesh), host_cols,
                                         scan_meta)

    def _run_dist_monolithic(self, root, nd: int, host_cols,
                             scan_meta) -> Chunk:
        """The JAX package's monolithic shard_map path
        (dist_fragment.DistTreeProgram): every rank on the engine's one
        device, each scan split into nd slabs of cap = pow2(ceil(total /
        nd)) rows, the collectives device-side copies between the ranks'
        buffers (K24, K25, K26). Capacity flags come back reduced over
        the ranks: a lost join bet or an expand overflow re-runs at the
        exact need, an exchange resizes only where it overflowed (to its
        exact need), a group overflow resizes the group cap. A shard
        fault retries the WHOLE step once, then raises one typed
        ShardFailure."""
        from dataclasses import replace as d_replace

        from tidb_tpu_torch.chunk import compress as _compress
        from tidb_tpu_torch.errors import ShardFailure
        from tidb_tpu_torch.executor import tree_fragment as TF
        from tidb_tpu_torch.executor.device_cache import (_col_bounds,
                                                          _pow2, _upload)
        from tidb_tpu_torch.planner.physical import PhysExchange
        from tidb_tpu_torch.util.escalation import CapacityLadder
        dev = torch.device(self.ctx.device)
        ph = self.ctx.phases
        comp_on = _var_bool(self.ctx.vars.get("tidb_tpu_compression", "on"))
        caps: Dict[int, Tuple[int, int]] = {}
        rank_inputs: List[List[dict]] = [[] for _ in range(nd)]
        rank_rows: List[List[int]] = [[] for _ in range(nd)]
        scan_dicts = {}
        scan_bounds: Dict[int, Dict[int, Tuple[int, int]]] = {}
        dist_layouts = []
        for scan, used, total in scan_meta:
            cap = _pow2((total + nd - 1) // nd, lo=8)
            caps[id(scan)] = (cap, 1)
            dicts = {}
            bounds: Dict[int, Tuple[int, int]] = {}
            lay_pairs = []
            cols = [{} for _ in range(nd)]
            for i in used:
                vals, valid, dictionary = host_cols[(id(scan), i)]
                dicts[i] = dictionary
                b = _col_bounds(vals, valid, dictionary)
                if b is not None:
                    bounds[i] = b
                # the JAX package packs one array for the whole mesh, so
                # word boundaries must coincide with rank boundaries (cap
                # a multiple of WORD_BITS); dictionaries would need
                # replication, a width-0 stub and a delta slab (one
                # global base) cannot split: the same rule here
                lay = None
                if comp_on and vals.ndim == 1 and \
                        cap % _compress.WORD_BITS == 0:
                    lay, _dv = _compress.choose_layout(vals, valid,
                                                       allow_dict=False)
                    if lay is not None and (lay.width == 0
                                            or lay.kind == "delta"):
                        lay = None
                with ph.phase("encode"):
                    pv = np.zeros(nd * cap, dtype=vals.dtype)
                    pv[:total] = vals
                    pm = np.zeros(nd * cap, dtype=bool)
                    pm[:total] = valid
                    slabs = [
                        _compress.pack_slab(lay, pv[r * cap:(r + 1) * cap],
                                            pm[r * cap:(r + 1) * cap])
                        if lay is not None else
                        (pv[r * cap:(r + 1) * cap], pm[r * cap:(r + 1) * cap])
                        for r in range(nd)]
                logical_b = pv.nbytes + pm.nbytes
                with ph.phase("upload"):
                    for r in range(nd):
                        cols[r][i] = [tuple(_upload(a, dev)
                                            for a in slabs[r])]
                phys_b = sum(a.nbytes for sl in slabs for a in sl)
                ph.add_h2d(phys_b, logical=logical_b)
                # the ranks stream these slabs from device memory too
                ph.add_scan(phys_b, logical=logical_b)
                if lay is not None:
                    lay_pairs.append((i, lay))
            dist_layouts.append(tuple(lay_pairs))
            rows = np.clip(total - np.arange(nd) * cap, 0, cap)
            for r in range(nd):
                rank_inputs[r].append(cols[r])
                rank_rows[r].append(int(rows[r]))
            scan_dicts[id(scan)] = dicts
            scan_bounds[id(scan)] = bounds
        rank_inputs = [tuple(x) for x in rank_inputs]
        rank_rows = [tuple(x) for x in rank_rows]
        layouts = tuple(dist_layouts) if any(dist_layouts) else None

        flows, root_dicts = TF.dictionary_flows(root, scan_dicts)
        flow_list = [flows.get(id(n), []) for n in TF._walk_nodes(root)]
        # initial bucket cap per hash exchange: 4× the balanced share
        # (tidb_tpu_exchange_bucket_cap overrides — skew/retry testing)
        cap_override = int(self.ctx.vars.get(
            "tidb_tpu_exchange_bucket_cap", 0) or 0)
        hash_exchanges = [n for n in TF._walk_nodes(root)
                          if isinstance(n, PhysExchange) and
                          n.kind == "hash"]
        bucket_caps = [cap_override or _pow2(
            4 * ((max(int(n.est_rows), 1) + nd - 1) // nd), lo=64)
            for n in hash_exchanges]
        vars_ = self.ctx.vars
        group_cap = int(vars_.get("tidb_tpu_group_cap", DEFAULT_GROUP_CAP))
        is_agg = isinstance(root, PhysHashAgg)
        max_cap = max(c for c, _n in caps.values())
        gcap = _initial_group_cap(root, group_cap, max_cap * nd) \
            if is_agg else 1

        def _shard_out_cap(cfg):
            # expand caps are PER RANK: the balanced share of the global
            # estimate; skew comes back as join_need → one retry
            return _pow2(int(cfg.est * 1.3 / nd) + 16, lo=1024)

        join_cfgs = TF.plan_join_configs(root, scan_bounds)
        join_cfgs = [d_replace(c, out_cap=_shard_out_cap(c))
                     if c.mode == "expand" else c for c in join_cfgs]
        out_cap_max = int(vars_.get("tidb_tpu_join_out_cap",
                                    TF.JOIN_OUT_CAP))
        ladder = CapacityLadder(guard=getattr(self.ctx, "guard", None),
                                stats=self.ctx.escalation)
        shard_faults = 0
        while True:
            # each re-run round is a checkpoint: a killed query must not
            # queue another multi-rank step
            self.ctx.check_killed("device-dispatch")
            prog = _get_dist_program(root, caps, gcap, nd, bucket_caps,
                                     dev, join_cfgs, layouts)
            prep_vals = prog.collect_preps(flow_list)
            out = None
            try:
                with self.ctx.device_slot():
                    with ph.phase("compute"):
                        out = prog(rank_inputs, rank_rows, prep_vals)
                ph.note_launch()
                with ph.phase("compute"):
                    _sync(dev)
                with ph.phase("fetch"):
                    flags = prog.read_flags(out)
                ph.add_d2h(8 * (2 * len(join_cfgs) + 1 +
                                len(hash_exchanges) + nd))
            except ShardFailure as e:
                # one rank's step failing heals by re-running the WHOLE
                # step: the collectives entangle every rank's state, and
                # the step is deterministic over host-resident inputs
                out = None
                shard_faults += 1
                if shard_faults > 1:
                    # the fault persisted through the retry: ONE typed
                    # error (the store and session stay usable)
                    raise ShardFailure(
                        "distributed fragment shard step failed twice: "
                        f"{e}") from e
                ladder.shard_retry(e)
                continue
            retry = False
            for ji, cfg in enumerate(join_cfgs):
                new_cfg, action = TF.escalate_join(
                    cfg, bool(flags["join_unique"][ji]),
                    int(flags["join_need"][ji]), out_cap_max,
                    flip_out_cap=_shard_out_cap(cfg), ladder=ladder)
                if action == "over-max":
                    ladder.fallback("join")
                    raise FragmentFallback(
                        f"join fan-out {int(flags['join_need'][ji])} "
                        f"exceeds the per-rank device cap",
                        reason="join-cap")
                if new_cfg is not None:
                    # a lost PK-FK bet re-runs in expand mode; an expand
                    # overflow resizes to the largest rank's true need
                    join_cfgs[ji] = new_cfg
                    retry = True
            for k, need in enumerate(flags["exchange_need"]):
                if int(need) > bucket_caps[k]:
                    from tidb_tpu_torch.util import failpoint
                    failpoint.inject("exchange-overflow")
                    # resize only the overflowed exchange, to its exact
                    # reported need
                    bucket_caps[k] = ladder.resize(
                        "exchange", bucket_caps[k], need=int(need), lo=64)
                    retry = True
            gneed = flags["group_need"]
            if gneed > gcap:
                if gcap >= max_cap * nd:
                    ladder.fallback("group")
                    raise FragmentFallback("group cap overflow",
                                           reason="group-cap")
                gcap = ladder.resize("group", gcap, need=gneed,
                                     max_cap=max_cap * nd)
                retry = True
            if not retry:
                break
            out = None
            ladder.attempt("dist")
        return self._dist_host_finish(root, out, flags["rank_n"], flows,
                                      root_dicts)

    def _dist_host_finish(self, root, out, rank_n, flows,
                          root_dicts) -> Chunk:
        """The MPPGather role over the ranks' outputs: an agg root
        decodes each rank's owned slots (a prefix of its slots); a
        TopN/Sort root takes each rank's n_out candidates and orders them
        on the host; a row root compacts each rank's live rows on the
        device (K22 at B = 1, then K18) — all in rank order."""
        ph = self.ctx.phases
        ranks = out["ranks"]
        dicts_root = {i: d for i, d in enumerate(root_dicts)}
        if isinstance(root, PhysHashAgg):
            got = ph.fetch([{"keys": [(v[..., :k], m[:k])
                                      for v, m in o["keys"]],
                             "states": [tuple(a[..., :k] for a in st)
                                        for st in o["states"]]}
                            for o, k in zip(ranks, (int(x)
                                                    for x in rank_n))])
            if root.group_exprs and not int(np.sum(rank_n)):
                from tidb_tpu_torch.executor import _empty_chunk
                return _empty_chunk(self.schema)
            inp = flows.get(id(root), [])
            cols: List[Column] = []
            with ph.phase("decode"):
                for kc, e in enumerate(root.group_exprs):
                    d = inp[e.index] if isinstance(e, ColumnRef) and \
                        e.index < len(inp) else None
                    cols.append(_decode_col(
                        self.schema[kc],
                        np.concatenate([g["keys"][kc][0] for g in got]),
                        np.concatenate([g["keys"][kc][1] for g in got]), d))
                for ai, agg in enumerate(build_agg(d) for d in root.aggs):
                    st = tuple(np.concatenate([g["states"][ai][c]
                                               for g in got], axis=-1)
                               for c in range(len(got[0]["states"][ai])))
                    v, m = agg.final(np, st)
                    cols.append(_decode_col(agg.ftype, np.asarray(v),
                                            np.asarray(m), None))
            return Chunk(cols)
        ftypes = root.schema.field_types
        if isinstance(root, (PhysTopN, PhysSort)):
            got = ph.fetch([[(v[..., :k], m[:k]) for v, m in o["cols"]]
                            for o, k in zip(ranks, (int(x)
                                                    for x in rank_n))])
        else:
            got = []
            for o in ranks:
                gathered, _offsets = compact_rows(o["cols"],
                                                  o["live"].view(1, -1))
                got.append(ph.fetch(gathered))
        with ph.phase("decode"):
            chunk = Chunk([_decode_col(
                ft, np.concatenate([g[ci][0] for g in got], axis=-1),
                np.concatenate([g[ci][1] for g in got]), dicts_root.get(ci))
                for ci, ft in enumerate(ftypes)])
        if isinstance(root, (PhysTopN, PhysSort)):
            chunk = _host_order(chunk, root, root.schema)
            chunk = _topn_slice(chunk, root)
        return chunk

    def _merge_tree_agg_passes(self, root: PhysHashAgg, pass_outs,
                               inp_dicts) -> Chunk:
        """Host-side cross-pass group merge: concatenate each pass's live
        (key, state) slots, re-group by key tuple, AggFunc.merge with
        xp=numpy (update=merge symmetry — the same segment op either
        way)."""
        aggs = [build_agg(d) for d in root.aggs]
        n_keys = len(root.group_exprs)
        if n_keys and getattr(root, "rollup", False):
            n_keys += 1     # device partials carry a grouping-level column
        key_parts: List[List] = [[] for _ in range(n_keys)]
        state_parts: List[List] = [[] for _ in aggs]
        for got in pass_outs:
            ng = int(np.asarray(got["ng"]))
            if ng == 0:
                continue
            for kc in range(n_keys):
                v, m = got["keys"][kc]
                key_parts[kc].append((np.asarray(v)[:ng],
                                      np.asarray(m)[:ng]))
            for ai, st in enumerate(got["states"]):
                state_parts[ai].append(
                    tuple(np.asarray(a)[:ng] for a in st))
        if n_keys and not key_parts[0]:
            from tidb_tpu_torch.executor import _empty_chunk
            return _empty_chunk(self.schema)
        key_cols = [(np.concatenate([v for v, _ in parts]),
                     np.concatenate([m for _, m in parts]))
                    for parts in key_parts]
        if n_keys:
            n_rows = key_cols[0][0].shape[0]
            # vectorized cross-pass group index (NULLs group together) —
            # the same sort-based factorize the CPU hash agg uses
            from tidb_tpu_torch.executor.hash_agg import factorize_columns
            gids, n_final, rep = factorize_columns(key_cols)
        else:
            # global agg: every pass contributes exactly one state row
            n_rows = sum(p[0].shape[0] for p in state_parts[0]) \
                if state_parts and state_parts[0] else 0
            gids = np.zeros(n_rows, dtype=np.int64)
            n_final = 1
        merged_states = []
        for agg, parts in zip(aggs, state_parts):
            if parts:
                partial = tuple(
                    np.concatenate([p[c] for p in parts], axis=0)
                    for c in range(len(parts[0])))
            else:
                partial = agg.init(np, 0)
            st = agg.init(np, n_final)
            merged_states.append(
                agg.merge(np, st, gids, n_final, partial))
        # representative key row per group (factorize's first occurrence)
        keys_out = []
        if n_keys:
            for kc in range(n_keys):
                v, m = key_cols[kc]
                keys_out.append((v[rep], m[rep]))
        out = {"keys": keys_out, "states": merged_states}
        return self._agg_chunk(root, out, inp_dicts, max(n_final, 1))


def _strip_exchanges(plan: PhysicalPlan) -> PhysicalPlan:
    """The plan without its Exchange nodes, for the CPU engine. Nodes
    above an exchange are copied: the cached plan keeps its exchanges."""
    import copy
    from tidb_tpu_torch.planner.physical import PhysExchange
    if isinstance(plan, PhysExchange):
        return _strip_exchanges(plan.children[0])
    kids = [_strip_exchanges(c) for c in plan.children]
    if all(k is c for k, c in zip(kids, plan.children)):
        return plan
    clone = copy.copy(plan)
    clone.children = kids
    return clone


class _RankZoneEnt:
    """Duck-typed zone-map carrier for staged-dist rank pruning: the
    per-rank slice plays the slab role, so zonemap.prune_slabs runs
    unchanged over rank-granular stats."""

    __slots__ = ("compressed", "n_slabs", "zmaps", "dicts")

    def __init__(self, nd: int, zmaps: dict, dicts: dict):
        self.compressed = True
        self.n_slabs = nd
        self.zmaps = zmaps
        self.dicts = dicts


class _GroupCapOverflow(Exception):
    """Factorize saw more groups than the program's cap. `need` carries
    the observed true count (0 = unknown) so the escalation ladder can
    resize to exact need instead of blind doubling."""

    def __init__(self, need: int = 0):
        super().__init__(f"group cap overflow (need {need})")
        self.need = int(need)


def _host_pairs(pairs_cache) -> dict:
    """{agg index: [per-slab pair columns]} from the per-slab host cache
    of a multi-slab DISTINCT run ({} when no aggregate emitted pairs)."""
    if not pairs_cache or not pairs_cache[0]:
        return {}
    return {ai: [ps[ai] for ps in pairs_cache] for ai in pairs_cache[0]}


def _host_run_bounds(cols) -> Tuple[np.ndarray, np.ndarray]:
    """Lexsort rows of [(values, valid), ...] → (order, first_of_run mask
    over the sorted order). NULL slots canonicalize so all NULLs in a
    column compare equal (the host mirror of ops/factorize.py)."""
    arrays: List[np.ndarray] = []
    for v, m in cols:
        v = np.asarray(v)
        m = np.asarray(m)
        arrays.append(np.where(m, v, np.zeros((), dtype=v.dtype)))
        arrays.append(m)
    n = len(arrays[0]) if arrays else 0
    order = np.lexsort(arrays[::-1]) if arrays else np.arange(0)
    first = np.zeros(n, dtype=bool)
    if n:
        first[0] = True
        for a in arrays:
            sa = a[order]
            first[1:] |= sa[1:] != sa[:-1]
    return order, first


def _host_group_index(final_cols, query_cols) -> np.ndarray:
    """Map each query row's key tuple to its row index in final_cols
    (−1 when absent). Vectorized via one shared lexsort — no Python dict,
    so cross-slab DISTINCT merges scale to millions of pairs."""
    nf = len(final_cols[0][0]) if final_cols else 0
    nq = len(query_cols[0][0]) if query_cols else 0
    if not final_cols:
        return np.zeros(nq, dtype=np.int64)
    both = [(np.concatenate([np.asarray(fv), np.asarray(qv)]),
             np.concatenate([np.asarray(fm), np.asarray(qm)]))
            for (fv, fm), (qv, qm) in zip(final_cols, query_cols)]
    order, first = _host_run_bounds(both)
    gid_sorted = np.cumsum(first) - 1
    gid = np.empty(nf + nq, dtype=np.int64)
    gid[order] = gid_sorted
    slot_of = np.full(int(gid_sorted[-1]) + 1 if len(gid_sorted) else 1,
                      -1, dtype=np.int64)
    slot_of[gid[:nf]] = np.arange(nf)
    return slot_of[gid[nf:]]


def _merge_distinct_states(root, host_keys, distinct_pairs, n_final):
    """Cross-slab DISTINCT merge: concatenate per-slab pair sets, dedup
    globally (lexsort runs), map pairs onto the final merged groups, and
    recompute each distinct aggregate's state with the numpy side of the
    xp-generic agg framework (the distinct-partials split of
    aggfuncs/func_sum.go:49-59). A pair with a NULL argument never
    counts. → {agg_index: state_tuple}."""
    nk = len(root.group_exprs)
    out = {}
    for ai, slabs in distinct_pairs.items():
        na = max(1, len(root.aggs[ai].args))
        cols = []
        for c in range(nk + na):
            v = np.concatenate([np.asarray(s[c][0]) for s in slabs])
            m = np.concatenate([np.asarray(s[c][1]) for s in slabs])
            cols.append((v, m))
        order, first = _host_run_bounds(cols)
        uniq = np.zeros(len(order), dtype=bool)
        uniq[order] = first
        vv = cols[nk][0]
        vm = np.ones(len(order), dtype=bool)
        for _av, am in cols[nk:]:
            vm = vm & np.asarray(am)     # any NULL arg → row never counts
        keep = uniq & vm
        if nk:
            gidx = _host_group_index(
                host_keys, [(np.asarray(v)[keep], np.asarray(m)[keep])
                            for v, m in cols[:nk]])
            ok = gidx >= 0   # every pair's group exists in the final set
            gids = np.where(ok, gidx, 0).astype(np.int32)
        else:
            ok = np.ones(int(keep.sum()), dtype=bool)
            gids = np.zeros(int(keep.sum()), dtype=np.int32)
        agg = build_agg(root.aggs[ai])
        st = agg.init(np, n_final)
        out[ai] = agg.update(np, st, gids, n_final,
                             np.asarray(vv)[keep],
                             np.asarray(vm)[keep] & ok)
    return out


# PhaseTimer of the most recent device fragment run (encode/upload/compute/
# fetch/decode seconds + byte ledger), for tests and smoke runs.
LAST_PHASES = None


def _expr_dict(e: Expression, dicts) -> Optional[np.ndarray]:
    if isinstance(e, ColumnRef):
        return dicts.get(e.index)
    return None


def _positional_dict(node: PhysicalPlan, out_idx: int, dicts
                     ) -> Optional[np.ndarray]:
    """Dictionary for output column `out_idx` of a non-agg root: identity
    through Selection/TopN/Sort and a window's child columns; via
    ColumnRef for Projection outputs; none for a window's own columns."""
    cur = node
    idx = out_idx
    while True:
        if isinstance(cur, PhysTableScan):
            return dicts.get(idx)
        if isinstance(cur, PhysWindow) and \
                idx >= len(cur.children[0].schema):
            return None
        if isinstance(cur, PhysProjection):
            e = cur.exprs[idx]
            if isinstance(e, ColumnRef):
                idx = e.index
            else:
                return None
        cur = cur.children[0] if cur.children else None
        if cur is None:
            return None


def _compact_decode(ph, cols_vm, live, ftypes, dicts_root) -> Chunk:
    """Compact padded (values, validity) device columns by a live mask ON
    THE DEVICE (K22 + K18, `compact_rows`), fetch only the surviving rows,
    and decode them into a host Chunk (the row-root result path of the
    join-tree programs)."""
    gathered, _offsets = compact_rows(cols_vm, live.reshape(1, -1))
    host = ph.fetch(gathered)
    with ph.phase("decode"):
        return Chunk([_decode_col(ft, np.asarray(v), np.asarray(m),
                                  dicts_root.get(ci))
                      for ci, ((v, m), ft) in enumerate(zip(host, ftypes))])


def compact_rows(cols, live):
    """The live rows of every output column, member-major: K22 turns the
    [B, cap] mask into row ids and K18 gathers every (value, mask)
    column through them in one launch. → (gathered columns, offsets
    [B+1] int64): member k's rows are slots offsets[k]:offsets[k+1]."""
    from tidb_tpu_torch.ops.compact import member_compact
    from tidb_tpu_torch.ops.gather import gather_columns
    _counts, offsets, ids = member_compact(live.contiguous())
    n_valid = offsets[-1:].to(torch.int32).reshape(())
    gathered = gather_columns([(v.contiguous(), m.contiguous())
                               for v, m in cols], ids, n_valid)
    return gathered, offsets


def _topn_slice(chunk: Chunk, root) -> Chunk:
    if isinstance(root, (PhysTopN, PhysLimit)):
        lo = min(root.offset, chunk.num_rows)
        hi = min(root.offset + root.count, chunk.num_rows)
        return chunk.slice(lo, hi)
    return chunk


def _decode_col(ft: FieldType, vals: np.ndarray, mask: np.ndarray,
                dictionary: Optional[np.ndarray]) -> Column:
    if ft.is_varlen:
        if dictionary is None:
            if not np.asarray(mask, dtype=bool).any():
                # unused placeholder column: all-NULL is fine
                return Column.all_null(ft, len(vals))
            raise FragmentFallback("string column without dictionary", reason="string-dict")
        neg = vals < 0
        if neg.any():
            mask = mask & ~neg
        if len(dictionary):
            decoded = dictionary[np.clip(vals, 0, len(dictionary) - 1)]
            decoded = np.asarray(decoded, dtype=object)
        else:
            decoded = np.full(len(vals), "", dtype=object)
        vals = decoded
    elif vals.dtype != ft.np_dtype:
        vals = vals.astype(ft.np_dtype)
    mask = np.asarray(mask, dtype=bool)
    return Column(ft, vals, None if mask.all() else mask.copy())


def _host_order(chunk: Chunk, root, schema) -> Chunk:
    """k-way candidate merge for multi-slab TopN: re-sort the (small)
    concatenated candidates on host with MySQL NULL ordering (NULLs first
    ASC, last DESC)."""
    from tidb_tpu_torch.expression.runner import eval_on_chunk
    lex_keys: List[np.ndarray] = []   # np.lexsort: LAST key is primary
    for e, desc in zip(root.by, root.descs):
        if isinstance(e, ColumnRef):
            col = chunk.columns[e.index]
        else:
            col = eval_on_chunk([e], chunk).columns[0]
        vals = col.values
        valid = col.valid_mask()
        if not valid.all():
            # neutralize masked-out garbage so ordering among NULL-key rows
            # falls through to the next ORDER BY key (matches CPU engine)
            fill = "" if vals.dtype == object else np.zeros(1, vals.dtype)[0]
            vals = np.where(valid, vals, fill)
        if vals.dtype == object:
            ranks = {v: i for i, v in
                     enumerate(sorted({str(x) for x in vals}))}
            vals = np.array([ranks[str(v)] for v in vals], dtype=np.int64)
        if desc:
            val_key = -vals.astype(np.float64) if vals.dtype.kind == "f" \
                else ~vals.astype(np.int64)
            null_key = ~valid            # NULLs last
        else:
            val_key = vals
            null_key = valid             # NULLs first (False < True)
        # primary-first ORDER BY list → reversed for lexsort; within one
        # column the null flag outranks the value
        lex_keys = [val_key, null_key] + lex_keys
    order = np.lexsort(lex_keys) if lex_keys else np.arange(chunk.num_rows)
    return chunk.take(order)

"""Session / statement lifecycle (ref: /root/reference/session/session.go).

`Engine` is the per-process singleton owning catalog + storage (the
domain.Domain analog, domain/domain.go:69-99); `Session` is one connection's
state: variables, the active transaction, and `execute(sql)` — the
ExecuteStmt path (session/session.go:1614): parse → plan → build executor →
drain → ResultSet. DML runs through the same planner for its WHERE clauses
and scans through the transaction's UnionScan merge view (staged writes
visible to the writing session, invisible to others until commit).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch import types as T
from tidb_tpu_torch.catalog import Catalog, ColumnInfo, IndexInfo, TableInfo
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.errors import (DDLError, ExecutionError, PlanError,
                             SchemaChangedError, TiDBTPUError, TxnError,
                             UnknownColumnError, UnknownTableError)
from tidb_tpu_torch.executor import ExecContext, build, run_to_completion
from tidb_tpu_torch.expression import Expression
from tidb_tpu_torch.expression.runner import eval_on_chunk, filter_mask
from tidb_tpu_torch.parser import ast, parse
from tidb_tpu_torch.planner import optimize
from tidb_tpu_torch.planner.builder import ExpressionRewriter, SubqueryEvaluator
from tidb_tpu_torch.planner.logical import Schema
from tidb_tpu_torch.storage import Store, Transaction
from tidb_tpu_torch.types import FieldType

DEFAULT_VARS: Dict[str, object] = {
    # ref: sessionctx/variable/tidb_vars.go — the knobs our engine honors
    "max_chunk_size": 65536,
    "tidb_tpu_engine": "auto",        # on | off | auto (auto: on when TPU)
    "tidb_tpu_row_threshold": 32768,  # min est. rows to route to device
    # staged (checkpointable, per-shard recoverable) distributed agg;
    # off = always the monolithic shard_map program
    "tidb_tpu_dist_staged": "on",
    # staged exchange-carrying fragments (distributed joins, DISTINCT
    # re-keys, windows): partition → device→host bucket checkpoint →
    # per-rank probe, each stage re-dispatchable per rank; off = the
    # monolithic in-trace all_to_all program (the byte-exactness oracle)
    "tidb_tpu_dist_staged_exchange": "on",
    # compressed device-resident columns (bit-pack / frame-of-reference /
    # dictionary) with decode fused into the scan; off = raw layouts
    "tidb_tpu_compression": "on",
    "tidb_mem_quota_query": 8 << 30,
    "sql_mode": "STRICT_TRANS_TABLES",
    "autocommit": 1,
    # statement deadline in ms, 0 = none. Deviation from MySQL (which
    # scopes it to read-only SELECT): applies to EVERY statement — the
    # never-hang guarantee matters more here than MySQL fidelity
    "max_execution_time": 0,
    # when non-empty, every session appends scheduler/compile/stream/
    # eviction events into ONE Chrome-trace JSON under this directory
    # (util/timeline.py) — load it in chrome://tracing or Perfetto
    "tidb_tpu_trace_dir": "",
    # priority-aware serving tier (executor/scheduler.py): classify each
    # admission as interactive/batch and grant the device slot by class;
    # off = the plain FIFO admission order, byte-identical to classless
    "tidb_tpu_priority_scheduling": "on",
    # same-plan micro-batching (executor/microbatch.py): coalesce up to
    # this many queued same-digest statements into ONE batched device
    # program. 1 = parametrize only (shared programs, no coalescing),
    # 0 = literal-baked programs (the pre-serving-tier behavior)
    "tidb_tpu_microbatch_max": 16,
    # one admission queue per visible device with locality-aware
    # placement and work stealing (SchedulerPool): auto = on when more
    # than one device is visible (single-device hosts size the pool to
    # 1, byte-identical to the shared device-0 queue); off = every
    # statement shares the device-0 queue (the PR 15 serving tier)
    "tidb_tpu_device_queues": "auto",
    # tables with at least this many rows partition their slab ranges
    # across the pool (one contiguous span per owner device) instead of
    # replicating a full copy per device (executor/device_cache.py)
    "tidb_tpu_partition_min_rows": 1 << 22,
    # coalesced single-row ingest (session/writebatch.py): N queued
    # same-digest autocommit writes share ONE commit — readers pay one
    # delta extension instead of N; off = every write commits alone
    "tidb_tpu_write_coalesce": "on",
    # async compaction of delta-extended cache entries (executor/
    # delta.py): rebuild base slabs with re-chosen layouts in idle
    # batch-class slots; off = deltas accumulate until a test/bench
    # drains them via delta.run_pending_compactions()
    "tidb_tpu_compaction": "on",
    # delta rows (appends + tombstones) a cached table tolerates before
    # a compaction job is scheduled
    "tidb_tpu_delta_compact_rows": 1024,
}


class ResultSet:
    """Query result. `rows` (python tuples) materialize lazily from the
    columnar `chunks` payload, so sinks that consume chunks directly (the
    wire server's native text encoder) never pay the per-row decode."""

    def __init__(self, names: List[str], ftypes: List[FieldType],
                 rows: Optional[List[tuple]] = None,
                 affected_rows: int = 0, is_query: bool = True,
                 chunks: Optional[List[Chunk]] = None):
        self.names = names
        self.ftypes = ftypes
        self._rows = rows
        self.affected_rows = affected_rows
        self.is_query = is_query
        self.chunks = chunks

    @property
    def rows(self) -> List[tuple]:
        if self._rows is None:
            self._rows = [r for ch in (self.chunks or [])
                          for r in ch.rows()]
        return self._rows

    @property
    def row_count(self) -> int:
        if self.chunks is not None:
            return sum(ch.num_rows for ch in self.chunks)
        return len(self._rows or ())

    def scalar(self):
        return self.rows[0][0] if self.rows else None


def ok(affected: int = 0) -> ResultSet:
    return ResultSet([], [], [], affected_rows=affected, is_query=False)


class _PrepareProbeSkip(Exception):
    """Internal: planning under plan_for_prepare reached a point that
    would EXECUTE a subquery — prepare-time metadata is not worth
    running user reads, so the probe bails out instead."""


def _table_schema_sig(info) -> tuple:
    """Shape signature of a table for the commit-time schema-lease check:
    column layout, index set (incl. uniqueness and DDL state — an index
    going write_only→public mid-transaction IS a relevant change) and
    primary key. Row counts / statistics deliberately excluded."""
    return (tuple((c.name.lower(), str(c.ftype)) for c in info.columns),
            tuple(sorted((ix.name.lower(), tuple(ix.columns), ix.unique,
                          ix.state) for ix in info.indexes)),
            tuple(info.primary_key))


def _plan_tables(plan) -> List[str]:
    """Base-table names a logical plan scans (privilege gate for plans
    built outside the AST path)."""
    from tidb_tpu_torch.planner.logical import LogicalDataSource
    out = []
    def rec(n):
        if isinstance(n, LogicalDataSource):
            out.append(n.table.name.lower())
        for c in n.children:
            rec(c)
    rec(plan)
    return out


def _stmt_tables(stmt) -> List[str]:
    """Base-table names a statement touches (for the privilege gate).
    Subqueries in expressions are covered by their own nested execution."""
    names: List[str] = []

    def from_ref(ref):
        if isinstance(ref, ast.TableName):
            if (ref.db or "").lower() == "information_schema":
                return          # world-readable virtual tables
            names.append(ref.name.lower())
        elif isinstance(ref, ast.JoinExpr):
            from_ref(ref.left)
            from_ref(ref.right)
        elif isinstance(ref, ast.SubqueryTable):
            sel(ref.select)

    def sel(s):
        if isinstance(s, ast.SetOpStmt):
            sel(s.left)
            sel(s.right)
            return
        if getattr(s, "from_", None) is not None:
            from_ref(s.from_)

    if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
        sel(stmt)
    elif isinstance(stmt, ast.WithStmt):
        cte_names = {c.name.lower() for c in stmt.ctes}
        for c in stmt.ctes:
            sel(c.select)
        inner = _stmt_tables(stmt.stmt)
        names.extend(t for t in inner if t not in cte_names)
    elif isinstance(stmt, ast.Insert):
        names.append(stmt.table.lower())
    elif isinstance(stmt, (ast.Update, ast.Delete)):
        names.append(stmt.table.name.lower())
    elif isinstance(stmt, (ast.CreateTable, ast.TruncateTable)):
        names.append(stmt.name.lower())
    elif isinstance(stmt, ast.LoadData):
        names.append(stmt.table.lower())
    elif isinstance(stmt, ast.DropTable):
        names.extend(n.lower() for n in stmt.names)
    elif isinstance(stmt, (ast.AlterTable, ast.CreateIndex, ast.DropIndex)):
        names.append(stmt.table.lower())
    return names


def _stmt_as_of(stmt):
    """The AS OF expression of a statement's table refs (one allowed)."""
    found = []

    def ref(r):
        if isinstance(r, ast.TableName):
            if r.as_of is not None:
                found.append(r.as_of)
        elif isinstance(r, ast.JoinExpr):
            ref(r.left)
            ref(r.right)
        elif isinstance(r, ast.SubqueryTable):
            sel(r.select)

    def sel(s):
        if isinstance(s, ast.SetOpStmt):
            sel(s.left)
            sel(s.right)
        elif getattr(s, "from_", None) is not None:
            ref(s.from_)

    sel(stmt)
    if len(found) > 1:
        raise PlanError(
            "only one AS OF TIMESTAMP is supported per statement")
    return found[0] if found else None


def _stmt_is_read_only_select(s) -> bool:
    """MySQL's max_execution_time scope (sql/sql_parse.cc
    set_statement_timer): only read-only SELECT statements get a timer.
    SELECT ... FOR UPDATE takes locks, and DML/DDL mutate — aborting those
    mid-flight on a deadline would leave half-applied work, so they run to
    completion or an explicit KILL."""
    if isinstance(s, ast.SelectStmt):
        return not s.for_update
    if isinstance(s, ast.SetOpStmt):
        return _stmt_is_read_only_select(s.left) and \
            _stmt_is_read_only_select(s.right)
    if isinstance(s, ast.WithStmt):
        return _stmt_is_read_only_select(s.stmt)
    return False


# aggregate function names whose presence makes a SELECT a "batch"
# admission (it reduces a scan, it doesn't look up a handful of rows)
_AGG_NAMES = frozenset({
    "count", "sum", "avg", "min", "max", "group_concat", "bit_and",
    "bit_or", "bit_xor", "std", "stddev", "stddev_pop", "stddev_samp",
    "var_pop", "var_samp", "variance", "approx_count_distinct"})

# statement kinds answered from catalogs/registries, never the device —
# always interactive, their admission must not sit behind a scan
_META_STMTS = (ast.ShowStmt, ast.Explain, ast.SetStmt, ast.UseStmt,
               ast.BeginStmt, ast.CommitStmt, ast.RollbackStmt,
               ast.KillStmt, ast.TraceStmt)


def _expr_has_agg(node) -> bool:
    """Any aggregate FuncCall (or windowed aggregate) under `node`?
    Generic dataclass walk — the AST has no visitor, and admission
    classification must not require one per node kind."""
    import dataclasses as _dc
    if isinstance(node, ast.FuncCall) \
            and node.name.lower() in _AGG_NAMES:
        return True
    if isinstance(node, ast.Node) and _dc.is_dataclass(node):
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, ast.Node):
                if _expr_has_agg(v):
                    return True
            elif isinstance(v, (list, tuple)):
                for item in v:
                    it = item[0] if isinstance(item, tuple) and item \
                        else item
                    if isinstance(it, ast.Node) and _expr_has_agg(it):
                        return True
    return False


def _classify_admission(s, sql: str, from_prepared: bool):
    """Admission class for the device scheduler's priority queues —
    → (class, cost_hint):

      interactive — metadata/control statements, prepared
                    COM_STMT_EXECUTE, and point-shaped reads (single
                    table, no aggregate/GROUP BY/DISTINCT, a WHERE or
                    LIMIT bounding the result);
      batch       — scans, joins and aggregations, with the digest's
                    historical average device seconds as the cost hint
                    (executor/scheduler.py CHEAP_BATCH_S splits cheap
                    from heavy batch);
      None        — everything else (DML/DDL), which keeps plain FIFO
                    admission semantics.
    """
    from tidb_tpu_torch.util.observability import REGISTRY
    if isinstance(s, _META_STMTS):
        return "interactive", None
    if from_prepared:
        return "interactive", None
    if isinstance(s, (ast.WithStmt, ast.SetOpStmt)):
        return "batch", REGISTRY.digest_cost(sql)
    if not isinstance(s, ast.SelectStmt):
        return None, None
    point_shaped = (
        (s.from_ is None or isinstance(s.from_, ast.TableName))
        and not s.group_by and s.having is None and not s.distinct
        and (s.where is not None or s.limit is not None
             or s.from_ is None)
        and not any(_expr_has_agg(it.expr) for it in s.items))
    if point_shaped:
        return "interactive", None
    return "batch", REGISTRY.digest_cost(sql)


def _operator_spans(tr, exec_root) -> None:
    """Per-operator runtime stats rendered as a NESTED span tree (the
    executor Next-wrapper spans of executor.go:278); durations come from
    accumulated wall time, carried as a tag."""
    name = type(exec_root).__name__
    info = ""
    fn = getattr(exec_root, "runtime_info", None)
    if fn is not None:
        info = fn() or ""
    tags = {"rows": exec_root.stats.rows,
            "wall_ms": round(exec_root.stats.wall_ns / 1e6, 3)}
    if info:
        tags["info"] = info
    with tr.span(f"op.{name}", **tags):
        for c in getattr(exec_root, "children", []):
            _operator_spans(tr, c)


class Engine:
    """Process-wide catalog + storage owner (the Domain analog)."""

    def __init__(self, device="cuda"):
        from tidb_tpu_torch.ops.torch_env import resolve_device
        from tidb_tpu_torch.session.auth import AuthManager
        # the ONE torch device every device fragment of this engine runs
        # on; "cuda" (the default) raises here when no GPU is visible —
        # the CPU is only ever a device the caller names
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.store = Store()
        self.stats_lock = threading.Lock()
        # table_id → statistics.TableStats (histograms/NDV/TopN; ref:
        # statistics/handle — the Domain-owned stats cache)
        self.table_stats: Dict[int, object] = {}
        # users/passwords/grants (privilege/privileges cache.go analog)
        self.auth = AuthManager()
        # bumped by ANALYZE: plan-cache entries keyed on it go stale
        self.stats_version = 0
        # table_id → rows modified since its last ANALYZE — feeds the
        # auto-analyze trigger (statistics/handle/update.go modifyCount)
        self.modify_counts: Dict[int, int] = {}
        # (table_id, col_offset) → next AUTO_INCREMENT value
        self._auto_ids: Dict[Tuple[int, int], int] = {}
        # SET GLOBAL scope, inherited by new sessions (sysvar.go analog)
        self.global_vars: Dict[str, object] = {}
        # background auto-analyze worker state (_kick_analyze)
        self._analyze_event = threading.Event()
        self._analyze_thread = None
        self._analyze_stop = False
        self._bg_session = None

    def assign_auto_ids(self, table_id: int, col_offset: int,
                        vals: np.ndarray, valid: np.ndarray,
                        seed) -> Optional[int]:
        """Row-ordered AUTO_INCREMENT assignment (the meta/autoid
        allocator, lock-protected): NULL slots take the counter in row
        order, and an explicit value ≥ the counter pushes it forward
        MID-STATEMENT — (NULL, 100, NULL) yields (n, 100, 101) exactly
        like MySQL. Lazily seeded from `seed` (MAX(col)) so restored or
        imported tables keep counting past their data. Returns the first
        generated id (for LAST_INSERT_ID), or None if none."""
        with self.stats_lock:
            key = (table_id, col_offset)
            nxt = self._auto_ids.get(key)
            if nxt is None:
                nxt = int(seed or 0) + 1
            first = None
            for i in range(len(vals)):
                # explicit 0 allocates too (MySQL default, i.e.
                # NO_AUTO_VALUE_ON_ZERO off)
                if valid[i] and int(vals[i]) != 0:
                    if int(vals[i]) >= nxt:
                        nxt = int(vals[i]) + 1
                else:
                    vals[i] = nxt
                    if first is None:
                        first = nxt
                    nxt += 1
            self._auto_ids[key] = nxt
            return first

    def note_modified(self, table_id: int, n: int) -> None:
        if n <= 0:
            return
        with self.stats_lock:
            self.modify_counts[table_id] = \
                self.modify_counts.get(table_id, 0) + int(n)
        self._kick_analyze()

    # ---- background auto-analyze (ref: statistics/handle/update.go:939
    # HandleAutoAnalyze on the domain's loop, domain/domain.go:1249) ------
    ANALYZE_LEASE_S = 0.25        # worker poll lease (3s in the reference)

    def _kick_analyze(self) -> None:
        """Wake the background analyzer — the ONLY cost a write statement
        pays (an Event.set); the analyze itself runs off-path."""
        if self._analyze_thread is None:
            with self.stats_lock:
                if self._analyze_thread is None:
                    import weakref
                    t = threading.Thread(
                        target=_analyze_worker_loop,
                        args=(weakref.ref(self), self._analyze_event),
                        name="auto-analyze", daemon=True)
                    self._analyze_thread = t
                    t.start()
        self._analyze_event.set()

    def close(self) -> None:
        """Stop the background analyzer and WAIT for an in-flight pass —
        close() is a barrier (GC also ends the worker via its weakref)."""
        self._analyze_stop = True
        self._analyze_event.set()
        t = self._analyze_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    def _auto_analyze_pass(self) -> None:
        """One trigger sweep: any table whose modified-row count since
        its last ANALYZE exceeds tidb_auto_analyze_ratio x analyzed rows
        (or that accumulated tidb_auto_analyze_min_rows with no stats)
        re-analyzes on THIS thread. Config reads GLOBAL scope — the
        analyzer serves every session."""
        from tidb_tpu_torch.executor.fragment import _var_bool
        from tidb_tpu_torch.parser import ast as _ast
        gv = self.global_vars
        if not _var_bool(gv.get("tidb_enable_auto_analyze", True)):
            return
        ratio = float(gv.get("tidb_auto_analyze_ratio", 0.5))
        min_rows = int(gv.get("tidb_auto_analyze_min_rows", 1000))
        with self.stats_lock:
            pending = dict(self.modify_counts)
        if not pending:
            return
        names = []
        for tid, mod in pending.items():
            if mod < min_rows:
                continue
            stats = self.table_stats.get(tid)
            if stats is not None and mod <= ratio * max(stats.row_count,
                                                        1):
                continue
            info = self.catalog.info_schema.table_by_id(tid)
            if info is not None:
                names.append(info.name)
        if names:
            if self._bg_session is None:
                self._bg_session = self.new_session()
            self._bg_session._analyze(_ast.AnalyzeTable(names))

    def new_session(self) -> "Session":
        return Session(self)


def _analyze_worker_loop(engine_ref, event) -> None:
    """Auto-analyze daemon body: holds the Engine only through a weakref,
    so a dropped Engine is collectable and ends this thread; wakes on the
    event (a write committed) or the lease timeout."""
    import logging
    log_ = logging.getLogger("tidb_tpu_torch.autoanalyze")
    while True:
        event.wait(timeout=Engine.ANALYZE_LEASE_S)
        event.clear()
        eng = engine_ref()
        if eng is None or eng._analyze_stop:
            return
        try:
            eng._auto_analyze_pass()
        except Exception:  # noqa: BLE001 — the loop must survive
            log_.warning("auto-analyze pass failed", exc_info=True)
        del eng            # don't pin the engine across the wait


class _PlanContext:
    """What the planner needs from the session (estimates + engine gate)."""

    def __init__(self, session: "Session"):
        self.session = session
        self.subquery_evaluator = session._subquery_evaluator()
        self.cte_map = dict(getattr(session, "_cte_map", {}) or {})
        self.tracer = session._tracer     # optimizer-trace sink

    def table_row_count(self, table_id: int) -> int:
        # exact live rows from the columnar store — cheap and fresher than
        # any analyzed count (the reference must estimate; we needn't)
        snap = self.session._read_view_snapshot()
        if snap.has_table(table_id):
            return snap.table_data(table_id).live_rows
        return 1

    def table_stats(self, table_id: int):
        eng = self.session.engine
        with eng.stats_lock:
            return eng.table_stats.get(table_id)

    @property
    def use_tpu(self) -> bool:
        mode = str(self.session.vars.get("tidb_tpu_engine", "auto"))
        if mode == "off":
            return False
        # "on" and "auto" both run eligible fragments on the engine's
        # device (Engine(device=...) — the GPU unless the caller named
        # the CPU)
        return True

    @property
    def tpu_row_threshold(self) -> int:
        return int(self.session.vars.get("tidb_tpu_row_threshold", 32768))

    @property
    def dist_devices(self) -> int:
        """Ranks for distributed fragments: tidb_tpu_dist_devices=N pins
        N ranks (sharing the engine's devices round-robin: on one GPU
        every rank runs on it); 'auto' uses every visible device of the
        engine's type — 1 on one card or on the CPU, which means no
        distribution (>1 ⇒ MPP-style distribution; the tidb_allow_mpp
        analog)."""
        v = self.session.vars.get("tidb_tpu_dist_devices", 0)
        if str(v) == "auto":
            if self.session.engine.device.type == "cuda":
                import torch
                return torch.cuda.device_count()
            return 1
        try:
            return int(v)
        except (TypeError, ValueError):
            return 0


class Session:
    _next_conn_id = itertools.count(1)

    def __init__(self, engine: Optional[Engine] = None):
        self.engine = engine or Engine()
        self.vars: Dict[str, object] = dict(DEFAULT_VARS)
        self.vars.update(self.engine.global_vars)
        self.txn: Optional[Transaction] = None
        self.last_plan = None
        self.conn_id = next(Session._next_conn_id)
        self.last_engine = "cpu"   # cpu | tpu — set by the fragment path
        self._cte_map: Dict[str, str] = {}
        self.user = "root"         # set by the wire server after auth
        # SQL plan cache (ref: planner/core/cache.go): physical plans of
        # repeated SELECT texts, keyed on schema/stats versions + the
        # planning-relevant session vars; plans whose build ran an eager
        # subquery bake data into constants and are never cached
        self._plan_cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._subq_execs = 0
        self._current_sql: Optional[str] = None
        self._prepare_probe = False  # COM_STMT_PREPARE metadata planning
        self._tracer = None        # set while a TRACE statement runs
        self._stmt_snapshot = None  # pinned read view (AS OF TIMESTAMP)
        self._for_update_snapshot = None
        self.last_insert_id = 0     # LAST_INSERT_ID() (session.go)
        # lifecycle guardrails: the per-statement ExecutionGuard (kill
        # flag + deadline + root tracker) published to PROCESS_REGISTRY
        # so KILL from any other session can find it
        self._guard = None
        self.last_guard = None     # kept after the stmt for introspection
        # (Level, Code, Message) rows of the last completed statement —
        # SHOW WARNINGS reads these; e.g. a degraded-mesh completion
        self.warnings: List[tuple] = []
        from tidb_tpu_torch.util.guard import PROCESS_REGISTRY
        PROCESS_REGISTRY.register(self)

    # ---- public API --------------------------------------------------------
    def execute(self, sql: str,
                from_prepared: bool = False) -> List[ResultSet]:
        """Parse + run every statement, recording per-statement metrics,
        slow-log entries and the processlist (ref: session.ExecuteStmt's
        observability hooks, session/session.go:1614). `from_prepared`
        marks a COM_STMT_EXECUTE dispatch (server/__init__.py) — those
        admissions classify as interactive regardless of shape."""
        import time as _time

        from tidb_tpu_torch.errors import QueryInterrupted
        from tidb_tpu_torch.parser import parse_with_text
        from tidb_tpu_torch.util import phases as phases_mod
        from tidb_tpu_torch.util import timeline
        from tidb_tpu_torch.util.guard import PROCESS_REGISTRY, ExecutionGuard
        from tidb_tpu_torch.util.memory import Tracker
        from tidb_tpu_torch.util.observability import REGISTRY
        out = []
        for s, one in parse_with_text(sql):
            kind = type(s).__name__
            self._current_sql = one
            self.last_engine = "cpu"
            if PROCESS_REGISTRY.conn_killed(self.conn_id):
                raise QueryInterrupted("Connection was killed")
            # arm this statement's guard: deadline from the sysvar, root
            # tracker from the quota — PROCESS_REGISTRY makes it killable.
            # MySQL scopes max_execution_time to read-only SELECT
            # (sql/sql_parse.cc set_statement_timer): writes and
            # SELECT ... FOR UPDATE run to completion (or explicit KILL) —
            # a deadline must never abort a half-applied mutation
            timeout_ms = int(self.vars.get("max_execution_time", 0) or 0) \
                if _stmt_is_read_only_select(s) else 0
            quota = int(self.vars.get("tidb_mem_quota_query", 0) or 0)
            guard = ExecutionGuard(self.conn_id, one[:256],
                                   timeout_ms / 1000.0,
                                   Tracker("query", quota))
            # admission classification for the priority-aware scheduler:
            # the class + cost hint ride the guard into every
            # device_slot() acquire of this statement
            prio = str(self.vars.get("tidb_tpu_priority_scheduling",
                                     "on")).lower()
            if prio not in ("off", "0", "false"):
                guard.sched_class, guard.sched_cost = \
                    _classify_admission(s, one, from_prepared)
                # tables the digest historically touched: the pool's
                # locality placement routes warm digests to the device
                # already holding them (cold digests → least depth)
                guard.sched_tables = REGISTRY.digest_tables(one)
            self._guard = guard
            self.last_guard = guard
            PROCESS_REGISTRY.stmt_begin(self.conn_id, guard)
            # opt-in cross-session Chrome trace: the sysvar names the
            # directory; start is idempotent, clearing the var stops it
            trace_dir = str(self.vars.get("tidb_tpu_trace_dir", "") or "")
            if trace_dir:
                timeline.start_global(trace_dir)
            # bind the statement's attribution ledger to this thread so
            # compile builders / evictions without a ctx can charge it
            phases_mod.set_current(guard.phases)
            t0 = _time.perf_counter()
            try:
                rs = self._execute_stmt(s)
            except Exception:
                REGISTRY.inc("tidb_tpu_stmt_errors_total",
                             {"stmt": kind})
                raise
            finally:
                # never let this statement's text key a LATER direct
                # _plan() call (plan-cache poisoning)
                self._current_sql = None
                self._guard = None
                phases_mod.set_current(None)
                PROCESS_REGISTRY.stmt_end(self.conn_id)
                if timeline.ENABLED:
                    timeline.flush(force=False)
            dt = _time.perf_counter() - t0
            if not (isinstance(s, ast.ShowStmt) and s.kind == "warnings"):
                self.warnings = list(guard.warnings)
            REGISTRY.inc("tidb_tpu_stmt_total", {"stmt": kind})
            REGISTRY.observe("tidb_tpu_stmt_seconds", dt, {"stmt": kind})
            n_rows = rs.row_count if rs.is_query else rs.affected_rows
            threshold = float(self.vars.get("long_query_time", 0.3))
            REGISTRY.record_stmt(one, dt, n_rows, self.last_engine,
                                 threshold, guard=guard)
            out.append(rs)
        return out

    def query(self, sql: str) -> ResultSet:
        results = self.execute(sql)
        return results[-1]

    # ---- txn plumbing ------------------------------------------------------
    def _read_view_snapshot(self):
        if self._stmt_snapshot is not None:
            return self._stmt_snapshot
        if self.txn is not None:
            return self.txn.snapshot
        return self.engine.store.snapshot()

    def _exec_ctx(self) -> ExecContext:
        dev = self.engine.device
        if self._stmt_snapshot is not None:
            return ExecContext(snapshot=self._stmt_snapshot,
                               vars=self.vars, guard=self._guard,
                               device=dev)
        if self.txn is not None:
            return ExecContext(txn=self.txn, vars=self.vars,
                               guard=self._guard, device=dev)
        return ExecContext(snapshot=self.engine.store.snapshot(),
                           vars=self.vars, guard=self._guard, device=dev)

    def _write_txn(self) -> Tuple[Transaction, bool]:
        """→ (txn, autocommit): DML inside BEGIN uses the session txn;
        otherwise a single-statement txn committed at the end. The txn
        remembers the schema version its statement planned against —
        _commit_auto enforces the schema lease at commit."""
        if self.txn is not None:
            return self.txn, False
        txn = self.engine.store.begin()
        txn.schema_version0 = self.engine.catalog.user_version
        return txn, True

    def _note_touched(self, txn: Transaction, info: TableInfo) -> None:
        """Record the schema signature the statement planned against for
        a table it is about to write. The lease check at commit compares
        only THESE tables — an unrelated concurrent DDL (new table,
        index on a table this txn never wrote) must not abort the
        commit (domain/schema_validator.go relatedChanges)."""
        touched = getattr(txn, "touched_schema", None)
        if touched is None:
            touched = txn.touched_schema = {}
        touched.setdefault(info.id, _table_schema_sig(info))

    def _touched_schema_changed(self, txn: Transaction) -> bool:
        """True when a table this txn wrote changed shape since the
        writing statement captured its TableInfo. Conservative on two
        edges: a write path that never called _note_touched, or staged
        writes against table ids with no recorded signature, fall back
        to 'changed' (abort) — correctness over availability."""
        touched = getattr(txn, "touched_schema", None)
        if not touched:
            return True
        staged = set(txn.staged_inserts) | set(txn.staged_deletes)
        if staged - set(touched):
            return True
        info_schema = self.engine.catalog.info_schema
        for tid, sig in touched.items():
            info = info_schema.table_by_id(tid)
            if info is None or _table_schema_sig(info) != sig:
                return True
        return False

    def _commit_auto(self, txn: Transaction) -> None:
        """Autocommit with the SAME schema-lease check explicit txns get
        at COMMIT: a statement that captured its TableInfo before a
        concurrent DDL (e.g. a unique index going write-only) must abort
        rather than commit rows that skipped the new constraint
        (domain/schema_validator.go — the lease covers autocommit too).
        The check is TABLE-SCOPED: user_version bumps from DDL on tables
        this statement never wrote do not abort it."""
        if getattr(txn, "schema_version0", None) is not None and \
                self.engine.catalog.user_version != txn.schema_version0 \
                and txn.has_staged_writes() \
                and self._touched_schema_changed(txn):
            txn.rollback()
            raise SchemaChangedError(
                "Information schema is changed during the execution of "
                "the statement; please retry")
        txn.commit()

    _DDL_STMTS = (ast.CreateTable, ast.DropTable, ast.TruncateTable,
                  ast.AlterTable, ast.CreateIndex, ast.DropIndex)

    def _implicit_commit(self) -> None:
        """DDL causes an implicit COMMIT of any open transaction (MySQL
        semantics) — staged rows must land under the pre-DDL schema, not
        be silently re-interpreted against the new layout."""
        if self.txn is not None:
            self.txn.commit()
            self.txn = None

    # ---- privilege gate (ref: privilege/privileges/privileges.go:62) -------
    _STMT_PRIV = {
        ast.Insert: "INSERT", ast.Update: "UPDATE", ast.Delete: "DELETE",
        ast.LoadData: "INSERT",
        ast.CreateTable: "CREATE", ast.DropTable: "DROP",
        ast.TruncateTable: "DROP", ast.AlterTable: "ALTER",
        ast.CreateIndex: "INDEX", ast.DropIndex: "INDEX",
    }

    def _check_privileges(self, stmt: ast.StmtNode) -> None:
        auth = self.engine.auth
        if auth.is_superuser(self.user):
            return
        if isinstance(stmt, (ast.CreateUser, ast.DropUser, ast.GrantStmt,
                             ast.BackupStmt, ast.RestoreStmt)):
            from tidb_tpu_torch.session.auth import PrivilegeError
            raise PrivilegeError(
                f"Access denied for user '{self.user}'@'%' "
                f"(this operation requires ALL on *.*)")
        if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt, ast.WithStmt)):
            for t in _stmt_tables(stmt):
                auth.require(self.user, "SELECT", t)
            return
        if isinstance(stmt, ast.Insert):
            # INSERT on the target; SELECT on INSERT…SELECT sources
            auth.require(self.user, "INSERT", stmt.table)
            if stmt.select is not None:
                for t in _stmt_tables(stmt.select):
                    auth.require(self.user, "SELECT", t)
            return
        priv = self._STMT_PRIV.get(type(stmt))
        if priv is not None:
            tables = _stmt_tables(stmt)
            if tables:
                for t in tables:
                    auth.require(self.user, priv, t)
            else:
                auth.require(self.user, priv, None)

    # ---- dispatch ----------------------------------------------------------
    def _execute_stmt(self, stmt: ast.StmtNode) -> ResultSet:
        self._check_privileges(stmt)
        if isinstance(stmt, self._DDL_STMTS):
            self._implicit_commit()
        if isinstance(stmt, ast.TraceStmt):
            return self._trace(stmt)
        if isinstance(stmt, ast.LoadData):
            return self._load_data(stmt)
        if isinstance(stmt, (ast.BackupStmt, ast.RestoreStmt)):
            raise ExecutionError("BACKUP/RESTORE are not in the PyTorch "
                                 "port yet (tidb_tpu_torch/tools)")
        if isinstance(stmt, ast.CreateUser):
            self.engine.auth.create_user(stmt.user, stmt.password,
                                         stmt.if_not_exists)
            return ok()
        if isinstance(stmt, ast.DropUser):
            self.engine.auth.drop_user(stmt.user, stmt.if_exists)
            return ok()
        if isinstance(stmt, ast.GrantStmt):
            if stmt.revoke:
                self.engine.auth.revoke(stmt.user, set(stmt.privs),
                                        stmt.scope)
            else:
                self.engine.auth.grant(stmt.user, set(stmt.privs),
                                       stmt.scope)
            return ok()
        if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
            as_of = _stmt_as_of(stmt)
            if as_of is not None:
                return self._run_as_of(stmt, as_of)
            if isinstance(stmt, ast.SelectStmt) and stmt.for_update \
                    and self.txn is not None:
                self._lock_for_update(stmt)
                orig = self.txn.snapshot
                self.txn.snapshot = self._for_update_snapshot or orig
                try:
                    return self._run_query(stmt)
                finally:
                    self.txn.snapshot = orig
                    self._for_update_snapshot = None
            return self._run_query(stmt)
        if isinstance(stmt, ast.WithStmt):
            return self._run_with(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.CreateView):
            # plan the body once now: an invalid definition must fail at
            # CREATE time (ddl/ddl_api.go CreateView builds the plan)
            body = self._plan(stmt.select)
            if stmt.columns and len(stmt.columns) != len(body.schema):
                raise PlanError(
                    "View's SELECT and view's field list have different "
                    "column counts")   # ER 1353
            self.engine.catalog.create_view(
                stmt.name, stmt.text, stmt.columns or (),
                stmt.or_replace)
            return ok()
        if isinstance(stmt, ast.DropView):
            for n in stmt.names:
                self.engine.catalog.drop_view(n, stmt.if_exists)
            return ok()
        if isinstance(stmt, ast.AlterTable):
            return self._alter_table(stmt)
        if isinstance(stmt, ast.CreateIndex):
            from tidb_tpu_torch.catalog import IndexInfo as _IdxInfo
            info = self.engine.catalog.info_schema.table(stmt.table)
            if not stmt.unique:
                self.engine.catalog.add_index(
                    stmt.table, _IdxInfo(stmt.name, tuple(stmt.columns)))
                return ok()
            # online unique-index build, the F1 state walk collapsed to
            # write_only → public (ddl/index.go:519-527):
            # 1. publish WRITE-ONLY first — from here every concurrent
            #    writer enforces the key (readers still ignore it);
            #    racing explicit txns abort at commit via the schema
            #    lease check
            self.engine.catalog.add_index(
                stmt.table, _IdxInfo(stmt.name, tuple(stmt.columns),
                                     True, state="write_only"))
            try:
                # 2. chunked, checkpoint-resumable validation of the
                #    COMMITTED data (ddl/reorg.go:193; tidb_tpu/ddl.py),
                #    re-run until the table is quiescent: a straggler
                #    statement that began before publication may commit
                #    unchecked rows after our snapshot — new data means
                #    another (checkpoint-incremental) pass
                from tidb_tpu_torch.ddl import unique_backfill
                from tidb_tpu_torch.errors import BackoffExhausted
                from tidb_tpu_torch.util.backoff import Backoffer
                ckpt_dir = str(self.vars.get(
                    "tidb_ddl_reorg_checkpoint_dir", "") or "") or None
                # quiescence retries ride the shared budgeted backoff:
                # each non-quiescent pass waits a beat (stragglers get a
                # chance to drain) and a hot table exhausts the budget
                # into the same 8214 cancellation
                bo = Backoffer("ddl-quiesce", base_ms=5.0, max_ms=100.0,
                               budget_ms=500.0, guard=self._guard)
                try:
                    while True:
                        seen_td = unique_backfill(self, info,
                                                  list(stmt.columns),
                                                  stmt.name, ckpt_dir)
                        snap_now = self.engine.store.snapshot()
                        now_td = snap_now.table_data(info.id) \
                            if snap_now.has_table(info.id) else None
                        if seen_td is now_td:
                            break
                        bo.backoff()
                except BackoffExhausted as e:
                    raise DDLError(
                        "Cancelled DDL job: table kept changing during "
                        "unique validation", code=8214) from e
            except BaseException:
                self.engine.catalog.drop_index(stmt.table, stmt.name)
                raise
            # 3. flip public: readers may now use it, and the PK-FK
            #    uniqueness bet may trust it
            self.engine.catalog.set_index_state(stmt.table, stmt.name,
                                                "public")
            return ok()
        if isinstance(stmt, ast.DropIndex):
            self.engine.catalog.drop_index(stmt.table, stmt.name)
            return ok()
        if isinstance(stmt, ast.DropTable):
            for name in stmt.names:
                info = self.engine.catalog.drop_table(name, stmt.if_exists)
                if info is not None:
                    self.engine.store.drop_table(info.id)
                    self._reset_auto_ids(info.id)
            return ok()
        if isinstance(stmt, ast.TruncateTable):
            info = self.engine.catalog.info_schema.table(stmt.name)
            self.engine.store.truncate_table(info.id)
            self._reset_auto_ids(info.id)   # MySQL: TRUNCATE restarts at 1
            return ok()
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, ast.SetStmt):
            return self._set(stmt)
        if isinstance(stmt, ast.ShowStmt):
            return self._show(stmt)
        if isinstance(stmt, ast.UseStmt):
            return ok()
        if isinstance(stmt, ast.BeginStmt):
            if self.txn is not None:
                self.txn.commit()  # implicit commit (MySQL semantics)
            self.txn = self.engine.store.begin()
            mode = stmt.mode or str(self.vars.get("tidb_txn_mode",
                                                  "optimistic"))
            self.txn.pessimistic = (mode == "pessimistic")
            self._txn_schema_version = self.engine.catalog.user_version
            return ok()
        if isinstance(stmt, ast.CommitStmt):
            if self.txn is not None:
                try:
                    # schema lease check (domain/schema_validator.go): a
                    # concurrent DDL may have changed layouts the staged
                    # chunks were built against — abort, don't corrupt.
                    # Table-scoped: only DDL that reshaped a table this
                    # txn actually wrote aborts the commit.
                    if self.engine.catalog.user_version != \
                            getattr(self, "_txn_schema_version", None) \
                            and self.txn.has_staged_writes() \
                            and self._touched_schema_changed(self.txn):
                        self.txn.rollback()
                        raise SchemaChangedError(
                            "Information schema is changed during the "
                            "execution of the statement; please retry")
                    self.txn.commit()
                    for tid, n in self.txn.modified.items():
                        self.engine.note_modified(tid, n)
                finally:
                    self.txn = None
            return ok()
        if isinstance(stmt, ast.RollbackStmt):
            if self.txn is not None:
                self.txn.rollback()
                self.txn = None
            return ok()
        if isinstance(stmt, ast.AnalyzeTable):
            return self._analyze(stmt)
        if isinstance(stmt, ast.KillStmt):
            return self._kill(stmt)
        raise PlanError(f"unsupported statement: {type(stmt).__name__}")

    def _kill(self, stmt: "ast.KillStmt") -> ResultSet:
        """KILL [QUERY] <id> (ref: server/conn.go handleQuery → KILL,
        executor/executor.go KillStmt): flips the target statement's
        guard; bare KILL also poisons the connection. MySQL's error split
        (sql/sql_class.cc kill_one_thread): unknown id → ER 1094; id
        exists but belongs to someone else and the killer lacks the
        global SUPER privilege → ER 1095 — NOT 1094, so an unprivileged
        user can still tell 'no such thread' from 'not yours'."""
        from tidb_tpu_torch.errors import KillDeniedError, NoSuchThreadError
        from tidb_tpu_torch.util.guard import PROCESS_REGISTRY
        info = PROCESS_REGISTRY.info(stmt.conn_id)
        if info is None:
            raise NoSuchThreadError(f"Unknown thread id: {stmt.conn_id}")
        if info["user"] not in (None, self.user) \
                and not self.engine.auth.has_global(self.user, "SUPER"):
            raise KillDeniedError(
                f"You are not owner of thread {stmt.conn_id}")
        PROCESS_REGISTRY.kill(stmt.conn_id, query_only=stmt.query_only)
        return ok()

    # ---- SELECT ------------------------------------------------------------
    def plan_for_prepare(self, stmt):
        """Plan for COM_STMT_PREPARE column metadata ONLY (ref:
        server/driver_tidb.go Prepare). Prepare must never execute user
        data reads, so subquery evaluation is disabled for the duration:
        a statement whose plan needs a subquery result (scalar subquery
        folding, apply probe) raises _PrepareProbeSkip and the caller
        falls back to deferred metadata (0 columns). Plans built under
        the probe are also kept out of the plan cache — NULL-substituted
        parameter text must not shadow real executions."""
        self._prepare_probe = True
        try:
            return self._plan(stmt)
        except _PrepareProbeSkip:
            return None
        finally:
            self._prepare_probe = False

    def _subquery_evaluator(self) -> SubqueryEvaluator:
        def run(sel: ast.SelectStmt):
            if self._prepare_probe:
                raise _PrepareProbeSkip()
            # expression subqueries read tables too — same privilege gate
            # as a top-level SELECT (privileges.go checks every access)
            self._check_privileges(sel)
            self._subq_execs += 1
            rs = self._run_query(sel)
            return rs.rows, rs.ftypes

        def run_plan(logical):
            if self._prepare_probe:
                raise _PrepareProbeSkip()
            # execute an already-built logical subquery plan (the
            # decorrelator's probe build) without re-planning the AST
            from tidb_tpu_torch.planner import optimize_logical
            self._subq_execs += 1
            if not self.engine.auth.is_superuser(self.user):
                for t in _plan_tables(logical):
                    self.engine.auth.require(self.user, "SELECT", t)
            phys = optimize_logical(logical, _PlanContext(self))
            root = build(phys)
            chunks = run_to_completion(root, self._exec_ctx())
            rows = [r for ch in chunks for r in ch.rows()]
            return rows, list(phys.schema.field_types)

        def build_plan(sel, outer_schema):
            # plan a subquery with the caller's row schema visible, so
            # unresolved names become CorrelatedRefs (apply fallback)
            from tidb_tpu_torch.planner.builder import PlanBuilder
            b = PlanBuilder(self.engine.catalog.info_schema,
                            _PlanContext(self))
            return b.build_subquery_plan(sel, outer_schema)

        ev = SubqueryEvaluator(run)
        ev.run_plan = run_plan
        ev.build_plan = build_plan

        def note_dynamic():
            # apply-fallback plans embed data-dependent row sets; bumping
            # the subquery counter makes _plan skip caching them
            self._subq_execs += 1

        ev.note_dynamic = note_dynamic
        return ev

    PLAN_CACHE_SIZE = 128

    def _note_modified(self, txn, auto: bool, table_id: int,
                       n: int) -> None:
        """Auto-analyze row accounting: immediate under autocommit;
        deferred to COMMIT inside explicit transactions so a ROLLBACK
        never inflates modify_counts (the reference flushes modifyCount
        on commit, statistics/handle/update.go)."""
        if auto or txn is None:
            self.engine.note_modified(table_id, n)
        else:
            txn.modified[table_id] = txn.modified.get(table_id, 0) + n

    def _plan(self, stmt):
        ctx = _PlanContext(self)
        key = self._plan_cache_key(stmt)
        if key is not None:
            hit = self._plan_cache.get(key)
            if hit is not None:
                self._plan_cache.move_to_end(key)
                from tidb_tpu_torch.util.observability import REGISTRY
                REGISTRY.inc("tidb_tpu_plan_cache_hits_total")
                return hit
        before = self._subq_execs
        plan = optimize(stmt, self.engine.catalog.info_schema, ctx)
        if key is not None and self._subq_execs == before \
                and not self._prepare_probe:
            self._plan_cache[key] = plan
            while len(self._plan_cache) > self.PLAN_CACHE_SIZE:
                self._plan_cache.popitem(last=False)
        return plan

    def _plan_cache_key(self, stmt):
        """None → uncacheable: non-SELECT, CTE scope (temp tables are
        per-execution), inside an explicit transaction, or no statement
        text available. Referenced-table live row counts are part of the
        key — cardinality estimates bake into the plan (fragment routing,
        join order), so any size change must re-plan."""
        if not isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
            return None
        if self._cte_map or self._current_sql is None or \
                self.txn is not None or self._stmt_snapshot is not None \
                or self._tracer is not None:
            return None
        info_schema = self.engine.catalog.info_schema
        snap = self._read_view_snapshot()
        names = self._expand_view_tables(sorted(set(_stmt_tables(stmt))),
                                         info_schema)
        if names is None:
            return None
        sizes = []
        for t in sorted(set(names)):
            if info_schema.view(t) is not None:
                sizes.append((t, -1))  # definition changes bump version
                continue
            try:
                info = info_schema.table(t)
            except TiDBTPUError:
                return None
            n = snap.table_data(info.id).live_rows \
                if snap.has_table(info.id) else 0
            sizes.append((t, n))
        v = self.vars
        return (self._current_sql,
                info_schema.version,
                self.engine.stats_version,
                tuple(sizes),
                str(v.get("tidb_tpu_engine")),
                int(v.get("tidb_tpu_row_threshold", 32768)),
                str(v.get("tidb_tpu_dist_devices", 0)),
                str(v.get("time_zone", "SYSTEM")),  # tz folds into plans
                self.user)

    _VIEW_TABLES_CACHE: Dict[Tuple[str, str], List[str]] = {}

    def _expand_view_tables(self, names, info_schema, depth=0):
        """Referenced names with views transitively expanded to their
        base tables (so view plans stay cacheable with the base tables'
        sizes in the key), or None when unresolvable."""
        if depth > 16:
            return None
        out = []
        for t in names:
            v = info_schema.view(t)
            if v is None:
                out.append(t)
                continue
            key = (v.name.lower(), v.sql)
            sub = self._VIEW_TABLES_CACHE.get(key)
            if sub is None:
                from tidb_tpu_torch.parser import parse as _parse
                try:
                    sub = _stmt_tables(_parse(v.sql)[0])
                except Exception:  # noqa: BLE001
                    return None
                if len(self._VIEW_TABLES_CACHE) >= 256:
                    self._VIEW_TABLES_CACHE.clear()   # bound, not LRU
                self._VIEW_TABLES_CACHE[key] = sub
            expanded = self._expand_view_tables(sub, info_schema,
                                                depth + 1)
            if expanded is None:
                return None
            out.append(t)
            out.extend(expanded)
        return out

    def _run_as_of(self, stmt, as_of_expr) -> ResultSet:
        """Historical read (AS OF TIMESTAMP ...): resolve the timestamp,
        pin the statement's read view to the matching store version."""
        from tidb_tpu_torch.planner.rules import fold_expr
        rw = ExpressionRewriter(Schema([]), None)
        const = fold_expr(rw.rewrite(as_of_expr))
        from tidb_tpu_torch.expression import Constant
        if not isinstance(const, Constant) or const.value is None:
            raise PlanError("AS OF TIMESTAMP requires a constant")
        import datetime as _dt
        v = const.value
        if isinstance(v, _dt.datetime):
            ts = v.timestamp()
        elif isinstance(v, (int, float)):
            ts = float(v)
        else:
            ts = _dt.datetime.fromisoformat(str(v)).timestamp()
        if self.txn is not None:
            raise TxnError(
                "AS OF reads are not allowed inside a transaction")
        self._stmt_snapshot = self.engine.store.snapshot_at(ts)
        try:
            return self._run_query(stmt)
        finally:
            self._stmt_snapshot = None

    def _load_data(self, stmt: ast.LoadData) -> ResultSet:
        """LOAD DATA INFILE: bulk CSV ingest through the INSERT path so
        type coercion, defaults and unique checks all apply (ref:
        executor/load_data.go)."""
        import csv
        total = 0
        batch: List[str] = []
        info = self.engine.catalog.info_schema.table(stmt.table)
        n_cols = len(info.columns)

        def flush():
            nonlocal total
            if batch:
                self.execute(f"INSERT INTO `{stmt.table}` VALUES " +
                             ",".join(batch))
                total += len(batch)
                batch.clear()

        with open(stmt.path, newline="") as f:
            r = csv.reader(f, delimiter=stmt.delimiter)
            for i, row in enumerate(r):
                if i < stmt.ignore_lines:
                    continue
                row = (row + [None] * n_cols)[:n_cols]
                vals = ", ".join(
                    "NULL" if v is None or v == "\\N" else
                    "'" + str(v).replace("\\", "\\\\")
                    .replace("'", "\\'") + "'"
                    for v in row)
                batch.append(f"({vals})")
                if len(batch) >= 2000:
                    flush()
            flush()
        return ok(total)

    def _trace(self, stmt) -> ResultSet:
        """TRACE <stmt>: run it with a span recorder attached and return
        the span tree (ref: executor/trace.go) — or, with
        FORMAT='chrome', capture the cross-thread timeline events of just
        this statement and return the Chrome-trace JSON as one row."""
        from tidb_tpu_torch.util.tracing import Tracer
        if getattr(stmt, "format", "row") == "chrome":
            from tidb_tpu_torch.util import timeline
            with timeline.capture() as cap:
                self._execute_stmt(stmt.stmt)
            return ResultSet(["trace"], [T.varchar()],
                             [(timeline.render(cap.events),)])
        prev = self._tracer
        tr = Tracer()
        self._tracer = tr
        try:
            with tr.span("session.run"):
                self._execute_stmt(stmt.stmt)
            rows = tr.rows()
        finally:
            self._tracer = prev
        return ResultSet(["operation", "startTS(us)", "duration(us)"],
                         [T.varchar(), T.varchar(), T.varchar()], rows)

    def _run_query_chunks(self, stmt, want_root: bool = False):
        from tidb_tpu_torch.util.tracing import maybe_span
        tr = self._tracer
        with maybe_span(tr, "planner.optimize"):
            plan = self._plan(stmt)
        self.last_plan = plan
        with maybe_span(tr, "executor.build"):
            exec_root = build(plan)
        with maybe_span(tr, "executor.run"):
            ctx = self._exec_ctx()
            ctx.tracer = tr
            chunks = run_to_completion(exec_root, ctx)
        if tr is not None:
            _operator_spans(tr, exec_root)
        if want_root:
            return plan, chunks, exec_root
        return plan, chunks

    def _run_query(self, stmt) -> ResultSet:
        plan, chunks, exec_root = self._run_query_chunks(stmt,
                                                        want_root=True)
        self.last_engine = "tpu" if _used_device(exec_root) else "cpu"
        if self.last_engine == "tpu":
            from tidb_tpu_torch.util.observability import REGISTRY
            REGISTRY.inc("tidb_tpu_device_queries_total")
        return ResultSet(plan.schema.names, plan.schema.field_types,
                         chunks=chunks)

    # ---- DDL ---------------------------------------------------------------
    def _create_table(self, stmt: ast.CreateTable) -> ResultSet:
        from tidb_tpu_torch.expression import Constant
        from tidb_tpu_torch.planner.rules import fold_expr
        cols = []
        for c in stmt.columns:
            default = None
            has_default = False
            if c.default is not None:
                rw = ExpressionRewriter(Schema([]))
                folded = fold_expr(rw.rewrite(c.default))
                if not isinstance(folded, Constant):
                    raise PlanError("DEFAULT must fold to a constant")
                default = folded.value
                has_default = True
            nullable = c.ftype.nullable and not c.primary_key
            auto_inc = getattr(c, "auto_increment", False)
            if auto_inc and not c.ftype.kind.is_integer:
                raise PlanError(
                    "Incorrect column specifier: AUTO_INCREMENT needs an "
                    "integer column")
            cols.append(ColumnInfo(c.name, c.ftype.with_nullable(nullable),
                                   primary_key=c.primary_key,
                                   default=default, has_default=has_default,
                                   auto_increment=auto_inc))
        pk = list(stmt.primary_key) or [c.name for c in stmt.columns
                                        if c.primary_key]
        idx = [IndexInfo(i.name, tuple(i.columns), i.unique)
               for i in stmt.indexes]
        pinfo = None
        if stmt.partition is not None:
            pinfo = self._build_partition_info(stmt, cols)
        info = self.engine.catalog.create_table(stmt.name, cols, pk, idx,
                                                stmt.if_not_exists, pinfo)
        if info is not None:
            self.engine.store.create_table(info.id)
        return ok()

    def _build_partition_info(self, stmt: ast.CreateTable, cols):
        """Validate and encode a PARTITION BY spec (ref: ddl/ddl_api.go
        buildTablePartitionInfo): the key column must exist and be
        integer-encodable; RANGE bounds fold to constants, encode in the
        column's value space, and must ascend strictly."""
        from tidb_tpu_torch.catalog import PartitionInfo
        spec = stmt.partition
        offset = next((i for i, c in enumerate(cols)
                       if c.name.lower() == spec.column.lower()), None)
        if offset is None:
            raise PlanError(f"Unknown column '{spec.column}' in "
                            f"partition function")
        ft = cols[offset].ftype
        if ft.kind.is_string or ft.is_wide_decimal or \
                ft.np_dtype.kind == "f":
            raise PlanError(
                "Partition key must be an integer-valued column "
                "(INT/BIGINT/DATE/DATETIME family)")
        names = tuple(d.name for d in spec.defs)
        if len(set(n.lower() for n in names)) != len(names):
            raise PlanError("Duplicate partition name")
        if spec.kind == "hash":
            return PartitionInfo("hash", spec.column, offset, names,
                                 num=spec.num)
        bounds = [self._encode_partition_bound(ft, d.less_than)
                  for d in spec.defs]
        for a, b in zip(bounds, bounds[1:]):
            if a is None or (b is not None and b <= a):
                raise PlanError(
                    "VALUES LESS THAN value must be strictly increasing "
                    "for each partition")
        return PartitionInfo("range", spec.column, offset, names,
                             tuple(bounds))

    @staticmethod
    def _encode_partition_bound(ft, expr) -> Optional[int]:
        """Fold + encode one VALUES LESS THAN bound (None = MAXVALUE) —
        the ONE validation path for CREATE TABLE and ADD PARTITION."""
        from tidb_tpu_torch.expression import Constant
        from tidb_tpu_torch.planner.rules import fold_expr
        if expr is None:
            return None
        rw = ExpressionRewriter(Schema([]))
        folded = fold_expr(rw.rewrite(expr))
        if not isinstance(folded, Constant) or folded.value is None:
            raise PlanError("VALUES LESS THAN must be a constant")
        try:
            enc = ft.encode_value(folded.value)
        except (ValueError, TiDBTPUError):
            enc = None
        if not isinstance(enc, (int, np.integer)):
            raise PlanError("VALUES LESS THAN must encode to an "
                            "integer for this column type")
        return int(enc)

    def _validate_routing(self, info: TableInfo, chunk: Chunk) -> None:
        """Raise ER 1526 BEFORE any delete is staged: a routing failure
        mid-statement must not leave half the DML applied."""
        if info.partition is None or chunk.num_rows == 0:
            return
        from tidb_tpu_torch.planner.partition import row_partitions
        col = chunk.columns[info.partition.col_offset]
        row_partitions(info.partition, col.values, col.valid_mask())

    def _append_routed(self, target, info: TableInfo, chunk: Chunk) -> None:
        """Append through partition routing: each sub-chunk lands in its
        partition's own regions (table/tables/partition.go
        locatePartition — here a vectorized split)."""
        if info.partition is None or chunk.num_rows == 0:
            target.append(info.id, chunk)
            return
        from tidb_tpu_torch.planner.partition import split_chunk
        for ordinal, sub in split_chunk(info.partition, chunk):
            target.append(info.id, sub, part=ordinal)

    # ---- DML ---------------------------------------------------------------
    def _fill_auto_increment(self, info: TableInfo, chunk: Chunk) -> Chunk:
        """Assign AUTO_INCREMENT values to NULL slots (NULL/absent means
        'allocate', MySQL semantics); explicit values above the counter
        push it forward. Sets last_insert_id to the FIRST id generated by
        this statement (ref: meta/autoid + session LastInsertID)."""
        auto_cols = [c for c in info.columns if c.auto_increment]
        if not auto_cols or chunk.num_rows == 0:
            return chunk
        cols = list(chunk.columns)
        for c in auto_cols:
            col = cols[c.offset]
            valid = col.valid_mask()
            vals = np.asarray(col.values).astype(np.int64, copy=True)
            seed = None
            if (info.id, c.offset) not in self.engine._auto_ids:
                seed = self._auto_id_seed(info, c)
            first = self.engine.assign_auto_ids(info.id, c.offset, vals,
                                                valid, seed)
            if first is not None:
                self.last_insert_id = first
            cols[c.offset] = Column(c.ftype, vals, None)
        return Chunk(cols)

    def _reset_auto_ids(self, table_id: int) -> None:
        with self.engine.stats_lock:
            for key in [k for k in self.engine._auto_ids
                        if k[0] == table_id]:
                self.engine._auto_ids.pop(key, None)

    def _auto_id_seed(self, info: TableInfo, c) -> int:
        """MAX(col) over live + staged rows: restored/imported tables
        keep counting past their data."""
        from tidb_tpu_torch.executor.scan import align_chunk_to_schema
        mx = 0
        snap = self._read_view_snapshot()
        if snap.has_table(info.id):
            for region, alive in snap.scan(info.id):
                ch = align_chunk_to_schema(region.chunk, info)
                col = ch.columns[c.offset]
                m = col.valid_mask() & alive
                if m.any():
                    mx = max(mx, int(np.asarray(col.values)[m].max()))
        if self.txn is not None:
            for st, _part in self.txn.staged_inserts.get(info.id, []):
                col = st.columns[c.offset]
                m = col.valid_mask()
                if m.any():
                    mx = max(mx, int(np.asarray(col.values)[m].max()))
        return mx

    def _insert(self, stmt: ast.Insert) -> ResultSet:
        info = self.engine.catalog.info_schema.table(stmt.table)
        names = _validate_insert_columns(stmt.columns, info)
        if stmt.select is not None:
            chunk = self._select_chunk_for_insert(stmt.select, info, names)
        else:
            chunk = self._rows_chunk(stmt, info, names)
        chunk = self._fill_auto_increment(info, chunk)
        if self.txn is None and stmt.select is None and chunk.num_rows == 1:
            # autocommit single-row INSERT: eligible for the coalesced
            # write batch (session/writebatch.py) — N queued same-digest
            # writers share ONE commit, so readers pay one delta
            # extension instead of N. The closure follows the
            # validate-then-stage discipline below exactly: a typed
            # failure leaves the shared transaction untouched.
            from tidb_tpu_torch.session import writebatch

            def _stage(txn, _chunk=chunk):
                self._note_touched(txn, info)
                self._validate_routing(info, _chunk)
                kept = self._enforce_unique(info, _chunk, txn,
                                            ignore=stmt.ignore,
                                            replace=stmt.replace)
                self._append_routed(txn, info, kept)
                return kept.num_rows

            n = writebatch.coalesce(self, info.id, _stage)
            if n is not None:
                return ok(n)
        txn, auto = self._write_txn()
        self._note_touched(txn, info)
        try:
            # route-validate BEFORE REPLACE stages conflicting-row deletes
            # (a superset of the post-enforce rows, so validity carries)
            self._validate_routing(info, chunk)
            chunk = self._enforce_unique(info, chunk, txn,
                                         ignore=stmt.ignore,
                                         replace=stmt.replace)
            self._append_routed(txn, info, chunk)
            if auto:
                self._commit_auto(txn)
        except TiDBTPUError:
            if auto:
                txn.rollback()
            raise
        self._note_modified(txn, auto, info.id, chunk.num_rows)
        return ok(chunk.num_rows)

    def _unique_constraints(self, info: TableInfo):
        out = []
        if info.primary_key:
            out.append(("PRIMARY", tuple(info.primary_key)))
        for ix in info.indexes:
            if ix.unique:
                out.append((ix.name, tuple(ix.columns)))
        return out

    def _enforce_unique(self, info: TableInfo, chunk: Chunk, txn,
                        ignore: bool = False, replace: bool = False):
        """PK / unique-key enforcement on the write path (ref:
        table/tables/tables.go AddRecord dup-key checks). MySQL semantics:
        NULL never conflicts; INSERT IGNORE drops conflicting rows;
        REPLACE deletes the existing conflicting rows first."""
        from tidb_tpu_torch.errors import DuplicateKeyError
        constraints = self._unique_constraints(info)
        if not constraints or chunk.num_rows == 0:
            return chunk
        col_of = {c.name.lower(): i for i, c in enumerate(info.columns)}
        keep = np.ones(chunk.num_rows, dtype=bool)
        for cname, cols in constraints:
            idxs = [col_of[c.lower()] for c in cols]
            new_keys = _key_tuples(chunk, idxs)
            # in-batch duplicates: IGNORE keeps the FIRST occurrence,
            # REPLACE keeps the LAST (MySQL: later rows replace earlier)
            seen = {}
            for ri, k in enumerate(new_keys):
                if k is None or not keep[ri]:
                    continue
                if k in seen:
                    if replace:
                        keep[seen[k]] = False
                        seen[k] = ri
                        continue
                    if ignore:
                        keep[ri] = False
                        continue
                    raise DuplicateKeyError(
                        f"Duplicate entry {k!r} for key '{cname}'")
                seen[k] = ri
            if not seen:
                continue
            # conflicts against the (staged-visible) current table
            conflict_masks: Dict[int, np.ndarray] = {}
            staged_keep: List[np.ndarray] = []
            first_vals = np.array([k[0] for k in seen], dtype=object)
            for region, ch, alive in txn.scan(info.id):
                # vectorized prefilter on the first key column narrows the
                # python tuple check to near-candidates (O(batch) not O(n))
                c0 = ch.columns[idxs[0]]
                c0_vals = c0.values.astype(object)
                if c0.ftype.is_ci:
                    from tidb_tpu_torch.types import fold_ci_array
                    c0_vals = fold_ci_array(c0_vals)  # seen keys are folded
                cand = np.isin(c0_vals, first_vals) & \
                    c0.valid_mask() & alive
                hit = np.zeros(ch.num_rows, dtype=bool)
                if cand.any():
                    ex_keys = _key_tuples(ch.take(np.nonzero(cand)[0]),
                                          idxs)
                    ci = np.nonzero(cand)[0]
                    for j, k in enumerate(ex_keys):
                        if k is not None and k in seen:
                            hit[ci[j]] = True
                if not hit.any():
                    if region is None:
                        staged_keep.append(np.ones(ch.num_rows,
                                                   dtype=bool))
                    continue
                if replace:
                    if region is None:
                        staged_keep.append(~hit)
                    else:
                        conflict_masks[region.id] = hit
                elif ignore:
                    # hit is chunk-space; ex_keys is candidate-space —
                    # map through ci (sorted candidate row indices)
                    for ri in np.nonzero(hit)[0]:
                        j = int(np.searchsorted(ci, int(ri)))
                        keep[seen[ex_keys[j]]] = False
                else:
                    ri0 = int(np.nonzero(hit)[0][0])
                    k = ex_keys[int(np.searchsorted(ci, ri0))]
                    raise DuplicateKeyError(
                        f"Duplicate entry {k!r} for key '{cname}'")
            if replace:
                if conflict_masks:
                    txn.delete(info.id, conflict_masks)
                if staged_keep and not all(m.all() for m in staged_keep):
                    txn.delete_staged(info.id,
                                      np.concatenate(staged_keep))
        if keep.all():
            return chunk
        return chunk.take(np.nonzero(keep)[0])

    def _session_env(self) -> Dict[str, object]:
        return {"user": self.user, "connection_id": self.conn_id,
                "time_zone": str(self.vars.get("time_zone", "SYSTEM")),
                "last_insert_id": self.last_insert_id}

    def _rows_chunk(self, stmt: ast.Insert, info: TableInfo,
                    names: List[str]) -> Chunk:
        from tidb_tpu_torch.expression import Constant
        from tidb_tpu_torch.planner.rules import fold_expr
        rw = ExpressionRewriter(Schema([]), env=self._session_env())
        rows = []
        for vals in stmt.rows:
            if len(vals) != len(names):
                raise PlanError("Column count doesn't match value count")
            evaluated = []
            for v in vals:
                folded = fold_expr(rw.rewrite(v))
                if not isinstance(folded, Constant):
                    raise PlanError("INSERT values must be constants")
                evaluated.append(folded.value)
            rows.append(evaluated)
        out_rows = _assemble_rows(rows, info, names)
        _check_not_null(out_rows, info)
        return Chunk.from_rows(info.field_types, out_rows)

    def _select_chunk_for_insert(self, select, info: TableInfo,
                                 names: List[str]) -> Chunk:
        """INSERT ... SELECT stays columnar: one cast-projection per source
        chunk instead of a per-row Python round trip (ref: the reference's
        insertRowsFromSelect also streams chunks, insert_common.go)."""
        from tidb_tpu_torch.expression import Constant, cast as _cast
        plan, chunks = self._run_query_chunks(select)
        src_schema = plan.schema
        if len(src_schema) != len(names):
            raise PlanError("Column count doesn't match value count")
        pos_of = {n.lower(): i for i, n in enumerate(names)}
        exprs = []
        for c in info.columns:
            pos = pos_of.get(c.name.lower())
            if pos is not None:
                ref = src_schema.column_ref(pos)
                if (ref.ftype.kind != c.ftype.kind or
                        ref.ftype.scale != c.ftype.scale):
                    exprs.append(_cast(ref, c.ftype))
                else:
                    exprs.append(ref)
            elif c.has_default:
                exprs.append(Constant(c.default, c.ftype))
            else:
                exprs.append(Constant(None, c.ftype.with_nullable(True)))
        out = [eval_on_chunk(exprs, ch) for ch in chunks if ch.num_rows]
        chunk = Chunk.concat(out) if len(out) > 1 else (
            out[0] if out else Chunk.from_rows(info.field_types, []))
        chunk = Chunk([Column(c.ftype, col.values, col.validity)
                       for c, col in zip(info.columns, chunk.columns)])
        _check_not_null_chunk(chunk, info, allow_auto_inc=True)
        return chunk

    def _pessimistic_match(self, txn, info, where):
        """Pessimistic DML read-and-lock loop (ref: the for-update-ts
        retry of pessimistic transactions): match rows, acquire their
        locks (waiting on owners), then re-read at the LATEST committed
        version — a concurrent commit while waiting must be visible, or
        updates would be lost against the stale start-ts view. The
        transaction's start-ts snapshot is RESTORED afterwards so plain
        reads keep repeatable-read; locks from stale retry iterations
        release before re-locking (they may cover rows that no longer
        match)."""
        store = self.engine.store
        orig = txn.snapshot
        base = len(txn.locked)
        try:
            for _ in range(16):
                txn.snapshot = store.snapshot()
                region_masks, staged_keep, matched = self._match_masks(
                    info, where, txn)
                self._maybe_lock(txn, info, region_masks)
                if store.snapshot().version == txn.snapshot.version:
                    return region_masks, staged_keep, matched
                store.release_entries(txn, txn.locked[base:])
                del txn.locked[base:]
            raise TxnError("pessimistic statement retry limit exceeded")
        finally:
            txn.snapshot = orig

    def _maybe_lock(self, txn, info, region_masks,
                    force: bool = False) -> None:
        """Pessimistic row locks (ref: session/txn.go pessimistic mode,
        TiKV's lock CF): DML inside a pessimistic txn — and any
        SELECT ... FOR UPDATE — acquires row locks at statement time,
        blocking on conflicting owners up to innodb_lock_wait_timeout."""
        if txn is None or not (force or txn.pessimistic):
            return
        if not region_masks:
            return
        timeout = float(self.vars.get("innodb_lock_wait_timeout", 5.0))
        self.engine.store.lock_rows(txn, info.id, region_masks,
                                    timeout_s=timeout)

    def _lock_for_update(self, stmt: ast.SelectStmt) -> None:
        """SELECT ... FOR UPDATE: lock matched rows of the (single)
        scanned table for the current transaction."""
        if self.txn is None:
            return                # autocommit: lock would release at once
        if not isinstance(stmt.from_, ast.TableName):
            raise PlanError(
                "FOR UPDATE is supported on single-table selects only")
        info = self.engine.catalog.info_schema.table(stmt.from_.name)
        store = self.engine.store
        txn = self.txn
        orig = txn.snapshot
        base = len(txn.locked)
        try:
            for _ in range(16):
                txn.snapshot = store.snapshot()
                region_masks, _, _ = self._match_masks(info, stmt.where,
                                                       txn)
                self._maybe_lock(txn, info, region_masks, force=True)
                if store.snapshot().version == txn.snapshot.version:
                    return
                store.release_entries(txn, txn.locked[base:])
                del txn.locked[base:]
            raise TxnError("pessimistic statement retry limit exceeded")
        finally:
            # FOR UPDATE reads the latest version for THIS statement only;
            # plain reads stay at the start-ts view (repeatable read)
            self._for_update_snapshot = txn.snapshot
            txn.snapshot = orig

    def _match_masks(self, info: TableInfo, where: Optional[ast.ExprNode],
                     txn: Transaction):
        """Scan the table under `txn`, returning (region_masks, staged_keep,
        matched_chunks): committed-region delete masks keyed by region id,
        keep-masks for staged inserts, and the matched rows themselves."""
        from tidb_tpu_torch.executor.scan import align_chunk_to_schema
        schema = Schema.from_table(info)
        cond: Optional[Expression] = None
        if where is not None:
            rw = ExpressionRewriter(schema, self._subquery_evaluator())
            cond = rw.rewrite(where)
        region_masks: Dict[int, np.ndarray] = {}
        staged_keep: List[np.ndarray] = []
        matched: List[Chunk] = []
        for region, chunk, alive in txn.scan(info.id):
            chunk = align_chunk_to_schema(chunk, info)
            hit = alive.copy()
            if cond is not None:
                hit &= filter_mask(cond, chunk)
            if region is not None:
                if hit.any():
                    region_masks[region.id] = hit
                    matched.append(chunk.filter(hit))
            else:
                staged_keep.append(~hit)
                if hit.any():
                    matched.append(chunk.filter(hit))
        return region_masks, staged_keep, matched

    def _delete(self, stmt: ast.Delete) -> ResultSet:
        info = self.engine.catalog.info_schema.table(stmt.table.name)
        if self.txn is None:
            # autocommit DELETE: coalesce-eligible (matching runs inside
            # the shared transaction, so members see one another's
            # staged effects in arrival order — sequential semantics)
            from tidb_tpu_torch.session import writebatch

            def _stage(txn):
                self._note_touched(txn, info)
                region_masks, staged_keep, _ = self._match_masks(
                    info, stmt.where, txn)
                n = sum(int(m.sum()) for m in region_masks.values())
                n += sum(int((~k).sum()) for k in staged_keep)
                if region_masks:
                    txn.delete(info.id, region_masks)
                if staged_keep:
                    txn.delete_staged(info.id, np.concatenate(staged_keep))
                return n

            n = writebatch.coalesce(self, info.id, _stage)
            if n is not None:
                return ok(n)
        txn, auto = self._write_txn()
        self._note_touched(txn, info)
        try:
            if txn.pessimistic:
                region_masks, staged_keep, _ = self._pessimistic_match(
                    txn, info, stmt.where)
            else:
                region_masks, staged_keep, _ = self._match_masks(
                    info, stmt.where, txn)
            n = sum(int(m.sum()) for m in region_masks.values())
            n += sum(int((~k).sum()) for k in staged_keep)
            if region_masks:
                txn.delete(info.id, region_masks)
            if staged_keep:
                txn.delete_staged(info.id, np.concatenate(staged_keep))
            if auto:
                self._commit_auto(txn)
            self._note_modified(txn, auto, info.id, n)
            return ok(n)
        except TiDBTPUError:
            if auto:
                txn.rollback()
            raise

    def _update(self, stmt: ast.Update) -> ResultSet:
        from tidb_tpu_torch.expression import cast as _cast
        info = self.engine.catalog.info_schema.table(stmt.table.name)
        schema = Schema.from_table(info)
        rw = ExpressionRewriter(schema, self._subquery_evaluator(),
                                env=self._session_env())
        assigns: Dict[str, Expression] = {}
        for name, expr in stmt.assignments:
            info.column(name)  # validates the column exists
            assigns[name.lower()] = rw.rewrite(expr)
        exprs = []
        for i, c in enumerate(info.columns):
            e = assigns.get(c.name.lower())
            if e is None:
                exprs.append(schema.column_ref(i))
            elif (e.ftype.kind != c.ftype.kind or
                  e.ftype.scale != c.ftype.scale):
                exprs.append(_cast(e, c.ftype))
            else:
                exprs.append(e)
        if self.txn is None:
            # autocommit UPDATE: coalesce-eligible (see _insert); the
            # delete+append pair stages only after NOT NULL + routing
            # validation, so a typed failure stays member-local
            from tidb_tpu_torch.session import writebatch

            def _stage(txn):
                self._note_touched(txn, info)
                region_masks, staged_keep, matched = self._match_masks(
                    info, stmt.where, txn)
                if not matched:
                    return 0
                old = Chunk.concat(matched) if len(matched) > 1 \
                    else matched[0]
                new_chunk = eval_on_chunk(exprs, old)
                new_chunk = Chunk([Column(c.ftype, col.values,
                                          col.validity)
                                   for c, col in zip(info.columns,
                                                     new_chunk.columns)])
                _check_not_null_chunk(new_chunk, info)
                self._validate_routing(info, new_chunk)
                if region_masks:
                    txn.delete(info.id, region_masks)
                if staged_keep:
                    txn.delete_staged(info.id, np.concatenate(staged_keep))
                self._append_routed(txn, info, new_chunk)
                return new_chunk.num_rows

            n = writebatch.coalesce(self, info.id, _stage)
            if n is not None:
                return ok(n)
        txn, auto = self._write_txn()
        self._note_touched(txn, info)
        try:
            if txn.pessimistic:
                region_masks, staged_keep, matched = \
                    self._pessimistic_match(txn, info, stmt.where)
            else:
                region_masks, staged_keep, matched = self._match_masks(
                    info, stmt.where, txn)
            if not matched:
                if auto:
                    txn.commit()
                return ok(0)
            old = Chunk.concat(matched) if len(matched) > 1 else matched[0]
            new_chunk = eval_on_chunk(exprs, old)
            new_chunk = Chunk([Column(c.ftype, col.values, col.validity)
                               for c, col in zip(info.columns,
                                                 new_chunk.columns)])
            _check_not_null_chunk(new_chunk, info)
            # route-validate BEFORE staging deletes: a PartitionError must
            # not leave the delete half of the update applied
            self._validate_routing(info, new_chunk)
            if region_masks:
                txn.delete(info.id, region_masks)
            if staged_keep:
                txn.delete_staged(info.id, np.concatenate(staged_keep))
            self._append_routed(txn, info, new_chunk)
            if auto:
                self._commit_auto(txn)
            self._note_modified(txn, auto, info.id, new_chunk.num_rows)
            return ok(new_chunk.num_rows)
        except TiDBTPUError:
            if auto:
                txn.rollback()
            raise

    # ---- utility statements -------------------------------------------------
    def _explain(self, stmt: ast.Explain) -> ResultSet:
        plan = self._plan(stmt.stmt)
        if stmt.analyze:
            exec_root = build(plan)
            ctx = self._exec_ctx()
            t0 = time.perf_counter()
            run_to_completion(exec_root, ctx)
            wall = time.perf_counter() - t0
            rows = [(op, est, _actual(exec_root, i), info)
                    for i, (op, est, info) in enumerate(plan.explain_lines())]
            rows.append(("(total)", "", f"{wall * 1e3:.1f}ms", ""))
            return ResultSet(["id", "estRows", "actual", "info"],
                             [T.varchar()] * 4, rows)
        rows = list(plan.explain_lines())
        return ResultSet(["id", "estRows", "info"], [T.varchar()] * 3, rows)

    def _set(self, stmt: ast.SetStmt) -> ResultSet:
        """SET [GLOBAL] var = value. GLOBAL scope persists engine-wide
        (ref: sessionctx/variable — global vars stored in
        mysql.global_variables and inherited by new sessions); session
        scope stays connection-local."""
        from tidb_tpu_torch.expression import Constant
        from tidb_tpu_torch.planner.rules import fold_expr
        rw = ExpressionRewriter(Schema([]))
        for name, expr in stmt.assignments:
            folded = fold_expr(rw.rewrite(expr))
            value = folded.value if isinstance(folded, Constant) else None
            key = name.lower().lstrip("@")
            if stmt.global_scope and not name.startswith("@"):
                if not self.engine.auth.is_superuser(self.user):
                    from tidb_tpu_torch.session.auth import PrivilegeError
                    raise PrivilegeError(
                        "SET GLOBAL requires ALL on *.*")
                with self.engine.stats_lock:
                    self.engine.global_vars[key] = value
                # GLOBAL scope affects only NEW sessions (MySQL scoping);
                # the current session keeps its value
            else:
                self.vars[key] = value
        return ok()

    def _show(self, stmt: ast.ShowStmt) -> ResultSet:
        info_schema = self.engine.catalog.info_schema
        if stmt.kind == "grants":
            target = stmt.target or self.user
            if target.lower() != self.user.lower() and \
                    not self.engine.auth.has_global(self.user, "SUPER"):
                from tidb_tpu_torch.errors import SpecificAccessDeniedError
                raise SpecificAccessDeniedError(
                    "Access denied; you need (at least one of) the "
                    "SUPER privilege(s) for this operation")
            rows = self.engine.auth.show_grants(target)
            return ResultSet([f"Grants for {target}@%"], [T.varchar()],
                             rows)
        if stmt.kind == "databases":
            return ResultSet(["Database"], [T.varchar()],
                             [("test",), ("information_schema",),
                              ("mysql",)])
        if stmt.kind == "collation":
            from tidb_tpu_torch.types import BIN_COLLATIONS, CI_COLLATIONS
            names = sorted((set(CI_COLLATIONS) | set(BIN_COLLATIONS))
                           - {"binary"})
            rows = [(c, c.split("_")[0], i + 1,
                     "Yes" if c == "utf8mb4_bin" else "",
                     "Yes", 1)
                    for i, c in enumerate(names)]
            return ResultSet(
                ["Collation", "Charset", "Id", "Default", "Compiled",
                 "Sortlen"],
                [T.varchar(), T.varchar(), T.bigint(), T.varchar(),
                 T.varchar(), T.bigint()], rows)
        if stmt.kind == "charset":
            return ResultSet(
                ["Charset", "Description", "Default collation", "Maxlen"],
                [T.varchar()] * 3 + [T.bigint()],
                [("utf8mb4", "UTF-8 Unicode", "utf8mb4_bin", 4)])
        if stmt.kind == "tables":
            rows = [(t.name,) for t in info_schema.list_tables()
                    if not t.name.startswith("#")]   # hide CTE temps
            rows += [(v.name,) for v in info_schema.list_views()]
            rows.sort()
            return ResultSet(["Tables"], [T.varchar()], rows)
        if stmt.kind == "columns":
            t = info_schema.table(stmt.target)
            rows = [(c.name, str(c.ftype),
                     "YES" if c.ftype.nullable else "NO",
                     "PRI" if c.primary_key else "",
                     None if not c.has_default else str(c.default))
                    for c in t.columns]
            return ResultSet(["Field", "Type", "Null", "Key", "Default"],
                             [T.varchar()] * 5, rows)
        if stmt.kind == "index":
            t = info_schema.table(stmt.target)
            rows = []
            if t.primary_key:
                for seq, c in enumerate(t.primary_key, 1):
                    rows.append((t.name, 0, "PRIMARY", seq, c, "BTREE",
                                 "public"))
            for ix in t.indexes:
                for seq, c in enumerate(ix.columns, 1):
                    rows.append((t.name, 0 if ix.unique else 1, ix.name,
                                 seq, c, "BTREE",
                                 getattr(ix, "state", "public")))
            return ResultSet(
                ["Table", "Non_unique", "Key_name", "Seq_in_index",
                 "Column_name", "Index_type", "State"],
                [T.varchar(), T.bigint(), T.varchar(), T.bigint(),
                 T.varchar(), T.varchar(), T.varchar()], rows)
        if stmt.kind == "variables":
            rows = sorted((k, str(v)) for k, v in self.vars.items())
            return ResultSet(["Variable_name", "Value"],
                             [T.varchar(), T.varchar()], rows)
        if stmt.kind == "create_view":
            v = info_schema.view(stmt.target)
            if v is None:
                raise UnknownTableError(f"Unknown view '{stmt.target}'")
            cols = f" ({', '.join(v.columns)})" if v.columns else ""
            ddl = f"CREATE VIEW `{v.name}`{cols} AS {v.sql}"
            return ResultSet(["View", "Create View"], [T.varchar()] * 2,
                             [(v.name, ddl)])
        if stmt.kind == "create_table":
            t = info_schema.table(stmt.target)
            from tidb_tpu_torch.tools import create_table_sql
            return ResultSet(["Table", "Create Table"],
                             [T.varchar(), T.varchar()],
                             [(t.name, create_table_sql(t))])
        from tidb_tpu_torch.util.observability import REGISTRY
        if stmt.kind == "metrics":
            return ResultSet(["Metric", "Labels", "Value"],
                             [T.varchar(), T.varchar(), T.double()],
                             REGISTRY.metric_rows())
        if stmt.kind == "slow_queries":
            return ResultSet(
                ["Time", "Duration_s", "Rows", "Engine", "Query"],
                [T.varchar(), T.double(), T.bigint(), T.varchar(),
                 T.varchar()], REGISTRY.slow_rows())
        if stmt.kind == "statement_summary":
            return ResultSet(
                ["Digest", "Count", "Sum_s", "Avg_s", "Max_s", "Rows"],
                [T.varchar(), T.bigint(), T.double(), T.double(),
                 T.double(), T.bigint()], REGISTRY.summary_rows())
        if stmt.kind == "warnings":
            # diagnostics of the LAST non-diagnostic statement — SHOW
            # WARNINGS itself must not clear what it reports (MySQL's
            # diagnostics-area statement classes)
            return ResultSet(["Level", "Code", "Message"],
                             [T.varchar(), T.bigint(), T.varchar()],
                             list(self.warnings))
        if stmt.kind == "processlist":
            # every live connection, not only those mid-statement —
            # otherwise KILL <id> can't target an idle session. Without
            # the global PROCESS privilege a user sees only their own
            # threads (sql/sql_show.cc mysqld_list_processes)
            from tidb_tpu_torch.util.guard import PROCESS_REGISTRY
            see_all = self.engine.auth.has_global(self.user, "PROCESS")
            rows = []
            for cid, user, guard, killed in PROCESS_REGISTRY.snapshot():
                if not see_all and user not in (None, self.user):
                    continue
                if guard is not None:
                    rows.append((cid, user or "", "Query",
                                 round(guard.elapsed(), 3), guard.sql))
                else:
                    rows.append((cid, user or "",
                                 "Killed" if killed else "Sleep",
                                 0.0, None))
            rows.sort()
            return ResultSet(
                ["Id", "User", "Command", "Time_s", "Info"],
                [T.bigint(), T.varchar(), T.varchar(), T.double(),
                 T.varchar()], rows)
        raise PlanError(f"unsupported SHOW {stmt.kind}")

    def _alter_table(self, stmt: ast.AlterTable) -> ResultSet:
        """Online-ish schema change (ref: ddl/column.go): ADD COLUMN is
        lazy (regions surface the default at read time via
        align_chunk_to_schema); DROP COLUMN rewrites storage eagerly
        because regions hold positional layouts."""
        cat = self.engine.catalog
        info0 = cat.info_schema.table(stmt.table)
        if info0.partition is not None and stmt.action in ("add_column",
                                                          "drop_column"):
            # column offsets anchor the partition function and region
            # layouts carry colocation tags; rewriting both online is
            # out of scope (the reference also restricts many ALTERs on
            # partitioned tables, ddl/ddl_api.go)
            raise DDLError("Unsupported ALTER on a partitioned table",
                           code=8200)
        if stmt.action == "add_column":
            c = stmt.column
            default = None
            has_default = False
            if c.default is not None:
                from tidb_tpu_torch.expression import Constant
                from tidb_tpu_torch.planner.rules import fold_expr
                rw = ExpressionRewriter(Schema([]))
                folded = fold_expr(rw.rewrite(c.default))
                if not isinstance(folded, Constant):
                    raise PlanError("DEFAULT must fold to a constant")
                default = folded.value
                has_default = True
            cat.add_column(stmt.table, ColumnInfo(
                c.name, c.ftype.with_nullable(True), default=default,
                has_default=has_default))
            return ok()
        if stmt.action == "drop_column":
            info = cat.info_schema.table(stmt.table)
            drop_idx = next((i for i, c in enumerate(info.columns)
                             if c.name.lower() ==
                             stmt.column_name.lower()), None)
            if drop_idx is None:
                raise UnknownColumnError(
                    f"Unknown column '{stmt.column_name}' in "
                    f"'{stmt.table}'")
            cat.drop_column(stmt.table, stmt.column_name)
            # eager storage rewrite minus the dropped column
            from tidb_tpu_torch.executor.scan import align_chunk_to_schema
            snap = self.engine.store.snapshot()
            if snap.has_table(info.id):
                keep_cols = [i for i in range(len(info.columns))
                             if i != drop_idx]
                chunks = []
                for region, alive in snap.scan(info.id):
                    ch = align_chunk_to_schema(region.chunk, info)
                    if not alive.all():
                        ch = ch.take(np.nonzero(alive)[0])
                    chunks.append(Chunk([ch.columns[i]
                                         for i in keep_cols]))
                self.engine.store.truncate_table(info.id)
                for ch in chunks:
                    if ch.num_rows:
                        self.engine.store.append(info.id, ch)
            return ok()
        if stmt.action == "rename":
            cat.rename_table(stmt.table, stmt.new_name)
            return ok()
        if stmt.action in ("add_partition", "drop_partition",
                           "truncate_partition"):
            return self._alter_partition(stmt, info0)
        raise PlanError(f"unsupported ALTER action {stmt.action}")

    def _alter_partition(self, stmt: ast.AlterTable,
                         info: TableInfo) -> ResultSet:
        """ADD/DROP/TRUNCATE PARTITION (ref: ddl/partition.go
        onAddTablePartition / onDropTablePartition; storage side is a
        wholesale region-set operation — the partition IS its regions)."""
        from dataclasses import replace as d_replace
        p = info.partition
        if p is None:
            raise DDLError("Partition management on a not partitioned "
                           "table", code=1505)
        if stmt.action == "add_partition":
            if p.kind != "range":
                raise DDLError("ADD PARTITION is for RANGE partitioning",
                               code=1492)
            d = stmt.partition_def
            if d.name.lower() in (n.lower() for n in p.names):
                raise DDLError(f"Duplicate partition name {d.name}",
                               code=1517)
            if p.bounds and p.bounds[-1] is None:
                raise DDLError(
                    "MAXVALUE can only be used in last partition "
                    "definition", code=1481)
            enc = self._encode_partition_bound(
                info.columns[p.col_offset].ftype, d.less_than)
            if enc is not None and p.bounds \
                    and p.bounds[-1] is not None and enc <= p.bounds[-1]:
                raise DDLError(
                    "VALUES LESS THAN value must be strictly "
                    "increasing for each partition", code=1493)
            new_p = d_replace(p, names=p.names + (d.name,),
                              bounds=p.bounds + (enc,))
            self.engine.catalog.set_partition(info.name, new_p)
            return ok()
        # DROP / TRUNCATE need the ordinal
        try:
            ordinal = next(i for i, n in enumerate(p.names)
                           if n.lower() == stmt.partition_name.lower())
        except StopIteration:
            raise DDLError(f"Unknown partition "
                           f"'{stmt.partition_name}'", code=1735)
        if stmt.action == "truncate_partition":
            n = self.engine.store.drop_partition_rows(info.id, ordinal)
            self.engine.note_modified(info.id, n)
            return ok(n)
        if p.kind != "range":
            raise DDLError("DROP PARTITION is for RANGE partitioning",
                           code=1512)
        if p.n_parts == 1:
            raise DDLError("Cannot remove all partitions", code=1508)
        remap = {i: (i - 1 if i > ordinal else i)
                 for i in range(p.n_parts) if i != ordinal}
        n = self.engine.store.drop_partition_rows(info.id, ordinal, remap)
        new_p = d_replace(
            p,
            names=tuple(x for i, x in enumerate(p.names) if i != ordinal),
            bounds=tuple(x for i, x in enumerate(p.bounds)
                         if i != ordinal))
        self.engine.catalog.set_partition(info.name, new_p)
        self.engine.note_modified(info.id, n)
        return ok(n)

    # ---- WITH / CTE (ref: executor/cte.go — materialized CTE storage) ----
    _cte_seq = itertools.count(1)
    MAX_CTE_RECURSION = 1000     # cte_max_recursion_depth default

    def _run_with(self, stmt: ast.WithStmt) -> ResultSet:
        """Materialize each CTE into a hidden temp table (multiple
        references share one materialization, the reference's cteutil
        storage reuse), then run the main statement with references
        remapped. Recursive CTEs iterate seed + recursive term over the
        delta until fixpoint (MySQL WITH RECURSIVE semantics)."""
        outer_map = dict(getattr(self, "_cte_map", {}) or {})
        created: List[str] = []
        try:
            for cte in stmt.ctes:
                tmp = f"#cte_{next(Session._cte_seq)}"
                if stmt.recursive and _references_table(cte.select,
                                                        cte.name):
                    self._materialize_recursive(cte, tmp, created)
                else:
                    plan, chunks = self._run_query_chunks(cte.select)
                    cnames = cte.columns or plan.schema.names
                    self._create_temp(tmp, cnames,
                                      plan.schema.field_types, None,
                                      created, chunks=chunks)
                self._cte_map = dict(self._cte_map or {})
                self._cte_map[cte.name.lower()] = tmp
            return self._execute_stmt(stmt.stmt)
        finally:
            self._cte_map = outer_map
            for name in created:
                info = self.engine.catalog.drop_table(name, if_exists=True)
                if info is not None:
                    self.engine.store.drop_table(info.id)

    def _run_cte_select(self, sel):
        plan, chunks = self._run_query_chunks(sel)
        rows: List[tuple] = []
        for ch in chunks:
            rows.extend(ch.rows())
        return rows, plan.schema.field_types, plan.schema.names

    def _create_temp(self, name, cnames, ftypes, rows, created,
                     chunks=None):
        cols = [ColumnInfo(n or f"c{i}", ft.with_nullable(True))
                for i, (n, ft) in enumerate(zip(cnames, ftypes))]
        self.engine.catalog.create_table(name, cols)
        info = self.engine.catalog.info_schema.table(name)
        self.engine.store.create_table(info.id)
        created.append(name)
        if chunks is not None:
            # columnar handoff: result chunks append directly, no per-row
            # python round trip (the cteutil storage-reuse spirit)
            for ch in chunks:
                if ch.num_rows:
                    self.engine.store.append(info.id, ch)
        elif rows:
            self._append_rows(info, rows)
        return info

    def _append_rows(self, info, rows):
        from tidb_tpu_torch.chunk import Chunk
        encoded = []
        for r in rows:
            encoded.append(tuple(
                c.ftype.encode_value(v) if v is not None else None
                for c, v in zip(info.columns, r)))
        chunk = Chunk.from_rows(info.field_types, encoded)
        txn = self.engine.store.begin()
        txn.append(info.id, chunk)
        txn.commit()

    def _materialize_recursive(self, cte, tmp, created):
        if not isinstance(cte.select, ast.SetOpStmt) or \
                cte.select.op != "union":
            raise PlanError(
                "recursive CTE must be <seed> UNION [ALL] <recursive>")
        seed_stmt, rec_stmt = cte.select.left, cte.select.right
        distinct = not cte.select.all
        rows, ftypes, names = self._run_cte_select(seed_stmt)
        cnames = cte.columns or names
        if distinct:
            rows = list(dict.fromkeys(map(tuple, rows)))
        info = self._create_temp(tmp, cnames, ftypes, rows, created)
        seen = set(map(tuple, rows)) if distinct else None
        delta = rows
        delta_tmp = f"#cte_delta_{next(Session._cte_seq)}"
        self._create_temp(delta_tmp, cnames, ftypes, delta, created)
        dinfo = self.engine.catalog.info_schema.table(delta_tmp)
        it = 0
        saved = dict(self._cte_map or {})
        try:
            while delta:
                it += 1
                if it > self.MAX_CTE_RECURSION:
                    raise ExecutionError(
                        "Recursive query aborted after "
                        f"{self.MAX_CTE_RECURSION} iterations")
                # the recursive term sees only the previous delta (MySQL)
                self._cte_map = dict(saved)
                self._cte_map[cte.name.lower()] = delta_tmp
                new_rows, _, _ = self._run_cte_select(rec_stmt)
                new_rows = [tuple(r) for r in new_rows]
                if distinct:
                    new_rows = [r for r in dict.fromkeys(new_rows)
                                if r not in seen]
                    seen.update(new_rows)
                if not new_rows:
                    break
                self._append_rows(info, new_rows)
                self.engine.store.truncate_table(dinfo.id)
                self._append_rows(dinfo, new_rows)
                delta = new_rows
        finally:
            self._cte_map = saved

    def _analyze(self, stmt: ast.AnalyzeTable) -> ResultSet:
        """Build per-column histogram/NDV/TopN stats (ref:
        executor/analyze.go → statistics/histogram.go:49)."""
        from tidb_tpu_torch.executor.scan import align_chunk_to_schema
        from tidb_tpu_torch.statistics import analyze_columns
        # counts pending BEFORE the snapshot are certainly covered by it;
        # later-arriving counts must survive the subtraction (the
        # background worker races concurrent writers — the reference
        # subtracts, statistics/handle/update.go)
        with self.engine.stats_lock:
            pending0 = dict(self.engine.modify_counts)
        snap = self._read_view_snapshot()
        for name in stmt.names:
            info = self.engine.catalog.info_schema.table(name)
            if not snap.has_table(info.id):
                continue
            covered = pending0.get(info.id, 0)
            parts = []
            for region, alive in snap.scan(info.id):
                chunk = align_chunk_to_schema(region.chunk, info)
                mask = None if alive.all() else alive
                parts.append((chunk, mask))
            n_cols = len(info.columns)
            cols = []
            for ci in range(n_cols):
                vs, ms = [], []
                for chunk, mask in parts:
                    col = chunk.columns[ci]
                    v, m = col.values, col.valid_mask()
                    if mask is not None:
                        v, m = v[mask], m[mask]
                    vs.append(v)
                    ms.append(m)
                if vs:
                    cols.append((np.concatenate(vs), np.concatenate(ms)))
                else:
                    cols.append((np.empty(0), np.empty(0, dtype=bool)))
            total = len(cols[0][0]) if cols else 0
            ts = analyze_columns(cols, total)
            with self.engine.stats_lock:
                ts.version = snap.version   # version of the analyzed data
                self.engine.table_stats[info.id] = ts
                self.engine.stats_version += 1
                left = self.engine.modify_counts.get(info.id, 0) - covered
                if left > 0:
                    self.engine.modify_counts[info.id] = left
                else:
                    self.engine.modify_counts.pop(info.id, None)
        return ok()


def _actual(exec_root, flat_index: int) -> str:
    nodes = []

    def walk(e):
        nodes.append(e)
        for c in getattr(e, "children", []):
            walk(c)
    walk(exec_root)
    if flat_index < len(nodes):
        node = nodes[flat_index]
        s = node.stats
        extra = ""
        info_fn = getattr(node, "runtime_info", None)
        if info_fn is not None:
            ri = info_fn()
            if ri:
                extra = " " + ri
        return f"rows:{s.rows} time:{s.wall_ns / 1e6:.1f}ms{extra}"
    return ""


def _check_not_null(rows, info: TableInfo):
    """INSERT rows: auto-inc NULLs mean 'allocate' and pass."""
    from tidb_tpu_torch.errors import NotNullViolation
    for r in rows:
        for v, c in zip(r, info.columns):
            if v is None and not c.ftype.nullable \
                    and not c.auto_increment:
                raise NotNullViolation(f"Column '{c.name}' cannot be null")


def _check_not_null_chunk(chunk: Chunk, info: TableInfo,
                          allow_auto_inc: bool = False):
    """allow_auto_inc: INSERT paths only — a NULL there means 'allocate'
    (_fill_auto_increment backfills). UPDATE keeps the NOT NULL
    invariant for auto-inc columns too."""
    from tidb_tpu_torch.errors import NotNullViolation
    for col, c in zip(chunk.columns, info.columns):
        if not c.ftype.nullable \
                and not (allow_auto_inc and c.auto_increment) \
                and col.validity is not None \
                and not col.validity.all():
            raise NotNullViolation(f"Column '{c.name}' cannot be null")


def _validate_insert_columns(columns: Optional[List[str]],
                             info: TableInfo) -> List[str]:
    if columns is None:
        return [c.name for c in info.columns]
    seen = set()
    for n in columns:
        info.column(n)  # raises UnknownColumnError for unknown names
        if n.lower() in seen:
            raise PlanError(f"Column '{n}' specified twice")
        seen.add(n.lower())
    return list(columns)


def _assemble_rows(rows: List[List], info: TableInfo,
                   names: List[str]) -> List[List]:
    """Map value rows (ordered by `names`) onto full table-column order,
    filling defaults/NULLs for unmentioned columns."""
    name_to_pos = {n.lower(): i for i, n in enumerate(names)}
    out_rows = []
    for r in rows:
        row = []
        for c in info.columns:
            pos = name_to_pos.get(c.name.lower())
            if pos is not None:
                row.append(r[pos])
            elif c.has_default:
                row.append(c.default)
            elif c.ftype.nullable or c.auto_increment:
                row.append(None)      # auto-inc NULLs are assigned later
            else:
                raise ExecutionError(
                    f"Field '{c.name}' doesn't have a default value")
        out_rows.append(row)
    return out_rows


def _references_table(node, name: str) -> bool:
    lname = name.lower()

    def walk(n) -> bool:
        if isinstance(n, ast.TableName):
            return n.name.lower() == lname
        for attr in ("from_", "left", "right", "stmt", "select",
                     "subquery", "expr"):
            v = getattr(n, attr, None)
            if isinstance(v, (ast.Node,)) and walk(v):
                return True
        for attr in ("items", "ctes"):
            v = getattr(n, attr, None)
            if isinstance(v, list):
                for x in v:
                    if isinstance(x, ast.Node) and walk(x):
                        return True
        return False

    return walk(node)


def _key_tuples(chunk: Chunk, idxs: List[int]):
    """Per-row unique-key tuples; None when any component is NULL (NULL
    never participates in unique conflicts, MySQL semantics). ci-collated
    columns fold, so 'abc' and 'ABC' conflict like MySQL."""
    from tidb_tpu_torch.types import collation_fold_array
    cols = [(collation_fold_array(chunk.columns[i].ftype,
                                  chunk.columns[i].values)
             if chunk.columns[i].ftype.is_ci
             else chunk.columns[i].values,
             chunk.columns[i].valid_mask())
            for i in idxs]
    out = []
    for ri in range(chunk.num_rows):
        parts = []
        null = False
        for v, m in cols:
            if not m[ri]:
                null = True
                break
            parts.append(v[ri])
        out.append(None if null else tuple(parts))
    return out


def _used_device(exec_root) -> bool:
    from tidb_tpu_torch.executor.fragment import TpuFragmentExec

    def walk(e):
        if isinstance(e, TpuFragmentExec) and e.used_device:
            return True
        return any(walk(c) for c in getattr(e, "children", []))

    return walk(exec_root)

"""Query lifecycle guardrails: per-statement ExecutionGuard + the global
process-info registry behind SHOW PROCESSLIST / KILL (ref:
util/sqlkiller/sqlkiller.go + infosync/ProcessInfo + server's
killConn path, collapsed to one module).

The reference interrupts queries cooperatively: every executor Next loop
polls an atomic kill flag, and `max_execution_time` arms an expire timer
that sets the same flag. Here both live on one ExecutionGuard:

  * kill flag  — flipped by KILL [QUERY] <id> from ANY session/thread;
  * deadline   — monotonic, armed from the max_execution_time sysvar;
  * mem_tracker— the statement's root memory Tracker, so the OOM action
    chain and the kill path cancel through the same typed errors;
  * checkpoints— per-site hit counters (observability + test assertions:
    "the scan actually polled the flag 37 times").

check() is the single checkpoint primitive, called at every chunk
boundary (executor child_next / run_to_completion), before and after
device dispatch and host fetch (fragment.py), inside spill loops
(util/memory.py) and backoff sleeps (util/backoff.py). It raises typed
QueryInterrupted / QueryTimeout which unwind through the device-fallback
ladder WITHOUT being swallowed into a CPU retry.

PROCESS_REGISTRY maps conn_id → live session entry. Sessions register at
construction (weakref-finalized, so dropped sessions self-deregister)
and publish their current guard per statement. KILL QUERY flips the
active guard's flag; bare KILL also marks the connection dead — its next
statement refuses to run and the wire server closes the socket.
"""

from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

from tidb_tpu_torch.errors import QueryInterrupted, QueryTimeout


class ExecutionGuard:
    """Kill flag + deadline + root memory tracker for ONE statement."""

    __slots__ = ("conn_id", "sql", "started", "deadline", "mem_tracker",
                 "checkpoints", "_killed", "escalation", "warnings",
                 "queue_wait_s", "queue_waits", "phases",
                 "sched_class", "sched_cost", "sched_tables",
                 "device_index", "sched_steal_ok", "sched_admitted",
                 "sched_steals", "sched_migrated")

    def __init__(self, conn_id: int = 0, sql: str = "",
                 timeout_s: float = 0.0, mem_tracker=None):
        from tidb_tpu_torch.util.escalation import EscalationStats
        from tidb_tpu_torch.util.phases import PhaseTimer
        self.conn_id = conn_id
        self.sql = sql
        # per-statement capacity-escalation counters (util/escalation.py),
        # read back by information_schema.processlist
        self.escalation = EscalationStats()
        # the statement's attribution ledger (util/phases.py): phase
        # seconds, h2d/d2h/scan bytes, compile count — every ExecContext
        # of this statement shares it, and record_stmt folds it into the
        # digest profile at statement end
        self.phases = PhaseTimer(conn_id)
        self.started = time.monotonic()
        self.deadline = (self.started + timeout_s
                         if timeout_s and timeout_s > 0 else None)
        self.mem_tracker = mem_tracker
        if mem_tracker is not None:
            # the tracker's root checks the guard on every consume, so
            # memory-heavy loops hit checkpoints even between chunks
            mem_tracker.guard = self
        self.checkpoints: Dict[str, int] = {}
        self._killed = False
        # device-scheduler admission accounting (executor/scheduler.py):
        # total seconds this statement spent queued for the device slot
        # and how many admissions actually waited — surfaced through
        # information_schema.processlist and EXPLAIN ANALYZE
        self.queue_wait_s = 0.0
        self.queue_waits = 0
        # admission classification (executor/scheduler.py priority
        # queues): "interactive" | "batch" | None (classification off),
        # plus the digest's historical device-seconds cost hint
        self.sched_class: Optional[str] = None
        self.sched_cost: Optional[float] = None
        # pod-scale placement (executor/scheduler.py SchedulerPool):
        # tables the digest historically touched (admission handoff),
        # the device index the statement is pinned to (stamped once by
        # place_statement/admit_statement), steal eligibility (False
        # when the working set is pod-partitioned), the admission-
        # turnstile latch, and how many times this statement migrated
        self.sched_tables: Optional[list] = None
        self.device_index: Optional[int] = None
        self.sched_steal_ok = True
        self.sched_admitted = False
        self.sched_steals = 0
        # how many times this statement was migrated OFF a lost device
        # (quarantine retry) — distinct from work-steal migrations
        self.sched_migrated = 0
        # (level, code, message) rows the statement accumulated — e.g.
        # a degraded-mesh completion — read back by SHOW WARNINGS
        self.warnings: list = []

    @property
    def killed(self) -> bool:
        return self._killed

    def kill(self) -> None:
        self._killed = True

    def elapsed(self) -> float:
        return time.monotonic() - self.started

    def hits(self, site: str) -> int:
        return self.checkpoints.get(site, 0)

    def check(self, site: str = "next") -> None:
        """One cooperative checkpoint: count the visit, then raise if the
        statement was killed or its deadline passed."""
        self.checkpoints[site] = self.checkpoints.get(site, 0) + 1
        if self._killed:
            raise QueryInterrupted("Query execution was interrupted")
        if self.deadline is not None and time.monotonic() >= self.deadline:
            raise QueryTimeout(
                "Query execution was interrupted, maximum statement "
                "execution time exceeded")


class ProcessRegistry:
    """conn_id → {session weakref, active guard, conn_killed} — the
    process-info table KILL and SHOW PROCESSLIST resolve against."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: Dict[int, dict] = {}
        self._dropped: List[int] = []

    @contextmanager
    def _locked(self):
        """Hold _lock, first removing the entries of collected sessions."""
        with self._lock:
            while self._dropped:
                self._conns.pop(self._dropped.pop(), None)
            yield

    def register(self, session) -> None:
        cid = session.conn_id
        with self._locked():
            self._conns[cid] = {"session": weakref.ref(session),
                                "guard": None, "conn_killed": False}
        weakref.finalize(session, self._drop, cid)

    def _drop(self, cid: int) -> None:
        """Finalizer of a collected session. It can run inside a garbage
        collection that this very thread started while holding _lock (a
        Lock is not re-entrant, so taking it here would hang the thread),
        so it only queues the id: list.append is atomic, and the next
        locked call removes the entry."""
        self._dropped.append(cid)

    def stmt_begin(self, cid: int, guard: ExecutionGuard) -> None:
        with self._locked():
            ent = self._conns.get(cid)
            if ent is None:
                return
            if ent["conn_killed"]:
                guard.kill()          # dead connection: die at checkpoint 1
            ent["guard"] = guard

    def stmt_end(self, cid: int) -> None:
        with self._locked():
            ent = self._conns.get(cid)
            if ent is not None:
                ent["guard"] = None

    def info(self, cid: int) -> Optional[dict]:
        with self._locked():
            ent = self._conns.get(cid)
            if ent is None:
                return None
            sess = ent["session"]()
            return {"session": sess,
                    "user": getattr(sess, "user", None),
                    "guard": ent["guard"],
                    "conn_killed": ent["conn_killed"]}

    def kill(self, cid: int, query_only: bool = True) -> bool:
        """KILL [QUERY] <cid>: flip the active guard's flag (if a
        statement is running) and, for a connection kill, poison the
        entry so future statements refuse to start. → found?"""
        with self._locked():
            ent = self._conns.get(cid)
            if ent is None:
                return False
            if not query_only:
                ent["conn_killed"] = True
            guard = ent["guard"]
        if guard is not None:
            guard.kill()
        return True

    def snapshot(self) -> list:
        """Every live connection, running or idle, for SHOW PROCESSLIST:
        (conn_id, user, guard|None, conn_killed)."""
        with self._locked():
            items = list(self._conns.items())
        out = []
        for cid, ent in items:
            sess = ent["session"]()
            if sess is None:
                continue
            out.append((cid, getattr(sess, "user", None), ent["guard"],
                        ent["conn_killed"]))
        return out

    def conn_killed(self, cid: int) -> bool:
        with self._locked():
            ent = self._conns.get(cid)
            return bool(ent and ent["conn_killed"])


PROCESS_REGISTRY = ProcessRegistry()

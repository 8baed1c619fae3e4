"""Same-plan micro-batching: N queued statements, ONE launch per slab.

A burst of point reads / prepared executes sharing a plan shape would
pay N separate dispatches through the device scheduler. Statements whose
fragment program is the same except for their comparison literals
(executor/fragment.py lifts those into ParamExpr parameters) run as one
program with the parameters stacked along a leading member axis.

Protocol (rendezvous while queued, not a background batcher thread):

  1. A dispatcher arriving at the device with a batchable fragment looks
     up its batch key — (digest, value-free chain signature [which pins
     the SQL shape + layout set + geometry], table version, zone-map
     survivor set). First arrival registers an OPEN batch and becomes
     the LEADER; it then queues for the device slot normally (keeping
     the KILL-while-queued guard polling).
  2. Later same-key dispatchers join as FOLLOWERS — up to
     `tidb_tpu_microbatch_max - 1` of them — parking on a per-member
     event instead of the scheduler queue. They poll their guard every
     POLL_S, so KILL / deadline land while parked: a WAITING member
     leaves the batch and raises its typed error alone.
  3. When the leader is granted the slot it CLOSES the batch and claims
     the compatible members: the prepared inputs must match in structure
     and, but for the ParamExpr values that are stacked, in value (a
     dictionary table, a string comparison's ranks); the others are
     demoted to individual execution. It runs the batched program
     (device_emit.emit_batched) once per surviving slab, then K22
     member_compact turns the [B, cap] live mask into member-major row
     ids and K18 gathers every output column through them, so only live
     rows cross to the host, in one fetch.
  4. Results de-multiplex by the members' offsets on the host: every
     member gets its own Chunk and its event is set. A member killed
     mid-dispatch raises its own typed error; its rows are never read.

Where the JAX package's batch degrades, and where this one does: the
reference turns ANY fault of the batched launch or of demux into warned
individual re-execution. Here a device, kernel or launch error raises to
the leader (a fallback would hide a kernel fault), and its followers
rerun on the card's individual path. Only the `microbatch-demux` fault
(the failpoint, or a fault of the host demux it models) degrades to
warned individual re-execution of every member, on the card.

There is no power-of-two padding of the member count: the reference pads
to bound XLA compiles; this port runs eagerly.

A solo leader (no followers by grant time) returns to the individual
path untouched — the individual path is the exactness oracle.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from tidb_tpu_torch.util import failpoint
from tidb_tpu_torch.util.observability import REGISTRY, normalize_sql

# follower guard-poll cadence while parked on the batch event
POLL_S = 0.02

_LOCK = threading.Lock()
_BATCHES: Dict[tuple, "_Batch"] = {}


class _Member:
    __slots__ = ("event", "guard", "conn_id", "prep_vals", "claimed",
                 "result", "fallback")

    def __init__(self, guard, conn_id: int, prep_vals):
        self.event = threading.Event()
        self.guard = guard
        self.conn_id = conn_id
        self.prep_vals = prep_vals
        self.claimed = False       # leader took this member at grant time
        self.result = None         # Chunk, set by the leader
        self.fallback = False      # woken for individual re-execution


class _Batch:
    __slots__ = ("key", "members", "closed")

    def __init__(self, key):
        self.key = key
        self.members: List[_Member] = []
        self.closed = False


def queued_members() -> int:
    """Followers currently parked on open batches (test/ bench probe)."""
    with _LOCK:
        return sum(len(b.members) for b in _BATCHES.values()
                   if not b.closed)


def batch_key(guard, sig: str, ent, slab_ids) -> tuple:
    """(digest, value-free signature, table + delta version, survivor
    slabs). The signature already pins the chain shape, column types,
    layout set, slab geometry and device; `id(ent.td)` is the
    table-version token and `delta_version` the store's commit version
    the entry serves (id() alone is an ABA hazard: a delta extension
    installs a NEW entry whose TableData id may be recycled), so a write
    landing between rendezvous and launch never serves stale rows to the
    batch. The zone-map survivor set must match because members share
    one launch per surviving slab."""
    digest = normalize_sql(getattr(guard, "sql", "") or "")
    return (digest, sig, id(ent.td), getattr(ent, "delta_version", 0),
            tuple(slab_ids))


def execute(exec_, prog, root, ent, dicts, prep_vals, slab_ids, sig,
            mb_max: int):
    """Try to serve this statement through a micro-batch. `prep_vals` is
    this statement's host preparation (collect_chain_preps). → Chunk, or
    None when the caller must run the individual path (solo batch,
    demotion, or a demux fault)."""
    ctx = exec_.ctx
    guard = getattr(ctx, "guard", None)
    conn_id = getattr(guard, "conn_id", 0) if guard is not None else 0
    key = batch_key(guard, sig, ent, slab_ids)

    with _LOCK:
        b = _BATCHES.get(key)
        if b is not None and not b.closed and len(b.members) < mb_max - 1:
            m = _Member(guard, conn_id, prep_vals)
            b.members.append(m)
            joined = b
        else:
            joined = None
            mine = _Batch(key)
            _BATCHES[key] = mine     # replaces a closed/full batch

    if joined is not None:
        return _follow(joined, m, guard)

    try:
        return _lead(exec_, mine, prog, root, ent, dicts, prep_vals,
                     slab_ids, sig)
    except BaseException:
        _abort(mine)
        raise


# ---------------------------------------------------------------------------
# follower side
# ---------------------------------------------------------------------------

def _follow(batch: _Batch, m: _Member, guard) -> Optional[object]:
    """Park on the member event; KILL/deadline isolation via guard
    polling. → the demuxed Chunk, or None for individual fallback."""
    t0 = time.monotonic()
    while not m.event.wait(POLL_S):
        if guard is None:
            continue
        try:
            guard.check("microbatch-wait")
        except BaseException:
            with _LOCK:
                if not m.claimed and m in batch.members:
                    # still WAITING: leave the batch; only THIS member
                    # surfaces the typed error
                    batch.members.remove(m)
            # claimed members raise too — the leader's lane for them
            # computes rows nobody reads; isolation is the point
            raise
    waited = time.monotonic() - t0
    if guard is not None and waited > 0.0:
        # parked time is queue time: same ledger the scheduler charges
        guard.queue_wait_s += waited
        guard.queue_waits += 1
    if m.fallback or m.result is None:
        return None
    return m.result


# ---------------------------------------------------------------------------
# leader side
# ---------------------------------------------------------------------------

def _abort(batch: _Batch, fallback: bool = True) -> None:
    """Wake every member for individual re-execution and retire the
    batch key. Never raises."""
    with _LOCK:
        if _BATCHES.get(batch.key) is batch:
            del _BATCHES[batch.key]
        batch.closed = True
        members = list(batch.members)
    for m in members:
        m.fallback = fallback
        m.event.set()


def _leaves(tree) -> List[object]:
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _structure(tree):
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return None


def _structure_matches(ref_pv, pv, stacked) -> bool:
    """Two statements' host preparations (lists of numpy arrays, scalars
    and tuples of them) batch together: the same structure, every leaf of
    the same shape and dtype, and the same value except at the stacked
    (ParamExpr) positions."""
    if len(ref_pv) != len(pv):
        return False
    for k, (a, b) in enumerate(zip(ref_pv, pv)):
        if _structure(a) != _structure(b):
            return False
        for x, y in zip(_leaves(a), _leaves(b)):
            if (x is None) != (y is None):
                return False
            if x is None:
                continue
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape or x.dtype != y.dtype:
                return False
            if k not in stacked and not np.array_equal(x, y):
                return False
    return True


def _stack_preps(prog, all_pvs, stacked):
    """The batched program's prepared inputs: each ParamExpr position the
    members' values stacked into one [B] tensor, every other position the
    leader's own upload."""
    from tidb_tpu_torch.ops.xp import to_device_tree
    out = []
    for k, v in enumerate(all_pvs[0]):
        if k in stacked:
            out.append(prog.xp.asarray(np.stack([np.asarray(pv[k])
                                                 for pv in all_pvs])))
        else:
            out.append(to_device_tree(prog.xp, v))
    return out


def _lead(exec_, batch: _Batch, prog, root, ent, dicts, prep_vals,
          slab_ids, sig) -> Optional[object]:
    from tidb_tpu_torch.executor import fragment
    from tidb_tpu_torch.expression import ParamExpr

    ctx = exec_.ctx
    ph = ctx.phases
    guard = getattr(ctx, "guard", None)
    stacked = {k for k, node in enumerate(prog.prep_nodes)
               if isinstance(node, ParamExpr)}

    with ctx.device_slot():
        # grant time: close the batch and claim compatible members
        with _LOCK:
            batch.closed = True
            if _BATCHES.get(batch.key) is batch:
                del _BATCHES[batch.key]
            members = list(batch.members)
        claimed: List[_Member] = []
        demoted: List[_Member] = []
        for m in members:
            if _structure_matches(prep_vals, m.prep_vals, stacked):
                m.claimed = True
                claimed.append(m)
            else:
                demoted.append(m)
        for m in demoted:
            m.fallback = True
            m.event.set()
        if not claimed:
            # solo: the individual path is the exactness oracle
            return None

        b_real = 1 + len(claimed)
        all_pvs = [prep_vals] + [m.prep_vals for m in claimed]
        stacked_preps = _stack_preps(prog, all_pvs, stacked)
        bprog = fragment.get_batched_program(prog, b_real, sig)
        outs = []
        for cols, n in exec_._slab_iter(ent, None, prog.used_cols,
                                        slab_ids):
            with ph.phase("compute", sig=f"batched:{sig}"):
                out = bprog.partial(cols, n, stacked_preps)
                # K22 + K18: member-major live rows of every column
                outs.append(fragment.compact_rows(out["cols"], out["live"]))
            ph.note_launch()
            ph.note_fused()

    # fetch + demux OUTSIDE the slot (matching _execute_filter's shape)
    with ph.phase("compute"):
        fragment._sync(ctx.device)
    host_outs = ph.fetch(outs)
    try:
        failpoint.inject("microbatch-demux")
        with ph.phase("decode"):
            chunks = _demux(host_outs, b_real, root, dicts)
    except BaseException as e:
        _abort(batch)
        if _is_guard_error(e):
            raise
        _warn(guard, f"micro-batch demux degraded to individual "
                     f"execution: {e}")
        return None

    REGISTRY.inc("tidb_tpu_microbatch_batches_total")
    REGISTRY.inc("tidb_tpu_microbatch_members_total", by=b_real)
    for m, chunk in zip(claimed, chunks[1:]):
        m.result = chunk
        m.fallback = False
        m.event.set()
    return chunks[0]


def _demux(host_outs, b_real: int, root, dicts) -> List[object]:
    """Split each slab's member-major live rows by the members' offsets
    into per-member (dictionary-decoded) Chunks — the batched twin of
    _execute_filter's decode loop."""
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.executor.fragment import (_decode_col,
                                                  _positional_dict)
    chunks: List[object] = []
    for k in range(b_real):
        pieces = []
        for cols, offsets in host_outs:
            lo, hi = int(offsets[k]), int(offsets[k + 1])
            pieces.append(Chunk([
                _decode_col(ft, v[lo:hi], m[lo:hi],
                            _positional_dict(root, ci, dicts))
                for ci, ((v, m), ft) in enumerate(
                    zip(cols, root.schema.field_types))]))
        chunks.append(Chunk.concat(pieces) if len(pieces) > 1
                      else pieces[0])
    return chunks


def _is_guard_error(e: BaseException) -> bool:
    from tidb_tpu_torch.errors import QueryInterrupted, QueryTimeout
    return isinstance(e, (QueryInterrupted, QueryTimeout)) \
        or not isinstance(e, Exception)


def _warn(guard, msg: str) -> None:
    REGISTRY.inc("tidb_tpu_microbatch_fallbacks_total")
    if guard is not None:
        guard.warnings.append(("Warning", 1105, msg))


__all__ = ["execute", "batch_key", "queued_members", "POLL_S"]

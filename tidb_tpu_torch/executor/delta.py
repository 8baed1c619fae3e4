"""Delta slabs — the HTAP write path of the device cache.

Without this module, any DML would throw a cached table away: one
single-row INSERT discarded the compressed slabs, the zone maps and the
aligned joins, and the next read re-encoded and re-uploaded every
column. The TiFlash analog is delta trees (TiFlash's DeltaTree storage
keeps a small delta layer over immutable stable packs and merges them at
read): committed base slabs stay immutable while writes accumulate in a
small device-resident delta, folded into reads, and a background
compaction periodically rebuilds the base with freshly re-chosen layouts
— the "Fine-Tuning Data Structures" load-time decision re-run when the
data has moved (arXiv 2112.13099).

`extend_entry` is the read-side half: a cached entry whose TableData
went stale is diffed region by region against the current snapshot
(regions are immutable and only ever grow at the tail, so the diff is
exact), and when the change is expressible as appends + tombstones the
entry EXTENDS instead of rebuilding:

  * appended rows encode host-side into ONE extra slab — the delta
    slab, at index `base_slabs`, using the SAME per-column layouts and
    dictionaries as the base, so every scan path (chain, tree, fused
    pipeline) consumes it through the per-slab program it already runs:
    the base∪delta merge costs one extra slab, no base re-upload;
  * tombstones rewrite ONLY the affected base slabs on the device
    (device_emit.emit_delta_merge): surviving rows stable-permute to the
    front and the slab's live count shrinks — one K19 partition per
    slab, packed columns repacked through it by K19 without unpacked
    codes ever reaching device memory, raw columns gathered through it
    by K18.

Extension installs a NEW CachedTable generation that shares the
untouched base tensors with its predecessor — in-flight readers keep the
old object (their snapshot), and the swap is atomic under the
device-cache lock. A list of data gates (dictionary membership, layout
range fit, bounds, delta-kind columns, holes) declines extension and
the caller rebuilds — extension is an optimization, never a correctness
risk. Nothing else declines: a kernel, CUDA or upload failure on this
path raises to the statement, as every device error of the port does.

`run_pending_compactions` / the background worker is the write-side
half: once a generation's delta grows past `tidb_tpu_delta_compact_rows`,
a compaction job rebuilds the base slabs from the current snapshot with
re-chosen compression layouts and fresh zone maps, in the scheduler's
idle heavy-batch slots (batch-class admission: interactive statements
always rank ahead of it). The swap is crash-consistent around the
`compaction-commit` failpoint: a fault BEFORE the commit drops the
rebuilt tensors and the old base+delta keep serving reads byte-exactly.

Failpoints: `delta-merge-stale` (entry of extend_entry — a fault there
raises a typed LayoutError to the statement, never silent wrong rows;
the cached generation stays, and the next read extends once disarmed)
and `compaction-commit` (above); the write side's `delta-append` lives
in storage Store.commit.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.errors import LayoutError
from tidb_tpu_torch.util import failpoint, timeline

#: delta live-rows + tombstones past this → schedule async compaction
DEFAULT_COMPACT_ROWS = 1024

# one extension at a time: extensions are short (a region diff, at most
# one slab encode and a few slab rewrites), and serializing them removes
# the same-entry race where two threads build sibling generations
_EXT_LOCK = threading.Lock()


def _var_on(vars_, name: str, default: str = "on") -> bool:
    return str(vars_.get(name, default)).lower() not in ("off", "0", "false")


# ---------------------------------------------------------------------------
# region diff — build-time coverage vs the current TableData
# ---------------------------------------------------------------------------

def _diff_regions(ent, td, scope):
    """Diff the entry's base-build coverage against the current regions.
    → (tombs_base, appends, base_total) or None when the change is not
    expressible as appends+tombstones (region GC'd, truncated, re-scoped
    via the part-reset on delete, or rows resurrected).

    tombs_base: int64 array of CUMULATIVE tombstoned positions in the
    base build's live-row coordinate space (== slab space: slab s covers
    [s*slab_cap, (s+1)*slab_cap)). appends: [(region, start_row,
    alive_tail_mask)] of CUMULATIVE appended-and-still-alive rows, in
    region order."""
    cov = ent.cov
    ci = 0
    tombs: List[np.ndarray] = []
    appends = []
    base_total = 0
    if cov:
        _rid, _n_old, alive_old, base_off = cov[-1]
        base_total = base_off + int(alive_old.sum())
    for r in td.regions:
        if scope is not None and r.part is not None and r.part not in scope:
            continue
        if ci < len(cov) and r.id == cov[ci][0]:
            _rid, n_old, alive_old, base_off = cov[ci]
            ci += 1
            if r.num_rows < n_old:
                return None                     # region shrank
            dnew = np.asarray(r.deleted[:n_old])
            if ((~alive_old) & ~dnew).any():
                return None                     # dead row resurrected
            nd = dnew & alive_old
            if nd.any():
                alive_idx = np.nonzero(alive_old)[0]
                pos = base_off + np.searchsorted(alive_idx,
                                                 np.nonzero(nd)[0])
                tombs.append(pos.astype(np.int64))
            if r.num_rows > n_old:
                tail_alive = ~np.asarray(r.deleted[n_old:])
                if tail_alive.any():
                    appends.append((r, n_old, tail_alive))
        else:
            if r.id <= ent.max_rid:
                # an OLD region this build never saw — deletes reset its
                # partition tag to None, pulling it into scope: rebuild
                return None
            alive = ~np.asarray(r.deleted)
            if alive.any():
                appends.append((r, 0, alive))
    if ci != len(cov):
        return None                             # a build region vanished
    out = np.sort(np.concatenate(tombs)) if tombs \
        else np.empty(0, dtype=np.int64)
    return out, appends, base_total


def _append_col(appends, scan, col_idx: int):
    """Materialize ONE column of the cumulative appended rows (aligned
    to the scan schema, DDL-padded) → (vals, valid)."""
    from tidb_tpu_torch.executor.scan import align_chunk_to_schema
    vals_list, valid_list = [], []
    for r, start, alive_tail in appends:
        chunk = align_chunk_to_schema(r.chunk, scan.table)
        idx = start + np.nonzero(alive_tail)[0]
        col = chunk.columns[col_idx]
        vals_list.append(col.values[idx])
        valid_list.append(col.valid_mask()[idx])
    if len(vals_list) == 1:
        return vals_list[0], valid_list[0]
    return np.concatenate(vals_list), np.concatenate(valid_list)


# ---------------------------------------------------------------------------
# per-column gates + delta-slab prep
# ---------------------------------------------------------------------------

def _host_dictvals(ent, dev, i: int):
    """Host copy of a dict-layout column's dictionary values: one d2h
    copy of the shared dictvals tensor, memoized on the entry (and so on
    every later generation, which shares the memo)."""
    dv = ent.dictvals_host.get(i)
    if dv is None:
        t = next((t for t in dev[i] if t is not None), None)
        if t is None or len(t) < 3:
            return None
        dv = t[2].cpu().numpy()
        ent.dictvals_host[i] = dv
    return dv


def _delta_prep(ent, dev, scan, i: int, ftype, appends, has_tombs: bool):
    """Gate + prep for column `i` of the delta slab → a _slab_host-style
    prep dict, or None when a gate trips (decline → full rebuild).
    Every gate protects an invariant the device programs assume:
    dictionary membership (global code space), layout range fit (packed
    widths), bounds (perfect-hash group domains), delta-kind purity."""
    lay = ent.layouts.get(i)
    if lay is not None and lay.kind == "delta" and has_tombs:
        return None     # diff codes don't survive a permutation
    vals, valid = _append_col(appends, scan, i)
    n = len(vals)
    if ftype.is_wide_decimal:
        return {"kind": "wide", "vals": vals, "valid": valid,
                "n_limbs": ftype.wide_limb_count, "layout": None}
    if ftype.is_varlen:
        dictionary = ent.dicts.get(i)
        if dictionary is None:
            return None
        str_vals = np.array([str(v) for v in vals], dtype=object)
        if ftype.is_ci:
            from tidb_tpu_torch.types import fold_ci_array
            folded = fold_ci_array(str_vals)
            keys = fold_ci_array(dictionary)
        else:
            folded = str_vals
            keys = dictionary
        if valid.any():
            vv = folded[valid]
            idx = np.searchsorted(keys, vv)
            if (idx >= len(keys)).any() or (keys[np.clip(
                    idx, 0, max(len(keys) - 1, 0))] != vv).any():
                return None     # value outside the global dictionary
        return {"kind": "str", "vals": folded, "valid": valid,
                "keys": keys, "layout": lay}
    if vals.dtype == np.dtype(np.float64):
        return {"kind": "float", "vals": vals, "valid": valid,
                "dtype": np.dtype(np.float64), "layout": None}
    prep = {"kind": "num", "vals": vals, "valid": valid, "layout": lay}
    if vals.dtype.kind in "iu" and valid.any():
        vv = vals[valid].astype(np.int64)
        bounds = ent.bounds.get(i)
        if bounds is not None:
            lo, hi = bounds
            if int(vv.min()) < lo or int(vv.max()) > hi:
                return None     # bounds feed perfect-hash group domains
        if lay is not None:
            if lay.kind == "pack":
                if lay.width == 0:
                    if (vv != lay.ref).any():
                        return None
                elif ((vv < lay.ref) |
                      (vv - lay.ref >= (1 << lay.width))).any():
                    return None
            elif lay.kind == "dict":
                dv = _host_dictvals(ent, dev, i)
                if dv is None:
                    return None
                idx = np.searchsorted(dv, vv)
                if (idx >= len(dv)).any() or \
                        (dv[np.clip(idx, 0, len(dv) - 1)] != vv).any():
                    return None
                prep["dictvals"] = dv
            elif lay.kind == "delta":
                if not valid.all() or n == 0:
                    return None
                diffs = np.diff(vv)
                if diffs.size and (int(diffs.min()) < 0 or
                                   int(diffs.max()).bit_length()
                                   > lay.width):
                    return None
    elif lay is not None and lay.kind == "delta" and not valid.all():
        return None
    return prep


# ---------------------------------------------------------------------------
# extension — the read-side delta merge
# ---------------------------------------------------------------------------

def extend_entry(ctx, scan, ent, max_slab: int, phases=None):
    """Try to extend a stale cached entry with a delta slab + tombstone
    rewrites instead of rebuilding it. → the NEW CachedTable generation
    (sharing untouched base tensors with `ent`), or None to decline
    (caller rebuilds). Never mutates `ent`. Only the data gates decline;
    any other failure (a kernel, CUDA or upload error) raises."""
    from tidb_tpu_torch.util.phases import PhaseTimer
    corrupted = failpoint.inject("delta-merge-stale")
    if corrupted is not None:
        raise LayoutError(
            f"delta extension diff failed validation "
            f"(failpoint: {corrupted!r}) — refusing the in-place merge")
    ph = phases if phases is not None else PhaseTimer()
    with _EXT_LOCK:
        return _extend_locked(ctx, scan, ent, max_slab, ph)


def _extend_locked(ctx, scan, ent, max_slab, ph):
    from tidb_tpu_torch.chunk import compress
    from tidb_tpu_torch.executor import device_cache as dc
    from tidb_tpu_torch.executor import device_emit
    table_id = scan.table.id
    td = ctx.snapshot.table_data(table_id)
    # a sibling's eviction may clear ent.dev while we run: read a snapshot
    # of the slab lists (it keeps their tensors alive)
    dev = dict(ent.dev)
    if td is None or ent.cov is None or ent.holes or not dev:
        return None
    pruned = getattr(scan, "partitions", None)
    scope = None if pruned is None else set(pruned)
    diff = _diff_regions(ent, td, scope)
    if diff is None:
        return None
    tombs_base, appends, base_total = diff
    cap = ent.slab_cap
    n_append = sum(int(a.sum()) for _r, _s, a in appends)
    if n_append > cap:
        return None                     # delta slab full → rebuild
    resident = sorted(dev)
    ftypes = scan.schema.field_types
    if any(i >= len(ftypes) for i in resident):
        return None

    # cumulative → fresh tombstones, per base slab, in base coordinates
    cum: Dict[int, np.ndarray] = {}
    for s in sorted(set(int(p) // cap for p in tombs_base)):
        sel = (tombs_base // cap) == s
        cum[s] = tombs_base[sel] - s * cap
    fresh: Dict[int, np.ndarray] = {}
    for s, pos in cum.items():
        applied = ent.tomb.get(s)
        f = pos if applied is None else np.setdiff1d(pos, applied)
        if f.size:
            if s >= ent.base_slabs:
                return None             # a tombstone past the base
            fresh[s] = f
    has_tombs = bool(fresh)

    # delta-slab preps (gates) for EVERY resident column — they all
    # must extend or none does (ragged slab lists would corrupt reads)
    preps = {}
    if n_append:
        with ph.phase("encode"):
            for i in resident:
                p = _delta_prep(ent, dev, scan, i, ftypes[i], appends,
                                has_tombs)
                if p is None:
                    return None
                preps[i] = p
    elif has_tombs:
        for i in resident:
            lay = ent.layouts.get(i)
            if lay is not None and lay.kind == "delta":
                return None

    base_slabs = ent.base_slabs
    total_tombs = int(tombs_base.size)
    new_total = base_total - total_tombs + n_append
    n_slabs = base_slabs + (1 if n_append else 0)

    new = dc.CachedTable(td, ent.max_slab, new_total, cap, n_slabs,
                         ent.parts, ent.n_cols, compressed=ent.compressed,
                         device=ent.device)
    new.dicts = dict(ent.dicts)
    new.bounds = dict(ent.bounds)
    new.layouts = dict(ent.layouts)
    new.zmaps = dict(ent.zmaps)
    new.cov = ent.cov
    new.max_rid = ent.max_rid
    new.base_slabs = base_slabs
    new.delta_version = int(getattr(ctx.snapshot, "version", 0) or 0)
    # an empty diff (the write landed in an out-of-scope partition, or
    # it only touched rows this build never covered) is a pure
    # REVALIDATION: same tensors, fresh td + version — keep the plain
    # entry semantics (aligned joins stay usable)
    new.is_delta = bool(n_append or tombs_base.size)
    new.tomb = dict(cum)
    new.delta_rows = n_append
    new.dictvals_host = ent.dictvals_host

    # complete per-slab live counts: the uniform slab_cap arithmetic is
    # wrong for every slab once total shifts
    rows_override: Dict[int, int] = {}
    for s in range(base_slabs):
        orig = min(cap, base_total - s * cap)
        rows_override[s] = orig - int(cum.get(s, np.empty(0)).size)
    if n_append:
        rows_override[base_slabs] = n_append
    new.rows_override = rows_override if new.is_delta else None

    # per freshly tombstoned slab: the keep mask in CURRENT slab
    # coordinates (the slab may already have been compacted by earlier
    # generations — map original positions through the applied set),
    # uploaded once; its stable partition (K19) and the new live count
    # are computed once and serve every column of the slab
    device = ent.device
    h2d = 0
    orders = {}
    for s, f in fresh.items():
        applied = ent.tomb.get(s)
        cur_pos = f if applied is None \
            else f - np.searchsorted(applied, f)
        keep = np.zeros(cap, dtype=bool)
        keep[:ent.slab_rows(s)] = True
        keep[cur_pos] = False
        with ph.phase("upload"):
            keep_t = dc._upload(keep, device)
        h2d += keep.nbytes
        with ph.phase("compute"):
            orders[s] = (keep_t, device_emit.delta_perm(keep_t),
                         torch.tensor(rows_override[s], dtype=torch.int32,
                                      device=device))

    # encode + upload the delta slab; rewrite tombstoned base slabs
    new_dev: Dict[int, List] = {}
    logical = 0
    for i in resident:
        slabs = list(dev[i][:base_slabs])
        lay = ent.layouts.get(i)
        if orders:
            with ph.phase("compute"):
                for s, (keep_t, perm, n_valid) in orders.items():
                    slabs[s] = device_emit.emit_delta_merge(
                        lay, slabs[s], keep_t, rows_override[s], cap,
                        perm=perm, n_valid=n_valid)
        if n_append:
            with ph.phase("encode"):
                host_t = dc._slab_host(preps[i], 0, n_append, cap)
            with ph.phase("upload"):
                dev_t = tuple(dc._upload(a, device) for a in host_t)
                if lay is not None and lay.kind == "dict":
                    # the column's ONE dictvals tensor rides along
                    base_t = next(t for t in reversed(dev[i])
                                  if t is not None)
                    dev_t = dev_t + (base_t[-1],)
            h2d += sum(a.nbytes for a in host_t)
            logical += compress.raw_slab_bytes(lay, cap) \
                if lay is not None else sum(a.nbytes for a in host_t)
            slabs.append(dev_t)
        new_dev[i] = slabs
    new.dev = new_dev
    if h2d:
        ph.add_h2d(h2d, logical=logical)
    ph.note_delta_rows(n_append, token=id(new))
    if timeline.ENABLED:
        timeline.instant("delta-extend", "cache",
                         args={"rows": n_append, "tombs": total_tombs,
                               "table": table_id})
    from tidb_tpu_torch.util.observability import REGISTRY
    REGISTRY.inc("tidb_tpu_delta_extensions_total",
                 {"table": str(table_id)})

    # past the threshold → hand the rebuild to the async compactor
    threshold = int(ctx.vars.get("tidb_tpu_delta_compact_rows",
                                 DEFAULT_COMPACT_ROWS))
    if n_append + total_tombs >= max(threshold, 1):
        store = getattr(ctx.snapshot, "store", None)
        if store is not None:
            key = (str(device), id(store), table_id,
                   None if pruned is None else tuple(pruned))
            schedule_compaction(store, key, scan, resident, max_slab,
                                dict(ctx.vars))
    return new


# ---------------------------------------------------------------------------
# async compaction — rebuild the base in idle heavy-batch slots
# ---------------------------------------------------------------------------

_PENDING: Dict[tuple, dict] = {}
_PENDING_LOCK = threading.Lock()
_DRAIN_LOCK = threading.Lock()
_WORKER: Optional[threading.Thread] = None


class _IdleGuard:
    """Batch-class admission token for the compaction worker: it queues
    like the heaviest batch statement, so interactive and cheap-batch
    work always ranks ahead — compaction runs in idle slots."""

    sched_class = "batch"
    sched_cost = 1e9
    conn_id = -7

    def __init__(self):
        self.queue_wait_s = 0.0
        self.queue_waits = 0

    def check(self, site: str) -> None:
        pass


def schedule_compaction(store, key, scan, cols, max_slab: int,
                        vars_: dict) -> None:
    """Queue one compaction job per cache key (newest wins) and make
    sure a worker will drain it (unless tidb_tpu_compaction=off — the
    queue still fills, and run_pending_compactions drains it)."""
    job = {"store": weakref.ref(store), "key": key, "scan": scan,
           "cols": list(cols), "max_slab": max_slab, "vars": vars_}
    with _PENDING_LOCK:
        _PENDING[key] = job
    if _var_on(vars_, "tidb_tpu_compaction"):
        _ensure_worker()


def pending_compactions() -> int:
    with _PENDING_LOCK:
        return len(_PENDING)


def _pop_job():
    with _PENDING_LOCK:
        if not _PENDING:
            return None
        key = next(iter(_PENDING))
        return _PENDING.pop(key)


def _ensure_worker() -> None:
    global _WORKER
    with _PENDING_LOCK:
        if _WORKER is not None and _WORKER.is_alive():
            return
        _WORKER = threading.Thread(target=_worker_loop,
                                   name="tidb-tpu-compactor", daemon=True)
        _WORKER.start()


def _worker_loop() -> None:
    while True:
        with _DRAIN_LOCK:
            job = _pop_job()
            if job is None:
                return
            try:
                _compact_one(job)
            except (_CommitFault, _StaleRebuild):
                # the old generation keeps serving; the next extension
                # past the threshold re-schedules. Anything else (a
                # kernel, CUDA or upload error) ends the worker with its
                # traceback; the next schedule starts a new one.
                pass


def run_pending_compactions() -> int:
    """Synchronously drain the compaction queue (tests, chip_smoke) →
    jobs that committed. An injected commit fault or a rebuild the table
    outran is swallowed per job (the old generation keeps serving and
    the job is consumed); any other error raises."""
    done = 0
    with _DRAIN_LOCK:
        while True:
            job = _pop_job()
            if job is None:
                return done
            try:
                if _compact_one(job):
                    done += 1
            except (_CommitFault, _StaleRebuild):
                pass


def _compact_one(job) -> bool:
    """Rebuild the job's cache entry from the current snapshot with
    freshly re-chosen layouts + zone maps, then atomically swap it in.
    The `compaction-commit` failpoint sits between the finished rebuild
    and the swap: a fault there drops the rebuilt tensors and leaves
    the old base+delta serving byte-exactly."""
    from tidb_tpu_torch.executor import ExecContext
    from tidb_tpu_torch.executor import device_cache as dc
    from tidb_tpu_torch.executor.scheduler import SCHEDULER
    from tidb_tpu_torch.util.phases import PhaseTimer
    store = job["store"]()
    if store is None:
        return False
    key, scan = job["key"], job["scan"]
    table_id = scan.table.id
    snapshot = store.snapshot()
    td = snapshot.table_data(table_id)
    if td is None:
        return False
    with dc._LOCK:
        cur = dc._CACHE.get(key)
    if cur is None or (cur.td is td and not cur.is_delta):
        return False    # evicted, or already rebuilt fresh — nothing to do
    guard = _IdleGuard()
    new = None
    try:
        with SCHEDULER.slot(guard=guard, conn_id=guard.conn_id):
            ctx = ExecContext(snapshot=snapshot, vars=dict(job["vars"]),
                              device=cur.device)
            ph = PhaseTimer()
            parts, total, cov, max_rid = dc._collect_parts(ctx, scan,
                                                           coverage=True)
            slab_cap = dc._pow2(min(total, job["max_slab"])) if total \
                else 1024
            n_slabs = (total + slab_cap - 1) // slab_cap
            new = dc.CachedTable(td, job["max_slab"], total, slab_cap,
                                 n_slabs, parts, cur.n_cols,
                                 compressed=cur.compressed,
                                 device=cur.device)
            new.cov = cov
            new.max_rid = max_rid
            new.delta_version = int(getattr(snapshot, "version", 0) or 0)
            ftypes = scan.schema.field_types
            cols = [i for i in job["cols"] if i < len(ftypes)]
            if total:
                preps = {}
                for i in cols:
                    # _col_prep re-runs choose_layout under the CURRENT
                    # workload hints — the compaction-time layout
                    # re-search of arXiv 2112.13099
                    preps[i] = dc._col_prep(new, i, ftypes[i])
                    new.dicts[i] = preps[i]["dict"]
                    new.bounds[i] = preps[i]["bounds"]
                    new.layouts[i] = preps[i]["layout"]
                    if new.compressed:
                        zm = dc._col_zone_stats(new, preps[i])
                        if zm is not None:
                            new.zmaps[i] = zm
                for _ in dc._stream_slabs(ctx, new, None, cols, preps, ph):
                    pass
            try:
                failpoint.inject("compaction-commit")
            except Exception as e:  # noqa: BLE001 — the armed fault
                raise _CommitFault(str(e)) from e
            with dc._LOCK:
                installed = dc._CACHE.get(key)
                fresh_td = store.snapshot().table_data(table_id)
                if fresh_td is not td or installed is None:
                    # the table moved on mid-rebuild (or the entry was
                    # evicted): our rebuild is already stale — abandon it
                    raise _StaleRebuild()
                dc._CACHE[key] = new
                dc._CACHE.move_to_end(key)
            # the replaced generation's tensors free NOW unless a live
            # statement still computes on them (protect discipline)
            dc._safe_delete(installed, key[1:3])
    except BaseException:
        if new is not None:
            new.delete()    # exclusively owned — frees device memory now
        raise
    from tidb_tpu_torch.util.observability import REGISTRY
    REGISTRY.inc("tidb_tpu_compactions_total", {"table": str(table_id)})
    if timeline.ENABLED:
        timeline.instant("compaction", "cache",
                         args={"table": table_id, "rows": total,
                               "slabs": n_slabs})
    return True


class _StaleRebuild(Exception):
    """The table moved on (or the entry went) while the rebuild ran."""


class _CommitFault(Exception):
    """An armed `compaction-commit` failpoint fired before the swap."""

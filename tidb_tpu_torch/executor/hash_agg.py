"""Hash aggregation as factorize + segment-reduce (ref: executor/aggregate.go).

The reference's HashAggExec runs a 2-phase parallel worker graph: partial
workers build per-shard hash tables with AggFunc.UpdatePartialResult, final
workers MergePartialResult per key shard (diagram aggregate.go:127-164).

TPU-first reformulation (SURVEY §7 stage 4): no hash table at all. Per input
batch, group keys are FACTORIZED into dense group ids (sort-based unique —
what TPUs and numpy are both good at), and partial states are built with
segment ops. Batch partials (small: one row per distinct group) are merged
by re-factorizing the concatenated partial keys and scatter-combining
states — `AggFunc.merge` is the same segment op as `update`, so the batch
merge, the multi-core merge, and the cross-chip psum merge are one code
path. DISTINCT aggs materialize (gid, value) pairs and dedupe before a
single update pass.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor import Executor, _empty_chunk
from tidb_tpu_torch.expression import EvalContext, Expression
from tidb_tpu_torch.expression.aggfuncs import AggFunc, build_agg
from tidb_tpu_torch.expression.runner import host_context
from tidb_tpu_torch.planner.physical import PhysHashAgg

_OVERFLOW_GUARD = 1 << 61


def _iter_batches(distinct_rows, n_batches):
    """Transpose per-agg distinct lists into per-batch rows for spilling."""
    for b in range(n_batches):
        yield [rows[b] if b < len(rows) else None
               for rows in distinct_rows]


def factorize_columns(cols: Sequence[Tuple[np.ndarray, np.ndarray]]
                      ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Dense group ids for multi-column keys, NULLs forming their own group.

    → (gids int64 per row, n_groups, representative row index per group).
    The reference's analog is getGroupKey→codec.HashGroupKey
    (executor/aggregate.go:563, util/codec/codec.go:1200) feeding an
    open-address map; here sort-based unique gives ids directly.
    """
    n = cols[0][0].shape[0] if cols else 0
    if not cols:
        return np.zeros(n, dtype=np.int64), min(n, 1), np.zeros(
            min(n, 1), dtype=np.int64)
    combined = np.zeros(n, dtype=np.int64)
    base = 1
    for values, validity in cols:
        vals = values
        if vals.dtype == object:
            # fixed-width unicode sorts at C speed; object arrays fall
            # back to per-element Python compares (~30x slower argsort)
            vals = np.asarray(vals, dtype="U") if n else \
                np.asarray([], dtype="U1")
        uniq, inv = np.unique(vals, return_inverse=True)
        inv = inv.astype(np.int64) + 1
        if validity is not None and not validity.all():
            inv = np.where(validity, inv, 0)
        k = len(uniq) + 1
        if base * k > _OVERFLOW_GUARD:
            # re-densify before the code space overflows int64
            _, combined = np.unique(combined, return_inverse=True)
            combined = combined.astype(np.int64)
            base = int(combined.max()) + 1 if n else 1
        combined = combined * k + inv
        base = base * k
    uniq, first_idx, gids = np.unique(combined, return_index=True,
                                      return_inverse=True)
    return gids.astype(np.int64), len(uniq), first_idx.astype(np.int64)


def _fold_group_key_cols(key_cols, group_exprs):
    """Fold ci group-key columns so equal-under-collation values form ONE
    group; binary columns pass through (util/collate semantics)."""
    from tidb_tpu_torch.types import fold_ci_array
    out = []
    for (v, m), e in zip(key_cols, group_exprs):
        v = np.asarray(v)
        if e.ftype.is_ci and v.dtype == object:
            v = fold_ci_array(v)
        out.append((v, np.asarray(m, dtype=bool)))
    return out


def batch_partial(group_exprs, descs, aggs, scalar: bool, ch: Chunk):
    """One batch → (partial keys, states, distinct rows, bytes). Pure
    computation over picklable inputs — runs on worker threads AND in
    spawned worker processes (the UpdatePartialResult body of the
    reference's partial workers, executor/aggregate.go:127)."""
    from tidb_tpu_torch.util import memory as M
    ctx = host_context(ch)
    key_cols = [e.eval(ctx) for e in group_exprs]
    # ci collations group in FOLD space; outputs keep a raw
    # representative (reps gather from the unfolded arrays)
    gids, n_groups, reps = factorize_columns(
        _fold_group_key_cols(key_cols, group_exprs))
    if scalar:
        gids = np.zeros(ch.num_rows, dtype=np.int64)
        n_groups, reps = 1, np.zeros(1, dtype=np.int64)
    states = []
    batch_distinct = [None] * len(aggs)
    for i, (agg, desc) in enumerate(zip(aggs, descs)):
        if desc.args:
            # multi-arg only for COUNT(DISTINCT a, b): row counts
            # iff every arg is non-NULL (MySQL semantics)
            vs, ms = [], []
            for a in desc.args:
                v, m = a.eval(ctx)
                vs.append(np.asarray(v))
                ms.append(np.asarray(m, dtype=bool))
            m = ms[0]
            for extra in ms[1:]:
                m = m & extra
            v = vs[0]
        else:  # COUNT(*)
            vs = [np.zeros(ch.num_rows, dtype=np.int64)]
            v = vs[0]
            m = np.ones(ch.num_rows, dtype=bool)
        if desc.distinct:
            batch_distinct[i] = (gids, vs, m)
            states.append(None)
        else:
            st = agg.init(np, n_groups)
            states.append(agg.update(np, st, gids, n_groups, v, m))
    pk = [(np.asarray(v)[reps], np.asarray(m, dtype=bool)[reps])
          for v, m in key_cols]
    batch_bytes = sum(M.array_bytes(v, m) for v, m in pk)
    for st in states:
        if st is not None:
            batch_bytes += M.array_bytes(*st)
    for bd in batch_distinct:
        if bd is not None:
            batch_bytes += M.array_bytes(bd[0], bd[2], *bd[1])
    return pk, states, batch_distinct, batch_bytes


def _pack_chunk(ch: Chunk):
    """Wire form for the worker pipe: STRING object columns convert to
    fixed-width unicode (pickles as ONE raw buffer instead of a
    per-element Python loop — the transfer cost is what makes or breaks
    process-level scaling). Non-string object columns (wide-decimal
    Python ints, JSON) must keep their dtype — stringifying them would
    corrupt worker-side arithmetic."""
    cols = []
    for c in ch.columns:
        v = c.values
        obj = v.dtype == object and c.ftype.is_varlen
        if obj:
            v = np.asarray(v, dtype="U") if len(v) else \
                np.asarray([], dtype="U1")
        cols.append((c.ftype, v, c.validity, obj))
    return cols


def _unpack_chunk(cols) -> Chunk:
    out = []
    for ftype, v, validity, obj in cols:
        if obj:
            v = v.astype(object)
        out.append(Column(ftype, v, validity))
    return Chunk(out)


def _mp_batch_partial(spec, packed):
    """Spawned-worker entry: rebuild aggs from descs (AggFunc instances
    carry no state worth shipping) and run the partial."""
    group_exprs, descs, scalar = spec
    aggs = [build_agg(d) for d in descs]
    return batch_partial(group_exprs, descs, aggs, scalar,
                         _unpack_chunk(packed))


_MP_POOL = None
_MP_POOL_SIZE = 0
_MP_POOL_LOCK = None


def _noop():
    return 0


def _get_pool(conc: int):
    """Lazy process pool (shared engine-wide): fork is unsafe with a live
    CUDA context and server threads, so workers come from a forkserver
    (they only run numpy partials). The pool is
    GROW-ONLY under a lock: resizing never cancels another session's
    in-flight partials. Standard multiprocessing caveat applies: a
    script driving concurrency > 1 needs the `if __name__ ==
    "__main__"` guard."""
    global _MP_POOL, _MP_POOL_SIZE, _MP_POOL_LOCK
    import threading
    if _MP_POOL_LOCK is None:
        _MP_POOL_LOCK = threading.Lock()
    with _MP_POOL_LOCK:
        if _MP_POOL is not None and _MP_POOL_SIZE >= conc:
            return _MP_POOL
        old = _MP_POOL
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, wait
        pool = ProcessPoolExecutor(
            conc, mp_context=multiprocessing.get_context("forkserver"))
        wait([pool.submit(_noop) for _ in range(conc * 2)])
        _MP_POOL = pool
        _MP_POOL_SIZE = conc
        if old is not None:
            # no new submits; in-flight futures complete undisturbed
            old.shutdown(wait=False)
        import atexit
        atexit.register(_shutdown_pool)
        return _MP_POOL


def _shutdown_pool():
    global _MP_POOL
    if _MP_POOL is not None:
        _MP_POOL.shutdown(wait=False, cancel_futures=True)
        _MP_POOL = None


class HashAggExec(Executor):
    def __init__(self, plan: PhysHashAgg, child: Executor):
        super().__init__(plan.schema.field_types, [child])
        self.group_exprs = plan.group_exprs
        self.descs = plan.aggs
        self.aggs: List[AggFunc] = [build_agg(d) for d in plan.aggs]
        self.scalar = not plan.group_exprs  # no GROUP BY → always one row
        self.rollup = getattr(plan, "rollup", False)
        self._replay: Optional[List[Chunk]] = None
        self._result: Optional[Chunk] = None
        self._offset = 0

    def open(self, ctx):
        super().open(ctx)
        self._result = None
        self._offset = 0

    # ---- core -------------------------------------------------------------
    N_SPILL_PARTITIONS = 16

    def _aggregate(self) -> Chunk:
        from tidb_tpu_torch.util import memory as M
        partial_keys: List[List[Tuple[np.ndarray, np.ndarray]]] = []
        partial_states: List[List[Tuple]] = []
        distinct_rows: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = \
            [[] for _ in self.aggs]
        saw_rows = False
        spill = None                # PartitionedPickleSpill once engaged
        tracker = self.ctx.mem_tracker.child("HashAgg")
        tracked = 0

        def engage_spill() -> bool:
            # AggSpillDiskAction analog: partition accumulated partials by
            # group-key hash onto disk; later batches write through
            nonlocal spill, tracked, partial_keys, partial_states
            nonlocal distinct_rows
            if self.scalar or spill is not None:
                return False     # single group: nothing to partition
            spill = M.PartitionedPickleSpill(
                self.N_SPILL_PARTITIONS,
                guard=getattr(self.ctx, "guard", None))
            for pk, st, dr in zip(partial_keys, partial_states,
                                  _iter_batches(distinct_rows,
                                                len(partial_keys))):
                self._spill_batch(spill, pk, st, dr)
            partial_keys, partial_states = [], []
            distinct_rows = [[] for _ in self.aggs]
            tracker.release(tracked)
            tracked = 0
            return True

        tracker.add_handler(engage_spill)

        def collect(result):
            # spill/tracker bookkeeping stays on the driving thread;
            # collection order == submission order so order-sensitive
            # states (first_row) remain deterministic
            nonlocal tracked, saw_rows
            pk, states, batch_distinct, batch_bytes = result
            saw_rows = True
            if spill is not None:
                self._spill_batch(spill, pk, states, batch_distinct)
                return
            partial_keys.append(pk)
            partial_states.append(states)
            for i, bd in enumerate(batch_distinct):
                if bd is not None:
                    distinct_rows[i].append(bd)
            tracked += batch_bytes
            tracker.consume(batch_bytes)

        # intra-operator parallelism (the partial-worker graph of
        # executor/aggregate.go:127-164): per-batch partials are pure AND
        # picklable, so they run on a forkserver PROCESS pool — numpy
        # sorts and scatter-adds hold the GIL, so threads cannot scale
        # this; processes can. Honest caveat, measured: on wide Q1-shaped
        # batches the parent-side pack/pickle of each 64K-row batch costs
        # about what the partial itself costs, so wall-clock gains only
        # appear when per-row compute is heavy relative to row width
        # (many exprs, wide decimals); the graph is the reference's
        # architecture, the single-thread path is the fast default here.
        conc = max(int(self.ctx.vars.get("tidb_tpu_cpu_concurrency", 1)),
                   1)
        try:
            if conc == 1:
                while True:
                    ch = self._next_input()
                    if ch is None:
                        break
                    if ch.num_rows == 0:
                        continue
                    collect(self._batch_partial(ch))
            else:
                from collections import deque

                def in_flight_bytes(packed) -> int:
                    # reservation for an un-collected batch: the PACKED
                    # payload actually in flight (fixed-width unicode can
                    # be much larger than the object array it replaces);
                    # keeps the pipeline visible to the quota so spill
                    # still engages under pressure
                    total = 0
                    for _ft, v, validity, _obj in packed:
                        total += v.nbytes
                        if validity is not None:
                            total += validity.nbytes
                    return total

                pool = _get_pool(conc)
                spec = (self.group_exprs, self.descs, self.scalar)
                pending = deque()

                def drain_one():
                    fut, reserved = pending.popleft()
                    try:
                        collect(fut.result())
                    finally:
                        tracker.release(reserved)

                while True:
                    ch = self._next_input()
                    if ch is None:
                        break
                    if ch.num_rows == 0:
                        continue
                    packed = _pack_chunk(ch)
                    reserve = in_flight_bytes(packed)
                    tracker.consume(reserve)
                    pending.append(
                        (pool.submit(_mp_batch_partial, spec, packed),
                         reserve))
                    if len(pending) >= conc * 2:
                        drain_one()
                while pending:
                    drain_one()

            if spill is None:
                return self._merge_partials(partial_keys, partial_states,
                                            distinct_rows, saw_rows)
            return self._merge_spilled(spill, saw_rows)
        finally:
            tracker.remove_handler(engage_spill)
            tracker.release(tracked)
            if spill is not None:
                spill.close()

    def _next_input(self) -> Optional[Chunk]:
        """Child pull, redirected to the buffered-chunk replay while a
        rollup level re-runs the pipeline."""
        if self._replay is not None:
            return self._replay.pop(0) if self._replay else None
        return self.child_next()

    def _aggregate_rollup(self) -> Chunk:
        """GROUP BY ... WITH ROLLUP: one aggregation per prefix of the
        group list (all k keys down to the grand total), rolled-up key
        columns emitted as NULL.  The child is drained ONCE; every level
        replays the buffered chunks through the regular partial/merge
        pipeline (spill, distinct, process pool all included), so each
        super-aggregate row is exactly the oracle result for its prefix.
        A genuinely-NULL key group and the super-aggregate over it stay
        separate rows, as in MySQL."""
        chunks: List[Chunk] = []
        while True:
            ch = self.child_next()
            if ch is None:
                break
            if ch.num_rows:
                chunks.append(ch)
        if not chunks:
            return _empty_chunk(self.schema)   # no rows at ANY level
        full_ge, full_scalar = self.group_exprs, self.scalar
        k = len(full_ge)
        pieces: List[Chunk] = []
        try:
            for keep in range(k, -1, -1):
                self.group_exprs = full_ge[:keep]
                self.scalar = keep == 0
                self._replay = list(chunks)
                piece = self._aggregate()
                if piece.num_rows == 0:
                    continue
                cols = list(piece.columns[:keep])
                for kc in range(keep, k):      # rolled-up keys → all-NULL
                    ft = self.schema[kc]
                    vals = np.full(piece.num_rows, None, dtype=object) \
                        if ft.is_varlen else \
                        np.zeros(piece.num_rows, dtype=ft.np_dtype)
                    cols.append(Column(ft, vals,
                                       np.zeros(piece.num_rows, dtype=bool)))
                cols += list(piece.columns[keep:])
                pieces.append(Chunk(cols))
        finally:
            self.group_exprs, self.scalar = full_ge, full_scalar
            self._replay = None
        if not pieces:
            return _empty_chunk(self.schema)
        return Chunk.concat(pieces) if len(pieces) > 1 else pieces[0]

    def _fold_group_keys(self, key_cols):
        """Every factorize/partition over group keys (partial, merge,
        spill routing) MUST go through the fold, or a ci group's rows
        scatter across partitions."""
        return _fold_group_key_cols(key_cols, self.group_exprs)

    def _batch_partial(self, ch: Chunk):
        return batch_partial(self.group_exprs, self.descs, self.aggs,
                             self.scalar, ch)

    def _spill_batch(self, spill, pk, states, batch_distinct) -> None:
        """Split one batch's partial groups by key hash into partitions."""
        from tidb_tpu_torch.util.memory import hash_partition
        pk_h = self._fold_group_keys(pk) if pk else pk
        n_groups = len(pk[0][0]) if pk else 0
        buckets = hash_partition(pk_h, spill.n)
        for p in np.unique(buckets):
            gsel = buckets == p
            keymap = np.full(n_groups, -1, dtype=np.int64)
            keymap[np.nonzero(gsel)[0]] = np.arange(int(gsel.sum()))
            pk_p = [(v[gsel], m[gsel]) for v, m in pk]

            def _sel(a):
                # ragged python-object states (GROUP_CONCAT/JSON_*AGG:
                # per-group LISTS) partition by comprehension; arrays by
                # mask
                if isinstance(a, list):
                    return [x for x, keep in zip(a, gsel) if keep]
                return a[gsel]

            st_p = [None if st is None else tuple(_sel(a) for a in st)
                    for st in states]
            dr_p = []
            for bd in batch_distinct:
                if bd is None:
                    dr_p.append(None)
                    continue
                gids, vs, m = bd
                rsel = gsel[gids]
                dr_p.append((keymap[gids[rsel]],
                             [v[rsel] for v in vs], m[rsel]))
            spill.add(int(p), (pk_p, st_p, dr_p))

    def _merge_spilled(self, spill, saw_rows: bool) -> Chunk:
        """Partition-at-a-time final merge: peak memory ≈ one partition."""
        pieces = []
        for p in range(spill.n):
            partial_keys, partial_states = [], []
            distinct_rows = [[] for _ in self.aggs]
            any_batch = False
            for pk_p, st_p, dr_p in spill.read(p):
                any_batch = True
                partial_keys.append(pk_p)
                partial_states.append(st_p)
                for i, d in enumerate(dr_p):
                    if d is not None:
                        distinct_rows[i].append(d)
            if not any_batch:
                continue
            piece = self._merge_partials(partial_keys, partial_states,
                                         distinct_rows, True)
            if piece.num_rows:
                pieces.append(piece)
        if not pieces:
            return _empty_chunk(self.schema)
        return Chunk.concat(pieces) if len(pieces) > 1 else pieces[0]

    def _merge_partials(self, partial_keys, partial_states, distinct_rows,
                        saw_rows: bool) -> Chunk:
        if not saw_rows:
            if self.scalar:
                return self._final_chunk(
                    [(np.empty(0), np.empty(0, dtype=bool))
                     for _ in self.group_exprs],
                    [a.init(np, 1) for a in self.aggs], 1, empty_input=True)
            return _empty_chunk(self.schema)

        if self.scalar:
            # all batches share group 0: straight merge
            n_final = 1
            final_gids_per_batch = [np.zeros(1, dtype=np.int64)
                                    for _ in partial_states]
            final_keys = [(np.empty(0), np.empty(0, dtype=bool))
                          for _ in self.group_exprs]
        else:
            # concatenate per-batch representative keys → re-factorize
            cat_keys = []
            for kc in range(len(self.group_exprs)):
                vals = np.concatenate([pk[kc][0] for pk in partial_keys])
                valid = np.concatenate([pk[kc][1] for pk in partial_keys])
                cat_keys.append((vals, valid))
            gids_all, n_final, reps = factorize_columns(
                self._fold_group_keys(cat_keys))
            final_keys = [(v[reps], m[reps]) for v, m in cat_keys]
            final_gids_per_batch = []
            off = 0
            for pk in partial_keys:
                sz = len(pk[0][0]) if pk else (
                    len(partial_states[0][0][0]) if partial_states else 0)
                final_gids_per_batch.append(gids_all[off:off + sz])
                off += sz

        final_states = []
        for i, agg in enumerate(self.aggs):
            if self.descs[i].distinct:
                final_states.append(self._distinct_state(
                    i, agg, distinct_rows[i], final_gids_per_batch, n_final))
                continue
            st = agg.init(np, n_final)
            for bgids, bstates in zip(final_gids_per_batch, partial_states):
                st = agg.merge(np, st, bgids, n_final, bstates[i])
            final_states.append(st)
        return self._final_chunk(final_keys, final_states, n_final)

    def _distinct_state(self, i: int, agg: AggFunc, rows, final_gids_per_batch,
                        n_final: int):
        """Dedupe (final_gid, arg-tuple) rows then one update pass."""
        n_args = len(rows[0][1]) if rows else 1
        all_g, all_m = [], []
        all_vs: List[List[np.ndarray]] = [[] for _ in range(n_args)]
        for (bgids, vs, m), fmap in zip(rows, final_gids_per_batch):
            all_g.append(fmap[bgids])
            all_m.append(m)
            for k, v in enumerate(vs):
                all_vs[k].append(v)
        g = np.concatenate(all_g) if all_g else np.empty(0, dtype=np.int64)
        m = np.concatenate(all_m) if all_m else np.empty(0, dtype=bool)
        vcols = [np.concatenate(v) if v else np.empty(0) for v in all_vs]
        # NULLs don't contribute to distinct aggs; drop before dedupe
        g = g[m]
        vcols = [v[m] for v in vcols]
        ones = np.ones(len(g), dtype=bool)
        dcols = []
        for k, v in enumerate(vcols):
            aft = self.descs[i].args[k].ftype
            if aft.is_ci and getattr(v, "dtype", None) == np.dtype(object):
                from tidb_tpu_torch.types import fold_ci_array
                v = fold_ci_array(v)
            dcols.append(v)
        _, _, reps = factorize_columns(
            [(g, ones)] + [(v, ones) for v in dcols])
        g = g[reps]
        v0 = vcols[0][reps] if vcols else np.empty(0)
        st = agg.init(np, n_final)
        return agg.update(np, st, g, n_final, v0,
                          np.ones(len(g), dtype=bool))

    def _final_chunk(self, final_keys, final_states, n_final: int,
                     empty_input: bool = False) -> Chunk:
        cols: List[Column] = []
        n_group_cols = len(self.group_exprs)
        for kc in range(n_group_cols):
            ft = self.schema[kc]
            vals, valid = final_keys[kc]
            if ft.is_varlen:
                vals = np.asarray(vals, dtype=object)
            else:
                vals = np.asarray(vals).astype(ft.np_dtype, copy=False)
            valid = np.asarray(valid, dtype=bool)
            cols.append(Column(ft, vals,
                               None if valid.all() else valid.copy()))
        for agg, st in zip(self.aggs, final_states):
            v, m = agg.final(np, st)
            ft = agg.ftype
            if ft.is_varlen:
                v = np.asarray(v, dtype=object)
            else:
                v = np.asarray(v).astype(ft.np_dtype, copy=False)
            m = np.asarray(m, dtype=bool)
            cols.append(Column(ft, v, None if m.all() else m.copy()))
        return Chunk(cols)

    # ---- volcano ----------------------------------------------------------
    def next(self) -> Optional[Chunk]:
        if self._result is None:
            self._result = self._aggregate_rollup() if self.rollup \
                else self._aggregate()
        if self._offset >= self._result.num_rows:
            return None
        size = self.ctx.chunk_size
        out = self._result.slice(self._offset,
                                 min(self._offset + size,
                                     self._result.num_rows))
        self._offset += out.num_rows
        return out

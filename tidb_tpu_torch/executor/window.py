"""Window-function executor (ref: executor/window.go:31).

Blocking operator: drains the child, sorts once per distinct window spec
by (partition, order) keys with MySQL NULL ordering, computes every
window column via the whole-column primitives in ops/window.py, and
scatters results back to the original row order. The reference streams
partition groups through per-function slide states (pipelined_window.go);
the columnar formulation is one sort + cumulative ops — the same code
path the device engine traces.

Two execution paths share the ops/window.py primitives:

* **Device** — when the engine is on, the input clears the row threshold
  and every spec passes the fragment gate (fragment._window_device_ok),
  the per-spec sort runs on the statement's device as ops/factorize.lexsort
  (K9 + K8) over the HOST-rank-encoded keys (executor/sort.rank_keys bakes
  in direction and MySQL NULL ordering, so the device comparison is a
  plain integer compare), and the window columns evaluate through the
  K12-K15 kernels of ops/window.py. This covers windows whose CHILD is a
  host operator — windows over device-eligible scans run inside the
  fragment programs instead (device_emit.emit_window) and never reach
  this executor. A spec whose argument evaluates to an object (string)
  array declines to the host before any device work; a device error
  raises.
* **Host** — the numpy primitives of ops/window.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor import Executor, MaterializingExec, _empty_chunk
from tidb_tpu_torch.expression import EvalContext
from tidb_tpu_torch.expression.runner import host_context
from tidb_tpu_torch.ops import window as W
from tidb_tpu_torch.planner.physical import PhysWindow
from tidb_tpu_torch.types import TypeKind


class WindowExec(MaterializingExec):
    def __init__(self, plan: PhysWindow, child: Executor):
        super().__init__(plan.schema.field_types, [child])
        self.plan = plan

    # ------------------------------------------------------------------
    def _materialize(self) -> Chunk:
        chunks = []
        while True:
            ch = self.child_next()
            if ch is None:
                break
            if ch.num_rows:
                chunks.append(ch)
        if not chunks:
            return _empty_chunk(self.schema)
        inp = Chunk.concat(chunks) if len(chunks) > 1 else chunks[0]
        ctx = host_context(inp)
        n = inp.num_rows

        sort_cache: Dict[str, Tuple] = {}
        device = self._device_eligible(n)
        out_cols = list(inp.columns)
        for d in self.plan.wdescs:
            key = repr((d.partition, d.order, d.descs))
            if device:
                col = self._one_device(d, ctx, inp, n, key, sort_cache)
                if col is not None:
                    out_cols.append(col)
                    continue
            layout = sort_cache.get("host|" + key)
            if layout is None:
                layout = _sorted_layout(inp, n, d)
                sort_cache["host|" + key] = layout
            sidx, pstart, peerstart = layout
            v, m = self._one(d, ctx, n, sidx, pstart, peerstart)
            back_v = np.empty_like(v)
            back_v[sidx] = v
            back_m = np.empty(n, dtype=bool)
            back_m[sidx] = m
            if d.ftype.is_varlen:
                back_v = np.asarray(back_v, dtype=object)
            elif back_v.dtype != d.ftype.np_dtype:
                back_v = back_v.astype(d.ftype.np_dtype)
            out_cols.append(Column(d.ftype, back_v,
                                   None if back_m.all() else back_m))
        return Chunk(out_cols)

    def _device_eligible(self, n: int) -> bool:
        from tidb_tpu_torch.executor.fragment import (_var_bool,
                                                      _window_device_ok)
        from tidb_tpu_torch.planner.physical import DEFAULT_TPU_ROW_THRESHOLD
        ctx = self.ctx
        if ctx is None or ctx.device is None:
            return False
        vars_ = ctx.vars or {}
        if not _var_bool(vars_.get("tidb_tpu_engine", "off")):
            return False
        threshold = int(vars_.get("tidb_tpu_row_threshold",
                                  DEFAULT_TPU_ROW_THRESHOLD))
        return n >= max(threshold, 1) and _window_device_ok(self.plan)

    def _one_device(self, d, ctx, inp, n: int, key: str,
                    sort_cache) -> Optional[Column]:
        """One window column on the statement's device: lexsort (K9 + K8)
        over host-rank-encoded keys, K12's flags and positions, K13-K15
        through ops/window.compute. → None (before any device work) when
        the argument is an object array: such a spec runs on the host."""
        import torch
        from tidb_tpu_torch.ops.xp import TorchXP
        arg = None
        if d.args:
            v, m = d.args[0].eval(ctx)
            v = np.asarray(v)
            if v.dtype == object:
                return None          # string payloads stay host-side
            arg = (v, np.asarray(m, dtype=bool))
        dev = self.ctx.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with self.ctx.device_slot():
            layout = sort_cache.get("dev|" + key)
            if layout is None:
                layout = _device_layout(inp, n, d, dev)
                sort_cache["dev|" + key] = layout
            sidx, pstart, peerstart, pos = layout
            vals = valid = fill = None
            if arg is not None:
                vals = up(arg[0])[sidx]
                valid = up(arg[1])[sidx]
            elif d.name not in ("row_number", "rank", "dense_rank"):
                vals = torch.zeros(n, dtype=torch.int64, device=dev)
                valid = torch.ones(n, dtype=torch.bool, device=dev)
            if d.name in ("lag", "lead"):
                if d.default is not None and d.default.value is not None:
                    fv = d.args[0].ftype.encode_value(d.default.value)
                    fill = (torch.tensor(fv, dtype=vals.dtype, device=dev),
                            torch.tensor(True, device=dev))
                else:
                    fill = (torch.zeros((), dtype=vals.dtype, device=dev),
                            torch.tensor(False, device=dev))
            if d.name == "avg" and d.args and \
                    d.args[0].ftype.kind is TypeKind.DECIMAL:
                vals = vals.to(torch.float64) / \
                    d.args[0].ftype.decimal_multiplier
            frame = getattr(d, "frame", None)
            range_key = None
            if frame is not None and frame[0] == "range":
                kv, km = d.order[0].eval(ctx)
                range_key = (up(np.asarray(kv))[sidx],
                             up(np.asarray(km, dtype=bool))[sidx],
                             bool(d.descs[0]))
            v, m = W.compute(TorchXP(dev), d.name, vals, valid, pstart,
                             peerstart, bool(d.order), d.offset, fill,
                             frame=frame, range_key=range_key,
                             positions=pos)
            back_v = torch.empty(n, dtype=v.dtype, device=dev)
            back_v[sidx] = v
            back_m = torch.empty(n, dtype=torch.bool, device=dev)
            back_m[sidx] = m
            back_v = back_v.cpu().numpy()
            back_m = back_m.cpu().numpy()
        if back_v.dtype != d.ftype.np_dtype and not d.ftype.is_varlen:
            back_v = back_v.astype(d.ftype.np_dtype)
        return Column(d.ftype, back_v, None if back_m.all() else back_m)

    def _one(self, d, ctx, n, sidx, pstart, peerstart):
        vals = valid = fill = None
        if d.args:
            v, m = d.args[0].eval(ctx)
            vals = np.asarray(v)[sidx]
            valid = np.asarray(m, dtype=bool)[sidx]
        elif d.name not in ("row_number", "rank", "dense_rank"):
            vals = np.zeros(n, dtype=np.int64)      # COUNT(*)
            valid = np.ones(n, dtype=bool)
        if d.name in ("lag", "lead"):
            if d.default is not None and d.default.value is not None:
                fv = d.args[0].ftype.encode_value(d.default.value)
                fill = (np.full(n, fv,
                                dtype=object if vals.dtype == object
                                else vals.dtype),
                        np.ones(n, dtype=bool))
            else:
                fill = (np.zeros(n, dtype=vals.dtype)
                        if vals.dtype != object
                        else np.full(n, "", dtype=object),
                        np.zeros(n, dtype=bool))
        if d.name == "avg" and d.args and \
                d.args[0].ftype.kind is TypeKind.DECIMAL:
            vals = vals.astype(np.float64) / \
                d.args[0].ftype.decimal_multiplier
        frame = getattr(d, "frame", None)
        range_key = None
        if frame is not None and frame[0] == "range":
            kv, km = d.order[0].eval(ctx)
            range_key = (np.asarray(kv)[sidx],
                         np.asarray(km, dtype=bool)[sidx],
                         bool(d.descs[0]))
        return W.compute(np, d.name, vals, valid, pstart, peerstart,
                         bool(d.order), d.offset, fill, frame=frame,
                         range_key=range_key)


def _device_layout(chunk: Chunk, n: int, d, dev):
    """→ (sidx int64, pstart, peerstart, K12 positions) on `dev` for one
    window spec: the rank codes of _sorted_layout, sorted by
    ops/factorize.lexsort (K9 + K8; each code bounds itself, so no
    min/max read-back) with K12's flags and positions over them (its
    `window_bounds`)."""
    import torch
    from tidb_tpu_torch.executor.sort import rank_keys
    from tidb_tpu_torch.ops.factorize import SortOp, lexsort
    pkeys = rank_keys(list(d.partition), [False] * len(d.partition), chunk)
    okeys = rank_keys(list(d.order), list(d.descs), chunk)
    keys = [torch.from_numpy(k).to(dev) for k in pkeys + okeys]
    if keys:
        sidx = lexsort([SortOp(t, hi=int(k.max()) + 1) for t, k in
                        zip(keys, pkeys + okeys)]).to(torch.int64)
    else:
        sidx = torch.arange(n, dtype=torch.int64, device=dev)
    return (sidx,) + W.window_bounds(sidx, None, [(t, None) for t in keys],
                                     len(pkeys))


def _sorted_layout(chunk: Chunk, n: int, d):
    """→ (sidx, pstart, peerstart) for one window spec. Rank-encoded keys
    (executor/sort.rank_keys) bake in direction and MySQL NULL ordering,
    so boundary detection is a plain code comparison."""
    from tidb_tpu_torch.executor.sort import rank_keys
    pkeys = rank_keys(list(d.partition), [False] * len(d.partition), chunk)
    okeys = rank_keys(list(d.order), list(d.descs), chunk)
    all_keys = pkeys + okeys
    if all_keys:
        sidx = np.lexsort(tuple(reversed(all_keys)))
    else:
        sidx = np.arange(n, dtype=np.int64)

    def changes(keys) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        if n:
            out[0] = True
        for k in keys:
            ks = k[sidx]
            out[1:] |= ks[1:] != ks[:-1]
        return out

    pstart = changes(pkeys)
    peerstart = changes(all_keys) if okeys else pstart
    return sidx, pstart, peerstart

"""Shared helpers of the tests/test_torch_*.py differential tests: fill
the JAX package's engine and the PyTorch port's engine from the SAME
seed-made numpy columns, run one SQL text through both with the device
engine on, and compare under tests/test_fragment.py's rule."""

import gc

import numpy as np

from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.chunk import Column as JColumn
from tidb_tpu.executor import build as jbuild
from tidb_tpu.executor import run_to_completion as jrun
from tidb_tpu.executor.fragment import TpuFragmentExec as JFrag
from tidb_tpu.parser import parse as jparse
from tidb_tpu.session import Engine as JEngine
from tidb_tpu_torch.executor import build as tbuild
from tidb_tpu_torch.executor import run_to_completion as trun
from tidb_tpu_torch.executor.fragment import TpuFragmentExec as TFrag
from tidb_tpu_torch.parser import parse as tparse
from tidb_tpu_torch.session import Engine as TEngine
from tidb_tpu_torch.testing import load_numpy_columns

#: float tolerance of the device comparisons (tests/test_fragment.py's
#: assert_same rule): the two engines sum in different orders
FLOAT_REL = 1e-5


def load_jax_columns(session, table, cols, valid=None):
    """The JAX-package twin of tidb_tpu_torch.testing.load_numpy_columns."""
    eng = session.engine
    info = eng.catalog.info_schema.table(table)
    valid = valid or {}
    out = []
    for c in info.columns:
        vals = np.asarray(cols[c.name])
        if not c.ftype.is_varlen:
            vals = vals.astype(c.ftype.np_dtype, copy=False)
        m = valid.get(c.name)
        out.append(JColumn(c.ftype, vals,
                           None if m is None else np.asarray(m, dtype=bool)))
    txn = eng.store.begin()
    txn.append(info.id, JChunk(out))
    txn.commit()


def jax_session(configure=None):
    """A new JAX-package engine's session, made with the garbage collector
    held off: the reference's ProcessRegistry.register deadlocks when a
    collection inside it finalizes a dead session (ROADMAP §3), so
    earlier sessions are collected here first. `configure(engine)` runs
    before the session is made."""
    gc.collect()
    gc.disable()
    try:
        eng = JEngine()
        if configure is not None:
            configure(eng)
        return eng.new_session()
    finally:
        gc.enable()


def twin_sessions(ddl, tables):
    """→ (jax session, port session) holding the same tables.
    `tables` maps a table name to (cols, valid)."""
    js = jax_session()
    ts = TEngine(device="cpu").new_session()
    for stmt in ddl:
        js.execute(stmt)
        ts.execute(stmt)
    for name, (cols, valid) in tables.items():
        load_jax_columns(js, name, cols, valid)
        load_numpy_columns(ts, name, cols, valid)
        js.execute(f"ANALYZE TABLE {name}")
        ts.execute(f"ANALYZE TABLE {name}")
    return js, ts


def _run(s, sql, parse, build, run, frag_cls, max_slab, extra):
    s.vars["tidb_tpu_engine"] = "on"
    s.vars["tidb_tpu_row_threshold"] = 1
    s.vars.update(extra or {})
    if max_slab is not None:
        s.vars["tidb_tpu_max_slab_rows"] = max_slab
    try:
        plan = s._plan(parse(sql)[0])
        root = build(plan)
        chunks = run(root, s._exec_ctx())
        frags = []

        def walk(e):
            if isinstance(e, frag_cls):
                frags.append(e)
            for c in getattr(e, "children", []):
                walk(c)

        walk(root)
        return [r for ch in chunks for r in ch.rows()], frags
    finally:
        s.vars["tidb_tpu_engine"] = "off"
        s.vars.pop("tidb_tpu_max_slab_rows", None)
        for k in (extra or {}):
            s.vars.pop(k, None)


def run_jax(s, sql, max_slab=None, extra=None):
    rows, frags = _run(s, sql, jparse, jbuild, jrun, JFrag, max_slab, extra)
    return rows, frags


def run_port(s, sql, max_slab=None, extra=None):
    """Port rows; every fragment must have run on the device."""
    rows, frags = _run(s, sql, tparse, tbuild, trun, TFrag, max_slab, extra)
    assert frags, f"no port fragment extracted for: {sql}"
    for f in frags:
        assert f.used_device and f.fallback_code is None, \
            (sql, f.fallback_reason)
    return rows


def run_port_tree(s, sql, max_slab=None, extra=None):
    """Port rows and fragments of a statement whose join tree must run on
    the device: every fragment used the device with no fallback, and one
    of them holds a join."""
    from tidb_tpu_torch.executor.tree_fragment import has_join
    rows, frags = _run(s, sql, tparse, tbuild, trun, TFrag, max_slab, extra)
    for f in frags:
        assert f.used_device and f.fallback_code is None, \
            (sql, f.fallback_reason)
    assert any(has_join(f.plan.root) for f in frags), \
        f"no device join-tree fragment for: {sql}"
    return rows, frags


def assert_same(rows1, rows2, ordered=False, rel=FLOAT_REL):
    assert len(rows1) == len(rows2), (len(rows1), len(rows2))
    if not ordered:
        rows1 = sorted(rows1, key=str)
        rows2 = sorted(rows2, key=str)
    for r1, r2 in zip(rows1, rows2):
        for v1, v2 in zip(r1, r2):
            if isinstance(v1, float) and v2 is not None:
                assert abs(v1 - v2) <= rel * max(1.0, abs(v2)), (r1, r2)
            else:
                assert v1 == v2, (r1, r2)

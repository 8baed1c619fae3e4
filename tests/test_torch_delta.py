"""The delta write path of the port (tidb_tpu_torch/executor/delta.py and
K19 delta_merge) against the JAX package on the CPU.

* Plain versions: `delta_merge_plain` against the reference's
  `emit_delta_merge` (jitted on the JAX CPU backend), byte for byte, over
  every layout kind (raw int8/int16/int32/int64/float64, a raw wide
  (n_limbs, cap) decimal, pack at each width of WIDTHS, dict), four
  tombstone sets (none dropped, a few, all but one, all) and a full and a
  part-filled slab; `pack_codes_plain` against the reference's
  `_emit_pack_codes` and the host encoder `compress._pack_codes`.
* SQL: the shapes of tests/test_delta_slabs.py (the pod test aside) on a
  JAX engine (device on) and the port's Engine(device="cpu") at
  1024-row slabs, so the base has three slabs: rows equal after every
  write, untouched base tensors shared, a new dictionary string declines
  to a rebuild, delta_version in the specialization keys, compaction and
  the compaction-commit fault, the tensors of a dropped delta generation
  freed (weakrefs), delta_rows in the phase accounting, and the port's
  typed LayoutError under the delta-merge-stale failpoint.
* The rendezvous shape of tests/test_write_coalesce.py: N coalesced
  writers give one version bump and one extension; the delta-append
  fault leaves the version and the cached generation in place.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from tests.torch_diff import (assert_same,  # noqa: F401  (autouse)
                              collect_jax_sessions, jax_session)
from tidb_tpu_torch.chunk import compress as TC
from tidb_tpu_torch.errors import LayoutError, TiDBTPUError, TxnError
from tidb_tpu_torch.executor import delta as TD
from tidb_tpu_torch.executor import device_cache as TDC
from tidb_tpu_torch.executor import device_emit as TE
from tidb_tpu_torch.executor import fragment as TFR
from tidb_tpu_torch.executor.device_cache import _upload
from tidb_tpu_torch.session import Engine as TEngine
from tidb_tpu_torch.session import writebatch as TWB
from tidb_tpu_torch.util import failpoint as TFP
from tidb_tpu_torch.util.observability import REGISTRY as TREG

CPU = torch.device("cpu")
CAP = 1024


def _ref():
    """(jnp, tidb_tpu.chunk.compress, tidb_tpu.executor.device_emit)."""
    import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
    from tidb_tpu.chunk import compress as JC
    from tidb_tpu.executor import device_emit as JE
    from tidb_tpu.ops.jax_env import jnp
    return jnp, JC, JE


# ---------------------------------------------------------------------------
# (a) delta_merge_plain against the reference's emit_delta_merge
# ---------------------------------------------------------------------------

LAYOUTS = ([("raw", dt) for dt in ("int8", "int16", "int32", "int64",
                                   "float64")]
           + [("wide", "int64")]
           + [("pack", w) for w in TC.WIDTHS]
           + [("dict", 8)])
TOMBS = ("none", "few", "all_but_one", "all")


def _slab_case(kind, arg, n_cur, seed):
    """→ (port layout or None, host slab tuple, dictvals or None)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(CAP) < 0.8) & (np.arange(CAP) < n_cur)
    if kind == "raw":
        dt = np.dtype(arg)
        if dt.kind == "f":
            vals = rng.standard_normal(CAP) * 1e6
        else:
            info = np.iinfo(dt)
            vals = rng.integers(info.min, info.max, CAP, dtype=dt,
                                endpoint=True)
        return None, (vals.astype(dt), mask), None
    if kind == "wide":
        vals = rng.integers(-(1 << 40), 1 << 40, (3, CAP)).astype(np.int64)
        return None, (vals, mask), None
    if kind == "pack":
        w = arg
        ref = -5
        codes = rng.integers(0, 1 << w, CAP, dtype=np.int64) if w else \
            np.zeros(CAP, dtype=np.int64)
        lay = TC.ColLayout("pack", w, ref, "int64")
        return lay, TC.pack_slab(lay, codes + ref, mask), None
    dv = np.unique(rng.integers(-999, 999, 200)).astype(np.int64)
    vals = dv[rng.integers(0, len(dv), CAP)]
    lay = TC.ColLayout("dict", arg, 0, "int64", len(dv))
    return lay, TC.pack_slab(lay, vals, mask, dv), dv


def _keep(tombs, n_cur, seed):
    rng = np.random.default_rng(seed + 1)
    keep = np.zeros(CAP, dtype=bool)
    keep[:n_cur] = True
    if tombs == "few":
        keep[rng.choice(n_cur, 5, replace=False)] = False
    elif tombs == "all_but_one":
        keep[:] = False
        keep[int(rng.integers(0, n_cur))] = True
    elif tombs == "all":
        keep[:] = False
    return keep


def _jax_layout(JC, lay):
    if lay is None:
        return None
    return JC.ColLayout(lay.kind, lay.width, lay.ref, lay.dtype, lay.card)


def _bytes_of(a) -> bytes:
    """Port tensors hold packed words as int32: compare the bits."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    return a.tobytes()


@pytest.mark.parametrize("n_cur", [CAP, 777])
@pytest.mark.parametrize("tombs", TOMBS)
@pytest.mark.parametrize("kind,arg", LAYOUTS)
def test_delta_merge_plain_matches_reference(kind, arg, tombs, n_cur):
    jnp, JC, JE = _ref()
    seed = LAYOUTS.index((kind, arg)) * 2 + (n_cur == CAP)
    lay, host, dv = _slab_case(kind, arg, n_cur, seed)
    keep = _keep(tombs, n_cur, seed)
    n_new = int(keep.sum())
    jslab = tuple(jnp.asarray(a) for a in host) + \
        ((jnp.asarray(dv),) if dv is not None else ())
    want = JE.emit_delta_merge(_jax_layout(JC, lay), jslab, keep, n_new,
                               CAP)
    tslab = tuple(_upload(a, CPU) for a in host) + \
        ((_upload(dv, CPU),) if dv is not None else ())
    got = TE.delta_merge_plain(lay, tslab, torch.from_numpy(keep), n_new,
                               CAP)
    # the K19 wrapper takes the plain version for CPU tensors
    via_wrapper = TE.emit_delta_merge(lay, tslab, torch.from_numpy(keep),
                                      n_new, CAP)
    assert len(got) == len(want) == len(via_wrapper)
    for g, w, v in zip(got, want, via_wrapper):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert _bytes_of(g) == w.tobytes()
        assert _bytes_of(v) == w.tobytes()
    if dv is not None:
        assert got[2] is tslab[2], "dictvals must ride along, not copy"
    if lay is not None and lay.width == 0:
        assert got[0] is tslab[0], "a width-0 stub is not rewritten"


def test_delta_kind_layout_raises_in_both():
    jnp, JC, JE = _ref()
    vals = np.cumsum(np.ones(CAP, dtype=np.int64))
    mask = np.ones(CAP, dtype=bool)
    lay = TC.ColLayout("delta", 1, 0, "int64")
    host = TC.pack_slab(lay, vals, mask)
    keep = mask.copy()
    keep[3] = False
    with pytest.raises(AssertionError):
        JE.emit_delta_merge(_jax_layout(JC, lay),
                            tuple(jnp.asarray(a) for a in host), keep,
                            CAP - 1, CAP)
    with pytest.raises(LayoutError):
        TE.delta_merge_plain(lay, tuple(_upload(a, CPU) for a in host),
                             torch.from_numpy(keep), CAP - 1, CAP)


# ---------------------------------------------------------------------------
# (b) pack_codes_plain against _emit_pack_codes and the host encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1024, 4096])
@pytest.mark.parametrize("width", [w for w in TC.WIDTHS if w])
def test_pack_codes_plain_matches_reference_and_host(width, cap):
    jnp, JC, JE = _ref()
    rng = np.random.default_rng(width * 7 + cap)
    codes = rng.integers(0, 1 << width, cap, dtype=np.uint64)
    host = TC._pack_codes(codes.copy(), width)
    ref = np.asarray(JE._emit_pack_codes(jnp.asarray(codes.astype(
        np.uint32)), width, cap))
    got = TE.pack_codes_plain(torch.from_numpy(codes.astype(np.int64)),
                              width, cap)
    assert ref.dtype == np.uint32 and got.dtype == torch.int32
    assert got.numpy().view(np.uint32).tobytes() == ref.tobytes() == \
        host.tobytes()


def test_delta_perm_plain_is_a_stable_partition():
    rng = np.random.default_rng(5)
    keep = rng.random(CAP) < 0.6
    perm = TE.delta_perm_plain(torch.from_numpy(keep)).numpy()
    want = np.concatenate([np.nonzero(keep)[0], np.nonzero(~keep)[0]])
    assert perm.dtype == np.int32 and np.array_equal(perm, want)


# ---------------------------------------------------------------------------
# (c) the SQL shapes of tests/test_delta_slabs.py on twin engines
# ---------------------------------------------------------------------------

Q = "SELECT a, COUNT(*), SUM(b) FROM t GROUP BY a ORDER BY a"
Q2 = "SELECT c, COUNT(*) FROM t WHERE a < 10 GROUP BY c ORDER BY c"
SLAB = 1024
# b = (i * 7919) % 5000 is unique per row (7919 is prime to 5000), so a
# DELETE by b values of rows below 1024 tombstones base slab 0 only
SLAB0_BS = ", ".join(str((i * 7919) % 5000) for i in (0, 5, 100, 777))


def _no_auto_analyze(eng):
    eng.global_vars["tidb_enable_auto_analyze"] = False


def _table(s, compression):
    s.execute("CREATE TABLE t (a BIGINT, b BIGINT, c VARCHAR(10))")
    # non-monotonic b: choose_layout picks pack/raw (delta-kind layouts
    # decline tombstones by design)
    s.execute("INSERT INTO t VALUES " + ",".join(
        f"({i % 40}, {(i * 7919) % 5000}, 'k{i % 5}')"
        for i in range(3000)))
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_compression": compression,
                   "tidb_tpu_compaction": "off",
                   "tidb_tpu_max_slab_rows": SLAB})
    return s.engine, s


class Twins:
    """The JAX engine (device on, CPU backend) and the port's CPU engine
    (device fragments under tidb_tpu_strict=1), fed the same SQL."""

    def __init__(self, compression="on"):
        TD.run_pending_compactions()    # no job of an earlier test left
        self.jeng, self.js = _table(jax_session(_no_auto_analyze),
                                    compression)
        teng = TEngine(device="cpu")
        _no_auto_analyze(teng)
        self.teng, self.ts = _table(teng.new_session(), compression)
        self.ts.vars["tidb_tpu_strict"] = 1

    def write(self, sql):
        a = self.js.query(sql).affected_rows
        b = self.ts.query(sql).affected_rows
        assert a == b, (sql, a, b)

    def read(self, sql=Q):
        """Port rows, held to the JAX engine's and the port's host rows."""
        rows = self.ts.query(sql).rows
        assert_same(rows, self.js.query(sql).rows,
                    ordered="ORDER BY" in sql)
        assert rows == self.oracle(sql)
        return rows

    def oracle(self, sql=Q):
        self.ts.vars["tidb_tpu_engine"] = "off"
        try:
            return self.ts.query(sql).rows
        finally:
            self.ts.vars["tidb_tpu_engine"] = "on"

    def entry(self, name="t"):
        tid = self.teng.catalog.info_schema.table(name).id
        for (_dev, sid, t, _parts), ent in TDC._CACHE.items():
            if sid == id(self.teng.store) and t == tid:
                return ent
        raise AssertionError(f"table {name} not cached")


def _base_ids(ent, slabs=None):
    """id() of every base-slab tensor, per column (optionally only the
    given slabs)."""
    keep = range(ent.base_slabs) if slabs is None else slabs
    return {i: [tuple(id(a) for a in ts[s]) for s in keep]
            for i, ts in ent.dev.items()}


@pytest.mark.parametrize("compression", ["on", "off"])
def test_insert_extends_without_reupload(compression):
    tw = Twins(compression)
    tw.read()
    ent0 = tw.entry()
    assert ent0.n_slabs == 3 and not ent0.is_delta
    ids0 = _base_ids(ent0)
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2'), (39, 4999, 'k4')")
    tw.read()
    ent1 = tw.entry()
    assert ent1 is not ent0 and ent1.is_delta
    assert ent1.delta_rows == 2 and ent1.n_slabs == 4
    assert ent1.base_slabs == 3 and ent1.slab_rows(3) == 2
    # no tombstones → every base tensor is SHARED, not re-encoded
    assert _base_ids(ent1) == ids0, "extension re-uploaded base slabs"


@pytest.mark.parametrize("compression", ["on", "off"])
def test_tombstones_and_mixed_writes(compression):
    tw = Twins(compression)
    tw.read()
    ids12 = _base_ids(tw.entry(), slabs=(1, 2))
    # tombstones in base slab 0 only: slabs 1 and 2 stay shared
    tw.write(f"DELETE FROM t WHERE b IN ({SLAB0_BS})")
    tw.read()
    ent = tw.entry()
    assert ent.is_delta and set(ent.tomb) == {0}
    assert ent.rows_override[0] == SLAB - 4
    assert _base_ids(ent, slabs=(1, 2)) == ids12
    tw.write("DELETE FROM t WHERE b % 97 = 3")
    tw.read()
    ent = tw.entry()
    assert ent.is_delta and any(len(v) for v in ent.tomb.values())
    # mixed insert + delete on the SAME generation, and an UPDATE
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2'), (7, 8, 'k0')")
    tw.write("DELETE FROM t WHERE b = 4998")
    tw.write("UPDATE t SET b = 11 WHERE b = 12")
    tw.read()
    assert tw.entry().is_delta
    # delete a row that lives in the DELTA slab (cumulative re-diff)
    rows_before = tw.entry().delta_rows
    tw.write("DELETE FROM t WHERE b = 1234 AND a = 3")
    tw.read()
    assert tw.entry().is_delta and tw.entry().delta_rows == rows_before - 1
    # the dictionary-string column is not resident: a delta generation
    # never cold-streams it, it rebuilds (and answers the same)
    tw.read(Q2)


def test_new_dictionary_string_declines_to_rebuild():
    tw = Twins()
    q = "SELECT c, COUNT(*) FROM t GROUP BY c ORDER BY c"
    tw.read(q)                      # cache covers the dictionary column
    # 'zzz' is not in the base dictionary: the extension must DECLINE and
    # the open rebuilds — never a wrong merge
    tw.write("INSERT INTO t VALUES (1, 1, 'zzz')")
    tw.read(q)
    assert not tw.entry().is_delta, "an un-encodable append must rebuild"
    tw.read()


def test_delta_version_in_spec_keys():
    """Two generations of one table never share a specialized program:
    the chain's specialization key carries delta_version."""
    tw = Twins()
    tw.read()
    v0 = tw.entry().delta_version
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2')")
    tw.read()
    v1 = tw.entry().delta_version
    assert v1 > v0
    with TFR._CC_LOCK:
        vs = {k[4] for k in TFR._SPEC_CACHE
              if k[0] == "chain" and k[2] == Q}
    assert {v0, v1} <= vs


def test_compaction_rebuilds_and_drops_delta():
    tw = Twins()
    tw.ts.vars["tidb_tpu_delta_compact_rows"] = 4
    tw.read()
    for i in range(5):
        tw.write(f"INSERT INTO t VALUES ({i % 40}, {i * 7 % 5000}, 'k1')")
    tw.read()
    assert tw.entry().is_delta
    assert TD.pending_compactions() >= 1
    tid = str(tw.teng.catalog.info_schema.table("t").id)
    key = ("tidb_tpu_compactions_total", (("table", tid),))
    c0 = TREG.counters.get(key, 0)
    assert TD.run_pending_compactions() == 1
    ent = tw.entry()
    assert not ent.is_delta, "compaction must fold the delta into base"
    assert ent.delta_rows == 0 and not ent.tomb
    assert ent.n_slabs == 3 and ent.total == 3005
    tw.read()
    assert TREG.counters.get(key, 0) == c0 + 1


def test_compaction_commit_fault_old_generation_serves():
    tw = Twins()
    tw.ts.vars["tidb_tpu_delta_compact_rows"] = 4
    tw.read()
    tw.write("DELETE FROM t WHERE b % 499 = 7")       # tombstones too
    for i in range(5):
        tw.write(f"INSERT INTO t VALUES ({i % 40}, {i * 7 % 5000}, 'k1')")
    warm = tw.read()
    ent0 = tw.entry()
    assert ent0.is_delta and TD.pending_compactions() >= 1
    TFP.enable("compaction-commit",
               raise_=RuntimeError("chaos: compaction fault"))
    try:
        assert TD.run_pending_compactions() == 0
    finally:
        TFP.disable("compaction-commit")
    # the old base+delta generation is UNTOUCHED and serves byte-exactly
    assert tw.entry() is ent0
    assert tw.read() == warm
    # the next extension past the threshold re-schedules: it heals
    tw.write("INSERT INTO t VALUES (9, 99, 'k0')")
    tw.read()
    assert TD.pending_compactions() >= 1
    assert TD.run_pending_compactions() == 1
    assert not tw.entry().is_delta
    tw.read()


def test_compaction_skips_evicted_entries():
    tw = Twins()
    tw.ts.vars["tidb_tpu_delta_compact_rows"] = 1
    tw.read()
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2')")
    tw.read()
    assert TD.pending_compactions() == 1
    TDC.clear()                     # evicted before the drain runs
    assert TD.run_pending_compactions() == 0, \
        "an evicted entry must not be rebuilt behind the cache's back"


def test_invalidation_frees_the_delta_generation():
    """Dropping a delta generation frees its delta-slab and rewritten
    slab tensors, and, with no other generation left, the base tensors
    it shared: weakrefs to every tensor die."""
    tw = Twins()
    tw.read()
    tw.write("DELETE FROM t WHERE b % 97 = 3")
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2')")
    tw.read()
    ent = tw.entry()
    assert ent.is_delta
    refs = [weakref.ref(a) for slabs in ent.dev.values() for t in slabs
            for a in t]
    delta_refs = [weakref.ref(a) for slabs in ent.dev.values()
                  for a in slabs[ent.base_slabs]]
    assert refs and delta_refs
    del ent
    TDC.invalidate(tw.teng.catalog.info_schema.table("t").id)
    gc.collect()
    assert not [r for r in delta_refs if r() is not None]
    assert not [r for r in refs if r() is not None], \
        "tensors of an invalidated delta generation survived"


def test_delta_rows_in_phase_accounting():
    tw = Twins()
    tw.read()
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2')")
    tw.ts.query(Q)
    assert tw.ts.last_guard.phases.as_dict().get("delta_rows", 0) == 1
    tw.read()


def test_delta_merged_slabs_own_their_storage():
    """After a DELETE on a table with a wide DECIMAL and a raw DOUBLE
    column, every tensor of the cached delta generation owns its storage
    (its storage's bytes within 16-byte alignment of its own), the rows
    equal to the host engine's. tests/test_torch_cuda.py holds the card's
    K18 route (`gather.gather_slab`) to the same."""
    s = TEngine(device="cpu").new_session()
    s.execute("CREATE TABLE w (a BIGINT, d DECIMAL(30,2), f DOUBLE, "
              "e BIGINT)")
    s.execute("INSERT INTO w VALUES " + ",".join(
        f"({i % 13}, {(i * 7919) * 10 ** 12}.{i % 100:02d}, "
        f"{(i * 53) % 1000 * 0.5}, {(i * 37) % 3000})" for i in range(3000)))
    sql = "SELECT a, SUM(d), SUM(f), COUNT(*) FROM w GROUP BY a ORDER BY a"
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_strict": 1, "tidb_tpu_max_slab_rows": CAP,
                   "tidb_tpu_compaction": "off"})
    s.query(sql)
    s.query("DELETE FROM w WHERE e % 7 = 3")
    rows = s.query(sql).rows
    ent = next(e for e in TDC._CACHE.values() if e.n_cols == 4)
    assert ent.is_delta
    assert any(t.dim() == 2 for slabs in ent.dev.values()
               for slab in slabs for t in slab
               if isinstance(t, torch.Tensor))
    s.vars["tidb_tpu_engine"] = "off"
    assert rows == s.query(sql).rows
    for slabs in ent.dev.values():
        for slab in slabs:
            for t in slab:
                if isinstance(t, torch.Tensor):
                    assert t.untyped_storage().nbytes() <= \
                        -(-t.nbytes // 16) * 16, (t.shape, t.dtype)


def test_gather_slab_plain_equals_gather_columns():
    """`gather.gather_slab` on CPU tensors: a wide (limbs, rows) column
    and a 1-D one gathered as `gather_columns` gathers them, the limbs
    sharing the first plane's mask, each output its own tensor."""
    from tidb_tpu_torch.ops import gather as G
    rng = np.random.default_rng(18)
    v2 = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (3, CAP)))
    v1 = torch.from_numpy(rng.normal(size=CAP))
    m = torch.from_numpy(rng.random(CAP) < 0.8)
    idx = torch.from_numpy(rng.permutation(CAP).astype(np.int32))
    nv = torch.tensor(CAP - 100, dtype=torch.int32)
    vals, mask = G.gather_slab(v2, m, idx, nv)
    want = G.gather_columns([(v2[k], m if k == 0 else None)
                             for k in range(3)], idx, nv)
    assert torch.equal(vals, torch.stack([w[0] for w in want]))
    assert torch.equal(mask, want[0][1])
    vals, mask = G.gather_slab(v1, m, idx, nv)
    (wv, wm), = G.gather_columns([(v1, m)], idx, nv)
    assert torch.equal(vals, wv) and torch.equal(mask, wm)
    assert vals.untyped_storage().nbytes() == vals.nbytes


def test_delta_merge_stale_raises_typed_layout_error():
    """The reference turns the fault into a warned CPU rerun; the port
    has no catch-all, so the statement raises the typed LayoutError
    (1105). The session stays usable and the cached generation stays;
    once disarmed, the next read extends."""
    tw = Twins()
    tw.read()
    ent0 = tw.entry()
    tw.write("INSERT INTO t VALUES (3, 1234, 'k2')")
    TFP.enable("delta-merge-stale", value="test: stale diff")
    try:
        with pytest.raises(LayoutError) as ei:
            tw.ts.query(Q)
        assert ei.value.code == 1105
        assert TFP.hits("delta-merge-stale") > 0
        assert tw.entry() is ent0
        assert tw.oracle("SELECT COUNT(*) FROM t") == [(3001,)]
    finally:
        TFP.disable("delta-merge-stale")
    tw.read()
    ent = tw.entry()
    assert ent.is_delta and ent.delta_rows == 1


# ---------------------------------------------------------------------------
# (d) the rendezvous shape of tests/test_write_coalesce.py
# ---------------------------------------------------------------------------

def _spawn_writers(eng, stmts, wait_parked, timeout=5.0):
    """One session+thread per statement while the caller holds the
    commit gate; waits until `wait_parked` followers are queued."""
    n = len(stmts)
    sessions = [eng.new_session() for _ in range(n)]
    results: list = [None] * n
    errors: list = [None] * n

    def run(i):
        try:
            results[i] = sessions[i].query(stmts[i]).affected_rows
        except TiDBTPUError as e:
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for i, th in enumerate(threads):
        th.start()
        if i == 0:
            deadline = time.monotonic() + timeout
            while not any(k[2] for k in list(TWB._BATCHES)) and \
                    time.monotonic() < deadline:
                time.sleep(0.002)
    deadline = time.monotonic() + timeout
    while TWB.queued_members() < wait_parked and \
            time.monotonic() < deadline:
        time.sleep(0.002)
    assert TWB.queued_members() >= wait_parked, \
        "followers never parked on the batch"
    return threads, results, errors


def _ext_count(tid):
    return TREG.counters.get(("tidb_tpu_delta_extensions_total",
                              (("table", str(tid)),)), 0)


@pytest.mark.parametrize("fault", [False, True])
def test_coalesced_writers_extend_once(fault):
    tw = Twins()
    tw.read()
    ent0 = tw.entry()
    info = tw.teng.catalog.info_schema.table("t")
    v0, x0 = tw.teng.store.version, _ext_count(info.id)
    stmts = [f"INSERT INTO t VALUES ({i}, {4000 + i}, 'k3')"
             for i in range(6)]
    if fault:
        TFP.enable("delta-append", raise_=TxnError("chaos: commit fault"),
                   times=1)
    gate = TWB.commit_gate(tw.teng.store, info.id)
    gate.acquire()
    try:
        threads, results, errors = _spawn_writers(tw.teng, stmts,
                                                  wait_parked=5)
    finally:
        gate.release()
        for th in threads:
            th.join(10)
        TFP.disable("delta-append")
    assert not any(th.is_alive() for th in threads)
    if fault:
        assert results == [None] * 6 and all(errors), errors
        assert tw.teng.store.version == v0, "a fault must not bump"
        tw.read()
        assert tw.entry() is ent0, "nothing committed: nothing to extend"
        assert _ext_count(info.id) == x0
        return
    assert results == [1] * 6 and errors == [None] * 6
    assert tw.teng.store.version - v0 == 1, "N writers, ONE version bump"
    for sql in stmts:
        tw.js.query(sql)
    tw.read()
    ent = tw.entry()
    assert ent.is_delta and ent.delta_rows == 6
    assert _ext_count(info.id) - x0 == 1, "one extension for the batch"

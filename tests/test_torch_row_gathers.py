"""The row gathers and the string IN of the port's device path against the
JAX package's engine on the CPU.

Every row gather of the device path goes through K18 (ops/gather.py:
`gather`, `gather_columns`, `gather_slab`, `inverse_permutation`; their
plain versions here): the join finishes' build and probe columns, the
aligned join's cached build columns, emit_root's LIMIT/TopN/Sort rows,
emit_merge's and the factorize branch's keys, emit_finalize's keys and
states, the window argument gathers and the results' way back to row
order (a gather through the layout's inverse permutation; both window
routes), the
monolithic dist program's owned merge, and the row roots' compaction
(K22 + K18, `fragment.compact_rows`). A spy on the plain versions shows
each site's SQL reaches them, with every index inside its source (the
kernel's out-of-range rule is never met), the rows equal to the JAX
engine's. The string IN is one K21 gather of a bool table over the
dictionary (`dict_lut` in fill mode), held to the JAX engine over a ci
and a cs column with a missing item, a NULL item, every code listed and
an empty dictionary. The aligned join's cached columns own their storage
(on the card, chip_smoke checks the same of the kernel's outputs)."""

import numpy as np
import pytest
import torch

from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        run_jax, run_port, run_port_frags, twin_sessions)
from tidb_tpu_torch.ops import dict_lut as DL
from tidb_tpu_torch.ops import gather as G

N_LI = 4000
N_OD = 1000

DDL = [
    "CREATE TABLE li (l_oid BIGINT, l_price BIGINT, l_disc DOUBLE, "
    "l_ship DATE, l_flag VARCHAR(1))",
    "CREATE TABLE od (o_id BIGINT, o_prio INT, o_dec DECIMAL(15,2), "
    "o_seg VARCHAR(10) COLLATE utf8mb4_general_ci, o_tag VARCHAR(10))",
    "CREATE TABLE nul (k BIGINT, s VARCHAR(8))",
]

SEGS = np.array(["Auto", "auto", "BUILDING", "building", "Machinery",
                 "HOUSEHOLD", "furniture"], dtype=object)
TAGS = np.array(["a", "b", "c", "d"], dtype=object)


def _tables():
    rng = np.random.default_rng(41)
    li = {"l_oid": rng.integers(0, N_OD + 50, N_LI),
          "l_price": rng.integers(1000, 100000, N_LI),
          "l_disc": rng.random(N_LI).round(2),
          "l_ship": rng.integers(8000, 10500, N_LI),
          "l_flag": rng.choice(np.array(["A", "N", "R"], dtype=object),
                               N_LI)}
    li_valid = {"l_price": rng.random(N_LI) > 0.03}
    od = {"o_id": np.arange(N_OD), "o_prio": rng.integers(1, 6, N_OD),
          "o_dec": rng.integers(-10 ** 9, 10 ** 9, N_OD),
          "o_seg": rng.choice(SEGS, N_OD), "o_tag": rng.choice(TAGS, N_OD)}
    od_valid = {"o_dec": rng.random(N_OD) > 0.1,
                "o_seg": rng.random(N_OD) > 0.05}
    od["o_seg"] = np.where(od_valid["o_seg"], od["o_seg"], "")
    nulls = {"k": np.arange(50), "s": np.array([""] * 50, dtype=object)}
    return {"li": (li, li_valid), "od": (od, od_valid),
            "nul": (nulls, {"s": np.zeros(50, dtype=bool)})}


@pytest.fixture(scope="module")
def twins():
    return twin_sessions(DDL, _tables())


STRICT = {"tidb_tpu_strict": 1}


@pytest.fixture
def spy(monkeypatch):
    """Every call of K18's plain versions, with its index checked inside
    its source → a list of the calls' kinds ("gather" / "inverse")."""
    calls = []
    real_g, real_i = G.gather_plain, G.inverse_permutation_plain

    def gather_plain(cols, idx, n_valid=None, keep=None, values=()):
        rows = (cols[0][0] if cols else values[0]).shape[-1]
        assert idx.numel() == 0 or (int(idx.min()) >= 0 and
                                    int(idx.max()) < rows), "gather index"
        calls.append("gather")
        return real_g(cols, idx, n_valid, keep, values)

    def inverse_plain(perm, n):
        assert perm.numel() == 0 or (int(perm.min()) >= 0 and
                                     int(perm.max()) < n), "inverse index"
        calls.append("inverse")
        return real_i(perm, n)

    monkeypatch.setattr(G, "gather_plain", gather_plain)
    monkeypatch.setattr(G, "inverse_permutation_plain", inverse_plain)
    return calls


#: one statement per moved site (the spy sees each reach K18):
#: name → (sql, session variables, the kinds of K18 call it must make)
SITES = {
    # the join finishes: an outer join whose other condition re-gathers
    # the build columns (the second `_gather`), unaligned
    "left_join_cond": (
        "SELECT o_prio, COUNT(*), COUNT(o_id), SUM(l_price) FROM li "
        "LEFT JOIN od ON l_oid = o_id AND l_price > o_prio * 15000 "
        "GROUP BY o_prio", {"tidb_tpu_aligned_join": 0}, {"gather"}),
    # an expand join: the probe and build columns through p_idx / b_idx
    "expand_join": (
        "SELECT COUNT(*), SUM(l_price), SUM(o_id) FROM li "
        "JOIN od ON l_oid = o_prio", {}, {"gather"}),
    # the aligned join's cached build columns (a wide-decimal column of a
    # join stays on the host at plan time, in both packages: its limb
    # planes are held at the wrapper below)
    "aligned_build": (
        "SELECT l_flag, COUNT(*), SUM(o_dec), MAX(o_prio) FROM li "
        "JOIN od ON l_oid = o_id GROUP BY l_flag", {}, {"gather"}),
    # emit_root's LIMIT, TopN and Sort over a join
    "limit_over_join": (
        "SELECT l_oid, l_price, o_prio FROM li JOIN od ON l_oid = o_id "
        "LIMIT 25", {}, {"gather"}),
    "topn_over_join": (
        "SELECT l_oid, l_price, o_prio FROM li JOIN od ON l_oid = o_id "
        "ORDER BY l_price DESC, l_oid LIMIT 12", {}, {"gather"}),
    "sort_over_join": (
        "SELECT l_oid, l_price, o_prio FROM li JOIN od ON l_oid = o_id "
        "WHERE l_price > 95000 ORDER BY l_price, l_oid", {}, {"gather"}),
    # GROUP BY through the factorize branch, with emit_merge over slabs
    # and emit_finalize's ORDER BY
    "factorize_group": (
        "SELECT l_oid, SUM(l_price), COUNT(*) FROM li GROUP BY l_oid "
        "ORDER BY SUM(l_price) DESC, l_oid LIMIT 20",
        {"tidb_tpu_max_slab_rows": 1024}, {"gather"}),
    # a window with a RANGE frame at the chain root: argument, RANGE key,
    # the inverse permutation and the gather back
    "window_range": (
        "SELECT l_oid, l_price, SUM(l_disc) OVER (PARTITION BY l_flag "
        "ORDER BY l_price RANGE BETWEEN 300 PRECEDING AND CURRENT ROW), "
        "COUNT(*) OVER (PARTITION BY l_flag ORDER BY l_price DESC RANGE "
        "BETWEEN 50 PRECEDING AND 50 FOLLOWING) FROM li WHERE l_oid > "
        "100", {}, {"gather", "inverse"}),
    # a join root: the rows compacted through K22 + K18
    "join_row_root": (
        "SELECT l_oid, l_price, o_prio FROM li JOIN od ON l_oid = o_id "
        "WHERE l_price > 90000", {}, {"gather"}),
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_moved_site_matches_jax_through_k18(twins, spy, name):
    sql, extra, kinds = SITES[name]
    js, ts = twins
    want, _ = run_jax(js, sql, extra=extra)
    spy.clear()
    got, frags = run_port_frags(ts, sql, extra={**STRICT, **extra})
    assert frags and all(f.used_device for f in frags), name
    assert kinds <= set(spy), (name, spy)
    assert_same(want, got, ordered="ORDER BY" in sql and
                "OVER" not in sql)


def test_window_exec_range_frame_goes_through_k18(twins, spy):
    """WindowExec's device path (a window over an aggregate's rows): the
    argument and RANGE key gathered, the layout's inverse made and the
    result gathered back through it, by K18."""
    from tidb_tpu_torch.executor import window as WX
    sql = ("SELECT l_flag, n, SUM(n) OVER (ORDER BY n RANGE BETWEEN 2 "
           "PRECEDING AND CURRENT ROW), MAX(p) OVER (PARTITION BY l_flag "
           "ORDER BY n ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM "
           "(SELECT l_flag, l_oid % 40 AS n, SUM(l_price) AS p FROM li "
           "GROUP BY l_flag, l_oid % 40) t")
    js, ts = twins
    want, _ = run_jax(js, sql)
    devs = []
    orig = WX.WindowExec._one_device

    def one(self, *a, **k):
        col = orig(self, *a, **k)
        devs.append(col is not None)
        return col

    spy.clear()
    WX.WindowExec._one_device = one
    try:
        got = run_port(ts, sql, extra=STRICT)
    finally:
        WX.WindowExec._one_device = orig
    assert devs and all(devs)
    assert {"gather", "inverse"} <= set(spy), spy
    assert_same(want, got)


def test_staged_dist_row_root_goes_through_k18(twins, spy, monkeypatch):
    """A staged dist fragment's row root and its broadcast side's stage 1:
    each rank's live rows compacted on the device (K22 + K18,
    `fragment.compact_rows`) before the fetch."""
    import inspect
    from tidb_tpu_torch.executor import fragment as F
    sql = ("SELECT l_oid, l_price, o_prio FROM li JOIN (SELECT * FROM od "
           "WHERE o_prio = 1) o ON l_oid = o_id")
    extra = {"tidb_tpu_dist_devices": 4}
    callers = set()
    real = F.compact_rows

    def compact(cols, live):
        callers.add(inspect.stack()[1].function)
        return real(cols, live)

    monkeypatch.setattr(F, "compact_rows", compact)
    js, ts = twins
    want, _ = run_jax(js, sql, extra=extra)
    spy.clear()
    got, frags = run_port_frags(ts, sql, extra={**STRICT, **extra})
    assert frags and all(f.plan.dist == 4 for f in frags)
    assert callers == {"_attempt_stage1", "_attempt_stage3"}, callers
    assert "gather" in spy
    assert_same(want, got)


#: the string IN over a ci column (o_seg: fold classes of two spellings)
#: and a cs one (o_tag), and the single-constant compares beside it
IN_CASES = {
    "ci_missing_item": "o_seg IN ('AUTO', 'nowhere')",
    "ci_null_item": "o_seg IN ('machinery', NULL)",
    "ci_every_code": ("o_seg IN ('auto', 'building', 'machinery', "
                      "'household', 'furniture')"),
    "ci_not_in": "o_seg NOT IN ('Building', 'zz')",
    "cs_missing_item": "o_tag IN ('a', 'q')",
    "cs_null_item": "o_tag IN (NULL, 'c')",
    "cs_every_code": "o_tag IN ('a', 'b', 'c', 'd')",
    "cs_no_listed_code": "o_tag IN ('x', 'y')",
    "cs_eq_absent": "o_tag = 'zz'",
    "cs_ne_absent": "o_tag <> 'zz'",
    "ci_eq_present": "o_seg = 'AUTO'",
    "ci_ne_present": "o_seg != 'HouseHold'",
}


@pytest.mark.parametrize("name", sorted(IN_CASES))
def test_string_in_matches_jax(twins, name):
    cond = IN_CASES[name]
    sql = (f"SELECT o_prio, COUNT(*), SUM(o_id) FROM od WHERE {cond} "
           f"GROUP BY o_prio")
    js, ts = twins
    want, _ = run_jax(js, sql)
    got, frags = run_port_frags(ts, sql, extra=STRICT)
    assert frags and all(f.used_device for f in frags)
    assert_same(want, got)


def test_string_in_is_one_k21_gather(twins, monkeypatch):
    """A ten-item IN list is one fill-mode gather of a bool table over the
    dictionary, true at the listed codes."""
    seen = []
    real = DL.dict_lut_plain

    def spy(table, codes, mode="clip", fill=-1):
        seen.append((table.dtype, table.shape[0], mode, fill))
        return real(table, codes, mode, fill)

    monkeypatch.setattr(DL, "dict_lut_plain", spy)
    items = ", ".join(f"'{t}'" for t in ["a", "c"] + [f"n{i}"
                                                     for i in range(8)])
    sql = f"SELECT COUNT(*) FROM od WHERE o_tag IN ({items})"
    js, ts = twins
    want, _ = run_jax(js, sql)
    got = run_port(ts, sql, extra=STRICT)
    assert_same(want, got)
    assert seen == [(torch.bool, len(TAGS), "fill", 0)]


def test_string_in_over_an_all_null_column(twins, monkeypatch):
    """A column of NULLs only: its one-entry dictionary's table, with a
    NULL item looked up as its `str`, on both engines."""
    seen = []
    real = DL.dict_lut_plain

    def spy(table, codes, mode="clip", fill=-1):
        seen.append(table.shape[0])
        return real(table, codes, mode, fill)

    monkeypatch.setattr(DL, "dict_lut_plain", spy)
    # the OR keeps the zone maps from pruning every slab
    sql = ("SELECT COUNT(*), SUM(k) FROM nul WHERE s IN ('a', NULL) "
           "OR k > 40")
    js, ts = twins
    want, _ = run_jax(js, sql)
    got, frags = run_port_frags(ts, sql, extra=STRICT)
    assert frags and all(f.used_device for f in frags)
    assert_same(want, got)
    assert seen == [1], seen


@pytest.mark.parametrize("ci", [False, True])
def test_string_in_over_an_empty_dictionary(ci):
    """An empty dictionary (no SQL statement reaches the device with one:
    only a column of no rows has it) prepares a table of no entry, and
    every row reads false, as the JAX package's device branch gives with
    its codeset [-1]: the two `_prepare_in` / `in` kernels side by side."""
    from tidb_tpu.expression import ColumnRef as JCol
    from tidb_tpu.expression import Constant as JConst
    from tidb_tpu.expression import EvalContext as JCtx
    from tidb_tpu.expression import ScalarFunc as JFunc
    from tidb_tpu.ops.jax_env import jnp
    from tidb_tpu.types import bigint as jbigint
    from tidb_tpu.types import varchar as jvarchar
    from tidb_tpu_torch.expression import (ColumnRef, Constant, EvalContext,
                                           ScalarFunc)
    from tidb_tpu_torch.ops.xp import TorchXP
    from tidb_tpu_torch.types import bigint, varchar
    rng = np.random.default_rng(43)
    codes = rng.integers(0, 3, 64).astype(np.int32)
    valid = rng.random(64) < 0.5
    empty = [np.array([], dtype=object)]
    jft, tft = jvarchar(8), varchar(8)
    if ci:
        import dataclasses
        jft = dataclasses.replace(jft, collation="utf8mb4_general_ci")
        tft = dataclasses.replace(tft, collation="utf8mb4_general_ci")
    jf = JFunc("in", [JCol(0, jft), JConst("a", jft), JConst(None, jft)],
               jbigint(True))
    tf = ScalarFunc("in", [ColumnRef(0, tft), Constant("a", tft),
                           Constant(None, tft)], bigint(True))
    jprep = jf.prepare(empty)
    tprep = tf.prepare(empty)
    assert tprep.dtype == np.bool_ and tprep.shape == (0,)
    jctx = JCtx(jnp, [(jnp.asarray(codes), jnp.asarray(valid))],
                prepared={id(jf): jprep}, on_device=True)
    tctx = EvalContext(TorchXP(torch.device("cpu")),
                       [(torch.from_numpy(codes), torch.from_numpy(valid))],
                       prepared={id(tf): torch.from_numpy(tprep)},
                       on_device=True)
    jv, jm = jf.eval(jctx)
    tv, tm = tf.eval(tctx)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tv.any()


def test_prepare_in_builds_the_bool_table():
    """`_prepare_in` → a bool table over the dictionary, true at the
    listed codes; the ci fold and a NULL item looked up as its `str`."""
    from tidb_tpu_torch.expression import (ColumnRef, Constant, ScalarFunc,
                                           _prepare_in)
    from tidb_tpu_torch.types import bigint, varchar
    cs = varchar(10)
    d = np.array(["None", "a", "b", "c"], dtype=object)

    def table(ft, *items):
        f = ScalarFunc("in", [ColumnRef(0, ft)] +
                       [Constant(v, cs) for v in items], bigint(True))
        return _prepare_in(f, [d])

    np.testing.assert_array_equal(table(cs, "b", "zz"),
                                  [False, False, True, False])
    np.testing.assert_array_equal(table(cs, None, "c"),
                                  [True, False, False, True])
    np.testing.assert_array_equal(table(cs), [False] * 4)
    out = _prepare_in(ScalarFunc("in", [ColumnRef(0, cs),
                                        Constant("a", cs)], bigint(True)),
                      [np.array([], dtype=object)])
    assert out.dtype == np.bool_ and out.shape == (0,)


def test_aligned_columns_own_their_storage(twins):
    """The FK-aligned join's cached build columns (device_cache.aligned_col)
    own their storage, as the delta merge's
    slabs do (tests/test_torch_delta.py::
    test_delta_merged_slabs_own_their_storage): a view of a shared buffer
    would pin its other outputs' bytes while cached."""
    from tidb_tpu_torch.executor import device_cache as DC
    sql = SITES["aligned_build"][0]
    js, ts = twins
    want, _ = run_jax(js, sql)
    assert_same(want, run_port(ts, sql, extra=STRICT))
    ents = [e for e in DC._ALIGNED.values() if e is not None and e.cols]
    assert ents
    for ent in ents:
        for slabs in ent.cols.values():
            for v, m in slabs:
                for t in (v, m):
                    assert t.untyped_storage().nbytes() <= \
                        -(-t.nbytes // 16) * 16, (t.shape, t.dtype)


def test_aligned_gather_of_limb_planes_matches_jax():
    """aligned_col's one gather a fact slab, `gather_slab(bv, bm, midx,
    keep=matched)`, over a wide decimal's (limbs, rows) build column,
    exactly the JAX package's `jnp.take(bv, midx, axis=-1)`,
    `jnp.take(bm, midx) & matched` (tidb_tpu/executor/device_cache.py
    aligned_col), each output its own tensor."""
    from tidb_tpu.ops.jax_env import jnp
    rng = np.random.default_rng(42)
    bv = rng.integers(-(1 << 40), 1 << 40, (3, 700))
    bm = rng.random(700) < 0.9
    midx = rng.integers(0, 700, 2048).astype(np.int32)
    matched = rng.random(2048) < 0.8
    midx[~matched] = 0          # as K5 leaves an unmatched row
    v, m = G.gather_slab(torch.from_numpy(bv), torch.from_numpy(bm),
                         torch.from_numpy(midx), keep=torch.from_numpy(matched))
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(jnp.take(jnp.asarray(bv), midx, axis=-1)))
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jnp.take(jnp.asarray(bm), midx)) & matched)
    for t in (v, m):
        assert t.untyped_storage().nbytes() == t.nbytes

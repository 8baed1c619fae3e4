"""DISTINCT and ROLLUP aggregates of the port against the JAX package on
the CPU.

* Ops: `dense_codes`, `distinct_pair_factorize` and `distinct_mask`
  (tidb_tpu_torch/ops/factorize.py, over the plain versions of K8-K10 and
  K16) against tidb_tpu.ops.factorize on seed-made inputs — int64 values
  with NULLs and dead rows, float64 with -0.0 and NaN, dictionary codes,
  group ids with the dead rows' cap — exactly equal: the first mask on
  the pair_live rows, the pair ids, n_pairs and rep[:n_pairs].
* Plain versions: the pair code and first mask the port keeps beside
  K16 against the reference's own expressions (`gids·(n+1)+vid`,
  `take(rep, pg) == iota`), K17
  against `_rollup_tile`'s concatenate (a 2-D limb plane among the
  columns) and the ROLLUP branch's level masks, K18 against
  emit_distinct's gathers (the whole pair output of emit_distinct, port
  against reference).
* SQL: twin sessions (tests/torch_diff.py) on the reference's own shapes
  (tests/test_whole_query.py's multi-arg and multiple DISTINCT aggregates,
  tests/test_tree_fragment.py's multi-slab DISTINCT at 1000- and 300-row
  slabs, tests/test_rollup.py's ROLLUP_QUERIES) and a pair-ladder case
  (a small tidb_tpu_distinct_pair_cap over several slabs, which must
  climb "pairs" rungs). The port's Engine(device="cpu") fragments run
  under tidb_tpu_strict=1 and report used_device with no fallback; rows
  equal the JAX engine's (device on, CPU backend). DISTINCT under ROLLUP
  stays on the host in both (a multi-argument DISTINCT other than COUNT,
  which the gates also refuse, is refused by the planner before them).
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.executor import device_emit as TE
from tidb_tpu_torch.expression import EvalContext as TCtx
from tidb_tpu_torch.ops import factorize as TF
from tidb_tpu_torch.ops import gather as TG
from tidb_tpu_torch.ops.xp import TorchXP
from torch_diff import collect_jax_sessions  # noqa: F401  (autouse)

N = 3000


def _ref():
    """(jnp, tidb_tpu.ops.factorize, tidb_tpu.executor.device_emit)."""
    import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
    from tidb_tpu.executor import device_emit as JE
    from tidb_tpu.ops import factorize as JF
    from tidb_tpu.ops.jax_env import jnp
    return jnp, JF, JE


def _values(kind, n, rng):
    if kind == "i64":
        return rng.integers(-40, 40, n).astype(np.int64)
    if kind == "f64":
        return rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, 3.0,
                                    np.inf]), n)
    return rng.integers(0, 9, n).astype(np.int32)          # dict codes


def _pair_inputs(kind, seed, n=N, cap=12):
    """(gids with the dead rows' cap, values, validity, live)."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) > 0.2
    gids = np.where(live, rng.integers(0, cap, n), cap).astype(np.int32)
    vals = _values(kind, n, rng)
    valid = rng.random(n) > 0.1
    return gids, vals, valid, live


KINDS = ("i64", "f64", "code")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_cap", [False, True])
def test_distinct_pair_factorize_matches_jax(kind, with_cap):
    jnp, JF, _ = _ref()
    gids, vals, valid, live = _pair_inputs(kind, 5 + KINDS.index(kind))
    jf, jpg, jnp_, jrep = JF.distinct_pair_factorize(
        jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(live), N)
    tf, tpg, tnp_, trep = TF.distinct_pair_factorize(
        torch.from_numpy(gids), torch.from_numpy(vals),
        torch.from_numpy(valid), torch.from_numpy(live), N,
        gid_cap=12 if with_cap else None)
    pl = live & valid
    n_pairs = int(jnp_)
    assert int(tnp_) == n_pairs > 0
    np.testing.assert_array_equal(tf.numpy()[pl], np.asarray(jf)[pl])
    np.testing.assert_array_equal(tpg.numpy()[pl], np.asarray(jpg)[pl])
    np.testing.assert_array_equal(trep.numpy()[:n_pairs],
                                  np.asarray(jrep)[:n_pairs])
    jm = JF.distinct_mask(jnp.asarray(gids), jnp.asarray(vals),
                          jnp.asarray(valid), jnp.asarray(live))
    tm = TF.distinct_mask(torch.from_numpy(gids), torch.from_numpy(vals),
                          torch.from_numpy(valid), torch.from_numpy(live))
    np.testing.assert_array_equal(tm.numpy()[pl], np.asarray(jm)[pl])


@pytest.mark.parametrize("spec", [("i64",), ("f64",), ("code", "i64"),
                                  ("i64", "code", "f64")],
                         ids=lambda s: "-".join(s))
def test_dense_codes_match_jax(spec):
    jnp, JF, _ = _ref()
    rng = np.random.default_rng(len(spec))
    keys = [(_values(k, N, rng), rng.random(N) > 0.1) for k in spec]
    live = rng.random(N) > 0.2
    want = JF.dense_codes([(jnp.asarray(v), jnp.asarray(m))
                           for v, m in keys], jnp.asarray(live))
    got = TF.dense_codes([(torch.from_numpy(v), torch.from_numpy(m))
                          for v, m in keys], torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])


def test_all_dead_and_all_null_pairs():
    jnp, JF, _ = _ref()
    gids, vals, _valid, _live = _pair_inputs("i64", 3, n=64)
    zeros, ones = np.zeros(64, dtype=bool), np.ones(64, dtype=bool)
    for valid, lv in ((zeros, ones), (ones, zeros)):
        _jf, _jpg, jn, jrep = JF.distinct_pair_factorize(
            jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(valid),
            jnp.asarray(lv), 64)
        _tf, _tpg, tn, trep = TF.distinct_pair_factorize(
            torch.from_numpy(gids), torch.from_numpy(vals),
            torch.from_numpy(valid), torch.from_numpy(lv), 64, gid_cap=12)
        assert int(tn) == int(jn) == 0
        np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))


# ---------------------------------------------------------------------------
# Plain versions of K16-K18 against the reference's own expressions
# ---------------------------------------------------------------------------


def test_k16_plain_matches_reference_expressions():
    jnp, JF, _ = _ref()
    rng = np.random.default_rng(11)
    gids, vals, valid, live = _pair_inputs("i64", 11)
    pl = live & valid
    vid = np.asarray(JF._dense1(jnp.asarray(vals), None, jnp.asarray(pl)))
    want = np.asarray(jnp.asarray(gids).astype(jnp.int64) *
                      jnp.int64(N + 1) + jnp.asarray(vid).astype(jnp.int64))
    got = TF.pair_code_plain(torch.from_numpy(gids), torch.from_numpy(vid))
    np.testing.assert_array_equal(got.numpy(), want)
    for cap in (1, 7, 200):
        rep = rng.integers(0, N, cap).astype(np.int32)
        rep[: cap // 2] = np.arange(cap // 2)      # some rows are firsts
        pg = rng.integers(0, cap, N).astype(np.int32)
        want = np.asarray(jnp.take(jnp.asarray(rep), jnp.asarray(pg)) ==
                          jnp.arange(N, dtype=jnp.int32))
        got = TF.first_mask_plain(torch.from_numpy(rep),
                                  torch.from_numpy(pg))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nk", [1, 2, 3])
def test_k17_plain_matches_rollup_tile(nk):
    """The tiled context of the port's _rollup_tile (K17 plain) equals
    the reference's concatenate on every column it tiles — 1-D values of
    each width, masks and a 2-D limb plane — and `live`; the level
    masks equal the ROLLUP branch's `m & (lev < nk - i)`."""
    jnp, _JF, JE = _ref()
    from tidb_tpu.expression import ColumnRef as JRef
    from tidb_tpu.expression import EvalContext as JCtx
    from tidb_tpu.planner.physical import PhysHashAgg as JAgg
    from tidb_tpu.types import bigint as jbigint
    from tidb_tpu_torch.expression import ColumnRef as TRef
    from tidb_tpu_torch.planner.physical import PhysHashAgg as TAgg
    from tidb_tpu_torch.types import bigint as tbigint
    rng = np.random.default_rng(nk)
    n = 257
    cols = [(rng.integers(-9, 9, n).astype(np.int64), rng.random(n) > .2),
            (rng.integers(0, 5, n).astype(np.int32), rng.random(n) > .2),
            (rng.random(n) > 0.5, np.ones(n, dtype=bool)),
            (rng.integers(0, 1 << 40, (3, n)).astype(np.int64),
             rng.random(n) > .1),
            (rng.normal(size=n), rng.random(n) > .2)]
    live = rng.random(n) > 0.3

    class _Desc:
        def __init__(self, ref):
            self.name, self.args, self.distinct = "count", [ref], False

    def plan(Agg, Ref, bigint):
        keys = [Ref(i, bigint()) for i in range(nk)]
        aggs = [_Desc(Ref(3, bigint())), _Desc(Ref(4, bigint()))]
        p = Agg.__new__(Agg)
        p.group_exprs, p.aggs, p.rollup = keys, aggs, True
        return p

    jctx = JCtx(jnp, [(jnp.asarray(v), jnp.asarray(m)) for v, m in cols])
    tctx = TCtx(TorchXP("cpu"), [(torch.from_numpy(v), torch.from_numpy(m))
                                 for v, m in cols])
    jt, jl = JE._rollup_tile(jctx, jnp.asarray(live),
                             plan(JAgg, JRef, jbigint))
    tt, tl = TE._rollup_tile(tctx, torch.from_numpy(live),
                             plan(TAgg, TRef, tbigint))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    read = set(range(nk)) | {3, 4}
    for i in range(len(cols)):
        if i not in read:
            assert tt.column(i) is None      # nothing reads it: not tiled
            continue
        for a, b in zip(tt.column(i), jt.column(i)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tt.num_rows == n * (nk + 1)
    masks = [torch.from_numpy(np.tile(cols[i][1], nk + 1))
             for i in range(nk)]
    lev, got = TE.rollup_levels_plain(masks, n)
    jlev = jnp.repeat(jnp.arange(nk + 1, dtype=jnp.int64), n)
    np.testing.assert_array_equal(lev.numpy(), np.asarray(jlev))
    for i, m in enumerate(got):
        want = jnp.asarray(masks[i].numpy()) & (jlev < nk - i)
        np.testing.assert_array_equal(m.numpy(), np.asarray(want))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("pair_cap", [0, 50, 5000])
def test_emit_distinct_pair_output_matches_jax(multi, pair_cap):
    """emit_distinct's first mask and pair output (the K18 gather of the
    key and raw argument columns through rep[:pc], cut at n_pairs), port
    against reference, single- and multi-argument."""
    jnp, _JF, JE = _ref()
    rng = np.random.default_rng(21 + pair_cap + multi)
    n = 1500
    gids, vals, valid, live = _pair_inputs("i64", 31 + multi, n=n, cap=9)
    k1 = (rng.integers(0, 4, n).astype(np.int32), rng.random(n) > 0.1)
    k2 = (rng.normal(size=n), rng.random(n) > 0.1)
    if multi:
        vcols = [(vals, valid & live),
                 (rng.integers(0, 3, n).astype(np.int32),
                  (rng.random(n) > 0.1) & live)]
        m = live & vcols[0][1] & vcols[1][1]
        from tidb_tpu.ops import factorize as JF
        jcode = JF.dense_codes([(jnp.asarray(v), jnp.asarray(mm))
                                for v, mm in vcols], jnp.asarray(live))
        tcode = TF.dense_codes([(torch.from_numpy(v), torch.from_numpy(mm))
                                for v, mm in vcols], torch.from_numpy(live))
        np.testing.assert_array_equal(tcode.numpy()[m], np.asarray(jcode)[m])
        jargs = (jcode, jnp.asarray(m))
        targs = (tcode, torch.from_numpy(m))
        jvc = [(jnp.asarray(v), jnp.asarray(mm)) for v, mm in vcols]
        tvc = [(torch.from_numpy(v), torch.from_numpy(mm))
               for v, mm in vcols]
    else:
        m = live & valid
        jargs = (jnp.asarray(vals), jnp.asarray(m))
        targs = (torch.from_numpy(vals), torch.from_numpy(m))
        jvc = tvc = None
    keys = [k1, k2]
    jf, (jcols, jn) = JE.emit_distinct(
        jnp.asarray(gids), *jargs, jnp.asarray(live), n,
        [(jnp.asarray(v), jnp.asarray(mm)) for v, mm in keys], True,
        pair_cap, vcols=jvc)
    tf, (tcols, tn) = TE.emit_distinct(
        torch.from_numpy(gids), *targs, torch.from_numpy(live), n,
        [(torch.from_numpy(v), torch.from_numpy(mm)) for v, mm in keys],
        True, pair_cap, vcols=tvc, group_cap=9)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tf.numpy()[m], np.asarray(jf)[m])
    assert len(tcols) == len(jcols) == 2 + (2 if multi else 1)
    for (tv, tm), (jv_, jm) in zip(tcols, jcols):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tv.numpy()[tm.numpy()],
                                      np.asarray(jv_)[np.asarray(jm)])


def test_k18_plain_with_and_without_masks():
    rng = np.random.default_rng(2)
    v8 = torch.from_numpy(rng.integers(-5, 5, 40).astype(np.int8))
    v64 = torch.from_numpy(rng.normal(size=40))
    m = torch.from_numpy(rng.random(40) > 0.3)
    idx = torch.from_numpy(rng.integers(0, 40, 25).astype(np.int32))
    out = TG.gather_columns([(v8, m), (v64, None)], idx,
                            torch.tensor(17, dtype=torch.int32))
    ix = idx.long()
    slot = torch.arange(25) < 17
    assert torch.equal(out[0][0], v8[ix]) and torch.equal(out[1][0], v64[ix])
    assert torch.equal(out[0][1], m[ix] & slot)
    assert torch.equal(out[1][1], slot)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A non-CPU tensor goes to a kernel or raises — here, with no CUDA
    device, a meta tensor must raise rather than fall back."""
    i32 = torch.empty(8, dtype=torch.int32, device="meta")
    b = torch.empty(8, dtype=torch.bool, device="meta")
    n_valid = torch.empty((), dtype=torch.int32, device="meta")
    i64 = torch.empty(8, dtype=torch.int64, device="meta")
    for call in (lambda: TF.pair_word(i32, i32, b, 4),
                 lambda: TF.group_ids_words(i64, i32, 7, None, 3, 8,
                                            first=True),
                 lambda: TE.rollup_tile([i32, b], 3),
                 lambda: TE.rollup_levels([b], 4),
                 lambda: TG.gather_columns([(i32, b)], i32, n_valid)):
        with pytest.raises(Exception):
            call()


# ---------------------------------------------------------------------------
# SQL on twin sessions
# ---------------------------------------------------------------------------

DDL = [
    "CREATE TABLE md (g BIGINT, a BIGINT, b BIGINT, v BIGINT)",
    "CREATE TABLE orders (o_id BIGINT, o_date DATE, o_prio BIGINT, "
    "o_seg VARCHAR(12))",
    "CREATE TABLE li (l_oid BIGINT, l_price DECIMAL(12,2), "
    "l_disc DECIMAL(12,2), l_ship DATE)",
    "CREATE TABLE r (a BIGINT, b BIGINT, c BIGINT, d DOUBLE, s VARCHAR(8))",
    "CREATE TABLE dim (a BIGINT, name BIGINT)",
]


def _tables():
    rng = np.random.default_rng(23)
    n = 3000
    md = ({"g": rng.integers(0, 6, n).astype(np.int64),
           "a": rng.integers(0, 12, n).astype(np.int64),
           "b": rng.integers(0, 9, n).astype(np.int64),
           "v": rng.integers(0, 400, n).astype(np.int64)},
          {"b": rng.random(n) > 0.05})
    no, nl = 500, 5000
    segs = np.array(["BUILDING", "AUTO", "STEEL"], dtype=object)
    orders = ({"o_id": np.arange(no, dtype=np.int64),
               "o_date": rng.integers(9131, 10500, no).astype(np.int32),
               "o_prio": rng.integers(0, 5, no).astype(np.int64),
               "o_seg": segs[rng.integers(0, 3, no)]}, None)
    li = ({"l_oid": rng.integers(0, no + 60, nl).astype(np.int64),
           "l_price": rng.integers(100, 90000, nl).astype(np.int64),
           "l_disc": rng.integers(0, 10, nl).astype(np.int64),
           "l_ship": rng.integers(9131, 10700, nl).astype(np.int32)},
          {"l_oid": rng.random(nl) > 0.02})
    nr = 4000
    r = ({"a": rng.integers(1, 6, nr).astype(np.int64),
          "b": rng.integers(1, 8, nr).astype(np.int64),
          "c": rng.integers(1, 1000, nr).astype(np.int64),
          "d": np.round(rng.uniform(0, 100, nr), 3),
          "s": np.array(["ant", "bee", "cow", "ant"],
                        dtype=object)[rng.integers(0, 4, nr)]},
         {"a": rng.random(nr) > 0.04, "b": rng.random(nr) > 0.04,
          "s": rng.random(nr) > 0.25})
    dim = ({"a": np.arange(1, 6, dtype=np.int64),
            "name": np.arange(1, 6, dtype=np.int64) * 10}, None)
    return {"md": md, "orders": orders, "li": li, "r": r, "dim": dim}


@pytest.fixture(scope="module")
def twins():
    from torch_diff import twin_sessions
    return twin_sessions(DDL, _tables())


STRICT = {"tidb_tpu_strict": 1}

ROLLUP_QUERIES = [
    "SELECT a, b, COUNT(*), SUM(c), MIN(c), MAX(c) FROM r "
    "GROUP BY a, b WITH ROLLUP",
    "SELECT a, COUNT(*), SUM(c), AVG(c) FROM r GROUP BY a WITH ROLLUP",
    "SELECT s, a, COUNT(*), SUM(d) FROM r GROUP BY s, a WITH ROLLUP",
    "SELECT a, b, COUNT(*), SUM(c) FROM r GROUP BY a, b WITH ROLLUP "
    "ORDER BY a, b, 3 LIMIT 10",
    "SELECT a, b, SUM(c) FROM r GROUP BY a, b WITH ROLLUP "
    "HAVING SUM(c) > 100000",
    "SELECT a, SUM(c) FROM r GROUP BY a WITH ROLLUP ORDER BY a",
]

#: (statement, max_slab): tests/test_whole_query.py:143-160,
#: tests/test_tree_fragment.py:214-245 and tests/test_rollup.py
SQL_CASES = {
    "multi_arg_count": ("SELECT g, COUNT(DISTINCT a, b), COUNT(*) FROM md "
                        "GROUP BY g", None),
    "several_distinct": ("SELECT g, COUNT(DISTINCT a), COUNT(DISTINCT b), "
                         "SUM(v) FROM md GROUP BY g", None),
    "scalar_root": ("SELECT COUNT(DISTINCT a), COUNT(DISTINCT b), "
                    "COUNT(DISTINCT a, b) FROM md WHERE v < 300", None),
    "multislab_scalar": ("SELECT COUNT(DISTINCT l_oid), COUNT(*) FROM li "
                         "WHERE l_ship < '1999-01-01'", 1000),
    "multislab_grouped": ("SELECT l_ship, COUNT(DISTINCT l_oid) FROM li "
                          "GROUP BY l_ship", 1000),
    "distinct_sum_avg": ("SELECT SUM(DISTINCT l_oid), AVG(DISTINCT l_oid), "
                         "COUNT(*) FROM li", 300),
    "distinct_over_join": ("SELECT o_prio, COUNT(DISTINCT l_oid), "
                           "SUM(DISTINCT l_oid), SUM(l_price) FROM li JOIN "
                           "orders ON l_oid = o_id GROUP BY o_prio", 300),
    "dict_arg": ("SELECT o_prio, COUNT(DISTINCT o_seg), COUNT(DISTINCT "
                 "o_id) FROM orders GROUP BY o_prio", 300),
    "multi_arg_multislab": ("SELECT g, COUNT(DISTINCT a, b) FROM md "
                            "GROUP BY g ORDER BY g", 1000),
    "rollup_multislab": (ROLLUP_QUERIES[0], 1024),
    "rollup_join": ("SELECT dim.name, r.b, COUNT(*), SUM(r.c) FROM r "
                    "JOIN dim ON r.a = dim.a "
                    "GROUP BY dim.name, r.b WITH ROLLUP", None),
}
SQL_CASES.update({f"rollup_{i}": (q, None)
                  for i, q in enumerate(ROLLUP_QUERIES)})


@pytest.mark.parametrize("case", list(SQL_CASES))
def test_distinct_rollup_sql_matches_jax_engine(twins, case):
    from torch_diff import assert_same, run_jax, run_port
    js, ts = twins
    sql, max_slab = SQL_CASES[case]
    want, jfrags = run_jax(js, sql, max_slab=max_slab)
    assert jfrags and all(f.used_device for f in jfrags), case
    got = run_port(ts, sql, max_slab=max_slab, extra=STRICT)
    assert_same(got, want, ordered="ORDER BY" in sql)


@pytest.mark.parametrize("sql", [
    "SELECT a, COUNT(DISTINCT b) FROM r GROUP BY a WITH ROLLUP",
    "SELECT dim.name, COUNT(DISTINCT r.b) FROM r JOIN dim ON r.a = dim.a "
    "GROUP BY dim.name WITH ROLLUP",
], ids=["chain", "join"])
def test_distinct_rollup_stays_on_the_host(twins, sql):
    """DISTINCT under ROLLUP runs on the host engine in both packages
    (the reference's plan-time gates, chain and tree), with equal rows."""
    from torch_diff import _run, assert_same, run_jax
    from tidb_tpu_torch.executor import build, run_to_completion
    from tidb_tpu_torch.executor.fragment import TpuFragmentExec
    from tidb_tpu_torch.parser import parse
    def agg_on_device(frags):
        def has_agg(p):
            return type(p).__name__ == "PhysHashAgg" or \
                any(has_agg(c) for c in p.children)
        return any(f.used_device and has_agg(f.plan.root) for f in frags)

    js, ts = twins
    want, jfrags = run_jax(js, sql)
    assert not agg_on_device(jfrags)
    got, tfrags = _run(ts, sql, parse, build, run_to_completion,
                       TpuFragmentExec, None, None)
    assert not agg_on_device(tfrags)
    assert_same(got, want)


@pytest.mark.parametrize("path", ["chain", "fused"])
def test_pair_ladder_resizes_and_stays_exact(twins, path):
    """A pair cap far below the per-slab pair count over several slabs:
    the pair output climbs "pairs" rungs (re-running only the slabs that
    overflowed) and the result still equals the JAX engine."""
    from torch_diff import assert_same, run_jax
    from tidb_tpu_torch.executor import build, run_to_completion
    from tidb_tpu_torch.parser import parse
    js, ts = twins
    sql = ("SELECT l_ship, COUNT(DISTINCT l_oid), SUM(l_price) FROM li "
           "GROUP BY l_ship" if path == "chain" else
           "SELECT o_prio, COUNT(DISTINCT l_oid) FROM li JOIN orders "
           "ON l_oid = o_id GROUP BY o_prio")
    extra = {"tidb_tpu_distinct_pair_cap": 16, "tidb_tpu_strict": 1,
             "tidb_tpu_specialization_cache": 0, "tidb_tpu_engine": "on",
             "tidb_tpu_row_threshold": 1, "tidb_tpu_max_slab_rows": 1000}
    want, _ = run_jax(js, sql, max_slab=1000)
    ts.vars.update(extra)
    try:
        ctx = ts._exec_ctx()
        root = build(ts._plan(parse(sql)[0]))
        got = [r for ch in run_to_completion(root, ctx) for r in ch.rows()]
    finally:
        for k in extra:
            ts.vars.pop(k, None)
        ts.vars["tidb_tpu_engine"] = "off"
    assert_same(got, want)
    rungs = dict(ctx.escalation.by_kind)
    assert any(k.startswith("pairs:") for k in rungs), rungs


def test_q16_shape_keeps_its_hash_agg_inside_the_fragment(twins):
    """tools/coverage.py's q16 shape (grouped COUNT(DISTINCT) over a
    join, ORDER BY the DISTINCT count): EXPLAIN shows the HashAgg inside
    the TpuFragment, the TopN above it on the host."""
    from torch_diff import assert_same, run_jax, run_port
    js, ts = twins
    sql = ("SELECT o_prio, o_seg, COUNT(DISTINCT l_oid) FROM li JOIN "
           "orders ON l_oid = o_id WHERE o_prio <> 3 AND o_date < "
           "'1998-01-01' GROUP BY o_prio, o_seg ORDER BY 3 DESC, o_prio, "
           "o_seg LIMIT 8")
    ts.vars["tidb_tpu_engine"] = "on"
    ts.vars["tidb_tpu_row_threshold"] = 1
    try:
        text = "\n".join(str(r[0]) for r in
                         ts.query("EXPLAIN " + sql).rows)
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    frag = text.index("TpuFragment")
    assert "HashAgg" in text[frag:], text
    want, _ = run_jax(js, sql)
    assert_same(run_port(ts, sql, extra=STRICT), want, ordered=True)

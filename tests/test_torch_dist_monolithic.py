"""The monolithic distributed program on the port (tidb_tpu_torch/
executor/dist_fragment.DistTreeProgram, run by fragment._run_dist_
monolithic) against the JAX package's shard_map program, both with
`tidb_tpu_dist_devices = 4` and both staged flags off: the JAX package
on 4 of its 8 virtual XLA CPU devices, the port's 4 ranks on `cpu`.

The tables and statements are tests/test_torch_dist.py's (every shape
of its SHAPES, the TopN over a join and the three-table join whose
exchange sits over a join), filled from the same seed-made numpy
columns on both engines and compared by tests/test_fragment.py's rule.
Every shape is also held with one staged flag off (the other path
still takes what it takes, the monolithic program the rest). Also
pinned: the port's staged rows equal its monolithic rows (the
counterpart of tests/test_mesh_chaos.py's staged-vs-monolithic check);
a skewed exchange under a small tidb_tpu_exchange_bucket_cap resizes
once, with the reference's escalation counts and one more program build
(tests/test_dist_sql.py's skew case); one `shard-step` fault heals with
one full-step retry; a persistent one is one typed ShardFailure."""

import pytest

import test_torch_dist as TD
from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        run_jax, run_port_frags, twin_sessions)
from tidb_tpu_torch.errors import ShardFailure
from tidb_tpu_torch.util import failpoint

OFF = {"tidb_tpu_dist_staged": "off", "tidb_tpu_dist_staged_exchange": "off"}
MONO = {**TD.DIST, **OFF}
SHAPES = dict(TD.SHAPES, topn_join=TD.TOPN_JOIN, join3=TD.JOIN3)


@pytest.fixture(scope="module")
def twins():
    return twin_sessions(TD.DDL, TD._tables())


def _ordered(sql: str) -> bool:
    return "ORDER BY" in sql.split("OVER")[-1]


@pytest.mark.parametrize("name", list(SHAPES))
def test_monolithic_shape_matches_jax(twins, name):
    js, ts = twins
    sql = SHAPES[name]
    want, jfrags = run_jax(js, sql, extra=MONO)
    got, frags = run_port_frags(ts, sql, extra=MONO)
    assert jfrags and all(f.plan.dist == 4 for f in jfrags), sql
    assert frags and all(f.plan.dist == 4 for f in frags), sql
    assert_same(want, got, ordered=_ordered(sql))


@pytest.mark.parametrize("flag", ["tidb_tpu_dist_staged",
                                  "tidb_tpu_dist_staged_exchange"],
                         ids=["agg_off", "exchange_off"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_one_staged_flag_off_matches_jax(twins, name, flag):
    js, ts = twins
    sql = SHAPES[name]
    extra = {**TD.DIST, flag: "off"}
    want, _ = run_jax(js, sql, extra=extra)
    got, frags = run_port_frags(ts, sql, extra=extra)
    assert frags and all(f.plan.dist == 4 for f in frags), sql
    assert_same(want, got, ordered=_ordered(sql))


@pytest.mark.parametrize("name", ["q1_chain", "ungrouped", "q3_join_agg",
                                  "distinct_global", "window_root",
                                  "row_root_join"])
def test_staged_rows_equal_monolithic_rows(twins, name):
    """The same statement through the port's staged path (flags on) and
    its monolithic program (flags off): the same rows."""
    _js, ts = twins
    sql = SHAPES[name]
    staged, _ = run_port_frags(ts, sql, extra=TD.DIST)
    mono, _ = run_port_frags(ts, sql, extra=MONO)
    assert_same(staged, mono, ordered=_ordered(sql))


def _query(s, sql, extra):
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   **MONO, **extra})
    try:
        return s.query(sql).rows
    finally:
        s.vars["tidb_tpu_engine"] = "off"
        for k in list(MONO) + list(extra):
            s.vars.pop(k, None)


def test_skewed_exchange_resizes_once_like_the_reference(twins,
                                                         monkeypatch):
    """3 distinct group keys hash onto at most 3 of 4 ranks: the re-key
    exchange overflows a 64-row bucket cap, reports its exact need, and
    the step re-runs once with that one exchange resized — the same
    escalation counts as the JAX package's monolithic path, and exactly
    one more program build."""
    from tidb_tpu_torch.executor import dist_fragment as DF
    from tidb_tpu_torch.executor import fragment as FR
    js, ts = twins
    sql = ("SELECT l_flag, COUNT(DISTINCT l_oid) FROM li GROUP BY l_flag")
    cap = {"tidb_tpu_exchange_bucket_cap": 64}
    want = _query(js, sql, cap)
    jesc = TD._esc(js)
    builds = []
    orig = DF.DistTreeProgram.__init__

    def counting(self, *a, **k):
        builds.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(DF.DistTreeProgram, "__init__", counting)
    FR._COMPILE_CACHE.clear()
    got = _query(ts, sql, cap)
    tesc = TD._esc(ts)
    assert_same(want, got)
    assert tesc == jesc, (tesc, jesc)
    assert tesc["by_kind"].get("exchange:exact") == 1
    assert tesc["recompiles"] == 1
    assert len(builds) == 2, builds        # initial + exactly one resize


@pytest.fixture
def clean_failpoints():
    yield
    failpoint.disable_all()
    failpoint.reset_counters()


@pytest.mark.parametrize("name", ["q1_chain", "q3_join_agg", "topn_join"])
def test_one_shard_fault_heals_with_one_full_step_retry(twins, name,
                                                        clean_failpoints):
    js, ts = twins
    sql = SHAPES[name]
    want = _query(js, sql, {})
    with failpoint.enabled("shard-step",
                           raise_=ShardFailure("chaos: rank down"),
                           times=1):
        got = _query(ts, sql, {})
    assert_same(want, got, ordered=_ordered(sql))
    e = ts.last_guard.escalation
    assert e.shard_retries == 1
    assert e.degraded_mesh == 0


def test_persistent_fault_is_one_typed_shard_failure(twins,
                                                     clean_failpoints):
    js, ts = twins
    sql = SHAPES["q3_join_agg"]
    with failpoint.enabled("shard-step",
                           raise_=ShardFailure("chaos: device down")):
        with pytest.raises(ShardFailure) as ei:
            _query(ts, sql, {})
    assert ei.value.code == 1105 and ei.value.retryable
    assert "failed twice" in str(ei.value)
    assert ts.last_guard.escalation.shard_retries == 1
    # the session stays usable
    assert_same(_query(js, sql, {}), _query(ts, sql, {}))

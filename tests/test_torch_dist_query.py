"""The distributed Q3-shaped step on the port (tidb_tpu_torch/parallel/
dist_query.py: build_agg_join_step over rank lists, the run_agg_join
ladder, reference_agg_join) against the JAX package's
(tidb_tpu/parallel/dist_query.py) on 4 of its 8 virtual XLA CPU devices,
the port on 4 ranks on `cpu`.

The cases are tests/test_parallel.py's agg-join and tests/test_mesh_chaos
.py's adversarial distributions: every row one key (the exchange funnels
everything to one rank), a group explosion past group_cap, NULL-heavy
probe keys, skew and explosion together, and ladder exhaustion as a
typed CapacityError. Inputs are made from a seed with numpy; both sides
must return the same dict of groups and the same EscalationStats counts.
Integer-valued payloads are held exactly; the uniform-float case within
1e-9 relative (the two sides add in different orders)."""

import numpy as np
import pytest

from tidb_tpu.parallel import make_mesh as j_make_mesh
from tidb_tpu.parallel.dist_query import reference_agg_join as j_reference
from tidb_tpu.parallel.dist_query import run_agg_join as j_run
from tidb_tpu_torch.errors import CapacityError
from tidb_tpu_torch.parallel import collective as C
from tidb_tpu_torch.parallel import make_mesh
from tidb_tpu_torch.parallel.dist_query import (build_agg_join_step,
                                                reference_agg_join,
                                                run_agg_join)
from tidb_tpu_torch.parallel import shard_rows


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return j_make_mesh(4), make_mesh(4, "cpu")


def _build(b, n_groups=5):
    bk = np.arange(b, dtype=np.int64)
    bg = (bk % n_groups).astype(np.int64)
    bw = np.ones(b, dtype=np.float64)        # integer-valued: exact sums
    return bk, bg, bw


def _stats(st):
    return {"by_kind": dict(st.by_kind), "recompiles": st.recompiles,
            "exact_resizes": st.exact_resizes, "total": st.total}


def _both(meshes, *args, **kw):
    jmesh, tmesh = meshes
    jout, jst = j_run(jmesh, *args, **kw)
    tout, tst = run_agg_join(tmesh, *args, **kw)
    return jout, _stats(jst), tout, _stats(tst)


def _case(name):
    if name == "all_rows_one_shard":
        n, b = 512, 64
        rng = np.random.default_rng(7)
        pk = np.full(n, 13, dtype=np.int64)
        px = rng.integers(0, 100, n).astype(np.float64)
        return (pk, px, np.zeros(n)) + _build(b), \
            dict(bucket_cap=16, group_cap=64, filter_limit=0.5)
    if name == "dense_group_explosion":
        n, b = 1024, 256
        rng = np.random.default_rng(11)
        pk = rng.integers(0, b, n).astype(np.int64)
        px = rng.integers(0, 50, n).astype(np.float64)
        pq = rng.uniform(0, 1, n)
        bk = np.arange(b, dtype=np.int64)
        return (pk, px, pq, bk, bk.copy(), np.ones(b)), \
            dict(bucket_cap=1024, group_cap=16, filter_limit=0.7)
    if name == "null_heavy_keys":
        n, b = 1024, 128
        rng = np.random.default_rng(23)
        pk = rng.integers(0, b, n).astype(np.int64)
        px = rng.integers(0, 30, n).astype(np.float64)
        pq = rng.uniform(0, 1, n)
        live = rng.random(n) >= 0.7
        return (pk, px, pq) + _build(b), \
            dict(bucket_cap=512, group_cap=64, filter_limit=0.6,
                 p_live=live)
    if name == "skew_and_group_explosion":
        n, b = 768, 192
        rng = np.random.default_rng(31)
        pk = np.where(rng.random(n) < 0.9, 5,
                      rng.integers(0, b, n)).astype(np.int64)
        px = rng.integers(0, 20, n).astype(np.float64)
        bk = np.arange(b, dtype=np.int64)
        return (pk, px, np.zeros(n), bk, bk.copy(), np.ones(b)), \
            dict(bucket_cap=32, group_cap=16, filter_limit=0.5)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["all_rows_one_shard",
                                  "dense_group_explosion",
                                  "null_heavy_keys",
                                  "skew_and_group_explosion"])
def test_ladder_matches_jax(meshes, name):
    args, kw = _case(name)
    jout, jst, tout, tst = _both(meshes, *args, **kw)
    assert tout == jout
    assert tst == jst, (tst, jst)
    # and the oracle: every group, byte-exact (integer-valued payloads)
    pk, px, pq, bk, bg, bw = args
    keep = kw.get("p_live", np.ones(len(pk), dtype=bool))
    s, c = reference_agg_join(pk[keep], px[keep], pq[keep], bk, bg, bw,
                              kw["filter_limit"])
    assert tout == {g: (float(s[g]), int(c[g])) for g in s}


def test_agg_join_step_matches_jax_and_oracle(meshes):
    """tests/test_parallel.py's agg-join: uniform floats, capacities held
    (no ladder), every rank owning a disjoint set of groups."""
    _jmesh, tmesh = meshes
    rng = np.random.default_rng(0)
    n, b = 1024, 256
    pk = rng.integers(0, b, n).astype(np.int64)
    px = rng.uniform(0, 10, n)
    pq = rng.uniform(0, 1, n)
    bk = np.arange(b, dtype=np.int64)
    bg = rng.integers(0, 5, b).astype(np.int64)
    bw = rng.uniform(0.5, 1.5, b)
    step = build_agg_join_step(tmesh, bucket_cap=n, group_cap=64,
                               filter_limit=0.7)
    out = step(*shard_rows(tmesh, [pk, px, pq, np.ones(n, bool), bk, bg,
                                   bw, np.ones(b, bool)]))
    kv, km, sums, counts, live, need, gneed = out
    assert int(need) <= n and int(gneed) <= 64
    got = {}
    for g, m, s, c, lv in zip(*(t.numpy() for t in
                                (kv, km, sums, counts, live))):
        if lv and m:
            assert int(g) not in got     # ranks own disjoint group sets
            got[int(g)] = (float(s), int(c))
    jout, _jst = j_run(meshes[0], pk, px, pq, bk, bg, bw, bucket_cap=n,
                       group_cap=64, filter_limit=0.7)
    ref_s, ref_c = j_reference(pk, px, pq, bk, bg, bw, 0.7)
    assert set(got) == set(jout) == set(ref_s)
    for g in ref_s:
        assert got[g][1] == jout[g][1] == ref_c[g]
        assert abs(got[g][0] - jout[g][0]) <= 1e-9 * max(1, abs(ref_s[g]))
    assert reference_agg_join(pk, px, pq, bk, bg, bw, 0.7) == (ref_s, ref_c)


def test_ladder_exhaustion_is_typed_capacity_error(meshes):
    _jmesh, tmesh = meshes
    n, b = 512, 64
    rng = np.random.default_rng(3)
    pk = np.full(n, 9, dtype=np.int64)
    px = rng.integers(0, 10, n).astype(np.float64)
    bk, bg, bw = _build(b)
    with pytest.raises(CapacityError) as ei:
        run_agg_join(tmesh, pk, px, np.zeros(n), bk, bg, bw,
                     bucket_cap=16, group_cap=64, filter_limit=0.5,
                     max_bucket_cap=16)
    assert ei.value.code == 1104


def test_exchange_overflow_failpoint_fires_once(meshes):
    from tidb_tpu_torch.util import failpoint
    args, kw = _case("all_rows_one_shard")
    failpoint.reset_counters()
    with failpoint.counting():
        run_agg_join(meshes[1], *args, **kw)
        hits = failpoint.counters()
    failpoint.reset_counters()
    assert hits.get("exchange-overflow") == 1


def test_require_capacity_guard():
    C.require_capacity(64, 64)
    with pytest.raises(CapacityError):
        C.require_capacity(65, 64, what="test-exchange")

"""The port's hand-written CUDA kernels on the card: K1 segment_reduce,
K2 unpack_decode and K3 perfect_group_ids against their plain torch
versions on the same CUDA tensors, and a Q1 run on the card against the
same engine's host result; K16 distinct_pairs (with the pair factorize
around it), K17 rollup_tile and K18 gather_columns against their plain
versions on CPU copies; K19 delta_merge (its partition, every packed
width, dict, raw and wide columns) against delta_merge_plain, and a
cached table extended on the card by writes against the host engine.
Needs a CUDA GPU and nvcc; skips without one.
Run on the card with:  python -m pytest -m cuda tests/test_torch_cuda.py

Integer, bool and decode results must be exactly equal; f64 sums within
(n-1)·eps·sum|x| per slot (the kernel adds in another order)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cap", [1, 20, 1024, 65536])
@pytest.mark.parametrize("dt", [torch.int64, torch.int32, torch.float64])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k1_matches_plain(cuda, cap, dt, op):
    from tidb_tpu_torch.ops import segment as seg
    n = 1 << 20
    g = torch.Generator().manual_seed(cap)
    gids = torch.randint(-1, cap + 1, (n,), generator=g,
                         dtype=torch.int32).to(cuda)
    if dt == torch.float64:
        data = torch.randn(n, generator=g, dtype=dt).to(cuda)
    else:
        data = torch.randint(-1000, 1000, (n,), generator=g,
                             dtype=dt).to(cuda)
    got = seg.segment_reduce(op, data, gids, cap)
    want = seg.segment_reduce_plain(op, data, gids, cap)
    if dt == torch.float64 and op == "sum":
        tol = n * 2.0 ** -52 * data.abs().sum()
        assert float((got - want).abs().max()) <= float(tol)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind,width", [("pack", 0), ("pack", 1),
                                        ("pack", 4), ("pack", 16),
                                        ("pack", 32), ("dict", 2),
                                        ("dict", 8), ("delta", 1),
                                        ("delta", 8), ("delta", 32)])
@pytest.mark.parametrize("dt", [np.int64, np.int32])
def test_k2_matches_plain(cuda, kind, width, dt):
    from tidb_tpu_torch.chunk import compress as C
    from tidb_tpu_torch.executor.device_cache import _upload
    cap, n = 1 << 16, (1 << 16) - 101
    rng = np.random.default_rng(width)
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    dv = None
    if kind == "pack":
        vals = (rng.integers(0, (1 << width) if width else 1, cap)
                - 5).astype(dt)
        lay = C.ColLayout("pack", width, -5, np.dtype(dt).name)
    elif kind == "dict":
        dv = np.unique(rng.integers(-999, 999, 1 << width).astype(dt))
        vals = dv[rng.integers(0, len(dv), cap)]
        lay = C.ColLayout("dict", width, 0, np.dtype(dt).name, len(dv))
    else:
        vals = np.cumsum(rng.integers(0, min(1 << width, 100),
                                      cap)).astype(dt)
        lay = C.ColLayout("delta", width, 0, np.dtype(dt).name)
    host = C.pack_slab(lay, vals, mask, dv) + ((dv,) if dv is not None
                                              else ())
    slab = tuple(_upload(a, cuda) for a in host)
    gv, gm = C.decode_slab_torch(lay, slab, cap)
    pv, pm = C.decode_slab_plain(lay, slab, cap)
    assert torch.equal(gm, pm)
    assert torch.equal(gv[pm], pv[pm])


def test_k3_matches_plain(cuda):
    from tidb_tpu_torch.executor import device_emit as E
    n = 1 << 20
    g = torch.Generator().manual_seed(3)
    keys = [(torch.randint(-2, 6, (n,), generator=g,
                           dtype=torch.int32).to(cuda),
             (torch.rand(n, generator=g) < 0.9).to(cuda)),
            (torch.randint(0, 3, (n,), generator=g,
                           dtype=torch.int64).to(cuda),
             (torch.rand(n, generator=g) < 0.8).to(cuda))]
    live = (torch.rand(n, generator=g) < 0.7).to(cuda)
    bounds, strides, cap = [(0, 4), (0, 2)], [1, 6], 24
    raw = E.perfect_group_ids(keys, live, bounds, strides, cap)
    assert torch.equal(raw, E.perfect_group_ids_plain(keys, live, bounds,
                                                      strides, cap))
    inv = torch.randperm(cap, generator=g).to(torch.int32).to(cuda)
    assert torch.equal(E.remap_group_ids(raw, inv, cap),
                       E.remap_group_ids_plain(raw, inv, cap))


def test_q1_on_card_equals_host_engine(cuda):
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.session import Engine
    from tidb_tpu_torch.testing import load_numpy_columns
    n = 200_000
    rng = np.random.default_rng(1)
    s = Engine(device="cuda").new_session()
    s.execute("CREATE TABLE li (q DECIMAL(15,2), p DECIMAL(15,2), "
              "f CHAR(1), st CHAR(1), sd DATE)")
    load_numpy_columns(s, "li", {
        "q": rng.integers(100, 5001, n), "p": rng.integers(9e4, 1e7, n),
        "f": np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)],
        "st": np.array(["F", "O"], dtype=object)[rng.integers(0, 2, n)],
        "sd": np.sort(rng.integers(8036, 10590, n)).astype(np.int32)})
    s.execute("ANALYZE TABLE li")
    sql = ("SELECT f, st, SUM(q), SUM(p * (1 - q)), AVG(p), COUNT(*) "
           "FROM li WHERE sd <= '1998-09-02' GROUP BY f, st ORDER BY f, st")
    host = s.query(sql).rows
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_strict": 1})
    before = ck.launches()
    assert s.query(sql).rows == host
    after = ck.launches()
    # K1-K3 under the grouped aggregate; K9 + K8 under the ORDER BY of the
    # fused finalize
    q1 = ("segment_reduce", "unpack_decode", "perfect_groups", "radix_sort",
          "sort_encode")
    assert all(after[k] > before[k] for k in q1), (before, after)


@pytest.mark.parametrize("n,cap", [(1, 1), (5000, 13), (200_003, 4096)])
def test_k16_matches_plain(cuda, n, cap):
    from tidb_tpu_torch.ops import factorize as F
    g = torch.Generator().manual_seed(n)
    live = torch.rand(n, generator=g) < 0.8
    gids = torch.where(live, torch.randint(0, cap, (n,), generator=g),
                       torch.full((n,), cap)).to(torch.int32)
    vid = torch.randint(0, max(n // 3, 1), (n,), generator=g,
                        dtype=torch.int32)
    assert torch.equal(F.pair_code(gids.to(cuda), vid.to(cuda), cap).cpu(),
                       F.pair_code_plain(gids, vid))
    rep = torch.randint(0, n, (cap,), generator=g, dtype=torch.int32)
    pg = torch.randint(0, cap, (n,), generator=g, dtype=torch.int32)
    rep[pg[: cap // 2].long()] = torch.arange(min(cap // 2, n),
                                              dtype=torch.int32)
    assert torch.equal(F.first_mask(rep.to(cuda), pg.to(cuda)).cpu(),
                       F.first_mask_plain(rep, pg))
    vals = torch.randint(-40, 40, (n,), generator=g)
    valid = torch.rand(n, generator=g) < 0.9
    got = F.distinct_pair_factorize(gids.to(cuda), vals.to(cuda),
                                    valid.to(cuda), live.to(cuda), n,
                                    gid_cap=cap)
    want = F.distinct_pair_factorize(gids, vals, valid, live, n,
                                     gid_cap=cap)
    pl = live & valid
    k = int(want[2])
    assert int(got[2]) == k
    assert torch.equal(got[0].cpu()[pl], want[0][pl])
    assert torch.equal(got[3].cpu()[:k], want[3][:k])


@pytest.mark.parametrize("reps", [2, 4])
def test_k17_matches_plain(cuda, reps):
    from tidb_tpu_torch.executor import device_emit as E
    n = 70_001
    g = torch.Generator().manual_seed(reps)
    cols = [torch.rand(n, generator=g) < 0.5,
            torch.randint(-9, 9, (n,), generator=g, dtype=torch.int16),
            torch.randint(0, 7, (n,), generator=g, dtype=torch.int32),
            torch.randn(n, generator=g, dtype=torch.float64),
            torch.randint(0, 1 << 40, (3, n), generator=g)]
    for a, b in zip(E.rollup_tile([c.to(cuda) for c in cols], reps),
                    E.rollup_tile_plain(cols, reps)):
        assert torch.equal(a.cpu(), b)
    masks = [torch.rand(reps * n, generator=g) < 0.8
             for _ in range(reps - 1)]
    lev, got = E.rollup_levels([m.to(cuda) for m in masks], n)
    wlev, want = E.rollup_levels_plain(masks, n)
    assert torch.equal(lev.cpu(), wlev)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("idx_dt", [torch.int32, torch.int64])
def test_k18_matches_plain(cuda, idx_dt):
    from tidb_tpu_torch.ops import gather as G
    n, m = 90_000, 40_000
    g = torch.Generator().manual_seed(3)
    cols = [(torch.rand(n, generator=g) < 0.5, torch.rand(n, generator=g)
             < 0.7),
            (torch.randint(0, 7, (n,), generator=g, dtype=torch.int32),
             None),
            (torch.randn(n, generator=g, dtype=torch.float64),
             torch.rand(n, generator=g) < 0.7)]
    idx = torch.randint(0, n, (m,), generator=g).to(idx_dt)
    for nv in (m // 3, m):
        n_valid = torch.tensor(nv, dtype=torch.int32)
        got = G.gather_columns(
            [(v.to(cuda), None if mk is None else mk.to(cuda))
             for v, mk in cols], idx.to(cuda), n_valid.to(cuda))
        want = G.gather_columns_plain(cols, idx, n_valid)
        for (a, am), (b, bm) in zip(got, want):
            assert torch.equal(a.cpu(), b) and torch.equal(am.cpu(), bm)


def _k19_slab(kind, width, cap, n_cur, rng):
    """(layout or None, host slab tuple) of one column, as the cache
    stores it (chunk/compress.pack_slab)."""
    from tidb_tpu_torch.chunk import compress as C
    mask = (rng.random(cap) < 0.8) & (np.arange(cap) < n_cur)
    if kind == "raw":
        return None, (rng.integers(-(1 << 50), 1 << 50, cap), mask)
    if kind == "wide":
        return None, (rng.integers(-(1 << 40), 1 << 40, (3, cap)), mask)
    if kind == "dict":
        dv = np.unique(rng.integers(-999, 999, 300)).astype(np.int64)
        lay = C.ColLayout("dict", width, 0, "int64", len(dv))
        return lay, C.pack_slab(lay, dv[rng.integers(0, len(dv), cap)],
                                mask, dv) + (dv,)
    lay = C.ColLayout("pack", width, 7, "int64")
    codes = rng.integers(0, 1 << width, cap) if width else np.zeros(cap)
    return lay, C.pack_slab(lay, codes.astype(np.int64) + 7, mask)


@pytest.mark.parametrize("tombs", ["none", "few", "half", "all"])
def test_k19_matches_plain(cuda, tombs):
    from tidb_tpu_torch.executor import device_emit as E
    from tidb_tpu_torch.executor.device_cache import _upload
    cap, n_cur = 1 << 16, (1 << 16) - 333
    rng = np.random.default_rng(len(tombs))
    keep = np.zeros(cap, dtype=bool)
    keep[:n_cur] = True
    if tombs == "few":
        keep[rng.choice(n_cur, 9, replace=False)] = False
    elif tombs == "half":
        keep &= rng.random(cap) < 0.5
    elif tombs == "all":
        keep[:] = False
    n_new = int(keep.sum())
    keep_t = torch.from_numpy(keep)
    perm = E.delta_perm(keep_t.to(cuda))
    assert torch.equal(perm.cpu(), E.delta_perm_plain(keep_t))
    n_valid = torch.tensor(n_new, dtype=torch.int32, device=cuda)
    cases = [("raw", 0), ("wide", 0), ("dict", 8)] + \
        [("pack", w) for w in (0, 1, 2, 4, 8, 16, 32)]
    for kind, width in cases:
        lay, host = _k19_slab(kind, width, cap, n_cur, rng)
        cpu = tuple(_upload(a, torch.device("cpu")) for a in host)
        got = E.emit_delta_merge(lay, tuple(t.to(cuda) for t in cpu),
                                 keep_t.to(cuda), n_new, cap, perm=perm,
                                 n_valid=n_valid)
        want = E.delta_merge_plain(lay, cpu, keep_t, n_new, cap)
        assert len(got) == len(want), kind
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (kind, width)


def test_delta_writes_on_card_equal_host_engine(cuda):
    from tidb_tpu_torch.executor import device_cache as DC
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.session import Engine
    s = Engine(device="cuda").new_session()
    s.execute("CREATE TABLE t (a BIGINT, b BIGINT, c VARCHAR(10))")
    s.execute("INSERT INTO t VALUES " + ",".join(
        f"({i % 40}, {(i * 7919) % 5000}, 'k{i % 5}')" for i in range(3000)))
    sql = "SELECT a, c, COUNT(*), SUM(b) FROM t GROUP BY a, c ORDER BY a, c"
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_strict": 1, "tidb_tpu_max_slab_rows": 1024,
                   "tidb_tpu_compaction": "off"})
    s.query(sql)
    for write in ("INSERT INTO t VALUES (3, 1234, 'k2')",
                  "DELETE FROM t WHERE b % 97 = 3",
                  "DELETE FROM t WHERE b = 1234"):
        s.query(write)
        before = ck.launches()
        rows = s.query(sql).rows
        after = ck.launches()
        ent = next(e for e in DC._CACHE.values() if e.n_cols == 3)
        assert ent.is_delta
        s.vars["tidb_tpu_engine"] = "off"
        assert rows == s.query(sql).rows
        s.vars["tidb_tpu_engine"] = "on"
        if write.startswith("DELETE FROM t WHERE b %"):
            assert after["delta_merge"] > before["delta_merge"]

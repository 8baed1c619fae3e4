"""The port's hand-written CUDA kernels on the card: K1 segment_reduce,
K2 unpack_decode and K3 perfect_group_ids against their plain torch
versions on the same CUDA tensors, and a Q1 run on the card against the
same engine's host result; K16 distinct_pairs (with the pair factorize
around it), K17 rollup_tile and K18 gather_columns against their plain
versions on CPU copies; K19 delta_merge (its partition, every packed
width, dict, raw and wide columns) against delta_merge_plain, and a
cached table extended on the card by writes against the host engine;
K20 civil_date and K21 dict_lut (both modes, every table width, codes
out of range, tables in and above shared memory) against theirs; K22
member_compact (B = 1, 3, 16; empty, full and random masks; cap at the
128 KB tile ± 1 over mask views 0-15 bytes off, one live row in the last
member) against its plain version; K23 hash_partition (1-64 destinations, the tile edge, an
overflowing cap, two key passes, three scatter launches) against its;
K24 rank_exchange, K25 rank_gather and K26 hash_dest (1-64 ranks, the
key, code and dest modes, unaligned pieces, limb columns) against
theirs. The sort formulation: K8 radix_sort (n = 1, the tile edges,
1,000,003; 1 to 64 bits; full-range, all-equal, sorted and reversed
words; given and generated row ids), K9 sort_encode, K10 group_ids (its
word entry over K8's sorted word and its gather entry for two-word
sorts: NaN, ±0.0, ±inf, NULLs, dead rows, cap overflow) and K11
sorted_search (every entry, on negative, full-range, sentinel-only,
skewed and equal-run tables, probes equal to INT64_MAX) against their
plain versions; K18 at 1-65 columns over views at odd byte offsets. K12's
positions and K13's prefix and segmented scans at the single-pass scan's
tile edges, one scan scratch reused over back-to-back calls, and two
threads scanning on one stream through the locked scratch. K1's path
edges (caps 1-4097), a gid column all in one slot, bool input, its small
path's f64 sums bit-equal call to call and to a numpy model of its
order; K12's window_bounds against its plain version and its two halves,
and one launch counted for each of its C calls; cached delta-merged slabs that own their storage.
Needs a CUDA GPU and nvcc; skips without one.
Run on the card with:  python -m pytest -m cuda tests/test_torch_cuda.py

Integer, bool and decode results must be exactly equal; f64 sums within
(n-1)·eps·sum|x| per slot (the kernel adds in another order)."""

import contextlib
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cap", [1, 12, 20, 32, 33, 1024, 4096, 4097,
                                 65536])
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


def _k1_same(op, got, want, data, gids, cap):
    """K1 against its plain version: exactly, f64 sums within
    (n-1)·eps·Σ|x| a slot."""
    assert got.dtype == want.dtype
    if got.dtype != torch.float64 or op != "sum":
        assert torch.equal(got, want)
        return
    ok = (gids >= 0) & (gids < cap)
    idx = torch.where(ok, gids.long(), torch.full_like(gids, cap).long())
    cnt = torch.zeros(cap + 1, dtype=torch.float64, device=data.device) \
        .index_add_(0, idx, torch.ones_like(data))[:cap]
    sabs = torch.zeros(cap + 1, dtype=torch.float64, device=data.device) \
        .index_add_(0, idx, data.abs())[:cap]
    tol = (cnt - 1).clamp(min=0) * 2.0 ** -52 * sabs
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("cap", [1, 12, 32, 33, 1024, 4096, 4097])
def test_k1_all_rows_in_one_slot(cuda, cap):
    """A skewed gid column: every row in the last slot but a few out of
    range, at each path's edges (the warp-aggregated atomics take one
    group of 32 lanes) and at a scalar aggregate's 1,024-slot capacity
    (Q6's calls), over a ragged 2^20 + 3 rows."""
    from tidb_tpu_torch.ops import segment as seg
    n = (1 << 20) + 3
    g = torch.Generator().manual_seed(cap)
    gids = torch.full((n,), cap - 1, dtype=torch.int32)
    gids[torch.randint(0, n, (999,), generator=g)] = -1
    gids[torch.randint(0, n, (999,), generator=g)] = cap
    gids = gids.to(cuda)
    for dt in (torch.int64, torch.int32, torch.float64):
        data = torch.randn(n, generator=g, dtype=torch.float64).to(cuda) \
            if dt == torch.float64 else torch.randint(
                -1000, 1000, (n,), generator=g, dtype=dt).to(cuda)
        for op in ("sum", "min", "max"):
            _k1_same(op, seg.segment_reduce(op, data, gids, cap),
                     seg.segment_reduce_plain(op, data, gids, cap), data,
                     gids, cap)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cap", [1, 12, 32, 33, 4096, 4097])
def test_k1_bool_input(cuda, cap, offset):
    """A bool mask reduces natively (COUNT in int64 or int32, ANY as an
    int32 max), from aligned tensors and from views one row in (the
    scalar loads)."""
    from tidb_tpu_torch.ops import segment as seg
    from tidb_tpu_torch.ops.xp import TorchXP
    n = (1 << 20) + 7
    g = torch.Generator().manual_seed(7 * cap)
    mask = (torch.rand(n, generator=g) < 0.4).to(cuda)[offset:]
    gids = torch.randint(-1, cap + 1, (n,), generator=g,
                         dtype=torch.int32).to(cuda)[offset:]
    for op, dt in (("sum", torch.int64), ("sum", torch.int32),
                   ("max", torch.int32), ("min", torch.int64)):
        got = seg.segment_reduce(op, mask, gids, cap, dt)
        assert torch.equal(got, seg.segment_reduce_plain(op, mask, gids,
                                                         cap, dt)), (op, dt)
    xp = TorchXP(cuda)
    want = seg.segment_reduce_plain("sum", mask, gids, cap, torch.int64)
    assert torch.equal(seg.segment_count(xp, mask, gids, cap), want)
    assert torch.equal(seg.segment_any(xp, mask, gids, cap), want > 0)


@pytest.mark.parametrize("cap", [1, 12, 32])
def test_k1_small_cap_f64_equals_the_model(cuda, cap):
    """The small path's f64 sums, bit for bit, against the numpy model of
    its order of operations (tests/test_torch_segment_model.py) at the
    grid the card plans; and two calls give the same bits."""
    from test_torch_segment_model import k1_model
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import segment as seg
    lib = ck.library("segment_reduce")
    assert (lib.tt_segment_small_cap(), lib.tt_segment_mid_cap()) == \
        (seg.SMALL_CAP, seg.MID_CAP)        # the model's path edges
    n = (1 << 18) + 5
    rng = np.random.default_rng(cap)
    x = rng.normal(size=n) * 1e3
    ids = rng.integers(-1, cap + 1, n).astype(np.int32)
    data = torch.from_numpy(x).to(cuda)
    gids = torch.from_numpy(ids).to(cuda)
    _path, grid, _bytes, _block = seg.segment_plan(2, 2, 0, n, cap, 0)
    got = seg.segment_reduce("sum", data, gids, cap)
    again = seg.segment_reduce("sum", data, gids, cap)
    assert got.cpu().numpy().tobytes() == again.cpu().numpy().tobytes()
    assert got.cpu().numpy().tobytes() == \
        k1_model("sum", x, ids, cap, grid).tobytes()


@pytest.mark.parametrize("cap", [1, 12])
def test_k1_f64_sums_bit_equal_call_to_call(cuda, cap):
    """chip_smoke's shape (8,388,608 rows): two f64 small-cap sums of the
    same rows are bit-equal."""
    from tidb_tpu_torch.ops import segment as seg
    n = 1 << 23
    g = torch.Generator().manual_seed(12)
    data = torch.randn(n, generator=g, dtype=torch.float64).to(cuda)
    gids = torch.randint(0, cap + 1, (n,), generator=g,
                         dtype=torch.int32).to(cuda)
    a = seg.segment_reduce("sum", data, gids, cap)
    b = seg.segment_reduce("sum", data, gids, cap)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


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


def _k18_columns(g, n, ncols):
    """ncols columns of n rows cycling through 1/2/4/8-byte dtypes, masks
    on every other one; every third column a view 1 element into a longer
    buffer (an odd byte offset for 1-byte values and every mask)."""
    dts = [torch.bool, torch.int16, torch.int32, torch.float64, torch.uint8,
           torch.int64, torch.float32]
    cols = []
    for c in range(ncols):
        dt = dts[c % len(dts)]
        off = 1 if c % 3 == 2 else 0
        if dt == torch.bool:
            v = torch.rand(n + off, generator=g) < 0.5
        elif dt.is_floating_point:
            v = torch.randn(n + off, generator=g).to(dt)
        else:
            v = torch.randint(-100, 100, (n + off,), generator=g).to(dt)
        m = (torch.rand(n + off, generator=g) < 0.7) if c % 2 == 0 else None
        cols.append((v[off:], None if m is None else m[off:]))
    return cols


@pytest.mark.parametrize("ncols", [1, 3, 64, 65])
@pytest.mark.parametrize("idx_dt", [torch.int32, torch.int64])
def test_k18_matches_plain(cuda, idx_dt, ncols):
    """K18 at 1, 3, 64 and 65 columns (65: two launches), sources that are
    views at odd byte offsets, int32/int64 indices with out-of-range ones,
    an index vector off its 16-byte alignment, n_valid 0, below m and m,
    and m not a multiple of the four slots a thread takes."""
    import ctypes
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import gather as G
    assert ck.library("gather_columns").tt_gather_args_bytes() == \
        ctypes.sizeof(G._GatherArgs)
    n = 90_000 if ncols < 64 else 5_000
    g = torch.Generator().manual_seed(3 + ncols)
    cols = _k18_columns(g, n, ncols)
    dcols = [(v.to(cuda), None if mk is None else mk.to(cuda))
             for v, mk in cols]
    dcols = [(_odd_view(v, cuda) if c % 3 == 2 else v,
              None if mk is None else
              (_odd_view(mk, cuda) if c % 3 == 2 else mk))
             for c, (v, mk) in enumerate(dcols)]
    for m in (1, 3, 4, 5, 40_001, 40_002, 40_003):
        idx = torch.randint(-3, n + 3, (m + 1,), generator=g).to(idx_dt)
        for off in (0, 1):
            ix = idx[off:off + m]
            for nv in (0, m // 3, m):
                n_valid = torch.tensor(nv, dtype=torch.int32)
                got = G.gather_columns(dcols, ix.to(cuda) if off == 0 else
                                       idx.to(cuda)[off:off + m],
                                       n_valid.to(cuda))
                want = G.gather_columns_plain(
                    cols, ix.clamp(0, n - 1), n_valid)
                ok = (ix >= 0) & (ix < n)
                assert len(got) == ncols
                for (a, am), (b, bm), (v, _mk) in zip(got, want, cols):
                    b = torch.where(ok, b, torch.zeros_like(b))
                    assert a.dtype == v.dtype and a.shape == (m,)
                    assert torch.equal(a.cpu(), b), (ncols, m, off, nv)
                    assert torch.equal(am.cpu(), bm & ok), (ncols, m, nv)


def _odd_view(t, cuda):
    """t's values in a CUDA buffer one element longer, as the view from
    element 1 (for 1-byte elements an odd byte offset)."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=cuda)
    buf[1:] = t
    return buf[1:]


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


def test_delta_merged_slabs_own_their_storage(cuda):
    """After a DELETE on a table with a wide DECIMAL and a raw DOUBLE
    column, every cached slab tensor owns its storage (its storage's
    bytes within 16-byte alignment of its own): no view of a K18 buffer
    holds bytes the device cache does not count."""
    from tidb_tpu_torch.executor import device_cache as DC
    from tidb_tpu_torch.session import Engine
    s = Engine(device="cuda").new_session()
    s.execute("CREATE TABLE w (a BIGINT, d DECIMAL(30,2), f DOUBLE, "
              "e BIGINT)")
    s.execute("INSERT INTO w VALUES " + ",".join(
        f"({i % 13}, {(i * 7919) * 10 ** 12}.{i % 100:02d}, "
        f"{(i * 53) % 1000 * 0.5}, {(i * 37) % 3000})" for i in range(3000)))
    sql = "SELECT a, SUM(d), SUM(f), COUNT(*) FROM w GROUP BY a ORDER BY a"
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_strict": 1, "tidb_tpu_max_slab_rows": 1024,
                   "tidb_tpu_compaction": "off"})
    s.query(sql)
    s.query("DELETE FROM w WHERE e % 7 = 3")
    rows = s.query(sql).rows
    ent = next(e for e in DC._CACHE.values() if e.n_cols == 4)
    assert ent.is_delta
    s.vars["tidb_tpu_engine"] = "off"
    assert rows == s.query(sql).rows
    seen = 0
    for slabs in ent.dev.values():
        for slab in slabs:
            for t in slab:
                if isinstance(t, torch.Tensor):
                    have = t.untyped_storage().nbytes()
                    assert have <= -(-t.nbytes // 16) * 16, \
                        (t.shape, t.dtype, have, t.nbytes)
                    seen += 1
    assert seen


def _k20_inputs(cuda):
    import datetime
    epoch = datetime.date(1970, 1, 1)
    first = (datetime.date(1, 1, 1) - epoch).days
    last = (datetime.date(9999, 12, 31) - epoch).days
    i32 = np.iinfo(np.int32)
    days = np.concatenate([np.arange(first, last + 1), [
        i32.min, i32.min + 1, -10**9, first - 1, -1, 0, last + 1, 10**9,
        i32.max - 1, i32.max]]).astype(np.int32)
    rng = np.random.default_rng(20)
    us = np.concatenate([
        rng.integers(first * 86_400_000_000, last * 86_400_000_000, 1 << 20),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     1 << 16),
        [np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max]])
    return torch.from_numpy(days).to(cuda), torch.from_numpy(us).to(cuda)


def test_k20_matches_plain(cuda):
    from tidb_tpu_torch.ops import calendar as CAL
    days, us = _k20_inputs(cuda)
    for part in CAL.PARTS:
        for v, micros in ((days, False), (days.long(), False), (us, True)):
            got = CAL.civil_part(v, part, micros)
            want = CAL.civil_part_plain(v, part, micros)
            assert got.dtype == want.dtype and torch.equal(got, want), \
                (part, micros, v.dtype)
    rng = np.random.default_rng(21)
    for mult in (1, 3, 12):
        for v, micros in ((days, False), (us, True)):
            n = torch.from_numpy(rng.integers(-1200, 1201, v.shape[0])).to(
                cuda)
            for k in (n, -1200, -13, -1, 0, 1, 11, 12, 13, 1200):
                got = CAL.date_add_months(v, micros, k, mult)
                want = CAL.date_add_months_plain(v, micros, k, mult)
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (mult, micros, k if isinstance(k, int) else "tensor")


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
def test_k21_matches_plain(cuda, dtype, code_dtype):
    from tidb_tpu_torch.ops import dict_lut as DL
    rng = np.random.default_rng(21)
    edge = DL.SMEM_BYTES // torch.tensor([], dtype=dtype).element_size()
    for n_lut in (0, 1, 7, edge, edge + 1, 1_500_303):
        table = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n_lut)) \
            .to(dtype).to(cuda)
        for n in (0, 1, 1001, 1 << 20):
            codes = torch.from_numpy(rng.integers(-3, n_lut + 3, n)).to(
                code_dtype)
            codes[:min(n, 3)] = torch.tensor([0, -1, n_lut])[:min(n, 3)] \
                .to(code_dtype)
            codes = codes.to(cuda)
            got = DL.dict_lut(table, codes, mode="fill", fill=-1)
            assert torch.equal(got, DL.dict_lut_plain(table, codes, "fill",
                                                      -1))
            if n_lut == 0 and n > 0:
                with pytest.raises(IndexError):
                    DL.dict_lut(table, codes)
                continue
            got = DL.dict_lut(table, codes)
            assert got.dtype == dtype
            assert torch.equal(got, DL.dict_lut_plain(table, codes))


@pytest.mark.parametrize("b", [1, 3, 16])
def test_k22_matches_plain(cuda, b):
    """K22 member_compact: counts, offsets and ids exactly equal to the
    plain version (and to per-member nonzero), with no live rows, every
    row live and random masks, across the tile edge; at the 128 KB tiles'
    edges (cap at multiples of the tile ± 1, and past its first 16 KB
    round), over mask views 1-15 bytes off their 16-byte boundary whose
    neighbouring bytes hold the opposite value, all-dead, all-live, one
    live row at the last member's first or last row; the scratch the
    wrapper sizes equals the library's."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops.compact import ROUNDS, TILE, member_compact, \
        member_compact_plain, scratch_bytes
    lib = ck.library("member_compact")
    assert lib.tt_member_tile() == TILE
    for cap in (0, 1, TILE - 15, TILE - 14, TILE, TILE + 1, 8_388_611):
        assert lib.tt_member_scratch_bytes(b, cap) == scratch_bytes(b, cap)
    rng = np.random.default_rng(22 + b)
    for cap in (0, 1, 1000, 1024, 1025, 1 << 20):
        for p in (0.0, 1.0, 0.5, 1e-3):
            live = torch.from_numpy(rng.random((b, cap)) < p)
            got = member_compact(live.to(cuda))
            want = member_compact_plain(live)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
            for k in range(b):
                lo, hi = int(want[1][k]), int(want[1][k + 1])
                assert torch.equal(want[2][lo:hi].long(),
                                   torch.nonzero(live[k]).reshape(-1))
    for cap in (TILE // ROUNDS + 1, TILE - 1, TILE, TILE + 1, 2 * TILE - 1,
                2 * TILE + 1):
        n = b * cap
        for off in (0, 1, 7, 15):
            for kind in ("dead", "live", "last row", "first of last",
                         "random"):
                inside = np.zeros(n, bool)
                if kind == "live":
                    inside[:] = True
                elif kind == "last row":
                    inside[-1] = True
                elif kind == "first of last":
                    inside[n - cap] = True
                elif kind == "random":
                    inside = rng.random(n) < 0.3
                flat = np.ones(n + 32, bool) if kind == "dead" else \
                    np.zeros(n + 32, bool)
                flat[off:off + n] = inside
                live = torch.from_numpy(flat).to(cuda)[off:off + n]
                live = live.view(b, cap)
                got = member_compact(live)
                want = member_compact_plain(live.cpu())
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g.cpu(), w), \
                        (cap, off, kind)


def _k23_case(rng, n, key_kinds, n_cols):
    keys = []
    for kind in key_kinds:
        if kind == "float":
            v = torch.from_numpy(rng.normal(0.0, 1e6, n))
            v[:min(n, 4)] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf"), 1e19])[:min(n, 4)]
        elif kind == "bool":
            v = torch.from_numpy(rng.random(n) < 0.5)
        elif kind == "int32":
            v = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, n,
                                              dtype=np.int32))
        else:
            v = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))
        keys.append((v, torch.from_numpy(rng.random(n) < 0.9)))
    live = torch.from_numpy(rng.random(n) < 0.8)
    pool = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)),
            torch.from_numpy(rng.random(n) < 0.5),
            torch.from_numpy(rng.integers(0, 1000, n, dtype=np.int32)),
            torch.from_numpy(rng.integers(0, 1000, n, dtype=np.int16)),
            torch.from_numpy(rng.normal(0.0, 1.0, n))]
    arrays = [pool[i % len(pool)] for i in range(n_cols)]
    return keys, live, arrays


@pytest.mark.parametrize("n_shards", [1, 3, 4, 64])
def test_k23_matches_plain(cuda, n_shards):
    """K23 hash_partition: every bucket buffer, sent_live, counts and
    need exactly equal to the plain version, across the 1,024-row tile
    edge; with an overflowing cap, 17-18 key columns (two passes) and 40
    payload columns (three scatter launches)."""
    from tidb_tpu_torch.ops import partition as P
    rng = np.random.default_rng(23 + n_shards)
    cases = [(0, ("int64",), 2, 8), (1, ("int64",), 2, 8),
             (1023, ("int32", "bool"), 4, 2048),
             (1025, ("float",), 6, 2048),
             (100_000, ("int64", "int32"), 5, 64),         # overflow
             (300_000, ("int64",) * 17 + ("bool",), 40, 300_000),
             (1 << 21, ("int64",), 4, 1 << 21)]
    for n, kinds, n_cols, cap in cases:
        keys, live, arrays = _k23_case(rng, n, kinds, n_cols)
        got = P.hash_partition([(v.to(cuda), m.to(cuda)) for v, m in keys],
                               live.to(cuda), [a.to(cuda) for a in arrays],
                               n_shards, cap)
        want = P.hash_partition_plain(keys, live, arrays, n_shards, cap)
        for g, w in zip(got[0], want[0]):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), \
                (n, kinds, n_shards)


def _ranks_of(rng, nd, n, kinds, n_cols):
    """nd sources of n rows each (the last one shorter), K23's cases."""
    out = []
    for s in range(nd):
        m = n if s < nd - 1 else max(n - 7, 0)
        out.append(_k23_case(rng, m, kinds, n_cols))
    return out


def _cuda_lists(srcs, cuda):
    keys = [[(v.to(cuda), m.to(cuda)) for v, m in k] for k, _l, _a in srcs]
    live = [lv.to(cuda) for _k, lv, _a in srcs]
    arrays = [[a.to(cuda) for a in arr] for _k, _l, arr in srcs]
    return keys, live, arrays


@pytest.mark.parametrize("n_shards", [1, 4, 64])
def test_k24_matches_plain(cuda, n_shards):
    """K24 rank_exchange: every rank's receive buffers, receive-live mask
    and the need shared by every source exactly equal to the plain
    version, across the tile edge, with an overflowing cap and 40
    payload columns (several scatter launches at 64 ranks), routed by
    K26 over the keys (17-18 key columns: two passes) or over an int64
    code, and by destinations given as they are, some outside the
    ranks (dead rows)."""
    from tidb_tpu_torch.ops import partition as P
    rng = np.random.default_rng(24 + n_shards)
    cases = [(1, ("int64",), 2, 8), (1025, ("int32", "bool"), 5, 2048),
             (50_000, ("float",), 4, 64),                  # overflow
             (20_000, ("int64",) * 17 + ("bool",), 40, 20_000)]
    if n_shards <= 4:
        cases.append((1 << 19, ("int64",), 4, 1 << 19))
    for n, kinds, n_cols, cap in cases:
        srcs = _ranks_of(rng, n_shards, n, kinds, n_cols)
        keys, live, arrays = _cuda_lists(srcs, cuda)
        modes = {"keys": [P.hash_dest(k, n_shards) for k in keys],
                 "given": [torch.from_numpy(rng.integers(
                     -1, n_shards + 1, lv.shape[0]).astype(np.int32))
                     .to(cuda) for lv in live]}
        if len(kinds) == 1 and kinds[0] == "int64":
            modes["code"] = [P.hash_dest(None, n_shards, code=k[0][0])
                             for k in keys]
        for mode, dest in modes.items():
            got = P.rank_exchange(arrays, dest, live, n_shards, cap)
            want = P.rank_exchange_plain(
                [[a.cpu() for a in arr] for arr in arrays],
                [d.cpu() for d in dest], [x.cpu() for x in live],
                n_shards, cap)
            for d in range(n_shards):
                for g, w in zip(got[0][d], want[0][d]):
                    assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
                assert torch.equal(got[1][d].cpu(), want[1][d])
            assert int(got[2]) == int(want[2]), (n, kinds, mode)


@pytest.mark.parametrize("n_ranks", [1, 4, 64])
def test_k25_matches_plain(cuda, n_ranks):
    """K25 rank_gather: every gathered column exactly equal to
    torch.cat of the pieces, over 1-, 2-, 4- and 8-byte items (every
    dtype at odd lengths: unaligned pieces), ragged ranks, an empty
    rank, 2-D limb columns of 1, 3 and 5 rows, a strided piece, and more
    pieces than one launch takes (64 ranks x 7 columns). The wrapper's
    chunk and launch sizes are the library's."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops.rank_gather import (CHUNK, MAX_SEGS,
                                                gather_plan, rank_gather,
                                                rank_gather_plain)
    lib = ck.library("rank_gather")
    assert (CHUNK, MAX_SEGS) == (lib.tt_rank_gather_chunk(),
                                 lib.tt_rank_gather_max_segs())
    g = torch.Generator().manual_seed(25 + n_ranks)
    dtypes = (torch.bool, torch.int8, torch.uint8, torch.int16,
              torch.int32, torch.float32, torch.int64, torch.float64)
    for n in (0, 1, 1025, 1 << 19):
        if n_ranks == 64 and n > 1025:
            continue
        for empty in (None, min(1, n_ranks - 1)):
            cols = []
            for dt in dtypes:
                pieces = []
                for r in range(n_ranks):
                    m = 0 if r == empty else n + (r % 3)
                    pieces.append(torch.randint(0, 100, (m,), generator=g)
                                  .to(dt))
                cols.append(pieces)
            for rows in (1, 3, 5):
                cols.append([torch.randint(
                    0, 1 << 30, (rows, 0 if r == empty else n + r),
                    generator=g) for r in range(n_ranks)])
            got = rank_gather([[p.to(cuda) for p in ps] for ps in cols])
            want = rank_gather_plain(cols)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x.cpu(), y), n
        key = tuple((p[0].dtype, tuple(p[0].shape[:-1]),
                     tuple(q.shape[-1] for q in p)) for p in cols)
        if n_ranks == 64 and n:
            assert len(gather_plan(key).segments) > MAX_SEGS
    # a strided (non-contiguous) piece is copied as its values
    base = torch.arange(40, dtype=torch.int64).reshape(2, 20)
    on_card = base.to(cuda)
    got = rank_gather([[on_card[:, ::2], on_card[:, 1::3]]])
    want = rank_gather_plain([[base[:, ::2], base[:, 1::3]]])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.parametrize("n_shards", [1, 4, 64, 1000])
def test_k26_matches_plain(cuda, n_shards):
    """K26 hash_dest: the owner of every row exactly equal to
    shard_of(mix_key_code(keys)), over K23's key kinds, 17-18 key
    columns (two passes) and the code mode."""
    from tidb_tpu_torch.ops import partition as P
    rng = np.random.default_rng(26 + n_shards)
    for n, kinds in ((0, ("int64",)), (1025, ("int32", "bool")),
                     (70_000, ("float",)), (1 << 20, ("int64", "int32")),
                     (5000, ("int64",) * 17 + ("bool",))):
        keys, _live, _arr = _k23_case(rng, n, kinds, 0)
        got = P.hash_dest([(v.to(cuda), m.to(cuda)) for v, m in keys],
                          n_shards)
        want = P.hash_dest_plain(keys, n_shards)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
        code = keys[0][0].to(torch.int64)
        assert torch.equal(P.hash_dest(None, n_shards,
                                       code=code.to(cuda)).cpu(),
                           P.hash_dest_plain(None, n_shards, code=code))


# ---------------------------------------------------------------------------
# K8-K11: the sort formulation
# ---------------------------------------------------------------------------


def _k8_words(kind, n, bits, rng):
    mask = -1 if bits == 64 else (1 << bits) - 1
    full = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64) & mask
    if kind == "full":
        return full
    if kind == "equal":
        return np.full(n, 12345 & mask, dtype=np.int64)
    if kind == "sorted":
        return np.sort(full)
    return np.sort(full)[::-1].copy()                       # "reversed"


@pytest.mark.parametrize("bits", [1, 8, 24, 40, 64])
@pytest.mark.parametrize("kind", ["full", "equal", "sorted", "reversed"])
def test_k8_matches_plain(cuda, kind, bits):
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import factorize as F
    tile = ck.library("radix_sort").tt_radix_tile()
    rng = np.random.default_rng(bits * 7 + len(kind))
    for n in (1, tile - 1, tile, tile + 1, 3 * tile - 1, 3 * tile,
              3 * tile + 1, 1_000_003):
        w = torch.from_numpy(_k8_words(kind, n, bits, rng)).to(cuda)
        perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
        for vals in (None, perm):
            got = F.radix_sort(w, vals, bits)
            want = F.radix_sort_plain(w, vals, bits)
            assert torch.equal(got[0], want[0]), (kind, bits, n)
            assert torch.equal(got[1], want[1]), (kind, bits, n)


@pytest.mark.parametrize("kind", ["f64", "i32", "i64", "bool"])
@pytest.mark.parametrize("desc", [False, True])
def test_k9_matches_plain(cuda, kind, desc):
    from tidb_tpu_torch.ops import factorize as F
    rng = np.random.default_rng(len(kind) + int(desc))
    n = 1_000_003
    if kind == "f64":
        raw = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5,
                                   -2.25, 1e300]), n)
    elif kind == "i32":
        raw = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    elif kind == "i64":
        raw = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    else:
        raw = rng.random(n) > 0.5
    v, code = F._k9_operand(torch.from_numpy(raw).to(cuda))
    m = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    st = torch.tensor([-1, 0], dtype=torch.int64, device=cuda)
    F.sort_encode(v, code, None, m, desc, 0, 0, stats=st)
    _, (lo, hi) = F.sort_encode_plain(v, code, None, m, desc, 0, 0)
    assert [x & ((1 << 64) - 1) for x in st.tolist()] == [lo, hi]
    base = torch.full((n,), 3, dtype=torch.int64, device=cuda)
    got = F.sort_encode(v, code, perm, m, desc, lo, 2, base.clone(),
                        accumulate=True)
    want, _ = F.sort_encode_plain(v, code, perm, m, desc, lo, 2, base,
                                  accumulate=True)
    assert torch.equal(got, want)


def _k10_case(case, n, rng):
    """→ (key values, NULL mask or None, live, radix words of its sort)."""
    live = rng.random(n) > 0.2
    m = rng.random(n) > 0.15
    if case == "nan":
        v = rng.choice(np.array([2.0, 3.5, 4.0, 1e300, np.inf, np.nan]), n)
        return v, None, live, 1
    if case == "signed_zero":
        return rng.choice(np.array([-0.0, 0.0, 0.5, 3.0]), n), None, live, 1
    if case == "neg_inf":
        v = rng.choice(np.array([-np.inf, -1e300, -2.0, -3.5]), n)
        return v, None, live, 1
    if case == "all_nan":
        return np.full(n, np.nan), None, live, 1
    if case == "nulls":
        return rng.integers(-40, 40, n).astype(np.int64), m, live, 1
    if case == "groups":                      # ~10^5 groups
        return rng.integers(0, 100_000, n).astype(np.int64), None, live, 1
    if case == "dead_equal":       # the last live key is a dead row's too
        v = rng.integers(0, 9, n).astype(np.int64)
        k = min(n, 5)
        v[:k] = 9
        live[:k] = [True, False, True, False, False][:k]
        return v, None, live, 1
    if case == "all_dead":
        return rng.integers(0, 30, n).astype(np.int32), m, \
            np.zeros(n, dtype=bool), 1
    if case == "nan_two_words":
        v = rng.choice(np.array([0.0, -0.0, -np.inf, np.inf, 1.5, np.nan]),
                       n)
        return v, m, live, 2
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)  # two_words
    v[:n // 3] = rng.integers(-3, 3, n // 3)
    return v, m, live, 2


@pytest.mark.parametrize("case", ["nan", "signed_zero", "neg_inf", "all_nan",
                                  "nulls", "groups", "dead_equal",
                                  "all_dead", "nan_two_words", "two_words"])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_k10_matches_plain(cuda, case, n):
    """Both K10 entries against their plain versions on the same sort, the
    route's results against the plain route on CPU copies, and the entry
    the word count picks (each with its own counter)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import factorize as F
    rng = np.random.default_rng(n + len(case))
    v, m, live, n_words = _k10_case(case, n, rng)
    hv, hl = torch.from_numpy(v), torch.from_numpy(live)
    hm = None if m is None else torch.from_numpy(m)
    dv, dl = hv.to(cuda), hl.to(cuda)
    dm = None if hm is None else hm.to(cuda)
    ops = F._key_operands([(dv, dm)], dl)
    sidx, words = F._lexsort_kernel(ops)
    if n > 1:                 # one row: every operand takes no bits
        assert words.count == n_words
    n_words = words.count
    for cap in (0, 3, n + 1):
        want = F.group_ids_plain(sidx, dv, dm, dl, cap)
        want = want if isinstance(want, tuple) else (want,)
        got = F.group_ids(sidx, dv, dm, dl, cap)              # gather
        for a, b in zip(got if cap else (got,), want):
            assert torch.equal(a, b), (case, n, cap)
        if n_words == 1:
            key = F._word_key(words)
            got = F.group_ids_words(words.last, sidx, *key, cap)
            for a, b in zip(got if cap else (got,), want):
                assert torch.equal(a, b), (case, n, cap)
            plain = F.group_ids_words_plain(words.last, sidx, *key, cap)
            for a, b in zip(plain if cap else (plain,), want):
                assert torch.equal(a, b), (case, n, cap)
        before = ck.launches()
        got = F._sort_groups_kernel(ops, dv, dm, dl, cap)
        after = ck.launches()
        entry = "group_ids_words" if n_words == 1 else "group_ids"
        other = "group_ids" if n_words == 1 else "group_ids_words"
        assert after[entry] == before[entry] + 1
        assert after[other] == before[other]
        host = F._sort_groups(F._key_operands([(hv, hm)], hl), hv, hm, hl,
                              cap)
        host = host if isinstance(host, tuple) else (host,)
        for a, b in zip(got if cap else (got,), host):
            assert torch.equal(a.cpu(), b.to(a.dtype)), (case, n, cap)


_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _k11_build(kind, nb, dup, rng):
    """(build codes, ok_b, the pool probes draw from) of one table kind:
    random codes in [0, 2^40) (pool), negative codes, the full int64 range
    from INT64_MIN to INT64_MAX - 1, dead rows only (a table of sentinels),
    runs of equal codes across bucket edges, and the skewed table (nb - 1
    codes in [0, nb) and one at 2^62)."""
    if kind == "pool":
        pool = np.sort(rng.choice(1 << 40, max(nb, 2), replace=False))
        bc = pool[rng.integers(0, max(nb // 3, 1), nb)] if dup else pool[:nb]
    elif kind == "negative":
        pool = np.sort(rng.integers(-(1 << 40), -5, nb))
        bc = pool
    elif kind == "full-range":
        pool = np.sort(np.concatenate([
            rng.integers(_I64_MIN, _I64_MAX, max(nb - 2, 0), dtype=np.int64),
            [_I64_MIN, _I64_MAX - 1]]))[:nb]
        bc = pool
    elif kind == "sentinels":
        pool = rng.integers(0, 1 << 40, nb)
        bc = pool
    elif kind == "runs":
        pool = np.repeat(np.arange(0, nb, 3, dtype=np.int64), 5)[:nb]
        bc = pool
    else:                           # skewed
        pool = np.concatenate([np.arange(nb - 1, dtype=np.int64), [1 << 62]])
        bc = pool
    ok_b = rng.random(nb) > 0.1
    if kind == "sentinels":
        ok_b[:] = False
    elif kind != "pool":
        ok_b[:] = True
    return rng.permutation(bc), ok_b[:nb], pool


def _k11_probes(rng, pool, P):
    """Probes from the pool, its neighbours, INT64_MAX, INT64_MIN and the
    whole int64 range."""
    base = pool[rng.integers(0, len(pool), P)]
    pick = rng.random(P)
    with np.errstate(over="ignore"):
        near = base + rng.integers(-1, 2, P)
    return np.where(pick < 0.6, base, np.where(
        pick < 0.75, near, np.where(
            pick < 0.8, _I64_MAX, np.where(
                pick < 0.85, _I64_MIN,
                rng.integers(_I64_MIN, _I64_MAX, P, dtype=np.int64)))))


@pytest.mark.parametrize("nb,P,dup,kind", [
    (1, 50, False, "pool"), (1, 0, False, "pool"), (5000, 0, False, "pool"),
    (200_000, 1_000_003, False, "pool"), (1, 50, True, "pool"),
    (1, 0, True, "pool"), (5000, 0, True, "pool"),
    (200_000, 1_000_003, True, "pool"),
    (70_001, 300_001, False, "negative"),
    (70_001, 300_001, False, "full-range"),
    (4_097, 100_003, False, "sentinels"), (1, 1_000, False, "sentinels"),
    (1, 1_000, False, "full-range"),
    (300_000, 1_000_001, False, "runs"),
    (2_097_152, 1_000_000, False, "skewed")])
def test_k11_matches_plain(cuda, nb, P, dup, kind):
    """Every K11 entry exactly equal to its plain version: duplicated and
    unique builds, missing probe keys, sentinel rows, nb = 1, P = 0, and
    the edge tables (negative, full-range, sentinels only, runs of equal
    codes across bucket edges, the skewed table) with probes equal to
    INT64_MAX and INT64_MIN."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import join as J
    k, scratch = J._dir_scratch(nb, cuda)
    assert ck.library("sorted_groups").tt_sorted_dir_bytes(k) == \
        scratch.numel()
    rng = np.random.default_rng(nb + P + int(dup))
    bc, okb, pool = _k11_build(kind, nb, dup, rng)
    codes = torch.from_numpy(bc).to(cuda)
    ok_b = torch.from_numpy(okb).to(cuda)
    if kind == "pool":
        probe = torch.from_numpy(np.where(
            rng.random(P) < 0.7, pool[rng.integers(0, len(pool), P)],
            rng.integers(0, 1 << 40, P))).to(cuda)
    else:
        probe = torch.from_numpy(_k11_probes(rng, pool, P)).to(cuda)
    ok_p = torch.from_numpy(rng.random(P) > 0.1).to(cuda)
    sc, order = J.sorted_build(codes, ok_b)
    hs, ho = J.sorted_build(codes.cpu(), ok_b.cpu())
    assert torch.equal(sc.cpu(), hs) and torch.equal(order.cpu(), ho)
    for a, b in zip(J.sorted_search_unique(sc, order, probe, ok_p),
                    J.sorted_search_unique_plain(sc, order, probe, ok_p)):
        assert torch.equal(a, b)
    for a, b in zip(J.sorted_search_multi(sc, probe, ok_p),
                    J.sorted_search_multi_plain(sc, probe, ok_p)):
        assert torch.equal(a, b)
    tables = [torch.from_numpy(np.sort(pool)).to(cuda), sc]
    for table in tables:
        for right in (False, True):
            assert torch.equal(J.searchsorted(table, probe, right),
                               torch.searchsorted(table, probe,
                                                  right=right))
    # a probe view off its 16-byte alignment (the scalar key loads)
    if P > 1:
        pv, okv = probe[1:], ok_p[1:]
        for a, b in zip(J.sorted_search_multi(sc, pv, okv),
                        J.sorted_search_multi_plain(sc, pv, okv)):
            assert torch.equal(a, b)
        for a, b in zip(J.sorted_search_unique(sc, order, pv, okv),
                        J.sorted_search_unique_plain(sc, order, pv, okv)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K12/K13: the single-pass look-back scan at its tile edges
# ---------------------------------------------------------------------------

_SCAN_SIZES = ["0", "1", "tile-1", "tile", "tile+1", "8388611"]


def _scan_n(size):
    """A size of _SCAN_SIZES in rows, the tile read from the library."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    tile = ck.library("window_scan").tt_window_tile()
    return {"tile-1": tile - 1, "tile": tile,
            "tile+1": tile + 1}.get(size) or int(size)


def _f64_prefix_close(got, want, z):
    """Within the reordered sum's bound: 2·(i+1)·eps·Σ|x| at row i."""
    bound = 2 * torch.arange(1, z.shape[0] + 1, device=z.device,
                             dtype=torch.float64) * \
        np.finfo(np.float64).eps * torch.cumsum(z.abs(), 0)
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("size", _SCAN_SIZES)
def test_k13_matches_plain(cuda, size):
    """K13's prefix (int32, int64 and float64 values, with and without
    `valid`, count only; int64 sums that wrap past ±2^63) and its
    segmented min/max (forward and reverse, with NaN, ±inf and the
    identity among the values) against their plain versions on the
    same tensors, at the tile edges: int results exactly, the f64
    prefix within 2·(i+1)·eps·Σ|x|."""
    from tidb_tpu_torch.ops import window as W
    n = _scan_n(size)
    rng = np.random.default_rng(13 + n)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    vals = {
        torch.int32: torch.from_numpy(rng.integers(
            -(1 << 31), (1 << 31) - 1, n, dtype=np.int32)).to(cuda),
        torch.int64: torch.from_numpy(rng.integers(
            (1 << 63) - (1 << 40), (1 << 63) - 1, n, dtype=np.int64)
            * rng.choice(np.array([-1, 1], dtype=np.int64), n)).to(cuda),
        torch.float64: torch.from_numpy(rng.normal(0.0, 1e6, n)).to(cuda)}
    for dt, v in vals.items():
        for ok in (valid, None):
            got = W.window_prefix(v, ok)
            want = W.window_prefix_plain(v, ok)
            assert torch.equal(got[1], want[1]), (dt, ok is None)
            assert got[0].dtype == want[0].dtype
            if dt == torch.float64:
                z = v if ok is None else torch.where(ok, v,
                                                     torch.zeros_like(v))
                assert _f64_prefix_close(got[0], want[0], z)
            else:
                assert torch.equal(got[0], want[0]), (dt, ok is None)
    got = W.window_prefix(None, valid)                  # count only
    assert got[0] is None and torch.equal(
        got[1], W.window_prefix_plain(None, valid)[1])
    pstart = torch.from_numpy(rng.random(n) < 0.001).to(cuda)
    if n:
        pstart[0] = True
    f = vals[torch.float64].clone()
    if n:
        idx = torch.from_numpy(rng.integers(0, n, max(n // 500, 1))).to(cuda)
        f[idx] = float("nan")
        f[idx[: len(idx) // 2]] = float("inf")
        f[idx[len(idx) // 2:][:3]] = -float("inf")
    for dt, v in ((torch.int32, vals[torch.int32]),
                  (torch.int64, torch.from_numpy(rng.integers(
                      -1000, 1000, n)).to(cuda)),
                  (torch.float64, f)):
        for is_max in (False, True):
            w = v.clone()
            w[: min(n, 7)] = W._ident(is_max, dt)     # the identity as a value
            for reverse in (False, True):
                for ok in (valid, None):
                    got = W.window_segscan(w, ok, pstart, is_max, reverse)
                    want = W.window_segscan_plain(w, ok, pstart, is_max,
                                                  reverse)
                    assert got.dtype == want.dtype
                    same = got == want
                    if dt == torch.float64:
                        same |= got.isnan() & want.isnan()
                    assert bool(same.all()), (dt, is_max, reverse)


@pytest.mark.parametrize("size", _SCAN_SIZES)
def test_k12_positions_match_plain(cuda, size):
    """K12's positions (its forward and backward scans) against the plain
    version, exactly, at the tile edges: sparse partitions with dense
    peer groups, every row its own partition, and one partition."""
    from tidb_tpu_torch.ops import window as W
    n = _scan_n(size)
    rng = np.random.default_rng(12 + n)
    for p_part, p_peer in ((0.0005, 0.3), (1.0, 1.0), (0.0, 0.0)):
        ps = rng.random(n) < p_part
        qs = ps | (rng.random(n) < p_peer)
        if n:
            ps[0] = qs[0] = True
        pstart = torch.from_numpy(ps).to(cuda)
        peerstart = torch.from_numpy(qs).to(cuda)
        got = W.window_positions(pstart, peerstart)
        want = W.window_positions_plain(pstart, peerstart)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (p_part, n)


@pytest.mark.parametrize("perm32", [False, True])
@pytest.mark.parametrize("n,nkeys,n_part", [
    (1, 3, 1), (2047, 3, 1), (2048, 4, 2), (2049, 5, 1), (6149, 2, 1),
    (2049, 9, 3), (700, 9, 0), (2047, 1, 1), (257, 0, 0),
    (3 * 2048 * 50 + 7, 4, 2), (2049, 17, 10), (2048, 9, 9)])
def test_k12_bounds_match_plain(cuda, n, nkeys, n_part, perm32):
    """K12's window_bounds (its own flags launch, then the positions)
    against its plain version and its two halves, exactly, at the tile
    edges: NaN, ±0.0, NULLs, dead rows, bool keys, int32 and int64
    permutations, 9 and 17 keys (the flags launch a chunk of 8 keys at a
    time, partition keys on both sides of a chunk edge), no `live`, and
    the count of live rows in place of `live`."""
    from test_torch_bounds_model import _layout
    from tidb_tpu_torch.ops import window as W
    for with_live in (True, False):
        perm, live, keys = _layout(n, nkeys, n + nkeys, with_live)
        p = torch.from_numpy(perm.astype(np.int32 if perm32 else np.int64))
        p = p.to(cuda)
        lv = None if live is None else torch.from_numpy(live).to(cuda)
        tk = [(torch.from_numpy(v).to(cuda), torch.from_numpy(m).to(cuda))
              for v, m in keys]
        want = W.window_bounds_plain(p, lv, tk, n_part)
        halves = W.window_flags(p, lv, tk, n_part)
        halves = halves + (W.window_positions(*halves),)
        # the layout lists live rows first (as sort_perm does), so the
        # count of live rows may stand in for `live`
        n_live = None if lv is None else \
            lv.sum().to(torch.int32).reshape(())
        for nl in (None, n_live):
            got = W.window_bounds(p, lv, tk, n_part, nl)
            for other in (want, halves):
                assert torch.equal(got[0], other[0]), (n, with_live, nl)
                assert torch.equal(got[1], other[1]), (n, with_live, nl)
                for a, b in zip(got[2], other[2]):
                    assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("nkeys,want", [(3, 2), (9, 3), (17, 4)])
def test_k12_counts_each_launch(cuda, nkeys, want):
    """window_bounds counts one launch for each C call: the flags launch
    (one a chunk of 8 keys), then the positions' scans."""
    from test_torch_bounds_model import _layout
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import window as W
    perm, live, keys = _layout(3000, nkeys, 7)
    tk = [(torch.from_numpy(v).to(cuda), torch.from_numpy(m).to(cuda))
          for v, m in keys]
    ck.reset_launches()
    W.window_bounds(torch.from_numpy(perm).to(cuda),
                    torch.from_numpy(live).to(cuda), tk, 1)
    assert ck.launches()["window_bounds"] == want


def test_scan_scratch_reused_back_to_back(cuda, monkeypatch):
    """One scratch buffer, filled with garbage once, serves 20
    back-to-back calls of each scan entry: each call zeroes its own
    status, and every result is identical every time. The scratch the
    wrappers size equals the library's own count."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import window as W
    lib = ck.library("window_scan")
    tile = lib.tt_window_tile()
    for n in (0, 1, tile - 1, tile, tile + 1, 8_388_611):
        for scans in (1, 2):
            assert W.scan_scratch_bytes(n, tile, scans) == \
                lib.tt_window_scratch_bytes(n, scans), (n, scans)
    n = 3 * tile * 1000 + 5
    rng = np.random.default_rng(20)
    v = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, n)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    ps = torch.from_numpy(rng.random(n) < 0.01).to(cuda)
    ps[0] = True
    qs = ps | torch.from_numpy(rng.random(n) < 0.2).to(cuda)
    scratch = torch.full((W.scan_scratch_bytes(n, tile, 2),), 0xFF,
                         dtype=torch.uint8, device=cuda)
    monkeypatch.setattr(W, "_scan_scratch",
                        lambda *a, **k: contextlib.nullcontext(
                            scratch.data_ptr()))
    calls = (lambda: W.window_prefix(v, valid),
             lambda: (W.window_segscan(v, valid, ps, True, True),),
             lambda: tuple(W.window_positions(ps, qs)))
    for call in calls:
        first = [t.clone() for t in call()]
        for _ in range(20):
            for a, b in zip(call(), first):
                assert torch.equal(a, b)
    want = W.window_prefix_plain(v, valid)
    assert all(torch.equal(a, b) for a, b in zip(calls[0](), want))


def test_scan_scratch_locked_across_threads(cuda):
    """Two threads scanning on one stream (the default one of the device)
    through the one per-stream scratch, many times over: every K13 prefix
    and every K12 positions result equals its plain version. Without the
    per-stream lock the two threads' status memsets and launches can
    interleave, and a scan starts from a tile counter the other
    advanced."""
    import threading
    from tidb_tpu_torch.ops import cuda_kernels as ck
    from tidb_tpu_torch.ops import window as W
    tile = ck.library("window_scan").tt_window_tile()
    n = 3 * tile * 20 + 5
    rng = np.random.default_rng(31)
    v = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, n)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    ps = torch.from_numpy(rng.random(n) < 0.01).to(cuda)
    ps[0] = True
    qs = ps | torch.from_numpy(rng.random(n) < 0.2).to(cuda)
    want_prefix = W.window_prefix_plain(v, valid)
    want_pos = W.window_positions_plain(ps, qs)
    errors = []
    done = []
    start = threading.Barrier(2)

    def run(which):
        try:
            start.wait()
            for it in range(150):
                if which == 0:
                    got, want = W.window_prefix(v, valid), want_prefix
                else:
                    got, want = W.window_positions(ps, qs), want_pos
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    errors.append((which, it))
                    return
            done.append(which)
        except Exception as e:          # surfaced below
            errors.append((which, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(w,)) for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(done) == [0, 1]

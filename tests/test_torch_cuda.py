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
sorted_search against their plain versions. K12's positions and K13's
prefix and segmented scans at the single-pass scan's tile edges, and
one scan scratch reused over back-to-back calls.
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


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("nb,P", [(1, 50), (1, 0), (5000, 0),
                                  (200_000, 1_000_003)])
def test_k11_matches_plain(cuda, nb, P, dup):
    from tidb_tpu_torch.ops import join as J
    rng = np.random.default_rng(nb + P + int(dup))
    pool = np.sort(rng.choice(1 << 40, max(nb, 2), replace=False))
    bc = pool[rng.integers(0, max(nb // 3, 1), nb)] if dup else pool[:nb]
    codes = torch.from_numpy(rng.permutation(bc)).to(cuda)
    ok_b = torch.from_numpy(rng.random(nb) > 0.1).to(cuda)
    probe = torch.from_numpy(np.where(
        rng.random(P) < 0.7, pool[rng.integers(0, len(pool), P)],
        rng.integers(0, 1 << 40, P))).to(cuda)
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
    table = torch.from_numpy(pool).to(cuda)
    for right in (False, True):
        assert torch.equal(J.searchsorted(table, probe, right),
                           torch.searchsorted(table, probe, right=right))


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
                        lambda *a, **k: scratch.data_ptr())
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

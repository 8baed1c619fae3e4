"""Window functions of the port (tidb_tpu_torch/ops/window.py and the three
device window paths) against the JAX package on the CPU.

* Ops: the port's `compute` on CPU tensors (the torch branch: K12-K15's
  plain versions) against tidb_tpu.ops.window.compute(jnp, ...) on the
  same seed-made sorted layouts — ~2,000 rows in partitions of 1-50 rows
  plus one of 400, ORDER BY keys int64 / int32 / float64 (with ±0.0) /
  scaled DECIMAL with 10% NULLs, ASC and DESC — for every function the
  device gate admits, under every frame kind. Integers, bools and masks
  are exact. Float columns hold within 2·(n-1)·eps·Σ|x| (absolute): the
  port evaluates SUM/AVG by prefix differences of a float64 prefix sum,
  the reference partly by segment sums, so the last bits differ by at
  most the summation error of one prefix. An int32 RANGE key, on which
  the reference raises (its NULL sentinel overflows int32), is held
  against the reference fed the same key as int64.
* Plain versions: K12-K15's plain versions against the reference helpers
  they replace (_pstart_pos, _next_peerstart_pos, _partition_last,
  _segmented_scan, _frame_bounds, range_frame_bounds, ...).
* SQL: twin sessions (tests/torch_diff.py) on tests/test_window.py's
  shapes and small versions of chip_smoke's W1-W6: chain window roots,
  interior windows (rn <= k, TopN over RANK, an aggregate over
  ROW_NUMBER), a window over a join, a multi-slab window root, and
  WindowExec's device path over a host operator. The port's
  Engine(device="cpu") fragments report used_device under strict mode;
  rows equal the JAX engine's (device on, CPU backend) by assert_same.
  The DATE-key RANGE statement, on which the JAX engine raises, equals
  the port's host engine and a brute-force oracle.
"""

import datetime

import numpy as np
import pytest
import torch

from tidb_tpu_torch.executor.fragment import _DEVICE_WINDOW_FUNCS
from tidb_tpu_torch.ops import window as TW
from tidb_tpu_torch.ops.xp import TorchXP
from torch_diff import collect_jax_sessions  # noqa: F401  (autouse)

TX = TorchXP("cpu")
EPS = 2.0 ** -52


def _ref():
    """(jnp, tidb_tpu.ops.window): JAX is imported by the CPU cases only,
    so the card's cases run where JAX is not installed."""
    import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
    from tidb_tpu.ops.jax_env import jnp
    from tidb_tpu.ops import window as JW
    return jnp, JW



KINDS = ("i64", "i32", "f64", "dec")
RANK_LIKE = ("row_number", "rank", "dense_rank", "percent_rank",
             "cume_dist", "ntile", "lag", "lead")
FRAMED = ("sum", "count", "avg", "min", "max", "first_value", "last_value",
          "nth_value")
#: (id, frame, has_order, desc) — the default frame with and without
#: ORDER BY, ROWS with each side bounded or unbounded (2 FOLLOWING AND 3
#: FOLLOWING among them), RANGE ASC and DESC with an unbounded side
FRAMES = [
    ("default", None, True, False),
    ("no_order", None, False, False),
    ("rows_3p_3f", ("rows", 3, 3), True, False),
    ("rows_unb_2f", ("rows", None, 2), True, True),
    ("rows_2p_unb", ("rows", 2, None), True, False),
    ("rows_unb_unb", ("rows", None, None), True, False),
    ("rows_2f_3f", ("rows", -2, 3), True, True),
    ("range_asc", ("range", 6, 0), True, False),
    ("range_desc", ("range", 2, 3), True, True),
    ("range_unb", ("range", None, 4), True, False),
]


def test_gate_lists_sixteen_functions():
    assert len(_DEVICE_WINDOW_FUNCS) == 16
    assert set(_DEVICE_WINDOW_FUNCS) == set(RANK_LIKE) | set(FRAMED)


# ---------------------------------------------------------------------------
# Sorted layouts
# ---------------------------------------------------------------------------


def _layout(kind: str, desc: bool, seed: int = 0, n: int = 2000):
    """A sorted window layout as sort_perm would leave it: partitions of
    1-50 rows and one of 400 in order; within each, the ORDER BY key in
    MySQL order (ASC: NULLs first, DESC: NULLs last). → dict of numpy
    arrays: pstart, peerstart, okey, ovalid, ivals/ivalid (DECIMAL-like
    int64 argument), fvals/fvalid (float64 argument)."""
    rng = np.random.default_rng(seed)
    sizes = [400]
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 51)))
    sizes[-1] -= sum(sizes) - n
    pid = np.repeat(np.arange(len(sizes)), sizes)
    if kind == "i64":
        key = rng.integers(-50, 50, n).astype(np.int64)
    elif kind == "i32":
        key = rng.integers(8036, 8100, n).astype(np.int32)
    elif kind == "f64":
        key = np.round(rng.normal(size=n) * 5, 0)
        key[rng.random(n) < 0.1] = -0.0
    else:
        key = rng.integers(-5000, 5000, n).astype(np.int64)
    ovalid = rng.random(n) > 0.1
    neutral = np.where(ovalid, key, np.zeros((), key.dtype))
    if desc:
        order = np.lexsort((-neutral.astype(np.float64), ~ovalid, pid))
    else:
        order = np.lexsort((neutral, ovalid, pid))
    key, ovalid, neutral = key[order], ovalid[order], neutral[order]
    pstart = np.zeros(n, bool)
    pstart[0] = True
    pstart[1:] = pid[1:] != pid[:-1]
    peerstart = pstart.copy()
    peerstart[1:] |= (neutral[1:] != neutral[:-1]) | \
        (ovalid[1:] != ovalid[:-1])
    fvals = np.round(rng.normal(size=n) * 10, 3)
    return {"pstart": pstart, "peerstart": peerstart, "okey": key,
            "ovalid": ovalid,
            "ivals": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
            "ivalid": rng.random(n) > 0.1, "fvals": fvals,
            "fvalid": rng.random(n) > 0.1}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want, absx):
    """got: the port's (values, mask) tensors; want: the reference's."""
    gv, gm = got[0].numpy(), got[1].numpy()
    wv, wm = np.asarray(want[0]), np.asarray(want[1])
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(gm, wm)
    gv, wv = gv[wm], wv[wm]
    if gv.dtype.kind == "f" or wv.dtype.kind == "f":
        n = len(absx)
        bound = 2 * max(n - 1, 1) * EPS * float(np.nansum(absx))
        same = (np.abs(gv - wv) <= bound) | (np.isnan(gv) & np.isnan(wv))
        assert same.all(), (gv[~same][:5], wv[~same][:5], bound)
    else:
        np.testing.assert_array_equal(gv, wv)


def _run_both(name, lay, frame, has_order, desc, use_float):
    jnp, JW = _ref()
    vals = lay["fvals"] if use_float else lay["ivals"]
    valid = lay["fvalid"] if use_float else lay["ivalid"]
    if name in ("row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist", "ntile"):
        vals = valid = None
    offset = {"ntile": 4, "nth_value": 3, "lag": 2, "lead": 1}.get(name, 1)
    fill = None
    if name in ("lag", "lead"):
        fill = (np.full(len(vals), 7, dtype=vals.dtype),
                np.ones(len(vals), bool))
    okey, ovalid = lay["okey"], lay["ovalid"]
    # the reference's RANGE sentinel overflows an int32 key: feed it int64
    ref_key = okey.astype(np.int64) if okey.dtype == np.int32 else okey
    want = JW.compute(
        jnp, name, None if vals is None else jnp.asarray(vals),
        None if valid is None else jnp.asarray(valid),
        jnp.asarray(lay["pstart"]), jnp.asarray(lay["peerstart"]),
        has_order, offset,
        None if fill is None else tuple(jnp.asarray(f) for f in fill),
        frame=frame, range_key=(jnp.asarray(ref_key), jnp.asarray(ovalid),
                                desc))
    got = TW.compute(
        TX, name, None if vals is None else _t(vals),
        None if valid is None else _t(valid), _t(lay["pstart"]),
        _t(lay["peerstart"]), has_order, offset,
        None if fill is None else tuple(_t(f) for f in fill),
        frame=frame, range_key=(_t(okey), _t(ovalid), desc))
    absx = np.abs(np.where(valid, vals, 0)) if vals is not None and \
        vals.dtype.kind == "f" else np.ones(1)
    _check(got, want, absx)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", RANK_LIKE)
def test_rank_lag_lead_match_reference(name, kind):
    for desc in (False, True):
        lay = _layout(kind, desc, seed=KINDS.index(kind))
        for use_float in ((False, True) if name in ("lag", "lead")
                          else (False,)):
            _run_both(name, lay, None, True, desc, use_float)


_FRAMED_CASES = [(name, fid) for name in FRAMED for fid, fr, _o, _d in FRAMES
                 if not (fr is not None and fr[0] == "range" and
                         name in ("min", "max"))]


@pytest.mark.parametrize("name,fid", _FRAMED_CASES,
                         ids=[f"{n}-{f}" for n, f in _FRAMED_CASES])
def test_framed_functions_match_reference(name, fid):
    _fid, frame, has_order, desc = next(f for f in FRAMES if f[0] == fid)
    kinds = KINDS if frame is not None and frame[0] == "range" else \
        ("i64", "f64")
    for kind in kinds:
        lay = _layout(kind, desc, seed=3 + KINDS.index(kind))
        for use_float in (False, True):
            _run_both(name, lay, frame, has_order, desc, use_float)


def test_int32_range_key_the_reference_rejects():
    """The reference's RANGE sentinel ±(INT64_MAX // 2) overflows an int32
    (DATE) key; the port widens the key first (ops/window.py
    range_frame_bounds)."""
    jnp, JW = _ref()
    lay = _layout("i32", False, seed=9)
    args = (jnp.asarray(lay["pstart"]), jnp.asarray(lay["peerstart"]),
            jnp.asarray(lay["okey"]), jnp.asarray(lay["ovalid"]), False,
            6, 0)
    with pytest.raises(OverflowError):
        JW.range_frame_bounds(jnp, *args)
    got = TW.range_frame_bounds(np, lay["pstart"], lay["peerstart"],
                                lay["okey"], lay["ovalid"], False, 6, 0)
    want = JW.range_frame_bounds(np, lay["pstart"], lay["peerstart"],
                                 lay["okey"].astype(np.int64),
                                 lay["ovalid"], False, 6, 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# K12-K15's plain versions against the reference helpers they replace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_reference_helpers(kind, desc):
    jnp, JW = _ref()
    lay = _layout(kind, desc, seed=20 + KINDS.index(kind))
    ps, qs = lay["pstart"], lay["peerstart"]
    jps, jqs = jnp.asarray(ps), jnp.asarray(qs)
    pos = TW.window_positions_plain(_t(ps), _t(qs))
    eq = np.testing.assert_array_equal
    eq(pos.ppos.numpy(), np.asarray(JW._pstart_pos(jnp, jps)))
    eq(pos.peer_lo.numpy(), np.asarray(JW._pstart_pos(jnp, jqs)))
    eq(pos.plast.numpy(), np.asarray(JW._partition_last(jnp, jps)))
    eq(pos.peer_hi.numpy(), np.asarray(JW._next_peerstart_pos(jnp, jqs)))
    eq((pos.dense - pos.dense[pos.ppos] + 1).numpy(),
       np.asarray(JW.dense_rank(jnp, jps, jqs)))
    for name in ("row_number", "rank", "dense_rank", "percent_rank",
                 "cume_dist"):
        fn = getattr(JW, name)
        want = fn(jnp, jps) if name == "row_number" else fn(jnp, jps, jqs)
        eq(TW.frame_rank_plain(name, pos).numpy(), np.asarray(want))
    eq(TW.frame_rank_plain("ntile", pos, 3).numpy(),
       np.asarray(JW.ntile(jnp, jps, 3)))
    # K13: the segmented scans, forward; the prefix
    for vk, mk in (("ivals", "ivalid"), ("fvals", "fvalid")):
        v, m = lay[vk], lay[mk]
        for is_max, op in ((False, jnp.minimum), (True, jnp.maximum)):
            ident = (-np.inf if is_max else np.inf) if v.dtype.kind == "f" \
                else (np.iinfo(np.int64).min if is_max
                      else np.iinfo(np.int64).max)
            masked = np.where(m, v, np.asarray(ident, dtype=v.dtype))
            eq(TW.window_segscan_plain(_t(v), _t(m), _t(ps), is_max).numpy(),
               np.asarray(JW._segmented_scan(jnp, jnp.asarray(masked), jps,
                                             op)))
        cum, ccnt = TW.window_prefix_plain(_t(v), _t(m))
        eq(ccnt.numpy(), np.cumsum(m.astype(np.int64)))
        np.testing.assert_allclose(cum.numpy(), np.cumsum(np.where(m, v, 0)),
                                   rtol=0, atol=1e-6)
    # K14: ROWS bounds; RANGE bounds over the int64 key
    for pre, post in ((3, 3), (None, 2), (2, None), (None, None), (-2, 3),
                      (1, -1)):
        lo, hi = TW.frame_bounds_plain(pos, pre, post)
        wlo, whi, _ = JW._frame_bounds(jnp, jps, pre, post)
        eq(lo.numpy(), np.asarray(wlo))
        eq(hi.numpy(), np.asarray(whi))
    key = lay["okey"].astype(np.float64 if kind == "f64" else np.int64)
    for pre, post in ((6, 0), (None, 3), (2, None), (0, 0)):
        lo, hi = TW.frame_bounds_plain(pos, pre, post, (_t(key),
                                                        _t(lay["ovalid"]),
                                                        desc))
        wlo, whi = JW.range_frame_bounds(jnp, jps, jqs, jnp.asarray(key),
                                         jnp.asarray(lay["ovalid"]), desc,
                                         pre, post)
        eq(lo.numpy(), np.asarray(wlo))
        eq(hi.numpy(), np.asarray(whi))
        # K15's prefix-difference aggregate over those bounds
        for what in ("count", "sum"):
            cum, ccnt = TW.window_prefix_plain(_t(lay["ivals"]),
                                               _t(lay["ivalid"]))
            gv, gm = TW.frame_agg_plain(what, cum, ccnt, lo, hi)
            wv, wm = JW.range_frame_agg(jnp, what, jnp.asarray(lay["ivals"]),
                                        jnp.asarray(lay["ivalid"]), wlo, whi)
            eq(gm.numpy(), np.asarray(wm))
            eq(gv.numpy()[gm.numpy()], np.asarray(wv)[np.asarray(wm)])
    # K15's bounded MIN/MAX (the sparse table) and gathers (LAG)
    lo, hi = TW.frame_bounds_plain(pos, 3, 3)
    for is_max in (False, True):
        got = TW.frame_minmax_plain(_t(lay["ivals"]), _t(lay["ivalid"]),
                                    is_max, lo, hi, 7)
        wv, wm = JW.rows_frame_agg(jnp, "max" if is_max else "min",
                                   jnp.asarray(lay["ivals"]),
                                   jnp.asarray(lay["ivalid"]), jps, 3, 3)
        eq(got.numpy()[np.asarray(wm)], np.asarray(wv)[np.asarray(wm)])
    fill = (torch.tensor(5), torch.tensor(True))
    gv, gm = TW.frame_gather_plain(_t(lay["ivals"]), _t(lay["ivalid"]), None,
                                   -2, pos.ppos, None, fill)
    wv, wm = JW.shifted(jnp, jnp.asarray(lay["ivals"]),
                        jnp.asarray(lay["ivalid"]), jps, 2,
                        jnp.full(len(ps), 5), jnp.ones(len(ps), bool))
    eq(gv.numpy(), np.asarray(wv))
    eq(gm.numpy(), np.asarray(wm))


def test_flags_plain_matches_a_row_loop():
    """K12 flags' plain version against a row-at-a-time oracle: row 0, a
    change of live, of a partition key or of its NULL flag start a
    partition; an order key change starts a peer group; NULL slots are
    neutralized; -0.0 equals +0.0; every NaN starts a new peer group."""
    rng = np.random.default_rng(5)
    n = 600
    p = rng.integers(0, 4, n)
    pm = rng.random(n) > 0.1
    o = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.0]), n)
    om = rng.random(n) > 0.1
    live = rng.random(n) > 0.2
    perm = rng.permutation(n)
    ps, qs = TW.window_flags_plain(_t(perm), _t(live),
                                   [(_t(p), _t(pm)), (_t(o), _t(om))], 1)

    def key_diff(v, m, a, b):
        if m[a] != m[b]:
            return True
        return bool(m[a]) and not (v[a] == v[b])

    for i in range(n):
        r, q = perm[i], perm[i - 1]
        want_p = i == 0 or live[r] != live[q] or key_diff(p, pm, r, q)
        want_q = want_p or (i > 0 and key_diff(o, om, r, q))
        assert bool(ps[i]) == want_p and bool(qs[i]) == want_q, i


@pytest.mark.parametrize("tile", [1024, 4096])
def test_scan_scratch_bytes_at_tile_edges(tile):
    """K12/K13's scan scratch: per scan a 16-byte tile counter and a
    4-byte flag a tile (rounded up to 16 bytes, the part one memset
    zeroes), then two 32-byte payload slots a tile; at least one tile,
    so n = 0 still gets a valid buffer."""
    for n, nb in ((0, 1), (1, 1), (tile - 1, 1), (tile, 1), (tile + 1, 2),
                  (2 * tile, 2), (8_388_611, -(-8_388_611 // tile))):
        zeroed = 16 + -(-4 * nb // 16) * 16
        one = TW.scan_scratch_bytes(n, tile)
        assert one == zeroed + 64 * nb, (n, tile)
        assert TW.scan_scratch_bytes(n, tile, 2) == 2 * one
        assert zeroed % 16 == 0 and one % 16 == 0
    assert TW.scan_scratch_bytes(4096, 4096) == 96
    assert TW.scan_scratch_bytes(4097, 4096) == 160
    assert TW.scan_scratch_bytes(8_388_611, 4096) == 139_360


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A non-CPU tensor goes to a kernel or raises — here, with no CUDA
    device, a meta tensor must raise rather than fall back."""
    meta = torch.empty(8, dtype=torch.bool, device="meta")
    idx = torch.empty(8, dtype=torch.int64, device="meta")
    pos = TW.Positions(idx, idx, idx, idx, idx)
    for call in (lambda: TW.window_positions(meta, meta),
                 lambda: TW.window_flags(idx, meta, [], 0),
                 lambda: TW.window_prefix(idx, meta),
                 lambda: TW.window_segscan(idx, meta, meta, True),
                 lambda: TW.frame_bounds(pos, 1, 1),
                 lambda: TW.frame_rank("rank", pos),
                 lambda: TW.frame_agg("count", None, idx, idx, idx),
                 lambda: TW.frame_gather(idx, meta, idx, 0, None, None),
                 lambda: TW.frame_minmax(idx, meta, True, idx, idx, 7)):
        with pytest.raises(Exception):
            call()


# ---------------------------------------------------------------------------
# SQL: the three device window paths against the JAX engine
# ---------------------------------------------------------------------------

DDL = [
    "CREATE TABLE w (id BIGINT, g VARCHAR(4), o BIGINT, x DOUBLE, "
    "d DECIMAL(8,2))",
    "CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
    "l_extendedprice DECIMAL(15,2), l_returnflag CHAR(1), "
    "l_linestatus CHAR(1), l_shipdate DATE, l_orderkey BIGINT)",
    "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_orderdate DATE, "
    "o_custkey BIGINT)",
    "CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, "
    "c_mktsegment CHAR(10))",
]


def _tables():
    rng = np.random.default_rng(17)
    n = 800
    gi = rng.integers(0, 6, n)
    w = ({"id": np.arange(n, dtype=np.int64),
          "g": np.array([f"g{i}" for i in gi], dtype=object),
          "o": rng.integers(0, 20, n).astype(np.int64),
          "x": np.round(rng.normal(0, 10, n), 3),
          "d": rng.integers(0, 5000, n).astype(np.int64)},
         {"g": rng.random(n) > 0.05, "o": rng.random(n) > 0.05})
    nl = 4000
    li = ({"l_quantity": rng.integers(100, 5001, nl).astype(np.int64),
           "l_extendedprice": rng.integers(90_000, 10_500_001,
                                           nl).astype(np.int64),
           "l_returnflag": np.array(["A", "N", "R"],
                                    dtype=object)[rng.integers(0, 3, nl)],
           "l_linestatus": np.array(["F", "O"],
                                    dtype=object)[rng.integers(0, 2, nl)],
           "l_shipdate": rng.integers(8036, 10590, nl).astype(np.int32),
           "l_orderkey": rng.integers(0, 1000, nl).astype(np.int64)}, None)
    no, nc = 1000, 100
    orders = ({"o_orderkey": np.arange(no, dtype=np.int64),
               "o_orderdate": rng.integers(8036, 10590, no).astype(np.int32),
               "o_custkey": rng.integers(0, nc, no).astype(np.int64)}, None)
    segs = np.array(["AUTOMOBILE", "BUILDING", "MACHINERY"], dtype=object)
    customer = ({"c_custkey": np.arange(nc, dtype=np.int64),
                 "c_mktsegment": segs[rng.integers(0, 3, nc)]}, None)
    return {"w": w, "lineitem": li, "orders": orders, "customer": customer}


@pytest.fixture(scope="module")
def twins():
    from torch_diff import twin_sessions
    return twin_sessions(DDL, _tables())


STRICT = {"tidb_tpu_strict": 1}

W1 = """SELECT l_orderkey, l_shipdate, l_extendedprice,
 ROW_NUMBER() OVER (PARTITION BY l_orderkey
                    ORDER BY l_shipdate, l_extendedprice),
 RANK() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 DENSE_RANK() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 SUM(l_extendedprice) OVER (PARTITION BY l_orderkey ORDER BY l_shipdate),
 LAG(l_extendedprice) OVER (PARTITION BY l_orderkey
                            ORDER BY l_shipdate, l_extendedprice),
 FIRST_VALUE(l_extendedprice) OVER (PARTITION BY l_orderkey
                                    ORDER BY l_shipdate, l_extendedprice),
 NTILE(4) OVER (PARTITION BY l_orderkey ORDER BY l_shipdate, l_extendedprice),
 CUME_DIST() OVER (PARTITION BY l_orderkey ORDER BY l_shipdate)
 FROM lineitem WHERE l_shipdate >= '1997-06-01'"""

W2 = """SELECT * FROM (SELECT l_returnflag, l_linestatus, l_orderkey,
 l_extendedprice, ROW_NUMBER() OVER (PARTITION BY l_returnflag,
 l_linestatus ORDER BY l_extendedprice DESC, l_orderkey) AS rn
 FROM lineitem) t WHERE rn <= 10"""

W3 = """SELECT l_returnflag, l_linestatus, SUM(s), MAX(m), COUNT(*)
 FROM (SELECT l_returnflag, l_linestatus,
 SUM(l_quantity) OVER (PARTITION BY l_returnflag, l_linestatus
   ORDER BY l_shipdate RANGE BETWEEN 6 PRECEDING AND CURRENT ROW) AS s,
 MAX(l_extendedprice) OVER (PARTITION BY l_returnflag, l_linestatus
   ORDER BY l_shipdate ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS m
 FROM lineitem) t GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""

W4 = """SELECT * FROM (SELECT c_custkey, o_orderkey, o_orderdate,
 RANK() OVER (PARTITION BY o_custkey ORDER BY o_orderdate DESC,
 o_orderkey) AS rk FROM customer JOIN orders ON c_custkey = o_custkey
 WHERE c_mktsegment = 'BUILDING') t WHERE rk = 1"""

W6 = """SELECT l_orderkey, l_returnflag, rev,
 RANK() OVER (PARTITION BY l_returnflag ORDER BY rev DESC) AS rk,
 SUM(n) OVER (PARTITION BY l_returnflag ORDER BY rev DESC, l_orderkey
   ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS n3,
 COUNT(*) OVER (PARTITION BY l_returnflag ORDER BY n
   RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS near
 FROM (SELECT l_orderkey, l_returnflag, SUM(l_extendedprice) AS rev,
 COUNT(*) AS n
 FROM lineitem GROUP BY l_orderkey, l_returnflag) t"""

SQL_CASES = {
    # tests/test_window.py's device differential shapes
    "row_number": "SELECT g, o, id, ROW_NUMBER() OVER (PARTITION BY g "
                  "ORDER BY o, id) FROM w",
    "rank_dense": "SELECT g, o, RANK() OVER (PARTITION BY g ORDER BY o), "
                  "DENSE_RANK() OVER (PARTITION BY g ORDER BY o) FROM w",
    "full_partition": "SELECT g, SUM(x) OVER (PARTITION BY g), "
                      "COUNT(*) OVER (PARTITION BY g), MIN(x) OVER "
                      "(PARTITION BY g), AVG(d) OVER (PARTITION BY g) "
                      "FROM w",
    "running_sum": "SELECT g, o, SUM(x) OVER (PARTITION BY g ORDER BY o) "
                   "FROM w",
    "running_min_max": "SELECT g, o, MIN(x) OVER (PARTITION BY g ORDER BY "
                       "o), MAX(x) OVER (PARTITION BY g ORDER BY o) FROM w",
    "lag_lead": "SELECT g, o, id, LAG(x) OVER (PARTITION BY g ORDER BY o, "
                "id), LEAD(x, 2, 0.25) OVER (PARTITION BY g ORDER BY o, id) "
                "FROM w",
    "rows_frames": "SELECT id, SUM(d) OVER (PARTITION BY g ORDER BY id "
                   "ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING), MIN(d) OVER "
                   "(PARTITION BY g ORDER BY id ROWS BETWEEN 3 PRECEDING AND "
                   "CURRENT ROW), MAX(x) OVER (PARTITION BY g ORDER BY id "
                   "ROWS BETWEEN 2 FOLLOWING AND 3 FOLLOWING) FROM w",
    "range_frames": "SELECT id, SUM(d) OVER (PARTITION BY g ORDER BY o "
                    "RANGE BETWEEN 3 PRECEDING AND 2 FOLLOWING), COUNT(x) "
                    "OVER (PARTITION BY g ORDER BY o DESC RANGE BETWEEN 1 "
                    "PRECEDING AND CURRENT ROW) FROM w",
    "values": "SELECT id, FIRST_VALUE(x) OVER (PARTITION BY g ORDER BY o, "
              "id), LAST_VALUE(d) OVER (PARTITION BY g ORDER BY o, id ROWS "
              "BETWEEN 1 PRECEDING AND 2 FOLLOWING), NTH_VALUE(id, 2) OVER "
              "(PARTITION BY g ORDER BY o, id) FROM w",
    "distribution": "SELECT id, PERCENT_RANK() OVER (PARTITION BY g ORDER "
                    "BY o), CUME_DIST() OVER (PARTITION BY g ORDER BY o), "
                    "NTILE(3) OVER (PARTITION BY g ORDER BY o, id) FROM w",
    "no_partition": "SELECT id, ROW_NUMBER() OVER (ORDER BY x, id), "
                    "SUM(d) OVER () FROM w",
    # interior windows
    "rn_le_k": "SELECT * FROM (SELECT g, id, x, ROW_NUMBER() OVER "
               "(PARTITION BY g ORDER BY x DESC, id) AS rn FROM w) t "
               "WHERE rn <= 3",
    "topn_over_rank": "SELECT g, id, r FROM (SELECT g, id, RANK() OVER "
                      "(PARTITION BY g ORDER BY o) AS r FROM w) t "
                      "ORDER BY r DESC, id LIMIT 7",
    "agg_over_row_number": "SELECT g, SUM(rn), MAX(rn), COUNT(*) FROM "
                           "(SELECT g, ROW_NUMBER() OVER (PARTITION BY g "
                           "ORDER BY id) AS rn FROM w) t GROUP BY g",
    # chip_smoke's statements at a small size
    "w1_chain_root": W1,
    "w2_top_k": W2,
    "w3_frames_under_agg": W3,
    "w4_over_join": W4,
}


@pytest.mark.parametrize("case", list(SQL_CASES))
def test_window_sql_matches_jax_engine(twins, case):
    from torch_diff import assert_same, run_jax, run_port
    js, ts = twins
    sql = SQL_CASES[case]
    got = run_port(ts, sql, extra=STRICT)
    if case == "w3_frames_under_agg":
        # its RANGE frame orders by a DATE: the JAX engine raises there
        # (test_date_range_frame_runs_on_both_engines); hold the port's
        # device run against the port's host engine
        with pytest.raises(OverflowError):
            run_jax(js, sql)
        ts.vars["tidb_tpu_engine"] = "off"
        assert_same([tuple(r) for r in ts.query(sql).rows], got,
                    ordered=True)
        return
    want, _ = run_jax(js, sql)
    assert_same(want, got, ordered="ORDER BY r DESC" in sql)


def _window_in_fragment(ts, sql):
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.physical import PhysTpuFragment, PhysWindow
    ts.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1})
    try:
        plan = ts._plan(parse(sql)[0])
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    found = {"in": False, "any": False}

    def walk(p, inside):
        if isinstance(p, PhysTpuFragment):
            inside = True
            walk(p.root, True)
        if isinstance(p, PhysWindow):
            found["any"] = True
            found["in"] |= inside
        for c in p.children:
            walk(c, inside)

    walk(plan, False)
    return found["in"], found["any"]


@pytest.mark.parametrize("case", ["row_number", "w1_chain_root", "w2_top_k",
                                  "w3_frames_under_agg", "w4_over_join",
                                  "rn_le_k", "agg_over_row_number"])
def test_windows_run_inside_the_device_fragment(twins, case):
    _js, ts = twins
    inside, anywhere = _window_in_fragment(ts, SQL_CASES[case])
    assert anywhere and inside


@pytest.mark.parametrize("max_slab", [1024, 2048])
def test_multi_slab_window_root_is_one_program(twins, max_slab):
    """W2 (and a chain window root) over several slabs: partitions span
    slabs, so the program runs over the concatenated slabs."""
    from torch_diff import assert_same, run_jax, run_port
    js, ts = twins
    for sql in (W2, SQL_CASES["rank_dense"]):
        want, _ = run_jax(js, sql)
        got = run_port(ts, sql, max_slab=max_slab, extra=STRICT)
        assert_same(want, got)
        # and equal to the single-slab run
        assert_same(run_port(ts, sql, extra=STRICT), got)


def test_window_exec_device_path_over_a_host_operator(twins, monkeypatch):
    """W6: the window over an aggregate's rows is a host WindowExec; with
    the engine on, its device path (lexsort over rank codes, K12-K15's
    plain versions here) computes every column."""
    from torch_diff import assert_same, run_jax, run_port
    from tidb_tpu_torch.executor import window as WX
    js, ts = twins
    inside, anywhere = _window_in_fragment(ts, W6)
    assert anywhere and not inside
    calls = []
    orig = WX.WindowExec._one_device

    def spy(self, *a, **k):
        col = orig(self, *a, **k)
        calls.append(col is not None)
        return col

    monkeypatch.setattr(WX.WindowExec, "_one_device", spy)
    want, _ = run_jax(js, W6)
    got = run_port(ts, W6, extra=STRICT)
    assert calls and all(calls)
    assert_same(want, got)
    ts.vars["tidb_tpu_engine"] = "off"
    assert_same([tuple(r) for r in ts.query(W6).rows], got)


def test_window_exec_declines_object_arguments_before_device_work(
        twins, monkeypatch):
    """A spec whose argument evaluates to an object array runs on the
    host, before any device work; the other specs keep the device path."""
    from torch_diff import assert_same
    from tidb_tpu_torch.ops import window as W
    _js, ts = twins
    sql = ("SELECT g, c, FIRST_VALUE(g) OVER (ORDER BY c, g), "
           "RANK() OVER (ORDER BY c DESC, g) FROM (SELECT g, COUNT(*) AS c "
           "FROM w GROUP BY g) t")
    seen = []
    from tidb_tpu_torch.executor import fragment as FR
    monkeypatch.setattr(FR, "_window_device_ok", lambda plan: True)
    orig = W.window_bounds

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(W, "window_bounds", spy)
    ts.vars["tidb_tpu_engine"] = "off"
    want = [tuple(r) for r in ts.query(sql).rows]
    ts.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1})
    try:
        got = [tuple(r) for r in ts.query(sql).rows]
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
    assert seen == [1]                # only the RANK spec sorted there
    assert_same(want, got)


def _date_range_oracle(rows):
    """SUM(q) over RANGE BETWEEN 6 PRECEDING AND CURRENT ROW by date within
    each flag, row by row (NULL dates are each other's peers)."""
    out = []
    for f, d, q in rows:
        if d is None:
            peers = [r[2] for r in rows if r[0] == f and r[1] is None]
        else:
            peers = [r[2] for r in rows if r[0] == f and r[1] is not None
                     and d - datetime.timedelta(days=6) <= r[1] <= d]
        vals = [p for p in peers if p is not None]
        out.append((f, d, sum(vals) if vals else None))
    return out


def test_date_range_frame_runs_on_both_engines(twins):
    """The RANGE frame over a DATE key: the JAX package raises
    OverflowError on it (host and device engine alike); the port answers
    on its host engine and on the device, equal to a brute-force
    oracle."""
    from torch_diff import assert_same, run_port
    js, ts = twins
    for t in (js, ts):
        t.execute("CREATE TABLE dr (f CHAR(1), d DATE, q BIGINT)")
    rng = np.random.default_rng(3)
    vals = []
    for i in range(3000):
        day = "NULL" if rng.random() < 0.05 else \
            f"'{datetime.date(1998, 1, 1) + datetime.timedelta(days=int(rng.integers(0, 60)))}'"
        q = "NULL" if rng.random() < 0.05 else str(int(rng.integers(1, 50)))
        vals.append(f"('{'ANR'[int(rng.integers(0, 3))]}', {day}, {q})")
    for t in (js, ts):
        t.execute("INSERT INTO dr VALUES " + ",".join(vals))
        t.execute("ANALYZE TABLE dr")
    sql = ("SELECT f, d, SUM(q) OVER (PARTITION BY f ORDER BY d "
           "RANGE BETWEEN 6 PRECEDING AND CURRENT ROW) FROM dr")
    with pytest.raises(OverflowError):
        js.query(sql)
    ts.vars["tidb_tpu_engine"] = "off"
    host = [tuple(r) for r in ts.query(sql).rows]
    dev = run_port(ts, sql, extra=STRICT)
    base = [tuple(r) for r in ts.query("SELECT f, d, q FROM dr").rows]

    def norm(rows):
        return sorted((str(f), str(d), None if v is None else int(v))
                      for f, d, v in rows)

    assert_same(host, dev)
    assert norm(host) == norm(_date_range_oracle(base))


# ---------------------------------------------------------------------------
# On the card (skips without a CUDA device)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_equal_plain_versions_on_the_card(cuda, kind):
    """compute over K12-K15 on CUDA tensors equals compute over the plain
    versions on CPU copies (float SUM/AVG within the prefix bound)."""
    for desc in (False, True):
        lay = _layout(kind, desc, seed=40 + KINDS.index(kind))
        for name in _DEVICE_WINDOW_FUNCS:
            for _fid, frame, has_order, _d in FRAMES:
                if frame is not None and frame[0] == "range" and \
                        name in ("min", "max"):
                    continue
                vals, valid = _t(lay["fvals"]), _t(lay["fvalid"])
                fill = (torch.tensor(0.5), torch.tensor(True))
                rk = (_t(lay["okey"]), _t(lay["ovalid"]), desc)
                args = (name, vals, valid, _t(lay["pstart"]),
                        _t(lay["peerstart"]), has_order, 2, fill)
                want = TW.compute(TX, *args, frame=frame, range_key=rk)
                got = TW.compute(
                    TorchXP(cuda), *[a.to(cuda) if isinstance(a, torch.Tensor)
                                     else a for a in args[:7]],
                    tuple(f.to(cuda) for f in fill), frame=frame,
                    range_key=tuple(k.to(cuda) if isinstance(k, torch.Tensor)
                                    else k for k in rk))
                _check(tuple(t.cpu() for t in got),
                       tuple(t.numpy() for t in want),
                       np.abs(np.where(lay["fvalid"], lay["fvals"], 0)))

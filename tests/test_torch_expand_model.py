"""A numpy model of K7 join_expand's one-launch design (csrc/join_expand.cu
`expand_onepass`) against tidb_tpu.ops.join.expand under jax.numpy.

The model follows the kernel step by step. Probe tiles of 2,048 rows
(lane l of warp w, load q: row w·256 + 32q + l) compute each row's
output count, scan each load over its 32 lanes, chain the loads, take
the 8 warp totals in order, and find their exclusive prefix by the
decoupled look-back window of csrc/lookback.cuh (lane l reads tile
t0 - l, the nearest inclusive prefix stops the window), here over
status words published in an arbitrary order; every row with slots
marks its first slot (row + 1) and names itself the first row of each
slot tile whose first slot it holds, and the last tile writes the
total. Slot tiles of 2,048 output slots take each slot's row from a
max-scan of (row + 1, offset) keys over their marks in slot order
(slot q·256 + warp·32 + lane: warp scans, then the warp maxima in
order), or from their first row where no mark precedes the slot;
slots past the total are dead (p_idx 0, k 0, b_idx 0). The same steps
also run at a small tile (64 threads, 2 rows a thread), so that the
look-back and the first rows cross many tiles at small sizes.

Live slots and the total must equal the reference exactly, at inner and
outer joins, P = 0, nb = 1, out_cap below the total and one probe row
holding most matches; every dead slot's indices lie in range."""

import functools

import numpy as np
import pytest

from tidb_tpu_torch.ops import join as TJ

CONFIGS = [(256, 8), (64, 2)]        # (threads, rows or slots a thread)


def look_back(agg, incl, t, first, rng):
    """The exclusive prefix of tile t over tiles [first, t), as warp 0 of
    csrc/lookback.cuh reads it: each earlier tile shows its aggregate or
    its inclusive prefix (drawn at random: any order of publication)."""
    if t == first:
        return 0
    shows_incl = rng.random(t) < 0.3
    excl = 0
    t0 = t - 1
    while True:
        lanes = t0 - np.arange(32)
        flags = [True if x < first else bool(shows_incl[x]) for x in lanes]
        vals = [0 if x < first else (incl[x] if shows_incl[x] else agg[x])
                for x in lanes]
        stop = flags.index(True) if any(flags) else 31
        excl += sum(vals[:stop + 1])
        if any(flags):
            return excl
        t0 -= 32


def probe_tiles(oc, threads, ipt, rng):
    """→ (cum, total): the probe tiles' scan, look-back and stores."""
    warps, tile = threads // 32, threads * ipt
    P = len(oc)
    tp = max(1, -(-P // tile))
    x = np.zeros(tp * tile, dtype=np.int64)
    x[:P] = oc
    # (tile, warp, load q, lane): row = t·tile + w·32·ipt + 32q + lane
    x = x.reshape(tp, warps, ipt, 32)
    inc = np.cumsum(x, axis=3)                    # each load's warp scan
    load_tot = inc[..., 31]
    inc = inc + (np.cumsum(load_tot, axis=2) - load_tot)[..., None]
    wtot = load_tot.sum(axis=2)                   # the 8 warp totals
    wex = np.cumsum(wtot, axis=1) - wtot
    agg = wtot.sum(axis=1)
    incl = np.cumsum(agg)                         # what tiles publish
    pre = np.array([look_back(agg, incl, t, 0, rng) for t in range(tp)])
    cum = (inc + wex[..., None, None] + pre[:, None, None, None])
    return cum.reshape(-1)[:P], int(pre[-1] + agg[-1])


def marks_and_first_rows(cum, oc, out_cap, tile):
    """The probe tiles' writes: row + 1 at each row's first slot (below
    out_cap), and each slot tile's first row and that row's first slot
    from the row holding the tile's first slot."""
    marks = np.zeros(out_cap, dtype=np.int64)
    first_row, first_begin = {}, {}
    rows = np.flatnonzero(oc)
    end = cum[rows].astype(np.int64)
    begin = end - oc[rows]
    keep = begin < out_cap
    rows, end, begin = rows[keep], end[keep], begin[keep]
    marks[begin] = rows + 1
    first_b = -(-begin // tile) * tile
    last = np.minimum(end, out_cap)
    for p, b0, b1, bg in zip(rows[first_b < last], first_b[first_b < last],
                             last[first_b < last], begin[first_b < last]):
        for b in range(int(b0), int(b1), tile):   # the row's thread's loop
            first_row[b // tile] = int(p)
            first_begin[b // tile] = int(bg)
    return marks, first_row, first_begin


def slot_keys(marks, s0, threads, ipt):
    """A slot tile's max-scan of (row + 1) << 32 | offset keys over its
    marks, slot q·threads + warp·32 + lane in (q, warp, lane) order: each
    warp's inclusive scan, then the warp maxima's exclusive scan."""
    warps = threads // 32
    j = s0 + np.arange(ipt * threads)
    m = np.where(j < len(marks), marks[np.minimum(j, len(marks) - 1)], 0)
    key = np.where(m > 0, (m << 32) | (j - s0), 0).reshape(ipt, warps, 32)
    inc = np.maximum.accumulate(key, axis=2)
    wmax = inc[..., 31].reshape(-1)                 # (q, warp) order
    excl = np.concatenate([[0], np.maximum.accumulate(wmax)[:-1]])
    return np.maximum(inc, excl.reshape(ipt, warps, 1)).reshape(-1)


def k7_model(start, count, order, out_cap, outer, live, threads=256,
             ipt=8, seed=0):
    rng = np.random.default_rng(seed)
    P, nb = len(count), len(order)
    oc = np.where(live, np.maximum(count, 1) if outer else count, 0)
    cum, total = probe_tiles(oc.astype(np.int64), threads, ipt, rng)
    tile = threads * ipt
    marks, first_row, first_begin = marks_and_first_rows(cum, oc, out_cap,
                                                         tile)
    p_idx = np.full(out_cap, -7, dtype=np.int32)     # every slot is written
    k = np.full(out_cap, -7, dtype=np.int32)
    b_idx = np.full(out_cap, -7, dtype=np.int32)
    matched = np.zeros(out_cap, dtype=bool)
    out_live = np.ones(out_cap, dtype=bool)
    for s in range(-(-out_cap // tile)):
        s0 = s * tile
        s1 = min(s0 + tile, out_cap)
        lend = min(s1, total)
        j = np.arange(s0, s1)
        dead = j >= lend
        p_idx[j[dead]] = 0
        k[j[dead]] = 0
        b_idx[j[dead]] = 0
        out_live[j[dead]] = False
        if s0 >= lend:
            continue
        # the kernel reads marks below lend only (none lies past the total)
        key = slot_keys(marks[:lend], s0, threads, ipt)[:s1 - s0][~dead]
        jl = j[~dead]
        p = np.where(key > 0, (key >> 32) - 1, first_row[s])
        begin = np.where(key > 0, s0 + (key & 0xFFFFFFFF), first_begin[s])
        kk = jl - begin
        pos = np.clip(start[p].astype(np.int64) + kk, 0, nb - 1)
        p_idx[jl] = p
        k[jl] = kk
        b_idx[jl] = order[pos]
        matched[jl] = kk < count[p]
    return p_idx, b_idx, matched, out_live, k, total


def _case(seed, P, nb, hot=0, counts=4):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, counts, P).astype(np.int32)
    live = rng.random(P) > 0.15
    start = rng.integers(0, max(nb - counts, 1), P).astype(np.int32)
    if hot:
        count[P // 2] = hot
        live[P // 2] = True
        start[P // 2] = 0
    order = rng.permutation(nb).astype(np.int32)
    return start, count, order, live


def _inputs(case, outer, fit):
    spec = CASES[case]
    start, count, order, live = _case(len(case), **spec)
    oc = np.where(live, np.maximum(count, 1) if outer else count, 0)
    total = int(oc.sum())
    out_cap = total + 1000 if fit == "above" else max(total // 3, 1)
    return start, count, order, out_cap, outer, live


@functools.lru_cache(maxsize=None)
def _reference(case, outer, fit):
    """tidb_tpu.ops.join.expand under jax.numpy, jitted (imported here),
    once a case for both tile configurations."""
    from tidb_tpu.ops import join as JJ
    from tidb_tpu.ops.jax_env import jax, jnp
    start, count, order, out_cap, outer, live = _inputs(case, outer, fit)
    expand = jax.jit(JJ.expand, static_argnums=(3, 4))
    out = expand(jnp.asarray(start), jnp.asarray(count), jnp.asarray(order),
                 out_cap, outer, jnp.asarray(live))
    return tuple(np.asarray(x) for x in out)


def _same(got, want, P, nb):
    gp, gb, gm, gl, gk, gt = got
    wp, wb, wm, wl, wk, wt = want
    assert gt == int(wt)
    np.testing.assert_array_equal(gl, wl)
    for a, b in ((gp, wp), (gb, wb), (gm, wm), (gk, wk)):
        np.testing.assert_array_equal(a[wl], b[wl])
    assert not gm[~wl].any()
    assert ((gp >= 0) & (gp < max(P, 1))).all()
    assert ((gb >= 0) & (gb < nb)).all()


CASES = {
    "spread": dict(P=5000, nb=300),
    "nb1": dict(P=700, nb=1, counts=2),
    "hot": dict(P=3000, nb=20_005, hot=20_000),
}


@pytest.mark.parametrize("threads,ipt", CONFIGS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("fit", ["above", "below"])
def test_model_equals_reference(threads, ipt, case, outer, fit):
    start, count, order, out_cap, outer, live = _inputs(case, outer, fit)
    got = k7_model(start, count, order, out_cap, outer, live, threads, ipt,
                   seed=threads)
    want = _reference(case, outer, fit)
    assert got[5] == int(want[5])         # true even when it overflows
    _same(got, want, CASES[case]["P"], CASES[case]["nb"])


@pytest.mark.parametrize("threads,ipt", CONFIGS)
def test_model_empty_probe(threads, ipt):
    """P = 0: one probe tile over no rows publishes a total of 0 and
    every slot is dead, as the port's plain version has it."""
    z = np.zeros(0, dtype=np.int32)
    order = np.zeros(1, dtype=np.int32)
    got = k7_model(z, z, order, 64, True, np.zeros(0, dtype=bool), threads,
                   ipt)
    want = TJ.expand_plain(*(TJ.torch.from_numpy(a) for a in (z, z, order)),
                           64, True, TJ.torch.from_numpy(
                               np.zeros(0, dtype=bool)))
    assert got[5] == int(want[5]) == 0
    assert not got[3].any() and not got[2].any()
    assert (got[0] == 0).all() and (got[1] == 0).all()


def test_look_back_window_sums_every_earlier_tile():
    """The look-back window over 100 tiles, whatever each shows: the sum
    of the aggregates before the tile, from the column's first tile."""
    rng = np.random.default_rng(3)
    agg = rng.integers(0, 1000, 100)
    incl = np.cumsum(agg)
    for t in (0, 1, 31, 32, 33, 64, 99):
        assert look_back(agg, incl, t, 0, rng) == agg[:t].sum()
    # a column starting at tile 40: its own tiles only
    incl40 = np.cumsum(np.where(np.arange(100) >= 40, agg, 0))
    for t in (40, 41, 75, 99):
        assert look_back(agg, incl40, t, 40, rng) == agg[40:t].sum()


def test_first_rows_name_every_live_tile_once():
    """Each slot tile below the total gets exactly one first row (the row
    holding its first slot), a hot row many, and marks sit only at rows'
    first slots."""
    rng = np.random.default_rng(4)
    oc = rng.integers(0, 3, 5000)
    oc[2500] = 10_000
    cum = np.cumsum(oc)
    out_cap = int(cum[-1]) - 77
    marks, first_row, first_begin = marks_and_first_rows(cum, oc, out_cap,
                                                         256)
    assert sorted(first_row) == list(range(-(-out_cap // 256)))
    for s, p in first_row.items():
        assert cum[p] - oc[p] <= s * 256 < cum[p]
        assert first_begin[s] == cum[p] - oc[p]
    rows = marks[marks > 0] - 1
    np.testing.assert_array_equal(np.flatnonzero(marks), (cum - oc)[rows])
    assert sum(p == 2500 for p in first_row.values()) >= 10_000 // 256

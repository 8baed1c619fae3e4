"""A numpy model of K2 unpack_decode's one-launch design
(csrc/unpack_decode.cu `decode_columns`) against
tidb_tpu.chunk.compress.decode_slab under jax.numpy.

The model follows the kernel step by step over a call of many columns:
launches of at most 16 columns, one block a (column, 4,096-row tile) in
column order; thread t of a tile expands mask word (r >> 5) at shift
r & 16 into the 16 bytes of rows r = 16t.. (four 4-bit nibbles spread by
the multiply 0x00204081); it takes groups of G = 16 / itemsize rows
(group s·256 + t), each row's code from word i·w/32 at shift (i·w) mod 32;
a delta tile scans its group sums (a warp scan a store step, the S·8 warp
totals in row order by warp 0, EPL of them a lane), takes its column's
prefix by the look-back window of csrc/lookback.cuh over the tiles
before it in the same column (the status in an arbitrary order of
publication), and adds the slab's base. Every row must be written once,
and every slot must equal the reference, values included, at widths
0-32, int64 and int32, caps of one, a part and several tiles, with the
delta carry across tiles and no carry across columns."""

import functools

import numpy as np
import pytest
import torch

from tidb_tpu_torch.chunk import compress as TC
from tidb_tpu_torch.executor.device_cache import _upload

THREADS = 256
WARPS = THREADS // 32
TILE = TC.K2_TILE
MAX_COLS = TC.K2_MAX_COLS
LAYOUTS = ([("pack", w) for w in (0, 1, 2, 4, 8, 16, 32)] +
           [("dict", w) for w in (1, 2, 4, 8, 16)] +
           [("delta", w) for w in (1, 2, 4, 8, 16, 32)])


def look_back(agg, incl, t, first, rng):
    """The exclusive prefix of status tile t over [first, t), as warp 0
    of csrc/lookback.cuh reads it (each earlier tile shows its aggregate
    or its inclusive prefix, drawn at random)."""
    if t == first:
        return 0
    shows_incl = rng.random(t) < 0.3
    excl, t0 = 0, t - 1
    while True:
        lanes = t0 - np.arange(32)
        flags = [True if x < first else bool(shows_incl[x]) for x in lanes]
        vals = [0 if x < first else int(incl[x] if shows_incl[x]
                                         else agg[x]) for x in lanes]
        stop = flags.index(True) if any(flags) else 31
        excl += sum(vals[:stop + 1])
        if any(flags):
            return excl
        t0 -= 32


def mask_model(mw, cap, tiles):
    """Every tile's 256 threads, 16 mask bytes each → (bytes, writes)."""
    out = np.zeros(cap, dtype=np.uint8)
    writes = np.zeros(cap, dtype=np.int64)
    r = (np.arange(tiles)[:, None] * TILE +
         16 * np.arange(THREADS)[None, :]).reshape(-1)
    r = r[r < cap]
    bits = (mw[r >> 5].astype(np.uint64) >> (r & 16).astype(np.uint64)) \
        & np.uint64(0xFFFF)
    q = [(((bits >> np.uint64(4 * i)) & np.uint64(0xF)) *
          np.uint64(0x00204081)) & np.uint64(0x01010101) for i in range(4)]
    by = np.stack(q, axis=1).astype("<u4").view(np.uint8)   # 16 a thread
    rows = r[:, None] + np.arange(16)[None, :]
    keep = rows < cap
    out[rows[keep]] = by[keep]
    np.add.at(writes, rows[keep], 1)
    return out, writes


def column_model(lay, slab, cap, tiles, status, rng):
    """One column's values, tile by tile; `status` = (first status tile
    of this delta column, agg, incl) or None."""
    dt = np.dtype(lay.dtype)
    G = 16 // dt.itemsize
    S = TILE // (THREADS * G)
    # (tile, store step s, thread t, row e of the group)
    rows = (np.arange(tiles)[:, None, None, None] * TILE +
            (np.arange(S)[None, :, None, None] * THREADS +
             np.arange(THREADS)[None, None, :, None]) * G +
            np.arange(G)[None, None, None, :])
    on = rows < cap
    out = np.zeros(cap, dtype=dt)
    writes = np.zeros(cap, dtype=np.int64)
    np.add.at(writes, rows[on], 1)
    if lay.width == 0:
        out[rows[on]] = np.int64(lay.ref).astype(dt)
        return out, writes
    w = lay.width
    words = slab[0].view(np.uint32).astype(np.uint64)
    bit = np.where(on, rows, 0).astype(np.uint64) * np.uint64(w)
    m = np.uint64((1 << w) - 1)
    codes = np.where(on, (words[(bit >> np.uint64(5)).astype(np.int64)] >>
                          (bit & np.uint64(31))) & m, 0).astype(np.int64)
    if lay.kind == "pack":
        vals = (codes + lay.ref).astype(dt)
    elif lay.kind == "dict":
        vals = slab[2][np.minimum(codes, lay.card - 1)]
    else:
        first, agg, incl = status
        gs = codes.sum(axis=3)                               # (T, S, 256)
        inc = np.cumsum(gs.reshape(tiles, S, WARPS, 32), axis=3)
        wtot = inc[..., 31].reshape(tiles, S * WARPS)        # row order
        epl = S * WARPS // 32
        lane_t = wtot.reshape(tiles, 32, epl)
        ls = lane_t.sum(axis=2)
        li = np.cumsum(ls, axis=1)
        base = int(slab[2][0])
        excl = np.empty_like(wtot)
        for t in range(tiles):
            agg[first + t] = li[t, 31]
            incl[first + t] = agg[first:first + t + 1].sum()
        for t in range(tiles):
            pre = look_back(agg, incl, first + t, first, rng)
            run = base + pre + li[t] - ls[t]                 # (32,)
            for e in range(epl):
                excl[t, np.arange(32) * epl + e] = run
                run = run + lane_t[t, :, e]
        grp = (excl.reshape(tiles, S, WARPS, 1) + inc -
               gs.reshape(tiles, S, WARPS, 32)).reshape(tiles, S, THREADS)
        vals = (grp[..., None] + np.cumsum(codes, axis=3)).astype(dt)
    out[rows[on]] = vals[on]
    return out, writes


def k2_model(items, cap, seed=0):
    """→ [(vals, mask)] of the call, launch by launch."""
    rng = np.random.default_rng(seed)
    tiles = -(-cap // TILE)
    out = []
    for c0 in range(0, len(items), MAX_COLS):
        part = items[c0:c0 + MAX_COLS]
        n_delta = sum(lay.kind == "delta" and lay.width > 0
                      for lay, _ in part)
        agg = np.zeros(max(n_delta, 1) * tiles, dtype=np.int64)
        incl = np.zeros_like(agg)
        dslot = 0
        for lay, slab in part:
            status = None
            if lay.kind == "delta" and lay.width:
                status = (dslot * tiles, agg, incl)
                dslot += 1
            vals, vw = column_model(lay, slab, cap, tiles, status, rng)
            mask, mwr = mask_model(slab[1].view(np.uint32), cap, tiles)
            assert (vw == 1).all() and (mwr == 1).all()   # each row once
            out.append((vals, mask.astype(bool)))
    return out


def _column(rng, kind, width, dt, cap, n):
    dt = np.dtype(dt)
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    if kind != "delta":
        mask[:n] &= rng.random(n) > 0.15
    if kind == "pack":
        ref = -(1 << 20) if dt == np.int64 else -777
        hi = min((1 << width) - 1 if width else 0,
                 int(np.iinfo(dt).max) + ref)
        vals = (rng.integers(0, hi + 1, cap) + ref).astype(dt)
        return TC.ColLayout("pack", width, ref, dt.name), vals, mask, None
    if kind == "dict":
        card = min(1 << width, 600)
        dv = np.unique(rng.integers(-10 ** 9, 10 ** 9, 4 * card)
                       .astype(dt))[:card]
        return (TC.ColLayout("dict", width, 0, dt.name, len(dv)),
                dv[rng.integers(0, len(dv), cap)], mask, dv)
    gap = min((1 << width) - 1, 1 << 20)
    vals = (np.cumsum(rng.integers(0, gap + 1, cap)) - 300).astype(dt)
    return TC.ColLayout("delta", width, 0, dt.name), vals, mask, None


def _host_items(cap, dt, seed):
    rng = np.random.default_rng(seed)
    items = []
    for kind, w in LAYOUTS:
        lay, vals, mask, dv = _column(rng, kind, w, dt, cap,
                                      max(cap - 37, 1))
        host = TC.pack_slab(lay, vals, mask, dv) + ((dv,) if dv is not None
                                                   else ())
        items.append((lay, host))
    return items


@functools.lru_cache(maxsize=None)
def _jax_decode(cap, dt, seed):
    from tidb_tpu.chunk import compress as JC
    from tidb_tpu.ops.jax_env import jnp
    out = []
    for lay, host in _host_items(cap, dt, seed):
        jlay = JC.ColLayout(lay.kind, lay.width, lay.ref, lay.dtype,
                            lay.card)
        v, m = JC.decode_slab(jlay, tuple(jnp.asarray(a) for a in host),
                              cap, jnp)
        out.append((np.asarray(v), np.asarray(m)))
    return out


CAPS = [1, 33, 3 * TILE - 37]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("dt", [np.int64, np.int32])
def test_model_equals_reference_every_slot(cap, dt):
    """18 columns (every kind and width of one dtype) in one call: two
    launches, each slot equal to the JAX decode."""
    items = _host_items(cap, dt, cap)
    got = k2_model(items, cap, seed=cap)
    for (lay, _), (gv, gm), (jv, jm) in zip(items, got,
                                           _jax_decode(cap, dt, cap)):
        assert gv.dtype == jv.dtype == np.dtype(dt), lay
        np.testing.assert_array_equal(gm, jm, err_msg=lay.sig())
        np.testing.assert_array_equal(gv, jv, err_msg=lay.sig())


def test_model_delta_carries_across_tiles_not_columns():
    """Two delta columns back to back over 5 tiles each: each starts
    from its own base, and the int64 running sum passes 2^31."""
    cap = 5 * TILE - 1
    rng = np.random.default_rng(9)
    items = []
    for w in (32, 16):
        lay, vals, mask, _ = _column(rng, "delta", w, np.int64, cap, cap)
        items.append((lay, TC.pack_slab(lay, vals, mask)))
        assert w == 16 or vals[-1] > 2 ** 31
    got = k2_model(items, cap, seed=4)
    for (lay, host), (gv, gm) in zip(items, got):
        tv, tm = TC.decode_slab(lay, host, cap, np)
        np.testing.assert_array_equal(gv, tv)
        np.testing.assert_array_equal(gm, tm)


def test_mask_nibble_spread():
    """The multiply 0x00204081 spreads a nibble's bits into four bytes."""
    for x in range(16):
        b = ((x * 0x00204081) & 0x01010101).to_bytes(4, "little")
        assert list(b) == [(x >> i) & 1 for i in range(4)]


def test_decode_plan_chunks_and_scratch():
    """The pure plan: launches of at most 16 columns, the static fields
    of each argument block, scratch only for a launch with delta
    columns, sized as csrc/unpack_decode.cu lays it out."""
    lays = tuple(TC.ColLayout(k, w, -3 if k == "pack" else 0, "int32",
                              5 if k == "dict" else 0)
                 for k, w in LAYOUTS) * 2
    plan = TC.decode_plan(lays, 10_000)
    assert [len(cols) for _, cols, _ in plan] == [16, 16, 4]
    tiles = -(-10_000 // TILE)
    for (blob, cols, need), c0 in zip(plan, (0, 16, 32)):
        a = TC._DecodeArgs.from_buffer_copy(blob)
        part = lays[c0:c0 + 16]
        assert a.n_cols == len(part) and a.cap == 10_000
        assert [a.width[q] for q in range(len(part))] == \
            [lay.width for lay in part]
        n_delta = sum(lay.kind == "delta" for lay in part)
        assert need == (16 + -(-4 * n_delta * tiles // 16) * 16 +
                        16 * n_delta * tiles if n_delta else 0)
        assert all(a.vals[q] is None for q in range(16))


def test_torch_entry_equals_the_model():
    """decode_slabs_torch on CPU tensors (the plain version) equals the
    model in every slot over a mixed call."""
    cap = 2 * TILE + 5
    items = _host_items(cap, np.int64, 11)
    dev = torch.device("cpu")
    tslabs = [(lay, tuple(_upload(a, dev) for a in host))
              for lay, host in items]
    for (tv, tm), (gv, gm) in zip(TC.decode_slabs_torch(tslabs, cap),
                                  k2_model(items, cap, seed=1)):
        np.testing.assert_array_equal(tv.numpy(), gv)
        np.testing.assert_array_equal(tm.numpy(), gm)

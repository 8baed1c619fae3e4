"""A numpy model of K12 window_bounds' flags launch (csrc/window_scan.cu
`bounds_flags`) against the JAX package's boundary flags and positions.

The model lays rows out as the kernel does: a warp takes 32 R
consecutive sorted rows (R = FLAG_ROWS, 2; the cases also run R = 8),
lane l of load k holding row w0 + 32 k + l.
Key by key (`live`, the partition keys, the order keys), a row whose
flag is already set reads no more keys; a row gathers a key's value and
mask once through the permutation when it or its successor still needs
them, and a needing row takes its predecessor's from the previous lane,
for lane 0 from the previous load's lane 31, and for the warp's first
row from a load of its own. Flags leave as each lane's R-byte store of
rows w0 + R l .. w0 + R l + R - 1, cut out of the ballot of load
R l // 32.
More than eight keys take the chunked flags entry: the same launch a
chunk of eight keys at a time, each chunk starting from the flags the
earlier ones stored. Given the count of live rows that the permutation lists
first (sort_perm's), the live flag is `row == n_live` with no gather.
The reference is the `flags` closure of
tidb_tpu/executor/device_emit.py emit_window_cols (restated here with
jnp, as it is a closure) and tidb_tpu/ops/window.py's _pstart_pos,
_partition_last and _next_peerstart_pos. Cases: n = 1, TILE - 1, TILE,
TILE + 1 and 3 TILE + 5, with NaN, ±0.0, NULLs, dead rows, bool keys,
int32 and int64 permutations, and 9 keys. The port's `window_bounds` on
CPU tensors (its plain version) is held to the same reference."""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import window as TW

TILE = 2048                 # the scans' tile, whose edges the cases hit
ROWS = 2                    # rows a lane in bounds_flags (FLAG_ROWS)
MAX_KEYS = 8


def _ref():
    import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
    from tidb_tpu.ops.jax_env import jnp
    from tidb_tpu.ops import window as JW
    return jnp, JW


def ref_flags(perm, live, keys, n_part):
    """The reference's `flags` closure (device_emit.py emit_window_cols),
    over numpy inputs; live None: every row live."""
    jnp, _ = _ref()
    n = len(perm)
    lv = np.ones(n, dtype=bool) if live is None else live
    lives_s = jnp.take(jnp.asarray(lv), jnp.asarray(perm))
    first = jnp.zeros(n, dtype=bool).at[0].set(True)

    def flags(cols):
        out = first | jnp.concatenate(
            [jnp.zeros(1, dtype=bool), lives_s[1:] != lives_s[:-1]])
        for v, m in cols:
            vs = jnp.take(jnp.asarray(v), jnp.asarray(perm))
            ms = jnp.take(jnp.asarray(m), jnp.asarray(perm))
            vs = jnp.where(ms, vs, jnp.zeros_like(vs))
            out = out | jnp.concatenate(
                [jnp.zeros(1, dtype=bool),
                 (vs[1:] != vs[:-1]) | (ms[1:] != ms[:-1])])
        return out

    pstart = flags(keys[:n_part])
    peerstart = flags(keys) if keys[n_part:] else pstart
    return np.asarray(pstart), np.asarray(peerstart)


def ref_positions(pstart, peerstart):
    jnp, JW = _ref()
    ps, qs = jnp.asarray(pstart), jnp.asarray(peerstart)
    return (np.asarray(JW._pstart_pos(jnp, ps)),
            np.asarray(JW._partition_last(jnp, ps)),
            np.asarray(JW._pstart_pos(jnp, qs)),
            np.asarray(JW._next_peerstart_pos(jnp, qs)),
            np.cumsum(peerstart.astype(np.int64)))


def _changes(vals, mask, r, inrow, rf, hf, flag):
    """flag |= one key's changes over the (warps, R, 32) row grid, for
    the rows whose flag is clear (`need`). A row gathers its value and
    mask only when it or its successor (the next lane; for lane 31 the
    next load's lane 0; none past the warp's last row) needs them; a
    needing row takes its predecessor's by the shuffle (the previous
    lane, the previous load's lane 31) and the warp's first row loads
    its own; NULL slots are neutralized."""
    need = inrow & ~flag
    succ = np.zeros_like(need)
    succ[:, :, :-1] = need[:, :, 1:]
    succ[:, :-1, 31] = need[:, 1:, 0]
    own = need | succ
    zero = vals.dtype.type(0)
    cur = np.where(own, vals[r], zero)
    mk = np.ones(r.shape, dtype=bool) if mask is None else \
        np.where(own, mask[r], False)
    fo = hf & need[:, 0, 0]
    first = np.where(fo, vals[rf], zero)
    fm = np.ones(rf.shape, dtype=bool) if mask is None else \
        np.where(fo, mask[rf], False)
    cur = np.where(mk, cur, zero)
    first = np.where(fm, first, zero)

    def pred(x, f):
        p = np.empty_like(x)
        p[:, :, 1:] = x[:, :, :-1]            # the previous lane
        p[:, 1:, 0] = x[:, :-1, 31]           # the previous load's lane 31
        p[:, 0, 0] = f                        # the warp's own load
        return p

    with np.errstate(invalid="ignore"):
        return flag | (need & ((cur != pred(cur, first)) |
                               (mk != pred(mk, fm))))


def flags_model(perm, live, keys, n_part, n_live=None, rows_a_lane=ROWS,
                prev=None):
    """→ (pstart, peerstart) bool (n) as K12's flags launch computes and
    stores them (at most MAX_KEYS keys; a warp takes 32 R consecutive
    rows, R = rows_a_lane). `n_live`: perm lists the live rows first, and
    the live flag is `row == n_live` (nothing gathered). `prev`: the
    (pstart, peerstart) already in the outputs, which the launch starts
    from (accumulate)."""
    n = len(perm)
    R = rows_a_lane
    nw = max(1, -(-n // (32 * R)))
    w0 = np.arange(nw) * 32 * R
    rows = (w0[:, None, None] + 32 * np.arange(R)[None, :, None] +
            np.arange(32)[None, None, :])
    inrow = rows < n
    r = np.where(inrow, perm[np.minimum(rows, max(n - 1, 0))], 0) if n \
        else np.zeros_like(rows)
    hf = (w0 > 0) & (w0 < n)
    rf = np.where(hf, perm[np.clip(w0 - 1, 0, max(n - 1, 0))], 0) if n \
        else np.zeros_like(w0)
    ps = np.zeros(rows.shape, dtype=bool)
    qs = np.zeros(rows.shape, dtype=bool)
    if prev is not None and n:
        at = np.minimum(rows, n - 1)
        ps = inrow & prev[0][at]
        qs = inrow & prev[1][at]
    if n_live is not None:
        ps = ps | (inrow & (rows == n_live) & (n_live > 0))
    elif live is not None:
        ps = _changes(live.astype(np.int32), None, r, inrow, rf, hf, ps)
    for v, m in keys[:n_part]:
        ps = _changes(v, m, r, inrow, rf, hf, ps)
    qs = qs | ps
    for v, m in keys[n_part:]:
        qs = _changes(v, m, r, inrow, rf, hf, qs)
    ps[rows == 0] = True
    qs[rows == 0] = True
    return _store(ps, w0, n), _store(qs, w0, n)


def _store(flags, w0, n):
    """The packed side output: lane l of warp w writes rows w0 + R l + b
    (b < R) from bit R l % 32 + b of load R l // 32's ballot."""
    R = flags.shape[1]
    out = np.zeros(n, dtype=bool)
    bits = (flags.astype(np.uint64) << np.arange(32, dtype=np.uint64))
    ballot = bits.sum(axis=2)                          # (warps, R)
    for w in range(len(w0)):
        for lane in range(32):
            word = int(ballot[w, R * lane // 32]) >> (R * lane % 32)
            for b in range(R):
                row = w0[w] + R * lane + b
                if row < n:
                    out[row] = (word >> b) & 1
    return out


def chunked_flags_model(perm, live, keys, n_part, rows_a_lane=ROWS):
    """More than MAX_KEYS keys: the flags launch once a chunk of MAX_KEYS
    keys (`live` in the first only), each later chunk starting from the
    flags the earlier ones stored."""
    prev = None
    for c0 in range(0, len(keys), MAX_KEYS):
        chunk = keys[c0:c0 + MAX_KEYS]
        np_c = min(max(n_part - c0, 0), len(chunk))
        prev = flags_model(perm, live if c0 == 0 else None, chunk, np_c,
                           None, rows_a_lane, prev)
    return prev


def bounds_model(perm, live, keys, n_part, n_live=None, rows_a_lane=ROWS):
    if len(keys) > MAX_KEYS:
        return chunked_flags_model(perm, live, keys, n_part, rows_a_lane)
    return flags_model(perm, live, keys, n_part, n_live, rows_a_lane)


def _layout(n, nkeys, seed, with_live=True):
    """Rows sorted as sort_perm sorts them (dead rows last), keys of small
    domains so runs of ties cross lanes, loads, warps and tiles: an int64
    partition key with NULLs, then float64 (NaN, ±0.0), int32, bool and
    int64 keys with NULLs."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) > 0.1 if with_live else None
    keys = []
    for j in range(nkeys):
        kind = ("i64", "f64", "i32", "bool")[j % 4] if j else "i64"
        if kind == "f64":
            v = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.0]), n)
        elif kind == "i32":
            v = rng.integers(0, 3, n).astype(np.int32)
        elif kind == "bool":
            v = rng.random(n) < 0.5
        else:
            v = rng.integers(0, 4 if j else 3, n).astype(np.int64)
        keys.append((v, rng.random(n) > 0.15))
    canon = [np.where(m, np.nan_to_num(np.abs(v).astype(np.float64),
                                       nan=9.0), -1.0) for v, m in keys]
    dead = np.zeros(n) if live is None else (~live).astype(np.float64)
    perm = np.lexsort(tuple(reversed([dead] + canon))) if n else \
        np.zeros(0, dtype=np.int64)
    return perm.astype(np.int64), live, keys


CASES = [(1, 3, 1), (TILE - 1, 3, 1), (TILE, 4, 2), (TILE + 1, 5, 1),
         (3 * TILE + 5, 2, 1), (TILE + 1, 9, 3), (700, 9, 0),
         (TILE - 1, 1, 1), (257, 0, 0), (TILE + 1, 17, 10), (TILE, 9, 9)]


@pytest.mark.parametrize("rows_a_lane", [ROWS, 8])
@pytest.mark.parametrize("perm32", [False, True])
@pytest.mark.parametrize("n,nkeys,n_part", CASES)
def test_flags_model_equals_reference(n, nkeys, n_part, perm32, rows_a_lane):
    perm, live, keys = _layout(n, nkeys, n + nkeys)
    if perm32:
        perm = perm.astype(np.int32)
    ps, qs = bounds_model(perm, live, keys, n_part, None, rows_a_lane)
    wps, wqs = ref_flags(perm, live, keys, n_part)
    np.testing.assert_array_equal(ps, wps)
    np.testing.assert_array_equal(qs, wqs)
    assert wps.any() and wqs[~wps].any() or n < 2 or nkeys <= n_part


@pytest.mark.parametrize("n,nkeys,n_part", CASES)
def test_window_bounds_plain_equals_reference(n, nkeys, n_part):
    """The port's window_bounds on CPU tensors (its plain version):
    flags and all five positions equal the reference's."""
    perm, live, keys = _layout(n, nkeys, 3 * n + nkeys)
    tkeys = [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in keys]
    ps, qs, pos = TW.window_bounds(torch.from_numpy(perm),
                                   torch.from_numpy(live), tkeys, n_part)
    wps, wqs = ref_flags(perm, live, keys, n_part)
    np.testing.assert_array_equal(ps.numpy(), wps)
    np.testing.assert_array_equal(qs.numpy(), wqs)
    for got, want in zip((pos.ppos, pos.plast, pos.peer_lo, pos.peer_hi,
                          pos.dense), ref_positions(wps, wqs)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,nkeys,n_part", CASES)
def test_flags_model_with_n_live_equals_reference(n, nkeys, n_part):
    """The window emit passes sort_perm's count of live rows, which it
    lists first: the live flag is then `row == n_live`, with no gather,
    and the flags equal the reference's, which compares `live`."""
    perm, live, keys = _layout(n, nkeys, 5 * n + nkeys)
    ps, qs = bounds_model(perm, live, keys, n_part, int(live.sum()))
    wps, wqs = ref_flags(perm, live, keys, n_part)
    np.testing.assert_array_equal(ps, wps)
    np.testing.assert_array_equal(qs, wqs)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE + 1])
def test_flags_model_without_live(n):
    """executor/window.py's layout passes no `live` (every row live)."""
    perm, _live, keys = _layout(n, 3, n, with_live=False)
    ps, qs = bounds_model(perm, None, keys, 1)
    wps, wqs = ref_flags(perm, None, keys, 1)
    np.testing.assert_array_equal(ps, wps)
    np.testing.assert_array_equal(qs, wqs)


@pytest.mark.parametrize("rows_a_lane", [1, 2, 4, 8])
def test_packed_store_places_every_row_once(rows_a_lane):
    """Each lane's R-byte store covers rows w0 + R l .. w0 + R l + R - 1
    of its warp: over a warp's 32 lanes every row of the 32 R exactly
    once, each from its own (load, lane) ballot bit."""
    R = rows_a_lane
    flags = np.zeros((1, R, 32), dtype=bool)
    for k in range(R):
        for lane in range(32):
            flags[0, k, lane] = (k * 32 + lane) % 3 == 0
    out = _store(flags, np.array([0]), 32 * R)
    np.testing.assert_array_equal(out, np.arange(32 * R) % 3 == 0)

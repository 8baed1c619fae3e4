"""A numpy model of K10's gather entry (csrc/sorted_groups.cu `gid_gather`)
against tidb_tpu.ops.factorize `factorize` and `_dense1` under jax.numpy.

The entry serves sorts of two radix words: the value fills the first word
(a full-range BIGINT or a DOUBLE; a 63-bit value shares it with its NULL
flag), and K8's sorted last word holds the dead flag and, when the value
leaves it room, the NULL flag. The model takes the words that the plain
K9/K8 packing makes (`_lexsort_kernel` on CPU tensors) and walks the
kernel's tiles of 2,048 sorted rows: eight warps of 256 rows, each in
eight rounds of 32 lanes (row = tile·2048 + warp·256 + round·32 + lane).
Each row reads its row id and word in order and gathers what the word
lacks (the value, and the mask when it shares the value's word; without
the word the mask and the live flag too); it takes its sorted
neighbour's (flag, value) from the previous lane, from lane 31 of the
round before, or for lane 0 of round 0 by reading the row before the
warp's run. Boundaries are ranked by ballots within each warp, the warps
by an exclusive scan, and the tile by look-back over the earlier tiles'
status words, drawn here at random as an aggregate or an inclusive
prefix, in windows of 32 as the kernel reads them; then the scattered
ids, rep (a group's first sorted row, the last slot by a minimum) and
n_groups from the last tile. The model and the wrapper's plain version
must equal the reference exactly (gids, n_groups and rep for cap 3 below
the group count and n + 1; `_dense1`'s codes for cap 0) over full-range
int64 with NULLs, float64 with NaN, -0.0 / +0.0 and NULLs, a 63-bit
value whose mask shares its word, a value without a mask, every row
dead, and n = 2, the tile's edges and two tiles and more; n = 1 (no sort
of two words) without the word. The card test
`test_k10_gather_entry_with_and_without_the_word` (tests/test_torch_cuda.py)
runs the kernel at the same edges."""

import numpy as np
import pytest
import torch

import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
from tidb_tpu.ops import factorize as JF
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu_torch.ops import factorize as TF

WORD_ITEMS = 8                  # csrc/sorted_groups.cu WORD_ITEMS
WARPS = 8                       # THREADS / 32
WARP_ROWS = 32 * WORD_ITEMS     # a warp's run of sorted rows
TILE = WARPS * WARP_ROWS        # WORD_TILE
CASES = ("i64_nulls", "f64_nulls", "i63_mask", "i64_no_mask", "all_dead")
SIZES = (2, 2047, 2048, 2049, 4099)


def _case(case, n, rng):
    """(values, NULL mask or None, live) whose sort takes two words
    (n >= 2), as the card test's cases."""
    live = rng.random(n) > 0.05
    m = rng.random(n) > 0.1
    if case == "f64_nulls":
        v = rng.choice(np.array([0.0, -0.0, -np.inf, np.inf, 2.5, -1.5,
                                 np.nan]), n)
        v[:2] = [-np.inf, np.nan]
        m[:2] = True
        return v, m, live
    if case == "i63_mask":
        v = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
        v[:2] = [-2 ** 62, 2 ** 62 - 1]
        m[:2] = True
        return v, m, live
    tokens = rng.integers(-2 ** 63, 2 ** 63 - 1, max(n // 8, 2),
                          dtype=np.int64)
    v = tokens[rng.integers(0, len(tokens), n)]
    v[:2] = [-2 ** 63, 2 ** 63 - 2]
    if case == "i64_no_mask":
        return v, None, live
    m[:2] = True
    if case == "all_dead":
        return v, m, np.zeros(n, dtype=bool)
    return v, m, live


def _look_back(status, tile):
    """The kernel's look-back: windows of 32 earlier tiles (lane l reads
    tile - 1 - l), summing every count up to the newest tile that holds
    an inclusive prefix. `status[t]` is (has_prefix, count)."""
    excl = 0
    t = tile - 1
    while t >= 0:
        window = [status[t - lane] if t - lane >= 0 else (True, 0)
                  for lane in range(32)]
        pre = [lane for lane, (p, _) in enumerate(window) if p]
        if pre:
            excl += sum(c for _, c in window[:pre[0] + 1])
            return excl
        excl += sum(c for _, c in window)
        t -= 32
    return excl


def gather_model(sidx, v, m, live, cap, word, rng):
    """K10's gather pass → (gids, n_groups, rep) (gids alone for cap 0)
    and the random loads a row made. `word` is (w as uint64, dead_shift,
    null_shift) or None."""
    n = len(sidx)
    loads = 0

    def key_at(i):
        nonlocal loads
        r = sidx[i]
        if word is not None:
            w, dead_shift, null_shift = word
            dead = bool((w[i] >> np.uint64(dead_shift)) & np.uint64(1))
            if null_shift >= 0:
                ok = bool((w[i] >> np.uint64(null_shift)) & np.uint64(1))
            else:
                ok = True if m is None else bool(m[r])
                loads += m is not None
        else:
            ok = True if m is None else bool(m[r])
            dead = cap > 0 and not live[r]
            loads += (m is not None) + (cap > 0)
        if ok:
            loads += 1
        return ok, dead, (v[r] if ok else 0)

    def differs(a, b):
        return bool(a != b)             # the dtype's own `!=`

    gids = np.zeros(n, dtype=np.int32)
    rep = np.full(max(cap, 0), max(n - 1, 0), dtype=np.int32)
    n_groups = 0
    status, totals = [], []
    n_tiles = (n + TILE - 1) // TILE
    for tile in range(n_tiles):
        ranks, flags, rows, counts = {}, {}, {}, []
        for warp in range(WARPS):
            wbase = tile * TILE + warp * WARP_ROWS
            keys = {}
            for j in range(WORD_ITEMS):
                for lane in range(32):
                    i = wbase + j * 32 + lane
                    if i < n:
                        keys[(j, lane)] = key_at(i)
            before = key_at(wbase - 1) if 0 < wbase <= n else None
            run = 0
            for j in range(WORD_ITEMS):
                bal = []
                for lane in range(32):
                    i = wbase + j * 32 + lane
                    if i >= n:
                        bal.append(False)
                        continue
                    ok, dead, val = keys[(j, lane)]
                    if lane > 0:
                        prev = keys[(j, lane - 1)]
                    elif j > 0:
                        prev = keys[(j - 1, 31)]
                    else:
                        prev = before
                    b = i == 0 or ok != prev[0] or \
                        (ok and differs(val, prev[2]))
                    if cap > 0 and dead:
                        b = False
                    bal.append(b)
                for lane in range(32):
                    i = wbase + j * 32 + lane
                    if i < n:
                        ranks[i] = run + sum(bal[:lane + 1])
                        flags[i] = bal[lane]
                        rows[i] = warp
                run += sum(bal)
            counts.append(run)
        warp_excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        total = int(sum(counts))
        excl = _look_back(status, tile)
        assert excl == sum(totals), (tile, excl)
        totals.append(total)
        # tile 0 publishes its prefix at once; a later tile its aggregate,
        # then its inclusive prefix: a look-back may find either
        has_prefix = tile == 0 or bool(rng.random() < 0.5)
        status.append((has_prefix, excl + total if has_prefix else total))
        for i, rank in ranks.items():
            gid_s = excl + int(warp_excl[rows[i]]) + rank - 1
            r = int(sidx[i])
            if cap <= 0:
                gids[r] = gid_s
                continue
            gids[r] = min(max(gid_s, 0), cap - 1)
            if flags[i]:
                if gid_s < cap - 1:
                    rep[gid_s] = r
                else:
                    rep[cap - 1] = min(rep[cap - 1], r)
        if cap > 0 and tile == n_tiles - 1:
            n_groups = excl + total
    return (gids if cap == 0 else (gids, n_groups, rep)), loads


def _reference(v, m, live, cap):
    jv = jnp.asarray(v)
    jm = None if m is None else jnp.asarray(m)
    jl = jnp.asarray(live)
    if cap == 0:
        return np.asarray(JF._dense1(jv, jm, jl))
    gids, ng, rep = JF.factorize([(jv, jm)], jl, cap)
    return np.asarray(gids), int(ng), np.asarray(rep)


def _same(got, want, what):
    if isinstance(want, tuple):
        assert np.array_equal(np.asarray(got[0]), want[0]), what
        assert int(got[1]) == want[1], what
        assert np.array_equal(np.asarray(got[2]), want[2]), what
    else:
        assert np.array_equal(np.asarray(got), want), what


def _sorted(v, m, live):
    """The plain K9 + K8 sort of the key's operands → (int32 row ids,
    SortWords, the torch inputs)."""
    tv, tl = torch.from_numpy(v), torch.from_numpy(live)
    tm = None if m is None else torch.from_numpy(m)
    sidx, words = TF._lexsort_kernel(TF._key_operands([(tv, tm)], tl))
    return sidx, words, (tv, tm, tl)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_gather_model_matches_reference(case, n):
    rng = np.random.default_rng(n + 11 * len(case))
    v, m, live = _case(case, n, rng)
    sidx, words, (tv, tm, tl) = _sorted(v, m, live)
    assert words.count == 2, case
    w, dead_shift, null_shift = TF._gather_key(words, tm)
    in_word = case in ("i64_nulls", "f64_nulls", "all_dead")
    assert (null_shift >= 0) == in_word, case
    word = (w.numpy().view(np.uint64), dead_shift, null_shift)
    s = sidx.numpy()
    for cap in (0, 3, n + 1):
        want = _reference(v, m, live, cap)
        got, loads = gather_model(s, v, m, live, cap, word, rng)
        _same(got, want, (case, n, cap, "word"))
        # with the word, one random load a row at most (the value, not
        # loaded for a NULL), two where the mask shares the value's word
        assert loads <= n * (1 if in_word or m is None else 2) + 2 * (
            (n + WARP_ROWS - 1) // WARP_ROWS), (case, loads)
        got, _ = gather_model(s, v, m, live, cap, None, rng)
        _same(got, want, (case, n, cap, "no word"))
        plain = TF.group_ids_plain(sidx, tv, tm, tl, cap)
        _same(plain if cap else plain.numpy(), want, (case, n, cap, "plain"))


@pytest.mark.parametrize("case", CASES)
def test_gather_model_one_row_without_the_word(case):
    """n = 1: every operand's codes are constant, so the sort takes one
    word and the main path never sends it here; the entry's call without
    the word still equals the reference."""
    rng = np.random.default_rng(len(case))
    v, m, live = _case(case, 2, rng)
    v, live = v[1:], live[1:]
    m = None if m is None else m[1:]
    s = np.zeros(1, dtype=np.int32)
    for cap in (0, 3):
        got, _ = gather_model(s, v, m, live, cap, None, rng)
        _same(got, _reference(v, m, live, cap), (case, cap))


def test_gather_route_passes_the_last_word():
    """`_sort_groups_kernel` hands a two-word sort's last word to the
    gather entry (the wrapper's CPU route runs the plain version, so the
    word's parameters are checked as `_gather_key` derives them): the
    dead flag above the NULL flag, both in the last word."""
    rng = np.random.default_rng(3)
    v, m, live = _case("i64_nulls", 4099, rng)
    _sidx, words, (_tv, tm, _tl) = _sorted(v, m, live)
    w, dead_shift, null_shift = TF._gather_key(words, tm)
    assert (dead_shift, null_shift) == (1, 0)
    bits = w.numpy().view(np.uint64)
    assert set(np.unique(bits).tolist()) <= {0, 1, 2, 3}

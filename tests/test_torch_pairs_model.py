"""A numpy model of the DISTINCT pair factorize's kernel steps against
tidb_tpu.ops.factorize.distinct_pair_factorize under jax.numpy.

The model follows the kernels step by step: K16 `pair_word` (warp steps
of 128 rows, two pairs of rows a lane, the last n % 128 rows one a
thread) writes the pair sort's one radix word, (gid·(n+1) + vid) |
!pair_live << W; a stable sort over
its W + 1 bits stands for K8; K10's word pass (csrc/sorted_groups.cu
`gid_words`) walks tiles of 2,048 sorted rows, eight warps of 256 rows
each in rounds of 32 lanes: boundary flags (a change under the code's
bits, masked by the dead flag), inclusive ranks within each warp, the
warps' exclusive prefix, the tile's prefix by look-back over the earlier
tiles, then the clamped ids, rep (the group's first sorted row; the last
slot by atomicMin) and the first mask (set at each flagged row; at row
n - 1 alone when the last tile finds no live row). The model and the
port's plain versions (`pair_word_plain`, `pair_sort`,
`group_ids_words_plain` with `first`) must equal the reference exactly:
first and pg on every row, n_pairs, and rep whole; over random gids with
dead rows, ties, every pair dead, every value NULL, n = 1, a gid_cap at
its limit and none given. The word is held to the two K9 passes it
replaces and the sort to `_lexsort_kernel` of the same operands."""

import numpy as np
import pytest
import torch

import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
from tidb_tpu.ops import factorize as JF
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu_torch.ops import factorize as TF

WORD_ITEMS = 8                  # csrc/sorted_groups.cu WORD_ITEMS
WARP_ROWS = 32 * WORD_ITEMS     # a warp's run of sorted rows
WORD_TILE = 256 * WORD_ITEMS    # a tile: eight warps
PAIR_STEP = 128                 # csrc/distinct_pairs.cu STEP_ROWS
N = 4099                        # two tiles and three rows


def pair_word_model(gids, vid, live, gid_cap):
    """K16: the word of every row (uint64), warp step by warp step (128
    rows; lane t's pairs of rows 2t and 64 + 2t, each stored by one
    16-byte store), then the last n % 128 rows one a thread; asserts
    that every row is written once."""
    n = len(gids)
    width = TF.pair_width(gid_cap, n)
    out = np.zeros(n, dtype=np.uint64)
    writes = np.zeros(n, dtype=np.int64)

    def word(r):
        code = np.uint64(int(gids[r]) * (n + 1) + int(vid[r]))
        return code | (np.uint64(0) if live[r] else np.uint64(1 << width))

    steps = n // PAIR_STEP
    for k in range(steps):
        for lane in range(32):
            for j in range(2):
                r = k * PAIR_STEP + j * 64 + 2 * lane
                assert (r * 8) % 16 == 0
                for e in range(2):
                    out[r + e] = word(r + e)
                    writes[r + e] += 1
    for r in range(steps * PAIR_STEP, n):
        out[r] = word(r)
        writes[r] += 1
    assert (writes == 1).all()
    return out, width


def k10_words_model(w, sidx, width, cap):
    """K10's word pass with the first mask over the sorted words `w`
    (uint64) and their rows `sidx` → (gids, n_groups, rep, first)."""
    n = len(w)
    cmp_mask = np.uint64((1 << width) - 1)
    gids = np.zeros(n, dtype=np.int32)
    rep = np.full(cap, max(n - 1, 0), dtype=np.int32)
    first = np.zeros(n, dtype=bool)
    n_groups = 0
    status = []                                   # each tile's total
    for tile in range((n + WORD_TILE - 1) // WORD_TILE):
        lo = tile * WORD_TILE
        warp_runs, ranks, flags = [], [], []
        for warp in range(WORD_TILE // WARP_ROWS):
            run, wr, wf = 0, [], []
            for j in range(WORD_ITEMS):
                i = lo + warp * WARP_ROWS + j * 32 + np.arange(32)
                ok = i < n
                ic = np.minimum(i, n - 1)
                prev = w[np.maximum(ic - 1, 0)]
                b = ok & ((i == 0) | (((w[ic] ^ prev) & cmp_mask) != 0))
                b &= ((w[ic] >> np.uint64(width)) & np.uint64(1)) == 0
                wr.append(run + np.cumsum(b))         # inclusive, a ballot
                wf.append(b)
                run += int(b.sum())
            warp_runs.append(run)
            ranks.append(wr)
            flags.append(wf)
        warp_excl = np.concatenate([[0], np.cumsum(warp_runs)[:-1]])
        excl = sum(status)                        # the look-back
        status.append(sum(warp_runs))
        for warp in range(len(warp_runs)):
            for j in range(WORD_ITEMS):
                for lane in range(32):
                    i = lo + warp * WARP_ROWS + j * 32 + lane
                    if i >= n:
                        continue
                    gid_s = excl + warp_excl[warp] + ranks[warp][j][lane] - 1
                    r = sidx[i]
                    gids[r] = min(max(gid_s, 0), cap - 1)
                    if flags[warp][j][lane]:
                        if gid_s < cap - 1:
                            rep[gid_s] = r
                        else:
                            rep[cap - 1] = min(rep[cap - 1], r)
                        first[r] = True
        if tile == (n - 1) // WORD_TILE:
            n_groups = excl + status[-1]
            if n_groups == 0:
                first[n - 1] = True
    return gids, n_groups, rep, first


def _inputs(case, seed, n=N):
    rng = np.random.default_rng(seed)
    cap = 12
    live = rng.random(n) > 0.2
    valid = rng.random(n) > 0.1
    gids = rng.integers(0, cap, n)
    vals = rng.integers(-40, 40, n)
    if case == "ties":
        vals = rng.integers(0, 3, n)
        gids = rng.integers(0, 2, n)
    elif case == "all dead":
        live[:] = False
    elif case == "all null":
        valid[:] = False
    elif case == "n=1":
        live, valid, gids, vals = live[:1] | True, valid[:1] | True, \
            gids[:1], vals[:1]
    elif case == "gid_cap limit":
        cap = (1 << 63) // (n + 1) - 1
        gids = np.where(gids > 6, (1 << 31) - 1, gids)
    gid_cap = None if case == "no gid_cap" else cap
    gids = np.where(live, gids, min(cap, (1 << 31) - 1)).astype(np.int32)
    return gids, vals.astype(np.int64), valid, live, gid_cap


CASES = ["random", "ties", "all dead", "all null", "n=1", "gid_cap limit",
         "no gid_cap"]


def _reference(gids, vals, valid, live):
    n = len(live)
    return [np.asarray(a) for a in JF.distinct_pair_factorize(
        jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(live), n)]


@pytest.mark.parametrize("case", CASES)
def test_pair_model_matches_reference(case):
    """The model's word, sort and K10 pass → exactly the reference's
    (first, pg, n_pairs, rep), every row and every slot."""
    gids, vals, valid, live, gid_cap = _inputs(case, 3 + CASES.index(case))
    n = len(live)
    jf, jpg, jn, jrep = _reference(gids, vals, valid, live)
    pl = live & valid
    vid = TF._dense1(torch.from_numpy(vals), None,
                     torch.from_numpy(pl)).numpy()
    bound = TF.GID_MAX if gid_cap is None else gid_cap
    w, width = pair_word_model(gids, vid, pl, bound)
    key = w & np.uint64((1 << (width + 1)) - 1) if width < 63 else w
    sidx = np.argsort(key, kind="stable")
    pg, n_pairs, rep, first = k10_words_model(w[sidx], sidx, width, n)
    assert n_pairs == int(jn)
    np.testing.assert_array_equal(first, jf)
    np.testing.assert_array_equal(pg, jpg)
    np.testing.assert_array_equal(rep, jrep)


@pytest.mark.parametrize("case", CASES)
def test_pair_plain_matches_reference_and_model(case):
    """The port's plain route (pair_word_plain, radix_sort_plain, the word
    entry's plain version with `first`, as distinct_pair_factorize takes
    it on CPU tensors) equals the reference and the model's word."""
    gids, vals, valid, live, gid_cap = _inputs(case, 11 + CASES.index(case))
    n = len(live)
    jf, jpg, jn, jrep = _reference(gids, vals, valid, live)
    t = torch.from_numpy
    tf, tpg, tn, trep = TF.distinct_pair_factorize(
        t(gids), t(vals), t(valid), t(live), n, gid_cap=gid_cap)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tpg.numpy(), jpg)
    np.testing.assert_array_equal(trep.numpy(), jrep)
    pl = t(live & valid)
    vid = TF._dense1(t(vals), None, pl)
    bound = TF.GID_MAX if gid_cap is None else gid_cap
    word = TF.pair_word_plain(t(gids), vid, pl, bound)
    model, _ = pair_word_model(gids, vid.numpy(), live & valid, bound)
    np.testing.assert_array_equal(word.numpy().view(np.uint64), model)
    f2, pg2, n2, rep2 = TF.distinct_pair_factorize(
        t(gids), t(vals), t(valid), t(live), n, gid_cap=gid_cap,
        want_pg=False)
    assert pg2 is None and int(n2) == int(jn)
    np.testing.assert_array_equal(f2.numpy(), jf)
    np.testing.assert_array_equal(rep2.numpy(), jrep)


@pytest.mark.parametrize("gid_cap", [12, 4096, (1 << 63) // (N + 1) - 1])
def test_pair_word_is_the_k9_word(gid_cap):
    """K16's word equals the two K9 passes it replaces (the pair code
    under its bound at shift 0, the dead flag at bit W), and the pair sort
    equals `_lexsort_kernel` of those operands: words, rows and fields."""
    gids, vals, valid, live, _ = _inputs("random", 29)
    t = torch.from_numpy
    gids = np.where(live, gids, min(gid_cap, 12)).astype(np.int32)
    pl = t(live & valid)
    vid = TF._dense1(t(vals), None, pl)
    g = t(gids)
    width = TF.pair_width(gid_cap, N)
    code = TF.pair_code_plain(g, vid)
    k9, _ = TF.sort_encode_plain(code, 2, None, None, False, 1 << 63, 0)
    k9, _ = TF.sort_encode_plain(pl, 0, None, None, True, 0, width, k9,
                                 accumulate=True)
    assert torch.equal(TF.pair_word(g, vid, pl, gid_cap), k9)
    perm, words = TF._lexsort_kernel([
        TF.SortOp(pl, desc=True),
        TF.SortOp(code, hi=(gid_cap + 1) * (N + 1))])
    sidx, pw = TF.pair_sort(g, vid, pl, gid_cap)
    assert (pw.count, pw.fields) == (words.count, words.fields)
    assert torch.equal(pw.last, words.last) and torch.equal(sidx, perm)


def test_first_mask_needs_a_slot_a_row():
    """The first mask is offered only for cap >= n (every pair its own
    slot): a smaller cap raises; the ids may be left out only beside the
    mask (never for _dense1's codes, cap 0), and rep, n_groups and the
    mask stay as they were."""
    w = torch.tensor([0, 0, 3, 3, 3, 7, 1 << 5, 1 << 5, 1 << 5, 1 << 5])
    sidx = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        TF.group_ids_words_plain(w, sidx, 31, None, 5, 9, first=True)
    with pytest.raises(ValueError):
        TF.group_ids_words_plain(w, sidx, 31, None, 5, 0, want_gids=False)
    with pytest.raises(ValueError):
        TF.group_ids_words_plain(w, sidx, 31, None, 5, 10, want_gids=False)
    gids, ng, rep = TF.group_ids_words_plain(w, sidx, 31, None, 5, 10)
    bare = TF.group_ids_words_plain(w, sidx, 31, None, 5, 10, first=True,
                                    want_gids=False)
    assert bare[0] is None and int(bare[1]) == int(ng) == 3
    assert torch.equal(bare[2], rep)
    first = bare[3]
    assert first.tolist() == [True, False, True, False, False, True] + \
        [False] * 4
    assert torch.equal(first, TF.first_mask_plain(rep, gids))
    with pytest.raises(ValueError):
        TF.pair_width(-1, 10)
    with pytest.raises(ValueError):
        TF.pair_width(1 << 62, 10)

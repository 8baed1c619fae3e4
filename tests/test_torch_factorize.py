"""Port factorize / sort_perm / topn (ops/factorize.py, plain torch)
against the JAX package's (lax.sort based) on the CPU. Exactly equal:
group ids in the same rank order (NULL first), n_groups, rep, the full
ORDER BY permutation (stable ties) and the top-k indices."""

import numpy as np
import pytest
import torch

from tidb_tpu.ops import factorize as JF
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu_torch.ops import factorize as TF

N = 2000


def _keys(spec, seed):
    rng = np.random.default_rng(seed)
    out = []
    for kind in spec:
        if kind == "i64":
            v = rng.integers(-5, 6, N).astype(np.int64)
        elif kind == "i32":
            v = rng.integers(0, 40, N).astype(np.int32)
        elif kind == "f64":
            v = np.round(rng.normal(size=N), 1)
        else:                                   # "code": dict codes
            v = rng.integers(0, 4, N).astype(np.int32)
        m = rng.random(N) > 0.1
        out.append((v, m))
    live = rng.random(N) > 0.2
    return out, live


def _both(keys, live):
    jk = [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys]
    tk = [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in keys]
    return jk, jnp.asarray(live), tk, torch.from_numpy(live)


SPECS = [["i64"], ["f64"], ["code", "i32"], ["i64", "code", "f64"],
         ["i32", "i32", "i64", "code"]]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("cap", [8, 4096])
def test_factorize_matches_jax(spec, cap):
    keys, live = _keys(spec, len(spec) * 13 + cap)
    jk, jl, tk, tl = _both(keys, live)
    jg, jn, jr = JF.factorize(jk, jl, cap)
    tg, tn, tr = TF.factorize(tk, tl, cap)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("desc_pattern", [0, 1, 2])
def test_sort_perm_matches_jax(spec, desc_pattern):
    keys, live = _keys(spec, len(spec) * 31 + desc_pattern)
    descs = [(i + desc_pattern) % 2 == 1 for i in range(len(spec))]
    if desc_pattern == 2:
        descs = [True] * len(spec)
    jk, jl, tk, tl = _both(keys, live)
    jp, jn = JF.sort_perm(jk, descs, jl)
    tp, tn = TF.sort_perm(tk, descs, tl)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("spec", SPECS[:3], ids=lambda s: "-".join(s))
@pytest.mark.parametrize("k", [1, 10, 3000])
def test_topn_matches_jax(spec, k):
    keys, live = _keys(spec, k)
    descs = [True] + [False] * (len(spec) - 1)
    jk, jl, tk, tl = _both(keys, live)
    ji, jn = JF.topn(jk, descs, jl, min(k, N))
    ti, tn = TF.topn(tk, descs, tl, min(k, N))
    assert int(tn) == int(jn)
    n = int(jn)
    np.testing.assert_array_equal(ti.numpy()[:n], np.asarray(ji)[:n])


def test_all_dead_rows():
    keys, _ = _keys(["i64"], 1)
    live = np.zeros(N, dtype=bool)
    jk, jl, tk, tl = _both(keys, live)
    _jg, jn, jr = JF.factorize(jk, jl, 16)
    _tg, tn, tr = TF.factorize(tk, tl, 16)
    assert int(tn) == int(jn) == 0
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# Key types and sizes the sort kernels must keep: float64 ±0.0 / ±inf,
# full-range int32 and int64, bool, dict codes, all-NULL keys, n = 1, and n
# over several K8 tiles (4,096 keys each)
# ---------------------------------------------------------------------------


def _special(kind, n, rng):
    if kind == "f64":
        v = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -2.25,
                                 1e300, -1e-300]), n)
    elif kind == "i32":
        v = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        v[: n // 3] = rng.integers(-3, 3, n // 3)
    elif kind == "i64":
        v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
        v[: n // 3] = rng.integers(-3, 3, n // 3)
        v[: min(n, 2)] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max][
            : min(n, 2)]
    elif kind == "bool":
        v = rng.random(n) > 0.5
    else:                                       # "code": dict codes
        v = rng.integers(0, 7, n).astype(np.int32)
    return v


def _special_keys(spec, n, seed, null_p=0.15, all_null=False):
    rng = np.random.default_rng(seed)
    keys = []
    for kind in spec:
        v = _special(kind, n, rng)
        m = np.zeros(n, dtype=bool) if all_null else rng.random(n) > null_p
        keys.append((v, m))
    live = rng.random(n) > 0.2
    if n == 1:
        live[:] = True
    return keys, live


SPECIAL = [["f64"], ["i32"], ["i64"], ["bool"], ["code"],
           ["bool", "f64"], ["code", "i64", "f64"]]


@pytest.mark.parametrize("spec", SPECIAL, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("n", [1, 9000])
def test_factorize_special_keys_match_jax(spec, n):
    keys, live = _special_keys(spec, n, n + len(spec))
    jk, jl, tk, tl = _both(keys, live)
    for cap in (4, 16384):
        jg, jn, jr = JF.factorize(jk, jl, cap)
        tg, tn, tr = TF.factorize(tk, tl, cap)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("spec", SPECIAL, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("n", [1, 9000])
def test_sort_perm_special_keys_match_jax(spec, n):
    keys, live = _special_keys(spec, n, 3 * n + len(spec))
    jk, jl, tk, tl = _both(keys, live)
    for descs in ([False] * len(spec), [True] * len(spec),
                  [i % 2 == 0 for i in range(len(spec))]):
        jp, jn = JF.sort_perm(jk, descs, jl)
        tp, tn = TF.sort_perm(tk, descs, tl)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("spec", [["f64"], ["code", "i32"],
                                  ["bool", "i64", "f64"]],
                         ids=lambda s: "-".join(s))
def test_pack_codes_matches_jax(spec):
    """The packed code values themselves, on every row (dead rows too)."""
    keys, live = _special_keys(spec, 5000, 77 + len(spec))
    jk, jl, tk, tl = _both(keys, live)
    np.testing.assert_array_equal(TF.pack_codes(tk, tl).numpy(),
                                  np.asarray(JF.pack_codes(jk, jl)))


@pytest.mark.parametrize("spec", [["i64"], ["f64", "code"]],
                         ids=lambda s: "-".join(s))
def test_all_null_keys_match_jax(spec):
    keys, live = _special_keys(spec, 3000, 5, all_null=True)
    jk, jl, tk, tl = _both(keys, live)
    jg, jn, jr = JF.factorize(jk, jl, 8)
    tg, tn, tr = TF.factorize(tk, tl, 8)
    assert int(tn) == int(jn) == 1
    np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jp, _ = JF.sort_perm(jk, [True] * len(spec), jl)
    tp, _ = TF.sort_perm(tk, [True] * len(spec), tl)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_partition_perm_is_a_stable_argsort_of_the_flag():
    rng = np.random.default_rng(4)
    keep = rng.random(9000) > 0.7
    want = np.argsort(~keep, kind="stable")
    got = TF.partition_perm(torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_path_packing_equals_plain_lexsort(seed):
    """The kernel path's word packing (widths from bounds or min/max,
    narrow operands sharing a word, wide ones alone, constant operands
    dropped), run here over K8's and K9's plain versions (the wrappers
    take them for CPU tensors), gives the plain permutation."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([1, 7, 5000]))
    ops = [TF.SortOp(torch.from_numpy(rng.random(n) > 0.3), desc=True)]
    for _ in range(int(rng.integers(1, 4))):
        kind = rng.choice(["f64", "i32", "i64", "bool", "code", "rank",
                           "const"])
        m = torch.from_numpy(rng.random(n) > 0.2) if rng.random() < 0.5 \
            else None
        desc = bool(rng.random() < 0.5)
        if kind == "rank":
            hi = int(rng.integers(1, 3 * n + 2))
            v = torch.from_numpy(rng.integers(0, hi, n).astype(np.int64))
            ops.append(TF.SortOp(v, m, desc, hi))
            continue
        if kind == "const":
            v = torch.full((n,), 42, dtype=torch.int64)
        else:
            v = torch.from_numpy(np.asarray(_special(kind, n, rng)))
        ops.append(TF.SortOp(v, m, desc))
    got, _words = TF._lexsort_kernel(ops)
    np.testing.assert_array_equal(got.numpy(), TF.lexsort_plain(ops).numpy())


def test_nan_desc_order_follows_the_reference():
    """The JAX package orders NaN last under a one-key DESC (its `-v`
    operand) but first, in reverse row order, under a multi-key DESC (the
    flipped dense rank n - g, where each NaN is its own rank). The port
    keeps both orders (ROADMAP queue 3 records it)."""
    v = np.array([1.0, np.nan, 2.0, np.nan, 0.5])
    a = np.zeros(5, dtype=np.int64)
    m = np.ones(5, dtype=bool)
    for keys, descs, want in (([v], [True], [2, 0, 4, 1, 3]),
                              ([a, v], [False, True], [3, 1, 2, 0, 4])):
        jk, jl, tk, tl = _both([(k, m) for k in keys], m)
        jp, _ = JF.sort_perm(jk, descs, jl)
        tp, _ = TF.sort_perm(tk, descs, tl)
        np.testing.assert_array_equal(np.asarray(jp), want)
        np.testing.assert_array_equal(tp.numpy(), want)


# ---------------------------------------------------------------------------
# The kernel route of factorize / _dense1 (K9 + K8, then K10's word entry
# over K8's sorted word, or its gather entry for a sort of two or more
# words), run here over the kernels' plain versions, against the JAX
# package
# ---------------------------------------------------------------------------


def _word_case(case, rng, n=3000):
    """→ (key values, NULL mask or None, live, radix words the sort of
    `_key_operands` takes)."""
    live = rng.random(n) > 0.2
    m = rng.random(n) > 0.15
    if case == "nan":          # several NaNs (each its own group), +inf
        # (no NULLs: a NULL slot reads as 0.0, whose code is 2^63 below
        # NaN's, and with the NULL flag the sort takes two words)
        v = rng.choice(np.array([2.0, 3.5, 4.0, 1e300, np.inf, np.nan]), n)
        return v, None, live, 1
    if case == "nan_two_words":    # NaN beside ±0.0 and -inf: 65+ bits
        v = rng.choice(np.array([0.0, -0.0, -np.inf, np.inf, 1.5, np.nan]),
                       n)
        return v, m, live, 2
    if case == "signed_zero":  # -0.0 and +0.0 share a group; no NULLs
        v = rng.choice(np.array([-0.0, 0.0, 0.5, 3.0, 7.25]), n)
        return v, None, live, 1
    if case == "neg_inf":
        v = rng.choice(np.array([-np.inf, -1e300, -2.0, -3.5]), n)
        return v, None, live, 1
    if case == "all_nan":      # the value field takes no bits
        return np.full(n, np.nan), None, live, 1
    if case == "nulls":
        v = rng.integers(-40, 40, n).astype(np.int64)
        return v, m, live, 1
    if case == "dead_equal":
        # the last live key (9) is also the first dead row's key: _dense1
        # gives both one code, as the JAX function does
        v = rng.integers(0, 9, n).astype(np.int64)
        v[:5] = 9
        live[:5] = [True, False, True, False, False]
        v[5:20] = 12
        live[5:20] = False
        return v, None, live, 1
    if case == "all_dead":
        v = rng.integers(0, 30, n).astype(np.int32)
        return v, m, np.zeros(n, dtype=bool), 1
    if case == "i32_codes":
        return rng.integers(0, 7, n).astype(np.int32), None, live, 1
    # "two_words": a full-range int64 key with NULLs (64 + 2 bits)
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    v[:n // 3] = rng.integers(-3, 3, n // 3)
    return v, m, live, 2


_GATHER_PLAIN = TF.group_ids_plain
WORD_CASES = ["nan", "nan_two_words", "signed_zero", "neg_inf", "all_nan",
              "nulls", "dead_equal", "all_dead", "i32_codes", "two_words"]


@pytest.fixture
def kernel_route(monkeypatch):
    """Route _dense1 / factorize through `_sort_groups_kernel` on CPU
    tensors and count which K10 entry each call took."""
    taken = {"words": 0, "gather": 0}
    words_plain, gather_plain = TF.group_ids_words_plain, TF.group_ids_plain

    def words(*a):
        taken["words"] += 1
        return words_plain(*a)

    def gather(*a):
        taken["gather"] += 1
        return gather_plain(*a)

    monkeypatch.setattr(TF, "_sort_groups", TF._sort_groups_kernel)
    monkeypatch.setattr(TF, "group_ids_words_plain", words)
    monkeypatch.setattr(TF, "group_ids_plain", gather)
    return taken


@pytest.mark.parametrize("case", WORD_CASES)
def test_word_route_matches_jax(case, kernel_route):
    rng = np.random.default_rng(WORD_CASES.index(case) + 101)
    v, m, live, n_words = _word_case(case, rng)
    tv, tl = torch.from_numpy(v), torch.from_numpy(live)
    tm = None if m is None else torch.from_numpy(m)
    jm = None if m is None else jnp.asarray(m)
    ops = TF._key_operands([(tv, tm)], tl)
    sidx, words = TF._lexsort_kernel(ops)
    assert words.count == n_words
    np.testing.assert_array_equal(sidx.numpy(),
                                  TF.lexsort_plain(ops).numpy())
    entry = "words" if n_words == 1 else "gather"
    # _dense1: every row's code, dead rows included
    want = np.asarray(JF._dense1(jnp.asarray(v), jm, jnp.asarray(live)))
    got = TF._dense1(tv, tm, tl)
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernel_route[entry] == 1 and sum(kernel_route.values()) == 1
    # factorize: cap below and above the group count
    for cap in (3, 4096):
        jg, jn, jr = JF.factorize([(jnp.asarray(v), jm)], jnp.asarray(live),
                                  cap)
        tg, tn, tr = TF.factorize([(tv, tm)], tl, cap)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        # the chosen entry equals the gather entry's plain version on the
        # same sort, dead rows too
        for a, b in zip(TF.group_ids(sidx, tv, tm, tl, cap, words),
                        _GATHER_PLAIN(sidx, tv, tm, tl, cap)):
            assert torch.equal(a, b)
    assert kernel_route[entry] == 5
    if case == "nan":
        n_nan = int(np.sum(np.isnan(v) & live))
        assert n_nan > 1 and int(tn) >= n_nan


@pytest.mark.parametrize("spec", [["f64"], ["code", "i64"],
                                  ["i64", "f64", "bool"]],
                         ids=lambda s: "-".join(s))
def test_word_route_multi_key_matches_jax(spec, kernel_route):
    """1-3 key columns through pack_codes: each key's _dense1 and the
    packed code's factorize over the kernel route."""
    keys, live = _special_keys(spec, 4000, 17 + len(spec))
    jk, jl, tk, tl = _both(keys, live)
    np.testing.assert_array_equal(TF.pack_codes(tk, tl).numpy(),
                                  np.asarray(JF.pack_codes(jk, jl)))
    for cap in (5, 8192):
        jg, jn, jr = JF.factorize(jk, jl, cap)
        tg, tn, tr = TF.factorize(tk, tl, cap)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # the packed code (bound (n+1)^2) always fits one word; a lone float
    # key with NULLs takes two
    if len(spec) > 1:
        assert kernel_route["words"] >= 2
    else:
        assert kernel_route["gather"] >= 2


def test_word_key_layout():
    """_word_key over known layouts: the dead flag on top, the NULL flag
    and the value below it; the NaN code at the value field's top."""
    live = torch.tensor([True, True, False, True])
    m = torch.tensor([True, True, True, False])
    v = torch.tensor([5, 7, 6, 5])
    _perm, words = TF._lexsort_kernel(TF._key_operands([(v, m)], live))
    dead, flag, val = words.fields
    assert words.count == 1 and dead.width == 1 and flag.width == 1
    assert val.shift == 0 and flag.shift == val.width and \
        dead.shift == val.width + 1 and not val.nan
    cmp_mask, nan, dead_shift = TF._word_key(words)
    assert cmp_mask == (1 << (val.width + 1)) - 1 and nan is None
    assert dead_shift == dead.shift
    f = torch.tensor([2.0, float("nan"), 3.0, 2.0])
    _perm, words = TF._lexsort_kernel(TF._key_operands([(f, None)], live))
    dead, val = words.fields
    assert words.count == 1 and val.nan and dead.shift == val.width
    cmp_mask, nan, dead_shift = TF._word_key(words)
    top = (1 << val.width) - 1
    assert cmp_mask == top and nan == (top, ((1 << 64) - 1 - val.base))


def test_raw_operand_stats_share_one_read_back(monkeypatch):
    """Every raw operand's K9 min/max goes into one (k, 2) tensor, read
    back once per sort; bounded operands launch no stats."""
    rows = []
    encode = TF.sort_encode

    def spy(*a, stats=None, **kw):
        if stats is not None:
            rows.append(stats)
        return encode(*a, stats=stats, **kw)

    monkeypatch.setattr(TF, "sort_encode", spy)
    rng = np.random.default_rng(3)
    n = 500
    ops = [TF.SortOp(torch.from_numpy(rng.random(n) > 0.2), desc=True),
           TF.SortOp(torch.from_numpy(rng.normal(size=n))),
           TF.SortOp(torch.from_numpy(rng.integers(0, 9, n)), hi=9),
           TF.SortOp(torch.from_numpy(rng.integers(-5, 5, n)), desc=True)]
    perm, _ = TF._lexsort_kernel(ops)
    assert len(rows) == 2
    assert all(r.shape == (2,) for r in rows)
    assert rows[0].untyped_storage().data_ptr() == \
        rows[1].untyped_storage().data_ptr()
    np.testing.assert_array_equal(perm.numpy(),
                                  TF.lexsort_plain(ops).numpy())

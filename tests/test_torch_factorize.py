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
    got = TF._lexsort_kernel(ops)
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

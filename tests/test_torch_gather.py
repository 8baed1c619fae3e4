"""The host halves of K18 gather_columns and K11 sorted_search on the CPU.

K18 (tidb_tpu_torch/ops/gather.py): the argument block a call signature
packs (`gather_plan`, pure and cached), where every output lies in the
one allocation of a call (`out_layout`, `_views`: 16-byte aligned views
of the right dtype and length), and the checks, which run once per
signature (`_checked_plan`; CUDA devices named without a card).

K11 (tidb_tpu_torch/ops/join.py): the directory's parameters as a pure
function (`directory_params`: k and the shift at spans 0 to 2^64 - 2),
and a numpy model of the card's search (csrc/sorted_groups.cu: the
per-bucket lower bounds of `dir_build`, the branchless lockstep bounds
of `dir_probe` inside the probe's bucket, the rows resolved without a
search) held exactly to the JAX package's sorted_probe_unique /
sorted_probe_multi and to np.searchsorted on edge tables: negative and
full-range codes, sentinels only, nb = 1, probes equal to INT64_MAX,
runs of equal codes across bucket edges, a skewed table. The kernels
themselves are held to their plain versions on the card
(tests/test_torch_cuda.py)."""

import ctypes

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import gather as TG
from tidb_tpu_torch.ops import join as TJ

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


@pytest.fixture(scope="module")
def jx():
    from tidb_tpu.ops import join as JJ
    from tidb_tpu.ops.jax_env import jnp
    return JJ, jnp


# ---------------------------------------------------------------------------
# K18: plan, layout, checks
# ---------------------------------------------------------------------------

_WIDTHS = [(4,), (1, 2, 4, 8), (8, 4, 4), tuple([1, 2, 4, 8] * 16),
           tuple([8, 1] * 33)]


@pytest.mark.parametrize("widths", _WIDTHS)
@pytest.mark.parametrize("idx64", [False, True])
def test_k18_plan_is_pure_and_cached(widths, idx64):
    """One argument block per launch of at most 64 columns, holding the
    column count, each width, the index width and n_src; every pointer
    and m zero; equal signatures share one plan."""
    plan = TG.gather_plan(widths, idx64, 12_345)
    assert plan is TG.gather_plan(widths, idx64, 12_345)
    assert len(plan) == -(-len(widths) // TG.MAX_COLS)
    assert ctypes.sizeof(TG._GatherArgs) == len(plan[0]) == 2344
    for q, block in enumerate(plan):
        a = TG._GatherArgs.from_buffer_copy(block)
        part = widths[q * TG.MAX_COLS:(q + 1) * TG.MAX_COLS]
        assert a.ncols == len(part) and a.idx64 == int(idx64)
        assert a.n_src == 12_345 and a.m == 0
        assert list(a.bytes) == list(part) + [0] * (TG.MAX_COLS - len(part))
        assert not any(a.src) and not any(a.msrc) and not any(a.dst) and \
            not any(a.mdst) and a.idx is None and a.n_valid is None
        a.src[0] = 99
        a.m = 7
        assert TG._GatherArgs.from_buffer_copy(block).m == 0


@pytest.mark.parametrize("widths", _WIDTHS)
@pytest.mark.parametrize("m", [0, 1, 3, 4, 5, 1000, 4099])
def test_k18_output_views_are_aligned_slices_of_one_buffer(widths, m):
    dtypes = {1: [torch.bool, torch.uint8], 2: [torch.int16],
              4: [torch.int32, torch.float32],
              8: [torch.int64, torch.float64]}
    dts = tuple(dtypes[w][c % len(dtypes[w])] for c, w in enumerate(widths))
    vals, masks, total = TG.out_layout(widths, m)
    assert TG.out_layout(widths, m) == (vals, masks, total)
    ends = []
    for off, w in zip(vals + masks, widths + (1,) * len(widths)):
        assert off % TG.ALIGN == 0
        ends.append((off, off + m * w))
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert total % TG.ALIGN == 0 and total >= (ends[-1][1] if ends else 0)
    buf = torch.empty(total, dtype=torch.bool)
    out = TG._views(buf, widths, dts, m)
    assert len(out) == len(widths)
    if m == 0:
        assert all(v.numel() == 0 and mk.numel() == 0 for v, mk in out)
        return
    base = out[0][0].data_ptr() - vals[0]
    storage = out[0][0].untyped_storage().data_ptr()
    for (v, mk), dt, voff, moff in zip(out, dts, vals, masks):
        assert v.dtype == dt and v.shape == (m,) and v.is_contiguous()
        assert mk.dtype == torch.bool and mk.shape == (m,) and \
            mk.is_contiguous()
        assert v.data_ptr() - base == voff and mk.data_ptr() - base == moff
        assert v.untyped_storage().data_ptr() == storage
        assert mk.untyped_storage().data_ptr() == storage
    # writing one view leaves every other untouched
    for v, mk in out:
        v.zero_()
        mk.fill_(False)
    out[-1][0].fill_(1)
    out[0][1].fill_(True)
    assert all(int(v.to(torch.int64).sum()) == 0 for v, _ in out[:-1])
    assert all(not bool(mk.any()) for _, mk in out[1:])


def _sig(cols, idx_dtype=torch.int32, dev=torch.device("cuda", 0)):
    """A call signature as `_signature` builds it, on a named device (no
    card needed: `_checked_plan` reads the key only)."""
    return (tuple((dt, torch.Size([n]), dev, True,
                   None if not masked else
                   (torch.bool, torch.Size([n]), dev, True))
                  for dt, n, masked in cols),
            idx_dtype, 1, dev, True, torch.int32, 1, dev)


def test_k18_checks_run_once_per_signature_and_raise_as_before():
    from tidb_tpu_torch.ops.cuda_kernels import KernelError
    TG._checked_plan.cache_clear()
    cols = [(torch.int32, 100, True), (torch.int64, 100, False),
            (torch.bool, 100, True)]
    first = TG._checked_plan(_sig(cols))
    assert TG._checked_plan(_sig(cols)) is first
    assert TG._checked_plan.cache_info().hits == 1
    blocks, widths, dtypes = first
    assert widths == (4, 8, 1) and dtypes == (torch.int32, torch.int64,
                                              torch.bool)
    assert blocks is TG.gather_plan((4, 8, 1), False, 100)
    assert TG._checked_plan(_sig(cols, torch.int64))[0] is \
        TG.gather_plan((4, 8, 1), True, 100)
    bad = [
        (_sig(cols, dev=torch.device("cpu")), "CUDA"),
        (_sig(cols, torch.int16), "int32/int64"),
        (_sig([(torch.int32, 100, True), (torch.int32, 99, False)]),
         "one length"),
        (_sig([(torch.complex128, 100, False)]), "1/2/4/8-byte"),
    ]
    sig = list(_sig(cols))
    sig[0] = sig[0][:1] + ((torch.int64, torch.Size([100]),
                            torch.device("cuda", 1), True, None),)
    bad.append((tuple(sig), "a column on cuda:1"))
    sig = list(_sig(cols))
    sig[0] = ((torch.int32, torch.Size([100]), torch.device("cuda", 0),
               False, None),)
    bad.append((tuple(sig), "contiguous"))
    sig = list(_sig(cols))
    sig[0] = ((torch.int32, torch.Size([100]), torch.device("cuda", 0),
               True, (torch.uint8, torch.Size([100]),
                      torch.device("cuda", 0), True)),)
    bad.append((tuple(sig), "masks must be bool"))
    sig = list(_sig(cols))
    sig[5] = torch.int64
    bad.append((tuple(sig), "n_valid"))
    for s, what in bad:
        with pytest.raises(KernelError, match=what):
            TG._checked_plan(s)


# ---------------------------------------------------------------------------
# K11: the directory's parameters and a model of its search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 4, 5, 1000, 2_097_152, 1 << 26])
def test_k11_directory_params_at_the_span_edges(nb):
    k = TJ.directory_log2(nb)
    assert k == min(max(0, int(np.ceil(np.log2(max(1, -(-nb // 2)))))),
                    TJ.DIR_MAX_LOG2)
    assert (1 << k) >= min(-(-nb // 2), 1 << TJ.DIR_MAX_LOG2)
    for span in (0, 1, (1 << k) - 1, 1 << k, 1 << 63, (1 << 64) - 2):
        kk, shift = TJ.directory_params(nb, span)
        assert kk == k
        assert shift == max(0, span.bit_length() - k)
        # the least shift that leaves span >> shift below 2^k
        assert (span >> shift) < (1 << k)
        assert shift == 0 or (span >> (shift - 1)) >= (1 << k)
    assert TJ.directory_params(nb, (1 << k) - 1)[1] == 0
    assert TJ.directory_params(nb, 1 << k)[1] == 1
    assert TJ.directory_params(nb, (1 << 64) - 2)[1] == 64 - k
    with pytest.raises(ValueError):
        TJ.directory_params(nb, (1 << 64) - 1)
    if k == 0:
        # one bucket over a span of 2^63 or more: a shift of 64
        assert TJ.directory_params(nb, 1 << 63)[1] == 64
    assert TJ.directory_log2(2_097_152) == 20


def _bucket(x, lo, hi, shift, last):
    """csrc/sorted_groups.cu `bucket_of`: 0 at or below lo, the last at or
    above hi, else (x - lo) >> shift in 64-bit unsigned arithmetic."""
    d = x.astype(np.uint64) - np.uint64(lo & ((1 << 64) - 1))
    mid = np.zeros(len(x), dtype=np.int64) if shift >= 64 else \
        (d >> np.uint64(shift)).astype(np.int64)
    return np.where(x <= lo, 0, np.where(x >= hi, last, mid))


def _lockstep(a, x, s, n, upper):
    """csrc/sorted_groups.cu `bounds`: the lower (upper) bound of x in
    a[s, s + n) by branchless halving, every row in lockstep."""
    base, n = s.copy(), n.copy()
    while (n > 1).any():
        more = n > 1
        half = n >> 1
        v = a[np.where(more, base + half, 0)]
        go = (v <= x) if upper else (v < x)
        base = np.where(more & go, base + half, base)
        n = np.where(more, n - half, n)
    v = a[np.clip(base, 0, max(len(a) - 1, 0))] if len(a) else base
    go = (v <= x) if upper else (v < x)
    return np.where(n == 0, s, base + go.astype(np.int64))


def _gallop(a, frm, t):
    """csrc/sorted_groups.cu `gallop`: the lower bound of t in a[frm:],
    given a[frm - 1] < t, by doubling steps then halving."""
    lo, hi, step = frm, len(a), 1
    while lo + step - 1 < len(a):
        i = lo + step - 1
        if a[i] >= t:
            hi = i
            break
        lo = i + 1
        step <<= 1
    while lo < hi:
        mid = lo + (hi - lo) // 2
        lo, hi = (mid + 1, hi) if a[mid] < t else (lo, mid)
    return lo


def _directory(a):
    """csrc/sorted_groups.cu `dir_build` → (the pairs dir[b] = (T[b],
    T[b + 1]), the search parameters)."""
    nb = len(a)
    n_real = int((a != I64_MAX).sum())
    t = TJ.directory_trim(n_real)
    lo = int(a[t]) if n_real else 0
    hi = int(a[n_real - 1 - t]) if n_real else 0
    k, shift = TJ.directory_params(nb, hi - lo)
    last = 0 if shift >= 64 else (hi - lo) >> shift
    real = a[:n_real]
    T = np.zeros((1 << k) + 1, dtype=np.int64)
    for b0 in range(0, 1 << k, 4):          # one thread: four pairs
        prev = None
        for b in range(b0, b0 + 5):
            if b > (1 << k):
                break
            if b == 0:
                v = 0
            elif b > last:
                v = n_real
            else:
                tg = np.int64(lo + (b << shift))
                v = int(_lockstep(real, np.array([tg]), np.array([0]),
                                  np.array([n_real]), False)[0]) \
                    if prev is None else _gallop(real, prev, tg)
                prev = v
            T[b] = v
    pairs = np.stack([T[:-1], T[1:]], axis=1)
    return pairs, dict(n_real=n_real, lo=lo, hi=hi, shift=shift, last=last,
                       amin=int(a[0]) if n_real else 0,
                       amax=int(a[n_real - 1]) if n_real else 0)


def _model_bounds(a, x):
    """csrc/sorted_groups.cu `dir_probe` → (lower, upper) of every x: the
    rows answered at once, the buckets of at most 6 codes read whole,
    the larger ones searched by halving."""
    nb = len(a)
    pairs, p = _directory(a)
    n_real = p["n_real"]
    lower = np.zeros(len(x), dtype=np.int64)
    upper = np.zeros(len(x), dtype=np.int64)
    is_max = x == I64_MAX
    lower[is_max], upper[is_max] = n_real, nb
    srch = ~is_max & (n_real > 0) & (x >= p["amin"]) & (x <= p["amax"])
    above = ~is_max & (n_real > 0) & (x > p["amax"])
    lower[above] = upper[above] = n_real
    b = np.where(srch, _bucket(x, p["lo"], p["hi"], p["shift"], p["last"]),
                 0)
    s = np.where(srch, pairs[b, 0], 0)
    e = np.where(srch, pairs[b, 1], 0)
    small = srch & (e - s <= 6)
    for i in np.nonzero(small)[0]:
        part = a[s[i]:e[i]]
        lower[i] = s[i] + int((part < x[i]).sum())
        upper[i] = s[i] + int((part <= x[i]).sum())
    big = srch & ~small
    lb = _lockstep(a, x, s, e - s, False)
    ub = _lockstep(a, x, lb, e - lb, True)
    lower = np.where(big, lb, lower)
    upper = np.where(big, ub, upper)
    return lower, upper


def _tables(rng):
    """(name, sorted build codes with the INT64_MAX tail, probes)."""
    out = []
    full = np.sort(np.concatenate([
        rng.integers(I64_MIN, I64_MAX, 3000, dtype=np.int64),
        [I64_MIN, I64_MAX - 1]]))
    out.append(("full-range", full))
    out.append(("negative", np.sort(rng.integers(-(1 << 40), -5, 2000))))
    out.append(("sentinels only", np.full(37, I64_MAX, dtype=np.int64)))
    out.append(("nb=1", np.array([12345], dtype=np.int64)))
    out.append(("nb=1 sentinel", np.array([I64_MAX], dtype=np.int64)))
    # runs of equal codes that straddle bucket edges (width 4 at k = 9)
    runs = np.repeat(np.arange(0, 2048, 3, dtype=np.int64), 5)[:2048]
    out.append(("runs", np.sort(runs)))
    # the skewed table: 2^21 - 1 codes in [0, 2^21) and one at 2^62, cut
    # to 2^13 - 1 codes here
    skew = np.concatenate([np.arange((1 << 13) - 1, dtype=np.int64),
                           [1 << 62]])
    out.append(("skewed", skew))
    with_tail = np.concatenate([np.sort(rng.integers(0, 1 << 20, 900)),
                                np.full(100, I64_MAX)])
    out.append(("sentinel tail", with_tail))
    return out


def _probes(rng, a, n=1500):
    base = a[rng.integers(0, len(a), n)]
    pick = rng.random(n)
    return np.where(pick < 0.5, base, np.where(
        pick < 0.7, base + rng.integers(-1, 2, n), np.where(
            pick < 0.8, I64_MAX, np.where(
                pick < 0.9, I64_MIN, rng.integers(I64_MIN, I64_MAX, n,
                                                  dtype=np.int64))))
                    ).astype(np.int64)


@pytest.mark.parametrize("case", range(8))
def test_k11_model_matches_numpy_searchsorted(case):
    rng = np.random.default_rng(100 + case)
    name, a = _tables(rng)[case]
    with np.errstate(over="ignore"):
        x = _probes(rng, a)
    lower, upper = _model_bounds(a, x)
    assert np.array_equal(lower, np.searchsorted(a, x, "left")), name
    assert np.array_equal(upper, np.searchsorted(a, x, "right")), name
    pairs, p = _directory(a)
    assert pairs[0, 0] == 0 and (pairs[:, 1] >= pairs[:, 0]).all()
    assert (pairs[1:, 0] == pairs[:-1, 1]).all()
    assert pairs[-1, 1] == p["n_real"]


@pytest.mark.parametrize("case", range(8))
def test_k11_model_matches_jax_sorted_probes(jx, case):
    JJ, jnp = jx
    rng = np.random.default_rng(200 + case)
    name, table = _tables(rng)[case]
    nb = len(table)
    # the build rows: the table's real codes in random order, its
    # sentinel tail as dead or NULL rows
    codes = rng.permutation(table)
    dead = codes == I64_MAX
    codes = np.where(dead, rng.integers(0, 1 << 30, nb), codes)
    valid = ~dead | (rng.random(nb) < 0.5)
    live = ~dead | ~valid
    ok_b = valid & live
    with np.errstate(over="ignore"):
        probe = _probes(rng, table)
    pv = rng.random(len(probe)) > 0.1
    pl = rng.random(len(probe)) > 0.1
    ok_p = pv & pl
    sort_key = np.where(ok_b, codes, I64_MAX)
    order = np.argsort(sort_key, kind="stable").astype(np.int32)
    a = sort_key[order]
    assert np.array_equal(a, table)
    lower, upper = _model_bounds(a, probe)
    # unique mode, as dir_probe writes it
    pos = np.minimum(lower, nb - 1)
    hit = ok_p & (a[pos] == probe)
    midx = np.where(hit, order[pos], 0)
    dup = (a[1:] == a[:-1]) & (a[1:] != I64_MAX)
    jidx, jm, ju = JJ.sorted_probe_unique(
        *(jnp.asarray(v) for v in (codes, valid, live, probe, pv, pl)))
    assert bool(ju) == (not dup.any()), name
    assert np.array_equal(np.asarray(jm), hit), name
    if bool(ju):
        assert np.array_equal(np.asarray(jidx), midx), name
    # multi mode
    js, jc, jo = JJ.sorted_probe_multi(
        *(jnp.asarray(v) for v in (codes, ok_b, probe, ok_p)))
    assert np.array_equal(np.asarray(js), lower.astype(np.int32)), name
    assert np.array_equal(np.asarray(jc),
                          np.where(ok_p, upper - lower, 0).astype(np.int32))
    assert np.array_equal(np.asarray(jo), order), name

"""The host halves of K18 gather_columns and K11 sorted_search on the CPU.

K18 (tidb_tpu_torch/ops/gather.py): the argument block a call packs
(`_pack`), where every output lies in the one allocation of a call
(`out_layout`, pure and cached; `_outputs`: 16-byte aligned views of the
right dtype and shape, or with `owned` tensors that own their storage),
the checks a call makes, and each mode of the plain versions (the keep
mask, the count cut, no cut, limb planes under one mask, values without
a mask, the inverse permutation and the way back to row order through
it, indices out of range) held exactly to the JAX package's expressions of the sites
that call it (`jnp.take`, `.at[perm].set`).

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

import struct

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
# K18: argument block, layout, checks, and each mode against the JAX
# package's expressions
# ---------------------------------------------------------------------------

_WIDTHS = [(4,), (1, 2, 4, 8), (8, 4, 4), tuple([1, 2, 4, 8] * 16),
           tuple([8, 1] * 33)]
_DTYPES = {1: [torch.bool, torch.uint8], 2: [torch.int16],
           4: [torch.int32, torch.float32], 8: [torch.int64, torch.float64]}


@pytest.fixture(scope="module")
def jnp():
    from tidb_tpu.ops.jax_env import jnp as _jnp
    return _jnp


@pytest.mark.parametrize("widths", _WIDTHS)
@pytest.mark.parametrize("idx64", [False, True])
def test_k18_plan_is_pure_and_cached(widths, idx64):
    """The argument block a call packs (csrc/gather_columns.cu `Header`
    and `Plane`s, 64-bit words): the index, n_valid and keep pointers (0
    when absent), m, n, the flags (bit 0 an int64 index), the plane count and the bytes a pass of the kernel may
    hold, then (src, msrc, dst, mdst, bytes) a plane; the output layout of
    a call's shape is a pure function, cached."""
    idx = torch.zeros(7, dtype=torch.int64 if idx64 else torch.int32)
    nv = torch.tensor(3, dtype=torch.int32)
    keep = torch.ones(7, dtype=torch.bool)
    planes = []
    for c, w in enumerate(widths):
        planes += (1000 + c, 0 if c % 2 else 2000 + c, 3000 + c,
                   0 if c % 3 == 2 else 4000 + c, w)
    k = len(widths)
    for n_valid, kp in ((None, None), (nv, None), (nv, keep)):
        block = TG._pack(idx, n_valid, kp, 7, 12_345, planes)
        assert len(block) == 8 * (TG.HEADER_WORDS + TG.PLANE_WORDS * k)
        words = struct.unpack(f"<{len(block) // 8}Q", block)
        assert words[:TG.HEADER_WORDS] == (
            idx.data_ptr(), 0 if n_valid is None else n_valid.data_ptr(),
            0 if kp is None else kp.data_ptr(), 7, 12_345,
            int(idx64), k, TG.PASS_BYTES)
        assert list(words[TG.HEADER_WORDS:]) == planes
    kinds = tuple((w, 1 + c % 2, c % 3 != 2) for c, w in enumerate(widths))
    lay = TG.out_layout(kinds, 12_345)
    assert TG.out_layout(kinds, 12_345) is lay
    assert sum(lay.sizes) == lay.total


@pytest.mark.parametrize("widths", _WIDTHS)
@pytest.mark.parametrize("m", [0, 1, 3, 4, 5, 1000, 4099])
def test_k18_output_views_are_aligned_slices_of_one_buffer(widths, m):
    """Every output of a call (values of 1 or 2 limb planes, masks where
    the column has one) is a view of one allocation at a 16-byte aligned
    offset, of its dtype and shape, the pointers the kernel is handed are
    the views' own, and writing one view leaves every other untouched."""
    dts = [_DTYPES[w][c % len(_DTYPES[w])] for c, w in enumerate(widths)]
    kinds = tuple((w, 2 if c % 4 == 3 else 1, c % 3 != 2)
                  for c, w in enumerate(widths))
    shapes = [(p, m) if p == 2 else (m,) for _w, p, _wm in kinds]
    lay = TG.out_layout(kinds, m)
    vals, masks, vptrs, mptrs = TG._outputs(kinds, dts, shapes, m,
                                            torch.device("cpu"), False)
    assert len(vals) == len(masks) == len(widths)
    for (w, p, wm), v, mk, vp, mp, voff, moff, dt, shp in zip(
            kinds, vals, masks, vptrs, mptrs, lay.voffs, lay.moffs, dts,
            shapes):
        assert voff % TG.ALIGN == 0 and v.dtype == dt
        assert tuple(v.shape) == shp and v.is_contiguous()
        assert (mk is None) == (not wm)
        if m:
            assert (mp == 0) == (not wm)
            assert v.data_ptr() == vp and \
                vp - vptrs[0] == voff - lay.voffs[0]
            if wm:
                assert moff % TG.ALIGN == 0 and mk.data_ptr() == mp
                assert mk.dtype == torch.bool and mk.shape == (m,)
    if not m:
        return
    storage = vals[0].untyped_storage().data_ptr()
    outs = vals + [mk for mk in masks if mk is not None]
    assert all(t.untyped_storage().data_ptr() == storage for t in outs)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes) for t in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for t in outs:
        t.zero_()
    vals[-1].fill_(1)
    assert all(int(v.to(torch.int64).sum()) == 0 for v in vals[:-1])
    assert all(not bool(mk.any()) for mk in masks if mk is not None)


def test_k18_owned_outputs_own_their_storage():
    """With `owned` (a cache keeps the results: device_cache.aligned_col,
    the delta merge) every output is its own allocation: its storage's
    bytes are its own, a wide decimal's planes one (limbs, m) tensor."""
    kinds = ((8, 3, True), (4, 1, True), (1, 1, False))
    dts = [torch.int64, torch.int32, torch.bool]
    shapes = [(3, 1001), (1001,), (1001,)]
    vals, masks, vptrs, mptrs = TG._outputs(kinds, dts, shapes, 1001,
                                            torch.device("cpu"), True)
    assert masks[2] is None and mptrs[2] == 0
    for t in vals + masks[:2]:
        assert t.untyped_storage().nbytes() == t.nbytes
    assert [v.data_ptr() for v in vals] == vptrs
    assert vals[0].shape == (3, 1001)


def test_k18_checks_run_once_per_signature_and_raise_as_before():
    """The checks a call makes (the build rule: one CUDA device, contiguous
    1-D columns or (limbs, rows) planes of one length and 1/2/4/8-byte
    elements, bool masks of that length, a 1-D int32/int64 index, one
    int32 n_valid, a bool keep of the index's length) raise KernelError
    with the messages they always had. They run on every call now (the
    per-signature cache went with the old host path); the index's dtype
    and shape, n_valid and keep are checked before its device, so each
    check is reached here with CPU tensors, which the wrappers themselves
    never send (they take the plain versions)."""
    from tidb_tpu_torch.ops.cuda_kernels import KernelError
    i32 = torch.zeros(10, dtype=torch.int32)
    nv = torch.tensor(3, dtype=torch.int32)
    keep = torch.ones(10, dtype=torch.bool)
    with pytest.raises(KernelError, match="CUDA"):
        TG._check_index(i32, nv, keep)
    for idx, n_valid, kp, what in [
            (torch.zeros(10, dtype=torch.int16), None, None, "int32/int64"),
            (torch.zeros((2, 5), dtype=torch.int32), None, None,
             "int32/int64"),
            (torch.zeros(20, dtype=torch.int64)[::2], None, None,
             "int32/int64"),
            (i32, torch.tensor(3, dtype=torch.int64), None, "n_valid"),
            (i32, torch.tensor([3, 4], dtype=torch.int32), None, "n_valid"),
            (i32, None, torch.ones(9, dtype=torch.bool), "keep"),
            (i32, None, torch.ones(10, dtype=torch.uint8), "keep"),
            (i32, None, torch.ones(20, dtype=torch.bool)[::2], "keep")]:
        with pytest.raises(KernelError, match=what):
            TG._check_index(idx, n_valid, kp)
    # the column checks against the device number -1 (the CPU's)
    assert TG._kind(torch.zeros(100, dtype=torch.int32), -1, None) == (4, 1)
    assert TG._kind(torch.zeros((3, 100)), -1, 100) == (4, 3)
    bad = [
        (lambda: TG._kind(torch.zeros(100, dtype=torch.int32), 0, None),
         "a column on cpu"),
        (lambda: TG._kind(torch.zeros(200)[::2], -1, None), "contiguous"),
        (lambda: TG._kind(torch.zeros(99), -1, 100), "one length"),
        (lambda: TG._kind(torch.zeros(100, dtype=torch.complex128), -1,
                          100), "1/2/4/8-byte"),
        (lambda: TG._kind(torch.zeros((2, 2, 100)), -1, 100),
         "limbs, rows"),
        (lambda: TG._check_mask(torch.zeros(100, dtype=torch.uint8), -1,
                                100), "masks must be"),
        (lambda: TG._check_mask(torch.zeros(99, dtype=torch.bool), -1,
                                100), "masks must be"),
    ]
    for call, what in bad:
        with pytest.raises(KernelError, match=what):
            call()


def _cols(rng, n, specs):
    """Seed-made numpy columns: (dtype, planes, masked) each → [(v, m)]."""
    out = []
    for dt, planes, masked in specs:
        shape = (planes, n) if planes > 1 else (n,)
        if dt == np.bool_:
            v = rng.random(shape) < 0.5
        elif np.issubdtype(dt, np.floating):
            v = rng.normal(size=shape).astype(dt)
        else:
            v = rng.integers(-1000, 1000, shape).astype(dt)
        out.append((v, (rng.random(n) < 0.7) if masked else None))
    return out


_SPECS = [(np.int64, 1, True), (np.int32, 1, False), (np.bool_, 1, True),
          (np.float64, 1, True), (np.int16, 1, True), (np.int64, 3, True)]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("idx_dt", [np.int32, np.int64])
@pytest.mark.parametrize("cut", ["keep", "n_valid", "both", "none"])
def test_k18_gather_modes_match_jax_expressions(jnp, idx_dt, cut):
    """The plain gather with a per-slot keep mask (the join finishes'
    `jnp.take(m, idx) & keep`), a count cut (`& (iota < n)`), both, or
    neither (LIMIT, TopN, Sort, finalize: uncut), over 1-D columns with
    and without masks and a wide decimal's three limb planes under one
    mask (`jnp.take(v, idx, axis=-1)`), exactly."""
    rng = np.random.default_rng(21)
    n, m = 3000, 2500
    cols = _cols(rng, n, _SPECS)
    idx = rng.integers(0, n, m).astype(idx_dt)
    keep = rng.random(m) < 0.6
    nv = 1700
    got = TG.gather_columns(
        [(_t(v), _t(mk)) for v, mk in cols], _t(idx),
        torch.tensor(nv, dtype=torch.int32) if cut in ("n_valid", "both")
        else None,
        _t(keep) if cut in ("keep", "both") else None)
    cutm = np.ones(m, dtype=bool)
    if cut in ("n_valid", "both"):
        cutm &= np.arange(m) < nv
    if cut in ("keep", "both"):
        cutm &= keep
    for (v, mk), (gv, gm) in zip(cols, got):
        wv = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(idx), axis=-1))
        wm = (np.asarray(jnp.take(jnp.asarray(mk), jnp.asarray(idx)))
              if mk is not None else np.ones(m, dtype=bool)) & cutm
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(gm.numpy(), wm)
        assert gv.dtype == torch.from_numpy(v).dtype and \
            gv.shape == wv.shape


def test_k18_values_carry_no_mask(jnp):
    """`values` (emit_finalize's aggregate states) come back as arrays
    alone, gathered like the columns of the same call."""
    rng = np.random.default_rng(22)
    keys = _cols(rng, 500, [(np.int64, 1, True)])
    states = [rng.integers(0, 99, 500), rng.normal(size=500),
              rng.random(500) < 0.5]
    idx = rng.permutation(500)[:123].astype(np.int64)
    (kv, km), = keys
    (gv, gm), = TG.gather([(_t(kv), _t(km))], _t(idx))[0]
    _cols_out, vals = TG.gather([(_t(kv), _t(km))], _t(idx),
                                values=[_t(a) for a in states])
    np.testing.assert_array_equal(gv.numpy(), kv[idx])
    np.testing.assert_array_equal(gm.numpy(), km[idx])
    assert len(vals) == len(states)
    for a, g in zip(states, vals):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jnp.take(jnp.asarray(a), idx)))


@pytest.mark.parametrize("idx_dt", [np.int32, np.int64])
@pytest.mark.parametrize("live_share", [0.0, 0.4, 0.8, 1.0])
def test_k18_way_back_matches_jax_at_set(jnp, idx_dt, live_share):
    """The window's way back to row order (`out.at[perm].set(v)` and
    `.at[perm].set(m & (iota < n_live))`, sort_perm listing the live rows
    first): one gather through the layout's inverse permutation with
    `live` as the keep mask, over 1-D columns with and without masks and
    a wide decimal's planes under one mask, exactly."""
    rng = np.random.default_rng(23)
    n = 3000
    cols = _cols(rng, n, _SPECS)
    live = rng.random(n) < live_share
    perm = np.concatenate([rng.permutation(np.flatnonzero(live)),
                           np.flatnonzero(~live)]).astype(idx_dt)
    n_live = int(live.sum())
    inv = TG.inverse_permutation(_t(perm), n)
    got = TG.gather_columns([(_t(v), _t(mk)) for v, mk in cols], inv,
                            keep=_t(live))
    cut = np.arange(n) < n_live
    for (v, mk), (gv, gm) in zip(cols, got):
        ones = np.ones(n, dtype=bool)
        wv = np.asarray(jnp.zeros(v.shape, v.dtype).at[..., perm].set(v))
        wm = np.asarray(jnp.zeros(n, bool).at[perm].set(
            (mk if mk is not None else ones) & cut))
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(gm.numpy(), wm)


@pytest.mark.parametrize("idx_dt", [np.int32, np.int64])
def test_k18_inverse_permutation_matches_jax(jnp, idx_dt):
    """The inverse permutation, `jnp.zeros(n).at[perm].set(iota)`, int32,
    exactly (n = 0, 1, and rows that are not a multiple of the kernel's
    four slots a thread)."""
    rng = np.random.default_rng(24)
    for n in (0, 1, 5, 2048, 2051):
        perm = rng.permutation(n).astype(idx_dt)
        inv = TG.inverse_permutation(_t(perm), n)
        assert inv.dtype == torch.int32 and inv.shape == (n,)
        np.testing.assert_array_equal(
            inv.numpy(), np.asarray(jnp.zeros(n, jnp.int32).at[perm].set(
                jnp.arange(n, dtype=jnp.int32))))


def test_k18_out_of_range_rule():
    """A gather index outside [0, rows) gives a zero value and a false
    mask, an index of the inverse's permutation outside [0, n) writes
    nothing, in the plain versions as on the card."""
    v = torch.arange(10, dtype=torch.int64) + 100
    mk = torch.ones(10, dtype=torch.bool)
    idx = torch.tensor([0, -1, 9, 10, 3], dtype=torch.int32)
    (gv, gm), = TG.gather_columns([(v, mk)], idx)
    assert gv.tolist() == [100, 0, 109, 0, 103]
    assert gm.tolist() == [True, False, True, False, True]
    inv = TG.inverse_permutation(torch.tensor([4, -2, 0, 77, 2]), 5)
    assert [inv[4].item(), inv[0].item(), inv[2].item()] == [0, 2, 4]

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

"""The port's join primitives (tidb_tpu_torch/ops/join.py), LUT and sort
formulations, against the JAX package's (tidb_tpu/ops/join.py) on the CPU;
the four LUT join kernels (K4 lut_build, K5 lut_probe, K6 lut_order, K7
join_expand) and the four sort kernels (K8 radix_sort, K9 sort_encode,
K10 group_ids, K11 sorted_search) against their plain torch versions on
the card.

The same seed-made numpy inputs go through both packages. Ints and bools
must be exactly equal, with two documented exceptions that the JAX
functions leave unspecified: a LUT slot of a duplicated build code holds
any one of its rows (compared only where the code's count is 1), and
`expand` is compared on live output slots plus its total.

Card cases carry the `cuda` marker and skip without a GPU:
    python -m pytest -m cuda tests/test_torch_join.py"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import join as TJ


@pytest.fixture(scope="module")
def jx():
    """The JAX package's join ops (imported here, not at module level, so
    the card cases also run where JAX is not installed)."""
    from tidb_tpu.ops import join as JJ
    from tidb_tpu.ops.jax_env import jnp
    return JJ, jnp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _keys(rng, n, bounds, null_p=0.1, spill=2):
    """k key columns drawn a little beyond their bounds, with NULLs."""
    out = []
    for lo, hi in bounds:
        v = rng.integers(lo - spill, hi + spill + 1, n).astype(np.int64)
        m = rng.random(n) > null_p
        out.append((v, m))
    return out


BOUNDS = {1: [(3, 40)], 2: [(0, 6), (-2, 4)], 3: [(0, 3), (10, 12), (5, 9)]}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pack_bounded_codes_matches_jax(jx, k):
    JJ, jnp = jx
    rng = np.random.default_rng(k)
    keys = _keys(rng, 200, BOUNDS[k])
    jc, jok = JJ.pack_bounded_codes(
        [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys], BOUNDS[k])
    tc, tok = TJ.pack_bounded_codes([(_t(v), _t(m)) for v, m in keys],
                                    BOUNDS[k])
    assert np.array_equal(np.asarray(jok), _np(tok))
    assert np.array_equal(np.asarray(jc), _np(tc))


def _codes_case(seed, nb, npr, dom, unique):
    rng = np.random.default_rng(seed)
    if unique:
        build = rng.permutation(dom)[:nb].astype(np.int64)
    else:
        build = rng.integers(0, dom, nb).astype(np.int64)
    ok_b = rng.random(nb) > 0.2
    probe = np.clip(rng.integers(-3, dom + 3, npr), 0, dom - 1) \
        .astype(np.int64)
    ok_p = rng.random(npr) > 0.2
    return build, ok_b, probe, ok_p


@pytest.mark.parametrize("nb,npr,dom,unique", [
    (37, 64, 50, True), (1, 9, 4, True), (200, 300, 64, False),
    (4, 4, 16, False)])
def test_lut_probe_unique_matches_jax(jx, nb, npr, dom, unique):
    JJ, jnp = jx
    build, ok_b, probe, ok_p = _codes_case(nb + dom, nb, npr, dom, unique)
    jidx, jm, ju = JJ.lut_probe_unique(jnp.asarray(build), jnp.asarray(ok_b),
                                       dom, jnp.asarray(probe),
                                       jnp.asarray(ok_p))
    tidx, tm, tu = TJ.lut_probe_unique(_t(build), _t(ok_b), dom, _t(probe),
                                       _t(ok_p))
    assert bool(ju) == bool(tu)
    assert np.array_equal(np.asarray(jm), _np(tm))
    cnt = np.bincount(build[ok_b], minlength=dom)
    single = _np(tm) & (cnt[probe] == 1)
    assert np.array_equal(np.asarray(jidx)[single], _np(tidx)[single])
    # a duplicated code's slot holds one of its rows
    dup = _np(tm) & (cnt[probe] > 1)
    assert (build[_np(tidx)[dup]] == probe[dup]).all()
    assert ((_np(tidx) >= 0) & (_np(tidx) < nb)).all()


@pytest.mark.parametrize("nb,npr,dom", [(41, 57, 20), (1, 5, 3),
                                        (300, 100, 7), (64, 64, 1000)])
def test_lut_probe_multi_matches_jax(jx, nb, npr, dom):
    JJ, jnp = jx
    build, ok_b, probe, ok_p = _codes_case(nb * 7 + dom, nb, npr, dom,
                                           unique=False)
    js, jc, jo = JJ.lut_probe_multi(jnp.asarray(build), jnp.asarray(ok_b),
                                    dom, jnp.asarray(probe),
                                    jnp.asarray(ok_p))
    ts, tc, to = TJ.lut_probe_multi(_t(build), _t(ok_b), dom, _t(probe),
                                    _t(ok_p))
    assert np.array_equal(np.asarray(js), _np(ts))
    assert np.array_equal(np.asarray(jc), _np(tc))
    # the stable build order, element for element (NULL rows last)
    assert np.array_equal(np.asarray(jo), _np(to))


def _expand_case(seed, P, nb, dom, outer_dead=3):
    build, ok_b, probe, ok_p = _codes_case(seed, nb, P, dom, unique=False)
    live = np.ones(P, dtype=bool)
    live[P - min(outer_dead, P):] = False
    # the port's plain lut_probe_multi (held equal to the JAX function by
    # test_lut_probe_multi_matches_jax)
    start, count, order = TJ.lut_probe_multi(_t(build), _t(ok_b), dom,
                                             _t(probe), _t(ok_p & live))
    return start.numpy(), count.numpy(), order.numpy(), live


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("P,nb,dom,out_cap", [
    (31, 23, 12, 256), (31, 23, 12, 8), (64, 200, 10, 4096),
    (16, 1, 1, 64)])
def test_expand_matches_jax(jx, outer, P, nb, dom, out_cap):
    JJ, jnp = jx
    start, count, order, live = _expand_case(P + nb, P, nb, dom)
    jout = JJ.expand(jnp.asarray(start), jnp.asarray(count),
                     jnp.asarray(order), out_cap, outer, jnp.asarray(live))
    tout = TJ.expand(_t(start), _t(count), _t(order), out_cap, outer,
                     _t(live))
    jp, jb, jm, jl, jk, jt = (np.asarray(x) for x in jout)
    tp, tb, tm, tl, tk, tt = (_np(x) for x in tout)
    assert int(jt) == int(tt)
    assert np.array_equal(jl, tl)
    for a, b in ((jp, tp), (jb, tb), (jm, tm), (jk, tk)):
        assert np.array_equal(a[jl], b[jl])
    assert ((tp >= 0) & (tp < P)).all() and ((tb >= 0) & (tb < nb)).all()


def test_expand_empty_probe():
    order = np.array([0], dtype=np.int32)
    z = np.zeros(0, dtype=np.int32)
    p, b, m, live, k, total = TJ.expand(_t(z), _t(z), _t(order), 8, True,
                                        _t(np.zeros(0, dtype=bool)))
    assert int(total) == 0 and not _np(live).any() and not _np(m).any()


def _raw_join_case(seed, k, nb, npr, unique):
    rng = np.random.default_rng(seed)
    bounds = BOUNDS[k]
    bkeys = _keys(rng, nb, bounds, null_p=0.05, spill=0)
    if unique:
        dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
        cells = rng.permutation(dom)[:nb]
        for q, (lo, hi) in enumerate(bounds):
            span = hi - lo + 1
            bkeys[q] = ((cells % span) + lo, np.ones(nb, dtype=bool))
            cells = cells // span
    pkeys = _keys(rng, npr, bounds)
    blive = rng.random(nb) > 0.1
    plive = rng.random(npr) > 0.1
    return bounds, bkeys, pkeys, blive, plive


def _jax_pack(JJ, jnp, keys, bounds):
    return JJ.pack_bounded_codes(
        [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys], bounds)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("unique", [True, False])
def test_lut_join_raw_keys_match_jax(jx, k, unique):
    JJ, jnp = jx
    """The tree programs' entry points over raw key columns equal the JAX
    tree trace: pack_bounded_codes on both sides, then the probe."""
    nb = 20 if k > 1 else 30
    bounds, bkeys, pkeys, blive, plive = _raw_join_case(10 * k + unique, k,
                                                        nb, 90, unique)
    dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    bc, bok = _jax_pack(JJ, jnp, bkeys, bounds)
    pc, pok = _jax_pack(JJ, jnp, pkeys, bounds)
    bok = bok & jnp.asarray(blive)
    pok = pok & jnp.asarray(plive)
    tb = [(_t(v), _t(m)) for v, m in bkeys]
    tp = [(_t(v), _t(m)) for v, m in pkeys]
    jidx, jm, ju = JJ.lut_probe_unique(bc, bok, dom, pc, pok)
    tidx, tm, tu = TJ.lut_join_unique(tb, tp, bounds, dom, _t(blive),
                                      _t(plive))
    assert bool(ju) == bool(tu) == unique
    assert np.array_equal(np.asarray(jm), _np(tm))
    if unique:
        assert np.array_equal(np.asarray(jidx), _np(tidx))
    js, jc, jo = JJ.lut_probe_multi(bc, bok, dom, pc, pok)
    ts, tc, to = TJ.lut_join_multi(tb, tp, bounds, dom, _t(blive),
                                   _t(plive))
    assert np.array_equal(np.asarray(js), _np(ts))
    assert np.array_equal(np.asarray(jc), _np(tc))
    assert np.array_equal(np.asarray(jo), _np(to))


def _probe_from_table(keys, bounds, table, live, nb, unique):
    """K5's arithmetic as the kernel runs it: one table read a row — K4's
    lut alone in unique mode, starts[code + 1] - starts[code] in multi."""
    codes, ok = TJ.pack_bounded_codes(keys, bounds)
    ok = ok & live
    dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    pc = codes.clamp(0, dom - 1)
    t = table[pc]
    if unique:
        matched = ok & (t >= 0)
        return torch.where(matched, t, torch.zeros_like(t)).clamp(0, nb - 1), \
            matched
    return t, torch.where(ok, table[pc + 1] - t, torch.zeros_like(t))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("n_live", [None, 0, 7, 19])
def test_k5_reads_one_table_entry_a_row(jx, k, unique, n_live):
    """K4's lut holds a row (>= 0) for exactly the codes cnt counts, over
    duplicate codes, NULL keys, dead rows, out-of-domain keys and an
    n_live prefix; so K5's unique probe from the lut alone equals
    lut_probe_plain and the JAX lut_probe_unique, and its multi probe
    from K6's starts alone equals lut_probe_plain."""
    JJ, jnp = jx
    nb = 20 if k > 1 else 30
    bounds, bkeys, pkeys, blive, plive = _raw_join_case(
        100 + 10 * k + unique, k, nb, 400, unique)
    rng = np.random.default_rng(k + 7 * unique)
    v0, m0 = bkeys[0]
    hi0 = bounds[0][1]
    bkeys[0] = (np.where(rng.random(nb) < 0.15, hi0 + 3, v0), m0)
    dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    tb = [(_t(v), _t(m)) for v, m in bkeys]
    tp = [(_t(v), _t(m)) for v, m in pkeys]
    cnt, lut, _, codes = TJ.lut_build_plain(tb, bounds, dom, live=_t(blive),
                                            n_live=n_live, want_codes=True)
    assert torch.equal(lut[:dom] >= 0, cnt[:dom] > 0)
    got = _probe_from_table(tp, bounds, lut, _t(plive), nb, True)
    want = TJ.lut_probe_plain(tp, bounds, cnt, lut, _t(plive), nb, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bc, bok = _jax_pack(JJ, jnp, bkeys, bounds)
    pc, pok = _jax_pack(JJ, jnp, pkeys, bounds)
    rows_live = blive & (np.arange(nb) < (nb if n_live is None else n_live))
    jidx, jm, _ = JJ.lut_probe_unique(bc, bok & jnp.asarray(rows_live), dom,
                                      pc, pok & jnp.asarray(plive))
    assert np.array_equal(np.asarray(jm), _np(got[1]))
    single = _np(got[1]) & (_np(cnt)[np.asarray(pc)] == 1)
    assert np.array_equal(np.asarray(jidx)[single], _np(got[0])[single])
    starts, _ = TJ.lut_order_plain(codes, cnt)
    assert starts.shape == (dom + 1,)
    got = _probe_from_table(tp, bounds, starts, _t(plive), nb, False)
    want = TJ.lut_probe_plain(tp, bounds, cnt, starts, _t(plive), nb, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_k5_probe_plan_is_pure_and_cached(k):
    """K5's argument block: a pure function of the key signature, cached,
    with the C struct's layout (12 pointers, 14 int64, 8 int32)."""
    import ctypes
    bounds = tuple((-q, 3 * q + 2) for q in range(k))
    is64 = tuple(q % 2 == 0 for q in range(k))
    plan = TJ.probe_plan(is64, bounds, 17, True)
    assert plan is TJ.probe_plan(is64, bounds, 17, True)
    assert ctypes.sizeof(TJ._ProbeArgs) == len(plan) == 240
    a = TJ._ProbeArgs.from_buffer_copy(plan)
    assert a.k == k and a.nb == 17 and a.unique_mode == 1 and a.n == 0
    assert list(a.is64) == [int(w) for w in is64] + [0] * (4 - k)
    assert list(a.lo) == [lo for lo, _ in bounds] + [0] * (4 - k)
    assert list(a.hi) == [hi for _, hi in bounds] + [0] * (4 - k)
    assert list(a.stride) == TJ._strides(bounds) + [0] * (4 - k)
    assert a.domain == int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    assert all(not p for p in list(a.vals) + list(a.masks)) and \
        a.live is None and a.table is None
    multi = TJ._ProbeArgs.from_buffer_copy(TJ.probe_plan(is64, bounds, 17,
                                                         False))
    assert multi.unique_mode == 0 and multi.domain == a.domain
    # a call's copy leaves the cached block untouched
    a.vals[0] = 1234
    a.n = 99
    assert TJ._ProbeArgs.from_buffer_copy(plan).n == 0


def test_k5_domain_checks_raise_as_before():
    from tidb_tpu_torch.ops.cuda_kernels import KernelError
    TJ._check_domain(70, [(0, 9), (-2, 4)], "lut_probe")
    with pytest.raises(KernelError, match="empty bounds"):
        TJ._check_domain(1, [(3, 2)], "lut_probe")
    with pytest.raises(KernelError, match="does not match"):
        TJ._check_domain(71, [(0, 9), (-2, 4)], "lut_probe")


# ---------------------------------------------------------------------------
# Sort formulation: combine_keys, sorted_probe_unique/multi
# ---------------------------------------------------------------------------


def _sparse(rng, n, pool):
    return pool[rng.integers(0, len(pool), n)]


def _sort_join_case(seed, k, nb, npr, unique):
    """k key columns of sparse 62-bit values (build drawn from a pool the
    probe shares in part), NULLs, dead rows; a unique build when asked."""
    rng = np.random.default_rng(seed)
    pools = [rng.integers(0, 1 << 62, max(nb, 4)) for _ in range(k)]
    bkeys, pkeys = [], []
    cells = rng.permutation(max(nb, 4) ** k if k < 3 else 4 ** 9)[:nb] \
        if unique else None
    for q, pool in enumerate(pools):
        if unique:
            bv = pool[(cells // max(nb, 4) ** q) % len(pool)] if k < 3 \
                else pool[(cells >> (2 * q)) % 4]
        else:
            bv = _sparse(rng, nb, pool[: max(2, nb // 3)])
        pv = np.where(rng.random(npr) < 0.8, _sparse(rng, npr, pool),
                      rng.integers(0, 1 << 62, npr))
        null_b = 0.0 if unique else 0.05
        bkeys.append((bv.astype(np.int64), rng.random(nb) >= null_b))
        pkeys.append((pv.astype(np.int64), rng.random(npr) > 0.05))
    blive = rng.random(nb) > (0.0 if unique else 0.1)
    plive = rng.random(npr) > 0.1
    return bkeys, pkeys, blive, plive


def _combined(JJ, jnp, bkeys, pkeys, blive, plive):
    both = [(np.concatenate([bv, pv]), np.concatenate([bm, pm]))
            for (bv, bm), (pv, pm) in zip(bkeys, pkeys)]
    live = np.concatenate([blive, plive])
    jc, jv = JJ.combine_keys([(jnp.asarray(v), jnp.asarray(m))
                              for v, m in both], jnp.asarray(live))
    tc, tv = TJ.combine_keys([(_t(v), _t(m)) for v, m in both], _t(live))
    return (np.asarray(jc), np.asarray(jv)), (_np(tc), _np(tv))


SORT_CASES = [(1, 300, 900, True), (1, 300, 900, False), (2, 200, 500, False),
              (3, 150, 400, True), (1, 1, 50, True), (2, 5000, 7000, False)]


@pytest.mark.parametrize("k,nb,npr,unique", SORT_CASES)
def test_combine_keys_matches_jax(jx, k, nb, npr, unique):
    JJ, jnp = jx
    bkeys, pkeys, blive, plive = _sort_join_case(k * nb, k, nb, npr, unique)
    (jc, jv), (tc, tv) = _combined(JJ, jnp, bkeys, pkeys, blive, plive)
    assert np.array_equal(jv, tv)
    assert np.array_equal(jc, tc)


@pytest.mark.parametrize("k,nb,npr,unique", SORT_CASES)
def test_sorted_probe_unique_matches_jax(jx, k, nb, npr, unique):
    JJ, jnp = jx
    bkeys, pkeys, blive, plive = _sort_join_case(k + nb, k, nb, npr, unique)
    (codes, valid), _ = _combined(JJ, jnp, bkeys, pkeys, blive, plive)
    args = (codes[:nb], valid[:nb], blive, codes[nb:], valid[nb:], plive)
    jidx, jm, ju = JJ.sorted_probe_unique(*(jnp.asarray(a) for a in args))
    tidx, tm, tu = TJ.sorted_probe_unique(*(_t(a) for a in args))
    assert bool(ju) == bool(tu)
    assert np.array_equal(np.asarray(jm), _np(tm))
    if bool(ju):
        assert np.array_equal(np.asarray(jidx), _np(tidx))
    # every match points at a build row of the probe's code
    hit = _np(tm)
    assert (codes[:nb][_np(tidx)[hit]] == codes[nb:][hit]).all()
    assert (_np(tidx)[~hit] == 0).all()


@pytest.mark.parametrize("k,nb,npr,unique", SORT_CASES)
def test_sorted_probe_multi_matches_jax(jx, k, nb, npr, unique):
    JJ, jnp = jx
    bkeys, pkeys, blive, plive = _sort_join_case(3 * k + nb, k, nb, npr,
                                                 unique)
    (codes, valid), _ = _combined(JJ, jnp, bkeys, pkeys, blive, plive)
    args = (codes[:nb], valid[:nb] & blive, codes[nb:], valid[nb:] & plive)
    js, jc, jo = JJ.sorted_probe_multi(*(jnp.asarray(a) for a in args))
    ts, tc, to = TJ.sorted_probe_multi(*(_t(a) for a in args))
    assert np.array_equal(np.asarray(js), _np(ts))
    assert np.array_equal(np.asarray(jc), _np(tc))
    # the build order with the dead/NULL sentinel tail, element for element
    assert np.array_equal(np.asarray(jo), _np(to))


# ---------------------------------------------------------------------------
# K4-K7 against their plain versions on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the join kernels run only on the card")
    return torch.device("cuda", 0)


def _dev_keys(keys, dev):
    return [(_t(v).to(dev), _t(m).to(dev)) for v, m in keys]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("n_live", [None, 17])
def test_k4_k5_match_plain(cuda, k, unique, n_live):
    nb = 20 if k > 1 else 30
    bounds, bkeys, pkeys, blive, plive = _raw_join_case(k + 2 * unique, k,
                                                        nb, 5000, unique)
    dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    got = TJ.lut_build(_dev_keys(bkeys, cuda), bounds, dom,
                       live=_t(blive).to(cuda), n_live=n_live,
                       want_codes=True)
    want = TJ.lut_build_plain(_dev_keys(bkeys, cuda), bounds, dom,
                              live=_t(blive).to(cuda), n_live=n_live,
                              want_codes=True)
    cnt, lut, maxcnt, codes = got
    assert torch.equal(cnt, want[0]) and torch.equal(codes, want[3])
    assert int(maxcnt) == int(want[2])
    single = cnt[:dom] <= 1
    assert torch.equal(lut[:dom][single], want[1][:dom][single])
    starts, _ = TJ.lut_order_plain(codes, cnt)
    for table, uq in ((lut, True), (starts, False)):
        a = TJ.lut_probe(_dev_keys(pkeys, cuda), bounds, cnt, table,
                         _t(plive).to(cuda), nb, unique=uq)
        b = TJ.lut_probe_plain(_dev_keys(pkeys, cuda), bounds, cnt, table,
                               _t(plive).to(cuda), nb, unique=uq)
        # both read the kernel's own table, so even a duplicated code's
        # slot gathers identically
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # K5's vector steps at their edges: n at multiples of 4 ± 1, key views
    # 1-3 elements and mask / live views 1-15 bytes off their boundaries,
    # int32 and int64 keys, all-dead and all-live probes, both modes
    rng = np.random.default_rng(40 + k + 3 * unique)
    for n in (1, 3, 4, 5, 1023, 1025, 4099):
        for off in (0, 1, 2, 3, 5, 15):
            keys = []
            for q, (v, m) in enumerate(_keys(rng, n + 16, bounds)):
                dt = torch.int32 if (q + off) % 2 else torch.int64
                keys.append((_t(v).to(dt).to(cuda)[off % 4:off % 4 + n],
                             _t(m).to(cuda)[off:off + n]))
            for lv in (rng.random(n + 16) > 0.1, np.zeros(n + 16, bool),
                       np.ones(n + 16, bool)):
                live = _t(lv).to(cuda)[15 - off:15 - off + n]
                for table, uq in ((lut, True), (starts, False)):
                    a = TJ.lut_probe(keys, bounds, cnt, table, live, nb, uq)
                    b = TJ.lut_probe_plain(keys, bounds, cnt, table, live,
                                           nb, uq)
                    assert torch.equal(a[0], b[0]) and \
                        torch.equal(a[1], b[1]), (n, off, uq)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,dom,skew", [(1, 1, False), (5000, 997, False),
                                         (70000, 40, True),
                                         (1 << 20, 1 << 18, False)])
def test_k6_matches_plain(cuda, nb, dom, skew):
    rng = np.random.default_rng(nb)
    vals = (rng.zipf(1.3, nb) % dom if skew
            else rng.integers(0, dom, nb)).astype(np.int64)
    keys = [(_t(vals).to(cuda), _t(rng.random(nb) > 0.3).to(cuda))]
    cnt, _, _, codes = TJ.lut_build(keys, [(0, dom - 1)], dom,
                                    want_lut=False, want_codes=True)
    s1, o1 = TJ.lut_order(codes, cnt)
    s2, o2 = TJ.lut_order_plain(codes, cnt)
    assert torch.equal(s1, s2) and torch.equal(o1, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("P,nb,dom,out_cap", [
    (31, 23, 12, 256), (31, 23, 12, 8), (5000, 20000, 900, 1 << 16),
    (0, 1, 1, 64), (16, 1, 1, 64)])
def test_k7_matches_plain(cuda, outer, P, nb, dom, out_cap):
    if P:
        start, count, order, live = _expand_case(P * 3 + nb, P, nb, dom)
    else:
        start = count = np.zeros(0, dtype=np.int32)
        order = np.zeros(nb, dtype=np.int32)
        live = np.zeros(0, dtype=bool)
    args = [_t(a).to(cuda) for a in (start, count, order)]
    lv = _t(live).to(cuda)
    gp, gb, gm, gl, gk, gt = TJ.expand(*args, out_cap, outer, lv)
    wp, wb, wm, wl, wk, wt = TJ.expand_plain(*args, out_cap, outer, lv)
    assert int(gt) == int(wt)
    assert torch.equal(gl, wl)
    for a, b in ((gp, wp), (gb, wb), (gm, wm), (gk, wk)):
        assert torch.equal(a[wl], b[wl])
    if P:
        assert bool(((gp >= 0) & (gp < P)).all())
    assert bool(((gb >= 0) & (gb < nb)).all())


# ---------------------------------------------------------------------------
# K8-K11 against their plain versions on the card
# ---------------------------------------------------------------------------


def _special_values(rng, kind, n):
    if kind == "f64":
        v = np.round(rng.normal(size=n), 2)
        pick = rng.random(n) < 0.5
        v[pick] = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                                       1.5]), int(pick.sum()))
        return v
    if kind == "i32":
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    if kind == "i64":
        return rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    if kind == "bool":
        return rng.random(n) > 0.5
    return rng.integers(0, 5, n).astype(np.int32)       # dict codes


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 4097, 100_003])
@pytest.mark.parametrize("end_bit", [1, 13, 64])
def test_k8_matches_plain(cuda, n, end_bit):
    from tidb_tpu_torch.ops import factorize as F
    rng = np.random.default_rng(n + end_bit)
    keys = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                         dtype=np.int64))
    if end_bit < 64:
        keys = keys & ((1 << end_bit) - 1)
    keys = keys.to(cuda)
    vals = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    for v in (None, vals):
        gk, gv = F.radix_sort(keys, v, end_bit)
        wk, wv = F.radix_sort_plain(keys, v, end_bit)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f64", "i32", "i64", "bool", "code"])
@pytest.mark.parametrize("desc", [False, True])
def test_k9_matches_plain(cuda, kind, desc):
    from tidb_tpu_torch.ops import factorize as F
    rng = np.random.default_rng(len(kind) + desc)
    n = 4097
    v, code = F._k9_operand(torch.from_numpy(
        np.asarray(_special_values(rng, kind, n))).to(cuda))
    m = torch.from_numpy(rng.random(n) > 0.2).to(cuda)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    stats = torch.tensor([-1, 0], dtype=torch.int64, device=cuda)
    F.sort_encode(v, code, None, m, desc, 0, 0, stats=stats)
    _, (lo, hi) = F.sort_encode_plain(v, code, None, m, desc, 0, 0)
    assert [x & ((1 << 64) - 1) for x in stats.tolist()] == [lo, hi]
    out = torch.empty(n, dtype=torch.int64, device=cuda)
    F.sort_encode(v, code, perm, m, desc, lo, 1, out)
    want, _ = F.sort_encode_plain(v, code, perm, m, desc, lo, 1)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [["f64"], ["i32"], ["i64"], ["bool"],
                                  ["code", "f64"], ["i64", "bool", "code"]])
@pytest.mark.parametrize("n", [1, 1000, 4097, 100_003])
def test_k8_k9_k10_sort_functions_match_plain(cuda, spec, n):
    """factorize / sort_perm / topn / pack_codes on the card (K9 + K8 +
    K10) equal the same functions over the same tensors on the CPU (the
    plain versions), with NULLs, dead rows, NaN / ±0.0 / ±inf and a cap
    below the group count."""
    from tidb_tpu_torch.ops import factorize as F
    rng = np.random.default_rng(n * len(spec))
    keys = [(torch.from_numpy(np.asarray(_special_values(rng, k, n))),
             torch.from_numpy(rng.random(n) > 0.1)) for k in spec]
    live = torch.from_numpy(rng.random(n) > 0.2)
    dkeys = [(v.to(cuda), m.to(cuda)) for v, m in keys]
    dlive = live.to(cuda)
    for cap in (3, 2 * n):
        got = F.factorize(dkeys, dlive, cap)
        want = F.factorize(keys, live, cap)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    for descs in ([False] * len(spec), [True] * len(spec)):
        gp, gn = F.sort_perm(dkeys, descs, dlive)
        wp, wn = F.sort_perm(keys, descs, live)
        assert torch.equal(gp.cpu(), wp) and int(gn) == int(wn)
        gi, go = F.topn(dkeys, descs, dlive, 10)
        wi, wo = F.topn(keys, descs, live, 10)
        assert torch.equal(gi.cpu(), wi) and int(go) == int(wo)
    assert torch.equal(F.pack_codes(dkeys, dlive).cpu(),
                       F.pack_codes(keys, live))
    assert torch.equal(F.partition_perm(dlive).cpu(),
                       F.partition_perm(live))


@pytest.mark.cuda
@pytest.mark.parametrize("k,nb,npr,unique", SORT_CASES + [
    (1, 200_000, 1_000_000, True), (2, 100_000, 300_000, False)])
def test_k11_matches_plain(cuda, k, nb, npr, unique):
    bkeys, pkeys, blive, plive = _sort_join_case(7 * k + nb, k, nb, npr,
                                                 unique)
    both = [(_t(np.concatenate([bv, pv])), _t(np.concatenate([bm, pm])))
            for (bv, bm), (pv, pm) in zip(bkeys, pkeys)]
    live = _t(np.concatenate([blive, plive]))
    codes, valid = TJ.combine_keys(both, live)
    gc, gv = TJ.combine_keys([(v.to(cuda), m.to(cuda)) for v, m in both],
                             live.to(cuda))
    assert torch.equal(gc.cpu(), codes) and torch.equal(gv.cpu(), valid)
    bl, pl = _t(blive), _t(plive)
    args = (codes[:nb], valid[:nb], bl, codes[nb:], valid[nb:], pl)
    got = TJ.sorted_probe_unique(*(a.to(cuda) for a in args),
                                 code_bound=(nb + npr + 1) ** 2)
    want = TJ.sorted_probe_unique(*args)
    assert bool(got[2]) == bool(want[2])
    assert torch.equal(got[1].cpu(), want[1])
    if bool(want[2]):
        assert torch.equal(got[0].cpu(), want[0])
    margs = (codes[:nb], valid[:nb] & bl, codes[nb:], valid[nb:] & pl)
    got = TJ.sorted_probe_multi(*(a.to(cuda) for a in margs))
    want = TJ.sorted_probe_multi(*margs)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    # K11 alone, against its plain version on the card's own sort
    sc, order = TJ.sorted_build(margs[0].to(cuda), margs[1].to(cuda))
    pc, ok = margs[2].to(cuda), margs[3].to(cuda)
    for a, b in zip(TJ.sorted_search_unique(sc, order, pc, ok),
                    TJ.sorted_search_unique_plain(sc, order, pc, ok)):
        assert torch.equal(a, b)
    for a, b in zip(TJ.sorted_search_multi(sc, pc, ok),
                    TJ.sorted_search_multi_plain(sc, pc, ok)):
        assert torch.equal(a, b)
    table = torch.sort(codes[:nb]).values
    for right in (False, True):
        assert torch.equal(
            TJ.searchsorted(table.to(cuda), codes[nb:].to(cuda),
                            right).cpu(),
            torch.searchsorted(table, codes[nb:], right=right))

"""The port's LUT join primitives (tidb_tpu_torch/ops/join.py) against the
JAX package's (tidb_tpu/ops/join.py) on the CPU, and the four join kernels
(K4 lut_build, K5 lut_probe, K6 lut_order, K7 join_expand) against their
plain torch versions on the card.

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

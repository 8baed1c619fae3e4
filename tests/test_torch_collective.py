"""The monolithic program's collectives on the port (tidb_tpu_torch/
parallel/collective.py: `exchange`, `broadcast_build`, `gather_partials`
over rank lists, their plain versions on the CPU) against the JAX
package's (tidb_tpu/parallel/collective.py) run inside shard_map on 2
and 4 of the 8 virtual XLA CPU devices.

The same seed-made numpy inputs go through both: the JAX side shards
them evenly over the mesh, the port takes each shard as one rank's
tensors. Received buffers, live masks and `need` are held exactly, over
mixed dtypes (int64, int32, int16, bool, float64), dead rows and an
overflowing cap. The wrappers of K24 rank_exchange, K25 rank_gather and
K26 hash_dest are held to their plain versions on the CPU, and their
argument checks run with the device check stubbed (the kernels
themselves are held in tests/test_torch_cuda.py on the card)."""

import numpy as np
import pytest
import torch

from tidb_tpu.ops.jax_env import jax, jnp, shard_map
from tidb_tpu.parallel import collective as JC
from tidb_tpu.parallel import make_mesh as j_make_mesh
from tidb_tpu.parallel import shard_rows as j_shard_rows
from tidb_tpu_torch.ops import cuda_kernels as ck
from tidb_tpu_torch.ops import partition as P
from tidb_tpu_torch.ops import rank_gather as RG
from tidb_tpu_torch.parallel import collective as TC
from tidb_tpu_torch.parallel import make_mesh, replicated, shard_rows

PS = jax.sharding.PartitionSpec


def _columns(rng, n):
    return [rng.integers(-(1 << 40), 1 << 40, n),
            rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(-300, 300, n).astype(np.int16),
            rng.random(n) < 0.5,
            rng.normal(0.0, 1e3, n)]


def _ranks(a, nd):
    per = len(a) // nd
    return [torch.from_numpy(np.ascontiguousarray(a[r * per:(r + 1) * per]))
            for r in range(nd)]


def _jax_exchange(mesh, nd, cap, dest, live, cols):
    k = len(cols)

    def step(d, lv, *arrays):
        recv, recv_live, need = JC.exchange(list(arrays), d, lv, nd, cap)
        return (*recv, recv_live, need)

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(PS("shard"),) *
                           (2 + k),
                           out_specs=(PS("shard"),) * (k + 1) + (PS(),),
                           check_rep=False))
    out = fn(*j_shard_rows(mesh, [dest, live] + cols))
    return [np.asarray(o) for o in out[:-1]], int(out[-1])


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("case", ["roomy", "dead_rows", "overflow",
                                  "one_destination"])
def test_exchange_matches_jax(eight_devices, nd, case):
    rng = np.random.default_rng(7 * nd + len(case))
    n = 1024
    cols = _columns(rng, n)
    dest = rng.integers(0, nd, n).astype(np.int32)
    live = np.ones(n, dtype=bool)
    cap = n
    if case == "dead_rows":
        live = rng.random(n) < 0.6
    elif case == "overflow":
        live = rng.random(n) < 0.9
        cap = 32
    elif case == "one_destination":
        dest[:] = nd - 1
        cap = 8
    want, jneed = _jax_exchange(j_make_mesh(nd), nd, cap, dest, live, cols)
    recv, recv_live, need = TC.exchange(
        [list(x) for x in zip(*[_ranks(c, nd) for c in cols])],
        _ranks(dest, nd), _ranks(live, nd), nd, cap)
    assert need.dtype == torch.int32 and int(need) == jneed
    total = nd * cap
    for d in range(nd):
        for j, c in enumerate(cols):
            got = recv[d][j].numpy()
            assert got.dtype == c.dtype and got.shape == (total,)
            assert np.array_equal(got, want[j][d * total:(d + 1) * total])
        assert np.array_equal(recv_live[d].numpy(),
                              want[-1][d * total:(d + 1) * total])


@pytest.mark.parametrize("nd", [2, 4])
def test_exchange_by_keys_is_the_hash_of_the_keys(nd):
    """A row whose dest lies outside [0, nd) is a dead row (K24 takes the
    same rule), and hash_dest's destinations route a row where
    shard_of(mix_key_code) of its keys, or shard_of of its code, sends
    it."""
    rng = np.random.default_rng(40 + nd)
    n = 600
    kv = torch.from_numpy(rng.integers(0, 50, n))
    km = torch.from_numpy(rng.random(n) < 0.9)
    live = torch.from_numpy(rng.random(n) < 0.8)
    cols = [torch.from_numpy(rng.normal(size=n))]
    per = n // nd
    sl = [slice(r * per, (r + 1) * per) for r in range(nd)]
    arrays = [[c[s] for c in cols] for s in sl]
    lives = [live[s] for s in sl]
    dest = torch.from_numpy(rng.integers(-2, nd + 2, n).astype(np.int32))
    inside = (dest >= 0) & (dest < nd)
    wild = TC.exchange(arrays, [dest[s] for s in sl], lives, nd, 256)
    tame = TC.exchange(arrays, [dest[s].clamp(0, nd - 1) for s in sl],
                       [(live & inside)[s] for s in sl], nd, 256)
    by_keys = TC.exchange(arrays, [P.hash_dest([(kv[s], km[s])], nd)
                                   for s in sl], lives, nd, 256)
    by_hash = TC.exchange(arrays, [TC.shard_of(TC.mix_key_code(
        [(kv[s], km[s])]), nd) for s in sl], lives, nd, 256)
    by_code = TC.exchange(arrays, [P.hash_dest(None, nd, code=kv[s])
                                   for s in sl], lives, nd, 256)
    by_cdest = TC.exchange(arrays, [TC.shard_of(kv[s], nd) for s in sl],
                           lives, nd, 256)
    assert int(wild[1][0].sum()) < int(live[sl[0]].sum())
    for a, b in ((wild, tame), (by_keys, by_hash), (by_code, by_cdest)):
        for d in range(nd):
            assert torch.equal(a[0][d][0], b[0][d][0])
            assert torch.equal(a[1][d], b[1][d])
        assert int(a[2]) == int(b[2])


@pytest.mark.parametrize("nd", [2, 4])
def test_broadcast_build_matches_jax(eight_devices, nd):
    rng = np.random.default_rng(50 + nd)
    n = 512
    cols = _columns(rng, n)
    live = rng.random(n) < 0.7
    k = len(cols)

    def step(lv, *arrays):
        out, out_live = JC.broadcast_build(list(arrays), lv)
        return (*out, out_live)

    mesh = j_make_mesh(nd)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(PS("shard"),) *
                           (1 + k), out_specs=(PS(),) * (k + 1),
                           check_rep=False))
    want = [np.asarray(o) for o in fn(*j_shard_rows(mesh, [live] + cols))]
    got_cols, got_live = TC.broadcast_build(
        [list(x) for x in zip(*[_ranks(c, nd) for c in cols])],
        _ranks(live, nd))
    assert len(got_cols) == nd and len(got_live) == nd
    for r in range(nd):
        assert got_cols[r] is got_cols[0]     # one gathered buffer
        for j in range(k):
            g = got_cols[r][j].numpy()
            assert g.dtype == want[j].dtype and np.array_equal(g, want[j])
        assert np.array_equal(got_live[r].numpy(), want[-1])


@pytest.mark.parametrize("nd", [2, 4])
def test_gather_partials_matches_jax(eight_devices, nd):
    rng = np.random.default_rng(60 + nd)
    cap = 64
    n = nd * cap
    kv = rng.integers(0, 20, n)
    km = rng.random(n) < 0.9
    s1 = rng.normal(size=n)
    s2 = rng.integers(0, 100, n)
    s3 = rng.integers(0, 5, n).astype(np.int32)
    slot = rng.random(n) < 0.5

    def step(v, m, a, b, c, sl):
        keys, states, gslot = JC.gather_partials([(v, m)], [(a, b), (c,)],
                                                 sl)
        return (keys[0][0], keys[0][1], states[0][0], states[0][1],
                states[1][0], gslot)

    mesh = j_make_mesh(nd)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(PS("shard"),) * 6,
                           out_specs=(PS(),) * 6, check_rep=False))
    want = [np.asarray(o) for o in
            fn(*j_shard_rows(mesh, [kv, km, s1, s2, s3, slot]))]
    rk = [_ranks(x, nd) for x in (kv, km, s1, s2, s3, slot)]
    gkeys, gstates, gslot = TC.gather_partials(
        [[(rk[0][r], rk[1][r])] for r in range(nd)],
        [[(rk[2][r], rk[3][r]), (rk[4][r],)] for r in range(nd)],
        rk[5])
    for r in range(nd):
        got = [gkeys[r][0][0], gkeys[r][0][1], gstates[r][0][0],
               gstates[r][0][1], gstates[r][1][0], gslot[r]]
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(),
                                                                 w)


def test_rank_gather_plain_takes_limb_columns_and_ragged_pieces():
    """K25's plain version concatenates along the LAST axis (wide-decimal
    limb planes keep their leading axis) and takes pieces of different
    lengths, in rank order."""
    a = [torch.arange(6).reshape(2, 3), torch.arange(6, 10).reshape(2, 2)]
    b = [torch.tensor([True]), torch.tensor([False, True])]
    got = RG.rank_gather([a, b])
    assert torch.equal(got[0], torch.tensor([[0, 1, 2, 6, 7],
                                             [3, 4, 5, 8, 9]]))
    assert torch.equal(got[1], torch.tensor([True, False, True]))


def test_hash_dest_plain_is_shard_of_mix_key_code():
    rng = np.random.default_rng(3)
    keys = [(torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 500)),
             torch.from_numpy(rng.random(500) < 0.8)),
            (torch.from_numpy(rng.normal(size=500)),
             torch.ones(500, dtype=torch.bool))]
    jkeys = [(jnp.asarray(v.numpy()), jnp.asarray(m.numpy()))
             for v, m in keys]
    for nd in (1, 4, 7, 64):
        want = np.asarray(JC.shard_of(JC.mix_key_code(jkeys), nd))
        got = P.hash_dest(keys, nd)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                           want)
        code = keys[0][0]
        assert np.array_equal(
            P.hash_dest(None, nd, code=code).numpy(),
            np.asarray(JC.shard_of(jnp.asarray(code.numpy()), nd)))


def test_shard_rows_pads_the_last_rank():
    """The reference's row split: cap = ceil(total / ranks), rank r holds
    rows [r·cap, (r+1)·cap), zero-padded (a padded mask is False)."""
    mesh = make_mesh(4, "cpu")
    v, m = shard_rows(mesh, [np.arange(10), np.ones(10, dtype=bool)])
    assert [t.tolist() for t in v] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                       [9, 0, 0]]
    assert [t.tolist() for t in m][-1] == [True, False, False]
    (rep,) = replicated(mesh, [np.arange(3)])
    assert len(rep) == 4 and all(t is rep[0] for t in rep)


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """On the CPU K24-K26's wrappers ARE their plain versions: no
    library is loaded and no launch is counted."""
    def boom(name):
        raise AssertionError("a kernel library was loaded on the CPU")
    monkeypatch.setattr(ck, "library", boom)
    before = ck.launches()
    live = [torch.ones(5, dtype=torch.bool)] * 2
    arrays = [[torch.arange(5)], [torch.arange(5, 10)]]
    codes = [torch.arange(5), torch.arange(5, 10)]
    dest = [P.hash_dest(None, 2, code=c) for c in codes]
    got = P.rank_exchange(arrays, dest, live, 2, 8)
    want = P.rank_exchange_plain(arrays, dest, live, 2, 8)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(got[0], want[0]))
    RG.rank_gather([arrays[0] + arrays[1]])
    assert ck.launches() == before


def test_k24_k26_argument_checks(monkeypatch):
    """K24's and K26's wrappers refuse what their kernels do not take,
    before any launch: a CPU tensor never reaches the checks (it takes
    the plain version), so the device requirement is stubbed to reach
    the shape and type checks."""
    live = [torch.ones(8, dtype=torch.bool)] * 2
    arrays = [[torch.arange(8)], [torch.arange(8)]]
    dest = [torch.zeros(8, dtype=torch.int32)] * 2
    with pytest.raises(ck.KernelError, match="expected a CUDA tensor"):
        P._check_exchange(arrays, dest, live, 2, 16)
    monkeypatch.setattr(ck, "require_cuda", lambda *t, what: None)
    P._check_exchange(arrays, dest, live, 2, 16)
    bad = [
        ((arrays, dest, live, 3, 16), "one entry per rank"),
        ((arrays, dest[:1], live, 2, 16), "one entry per rank"),
        ((arrays * 65, dest * 65, live * 65, 65, 16), "one entry per rank"),
        ((arrays, dest, live, 2, -1), "negative bucket_cap"),
        ((arrays, dest, [lv.to(torch.int8) for lv in live], 2, 16),
         "bool live masks"),
        ((arrays, [torch.arange(8)] * 2, live, 2, 16), "int32 dest"),
        ((arrays, [torch.zeros(7, dtype=torch.int32)] * 2, live, 2, 16),
         "int32 dest"),
        (([[torch.arange(8)], [torch.arange(8.0)]], dest, live, 2, 16),
         "same payload dtypes"),
        (([[torch.zeros(8, dtype=torch.complex128)]] * 2, dest, live, 2,
          16), "1, 2, 4 or 8 bytes"),
        (([[torch.arange(7)]] * 2, dest, live, 2, 16), "1-D of the live"),
    ]
    for args, msg in bad:
        with pytest.raises(ck.KernelError, match=msg):
            P._check_exchange(*args)
    k1 = [(torch.arange(8), torch.ones(8, dtype=torch.bool))]
    P._check_dest(k1, 4, None)
    P._check_dest(None, 4, torch.arange(8))
    for args, msg in [((k1, 0, None), "at least one shard"),
                      ((None, 4, None), "key columns or one code"),
                      ((k1, 4, torch.arange(8)), "key columns or one code"),
                      ((None, 4, torch.arange(8).int()), "int64 code"),
                      ((None, 4, torch.zeros(2, 4, dtype=torch.int64)),
                       "1-D columns"),
                      (([(torch.arange(8), torch.ones(7, dtype=torch.bool))],
                        4, None), "bool validity"),
                      (([(torch.zeros(8, dtype=torch.complex64),
                          torch.ones(8, dtype=torch.bool))], 4, None),
                       "key dtype")]:
        with pytest.raises(ck.KernelError, match=msg):
            P._check_dest(*args)


def test_k25_argument_checks(monkeypatch):
    """K25's wrapper refuses pieces of another dtype, leading shape or
    rank count before any launch (device check stubbed, as above)."""
    with pytest.raises(ck.KernelError, match="expected a CUDA tensor"):
        RG._check_pieces([torch.arange(3), torch.arange(2)])
    monkeypatch.setattr(ck, "require_cuda", lambda *t, what: None)
    RG._check_pieces([torch.arange(3), torch.arange(2)])
    for pieces, msg in [([torch.arange(3), torch.arange(2.0)], "share one"),
                        ([torch.zeros(2, 3), torch.zeros(3, 3)],
                         "share one"),
                        ([torch.zeros(1, 2, 3)] * 2, "1-D or 2-D")]:
        with pytest.raises(ck.KernelError, match=msg):
            RG._check_pieces(pieces)


def _replay(plan, columns):
    """What rg_copy does with `plan`, over byte buffers: each launch's
    chunks numbered from 0, a chunk's segment found by bisection over
    the segments' first chunks, its row and part by division; every
    output byte must be written exactly once. → the gathered columns."""
    import bisect
    ch = RG.CHUNK
    srcs = [np.ascontiguousarray(p).reshape(-1).view(np.uint8)
            for pieces in columns for p in pieces]
    outs, hits = [], []
    for pieces, total in zip(columns, plan.totals):
        shape = pieces[0].shape[:-1] + (total,)
        outs.append(np.zeros(shape, dtype=pieces[0].dtype))
        hits.append(np.zeros(outs[-1].nbytes, dtype=np.int64))
    segs = plan.segments
    for i0 in range(0, len(segs), RG.MAX_SEGS):
        launch = segs[i0:i0 + RG.MAX_SEGS]
        assert launch[0].start == 0
        starts = [s.start for s in launch]
        n_chunks = launch[-1].start + launch[-1].rows * launch[-1].row_chunks
        for c in range(n_chunks):
            k = bisect.bisect_right(starts, c) - 1
            s = launch[k]
            row, part = divmod(c - s.start, s.row_chunks)
            nb = min(ch, s.row_bytes - part * ch)
            assert nb > 0
            src = srcs[plan.pieces[i0 + k]]
            a = row * s.row_bytes + part * ch
            b = s.dst_off + row * s.pitch + part * ch
            outs[s.col].reshape(-1).view(np.uint8)[b:b + nb] = src[a:a + nb]
            hits[s.col][b:b + nb] += 1
    for h in hits:
        assert (h == 1).all()
    return outs


def _plan_of(columns):
    """gather_plan of numpy pieces: (torch dtype, leading shape, lengths)
    a column, as rank_gather builds it."""
    return RG.gather_plan(tuple(
        (torch.from_numpy(p[0][:0]).dtype, p[0].shape[:-1],
         tuple(q.shape[-1] for q in p)) for p in columns))


_DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32,
           np.float64)


@pytest.mark.parametrize("case", ["even", "ragged", "empty_rank",
                                  "limbs", "launch_split", "big_rows"])
def test_gather_plan_replay_matches_plain(case):
    """K25's descriptor builder, replayed chunk by chunk over byte buffers
    as the kernel walks it, equals rank_gather_plain: 1-D columns of
    every item size at odd lengths (unaligned pieces), ragged and empty
    ranks, 2-D limb columns, more segments than one launch takes, and
    rows of several chunks."""
    rng = np.random.default_rng(len(case))
    ranks = {"launch_split": 24, "big_rows": 2}.get(case, 4)

    def length(r):
        if case == "empty_rank" and r == 1:
            return 0
        if case == "big_rows":
            return 3 * RG.CHUNK + 7
        return 5 if case == "even" else 3 + 2 * r + (r % 2)

    columns = []
    for dt in _DTYPES:
        columns.append([rng.integers(0, 100, length(r)).astype(dt)
                        for r in range(ranks)])
    for rows in ((1, 5) if case in ("limbs", "launch_split") else (3,)):
        columns.append([rng.integers(0, 1 << 40, (rows, length(r)))
                        for r in range(ranks)])
    plan = _plan_of(columns)
    if case == "launch_split":
        assert len(plan.segments) > 2 * RG.MAX_SEGS
    got = _replay(plan, columns)
    want = RG.rank_gather_plain([[torch.from_numpy(p) for p in pieces]
                                 for pieces in columns])
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())
    recs = [RG._REC.unpack_from(plan.table, i * RG._REC.size)
            for i in range(len(plan.segments))]
    for s, rec in zip(plan.segments, recs):
        assert rec[:7] == (s.dst_off, s.row_bytes, s.pitch, s.start, s.col,
                           s.rows, s.row_chunks)
    # the outputs: one buffer a group of columns sharing dtype, leading
    # shape and total; every column once, of its gathered shape and dtype
    outs = RG._allocate(plan, [torch.from_numpy(p[0]) for p in columns])
    assert sorted(j for _d, _s, cols in plan.groups for j in cols) == \
        list(range(len(columns)))
    for o, w in zip(outs, want):
        assert o.shape == w.shape and o.dtype == w.dtype
    for _d, _s, cols in plan.groups:
        base = outs[cols[0]].untyped_storage().data_ptr()
        assert all(outs[j].untyped_storage().data_ptr() == base
                   for j in cols)


@pytest.mark.parametrize("nd", [2, 4])
def test_gather_plan_replay_matches_jax_all_gather(eight_devices, nd):
    """The replayed plan over broadcast_build's and gather_partials'
    columns (rank shards of a build side and of partial states, 1-D of
    every item size) equals the JAX package's tiled all_gather."""
    rng = np.random.default_rng(70 + nd)
    n = nd * 33
    cols = _columns(rng, n) + [rng.integers(0, 9, n).astype(np.int8)]
    live = rng.random(n) < 0.7

    def step(lv, *arrays):
        out, out_live = JC.broadcast_build(list(arrays), lv)
        return (*out, out_live)

    mesh = j_make_mesh(nd)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(PS("shard"),) *
                           (1 + len(cols)),
                           out_specs=(PS(),) * (len(cols) + 1),
                           check_rep=False))
    want = [np.asarray(o) for o in fn(*j_shard_rows(mesh, [live] + cols))]
    columns = [[t.numpy() for t in _ranks(c, nd)] for c in cols + [live]]
    got = _replay(_plan_of(columns), columns)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_k25_launch_tables_drive_a_host_copy(monkeypatch):
    """The wrapper's packed call on CPU tensors, with the library replaced
    by a host model of tt_rank_gather's contract (records of the cached
    plan, each segment's piece pointer, the outputs' pointers; row l of a
    segment copied from src + l·row_bytes to out[col] + dst_off +
    l·pitch): the outputs equal rank_gather_plain, every launch's
    records start at chunk 0, and one count is taken."""
    import ctypes

    calls = []

    class Lib:
        def tt_rank_gather(self, n_segs, table, src, out, stream):
            recs = [RG._REC.unpack_from(table, i * RG._REC.size)
                    for i in range(n_segs)]
            srcs = struct_unpack(f"<{n_segs}Q", src)
            outs = struct_unpack(f"<{len(out) // 8}Q", out)
            calls.append([r[3] for r in recs[::RG.MAX_SEGS]])
            for (dst_off, row_bytes, pitch, _s, col, rows, _c, _p), s in \
                    zip(recs, srcs):
                for row in range(rows):
                    ctypes.memmove(outs[col] + dst_off + row * pitch,
                                   s + row * row_bytes, row_bytes)
            return 0

    from struct import unpack as struct_unpack
    monkeypatch.setattr(ck, "library", lambda name: Lib())
    monkeypatch.setattr(ck, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(ck, "require_cuda", lambda *t, what: None)
    rng = np.random.default_rng(9)
    columns = []
    for dt in _DTYPES:
        columns.append([torch.from_numpy(rng.integers(0, 100, 3 + r)
                                         .astype(dt)) for r in range(30)])
    columns.append([torch.from_numpy(rng.integers(0, 1 << 40, (5, r)))
                    for r in range(30)])                 # rank 0 is empty
    columns.append([torch.arange(40).reshape(4, 10)[:, ::3]] * 3)
    before = ck.launches()["rank_gather"]
    dev = torch.device("cpu")
    plan, src, keep = RG._describe(columns, dev)
    outs = RG._allocate(plan, [pieces[0] for pieces in keep])
    RG._launch(plan, src, outs, dev)
    launches = -(-len(plan.segments) // RG.MAX_SEGS)
    assert launches > 2 and calls == [[0] * launches]
    for got, want in zip(outs, RG.rank_gather_plain(columns)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert ck.launches()["rank_gather"] == before + 1

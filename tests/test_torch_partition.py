"""The staged exchange's bucket scatter on the port (K23 hash_partition's
plain torch version, ops/partition.py) and its key hash and host routing
(tidb_tpu_torch/parallel/collective.py) against the JAX package's
`device_emit.emit_partition`, `collective.shard_of(mix_key_code(...))`
and `collective.route_buckets` on the CPU.

The same seed-made numpy inputs go through both. Every output is held
exactly: the hash bits, each bucket buffer, sent_live, counts and need.
Keys cover int32, int64, bool, DATE (int32 days), finite floats and NULL
keys, 1-3 key columns; n_shards 1, 2, 3, 4 and 8; dead rows; and an
overflow where need > bucket_cap (rows past the cap dropped, need
reporting the true size). Floats outside the reference's defined
conversion (NaN, ±inf, |v| ≥ 2⁶³) take the port's own definition, held
here by value. The K23 wrapper's argument checks run on the CPU with the
device check stubbed (the kernel itself is held in
tests/test_torch_cuda.py on the card)."""

import numpy as np
import pytest
import torch

from tidb_tpu.executor.device_emit import emit_partition as j_emit_partition
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu.parallel import collective as JC
from tidb_tpu_torch.ops import cuda_kernels as ck
from tidb_tpu_torch.ops import partition as P
from tidb_tpu_torch.parallel import collective as TC

N = 3000


def _key(rng, kind, n, null_p=0.1):
    if kind == "int32":
        v = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    elif kind == "int64":
        v = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    elif kind == "small":
        v = rng.integers(0, 7, n, dtype=np.int64)   # heavy duplicates
    elif kind == "bool":
        v = rng.random(n) < 0.5
    elif kind == "date":
        v = rng.integers(8000, 11000, n, dtype=np.int32)
    elif kind == "float":
        v = rng.normal(0.0, 1e6, n)
        v[:50] = np.round(v[:50])           # some integral values
        v[50:60] = -0.0
    else:
        raise AssertionError(kind)
    m = rng.random(n) >= null_p
    return v, m


def _jax_keys(keys):
    return [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys]


def _torch_keys(keys):
    return [(torch.from_numpy(np.asarray(v)), torch.from_numpy(m))
            for v, m in keys]


@pytest.mark.parametrize("kinds", [("int32",), ("int64",), ("bool",),
                                   ("date",), ("float",), ("small",),
                                   ("int64", "date"),
                                   ("bool", "float", "int32")])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_of_bit_exact(kinds, n_shards):
    rng = np.random.default_rng(sum(map(ord, "".join(kinds))) + n_shards)
    keys = [_key(rng, k, N) for k in kinds]
    jcode = np.asarray(JC.mix_key_code(_jax_keys(keys)))
    tcode = TC.mix_key_code(_torch_keys(keys)).numpy()
    assert tcode.dtype == np.int64 and np.array_equal(tcode, jcode)
    jdest = np.asarray(JC.shard_of(JC.mix_key_code(_jax_keys(keys)),
                                   n_shards))
    tdest = TC.shard_of(torch.from_numpy(tcode), n_shards).numpy()
    assert tdest.dtype == np.int32 and np.array_equal(tdest, jdest)
    assert tdest.min() >= 0 and tdest.max() < n_shards


def test_mix64_full_range():
    """The splitmix64 finalizer over codes across the whole int64 range,
    the sign bit included, and the unsigned modulus for every n ≤ 64."""
    rng = np.random.default_rng(64)
    codes = np.concatenate([
        rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64),
        np.array([0, 1, -1, (1 << 63) - 1, -(1 << 63)], dtype=np.int64)])
    jm = np.asarray(JC._mix64(jnp.asarray(codes))).view(np.int64)
    tm = TC._mix64(torch.from_numpy(codes)).numpy()
    assert np.array_equal(tm, jm)
    for n in range(1, 65):
        assert np.array_equal(
            TC.shard_of(torch.from_numpy(codes), n).numpy(),
            np.asarray(JC.shard_of(jnp.asarray(codes), n)))


def test_float_key_conversion_defined():
    """NaN, ±inf and out-of-range floats: one conversion the kernel and
    the plain version share (NaN → 0, saturation at the int64 ends), and
    truncation toward zero inside the range, as astype(int64)."""
    v = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e19,
                      -1e19, 2.0 ** 63, -(2.0 ** 63), 2.9, -2.9, -0.0])
    want = [0, (1 << 63) - 1, -(1 << 63), (1 << 63) - 1, -(1 << 63),
            (1 << 63) - 1, -(1 << 63), 2, -2, 0]
    assert TC.key_canon(v).tolist() == want
    # equal float keys hash equal, NaN keys co-locate
    m = torch.ones(v.shape[0], dtype=torch.bool)
    d = TC.shard_of(TC.mix_key_code([(v, m)]), 8)
    assert d[0] == TC.shard_of(TC.mix_key_code(
        [(torch.tensor([float("nan")]), torch.ones(1, dtype=torch.bool))]),
        8)[0]


def _payload(rng, n):
    """Payload columns of every itemsize the exchange carries: int64
    values, int32 codes / days, float64, and bool masks."""
    cols = [rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64),
            rng.random(n) < 0.9,
            rng.integers(0, 1000, n, dtype=np.int32),
            rng.random(n) < 0.7,
            rng.normal(0.0, 100.0, n),
            rng.random(n) < 1.0]
    return cols


def _both(keys, live, arrays, n_shards, bucket_cap):
    jdest = JC.shard_of(JC.mix_key_code(_jax_keys(keys)), n_shards)
    jb, js, jc, jn = j_emit_partition([jnp.asarray(a) for a in arrays],
                                      jdest, jnp.asarray(live), n_shards,
                                      bucket_cap)
    tb, ts, tc, tn = P.hash_partition(
        _torch_keys(keys), torch.from_numpy(live),
        [torch.from_numpy(np.asarray(a)) for a in arrays], n_shards,
        bucket_cap)
    return ([np.asarray(b) for b in jb], np.asarray(js), np.asarray(jc),
            int(jn)), ([b.numpy() for b in tb], ts.numpy(), tc.numpy(),
                       int(tn))


def _assert_exact(j, t):
    jb, js, jc, jn = j
    tb, ts, tc, tn = t
    assert tn == jn
    assert tc.dtype == np.int32 and np.array_equal(tc, jc)
    assert ts.dtype == js.dtype and np.array_equal(ts, js)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kinds", [("int64",), ("int32",), ("bool",),
                                   ("date",), ("float",),
                                   ("int64", "date"),
                                   ("small", "bool", "float")])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_partition_matches_reference(kinds, n_shards):
    """Buffers, sent_live, counts and need exactly equal to the JAX
    package's emit_partition over its own shard_of(mix_key_code(...)),
    with dead rows and NULL keys, at a cap every bucket fits."""
    rng = np.random.default_rng(7 * n_shards + len(kinds))
    keys = [_key(rng, k, N) for k in kinds]
    live = rng.random(N) < 0.8
    arrays = _payload(rng, N)
    cap = N          # no bucket can overflow
    j, t = _both(keys, live, arrays, n_shards, cap)
    _assert_exact(j, t)
    assert t[2].sum() == live.sum()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_overflow_reports_need(n_shards):
    """need > bucket_cap: the rows past the cap are dropped in both, and
    need is the true largest bucket (the ladder's exact resize)."""
    rng = np.random.default_rng(11 + n_shards)
    keys = [_key(rng, "small", N, null_p=0.2)]
    live = rng.random(N) < 0.9
    arrays = _payload(rng, N)
    cap = 64
    j, t = _both(keys, live, arrays, n_shards, cap)
    _assert_exact(j, t)
    assert t[3] > cap
    assert t[3] == t[2].max()
    assert t[1].sum() == np.minimum(t[2], cap).sum()


def test_partition_edges():
    """No rows, no live rows, and a zero bucket cap."""
    rng = np.random.default_rng(5)
    for n, p_live, cap in ((0, 1.0, 8), (100, 0.0, 8), (100, 1.0, 0)):
        keys = [_key(rng, "int64", n)]
        live = rng.random(n) < p_live
        arrays = _payload(rng, n)
        j, t = _both(keys, live, arrays, 4, cap)
        _assert_exact(j, t)


def test_partition_is_stable_within_a_bucket():
    """Within bucket d the live prefix is the destination's rows in
    source row order (the routing's invariant)."""
    rng = np.random.default_rng(3)
    keys = [_key(rng, "small", N)]
    live = rng.random(N) < 0.7
    rows = np.arange(N, dtype=np.int64)
    (bufs, sent, counts, _need) = P.hash_partition_plain(
        _torch_keys(keys), torch.from_numpy(live),
        [torch.from_numpy(rows)], 4, N)
    dest = TC.shard_of(TC.mix_key_code(_torch_keys(keys)), 4).numpy()
    got = bufs[0].numpy()
    for d in range(4):
        k = int(counts[d])
        want = rows[live & (dest == d)]
        assert np.array_equal(got[d * N:d * N + k], want)
        assert sent.numpy()[d * N:d * N + k].all()
        assert not sent.numpy()[d * N + k:(d + 1) * N].any()


def _checkpoints(rng, n_shards, caps):
    """Per-rank stage-1 checkpoints with differing per-rank caps, the
    partition outputs of random rank slices."""
    out = []
    for cap in caps:
        keys = [_key(rng, "int64", 500)]
        live = rng.random(500) < 0.8
        arrays = _payload(rng, 500)[:4]
        bufs, _sent, counts, need = P.hash_partition_plain(
            _torch_keys(keys), torch.from_numpy(live),
            [torch.from_numpy(np.asarray(a)) for a in arrays], n_shards,
            cap)
        assert int(need) <= cap
        out.append({"bufs": {0: (bufs[0].numpy(), bufs[1].numpy()),
                             3: (bufs[2].numpy(), bufs[3].numpy())},
                    "counts": counts.numpy(), "cap": cap})
    return out


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_route_buckets_matches_reference(n_shards):
    rng = np.random.default_rng(40 + n_shards)
    ckpts = _checkpoints(rng, n_shards, [512, 1024, 512, 2048])
    # a pruned rank's identity checkpoint (cap 0, no rows)
    ckpts.append({"bufs": {i: (np.zeros(0, v.dtype), np.zeros(0, bool))
                           for i, (v, _m) in ckpts[0]["bufs"].items()},
                  "counts": np.zeros(n_shards, np.int32), "cap": 0})
    t_routed, t_rows = TC.route_buckets(ckpts, n_shards)
    j_routed, j_rows = JC.route_buckets(ckpts, n_shards)
    assert t_rows == j_rows
    assert sum(t_rows) == sum(int(c["counts"].sum()) for c in ckpts)
    for td, jd in zip(t_routed, j_routed):
        assert td.keys() == jd.keys()
        for i in td:
            for a, b in zip(td[i], jd[i]):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_require_capacity():
    from tidb_tpu_torch.errors import CapacityError
    TC.require_capacity(64, 64)
    with pytest.raises(CapacityError, match="needs 65 rows/bucket"):
        TC.require_capacity(65, 64)


def test_hash_partition_argument_checks(monkeypatch):
    """The wrapper refuses what K23 does not take, before any launch: a
    CPU tensor never reaches _check (it takes the plain version), so the
    device requirement is stubbed to reach the shape and type checks."""
    live = torch.ones(8, dtype=torch.bool)
    key = (torch.arange(8), torch.ones(8, dtype=torch.bool))
    arr = [torch.arange(8)]
    with pytest.raises(ck.KernelError, match="expected a CUDA tensor"):
        P._check([key], live, arr, 4, 16)
    monkeypatch.setattr(ck, "require_cuda", lambda *t, what: None)
    P._check([key], live, arr, 4, 16)          # a well-formed call
    for n_shards in (0, P.MAX_SHARDS + 1):
        with pytest.raises(ck.KernelError, match="destinations"):
            P._check([key], live, arr, n_shards, 16)
    with pytest.raises(ck.KernelError, match="negative bucket_cap"):
        P._check([key], live, arr, 4, -1)
    with pytest.raises(ck.KernelError, match="at least one key"):
        P._check([], live, arr, 4, 16)
    with pytest.raises(ck.KernelError, match="bool live mask"):
        P._check([key], live.to(torch.int8), arr, 4, 16)
    with pytest.raises(ck.KernelError, match="key dtype"):
        P._check([(torch.zeros(8, dtype=torch.complex64), key[1])], live,
                 arr, 4, 16)
    with pytest.raises(ck.KernelError, match="bool validity"):
        P._check([(key[0], key[1].to(torch.int32))], live, arr, 4, 16)
    with pytest.raises(ck.KernelError, match="bool validity"):
        P._check([(torch.arange(9), torch.ones(9, dtype=torch.bool))],
                 live, arr, 4, 16)
    with pytest.raises(ck.KernelError, match="payload columns"):
        P._check([key], live, [torch.arange(9)], 4, 16)
    with pytest.raises(ck.KernelError, match="payload columns"):
        P._check([key], live, [torch.zeros((8, 2))], 4, 16)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the wrapper IS the plain version: no library is
    loaded and no launch is counted."""
    def boom(name):
        raise AssertionError("a kernel library was loaded on the CPU")
    monkeypatch.setattr(ck, "library", boom)
    before = ck.launches()["hash_partition"]
    rng = np.random.default_rng(1)
    keys = [_key(rng, "int64", 100)]
    live = rng.random(100) < 0.5
    got = P.hash_partition(_torch_keys(keys), torch.from_numpy(live),
                           [torch.arange(100)], 4, 128)
    want = P.hash_partition_plain(_torch_keys(keys), torch.from_numpy(live),
                                  [torch.arange(100)], 4, 128)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[2], want[2]) and int(got[3]) == int(want[3])
    assert ck.launches()["hash_partition"] == before

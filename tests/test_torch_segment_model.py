"""A numpy model of K1 segment_reduce's three paths (csrc/segment_reduce.cu)
against tidb_tpu.ops.segment under jax.numpy.

The model follows the kernel's order of operations step by step: on the
small-cap path (cap <= 32) each block's contiguous range of row quads
(`ops/segment.block_quads`), thread t reading quads t, t + 256, ... of it
into its own column, the xor-shuffle tree over a warp's 32 lanes, the
warps in order, and the block partials folded in block order (lane l
taking blocks l, l + 32, ..., then the same tree); on the mid path
(cap <= 4096) block partials in any order folded in block order; above
that one scatter. Integer and bool results must equal the reference
exactly at caps 1, 12, 32, 33, 4096 and 4097 with out-of-range gids;
float64 sums within (n-1)·eps·Σ|x| a slot (the reference adds in another
order). The card test `test_k1_small_cap_f64_equals_the_model`
(tests/test_torch_cuda.py) holds the kernel's f64 sums bit for bit to
this model at the grid the card plans."""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import segment as tseg
from tidb_tpu_torch.ops.xp import TorchXP

TX = TorchXP("cpu")
THREADS = tseg.K1_THREADS
WARPS = THREADS // 32
EPS = 2.0 ** -52
N = 5003                       # not a multiple of 4: a ragged last quad
CAPS = [1, 12, 32, 33, 4096, 4097]


def _ident(op, dt):
    if op == "sum":
        return dt.type(0)
    if dt.kind == "f":
        return dt.type(np.inf if op == "min" else -np.inf)
    info = np.iinfo(dt)
    return dt.type(info.max if op == "min" else info.min)


def _combine(op, a, b):
    """The kernel's combine(a, b): a wrapping sum, `b < a ? b : a`,
    `b > a ? b : a`."""
    if op == "sum":
        return a + b
    if op == "min":
        return np.where(b < a, b, a)
    return np.where(b > a, b, a)


def _warp_tree(op, x):
    """The xor-shuffle tree over 32 lanes (axis 0) → lane 0's value."""
    lane = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        x = _combine(op, x, x[lane ^ d])
    return x[0]


def k1_model(op, data, gids, cap, grid, out_dtype=None):
    """K1's result for `data` (int64, int32, float64 or bool) by int32
    `gids` over `grid` blocks, in the kernel's order of operations."""
    dt = np.dtype(out_dtype) if out_dtype is not None else (
        np.dtype(np.int64) if data.dtype == bool else data.dtype)
    vals = data.astype(dt)
    n = len(vals)
    ident = _ident(op, dt)
    ok = (gids >= 0) & (gids < cap)
    with np.errstate(over="ignore"):
        if cap > tseg.MID_CAP:
            out = np.full(cap, ident, dtype=dt)
            ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
            ufunc.at(out, gids[ok], vals[ok])
            return out
        partials = np.full((grid, cap), ident, dtype=dt)
        for b, (q0, q1) in enumerate(tseg.block_quads(n, grid)):
            if cap > tseg.SMALL_CAP:
                rows = np.arange(4 * q0, min(4 * max(q1, q0), n))
                keep = rows[ok[rows]]
                ufunc = {"sum": np.add, "min": np.minimum,
                         "max": np.maximum}[op]
                ufunc.at(partials[b], gids[keep], vals[keep])
                continue
            acc = np.full((THREADS, cap), ident, dtype=dt)
            t = np.arange(THREADS)
            for q in range(q0, q1, THREADS):
                qs = q + t
                for j in range(4):
                    r = 4 * qs + j
                    on = (qs < q1) & (r < n)
                    on[on] &= ok[r[on]]
                    tt, rr = t[on], r[on]
                    acc[tt, gids[rr]] = _combine(op, acc[tt, gids[rr]],
                                                 vals[rr])
            warp = [_warp_tree(op, acc[32 * w:32 * w + 32])
                    for w in range(WARPS)]
            part = warp[0]
            for w in range(1, WARPS):
                part = _combine(op, part, warp[w])
            partials[b] = part
        if cap > tseg.SMALL_CAP:
            out = np.full(cap, ident, dtype=dt)
            for b in range(grid):
                out = _combine(op, out, partials[b])
            return out
        lanes = np.full((32, cap), ident, dtype=dt)
        for lane in range(32):
            for b in range(lane, grid, 32):
                lanes[lane] = _combine(op, lanes[lane], partials[b])
        return _warp_tree(op, lanes)


def _inputs(dt, cap, seed):
    rng = np.random.default_rng(seed)
    gids = rng.integers(-1, cap + 1, N).astype(np.int32)
    if dt == np.float64:
        data = rng.normal(size=N) * 1e3
    elif dt == bool:
        data = rng.random(N) < 0.5
    else:
        bound = 10 ** 5 if dt == np.int32 else 10 ** 12
        data = rng.integers(-bound, bound, N).astype(dt)
    return data, gids


def _reference(op, data, gids, cap, out_dtype):
    """tidb_tpu.ops.segment under jax.numpy (imported here, so the card's
    tests can import the model without JAX)."""
    from tidb_tpu.ops import segment as jseg
    from tidb_tpu.ops.jax_env import jnp
    j = jnp.asarray
    if data.dtype == bool:
        if out_dtype == np.int64:
            return np.asarray(jseg.segment_count(jnp, j(data), j(gids), cap))
        return np.asarray(jseg.segment_max(jnp, j(data.astype(np.int32)),
                                           j(gids), cap))
    fn = {"sum": jseg.segment_sum, "min": jseg.segment_min,
          "max": jseg.segment_max}[op]
    return np.asarray(fn(jnp, j(data), j(gids), cap))


@pytest.mark.parametrize("grid", [1, 3, 40])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dt", [np.int64, np.int32])
@pytest.mark.parametrize("cap", CAPS)
def test_model_int_equals_reference(cap, dt, op, grid):
    data, gids = _inputs(dt, cap, cap + grid)
    got = k1_model(op, data, gids, cap, grid)
    want = _reference(op, data, gids, cap, None)
    np.testing.assert_array_equal(got, want.astype(dt))


@pytest.mark.parametrize("grid", [1, 7])
@pytest.mark.parametrize("cap", CAPS)
def test_model_bool_equals_reference(cap, grid):
    """A bool mask reduces natively: COUNT as int64 sums, ANY as int32
    maxima (segment_count / segment_any)."""
    data, gids = _inputs(bool, cap, 3 * cap + grid)
    got = k1_model("sum", data, gids, cap, grid, np.int64)
    np.testing.assert_array_equal(got, _reference("sum", data, gids, cap,
                                                  np.int64))
    got = k1_model("max", data, gids, cap, grid, np.int32)
    np.testing.assert_array_equal(got, _reference("max", data, gids, cap,
                                                  np.int32))


@pytest.mark.parametrize("grid", [1, 5, 33])
@pytest.mark.parametrize("cap", CAPS)
def test_model_f64_sum_within_bound(cap, grid):
    data, gids = _inputs(np.float64, cap, 7 * cap + grid)
    got = k1_model("sum", data, gids, cap, grid)
    want = _reference("sum", data, gids, cap, None)
    ok = (gids >= 0) & (gids < cap)
    cnt = np.bincount(gids[ok], minlength=cap)
    sabs = np.bincount(gids[ok], weights=np.abs(data[ok]), minlength=cap)
    tol = np.maximum(cnt - 1, 0) * EPS * sabs
    assert np.all(np.abs(got - want) <= tol)
    for op in ("min", "max"):
        np.testing.assert_array_equal(
            k1_model(op, data, gids, cap, grid),
            _reference(op, data, gids, cap, None))


def test_model_small_cap_sum_is_one_fixed_order():
    """The small path's f64 sum depends on (n, cap, grid) only: the same
    rows give the same bits, and another grid may give others."""
    data, gids = _inputs(np.float64, 12, 99)
    a = k1_model("sum", data, gids, 12, 9)
    b = k1_model("sum", data.copy(), gids.copy(), 12, 9)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 5003, 8_388_608])
@pytest.mark.parametrize("grid", [1, 2, 132, 528])
def test_block_quads_cover_every_quad_once(n, grid):
    nq = -(-n // 4)
    seen = np.zeros(nq, dtype=np.int64)
    for q0, q1 in tseg.block_quads(n, grid):
        if q1 > q0:
            seen[q0:q1] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("cap", [1, 12, 33])
def test_plain_version_takes_bool_natively(cap):
    """The wrapper's plain version (CPU tensors) reads a bool mask as the
    kernel does: counted in int64, maxed in int32."""
    data, gids = _inputs(bool, cap, cap)
    d, g = torch.from_numpy(data), torch.from_numpy(gids)
    got = tseg.segment_reduce("sum", d, g, cap)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), _reference("sum", data, gids, cap, np.int64))
    got = tseg.segment_reduce("max", d, g, cap, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  k1_model("max", data, gids, cap, 1,
                                           np.int32))
    np.testing.assert_array_equal(
        tseg.segment_count(TX, d, g, cap).numpy(),
        _reference("sum", data, gids, cap, np.int64))
    np.testing.assert_array_equal(
        tseg.segment_any(TX, d, g, cap).numpy(),
        _reference("max", data, gids, cap, np.int32) > 0)

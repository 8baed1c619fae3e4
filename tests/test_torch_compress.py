"""Port compressed-slab decode (chunk/compress.decode_slab on CPU
tensors: K2's plain torch version) against the JAX package's
decode_slab under jax.numpy: pack / dict / delta / width-0 layouts at
every packed width, int64 and int32, with NULLs and ragged tails.
Byte-exact: values on the valid slots, the mask everywhere. The host
encoder is the port's own copy, held byte-equal to the JAX package's."""

import numpy as np
import pytest
import torch

from tidb_tpu.chunk import compress as JC
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu_torch.chunk import compress as TC
from tidb_tpu_torch.executor.device_cache import _upload

CAP = 4096


def _case(kind, width, dt, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dt)
    mask = np.zeros(CAP, dtype=bool)
    mask[:n] = True
    if kind != "delta":
        mask[:n] &= rng.random(n) > 0.15            # NULLs
    if kind == "pack":
        ref = -777
        hi = (1 << width) - 1 if width else 0
        vals = (rng.integers(0, hi + 1, CAP) + ref).astype(dt)
        return TC.ColLayout("pack", width, ref, dt.name), \
            JC.ColLayout("pack", width, ref, dt.name), vals, mask, None
    if kind == "dict":
        card = min(1 << width, 600)
        dv = np.unique(rng.integers(-10 ** 5, 10 ** 5, 4 * card)
                       .astype(dt))[:card]
        vals = dv[rng.integers(0, len(dv), CAP)]
        return TC.ColLayout("dict", width, 0, dt.name, len(dv)), \
            JC.ColLayout("dict", width, 0, dt.name, len(dv)), vals, mask, dv
    gap = min((1 << width) - 1, 50)
    vals = (np.cumsum(rng.integers(0, gap + 1, CAP)) - 300).astype(dt)
    return TC.ColLayout("delta", width, 0, dt.name), \
        JC.ColLayout("delta", width, 0, dt.name), vals, mask, None


CASES = ([("pack", w) for w in (0, 1, 2, 4, 8, 16, 32)] +
         [("dict", w) for w in (1, 2, 4, 8, 16)] +
         [("delta", w) for w in (1, 2, 4, 8, 16, 32)])


@pytest.mark.parametrize("kind,width", CASES)
@pytest.mark.parametrize("dt", [np.int64, np.int32])
@pytest.mark.parametrize("n", [CAP, CAP - 37])
def test_decode_matches_jax(kind, width, dt, n):
    tlay, jlay, vals, mask, dv = _case(kind, width, dt, n, width * 7 + n)
    host = TC.pack_slab(tlay, vals, mask, dv)
    jhost = JC.pack_slab(jlay, vals, mask, dv)
    for a, b in zip(host, jhost):
        np.testing.assert_array_equal(a, b)     # encoder copy is exact
    extra = (dv,) if kind == "dict" else ()
    jv, jm = JC.decode_slab(jlay, tuple(jnp.asarray(a) for a in
                                        jhost + extra), CAP, jnp)
    slab = tuple(_upload(a, torch.device("cpu")) for a in host + extra)
    tv, tm = TC.decode_slab_torch(tlay, slab, CAP)
    jv, jm = np.asarray(jv), np.asarray(jm)
    tv, tm = tv.numpy(), tm.numpy()
    assert tv.dtype == jv.dtype == np.dtype(dt)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv[tm], jv[jm])


def test_words_travel_as_int32_bits():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     dtype=np.uint32)
    t = _upload(words, torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), words)


def test_numpy_decode_is_the_jax_packages():
    tlay, jlay, vals, mask, _ = _case("delta", 4, np.int64, CAP - 5, 1)
    host = TC.pack_slab(tlay, vals, mask)
    tv, tm = TC.decode_slab(tlay, host, CAP, np)
    jv, jm = JC.decode_slab(jlay, host, CAP, np)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv[tm], jv[jm])


def test_decode_slabs_equals_per_column_and_jax():
    """One decode_slabs_torch call over mixed layouts (every kind and
    width, both dtypes: 36 columns, more than one K2 launch holds) on CPU
    tensors equals decode_slab_torch a column and the JAX decode, in
    every slot."""
    items, jitems = [], []
    for i, ((kind, width), dt) in enumerate(
            (c, dt) for c in CASES for dt in (np.int64, np.int32)):
        tlay, jlay, vals, mask, dv = _case(kind, width, dt, CAP - 3, i)
        host = TC.pack_slab(tlay, vals, mask, dv) + \
            ((dv,) if kind == "dict" else ())
        items.append((tlay, tuple(_upload(a, torch.device("cpu"))
                                  for a in host)))
        jitems.append((jlay, tuple(jnp.asarray(a) for a in host)))
    assert len(items) > TC.K2_MAX_COLS
    got = TC.decode_slabs_torch(items, CAP)
    for (tlay, slab), (jlay, jslab), (gv, gm) in zip(items, jitems, got):
        ov, om = TC.decode_slab_torch(tlay, slab, CAP)
        jv, jm = JC.decode_slab(jlay, jslab, CAP, jnp)
        assert torch.equal(gv, ov) and torch.equal(gm, om)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))

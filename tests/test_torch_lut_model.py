"""A numpy model of K21 dict_lut's mapping of rows to threads
(csrc/dict_lut.cu) against the reference's gathers under jax.numpy.

The model runs the kernel's grid thread by thread from the wrapper's
row plan (`ops/dict_lut.lut_plan`): the scalar rows before the codes'
first 16-byte boundary (`head`, a codes view 1-3 entries off), warp
steps of 512 rows (bool tables) or 128 (int32/int64 tables) in a
grid-stride loop over warps, each lane's groups of 16 / table-bytes rows
read from aligned codes and stored with one 16-byte store (the output
placed `pad` entries into its allocation), and the scalar rows after
the last whole step (`tail`). Every row must be
written exactly once, and the values must equal `jnp.take(table,
codes.astype(int32), mode="clip")` (the string functions', LIKE's and
REGEXP's gather) and the fill-mode remap of the reference's
`KeyRemap.eval` (tidb_tpu/executor/tree_fragment.py), for bool, int32
and int64 tables and int32/int64 codes. The regime choice is held at the
shared-memory limit: the last table that fits is staged, one entry more
is gathered through L2, and the limit is the kernel source's own
SMEM_MAX. The card test `test_k21_views_lengths_and_limit`
(tests/test_torch_cuda.py) runs the kernel at the same edges."""

import os
import re

import numpy as np
import pytest
import torch

import tidb_tpu.ops.jax_env  # noqa: F401 — x64 before jax is used
from tidb_tpu.ops.jax_env import jnp
from tidb_tpu_torch.ops import dict_lut as DL

THREADS = 1024                 # csrc/dict_lut.cu THREADS
DTYPES = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64}
CODES = {torch.int32: np.int32, torch.int64: np.int64}


def _table(rng, dtype, n_lut):
    if dtype == torch.bool:
        return rng.random(n_lut) < 0.4
    return rng.integers(-(1 << 40), 1 << 40, n_lut).astype(DTYPES[dtype])


def _lookup(table, c, fill_mode, fill):
    """The kernel's lookup of codes `c` (clip or fill mode; an int64 code
    narrowed to 32 bits first: below 0 → -1, above 2^31 - 1 → 2^31 - 1)."""
    n_lut = len(table)
    c = np.clip(np.asarray(c, dtype=np.int64), -1, (1 << 31) - 1)
    if fill_mode:
        inside = (c >= 0) & (c < n_lut)
        return np.where(inside, table[np.where(inside, c, 0)],
                        table.dtype.type(fill))
    return table[np.clip(c, 0, n_lut - 1)]


def k21_model(table, codes, phase, fill_mode, fill, grid):
    """The kernel's grid over `codes` (whose first entry lies `phase`
    bytes past a 16-byte boundary) → (out, write count a row). Asserts
    that every group's codes are read from an address aligned to their
    size (16 bytes, 8 for two int32 codes) and its values stored at a
    16-byte aligned one."""
    n = len(codes)
    cb, lb = codes.dtype.itemsize, table.dtype.itemsize
    plan = DL.lut_plan(phase, cb, lb, n)
    rg = 16 // lb                          # rows of one 16-byte store
    groups = plan.rows // (32 * rg)        # a lane's stores a step
    out = np.zeros(n, dtype=table.dtype)
    writes = np.zeros(n, dtype=np.int64)
    warps = grid * THREADS // 32
    # only the threads with a row to do (the others find none)
    for g in range(min(grid * THREADS,
                       max(plan.head, plan.tail, 32 * plan.steps))):
        if g < plan.head:
            out[g] = _lookup(table, codes[g], fill_mode, fill)
            writes[g] += 1
        if g < plan.tail:
            r = plan.head + plan.steps * plan.rows + g
            out[r] = _lookup(table, codes[r], fill_mode, fill)
            writes[r] += 1
        lane = g % 32
        for k in range(g // 32, plan.steps, warps):
            for j in range(groups):
                r0 = plan.head + k * plan.rows + j * 32 * rg + lane * rg
                assert (phase + r0 * cb) % min(16, rg * cb) == 0
                assert ((plan.pad + r0) * lb) % 16 == 0
                rows = slice(r0, r0 + rg)
                out[rows] = _lookup(table, codes[rows], fill_mode, fill)
                writes[rows] += 1
    return out, writes


def _codes(rng, n, n_lut, code_dtype):
    body = rng.integers(-3, n_lut + 3, n)
    special = np.array([0, -1, n_lut, (1 << 31) - 1, -(1 << 31),
                        max(n_lut - 1, 0)])
    body[:min(n, len(special))] = special[:n]
    return body.astype(CODES[code_dtype])


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
def test_k21_model_matches_reference(dtype, code_dtype):
    """Views 0-3 entries off their 16-byte boundary, n = 1-17 and a
    length past one block's warp steps with a ragged tail (the first
    warps take a second step): every row once, values equal to
    jnp.take(..., mode="clip") and to KeyRemap's remap."""
    rng = np.random.default_rng(21)
    cb = np.dtype(CODES[code_dtype]).itemsize
    for n_lut in (1, 7, 300):
        table = _table(rng, dtype, n_lut)
        jt = jnp.asarray(table)
        big = 35 * DL.step_rows(np.dtype(DTYPES[dtype]).itemsize) + 5
        base = _codes(rng, big + 3, n_lut, code_dtype)
        jb = jnp.asarray(base)
        jc = jb.astype(jnp.int32)
        want = np.asarray(jnp.take(jt, jc, mode="clip"))
        fill_want = np.asarray(jnp.where(
            (jb >= 0) & (jb < n_lut), jnp.take(jt, jnp.clip(jc, 0, n_lut - 1)),
            jnp.asarray(-1).astype(jt.dtype)))
        for off in range(16 // cb):
            for n in list(range(1, 18)) + ([big] if n_lut == 300 else []):
                codes = base[off:off + n]
                got, writes = k21_model(table, codes, off * cb, False, -1, 1)
                assert (writes == 1).all()
                np.testing.assert_array_equal(got, want[off:off + n])
                got, writes = k21_model(table, codes, off * cb, True,
                                        table.dtype.type(-1), 1)
                assert (writes == 1).all()
                np.testing.assert_array_equal(got, fill_want[off:off + n])


@pytest.mark.parametrize("lut_bytes", [1, 4, 8])
@pytest.mark.parametrize("code_bytes", [4, 8])
def test_k21_plan_places_every_row_once(code_bytes, lut_bytes):
    """`lut_plan` over every phase, n around one and two warp steps and
    both modes: head rows up to the codes' boundary, whole steps (512 rows
    for a bool table, 128 otherwise), a tail shorter than a step, an
    output pad that puts row `head` on a 16-byte boundary, and the flags
    word the C entry unpacks."""
    rows = DL.step_rows(lut_bytes)
    assert rows == {1: 512, 4: 128, 8: 128}[lut_bytes]
    for phase in range(0, 16, code_bytes):
        for n in list(range(20)) + [rows - 1, rows, rows + 3, 2 * rows + 17]:
            for mode in (0, 1):
                p = DL.lut_plan(phase, code_bytes, lut_bytes, n, mode)
                assert p.rows == rows
                assert p.head + p.steps * p.rows + p.tail == n
                assert 0 <= p.tail < p.rows
                assert p.head * code_bytes < 16
                if p.steps:
                    assert (phase + p.head * code_bytes) % 16 == 0
                    assert ((p.pad + p.head) * lut_bytes) % 16 == 0
                assert 0 <= p.pad < 16 // lut_bytes
                f = p.flags
                assert (f & 15, f >> 4 & 15, f >> 8 & 1, f >> 9 & 7,
                        f >> 12 & 15) == (code_bytes, lut_bytes, mode, 0,
                                          p.head)


def test_k21_regime_at_the_shared_memory_limit():
    """The last table that fits SMEM_BYTES is staged, one entry more is
    gathered through L2, for every table width; SMEM_BYTES is the kernel
    source's SMEM_MAX; the modelled values stay equal to jnp.take on both
    sides of the limit."""
    src = os.path.join(os.path.dirname(DL.__file__), "..", "csrc",
                       "dict_lut.cu")
    with open(src) as f:
        m = re.search(r"SMEM_MAX = (\d+) \* 1024;", f.read())
    assert m and int(m.group(1)) * 1024 == DL.SMEM_BYTES
    rng = np.random.default_rng(5)
    for dtype, lb in ((torch.bool, 1), (torch.int32, 4), (torch.int64, 8)):
        edge = DL.SMEM_BYTES // lb
        assert DL.in_shared_memory(edge, lb)
        assert not DL.in_shared_memory(edge + 1, lb)
        for n_lut in (edge, edge + 1):
            table = _table(rng, dtype, n_lut)
            codes = _codes(rng, 257, n_lut, torch.int32)
            got, writes = k21_model(table, codes, 4, False, -1, 1)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, np.asarray(jnp.take(
                jnp.asarray(table), jnp.asarray(codes), mode="clip")))


def test_k21_plain_over_views_matches_the_model():
    """dict_lut (its plain version on CPU tensors) over codes views 1-3
    entries off equals the model's output."""
    rng = np.random.default_rng(7)
    table = _table(rng, torch.int64, 50)
    base = _codes(rng, 200, 50, torch.int32)
    for off in (1, 2, 3):
        view = torch.from_numpy(base)[off:off + 101]
        got = DL.dict_lut(torch.from_numpy(table), view)
        want, _ = k21_model(table, base[off:off + 101], 4 * off, False, -1,
                            1)
        np.testing.assert_array_equal(got.numpy(), want)

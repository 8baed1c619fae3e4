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


# ---------------------------------------------------------------------------
# K4 lut_build (csrc/lut_join.cu `lut_build_kernel`)
# ---------------------------------------------------------------------------

K4_THREADS = 256               # csrc/lut_join.cu THREADS
K4_ROUNDS = 4                  # BUILD_ROUNDS: rows a lane a warp step
K4_BOUNDS = {1: [(0, 99)], 2: [(0, 49), (-3, 6)],
             3: [(0, 9), (5, 14), (-2, 7)],
             4: [(0, 4), (0, 4), (1, 5), (0, 3)]}


def k4_model(keys, bounds, domain, live, n_live, grid):
    """K4's grid over `keys` [(values, mask)] → (cnt, lut, maxcnt, codes,
    row visits, the codes each round's 32 atomics touch). Warps take
    steps of 128 consecutive rows in a grid-stride loop over warps, lane l
    the rows 32 j + l of a step (j < 4; rows past nb idle); a row not
    live, NULL, out of bounds or at or past n_live goes to the sentinel,
    counted once a block from the threads' own counts, and the largest
    count once a block likewise."""
    nb = len(keys[0][0]) if keys else 0
    strides = np.cumprod([1] + [hi - lo + 1 for lo, hi in bounds[:-1]])
    cnt = np.zeros(domain + 1, dtype=np.int64)
    lut = np.full(domain + 1, -1, dtype=np.int64)
    codes = np.zeros(nb, dtype=np.int64)
    visits = np.zeros(nb, dtype=np.int64)
    rounds = []

    def pack(i):
        ok = live is None or bool(live[i])
        code = 0
        for (v, m), (lo, hi), st in zip(keys, bounds, strides):
            x = int(v[i])
            ok = ok and bool(m[i]) and lo <= x <= hi
            code += (min(max(x, lo), hi) - lo) * int(st)
        return ok and i < n_live, code

    step = 32 * K4_ROUNDS
    warps = grid * K4_THREADS // 32
    maxcnt = 0
    for b in range(grid):
        block_sent, block_max = 0, 0
        for warp in range(K4_THREADS // 32):
            sent = np.zeros(32, dtype=np.int64)
            most = np.zeros(32, dtype=np.int64)
            w = b * (K4_THREADS // 32) + warp
            while w * step < nb:
                for j in range(K4_ROUNDS):
                    touched = []
                    for lane in range(32):
                        i = w * step + 32 * j + lane
                        if i >= nb:
                            continue
                        visits[i] += 1
                        ok, code = pack(i)
                        if ok:
                            cnt[code] += 1
                            most[lane] = max(most[lane], cnt[code])
                            lut[code] = i
                            codes[i] = code
                            touched.append(code)
                        else:
                            sent[lane] += 1
                            codes[i] = domain
                    rounds.append(touched)
                w += warps
            block_sent += int(sent.sum())
            block_max = max(block_max, int(most.max()))
        cnt[domain] += block_sent
        maxcnt = max(maxcnt, block_max)
    return cnt, lut, maxcnt, codes, visits, rounds


def _k4_keys(rng, nb, bounds, unique):
    if unique:                  # every code at most once
        dom = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
        cells = rng.permutation(dom)[:nb]
        out = []
        for lo, hi in bounds:
            out.append((cells % (hi - lo + 1) + lo, np.ones(len(cells),
                                                            dtype=bool)))
            cells = cells // (hi - lo + 1)
        return out
    return [(rng.integers(lo - 2, hi + 3, nb), rng.random(nb) > 0.1)
            for lo, hi in bounds]


def _k4_reference(keys, bounds, domain, row_ok):
    """The reference's counts and lut: pack_bounded_codes, then
    lut_probe_multi's count and lut_probe_unique's match over every code
    of the domain (tidb_tpu/ops/join.py:65,93,114)."""
    from tidb_tpu.ops import join as JJ
    jkeys = [(jnp.asarray(v), jnp.asarray(m)) for v, m in keys]
    codes, ok = JJ.pack_bounded_codes(jkeys, bounds)
    ok = ok & jnp.asarray(row_ok)
    every = jnp.arange(domain, dtype=jnp.int64)
    ones = jnp.ones(domain, dtype=bool)
    _start, count, _order = JJ.lut_probe_multi(codes, ok, domain, every,
                                               ones)
    idx, matched, unique = JJ.lut_probe_unique(codes, ok, domain, every,
                                               ones)
    return (np.asarray(codes), np.asarray(ok), np.asarray(count),
            np.asarray(idx), np.asarray(matched), bool(unique))


@pytest.mark.parametrize("nb", [0, 1, 3, 4, 5, 127, 129, 1023, 1025, 4099])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_k4_model_matches_reference(k, nb):
    """The model over 1-4 int32/int64 keys, live masks random or all dead
    or absent, an n_live prefix, duplicated and unique codes, nb at the
    warp step's edges, one block and three, against the reference: every
    row visited once, cnt (its sentinel the rows not counted), maxcnt
    (unique iff <= 1), the codes, and lut where a code has one row (a
    duplicated code's entry one of its rows); and the wrapper's plain
    version over views 0-3 elements off their start against both."""
    from tidb_tpu_torch.ops import join as TJ
    rng = np.random.default_rng(10 * k + nb)
    bounds = K4_BOUNDS[k]
    domain = int(np.prod([hi - lo + 1 for lo, hi in bounds]))
    for unique in (False, True):
        if unique and nb > domain:
            continue
        keys = _k4_keys(rng, nb, bounds, unique)
        keys = [(v.astype(np.int32 if q % 2 else np.int64), m)
                for q, (v, m) in enumerate(keys)]
        for live_kind, n_live in (("random", nb), ("dead", nb),
                                  (None, nb // 2), ("random", nb // 3)):
            live = None if live_kind is None else (
                rng.random(nb) > 0.2 if live_kind == "random"
                else np.zeros(nb, dtype=bool))
            for grid in (1, 3):
                cnt, lut, maxcnt, codes, visits, _ = k4_model(
                    keys, bounds, domain, live, n_live, grid)
                assert (visits == 1).all()
                row_ok = (np.ones(nb, dtype=bool) if live is None
                          else live) & (np.arange(nb) < n_live)
                rc, rok, count, idx, matched, runique = _k4_reference(
                    keys, bounds, domain, row_ok)
                np.testing.assert_array_equal(cnt[:domain], count)
                assert cnt[domain] == nb - int(count.sum())
                assert (maxcnt <= 1) == runique
                assert maxcnt == (int(count.max()) if domain else 0)
                np.testing.assert_array_equal(
                    codes, np.where(rok, rc, domain))
                single = count == 1
                np.testing.assert_array_equal(lut[:domain][single],
                                              idx[single])
                assert (matched == (count > 0)).all()
                dup = np.nonzero(count > 1)[0]
                np.testing.assert_array_equal(codes[lut[dup]], dup)
            off = nb % 4
            views = []
            for v, m in keys:
                vv = torch.from_numpy(np.concatenate([v[:off], v]))[off:]
                mm = torch.from_numpy(np.concatenate([m[:off], m]))[off:]
                views.append((vv, mm))
            plain = TJ.lut_build_plain(
                views, bounds, domain,
                None if live is None else torch.from_numpy(live),
                None if n_live == nb else n_live, want_codes=True)
            np.testing.assert_array_equal(plain[0].numpy(), cnt)
            assert int(plain[2]) == maxcnt
            np.testing.assert_array_equal(plain[3].numpy(), codes)
            np.testing.assert_array_equal(plain[1].numpy()[:domain][single],
                                          idx[single])


def test_k4_model_rounds_are_coalesced():
    """Each round of a warp step is 32 consecutive rows, so a dense
    primary key (the orders build: code = row) puts its 32 atomics on 32
    consecutive codes, 128 bytes of cnt; a lane's four consecutive rows
    (K5's mapping) would spread them over 512."""
    nb = 4096
    keys = [(np.arange(nb, dtype=np.int64), np.ones(nb, dtype=bool))]
    *_, rounds = k4_model(keys, [(0, nb - 1)], nb, None, nb, 2)
    assert len(rounds) == nb // 32
    for touched in rounds:
        assert touched == list(range(touched[0], touched[0] + 32))


def test_k4_build_layout_places_every_output():
    """`build_layout` (the wrapper's views of the one allocation) is the
    kernel entry's: maxcnt at word 0, cnt from word 1, lut right after
    cnt, codes right after the last table, for each choice of outputs."""
    from tidb_tpu_torch.ops import join as TJ
    for domain in (1, 2, 3, 4, 5, 1_500_303):
        for want_lut in (False, True):
            for want_codes in (False, True):
                lut, codes, words = TJ.build_layout(domain, 77, want_lut,
                                                    want_codes)
                tables = 1 + want_lut
                assert lut == (domain + 2 if want_lut else -1)
                assert codes == (1 + tables * (domain + 1) if want_codes
                                 else -1)
                assert words == 1 + tables * (domain + 1) + \
                    (77 if want_codes else 0)

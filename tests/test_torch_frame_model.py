"""A numpy model of K14 frame_bounds' RANGE searches (csrc/window_frame.cu
`range_bounds`, modelled by `tools/frame_model.frame_search_model`) held
to the JAX package's `range_frame_bounds(np, ...)`.

The kernel's three searches: (a) the reference's binary search stopped
once its interval is empty, under the reference's cap of bit_length(n -
1) rounds; (b) a row's two searches in one loop; (c) with the caller's
`sorted_key` and an int32 key, the warp's lanes of one (partition,
target) sharing one 33-ary search, and a 0 offset taking the peer edge,
except in a partition that spans all n = 2^k rows, where the reference's
rounds stop one short (ROADMAP F4) and (a) + (b) keep its answer. Cases:
F4's n = 8 and 16 single partitions, partitions of 1 row, negative
offsets, ASC and DESC with NULLs, CURRENT ROW on either side, unsorted
int32 keys without `sorted_key`; int64 keys with INT64_MIN under DESC and
keys beyond ±(INT64_MAX // 2) beside NULLs; float64 keys with NaN."""

import numpy as np
import pytest
import torch

from tidb_tpu.ops import jax_env  # noqa: F401  (x64 before jax.numpy)
from tidb_tpu.ops import window as JW
from tidb_tpu_torch.ops import window as W
from tidb_tpu_torch.tools import frame_model as FM

HALF = np.iinfo(np.int64).max // 2
I64 = np.iinfo(np.int64)
#: (pre, post) offsets of the RANGE frames run over every layout
FRAMES = [(6, 0), (0, 6), (None, 3), (2, None), (0, 0), (-1, 5), (3, 2),
          (5, -2), (0, None), (None, 0)]


def _flags(pid, key, valid):
    """pstart where the partition changes, peerstart also where the key
    (NULLs neutralized) changes."""
    n = len(pid)
    pstart = np.ones(n, dtype=bool)
    pstart[1:] = pid[1:] != pid[:-1]
    v = np.where(valid, key, 0)
    peer = pstart.copy()
    same = (v[1:] == v[:-1]) | (np.isnan(v[1:]) & np.isnan(v[:-1])) \
        if v.dtype.kind == "f" else v[1:] == v[:-1]
    peer[1:] |= ~same | (valid[1:] != valid[:-1])
    return pstart, peer


def _sorted_layout(pid, key, valid, desc: bool):
    """Rows sorted by partition, then by key in its direction with NULLs
    first (ASC) or last (DESC), as the window layout sorts them."""
    null_rank = np.where(valid, 1, 0) if not desc else np.where(valid, 0, 1)
    kk = np.where(valid, key, 0)
    if kk.dtype.kind == "f":
        kk = np.where(np.isnan(kk), np.inf, kk)
    order = np.lexsort((-kk if desc else kk, null_rank, pid)) if \
        kk.dtype.kind == "f" else np.lexsort(
            (np.where(valid, ~key if desc else key, 0), null_rank, pid))
    return pid[order], key[order], valid[order]


def _partitions(rng, n, big):
    """One partition of `big` rows, the rest of 1 to 50 rows."""
    rest = rng.choice([1, 1, 2, 7, 30, 50], n)
    cut = np.searchsorted(np.cumsum(rest), n - big)
    sizes = np.concatenate([[big], rest[:cut], [n - big - rest[:cut].sum()]])
    return np.repeat(np.arange(len(sizes)), sizes)


def _m_space(key, valid, desc):
    if key.dtype.kind == "f":
        m = -key if desc else key.copy()
        return np.where(valid, m, np.inf if desc else -np.inf)
    m = key.astype(np.int64)
    with np.errstate(over="ignore"):
        m = -m if desc else m
    return np.where(valid, m, HALF if desc else -HALF)


def _check(pid, key, valid, desc, frames, sorted_key):
    """The model (warp path where the kernel takes it) and the port's
    plain version against the reference, every frame."""
    pstart, peer = _flags(pid, key, valid)
    pos = W.window_positions_plain(torch.from_numpy(pstart),
                                   torch.from_numpy(peer))
    pp, pl, plo, phi = (t.numpy() for t in pos[:4])
    m = _m_space(key, valid, desc)
    warp_path = sorted_key and key.dtype == np.int32
    is_f = key.dtype.kind == "f"
    okey = key if is_f else key.astype(np.int64)
    rounds = []
    for pre, post in frames:
        want = JW.range_frame_bounds(np, pstart, peer, okey, valid, desc,
                                     pre, post)
        cast = (lambda o: None if o is None else (float(o) if is_f
                                                  else int(o)))
        lo, hi, r = FM.frame_search_model(pp, pl, plo, phi, m, valid,
                                          cast(pre), cast(post), warp_path)
        assert np.array_equal(lo, want[0]), (pre, post, np.flatnonzero(
            lo != want[0])[:5])
        assert np.array_equal(hi, want[1]), (pre, post, np.flatnonzero(
            hi != want[1])[:5])
        got = W.frame_bounds(pos, pre, post, (torch.from_numpy(key),
                                              torch.from_numpy(valid), desc),
                             sorted_key=sorted_key)
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
        rounds.append(r)
    return rounds


@pytest.mark.parametrize("n", [8, 16])
def test_f4_whole_power_of_two_partition(n):
    """ROADMAP F4: one partition of all n = 2^k rows, keys [0, 10, 10,
    ...], RANGE 5 PRECEDING: the reference's bit_length(n - 1) rounds stop
    one short and give lo[1] = 0 where the first key >= 5 is at 1. The
    kernel keeps the reference's answer with `sorted_key` on."""
    pid = np.zeros(n, dtype=np.int64)
    key = np.array([0] + [10] * (n - 1), dtype=np.int32)
    valid = np.ones(n, dtype=bool)
    pstart, peer = _flags(pid, key, valid)
    want = JW.range_frame_bounds(np, pstart, peer, key.astype(np.int64),
                                 valid, False, 5, 0)
    assert want[0][1] == 0
    _check(pid, key, valid, False, [(5, 0), (5, None), (5, 2)], True)
    # the shared search alone finds the first key >= 5: the guard matters
    pos = W.window_positions_plain(torch.from_numpy(pstart),
                                   torch.from_numpy(peer))
    rows = np.array([1])
    m = key.astype(np.int64)
    ans, _r = FM.warp_first_model(m, rows, pos.ppos.numpy()[rows],
                                  pos.plast.numpy()[rows], m[rows] - 5,
                                  False)
    assert ans[0] == 1
    # one row fewer: no longer whole, the warp path's answer is the
    # reference's
    _check(pid[1:], key[1:], valid[1:], False, [(5, 0)], True)


@pytest.mark.parametrize("desc", [False, True])
def test_int32_sorted_warp_path(desc):
    """An int32 key (dates with ties, 10% NULLs) sorted as the window
    layout sorts it: one 1,500-row partition, partitions of 1 to 50 rows,
    every frame; the warp path's rounds stay far below the reference's
    two searches of bit_length(n - 1) rounds."""
    rng = np.random.default_rng(7 + desc)
    n = 3000
    pid = _partitions(rng, n, 1500)
    key = rng.integers(8036, 8100, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    pid, key, valid = _sorted_layout(pid, key, valid, desc)
    rounds = _check(pid, key, valid, desc, FRAMES, True)
    searched = np.concatenate([r[r > 0] for r in rounds])
    assert searched.mean() < (n - 1).bit_length()


def test_int32_sorted_whole_power_of_two():
    """A sorted int32 key over one partition of all 2,048 rows: every row
    keeps the reference's capped search (F4), in both directions."""
    rng = np.random.default_rng(11)
    n = 2048
    for desc in (False, True):
        pid = np.zeros(n, dtype=np.int64)
        key = rng.integers(0, 40, n).astype(np.int32)
        valid = rng.random(n) > 0.05
        _check(*_sorted_layout(pid, key, valid, desc), desc, FRAMES, True)


def test_int32_unsorted_keeps_the_full_search():
    """Unsorted int32 keys (the reference's search over them is defined by
    its probe path alone) with `sorted_key` off."""
    rng = np.random.default_rng(13)
    n = 2000
    pid = np.sort(_partitions(rng, n, 900))
    key = rng.integers(-50, 50, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    for desc in (False, True):
        _check(pid, key, valid, desc, FRAMES, False)


def test_single_row_partitions():
    rng = np.random.default_rng(17)
    n = 300
    pid = np.arange(n)
    key = rng.integers(0, 9, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    for desc in (False, True):
        _check(pid, key, valid, desc, FRAMES, True)


def test_int64_extremes_beside_nulls():
    """int64 keys: INT64_MIN (its negation wraps under DESC) and keys
    beyond ±(INT64_MAX // 2), the NULL sentinels, beside NULLs; sorted
    and unsorted, `sorted_key` on and off (an int64 key never takes the
    warp path)."""
    rng = np.random.default_rng(19)
    n = 1500
    pid = _partitions(rng, n, 700)
    key = rng.integers(-1000, 1000, n).astype(np.int64)
    pick = rng.random(n) < 0.1
    key[pick] = rng.choice(np.array([I64.min, I64.min + 1, -HALF - 1, -HALF,
                                     HALF, HALF + 1, I64.max]), pick.sum())
    valid = rng.random(n) > 0.1
    for desc in (False, True):
        for sk in (False, True):
            _check(*_sorted_layout(pid, key, valid, desc), desc, FRAMES, sk)
            _check(np.sort(pid), key, valid, desc, FRAMES, sk)


def test_float64_with_nan():
    rng = np.random.default_rng(23)
    n = 1500
    pid = _partitions(rng, n, 700)
    key = np.round(rng.normal(size=n) * 10, 1)
    key[rng.random(n) < 0.05] = np.nan
    key[rng.random(n) < 0.02] = -0.0
    valid = rng.random(n) > 0.1
    frames = [(2.5, 0.5), (0, 0), (None, 1.5), (1.0, None), (-1.0, 3.0)]
    for desc in (False, True):
        for sk in (False, True):
            _check(*_sorted_layout(pid, key, valid, desc), desc, frames, sk)
            _check(np.sort(pid), key, valid, desc, frames, sk)


def test_window_layout_keeps_the_promise(monkeypatch):
    """Every `sorted_key=True` call that a window layout makes passes a
    key that does not decrease within its partitions in m-space, with the
    peers its runs of equal keys (peer_lo their first row, peer_hi their
    last): the device fragment's layout (device_emit._window_value) and
    the Window operator's over a host operator (WindowExec._one_device),
    on CPU tensors, ASC and DESC."""
    from tidb_tpu_torch.executor import window as WX
    from tidb_tpu_torch.session import Engine
    seen = []
    in_exec = [False]
    orig = W.frame_bounds
    orig_exec = WX.WindowExec._one_device

    def spy(pos, pre, post, range_key=None, sorted_key=False):
        if sorted_key and range_key is not None:
            key, valid, desc = (t.numpy() if isinstance(t, torch.Tensor)
                                else t for t in range_key)
            m = _m_space(key, valid, desc)
            n = len(m)
            pp = pos.ppos.numpy()
            same_part = pp[1:] == pp[:-1]
            assert (m[1:][same_part] >= m[:-1][same_part]).all()
            run = np.ones(n, dtype=bool)
            run[1:] = ~same_part | (m[1:] != m[:-1])
            first = np.maximum.accumulate(np.where(run, np.arange(n), 0))
            end = np.ones(n, dtype=bool)
            end[:-1] = run[1:]
            last = np.minimum.accumulate(
                np.where(end, np.arange(n), n)[::-1])[::-1]
            assert np.array_equal(pos.peer_lo.numpy()[valid], first[valid])
            assert np.array_equal(pos.peer_hi.numpy()[valid], last[valid])
            seen.append((bool(desc), in_exec[0]))
        return orig(pos, pre, post, range_key, sorted_key)

    def exec_spy(self, *a, **k):
        in_exec[0] = True
        try:
            return orig_exec(self, *a, **k)
        finally:
            in_exec[0] = False

    monkeypatch.setattr(W, "frame_bounds", spy)
    monkeypatch.setattr(WX.WindowExec, "_one_device", exec_spy)
    s = Engine(device="cpu").new_session()
    s.execute("CREATE TABLE fr (p INT, d DATE, q BIGINT)")
    rng = np.random.default_rng(29)
    rows = []
    for _ in range(600):
        d = "NULL" if rng.random() < 0.1 else \
            f"'1998-0{int(rng.integers(1, 4))}-1{int(rng.integers(0, 9))}'"
        rows.append(f"({int(rng.integers(0, 4))}, {d}, "
                    f"{int(rng.integers(0, 9))})")
    s.execute("INSERT INTO fr VALUES " + ",".join(rows))
    s.vars.update({"tidb_tpu_engine": "on", "tidb_tpu_row_threshold": 1,
                   "tidb_tpu_strict": 1})
    for order in ("d", "d DESC"):
        frame = (f"OVER (PARTITION BY p ORDER BY {order} RANGE BETWEEN 6 "
                 f"PRECEDING AND CURRENT ROW)")
        s.query(f"SELECT p, d, SUM(q) {frame} FROM fr WHERE q > 1")
        # over an aggregate's rows: the Window operator's device route
        s.query(f"SELECT p, d, sq, SUM(sq) {frame} FROM (SELECT p, d, "
                f"SUM(q) AS sq FROM fr GROUP BY p, d) t")
    assert set(seen) == {(False, False), (True, False), (False, True),
                         (True, True)}

"""A host (numpy) model of K14 frame_bounds' RANGE searches, as
csrc/window_frame.cu `range_bounds` runs them: each row's answer and the
probe rounds it took. No production code calls it: the tests hold it to
the JAX package's `range_frame_bounds`, and chip_smoke holds it to the
kernel on the card and logs its rounds.
"""

from __future__ import annotations

import numpy as np

#: rows of one warp of K14's range kernel
WARP = 32


def warp_first_model(m, rows, pp, pl, t, strict: bool):
    """csrc/window_frame.cu `warp_first` over numpy: the wanting rows
    `rows` grouped by (warp, partition, target), each group's 33-ary
    search → (each row's first hit, each row's group's rounds)."""
    order = np.lexsort((t, pp, rows // WARP))
    w, ppo, to = rows[order] // WARP, pp[order], t[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = (w[1:] != w[:-1]) | (ppo[1:] != ppo[:-1]) | (to[1:] != to[:-1])
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.cumsum(new) - 1
    first = order[new]
    a, b, gt = pp[first].copy(), pl[first] + 1, t[first]
    rounds = np.zeros(len(a), dtype=np.int64)
    lanes = np.arange(WARP, dtype=np.int64)

    def hits(v, tt):
        return v > tt if strict else v >= tt

    while True:
        act = np.flatnonzero(b - a > WARP)
        if act.size == 0:
            break
        ai, ln = a[act], b[act] - a[act]
        q = ai[:, None] + (lanes + 1)[None, :] * ln[:, None] // 33
        h = hits(m[q], gt[act][:, None])
        anyh, f = h.any(axis=1), h.argmax(axis=1)
        b[act] = np.where(anyh, ai + (f + 1) * ln // 33, b[act])
        a[act] = np.where(anyh, np.where(f > 0, ai + f * ln // 33 + 1, ai),
                          ai + 32 * ln // 33 + 1)
        rounds[act] += 1
    q = a[:, None] + lanes[None, :]
    h = (q < b[:, None]) & hits(m[np.minimum(q, len(m) - 1)], gt[:, None])
    ans = np.where(h.any(axis=1), a + h.argmax(axis=1), b)
    return ans[inv], rounds[inv] + 1


def frame_search_model(ppos, plast, peer_lo, peer_hi, m, valid, pre, post,
                       warp_path: bool):
    """A host (numpy) model of K14's RANGE searches as csrc/window_frame.cu
    `range_bounds` runs them → (lo, hi, rounds), each int64 per row.

    `m` is the ORDER BY key in m-space (int64 or float64, DESC negated,
    NULLs at their sentinels), `valid` its validity, `pre` / `post` the
    offsets in m's dtype (None: unbounded), `warp_path` the kernel's
    `sorted` for an int32 key. NULL rows take their peer block on a
    bounded side. With `warp_path`, a valid row outside a partition that
    spans all n = 2^k rows takes the peer edge for a 0 offset and the
    warp's shared 33-ary search for any other; every other valid row runs
    the reference's two binary searches in one loop, stopped once both
    intervals are empty, under the reference's cap of bit_length(n - 1)
    rounds. `rounds` is each row's probe rounds: its group's rounds on
    each side (a warp runs its groups one after the other), or its loop's
    rounds; 0 where no search ran."""
    n = ppos.shape[0]
    lo = np.where((pre is not None) & ~valid, peer_lo, ppos)
    hi = np.where((post is not None) & ~valid, peer_hi, plast)
    rounds = np.zeros(n, dtype=np.int64)
    need_lo = valid & (pre is not None)
    need_hi = valid & (post is not None)
    t_lo = m - (pre if pre is not None else 0)
    t_hi = m + (post if post is not None else 0)
    if warp_path:
        fast = ~((ppos == 0) & (plast == n - 1) & (n & (n - 1) == 0))
        for side, need, t, strict in ((0, need_lo, t_lo, False),
                                      (1, need_hi, t_hi, True)):
            off = pre if side == 0 else post
            rows = np.flatnonzero(fast & need)
            if off == 0:
                (lo if side == 0 else hi)[rows] = \
                    (peer_lo if side == 0 else peer_hi)[rows]
            elif rows.size:
                ans, r = warp_first_model(m, rows, ppos[rows], plast[rows],
                                           t[rows], strict)
                if side == 0:
                    lo[rows] = ans
                else:
                    hi[rows] = ans - 1
                rounds[rows] += r
        need_lo = need_lo & ~fast
        need_hi = need_hi & ~fast
    rows = np.flatnonzero(need_lo | need_hi)
    if rows.size:
        pp, pl = ppos[rows], plast[rows]
        a0 = np.where(need_lo[rows], pp, pl + 1)
        a1 = np.where(need_hi[rows], pp, pl + 1)
        b0, b1 = pl + 1, pl + 1
        cnt = np.zeros(rows.size, dtype=np.int64)
        for _ in range(max(int(max(n - 1, 1)).bit_length(), 1)):
            act = (a0 < b0) | (a1 < b1)
            if not act.any():
                break
            cnt += act
            m0, m1 = (a0 + b0) >> 1, (a1 + b1) >> 1
            h0 = (m[np.clip(m0, 0, n - 1)] >= t_lo[rows]) | (m0 > pl)
            h1 = (m[np.clip(m1, 0, n - 1)] > t_hi[rows]) | (m1 > pl)
            b0, a0 = np.where(h0, m0, b0), np.where(h0, a0, m0 + 1)
            b1, a1 = np.where(h1, m1, b1), np.where(h1, a1, m1 + 1)
        lo[rows] = np.where(need_lo[rows], a0, lo[rows])
        hi[rows] = np.where(need_hi[rows], a1 - 1, hi[rows])
        rounds[rows] = cnt
    return lo, hi, rounds

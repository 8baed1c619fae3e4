"""Device factorization & ordering primitives.

The reference's hash aggregation and hash join both revolve around an
open-address hash table (executor/aggregate.go getGroupKey→HashGroupKey,
executor/hash_table.go hashRowContainer). The device formulation here is
sort-based (SURVEY §7 stage 4), as in the JAX package
(tidb_tpu/ops/factorize.py):

  * `factorize` — dense group ids from a lexicographic sort of the key
    operands, boundary detection between sorted neighbours, and a cumsum.
    EXACT: the typed key values (or exact dense rank packings of them)
    are the sort operands, not a hash.
  * `topn` / `sort_perm` — MySQL ORDER BY semantics (NULLs first ASC,
    last DESC) as sorts returning a gather permutation.

Multi-key operations chain-pack like the JAX package (per-key dense ranks
packed into one int64 code, re-densified each step), so group ids come
out in the same rank order, NULL first, with the same `n_groups` and
`rep`.

Each sort is a list of `SortOp`s, first operand primary. Two primitives
carry the work, each with a plain torch version (the CPU path) and a
kernel path for CUDA tensors (csrc/radix_sort.cu, csrc/sorted_groups.cu):

  `lexsort`   the stable lexicographic permutation. Plain: a chain of
              stable `torch.sort` passes from the last operand to the
              first. Kernel: K9 `sort_encode` packs the operands into as
              few 64-bit radix words as their varying bits need, K8
              `radix_sort` sorts each word stably, least significant word
              first.
  `group_ids` the back half of factorize / _dense1 over the sorted order
              (boundaries, scan, gids, n_groups, rep). Kernel: K10. When
              the sort took one word, its word entry reads K8's sorted
              word (`SortWords`), whose bits hold the dead flag, the NULL
              flag and the value code side by side; a sort of two or more
              words takes its gather entry, which reads the flags from
              K8's sorted last word and gathers the value through the
              permutation. The word count, known on the host, picks.

The kernel path needs each operand's bit width: a dense rank or packed
code carries its bound (`SortOp.hi`, known on the host), a raw key costs
one K9 min/max reduction; a sort reads all its raw operands' min/max back
to the host at once (one sync per sort). Permutations come back as int64
(torch's index type) from `sort_perm`, `topn` and `partition_perm`; the
kernels carry int32 row ids inside.

All group counts are explicit (`cap`): callers get `n_groups` back and
retry with a bigger cap when `n_groups > cap`.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class SortOp(NamedTuple):
    """One sort operand. Slots where `m` is False read as 0 (NULL
    canonicalization: all NULLs form one group); `desc` sorts descending;
    `hi`, when known, bounds every value to [0, hi) (dense ranks and
    packed codes), which spares the kernel path its min/max read-back."""
    v: torch.Tensor
    m: Optional[torch.Tensor] = None
    desc: bool = False
    hi: Optional[int] = None


class Field(NamedTuple):
    """An operand's bit field in a radix word: codes minus `base`, shifted
    left by `shift`, over `width` bits; `nan` when the codes reach K9's
    NaN code (~0), which then marks every NaN."""
    shift: int
    width: int
    base: int
    nan: bool = False


class SortWords(NamedTuple):
    """What the kernel sort leaves beside its permutation: the number of
    64-bit radix words it took, the last (most significant) word in sorted
    order, and each operand's `Field` in that word (None for an operand
    packed into an earlier word)."""
    count: int
    last: Optional[torch.Tensor]
    fields: Tuple[Optional[Field], ...]


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _sortable(a: torch.Tensor) -> torch.Tensor:
    # CUDA has no sort for bool tensors; False < True is kept by uint8
    return a.to(torch.uint8) if a.dtype == torch.bool else a


def _operand(op: SortOp) -> torch.Tensor:
    t = op.v
    if op.m is not None:
        t = torch.where(op.m, t, torch.zeros_like(t))
    if op.desc:
        if t.dtype.is_floating_point:
            t = -t
        elif t.dtype == torch.bool:
            t = torch.logical_not(t)
        else:
            t = torch.bitwise_not(t)        # exact order flip
    return _sortable(t)


def lexsort_plain(ops: Sequence[SortOp]) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64), first operand
    primary: stable single-key sorts from the last operand to the first."""
    n = ops[0].v.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=ops[0].v.device)
    for op in reversed(ops):
        key = _operand(op)[perm]
        perm = perm[torch.sort(key, stable=True).indices]
    return perm


def _boundaries(sorted_ops: Sequence[torch.Tensor], n: int, device):
    diff = torch.zeros(n, dtype=torch.bool, device=device)
    if n:
        diff[0] = True
    for comp in sorted_ops:
        diff[1:] |= comp[1:] != comp[:-1]
    return diff


def _groups_from_boundaries(sidx, diff, live_s, cap: int):
    """The tail of K10's plain versions: boundaries `diff` in sorted order
    (masked by `live_s` when cap > 0) → gids, or (gids, n_groups, rep)."""
    n = sidx.shape[0]
    dev = sidx.device
    gids = torch.zeros(n, dtype=torch.int32, device=dev)
    if cap == 0:
        gids[sidx] = torch.cumsum(diff.to(torch.int32), 0,
                                  dtype=torch.int32) - 1
        return gids
    boundary = diff & live_s
    gid_s = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = boundary.sum().to(torch.int32)
    gid_s = gid_s.clamp(0, cap - 1)
    gids[sidx] = gid_s
    from tidb_tpu_torch.ops.segment import segment_reduce
    sidx = sidx.to(torch.int64)
    rows = torch.where(live_s, sidx, torch.full_like(sidx, n))
    rep = segment_reduce("min", rows, gid_s, cap)
    rep = torch.minimum(rep, torch.full_like(rep, max(n - 1, 0)))
    return gids, n_groups, rep.to(torch.int32)


def group_ids_plain(sidx, v, m, live, cap: int):
    """Plain torch version of K10's gather entry over the stable order
    `sidx` of one key (v, m). cap == 0 (_dense1): dense codes in sorted
    order, boundaries unmasked → gids (n,) int32. cap > 0 (factorize):
    boundaries masked by the sorted rows' liveness → (gids clamped to
    [0, cap), n_groups, rep (cap,) int32 — a group's smallest row,
    max(n - 1, 0) where empty)."""
    n = sidx.shape[0]
    ops = [v] if m is None else [m, torch.where(m, v, torch.zeros_like(v))]
    diff = _boundaries([op[sidx] for op in ops], n, sidx.device)
    return _groups_from_boundaries(sidx, diff,
                                   live[sidx] if cap > 0 else None, cap)


def _check_outputs(n: int, cap: int, first: bool, want_gids: bool) -> None:
    if first and cap < max(n, 1):
        raise ValueError(f"group_ids_words: the first mask needs a slot a "
                         f"row (cap >= n >= 1 or cap >= 1), got cap={cap}, "
                         f"n={n}")
    if not (want_gids or first):
        raise ValueError("group_ids_words: the ids are left out only "
                         "beside the first mask")


def group_ids_words_plain(w, sidx, cmp_mask: int, nan, dead_shift: int,
                          cap: int, first: bool = False,
                          want_gids: bool = True):
    """Plain torch version of K10's word entry over `w`, a sort's one radix
    word in sorted order (uint64 bits in an int64 tensor), and its row ids
    `sidx`: a boundary where a bit under `cmp_mask` changes, or where
    `nan` = (mask, code) is given and w & mask == code (each NaN its own
    group); cap > 0 masks it by the live flag (bit `dead_shift` of w
    clear). Outputs as `group_ids_plain`; with `first` (cap >= n), a
    fourth, the first-occurrence mask `rep[gids] == iota` in row order:
    true at each group's first sorted row, or at row n - 1 alone when no
    row is live (every id clamps to slot 0, whose rep is n - 1); with
    `first` and without `want_gids` the ids are None."""
    n = w.shape[0]
    _check_outputs(n, cap, first, want_gids)
    diff = torch.zeros(n, dtype=torch.bool, device=w.device)
    if n:
        diff[0] = True
        diff[1:] = ((w[1:] ^ w[:-1]) & _signed(cmp_mask)) != 0
    if nan is not None:
        diff |= (w & _signed(nan[0])) == _signed(nan[1])
    live_s = None
    if cap > 0:
        live_s = torch.bitwise_right_shift(w, dead_shift) & 1 == 0
    out = _groups_from_boundaries(sidx, diff, live_s, cap)
    if not first:
        return out
    gids, ng, rep = out
    mask = torch.zeros(n, dtype=torch.bool, device=w.device)
    mask[sidx[diff & live_s].to(torch.int64)] = True
    if n and int(ng) == 0:
        mask[n - 1] = True
    return (gids if want_gids else None), ng, rep, mask


# K9's operand types: 0 bool, 1 int32, 2 int64, 3 float64
_M64 = (1 << 64) - 1
_SIGN = -(1 << 63)
_ZERO_CODE = {0: 0, 1: 1 << 31, 2: 1 << 63, 3: 1 << 63}


def _flip_code(u: int, code: int) -> int:
    return {0: u ^ 1, 1: u ^ 0xFFFFFFFF}.get(code, ~u & _M64)


def sort_codes_plain(v, code: int, m=None, desc: bool = False):
    """K9's order-preserving codes in plain torch: uint64 bit patterns in
    an int64 tensor (row order, no gather)."""
    if code == 0:
        u = v.to(torch.int64)
    elif code == 1:
        u = v.to(torch.int64) + (1 << 31)
    elif code == 2:
        u = v ^ _SIGN
    else:
        x = torch.where(v == 0, torch.zeros_like(v), v).contiguous()
        b = x.view(torch.int64)
        u = torch.where(b < 0, torch.bitwise_not(b), b ^ _SIGN)
        u = torch.where(torch.isnan(v), torch.full_like(u, -1), u)
    if m is not None:
        zero = _ZERO_CODE[code]
        zero = zero - (1 << 64) if zero >= 1 << 63 else zero
        u = torch.where(m, u, torch.full_like(u, zero))
    if desc:
        if code == 0:
            u = u ^ 1
        elif code == 1:
            u = u ^ 0xFFFFFFFF
        elif code == 2:
            u = torch.bitwise_not(u)
        else:
            u = torch.where(u == -1, u, torch.bitwise_not(u))
    return u


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def sort_encode_plain(v, code: int, perm, m, desc: bool, base: int,
                      shift: int, out=None, accumulate: bool = False):
    """Plain torch version of K9 → (out (n,) int64 holding uint64 words,
    (lo, hi) — the codes' unsigned min and max as Python ints)."""
    u = sort_codes_plain(v, code, m, desc)
    if perm is not None:
        u = u[perm.to(torch.int64)]
    n = u.shape[0]
    if n:
        s = u ^ _SIGN                      # unsigned order as signed
        lo = (int(s.min()) ^ _SIGN) & _M64
        hi = (int(s.max()) ^ _SIGN) & _M64
    else:
        lo, hi = _M64, 0
    w = torch.bitwise_left_shift(u - _signed(base), shift)
    if out is not None and accumulate:
        w = out | w
    return w, (lo, hi)


def radix_sort_plain(keys, vals, end_bit: int):
    """Plain torch version of K8: stable sort of uint64 words (in an int64
    tensor) by their bits [0, end_bit) → (sorted words, their int32 row
    ids; `vals` None means 0..n-1)."""
    n = keys.shape[0]
    v = vals if vals is not None else torch.arange(
        n, dtype=torch.int32, device=keys.device)
    if end_bit <= 0:
        return keys, v
    k = keys ^ _SIGN if end_bit >= 64 else keys & ((1 << end_bit) - 1)
    idx = torch.sort(k, stable=True).indices
    return keys[idx], v[idx]


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors; plain versions for CPU tensors)
# ---------------------------------------------------------------------------


def _k9_operand(v: torch.Tensor):
    """→ (values as K9 reads them, type code)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if v.dtype == torch.bool:
        return v.contiguous(), 0
    if v.dtype in (torch.int8, torch.int16, torch.int32, torch.uint8):
        return v.to(torch.int32).contiguous(), 1
    if v.dtype == torch.int64:
        return v.contiguous(), 2
    if v.dtype in (torch.float16, torch.bfloat16, torch.float32,
                   torch.float64):
        return v.to(torch.float64).contiguous(), 3
    raise ck.KernelError(f"sort operand of dtype {v.dtype}")


def _check_mask(m, n: int, what: str):
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if m is None:
        return None
    ck.require_cuda(m, what=what)
    if m.dtype != torch.bool or m.shape != (n,):
        raise ck.KernelError(f"{what}: masks must be bool of the values' "
                             f"length")
    return m.data_ptr()


def sort_encode(v, code: int, perm, m, desc: bool, base: int, shift: int,
                out=None, accumulate: bool = False, stats=None):
    """K9 wrapper over values already in K9's type (`_k9_operand`): codes
    gathered through `perm` (int32 or None = identity), minus `base`,
    shifted left by `shift`, written (or OR-ed) into `out` (int64 (n,));
    `stats` (2,) int64 receives the codes' unsigned min and max. CPU
    tensors take `sort_encode_plain`."""
    if v.device.type == "cpu":
        w, (lo, hi) = sort_encode_plain(v, code, perm, m, desc, base, shift,
                                        out, accumulate)
        if out is not None:
            out.copy_(w)
        if stats is not None:
            stats.copy_(torch.tensor([_signed(lo), _signed(hi)]))
        return out
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(v, what="sort_encode")
    nv = v.shape[0]
    n = nv if perm is None else perm.shape[0]
    if perm is not None:
        ck.require_cuda(perm, what="sort_encode")
        if perm.dtype != torch.int32:
            raise ck.KernelError("sort_encode: int32 permutation expected")
    mp = _check_mask(m, nv, "sort_encode")
    for t in (out, stats):
        if t is not None:
            ck.require_cuda(t, what="sort_encode")
            if t.dtype != torch.int64:
                raise ck.KernelError("sort_encode: int64 words expected")
    if out is not None and out.shape != (n,):
        raise ck.KernelError("sort_encode: output of the wrong length")
    rc = ck.library("radix_sort").tt_sort_encode(
        v.data_ptr(), code, n, None if perm is None else perm.data_ptr(),
        mp, int(bool(desc)), int(base) & _M64, int(shift),
        None if out is None else out.data_ptr(), int(bool(accumulate)),
        None if stats is None else stats.data_ptr(), ck.stream_ptr(v.device))
    if n > 0:
        ck.count("sort_encode")
    ck.check(rc, "sort_encode")
    return out


def radix_sort(keys, vals, end_bit: int):
    """K8 wrapper → (sorted words, int32 row ids), as `radix_sort_plain`."""
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, vals, end_bit)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(keys, what="radix_sort")
    n = keys.shape[0]
    if keys.dtype != torch.int64 or keys.dim() != 1 or n >= 2 ** 31 or \
            not 0 <= end_bit <= 64:
        raise ck.KernelError("radix_sort: int64 words (< 2^31 of them) and "
                             "a bit range within 64 expected")
    if vals is not None:
        ck.require_cuda(vals, what="radix_sort")
        if vals.dtype != torch.int32 or vals.shape != (n,):
            raise ck.KernelError("radix_sort: int32 row ids of the words' "
                                 "length expected")
    passes = -(-end_bit // 8)
    dev = keys.device
    if n == 0 or passes == 0:
        return keys, (vals if vals is not None else torch.arange(
            n, dtype=torch.int32, device=dev))
    lib = ck.library("radix_sort")
    ka = torch.empty(n, dtype=torch.int64, device=dev)
    kb = torch.empty(n, dtype=torch.int64, device=dev)
    va = torch.empty(n, dtype=torch.int32, device=dev)
    vb = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.tt_radix_scratch_words(n), dtype=torch.int64,
                          device=dev)
    rc = lib.tt_radix_sort(
        keys.data_ptr(), None if vals is None else vals.data_ptr(), n,
        end_bit, ka.data_ptr(), va.data_ptr(), kb.data_ptr(), vb.data_ptr(),
        scratch.data_ptr(), ck.stream_ptr(dev))
    ck.count("radix_sort")
    ck.check(rc, "radix_sort")
    return (ka, va) if passes % 2 == 1 else (kb, vb)


def _fields(ops: Sequence[SortOp], n: int) -> List[Tuple]:
    """→ [(values as K9 reads them, type code, base, width, nan)] per
    operand: the smallest code, the bits the codes span above it, and
    whether they reach the NaN code. Dense ranks and packed codes take
    their bound; every raw key's K9 min/max lands in one (k, 2) tensor,
    read back to the host once."""
    enc = [_k9_operand(op.v) for op in ops]
    raw = [j for j, (op, (_v, code)) in enumerate(zip(ops, enc))
           if code != 0 and not (op.hi is not None and code in (1, 2))]
    stats = {}
    if raw and n:
        st = torch.tensor([[-1, 0]] * len(raw), dtype=torch.int64,
                          device=ops[0].v.device)
        for row, j in enumerate(raw):
            v, code = enc[j]
            sort_encode(v, code, None, ops[j].m, ops[j].desc, 0, 0,
                        stats=st[row])
        stats = dict(zip(raw, st.tolist()))
    out = []
    for j, (op, (v, code)) in enumerate(zip(ops, enc)):
        if code == 0:
            out.append((v, code, 0, 1, False))
        elif j not in raw:
            lo = _ZERO_CODE[code]
            hi = lo + max(int(op.hi), 1) - 1
            if op.desc:
                lo, hi = _flip_code(hi, code), _flip_code(lo, code)
            out.append((v, code, lo, (hi - lo).bit_length(), False))
        elif j not in stats:                       # n == 0
            out.append((v, code, 0, 0, False))
        else:
            lo, hi = (x & _M64 for x in stats[j])
            out.append((v, code, lo, (hi - lo).bit_length(),
                        code == 3 and hi == _M64))
    return out


def _lexsort_kernel(ops: Sequence[SortOp]):
    """K9 + K8: operands packed into 64-bit words from the least
    significant operand up (an operand whose codes do not vary takes no
    bits), each word encoded through the permutation so far and sorted
    stably over its bits → (int32 permutation, `SortWords`)."""
    n = ops[0].v.shape[0]
    dev = ops[0].v.device
    fields = _fields(ops, n)
    words: List = []
    cur: List = []
    used = 0
    for j in reversed(range(len(ops))):
        width = fields[j][3]
        if width == 0:
            continue
        if used + width > 64:
            words.append((cur, used))
            cur, used = [], 0
        cur.append((j, used))
        used += width
    if cur:
        words.append((cur, used))
    perm = w = None
    for spec, bits in words:
        word = torch.empty(n, dtype=torch.int64, device=dev)
        for k, (j, shift) in enumerate(spec):
            v, code, base, _width, _nan = fields[j]
            sort_encode(v, code, perm, ops[j].m, ops[j].desc, base, shift,
                        word, accumulate=k > 0)
        w, perm = radix_sort(word, perm, bits)
    if perm is None:
        perm = torch.arange(n, dtype=torch.int32, device=dev)
    shifts = dict(words[-1][0]) if words else {}
    layout = tuple(
        Field(shifts.get(j, 0), f[3], f[2], f[4])
        if j in shifts or f[3] == 0 else None
        for j, f in enumerate(fields))
    return perm, SortWords(len(words), w, layout)


def lexsort(ops: Sequence[SortOp]) -> torch.Tensor:
    """Stable lexicographic sort permutation, first operand primary:
    `lexsort_plain` (int64) for CPU tensors, K9 + K8 (int32) for CUDA."""
    if ops[0].v.device.type == "cpu":
        return lexsort_plain(ops)
    return _lexsort_kernel(ops)[0]


def _word_key(words: SortWords):
    """K10's word-entry parameters for a one-word sort of
    `_key_operands([(v, m)], live)` → (cmp_mask, nan, dead_shift): every
    key field but the dead flag (the JAX function compares the key
    components only), the value field's NaN code when its codes reach it,
    and the dead flag's bit."""
    dead, *key = words.fields
    cmp_mask = 0
    for f in key:
        cmp_mask |= ((1 << f.width) - 1) << f.shift
    val = key[-1]
    nan = None
    if val.nan:
        nan = (((1 << val.width) - 1) << val.shift,
               ((_M64 - val.base) << val.shift) & _M64)
    return cmp_mask, nan, dead.shift


def _gather_key(words: SortWords, m):
    """K10's gather-entry parameters for a sort of two or more words of
    `_key_operands([(v, m)], live)` → (the sorted last word, the dead
    flag's bit in it, the NULL flag's bit in it or -1). The value fills
    the first word, so the last holds the dead flag always, and the NULL
    flag when the value leaves it no room (its field is None when the
    flag shares the value's word)."""
    dead = words.fields[0]
    null = words.fields[1] if m is not None else None
    return words.last, dead.shift, (-1 if null is None else null.shift)


def group_ids(sidx, v, m, live, cap: int,
              words: Optional[SortWords] = None):
    """K10 wrapper, as `group_ids_plain` (`live` is read only when
    cap > 0). `words`, from the kernel sort of `_key_operands([(v, m)],
    live)` that made `sidx`, picks the entry: one word takes the word
    entry (`group_ids_words`) over K8's sorted word; two or more take the
    gather entry with the sorted last word (`_gather_key`: the dead and
    NULL flags read from it, the value gathered); without `words` the
    gather entry gathers the flags too. CPU tensors take the plain
    version."""
    if words is not None and words.count == 1:
        cmp_mask, nan, dead_shift = _word_key(words)
        return group_ids_words(words.last, sidx, cmp_mask, nan, dead_shift,
                               cap)
    if sidx.device.type == "cpu":
        return group_ids_plain(sidx, v, m, live, cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(sidx, what="group_ids")
    n = sidx.shape[0]
    if sidx.dtype != torch.int32 or n >= 2 ** 31 or cap < 0:
        raise ck.KernelError("group_ids: int32 permutation and cap >= 0 "
                             "expected")
    v, code = _k9_operand(v)
    ck.require_cuda(v, what="group_ids")
    if v.shape != (n,):
        raise ck.KernelError("group_ids: key of the permutation's length "
                             "expected")
    mp = _check_mask(m, n, "group_ids")
    # with the word, the dead flag comes from it and live is not read
    lp = _check_mask(live, n, "group_ids") \
        if cap > 0 and words is None else None
    w, dead_shift, null_shift = None, 0, -1
    if words is not None:
        w, dead_shift, null_shift = _gather_key(words, m)
        ck.require_cuda(w, what="group_ids")
        if w.dtype != torch.int64 or w.shape != (n,):
            raise ck.KernelError("group_ids: the sorted last word must be "
                                 "int64 of the permutation's length")
    lib = ck.library("sorted_groups")
    # one int32 allocation: the kernel's scratch (64-bit words), the ids,
    # then rep (which the kernel fills with max(n - 1, 0)) and n_groups
    at = 2 * _words_scratch(n)
    buf = torch.empty(at + n + (cap + 1 if cap > 0 else 0),
                      dtype=torch.int32, device=sidx.device)
    base = buf.data_ptr()
    rc = lib.tt_group_ids(
        sidx.data_ptr(), None if w is None else w.data_ptr(), dead_shift,
        null_shift, v.data_ptr(), code, mp, lp, n, int(cap),
        base + 4 * at, base + 4 * (at + n) if cap > 0 else None,
        base + 4 * (at + n + cap) if cap > 0 else None, base,
        ck.stream_ptr(sidx.device))
    if n > 0:
        ck.count("group_ids")
    ck.check(rc, "group_ids")
    # the views, made while the kernel runs
    gids = buf[at:at + n]
    if cap == 0:
        return gids
    return gids, buf[at + n + cap], buf[at + n:at + n + cap]


@functools.lru_cache(maxsize=64)
def _words_scratch(n: int) -> int:
    """K10's scratch for n rows, in 64-bit words (tt_group_words_scratch)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    return ck.library("sorted_groups").tt_group_words_scratch(n)


def group_ids_words(w, sidx, cmp_mask: int, nan, dead_shift: int,
                    cap: int, first: bool = False, want_gids: bool = True):
    """K10 word-entry wrapper, as `group_ids_words_plain` (CPU tensors take
    it); `first` (cap >= n) adds the first-occurrence mask from the same
    pass, and then `want_gids` False spares the ids' store."""
    if w.device.type == "cpu":
        return group_ids_words_plain(w, sidx, cmp_mask, nan, dead_shift,
                                     cap, first, want_gids)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(w, sidx, what="group_ids_words")
    n = w.shape[0]
    if w.dtype != torch.int64 or sidx.dtype != torch.int32 or \
            w.shape != (n,) or sidx.shape != (n,) or n >= 2 ** 31 or \
            cap < 0 or not 0 <= dead_shift < 64:
        raise ck.KernelError("group_ids_words: int64 words, int32 row ids "
                             "of one length, cap >= 0 and a dead bit in "
                             "0..63 expected")
    _check_outputs(n, cap, first, want_gids)
    dev = w.device
    gids = torch.empty(n, dtype=torch.int32, device=dev) if want_gids \
        else None
    lib = ck.library("sorted_groups")
    # one allocation: the kernel's scratch, then rep (which the kernel
    # fills with max(n - 1, 0)) and n_groups as int32, then the first
    # mask's bytes
    words = _words_scratch(n)
    mid = words + cap // 2 + 1
    buf = torch.empty(mid + (-(-n // 8) if first else 0), dtype=torch.int64,
                      device=dev)
    scratch = buf[:words]
    rep = ng = mask = None
    if cap > 0:
        tail = buf[words:mid].view(torch.int32)
        rep, ng = tail[:cap], tail[cap]
    if first:
        mask = buf[mid:].view(torch.bool)[:n]
    nan_mask, nan_val = nan if nan is not None else (0, 0)
    rc = lib.tt_group_ids_words(
        w.data_ptr(), sidx.data_ptr(), n, int(cmp_mask) & _M64,
        int(nan is not None), int(nan_mask) & _M64, int(nan_val) & _M64,
        int(dead_shift), int(cap), None if gids is None else gids.data_ptr(),
        None if rep is None else rep.data_ptr(),
        None if ng is None else ng.data_ptr(),
        None if mask is None else mask.data_ptr(), scratch.data_ptr(),
        ck.stream_ptr(dev))
    if n > 0:
        ck.count("group_ids_words")
    ck.check(rc, "group_ids_words")
    if first:
        return gids, ng, rep, mask
    return gids if cap == 0 else (gids, ng, rep)


def _sort_groups_kernel(ops: Sequence[SortOp], v, m, live, cap: int):
    """The kernel route of _dense1 / factorize: K9 + K8 over `ops` (the
    key's `_key_operands`), then K10's entry for the sort's word count."""
    sidx, words = _lexsort_kernel(ops)
    return group_ids(sidx, v, m, live, cap, words)


def _sort_groups(ops: Sequence[SortOp], v, m, live, cap: int):
    if live.device.type == "cpu":
        return group_ids_plain(lexsort_plain(ops), v, m, live, cap)
    return _sort_groups_kernel(ops, v, m, live, cap)


# ---------------------------------------------------------------------------
# The JAX package's functions (tidb_tpu/ops/factorize.py)
# ---------------------------------------------------------------------------


def _key_operands(keys: Sequence[Tuple], live, hi: Optional[int] = None
                  ) -> List[SortOp]:
    """Sort operands for [(values, valid-or-None)] keys: dead rows last,
    NULL group before non-NULL, NULL slots canonicalized (all NULLs form
    ONE group). `hi` bounds the values of a single dense-code key."""
    operands: List[SortOp] = [SortOp(live, desc=True)]
    for v, m in keys:
        if m is None:
            operands.append(SortOp(v, hi=hi))
        else:
            operands.append(SortOp(m))
            operands.append(SortOp(v, m, hi=hi))
    return operands


def _dense1(v, m, live, hi: Optional[int] = None):
    """Dense codes of ONE key column — sort + boundary scan. Dead rows get
    arbitrary (larger) codes; callers mask them."""
    return _sort_groups(_key_operands([(v, m)], live, hi), v, m, live, 0)


def pack_codes(keys: Sequence[Tuple], live):
    """One int64 code per row identifying the multi-key tuple (per-key
    dense ranks packed and re-densified; rank-ordered, NULLs first). The
    codes are below (n+1)²."""
    n = live.shape[0]
    code = None
    for i, (v, m) in enumerate(keys):
        g = _dense1(v, m, live)
        if code is None:
            code = g.to(torch.int64)
            continue
        code = code * (n + 1) + g.to(torch.int64)
        if i < len(keys) - 1:     # keep the running domain < n+1
            code = _dense1(code, None, live, (n + 1) ** 2).to(torch.int64)
    return code


def factorize(keys: Sequence[Tuple], live, cap: int,
              hi: Optional[int] = None):
    """Dense group ids for rows under multi-column keys.

    keys: list of (values, valid) pairs — `valid` False means SQL NULL,
          which forms its own group.
    live: (N,) bool — False rows (padding / filtered-out) join no group.
    cap:  maximum number of groups.
    hi:   for ONE key without NULLs, a host-known bound [0, hi) on its
          values (a packed code), which spares K9 its min/max read-back.

    Returns (gids, n_groups, rep):
      gids     (N,) int32 in [0, cap) — dead rows get an arbitrary in-range
               id; callers must mask their contributions.
      n_groups () int32 — may exceed cap, in which case results are invalid
               and the caller must retry with a larger cap.
      rep      (cap,) int32 — smallest original row index of each group
               (clamped to N-1 for empty slots; gather-safe).
    """
    n = live.shape[0]
    if len(keys) > 1:
        keys = [(pack_codes(keys, live), None)]
        hi = (n + 1) ** 2
    (v, m), = keys
    return _sort_groups(_key_operands(keys, live, hi), v, m, live, cap)


def _order_operands(keys: Sequence[Tuple], descs: Sequence[bool], live
                    ) -> List[SortOp]:
    """Sort operands implementing MySQL ORDER BY over possibly-NULL keys:
    dead rows last; ASC puts NULLs first, DESC (every bit of the flag and
    the value flipped) last."""
    operands: List[SortOp] = [SortOp(live, desc=True)]
    for (v, m), desc in zip(keys, descs):
        operands.append(SortOp(m, desc=bool(desc)))
        operands.append(SortOp(v, desc=bool(desc)))
    return operands


def sort_perm(keys: Sequence[Tuple], descs: Sequence[bool], live):
    """Full-sort permutation → (perm (N,) int64, n_live () int32).

    perm[0:n_live] are original row indices in output order; the tail is
    the dead rows (stable). Multi-key orders chain-pack into per-key
    dense RANKS (DESC flips the rank, which also sends NULLs last)."""
    n = live.shape[0]
    if len(keys) > 1:
        code = None
        for i, ((v, m), desc) in enumerate(zip(keys, descs)):
            g = _dense1(v, m, live)        # rank-ordered, NULLs first
            if desc:
                g = n - g                  # flip order, NULLs last
            if code is None:
                code = g.to(torch.int64)
                continue
            code = code * (n + 1) + g.to(torch.int64)
            if i < len(keys) - 1:
                code = _dense1(code, None, live, (n + 1) ** 2).to(
                    torch.int64)
        operands = [SortOp(live, desc=True),
                    SortOp(code, hi=(n + 1) ** 2)]
    else:
        operands = _order_operands(keys, descs, live)
    return lexsort(operands).to(torch.int64), live.sum().to(torch.int32)


def topn(keys: Sequence[Tuple], descs: Sequence[bool], live, k: int):
    """Top-k row indices under ORDER BY semantics → (idx (k,), n_out)."""
    perm, n_live = sort_perm(keys, descs, live)
    return perm[:k], torch.clamp(n_live, max=k)


def partition_perm(keep) -> torch.Tensor:
    """Stable partition → int64 permutation: the rows where `keep` is True
    in row order, then the rest in row order (a one-bit sort: one K8
    pass on the card)."""
    return lexsort([SortOp(keep, desc=True)]).to(torch.int64)


def dense_codes(keys: Sequence[Tuple], live):
    """Dense group codes ONLY — factorize without the representative-row
    reduction: one key's dense rank, or several keys' packed code."""
    if len(keys) == 1:
        return _dense1(keys[0][0], keys[0][1], live)
    return pack_codes(keys, live)


def distinct_pair_factorize(gids, values, validity, live, cap: int,
                            gid_cap: Optional[int] = None,
                            want_pg: bool = True):
    """Dense ids of live (group, value) pairs → (first_mask, pair_gids,
    n_pairs, rep). One value-rank sort + one pair sort, shared between
    DISTINCT state masking (first_mask) and the cross-slab distinct-pair
    partials (rep/n_pairs). `gids` are the rows' group ids in [0, gid_cap]
    (dead rows carry the group cap); `gid_cap`, when known, bounds them
    (else int32's bound does), so the pair code gid·(n+1)+vid carries its
    bound (gid_cap+1)·(n+1) into the one-word sort (`pair_factorize`).
    `cap` >= n: a slot for every row (the JAX function's callers pass
    the slab). Without `want_pg`, pair_gids is None."""
    n = live.shape[0]
    pair_live = live & validity
    vid = _dense1(values, None, pair_live)
    return pair_factorize(gids, vid, pair_live, cap, gid_cap, want_pg)


def distinct_mask(gids, values, validity, live,
                  gid_cap: Optional[int] = None):
    """True at the first live+valid occurrence of each (group, value) pair.
    Rows where validity/live is False return garbage; callers keep masking
    with validity & live as usual."""
    n = live.shape[0]
    return distinct_pair_factorize(gids, values, validity, live, n,
                                   gid_cap)[0]


# ---------------------------------------------------------------------------
# K16 distinct_pairs: the pair sort's word; the pair factorize after it
# ---------------------------------------------------------------------------

#: the bound of int32 group ids, where the caller gives none
GID_MAX = 2 ** 31 - 1


def pair_code_plain(gids, vid):
    """The JAX function's pair code, gid·(n+1) + vid (int64)."""
    n = gids.shape[0]
    return gids.to(torch.int64) * (n + 1) + vid.to(torch.int64)


def first_mask_plain(rep, pg):
    """The JAX function's first-occurrence mask, rep[pg] == iota."""
    n = pg.shape[0]
    return rep.to(torch.int64)[pg.to(torch.int64)] == \
        torch.arange(n, dtype=torch.int64, device=pg.device)


def pair_width(gid_cap: int, n: int) -> int:
    """W, the bits of the pair code gid·(n+1) + vid under its bound
    (gid_cap+1)·(n+1), which must stay below 2^63."""
    hi = (gid_cap + 1) * (n + 1)
    if not 0 <= gid_cap or hi >= 2 ** 63:
        raise ValueError(f"pair code: (cap+1)·(n+1) = ({gid_cap}+1)·({n}+1)"
                         f" does not fit int64")
    return (hi - 1).bit_length()


def pair_fields(width: int) -> Tuple[Field, Field]:
    """The `Field`s K9 gives [SortOp(pair_live, desc=True), SortOp(code,
    hi=...)] in their one word: the dead flag at bit W, the code (int64
    type, base 2^63) at shift 0 over W bits."""
    return (Field(width, 1, 0), Field(0, width, _ZERO_CODE[2]))


def pair_word_plain(gids, vid, pair_live, gid_cap: int):
    """Plain torch version of K16: (gid·(n+1) + vid) | !pair_live << W,
    the pair sort's one radix word (int64 holding uint64 bits)."""
    n = gids.shape[0]
    width = pair_width(gid_cap, n)
    dead = torch.logical_not(pair_live).to(torch.int64)
    return pair_code_plain(gids, vid) | torch.bitwise_left_shift(dead, width)


def pair_word(gids, vid, pair_live, gid_cap: int):
    """K16 wrapper: CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise on anything it does not take)."""
    if gids.device.type == "cpu":
        return pair_word_plain(gids, vid, pair_live, gid_cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(gids, vid, pair_live, what="pair_word")
    n = gids.shape[0]
    if gids.dtype != torch.int32 or vid.dtype != torch.int32 or \
            pair_live.dtype != torch.bool or gids.shape != (n,) or \
            vid.shape != (n,) or pair_live.shape != (n,):
        raise ck.KernelError("pair_word: int32 gids and value ranks and "
                             "bool flags of one length expected")
    try:
        width = pair_width(gid_cap, n)
    except ValueError as e:
        raise ck.KernelError(str(e)) from None
    kernel = _PAIR_WORD or _bind_pair_word()
    dev = gids.device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    rc = kernel(gids.data_ptr(), vid.data_ptr(), pair_live.data_ptr(), n,
                n + 1, width, out.data_ptr(), ck.stream_ptr(dev))
    if n > 0:
        ck.count("distinct_pairs")
    if rc:
        ck.check(rc, "pair_word")
    return out


#: csrc/distinct_pairs.cu tt_pair_word, bound at the first CUDA call
_PAIR_WORD = None


def _bind_pair_word():
    global _PAIR_WORD
    from tidb_tpu_torch.ops import cuda_kernels as ck
    _PAIR_WORD = ck.library("distinct_pairs").tt_pair_word
    return _PAIR_WORD


def pair_sort(gids, vid, pair_live, gid_cap: int):
    """The pair sort: K16's word, sorted stably by K8 over its W + 1 bits
    → (int32 permutation, `SortWords`), what `_lexsort_kernel` returns
    for [SortOp(pair_live, desc=True), SortOp(pair code, hi=(gid_cap+1)·
    (n+1))] (radix_sort_plain on CPU tensors)."""
    n = gids.shape[0]
    width = pair_width(gid_cap, n)
    w, sidx = radix_sort(pair_word(gids, vid, pair_live, gid_cap), None,
                         width + 1)
    return sidx, SortWords(1, w, pair_fields(width))


def pair_factorize(gids, vid, pair_live, cap: int,
                   gid_cap: Optional[int] = None, want_pg: bool = True):
    """The pair factorize after the value ranks: K16's word, K8's sort and
    K10's word entry, which writes the first mask in its own pass →
    (first_mask, pair_gids or None without `want_pg`, n_pairs, rep), the
    JAX function's outputs (cap >= n)."""
    n = gids.shape[0]
    if n == 0:
        dev = gids.device
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev)
                if want_pg else None,
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int32, device=dev))
    sidx, words = pair_sort(gids, vid, pair_live,
                            GID_MAX if gid_cap is None else gid_cap)
    cmp_mask, nan, dead_shift = _word_key(words)
    pg, n_pairs, rep, first = group_ids_words(
        words.last, sidx, cmp_mask, nan, dead_shift, cap, first=True,
        want_gids=want_pg)
    return first, pg, n_pairs, rep

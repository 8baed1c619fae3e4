"""Device equi-join primitives — the LUT (bounded-key) and sort formulations.

The reference's HashJoinExec builds an open-address table over the build
side and probes it row at a time (executor/hash_table.go:77-146). When the
build keys live in a small dense domain — known from the device cache's
per-column (lo, hi) bounds, which dense surrogate keys and every
dictionary-encoded string column satisfy — the build scatters its rows
into a domain-sized table once and every probe is a gather:

  * **unique** (the PK-FK shape): probe-shaped output, no expansion. The
    build's largest count per code guards the planner's uniqueness bet; a
    lost bet re-runs the join in expand mode.
  * **multi**: per probe row a (start, count) window into the build rows
    ordered by code, which `expand` materializes into a static
    `out_cap`-shaped batch, reporting the true total so an overflow
    retries at the exact capacity.

Four hand-written CUDA kernels run it on the card (csrc/lut_join.cu,
csrc/join_expand.cu):

  K4 `lut_build`  pack the build keys, count rows per code, LUT of row ids
  K5 `lut_probe`  pack the probe keys, gather match / (start, count)
  K6 `lut_order`  starts (exclusive scan of the counts) and the stable
                  build-row order by code
  K7 `join_expand` the expansion of (start, count) windows into slots
                  (wrapper `expand`)

Each wrapper takes its plain torch version for CPU tensors and launches its
kernel for CUDA tensors, or raises on anything the kernel does not take.
`lut_join_unique` / `lut_join_multi` compose them over raw key columns
for the join-tree programs (executor/tree_fragment.py). `pack_bounded_codes`,
`lut_probe_unique`, `lut_probe_multi` and `expand` keep the JAX package's
functions (tidb_tpu/ops/join.py) with their exact results; the first is
plain torch, the other three run through the wrappers.

The sort formulation runs joins whose keys have no bounded domain
(tidb_tpu/ops/join.py `combine_keys`, `sorted_probe_unique`,
`sorted_probe_multi`): build and probe keys are concatenated and reduced
to one exact dense code per row by the sort factorize of
ops/factorize.py (K9 + K8 + K10); the build codes sort with an INT64_MAX
sentinel for dead or NULL rows (K9 + K8), and every probe row binary-
searches them:

  K11 `sorted_search`  lower (and upper) bound of each probe code in the
                       sorted build codes through a bucket directory built
                       once a call (`directory_params`), the hit test and
                       the gather of the build row id; the same kernel
                       answers `searchsorted` for the device IN list
                       (ops/xp.py)
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from tidb_tpu_torch.ops import cuda_kernels as ck

#: key columns K4 and K5 pack at most
MAX_JOIN_KEYS = 4
#: the sort key of dead or NULL build rows (dense codes stay far below it)
SENTINEL = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# Plain torch: the JAX package's pack_bounded_codes, and each kernel's
# plain version
# ---------------------------------------------------------------------------


def pack_bounded_codes(keys: Sequence[Tuple], bounds: Sequence[Tuple[int, int]]):
    """Pack multi-column keys with known per-column (lo, hi) bounds into one
    dense int64 code in [0, prod(hi-lo+1)) — no sort, pure arithmetic.

    → (codes (N,) int64, ok (N,) bool). `ok` is False when any column is
    NULL or falls outside its bounds (such rows match nothing)."""
    v0 = keys[0][0]
    n = v0.shape[0]
    codes = torch.zeros(n, dtype=torch.int64, device=v0.device)
    ok = torch.ones(n, dtype=torch.bool, device=v0.device)
    stride = 1
    for (v, m), (lo, hi) in zip(keys, bounds):
        v = v.to(torch.int64)
        ok = ok & m & (v >= lo) & (v <= hi)
        codes = codes + (v.clamp(lo, hi) - lo) * stride
        stride *= (hi - lo + 1)
    return codes, ok


def _strides(bounds) -> List[int]:
    out, stride = [], 1
    for lo, hi in bounds:
        out.append(stride)
        stride *= (hi - lo + 1)
    return out


def _row_ok(ok, live, n_live: Optional[int]):
    if live is not None:
        ok = ok & live
    if n_live is not None:
        ok = ok & (torch.arange(ok.shape[0], device=ok.device) < n_live)
    return ok


def lut_build_plain(keys, bounds, domain: int, live=None,
                    n_live: Optional[int] = None, want_lut: bool = True,
                    want_codes: bool = False):
    """Plain torch version of K4 → (cnt (domain+1,) int32 — the sentinel
    slot `domain` counts NULL/out-of-domain/dead rows, lut (domain+1,)
    int32 or None — a row id per code, -1 where none, maxcnt () int32 —
    the largest count of a real code, codes (nb,) int32 or None)."""
    codes, ok = pack_bounded_codes(keys, bounds)
    ok = _row_ok(ok, live, n_live)
    code = torch.where(ok, codes, torch.full_like(codes, domain))
    dev = code.device
    cnt = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, code, torch.ones_like(code, dtype=torch.int32))
    lut = None
    if want_lut:
        lut = torch.full((domain + 1,), -1, dtype=torch.int32, device=dev)
        rows = torch.nonzero(ok).reshape(-1)
        lut[code[rows]] = rows.to(torch.int32)
    maxcnt = cnt[:domain].max()
    return cnt, lut, maxcnt, (code.to(torch.int32) if want_codes else None)


def lut_probe_plain(keys, bounds, cnt, table, live, nb: int, unique: bool):
    """Plain torch version of K5. Unique → (match_idx (P,) int32 clamped to
    [0, nb), 0 when unmatched; matched (P,) bool) with `table` = lut;
    multi → (start (P,) int32, count (P,) int32) with `table` = starts.
    Reads cnt[code] where the kernel reads the table alone (the
    invariants of `lut_probe`)."""
    codes, ok = pack_bounded_codes(keys, bounds)
    ok = _row_ok(ok, live, None)
    domain = cnt.shape[0] - 1
    pc = codes.clamp(0, domain - 1)
    c, t = cnt[pc], table[pc]
    if unique:
        matched = ok & (c > 0)
        idx = torch.where(matched, t, torch.zeros_like(t))
        return idx.clamp(0, nb - 1), matched
    return t, torch.where(ok, c, torch.zeros_like(c))


def lut_order_plain(codes, cnt):
    """Plain torch version of K6 → (starts (domain+1,) int32, the exclusive
    scan of cnt; order (nb,) int32, build row ids stably sorted by code)."""
    starts = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    order = torch.sort(codes, stable=True).indices.to(torch.int32)
    return starts, order


def expand_plain(start, count, order, out_cap: int, outer: bool,
                 probe_live):
    """Plain torch version of K7: the JAX package's `expand` (scatter-max
    of row marks at each row's first slot, then a running max)."""
    nb = order.shape[0]
    P = count.shape[0]
    dev = count.device
    oc = torch.clamp(count, min=1) if outer else count
    oc = torch.where(probe_live, oc, torch.zeros_like(oc)).to(torch.int64)
    cum = torch.cumsum(oc, 0)
    total = cum[P - 1] if P else torch.zeros((), dtype=torch.int64,
                                              device=dev)
    begin = cum - oc
    iota_p = torch.arange(P, dtype=torch.int32, device=dev)
    marks = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
    at = torch.where(oc > 0, begin, torch.full_like(begin, out_cap))
    at = torch.where(at < out_cap, at, torch.full_like(at, out_cap))
    marks.scatter_reduce_(0, at, iota_p + 1, reduce="amax")
    p_idx = torch.cummax(marks[:out_cap], 0).values - 1
    p_safe = p_idx.clamp(0, max(P - 1, 0))
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    if P:
        k = (j - begin[p_safe]).to(torch.int32)
        matched = (p_idx >= 0) & (k < count[p_safe]) & (j < total)
        b_pos = start[p_safe].to(torch.int64) + k
        b_idx = order[b_pos.clamp(0, nb - 1)]
    else:
        k = torch.zeros(out_cap, dtype=torch.int32, device=dev)
        matched = torch.zeros(out_cap, dtype=torch.bool, device=dev)
        b_idx = torch.zeros(out_cap, dtype=torch.int32, device=dev)
    out_live = (j < total) & (p_idx >= 0)
    return (p_safe.to(torch.int32), b_idx.to(torch.int32), matched,
            out_live, k, total)


# ---------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------


def _key_cols(keys, bounds, what: str):
    """Validate K4/K5 key columns → (the columns as the kernel reads them:
    int32 or int64 values with bool masks, their row count)."""
    k = len(keys)
    if not 1 <= k <= MAX_JOIN_KEYS or len(bounds) != k:
        raise ck.KernelError(f"{what}: {k} key columns "
                             f"(1..{MAX_JOIN_KEYS} taken)")
    n = keys[0][0].shape[0]
    cols = []
    for v, m in keys:
        if v.dtype not in (torch.int64, torch.int32):
            if v.dtype.is_floating_point or v.dtype.is_complex:
                raise ck.KernelError(f"{what}: key dtype {v.dtype} is not "
                                     f"an integer code")
            v = v.to(torch.int32)
        if m.dtype != torch.bool:
            raise ck.KernelError(f"{what}: key masks must be bool")
        if v.dim() != 1 or v.shape != (n,) or m.shape != (n,):
            raise ck.KernelError(f"{what}: key columns of unequal shapes")
        ck.require_cuda(v, m, what=what)
        cols.append((v, m))
    return cols, n


@functools.lru_cache(maxsize=256)
def _bounds_domain(bounds: Tuple[Tuple[int, int], ...]) -> int:
    """The code count of these per-key bounds, or -1 when one is empty."""
    want = 1
    for lo, hi in bounds:
        if hi < lo:
            return -1
        want *= hi - lo + 1
    return want


def _check_domain(domain: int, bounds, what: str):
    """Raise unless the bounds' code count is `domain` (and fits int32);
    → the bounds as a tuple of int pairs."""
    bounds = tuple((int(lo), int(hi)) for lo, hi in bounds)
    want = _bounds_domain(bounds)
    if want < 0:
        lo, hi = next((lo, hi) for lo, hi in bounds if hi < lo)
        raise ck.KernelError(f"{what}: empty bounds ({lo}, {hi})")
    if want != domain or not 1 <= domain < 2 ** 31 - 1:
        raise ck.KernelError(f"{what}: domain {domain} does not match the "
                             f"bounds ({want}) or exceeds int32")
    return bounds


class _BuildArgs(ctypes.Structure):
    """K4's argument block (csrc/lut_join.cu `BuildArgs`)."""
    _fields_ = [("vals", ctypes.c_void_p * MAX_JOIN_KEYS),
                ("masks", ctypes.c_void_p * MAX_JOIN_KEYS),
                ("live", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("lo", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("hi", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("stride", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("nb", ctypes.c_longlong),
                ("n_live", ctypes.c_longlong),
                ("domain", ctypes.c_longlong),
                ("is64", ctypes.c_int * MAX_JOIN_KEYS),
                ("k", ctypes.c_int),
                ("flags", ctypes.c_int)]


#: `_BuildArgs.flags` bits (csrc/lut_join.cu BUILD_LUT, BUILD_CODES)
BUILD_LUT, BUILD_CODES = 1, 2


@functools.lru_cache(maxsize=256)
def build_plan(is64: Tuple[bool, ...], bounds: Tuple[Tuple[int, int], ...],
               want_lut: bool, want_codes: bool) -> bytes:
    """K4's argument block for one key signature, a pure function: the
    key count, each key's width (`is64`), bounds and stride, the domain
    and the outputs asked for filled in; every pointer, nb and n_live
    zero. → its bytes: a call copies them into a `_BuildArgs` and fills
    in its pointers, nb and n_live."""
    a = _BuildArgs()
    a.k = len(bounds)
    a.is64[:a.k] = [int(w) for w in is64]
    a.lo[:a.k] = [lo for lo, _ in bounds]
    a.hi[:a.k] = [hi for _, hi in bounds]
    a.stride[:a.k] = _strides(bounds)
    a.domain = math.prod(hi - lo + 1 for lo, hi in bounds)
    a.flags = (BUILD_LUT if want_lut else 0) | \
        (BUILD_CODES if want_codes else 0)
    return bytes(a)


@functools.lru_cache(maxsize=256)
def build_layout(domain: int, nb: int, want_lut: bool,
                 want_codes: bool) -> Tuple[int, int, int]:
    """K4's one int32 output allocation, as csrc/lut_join.cu
    `tt_lut_build` lays it out: maxcnt at word 0, cnt (domain + 1) from
    word 1, then lut (domain + 1, `want_lut`), then codes (nb,
    `want_codes`) → (lut's first word or -1, codes' first word or -1,
    the words in all)."""
    end = domain + 2
    lut = end if want_lut else -1
    end += domain + 1 if want_lut else 0
    codes = end if want_codes else -1
    return lut, codes, end + (nb if want_codes else 0)


def lut_build(keys, bounds, domain: int, live=None,
              n_live: Optional[int] = None, want_lut: bool = True,
              want_codes: bool = False):
    """K4 wrapper → (cnt, lut or None, maxcnt, codes or None), as
    `lut_build_plain`. One C call: the outputs are views of one
    allocation (`build_layout`), which the entry fills and the kernel
    writes; its arguments are the cached `build_plan` with this call's
    pointers."""
    if keys[0][0].device.type == "cpu":
        return lut_build_plain(keys, bounds, domain, live, n_live, want_lut,
                               want_codes)
    bounds = _check_domain(domain, bounds, "lut_build")
    cols, nb = _key_cols(keys, bounds, "lut_build")
    if nb >= 2 ** 31:
        raise ck.KernelError(f"lut_build: build rows {nb} out of range")
    dev = cols[0][0].device
    if live is not None:
        ck.require_cuda(live, what="lut_build")
        if live.dtype != torch.bool or live.shape != (nb,):
            raise ck.KernelError("lut_build: live must be bool of the "
                                 "build's length")
    want_lut, want_codes = bool(want_lut), bool(want_codes)
    lut_at, codes_at, words = build_layout(domain, nb, want_lut, want_codes)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    a = _BuildArgs.from_buffer_copy(build_plan(
        tuple(v.dtype == torch.int64 for v, _ in cols), bounds, want_lut,
        want_codes))
    for q, (v, m) in enumerate(cols):
        a.vals[q] = v.data_ptr()
        a.masks[q] = m.data_ptr()
    a.live = None if live is None else live.data_ptr()
    a.out = buf.data_ptr()
    a.nb = nb
    a.n_live = nb if n_live is None else int(n_live)
    rc = ck.library("lut_join").tt_lut_build(ctypes.addressof(a),
                                             ck.stream_ptr(dev))
    if nb > 0:                      # for nb == 0 the entry only fills
        ck.count("lut_build")
    ck.check(rc, "lut_build")
    # the views, made while the kernel runs
    return (buf[1:domain + 2],
            buf[lut_at:lut_at + domain + 1] if want_lut else None, buf[0],
            buf[codes_at:] if want_codes else None)


class _ProbeArgs(ctypes.Structure):
    """K5's argument block (csrc/lut_join.cu `ProbeArgs`)."""
    _fields_ = [("vals", ctypes.c_void_p * MAX_JOIN_KEYS),
                ("masks", ctypes.c_void_p * MAX_JOIN_KEYS),
                ("live", ctypes.c_void_p),
                ("table", ctypes.c_void_p),
                ("out_a", ctypes.c_void_p),
                ("out_b", ctypes.c_void_p),
                ("lo", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("hi", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("stride", ctypes.c_longlong * MAX_JOIN_KEYS),
                ("n", ctypes.c_longlong),
                ("domain", ctypes.c_longlong),
                ("is64", ctypes.c_int * MAX_JOIN_KEYS),
                ("k", ctypes.c_int),
                ("unique_mode", ctypes.c_int),
                ("nb", ctypes.c_int),
                ("reserved", ctypes.c_int)]


@functools.lru_cache(maxsize=256)
def probe_plan(is64: Tuple[bool, ...], bounds: Tuple[Tuple[int, int], ...],
               nb: int, unique: bool) -> bytes:
    """K5's argument block for one key signature, a pure function: the
    key count, each key's width (`is64`), bounds and stride, the domain,
    nb and the mode filled in; every pointer and n zero. → its bytes: a
    call copies them into a `_ProbeArgs` and fills in its pointers and
    n."""
    a = _ProbeArgs()
    a.k = len(bounds)
    a.is64[:a.k] = [int(w) for w in is64]
    a.lo[:a.k] = [lo for lo, _ in bounds]
    a.hi[:a.k] = [hi for _, hi in bounds]
    a.stride[:a.k] = _strides(bounds)
    a.domain = math.prod(hi - lo + 1 for lo, hi in bounds)
    a.unique_mode = int(unique)
    a.nb = nb
    return bytes(a)


def lut_probe(keys, bounds, cnt, table, live, nb: int, unique: bool):
    """K5 wrapper, as `lut_probe_plain`. On the card the kernel reads the
    table alone, which holds for the tables the LUT join passes:
      * unique: `table` is K4's lut (`lut_build` fills it with -1 and
        writes a row id for every counted row), so for a code below the
        domain lut[code] >= 0 exactly when cnt[code] > 0; matched is
        lut[code] >= 0;
      * multi: `table` is K6's starts over domain + 1 slots, the
        exclusive scan of cnt; count is starts[code + 1] - starts[code].
    `cnt` gives the domain (its length - 1) and is checked, not read."""
    if keys[0][0].device.type == "cpu":
        return lut_probe_plain(keys, bounds, cnt, table, live, nb, unique)
    domain = cnt.shape[0] - 1
    bounds = _check_domain(domain, bounds, "lut_probe")
    cols, n = _key_cols(keys, bounds, "lut_probe")
    ck.require_cuda(cnt, table, what="lut_probe")
    if cnt.dtype != torch.int32 or table.dtype != torch.int32 or \
            table.shape[0] < domain + (not unique):
        raise ck.KernelError("lut_probe: cnt/table must be int32 of the "
                             "domain's length")
    if live is not None:
        ck.require_cuda(live, what="lut_probe")
        if live.dtype != torch.bool or live.shape != (n,):
            raise ck.KernelError("lut_probe: live must be bool of the "
                                 "probe's length")
    if not 1 <= nb < 2 ** 31:
        raise ck.KernelError(f"lut_probe: build rows {nb} out of range")
    dev = cols[0][0].device
    a = _ProbeArgs.from_buffer_copy(probe_plan(
        tuple(v.dtype == torch.int64 for v, _ in cols), bounds, nb,
        bool(unique)))
    for q, (v, m) in enumerate(cols):
        a.vals[q] = v.data_ptr()
        a.masks[q] = m.data_ptr()
    out_a = torch.empty(n, dtype=torch.int32, device=dev)
    out_b = torch.empty(n, dtype=torch.bool if unique else torch.int32,
                        device=dev)
    a.live = None if live is None else live.data_ptr()
    a.table = table.data_ptr()
    a.out_a = out_a.data_ptr()
    a.out_b = out_b.data_ptr()
    a.n = n
    rc = ck.library("lut_join").tt_lut_probe(ctypes.addressof(a),
                                             ck.stream_ptr(dev))
    if n > 0:                       # the entry launches nothing for n == 0
        ck.count("lut_probe")
    ck.check(rc, "lut_probe")
    return out_a, out_b


def _long_run(nb: int) -> int:
    """Runs longer than this are placed by a scan over the build rows
    instead of an insertion sort (K6)."""
    return max(64, math.isqrt(max(nb, 1)))


def lut_order(codes, cnt):
    """K6 wrapper → (starts, order), as `lut_order_plain`. `codes` holds a
    code in [0, domain] per build row (K4's `want_codes` output)."""
    if codes.device.type == "cpu":
        return lut_order_plain(codes, cnt)
    ck.require_cuda(codes, cnt, what="lut_order")
    if codes.dtype != torch.int32 or cnt.dtype != torch.int32 or \
            codes.dim() != 1 or cnt.dim() != 1:
        raise ck.KernelError("lut_order: int32 vectors expected")
    nb = codes.shape[0]
    domain = cnt.shape[0] - 1
    if not 1 <= domain < 2 ** 31 - 1 or nb >= 2 ** 31:
        raise ck.KernelError(f"lut_order: domain {domain} / rows {nb} out "
                             f"of range")
    dev = codes.device
    long_run = _long_run(nb)
    starts = torch.empty(domain + 1, dtype=torch.int32, device=dev)
    order = torch.empty(nb, dtype=torch.int32, device=dev)
    cursor = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
    long_list = torch.zeros(1 + nb // (long_run + 1) + 1, dtype=torch.int32,
                            device=dev)
    block = torch.empty(-(-max(domain + 1, nb) // 1024), dtype=torch.int32,
                        device=dev)
    rc = ck.library("join_expand").tt_lut_order(
        codes.data_ptr(), cnt.data_ptr(), nb, domain, long_run,
        starts.data_ptr(), order.data_ptr(), cursor.data_ptr(),
        long_list.data_ptr(), block.data_ptr(), ck.stream_ptr(dev))
    ck.count("lut_order")
    ck.check(rc, "lut_order")
    return starts, order


#: probe rows, and output slots, a tile of K7 (csrc/join_expand.cu EX_TILE)
EXPAND_TILE = 2048


def expand_scratch_bytes(P: int, out_cap: int) -> int:
    """Bytes of the stream scratch K7 takes for P probe rows and out_cap
    slots (csrc/join_expand.cu `expand_scratch`): the zeroed part (a
    16-byte tile counter and completion count, a 4-byte look-back flag a
    probe tile and a 4-byte mark a slot, each rounded up to 16 bytes),
    then the probe tiles' aggregates and inclusive prefixes (8 bytes
    each) and each slot tile's first row (12 bytes)."""
    tiles = max(1, -(-P // EXPAND_TILE))
    slot_tiles = -(-out_cap // EXPAND_TILE)
    return (16 + -(-4 * tiles // 16) * 16 + -(-4 * out_cap // 16) * 16 +
            16 * tiles + 12 * slot_tiles)


def expand_layout(out_cap: int) -> int:
    """K7's one output allocation for out_cap slots, in int32 words: the
    total (two words), then p_idx, b_idx and k (out_cap each), then
    matched and out_live as bool rows of out_cap bytes."""
    return 2 + 3 * out_cap + -(-2 * out_cap // 4)


def expand(start, count, order, out_cap: int, outer: bool, probe_live):
    """K7 wrapper: materialize per-probe matches into a static
    (out_cap,)-shaped batch, as tidb_tpu/ops/join.py expand → (p_idx,
    b_idx, matched, out_live, k, total). Equal to `expand_plain` on every
    live slot and in `total`; dead slots carry p_idx 0, k 0 and b_idx 0.
    One launch a call; the six outputs are views of one allocation."""
    if count.device.type == "cpu":
        return expand_plain(start, count, order, out_cap, outer, probe_live)
    ck.require_cuda(start, count, order, probe_live, what="join_expand")
    P = count.shape[0]
    nb = order.shape[0]
    if start.dtype != torch.int32 or count.dtype != torch.int32 or \
            order.dtype != torch.int32 or probe_live.dtype != torch.bool:
        raise ck.KernelError("join_expand: int32 start/count/order and a "
                             "bool live mask expected")
    if start.shape != (P,) or probe_live.shape != (P,) or order.dim() != 1:
        raise ck.KernelError("join_expand: start/count/live of unequal "
                             "shapes")
    if not 1 <= nb < 2 ** 31 or not 0 <= out_cap < 2 ** 31 or \
            P >= 2 ** 31:
        raise ck.KernelError(f"join_expand: build rows {nb} / out_cap "
                             f"{out_cap} / probe rows {P} out of range")
    dev = count.device
    buf = torch.empty(expand_layout(out_cap), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    stream = ck.stream_ptr(dev)
    need = expand_scratch_bytes(P, out_cap)
    ent = ck.stream_scratch("join_expand", dev, stream)
    with ent.lock:      # from the call's scratch memset to its launch
        rc = ck.library("join_expand").tt_join_expand(
            start.data_ptr(), count.data_ptr(), order.data_ptr(),
            probe_live.data_ptr(), P, nb, int(bool(outer)), out_cap,
            base + 8, base + 8 + 4 * out_cap, base + 8 + 8 * out_cap,
            base + 8 + 12 * out_cap, base + 8 + 13 * out_cap, base,
            ent.ensure(need, dev), need, stream)
    ck.count("join_expand")
    ck.check(rc, "join_expand")
    # the views, made while the kernel runs (the layout of expand_layout)
    t, p_idx, b_idx, k, flags = buf.split_with_sizes(
        (2, out_cap, out_cap, out_cap, buf.shape[0] - 2 - 3 * out_cap))
    flags = flags.view(torch.bool)
    return (p_idx, b_idx, flags[:out_cap], flags[out_cap:2 * out_cap], k,
            t.view(torch.int64).view(()))


# ---------------------------------------------------------------------------
# Join formulations over raw key columns (the join-tree programs)
# ---------------------------------------------------------------------------


def lut_join_unique(bkeys, pkeys, bounds, domain: int, blive=None,
                    plive=None):
    """Unique-build LUT join: K4 over the build keys, K5 over the probe
    keys → (match_idx (P,) int32, matched (P,) bool, unique () bool).
    `unique` is the runtime guard of the planner's uniqueness bet; on
    False the caller re-runs the join in expand mode."""
    cnt, lut, maxcnt, _ = lut_build(bkeys, bounds, domain, live=blive)
    match_idx, matched = lut_probe(pkeys, bounds, cnt, lut, plive,
                                   bkeys[0][0].shape[0], unique=True)
    return match_idx, matched, maxcnt <= 1


def lut_join_multi(bkeys, pkeys, bounds, domain: int, blive=None,
                   plive=None):
    """General LUT join: K4 (counts and codes), K6 (starts and the stable
    build order), K5 (per-probe windows) → (start (P,) int32, count (P,)
    int32, order (nb,) int32)."""
    cnt, _, _, codes = lut_build(bkeys, bounds, domain, live=blive,
                                 want_lut=False, want_codes=True)
    starts, order = lut_order(codes, cnt)
    start, count = lut_probe(pkeys, bounds, cnt, starts, plive,
                             bkeys[0][0].shape[0], unique=False)
    return start, count, order


# ---------------------------------------------------------------------------
# The JAX package's functions over pre-packed codes
# ---------------------------------------------------------------------------


def _packed(build_codes, ok_b, domain: int, probe_codes, ok_p):
    """Pre-packed codes as one key column over [0, domain). Build rows
    with `ok_b` set must hold codes in that range (as pack_bounded_codes
    gives them); probe codes clamp into it, as the JAX functions do."""
    return ([(build_codes, ok_b)], [(probe_codes.clamp(0, domain - 1), ok_p)],
            [(0, domain - 1)])


def lut_probe_unique(build_codes, ok_b, domain: int, probe_codes, ok_p):
    """→ (match_idx (P,) int32, matched (P,) bool, unique () bool), as
    tidb_tpu/ops/join.py lut_probe_unique."""
    return lut_join_unique(*_packed(build_codes, ok_b, domain, probe_codes,
                                    ok_p), domain)


def lut_probe_multi(build_codes, ok_b, domain: int, probe_codes, ok_p):
    """→ (start (P,) int32, count (P,) int32, order (nb,) int32), as
    tidb_tpu/ops/join.py lut_probe_multi."""
    return lut_join_multi(*_packed(build_codes, ok_b, domain, probe_codes,
                                   ok_p), domain)


# ---------------------------------------------------------------------------
# Sort formulation — unbounded or computed keys
# ---------------------------------------------------------------------------


def combine_keys(keys: Sequence[Tuple], live):
    """Collapse multi-column keys into one exact int64 code per row, as
    tidb_tpu/ops/join.py combine_keys → (codes (N,) int64, code_valid (N,)
    bool — False where any key column is NULL). For joins the caller
    concatenates build and probe rows first so the codes share one space.
    The codes are per-column dense ranks packed by ops/factorize.py
    pack_codes (K9 + K8 + K10 on the card), below (N+1)²."""
    from tidb_tpu_torch.ops.factorize import pack_codes
    n = live.shape[0]
    code_valid = torch.ones(n, dtype=torch.bool, device=live.device)
    for _, m in keys:
        code_valid = code_valid & m
    return pack_codes(keys, live).to(torch.int64), code_valid


def sorted_build(build_codes, ok_b, code_bound: Optional[int] = None):
    """The build side of the sort formulation → (sorted codes (nb,) int64
    with INT64_MAX in place of dead/NULL rows, which form the tail; order
    (nb,) int32 — the build row ids in that order, ties in row order).
    Plain: a stable torch.sort of the sentinel key, as the JAX functions.
    On the card: K9 + K8 over (dead/NULL flag, code), the same order for
    codes below the sentinel; `code_bound` (codes in [0, code_bound))
    spares it the min/max read-back."""
    sort_key = torch.where(ok_b, build_codes,
                           torch.full_like(build_codes, SENTINEL))
    if build_codes.device.type == "cpu":
        order = torch.sort(sort_key, stable=True).indices
        return sort_key[order], order.to(torch.int32)
    from tidb_tpu_torch.ops.factorize import SortOp, lexsort
    order = lexsort([SortOp(ok_b, desc=True),
                     SortOp(build_codes, ok_b, hi=code_bound)])
    return sort_key[order].contiguous(), order


def sorted_search_unique_plain(sorted_codes, order, probe_codes, ok_p):
    """Plain torch version of K11's unique mode → (match_idx (P,) int32,
    0 where unmatched; matched (P,) bool; unique () bool — no two equal
    non-sentinel neighbours in the sorted codes)."""
    nb = sorted_codes.shape[0]
    dup = (sorted_codes[1:] == sorted_codes[:-1]) & \
        (sorted_codes[1:] != SENTINEL)
    unique = torch.logical_not(dup.any())
    pos = torch.searchsorted(sorted_codes, probe_codes).clamp(0, nb - 1)
    matched = (sorted_codes[pos] == probe_codes) & ok_p
    match_idx = torch.where(matched, order[pos].to(torch.int32),
                            torch.zeros_like(pos, dtype=torch.int32))
    return match_idx, matched, unique


def sorted_search_multi_plain(sorted_codes, probe_codes, ok_p):
    """Plain torch version of K11's multi mode → (start (P,) int32, the
    left insertion point; count (P,) int32, right - left where ok_p)."""
    lo = torch.searchsorted(sorted_codes, probe_codes)
    hi = torch.searchsorted(sorted_codes, probe_codes, right=True)
    count = torch.where(ok_p, (hi - lo).to(torch.int32),
                        torch.zeros_like(hi, dtype=torch.int32))
    return lo.to(torch.int32), count


#: K11's directory holds at most 2^DIR_MAX_LOG2 buckets
#: (csrc/sorted_groups.cu DIR_MAX_LOG2)
DIR_MAX_LOG2 = 22
#: the codes K11's directory range leaves out at each end of a table of
#: more than 2 * DIR_TRIM + 1 codes (csrc/sorted_groups.cu TRIM): a few
#: outliers then widen no bucket
DIR_TRIM = 32
#: the search parameters ahead of the directory in its scratch
_DIR_PARAM_BYTES = 64


def directory_log2(nb: int) -> int:
    """k: K11's directory over nb sorted codes has 2^k buckets, about
    nb / 2 rounded up to a power of two (two codes a bucket on spread
    codes), at least 1 and at most 2^DIR_MAX_LOG2 (the directory is
    8 * 2^k bytes)."""
    return min((max(1, -(-nb // 2)) - 1).bit_length(), DIR_MAX_LOG2)


def directory_trim(n_real: int) -> int:
    """The codes K11's directory range leaves out at each end of n_real
    codes below INT64_MAX: its range is [a[t], a[n_real - 1 - t]]."""
    return DIR_TRIM if n_real > 2 * DIR_TRIM + 1 else 0


def directory_params(nb: int, span: int) -> Tuple[int, int]:
    """(k, shift) of K11's directory, a pure function (the card computes
    the shift from the table's own span): of nb sorted codes, those below
    INT64_MAX and `directory_trim` in from each end span hi - lo = `span`
    (0 to 2^64 - 2); they fall into 2^k buckets of (x - lo) >> shift
    (codes at or below lo in bucket 0, at or above hi in the last), shift
    the least that leaves span >> shift below 2^k. A shift of 64 (span >=
    2^63 with k = 0) puts every code in bucket 0."""
    if not 0 <= span <= (1 << 64) - 2:
        raise ValueError(f"span {span} out of range")
    k = directory_log2(nb)
    return k, max(0, span.bit_length() - k)


def _dir_scratch(nb: int, dev):
    """(k, the directory's scratch: the search parameters, then 2^k pairs
    of int32 bucket bounds; csrc/sorted_groups.cu tt_sorted_dir_bytes)."""
    k = directory_log2(nb)
    return k, torch.empty(_DIR_PARAM_BYTES + 8 * (1 << k),
                          dtype=torch.uint8, device=dev)


def _search_args(sorted_codes, probe_codes, ok_p):
    ck.require_cuda(sorted_codes, probe_codes, ok_p, what="sorted_search")
    nb, P = sorted_codes.shape[0], probe_codes.shape[0]
    if sorted_codes.dtype != torch.int64 or \
            probe_codes.dtype != torch.int64 or ok_p.dtype != torch.bool:
        raise ck.KernelError("sorted_search: int64 codes and a bool mask "
                             "expected")
    if not 1 <= nb < 2 ** 31 or ok_p.shape != (P,):
        raise ck.KernelError(f"sorted_search: build rows {nb} out of range "
                             f"or a mask of the wrong length")
    return nb, P


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def sorted_search_unique(sorted_codes, order, probe_codes, ok_p):
    """K11 wrapper (unique mode), as `sorted_search_unique_plain`: a
    directory launch, then one probe launch that also writes `unique`.
    match_idx and matched are views of one allocation, made after the
    launch; `unique` has its own (callers keep it past the others)."""
    if sorted_codes.device.type == "cpu":
        return sorted_search_unique_plain(sorted_codes, order, probe_codes,
                                          ok_p)
    nb, P = _search_args(sorted_codes, probe_codes, ok_p)
    ck.require_cuda(order, what="sorted_search")
    if order.dtype != torch.int32 or order.shape != (nb,):
        raise ck.KernelError("sorted_search: int32 build order expected")
    dev = sorted_codes.device
    at_matched = _round16(4 * P)
    buf = torch.empty(at_matched + P, dtype=torch.bool, device=dev)
    unique = torch.empty((), dtype=torch.bool, device=dev)
    base = buf.data_ptr()
    k, scratch = _dir_scratch(nb, dev)
    rc = ck.library("sorted_groups").tt_sorted_probe_unique(
        sorted_codes.data_ptr(), order.data_ptr(), nb,
        probe_codes.data_ptr(), ok_p.data_ptr(), P, k, scratch.data_ptr(),
        base, base + at_matched, unique.data_ptr(), ck.stream_ptr(dev))
    ck.count("sorted_search")
    ck.check(rc, "sorted_search")
    return buf[:4 * P].view(torch.int32), buf[at_matched:], unique


def sorted_search_multi(sorted_codes, probe_codes, ok_p):
    """K11 wrapper (multi mode), as `sorted_search_multi_plain`; start and
    count are views of one allocation."""
    if sorted_codes.device.type == "cpu":
        return sorted_search_multi_plain(sorted_codes, probe_codes, ok_p)
    nb, P = _search_args(sorted_codes, probe_codes, ok_p)
    dev = sorted_codes.device
    step = _round16(4 * P) // 4
    buf = torch.empty(2 * step, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    k, scratch = _dir_scratch(nb, dev)
    rc = ck.library("sorted_groups").tt_sorted_probe_multi(
        sorted_codes.data_ptr(), nb, probe_codes.data_ptr(),
        ok_p.data_ptr(), P, k, scratch.data_ptr(), base, base + 4 * step,
        ck.stream_ptr(dev))
    if P > 0:
        ck.count("sorted_search")
    ck.check(rc, "sorted_search")
    return buf[:P], buf[step:step + P]


def sorted_probe_unique(build_codes, build_valid, build_live, probe_codes,
                        probe_valid, probe_live,
                        code_bound: Optional[int] = None):
    """Unique-build sort-merge probe, as tidb_tpu/ops/join.py
    sorted_probe_unique → (match_idx (P,) int32 — build row per probe row,
    0 when unmatched; matched (P,) bool; unique () bool). On the card:
    K9 + K8 sort the build codes, K11 searches them."""
    sorted_codes, order = sorted_build(build_codes, build_valid & build_live,
                                       code_bound)
    return sorted_search_unique(sorted_codes, order, probe_codes,
                                probe_valid & probe_live)


def sorted_probe_multi(build_codes, ok_b, probe_codes, ok_p,
                       code_bound: Optional[int] = None):
    """General sort-merge probe, as tidb_tpu/ops/join.py
    sorted_probe_multi → (start (P,) int32, count (P,) int32, order (nb,)
    int32 — build rows by code, the dead/NULL sentinel rows last)."""
    sorted_codes, order = sorted_build(build_codes, ok_b, code_bound)
    start, count = sorted_search_multi(sorted_codes, probe_codes, ok_p)
    return start, count, order


def searchsorted(sorted_seq, v, right: bool = False):
    """Insertion points (int64) of `v` in the ascending `sorted_seq`:
    torch.searchsorted for CPU tensors, K11 for CUDA int64 tensors."""
    if sorted_seq.device.type == "cpu":
        return torch.searchsorted(sorted_seq.contiguous(), v.contiguous(),
                                  right=right)
    sorted_seq, v = sorted_seq.contiguous(), v.contiguous()
    ck.require_cuda(sorted_seq, v, what="sorted_search")
    if sorted_seq.dtype != torch.int64 or v.dtype != torch.int64 or \
            sorted_seq.dim() != 1 or v.dim() != 1:
        raise ck.KernelError("sorted_search: 1-D int64 table and values "
                             "expected")
    out = torch.empty(v.shape[0], dtype=torch.int64, device=v.device)
    k, scratch = _dir_scratch(sorted_seq.shape[0], v.device)
    rc = ck.library("sorted_groups").tt_sorted_search(
        sorted_seq.data_ptr(), sorted_seq.shape[0], v.data_ptr(),
        v.shape[0], int(bool(right)), k, scratch.data_ptr(), out.data_ptr(),
        ck.stream_ptr(v.device))
    if v.shape[0] > 0:
        ck.count("sorted_search")
    ck.check(rc, "sorted_search")
    return out

"""The exchange's key hash, and one rank's rows into fixed-capacity
destination buckets (K23 hash_partition): stage 1 of the staged
exchange; the monolithic program's all_to_all (K24 rank_exchange) and
owner hash (K26 hash_dest).

`shard_of` and `mix_key_code` are the plain torch versions of the JAX
package's hash partition function (`tidb_tpu/parallel/collective.py`
`_mix64`, `shard_of`, `mix_key_code`): the oracle of K23 and K26, which
compute the same bits on the card. Torch has no usable uint64
arithmetic, so the splitmix64 finalizer runs in int64: a multiply wraps
as it is, a logical right shift masks off the sign extension, and the
unsigned modulus is taken from the two 32-bit halves.

The JAX package scatters the payload with `device_emit.emit_partition`
(a lax.sort of (dest, row), a segment_min rank and one `.at[slot].set`
per column). `hash_partition` computes the same outputs: rows ranked
stably within their destination in source order, slot =
dest·bucket_cap + rank, rows past the cap dropped and reported through
`counts` and `need`.

`rank_exchange` is the reference's `exchange(arrays, dest, live, ...)`
over every rank at once, each source writing its buckets straight into
the destinations' receive buffers; `hash_dest` computes a `dest`,
`shard_of(mix_key_code(keys))` or `shard_of(code)` as int32.
parallel/collective re-exports the hash and the exchange.

Each takes its plain version for CPU tensors and launches
csrc/hash_partition.cu for CUDA tensors (or raises on anything the
kernel does not take).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

#: most destinations K23 takes (its per-block counters live in shared
#: memory, and a destination is stored in one byte)
MAX_SHARDS = 64
#: key columns folded per kernel pass (csrc/hash_partition.cu MAX_KEYS)
KEYS_PER_PASS = 16
#: rows per block of csrc/hash_partition.cu
TILE = 1024

#: csrc/hash_partition.cu KeyType of each key dtype
_KEY_TYPES = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
              torch.int32: 3, torch.int64: 4, torch.float32: 5,
              torch.float64: 6}


_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits: the arithmetic shift with the
    copied sign bits masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 bits (the uint64 result's bits)."""
    x = x.to(torch.int64)
    x = (x ^ _srl(x, 30)) * _signed(_M1)
    x = (x ^ _srl(x, 27)) * _signed(_M2)
    return x ^ _srl(x, 31)


def shard_of(codes: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of each key code: `(uint64) _mix64(code) % n_shards`,
    int32. The unsigned modulus comes from the halves:
    h = hi·2³² + lo ⇒ h mod n = ((hi mod n)·(2³² mod n) + lo mod n) mod n."""
    n = int(n_shards)
    h = _mix64(codes)
    hi = _srl(h, 32)
    lo = h & 0xFFFFFFFF
    r = ((hi % n) * ((1 << 32) % n) + lo % n) % n
    return r.to(torch.int32)


def key_canon(v: torch.Tensor) -> torch.Tensor:
    """A key column's values as int64: the JAX package's `astype(int64)`.
    Integers and bools widen; floats truncate toward zero. Where that
    conversion has no defined value the port defines one, which K23
    shares: NaN → 0, v ≥ 2⁶³ → INT64_MAX, v < -2⁶³ → INT64_MIN. Equal
    keys still map equally, so only balance can change."""
    if not v.dtype.is_floating_point:
        return v.to(torch.int64)
    v = v.to(torch.float64)
    big = v >= 2.0 ** 63
    small = v < -(2.0 ** 63)
    nan = torch.isnan(v)
    safe = torch.where(big | small | nan, torch.zeros_like(v), v)
    out = torch.trunc(safe).to(torch.int64)
    out = torch.where(big, torch.full_like(out, _INT64_MAX), out)
    return torch.where(small, torch.full_like(out, _INT64_MIN), out)


def mix_key_code(keys) -> torch.Tensor:
    """Collapse key columns [(values, validity), ...] into one int64 hash
    input for shard_of. Equal values map equally; validity is mixed in
    so NULL keys, whose slot values may differ, co-locate."""
    code = None
    for v, m in keys:
        m = m.to(torch.bool)
        canon = torch.where(m, key_canon(v), torch.zeros((), dtype=torch.int64,
                                                         device=v.device))
        part = canon * 2 + m.to(torch.int64)
        code = part if code is None else code * 1000003 + part
    return code


def bucket_scatter_plain(dest: torch.Tensor, live: torch.Tensor,
                         arrays: Sequence[torch.Tensor], n_shards: int,
                         bucket_cap: int):
    """One source's bucket scatter by given destinations: rows ranked
    stably within their destination by a stable argsort, slot =
    dest·bucket_cap + rank, rows past the cap dropped; a row whose dest
    is outside [0, n_shards) counts as dead. → (bufs [n_shards·bucket_cap]
    per array, sent_live, counts (n_shards,) int32, need () int32)."""
    dev = live.device
    n = live.shape[0]
    dest = dest.to(torch.int64)
    ok_dest = live & (dest >= 0) & (dest < n_shards)
    d = torch.where(ok_dest, dest, torch.full_like(dest, n_shards))
    order = torch.argsort(d, stable=True)
    per_dest = torch.bincount(d, minlength=n_shards + 1)
    first = torch.cumsum(per_dest, 0) - per_dest
    rank_sorted = torch.arange(n, dtype=torch.int64, device=dev) - \
        first[d[order]]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    counts = per_dest[:n_shards].to(torch.int32)
    total = n_shards * bucket_cap
    ok = ok_dest & (rank < bucket_cap)
    # dropped and dead rows land in one spare slot past the end
    slot = torch.where(ok, d * bucket_cap + rank,
                       torch.full_like(d, total))
    sent_live = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    sent_live[slot] = ok
    bufs = []
    for a in arrays:
        buf = torch.zeros(total + 1, dtype=a.dtype, device=dev)
        buf[slot] = torch.where(ok, a, torch.zeros((), dtype=a.dtype,
                                                   device=dev))
        bufs.append(buf[:total])
    return bufs, sent_live[:total], counts, counts.max()


def hash_partition_plain(keys, live: torch.Tensor,
                         arrays: Sequence[torch.Tensor], n_shards: int,
                         bucket_cap: int):
    """Plain torch version: the hash, then a stable argsort of the
    destinations for the ranks. → (bufs [n_shards·bucket_cap] per array,
    sent_live, counts (n_shards,) int32, need () int32)."""
    dest = shard_of(mix_key_code(keys), n_shards)
    return bucket_scatter_plain(dest, live, arrays, n_shards, bucket_cap)


def _check(keys, live, arrays, n_shards: int, bucket_cap: int) -> None:
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if not 1 <= int(n_shards) <= MAX_SHARDS:
        raise ck.KernelError(f"hash_partition: 1 to {MAX_SHARDS} "
                             f"destinations expected, got {n_shards}")
    if int(bucket_cap) < 0:
        raise ck.KernelError("hash_partition: a negative bucket_cap")
    if not keys:
        raise ck.KernelError("hash_partition: at least one key column "
                             "expected")
    if live.dtype != torch.bool or live.dim() != 1:
        raise ck.KernelError("hash_partition: a 1-D bool live mask "
                             "expected")
    n = live.shape[0]
    ck.require_cuda(live, what="hash_partition")
    for v, m in keys:
        ck.require_cuda(v, m, what="hash_partition")
        if v.dtype not in _KEY_TYPES:
            raise ck.KernelError(f"hash_partition: key dtype {v.dtype} "
                                 f"not taken")
        if m.dtype != torch.bool or v.shape != (n,) or m.shape != (n,):
            raise ck.KernelError("hash_partition: a key is a 1-D column "
                                 "with a bool validity of the live "
                                 "mask's length")
    for a in arrays:
        ck.require_cuda(a, what="hash_partition")
        if a.shape != (n,) or a.element_size() not in (1, 2, 4, 8):
            raise ck.KernelError("hash_partition: payload columns are 1-D "
                                 "of the live mask's length, of 1, 2, 4 "
                                 "or 8 bytes an item")
    for t in [live] + [x for k in keys for x in k] + list(arrays):
        if t.device != live.device:
            raise ck.KernelError("hash_partition: every tensor on one "
                                 "device")


def _host_ptrs(values: List[int], ctype):
    return (ctype * max(len(values), 1))(*values)


def hash_partition(keys, live: torch.Tensor, arrays: Sequence[torch.Tensor],
                   n_shards: int, bucket_cap: int
                   ) -> Tuple[List[torch.Tensor], torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """K23 wrapper. keys: [(values, validity)] 1-D columns (bool, int8-64
    or float32/64 values); live: (N,) bool; arrays: (N,) payload columns
    of 1, 2, 4 or 8 bytes an item. → (bufs, sent_live, counts, need) as
    hash_partition_plain; the buffers are zero-filled before the scatter.
    Three launches (more for over 16 keys, or over 16 payload columns of
    one itemsize), no host sync."""
    if live.device.type == "cpu":
        return hash_partition_plain(keys, live, arrays, n_shards,
                                    bucket_cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    _check(keys, live, arrays, n_shards, bucket_cap)
    dev = live.device
    n = live.shape[0]
    n_shards = int(n_shards)
    bucket_cap = int(bucket_cap)
    total = n_shards * bucket_cap
    keys = [(v.contiguous(), m.contiguous()) for v, m in keys]
    arrays = [a.contiguous() for a in arrays]
    live = live.contiguous()
    bufs = [torch.zeros(total, dtype=a.dtype, device=dev) for a in arrays]
    sent_live = torch.zeros(total, dtype=torch.bool, device=dev)
    counts = torch.zeros(n_shards, dtype=torch.int32, device=dev)
    need = torch.zeros(1, dtype=torch.int32, device=dev)
    dest = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
    nblocks = -(-n // TILE)
    hist = torch.empty(max(n_shards * nblocks, 1), dtype=torch.int32,
                       device=dev)
    code = torch.empty(n, dtype=torch.int64, device=dev) \
        if len(keys) > KEYS_PER_PASS else None
    key_vals = _host_ptrs([v.data_ptr() for v, _ in keys], ctypes.c_uint64)
    key_valid = _host_ptrs([m.data_ptr() for _, m in keys], ctypes.c_uint64)
    key_types = _host_ptrs([_KEY_TYPES[v.dtype] for v, _ in keys],
                           ctypes.c_int)
    col_src = _host_ptrs([a.data_ptr() for a in arrays], ctypes.c_uint64)
    col_dst = _host_ptrs([b.data_ptr() for b in bufs], ctypes.c_uint64)
    col_size = _host_ptrs([a.element_size() for a in arrays], ctypes.c_int)
    lib = ck.library("hash_partition")
    rc = lib.tt_hash_partition(
        len(keys), ctypes.addressof(key_vals), ctypes.addressof(key_valid),
        ctypes.addressof(key_types), live.data_ptr(), n, n_shards,
        bucket_cap, len(arrays), ctypes.addressof(col_src),
        ctypes.addressof(col_dst), ctypes.addressof(col_size),
        sent_live.data_ptr(), counts.data_ptr(), need.data_ptr(),
        dest.data_ptr(), hist.data_ptr(),
        code.data_ptr() if code is not None else None,
        ck.stream_ptr(dev))
    ck.count("hash_partition")
    ck.check(rc, "hash_partition")
    return bufs, sent_live, counts, need.reshape(())


# ---------------------------------------------------------------------------
# K24 rank_exchange: the all_to_all fused into the scatter
# ---------------------------------------------------------------------------


def rank_exchange_plain(arrays, dest, live, n_shards: int, bucket_cap: int):
    """Plain version of the all_to_all bucket exchange over rank lists.

    arrays[s]: source rank s's payload columns, 1-D of its N_s rows (the
    same dtypes on every rank); dest[s]: (N_s,) destinations; live[s]:
    (N_s,) bool. Each source scatters its live rows into `n_shards`
    buckets of `bucket_cap` slots, stably in row order (a row whose dest
    is outside [0, n_shards) counts as dead); rank d then receives bucket
    d of every source, source s's at slots [s·bucket_cap, (s+1)·
    bucket_cap), zero past that bucket's count.

    → (recv [d] = [(n_shards·bucket_cap,) per column], recv_live [d],
       need () int32 — the largest true bucket of any source, over every
       destination; need > bucket_cap means rows were dropped)."""
    nd = int(n_shards)
    sent = [bucket_scatter_plain(d, lv, list(a), nd, bucket_cap)
            for a, d, lv in zip(arrays, dest, live)]
    n_cols = len(arrays[0]) if len(arrays) else 0
    recv = [[torch.cat([bufs[j].view(nd, bucket_cap)[d]
                        for bufs, _sl, _c, _n in sent])
             for j in range(n_cols)] for d in range(nd)]
    recv_live = [torch.cat([sl.view(nd, bucket_cap)[d]
                            for _b, sl, _c, _n in sent]) for d in range(nd)]
    need = torch.stack([nn for _b, _sl, _c, nn in sent]).max()
    return recv, recv_live, need.to(torch.int32)


def _check_exchange(arrays, dest, live, nd: int, bucket_cap: int):
    """K24's argument checks → the ranks' one device."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if not 1 <= nd <= MAX_SHARDS or len(live) != nd or len(arrays) != nd \
            or len(dest) != nd:
        raise ck.KernelError(f"rank_exchange: one entry per rank of 1 to "
                             f"{MAX_SHARDS} ranks expected")
    if bucket_cap < 0:
        raise ck.KernelError("rank_exchange: a negative bucket_cap")
    dev = live[0].device
    dtypes = [a.dtype for a in arrays[0]]
    for s in range(nd):
        lv, d = live[s], dest[s]
        ck.require_cuda(lv, d, what="rank_exchange")
        if lv.dtype != torch.bool or lv.dim() != 1 or lv.device != dev:
            raise ck.KernelError("rank_exchange: 1-D bool live masks on "
                                 "one device expected")
        n = lv.shape[0]
        if d.dtype != torch.int32 or d.shape != (n,) or d.device != dev:
            raise ck.KernelError("rank_exchange: a 1-D int32 dest of the "
                                 "live mask's length expected")
        if [a.dtype for a in arrays[s]] != dtypes:
            raise ck.KernelError("rank_exchange: the same payload dtypes "
                                 "on every rank expected")
        for a in arrays[s]:
            ck.require_cuda(a, what="rank_exchange")
            if a.shape != (n,) or a.element_size() not in (1, 2, 4, 8) \
                    or a.device != dev:
                raise ck.KernelError(
                    "rank_exchange: payload columns are 1-D of the live "
                    "mask's length, of 1, 2, 4 or 8 bytes an item, on the "
                    "live mask's device")
    return dev


def rank_exchange(arrays, dest, live, n_shards: int, bucket_cap: int):
    """Hash-repartition rows across ranks: the JAX package's `exchange`
    over rank lists (see rank_exchange_plain for the layout). K24 on
    CUDA tensors, one launch group per source rank: arrays[s] the
    source's payload columns (1-D, 1, 2, 4 or 8 bytes an item, the same
    dtypes on every rank), dest[s] (N_s,) int32 (hash_dest computes it),
    live[s] (N_s,) bool; every rank's tensors on one CUDA device,
    len(live) == n_shards ≤ 64. → (recv, recv_live, need) as
    rank_exchange_plain. Each column's receive buffers are one
    zero-filled (n_shards, n_shards·bucket_cap) allocation, rank d's
    buffer its row d; no host sync."""
    if live[0].device.type == "cpu":
        return rank_exchange_plain(arrays, dest, live, n_shards, bucket_cap)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    nd = int(n_shards)
    bucket_cap = int(bucket_cap)
    dev = _check_exchange(arrays, dest, live, nd, bucket_cap)
    dtypes = [a.dtype for a in arrays[0]]
    total = nd * bucket_cap
    recv_cols = [torch.zeros((nd, total), dtype=dt, device=dev)
                 for dt in dtypes]
    recv_live = torch.zeros((nd, total), dtype=torch.bool, device=dev)
    need = torch.zeros(1, dtype=torch.int32, device=dev)
    col_size = _host_ptrs([torch.empty((), dtype=dt).element_size()
                           for dt in dtypes], ctypes.c_int)
    col_dst = _host_ptrs([rc[d].data_ptr() for rc in recv_cols
                          for d in range(nd)], ctypes.c_uint64)
    live_dst = _host_ptrs([recv_live[d].data_ptr() for d in range(nd)],
                          ctypes.c_uint64)
    lib = ck.library("hash_partition")
    stream = ck.stream_ptr(dev)
    counts = torch.empty(nd, dtype=torch.int32, device=dev)
    for s in range(nd):
        lv = live[s].contiguous()
        d_in = dest[s].contiguous()
        n = lv.shape[0]
        cols = [a.contiguous() for a in arrays[s]]
        nblocks = -(-n // TILE)
        dest_b = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
        hist = torch.empty(max(nd * nblocks, 1), dtype=torch.int32,
                           device=dev)
        col_src = _host_ptrs([a.data_ptr() for a in cols], ctypes.c_uint64)
        rc = lib.tt_rank_exchange(
            d_in.data_ptr(), lv.data_ptr(), n, nd, bucket_cap, s, len(cols),
            ctypes.addressof(col_src), ctypes.addressof(col_size),
            ctypes.addressof(col_dst), ctypes.addressof(live_dst),
            counts.data_ptr(), need.data_ptr(), dest_b.data_ptr(),
            hist.data_ptr(), stream)
        ck.count("rank_exchange")
        ck.check(rc, "rank_exchange")
    return ([[rc[d] for rc in recv_cols] for d in range(nd)],
            [recv_live[d] for d in range(nd)], need.reshape(()))


# ---------------------------------------------------------------------------
# K26 hash_dest: the owner shard of every row
# ---------------------------------------------------------------------------


def hash_dest_plain(keys, n_shards: int, *, code=None) -> torch.Tensor:
    """Plain version: shard_of(mix_key_code(keys), n_shards), or
    shard_of(code) for one int64 code a row. → (N,) int32."""
    return shard_of(mix_key_code(keys) if code is None else code, n_shards)


def _check_dest(keys, n_shards: int, code):
    """K26's argument checks → (rows, the contiguous code or None, the
    contiguous keys and their ctypes tables, or None)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if int(n_shards) < 1:
        raise ck.KernelError("hash_dest: at least one shard expected")
    if (code is None) == (not keys):
        raise ck.KernelError("hash_dest: key columns or one code column "
                             "expected")
    t = code if code is not None else keys[0][0]
    if t.dim() != 1:
        raise ck.KernelError("hash_dest: 1-D columns expected")
    n = t.shape[0]
    if code is not None:
        ck.require_cuda(code, what="hash_dest")
        if code.dtype != torch.int64:
            raise ck.KernelError("hash_dest: an int64 code column expected")
        return n, code.contiguous(), None
    keys = [(v.contiguous(), m.contiguous()) for v, m in keys]
    for v, m in keys:
        ck.require_cuda(v, m, what="hash_dest")
        if v.dtype not in _KEY_TYPES:
            raise ck.KernelError(f"hash_dest: key dtype {v.dtype} not taken")
        if m.dtype != torch.bool or v.shape != (n,) or m.shape != (n,):
            raise ck.KernelError("hash_dest: a key is a 1-D column with a "
                                 "bool validity of the rows' length")
        if v.device != t.device or m.device != t.device:
            raise ck.KernelError("hash_dest: every tensor on one device")
    return n, None, (keys, (
        _host_ptrs([v.data_ptr() for v, _ in keys], ctypes.c_uint64),
        _host_ptrs([m.data_ptr() for _, m in keys], ctypes.c_uint64),
        _host_ptrs([_KEY_TYPES[v.dtype] for v, _ in keys], ctypes.c_int)))


def hash_dest(keys, n_shards: int, *, code=None) -> torch.Tensor:
    """K26 wrapper: the owner shard of each row of `keys` ([(values,
    validity)] 1-D key columns) or of `code` ((N,) int64), int32, bit-
    exact with shard_of(mix_key_code(keys)) or shard_of(code). One
    launch (more for over 16 key columns), no host sync."""
    t = code if code is not None else keys[0][0]
    if t.device.type == "cpu":
        return hash_dest_plain(keys, n_shards, code=code)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    n, code, tabs = _check_dest(keys, n_shards, code)
    dev = t.device
    # `kept` holds the contiguous key columns the tables point into
    kept, (kv, km, kt) = tabs if tabs else ([], (None, None, None))
    n_keys = len(kept)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(n, dtype=torch.int64, device=dev) \
        if n_keys > KEYS_PER_PASS else None
    lib = ck.library("hash_partition")
    rc = lib.tt_hash_dest(
        n_keys, ctypes.addressof(kv) if kv is not None else None,
        ctypes.addressof(km) if km is not None else None,
        ctypes.addressof(kt) if kt is not None else None,
        code.data_ptr() if code is not None else None, n, int(n_shards),
        out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        ck.stream_ptr(dev))
    ck.count("hash_dest")
    ck.check(rc, "hash_dest")
    return out

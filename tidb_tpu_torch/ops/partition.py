"""One rank's rows into fixed-capacity destination buckets (K23
hash_partition): stage 1 of the staged exchange.

The JAX package computes each row's destination with
`collective.shard_of(collective.mix_key_code(keys), n_shards)` and
scatters the payload with `device_emit.emit_partition` (a lax.sort of
(dest, row), a segment_min rank and one `.at[slot].set` per column).
`hash_partition` computes the same outputs: rows ranked stably within
their destination in source order, slot = dest·bucket_cap + rank, rows
past the cap dropped and reported through `counts` and `need`.

It takes its plain version for CPU tensors and launches
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


def hash_partition_plain(keys, live: torch.Tensor,
                         arrays: Sequence[torch.Tensor], n_shards: int,
                         bucket_cap: int):
    """Plain torch version: the hash, then a stable argsort of the
    destinations for the ranks. → (bufs [n_shards·bucket_cap] per array,
    sent_live, counts (n_shards,) int32, need () int32)."""
    from tidb_tpu_torch.parallel import collective as C
    dev = live.device
    n = live.shape[0]
    dest = C.shard_of(C.mix_key_code(keys), n_shards).to(torch.int64)
    d = torch.where(live, dest, torch.full_like(dest, n_shards))
    order = torch.argsort(d, stable=True)
    per_dest = torch.bincount(d, minlength=n_shards + 1)
    first = torch.cumsum(per_dest, 0) - per_dest
    rank_sorted = torch.arange(n, dtype=torch.int64, device=dev) - \
        first[d[order]]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    counts = per_dest[:n_shards].to(torch.int32)
    total = n_shards * bucket_cap
    ok = live & (rank < bucket_cap)
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

"""The exchange's key hash and host routing.

The plain torch versions of the JAX package's hash partition function
(`tidb_tpu/parallel/collective.py` `_mix64`, `shard_of`, `mix_key_code`):
the CPU path of ops/partition.py and the oracle of K23 `hash_partition`,
which computes the same bits on the card. Torch has no usable uint64
arithmetic, so the splitmix64 finalizer runs in int64: a multiply wraps
as it is, a logical right shift masks off the sign extension, and the
unsigned modulus is taken from the two 32-bit halves.

`route_buckets` is the staged exchange's host routing, numpy as in the
JAX package. The in-trace collectives of the monolithic shard_map
program (`exchange`'s all_to_all, `broadcast_build`, `gather_partials`)
are not ported: the port runs only the staged paths.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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


def require_capacity(need: int, bucket_cap: int, what: str = "exchange"):
    """Host-side overflow guard for a bucket scatter WITHOUT a resize
    ladder: rows past bucket_cap were dropped, so ignoring the reported
    need silently loses rows. Raises a typed CapacityError instead."""
    from tidb_tpu_torch.errors import CapacityError
    if int(need) > int(bucket_cap):
        raise CapacityError(
            f"{what} needs {int(need)} rows/bucket but capacity is "
            f"{int(bucket_cap)}; rows would be silently dropped — resize "
            f"(escalation ladder) or raise the cap")


def route_buckets(checkpoints: Sequence[dict], n_shards: int):
    """Host-mediated bucket routing — the staged exchange's replacement
    for the monolithic program's all_to_all. `checkpoints[r]` is rank r's
    device→host checkpoint of its stage-1 partition output:

        {"bufs":   {col_idx: (values, validity)},   # n_shards*cap_r rows
         "counts": (n_shards,) int — live rows per destination bucket,
         "cap":    int — rank r's per-destination bucket capacity}

    Per-rank caps may differ (a skewed rank resizes alone — the exact-need
    ladder contract), so routing slices each source's buckets at ITS cap.
    Within bucket d the prefix [0:counts[d]] is contiguous live rows (the
    scatter ranks rows densely per destination), so the routed payload is
    front-packed by construction.

    Returns (routed, recv_rows): routed[d] = {col_idx: (values, validity)}
    concatenated over source ranks in rank order; recv_rows[d] = total live
    rows destined for rank d."""
    cols = list(checkpoints[0]["bufs"].keys()) if checkpoints else []
    routed = []
    recv_rows = []
    for d in range(n_shards):
        bufs = {}
        for i in cols:
            vs, ms = [], []
            for cp in checkpoints:
                cap = int(cp["cap"])
                k = int(cp["counts"][d])
                v, m = cp["bufs"][i]
                vs.append(np.asarray(v)[d * cap:d * cap + k])
                ms.append(np.asarray(m)[d * cap:d * cap + k])
            bufs[i] = (np.concatenate(vs) if vs else np.zeros(0),
                       np.concatenate(ms) if ms else np.zeros(0, bool))
        routed.append(bufs)
        recv_rows.append(int(sum(int(cp["counts"][d])
                              for cp in checkpoints)))
    return routed, recv_rows

"""Segment (grouped) reduction primitives, numpy + torch backends.

The reformulation of TiDB's hash aggregation (SURVEY §7 stage 4) as
segment ops — scatter-combine rows into dense group slots. On numpy these
use `ufunc.at` (exact int64 — np.bincount would round through float64);
on torch tensors every reduction goes through `segment_reduce`: the K1
CUDA kernel (csrc/segment_reduce.cu) for CUDA tensors, its plain torch
version (`segment_reduce_plain`) for CPU tensors.

All functions take `num_segments` explicitly. Rows whose id is < 0 or
>= num_segments contribute nothing (the dead-row padding convention).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tidb_tpu_torch.ops.xp import astype

#: K1's type codes (csrc/segment_reduce.cu): the input's, and the
#: accumulator's (the input's own type, or int32/int64 for a bool mask)
_K1_IN = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.bool: 3}
_K1_OUT = {torch.int64: 0, torch.int32: 1, torch.float64: 2}
_K1_OPS = {"sum": 0, "min": 1, "max": 2}
#: the cap ranges of K1's three paths (csrc/segment_reduce.cu): lane-
#: private columns up to SMALL_CAP, a block-private accumulator up to
#: MID_CAP, global atomics above
SMALL_CAP = 32
MID_CAP = 4096
#: threads a block
K1_THREADS = 256


def _is_np(xp) -> bool:
    return xp is np


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _out_dtype(data: torch.Tensor, out_dtype) -> torch.dtype:
    if out_dtype is not None:
        return out_dtype
    return torch.int64 if data.dtype == torch.bool else data.dtype


def segment_reduce_plain(op: str, data: torch.Tensor, gids: torch.Tensor,
                         cap: int, out_dtype=None) -> torch.Tensor:
    """Plain torch version of K1: (cap,) reduction of `data` by `gids`,
    out-of-range ids dropped; a bool `data` counts as 0 / 1 in
    `out_dtype` (default int64)."""
    dt = _out_dtype(data, out_dtype)
    if data.dtype != dt:
        data = data.to(dt)
    ok = (gids >= 0) & (gids < cap)
    idx = torch.where(ok, gids.to(torch.int64),
                      torch.full_like(gids, cap, dtype=torch.int64))
    out = torch.full((cap + 1,), _identity(op, dt), dtype=dt,
                     device=data.device)
    if op == "sum":
        out.index_add_(0, idx, data)
    else:
        out.scatter_reduce_(0, idx, data, reduce="amin" if op == "min"
                            else "amax", include_self=True)
    return out[:cap]


def block_quads(n: int, grid: int):
    """K1's row split (the small and mid paths): block b reads the row
    quads [b * per, min((b + 1) * per, nq)) of nq = ceil(n / 4), per =
    ceil(nq / grid). → [(q0, q1)] a block."""
    nq = -(-n // 4)
    per = -(-nq // grid)
    return [(b * per, min(b * per + per, nq)) for b in range(grid)]


class _SegPlan(ctypes.Structure):
    """K1's launch parameters of one shape (csrc/segment_reduce.cu
    `SegPlan`)."""
    _fields_ = [("n", ctypes.c_longlong), ("path", ctypes.c_longlong),
                ("grid", ctypes.c_longlong), ("in_dt", ctypes.c_int),
                ("out_dt", ctypes.c_int), ("op", ctypes.c_int),
                ("cap", ctypes.c_int)]


@functools.lru_cache(maxsize=1024)
def segment_plan(in_code: int, out_code: int, op_code: int, n: int,
                 cap: int, device_index: int):
    """K1's launch parameters for one shape on one card, computed once
    by the library (`tt_segment_plan`: the path, the grid of the card's
    SMs times the resident blocks, the scratch bytes) and cached with
    the parameter block the calls pass by reference. → (path, grid,
    scratch bytes, the `_SegPlan` block)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    plan = (ctypes.c_longlong * 3)()
    lib = ck.library("segment_reduce")
    with torch.cuda.device(device_index):
        rc = lib.tt_segment_plan(in_code, out_code, op_code, n, cap, plan)
    ck.check(rc, "segment_reduce plan")
    if lib.tt_segment_plan_bytes() != ctypes.sizeof(_SegPlan):
        raise ck.KernelError("segment_reduce: parameter block size differs "
                             "from the library's")
    block = _SegPlan(n=n, path=plan[0], grid=plan[1], in_dt=in_code,
                     out_dt=out_code, op=op_code, cap=cap)
    return plan[0], plan[1], plan[2], block


def segment_reduce(op: str, data: torch.Tensor, gids: torch.Tensor,
                   cap: int, out_dtype=None) -> torch.Tensor:
    """K1 wrapper: CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise on anything it does not take). A bool `data`
    reduces natively as `out_dtype` (int64 unless int32 is named)."""
    if data.device.type == "cpu" and gids.device.type == "cpu":
        return segment_reduce_plain(op, data, gids, cap, out_dtype)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    dev = data.device
    if not (data.is_cuda and gids.device == dev and data.is_contiguous()
            and gids.is_contiguous()):
        ck.require_cuda(data, gids, what="segment_reduce")
        raise ck.KernelError("segment_reduce: data and gids on different "
                             "devices")
    dt = _out_dtype(data, out_dtype)
    in_code = _K1_IN.get(data.dtype)
    out_code = _K1_OUT.get(dt)
    if in_code is None or out_code is None or \
            (in_code != 3 and dt != data.dtype) or \
            (in_code == 3 and out_code == 2):
        raise ck.KernelError(f"segment_reduce: unsupported types "
                             f"{data.dtype} -> {dt}")
    if gids.dtype != torch.int32:
        raise ck.KernelError("segment_reduce: gids must be int32")
    op_code = _K1_OPS.get(op)
    if op_code is None:
        raise ck.KernelError(f"segment_reduce: unsupported op {op!r}")
    if data.dim() != 1 or gids.shape != data.shape:
        raise ck.KernelError("segment_reduce: expected equal 1-D shapes")
    if not 0 < cap < 2 ** 31:
        raise ck.KernelError(f"segment_reduce: cap {cap} out of range")
    _path, _grid, nbytes, block = segment_plan(
        in_code, out_code, op_code, data.shape[0], cap,
        dev.index if dev.index is not None else torch.cuda.current_device())
    out = torch.empty(cap, dtype=dt, device=dev)
    stream = ck.stream_ptr(dev)
    # the scratch's first 16 bytes are the small path's completion
    # counter: zero in a new buffer, and every call leaves it zero
    ent = ck.stream_scratch("segment_reduce", dev, stream)
    with ent.lock:
        rc = ck.library("segment_reduce").tt_segment_reduce(
            ctypes.byref(block), data.data_ptr(), gids.data_ptr(),
            out.data_ptr(),
            ent.ensure(nbytes, dev, zeroed=True), stream)
    ck.count("segment_reduce")
    ck.check(rc, "segment_reduce")
    return out


def _torch_ids(xp, segment_ids):
    ids = xp.asarray(segment_ids)
    return ids if ids.dtype == torch.int32 else ids.to(torch.int32)


def _torch_reduce(xp, op, data, segment_ids, num_segments, out_dtype=None):
    data = xp.asarray(data)
    if data.dtype == torch.bool and out_dtype is None:
        out_dtype = torch.int32
    ids = _torch_ids(xp, segment_ids)
    if data.dim() == 2:
        # wide-decimal limb planes (limbs, rows): one reduction per limb
        return torch.stack([segment_reduce(op, data[k].contiguous(), ids,
                                           num_segments, out_dtype)
                            for k in range(data.shape[0])])
    return segment_reduce(op, data.contiguous(), ids, num_segments,
                          out_dtype)


def segment_sum(xp, data, segment_ids, num_segments: int):
    if _is_np(xp):
        out = np.zeros(num_segments, dtype=data.dtype)
        np.add.at(out, segment_ids, data)
        return out
    return _torch_reduce(xp, "sum", data, segment_ids, num_segments)


def segment_sum_accurate(xp, data, segment_ids, num_segments: int):
    """Float segment sum → (hi, lo) per segment with hi + lo the sum.

    float64 is native on every device the port targets, so this is the
    JAX package's f64 branch: hi is the f64 segment sum, lo is 0. The
    (hi, lo) state layout stays so the partial states keep their shape."""
    if _is_np(xp):
        out = np.zeros(num_segments, dtype=np.float64)
        np.add.at(out, segment_ids, astype(data, np.float64))
        return out, np.zeros_like(out)
    s = segment_sum(xp, astype(xp.asarray(data), torch.float64),
                    segment_ids, num_segments)
    return s, torch.zeros_like(s)


def two_float_add(xp, ahi, alo, bhi, blo):
    """(ahi+alo) + (bhi+blo) as a renormalized two-float pair (Knuth
    two-sum)."""
    s = ahi + bhi
    bb = s - ahi
    err = (ahi - (s - bb)) + (bhi - bb)
    e = err + alo + blo
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def segment_count(xp, mask, segment_ids, num_segments: int):
    """Count of True rows per segment → int64."""
    if _is_np(xp):
        out = np.zeros(num_segments, dtype=np.int64)
        np.add.at(out, segment_ids, astype(mask, np.int64))
        return out
    mask = xp.asarray(mask)
    if mask.dtype == torch.bool:      # K1 reads the 1-byte mask itself
        return _torch_reduce(xp, "sum", mask, segment_ids, num_segments,
                             torch.int64)
    return segment_sum(xp, astype(mask, torch.int64), segment_ids,
                       num_segments)


def segment_min(xp, data, segment_ids, num_segments: int):
    if _is_np(xp):
        out = np.full(num_segments, _max_identity(data.dtype),
                      dtype=data.dtype)
        np.minimum.at(out, segment_ids, data)
        return out
    return _torch_reduce(xp, "min", data, segment_ids, num_segments)


def segment_max(xp, data, segment_ids, num_segments: int):
    if _is_np(xp):
        out = np.full(num_segments, _min_identity(data.dtype),
                      dtype=data.dtype)
        np.maximum.at(out, segment_ids, data)
        return out
    return _torch_reduce(xp, "max", data, segment_ids, num_segments)


def segment_any(xp, mask, segment_ids, num_segments: int):
    """True iff any True row lands in the segment."""
    if _is_np(xp):
        out = np.zeros(num_segments, dtype=bool)
        np.logical_or.at(out, segment_ids, mask)
        return out
    mask = xp.asarray(mask)
    if mask.dtype == torch.bool:      # K1 reads the 1-byte mask itself
        return _torch_reduce(xp, "max", mask, segment_ids, num_segments,
                             torch.int32) > 0
    return segment_max(xp, astype(mask, torch.int32), segment_ids,
                       num_segments) > 0


def segment_first(xp, data, mask, segment_ids, num_segments: int):
    """First masked value per segment, in row order → (values, found)."""
    n = data.shape[0]
    if _is_np(xp):
        idx = np.full(num_segments, n, dtype=np.int64)
        rows = np.where(mask, np.arange(n, dtype=np.int64), n)
        np.minimum.at(idx, segment_ids, rows)
        found = idx < n
        safe = np.where(found, idx, 0)
        return data[safe], found
    rows = xp.where(xp.asarray(mask), xp.arange(n, dtype=np.int64), n)
    idx = segment_min(xp, rows, segment_ids, num_segments)
    found = idx < n
    safe = xp.where(found, idx, 0)
    return xp.asarray(data)[safe], found


def _max_identity(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        return np.iinfo(dtype).max
    if dtype.kind == "f":
        return np.inf
    if dtype.kind == "b":
        return True
    raise AssertionError(f"no identity for {dtype}")


def _min_identity(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        return np.iinfo(dtype).min
    if dtype.kind == "f":
        return -np.inf
    if dtype.kind == "b":
        return False
    raise AssertionError(f"no identity for {dtype}")


__all__ = ["segment_reduce", "segment_reduce_plain", "segment_plan",
           "block_quads", "segment_sum",
           "segment_sum_accurate", "two_float_add", "segment_count",
           "segment_min", "segment_max", "segment_any", "segment_first"]

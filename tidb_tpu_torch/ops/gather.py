"""Column gathers through one index vector (K18 gather_columns).

The JAX package gathers rows with `jnp` indexing inside its traced
programs: emit_distinct's pair output (every group key and raw DISTINCT
argument column through `rep[:pc]`, the masks AND-ed with
`iota < n_pairs`) and the ROLLUP branch's `key_out` (each key and the
level column through `rep`, AND-ed with `iota < n_groups`). Here one
launch gathers all of a call's columns, and the count that cuts the
masks stays on the device (no host sync).

`gather_columns` takes its plain version for CPU tensors and launches
csrc/gather_columns.cu for CUDA tensors (or raises on anything the kernel
does not take).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

#: columns per launch (csrc/gather_columns.cu MAX_COLS)
MAX_COLS = 64

Column = Tuple[torch.Tensor, Optional[torch.Tensor]]


def gather_columns_plain(cols: Sequence[Column], idx: torch.Tensor,
                         n_valid) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain torch version: (v[idx], (m[idx] or True) & (slot < n_valid))
    per column; `m` None means every row valid."""
    slot = torch.arange(idx.shape[0], device=idx.device) < n_valid
    ix = idx.to(torch.int64)
    out = []
    for v, m in cols:
        out.append((v[ix], slot if m is None else m[ix] & slot))
    return out


def gather_columns(cols: Sequence[Column], idx: torch.Tensor,
                   n_valid: torch.Tensor
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K18 wrapper: every (value, mask-or-None) column of one row count
    gathered through `idx` (int32 or int64), each output mask cut to the
    slots below `n_valid` (a 0-d int32 tensor on the same device)."""
    if idx.device.type == "cpu":
        return gather_columns_plain(cols, idx, n_valid)
    import ctypes
    from tidb_tpu_torch.ops import cuda_kernels as ck
    if not cols:
        return []
    ck.require_cuda(idx, n_valid, what="gather_columns")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ck.KernelError("gather_columns: a 1-D int32/int64 index "
                             "expected")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ck.KernelError("gather_columns: n_valid must be one int32")
    n_src = cols[0][0].shape[0]
    for v, m in cols:
        ck.require_cuda(v, what="gather_columns")
        if v.dim() != 1 or v.shape[0] != n_src or \
                v.element_size() not in (1, 2, 4, 8):
            raise ck.KernelError("gather_columns: 1-D columns of one length "
                                 "and 1/2/4/8-byte elements expected")
        if m is not None:
            ck.require_cuda(m, what="gather_columns")
            if m.dtype != torch.bool or m.shape != (n_src,):
                raise ck.KernelError("gather_columns: masks must be bool of "
                                     "the values' length")
    n_out = idx.shape[0]
    dev = idx.device
    out = [(torch.empty(n_out, dtype=v.dtype, device=dev),
            torch.empty(n_out, dtype=torch.bool, device=dev))
           for v, _m in cols]
    if n_out == 0:
        return out
    lib = ck.library("gather_columns")
    for lo in range(0, len(cols), MAX_COLS):
        part = list(zip(cols[lo:lo + MAX_COLS], out[lo:lo + MAX_COLS]))
        k = len(part)
        P = ctypes.c_void_p * k
        rc = lib.tt_gather_columns(
            k, P(*[v.data_ptr() for (v, _m), _o in part]),
            P(*[None if m is None else m.data_ptr()
                for (_v, m), _o in part]),
            (ctypes.c_int * k)(*[v.element_size() for (v, _m), _o in part]),
            n_src, idx.data_ptr(), int(idx.dtype == torch.int64), n_out,
            n_valid.data_ptr(), P(*[ov.data_ptr() for _c, (ov, _om) in part]),
            P(*[om.data_ptr() for _c, (_ov, om) in part]),
            ck.stream_ptr(dev))
        ck.count("gather_columns")
        ck.check(rc, "gather_columns")
    return out

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
does not take). Its host side is built for one call in a few µs:
  * `gather_plan(widths, idx64, n_src)`, a pure function cached by the
    call's signature, packs the argument block of each launch (at
    most MAX_COLS columns) with only the pointers and the slot count
    left to fill in;
  * `out_layout(widths, m)`, also pure and cached, places every output
    value and mask in one allocation at 16-byte aligned offsets (the
    kernel's vector stores need them);
  * the checks (one device, contiguity, dtypes, lengths) run once per
    distinct signature; a call builds the signature and looks it up.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

#: columns per launch (csrc/gather_columns.cu MAX_COLS)
MAX_COLS = 64
#: byte alignment of every output view (the kernel's 16-byte stores)
ALIGN = 16

Column = Tuple[torch.Tensor, Optional[torch.Tensor]]


class _GatherArgs(ctypes.Structure):
    """K18's argument block (csrc/gather_columns.cu `GatherArgs`)."""
    _fields_ = [("src", ctypes.c_void_p * MAX_COLS),
                ("msrc", ctypes.c_void_p * MAX_COLS),
                ("dst", ctypes.c_void_p * MAX_COLS),
                ("mdst", ctypes.c_void_p * MAX_COLS),
                ("idx", ctypes.c_void_p),
                ("n_valid", ctypes.c_void_p),
                ("m", ctypes.c_longlong),
                ("n_src", ctypes.c_longlong),
                ("bytes", ctypes.c_int * MAX_COLS),
                ("ncols", ctypes.c_int),
                ("idx64", ctypes.c_int)]


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


@functools.lru_cache(maxsize=256)
def gather_plan(widths: Tuple[int, ...], idx64: bool,
                n_src: int) -> Tuple[bytes, ...]:
    """K18's argument blocks for one call signature, a pure function: one
    block per launch of at most MAX_COLS columns, with the column count,
    each width, the index width and n_src filled in and every pointer and
    m zero. A call copies each block into a `_GatherArgs` and fills in
    its pointers (a column without a mask passes a null mask) and m."""
    blocks = []
    for lo in range(0, len(widths), MAX_COLS):
        part = widths[lo:lo + MAX_COLS]
        a = _GatherArgs()
        a.ncols = len(part)
        a.bytes[:len(part)] = list(part)
        a.idx64 = int(idx64)
        a.n_src = n_src
        blocks.append(bytes(a))
    return tuple(blocks)


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@functools.lru_cache(maxsize=256)
def out_layout(widths: Tuple[int, ...], m: int
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    """Where each output lies in the one allocation of a call, a pure
    function: → (byte offsets of the values, byte offsets of the masks,
    total bytes). Values come first in column order, then the masks; every
    offset is a multiple of ALIGN and each piece holds m elements."""
    off = 0
    vals = []
    for w in widths:
        vals.append(off)
        off += _aligned(m * w)
    masks = []
    for _w in widths:
        masks.append(off)
        off += _aligned(m)
    return tuple(vals), tuple(masks), off


def _signature(cols: Sequence[Column], idx: torch.Tensor,
               n_valid: torch.Tensor) -> tuple:
    """Everything the checks read of a call, as one hashable key."""
    return (tuple((v.dtype, v.shape, v.device, v.is_contiguous(),
                   None if m is None else
                   (m.dtype, m.shape, m.device, m.is_contiguous()))
                  for v, m in cols),
            idx.dtype, idx.dim(), idx.device, idx.is_contiguous(),
            n_valid.dtype, n_valid.numel(), n_valid.device)


@functools.lru_cache(maxsize=256)
def _checked_plan(sig: tuple):
    """Check a call's signature once (the build rule: one CUDA device,
    contiguous 1-D columns of one length and 1/2/4/8-byte elements, bool
    masks of that length, a 1-D int32/int64 index, one int32 n_valid)
    → (the launches' argument blocks, widths, value dtypes)."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    colsig, idt, idim, idev, icont, nvdt, nvn, nvdev = sig
    if idev.type != "cuda":
        raise ck.KernelError(f"gather_columns: expected a CUDA tensor, got "
                             f"{idev}")
    if idt not in (torch.int32, torch.int64) or idim != 1 or not icont:
        raise ck.KernelError("gather_columns: a contiguous 1-D int32/int64 "
                             "index expected")
    if nvdev != idev or nvdt != torch.int32 or nvn != 1:
        raise ck.KernelError("gather_columns: n_valid must be one int32 on "
                             "the index's device")
    n_src = colsig[0][1][0] if len(colsig[0][1]) == 1 else -1
    widths, dtypes = [], []
    for vdt, vshape, vdev, vcont, msig in colsig:
        if vdev != idev:
            raise ck.KernelError(f"gather_columns: a column on {vdev}, the "
                                 f"index on {idev}")
        if not vcont or msig is not None and not msig[3]:
            raise ck.KernelError("gather_columns: expected a contiguous "
                                 "tensor")
        width = vdt.itemsize
        if len(vshape) != 1 or vshape[0] != n_src or \
                width not in (1, 2, 4, 8):
            raise ck.KernelError("gather_columns: 1-D columns of one length "
                                 "and 1/2/4/8-byte elements expected")
        if msig is not None and (msig[2] != idev or msig[0] != torch.bool or
                                 tuple(msig[1]) != (n_src,)):
            raise ck.KernelError("gather_columns: masks must be bool of "
                                 "the values' length")
        widths.append(width)
        dtypes.append(vdt)
    widths = tuple(widths)
    return (gather_plan(widths, idt == torch.int64, n_src), widths,
            tuple(dtypes))


def _views(buf: torch.Tensor, widths, dtypes, m: int):
    """The outputs of a call as views of its one bool buffer `buf`:
    → [(values, mask)], at `out_layout`'s 16-byte aligned offsets (basic
    slices and `view(dtype)`, the cheapest views to make)."""
    vals, masks, _total = out_layout(widths, m)
    return [(buf[o:o + m * w] if dt == torch.bool else
             buf[o:o + m * w].view(dt), buf[mo:mo + m])
            for o, mo, w, dt in zip(vals, masks, widths, dtypes)]


def gather_columns(cols: Sequence[Column], idx: torch.Tensor,
                   n_valid: torch.Tensor
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K18 wrapper: every (value, mask-or-None) column of one row count
    gathered through `idx` (int32 or int64), each output mask cut to the
    slots below `n_valid` (a 0-d int32 tensor on the same device). On the
    card the outputs are views of one allocation; the kernel is launched
    on the allocation's address and the views are made while it runs."""
    dev = idx.device
    if dev.type == "cpu":
        return gather_columns_plain(cols, idx, n_valid)
    if not cols:
        return []
    blocks, widths, dtypes = _checked_plan(_signature(cols, idx, n_valid))
    n_out = idx.shape[0]
    vals, masks, total = out_layout(widths, n_out)
    buf = torch.empty(total, dtype=torch.bool, device=dev)
    base = buf.data_ptr()
    _launch(blocks, cols, idx, n_valid, [base + o for o in vals],
            [base + o for o in masks])
    return _views(buf, widths, dtypes, n_out)


def _launch(blocks, cols, idx, n_valid, vptrs, mptrs) -> None:
    """K18's launches of one call: each argument block with its columns'
    sources and the output addresses `vptrs` / `mptrs` (16-byte
    aligned) filled in."""
    n_out = idx.shape[0]
    if not n_out:
        return
    from tidb_tpu_torch.ops import cuda_kernels as ck
    lib = ck.library("gather_columns")
    stream = ck.stream_ptr(idx.device)
    for q, block in enumerate(blocks):
        lo = q * MAX_COLS
        part = cols[lo:lo + MAX_COLS]
        k = len(part)
        a = _GatherArgs.from_buffer_copy(block)
        a.src[:k] = [v.data_ptr() for v, _m in part]
        a.msrc[:k] = [None if m is None else m.data_ptr() for _v, m in part]
        a.dst[:k] = vptrs[lo:lo + k]
        a.mdst[:k] = mptrs[lo:lo + k]
        a.idx = idx.data_ptr()
        a.n_valid = n_valid.data_ptr()
        a.m = n_out
        rc = lib.tt_gather_columns(ctypes.addressof(a), stream)
        ck.count("gather_columns")
        ck.check(rc, "gather_columns")


def gather_slab(v: torch.Tensor, m: torch.Tensor, idx: torch.Tensor,
                n_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cached slab column (values `v`, 1-D, or a wide decimal's
    (limbs, rows) limb planes that share the mask `m`) gathered through
    `idx` as `gather_columns` does, into outputs that each own their
    storage: the values one (limbs, m)-shaped allocation the kernel
    writes row by row, the mask its own (the other limbs' masks go to a
    scratch buffer). A view of a shared buffer would hold every other
    output's bytes for as long as the slab is cached, bytes the device
    cache does not count."""
    planes = [v] if v.dim() == 1 else list(v.unbind(0))
    cols = [(p, m if k == 0 else None) for k, p in enumerate(planes)]
    dev = idx.device
    if dev.type == "cpu":
        out = gather_columns_plain(cols, idx, n_valid)
        vals = out[0][0] if v.dim() == 1 else \
            torch.stack([o[0] for o in out])
        return vals, out[0][1]
    from tidb_tpu_torch.ops import cuda_kernels as ck
    blocks, widths, _dtypes = _checked_plan(_signature(cols, idx, n_valid))
    n_out = idx.shape[0]
    row = n_out * v.dtype.itemsize
    if row % ALIGN:
        raise ck.KernelError(f"gather_slab: {n_out} slots of "
                             f"{v.dtype} are not a 16-byte multiple")
    vals = torch.empty(v.shape[:-1] + (n_out,), dtype=v.dtype, device=dev)
    mask = torch.empty(n_out, dtype=torch.bool, device=dev)
    spare = torch.empty((len(planes) - 1) * _aligned(n_out),
                        dtype=torch.bool, device=dev)
    sp = spare.data_ptr()
    _launch(blocks, cols, idx, n_valid,
            [vals.data_ptr() + k * row for k in range(len(planes))],
            [mask.data_ptr()] + [sp + k * _aligned(n_out)
                                 for k in range(len(planes) - 1)])
    return vals, mask

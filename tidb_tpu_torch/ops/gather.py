"""Row gathers through one index vector, and the inverse of a permutation
(K18 gather_columns).

The JAX package moves rows with `jnp` indexing inside its traced
programs, `jnp.take(v, idx, axis=-1)` beside `jnp.take(m, idx) & keep`
(or `& (iota < n)`), and scatters window results back to row order with
`.at[perm].set(v)`: emit_distinct's pair output, the ROLLUP, factorize,
merge and finalize branches' key and state gathers, emit_root's LIMIT,
TopN and Sort rows, the join finishes' build and probe columns, the
FK-aligned build columns of device_cache, and the window argument
gathers and scatter back. Here one launch moves all of a call's columns,
and the count and keep mask that cut the output masks stay on the device
(no host sync). A window layout's results go back to row order through
its inverse permutation (`inverse_permutation`, one scatter of the slot
numbers) in one gather: random stores cost the card about twice what
random loads do (csrc/gather_columns.cu).

  gather(cols, idx, n_valid=None, keep=None, values=(), owned=False)
      → ([(v[..., idx], m[idx] & cut)], [a[..., idx]])
  inverse_permutation(perm, n) → inv (int32), inv[perm[s]] = s

where cut(s) = (s < n_valid) & keep[s], each part only where given, and
a column's mask `None` reads as every row valid. `values` are arrays
whose callers read no mask (aggregate states): none is written. A value
is 1-D, or a wide decimal's (limbs, rows) limb planes under one mask.
A gather index outside [0, rows) gives a zero value and a false mask, an
index of `perm` outside [0, n) writes nothing; no caller sends one.

CPU tensors take the plain versions; CUDA tensors launch
csrc/gather_columns.cu (or raise on anything the kernel does not take).
The host side a call is short: a few tensor reads a column for its
checks and pointers, the output layout cached by the call's shape
(`out_layout`), one allocation cut into views by one `split_with_sizes`
(or, with `owned`, one allocation an output, for results a cache keeps),
one `struct.pack` of the argument block, one ctypes call.
"""

from __future__ import annotations

import functools
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

#: planes per launch (csrc/gather_columns.cu MAX_COLS); a call of more
#: launches once per 64
MAX_COLS = 64
#: byte alignment of every output view (the kernel's 16-byte stores)
ALIGN = 16
#: 64-bit words of the argument block's header and of each plane
#: (csrc/gather_columns.cu `Header`, `Plane`)
HEADER_WORDS = 8
PLANE_WORDS = 5
#: the bytes of gathered sources one pass of the kernel may hold, so that
#: its random loads stay in the card's 50 MB L2 (csrc/gather_columns.cu):
#: the fastest of one pass, 8, 24 and 40 MB at the join finish's shape on
#: an NVIDIA H100 80GB HBM3 (tools/scan_timing.py's `k18_pass_sweep`).
#: Every call sends it in its argument block, so the sweep and the tests
#: (a pass a plane) set it here without a second build of the kernel.
PASS_BYTES = 8 << 20

Column = Tuple[torch.Tensor, Optional[torch.Tensor]]
#: csrc/gather_columns.cu's C entries, bound at their first CUDA call
_KERNELS = {}


def _cut(m: int, dev, n_valid, keep):
    """cut(s) of the plain versions, or None when nothing cuts."""
    cut = None
    if n_valid is not None:
        cut = torch.arange(m, device=dev) < n_valid
    if keep is not None:
        cut = keep if cut is None else cut & keep
    return cut


def _take(v, ix, inside):
    """v's rows (its last axis) at the in-range indices ix, zero where an
    index lies outside (`inside` None: every index inside)."""
    if inside is None:
        return v[..., ix]
    got = v[..., ix.clamp(0, max(v.shape[-1] - 1, 0))] if v.shape[-1] \
        else torch.zeros(v.shape[:-1] + ix.shape, dtype=v.dtype,
                         device=v.device)
    return torch.where(inside, got, torch.zeros((), dtype=v.dtype,
                                                device=v.device))


def gather_plain(cols: Sequence[Column], idx: torch.Tensor, n_valid=None,
                 keep=None, values: Sequence[torch.Tensor] = ()):
    """Plain torch version of K18's gather, as the JAX package writes it:
    `(v[..., idx], m[idx] & cut)` per column and `a[..., idx]` per value
    array; an index outside [0, rows) gives zero and false."""
    ix = idx.to(torch.int64)
    m = ix.shape[0]
    cut = _cut(m, idx.device, n_valid, keep)
    rows = (cols[0][0] if cols else values[0]).shape[-1] \
        if cols or values else 0
    inside = (ix >= 0) & (ix < rows)
    if bool(inside.all()):
        inside = None
    out = []
    for v, mk in cols:
        om = _take(mk, ix, inside) if mk is not None else \
            (torch.ones(m, dtype=torch.bool, device=idx.device)
             if inside is None else inside)
        out.append((_take(v, ix, inside), om if cut is None else om & cut))
    return out, [_take(a, ix, inside) for a in values]


def gather_columns_plain(cols: Sequence[Column], idx: torch.Tensor,
                         n_valid=None, keep=None
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """`gather_plain`'s columns."""
    return gather_plain(cols, idx, n_valid, keep)[0]


def inverse_permutation_plain(perm: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of K18's inverse permutation,
    `jnp.zeros(n).at[perm].set(iota)`: inv[perm[s]] = s, int32; an index
    outside [0, n) writes nothing, a row no index reaches is left as
    `torch.empty` left it."""
    ix = perm.to(torch.int64)
    slots = torch.arange(ix.shape[0], dtype=torch.int32, device=perm.device)
    inv = torch.empty(n, dtype=torch.int32, device=perm.device)
    inside = (ix >= 0) & (ix < n)
    if bool(inside.all()):
        inv[ix] = slots
    else:
        inv[ix[inside]] = slots[inside]
    return inv


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class Layout(NamedTuple):
    """Where each output of a call lies in its one allocation (bytes):
    `sizes` cut the allocation with `split_with_sizes` (16-byte alignment
    pads included), `vals` and `masks` name each output's piece (-1: no
    mask) and `voffs` / `moffs` its byte offset."""
    sizes: Tuple[int, ...]
    vals: Tuple[int, ...]
    masks: Tuple[int, ...]
    voffs: Tuple[int, ...]
    moffs: Tuple[int, ...]
    total: int


@functools.lru_cache(maxsize=512)
def out_layout(kinds: Tuple[Tuple[int, int, bool], ...], m: int) -> Layout:
    """The one allocation of a call, a pure function of each output's
    (width, planes, with a mask) and the slot count m: values first in
    column order, then the masks, every piece at a multiple of ALIGN."""
    sizes, vals, masks, voffs, moffs = [], [], [], [], []
    off = 0

    def piece(nbytes):
        nonlocal off
        sizes.append(nbytes)
        at = off
        off += nbytes
        pad = _aligned(nbytes) - nbytes
        if pad:
            sizes.append(pad)
            off += pad
        return at

    for w, planes, _wm in kinds:
        vals.append(len(sizes))
        voffs.append(piece(w * planes * m))
    for _w, _planes, wm in kinds:
        if wm:
            masks.append(len(sizes))
            moffs.append(piece(m))
        else:
            masks.append(-1)
            moffs.append(-1)
    return Layout(tuple(sizes), tuple(vals), tuple(masks), tuple(voffs),
                  tuple(moffs), off)


#: the element widths K18 moves, by dtype
_WIDTH = {dt: dt.itemsize for dt in (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.float16,
    torch.bfloat16, torch.int32, torch.float32, torch.int64, torch.float64)}


def _kind(v: torch.Tensor, dev: int, rows: Optional[int]):
    """A value's (width, planes) after the checks; `rows` the length every
    source must have (None: this one's)."""
    w = _WIDTH.get(v.dtype)
    shape = v.shape
    if w is None or v.get_device() != dev or not v.is_contiguous() or \
            not 0 < len(shape) < 3 or \
            rows is not None and shape[-1] != rows:
        from tidb_tpu_torch.ops import cuda_kernels as ck
        if v.get_device() != dev:
            raise ck.KernelError(f"gather_columns: a column on {v.device}, "
                                 f"the index on cuda:{dev}")
        if not v.is_contiguous():
            raise ck.KernelError("gather_columns: expected a contiguous "
                                 "tensor")
        raise ck.KernelError("gather_columns: 1-D columns (or (limbs, "
                             "rows) limb planes) of one length and 1/2/4/"
                             "8-byte elements expected")
    return w, (shape[0] if len(shape) == 2 else 1)


def _check_mask(mk: torch.Tensor, dev: int, rows: int) -> None:
    if mk.dtype is not torch.bool or mk.get_device() != dev or \
            mk.shape != (rows,) or not mk.is_contiguous():
        from tidb_tpu_torch.ops import cuda_kernels as ck
        raise ck.KernelError("gather_columns: masks must be contiguous bool "
                             "of the values' length, on the index's "
                             "device")


def _check_index(idx, n_valid, keep) -> int:
    """The index, n_valid and keep checks → the index's card number; the
    dtypes and shapes first, then the device."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    dev = idx.get_device()
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1 or \
            not idx.is_contiguous():
        raise ck.KernelError("gather_columns: a contiguous 1-D int32/int64 "
                             "index expected")
    if n_valid is not None and (n_valid.get_device() != dev or
                                n_valid.dtype != torch.int32 or
                                n_valid.numel() != 1):
        raise ck.KernelError("gather_columns: n_valid must be one int32 on "
                             "the index's device")
    if keep is not None and (keep.get_device() != dev or
                             keep.dtype != torch.bool or
                             keep.shape != idx.shape or
                             not keep.is_contiguous()):
        raise ck.KernelError("gather_columns: keep must be contiguous bool "
                             "of the index's length on its device")
    if dev < 0:
        raise ck.KernelError(f"gather_columns: expected a CUDA tensor, got "
                             f"{idx.device}")
    return dev


@functools.lru_cache(maxsize=64)
def _format(planes: int) -> str:
    return "<" + "Q" * (HEADER_WORDS + PLANE_WORDS * planes)


def _pack(idx, n_valid, keep, m: int, n: int, planes):
    """The C call's argument block: the header (the index, n_valid and
    keep pointers, m, n, the flags, the plane count, PASS_BYTES), then per
    plane (src, msrc, dst, mdst, bytes), with null pointers as 0."""
    return struct.pack(
        _format(len(planes) // PLANE_WORDS), idx.data_ptr(),
        0 if n_valid is None else n_valid.data_ptr(),
        0 if keep is None else keep.data_ptr(), m, n,
        int(idx.dtype == torch.int64), len(planes) // PLANE_WORDS,
        PASS_BYTES, *planes)


def _kernel(name: str):
    """The C entry `name` of csrc/gather_columns.cu, bound once."""
    fn = _KERNELS.get(name)
    if fn is None:
        from tidb_tpu_torch.ops import cuda_kernels as ck
        fn = _KERNELS[name] = getattr(ck.library("gather_columns"), name)
    return fn


def _call(block: bytes, n_planes: int, dev: int) -> None:
    from tidb_tpu_torch.ops import cuda_kernels as ck
    rc = _kernel("tt_gather_columns")(
        block, torch._C._cuda_getCurrentRawStream(dev))
    for _ in range(-(-n_planes // MAX_COLS)):
        ck.count("gather_columns")
    if rc:
        ck.check(rc, "gather_columns")


def _outputs(kinds, dtypes, shapes, m: int, device, owned: bool):
    """The outputs of a call on `device`: → (values, masks (None where no
    mask is written), the value pointers, the mask pointers (0: none)).
    One allocation cut by `out_layout`, or with `owned` one allocation an
    output, each owning its storage (a cache keeps them)."""
    if owned:
        vals = [torch.empty(s, dtype=dt, device=device)
                for s, dt in zip(shapes, dtypes)]
        masks = [torch.empty(m, dtype=torch.bool, device=device) if wm
                 else None for _w, _p, wm in kinds]
        return (vals, masks, [v.data_ptr() for v in vals],
                [0 if mk is None else mk.data_ptr() for mk in masks])
    lay = out_layout(kinds, m)
    buf = torch.empty(lay.total, dtype=torch.bool, device=device)
    base = buf.data_ptr()
    pieces = buf.split_with_sizes(lay.sizes) if lay.sizes else ()
    vals = []
    for j, dt, s in zip(lay.vals, dtypes, shapes):
        p = pieces[j]
        if dt != torch.bool:
            p = p.view(dt)
        vals.append(p.view(s) if len(s) == 2 else p)
    masks = [pieces[j] if j >= 0 else None for j in lay.masks]
    return (vals, masks, [base + o for o in lay.voffs],
            [base + o if o >= 0 else 0 for o in lay.moffs])


def _k18(cols, values, idx, n_valid, keep, owned):
    """One K18 call on the card → (columns, values)."""
    dev = _check_index(idx, n_valid, keep)
    m = idx.shape[0]
    entries = [(v, mk, True) for v, mk in cols] + \
        [(a, None, False) for a in values]
    if not entries:
        return [], []
    rows = None
    kinds, dtypes, shapes = [], [], []
    for v, mk, wm in entries:
        w, planes = _kind(v, dev, rows)
        if rows is None:
            rows = v.shape[-1]
        if mk is not None:
            _check_mask(mk, dev, rows)
        kinds.append((w, planes, wm))
        dtypes.append(v.dtype)
        shapes.append((planes, m) if v.dim() == 2 else (m,))
    vals, masks, vptrs, mptrs = _outputs(tuple(kinds), dtypes, shapes, m,
                                         idx.device, owned)
    if m:
        planes = []
        for (v, mk, _wm), (w, k, _), vp, mp in zip(entries, kinds, vptrs,
                                                   mptrs):
            src = v.data_ptr()
            msrc = 0 if mk is None else mk.data_ptr()
            planes += (src, msrc, vp, mp, w)
            for p in range(1, k):
                planes += (src + p * rows * w, 0, vp + p * m * w, 0, w)
        _call(_pack(idx, n_valid, keep, m, rows, planes),
              len(planes) // PLANE_WORDS, dev)
    nc = len(cols)
    return list(zip(vals[:nc], masks[:nc])), vals[nc:]


def gather(cols: Sequence[Column], idx: torch.Tensor, n_valid=None,
           keep=None, values: Sequence[torch.Tensor] = (),
           owned: bool = False):
    """K18 wrapper: every (value, mask-or-None) column and every value
    array (no mask) of one row count gathered through `idx` (int32 or
    int64) → (columns, values). `n_valid` (a 0-d int32 tensor) and `keep`
    (bool, one a slot) cut the output masks. On the card the outputs are
    views of one allocation, or with `owned` each its own tensor."""
    if idx.device.type == "cpu":
        return gather_plain(cols, idx, n_valid, keep, values)
    return _k18(cols, values, idx, n_valid, keep, owned)


def gather_columns(cols: Sequence[Column], idx: torch.Tensor, n_valid=None,
                   keep=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """`gather`'s columns: [(v[..., idx], m[idx] & cut)]."""
    return gather(cols, idx, n_valid, keep)[0]


def inverse_permutation(perm: torch.Tensor, n: int) -> torch.Tensor:
    """K18 wrapper: the inverse of a permutation `perm` of n rows (int32
    or int64), inv[perm[s]] = s as int32: one launch that stores each
    slot number at its row (no source read, no mask written)."""
    if perm.device.type == "cpu":
        return inverse_permutation_plain(perm, n)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    dev = _check_index(perm, None, None)
    inv = torch.empty(n, dtype=torch.int32, device=perm.device)
    m = perm.shape[0]
    if m:
        rc = _kernel("tt_inverse_permutation")(
            perm.data_ptr(), int(perm.dtype == torch.int64), m, n,
            inv.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
        ck.count("gather_columns")
        if rc:
            ck.check(rc, "gather_columns")
    return inv


def gather_slab(v: torch.Tensor, m: torch.Tensor, idx: torch.Tensor,
                n_valid=None, keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slab column (values `v`, 1-D, or a wide decimal's (limbs, rows)
    limb planes that share the mask `m`) gathered through `idx` as
    `gather` does, into outputs that each own their storage: a cached
    slab holding a view of a shared buffer would hold every other
    output's bytes for as long as it is cached, bytes the device cache
    does not count."""
    (out,), _ = gather([(v, m)], idx, n_valid, keep, owned=True)
    return out

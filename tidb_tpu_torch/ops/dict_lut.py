"""Per-dictionary lookup tables gathered by dictionary code (K21 dict_lut).

The JAX package evaluates every string function over a dictionary-coded
column as a host preparation (the function applied to each dictionary
entry once per statement: an int64 result per entry, a bool for LIKE and
REGEXP, or the int32 code of the result in a derived dictionary) and one
device gather, `xp.take(table, codes.astype(int32), mode="clip")`. Its
string equi-join remaps probe codes into the build side's dictionary the
same way (`KeyRemap.eval`: clip, take, then -1 where the code was out of
range). Evaluated eagerly through torch that is three to five launches
over the slab; here one launch of csrc/dict_lut.cu does it.

`dict_lut(table, codes, mode, fill)`:
  clip: out[i] = table[min(max(codes[i], 0), n_lut - 1)]
  fill: out[i] = table[codes[i]] if 0 <= codes[i] < n_lut else fill
The output has the table's dtype (bool, int32 or int64). An empty table
raises IndexError in clip mode over a non-empty codes vector, as
`jnp.take(..., mode="clip")` does; fill mode gives `fill` everywhere.

CPU tensors take the plain version; CUDA tensors launch the kernel (or
raise on anything it does not take). The host path a call is short: the
C function bound once, the checks, one cached row mapping (`lut_plan`),
one allocation, one ctypes call and the launch count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

MODES = ("clip", "fill")
_MODE_CODE = {"clip": 0, "fill": 1}
#: the largest table, in bytes, that K21 stages in shared memory
#: (csrc/dict_lut.cu SMEM_MAX); larger ones are gathered through L2
SMEM_BYTES = 200 * 1024
_LUT_DTYPES = (torch.bool, torch.int32, torch.int64)
_CODE_DTYPES = (torch.int32, torch.int64)
#: csrc/dict_lut.cu tt_dict_lut, bound at the first CUDA call
_KERNEL = None


class LutPlan(NamedTuple):
    """How K21 maps rows to threads for one call (csrc/dict_lut.cu): the
    scalar rows before the codes' first 16-byte boundary (`head`), whole
    warp steps of `rows` rows (each lane's groups of 16 / table-bytes
    rows loaded, gathered, then stored with one 16-byte store, a warp's
    store 512 contiguous bytes), the scalar rows after them (`tail`),
    `pad`, the output's offset in entries inside its allocation that puts
    row `head` on a 16-byte boundary too, and the C entry's `flags` word
    (code and table bytes, mode, head)."""
    rows: int
    head: int
    steps: int
    tail: int
    pad: int
    flags: int


def step_rows(lut_bytes: int) -> int:
    """Rows of one K21 warp step: 32 lanes x 16 bytes of output, twice
    for an int64 table."""
    return 32 * (16 // lut_bytes) * (2 if lut_bytes == 8 else 1)


@functools.lru_cache(maxsize=256)
def lut_plan(phase: int, code_bytes: int, lut_bytes: int, n: int,
             mode: int = 0) -> LutPlan:
    """The row mapping for n codes of `code_bytes` whose first lies
    `phase` bytes past a 16-byte boundary, into a table of `lut_bytes`
    entries, in mode 0 (clip) or 1 (fill) (pure; cached)."""
    rows = step_rows(lut_bytes)
    head = min((16 - phase) % 16 // code_bytes, n)
    steps = (n - head) // rows
    pad = (16 - head * lut_bytes % 16) % 16 // lut_bytes
    flags = code_bytes | lut_bytes << 4 | mode << 8 | head << 12
    return LutPlan(rows, head, steps, n - head - steps * rows, pad, flags)


def in_shared_memory(n_lut: int, lut_bytes: int) -> bool:
    """Whether K21 stages a table of n_lut entries in shared memory (else
    it gathers it through L2)."""
    return n_lut * lut_bytes <= SMEM_BYTES


def _empty_take(n: int) -> None:
    if n > 0:
        raise IndexError("Cannot do a non-empty take from an empty table")


def dict_lut_plain(table, codes, mode: str = "clip", fill: int = -1):
    """Plain torch version of K21: clamp, then index."""
    n_lut = table.shape[0]
    if mode == "fill":
        if n_lut == 0:
            return torch.full(codes.shape, fill, dtype=table.dtype,
                              device=codes.device)
        inside = (codes >= 0) & (codes < n_lut)
        out = table[torch.clamp(codes, 0, n_lut - 1)]
        return torch.where(inside, out,
                           torch.tensor(fill, dtype=table.dtype,
                                        device=codes.device))
    if mode != "clip":
        raise ValueError(f"dict_lut: mode {mode!r} not in {MODES}")
    if n_lut == 0:
        _empty_take(codes.shape[0])
        return torch.empty(codes.shape, dtype=table.dtype,
                           device=codes.device)
    return table[torch.clamp(codes, 0, n_lut - 1)]


def _bind():
    global _KERNEL
    from tidb_tpu_torch.ops import cuda_kernels as ck
    _KERNEL = ck.library("dict_lut").tt_dict_lut
    return _KERNEL


def dict_lut(table, codes, mode: str = "clip", fill: int = -1):
    """K21 wrapper: `table` gathered by `codes` (see the module doc). CPU
    tensors take the plain version. The output may be a view that starts
    a few entries into its allocation (`LutPlan.pad`)."""
    if codes.device.type == "cpu":
        return dict_lut_plain(table, codes, mode, fill)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    mcode = _MODE_CODE.get(mode)
    if mcode is None or not (table.is_cuda and codes.is_cuda) or \
            table.dim() != 1 or codes.dim() != 1 or \
            table.dtype not in _LUT_DTYPES or \
            codes.dtype not in _CODE_DTYPES or \
            not (table.is_contiguous() and codes.is_contiguous()):
        raise ck.KernelError(
            f"dict_lut: mode in {MODES}, a contiguous 1-D bool/int32/int64 "
            f"CUDA table and 1-D int32/int64 CUDA codes expected, got "
            f"{mode!r}, {table.dtype} {tuple(table.shape)} on "
            f"{table.device} and {codes.dtype} {tuple(codes.shape)} on "
            f"{codes.device}")
    n, n_lut = codes.shape[0], table.shape[0]
    if mcode == 0 and n_lut == 0:
        _empty_take(n)
    if table.dtype == torch.bool:
        fill = int(bool(fill))
    kernel = _KERNEL or _bind()
    lb = table.element_size()
    cp = codes.data_ptr()
    plan = lut_plan(cp & 15, codes.element_size(), lb, n, mcode)
    dev = codes.device
    out = torch.empty(n + plan.pad, dtype=table.dtype, device=dev)
    rc = kernel(cp, table.data_ptr(), n_lut, int(fill),
                out.data_ptr() + plan.pad * lb, n, plan.flags,
                ck.stream_ptr(dev))
    if n > 0:
        ck.count("dict_lut")
    if rc:
        ck.check(rc, "dict_lut")
    return out[plan.pad:] if plan.pad else out

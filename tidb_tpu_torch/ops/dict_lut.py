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
raise on anything it does not take).
"""

from __future__ import annotations

import torch

MODES = ("clip", "fill")
#: the largest table, in bytes, that K21 stages in shared memory
#: (csrc/dict_lut.cu SMEM_MAX); larger ones are read through L2
SMEM_BYTES = 48 * 1024
_LUT_DTYPES = (torch.bool, torch.int32, torch.int64)
_CODE_DTYPES = (torch.int32, torch.int64)


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


def dict_lut(table, codes, mode: str = "clip", fill: int = -1):
    """K21 wrapper: `table` gathered by `codes` (see the module doc). CPU
    tensors take the plain version."""
    if codes.device.type == "cpu":
        return dict_lut_plain(table, codes, mode, fill)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(table, codes, what="dict_lut")
    if mode not in MODES:
        raise ck.KernelError(f"dict_lut: mode {mode!r} not in {MODES}")
    if table.dim() != 1 or codes.dim() != 1 or \
            table.dtype not in _LUT_DTYPES or \
            codes.dtype not in _CODE_DTYPES:
        raise ck.KernelError(
            f"dict_lut: a 1-D bool/int32/int64 table and 1-D int32/int64 "
            f"codes expected, got {table.dtype} {tuple(table.shape)} and "
            f"{codes.dtype} {tuple(codes.shape)}")
    n, n_lut = codes.shape[0], table.shape[0]
    if mode == "clip" and n_lut == 0:
        _empty_take(n)
    if table.dtype == torch.bool:
        fill = int(bool(fill))
    out = torch.empty(n, dtype=table.dtype, device=codes.device)
    rc = ck.library("dict_lut").tt_dict_lut(
        codes.data_ptr(), codes.element_size(), table.data_ptr(),
        table.element_size(), n_lut, MODES.index(mode), int(fill),
        out.data_ptr(), n, ck.stream_ptr(codes.device))
    if n > 0:
        ck.count("dict_lut")
    ck.check(rc, "dict_lut")
    return out

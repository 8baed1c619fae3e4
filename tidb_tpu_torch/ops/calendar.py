"""Calendar functions over DATE days and DATETIME microseconds (K20
civil_date).

The JAX package computes every calendar part with Hinnant's civil-date
algorithm as a chain of integer jnp ops (`_civil_from_days`,
`_days_from_civil`, `_date_part`, the month branch of
`_date_add_interval`, `dayofyear`, `quarter`, `week`, `last_day`,
`dayofweek`, `weekday`, `_time_part`), which XLA fuses into one pass per
slab. Evaluated eagerly through torch, each of them is 20-40 launches
over full-slab int64 temporaries; here one launch of
csrc/civil_date.cu computes the part in registers.

Inputs are int32 or int64 days since 1970-01-01 (`micros=False`) or
int64 microseconds since the epoch (`micros=True`, floor-divided to days
as the reference does). Outputs keep the reference's dtypes: int64
parts, int32 `last_day`, and for `date_add_months` int32 days (a DATE)
or int64 microseconds (a DATETIME, the time of day kept).

`civil_part` and `date_add_months` take their plain versions for CPU
tensors and launch the kernel for CUDA tensors (or raise on anything the
kernel does not take). The plain versions repeat the reference's
arithmetic op for op in torch int64, wrapping as it wraps. The host path
of a call is short: the C entry bound once, a cached flags word that
picks the kernel instance, one allocation and one ctypes call.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

from tidb_tpu_torch.ops import cuda_kernels as ck

#: part names, in the kernel's code order (csrc/civil_date.cu Part)
PARTS = ("year", "month", "day", "dayofyear", "quarter", "week",
         "last_day", "dayofweek", "weekday", "hour", "minute", "second")
DAY_US = 86_400_000_000
_TIME_UNITS = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
               "second": (1_000_000, 60)}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _floor_mod(a, n):
    return a - (a // n) * n


def civil_from_days(days):
    """int64 days → (year, month, day), each int64 (the reference's
    `_civil_from_days`)."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    mth = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(mp >= 10, y + 1, y)
    return y, mth, d


def days_from_civil(y, mth, d):
    """(year, month, day) → int64 days; inverse of civil_from_days (the
    reference's `_days_from_civil`)."""
    y = y - (mth <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(mth > 2, mth - 3, mth + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days(v, micros: bool):
    v = v.to(torch.int64)
    return v // DAY_US if micros else v


def civil_part_plain(v, part: str, micros: bool):
    """Plain torch version of K20's civil_part."""
    if part in _TIME_UNITS:
        if not micros:
            return torch.zeros(v.shape[0], dtype=torch.int64,
                               device=v.device)
        unit, modulo = _TIME_UNITS[part]
        return _floor_mod(v.to(torch.int64) // unit, modulo)
    days = _days(v, micros)
    if part == "dayofweek":
        return _floor_mod(days + 4, 7) + 1
    if part == "weekday":
        return _floor_mod(days + 3, 7)
    y, mth, d = civil_from_days(days)
    if part in ("year", "month", "day"):
        return {"year": y, "month": mth, "day": d}[part]
    if part == "quarter":
        return (mth + 2) // 3
    one = torch.ones_like(y)
    if part == "last_day":
        ny = torch.where(mth == 12, y + 1, y)
        nm = torch.where(mth == 12, one, mth + 1)
        return (days_from_civil(ny, nm, one) - 1).to(torch.int32)
    jan1 = days_from_civil(y, one, one)
    if part == "dayofyear":
        return days - jan1 + 1
    if part == "week":
        jan1_dow = _floor_mod(jan1 + 4, 7)        # 0 = Sunday
        first_sunday = jan1 + _floor_mod(-jan1_dow, 7)
        return torch.where(days < first_sunday, torch.zeros_like(days),
                           (days - first_sunday) // 7 + 1)
    raise ValueError(f"civil_part: unknown part {part!r}")


def date_add_months_plain(v, micros: bool, n_months, mult: int):
    """Plain torch version of K20's date_add_months: the month branch of
    the reference's `_date_add_interval`, with `months = n * mult`."""
    n = n_months if isinstance(n_months, torch.Tensor) else \
        torch.full((v.shape[0],), int(n_months), dtype=torch.int64,
                   device=v.device)
    months = n.to(torch.int64) * mult
    days = _days(v, micros)
    y, mth, d = civil_from_days(days)
    tot = y * 12 + (mth - 1) + months
    ny = tot // 12
    nm = tot - ny * 12 + 1
    one = torch.ones_like(d)
    nxt = days_from_civil(torch.where(nm == 12, ny + 1, ny),
                          torch.where(nm == 12, one, nm + 1), one)
    first = days_from_civil(ny, nm, one)
    nd = torch.minimum(d, nxt - first)
    out_days = days_from_civil(ny, nm, nd)
    if micros:
        return out_days * DAY_US + (v - days * DAY_US)
    return out_days.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: csrc/civil_date.cu's two C entries, bound at the first CUDA call
_KERNELS = None
_MULTS = (1, 3, 12)


def _bind():
    global _KERNELS
    lib = ck.library("civil_date")
    _KERNELS = (lib.tt_civil_part, lib.tt_date_add_months)
    return _KERNELS


def _kind(dtype, micros: bool) -> int:
    """Kernel input code: 0 int32 days, 1 int64 days, 2 int64 µs."""
    if dtype not in (torch.int32, torch.int64) or \
            (micros and dtype != torch.int64):
        raise ck.KernelError(f"civil_date: int32/int64 days or int64 "
                             f"microseconds expected, got {dtype}")
    return 2 if micros else int(dtype == torch.int64)


@functools.lru_cache(maxsize=None)
def part_flags(part: str, micros: bool, dtype) -> int:
    """tt_civil_part's flags word: the input kind (0 int32 days, 1 int64
    days, 2 int64 µs) in bits 0-1, the part's code in bits 4-7."""
    if part not in PARTS:
        raise ck.KernelError(f"civil_part: unknown part {part!r}")
    return _kind(dtype, micros) | PARTS.index(part) << 4


@functools.lru_cache(maxsize=None)
def add_flags(micros: bool, dtype, mult: int, per_row: bool) -> int:
    """tt_date_add_months's flags word: the input kind in bits 0-1, mult in
    bits 4-7, a month count per row in bit 8."""
    if mult not in _MULTS:
        raise ck.KernelError(f"date_add_months: mult {mult} not 1, 3, 12")
    return _kind(dtype, micros) | mult << 4 | int(per_row) << 8


def _one_d_cuda(v, what: str):
    if not v.is_cuda or v.dim() != 1:
        raise ck.KernelError(f"{what}: a 1-D CUDA tensor expected, got "
                             f"{tuple(v.shape)} on {v.device}")
    return v if v.is_contiguous() else v.contiguous()


def civil_part(v, part: str, micros: bool):
    """K20 wrapper: one calendar part of every row of `v` (int64; int32
    for `last_day`). CPU tensors take the plain version."""
    if v.is_cpu:
        return civil_part_plain(v, part, micros)
    flags = part_flags(part, micros, v.dtype)
    v = _one_d_cuda(v, "civil_part")
    kernel = (_KERNELS or _bind())[0]
    n = v.shape[0]
    out = v.new_empty(n, dtype=torch.int32 if part == "last_day"
                      else torch.int64)
    rc = kernel(v.data_ptr(), out.data_ptr(), n, flags,
                ck.stream_ptr(v.device))
    if n > 0:
        ck.count("civil_date")
    if rc:
        ck.check(rc, "civil_part")
    return out


def date_add_months(v, micros: bool, n_months: Union[int, torch.Tensor],
                    mult: int):
    """K20 wrapper: `v` plus `n_months * mult` months, the day clamped to
    the target month's length (int32 days, or int64 µs for `micros`).
    `n_months` is an int64 tensor of v's length or one int for every
    row; `mult` is 1, 3 or 12. CPU tensors take the plain version."""
    if v.is_cpu:
        return date_add_months_plain(v, micros, n_months, mult)
    per_row = isinstance(n_months, torch.Tensor)
    flags = add_flags(micros, v.dtype, mult, per_row)
    v = _one_d_cuda(v, "date_add_months")
    kernel = (_KERNELS or _bind())[1]
    n = v.shape[0]
    n_ptr, n_scalar = None, 0
    if per_row:
        n_months = _one_d_cuda(n_months, "date_add_months")
        if n_months.dtype != torch.int64 or n_months.shape[0] != n or \
                n_months.get_device() != v.get_device():
            raise ck.KernelError("date_add_months: an int64 month count "
                                 "per row on v's device expected")
        n_ptr = n_months.data_ptr()
    else:
        n_scalar = int(n_months)
    out = v.new_empty(n, dtype=torch.int64 if micros else torch.int32)
    rc = kernel(v.data_ptr(), n_ptr, n_scalar, out.data_ptr(), n, flags,
                ck.stream_ptr(v.device))
    if n > 0:
        ck.count("civil_date")
    if rc:
        ck.check(rc, "date_add_months")
    return out

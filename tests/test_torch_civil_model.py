"""A numpy model of K20 civil_date's 32-bit path and of its warp range
guard (csrc/civil_date.cu), held to the JAX package's calendar code run
through its device branches with jax.numpy on the CPU.

The model repeats the kernel's arithmetic in uint32 (and its few 64-bit
steps in int64) line for line: z = days + Z0, Hinnant's decomposition of
z, the parts from it, and date_add_months through the target month's
index U = 12·Y + mp + months. A warp of the model is 32 lanes of 4
(int32 input) or 2 (int64 input) rows; it takes the 32-bit path when
every row of it is in range, else the 64-bit path, which is the plain
version's arithmetic (held to the reference by tests/
test_torch_calendar.py). Inputs: every day of 0001-9999, a strided
sample over the whole proven range, every guard edge ±2, µs values over
the whole int64 range, and warps that mix in-range and out-of-range
rows; every part and every (kind, mult)."""

import datetime
import functools

import numpy as np
import pytest
import torch

from tidb_tpu.ops import jax_env  # noqa: F401  (x64 before jax.numpy)
import jax
import jax.numpy as jnp
from tidb_tpu import expression as JE
from tidb_tpu import types as JT
from tidb_tpu_torch.ops import calendar

DAY_US = 86_400_000_000
U32 = np.uint32
# csrc/civil_date.cu's constants
SHIFT_ERAS = 800
Z0 = 719468 + 146097 * SHIFT_ERAS
LO = -Z0
HI = (1 << 32) - 8 - Z0
YEAR0 = 400 * SHIFT_ERAS
DOW_C = (4 - Z0) % 7
WKD_C = (3 - Z0) % 7
SHORT_MONTHS = (1 << 1) | (1 << 3) | (1 << 6) | (1 << 8)
KINDS = {"days32": 0, "days64": 1, "micros": 2}

_EPOCH = datetime.date(1970, 1, 1)
FIRST = (datetime.date(1, 1, 1) - _EPOCH).days
LAST = (datetime.date(9999, 12, 31) - _EPOCH).days
I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)
DATE = JT.FieldType(JT.TypeKind.DATE)
DATETIME = JT.FieldType(JT.TypeKind.DATETIME)
BIGINT = JT.FieldType(JT.TypeKind.BIGINT)
_OPS = {"year": "year", "month": "month", "day": "dayofmonth",
        "dayofyear": "dayofyear", "quarter": "quarter", "week": "week",
        "last_day": "last_day", "dayofweek": "dayofweek",
        "weekday": "weekday", "hour": "hour", "minute": "minute",
        "second": "second"}
_UNITS = {1: "month", 3: "quarter", 12: "year"}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def leap(r):
    """A year whose residue mod 400 is r (uint32, 0..400) is a leap year."""
    r = r.astype(U32)
    return (((r & U32(3)) == 0) & ((r % U32(100) != 0) |
                                   (r % U32(400) == 0))).astype(U32)


def month_days(mp, yoe):
    return np.where(mp == 11, U32(28) + leap(yoe + U32(1)),
                    U32(31) - ((U32(SHORT_MONTHS) >> mp) & U32(1)))


def civil32(z):
    """Hinnant's decomposition in uint32 → (yoe, y, doy, mp, d)."""
    z = z.astype(U32)
    era = z // U32(146097)
    doe = z - era * U32(146097)
    yoe = (doe - doe // U32(1460) + doe // U32(36524) -
           doe // U32(146096)) // U32(365)
    y = era * U32(400) + yoe
    doy = doe - (U32(365) * yoe + yoe // U32(4) - yoe // U32(100))
    mp = (U32(5) * doy + U32(2)) // U32(153)
    d = doy - (U32(153) * mp + U32(2)) // U32(5) + U32(1)
    return yoe, y, doy, mp, d


def z_of(days):
    """uint32 z of in-range days (other rows: any value)."""
    return (days.astype(np.int64) + Z0).astype(np.uint64).astype(U32)


def part32(days, part):
    """The kernel's 32-bit path for one date part (int64; int32 for
    last_day), valid for days in [LO, HI]."""
    z = z_of(days)
    if part == "dayofweek":
        return ((z + U32(DOW_C)) % U32(7) + U32(1)).astype(np.int64)
    if part == "weekday":
        return ((z + U32(WKD_C)) % U32(7)).astype(np.int64)
    yoe, y, doy, mp, d = civil32(z)
    month = np.where(mp < 10, mp + U32(3), mp - U32(9))
    if part == "year":
        return y.astype(np.int64) - YEAR0 + (mp >= 10)
    if part == "month":
        return month.astype(np.int64)
    if part == "day":
        return d.astype(np.int64)
    if part == "quarter":
        return ((month + U32(2)) // U32(3)).astype(np.int64)
    if part == "last_day":
        low = days.astype(np.int64).astype(np.uint64).astype(U32)
        return (low - d + month_days(mp, yoe)).astype(np.int32)
    doy0 = np.where(mp >= 10, doy - U32(305),
                    doy + U32(60) + leap(yoe)) - U32(1)
    if part == "dayofyear":
        return (doy0 + U32(1)).astype(np.int64)
    assert part == "week"
    jan1_dow = ((z + U32(DOW_C)) % U32(7) + U32(371) - doy0) % U32(7)
    first_sunday = (U32(7) - jan1_dow) % U32(7)
    return np.where(doy0 < first_sunday, U32(0),
                    (doy0 - first_sunday) // U32(7) + U32(1)).astype(
                        np.int64)


def time32(us, part):
    """hour / minute / second of µs through the exact time of day."""
    days = us // DAY_US
    tod = (us.astype(np.uint64) - days.astype(np.uint64) *
           np.uint64(DAY_US))
    s = (tod // np.uint64(1_000_000)).astype(U32)
    out = {"hour": s // U32(3600), "minute": s // U32(60) % U32(60),
           "second": s % U32(60)}[part]
    return out.astype(np.int64)


def in_range(days, kind: str):
    if kind == "micros":
        return np.ones(days.shape, dtype=bool)
    if kind == "days32":
        return days >= LO
    return (days >= LO) & (days <= HI)


def add32(days, months):
    """date_add_months' 32-bit path → (row ok for it, target days as
    int64)."""
    z = z_of(days)
    _yoe, y, _doy, mp, d = civil32(z)
    with np.errstate(over="ignore"):
        idx = (12 * y.astype(np.int64) + mp.astype(np.int64)) + months
    ok = (idx >= 0) & (idx < (1 << 32))
    t = np.where(ok, idx, 0).astype(U32)
    ty = t // U32(12)
    tmp = t - U32(12) * ty
    dim = month_days(tmp, ty % U32(400))
    nd = np.minimum(d, dim)
    first = (365 * ty.astype(np.int64) +
             (ty // U32(4) - ty // U32(100) + ty // U32(400)).astype(
                 np.int64) +
             ((U32(153) * tmp + U32(2)) // U32(5)).astype(np.int64))
    return ok, first + nd.astype(np.int64) - 1 - Z0


def _rows_per_lane(kind: str) -> int:
    return 4 if kind == "days32" else 2


def warps_of(ok, kind: str):
    """Each row's warp-wide vote: all rows of its warp (32 lanes x 4 or
    2 rows, from row 0) ok."""
    w = 32 * _rows_per_lane(kind)
    pad = -len(ok) % w
    full = np.concatenate([ok, np.ones(pad, dtype=bool)]).reshape(-1, w)
    return np.repeat(full.all(axis=1), w)[:len(ok)]


def _days_of(v, kind: str):
    v = v.astype(np.int64)
    return v // DAY_US if kind == "micros" else v


def model_part(v, kind: str, part: str, fast32=None):
    """K20's civil_part as the model runs it: the warp vote, then the
    32-bit path (`fast32`, where the caller has it already) or the 64-bit
    path (the plain version's arithmetic)."""
    if part in ("hour", "minute", "second"):
        if kind != "micros":
            return np.zeros(len(v), dtype=np.int64)
        return time32(v, part)
    days = _days_of(v, kind)
    fast = warps_of(in_range(days, kind), kind)
    with np.errstate(over="ignore"):
        out = part32(days, part) if fast32 is None else fast32.copy()
    out[~fast] = calendar.civil_part_plain(torch.from_numpy(v[~fast]), part,
                                           kind == "micros").numpy()
    return out


def model_add(v, kind: str, n, mult: int):
    days = _days_of(v, kind)
    with np.errstate(over="ignore"):
        months = n.astype(np.int64) * mult
    ok, od = add32(days, months)
    fast = warps_of(in_range(days, kind) & ok, kind)
    if kind == "micros":
        with np.errstate(over="ignore"):
            out = od * DAY_US + (v - days * DAY_US)
    else:
        out = od.astype(np.int32)
    out[~fast] = calendar.date_add_months_plain(
        torch.from_numpy(v[~fast]), kind == "micros",
        torch.from_numpy(n[~fast]), mult).numpy()
    return out, fast


# ---------------------------------------------------------------------------
# inputs and the reference
# ---------------------------------------------------------------------------

EDGES = np.array([LO - 2, LO - 1, LO, LO + 1, LO + 2,
                  HI - 2, HI - 1, HI, HI + 1, HI + 2], dtype=np.int64)
#: every day of 0001-9999
ALL_DAYS = np.arange(FIRST, LAST + 1, dtype=np.int64)
#: a strided sample over the whole proven range
STRIDED = np.arange(LO, HI + 1, 9973, dtype=np.int64)


def _days64():
    """int64 days: the strided sample, the guard edges and the int32 and
    int64 extremes (every day of 0001-9999 runs as int32 days: the 32-bit
    path's arithmetic does not depend on the input's width)."""
    return np.concatenate([STRIDED, EDGES,
                           [I32.min, I32.max, I64.min, I64.max,
                            -(1 << 40), 1 << 40]])


def _days32():
    d = np.concatenate([ALL_DAYS, _days64()])
    return d[(d >= I32.min) & (d <= I32.max)].astype(np.int32)


def _micros():
    rng = np.random.default_rng(19)
    return np.concatenate([
        rng.integers(FIRST * DAY_US, (LAST + 1) * DAY_US, 100_000),
        rng.integers(I64.min, I64.max, 100_000, endpoint=True),
        [I64.min, I64.min + 1, -DAY_US - 1, -1, 0, DAY_US - 1, I64.max]])


def _mixed(kind: str):
    """Warps that mix in-range rows with out-of-range ones: each warp's
    rows are in-range days but for one row at a random lane."""
    rng = np.random.default_rng(23)
    w = 32 * _rows_per_lane(kind)
    v = rng.integers(FIRST, LAST + 1, 64 * w).astype(np.int64)
    out = np.array([LO - 1, LO - 2, HI + 1, I64.min, I64.max, -(1 << 40)])
    if kind == "days32":
        out = np.array([LO - 1, LO - 2, I32.min, I32.min + 1])
    bad = rng.integers(0, w, 48) + np.arange(48) * w
    v[bad] = rng.choice(out, 48)
    return v.astype(np.int32 if kind == "days32" else np.int64)


#: each kind's rows: the mixed warps first (the model's warps start at
#: row 0), then the rest
INPUTS = {"days32": np.concatenate([_mixed("days32"), _days32()]),
          "days64": np.concatenate([_mixed("days64"), _days64()]),
          "micros": _micros()}
#: date_add_months' rows: the same but every 4th day of 0001-9999 (each
#: day of month of each month, in every year, against per-row counts)
ADD_INPUTS = dict(INPUTS, days32=np.concatenate([
    _mixed("days32"), ALL_DAYS[::4].astype(np.int32),
    _days32()[len(ALL_DAYS):]]))


@functools.lru_cache(maxsize=None)
def _jitted(op, ftype, with_n: bool):
    """The JAX package's registered kernel `op` through its device branch
    (jax.numpy, on_device=True), jitted."""
    def run(values, n_months):
        ones = jnp.ones(values.shape[0], dtype=bool)
        cols = [(values, ones)]
        args = [JE.ColumnRef(0, ftype)]
        if with_n:
            cols.append((n_months, ones))
            args.append(JE.ColumnRef(1, BIGINT))
        ctx = JE.EvalContext(jnp, cols, on_device=True)
        return JE.ScalarFunc(op, args, ftype).eval(ctx)[0]
    return jax.jit(run)


def _reference(op, values, ftype, n_months=None):
    """→ numpy; a DATE input runs as int64 days (the reference widens
    every days input to int64 first)."""
    if ftype is DATE:
        values = values.astype(np.int64)
    out = _jitted(op, ftype, n_months is not None)(values, n_months)
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def _part_reference(part):
    """The reference of `part` over every kind's rows, in one call for the
    two days kinds → {kind: numpy}."""
    d64, d32 = INPUTS["days64"], INPUTS["days32"]
    days = _reference(_OPS[part], np.concatenate([d64, d32]), DATE)
    return {"days64": days[:len(d64)], "days32": days[len(d64):],
            "micros": _reference(_OPS[part], INPUTS["micros"], DATETIME)}


def _counts(kind: str, mult: int):
    """Per-row month counts: in [-1200, 1200]; in every 8th warp of the
    model, counts that put U at its guard edges ±2 for a tenth of its
    rows; in every 64th, counts far outside (wrapping) for 2% of its
    rows."""
    rng = np.random.default_rng(mult * 10 + KINDS[kind])
    v = ADD_INPUTS[kind]
    n = rng.integers(-1200, 1201, len(v))
    _yoe, y, _doy, mp, _d = civil32(z_of(_days_of(v, kind)))
    cur = 12 * y.astype(np.int64) + mp.astype(np.int64)
    warp = np.arange(len(v)) // (32 * _rows_per_lane(kind))
    pick = (warp % 8 == 0) & (rng.random(len(v)) < 0.1)
    goal = rng.choice(np.array([-2, -1, 0, 1, 2, (1 << 32) - 2,
                                (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                                (1 << 32) + 2]), len(v))
    n = np.where(pick, (goal - cur) // mult, n)
    far = (warp % 64 == 1) & (rng.random(len(v)) < 0.02)
    return np.where(far, rng.integers(I64.min, I64.max, len(v)), n)


@functools.lru_cache(maxsize=None)
def _add_reference(mult: int):
    """The reference of date_add by `mult` months over every kind's rows
    and counts, in one call for the two days kinds → {kind: (n, want)}."""
    op = f"date_add_{_UNITS[mult]}"
    n = {kind: _counts(kind, mult) for kind in KINDS}
    d64, d32 = ADD_INPUTS["days64"], ADD_INPUTS["days32"]
    days = _reference(op, np.concatenate([d64, d32]), DATE,
                      np.concatenate([n["days64"], n["days32"]]))
    return {"days64": (n["days64"], days[:len(d64)].astype(np.int32)),
            "days32": (n["days32"], days[len(d64):].astype(np.int32)),
            "micros": (n["micros"], _reference(op, INPUTS["micros"],
                                               DATETIME, n["micros"]))}


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (bad[:5], got[bad[:5]], want[bad[:5]])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_range_constants():
    """The proven range holds every int32 day from -719,468 to 2^31 -
    719,469 (z of Hinnant's origin and up, as signed 32-bit) and every
    day of a µs input; z stays within uint32 with room for the weekday's
    + 6."""
    assert LO <= -719_468 and HI >= (1 << 31) - 719_469
    assert LO <= I64.min // DAY_US and HI >= I64.max // DAY_US
    assert 0 <= HI + Z0 <= (1 << 32) - 1 - 6
    assert Z0 % 146097 == 719468 % 146097 and YEAR0 % 400 == 0
    # the guard edges
    assert in_range(EDGES, "days64").tolist() == [False, False] + [True] * 6 \
        + [False, False]
    assert not in_range(np.array([LO - 1], dtype=np.int64), "days32")[0]


@pytest.mark.parametrize("part", calendar.PARTS)
def test_part32_equals_reference(part):
    """Every part over every kind, each row through the model's vote:
    in-range warps by the 32-bit path, mixed warps by the 64-bit path."""
    ref = _part_reference(part)
    for kind, v in INPUTS.items():
        want = ref[kind]
        fast32 = None
        if part not in ("hour", "minute", "second"):
            # the 32-bit path alone on every in-range row
            days = _days_of(v, kind)
            inside = in_range(days, kind)
            with np.errstate(over="ignore"):
                fast32 = part32(days, part)
            _same(fast32[inside].astype(want.dtype), want[inside])
        _same(model_part(v, kind, part, fast32).astype(want.dtype), want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mult", [1, 3, 12])
def test_add32_equals_reference(kind, mult):
    """date_add_months per row: counts in [-1200, 1200], counts that put
    U at its guard edges ±2, and counts far outside (wrapping)."""
    n, want = _add_reference(mult)[kind]
    v = ADD_INPUTS[kind]
    got, fast = model_add(v, kind, n, mult)
    _same(got.astype(want.dtype), want)
    assert fast.any() and (~fast).any()
    # the 32-bit path alone on every row it takes
    days = _days_of(v, kind)
    with np.errstate(over="ignore"):
        ok, od = add32(days, n * mult)
    ok &= in_range(days, kind)
    if kind == "micros":
        with np.errstate(over="ignore"):
            od = od * DAY_US + (v - days * DAY_US)
    _same(od[ok].astype(want.dtype), want[ok])


def test_mixed_warps_take_the_64_bit_path():
    """A warp with one out-of-range row computes every row on the 64-bit
    path; the warps around it keep the 32-bit path."""
    for kind in ("days32", "days64"):
        v = _mixed(kind)
        days = _days_of(v, kind)
        fast = warps_of(in_range(days, kind), kind)
        w = 32 * _rows_per_lane(kind)
        per_warp = fast.reshape(-1, w)
        assert (per_warp.all(axis=1) | ~per_warp.any(axis=1)).all()
        assert (~per_warp[:48, 0]).all() and per_warp[48:, 0].all()

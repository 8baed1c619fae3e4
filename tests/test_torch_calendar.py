"""ops/calendar's plain versions (K20 civil_date's reference on the
card) against the JAX package's own calendar code run with jax.numpy on
the CPU: `_civil_from_days` / `_days_from_civil`, and the registered
kernels year … last_day, dayofweek, weekday, hour/minute/second and
date_add_month/quarter/year evaluated through their device branch. Over
every day of 0001-01-01 .. 9999-12-31, the int32 edges, days beyond
MySQL's range, and µs values on both sides of the epoch up to the int64
edges. Values and dtypes exactly equal. Each reference is jitted and
computed once for the module (every part of one input in one call, each
unit's DATE_ADD cases in one call)."""

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
_EPOCH = datetime.date(1970, 1, 1)
FIRST = (datetime.date(1, 1, 1) - _EPOCH).days
LAST = (datetime.date(9999, 12, 31) - _EPOCH).days
I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)


def _days(*dates):
    return [(datetime.date(*d) - _EPOCH).days for d in dates]


#: every day of 0001-9999
ALL_DAYS = np.arange(FIRST, LAST + 1, dtype=np.int32)
#: the int32 edges, days past 9999 and before 0001, month ends, leap days
EDGE_DAYS = np.array(
    [I32.min, I32.min + 1, I32.min + 719468, -10**9, FIRST - 1, -719468,
     -719469, -1, 0, 1, LAST + 1, 10**9, I32.max - 719468, I32.max - 1,
     I32.max]
    + _days((2000, 1, 31), (2000, 2, 29), (2100, 2, 28), (1900, 2, 28),
            (2024, 2, 29), (2023, 12, 31), (1969, 12, 31)),
    dtype=np.int32)


def _micros(n):
    rng = np.random.default_rng(5)
    near = rng.integers(FIRST * DAY_US, (LAST + 1) * DAY_US, n)
    full = rng.integers(I64.min, I64.max, n // 8, endpoint=True)
    edges = np.array([I64.min, I64.min + 1, -DAY_US - 1, -DAY_US, -1, 0, 1,
                      DAY_US - 1, DAY_US, I64.max - 1, I64.max],
                     dtype=np.int64)
    return np.concatenate([near, full, edges])


MICROS = _micros(200_000)
DATE = JT.FieldType(JT.TypeKind.DATE)
DATETIME = JT.FieldType(JT.TypeKind.DATETIME)
BIGINT = JT.FieldType(JT.TypeKind.BIGINT)


def _eval(op, values, ftype, n_months=None):
    """The JAX package's registered kernel `op` through its device branch
    (jax.numpy, on_device=True)."""
    ones = jnp.ones(values.shape[0], dtype=bool)
    cols = [(values, ones)]
    args = [JE.ColumnRef(0, ftype)]
    if n_months is not None:
        cols.append((n_months, ones))
        args.append(JE.ColumnRef(1, BIGINT))
    ctx = JE.EvalContext(jnp, cols, on_device=True)
    out, _m = JE.ScalarFunc(op, args, ftype).eval(ctx)
    return out


@functools.lru_cache(maxsize=None)
def _parts_reference(micros: bool):
    """Every part's reference over the days (every day and the edges) or
    the µs values, in one jitted call for the module → {part: numpy}."""
    values = MICROS if micros else np.concatenate([ALL_DAYS, EDGE_DAYS])
    ftype = DATETIME if micros else DATE
    run = jax.jit(lambda v: {p: _eval(_OPS[p], v, ftype)
                             for p in calendar.PARTS})
    return {p: np.asarray(o) for p, o in run(values).items()}


@functools.lru_cache(maxsize=None)
def _add_reference(unit: str):
    """date_add_<unit>'s reference over each case of
    test_date_add_months_equals_reference, in one jitted call → the
    inputs and outputs (the counts from the test's own seed)."""
    mult = {"month": 1, "quarter": 3, "year": 12}[unit]
    op = f"date_add_{unit}"
    rng = np.random.default_rng(mult)
    days = np.concatenate([ALL_DAYS, EDGE_DAYS])
    n = rng.integers(-1200, 1201, len(days))
    n_us = rng.integers(-1200, 1201, len(MICROS))
    few = np.concatenate([EDGE_DAYS, ALL_DAYS[::97]])
    ks = (-1200, -13, -1, 0, 1, 11, 12, 13, 1200)
    few_n = np.concatenate([np.full(len(few), k) for k in ks])
    run = jax.jit(lambda d, dn, u, un, f, fn: (
        _eval(op, d, DATE, dn), _eval(op, u, DATETIME, un),
        _eval(op, f, DATE, fn)))
    got = run(days, n, MICROS, n_us, np.tile(few, len(ks)), few_n)
    want_days, want_us, want_few = (np.asarray(o) for o in got)
    return (days, n, want_days, n_us, want_us, few, ks,
            np.split(want_few, len(ks)))


def _same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (bad[:5], got[bad[:5]], want[bad[:5]])


_OPS = {"year": "year", "month": "month", "day": "dayofmonth",
        "dayofyear": "dayofyear", "quarter": "quarter", "week": "week",
        "last_day": "last_day", "dayofweek": "dayofweek",
        "weekday": "weekday", "hour": "hour", "minute": "minute",
        "second": "second"}


def test_parts_cover_the_kernel():
    assert set(_OPS) == set(calendar.PARTS)


@pytest.mark.parametrize("part", calendar.PARTS)
def test_civil_part_on_days_equals_reference(part):
    days = np.concatenate([ALL_DAYS, EDGE_DAYS])
    _same(calendar.civil_part(torch.from_numpy(days), part, micros=False),
          _parts_reference(False)[part])


@pytest.mark.parametrize("part", calendar.PARTS)
def test_civil_part_on_micros_equals_reference(part):
    _same(calendar.civil_part(torch.from_numpy(MICROS), part, micros=True),
          _parts_reference(True)[part])


def test_civil_helpers_equal_reference():
    days = np.concatenate([ALL_DAYS, EDGE_DAYS]).astype(np.int64)
    got = calendar.civil_from_days(torch.from_numpy(days))

    def civil_and_back(d):
        ymd = JE._civil_from_days(jnp, d)
        return ymd, JE._days_from_civil(jnp, *ymd)

    want, back = jax.jit(civil_and_back)(days)
    for g, w in zip(got, want):
        _same(g, np.asarray(w))
    y, m, d = got
    _same(calendar.days_from_civil(y, m, d), np.asarray(back))
    assert torch.equal(calendar.days_from_civil(y, m, d),
                       torch.from_numpy(days))


@pytest.mark.parametrize("unit,mult", [("month", 1), ("quarter", 3),
                                       ("year", 12)])
def test_date_add_months_equals_reference(unit, mult):
    """Every day with a per-row month count in [-1200, 1200], and a few
    constant counts over Jan 31, Feb 29 and the edges, as DATE and as
    DATETIME."""
    days, n, want_days, n_us, want_us, few, ks, want_few = \
        _add_reference(unit)
    _same(calendar.date_add_months(torch.from_numpy(days), False,
                                   torch.from_numpy(n), mult), want_days)
    _same(calendar.date_add_months(torch.from_numpy(MICROS), True,
                                   torch.from_numpy(n_us), mult), want_us)
    for k, want in zip(ks, want_few):
        _same(calendar.date_add_months(torch.from_numpy(few), False, k,
                                       mult), want)


def test_month_ends_clamp():
    jan31, feb29 = _days((2020, 1, 31), (2020, 2, 29))
    v = torch.tensor([jan31, feb29, feb29], dtype=torch.int32)
    out = calendar.date_add_months(v, False, torch.tensor([1, 12, -12]), 1)
    assert out.tolist() == _days((2020, 2, 29), (2021, 2, 28),
                                 (2019, 2, 28))

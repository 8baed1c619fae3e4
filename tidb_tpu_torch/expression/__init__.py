"""Scalar expression engine — vectorized, NULL-aware, device-traceable.

Ref: /root/reference/expression/ (Expression/VecExpr, expression.go:63-78;
vectorized builtins, builtin_*_vec.go). Instead of 562 per-signature structs
with scalar+vec twins, one expression tree evaluates under any array
namespace: numpy on host (the CPU oracle/baseline) and a numpy-surface torch
namespace on the engine's device (ops/xp.TorchXP, the device path). A column of values is always the pair (values, validity);
every kernel implements MySQL's three-valued logic explicitly.

String strategy (TPU-first): device strings are int32 dictionary codes whose
dictionary is SORTED (np.unique), so order comparisons against constants
become integer rank comparisons, and arbitrary per-row string functions
become a host-side evaluation over the (small) dictionary plus a device
gather by code — the "dictionary pushdown" pattern. Host-side preparation is
collected by `collect_preparations` and fed to jitted fragments as traced
inputs so dictionaries never bake into the XLA program.
"""

from __future__ import annotations

import fnmatch
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tidb_tpu_torch import types as T
from tidb_tpu_torch.errors import (ExecutionError, TypeError_,
                             UnknownColumnError)
from tidb_tpu_torch.ops import calendar
from tidb_tpu_torch.ops.dict_lut import dict_lut
from tidb_tpu_torch.ops.xp import astype
from tidb_tpu_torch.types import FieldType, TypeKind

# ---------------------------------------------------------------------------
# Evaluation context
# ---------------------------------------------------------------------------


class EvalContext:
    """Bridges an expression tree to a batch of input columns.

    `columns[i]` → (values, validity) arrays under namespace `xp`.
    On device, string columns hold dictionary codes and `dictionaries[i]`
    holds the (host-side) sorted dictionary; `prepared` maps expression node
    ids to host-precomputed traced inputs (constant ranks, dictionary-mapped
    lookup tables).
    """

    def __init__(self, xp, columns: Sequence[Tuple], *,
                 dictionaries: Optional[Sequence[Optional[np.ndarray]]] = None,
                 prepared: Optional[Dict[int, object]] = None,
                 on_device: bool = False, n_rows: Optional[int] = None):
        self.xp = xp
        self._columns = list(columns)
        self.dictionaries = list(dictionaries) if dictionaries else [
            None] * len(self._columns)
        self.prepared = prepared or {}
        self.on_device = on_device
        self._n_rows = n_rows

    def column(self, i: int):
        return self._columns[i]

    @property
    def num_rows(self):
        if self._n_rows is not None:
            return self._n_rows
        for c in self._columns:
            if c is not None:       # unused positions ride as None
                return c[0].shape[0]
        return 0


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Expression:
    ftype: FieldType

    def children(self) -> List["Expression"]:
        return []

    def eval(self, ctx: EvalContext):
        """→ (values, validity) arrays, full batch length."""
        raise NotImplementedError

    # host-side per-batch preparation (dictionary-dependent constants)
    def prepare(self, dictionaries) -> Optional[object]:
        return None

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()

    def references(self) -> List[int]:
        return sorted({e.index for e in self.walk() if isinstance(e, ColumnRef)})

    def is_constant(self) -> bool:
        return all(not isinstance(e, ColumnRef) for e in self.walk())


@dataclass(eq=False)
class ColumnRef(Expression):
    """Positional input column reference (ref: expression/column.go)."""

    index: int
    ftype: FieldType
    name: str = ""

    def eval(self, ctx: EvalContext):
        return ctx.column(self.index)

    def __repr__(self):
        return f"col#{self.index}" + (f"({self.name})" if self.name else "")


@dataclass(eq=False)
class CorrelatedRef(Expression):
    """Reference to an OUTER query's column from inside a subquery (ref:
    expression/column.go CorrelatedColumn). Only a planning-time artifact:
    decorrelation (planner/decorrelate.py) must rewrite every one into a
    join-side ColumnRef before execution."""

    index: int               # column index in the OUTER schema
    ftype: FieldType
    name: str = ""

    def eval(self, ctx: EvalContext):
        raise AssertionError(
            "CorrelatedRef survived planning — decorrelation failed")

    def __repr__(self):
        return f"corr#{self.index}" + (f"({self.name})" if self.name else "")


@dataclass(eq=False)
class Constant(Expression):
    """Literal (ref: expression/constant.go). Value is the *python* value."""

    value: object
    ftype: FieldType

    def eval(self, ctx: EvalContext):
        xp = ctx.xp
        n = ctx.num_rows
        if self.value is None:
            return (xp.zeros(n, dtype=xp.int64 if not ctx.on_device else xp.int64),
                    xp.zeros(n, dtype=bool))
        raw = self.ftype.encode_value(self.value)
        if self.ftype.kind.is_string:
            if ctx.on_device:
                raise AssertionError(
                    "bare string constant on device; must be consumed by a "
                    "prepared comparison/gather node")
            vals = np.full(n, raw, dtype=object)
            return vals, np.ones(n, dtype=bool)
        dt = _xp_dtype(xp, self.ftype, ctx.on_device)
        return xp.full(n, raw, dtype=dt), xp.ones(n, dtype=bool)

    def __repr__(self):
        return f"lit({self.value!r})"


def _xp_dtype(xp, ftype: FieldType, on_device: bool):
    npdt = ftype.np_dtype
    if npdt == np.dtype(object):
        return None
    return npdt     # float64 is the device float dtype too


class ParamExpr(Constant):
    """A Constant whose VALUE rides the prepared-inputs channel instead
    of being baked into the traced program (ref: expression/constant.go
    ParamMarker — the plan-cache parameter placeholder).

    The fragment layer substitutes these for comparison literals so that
    `WHERE k = 17` and `WHERE k = 42` share ONE compiled XLA executable
    (the repr is value-free, so they produce the same chain signature)
    and so the micro-batcher can stack many statements' parameters along
    a leading batch axis of one program. `prepare()` returns the encoded
    scalar — it travels positionally with the dictionary preparations —
    and `eval()` broadcasts the scalar instead of a literal.

    A micro-batch (executor/microbatch.py) stacks the members' values
    into one `[B]` prep: `eval()` then gives a `[B, 1]` value, which
    broadcasts through the comparison and the logical ops above it to a
    `[B, n]` result; the validity stays `[n]`."""

    def prepare(self, dictionaries):
        raw = self.ftype.encode_value(self.value)
        return np.asarray(raw, dtype=self.ftype.np_dtype)

    def eval(self, ctx: EvalContext):
        prep = ctx.prepared.get(id(self))
        if prep is None:
            # host oracle / un-prepared context: behave as the literal
            return Constant.eval(self, ctx)
        xp = ctx.xp
        n = ctx.num_rows
        dt = _xp_dtype(xp, self.ftype, ctx.on_device)
        if getattr(prep, "ndim", 0) == 1:
            return astype(prep, dt).reshape(-1, 1), xp.ones(n, dtype=bool)
        return (xp.full(n, prep, dtype=dt) if dt is not None
                else np.full(n, prep, dtype=object)), \
            xp.ones(n, dtype=bool)

    def __repr__(self):
        # value-free on purpose: parametrized chains of different
        # literals must hash to one compile-cache signature
        return f"param({self.ftype})"


# ---------------------------------------------------------------------------
# Scalar function framework
# ---------------------------------------------------------------------------

_KERNELS: Dict[str, Callable] = {}


def kernel(name):
    def deco(fn):
        _KERNELS[name] = fn
        return fn
    return deco


@dataclass(eq=False)
class ScalarFunc(Expression):
    """One scalar builtin call (ref: expression/scalar_function.go)."""

    op: str
    args: List[Expression]
    ftype: FieldType

    def children(self):
        return self.args

    def rebuild(self, args: List["Expression"]) -> "ScalarFunc":
        """Reconstruct with new args — subclasses carrying extra state
        (e.g. planner/apply.ApplySubquery) override to preserve it, so
        generic expression transformers (fold, shift, remap) don't
        downgrade them to a plain ScalarFunc."""
        return ScalarFunc(self.op, args, self.ftype)

    def eval(self, ctx: EvalContext):
        fn = _KERNELS.get(self.op)
        if fn is None:
            raise TypeError_(f"unsupported scalar function: {self.op}")
        return fn(self, ctx)

    def prepare(self, dictionaries):
        prep = _PREPARE.get(self.op)
        return prep(self, dictionaries) if prep else None

    def __repr__(self):
        if self.op == "cast":
            # the target type is the cast's only operand besides its
            # argument: the program cache and GROUP BY matching key on repr
            return f"cast({self.args[0]!r} AS {self.ftype})"
        return f"{self.op}({', '.join(map(repr, self.args))})"


_PREPARE: Dict[str, Callable] = {}


def preparer(name):
    def deco(fn):
        _PREPARE[name] = fn
        return fn
    return deco


def collect_preparations(exprs: Sequence[Expression], dictionaries):
    """Host-side pass: compute dictionary-dependent traced inputs.

    Returns {node_id: value}; values become extra jit arguments so changing
    dictionaries never re-triggers XLA compilation.
    """
    prepared: Dict[int, object] = {}
    for e in exprs:
        for node in e.walk():
            v = node.prepare(dictionaries)
            if v is not None:
                prepared[id(node)] = v
    return prepared


# ---------------------------------------------------------------------------
# Helpers shared by kernels
# ---------------------------------------------------------------------------


def _rescale(xp, vals, from_scale: int, to_scale: int):
    if to_scale > from_scale:
        return vals * (10 ** (to_scale - from_scale))
    if to_scale < from_scale:
        # dropping digits rounds half away from zero (types/mydecimal.go
        # Round) — CAST(1.005 AS DECIMAL(10,2)) is 1.01, not a
        # reinterpretation of the scaled int as 10.05
        return _half_away_div(xp, vals, 10 ** (from_scale - to_scale))
    return vals


def _numeric_common(func: ScalarFunc, ctx: EvalContext):
    """Evaluate both args, promote to the result's physical domain."""
    a, b = func.args
    av, am = a.eval(ctx)
    bv, bm = b.eval(ctx)
    xp = ctx.xp
    rt = func.ftype
    if rt.kind.is_float or a.ftype.kind.is_float or b.ftype.kind.is_float:
        fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
        av = _to_float(xp, av, a.ftype, fdt)
        bv = _to_float(xp, bv, b.ftype, fdt)
        return av, am, bv, bm, None
    if a.ftype.kind is TypeKind.DECIMAL or b.ftype.kind is TypeKind.DECIMAL:
        # integers participate as scale-0 decimals
        scale = max(a.ftype.scale, b.ftype.scale)
        av = _rescale(xp, av, a.ftype.scale, scale)
        bv = _rescale(xp, bv, b.ftype.scale, scale)
        return av, am, bv, bm, scale
    return av, am, bv, bm, None


def _to_float(xp, vals, ftype: FieldType, fdt):
    vals = astype(vals, fdt)
    if ftype.kind is TypeKind.DECIMAL and ftype.scale:
        vals = vals / (10 ** ftype.scale)
    return vals


# ---------------------------------------------------------------------------
# Arithmetic (ref: expression/builtin_arithmetic_vec.go)
# ---------------------------------------------------------------------------


def _arith(op):
    def fn(func: ScalarFunc, ctx: EvalContext):
        xp = ctx.xp
        if op == "mul" and func.ftype.kind is TypeKind.DECIMAL:
            # decimal × decimal/int: scales ADD, no equalization needed
            a, b = func.args
            av, am = a.eval(ctx)
            bv, bm = b.eval(ctx)
            prod_scale = a.ftype.scale + b.ftype.scale
            out = av * bv
            if prod_scale > func.ftype.scale:
                out = out // (10 ** (prod_scale - func.ftype.scale))
            else:
                out = _rescale(xp, out, prod_scale, func.ftype.scale)
            return out, am & bm
        av, am, bv, bm, scale = _numeric_common(func, ctx)
        valid = am & bm
        if op == "plus":
            out = av + bv
        elif op == "minus":
            out = av - bv
        elif op == "mul":
            out = av * bv
        elif op == "div":
            # SQL '/' → DOUBLE (planner types decimal div as double for device)
            fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
            if scale is not None:
                # decimal path: scaled ints at common scale — descale once
                av = astype(av, fdt) / (10 ** scale)
                bv = astype(bv, fdt) / (10 ** scale)
            else:
                # float path already converted by _numeric_common; int path
                # is raw int64 — astype is correct for both
                av = astype(av, fdt)
                bv = astype(bv, fdt)
            zero = bv == 0
            valid = valid & ~zero
            out = av / xp.where(zero, xp.ones_like(bv), bv)
        elif op == "intdiv":
            zero = bv == 0
            valid = valid & ~zero
            out = _floor_div_trunc(xp, av, xp.where(zero, xp.ones_like(bv), bv))
        elif op == "mod":
            zero = bv == 0
            valid = valid & ~zero
            safe_b = xp.where(zero, xp.ones_like(bv), bv)
            if func.ftype.kind.is_float:
                out = xp.where(valid, av - _trunc(xp, av / safe_b) * safe_b, 0.0)
            else:
                out = av - _floor_div_trunc(xp, av, safe_b) * safe_b
        else:
            raise AssertionError(op)
        return out, valid
    return fn


def _trunc(xp, x):
    return xp.trunc(x)


def _floor_div_trunc(xp, a, b):
    """MySQL DIV truncates toward zero (Go integer division semantics)."""
    q = xp.abs(a) // xp.abs(b)
    return astype(xp.where((a < 0) != (b < 0), -q, q), a.dtype)


for _op in ("plus", "minus", "mul", "div", "intdiv", "mod"):
    kernel(_op)(_arith(_op))


@kernel("unary_minus")
def _unary_minus(func, ctx):
    v, m = func.args[0].eval(ctx)
    return -v, m


# ---------------------------------------------------------------------------
# Comparison (ref: expression/builtin_compare_vec.go)
# ---------------------------------------------------------------------------

_CMP_NUMPY = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
}


def _is_string_cmp(func: ScalarFunc) -> bool:
    return any(a.ftype.kind.is_string for a in func.args)


def _cmp(op):
    def fn(func: ScalarFunc, ctx: EvalContext):
        xp = ctx.xp
        a, b = func.args
        if ctx.on_device and _is_string_cmp(func):
            return _cmp_string_device(op, func, ctx)
        if a.ftype.kind.is_string and not ctx.on_device:
            av, am = a.eval(ctx)
            bv, bm = b.eval(ctx)
            if a.ftype.is_ci or b.ftype.is_ci:
                from tidb_tpu_torch.types import fold_ci_array
                av = fold_ci_array(np.asarray(av, dtype=object))
                bv = fold_ci_array(np.asarray(bv, dtype=object))
            res = np.asarray(_CMP_NUMPY[op](av, bv), dtype=bool)
            return res, am & bm
        av, am, bv, bm, _ = _numeric_common(func, ctx)
        res = _CMP_NUMPY[op](av, bv)
        return astype(res, bool), am & bm
    return fn


def _cmp_string_device(op, func: ScalarFunc, ctx: EvalContext):
    """String vs constant on device: integer rank comparison on codes, one
    elementwise launch (`present`, a host bool, folds eq and ne on the
    host)."""
    xp = ctx.xp
    prep = ctx.prepared.get(id(func))
    assert prep is not None, "string comparison missing host preparation"
    col = next(a for a in func.args if isinstance(a, ColumnRef))
    flipped = not isinstance(func.args[0], ColumnRef)
    codes, valid = col.eval(ctx)
    left_rank, right_rank, present = prep
    o = op
    if flipped:  # const OP col  ≡  col flip(OP) const
        o = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    if o in ("eq", "ne") and not present:
        res = xp.full(codes.shape, o == "ne", dtype=bool)
    elif o == "eq":
        res = codes == left_rank
    elif o == "ne":
        res = codes != left_rank
    elif o == "lt":
        res = codes < left_rank
    elif o == "le":
        res = codes < right_rank
    elif o == "gt":
        res = codes >= right_rank
    else:  # ge
        res = codes >= left_rank
    return res, valid


def _prepare_string_cmp(func: ScalarFunc, dictionaries):
    col = next((a for a in func.args if isinstance(a, ColumnRef)), None)
    const = next((a for a in func.args if isinstance(a, Constant)), None)
    if col is None or const is None or const.value is None:
        return None
    d = dictionaries[col.index]
    if d is None:
        return None
    s = str(const.value)
    if col.ftype.is_ci:
        # ci dictionaries hold representatives SORTED BY their fold
        # (chunk/device.encode_strings); compare in fold space
        from tidb_tpu_torch.types import fold_ci_array
        d = fold_ci_array(np.asarray(d, dtype=object))
        s = s.upper()
    left = int(np.searchsorted(d, s, side="left"))
    right = int(np.searchsorted(d, s, side="right"))
    present = left < right
    return (np.int32(left), np.int32(right), np.bool_(present))


for _op in _CMP_NUMPY:
    kernel(_op)(_cmp(_op))
    preparer(_op)(_prepare_string_cmp)


@kernel("nulleq")  # <=> NULL-safe equal
def _nulleq(func, ctx):
    xp = ctx.xp
    av, am, bv, bm, _ = _numeric_common(func, ctx)
    eq = (av == bv) & am & bm
    both_null = ~am & ~bm
    return (eq | both_null), xp.ones_like(am)


# ---------------------------------------------------------------------------
# Logic — Kleene three-valued (ref: builtin_op_vec.go)
# ---------------------------------------------------------------------------


@kernel("and")
def _and(func, ctx):
    av, am = _as_bool(func.args[0], ctx)
    bv, bm = _as_bool(func.args[1], ctx)
    val = av & bv
    # false dominates NULL
    valid = (am & bm) | (am & ~av) | (bm & ~bv)
    return val & valid, valid


@kernel("or")
def _or(func, ctx):
    av, am = _as_bool(func.args[0], ctx)
    bv, bm = _as_bool(func.args[1], ctx)
    val = (av & am) | (bv & bm)
    valid = (am & bm) | (am & av) | (bm & bv)
    return val, valid


@kernel("xor")
def _xor(func, ctx):
    av, am = _as_bool(func.args[0], ctx)
    bv, bm = _as_bool(func.args[1], ctx)
    return av ^ bv, am & bm


@kernel("not")
def _not(func, ctx):
    av, am = _as_bool(func.args[0], ctx)
    return (~av) & am, am


def _as_bool(expr: Expression, ctx: EvalContext):
    v, m = expr.eval(ctx)
    if v.dtype == bool:
        return v, m
    return (v != 0), m


@kernel("isnull")
def _isnull(func, ctx):
    xp = ctx.xp
    _, m = func.args[0].eval(ctx)
    return ~m, xp.ones_like(m)


# ---------------------------------------------------------------------------
# Control (ref: builtin_control_vec.go)
# ---------------------------------------------------------------------------


@kernel("if")
def _if(func, ctx):
    xp = ctx.xp
    cv, cm = _as_bool(func.args[0], ctx)
    tv, tm = _coerced(func.args[1], func.ftype, ctx)
    ev, em = _coerced(func.args[2], func.ftype, ctx)
    cond = cv & cm  # NULL condition → else branch (MySQL IF)
    return xp.where(cond, tv, ev), xp.where(cond, tm, em)


@kernel("ifnull")
def _ifnull(func, ctx):
    xp = ctx.xp
    av, am = _coerced(func.args[0], func.ftype, ctx)
    bv, bm = _coerced(func.args[1], func.ftype, ctx)
    return xp.where(am, av, bv), am | bm


@kernel("coalesce")
def _coalesce(func, ctx):
    xp = ctx.xp
    out_v, out_m = _coerced(func.args[0], func.ftype, ctx)
    for a in func.args[1:]:
        av, am = _coerced(a, func.ftype, ctx)
        take = ~out_m & am
        out_v = xp.where(take, av, out_v)
        out_m = out_m | am
    return out_v, out_m


@kernel("case")
def _case(func, ctx):
    """case(when1, then1, when2, then2, ..., [else]) — pre-desugared."""
    xp = ctx.xp
    n = len(func.args)
    has_else = n % 2 == 1
    pairs = (n - 1) // 2 if has_else else n // 2
    if has_else:
        out_v, out_m = _coerced(func.args[-1], func.ftype, ctx)
    else:
        zv, _ = _coerced(func.args[1], func.ftype, ctx)
        out_v, out_m = xp.zeros_like(zv), xp.zeros(zv.shape[0], dtype=bool)
    decided = xp.zeros(ctx.num_rows, dtype=bool)
    for i in range(pairs):
        wv, wm = _as_bool(func.args[2 * i], ctx)
        tv, tm = _coerced(func.args[2 * i + 1], func.ftype, ctx)
        hit = wv & wm & ~decided
        out_v = xp.where(hit, tv, out_v)
        out_m = xp.where(hit, tm, out_m)
        decided = decided | (wv & wm)
    return out_v, out_m


def _coerced(expr: Expression, target: FieldType, ctx: EvalContext):
    """Evaluate expr and cast its physical values into target's domain."""
    v, m = expr.eval(ctx)
    ft = expr.ftype
    xp = ctx.xp
    if ft.kind == target.kind and ft.scale == target.scale:
        return v, m
    if target.kind is TypeKind.DECIMAL:
        if ft.kind is TypeKind.DECIMAL:
            return _rescale(xp, v, ft.scale, target.scale), m
        if ft.kind.is_integer:
            return v * (10 ** target.scale), m
        if ft.kind.is_float:
            return _round_half_away(xp, v * (10 ** target.scale)), m
    if target.kind.is_float:
        fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
        return _to_float(xp, v, ft, fdt), m
    if target.kind.is_integer and ft.kind.is_integer:
        return v, m
    if target.kind.is_integer:
        return _round_half_away(xp, _to_float(
            xp, v, ft, np.float64 if not ctx.on_device else v.dtype)), m
    if target.kind.is_string or ft.kind.is_string:
        return v, m  # same dictionary domain or host objects
    if ft.kind is TypeKind.DATE and target.kind in _DATETIME_KINDS:
        return astype(v, xp.int64) * 86_400_000_000, m
    if ft.kind in _DATETIME_KINDS and target.kind is TypeKind.DATE:
        return astype(_floor_div_neg(xp, astype(v, xp.int64),
                                     86_400_000_000), xp.int32), m
    return v, m


_DATETIME_KINDS = (TypeKind.DATETIME, TypeKind.TIMESTAMP)


def _round_half_away(xp, x):
    return astype(xp.where(x >= 0, xp.floor(x + 0.5), xp.ceil(x - 0.5)), xp.int64)


@kernel("cast")
def _cast(func, ctx):
    return _coerced(func.args[0], func.ftype, ctx)


# ---------------------------------------------------------------------------
# Math (ref: builtin_math_vec.go)
# ---------------------------------------------------------------------------


@kernel("abs")
def _abs(func, ctx):
    v, m = func.args[0].eval(ctx)
    return ctx.xp.abs(v), m


@kernel("ceil")
def _ceil(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind is TypeKind.DECIMAL:
        mul = 10 ** ft.scale
        return _floor_div_neg(xp, v + mul - 1, mul), m
    if ft.kind.is_integer:
        return v, m
    return astype(xp.ceil(v), xp.int64), m


@kernel("floor")
def _floor(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind is TypeKind.DECIMAL:
        return _floor_div_neg(xp, v, 10 ** ft.scale), m
    if ft.kind.is_integer:
        return v, m
    return astype(xp.floor(v), xp.int64), m


def _floor_div_neg(xp, a, b):
    return a // b  # python/numpy floor-div already floors toward -inf


def _half_away_div(xp, v, mul):
    """Exact half-away-from-zero division of scaled ints by `mul` (the
    MySQL decimal rounding rule, types/mydecimal.go Round)."""
    half = mul // 2
    return xp.where(v >= 0, (v + half) // mul, -((-v + half) // mul))


@kernel("round")
def _round(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    d = _const_int(func.args[1]) if len(func.args) == 2 else None
    if ft.kind is TypeKind.DECIMAL:
        if len(func.args) == 1:
            return _half_away_div(xp, v, 10 ** ft.scale), m
        if d is not None:
            # ROUND(dec, const d): exact scaled-int arithmetic. t is the
            # kept digit position (may be negative); the result scale is
            # max(t, 0) — infer_type computed the same, so func.ftype
            # agrees with the value by construction.
            t = min(int(d), ft.scale)
            if t >= ft.scale:
                return v, m
            q = _half_away_div(xp, v, 10 ** (ft.scale - t))
            if t < 0:
                q = q * (10 ** (-t))
            return q, m
        # non-constant d: per-row, same clamp discipline as TRUNCATE
        dv, dm = func.args[1].eval(ctx)
        m = m & dm
        s = ft.scale
        dcl = xp.clip(astype(dv, xp.int64), -18, s)
        e = xp.clip(s - dcl, 0, 18)
        p = (10 ** e) if ctx.on_device else \
            astype(xp.asarray(10 ** e), xp.int64)
        # result keeps the input scale (infer_type): round at d digits,
        # then scale back up
        return _half_away_div(xp, v, p) * p, m
    if ft.kind.is_integer:
        if len(func.args) == 1:
            return v, m
        if d is not None:
            if int(d) >= 0:
                return v, m
            mul = 10 ** min(-int(d), 18)
            return _half_away_div(xp, v, mul) * mul, m
        dv, dm = func.args[1].eval(ctx)
        m = m & dm
        e = xp.clip(-astype(dv, xp.int64), 0, 18)
        p = (10 ** e) if ctx.on_device else \
            astype(xp.asarray(10 ** e), xp.int64)
        return _half_away_div(xp, v, p) * p, m
    if len(func.args) == 2:
        # ROUND(double, d) stays double (MySQL): half-away at d decimals
        fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
        x = _to_float(xp, v, ft, fdt)
        if d is not None:
            p = float(10.0 ** int(d))
            dm = None
        else:
            dv, dm = func.args[1].eval(ctx)
            p = xp.power(xp.asarray(10.0, dtype=fdt), astype(dv, fdt))
        q = xp.where(x >= 0, xp.floor(x * p + 0.5),
                     xp.ceil(x * p - 0.5)) / p
        return q, (m if dm is None else m & dm)
    return _round_half_away(xp, v), m


def _const_int(e) -> "Optional[int]":
    """Constant integer-ish expression value, else None."""
    if isinstance(e, Constant) and e.value is not None \
            and not isinstance(e.value, str):
        try:
            return int(e.value)
        except (TypeError, ValueError):
            return None
    return None


@kernel("sqrt")
def _sqrt(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
    fv = _to_float(xp, v, func.args[0].ftype, fdt)
    neg = fv < 0
    return xp.sqrt(xp.where(neg, 0.0, fv)), m & ~neg


@kernel("pow")
def _pow(func, ctx):
    xp = ctx.xp
    av, am, bv, bm, _ = _numeric_common(func, ctx)
    fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
    return xp.power(astype(av, fdt), astype(bv, fdt)), am & bm


# ---------------------------------------------------------------------------
# String functions — dictionary pushdown (host evaluates over the dictionary,
# device gathers by code). Ref: builtin_string_vec.go, builtin_like.go.
# ---------------------------------------------------------------------------


def _host_string_fn(name):
    return _HOST_STRING_FNS[name]


def _soundex(s: str) -> str:
    """MySQL SOUNDEX (builtin_string.go soundex): standard 4+ char code."""
    codes = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4",
             **{c: "5" for c in "MN"}, "R": "6"}
    s = "".join(c for c in s.upper() if c.isalpha())
    if not s:
        return ""
    out = s[0]
    prev = codes.get(s[0], "")
    for c in s[1:]:
        d = codes.get(c, "")
        if d and d != prev:
            out += d
        if c not in "HW":
            prev = d
    return (out + "000")[:4] if len(out) < 4 else out


_HOST_STRING_FNS = {
    "length": lambda s: len(s.encode("utf-8")),
    "char_length": len,
    "upper": str.upper,
    "lower": str.lower,
    "reverse": lambda s: s[::-1],
    "ltrim": str.lstrip,
    "rtrim": str.rstrip,
    "trim": str.strip,
    "ascii": lambda s: ord(s[0]) if s else 0,
    "hex": lambda s: s.encode("utf-8").hex().upper(),
    "bit_length": lambda s: len(s.encode("utf-8")) * 8,
    "ord": lambda s: ord(s[0]) if s else 0,   # BMP = MySQL for utf8 lead
    "quote": lambda s: "'" + s.replace("\\", "\\\\")
                       .replace("'", "\\'") + "'",
    "to_base64": lambda s: __import__("base64")
                 .b64encode(s.encode("utf-8")).decode("ascii"),
    "from_base64": lambda s: __import__("base64")
                   .b64decode(s.encode("ascii"), validate=False)
                   .decode("utf-8", "replace"),
    "soundex": _soundex,
}

_STRING_INT_RESULT = {"length", "char_length", "ascii", "bit_length",
                      "ord"}


def _make_string_fn_kernel(name):
    host = _HOST_STRING_FNS[name]

    def fn(func: ScalarFunc, ctx: EvalContext):
        v, m = func.args[0].eval(ctx)
        if not ctx.on_device:
            out = np.array([host(str(x)) for x in v],
                           dtype=np.int64 if name in _STRING_INT_RESULT
                           else object)
            return out, m
        table = ctx.prepared.get(id(func))
        assert table is not None, f"{name}: missing dictionary preparation"
        return dict_lut(table, v), m

    def prep(func: ScalarFunc, dictionaries):
        col = func.args[0]
        if not isinstance(col, ColumnRef):
            return None
        d = dictionaries[col.index]
        if d is None:
            return None
        if name in _STRING_INT_RESULT:
            return np.array([host(str(s)) for s in d], dtype=np.int64)
        # string→string over dictionary: result values are NEW codes into a
        # derived dictionary; executor retrieves it via derived_dictionary()
        out = np.array([host(str(s)) for s in d], dtype=object)
        newdict, codes = np.unique(out, return_inverse=True)
        func._derived_dict = newdict  # noqa: SLF001 — consumed by executor
        return astype(codes, np.int32)

    kernel(name)(fn)
    preparer(name)(prep)


for _n in _HOST_STRING_FNS:
    _make_string_fn_kernel(_n)


# -- multi-arg string builtins ------------------------------------------
# host path evaluates row-wise; the device path precomputes a dictionary
# lookup table when the single string column's co-arguments are constants
# (same trick as the unary functions above).


def _mysql_substr(s: str, pos: int, ln=None) -> str:
    if pos == 0:
        return ""
    start = pos - 1 if pos > 0 else len(s) + pos
    if start < 0:
        return ""
    end = len(s) if ln is None else start + max(int(ln), 0)
    return s[start:end]


def _mysql_locate(sub: str, s: str, pos: int = 1) -> int:
    if pos < 1:
        return 0
    return s.find(sub, pos - 1) + 1


_STRING_FNS_EXTRA = {
    # name: (host_fn(str, *co_args), string-col arg index, result kind)
    "substr": (lambda s, pos, ln=None: _mysql_substr(s, int(pos), ln),
               0, "str"),
    "left": (lambda s, n: s[:max(int(n), 0)], 0, "str"),
    "right": (lambda s, n: s[-int(n):] if int(n) > 0 else "", 0, "str"),
    "repeat": (lambda s, n: s * max(int(n), 0), 0, "str"),
    "replace": (lambda s, a, b: s.replace(str(a), str(b)), 0, "str"),
    "lpad": (lambda s, n, p: "" if int(n) < 0 else
             (s[:int(n)] if len(s) >= int(n) else
              ((str(p) * int(n))[:int(n) - len(s)] + s if p else s)),
             0, "str"),
    "rpad": (lambda s, n, p: "" if int(n) < 0 else
             (s[:int(n)] if len(s) >= int(n) else
              (s + (str(p) * int(n))[:int(n) - len(s)] if p else s)),
             0, "str"),
    "instr": (lambda s, sub: s.find(str(sub)) + 1, 0, "int"),
    "locate": (lambda s, sub, pos=1: _mysql_locate(str(sub), s, int(pos)),
               1, "int"),
    "substring_index": (
        lambda s, delim, cnt:
            str(delim).join(s.split(str(delim))[:int(cnt)])
            if int(cnt) > 0 else
            (str(delim).join(s.split(str(delim))[int(cnt):])
             if int(cnt) < 0 else ""),
        0, "str"),
    "insert": (lambda s, pos, ln, news:
               s if int(pos) < 1 or int(pos) > len(s) else
               s[:int(pos) - 1] + str(news) +
               (s[int(pos) - 1 + int(ln):] if int(ln) >= 0 else ""),
               0, "str"),
    "field": (lambda s, *items: next(
        (i + 1 for i, it in enumerate(items) if str(it) == s), 0),
        0, "int"),
    # col is the SET string (arg 1); the needle arrives as the co-arg
    "find_in_set": (
        lambda setstr, needle: (setstr.split(",").index(str(needle)) + 1
                                if str(needle) in setstr.split(",")
                                else 0), 1, "int"),
}


def _make_string_extra_kernel(name):
    host, col_idx, rkind = _STRING_FNS_EXTRA[name]

    def k(func: ScalarFunc, ctx: EvalContext):
        if ctx.on_device:
            # the prepared LUT folds constant co-args; only the string
            # column's codes are evaluated (string constants cannot trace)
            table = ctx.prepared.get(id(func))
            if table is None:
                raise TypeError_(f"{name}: device path needs constant "
                                 f"co-arguments")
            codes, m = func.args[col_idx].eval(ctx)
            return dict_lut(table, codes), m
        evals = [a.eval(ctx) for a in func.args]
        m = evals[0][1]
        for _, am in evals[1:]:
            m = m & am
        n = ctx.num_rows
        out = []
        for i in range(n):
            row = [np.asarray(v)[i] if np.ndim(v) else v
                   for v, _ in evals]
            s = str(row[col_idx])
            co = [row[j] for j in range(len(row)) if j != col_idx]
            out.append(host(s, *co))
        dtype = np.int64 if rkind == "int" else object
        return np.array(out, dtype=dtype), m

    def prep(func: ScalarFunc, dictionaries):
        col = func.args[col_idx]
        if not isinstance(col, ColumnRef):
            return None
        co = [a for j, a in enumerate(func.args) if j != col_idx]
        if not all(isinstance(a, Constant) and a.value is not None
                   for a in co):
            return None
        d = dictionaries[col.index] if col.index < len(dictionaries) \
            else None
        if d is None:
            return None
        co_vals = [a.ftype.encode_value(a.value) for a in co]
        out = [host(str(s), *co_vals) for s in d]
        if rkind == "int":
            return np.array(out, dtype=np.int64)
        newdict, codes = np.unique(np.array(out, dtype=object),
                                   return_inverse=True)
        func._derived_dict = newdict  # noqa: SLF001
        return astype(codes, np.int32)

    kernel(name)(k)
    preparer(name)(prep)


for _n in _STRING_FNS_EXTRA:
    _make_string_extra_kernel(_n)


@kernel("concat")
def _concat(func, ctx):
    """CONCAT(a, b, …): NULL if any arg NULL. Host-only for multi-column
    inputs; single string column + constants goes through the dictionary
    preparation (prepared table of result codes)."""
    if ctx.on_device:
        table = ctx.prepared.get(id(func))
        if table is None:
            raise TypeError_("concat: device path needs a prepared table")
        col_idx = next(i for i, a in enumerate(func.args)
                       if isinstance(a, ColumnRef) and
                       a.ftype.kind.is_string)
        codes, m = func.args[col_idx].eval(ctx)
        return dict_lut(table, codes), m
    evals = [a.eval(ctx) for a in func.args]
    m = evals[0][1]
    for _, am in evals[1:]:
        m = m & am
    n = ctx.num_rows
    out = []
    for i in range(n):
        parts = []
        for (v, _), a in zip(evals, func.args):
            x = np.asarray(v)[i] if np.ndim(v) else v
            parts.append(_concat_str(x, a.ftype))
        out.append("".join(parts))
    return np.array(out, dtype=object), m


def _concat_str(x, ft: FieldType) -> str:
    if ft.kind.is_string:
        return str(x)
    v = ft.decode_value(x)
    return str(v)


@preparer("concat")
def _prepare_concat(func: ScalarFunc, dictionaries):
    scols = [(i, a) for i, a in enumerate(func.args)
             if isinstance(a, ColumnRef) and a.ftype.kind.is_string]
    others = [a for i, a in enumerate(func.args)
              if not (isinstance(a, ColumnRef) and a.ftype.kind.is_string)]
    if len(scols) != 1 or not all(isinstance(a, Constant) for a in others):
        return None
    ci, col = scols[0]
    d = dictionaries[col.index] if col.index < len(dictionaries) else None
    if d is None:
        return None
    out = []
    for s in d:
        parts = []
        for i, a in enumerate(func.args):
            if i == ci:
                parts.append(str(s))
            else:
                parts.append(_concat_str(a.ftype.encode_value(a.value),
                                         a.ftype))
        out.append("".join(parts))
    newdict, codes = np.unique(np.array(out, dtype=object),
                               return_inverse=True)
    func._derived_dict = newdict  # noqa: SLF001
    return astype(codes, np.int32)


@kernel("strcmp")
def _strcmp(func, ctx):
    xp = ctx.xp
    a, am = func.args[0].eval(ctx)
    b, bm = func.args[1].eval(ctx)
    m = am & bm
    if ctx.on_device:
        raise TypeError_("strcmp: host-only")
    # MySQL coerces both sides to strings (STRCMP(3, '3') = 0)
    sa = np.array([_concat_str(x, func.args[0].ftype)
                   for x in np.asarray(a)], dtype=object)
    sb = np.array([_concat_str(x, func.args[1].ftype)
                   for x in np.asarray(b)], dtype=object)
    out = astype(np.where(sa < sb, -1, np.where(sa > sb, 1, 0)), np.int64)
    return out, m


@kernel("space")
def _space(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if ctx.on_device:
        raise TypeError_("space: host-only")
    return np.array([" " * max(int(x), 0) for x in np.asarray(v)],
                    dtype=object), m


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


@kernel("like")
def _like(func, ctx):
    v, m = func.args[0].eval(ctx)
    pat = func.args[1]
    assert isinstance(pat, Constant), "LIKE pattern must be a constant"
    # ci collations match case-insensitively; the device ci dictionary
    # keeps one arbitrary-case representative per fold class, so
    # IGNORECASE is also what keeps host/device answers identical
    ci = re.IGNORECASE if getattr(func.args[0].ftype, "is_ci", False) else 0
    if not ctx.on_device:
        rx = re.compile(_like_to_regex(str(pat.value)), re.DOTALL | ci)
        out = np.fromiter((rx.match(str(x)) is not None for x in v),
                          dtype=bool, count=len(v))
        return out, m
    table = ctx.prepared.get(id(func))
    assert table is not None, "LIKE: missing dictionary preparation"
    return dict_lut(table, v), m


@preparer("like")
def _prepare_like(func: ScalarFunc, dictionaries):
    col = func.args[0]
    if not isinstance(col, ColumnRef):
        return None
    d = dictionaries[col.index]
    if d is None:
        return None
    ci = re.IGNORECASE if getattr(col.ftype, "is_ci", False) else 0
    rx = re.compile(_like_to_regex(str(func.args[1].value)), re.DOTALL | ci)
    return np.fromiter((rx.match(str(s)) is not None for s in d),
                       dtype=bool, count=len(d))


@kernel("regexp_like")
def _regexp_like(func, ctx):
    """REGEXP / RLIKE (ref: builtin_regexp.go; re2 → python re). Device
    path = prepared per-dictionary-entry boolean LUT, like LIKE."""
    v, m = func.args[0].eval(ctx)
    pat = func.args[1]
    if ctx.on_device:
        table = ctx.prepared.get(id(func))
        assert table is not None, "REGEXP: missing dictionary preparation"
        return dict_lut(table, v), m
    pv, pm = pat.eval(ctx)
    # ci collations match case-insensitively (util/collate semantics) —
    # and the device's ci dictionary keeps ONE arbitrary-case
    # representative per fold class, so IGNORECASE is also what keeps
    # host and device answers identical
    flags = re.IGNORECASE if func.args[0].ftype.is_ci else 0
    cache = {}
    out = np.zeros(len(v), dtype=bool)
    for i in range(len(v)):
        p_s = str(np.asarray(pv)[i] if np.ndim(pv) else pv)
        rx = cache.get(p_s)
        if rx is None:
            rx = cache[p_s] = re.compile(p_s, flags)
        out[i] = rx.search(str(v[i])) is not None
    return out, m & np.asarray(pm, dtype=bool)


@preparer("regexp_like")
def _prepare_regexp(func: ScalarFunc, dictionaries):
    col = func.args[0]
    if not isinstance(col, ColumnRef) or \
            not isinstance(func.args[1], Constant) or \
            func.args[1].value is None:
        return None
    d = dictionaries[col.index]
    if d is None:
        return None
    flags = re.IGNORECASE if col.ftype.is_ci else 0
    rx = re.compile(str(func.args[1].value), flags)
    return np.fromiter((rx.search(str(x)) is not None for x in d),
                       dtype=bool, count=len(d))


@kernel("weekofyear")
def _weekofyear(func, ctx):
    ft = func.args[0].ftype

    def one(raw):
        import datetime as _dt
        days = int(raw) // 86_400_000_000 \
            if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP) \
            else int(raw)
        d = _dt.date(1970, 1, 1) + _dt.timedelta(days=days)
        return d.isocalendar()[1]
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("maketime")
def _maketime(func, ctx):
    def one(h, mi, sec):
        if not (0 <= int(mi) < 60 and 0 <= float(sec) < 60):
            return None
        sign = -1 if int(h) < 0 else 1
        return sign * ((abs(int(h)) * 3600 + int(mi) * 60) * 1_000_000
                       + int(round(float(sec) * 1_000_000)))
    return _host_rows(func, ctx, one, dtype=np.int64)


def _addtime_kernel(sign):
    def k(func, ctx):
        xp = ctx.xp
        av, am = func.args[0].eval(ctx)
        bv, bm = func.args[1].eval(ctx)
        if func.args[0].ftype.kind is TypeKind.DATE:
            av = astype(av, xp.int64) * 86_400_000_000   # → DATETIME µs
        return av + sign * astype(bv, xp.int64), am & bm
    return k


kernel("addtime")(_addtime_kernel(1))
kernel("subtime")(_addtime_kernel(-1))


def _period_months(p: int) -> int:
    """YYMM/YYYYMM → absolute months with MySQL's 2-digit-year rule
    (00-69 → 2000s, 70-99 → 1900s; types/time.go adjustedYear)."""
    y, mo = divmod(int(p), 100)
    if y < 70:
        y += 2000 if y or mo else 0       # period 0 stays 0
    elif y < 100:
        y += 1900
    return y * 12 + (mo - 1)


@kernel("period_add")
def _period_add(func, ctx):
    def one(p, n):
        total = _period_months(p) + int(n)
        return (total // 12) * 100 + total % 12 + 1
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("period_diff")
def _period_diff(func, ctx):
    def one(a, b):
        return _period_months(a) - _period_months(b)
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("make_set")
def _make_set(func, ctx):
    """MySQL MAKE_SET: NULL ITEMS are skipped (not propagated); only a
    NULL bits argument makes the result NULL — hand-rolled masking
    instead of _host_rows' any-NULL-skips-the-row rule."""
    evals = [a.eval(ctx) for a in func.args]
    n = ctx.num_rows
    bits_v, bits_m = evals[0]
    bits_m = np.asarray(bits_m, dtype=bool)
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not bits_m[i]:
            out[i] = ""
            continue
        b = int(np.asarray(bits_v)[i])
        parts = []
        for k, (iv, im) in enumerate(evals[1:]):
            if b & (1 << k) and np.asarray(im, dtype=bool)[i]:
                parts.append(str(np.asarray(iv)[i] if np.ndim(iv)
                                 else iv))
        out[i] = ",".join(parts)
    return out, bits_m


@kernel("export_set")
def _export_set(func, ctx):
    def one(bits, on, off, sep=",", n=64):
        return str(sep).join(str(on) if int(bits) & (1 << i) else str(off)
                             for i in range(int(n)))
    return _host_rows(func, ctx, one)


@kernel("in")
def _in(func, ctx):
    """col IN (c1, c2, ...) — constants only on device (planner guarantees)."""
    xp = ctx.xp
    arg = func.args[0]
    v, m = arg.eval(ctx)
    if ctx.on_device and arg.ftype.kind.is_string:
        # one K21 gather of the prepared bool table over the dictionary:
        # a code outside it (and any code of an empty one) is not listed
        from tidb_tpu_torch.ops.dict_lut import dict_lut
        table = ctx.prepared.get(id(func))
        assert table is not None
        return dict_lut(table, v, "fill", fill=0), m
    # fast path: integer probe + constant items → ONE sorted-table binary
    # search instead of per-item compares (IN-subqueries expand to
    # thousands of constants). Non-integral items can never equal an
    # integer value (MySQL numeric compare), so they drop out exactly.
    items = func.args[1:]
    if arg.ftype.kind.is_integer and all(isinstance(c, Constant)
                                         for c in items):
        import decimal as _dec
        ints = set()
        for c in items:
            cv = c.value
            if cv is None:
                continue
            if isinstance(cv, bool):
                cv = int(cv)
            if isinstance(cv, (int, np.integer)):
                cv = int(cv)
            elif isinstance(cv, (float, _dec.Decimal)) and cv == int(cv):
                cv = int(cv)
            else:
                continue
            if -(1 << 63) <= cv < (1 << 63):   # out-of-range never matches
                ints.add(cv)
        table = xp.asarray(np.array(sorted(ints), dtype=np.int64))
        if len(ints) == 0:
            return xp.zeros(v.shape[0], dtype=bool), m
        if ctx.on_device:
            pos = xp.clip(xp.searchsorted(table, v, method='sort'),
                          0, len(ints) - 1)
        else:
            pos = xp.clip(xp.searchsorted(table, v), 0, len(ints) - 1)
        hit = xp.take(table, pos) == v
        return hit, m
    # general path: each membership test goes through the eq kernel so
    # mixed-type items coerce like `col = item` would (a DECIMAL 5.5 must
    # NOT compare its scaled encoding 55 against raw BIGINT values); the
    # probe expression evaluates ONCE and rides as a precomputed leaf
    hit = None
    eqfn = _KERNELS["eq"]
    pre = _Precomputed(v, m, arg.ftype)
    for cexpr in items:
        h, hm = eqfn(ScalarFunc("eq", [pre, cexpr], T.bigint(False)), ctx)
        h = h & hm
        hit = h if hit is None else (hit | h)
    return np.asarray(hit, dtype=bool) if not ctx.on_device else hit, m


class _Precomputed(Expression):
    """Leaf wrapping already-evaluated (values, validity) arrays so a
    kernel can reuse another kernel without re-evaluating subtrees."""

    def __init__(self, v, m, ftype):
        self._v = v
        self._m = m
        self.ftype = ftype

    def eval(self, ctx: EvalContext):
        return self._v, self._m


@preparer("in")
def _prepare_in(func: ScalarFunc, dictionaries):
    col = func.args[0]
    if not isinstance(col, ColumnRef) or not col.ftype.kind.is_string:
        return None
    d = dictionaries[col.index]
    if d is None:
        return None
    if col.ftype.is_ci:
        from tidb_tpu_torch.types import fold_ci_array
        d = fold_ci_array(np.asarray(d, dtype=object))
    table = np.zeros(len(d), dtype=bool)
    for cexpr in func.args[1:]:
        s = str(cexpr.value)
        if col.ftype.is_ci:
            s = s.upper()
        left = int(np.searchsorted(d, s, side="left"))
        if left < len(d) and d[left] == s:
            table[left] = True
    return table


# ---------------------------------------------------------------------------
# Temporal (ref: builtin_time_vec.go) — physical encodings are plain ints
# ---------------------------------------------------------------------------


@kernel("year")
def _year(func, ctx):
    return _date_part(func, ctx, part="year")


@kernel("month")
def _month(func, ctx):
    return _date_part(func, ctx, part="month")


@kernel("dayofmonth")
def _dayofmonth(func, ctx):
    return _date_part(func, ctx, part="day")


def _date_part(func, ctx, part):
    """Civil-date decomposition from days-since-epoch (Howard Hinnant algo —
    pure integer ops; torch tensors go through ops.calendar, K20 on the
    card)."""
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, ft, part), m
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        days = _floor_div_neg(xp, v, 86_400_000_000)
    else:
        days = v
    days = astype(days, xp.int64)
    z = days + 719468
    era = _floor_div_neg(xp, z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    mth = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(mp >= 10, y + 1, y)
    out = {"year": y, "month": mth, "day": d}[part]
    return astype(out, xp.int64), m


@kernel("date")
def _date_fn(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return astype(_floor_div_neg(xp, v, 86_400_000_000), xp.int32), m
    return v, m


# ---------------------------------------------------------------------------
# Round-4 breadth builtins (ref: builtin_string.go / builtin_math.go /
# builtin_time.go / builtin_info.go / builtin_miscellaneous.go) — host
# kernels; HOST_ONLY_OPS keeps them off device fragments
# ---------------------------------------------------------------------------


def _host_rows(func, ctx, fn, dtype=object):
    """Row-loop helper: evaluate args, apply fn(row_values) per row.
    Any-NULL input rows skip fn; fn returning None yields SQL NULL —
    both come back masked out with a dtype-safe filler in the values."""
    evals = [a.eval(ctx) for a in func.args]
    n = ctx.num_rows
    m = np.ones(n, dtype=bool)
    for _, am in evals:
        m = m & np.asarray(am, dtype=bool)
    out = []
    for i in range(n):
        row = [np.asarray(v)[i] if np.ndim(v) else v for v, _ in evals]
        out.append(fn(*row) if m[i] else None)
    nulls = np.array([v is None for v in out], dtype=bool)
    fill = "" if dtype == object else 0
    vals = np.array([fill if v is None else v for v in out], dtype=dtype)
    return vals, m & ~nulls


@kernel("atan2")
def _atan2(func, ctx):
    xp = ctx.xp
    av, am = func.args[0].eval(ctx)
    bv, bm = func.args[1].eval(ctx)
    fdt = _xp_dtype(xp, T.double(), ctx.on_device) or np.float64
    return xp.arctan2(_to_float(xp, av, func.args[0].ftype, fdt),
                      _to_float(xp, bv, func.args[1].ftype, fdt)), am & bm


@kernel("conv")
def _conv(func, ctx):
    def one(v, fb, tb):
        try:
            n = int(str(v), int(fb))
        except ValueError:
            return "0"
        tb = int(tb)
        if n == 0:
            return "0"
        digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        neg, n = n < 0, abs(n)
        out = ""
        while n:
            out = digits[n % tb] + out
            n //= tb
        return ("-" if neg else "") + out
    return _host_rows(func, ctx, one)


@kernel("format")
def _format_fn(func, ctx):
    def one(x, d):
        d = max(int(d), 0)
        from decimal import Decimal
        q = Decimal(str(x)).quantize(Decimal(1).scaleb(-d))
        return f"{q:,.{d}f}"
    # DECIMAL args arrive scaled: descale first
    ft = func.args[0].ftype
    def one_scaled(x, d):
        if ft.kind is TypeKind.DECIMAL:
            from decimal import Decimal
            x = Decimal(int(x)).scaleb(-ft.scale)
        return one(x, d)
    return _host_rows(func, ctx, one_scaled)


@kernel("char")
def _char_fn(func, ctx):
    def one(*codes):
        return "".join(chr(int(c) & 0x10FFFF) for c in codes if c)
    return _host_rows(func, ctx, one)


@kernel("elt")
def _elt(func, ctx):
    def one(n, *items):
        n = int(n)
        return str(items[n - 1]) if 1 <= n <= len(items) else None
    return _host_rows(func, ctx, one)


@kernel("inet_aton")
def _inet_aton(func, ctx):
    def one(s):
        parts = str(s).split(".")
        if not 1 <= len(parts) <= 4 or \
                not all(p.isdigit() and int(p) < 256 for p in parts):
            return None  # MySQL: malformed address → NULL, not 0
        n = 0
        for p in parts[:-1]:
            n = (n << 8) | int(p)
        return (n << (8 * (4 - len(parts) + 1))) | int(parts[-1]) \
            if len(parts) < 4 else (n << 8) | int(parts[-1])
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("inet_ntoa")
def _inet_ntoa(func, ctx):
    def one(n):
        n = int(n) & 0xFFFFFFFF
        return ".".join(str((n >> s) & 0xFF) for s in (24, 16, 8, 0))
    return _host_rows(func, ctx, one)


@kernel("uuid")
def _uuid(func, ctx):
    import uuid as _uuid_mod
    n = ctx.num_rows
    return (np.array([str(_uuid_mod.uuid4()) for _ in range(n)],
                     dtype=object), np.ones(n, dtype=bool))


_DAYS_TO_EPOCH = 719528       # TO_DAYS('1970-01-01') in MySQL


@kernel("to_days")
def _to_days(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        v = _floor_div_neg(xp, v, 86_400_000_000)
    return astype(v, xp.int64) + _DAYS_TO_EPOCH, m


@kernel("from_days")
def _from_days(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    return astype((astype(v, xp.int64) - _DAYS_TO_EPOCH), xp.int32), m


@kernel("makedate")
def _makedate(func, ctx):
    def one(y, doy):
        import datetime as _dt
        y, doy = int(y), int(doy)
        if doy < 1:
            return None
        d = _dt.date(y, 1, 1) + _dt.timedelta(days=doy - 1)
        return (d - _dt.date(1970, 1, 1)).days
    vals, m = _host_rows(func, ctx, one, dtype=np.int64)
    return astype(vals, np.int32), m


@kernel("time_to_sec")
def _time_to_sec(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        day_us = v - _floor_div_neg(xp, v, 86_400_000_000) * 86_400_000_000
        return _floor_div_neg(xp, day_us, 1_000_000), m
    return _floor_div_neg(xp, v, 1_000_000), m


@kernel("sec_to_time")
def _sec_to_time(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    return (astype(v, xp.int64) * 1_000_000), m


@kernel("microsecond")
def _microsecond(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    return astype(v, xp.int64) % 1_000_000, m


@kernel("yearweek")
def _yearweek(func, ctx):
    def one(days):
        import datetime as _dt
        d = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))
        iso = d.isocalendar()
        return iso[0] * 100 + iso[1]
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        v = _floor_div_neg(xp, v, 86_400_000_000)
    out = np.fromiter((one(x) for x in np.asarray(v)), dtype=np.int64,
                      count=len(np.asarray(v)))
    return out, m


_STR_TO_DATE_MAP = {"%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%m",
                    "%d": "%d", "%e": "%d", "%H": "%H", "%k": "%H",
                    "%i": "%M", "%s": "%S", "%S": "%S", "%f": "%f",
                    "%b": "%b", "%M": "%B", "%a": "%a", "%W": "%A",
                    "%p": "%p", "%h": "%I", "%I": "%I", "%%": "%%"}


@kernel("str_to_date")
def _str_to_date(func, ctx):
    import datetime as _dt
    fmt_c = func.args[1]
    def one(s, fmt):
        pyfmt = ""
        i = 0
        fmt = str(fmt)
        while i < len(fmt):
            if fmt[i] == "%" and i + 1 < len(fmt):
                tok = fmt[i:i + 2]
                pyfmt += _STR_TO_DATE_MAP.get(tok, tok[1])
                i += 2
            else:
                pyfmt += fmt[i]
                i += 1
        try:
            dt = _dt.datetime.strptime(str(s), pyfmt)
        except ValueError:
            return None
        return (dt - _dt.datetime(1970, 1, 1)) // _dt.timedelta(
            microseconds=1)
    return _host_rows(func, ctx, one, dtype=np.int64)


_TS_UNITS_US = {"microsecond": 1, "second": 1_000_000,
                "minute": 60_000_000, "hour": 3_600_000_000,
                "day": 86_400_000_000, "week": 7 * 86_400_000_000}


def _as_us(xp, v, ft):
    if ft.kind is TypeKind.DATE:
        return astype(v, xp.int64) * 86_400_000_000
    return astype(v, xp.int64)


@kernel("timestampdiff")
def _timestampdiff(func, ctx):
    # unit rides in the op-constant first arg (builder packs it)
    xp = ctx.xp
    unit = func.args[0].value
    av, am = func.args[1].eval(ctx)
    bv, bm = func.args[2].eval(ctx)
    a = _as_us(xp, av, func.args[1].ftype)
    b = _as_us(xp, bv, func.args[2].ftype)
    if unit in _TS_UNITS_US:
        return _floor_div_neg(xp, b - a, _TS_UNITS_US[unit]), am & bm
    # month/quarter/year: civil arithmetic on host
    def one(x, y):
        import datetime as _dt
        da = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(x))
        db = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(y))
        months = (db.year - da.year) * 12 + (db.month - da.month)
        # partial months don't count: compare the within-month position
        # (tuple compare sidesteps invalid replace() days at month ends)
        pa = (da.day, da.hour, da.minute, da.second, da.microsecond)
        pb = (db.day, db.hour, db.minute, db.second, db.microsecond)
        if months > 0 and pb < pa:
            months -= 1
        elif months < 0 and pb > pa:
            months += 1
        q = months // 3 if months >= 0 else -((-months) // 3)
        yr = months // 12 if months >= 0 else -((-months) // 12)
        return {"month": months, "quarter": q, "year": yr}[unit]
    out = np.fromiter((one(x, y) for x, y in zip(np.asarray(a),
                                                 np.asarray(b))),
                      dtype=np.int64, count=len(np.asarray(a)))
    return out, am & bm


# ---------------------------------------------------------------------------
# Math builtins (ref: expression/builtin_math.go + _vec twins)
# ---------------------------------------------------------------------------


def _float_unary(name, fn, domain=None):
    """Register a float→float elementwise builtin; NULL (and out-of-domain,
    MySQL-style) yields NULL."""

    def k(func: ScalarFunc, ctx: EvalContext):
        xp = ctx.xp
        v, m = func.args[0].eval(ctx)
        fdt = _xp_dtype(xp, T.double(), ctx.on_device)
        x = _to_float(xp, v, func.args[0].ftype, fdt)
        if domain is not None:
            ok = domain(xp, x)
            m = m & ok
            x = xp.where(ok, x, xp.ones_like(x))
        return fn(xp, x), m

    kernel(name)(k)


_float_unary("exp", lambda xp, x: xp.exp(x))
_float_unary("ln", lambda xp, x: xp.log(x), domain=lambda xp, x: x > 0)
_float_unary("log2", lambda xp, x: xp.log2(x), domain=lambda xp, x: x > 0)
_float_unary("log10", lambda xp, x: xp.log10(x), domain=lambda xp, x: x > 0)
_float_unary("sin", lambda xp, x: xp.sin(x))
_float_unary("cos", lambda xp, x: xp.cos(x))
_float_unary("tan", lambda xp, x: xp.tan(x))
_float_unary("cot", lambda xp, x: 1.0 / xp.tan(x))
_float_unary("asin", lambda xp, x: xp.arcsin(x),
             domain=lambda xp, x: (x >= -1) & (x <= 1))
_float_unary("acos", lambda xp, x: xp.arccos(x),
             domain=lambda xp, x: (x >= -1) & (x <= 1))
_float_unary("atan", lambda xp, x: xp.arctan(x))
_float_unary("degrees", lambda xp, x: x * (180.0 / np.pi))
_float_unary("radians", lambda xp, x: x * (np.pi / 180.0))


@kernel("log")
def _log(func, ctx):
    """LOG(x) = ln x; LOG(b, x) = log_b x."""
    xp = ctx.xp
    fdt = _xp_dtype(xp, T.double(), ctx.on_device)
    if len(func.args) == 1:
        v, m = func.args[0].eval(ctx)
        x = _to_float(xp, v, func.args[0].ftype, fdt)
        ok = x > 0
        return xp.log(xp.where(ok, x, xp.ones_like(x))), m & ok
    bv, bm = func.args[0].eval(ctx)
    xv, xm = func.args[1].eval(ctx)
    b = _to_float(xp, bv, func.args[0].ftype, fdt)
    x = _to_float(xp, xv, func.args[1].ftype, fdt)
    ok = (x > 0) & (b > 0) & (b != 1)
    b = xp.where(ok, b, xp.full_like(b, 2.0))
    x = xp.where(ok, x, xp.ones_like(x))
    return xp.log(x) / xp.log(b), bm & xm & ok


@kernel("pi")
def _pi(func, ctx):
    xp = ctx.xp
    n = ctx.num_rows
    fdt = _xp_dtype(xp, T.double(), ctx.on_device)
    return (xp.full(n, np.pi, dtype=fdt), xp.ones(n, dtype=bool))


@kernel("sign")
def _sign(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    return astype(xp.sign(v), xp.int64), m


@kernel("truncate")
def _truncate(func, ctx):
    """TRUNCATE(x, d): toward zero at d decimal places. DECIMAL args stay
    exact (integer arithmetic on the scaled representation)."""
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    dv, dm = func.args[1].eval(ctx)
    ft = func.args[0].ftype
    m = m & dm
    if ft.kind is TypeKind.DECIMAL:
        # d clamps to [ -precision, scale ]; scaled int math is exact
        s = ft.scale
        d = xp.clip(astype(dv, xp.int64), -18, s)
        p = astype(xp.asarray(10 ** xp.clip(s - d, 0, 18)), xp.int64) \
            if not ctx.on_device else 10 ** xp.clip(s - d, 0, 18)
        q = xp.abs(v) // p * p
        return xp.where(v < 0, -q, q), m
    fdt = _xp_dtype(xp, T.double(), ctx.on_device)
    x = _to_float(xp, v, ft, fdt)
    p = xp.power(xp.asarray(10.0, dtype=fdt), astype(dv, fdt))
    return _trunc(xp, x * p) / p, m


def _nary_minmax(name, pick):
    def k(func: ScalarFunc, ctx: EvalContext):
        # MySQL GREATEST/LEAST: NULL if ANY argument is NULL
        xp = ctx.xp
        target = func.ftype
        if target.kind.is_string:
            if ctx.on_device:
                raise TypeError_(f"{name}: host-only for strings")
            out_v = out_m = None
            for a in func.args:
                v, m = a.eval(ctx)
                sv = np.array([_concat_str(x, a.ftype)
                               for x in np.asarray(v)], dtype=object)
                if out_v is None:
                    out_v, out_m = sv, m
                else:
                    cond = sv > out_v if name == "greatest" else sv < out_v
                    out_v = np.where(cond, sv, out_v)
                    out_m = out_m & m
            return out_v, out_m
        out_v = out_m = None
        for a in func.args:
            v, m = _coerced(a, target, ctx)
            if out_v is None:
                out_v, out_m = v, m
            else:
                out_v = pick(xp, out_v, v)
                out_m = out_m & m
        return out_v, out_m

    kernel(name)(k)


_nary_minmax("greatest", lambda xp, a, b: xp.maximum(a, b))
_nary_minmax("least", lambda xp, a, b: xp.minimum(a, b))


# ---------------------------------------------------------------------------
# Date/time builtins (ref: expression/builtin_time.go)
# ---------------------------------------------------------------------------


def _calendar_part(v, ft, part):
    """One calendar part of a DATE/DATETIME tensor through ops.calendar
    (K20 on the card): the time parts read every non-DATE input as µs,
    the date parts only DATETIME/TIMESTAMP, as the numpy branches do."""
    micros = ft.kind is not TypeKind.DATE if part in ("hour", "minute",
                                                      "second") \
        else ft.kind in _DATETIME_KINDS
    return calendar.civil_part(_int_days_or_us(v), part, micros)


def _int_days_or_us(v):
    """The kernel reads contiguous int32/int64: anything else truncates
    to int64 first, as the numpy branches' `astype(v, int64)`."""
    if v.dtype not in (torch.int32, torch.int64):
        v = v.to(torch.int64)
    return v.contiguous()


def _civil_from_days(xp, days):
    """days-since-epoch → (year, month, day) — Hinnant algorithm, pure
    integer ops; torch tensors go through ops.calendar (K20 on the
    card)."""
    if isinstance(days, torch.Tensor):
        return tuple(calendar.civil_part(days, p, False)
                     for p in ("year", "month", "day"))
    z = astype(days, xp.int64) + 719468
    era = _floor_div_neg(xp, z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    mth = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(mp >= 10, y + 1, y)
    return y, mth, d


def _days_from_civil(xp, y, mth, d):
    """(year, month, day) → days-since-epoch; inverse of _civil_from_days."""
    y = y - (mth <= 2)
    era = _floor_div_neg(xp, y, 400)
    yoe = y - era * 400
    mp = xp.where(mth > 2, mth - 3, mth + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _as_days(xp, v, ft):
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return _floor_div_neg(xp, v, 86_400_000_000)
    return astype(v, xp.int64)


@kernel("datediff")
def _datediff(func, ctx):
    xp = ctx.xp
    a, am = func.args[0].eval(ctx)
    b, bm = func.args[1].eval(ctx)
    da = _as_days(xp, a, func.args[0].ftype)
    db = _as_days(xp, b, func.args[1].ftype)
    return astype((da - db), xp.int64), am & bm


def _date_add_interval(func, ctx):
    """DATE_ADD/SUB lowered by the planner to `date_add_<unit>(date, n)` —
    the unit rides in the op name so plan signatures stay faithful;
    DATE_SUB negates n at build time."""
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    nv, nm = func.args[1].eval(ctx)
    ft = func.args[0].ftype
    unit = func.op[len("date_add_"):]
    n = astype(nv, xp.int64)
    is_dt = ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP)
    usec = astype(v, xp.int64) if is_dt else None
    days = _as_days(xp, v, ft)
    if unit in ("day", "week"):
        delta = n * (7 if unit == "week" else 1)
        out_days = days + delta
        tod = usec - days * 86_400_000_000 if is_dt else None
    elif unit in ("month", "quarter", "year"):
        mult = {"month": 1, "quarter": 3, "year": 12}[unit]
        if isinstance(v, torch.Tensor):
            k = _host_int_const(func.args[1], ctx)
            return calendar.date_add_months(
                _int_days_or_us(v), is_dt,
                n.contiguous() if k is None else k, mult), m & nm
        months = n * mult
        y, mth, d = _civil_from_days(xp, days)
        tot = y * 12 + (mth - 1) + months
        ny = _floor_div_neg(xp, tot, 12)
        nm_ = tot - ny * 12 + 1
        # clamp day to the target month's length (MySQL semantics)
        nxt = _days_from_civil(xp, xp.where(nm_ == 12, ny + 1, ny),
                               xp.where(nm_ == 12, 1, nm_ + 1),
                               xp.ones_like(d))
        first = _days_from_civil(xp, ny, nm_, xp.ones_like(d))
        dim = nxt - first
        nd = xp.minimum(d, dim)
        out_days = _days_from_civil(xp, ny, nm_, nd)
        tod = usec - days * 86_400_000_000 if is_dt else None
    elif unit in ("hour", "minute", "second", "microsecond"):
        mult = {"hour": 3_600_000_000, "minute": 60_000_000,
                "second": 1_000_000, "microsecond": 1}[unit]
        base = usec if is_dt else days * 86_400_000_000
        return (base + n * mult), m & nm
    else:
        raise TypeError_(f"unsupported INTERVAL unit: {unit}")
    if is_dt:
        return out_days * 86_400_000_000 + tod, m & nm
    return astype(out_days, xp.int32), m & nm


def _host_int_const(e, ctx):
    """A plain non-NULL numeric constant's value as `astype(eval, int64)`
    would give it, without reading the device; else None."""
    if type(e) is not Constant or e.value is None:
        return None
    dt = _xp_dtype(ctx.xp, e.ftype, ctx.on_device)
    if dt is None:
        return None
    raw = np.asarray(e.ftype.encode_value(e.value), dtype=dt)
    return int(raw.astype(np.int64))


INTERVAL_UNITS = ("day", "week", "month", "quarter", "year", "hour",
                  "minute", "second", "microsecond")
for _u in INTERVAL_UNITS:
    kernel(f"date_add_{_u}")(_date_add_interval)


@kernel("dayofweek")
def _dayofweek(func, ctx):
    # 1 = Sunday … 7 = Saturday; epoch 1970-01-01 was a Thursday
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "dayofweek"), m
    days = _as_days(xp, v, func.args[0].ftype)
    return astype((_floor_mod(xp, days + 4, 7) + 1), xp.int64), m


@kernel("weekday")
def _weekday(func, ctx):
    # 0 = Monday … 6 = Sunday
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "weekday"), m
    days = _as_days(xp, v, func.args[0].ftype)
    return astype(_floor_mod(xp, days + 3, 7), xp.int64), m


@kernel("dayofyear")
def _dayofyear(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "dayofyear"), m
    days = _as_days(xp, v, func.args[0].ftype)
    y, _, _ = _civil_from_days(xp, days)
    jan1 = _days_from_civil(xp, y, xp.ones_like(y), xp.ones_like(y))
    return astype((days - jan1 + 1), xp.int64), m


@kernel("quarter")
def _quarter(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "quarter"), m
    _, mth, _ = _civil_from_days(xp, _as_days(xp, v, func.args[0].ftype))
    return astype(((mth + 2) // 3), xp.int64), m


@kernel("week")
def _week(func, ctx):
    """WEEK(d) mode 0: week 0..53, weeks start Sunday; week 1 is the first
    week containing a Sunday of the year."""
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "week"), m
    days = _as_days(xp, v, func.args[0].ftype)
    y, _, _ = _civil_from_days(xp, days)
    jan1 = _days_from_civil(xp, y, xp.ones_like(y), xp.ones_like(y))
    jan1_dow = _floor_mod(xp, jan1 + 4, 7)        # 0 = Sunday
    first_sunday = jan1 + _floor_mod(xp, -jan1_dow, 7)
    return astype(xp.where(days < first_sunday, 0,
                    (days - first_sunday) // 7 + 1), xp.int64), m


@kernel("last_day")
def _last_day(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, func.args[0].ftype, "last_day"), m
    days = _as_days(xp, v, func.args[0].ftype)
    y, mth, _ = _civil_from_days(xp, days)
    ny = xp.where(mth == 12, y + 1, y)
    nm_ = xp.where(mth == 12, xp.ones_like(mth), mth + 1)
    nxt = _days_from_civil(xp, ny, nm_, xp.ones_like(mth))
    return astype((nxt - 1), xp.int32), m


@kernel("hour")
def _hour(func, ctx):
    return _time_part(func, ctx, 3_600_000_000, 24)


@kernel("minute")
def _minute(func, ctx):
    return _time_part(func, ctx, 60_000_000, 60)


@kernel("second")
def _second(func, ctx):
    return _time_part(func, ctx, 1_000_000, 60)


def _time_part(func, ctx, unit_usec, modulo):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if isinstance(v, torch.Tensor):
        return _calendar_part(v, ft, func.op), m
    if ft.kind is TypeKind.DATE:
        return xp.zeros(v.shape[0], dtype=xp.int64), m
    usec = astype(v, xp.int64)
    return astype(_floor_mod(xp, _floor_div_neg(xp, usec, unit_usec),
                      modulo), xp.int64), m


_DAY_NAMES = np.array(["Monday", "Tuesday", "Wednesday", "Thursday",
                       "Friday", "Saturday", "Sunday"], dtype=object)
_MONTH_NAMES = np.array(
    ["January", "February", "March", "April", "May", "June", "July",
     "August", "September", "October", "November", "December"], dtype=object)


@kernel("dayname")
def _dayname(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    days = _as_days(xp, v, func.args[0].ftype)
    idx = _floor_mod(xp, days + 3, 7)        # 0 = Monday
    if ctx.on_device:
        raise TypeError_("dayname: host-only (string result)")
    return _DAY_NAMES[np.asarray(idx)], m


@kernel("monthname")
def _monthname(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    _, mth, _ = _civil_from_days(xp, _as_days(xp, v, func.args[0].ftype))
    if ctx.on_device:
        raise TypeError_("monthname: host-only (string result)")
    return _MONTH_NAMES[np.asarray(mth) - 1], m


def _floor_mod(xp, a, n):
    return a - _floor_div_neg(xp, a, n) * n


# ---------------------------------------------------------------------------
# Type inference / construction helpers (used by the planner)
# ---------------------------------------------------------------------------

# ops whose kernels can only run host-side (string results with no
# dictionary precompute, or object-array machinery) — the device gate
# (_fragment_ok/tree_ok) rejects fragments containing them up front
# ---------------------------------------------------------------------------
# Temporal epoch conversions, digests, radix conversions
# (ref: expression/builtin_time.go, builtin_encryption.go, builtin_math.go)
# ---------------------------------------------------------------------------


@kernel("unix_timestamp")
def _unix_timestamp(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    ft = func.args[0].ftype
    if ft.kind is TypeKind.DATE:
        return (astype(v, xp.int64) * 86400), m
    # DATETIME/TIMESTAMP raw = µs since epoch
    return astype(_floor_div_neg(xp, v, 1_000_000), xp.int64), m


@kernel("from_unixtime")
def _from_unixtime(func, ctx):
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    fdt = _xp_dtype(xp, T.double(), ctx.on_device)
    secs = _to_float(xp, v, func.args[0].ftype, fdt)
    return astype((secs * 1_000_000.0), xp.int64), m


@kernel("crc32")
def _crc32(func, ctx):
    if ctx.on_device:
        raise TypeError_("crc32: host-only")
    import zlib
    v, m = func.args[0].eval(ctx)
    out = np.fromiter(
        (zlib.crc32(str(x).encode()) for x in v), dtype=np.int64,
        count=len(v))
    return out, m


def _digest_kernel(name, fn):
    def k(func: ScalarFunc, ctx: EvalContext):
        if ctx.on_device:
            raise TypeError_(f"{name}: host-only")
        v, m = func.args[0].eval(ctx)
        out = np.array([fn(func, str(x)) for x in v], dtype=object)
        return out, m
    kernel(name)(k)


def _md5(_f, s):
    import hashlib
    return hashlib.md5(s.encode()).hexdigest()


def _sha1(_f, s):
    import hashlib
    return hashlib.sha1(s.encode()).hexdigest()


def _sha2(f, s):
    import hashlib
    bits = 256
    if len(f.args) > 1 and isinstance(f.args[1], Constant) and f.args[1].value:
        bits = int(f.args[1].value)
    algo = {224: "sha224", 256: "sha256", 384: "sha384",
            512: "sha512", 0: "sha256"}.get(bits)
    if algo is None:
        return None
    return getattr(hashlib, algo)(s.encode()).hexdigest()


_digest_kernel("md5", _md5)
_digest_kernel("sha1", _sha1)
_digest_kernel("sha2", _sha2)


@kernel("bin")
def _bin(func, ctx):
    if ctx.on_device:
        raise TypeError_("bin: host-only")
    v, m = func.args[0].eval(ctx)
    return np.array([format(int(x), "b") for x in np.asarray(v)],
                    dtype=object), m


@kernel("oct")
def _oct(func, ctx):
    if ctx.on_device:
        raise TypeError_("oct: host-only")
    v, m = func.args[0].eval(ctx)
    return np.array([format(int(x), "o") for x in np.asarray(v)],
                    dtype=object), m


@kernel("unhex")
def _unhex(func, ctx):
    if ctx.on_device:
        raise TypeError_("unhex: host-only")
    v, m = func.args[0].eval(ctx)
    out = np.empty(len(v), dtype=object)
    ok = np.asarray(m).copy()
    for i, x in enumerate(v):
        try:
            out[i] = bytes.fromhex(str(x)).decode("utf-8", "replace")
        except ValueError:
            out[i] = ""
            ok[i] = False
    return out, ok


_DATE_FORMAT_CODES = "YymcdeHisfMbWajprT%"


@kernel("date_format")
def _date_format(func, ctx):
    """DATE_FORMAT(dt, fmt) — the common % codes (builtin_time.go
    dateFormat); host-only (string result)."""
    if ctx.on_device:
        raise TypeError_("date_format: host-only")
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    fv, fm = func.args[1].eval(ctx)
    ft = func.args[0].ftype
    days = _as_days(xp, v, ft)
    y, mo, d = _civil_from_days(xp, days)
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        us = _floor_mod(xp, v, 86_400_000_000)
    else:
        us = xp.zeros_like(v)
    hh = us // 3_600_000_000
    mi = (us // 60_000_000) % 60
    ss = (us // 1_000_000) % 60
    micro = us % 1_000_000
    y, mo, d, hh, mi, ss, micro, days = map(
        np.asarray, (y, mo, d, hh, mi, ss, micro, days))
    out = np.empty(len(np.asarray(v)), dtype=object)
    for i in range(len(out)):
        fmt = str(fv[i]) if not np.isscalar(fv) else str(fv)
        s = []
        j = 0
        while j < len(fmt):
            c = fmt[j]
            if c != "%" or j + 1 >= len(fmt):
                s.append(c)
                j += 1
                continue
            code = fmt[j + 1]
            j += 2
            wd = int((days[i] + 3) % 7)          # 0 = Monday
            rep = {
                "Y": f"{y[i]:04d}", "y": f"{y[i] % 100:02d}",
                "m": f"{mo[i]:02d}", "c": str(mo[i]),
                "d": f"{d[i]:02d}", "e": str(d[i]),
                "H": f"{hh[i]:02d}", "i": f"{mi[i]:02d}",
                "s": f"{ss[i]:02d}", "S": f"{ss[i]:02d}",
                "f": f"{micro[i]:06d}",
                "M": _MONTH_NAMES[mo[i] - 1], "b": _MONTH_NAMES[mo[i] - 1][:3],
                "W": _DAY_NAMES[wd], "a": _DAY_NAMES[wd][:3],
                "p": "AM" if hh[i] < 12 else "PM",
                "r": f"{(hh[i] % 12) or 12:02d}:{mi[i]:02d}:{ss[i]:02d} "
                     f"{'AM' if hh[i] < 12 else 'PM'}",
                "T": f"{hh[i]:02d}:{mi[i]:02d}:{ss[i]:02d}",
                "%": "%",
            }.get(code)
            s.append(rep if rep is not None else "%" + code)
        out[i] = "".join(s)
    return out, np.asarray(m) & np.asarray(fm)


# ---------------------------------------------------------------------------
# JSON functions (ref: types/json + expression/builtin_json.go) — host-only
# path evaluation over JSON text; results are JSON text (or unquoted str)
# ---------------------------------------------------------------------------


def _json_path_steps(path: str):
    """'$.a.b[0].c' → ['a', 'b', 0, 'c'] (the common path subset)."""
    if not path.startswith("$"):
        raise TypeError_(f"Invalid JSON path expression: {path!r}")
    steps = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            if j < n and path[j] == '"':
                k = path.index('"', j + 1)
                steps.append(path[j + 1:k])
                i = k + 1
            else:
                k = j
                while k < n and path[k] not in ".[":
                    k += 1
                steps.append(path[j:k])
                i = k
        elif c == "[":
            k = path.index("]", i)
            steps.append(int(path[i + 1:k]))
            i = k + 1
        else:
            raise TypeError_(f"Invalid JSON path expression: {path!r}")
    return steps


def _json_get(doc, steps):
    for s in steps:
        if isinstance(s, int):
            if not isinstance(doc, list) or s >= len(doc):
                return None, False
            doc = doc[s]
        else:
            if not isinstance(doc, dict) or s not in doc:
                return None, False
            doc = doc[s]
    return doc, True


def _json_rows(func, ctx, arg_idx=0):
    import json as _json
    if ctx.on_device:
        raise TypeError_(f"{func.op}: host-only")
    v, m = func.args[arg_idx].eval(ctx)
    docs = []
    ok = np.asarray(m).copy()
    for i, x in enumerate(v):
        if not ok[i]:
            docs.append(None)
            continue
        try:
            docs.append(_json.loads(str(x)))
        except (ValueError, TypeError):
            docs.append(None)
            ok[i] = False
    return docs, ok


@kernel("json_extract")
def _json_extract(func, ctx):
    import json as _json
    docs, ok = _json_rows(func, ctx)
    pv, pm = func.args[1].eval(ctx)
    out = np.empty(len(docs), dtype=object)
    valid = ok & np.asarray(pm)
    for i, d in enumerate(docs):
        if not valid[i]:
            out[i] = ""
            continue
        hit, found = _json_get(d, _json_path_steps(str(pv[i])))
        if not found:
            out[i] = ""
            valid[i] = False
        else:
            out[i] = _json.dumps(hit, separators=(", ", ": "))
    return out, valid


@kernel("json_unquote")
def _json_unquote(func, ctx):
    if ctx.on_device:
        raise TypeError_("json_unquote: host-only")
    import json as _json
    v, m = func.args[0].eval(ctx)
    out = np.empty(len(v), dtype=object)
    for i, x in enumerate(v):
        s = str(x)
        if s.startswith('"'):
            try:
                out[i] = _json.loads(s)
                continue
            except ValueError:
                pass
        out[i] = s
    return out, m


@kernel("json_valid")
def _json_valid(func, ctx):
    import json as _json
    if ctx.on_device:
        raise TypeError_("json_valid: host-only")
    v, m = func.args[0].eval(ctx)
    out = np.zeros(len(v), dtype=np.int64)
    for i, x in enumerate(v):
        try:
            _json.loads(str(x))
            out[i] = 1
        except (ValueError, TypeError):
            out[i] = 0
    return out, m


@kernel("json_type")
def _json_type(func, ctx):
    docs, ok = _json_rows(func, ctx)
    out = np.empty(len(docs), dtype=object)
    for i, d in enumerate(docs):
        out[i] = ("OBJECT" if isinstance(d, dict) else
                  "ARRAY" if isinstance(d, list) else
                  "STRING" if isinstance(d, str) else
                  "BOOLEAN" if isinstance(d, bool) else
                  "INTEGER" if isinstance(d, int) else
                  "DOUBLE" if isinstance(d, float) else "NULL")
    return out, ok


@kernel("json_length")
def _json_length(func, ctx):
    docs, ok = _json_rows(func, ctx)
    out = np.zeros(len(docs), dtype=np.int64)
    for i, d in enumerate(docs):
        out[i] = len(d) if isinstance(d, (dict, list)) else 1
    return out, ok


@kernel("json_keys")
def _json_keys(func, ctx):
    import json as _json
    docs, ok = _json_rows(func, ctx)
    out = np.empty(len(docs), dtype=object)
    valid = ok.copy()
    for i, d in enumerate(docs):
        if isinstance(d, dict):
            out[i] = _json.dumps(list(d.keys()), separators=(", ", ": "))
        else:
            out[i] = ""
            valid[i] = False
    return out, valid


@kernel("json_contains")
def _json_contains(func, ctx):
    docs, ok = _json_rows(func, ctx)
    cands, cok = _json_rows(func, ctx, arg_idx=1)

    def contains(doc, cand):
        if isinstance(doc, list):
            return any(contains(x, cand) or x == cand for x in doc) \
                or doc == cand
        if isinstance(doc, dict) and isinstance(cand, dict):
            return all(k in doc and contains(doc[k], v) or
                       doc.get(k) == v for k, v in cand.items())
        return doc == cand

    out = np.zeros(len(docs), dtype=np.int64)
    for i, (d, c) in enumerate(zip(docs, cands)):
        out[i] = 1 if contains(d, c) else 0
    return out, ok & cok


def _json_build_kernel(name, array: bool):
    def k(func: ScalarFunc, ctx: EvalContext):
        import json as _json
        if ctx.on_device:
            raise TypeError_(f"{name}: host-only")
        cols = [a.eval(ctx) for a in func.args]
        n = ctx.num_rows
        out = np.empty(n, dtype=object)
        for i in range(n):
            vals = []
            for (v, m), arg in zip(cols, func.args):
                x = None if not np.asarray(m)[i] else v[i]
                if x is not None and arg.ftype.kind is TypeKind.JSON:
                    x = _json.loads(str(x))     # nest, don't double-encode
                elif x is not None and not arg.ftype.kind.is_string:
                    x = arg.ftype.decode_value(x)
                    if hasattr(x, "isoformat"):
                        x = str(x)
                    from decimal import Decimal
                    if isinstance(x, Decimal):
                        x = float(x)
                vals.append(x)
            if array:
                out[i] = _json.dumps(vals, separators=(", ", ": "))
            else:
                obj = {str(vals[j]): vals[j + 1]
                       for j in range(0, len(vals) - 1, 2)}
                out[i] = _json.dumps(obj, separators=(", ", ": "))
        return out, np.ones(n, dtype=bool)
    kernel(name)(k)


_json_build_kernel("json_array", True)
_json_build_kernel("json_object", False)


HOST_ONLY_OPS = {"strcmp", "space", "dayname", "monthname", "crc32",
                 "md5", "sha1", "sha2", "bin", "oct", "unhex",
                 "date_format", "json_extract", "json_unquote",
                 "json_valid", "json_type", "json_length", "json_keys",
                 "json_contains", "json_array", "json_object",
                 "apply_subquery",
                 "conv", "format", "char", "elt", "inet_aton", "inet_ntoa",
                 "uuid", "makedate", "yearweek", "str_to_date",
                 "timestampdiff", "soundex", "quote", "to_base64",
                 "from_base64", "insert", "field", "weekofyear",
                 "maketime", "period_add", "period_diff", "make_set",
                 "export_set"}

_BOOL_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "nulleq", "and", "or", "xor",
             "not", "isnull", "like", "in"}
_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}


def infer_type(op: str, args: Sequence[Expression]) -> FieldType:
    nullable = any(a.ftype.nullable for a in args)
    if op in _BOOL_OPS:
        nn = False if op in ("isnull", "nulleq") else nullable
        return FieldType(TypeKind.BIGINT, nn)  # MySQL booleans are ints
    if op in ("plus", "minus"):
        return T.merge_numeric(args[0].ftype, args[1].ftype)
    if op == "mul":
        a, b = args[0].ftype, args[1].ftype
        if a.kind is TypeKind.DECIMAL and b.kind is TypeKind.DECIMAL:
            scale = min(a.scale + b.scale, 30)
            prec = min(a.precision + b.precision, 65)
            return FieldType(TypeKind.DECIMAL, nullable, prec, scale)
        return T.merge_numeric(a, b)
    if op == "div":
        return T.double(True)
    if op in ("intdiv",):
        return T.bigint(nullable or True)
    if op == "mod":
        return T.merge_numeric(args[0].ftype, args[1].ftype).with_nullable(True)
    if op == "unary_minus":
        return args[0].ftype
    if op in ("if",):
        return _merge_branch(args[1].ftype, args[2].ftype)
    if op in ("ifnull", "coalesce"):
        out = args[0].ftype
        for a in args[1:]:
            out = _merge_branch(out, a.ftype)
        return out.with_nullable(all(a.ftype.nullable for a in args))
    if op == "case":
        n = len(args)
        has_else = n % 2 == 1
        branches = [args[2 * i + 1] for i in range((n - 1) // 2 if has_else
                                                   else n // 2)]
        if has_else:
            branches.append(args[-1])
        out = branches[0].ftype
        for b in branches[1:]:
            out = _merge_branch(out, b.ftype)
        return out.with_nullable(True)
    if op in ("abs",):
        return args[0].ftype
    if op in ("ceil", "floor", "round"):
        ft0 = args[0].ftype
        if op == "round" and len(args) == 2:
            # ROUND(x, d) preserves decimal scale (ROADMAP: ROUND(1.005, 2)
            # must be 1.01, exact half-away-from-zero — not integer 1)
            if ft0.kind is TypeKind.DECIMAL:
                d = _const_int(args[1])
                if d is None:
                    return ft0.with_nullable(nullable)
                scale = max(0, min(int(d), ft0.scale))
                return T.decimal(max(ft0.precision, scale + 1), scale,
                                 nullable)
            if ft0.kind.is_integer:
                return T.bigint(nullable)
            return T.double(nullable)
        if ft0.kind is TypeKind.DECIMAL:
            return T.decimal(ft0.precision, 0, nullable)
        return T.bigint(nullable)
    if op in ("sqrt", "pow", "exp", "ln", "log", "log2", "log10", "sin",
              "cos", "tan", "cot", "asin", "acos", "atan", "degrees",
              "radians", "pi"):
        return T.double(True)
    if op == "sign":
        return T.bigint(nullable)
    if op == "truncate":
        if args[0].ftype.kind is TypeKind.DECIMAL:
            return args[0].ftype.with_nullable(nullable)
        return T.double(nullable)
    if op in ("greatest", "least"):
        if any(a.ftype.kind.is_string for a in args):
            return T.varchar(nullable=nullable)
        out = args[0].ftype
        for a in args[1:]:
            out = T.merge_numeric(out, a.ftype)
        return out.with_nullable(nullable)
    if op in _STRING_INT_RESULT or op in ("year", "month", "dayofmonth",
                                          "datediff", "dayofweek",
                                          "weekday", "dayofyear", "quarter",
                                          "week", "hour", "minute",
                                          "second", "strcmp"):
        return T.bigint(nullable)
    if op in _STRING_FNS_EXTRA:
        _, _, rkind = _STRING_FNS_EXTRA[op]
        return T.bigint(nullable) if rkind == "int" else \
            T.varchar(nullable=nullable)
    if op in _HOST_STRING_FNS or op in ("concat", "space", "dayname",
                                        "monthname"):
        return T.varchar(nullable=nullable)
    if op in ("date", "last_day"):
        return T.date(nullable)
    if op in ("unix_timestamp", "crc32", "inet_aton", "to_days",
              "time_to_sec", "microsecond", "yearweek", "timestampdiff"):
        return T.bigint(nullable)
    if op in ("from_unixtime", "str_to_date"):
        return T.datetime(nullable)
    if op in ("from_days", "makedate"):
        return T.date(True)
    if op == "sec_to_time":
        return T.time_type(nullable) if hasattr(T, "time_type") else \
            FieldType(TypeKind.TIME, nullable)
    if op == "atan2":
        return T.double(nullable)
    if op in ("conv", "format", "char", "elt", "inet_ntoa", "uuid",
              "make_set", "export_set"):
        return T.varchar(nullable=True)
    if op in ("regexp_like", "weekofyear", "period_add", "period_diff"):
        return T.bigint(nullable)
    if op == "maketime":
        return FieldType(TypeKind.TIME, True)
    if op in ("addtime", "subtime"):
        if args[0].ftype.kind is TypeKind.DATE:
            return T.datetime(nullable)       # DATE + TIME → DATETIME
        return args[0].ftype.with_nullable(nullable)
    if op in ("md5", "sha1", "sha2", "bin", "oct", "unhex",
              "date_format", "json_unquote", "json_type", "json_keys"):
        return T.varchar(nullable=True)
    if op in ("json_extract",):
        return T.json_type(True)
    if op in ("json_array", "json_object"):
        return T.json_type(False)
    if op in ("json_valid", "json_length", "json_contains"):
        return T.bigint(True)
    if op in _BATCH3_INT_FNS:
        return T.bigint(True)
    if op in _BATCH3_STR_FNS:
        return T.varchar(nullable=True)
    if op in _BATCH3_JSON_FNS:
        return T.json_type(True)
    if op == "json_kv_pair":
        return T.json_type(True)    # internal pair transport
    if op == "rand":
        return T.double(False)
    if op == "any_value":
        return args[0].ftype
    if op == "name_const":
        return args[1].ftype
    if op in ("timediff", "time"):
        return FieldType(TypeKind.TIME, nullable)
    if op == "timestamp":
        return T.datetime(nullable)
    if op == "cast":
        raise AssertionError("cast requires explicit target type")
    raise TypeError_(f"cannot infer type for {op}")


_BATCH3_INT_FNS = frozenset((
    "gtid_subset", "ps_thread_id", "ps_current_thread_id",
    "release_all_locks",
    "is_ipv4", "is_ipv6", "is_ipv4_compat", "is_ipv4_mapped", "is_uuid",
    "bit_count", "octet_length", "uncompressed_length", "sleep",
    "interval", "benchmark", "get_lock", "release_lock", "is_free_lock",
    "is_used_lock", "coercibility", "tidb_shard", "tidb_is_ddl_owner",
    "regexp_instr",
    "validate_password_strength", "uuid_short", "to_seconds",
    "json_depth", "json_storage_size", "json_contains_path",
    "json_overlaps", "json_member_of"))
_BATCH3_STR_FNS = frozenset((
    "gtid_subtract", "roles_graphml",
    "inet6_aton", "inet6_ntoa", "uuid_to_bin", "bin_to_uuid",
    "concat_ws", "format_bytes", "format_pico_time", "weight_string",
    "load_file", "regexp_substr", "regexp_replace", "compress",
    "uncompress", "random_bytes", "aes_encrypt", "aes_decrypt",
    "password", "statement_digest", "statement_digest_text", "charset",
    "collation", "extractvalue", "updatexml", "json_quote",
    "json_pretty", "json_search", "json_value", "time_format",
    "get_format"))
_BATCH3_JSON_FNS = frozenset((
    "json_set", "json_insert", "json_replace", "json_remove",
    "json_array_append", "json_array_insert", "json_merge_patch",
    "json_merge_preserve"))


def _merge_branch(a: FieldType, b: FieldType) -> FieldType:
    if a.kind is TypeKind.NULLTYPE:
        return b.with_nullable(True)
    if b.kind is TypeKind.NULLTYPE:
        return a.with_nullable(True)
    if a.kind.is_string and b.kind.is_string:
        return T.varchar(nullable=a.nullable or b.nullable)
    if a.kind == b.kind and a.scale == b.scale:
        return a.with_nullable(a.nullable or b.nullable)
    return T.merge_numeric(a, b)


def func(op: str, *args: Expression, ftype: Optional[FieldType] = None
         ) -> ScalarFunc:
    return ScalarFunc(op, list(args), ftype or infer_type(op, args))


def cast(arg: Expression, target: FieldType) -> ScalarFunc:
    return ScalarFunc("cast", [arg], target)


def lit(value, ftype: Optional[FieldType] = None) -> Constant:
    if ftype is None:
        if value is None:
            ftype = T.null_type()
        elif isinstance(value, bool):
            ftype = T.bigint(False)
        elif isinstance(value, int):
            ftype = T.bigint(False)
        elif isinstance(value, float):
            ftype = T.double(False)
        elif isinstance(value, str):
            ftype = T.varchar(nullable=False)
        else:
            from decimal import Decimal
            if isinstance(value, Decimal):
                exp = -value.as_tuple().exponent
                ftype = T.decimal(max(len(value.as_tuple().digits), exp + 1),
                                  max(exp, 0), False)
            else:
                raise TypeError_(f"cannot infer literal type: {value!r}")
    return Constant(value, ftype)


# ---------------------------------------------------------------------------
# Builtin batch 3 (round 5): info/IP/UUID/JSON-mutation/crypto/misc breadth
# (ref: expression/builtin_info.go, builtin_miscellaneous.go,
#  builtin_json.go, builtin_encryption.go — host row-loop kernels; the
#  device allowlist is unchanged, these run on the CPU engine)
# ---------------------------------------------------------------------------


def _ip4_parse(s):
    parts = str(s).split(".")
    if len(parts) != 4 or not all(p.isdigit() and len(p) <= 3
                                  and int(p) < 256 for p in parts):
        return None
    return [int(p) for p in parts]


def _ip6_bytes(s):
    import ipaddress
    try:
        return ipaddress.ip_address(str(s)).packed
    except ValueError:
        return None


@kernel("is_ipv4")
def _is_ipv4(func, ctx):
    return _host_rows(func, ctx,
                      lambda s: 1 if _ip4_parse(s) else 0,
                      dtype=np.int64)


@kernel("is_ipv6")
def _is_ipv6(func, ctx):
    def one(s):
        b = _ip6_bytes(s)
        return 1 if (b is not None and len(b) == 16) else 0
    return _host_rows(func, ctx, one, dtype=np.int64)


def _ip6_raw(s):
    """Accept the hex transport INET6_ATON emits, then address text."""
    try:
        raw = bytes.fromhex(str(s))
        if len(raw) in (4, 16):
            return raw
    except ValueError:
        pass
    return _ip6_bytes(s)


@kernel("is_ipv4_compat")
def _is_ipv4_compat(func, ctx):
    def one(s):
        b = _ip6_raw(s)
        return 1 if (b is not None and len(b) == 16
                     and b[:12] == b"\x00" * 12
                     and b[12:] != b"\x00" * 4) else 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("is_ipv4_mapped")
def _is_ipv4_mapped(func, ctx):
    def one(s):
        b = _ip6_raw(s)
        return 1 if (b is not None and len(b) == 16
                     and b[:12] == b"\x00" * 10 + b"\xff\xff") else 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("inet6_aton")
def _inet6_aton(func, ctx):
    def one(s):
        b = _ip6_bytes(s)
        return b.hex() if b is not None else None   # hex text transport
    return _host_rows(func, ctx, one)


@kernel("inet6_ntoa")
def _inet6_ntoa(func, ctx):
    import ipaddress

    def one(s):
        try:
            raw = bytes.fromhex(str(s))
            if len(raw) == 4:
                return str(ipaddress.IPv4Address(raw))
            if len(raw) == 16:
                return str(ipaddress.IPv6Address(raw))
        except ValueError:
            pass
        return None
    return _host_rows(func, ctx, one)


@kernel("is_uuid")
def _is_uuid(func, ctx):
    import uuid as _u

    def one(s):
        try:
            _u.UUID(str(s))
            return 1
        except ValueError:
            return 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("uuid_to_bin")
def _uuid_to_bin(func, ctx):
    import uuid as _u

    def one(s, swap=0):
        try:
            h = _u.UUID(str(s)).hex
        except ValueError:
            return None
        if int(swap):       # time-swapped layout (MySQL 8 optimization)
            h = h[12:16] + h[8:12] + h[:8] + h[16:]
        return h
    return _host_rows(func, ctx, one)


@kernel("bin_to_uuid")
def _bin_to_uuid(func, ctx):
    import uuid as _u

    def one(s, swap=0):
        h = str(s)
        if len(h) != 32:
            return None
        if int(swap):
            h = h[8:16] + h[4:8] + h[:4] + h[16:]
        try:
            return str(_u.UUID(hex=h))
        except ValueError:
            return None
    return _host_rows(func, ctx, one)


@kernel("concat_ws")
def _concat_ws(func, ctx):
    """CONCAT_WS skips NULL args (unlike CONCAT) — evaluate manually."""
    evals = [a.eval(ctx) for a in func.args]
    n = ctx.num_rows
    sep_v, sep_m = evals[0]
    out = np.empty(n, dtype=object)
    valid = np.asarray(sep_m, dtype=bool).copy()
    for i in range(n):
        if not valid[i]:
            out[i] = ""
            continue
        sep = str(np.asarray(sep_v)[i] if np.ndim(sep_v) else sep_v)
        parts = []
        for v, m in evals[1:]:
            if np.asarray(m)[i]:
                parts.append(str(np.asarray(v)[i] if np.ndim(v) else v))
        out[i] = sep.join(parts)
    return out, valid


@kernel("bit_count")
def _bit_count(func, ctx):
    return _host_rows(func, ctx,
                      lambda v: bin(int(v) & ((1 << 64) - 1)).count("1"),
                      dtype=np.int64)


@kernel("octet_length")
def _octet_length(func, ctx):
    return _host_rows(func, ctx,
                      lambda s: len(str(s).encode("utf-8")),
                      dtype=np.int64)


@kernel("format_bytes")
def _format_bytes(func, ctx):
    def one(v):
        x = float(v)
        for unit in ("bytes", "KiB", "MiB", "GiB", "TiB", "PiB", "EiB"):
            if abs(x) < 1024 or unit == "EiB":
                return (f"{x:4.0f} {unit}".strip() if unit == "bytes"
                        else f"{x:.2f} {unit}")
            x /= 1024
    return _host_rows(func, ctx, one)


def _regex_flags(ftype):
    import re as _re
    return _re.IGNORECASE if getattr(ftype, "is_ci", False) else 0


@kernel("regexp_instr")
def _regexp_instr(func, ctx):
    import re as _re
    flags = _regex_flags(func.args[0].ftype)

    def one(s, pat, pos=1, occ=1):
        s = str(s)
        it = list(_re.finditer(str(pat), s[int(pos) - 1:], flags))
        k = int(occ) - 1
        return (it[k].start() + int(pos)) if 0 <= k < len(it) else 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("regexp_substr")
def _regexp_substr(func, ctx):
    import re as _re
    flags = _regex_flags(func.args[0].ftype)

    def one(s, pat, pos=1, occ=1):
        it = list(_re.finditer(str(pat), str(s)[int(pos) - 1:], flags))
        k = int(occ) - 1
        return it[k].group(0) if 0 <= k < len(it) else None
    return _host_rows(func, ctx, one)


@kernel("regexp_replace")
def _regexp_replace(func, ctx):
    import re as _re
    flags = _regex_flags(func.args[0].ftype)

    def one(s, pat, repl, pos=1, occ=0):
        head = str(s)[:int(pos) - 1]
        tail = str(s)[int(pos) - 1:]
        rtxt = str(repl).replace("\\", "\\\\")
        if int(occ) == 0:          # 0 = replace every occurrence
            return head + _re.sub(str(pat), rtxt, tail, flags=flags)
        hits = list(_re.finditer(str(pat), tail, flags))
        k = int(occ) - 1
        if not 0 <= k < len(hits):
            return head + tail
        hit = hits[k]
        return (head + tail[:hit.start()] + hit.expand(rtxt)
                + tail[hit.end():])
    return _host_rows(func, ctx, one)


@kernel("compress")
def _compress(func, ctx):
    import zlib

    def one(s):
        raw = str(s).encode("utf-8")
        if not raw:
            return ""
        out = len(raw).to_bytes(4, "little") + zlib.compress(raw)
        return out.hex()            # hex text transport (BLOB-less)
    return _host_rows(func, ctx, one)


@kernel("uncompress")
def _uncompress(func, ctx):
    import zlib

    def one(s):
        if str(s) == "":
            return ""
        try:
            raw = bytes.fromhex(str(s))
            return zlib.decompress(raw[4:]).decode("utf-8")
        except Exception:  # noqa: BLE001 — malformed input → NULL
            return None
    return _host_rows(func, ctx, one)


@kernel("uncompressed_length")
def _uncompressed_length(func, ctx):
    def one(s):
        if str(s) == "":
            return 0
        try:
            return int.from_bytes(bytes.fromhex(str(s))[:4], "little")
        except ValueError:
            return None
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("random_bytes")
def _random_bytes(func, ctx):
    import os as _os

    def one(n):
        n = int(n)
        if not 1 <= n <= 1024:
            return None
        return _os.urandom(n).hex()
    return _host_rows(func, ctx, one)


@kernel("statement_digest")
def _statement_digest(func, ctx):
    import hashlib

    from tidb_tpu_torch.util.observability import normalize_sql

    def one(s):
        return hashlib.sha256(
            normalize_sql(str(s)).encode()).hexdigest()
    return _host_rows(func, ctx, one)


@kernel("statement_digest_text")
def _statement_digest_text(func, ctx):
    from tidb_tpu_torch.util.observability import normalize_sql
    return _host_rows(func, ctx, lambda s: normalize_sql(str(s)))


@kernel("validate_password_strength")
def _validate_password_strength(func, ctx):
    def one(s):
        s = str(s)
        if len(s) < 4:
            return 0
        if len(s) < 8:
            return 25
        score = 25
        if any(c.isdigit() for c in s):
            score += 25
        if any(c.islower() for c in s) and any(c.isupper() for c in s):
            score += 25
        if any(not c.isalnum() for c in s):
            score += 25
        return score
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("sleep")
def _sleep(func, ctx):
    import time as _t

    def one(sec):
        _t.sleep(min(max(float(sec), 0.0), 10.0))   # capped: DoS guard
        return 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("any_value")
def _any_value(func, ctx):
    return func.args[0].eval(ctx)


@kernel("name_const")
def _name_const(func, ctx):
    return func.args[1].eval(ctx)


@kernel("interval")
def _interval_fn(func, ctx):
    """INTERVAL(N, N1, N2, ...) → index of last Ni <= N (builtin_compare)."""
    evals = [a.eval(ctx) for a in func.args]
    n = ctx.num_rows
    out = np.zeros(n, dtype=np.int64)
    v0, m0 = evals[0]
    for i in range(n):
        if not np.asarray(m0)[i]:
            out[i] = -1
            continue
        x = float(np.asarray(v0)[i])
        k = 0
        for v, m in evals[1:]:
            if np.asarray(m)[i] and x >= float(np.asarray(v)[i]):
                k += 1
            elif not np.asarray(m)[i]:
                k += 1          # MySQL: NULL bounds count as below
            else:
                break
        out[i] = k
    return out, np.ones(n, dtype=bool)


@kernel("tidb_shard")
def _tidb_shard(func, ctx):
    """TiDB's shard-index hash (expression/builtin_info.go tidbShard)."""
    return _host_rows(func, ctx, lambda v: (int(v) % (2 ** 64)) % 256,
                      dtype=np.int64)


# -- session user-level locks (GET_LOCK family; ref: builtin_miscellaneous
# .go + the server's lock table) — engine-global registry keyed by name
_USER_LOCKS: dict = {}
_USER_LOCKS_GUARD = None


def _locks_guard():
    global _USER_LOCKS_GUARD
    if _USER_LOCKS_GUARD is None:
        import threading
        _USER_LOCKS_GUARD = threading.Lock()
    return _USER_LOCKS_GUARD


def _lock_owner(ctx):
    # MySQL user locks are per-CONNECTION; the server runs one thread
    # per connection, so the thread is the stable owner identity the
    # expression context can see across statements
    import threading
    return threading.get_ident()


@kernel("get_lock")
def _get_lock(func, ctx):
    owner = _lock_owner(ctx)

    def one(name, _timeout):
        with _locks_guard():
            cur = _USER_LOCKS.get(str(name))
            if cur is None or cur == owner:
                _USER_LOCKS[str(name)] = owner
                return 1
            return 0            # held elsewhere: no blocking wait
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("release_lock")
def _release_lock(func, ctx):
    owner = _lock_owner(ctx)

    def one(name):
        with _locks_guard():
            cur = _USER_LOCKS.get(str(name))
            if cur is None:
                return None
            if cur == owner:
                del _USER_LOCKS[str(name)]
                return 1
            return 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("is_free_lock")
def _is_free_lock(func, ctx):
    def one(name):
        with _locks_guard():
            return 1 if str(name) not in _USER_LOCKS else 0
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("is_used_lock")
def _is_used_lock(func, ctx):
    def one(name):
        with _locks_guard():
            return _USER_LOCKS.get(str(name))
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("benchmark")
def _benchmark(func, ctx):
    def one(n, _expr_result):
        return 0        # the expr arg was already evaluated (vectorized)
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("rand")
def _rand(func, ctx):
    import random as _r
    n = ctx.num_rows
    if func.args:
        v, m = func.args[0].eval(ctx)
        seed = int(np.asarray(v)[0]) if np.ndim(v) else int(v)
        rng = _r.Random(seed)
    else:
        rng = _r.Random()
    return (np.array([rng.random() for _ in range(n)], dtype=np.float64),
            np.ones(n, dtype=bool))


# -- JSON mutation / inspection family (ref: expression/builtin_json.go;
# documents transport as text, paths via _json_path_steps — wildcard-free
# paths only, like the reference's modify functions) ------------------------


def _json_coerce(v):
    """SQL value → JSON value for modify/append functions. Numbers stay
    numbers; strings that ARE serialized JSON docs stay text (MySQL wraps
    SQL strings as JSON strings — callers pass JSON via CAST or nested
    calls, which arrive here already serialized; detecting that is the
    pragmatic middle)."""
    import json as _json
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    s = str(v)
    try:
        return _json.loads(s)
    except ValueError:
        return s


_JSON_MISSING = object()


def _json_modify(doc, steps, value, mode):
    """Set/insert/replace at a simple path; returns the new doc. MySQL
    semantics: intermediate path members must EXIST (only a single
    missing leaf may be created), and a JSON null value is present —
    not a missing key (builtin_json.go jsonModify)."""
    import copy
    d = copy.deepcopy(doc)
    if not steps:
        return value if mode in ("set", "replace") else d
    cur = d
    for st in steps[:-1]:
        if isinstance(st, str) and isinstance(cur, dict):
            nxt = cur.get(st, _JSON_MISSING)
        elif isinstance(st, int) and isinstance(cur, list) \
                and st < len(cur):
            nxt = cur[st]
        else:
            return d                 # missing intermediate: no-op
        if nxt is _JSON_MISSING or not isinstance(nxt, (dict, list)):
            return d
        cur = nxt
    last = steps[-1]
    if isinstance(last, str) and isinstance(cur, dict):
        exists = last in cur
        if (exists and mode in ("set", "replace")) or \
                (not exists and mode in ("set", "insert")):
            cur[last] = value
    elif isinstance(last, int) and isinstance(cur, list):
        if last < len(cur):
            if mode in ("set", "replace"):
                cur[last] = value
        elif mode in ("set", "insert"):
            cur.append(value)
    return d


def _json_modify_kernel(name, mode):
    @kernel(name)
    def _fn(func, ctx):
        import json as _json

        def one(doc, *pv):
            d = _json.loads(str(doc))
            for i in range(0, len(pv), 2):
                steps = _json_path_steps(str(pv[i]))
                d = _json_modify(d, steps, _json_coerce(pv[i + 1]), mode)
            return _json.dumps(d, separators=(", ", ": "))
        return _host_rows(func, ctx, one)
    return _fn


_json_modify_kernel("json_set", "set")
_json_modify_kernel("json_insert", "insert")
_json_modify_kernel("json_replace", "replace")


@kernel("json_remove")
def _json_remove(func, ctx):
    import json as _json

    def one(doc, *paths):
        d = _json.loads(str(doc))
        for p in paths:
            steps = _json_path_steps(str(p))
            if not steps:
                continue
            cur = d
            ok = True
            for st in steps[:-1]:
                if isinstance(st, str) and isinstance(cur, dict) \
                        and st in cur:
                    cur = cur[st]
                elif isinstance(st, int) and isinstance(cur, list) \
                        and st < len(cur):
                    cur = cur[st]
                else:
                    ok = False
                    break
            if not ok:
                continue
            last = steps[-1]
            if isinstance(last, str) and isinstance(cur, dict):
                cur.pop(last, None)
            elif isinstance(last, int) and isinstance(cur, list) \
                    and last < len(cur):
                cur.pop(last)
        return _json.dumps(d, separators=(", ", ": "))
    return _host_rows(func, ctx, one)


@kernel("json_quote")
def _json_quote(func, ctx):
    import json as _json
    return _host_rows(func, ctx,
                      lambda s: _json.dumps(str(s)))


@kernel("json_depth")
def _json_depth(func, ctx):
    import json as _json

    def depth(v):
        if isinstance(v, dict):
            return 1 + max([depth(x) for x in v.values()] or [0])
        if isinstance(v, list):
            return 1 + max([depth(x) for x in v] or [0])
        return 1
    return _host_rows(func, ctx,
                      lambda s: depth(_json.loads(str(s))),
                      dtype=np.int64)


@kernel("json_storage_size")
def _json_storage_size(func, ctx):
    import json as _json
    return _host_rows(
        func, ctx,
        lambda s: len(_json.dumps(_json.loads(str(s)))), dtype=np.int64)


@kernel("json_pretty")
def _json_pretty(func, ctx):
    import json as _json
    return _host_rows(
        func, ctx,
        lambda s: _json.dumps(_json.loads(str(s)), indent=2))


def _json_append_kernel(name, insert: bool):
    @kernel(name)
    def _fn(func, ctx):
        import json as _json

        def one(doc, *pv):
            d = _json.loads(str(doc))
            for i in range(0, len(pv), 2):
                steps = _json_path_steps(str(pv[i]))
                val = _json_coerce(pv[i + 1])
                if insert and steps and isinstance(steps[-1], int):
                    # ARRAY_INSERT: shift at the index
                    cur, ok = _json_get(d, steps[:-1])
                    if ok and isinstance(cur, list):
                        cur.insert(min(steps[-1], len(cur)), val)
                    continue
                cur, ok = _json_get(d, steps)
                if not ok:
                    continue
                if isinstance(cur, list) and not insert:
                    cur.append(val)
                elif not insert:
                    # appending to a scalar wraps it (MySQL semantics);
                    # only expressible at the root without a parent ref
                    if not steps:
                        d = [d, val]
                    else:
                        parent, pok = _json_get(d, steps[:-1])
                        last = steps[-1]
                        if pok and isinstance(parent, dict) \
                                and isinstance(last, str):
                            parent[last] = [cur, val]
                        elif pok and isinstance(parent, list) \
                                and isinstance(last, int) \
                                and last < len(parent):
                            parent[last] = [cur, val]
            return _json.dumps(d, separators=(", ", ": "))
        return _host_rows(func, ctx, one)
    return _fn


_json_append_kernel("json_array_append", False)
_json_append_kernel("json_array_insert", True)


def _json_merge(a, b, patch: bool):
    if patch:
        if not isinstance(b, dict):
            return b
        if not isinstance(a, dict):
            a = {}
        out = dict(a)
        for k, v in b.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = _json_merge(out.get(k), v, True)
        return out
    # MERGE_PRESERVE
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _json_merge(out[k], v, False) if k in out else v
        return out
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    return la + lb


def _json_merge_kernel(name, patch: bool):
    @kernel(name)
    def _fn(func, ctx):
        import json as _json

        def one(*docs):
            cur = _json.loads(str(docs[0]))
            for d in docs[1:]:
                cur = _json_merge(cur, _json.loads(str(d)), patch)
            return _json.dumps(cur, separators=(", ", ": "))
        return _host_rows(func, ctx, one)
    return _fn


_json_merge_kernel("json_merge_patch", True)
_json_merge_kernel("json_merge_preserve", False)


@kernel("json_contains_path")
def _json_contains_path(func, ctx):
    import json as _json

    def one(doc, mode, *paths):
        d = _json.loads(str(doc))
        hits = [(_json_get(d, _json_path_steps(str(p)))[1]) for p in paths]
        return int(all(hits) if str(mode).lower() == "all" else any(hits))
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("json_search")
def _json_search(func, ctx):
    import fnmatch
    import json as _json

    def walk(v, path):
        if isinstance(v, dict):
            for k, x in v.items():
                yield from walk(x, path + [k])
        elif isinstance(v, list):
            for i, x in enumerate(v):
                yield from walk(x, path + [i])
        elif isinstance(v, str):
            yield v, path

    def one(doc, mode, pat):
        d = _json.loads(str(doc))
        glob = str(pat).replace("%", "*").replace("_", "?")
        out = []
        for s, path in walk(d, []):
            if fnmatch.fnmatchcase(s, glob):
                p = "$" + "".join(
                    f"[{x}]" if isinstance(x, int) else f".{x}"
                    for x in path)
                out.append(p)
                if str(mode).lower() == "one":
                    break
        if not out:
            return None
        if len(out) == 1:
            return _json.dumps(out[0])
        return _json.dumps(out, separators=(", ", ": "))
    return _host_rows(func, ctx, one)


@kernel("json_overlaps")
def _json_overlaps(func, ctx):
    import json as _json

    def one(a, b):
        da, db = _json.loads(str(a)), _json.loads(str(b))
        la = da if isinstance(da, list) else [da]
        lb = db if isinstance(db, list) else [db]
        return int(any(x in lb for x in la))
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("json_member_of")
def _json_member_of(func, ctx):
    import json as _json

    def one(val, arr):
        d = _json.loads(str(arr))
        v = _json_coerce(val)
        if isinstance(d, list):
            return int(v in d)
        return int(v == d)
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("json_value")
def _json_value(func, ctx):
    import json as _json

    def one(doc, path):
        hit, found = _json_get(_json.loads(str(doc)),
                               _json_path_steps(str(path)))
        if not found or hit is None:
            return None
        if isinstance(hit, (dict, list)):
            return _json.dumps(hit, separators=(", ", ": "))
        return str(hit) if not isinstance(hit, bool) else \
            ("1" if hit else "0")
    return _host_rows(func, ctx, one)


# -- temporal additions -------------------------------------------------------


def _parse_time_us(s):
    """'[-]HH:MM:SS[.ffffff]' or 'YYYY-MM-DD HH:MM:SS' → microseconds."""
    import datetime as _dt
    s = str(s).strip()
    try:
        d = _dt.datetime.fromisoformat(s)
        return int((d - _dt.datetime(1970, 1, 1)).total_seconds() * 1_000_000)
    except ValueError:
        pass
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    parts = s.split(":")
    if not 1 <= len(parts) <= 3:
        return None
    try:
        h = int(parts[0])
        mi = int(parts[1]) if len(parts) > 1 else 0
        sec = float(parts[2]) if len(parts) > 2 else 0.0
    except ValueError:
        return None
    us = int(((h * 60 + mi) * 60 + sec) * 1_000_000)
    return -us if neg else us


def _parse_dt_us(s):
    """Datetime/date string → epoch microseconds, or None."""
    import datetime as _dt
    try:
        d = _dt.datetime.fromisoformat(str(s).strip())
        return int((d - _dt.datetime(1970, 1, 1)).total_seconds()
                   * 1_000_000)
    except ValueError:
        return None


def _temporal_us(func, ctx, idx):
    """Arg `idx` as epoch-µs (datetime-ish) regardless of arg type."""
    ft = func.args[idx].ftype
    if ft.kind.is_string:
        e = func.args[idx]
        v, m = e.eval(ctx)
        out = np.empty(len(v), dtype=np.int64)
        ok = np.asarray(m, dtype=bool).copy()
        for i, x in enumerate(v):
            if not ok[i]:
                out[i] = 0
                continue
            us = _parse_dt_us(x)
            if us is None:
                us = _parse_time_us(x)
            if us is None:
                ok[i] = False
                out[i] = 0
            else:
                out[i] = us
        return out, ok
    v, m = func.args[idx].eval(ctx)
    if ft.kind is TypeKind.DATE:
        return astype(np.asarray(v), np.int64) * 86_400_000_000, m
    return astype(np.asarray(v), np.int64), m


@kernel("to_seconds")
def _to_seconds(func, ctx):
    xp = ctx.xp
    ft = func.args[0].ftype
    if ft.kind.is_string and not ctx.on_device:
        v, m = _temporal_us(func, ctx, 0)
        return v // 1_000_000 + _DAYS_TO_EPOCH * 86_400, m
    v, m = func.args[0].eval(ctx)
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        secs = _floor_div_neg(xp, v, 1_000_000)
        return astype(secs, xp.int64) + _DAYS_TO_EPOCH * 86_400, m
    return (astype(v, xp.int64) + _DAYS_TO_EPOCH) * 86_400, m


@kernel("timediff")
def _timediff(func, ctx):
    if ctx.on_device:
        xp = ctx.xp
        av, am = func.args[0].eval(ctx)
        bv, bm = func.args[1].eval(ctx)
        return (_as_us(xp, av, func.args[0].ftype) -
                _as_us(xp, bv, func.args[1].ftype)), am & bm
    av, am = _temporal_us(func, ctx, 0)
    bv, bm = _temporal_us(func, ctx, 1)
    return av - bv, am & bm


@kernel("time_format")
def _time_format(func, ctx):
    def one(us, fmt):
        us = int(us)
        sign = "-" if us < 0 else ""
        us = abs(us)
        h, rem = divmod(us, 3_600_000_000)
        mi, rem = divmod(rem, 60_000_000)
        se, micro = divmod(rem, 1_000_000)
        out = str(fmt)
        for pat, val in (("%H", f"{sign}{h:02d}"), ("%i", f"{mi:02d}"),
                         ("%s", f"{se:02d}"), ("%S", f"{se:02d}"),
                         ("%f", f"{micro:06d}"), ("%h", f"{h % 12:02d}"),
                         ("%k", f"{sign}{h}")):
            out = out.replace(pat, val)
        return out
    return _host_rows(func, ctx, one)


@kernel("get_format")
def _get_format(func, ctx):
    _FORMATS = {
        ("date", "usa"): "%m.%d.%Y", ("date", "jis"): "%Y-%m-%d",
        ("date", "iso"): "%Y-%m-%d", ("date", "eur"): "%d.%m.%Y",
        ("date", "internal"): "%Y%m%d",
        ("datetime", "usa"): "%Y-%m-%d %H.%i.%s",
        ("datetime", "jis"): "%Y-%m-%d %H:%i:%s",
        ("datetime", "iso"): "%Y-%m-%d %H:%i:%s",
        ("datetime", "eur"): "%Y-%m-%d %H.%i.%s",
        ("datetime", "internal"): "%Y%m%d%H%i%s",
        ("time", "usa"): "%h:%i:%s %p", ("time", "jis"): "%H:%i:%s",
        ("time", "iso"): "%H:%i:%s", ("time", "eur"): "%H.%i.%s",
        ("time", "internal"): "%H%i%s",
    }

    def one(kind, region):
        return _FORMATS.get((str(kind).lower(), str(region).lower()))
    return _host_rows(func, ctx, one)


@kernel("timestamp")
def _timestamp_fn(func, ctx):
    ft = func.args[0].ftype
    if ft.kind.is_string and not ctx.on_device:
        return _temporal_us(func, ctx, 0)
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if ft.kind is TypeKind.DATE:
        v = astype(v, xp.int64) * 86_400_000_000
    return v, m


# -- AES (MySQL AES_ENCRYPT/AES_DECRYPT: AES-128-ECB, PKCS7, with MySQL's
# key folding — XOR the key bytes cyclically into 16 bytes). Pure-python
# table AES (ref: expression/builtin_encryption.go; stdlib has no AES) --


_AES_SBOX = None
_AES_INV = None


def _aes_tables():
    """The FIPS-197 S-box built from GF(2^8) inversion + affine map —
    computed via discrete logs over the generator 3 (a few lines beats a
    256-literal table and is checked by the FIPS known-answer test)."""
    global _AES_SBOX, _AES_INV
    if _AES_SBOX is not None:
        return _AES_SBOX, _AES_INV
    # log/antilog tables over generator 3
    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # x *= 3  (x ^ xtime(x))
        x ^= _xtime(x)
    sbox = [0] * 256
    for a in range(256):
        inv_a = 0 if a == 0 else exp[(255 - log[a]) % 255]
        b = inv_a
        s = 0x63
        for k in range(8):
            bit = (b >> k) & 1
            for dst in (k, (k + 1) % 8, (k + 2) % 8, (k + 3) % 8,
                        (k + 4) % 8):
                s ^= bit << dst
        sbox[a] = s & 0xFF
    inv = [0] * 256
    for i, v in enumerate(sbox):
        inv[v] = i
    _AES_SBOX, _AES_INV = sbox, inv
    return sbox, inv


def _xtime(a):
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _aes_expand_key(key):
    sbox, _ = _aes_tables()
    rcon = 1
    w = list(key)
    while len(w) < 176:
        t = w[-4:]
        if len(w) % 16 == 0:
            t = [sbox[t[1]] ^ rcon, sbox[t[2]], sbox[t[3]], sbox[t[0]]]
            rcon = _xtime(rcon)
        base = [w[len(w) - 16 + i] for i in range(4)]
        w.extend(base[i] ^ t[i] for i in range(4))
    return w


def _aes_block(block, rk, enc: bool):
    sbox, inv = _aes_tables()
    s = list(block)

    def add_rk(r):
        for i in range(16):
            s[i] ^= rk[16 * r + i]

    def sub(box):
        for i in range(16):
            s[i] = box[s[i]]

    def shift(enc_):
        for r in range(1, 4):
            row = [s[r + 4 * c] for c in range(4)]
            k = r if enc_ else -r
            row = row[k:] + row[:k]
            for c in range(4):
                s[r + 4 * c] = row[c]

    def mix(enc_):
        for c in range(4):
            col = s[4 * c:4 * c + 4]
            if enc_:
                t = col[0] ^ col[1] ^ col[2] ^ col[3]
                u = col[0]
                s[4 * c + 0] ^= t ^ _xtime(col[0] ^ col[1])
                s[4 * c + 1] ^= t ^ _xtime(col[1] ^ col[2])
                s[4 * c + 2] ^= t ^ _xtime(col[2] ^ col[3])
                s[4 * c + 3] ^= t ^ _xtime(col[3] ^ u)
            else:
                def mul(a, b):
                    out = 0
                    while b:
                        if b & 1:
                            out ^= a
                        a = _xtime(a)
                        b >>= 1
                    return out
                a0, a1, a2, a3 = col
                s[4 * c + 0] = mul(a0, 14) ^ mul(a1, 11) ^ \
                    mul(a2, 13) ^ mul(a3, 9)
                s[4 * c + 1] = mul(a0, 9) ^ mul(a1, 14) ^ \
                    mul(a2, 11) ^ mul(a3, 13)
                s[4 * c + 2] = mul(a0, 13) ^ mul(a1, 9) ^ \
                    mul(a2, 14) ^ mul(a3, 11)
                s[4 * c + 3] = mul(a0, 11) ^ mul(a1, 13) ^ \
                    mul(a2, 9) ^ mul(a3, 14)

    if enc:
        add_rk(0)
        for r in range(1, 10):
            sub(sbox)
            shift(True)
            mix(True)
            add_rk(r)
        sub(sbox)
        shift(True)
        add_rk(10)
    else:
        add_rk(10)
        for r in range(9, 0, -1):
            shift(False)
            sub(inv)
            add_rk(r)
            mix(False)
        shift(False)
        sub(inv)
        add_rk(0)
    return bytes(s)


def _mysql_aes_key(key):
    out = bytearray(16)
    for i, b in enumerate(key.encode("utf-8") if isinstance(key, str)
                          else key):
        out[i % 16] ^= b
    return bytes(out)


@kernel("aes_encrypt")
def _aes_encrypt(func, ctx):
    def one(s, key):
        rk = _aes_expand_key(_mysql_aes_key(str(key)))
        raw = str(s).encode("utf-8")
        pad = 16 - len(raw) % 16
        raw += bytes([pad]) * pad
        out = b"".join(_aes_block(raw[i:i + 16], rk, True)
                       for i in range(0, len(raw), 16))
        return out.hex()            # hex text transport
    return _host_rows(func, ctx, one)


@kernel("aes_decrypt")
def _aes_decrypt(func, ctx):
    def one(s, key):
        try:
            raw = bytes.fromhex(str(s))
            if not raw or len(raw) % 16:
                return None
            rk = _aes_expand_key(_mysql_aes_key(str(key)))
            out = b"".join(_aes_block(raw[i:i + 16], rk, False)
                           for i in range(0, len(raw), 16))
            pad = out[-1]
            if not 1 <= pad <= 16:
                return None
            return out[:-pad].decode("utf-8")
        except Exception:  # noqa: BLE001 — wrong key/garbage → NULL
            return None
    return _host_rows(func, ctx, one)


@kernel("extractvalue")
def _extractvalue(func, ctx):
    import xml.etree.ElementTree as ET

    def one(xml, xpath):
        try:
            root = ET.fromstring(str(xml))
        except ET.ParseError:
            return None
        p = str(xpath).strip("/")
        parts = p.split("/")
        # root tag consumes the first step
        if parts and parts[0] == root.tag:
            parts = parts[1:]
        nodes = [root]
        for step in parts:
            if step in ("text()",):
                break
            nxt = []
            for nd in nodes:
                nxt.extend(nd.findall(step))
            nodes = nxt
        return " ".join((nd.text or "").strip() for nd in nodes)
    return _host_rows(func, ctx, one)


@kernel("updatexml")
def _updatexml(func, ctx):
    import re as _re

    def one(xml, xpath, repl):
        # MySQL semantics: replace the single matched ELEMENT text-wise;
        # a non-matching path returns the original document
        tag = str(xpath).strip("/").split("/")[-1]
        pat = f"<{tag}(\\s[^>]*)?>.*?</{tag}>"
        s = str(xml)
        if _re.search(pat, s, _re.S):
            return _re.sub(pat, str(repl), s, count=1, flags=_re.S)
        return s
    return _host_rows(func, ctx, one)


@kernel("charset")
def _charset_fn(func, ctx):
    ft = func.args[0].ftype
    val = "utf8mb4" if ft.kind.is_string else "binary"
    n = ctx.num_rows
    return np.array([val] * n, dtype=object), np.ones(n, dtype=bool)


@kernel("collation")
def _collation_fn(func, ctx):
    ft = func.args[0].ftype
    val = ("utf8mb4_general_ci" if getattr(ft, "is_ci", False)
           else "utf8mb4_bin") if ft.kind.is_string else "binary"
    n = ctx.num_rows
    return np.array([val] * n, dtype=object), np.ones(n, dtype=bool)


@kernel("coercibility")
def _coercibility_fn(func, ctx):
    from tidb_tpu_torch.expression import Constant as _C
    e = func.args[0]
    val = 4 if isinstance(e, _C) else (2 if e.ftype.kind.is_string else 5)
    n = ctx.num_rows
    return np.full(n, val, dtype=np.int64), np.ones(n, dtype=bool)


@kernel("load_file")
def _load_file(func, ctx):
    # secure_file_priv defaults to restricted: always NULL (MySQL parity
    # for the common locked-down configuration)
    return _host_rows(func, ctx, lambda s: None)


_UUID_SHORT_STATE = [0]


@kernel("uuid_short")
def _uuid_short(func, ctx):
    import time as _t
    n = ctx.num_rows
    base = (int(_t.time()) & 0xFFFFFFF) << 24
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        _UUID_SHORT_STATE[0] += 1
        out[i] = base | (_UUID_SHORT_STATE[0] & 0xFFFFFF)
    return out, np.ones(n, dtype=bool)


@kernel("format_pico_time")
def _format_pico_time(func, ctx):
    def one(v):
        x = float(v)
        for unit, div in (("ps", 1.0), ("ns", 1e3), ("us", 1e6),
                          ("ms", 1e9), ("s", 1e12), ("min", 60e12),
                          ("h", 3.6e15), ("d", 86.4e15)):
            nxt = {"ps": 1e3, "ns": 1e6, "us": 1e9, "ms": 1e12,
                   "s": 60e12, "min": 3.6e15, "h": 86.4e15,
                   "d": float("inf")}[unit]
            if abs(x) < nxt:
                val = x / div
                return (f"{val:.0f} {unit}" if unit == "ps"
                        else f"{val:.2f} {unit}")
    return _host_rows(func, ctx, one)


@kernel("weight_string")
def _weight_string(func, ctx):
    def one(s):
        ft = func.args[0].ftype
        t = str(s)
        if getattr(ft, "is_ci", False):
            import numpy as _np

            from tidb_tpu_torch.types import fold_ci_array
            t = str(fold_ci_array(_np.array([t], dtype=object))[0])
        return t.encode("utf-8").hex().upper()
    return _host_rows(func, ctx, one)


@kernel("time")
def _time_extract(func, ctx):
    ft = func.args[0].ftype
    if ft.kind.is_string and not ctx.on_device:
        e = func.args[0]
        v, m = e.eval(ctx)
        out = np.empty(len(v), dtype=np.int64)
        ok = np.asarray(m, dtype=bool).copy()
        for i, x in enumerate(v):
            us = _parse_time_us(x) if ok[i] else None
            if us is None:
                ok[i] = False
                out[i] = 0
            else:
                out[i] = us
        return out, ok
    xp = ctx.xp
    v, m = func.args[0].eval(ctx)
    if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return astype(v, xp.int64) % 86_400_000_000, m
    if ft.kind is TypeKind.DATE:
        return xp.zeros_like(astype(v, xp.int64)), m
    return v, m


@kernel("tidb_is_ddl_owner")
def _tidb_is_ddl_owner(func, ctx):
    n = ctx.num_rows
    return np.ones(n, dtype=np.int64), np.ones(n, dtype=bool)


@kernel("password")
def _password_fn(func, ctx):
    import hashlib

    def one(s):
        if str(s) == "":
            return ""
        inner = hashlib.sha1(str(s).encode()).digest()
        return "*" + hashlib.sha1(inner).hexdigest().upper()
    return _host_rows(func, ctx, one)


def _gtid_sets(s):
    out = {}
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        uuid, ranges = bits[0].lower(), bits[1:]
        ivals = out.setdefault(uuid, [])
        for r in ranges:
            if "-" in r:
                a, b = r.split("-")
                ivals.append((int(a), int(b)))
            else:
                ivals.append((int(r), int(r)))
    return out


def _gtid_contains(sup, a, b):
    return any(lo <= a and b <= hi for lo, hi in sup)


@kernel("gtid_subset")
def _gtid_subset(func, ctx):
    def one(sub, sup):
        subs, sups = _gtid_sets(sub), _gtid_sets(sup)
        for uuid, ivals in subs.items():
            have = sups.get(uuid, [])
            if not all(_gtid_contains(have, a, b) for a, b in ivals):
                return 0
        return 1
    return _host_rows(func, ctx, one, dtype=np.int64)


@kernel("gtid_subtract")
def _gtid_subtract(func, ctx):
    def one(a, b):
        A, B = _gtid_sets(a), _gtid_sets(b)
        out = []
        for uuid, ivals in A.items():
            cut = B.get(uuid, [])
            pieces = []
            for lo, hi in ivals:
                segs = [(lo, hi)]
                for clo, chi in cut:
                    nxt = []
                    for slo, shi in segs:
                        if chi < slo or clo > shi:
                            nxt.append((slo, shi))
                            continue
                        if slo < clo:
                            nxt.append((slo, clo - 1))
                        if chi < shi:
                            nxt.append((chi + 1, shi))
                    segs = nxt
                pieces.extend(segs)
            if pieces:
                rs = ":".join(f"{lo}-{hi}" if hi > lo else str(lo)
                              for lo, hi in sorted(pieces))
                out.append(f"{uuid}:{rs}")
        return ",".join(out)
    return _host_rows(func, ctx, one)


@kernel("ps_thread_id")
def _ps_thread_id(func, ctx):
    return _host_rows(func, ctx, lambda v: int(v), dtype=np.int64)


@kernel("ps_current_thread_id")
def _ps_current_thread_id(func, ctx):
    import threading
    n = ctx.num_rows
    return (np.full(n, threading.get_ident() % (1 << 31), dtype=np.int64),
            np.ones(n, dtype=bool))


@kernel("release_all_locks")
def _release_all_locks(func, ctx):
    owner = _lock_owner(ctx)
    n = ctx.num_rows
    with _locks_guard():
        mine = [k for k, v in _USER_LOCKS.items() if v == owner]
        for k in mine:
            del _USER_LOCKS[k]
    return np.full(n, len(mine), dtype=np.int64), np.ones(n, dtype=bool)


@kernel("roles_graphml")
def _roles_graphml(func, ctx):
    n = ctx.num_rows
    xml = ('<?xml version="1.0" encoding="UTF-8"?><graphml '
           'xmlns="http://graphml.graphdrawing.org/xmlns"><graph '
           'id="roles" edgedefault="directed"/></graphml>')
    return np.array([xml] * n, dtype=object), np.ones(n, dtype=bool)


@kernel("json_kv_pair")
def _json_kv_pair(func, ctx):
    """Internal: (key, value) → one object tuple per row, feeding
    JSON_OBJECTAGG through the single-arg aggregate pipeline. A NULL key
    is an error (MySQL ER 3158); a NULL value rides as JSON null."""
    from tidb_tpu_torch.expression.aggfuncs import _json_value
    kv, km = func.args[0].eval(ctx)
    vv, vm = func.args[1].eval(ctx)
    n = ctx.num_rows
    kv = np.asarray(kv)
    km = np.asarray(km, dtype=bool)
    vv = np.asarray(vv)
    vm = np.asarray(vm, dtype=bool)
    if not km.all():
        raise ExecutionError(
            "JSON documents may not contain NULL member names")
    out = np.empty(n, dtype=object)
    kft, vft = func.args[0].ftype, func.args[1].ftype
    for i in range(n):
        val = _json_value(vv[i], vft) if vm[i] else None
        # keys decode through their FieldType (dates/decimals/enums must
        # not leak their internal encodings), then stringify like MySQL
        k = _json_value(kv[i], kft)
        out[i] = (str(k), val)
    return out, km

"""A numpy-surface array namespace over torch tensors on one device.

The expression evaluator, the aggregate states and the emit layer are
written against an array namespace `xp`: numpy on the host engine, and
(in the JAX package) jax.numpy inside traced fragments. The port keeps
that design and supplies `TorchXP(device)` — the subset of the numpy
surface those modules call, implemented with torch ops on the engine's
device. Arrays created by the namespace land on that device; numpy dtypes
passed in map to torch dtypes.

Two numpy habits have no torch counterpart and go through functions
here: `astype(v, dtype)` (torch tensors have no `.astype`) and
`torch_dtype` / `numpy_dtype` (the dtype objects differ).
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype / python type / torch dtype → torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    if dt is bool:
        return torch.bool
    if dt is int:
        return torch.int64
    if dt is float:
        return torch.float64
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except KeyError:
        raise TypeError(f"no torch dtype for {dt!r}") from None


def numpy_dtype(dt) -> np.dtype:
    """torch dtype / numpy dtype → numpy dtype."""
    if isinstance(dt, torch.dtype):
        return _TORCH_TO_NP[dt]
    return np.dtype(dt)



def astype(v, dt, copy: bool = True):
    """`v.astype(dt)` for numpy arrays AND torch tensors (C-style
    truncation toward zero for float → int, as numpy)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch_dtype(dt))
    return v.astype(dt, copy=copy)


def _scalar(x):
    """numpy scalars → python scalars (torch ops take python numbers)."""
    if isinstance(x, np.generic):
        return x.item()
    return x



class TorchXP:
    """numpy-like namespace whose arrays are torch tensors on `device`."""

    bool_ = torch.bool
    int32 = torch.int32
    int64 = torch.int64
    float64 = torch.float64

    def __init__(self, device):
        self.device = torch.device(device)

    def __repr__(self):
        return f"TorchXP({self.device})"

    # -- construction --------------------------------------------------------
    def asarray(self, a, dtype=None):
        if isinstance(a, torch.Tensor):
            t = a if a.device == self.device else a.to(self.device)
        else:
            arr = np.asarray(a)
            if arr.dtype == np.dtype(object):
                raise TypeError("object arrays have no device form")
            if arr.dtype.kind == "u" and arr.dtype.itemsize >= 4:
                arr = arr.astype(np.int64)
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return t

    def zeros(self, n, dtype=None):
        return torch.zeros(n, dtype=torch_dtype(dtype or np.float64),
                           device=self.device)

    def ones(self, n, dtype=None):
        return torch.ones(n, dtype=torch_dtype(dtype or np.float64),
                          device=self.device)

    def full(self, n, fill, dtype=None):
        if isinstance(fill, torch.Tensor):
            dt = torch_dtype(dtype) if dtype is not None else fill.dtype
            return fill.to(self.device, dt).reshape(()).expand(
                n if isinstance(n, tuple) else (n,)).clone()
        fill = _scalar(fill)
        if dtype is None:
            dt = torch.bool if isinstance(fill, bool) else (
                torch.int64 if isinstance(fill, int) else torch.float64)
        else:
            dt = torch_dtype(dtype)
        return torch.full(n if isinstance(n, tuple) else (n,), fill,
                          dtype=dt, device=self.device)

    def zeros_like(self, a, dtype=None):
        return torch.zeros_like(
            a, dtype=None if dtype is None else torch_dtype(dtype))

    def ones_like(self, a, dtype=None):
        return torch.ones_like(
            a, dtype=None if dtype is None else torch_dtype(dtype))

    def full_like(self, a, fill, dtype=None):
        return torch.full_like(
            a, _scalar(fill), dtype=None if dtype is None else
            torch_dtype(dtype))

    def arange(self, start, stop=None, step=1, dtype=None):
        if stop is None:
            start, stop = 0, start
        return torch.arange(_scalar(start), _scalar(stop), _scalar(step),
                            dtype=torch_dtype(dtype or np.int64),
                            device=self.device)

    # -- elementwise ---------------------------------------------------------
    def where(self, cond, a, b):
        cond = self._t(cond)
        a, b = _scalar(a), _scalar(b)
        if not isinstance(a, torch.Tensor) and \
                not isinstance(b, torch.Tensor):
            a = torch.tensor(a, device=self.device)
        return torch.where(cond, a, b)

    def clip(self, a, lo, hi):
        return torch.clamp(self._t(a), _scalar(lo), _scalar(hi))

    def abs(self, a):
        return torch.abs(self._t(a))

    def sign(self, a):
        return torch.sign(self._t(a))

    def floor(self, a):
        return torch.floor(self._t(a))

    def ceil(self, a):
        return torch.ceil(self._t(a))

    def trunc(self, a):
        return torch.trunc(self._t(a))

    # float math: numpy's dtype results (an integer input computes in
    # float64, as numpy's ufuncs do; torch would pick float32)
    def sqrt(self, a):
        return torch.sqrt(self._f(a))

    def exp(self, a):
        return torch.exp(self._f(a))

    def log(self, a):
        return torch.log(self._f(a))

    def log2(self, a):
        return torch.log2(self._f(a))

    def log10(self, a):
        return torch.log10(self._f(a))

    def sin(self, a):
        return torch.sin(self._f(a))

    def cos(self, a):
        return torch.cos(self._f(a))

    def tan(self, a):
        return torch.tan(self._f(a))

    def arcsin(self, a):
        return torch.asin(self._f(a))

    def arccos(self, a):
        return torch.acos(self._f(a))

    def arctan(self, a):
        return torch.atan(self._f(a))

    def arctan2(self, a, b):
        return torch.atan2(self._f(a), self._f(b))

    def power(self, a, b):
        a, b = self._t(a), self._t(b)
        if a.dtype.is_floating_point or b.dtype.is_floating_point:
            a, b = self._f(a), self._f(b)
        return torch.pow(a, b)

    def maximum(self, a, b):
        return torch.maximum(*self._pair(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._pair(a, b))

    # -- gathers / reshaping -------------------------------------------------
    def take(self, a, idx, axis=None):
        a = self._t(a)
        idx = self._t(idx)
        if idx.dtype not in (torch.int64, torch.int32):
            idx = idx.to(torch.int64)
        if axis == -1 and a.dim() > 1:
            return a[..., idx]
        return a[idx]

    def concatenate(self, arrays, axis=0):
        return torch.cat([self._t(a) for a in arrays], dim=axis)

    def searchsorted(self, sorted_seq, v, side="left", method=None):
        """Insertion points (int64). On the card integer tables go through
        K11 (ops/join.py searchsorted), as in int64; other dtypes raise."""
        from tidb_tpu_torch.ops.join import searchsorted
        a, b = self._t(sorted_seq), self._t(v)
        if a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        if a.device.type != "cpu" and not a.dtype.is_floating_point and \
                a.dtype != torch.bool:
            a, b = a.to(torch.int64), b.to(torch.int64)
        return searchsorted(a, b, right=(side == "right"))

    # -- helpers -------------------------------------------------------------
    def _t(self, a):
        if isinstance(a, torch.Tensor):
            return a
        return self.asarray(a)

    def _f(self, a):
        a = self._t(a)
        return a if a.dtype.is_floating_point else a.to(torch.float64)

    def _pair(self, a, b):
        """Two operands promoted to one dtype, as numpy's binary ufuncs."""
        a, b = self._t(a), self._t(b)
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)



def to_device_tree(xp: TorchXP, tree):
    """Host preparations (numpy arrays / scalars, nested in lists and
    tuples) → the same structure with arrays as tensors on xp's device
    and numpy scalars as python scalars."""
    if isinstance(tree, np.ndarray):
        return xp.asarray(tree)
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device_tree(xp, t) for t in tree)
    return tree


__all__ = ["TorchXP", "astype", "torch_dtype", "numpy_dtype",
           "to_device_tree"]

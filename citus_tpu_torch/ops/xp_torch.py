"""A numpy-style array namespace over torch tensors on one device.

``planner/bound.py`` compiles an expression tree against an ``xp``
namespace: numpy for the host oracle, this module's
:class:`TorchNamespace` for the device path.  It implements the ~20
functions those bodies call (``where``, ``clip``, ``floor``, ...), plus
the three helpers the port added in place of numpy's scalar methods:
``astype`` (``.astype``), ``const`` (``dtype.type(x)``) and ``truediv``
(``/``).

Type promotion follows the JAX reference with 64-bit types on, which
differs from torch's own rules in two places:

- a numpy scalar is a *strongly typed* constant in JAX (``int32 array *
  np.int64(5)`` is int64), while torch gives a 0-d tensor the lower
  priority (the product stays int32).  ``const`` and ``asarray``
  therefore make every typed constant a one-element 1-d tensor, which
  torch promotes like any other tensor.  Python scalars stay Python
  scalars: they are weak in both frameworks.
- true division of two integer tensors is float64 in JAX and numpy,
  but torch's default float type (float32); ``truediv`` divides in
  float64 when neither side is a float tensor.

``astype`` from a float to an integer type saturates and maps NaN to 0,
as XLA does; torch on the CPU (like numpy) gives the type's minimum.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype (or scalar type, or Python ``bool``) -> torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return _TORCH_DTYPES[np.dtype(dt)]


def _py_dtype(x) -> torch.dtype:
    """numpy's default dtype for a Python scalar."""
    if isinstance(x, (bool, np.bool_)):
        return torch.bool
    if isinstance(x, (int, np.integer)):
        return torch.int64
    return torch.float64


class TorchNamespace:
    """numpy-compatible functions on tensors of ``device``."""

    __name__ = "torch"

    def __init__(self, device):
        self.device = torch.device(device)

    # ---- conversion ----------------------------------------------------
    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (bool, int, float)):
            return torch.tensor([x], dtype=_py_dtype(x), device=self.device)
        a = np.asarray(x)
        if a.ndim == 0:
            a = a.reshape(1)  # a strongly typed constant, see module doc
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _operand(self, x):
        """Tensor or weak Python scalar, the two forms torch ops take."""
        if isinstance(x, torch.Tensor) or type(x) in (bool, int, float):
            return x
        return self.asarray(x)

    def const(self, value, dt):
        return torch.tensor([value], dtype=torch_dtype(dt),
                            device=self.device)

    def astype(self, v, dt):
        v, t = self.asarray(v), torch_dtype(dt)
        if v.is_floating_point() and not t.is_floating_point \
                and t != torch.bool:
            return _float_to_int(v, t)
        return v.to(t)

    def truediv(self, a, b):
        a, b = self._operand(a), self._operand(b)
        if not (_is_float_tensor(a) or _is_float_tensor(b)):
            a = self.asarray(a).to(torch.float64)
        return a / b

    # ---- elementwise ---------------------------------------------------
    def where(self, cond, a, b):
        cond, a, b = self._operand(cond), self._operand(a), self._operand(b)
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = torch.tensor(a, dtype=_py_dtype(a), device=self.device)
        return torch.where(cond, a, b)

    def clip(self, x, lo=None, hi=None):
        return torch.clamp(self._operand(x), min=lo, max=hi)

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def sign(self, x):
        return torch.sign(self.asarray(x))

    def abs(self, x):
        return torch.abs(self.asarray(x))

    def floor(self, x):
        return torch.floor(self.asarray(x))

    def ceil(self, x):
        return torch.ceil(self.asarray(x))

    def round(self, x):
        return torch.round(self.asarray(x))  # half to even, as numpy

    def trunc(self, x):
        return torch.trunc(self.asarray(x))

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def exp(self, x):
        return torch.exp(self.asarray(x))

    def log(self, x):
        return torch.log(self.asarray(x))

    def log10(self, x):
        return torch.log10(self.asarray(x))

    def log2(self, x):
        return torch.log2(self.asarray(x))

    def power(self, a, b):
        return torch.pow(self.asarray(a), self.asarray(b))

    # ---- construction --------------------------------------------------
    def zeros_like(self, x, dtype=None):
        x = self.asarray(x)
        return torch.zeros_like(
            x, dtype=None if dtype is None else torch_dtype(dtype))

    def ones_like(self, x, dtype=None):
        x = self.asarray(x)
        return torch.ones_like(
            x, dtype=None if dtype is None else torch_dtype(dtype))

    def full(self, shape, value, dtype=None):
        if isinstance(value, torch.Tensor):
            out = value.reshape(()).expand(tuple(shape)).clone()
            return out if dtype is None else out.to(torch_dtype(dtype))
        if dtype is None:
            dtype = (_py_dtype(value) if type(value) in (bool, int, float)
                     else np.asarray(value).dtype)
        if isinstance(value, np.generic):
            value = value.item()
        return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                          device=self.device)

    def zeros(self, shape, dtype=np.float64):
        if isinstance(shape, int):
            shape = (shape,)
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                           device=self.device)


def _float_to_int(v: torch.Tensor, t: torch.dtype) -> torch.Tensor:
    """Float -> integer conversion as XLA does it (and the card's
    ``cvt.rzi``): truncation, saturating at the type's bounds, NaN -> 0.
    torch on the CPU gives the type's minimum for NaN and out-of-range
    values instead."""
    info = torch.iinfo(t)
    w = v.to(torch.float64)
    hi = 2.0 ** (info.bits - 1)
    out = torch.where((w >= -hi) & (w < hi), w, 0.0).to(t)
    out = torch.where(w >= hi, info.max, out)
    return torch.where(w < -hi, info.min, out)


def _is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()

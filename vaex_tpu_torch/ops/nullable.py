"""NA — nullable tensor, the unit of data inside a pass.

``data`` is a torch tensor and ``mask`` an optional bool tensor (True ==
missing, numpy.ma convention).  Expression operators and registered
functions compute on NA values tile by tile, propagating the mask.  NaN and
null are distinct: NaN lives in ``data``, null lives in ``mask``.

Torch promotes differently from numpy in two places the expression engine
meets, and both are mapped to numpy's result here:

* a Python float against an integer tensor gives float32 in torch; it is
  passed as a 0-dim float64 tensor, which gives float64 as in numpy;
* true division of two integer tensors gives float32 in torch; the left
  operand is widened to float64 first.
"""

from __future__ import annotations

import operator

import numpy as np
import torch


class NA:
    """data + optional validity. Immutable."""

    __slots__ = ("data", "mask")
    __array_priority__ = 100  # beat numpy operator dispatch

    def __init__(self, data, mask=None):
        self.data = data
        self.mask = mask

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        return f"NA({self.data!r}, mask={self.mask!r})"

    def maskarray(self):
        """Always-materialized mask (False where no mask)."""
        if self.mask is None:
            return torch.zeros(self.data.shape, dtype=torch.bool, device=self.data.device)
        return self.mask


def _mask_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def as_operand(x):
    """Plain (non-NA) operand of a tensor op, with numpy's promotion of
    Python floats (see the module docstring)."""
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64)
    if isinstance(x, (list, tuple, np.ndarray)):
        return torch.as_tensor(np.asarray(x))
    return x


def lift(op, *args):
    """Apply op to the .data of NA/plain args, OR-combining masks."""
    datas = []
    mask = None
    for a in args:
        if isinstance(a, NA):
            datas.append(a.data)
            mask = _mask_or(mask, a.mask)
        else:
            datas.append(as_operand(a))
    return NA(op(*datas), mask)


def _is_integral(x):
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, (bool, int))


def _truediv(a, b):
    if _is_integral(a) and _is_integral(b):
        a = a.to(torch.float64) if isinstance(a, torch.Tensor) else float(a)
    return operator.truediv(a, b)


def _binop(op, reflected=False):
    def method(self, other):
        if reflected:
            return lift(lambda a, b: op(b, a), self, other)
        return lift(op, self, other)
    return method


def _install_operators():
    ops = {
        "add": operator.add, "sub": operator.sub, "mul": operator.mul,
        "truediv": _truediv, "floordiv": operator.floordiv,
        "mod": operator.mod, "pow": operator.pow,
        "and": operator.and_, "or": operator.or_, "xor": operator.xor,
        "lshift": operator.lshift, "rshift": operator.rshift,
        "lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
        "matmul": operator.matmul,
    }
    for name, op in ops.items():
        setattr(NA, f"__{name}__", _binop(op))
        if name not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(NA, f"__r{name}__", _binop(op, reflected=True))
    NA.__neg__ = lambda self: NA(-self.data, self.mask)
    NA.__pos__ = lambda self: NA(+self.data, self.mask)
    NA.__abs__ = lambda self: NA(torch.abs(self.data), self.mask)
    NA.__invert__ = lambda self: NA(~self.data, self.mask)


_install_operators()

"""The expression-namespace functions, with ``vaex_tpu``'s semantics (NaN
and null are distinct; a result is missing where any argument is):

* the numpy-named math of ``vaex_tpu/functions.py:78-126`` (31 unary and 8
  binary ufuncs, ``round``, ``clip``, ``searchsorted``, ``digitize``), one
  table from the numpy name to a torch function, applied through
  :func:`~vaex_tpu_torch.ops.nullable.lift`.  The result dtype is numpy's:
  the arguments are cast to ``numpy.result_type`` of their dtypes (a Python
  number is weak, as in numpy 2), and a function whose result is a float
  computes an int or bool argument in float64 (numpy gives float16 for
  bool and int8, float32 for int16; the port widens those to float64 too);
* the NaN / null helpers (``isnan``, ``ismissing``, ``isna``, ``notna``,
  ``isfinite``, ``isinf``, ``fillmissing``, ``fillnan``, ``fillna``),
  ``astype``, ``where``, ``abs`` and ``pnpoly`` (the crossing-number
  point-in-polygon test of ``select_lasso``);
* the set-based internals ``_ordinal_values``, ``isin_set`` and
  ``_choose``, whose set argument is a variable the scope resolves to a
  :class:`~vaex_tpu_torch.ops.setops.DeviceSetHandle`.

Arithmetic and comparisons are the operators of
:class:`~vaex_tpu_torch.ops.nullable.NA`.  Where torch and numpy differ,
numpy's answer is kept: ``sign(nan)`` is NaN (torch gives 0), ``digitize``
takes decreasing bins, an int ``fmod`` by 0 gives 0 and an int ``power``
with a negative exponent raises, as numpy does; torch has no ``cbrt`` and
no ``rint`` (:func:`_cbrt`; ``rint`` is ``torch.round``, half to even).
"""

from __future__ import annotations

import numpy as np
import torch

from .datatype import _TORCH_TO_NUMPY, torch_dtype
from .ops import setops
from .ops.nullable import (NA, TEMPORAL_PENDING, UINT64, UNSIGNED_PENDING, as_operand, lift,
                           refuse_temporal, unsigned_float)
from .registry import register_function


def _na(x):
    return x if isinstance(x, NA) else NA(torch.as_tensor(as_operand(x)))


def _ismissing(x):
    return NA(_na(x).maskarray())


def _isnan(x):
    x = _na(x)
    if x.data.is_floating_point():
        nan = torch.isnan(x.data)
        return NA(nan if x.mask is None else nan & ~x.mask)
    return NA(torch.zeros(x.shape, dtype=torch.bool, device=x.data.device))


def _isna(x):
    return NA(_isnan(x).data | _ismissing(x).data)


def _notna(x):
    return NA(~_isna(x).data)


def _where(cond, a, b):
    logical = {v.logical for v in (a, b) if isinstance(v, NA)} - {None}
    if logical and (len(logical) > 1 or not all(isinstance(v, NA) for v in (a, b))):
        refuse_temporal("where", a, b)
    datas = []
    mask = None
    for v in (cond, a, b):
        if isinstance(v, NA):
            datas.append(v.data)
            if v.mask is not None:
                mask = v.mask if mask is None else mask | v.mask
        else:
            datas.append(as_operand(v))
    return NA(torch.where(*datas), mask, logical.pop() if logical else None)


def _float_to_int(data, target):
    """A float tensor as the integer type ``target``: NaN becomes 0 and a
    value outside the type's range its nearest end, on every device (a bare
    ``.to`` gives the minimum for all of them on the CPU and saturates on
    CUDA)."""
    info = torch.iinfo(target)
    # in the float type the largest value that still fits is the last one
    # below 2^bits: float(info.max) rounds up to it
    high = data >= float(info.max)
    low = data <= float(info.min)
    out = torch.where(high | low | torch.isnan(data), 0, data).to(target)
    out = torch.where(high, info.max, out)
    return torch.where(low, info.min, out)


def _astype_unsigned(x, dtype):
    """astype from or to uint64: to float the unsigned value, to int64 or
    from an int the same bits (numpy wraps alike), to uint64 itself."""
    if x.logical == UINT64:
        if dtype == UINT64:
            return x
        if dtype.kind == "f":
            return NA(unsigned_float(x.data).to(torch_dtype(dtype)), x.mask)
        if dtype == np.int64:
            return NA(x.data, x.mask)
    elif not x.data.is_floating_point() and x.logical is None:
        return NA(x.data.to(torch.int64), x.mask, UINT64)
    raise NotImplementedError(f"astype of a {x.logical or x.dtype} value to {dtype} is "
                              f"{UNSIGNED_PENDING}")


def _astype(x, dtype):
    """numpy's ``astype``: a datetime or timedelta as an int or float is its
    epoch count; an int column becomes a temporal dtype by its count; a
    temporal value keeps only its own dtype."""
    x = _na(x)
    if x.logical == UINT64 or np.dtype(dtype) == UINT64:
        return _astype_unsigned(x, np.dtype(dtype))
    if np.dtype(dtype).kind in "Mm":
        if x.logical == np.dtype(dtype):
            return x
        if x.logical is not None or x.data.is_floating_point():
            raise NotImplementedError(f"astype of a {x.logical or x.dtype} value to {dtype} "
                                      f"is {TEMPORAL_PENDING}")
        return NA(x.data.to(torch.int64), x.mask, dtype)
    target = torch_dtype(dtype)
    if x.data.is_floating_point() and not target.is_floating_point and target != torch.bool:
        return NA(_float_to_int(x.data, target), x.mask)
    return NA(x.data.to(target), x.mask)


def _abs(x):
    return abs(_na(x))


register_function(name="ismissing", device=_ismissing)(None)
register_function(name="isnan", device=_isnan)(None)
register_function(name="isna", device=_isna)(None)
register_function(name="notna", device=_notna)(None)
register_function(name="where", device=_where)(None)
register_function(name="astype", device=_astype)(None)
register_function(name="abs", device=_abs)(None)


def _ordinal_values(x, oset):
    """The ordinal of each value in the set (int32; -1 for a value that is
    not in it)."""
    return NA(setops.device_map_ordinal(oset, _na(x)))


def _isin_set(x, oset):
    return NA(setops.device_isin(oset, _na(x)))


def _choose(codes, choices):
    """``choices[codes]``; codes outside the table, and masked codes, give a
    missing value."""
    codes = _na(codes)
    table = choices.data if isinstance(choices, NA) else torch.as_tensor(as_operand(choices))
    table = table.to(codes.data.device)
    oob = (codes.data < 0) | (codes.data >= table.shape[0])
    safe = codes.data.clamp(0, max(table.shape[0] - 1, 0)).to(torch.int64)
    return NA(table[safe], oob if codes.mask is None else codes.mask | oob)


register_function(name="_ordinal_values", device=_ordinal_values)(None)
register_function(name="isin_set", device=_isin_set)(None)
register_function(name="_choose", device=_choose)(None)


# ---------------------------------------------------------------------------
# numpy-named math (vaex_tpu/functions.py:78-126, 176-226)


def _numpy_type(a):
    """What ``numpy.result_type`` takes for an argument: the numpy dtype of
    a tensor, a Python number as it is (weak)."""
    if isinstance(a, NA):
        a = a.data
    if isinstance(a, torch.Tensor):
        return _TORCH_TO_NUMPY[a.dtype]
    if isinstance(a, (list, tuple)):
        return np.asarray(a).dtype
    return a


def _result_dtype(args, inexact=False):
    """numpy's result dtype of ``args`` as a torch dtype; with ``inexact`` a
    float (an int or bool result becomes float64).  A float narrower than
    float32 (numpy 1's value-based promotion of a small int) becomes
    float64."""
    dt = np.result_type(*[_numpy_type(a) for a in args])
    if (inexact and dt.kind != "f") or (dt.kind == "f" and dt.itemsize < 4):
        dt = np.dtype("float64")
    return torch_dtype(dt)


def _device(args):
    for a in args:
        data = a.data if isinstance(a, NA) else a
        if isinstance(data, torch.Tensor):
            return data.device
    return torch.device("cpu")


def _operands(args, dtype):
    """``args`` as NA values of ``dtype`` on one device (a Python number as
    a 0-dim tensor there)."""
    refuse_temporal("this function", *args)
    device = _device(args)
    out = []
    for a in args:
        if isinstance(a, NA):
            out.append(NA(a.data.to(dtype), a.mask))
        elif isinstance(a, torch.Tensor):
            out.append(NA(a.to(device=device, dtype=dtype)))
        else:
            out.append(NA(torch.as_tensor(np.asarray(a), device=device).to(dtype)))
    return out


def _elementwise(op, inexact=False):
    """A registered function: ``op`` of the tensors of its arguments, cast to
    their numpy result dtype (a float one with ``inexact``), masks OR-ed."""
    def impl(*args):
        return lift(op, *_operands(args, _result_dtype(args, inexact)))
    return impl


def _cbrt(x):
    """The real cube root.  ``|x| ** (1/3)`` is off by up to tens of ulp at
    the ends of the range (1/3 is not a float), so one Newton step follows,
    written so that no term overflows; then an exact cube's root is made
    exact.  A float32 column is computed in float64 and rounded once."""
    if x.dtype != torch.float64:
        return _cbrt(x.to(torch.float64)).to(x.dtype)
    r = torch.copysign(torch.abs(x) ** (1.0 / 3.0), x)
    finite = torch.isfinite(r) & (r != 0)
    safe = torch.where(finite, r, 1.0)
    r = torch.where(finite, safe - (safe - x / (safe * safe)) / 3, r)
    whole = torch.round(r)
    return torch.where(whole * whole * whole == x, whole, r)


def _sign(x):
    if x.dtype == torch.bool:
        raise TypeError("sign of a bool column: numpy has no such loop")
    out = torch.sign(x)
    return torch.where(torch.isnan(x), x, out) if x.is_floating_point() else out


def _power(a, b):
    if not (a.is_floating_point() or b.is_floating_point()) and bool((b < 0).any()):
        raise ValueError("Integers to negative integer powers are not allowed.")
    return torch.pow(a, b)


def _fmod(a, b):
    if a.is_floating_point():
        return torch.fmod(a, b)
    zero = b == 0  # numpy gives 0 where torch raises or leaves garbage
    return torch.where(zero, 0, torch.fmod(a, torch.where(zero, 1, b)))


# numpy name -> torch function of a float tensor; an int or bool input is
# computed in float64
_FLOAT_UNARY = {
    "arccos": torch.arccos, "arccosh": torch.arccosh, "arcsin": torch.arcsin,
    "arcsinh": torch.arcsinh, "arctan": torch.arctan, "arctanh": torch.arctanh,
    "cos": torch.cos, "cosh": torch.cosh, "deg2rad": torch.deg2rad, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "rad2deg": torch.rad2deg, "sin": torch.sin, "sinc": torch.sinc, "sinh": torch.sinh,
    "sqrt": torch.sqrt, "tan": torch.tan, "tanh": torch.tanh, "floor": torch.floor,
    "ceil": torch.ceil, "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "exp2": torch.exp2, "log2": torch.log2, "rint": torch.round, "cbrt": _cbrt,
}
_FLOAT_BINARY = {"arctan2": torch.atan2, "hypot": torch.hypot, "copysign": torch.copysign,
                 "logaddexp": torch.logaddexp}
# computed in the arguments' result dtype
_SAME_UNARY = {"sign": _sign, "isfinite": torch.isfinite, "isinf": torch.isinf}
_SAME_BINARY = {"maximum": torch.maximum, "minimum": torch.minimum, "power": _power,
                "fmod": _fmod}

for _name, _op in {**_FLOAT_UNARY, **_FLOAT_BINARY}.items():
    register_function(name=_name, device=_elementwise(_op, inexact=True))(None)
for _name, _op in {**_SAME_UNARY, **_SAME_BINARY}.items():
    register_function(name=_name, device=_elementwise(_op))(None)


def _round(x, decimals=0):
    """numpy's round: half to even; an int column as it is, or rounded to a
    power of ten for negative ``decimals``; a bool column as float64."""
    x = _na(x)
    refuse_temporal("round", x)
    data = x.data
    if data.dtype == torch.bool:
        data = data.to(torch.float64)
    if data.is_floating_point():
        return NA(torch.round(data, decimals=decimals), x.mask)
    if decimals >= 0:
        return NA(data, x.mask)
    scale = 10.0 ** -decimals
    return NA((torch.round(data.to(torch.float64) / scale) * scale).to(data.dtype), x.mask)


def _clip(x, a_min=None, a_max=None):
    bounds = [b for b in (a_min, a_max) if b is not None]
    x = _operands([x], _result_dtype([x] + bounds))[0]
    return NA(torch.clamp(x.data, a_min, a_max), x.mask)


def _host_list(values):
    """A polygon or bins argument (a list, an array, a tensor variable) as a
    host float64 array."""
    if isinstance(values, NA):
        values = values.data
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    return np.asarray(values, dtype=np.float64)


def _sorted_array(values, dtype, device):
    if isinstance(values, NA):
        values = values.data
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    return values.to(device=device, dtype=dtype)


def _search(boundaries, q, right):
    """numpy's searchsorted of ``q`` in the ascending ``boundaries``: NaN sorts
    after every number, so a NaN query lands at the first NaN boundary
    ("left") or at the end ("right")."""
    out = torch.searchsorted(boundaries, q, right=right)
    if not q.is_floating_point():
        return out
    end = boundaries.numel() if right else int((~torch.isnan(boundaries)).sum())
    return torch.where(torch.isnan(q), end, out)


def _searchsorted(ar, values, side="left"):
    """The insertion points of the column ``ar`` in the sorted ``values``
    (the arguments are in the opposite order to numpy's, as
    vaex_tpu/functions.py:105-116 has them)."""
    ar = _na(ar)
    dtype = _result_dtype([ar, values])
    boundaries = _sorted_array(values, dtype, ar.data.device)
    return NA(_search(boundaries, ar.data.to(dtype), side == "right"), ar.mask)


def _digitize(x, bins, right=False):
    """numpy's digitize: the bin of each value among increasing or
    decreasing ``bins`` (checked on the host)."""
    x = _na(x)
    dtype = _result_dtype([x, bins])
    boundaries = _sorted_array(bins, dtype, x.data.device)
    step = np.diff(_host_list(bins))
    if (step >= 0).all():
        return NA(_search(boundaries, x.data.to(dtype), not right), x.mask)
    if not (step <= 0).all():
        raise ValueError("bins must be monotonically increasing or decreasing")
    flipped = _search(boundaries.flip(0), x.data.to(dtype), not right)
    return NA(boundaries.numel() - flipped, x.mask)


def _fillmissing(x, value):
    """Missing values replaced by ``value`` cast to the column's dtype."""
    x = _na(x)
    if x.mask is None:
        return x
    refuse_temporal("fillmissing", x)
    fill = torch.as_tensor(np.asarray(value)).to(device=x.data.device, dtype=x.dtype)
    return NA(torch.where(x.mask, fill, x.data))


def _fillnan(x, value):
    x = _na(x)
    if not x.data.is_floating_point():
        return x
    fill = torch.as_tensor(np.asarray(value)).to(device=x.data.device, dtype=x.dtype)
    return NA(torch.where(torch.isnan(x.data), fill, x.data), x.mask)


def _fillna(x, value):
    return _fillnan(_fillmissing(x, value), value)


def _pnpoly(x, y, xs, ys):
    """True where (x, y) lies inside the polygon of vertices (xs, ys), by the
    crossing rule of vaex_tpu/functions.py:561-600 in float64 (a horizontal
    edge divides by 1e-300); a row where x or y is missing is outside."""
    x, y = _na(x), _na(y)
    xs, ys = _host_list(xs).tolist(), _host_list(ys).tolist()
    xd, yd = x.data.to(torch.float64), y.data.to(torch.float64)
    inside = torch.zeros(xd.shape, dtype=torch.bool, device=xd.device)
    j = len(xs) - 1
    for i in range(len(xs)):
        x0, y0, x1, y1 = xs[j], ys[j], xs[i], ys[i]
        denom = (y0 - y1) or 1e-300
        inside ^= ((y1 > yd) != (y0 > yd)) & (xd < (x0 - x1) * (yd - y1) / denom + x1)
        j = i
    for mask in (x.mask, y.mask):
        if mask is not None:
            inside &= ~mask
    return NA(inside)


register_function(name="round", device=_round)(None)
register_function(name="clip", device=_clip)(None)
register_function(name="searchsorted", device=_searchsorted)(None)
register_function(name="digitize", device=_digitize)(None)
register_function(name="fillmissing", device=_fillmissing)(None)
register_function(name="fillnan", device=_fillnan)(None)
register_function(name="fillna", device=_fillna)(None)
register_function(name="pnpoly", device=_pnpoly)(None)

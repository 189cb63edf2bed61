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

from . import array_types
from .datatype import _TORCH_TO_NUMPY, TOP, torch_dtype
from .ops import setops
from .ops.nullable import (NA, UINT64, DictNA, HostStage, as_operand, lift, refuse_temporal,
                           unsigned_divmod, unsigned_float, unsigned_pow)
from .registry import expression_namespace, expression_namespace_host, register_function


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
    if _has_unsigned((a, b)):  # numpy's dtype of the pair: uint64 bits or float64
        cond = _na(cond)
        dtype, (a, b) = _unsigned_operands((a, b))
        mask = _mask_or_all([cond, a, b])
        return NA(torch.where(cond.data.to(torch.bool), a.data, b.data), mask, dtype)
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
    """astype from or to uint64, as numpy casts: to a float the unsigned
    value, to a signed int or bool the low bits (numpy wraps alike), from an
    int the same bits, from a float its value's bits (NaN and what lies
    outside [0, 2^64) as 0), to uint64 itself."""
    if x.logical == UINT64:
        if dtype == UINT64:
            return x
        if dtype.kind == "f":
            return NA(unsigned_float(x.data).to(torch_dtype(dtype)), x.mask)
        if dtype.kind in "ib":
            return NA(x.data != 0 if dtype.kind == "b" else x.data.to(torch_dtype(dtype)),
                      x.mask)
    elif x.logical is None and x.data.is_floating_point():
        f = x.data.to(torch.float64)
        ok = (f >= 0) & (f < 2.0 ** 64)
        f = torch.where(ok, f, 0.0)
        high = f >= 2.0 ** 63
        bits = torch.where(high, (f - 2.0 ** 64).trunc(), f.trunc()).to(torch.int64)
        return NA(bits, x.mask, UINT64)
    elif x.logical is None:
        return NA(x.data.to(torch.int64), x.mask, UINT64)
    raise TypeError(f"astype of a {x.logical or x.dtype} value to {dtype}: the port keeps "
                    f"no narrower unsigned type in an expression")


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
            raise HostStage(f"astype of a {x.logical or x.dtype} value to {dtype} runs in "
                            f"the host stage")
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
    missing value; string choices (an arrow array) make strings, the codes
    their dictionary codes."""
    codes = _na(codes)
    if array_types.is_arrow(choices):
        oob = (codes.data < 0) | (codes.data >= len(choices))
        mask = oob if codes.mask is None else codes.mask | oob
        return DictNA(codes.data.masked_fill(mask, 0).to(torch.int32), mask, choices)
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
    a tensor (uint64 for a uint64 value), a Python number as it is (weak)."""
    if isinstance(a, NA):
        if a.logical == UINT64:
            return UINT64
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
    refuse_temporal("this function", *(a for a in args
                                        if not (isinstance(a, NA) and a.logical == UINT64)))
    device = _device(args)
    out = []
    for a in args:
        if isinstance(a, NA) and a.logical == UINT64:  # its unsigned value
            data = unsigned_float(a.data) if dtype.is_floating_point else a.data
            out.append(NA(data.to(dtype), a.mask))
        elif isinstance(a, NA):
            out.append(NA(a.data.to(dtype), a.mask))
        elif isinstance(a, torch.Tensor):
            out.append(NA(a.to(device=device, dtype=dtype)))
        else:
            out.append(NA(torch.as_tensor(np.asarray(a), device=device).to(dtype)))
    return out


def _elementwise(op, inexact=False, unsigned=None):
    """A registered function: ``op`` of the tensors of its arguments, cast to
    their numpy result dtype (a float one with ``inexact``), masks OR-ed;
    where that dtype is uint64, ``unsigned`` of their bits."""
    def impl(*args):
        if _has_unsigned(args) and not inexact:
            dtype, operands = _unsigned_operands(args)
            if dtype == UINT64:
                value = unsigned(*(a.data for a in operands))
                return NA(value, _mask_or_all(operands),
                          UINT64 if value.dtype == torch.int64 else None)
            return lift(op, *operands)
        return lift(op, *_operands(args, _result_dtype(args, inexact)))
    return impl


def _has_unsigned(args):
    return any(isinstance(a, NA) and a.logical == UINT64 for a in args)


def _mask_or_all(values):
    mask = None
    for v in values:
        if isinstance(v, NA) and v.mask is not None:
            mask = v.mask if mask is None else mask | v.mask
    return mask


def _unsigned_operands(args):
    """(numpy's result dtype, the arguments as NA values of it) where one is
    a uint64 value: uint64 (their bits: a bool's 0 or 1, a Python int's
    two's complement) or a float (a uint64's unsigned value)."""
    dtype = np.result_type(*[_numpy_type(a) for a in args])
    device = _device(args)
    out = []
    for a in args:
        unsigned = isinstance(a, NA) and a.logical == UINT64
        if isinstance(a, NA):
            data, mask = a.data, a.mask
        else:
            value = np.asarray(a)
            if dtype == UINT64 and value.dtype.kind in "iu":
                value = value.astype(np.uint64).view(np.int64)
            data, mask = torch.as_tensor(value, device=device), None
        if dtype == UINT64:
            data = data.to(torch.int64)
        else:
            data = (unsigned_float(data) if unsigned else data).to(torch_dtype(dtype))
        out.append(NA(data, mask))
    return (UINT64 if dtype == UINT64 else None), out


def _umax(a, b):
    return torch.where((a ^ TOP) >= (b ^ TOP), a, b)


def _umin(a, b):
    return torch.where((a ^ TOP) <= (b ^ TOP), a, b)


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
# computed in the arguments' result dtype; where that is uint64, on the
# bits by the second function
_SAME_UNARY = {"sign": (_sign, lambda a: (a != 0).to(torch.int64)),
               "isfinite": (torch.isfinite, lambda a: torch.ones_like(a, dtype=torch.bool)),
               "isinf": (torch.isinf, lambda a: torch.zeros_like(a, dtype=torch.bool))}
_SAME_BINARY = {"maximum": (torch.maximum, _umax), "minimum": (torch.minimum, _umin),
                "power": (_power, unsigned_pow), "fmod": (_fmod, lambda a, b: unsigned_divmod(a, b)[1])}

for _name, _op in {**_FLOAT_UNARY, **_FLOAT_BINARY}.items():
    register_function(name=_name, device=_elementwise(_op, inexact=True))(None)
for _name, (_op, _unsigned) in {**_SAME_UNARY, **_SAME_BINARY}.items():
    register_function(name=_name, device=_elementwise(_op, unsigned=_unsigned))(None)


def _round(x, decimals=0):
    """numpy's round: half to even; an int column as it is, or rounded to a
    power of ten for negative ``decimals``; a bool column as float64."""
    x = _na(x)
    if x.logical == UINT64 and decimals >= 0:  # numpy keeps an int as it is
        return x
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
    if _has_unsigned([x]):
        dtype, (x, *limits) = _unsigned_operands([x] + bounds)
        data = x.data
        for bound, limit in zip([b for b in (a_min, a_max) if b is not None], limits):
            if dtype == UINT64:
                data = _umax(data, limit.data) if bound is a_min else _umin(data, limit.data)
            else:
                data = torch.maximum(data, limit.data) if bound is a_min else torch.minimum(
                    data, limit.data)
        return NA(data, x.mask, dtype)
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
    boundaries, q = _search_operands(ar, values)
    return NA(_search(boundaries, q, side == "right"), ar.mask)


def _search_operands(x, values):
    """(the sorted ``values``, ``x``'s data), both in numpy's result dtype;
    uint64 values as their order images, which sort as they do."""
    if _has_unsigned([x]) or np.asarray(_host_values(values)).dtype == UINT64:
        values = _host_values(values)
        dtype, (x, v) = _unsigned_operands([x, NA(torch.as_tensor(
            values.view(np.int64) if values.dtype == UINT64 else values), None,
            UINT64 if values.dtype == UINT64 else None)])
        v = v.data.to(x.data.device)
        if dtype == UINT64:
            return v ^ TOP, x.data ^ TOP
        return v, x.data
    dtype = _result_dtype([x, values])
    return _sorted_array(values, dtype, x.data.device), x.data.to(dtype)


def _host_values(values):
    if isinstance(values, NA):
        values = values.data
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    return np.asarray(values)


def _digitize(x, bins, right=False):
    """numpy's digitize: the bin of each value among increasing or
    decreasing ``bins`` (checked on the host)."""
    x = _na(x)
    boundaries, q = _search_operands(x, bins)
    step = np.diff(_host_list(bins))
    if (step >= 0).all():
        return NA(_search(boundaries, q, not right), x.mask)
    if not (step <= 0).all():
        raise ValueError("bins must be monotonically increasing or decreasing")
    flipped = _search(boundaries.flip(0), q, not right)
    return NA(boundaries.numel() - flipped, x.mask)


def _fillmissing(x, value):
    """Missing values replaced by ``value`` cast to the column's dtype."""
    x = _na(x)
    if x.mask is None:
        return x
    if x.logical == UINT64:  # the value cast to uint64, as numpy's
        bits = np.asarray(value).astype(np.uint64).view(np.int64)
        fill = torch.as_tensor(bits).to(x.data.device)
        return NA(torch.where(x.mask, fill, x.data), None, UINT64)
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


# ---------------------------------------------------------------------------
# strings on the device: the functions that take a DictNA (dictionary codes)
# as it is; every other device function refuses one, so that an expression
# that applies it to strings runs in the host stage

_STRINGS_ON_DEVICE = {"ismissing", "isna", "notna", "isnan", "_ordinal_values", "isin_set",
                      "_codes"}


def _codes(x):
    """The dictionary codes of strings, a null row the code after the last
    label: what a string category bins on."""
    if not isinstance(x, DictNA):
        raise TypeError("_codes takes strings")
    return NA(x.data if x.mask is None else x.data.masked_fill(x.mask, len(x.labels)))


def _host_codes(x):
    import pyarrow as pa
    a = array_types.string_arrow(x)
    if not pa.types.is_dictionary(a.type):
        raise TypeError("_codes takes a dictionary array")
    return np.asarray(a.indices.fill_null(len(a.dictionary))).astype(np.int32)


register_function(name="_codes", device=_codes, host=_host_codes, on_expression=False)(None)


def _refusing_strings(name, impl):
    def guarded(*args, **kwargs):
        for a in (*args, *kwargs.values()):
            if isinstance(a, DictNA):
                raise HostStage(f"{name} of strings runs in the host stage")
        return impl(*args, **kwargs)
    guarded.__name__ = name
    return guarded


for _name in list(expression_namespace):
    if _name not in _STRINGS_ON_DEVICE:
        expression_namespace[_name] = _refusing_strings(_name, expression_namespace[_name])


# ---------------------------------------------------------------------------
# the host half: numpy / pyarrow / pandas over host arrays (a numpy array,
# a masked one, an arrow array), for the host stage of a pass
# (vaex_tpu/functions.py:40-320, 326-618)


def _host_split(x):
    """A host array as (data ndarray, mask ndarray or None)."""
    return array_types.data_and_mask(x)


def _host_rejoin(data, mask):
    if mask is None or not np.any(mask):
        return data
    return np.ma.MaskedArray(data, mask)


def _host_elementwise(op):
    """``op`` of the data of its array arguments, their masks OR-ed."""
    def impl(*args, **kwargs):
        datas, mask = [], None
        for a in args:
            if isinstance(a, np.ndarray) or array_types.is_arrow(a):
                d, m = _host_split(a)
                datas.append(d)
                if m is not None:
                    mask = m if mask is None else mask | m
            else:
                datas.append(a)
        return _host_rejoin(op(*datas, **kwargs), mask)
    return impl


for _name in [*_FLOAT_UNARY, *_FLOAT_BINARY, *_SAME_UNARY, *_SAME_BINARY, "abs"]:
    expression_namespace_host[_name] = _host_elementwise(getattr(np, _name))
expression_namespace_host["round"] = _host_elementwise(
    lambda d, decimals=0: np.round(d, decimals))
expression_namespace_host["clip"] = _host_elementwise(
    lambda d, a_min=None, a_max=None: np.clip(d, a_min, a_max))
expression_namespace_host["searchsorted"] = _host_elementwise(
    lambda d, values, side="left": np.searchsorted(np.asarray(values), d, side=side))
expression_namespace_host["digitize"] = _host_elementwise(
    lambda d, bins, right=False: np.digitize(d, np.asarray(bins), right=right))


def _host_missing(x):
    d, m = _host_split(x)
    missing = np.zeros(len(d), bool) if m is None else m.copy()
    if d.dtype.kind in "Mm":
        missing |= np.isnat(d)
    return missing


def _host_isnan(x):
    d, m = _host_split(x)
    out = np.isnan(d) if d.dtype.kind == "f" else np.zeros(len(d), bool)
    return out if m is None else out & ~m


def _host_fillmissing(x, value):
    d, m = _host_split(x)
    if m is None:
        return d
    d = d.copy()
    d[m] = value
    return d


def _host_fillnan(x, value):
    d, m = _host_split(x)
    if d.dtype.kind != "f":
        return _host_rejoin(d, m)
    return _host_rejoin(np.where(np.isnan(d), value, d), m)


def _host_where(cond, a, b):
    return _host_elementwise(np.where)(cond, a, b)


def _host_astype(x, dtype):
    d, m = _host_split(x)
    if np.dtype(dtype).kind in "OUS" or str(dtype) in ("str", "string"):
        return _host_rejoin(np.asarray([str(v) for v in d], dtype=object), m)
    return _host_rejoin(d.astype(np.dtype(dtype)), m)


def _host_choose(codes, choices):
    d, m = _host_split(codes)
    table = np.asarray(choices)
    oob = (d < 0) | (d >= len(table))
    out = table[np.clip(d, 0, max(len(table) - 1, 0))]
    return _host_rejoin(out, oob if m is None else m | oob)


def _host_pnpoly(x, y, xs, ys):
    return _pnpoly(NA(torch.as_tensor(_host_fillmissing(x, 0))),
                   NA(torch.as_tensor(_host_fillmissing(y, 0))), xs, ys).data.numpy() & ~(
        _host_missing(x) | _host_missing(y))


expression_namespace_host.update({
    "ismissing": _host_missing,
    "isnan": _host_isnan,
    "isna": lambda x: _host_missing(x) | _host_isnan(x),
    "notna": lambda x: ~(_host_missing(x) | _host_isnan(x)),
    "fillmissing": _host_fillmissing,
    "fillnan": _host_fillnan,
    "fillna": lambda x, value: _host_fillnan(_host_fillmissing(x, value), value),
    "where": _host_where,
    "astype": _host_astype,
    "_ordinal_values": lambda x, oset: setops.host_map_ordinal(oset, x),
    "isin_set": lambda x, oset: setops.host_isin(oset, x),
    "_choose": _host_choose,
    "pnpoly": _host_pnpoly,
})


# dt_* / td_*: calendar functions through pandas (vaex_tpu/functions.py:326-373)


def _via_pandas(attr, is_method=False):
    """A pandas ``.dt`` attribute or method; where it gives objects (a
    name, a date, a formatted string) a NaT row is missing (vaex_tpu's
    host raises on them), a number keeps pandas' NaN."""
    def impl(x, *args, **kwargs):
        import pandas as pd
        d, m = _host_split(x)
        value = getattr(pd.Series(d).dt, attr)
        if is_method:
            value = value(*args, **kwargs)
        out = np.asarray(value.to_numpy())
        if out.dtype == object and d.dtype.kind in "Mm":
            nat = np.isnat(d) if m is None else np.isnat(d) | m
            out = np.where(nat, None, out)
            m = nat
        return _host_rejoin(out, m)
    return impl


def _weekofyear(x):
    import pandas as pd
    d, m = _host_split(x)
    return _host_rejoin(pd.Series(d).dt.isocalendar().week.to_numpy().astype(np.int64), m)


for _p in ["year", "month", "day", "hour", "minute", "second", "microsecond", "nanosecond",
           "dayofweek", "dayofyear", "daysinmonth", "quarter", "is_leap_year", "date"]:
    register_function(scope="dt", name=_p, as_property=True, host=_via_pandas(_p))(None)
register_function(scope="dt", name="weekofyear", as_property=True, host=_weekofyear)(None)
for _m in ["strftime", "floor", "day_name", "month_name"]:
    register_function(scope="dt", name=_m, host=_via_pandas(_m, is_method=True))(None)
for _p in ["days", "seconds", "microseconds", "nanoseconds"]:
    register_function(scope="td", name=_p, as_property=True, host=_via_pandas(_p))(None)
register_function(scope="td", name="total_seconds",
                  host=_via_pandas("total_seconds", is_method=True))(None)


# str_*: string functions through pyarrow.compute (vaex_tpu/functions.py:375-558)


def _to_pa(x):
    import pyarrow as pa
    a = array_types.to_arrow(x)
    return a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a


def _dict_aware(fn):
    """A per-value arrow kernel that runs once per label of a dictionary
    array and is gathered by its indices: a string result stays a
    dictionary array over the same indices, any other is taken."""
    def impl(x, *args, **kwargs):
        import pyarrow as pa
        a = _to_pa(x)
        if pa.types.is_dictionary(a.type):
            values = fn(a.dictionary, *args, **kwargs)
            if pa.types.is_string(values.type) or pa.types.is_large_string(values.type):
                return pa.DictionaryArray.from_arrays(a.indices, values)
            return values.take(a.indices)
        return fn(a, *args, **kwargs)
    return impl


def _decoded(x):
    import pyarrow as pa
    a = _to_pa(x)
    return a.dictionary_decode() if pa.types.is_dictionary(a.type) else a


def _pc(name, **fixed):
    def kernel(a, *args, **kwargs):
        import pyarrow.compute as pc
        return getattr(pc, name)(a, *args, **fixed, **kwargs)
    return kernel


_STR_SIMPLE = {
    "capitalize": "utf8_capitalize", "lower": "utf8_lower", "upper": "utf8_upper",
    "title": "utf8_title", "swapcase": "utf8_swapcase", "isalnum": "utf8_is_alnum",
    "isalpha": "utf8_is_alpha", "isdigit": "utf8_is_digit", "isspace": "utf8_is_space",
    "islower": "utf8_is_lower", "isupper": "utf8_is_upper", "istitle": "utf8_is_title",
    "len": "utf8_length", "byte_length": "binary_length", "reverse": "utf8_reverse",
    "trim_whitespace": "utf8_trim_whitespace", "isnumeric": "utf8_is_numeric",
    "len_unicode": "utf8_length",
}
for _name, _pc_name in _STR_SIMPLE.items():
    register_function(scope="str", name=_name, host=_dict_aware(_pc(_pc_name)))(None)


def _trim(side):
    def kernel(a, to_strip=None):
        import pyarrow.compute as pc
        if to_strip is None:
            return getattr(pc, f"utf8_{side}_whitespace")(a)
        return getattr(pc, f"utf8_{side}")(a, characters=to_strip)
    return _dict_aware(kernel)


def _contains(a, pattern, regex=True):
    import pyarrow.compute as pc
    return (pc.match_substring_regex if regex else pc.match_substring)(a, pattern)


def _match(a, pattern):
    import pyarrow.compute as pc
    if "%" in str(pattern):
        return pc.match_like(a, pattern)
    return pc.match_substring_regex(a, "^(" + str(pattern) + ")$")


def _count(a, pattern, regex=True):
    import pyarrow.compute as pc
    return (pc.count_substring_regex if regex else pc.count_substring)(a, pattern)


def _replace(a, pattern, repl, n=-1, regex=False):
    import pyarrow.compute as pc
    kwargs = {} if n == -1 else {"max_replacements": n}
    return (pc.replace_substring_regex if regex else pc.replace_substring)(
        a, pattern, repl, **kwargs)


def _slice(a, start=0, stop=None):
    import pyarrow.compute as pc
    return pc.utf8_slice_codeunits(a, start=start, stop=stop if stop is not None else 2 ** 31 - 1)


def _pad(a, width, side="left", fillchar=" "):
    import pyarrow.compute as pc
    fn = {"left": pc.utf8_lpad, "right": pc.utf8_rpad}.get(side, pc.utf8_center)
    return fn(a, width=width, padding=fillchar)


def _split(a, pattern=" ", max_splits=None, regex=False):
    import pyarrow.compute as pc
    kwargs = {} if max_splits is None else {"max_splits": max_splits}
    return (pc.split_pattern_regex if regex else pc.split_pattern)(a, pattern, **kwargs)


def _equals(x, y):
    import pyarrow.compute as pc
    return pc.equal(_decoded(x), y if isinstance(y, str) else _decoded(y))


def _cat(x, other):
    import pyarrow.compute as pc
    return pc.binary_join_element_wise(
        _decoded(x), other if isinstance(other, str) else _decoded(other), "")


def _join(x, separator=" "):
    import pyarrow.compute as pc
    return pc.binary_join(_to_pa(x), separator)


for _name, _impl in {
    "strip": _trim("trim"), "lstrip": _trim("ltrim"), "rstrip": _trim("rtrim"),
    "contains": _dict_aware(_contains),
    "startswith": _dict_aware(lambda a, pat: _pc("starts_with")(a, pattern=pat)),
    "endswith": _dict_aware(lambda a, pat: _pc("ends_with")(a, pattern=pat)),
    "match": _dict_aware(_match),
    "equals": _equals,
    "count": _dict_aware(_count),
    "find": _dict_aware(_pc("find_substring")),
    "replace": _dict_aware(_replace),
    "slice": _dict_aware(_slice),
    "pad": _dict_aware(_pad),
    "ljust": _dict_aware(lambda a, width, fillchar=" ": _pad(a, width, "right", fillchar)),
    "rjust": _dict_aware(lambda a, width, fillchar=" ": _pad(a, width, "left", fillchar)),
    "zfill": _dict_aware(lambda a, width: _pad(a, width, "left", "0")),
    "repeat": _dict_aware(_pc("binary_repeat")),
    "cat": _cat,
    "split": _dict_aware(_split),
    "join": _join,
    "index_of": _dict_aware(_pc("find_substring")),
    "extract_regex": _dict_aware(_pc("extract_regex")),
    "count_substring": _dict_aware(_pc("count_substring")),
}.items():
    register_function(scope="str", name=_name, host=_impl)(None)


def _to_string(x):
    d, m = _host_split(x)
    return _host_rejoin(np.asarray([str(v) for v in d], dtype=object), m)


def _format(x, fmt):
    d, m = _host_split(x)
    return _host_rejoin(np.asarray([fmt.format(v) for v in d], dtype=object), m)


register_function(name="to_string", host=_to_string)(None)
register_function(name="format", host=_format)(None)

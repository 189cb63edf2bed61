"""The expression-namespace functions of the slice: ``astype``, ``where``,
``abs``, the NaN/null helpers (``isnan``, ``ismissing``, ``isna``,
``notna``), with ``vaex_tpu``'s semantics (NaN and null are distinct), and
the set-based internals ``_ordinal_values``, ``isin_set`` and ``_choose``,
whose set argument is a variable the scope resolves to a
:class:`~vaex_tpu_torch.ops.setops.DeviceSetHandle`.
Arithmetic and comparisons are the operators of
:class:`~vaex_tpu_torch.ops.nullable.NA`.
"""

from __future__ import annotations

import torch

from .datatype import torch_dtype
from .ops import setops
from .ops.nullable import NA, as_operand
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
    datas = []
    mask = None
    for v in (cond, a, b):
        if isinstance(v, NA):
            datas.append(v.data)
            if v.mask is not None:
                mask = v.mask if mask is None else mask | v.mask
        else:
            datas.append(as_operand(v))
    return NA(torch.where(*datas), mask)


def _astype(x, dtype):
    x = _na(x)
    return NA(x.data.to(torch_dtype(dtype)), x.mask)


def _abs(x):
    x = _na(x)
    return NA(torch.abs(x.data), x.mask)


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

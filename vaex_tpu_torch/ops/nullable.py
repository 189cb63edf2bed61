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

A ``datetime64`` or ``timedelta64`` value is its int64 epoch count (NaT is
the int64 minimum) with the numpy dtype in ``logical``.  The operators
carry that dtype as numpy does (:func:`temporal_binop`): numpy's result
dtype, the units aligned to the finer one, NaT in gives NaT out (False in a
comparison, True in ``!=``, NaN in a float quotient, 0 in an int one), and
an operation numpy refuses raises ``TypeError``.  Any other operation on a
temporal value raises :class:`HostStage` (:func:`refuse_temporal`): the
pass's classifier (:func:`vaex_tpu_torch.scopes.expression_is_device`)
tries an expression on an empty tile and sends one that raises it to the
host stage, where numpy computes it, as in vaex_tpu.

Strings on a device are :class:`DictNA`: int32 dictionary codes with the
labels (an arrow string array) on the host.  A comparison with a string is
computed once per label and gathered by code on the device; any other
operation raises :class:`HostStage`.

A ``uint64`` value is its int64 bits with ``logical`` uint64.  Its
operators follow numpy's values and promotion (:func:`unsigned_binop`):
with uint64 values and non-negative Python ints the arithmetic wraps mod
2^64, ``//`` and ``%`` are unsigned, the bitwise operators and shifts work
on the bits; with a signed int or float column the arithmetic is float64;
comparisons are exact.  The functions of :mod:`..functions` take it as
numpy does (float64 for ``sqrt``, uint64 for ``maximum`` or
``fillmissing``).
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from ..datatype import _TORCH_TO_NUMPY, TOP, UINT64

# NaT in the int64 view of a datetime or timedelta
NAT = np.iinfo(np.int64).min


class NA:
    """data + optional validity (+ the numpy temporal dtype an int64 ``data``
    stands for). Immutable."""

    __slots__ = ("data", "mask", "logical")
    __array_priority__ = 100  # beat numpy operator dispatch

    def __init__(self, data, mask=None, logical=None):
        self.data = data
        self.mask = mask
        self.logical = None if logical is None else np.dtype(logical)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        return f"NA({self.data!r}, mask={self.mask!r})"

    def astype(self, dtype):
        """``x.astype('float32')`` inside an expression string."""
        from ..functions import _astype
        return _astype(self, dtype)

    def maskarray(self):
        """Always-materialized mask (False where no mask)."""
        if self.mask is None:
            return torch.zeros(self.data.shape, dtype=torch.bool, device=self.data.device)
        return self.mask

    def valid(self):
        """True where the value is present."""
        return ~self.maskarray()

    def fill(self, value):
        """The data with the missing entries replaced by ``value``."""
        if self.mask is None:
            return self.data
        return self.data.masked_fill(self.mask, value)


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


class HostStage(NotImplementedError):
    """An operation the device stage does not carry for its operands (a
    temporal value, strings): an expression that meets one runs in the
    host stage."""


def refuse_temporal(what, *args):
    """Raise for an operation the device stage does not carry for a
    temporal value or strings (:class:`HostStage`), or that takes no uint64
    value (the functions that do handle it before)."""
    for a in args:
        if isinstance(a, DictNA):
            raise HostStage(f"{what} of strings runs in the host stage")
        if isinstance(a, NA) and a.logical is not None:
            if a.logical == UINT64:
                raise TypeError(f"{what} of a uint64 value")
            raise HostStage(f"{what} of a {a.logical} value runs in the host stage")


def wrap(x) -> NA:
    """An NA of a tensor, a host array (a masked one's mask kept where it
    masks something) or an NA."""
    if isinstance(x, NA):
        return x
    if isinstance(x, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(x)
        return NA(torch.as_tensor(np.ma.getdata(x)),
                  torch.as_tensor(mask) if mask.any() else None)
    return NA(torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x)


def unwrap(x):
    """An NA as a host numpy array, masked where it holds missing values."""
    if not isinstance(x, NA):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    data = x.data.cpu().numpy()
    if x.mask is None or not bool(x.mask.any()):
        return data
    return np.ma.MaskedArray(data, x.mask.cpu().numpy())


def lift(op, *args, bool_out=False):
    """Apply op to the .data of NA/plain args, OR-combining masks (a
    temporal value or strings raise :class:`HostStage`); ``bool_out``
    changes nothing, as in vaex_tpu."""
    refuse_temporal(getattr(op, "__name__", "this function"), *args)
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


def _is_temporal(x):
    return isinstance(x, NA) and x.logical is not None and x.logical.kind in "Mm"


def _is_unsigned(x):
    return isinstance(x, NA) and x.logical == UINT64


def _binop(name, op, reflected=False):
    def method(self, other):
        left, right = (other, self) if reflected else (self, other)
        if _is_unsigned(left) or _is_unsigned(right):
            return unsigned_binop(name, left, right)
        if _is_temporal(left) or _is_temporal(right):
            return temporal_binop(name, left, right)
        return lift(op, left, right)
    return method


_NUMPY_OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv, "mod": operator.mod,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "eq": operator.eq, "ne": operator.ne,
}
_COMPARISONS = {"lt", "le", "gt", "ge", "eq", "ne"}


def _numpy_stand_in(x):
    """What numpy's dtype rules see of an operand: one element of its dtype,
    a Python number as it is (weak)."""
    if isinstance(x, NA):
        if x.logical is not None:
            return np.zeros(1, x.logical)
        x = x.data
    if isinstance(x, torch.Tensor):
        return np.ones(1, _TORCH_TO_NUMPY[x.dtype])
    return x


def _unit_scale(logical, unit):
    """The int64 factor from ``logical``'s unit to ``unit``; raises for the
    calendar units (months, years), which no factor converts."""
    own, count = np.datetime_data(logical)
    if (own, count) == (unit, 1):
        return 1
    if own in ("Y", "M", "generic") or unit in ("Y", "M", "generic"):
        raise HostStage(f"converting {logical} to the unit {unit!r} runs in the host stage")
    return int(np.timedelta64(count, own).astype(f"m8[{unit}]").astype(np.int64))


def _data(x):
    if isinstance(x, NA):
        return x.data
    return as_operand(x)


def temporal_binop(name, left, right):
    """``left <name> right`` where one side is a datetime64 or timedelta64 NA,
    with numpy's result dtype and values (see the module docstring): int
    division of a timedelta by a number truncates toward zero and gives NaT
    for 0, a float factor or divisor is applied in float64 and truncated,
    a timedelta over a timedelta floors (``//``, 0 for 0) or is float64
    (``/``), ``%`` follows the divisor's sign (NaT for 0)."""
    if name not in _NUMPY_OPS:
        refuse_temporal(name, left, right)
    with np.errstate(all="ignore"):
        try:
            out = _NUMPY_OPS[name](_numpy_stand_in(left), _numpy_stand_in(right)).dtype
        except TypeError as e:  # numpy has no such loop
            raise TypeError(f"{name} of {_describe(left)} and {_describe(right)}: {e}") from None
    mask = _mask_or(*(x.mask if isinstance(x, NA) else None for x in (left, right)))
    a, b = _data(left), _data(right)
    nat = None
    for x in (left, right):
        if _is_temporal(x):
            hit = x.data == NAT
            nat = hit if nat is None else nat | hit
    if _is_temporal(left) and _is_temporal(right):
        # both sides in the finer unit (numpy's common metadata)
        unit = np.datetime_data(np.result_type(
            *(np.dtype(f"m8[{np.datetime_data(x.logical)[0]}]") for x in (left, right))))[0]
        a = a * _unit_scale(left.logical, unit)
        b = b * _unit_scale(right.logical, unit)
    float_operand = any(isinstance(v, float) or (isinstance(v, torch.Tensor)
                                                   and v.is_floating_point()) for v in (a, b))
    if name in _COMPARISONS:
        value = _NUMPY_OPS[name](a, b)
        return NA(value if nat is None else torch.where(nat, name == "ne", value), mask)
    if name in ("add", "sub"):
        value = _NUMPY_OPS[name](a, b)
    elif name == "mul" or (name in ("truediv", "floordiv") and out.kind in "Mm"):
        if float_operand:  # numpy multiplies or divides in float64, then truncates
            f = (a.to(torch.float64) * b if name == "mul" else a.to(torch.float64) / b)
            finite = torch.isfinite(f)
            value = torch.where(finite, torch.where(finite, f, 0).trunc().to(torch.int64), NAT)
        elif name == "mul":
            value = a * b
        else:  # an int divisor: C division, NaT for 0
            b = torch.as_tensor(b, device=a.device)
            zero = b == 0
            value = torch.where(zero, NAT, torch.div(a, torch.where(zero, 1, b),
                                                     rounding_mode="trunc"))
    elif name == "truediv":  # a timedelta over a timedelta
        value = a.to(torch.float64) / b.to(torch.float64)
        return NA(torch.where(nat, torch.nan, value), mask)
    else:  # floordiv or mod of two timedeltas
        zero = b == 0
        safe = torch.where(zero, 1, b)
        if name == "floordiv":
            value = torch.where(zero | nat, 0, torch.div(a, safe, rounding_mode="floor"))
            return NA(value, mask)
        value = torch.where(zero, NAT, torch.remainder(a, safe))
    if nat is not None:
        value = torch.where(nat, NAT, value)
    return NA(value, mask, out)


def _unsigned_side(x, name):
    """One operand of an operation with a uint64 value, as numpy's rules see
    it: ("u", int64 bits) for a uint64 NA, a bool, or a Python int in [0,
    2^64); ("neg", int) for a negative Python int; ("i", int64 tensor) for a
    signed int or bool column; ("f", float64 tensor or float) for a float."""
    if _is_unsigned(x):
        return "u", x.data
    if isinstance(x, DictNA):
        raise HostStage(f"{name} of strings and a uint64 value runs in the host stage")
    if isinstance(x, NA):
        if x.logical is not None:
            raise TypeError(f"{name} of a uint64 value and {_describe(x)}: numpy has no such "
                            f"loop")
        if x.data.is_floating_point():
            return "f", x.data.to(torch.float64)
        return "i", x.data.to(torch.int64)
    if isinstance(x, (float, np.floating)):
        return "f", float(x)
    if isinstance(x, (bool, int, np.integer)):
        x = int(x)
        if x < 0:
            return "neg", x
        if x >= 2 ** 64:
            raise OverflowError(f"Python integer {x} out of bounds for uint64")
        return "u", x - 2 ** 64 if x >= 2 ** 63 else x
    raise TypeError(f"{name} of a uint64 value and {_describe(x)}")


def _ufloat(kind, v):
    """An operand's float64 value (a uint64's from its bits)."""
    if kind == "u":
        return unsigned_float(v) if isinstance(v, torch.Tensor) else float(v % 2 ** 64)
    return v.to(torch.float64) if isinstance(v, torch.Tensor) else float(v)


def _uge(a, b):
    """a >= b as uint64 bits (the order images compare as int64)."""
    return (a ^ TOP) >= (b ^ TOP)


_LOW63 = (1 << 63) - 1


def unsigned_divmod(a, b):
    """numpy's floor quotient and remainder of uint64 bits (0 and 0 where
    ``b`` is 0).  Below 2^63 a divisor divides ``a >> 1`` (a non-negative
    int64) and one correction step follows; from 2^63 up the quotient is 0
    or 1."""
    a, b = torch.broadcast_tensors(a, b)
    zero = b == 0
    b = torch.where(zero, 1, b)
    big = b < 0
    small = torch.where(big, 1, b)
    q = torch.div((a >> 1) & _LOW63, small, rounding_mode="floor") << 1
    r = a - q * small
    fix = _uge(r, small)
    q, r = q + fix.to(torch.int64), r - torch.where(fix, small, 0)
    q_big = _uge(a, b).to(torch.int64)
    q, r = torch.where(big, q_big, q), torch.where(big, a - q_big * b, r)
    return torch.where(zero, 0, q), torch.where(zero, 0, r)


def unsigned_pow(a, e):
    """``a ** e`` of uint64 bits mod 2^64, by squaring."""
    if isinstance(e, int):
        bits = [(e >> i) & 1 for i in range(e.bit_length())]
        out, base = torch.ones_like(a), a
        for bit in bits:
            if bit:
                out = out * base
            base = base * base
        return out
    a, e = torch.broadcast_tensors(a, e)
    out, base = torch.ones_like(a), a
    for _ in range(64):
        out = torch.where((e & 1) != 0, out * base, out)
        base = base * base
        e = (e >> 1) & _LOW63
    return out


def _ushift(name, a, s):
    """A shift of uint64 bits by a uint64 amount: numpy gives 0 past 63."""
    if isinstance(s, int):
        if s >= 64:
            return torch.zeros_like(a)
        return a << s if name == "lshift" else (a >> s) & ((1 << (64 - s)) - 1 if s else -1)
    a, s = torch.broadcast_tensors(a, s)
    past = (s < 0) | (s >= 64)
    s = torch.where(past, 0, s)
    if name == "lshift":
        out = a << s
    else:  # a logical shift: the arithmetic one, then the sign's copies cleared
        out = (a >> s) & torch.where(s == 0, -1, (torch.ones_like(s) << (64 - s)) - 1)
    return torch.where(past, 0, out)


_UNSIGNED_BITS = {"and": operator.and_, "or": operator.or_, "xor": operator.xor}


def unsigned_binop(name, left, right):
    """``left <name> right`` where one side is a uint64 NA, as numpy gives
    it: with uint64 values, bools and non-negative Python ints ``+ - * **``
    wrap mod 2^64, ``// %`` are unsigned (0 for a 0 divisor), the bitwise
    operators and shifts work on the bits (a shift past 63 gives 0), all
    uint64, ``/`` float64; with a signed int or float column or a float the
    arithmetic is float64 and the bitwise operators raise; comparisons are
    exact against signed ints (a negative one is below every uint64) and in
    float64 against floats; arithmetic with a negative Python int raises
    ``OverflowError``, as numpy's."""
    mask = _mask_or(*(x.mask if isinstance(x, NA) else None for x in (left, right)))
    (ka, a), (kb, b) = (_unsigned_side(x, name) for x in (left, right))
    kinds = {ka, kb}
    if name in _COMPARISONS:
        if "f" in kinds:
            return NA(_NUMPY_OPS[name](_ufloat(ka, a), _ufloat(kb, b)), mask)
        # a negative int is below every uint64 (a Python one, or a column's row)
        above = (name in ("gt", "ge", "ne")) if ka == "u" else (name in ("lt", "le", "ne"))
        if "neg" in kinds:
            u = a if ka == "u" else b
            return NA(torch.full(u.shape, above, dtype=torch.bool, device=u.device), mask)
        value = _NUMPY_OPS[name](a ^ TOP, b ^ TOP)
        if "i" in kinds:
            value = torch.where((a if ka == "i" else b) < 0, above, value)
        return NA(value, mask)
    if "neg" in kinds:
        raise OverflowError(f"Python integer {a if ka == 'neg' else b} out of bounds for uint64")
    if kinds != {"u"} or name == "truediv":
        if name in _UNSIGNED_BITS or name in ("lshift", "rshift"):
            raise TypeError(f"{name} of a uint64 value and {_describe(left if ka != 'u' else right)}"
                            f": numpy has no such loop")
        a, b = _ufloat(ka, a), _ufloat(kb, b)
        if name == "floordiv":
            return NA(torch.div(torch.as_tensor(a), b, rounding_mode="floor"), mask)
        if name == "mod":
            return NA(torch.remainder(torch.as_tensor(a), b), mask)
        return NA(_NUMPY_OPS.get(name, operator.pow)(a, b), mask)
    device = (a if isinstance(a, torch.Tensor) else b).device
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=torch.int64, device=device)
    if name in ("add", "sub", "mul"):
        value = _NUMPY_OPS[name](a, b)
    elif name in ("floordiv", "mod"):
        q, r = unsigned_divmod(a, b if isinstance(b, torch.Tensor) else torch.tensor(b, device=device))
        value = q if name == "floordiv" else r
    elif name == "pow":
        value = unsigned_pow(a, b)
    elif name in _UNSIGNED_BITS:
        value = _UNSIGNED_BITS[name](a, b)
    elif name in ("lshift", "rshift"):
        value = _ushift(name, a, b)
    else:
        raise TypeError(f"{name} of a uint64 value: numpy has no such loop")
    return NA(value, mask, UINT64)


def unsigned_float(t):
    """The float64 value of the uint64 bits in an int64 tensor."""
    f = t.to(torch.float64)
    return torch.where(t < 0, f + 2.0 ** 64, f)


def _describe(x):
    if isinstance(x, NA):
        return str(x.logical or _numpy_stand_in(x).dtype)
    return type(x).__name__


def _unary(name, op):
    def method(self):
        if self.logical is None:
            return NA(op(self.data), self.mask)
        if self.logical == UINT64:  # numpy keeps uint64: -x and ~x wrap, abs is x
            return self if name in ("pos", "abs") else NA(op(self.data), self.mask, UINT64)
        if self.logical.kind == "M" or name == "invert":
            raise TypeError(f"{name} of a {self.logical} value: numpy has no such loop")
        return NA(torch.where(self.data == NAT, NAT, op(self.data)), self.mask, self.logical)
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
        setattr(NA, f"__{name}__", _binop(name, op))
        if name not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(NA, f"__r{name}__", _binop(name, op, reflected=True))
    NA.__neg__ = _unary("neg", operator.neg)
    NA.__pos__ = _unary("pos", operator.pos)
    NA.__abs__ = _unary("abs", torch.abs)
    NA.__invert__ = _unary("invert", operator.invert)


_install_operators()


# ---------------------------------------------------------------------------
# strings on a device

_ARROW_COMPARE = {"eq": "equal", "ne": "not_equal", "lt": "less", "le": "less_equal",
                  "gt": "greater", "ge": "greater_equal"}
_REFLECTED = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


class DictNA(NA):
    """Strings on a device: ``data`` holds int32 codes into ``labels`` (an
    arrow string array on the host), ``mask`` the null rows.  A code may
    lie past the labels where the row is masked."""

    __slots__ = ("labels",)

    def __init__(self, data, mask, labels):
        super().__init__(data, mask)
        self.labels = labels

    def __repr__(self):
        return f"DictNA({self.data!r}, mask={self.mask!r}, labels={len(self.labels)})"

    def gather(self, values, null=None):
        """Per-label ``values`` (a host array of one value per label) at each
        row's code, on the device; rows masked, and rows whose label is
        ``null`` (a host bool array), are missing."""
        values = np.asarray(values)
        pad = np.zeros(1, values.dtype)  # masked rows may hold the code len(labels)
        table = torch.as_tensor(np.concatenate([values, pad])).to(self.data.device)
        codes = self.data if self.data.dtype in (torch.int32, torch.int64) else (
            self.data.to(torch.int32))
        out = table.index_select(0, codes)
        mask = self.mask
        if null is not None and null.any():
            hit = torch.as_tensor(np.concatenate([null, [False]])).to(self.data.device)
            hit = hit.index_select(0, codes)
            mask = hit if mask is None else mask | hit
        return NA(out, mask)

def _dict_binop(name):
    def method(self, other, reflected=False):
        if name in _ARROW_COMPARE and isinstance(other, (str, type(None))):
            if other is None:  # numpy's answer for None: no row equals it
                return self.gather(np.full(len(self.labels), name == "ne"))
            import pyarrow.compute as pc
            op = _REFLECTED[name] if reflected else name
            result = getattr(pc, _ARROW_COMPARE[op])(self.labels, other)
            null = np.asarray(result.is_null()) if result.null_count else None
            return self.gather(np.asarray(result.fill_null(False)), null)
        raise HostStage(f"{name} of strings and {_describe(other)} runs in the host stage")
    return method


def _install_dict_operators():
    for name in ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "and", "or",
                 "xor", "lshift", "rshift", "lt", "le", "gt", "ge", "eq", "ne", "matmul"):
        impl = _dict_binop(name)
        setattr(DictNA, f"__{name}__", impl)
        if name not in _ARROW_COMPARE:
            setattr(DictNA, f"__r{name}__",
                    lambda self, other, impl=impl: impl(self, other, reflected=True))

    def unary(self):
        raise HostStage("an arithmetic operator of strings runs in the host stage")
    for name in ("neg", "pos", "abs", "invert"):
        setattr(DictNA, f"__{name}__", unary)


_install_dict_operators()

"""Expression: operator-overloaded, string-backed lazy column expressions.

An Expression is (DataFrame, expression string); every operator builds a new
string, and evaluation happens in a pass, where the string is ``eval``'d
over a tile's tensors (:mod:`vaex_tpu_torch.scopes`).
"""

from __future__ import annotations

import numpy as np

from . import expresso
from .registry import install_all_on_expression


def _to_expression_string(value, df=None):
    if isinstance(value, Expression):
        return f"({value.expression})"
    if isinstance(value, (str, bool, int, float)) or value is None:
        return repr(value)
    if isinstance(value, np.generic) and value.dtype.kind in "Mm" and df is not None:
        # a datetime or timedelta: a variable (vaex_tpu/expression.py:27-30)
        return df.add_variable("literal", value, unique=True)
    if isinstance(value, np.generic):
        return repr(value.item())
    raise TypeError(f"cannot use {type(value).__name__} in an expression yet")


_binary_ops = {
    "add": "+", "sub": "-", "mul": "*", "truediv": "/", "floordiv": "//",
    "mod": "%", "pow": "**", "and": "&", "or": "|", "xor": "^",
    "lshift": "<<", "rshift": ">>",
}
_comparison_ops = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_unary_ops = {"neg": "-", "pos": "+", "invert": "~"}


class Meta(type):
    def __new__(mcs, name, bases, attrs):
        for opname, symbol in {**_binary_ops, **_comparison_ops}.items():
            def closure(symbol=symbol):
                def operator_fn(self, other):
                    rhs = _to_expression_string(other, self.df)
                    return Expression(self.df, f"({self.expression} {symbol} {rhs})")
                return operator_fn

            def rclosure(symbol=symbol):
                def operator_fn(self, other):
                    lhs = _to_expression_string(other, self.df)
                    return Expression(self.df, f"({lhs} {symbol} {self.expression})")
                return operator_fn
            attrs[f"__{opname}__"] = closure()
            if opname not in _comparison_ops:
                attrs[f"__r{opname}__"] = rclosure()
        for opname, symbol in _unary_ops.items():
            def uclosure(symbol=symbol):
                def operator_fn(self):
                    return Expression(self.df, f"({symbol}({self.expression}))")
                return operator_fn
            attrs[f"__{opname}__"] = uclosure()
        return type.__new__(mcs, name, bases, attrs)


class StringOperations:
    """``expr.str``: the ``str_*`` functions as methods (vaex_tpu/expression.py:74-98)."""

    def __init__(self, expression):
        self.expression = expression


class StringOperationsPandas(StringOperations):
    """``expr.str_pandas``: the same functions."""


class DateTime(StringOperations):
    """``expr.dt``: the ``dt_*`` functions (properties and methods)."""


class TimeDelta(StringOperations):
    """``expr.td``: the ``td_*`` functions."""


_scope_accessors = {"str": StringOperations, "str_pandas": StringOperationsPandas,
                    "dt": DateTime, "td": TimeDelta}


def get_scope_accessor(scope):
    return _scope_accessors[scope]


class Expression(metaclass=Meta):
    def __init__(self, df, expression, validate=True):
        # ``validate`` changes nothing, as in vaex_tpu (vaex_tpu/expression.py:107)
        self.df = df
        if isinstance(expression, Expression):
            expression = expression.expression
        self.expression = str(expression)

    def __str__(self):
        return self.expression

    def __repr__(self):
        """Its first values, its length and dtype (vaex_tpu/expression.py:120-125)."""
        from .formatting import format_expression_preview
        return format_expression_preview(self)

    @property
    def ast(self):
        """The expression's Python syntax tree (vaex_tpu/expression.py:114)."""
        return expresso.parse_expression(self.expression)

    def __hash__(self):
        return hash((id(self.df), self.expression))

    # -- accessors (vaex_tpu/expression.py:143-160) ---------------------------
    @property
    def str(self):
        return StringOperations(self)

    @property
    def str_pandas(self):
        return StringOperationsPandas(self)

    @property
    def dt(self):
        return DateTime(self)

    @property
    def td(self):
        return TimeDelta(self)

    def _call_function(self, name, *args, **kwargs):
        parts = [self.expression]
        parts += [_to_expression_string(a, self.df) for a in args]
        parts += [f"{k}={_to_expression_string(v, self.df)}" for k, v in kwargs.items()]
        return Expression(self.df, f"{name}({', '.join(parts)})")

    def astype(self, dtype):
        if dtype in (str, "str", "string"):
            return Expression(self.df, f"astype({self.expression}, 'str')")
        return Expression(self.df, f"astype({self.expression}, {str(np.dtype(dtype))!r})")

    # -- structure (vaex_tpu/expression.py:172-200) --------------------------
    def expand(self, stop=()):
        """The expression with every virtual column replaced by its own
        expression, recursively, except the names in ``stop``."""
        virtual = self.df.virtual_columns
        expr, previous = self.expression, None
        while previous != expr:
            previous = expr
            expr = expresso.substitute(expr, {
                name: f"({virtual[name]})" for name in expresso.collect_names(expr)
                if name in virtual and name not in stop})
        return Expression(self.df, expr)

    def variables(self, ourself=False, expand_virtual=True):
        """The physical columns and variables the expression reads;
        ``ourself`` and ``expand_virtual`` change nothing, as in vaex_tpu
        (vaex_tpu/expression.py:191-195)."""
        from .scopes import _leaves
        columns, used = _leaves(self.expression, self.df.variables, self.df.virtual_columns)
        return columns | used

    def fingerprint(self):
        from .utils import fingerprint
        return fingerprint("expression", self.expression, self.df.fingerprint())

    @property
    def dtype(self):
        return self.df.data_type(self.expression)

    def data_type(self):
        return self.df.data_type(self.expression)

    def derivative(self, var, simplify=True):
        """The symbolic derivative by ``var`` (:func:`.expresso.derivative`)."""
        var = var.expression if isinstance(var, Expression) else str(var)
        return Expression(self.df, expresso.derivative(self.expression, var, simplify=simplify))

    # -- statistics (vaex_tpu/expression.py:233-255) -------------------------
    def count(self, **kwargs):
        return self.df.count(self.expression, **kwargs)

    def sum(self, axis=None, **kwargs):
        return self.df.sum(self.expression, **kwargs)

    def mean(self, **kwargs):
        return self.df.mean(self.expression, **kwargs)

    def std(self, **kwargs):
        return self.df.std(self.expression, **kwargs)

    def var(self, **kwargs):
        return self.df.var(self.expression, **kwargs)

    def min(self, **kwargs):
        return self.df.min(self.expression, **kwargs)

    def max(self, **kwargs):
        return self.df.max(self.expression, **kwargs)

    def minmax(self, **kwargs):
        return self.df.minmax(self.expression, **kwargs)

    # -- convenience (vaex_tpu/expression.py:332-360): ``abs``, ``clip``,
    # ``fillna``, ``fillmissing``, ``isna`` ... are the registry's methods
    # (``df.x.clip(1, 2)`` is ``clip(x, 1, 2)``); ``where`` takes the
    # condition first, so the class defines it
    def where(self, condition, other):
        """This expression where ``condition`` holds, else ``other``."""
        return Expression(self.df, f"where({_to_expression_string(condition, self.df)}, "
                                   f"{self.expression}, "
                                   f"{_to_expression_string(other, self.df)})")

    def __abs__(self):
        return self.abs()

    def evaluate(self, i1=None, i2=None, out=None, selection=None, filtered=True,
                 array_type=None, parallel=True):
        """The values as a host numpy (masked) array
        (:meth:`~vaex_tpu_torch.dataframe.DataFrame.evaluate`)."""
        return self.df.evaluate(self.expression, i1, i2, out, selection, filtered, array_type)

    def nop(self):
        """Evaluate and drop the values (vaex_tpu/expression.py:257)."""
        self.evaluate()

    def jit(self, verbose=False):
        """The expression itself: vaex_tpu's jit_numba / jit_jax are the
        identity (vaex_tpu/expression.py:366-373), and a pass evaluates it
        on the card as it is."""
        return Expression(self.df, self.expression)

    jit_numba = jit
    jit_jax = jit

    def apply(self, f, vectorize=False, multiprocessing=False):
        """``f`` of this expression, a Python function on the host
        (:meth:`~vaex_tpu_torch.dataframe.DataFrame.add_function`;
        vaex_tpu/expression.py:375-380): row by row unless ``vectorize``."""
        name = self.df.add_function(getattr(f, "__name__", "lambda"), f, vectorize=vectorize,
                                    unique=True, multiprocessing=multiprocessing)
        return Expression(self.df, f"{name}({self.expression})")

    @property
    def values(self):
        return self.evaluate()

    def to_numpy(self):
        return self.evaluate(array_type="numpy")

    def tolist(self, i1=None, i2=None):
        return self.evaluate(i1, i2, array_type="list")

    def __len__(self):
        return len(self.df)

    # -- set-based operations (vaex_tpu/expression.py:262-329) ---------------
    def unique(self, dropna=False, dropnan=False, dropmissing=False, array_type="python",
               limit=None, limit_raise=True):
        return self.df.unique(self.expression, dropna=dropna, dropnan=dropnan,
                              dropmissing=dropmissing, array_type=array_type, limit=limit,
                              limit_raise=limit_raise)

    def nunique(self, dropna=False, dropnan=False, dropmissing=False):
        """The number of distinct values; NaN and a missing value count as
        one each unless dropped."""
        oset = self.df._set(self.expression)
        n = oset.count
        if (dropna or dropnan) and oset.has_nan:
            n -= 1
        if (dropna or dropmissing) and oset.has_null:
            n -= 1
        return n

    def value_counts(self, dropna=False, dropnan=False, dropmissing=False, ascending=False,
                     progress=False, axis=None):
        """A pandas Series value -> number of rows, ordered by the count; a
        missing value is indexed as "missing" (as NaT in a datetime or
        timedelta index).  ``progress`` and ``axis`` change nothing, as in
        vaex_tpu (vaex_tpu/expression.py:278-299)."""
        import pandas as pd
        oset = self.df._set(self.expression, keep_counts=True)
        keys, counts = list(oset.keys), list(oset.counts)
        if oset.has_nan and not (dropna or dropnan):
            keys.append(np.nan)
            counts.append(oset.nan_count)
        if oset.has_null and not (dropna or dropmissing):
            keys.append(np.array("NaT", oset.dtype) if oset.is_temporal else "missing")
            counts.append(oset.null_count)
        counts = np.asarray(counts, np.int64)
        order = np.argsort(counts, kind="stable")
        if not ascending:
            order = order[::-1]
        index = np.array(keys, oset.dtype)[order] if oset.is_temporal else [keys[i] for i in order]
        return pd.Series(counts[order], index=index)

    def isin(self, values, use_hashmap=True):
        """True where the value is one of ``values``: rewrites to
        ``isin_set(expression, <set variable>)``, which the probe B6 serves
        whatever ``use_hashmap`` says (vaex_tpu/expression.py:301).  Against a uint64
        expression, integer values make a uint64 set (a negative one matches
        nothing): numpy would make a list of Python ints past 2^63 beside
        small ones float64, where neighbours past 2^53 merge."""
        if self.df.data_type(self.expression).numpy == np.uint64:
            values = _as_unsigned(values)
        var = self.df.add_variable("isin_set", _set_of(values), unique=True)
        return Expression(self.df, f"isin_set({self.expression}, {var})")

    def map(self, mapper, nan_value=None, missing_value=None, default_value=None,
            allow_missing=False, axis=None):
        """Each value through the dict ``mapper`` (numbers or strings, keys
        and values), as one ``_choose(_ordinal_values(...))`` on the pass
        device (vaex_tpu/expression.py:311).  A value that is not a key gives
        ``default_value``, as ``dict.get`` does (vaex_tpu's ``map`` gives a
        missing value there: ROADMAP, known problems), and a missing value
        without one; NaN that is not a key gives ``nan_value`` where given,
        a missing value gives ``missing_value`` where given, else it stays
        missing.  ``allow_missing`` and ``axis`` are the reference's and
        change nothing: a value that is not a key never raises."""
        items = list(mapper.items())
        if self.df.data_type(self.expression).numpy == np.uint64 and all(
                isinstance(k, (int, np.integer)) and not isinstance(k, bool) for k, _ in items):
            # ints as uint64 keys (numpy would make those past 2^63 beside small
            # ones float64); a key no uint64 holds matches no row
            items = [(k, v) for k, v in items if 0 <= int(k) < 2 ** 64]
            keys = np.array([int(k) for k, _ in items], dtype=np.uint64)
        else:
            keys = _host_values([k for k, _ in items])
        extras = [v for v in (default_value, nan_value, missing_value) if v is not None]
        values = _host_values([v for _, v in items] + extras)[:len(items)]
        oset = _set_of(keys)
        ordinals = np.asarray(oset.map_ordinal(keys), np.int64) if items else None
        # a NaN slot for nan_value; a null slot for missing_value, or where a
        # default would otherwise take the missing rows (their ordinal is -1
        # without one): with no missing_value its choice lies past the table,
        # which gives a missing value
        if nan_value is not None and not oset.has_nan:
            oset.nan_count = 1
        if (missing_value is not None or default_value is not None) and not oset.has_null:
            oset.null_count = 1
        # the choices in ordinal order of the keys, after the default's own
        # slot 0 where a default is given (the ordinals then shift by one)
        shift = int(default_value is not None)
        size = oset.count + shift - int(oset.has_null and missing_value is None)
        choices = np.zeros(size, dtype=values.dtype) if values.dtype != object else (
            np.full(size, "", dtype=object))
        if shift:
            choices[0] = default_value
        if nan_value is not None:
            choices[oset.nan_ordinal + shift] = nan_value
        if missing_value is not None:
            choices[oset.null_ordinal + shift] = missing_value
        if items:  # the mapper's own NaN key before nan_value
            choices[ordinals + shift] = values
        set_var = self.df.add_variable("map_set", oset, unique=True)
        choices_var = self.df.add_variable("map_choices", choices, unique=True)
        codes = f"_ordinal_values({self.expression}, {set_var})"
        if shift:
            codes = f"({codes} + 1)"
        return Expression(self.df, f"_choose({codes}, {choices_var})")


def _as_unsigned(values):
    """Integer values as a uint64 array, without those no uint64 holds;
    anything else as it is."""
    if isinstance(values, np.ndarray) and values.dtype.kind != "O":
        if values.dtype.kind not in "iu":
            return values
        return values[values >= 0].astype(np.uint64) if values.dtype.kind == "i" else (
            values.astype(np.uint64))
    values = list(values)
    if not all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in values):
        return np.asarray(values)
    return np.array([int(v) for v in values if 0 <= int(v) < 2 ** 64], dtype=np.uint64)


def _host_values(values):
    """A list of values as a numpy array; of strings an object array."""
    from .array_types import is_string_array
    if isinstance(values, np.ndarray) and values.dtype != object:
        return values.astype(object) if values.dtype.kind in "UST" else values
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out if is_string_array(out) else np.asarray(list(values))


def _set_of(values):
    """The SortedSet of a host list or array of numbers or strings."""
    from .array_types import is_arrow, is_string_array
    from .ops.setops import SortedSet
    if not is_arrow(values):
        values = _host_values(values)
    oset = SortedSet("string" if is_string_array(values) else values.dtype)
    oset.update(values)
    return oset


install_all_on_expression()

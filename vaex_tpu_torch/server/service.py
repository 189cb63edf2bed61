"""The service: remote calls on the frames it serves
(vaex_tpu/server/service.py).

A call is a method of :data:`ALLOWED_METHODS` with the client's state set
on a copy of the served frame (:meth:`DataFrame.copy` shares the dataset
and the executor, so a frame staged on the card is not staged again per
request).  Its passes run wherever the served frame's columns live; the
result leaves the device only as the numpy arrays and scalars of the wire
(:func:`encode_result`).  Tokens are compared in constant time
(``hmac.compare_digest``).

Every expression a request carries (a method's expressions and selection,
the state's virtual columns, selections and filter, a REST grid's axes and
filter) is checked before a pass evaluates it (:func:`check_expression`):
only the nodes of the expression language, no attribute but
:data:`EXPRESSION_ATTRIBUTES`, and no name but the frame's columns,
variables and functions.  The expressions are ``eval``'d per tile, and an
attribute such as ``x.__init__.__globals__`` would reach Python's builtins.
"""

from __future__ import annotations

import ast
import hmac
import inspect
import time
import traceback

import numpy as np
import torch

from .. import encoding as enc
from .. import registry
from ..expresso import refuse_nodes, validate_expression

# methods a client may invoke on a served DataFrame
ALLOWED_METHODS = {
    "count", "sum", "mean", "std", "var", "min", "max", "minmax", "first",
    "nunique", "limits", "limits_percentage", "percentile_approx",
    "median_approx", "covar", "correlation", "mode", "unique", "evaluate",
    "__len__", "data_type", "groupby_agg",
}
# methods that need trusted mode: a state's pickled functions run only there
TRUSTED_METHODS = {"add_function"}
# the attributes a served expression may name: the methods the expression
# language offers on a value; any other reaches Python's objects rather than
# the data (``x.data.numpy().tofile(path)``)
EXPRESSION_ATTRIBUTES = {"astype"}
# the parameters of the served methods that take expressions
EXPRESSION_PARAMETERS = {"expression", "x", "y", "binby", "order_expression"}


class ExpressionRefused(ValueError):
    """A request's expression is not one of the expression language."""


def _refuse_nodes(expression):
    """Refuse ``expression`` unless it is made of the expression language's
    nodes and :data:`EXPRESSION_ATTRIBUTES` (a string that is no Python
    expression passes: nothing can evaluate it)."""
    try:
        tree = ast.parse(expression, mode="eval")
    except SyntaxError:
        return
    try:
        refuse_nodes(tree, expression, EXPRESSION_ATTRIBUTES)
    except ValueError as e:
        raise ExpressionRefused(str(e)) from None


def check_expression(df, expression):
    """Refuse a request's expression over ``df`` that is not of the
    expression language (:class:`ExpressionRefused`) or names anything but
    the frame's columns, variables and functions (``NameError``, as a pass
    over a missing column raises)."""
    known = (set(df.get_column_names(hidden=True)) | set(df.virtual_columns)
             | set(df.variables) | set(df.functions)
             | set(registry.expression_namespace) | set(registry.expression_namespace_host))
    try:
        validate_expression(str(expression), known, attributes=EXPRESSION_ATTRIBUTES)
    except ValueError as e:  # a node or an attribute outside the language
        raise ExpressionRefused(str(e)) from None


def check_selection(df, selection):
    """A ``selection=`` of a request: a string that is no selection's name
    is an expression (:func:`check_expression`)."""
    for s in _strings(selection):
        if s not in df.selections:
            check_expression(df, s)


def _strings(value):
    if isinstance(value, str):
        yield value
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from _strings(k)
            yield from _strings(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _strings(v)


def check_call(df, method, args, kwargs):
    """Check the expressions of a served call: every string of its
    arguments is held to the language's nodes and attributes, and those in
    an expression's place (:data:`EXPRESSION_PARAMETERS`, ``selection``,
    ``groupby_agg``'s keys and columns) to the frame's names as well."""
    for s in _strings([args, kwargs]):
        _refuse_nodes(s)
    if method == "groupby_agg":
        by, spec = args[0], args[1]
        expressions = list(_strings(by))
        if isinstance(spec, dict):
            expressions += [s[1] for s in spec.values() if isinstance(s, (list, tuple))
                            and len(s) == 2 and isinstance(s[1], str)]
    else:
        bound = inspect.signature(getattr(df, method)).bind(*args, **kwargs)
        expressions = []
        for name, value in bound.arguments.items():
            if name in EXPRESSION_PARAMETERS:
                expressions += _strings(value)
            elif name == "selection":
                check_selection(df, value)
    for expression in expressions:
        check_expression(df, expression)


def check_state(served, df):
    """Check the expressions that a client's state put on ``df``, a copy of
    the ``served`` frame: its virtual columns, selections and filter, each
    unless it is the served frame's own."""
    for name, expression in df.virtual_columns.items():
        if served.virtual_columns.get(name) != expression:
            check_expression(df, expression)
    for name, selection in df.selections.items():
        own = served.selections.get(name)
        if own is None or own.encode() != selection.encode():
            check_expression(df, selection.to_expression(df))
    if df.filtered and df.filter_expression != served.filter_expression:
        check_expression(df, df.filter_expression)


def token_matches(presented, expected):
    """``presented == expected`` for two tokens, in time that does not
    depend on where they differ; a missing or non-string token matches
    nothing."""
    if not isinstance(presented, str) or not isinstance(expected, str):
        return False
    return hmac.compare_digest(presented.encode(), expected.encode())


def encode_result(value):
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    if isinstance(value, (np.ndarray, np.ma.MaskedArray)):
        return {"kind": "array", "data": enc._encode_array(value)}
    if isinstance(value, np.generic):
        return {"kind": "scalar", "dtype": str(value.dtype), "value": value.item()}
    if isinstance(value, (list, tuple)):
        return {"kind": "list", "items": [encode_result(v) for v in value]}
    if isinstance(value, dict):
        return {"kind": "dict", "items": {k: encode_result(v) for k, v in value.items()}}
    return {"kind": "json", "value": value}


def decode_result(spec):
    kind = spec["kind"]
    if kind == "array":
        return enc._decode_array(spec["data"])
    if kind == "scalar":
        return np.dtype(spec["dtype"]).type(spec["value"])
    if kind == "list":
        return [decode_result(v) for v in spec["items"]]
    if kind == "dict":
        return {k: decode_result(v) for k, v in spec["items"].items()}
    return spec["value"]


def _decode_agg_spec(spec):
    """Wire agg specs: strings pass through, {'name': ['sum', 'col']} pairs
    become descriptors."""
    from .. import agg as agg_module
    if isinstance(spec, dict):
        return {name: agg_module.aggregates[s[0]](s[1])
                if isinstance(s, (list, tuple)) and len(s) == 2 and isinstance(s[0], str) else s
                for name, s in spec.items()}
    return spec


class AuthError(PermissionError):
    pass


class Service:
    """``token`` gates all access; ``token_trusted`` additionally unlocks
    trusted mode (pickled functions in state) for requests presenting it."""

    def __init__(self, dataframes: dict, trusted=False, token=None, token_trusted=None):
        self.dataframes = dict(dataframes)
        self.trusted = trusted
        self.token = token
        self.token_trusted = token_trusted

    def check_auth(self, auth=None):
        """-> trusted flag for this request; raises AuthError when locked."""
        auth = auth or {}
        presented = auth.get("token")
        presented_trusted = auth.get("token-trusted")
        if self.token_trusted is not None and token_matches(presented_trusted,
                                                            self.token_trusted):
            return True
        if self.token is not None:
            if not token_matches(presented, self.token):
                raise AuthError("invalid or missing token")
            return self.trusted
        if self.token_trusted is not None and presented_trusted is not None:
            raise AuthError("invalid trusted token")
        return self.trusted

    def list_dataframes(self):
        return {name: {"row_count": df.length_original(),
                       "column_names": df.get_column_names(),
                       "dtypes": {c: str(df.data_type(c).name) for c in df.get_column_names()}}
                for name, df in self.dataframes.items()}

    def call(self, df_name, method, args, kwargs, state=None, trusted=None,
             on_progress=None):
        if df_name not in self.dataframes:
            raise KeyError(f"no such dataframe: {df_name!r}")
        if method not in ALLOWED_METHODS:
            raise PermissionError(f"method {method!r} not allowed")
        df = self.dataframes[df_name].copy()
        if state:
            # the served frame's rows are not the client's to narrow: its
            # state's active range is left out, as vaex_tpu's service does
            state = {k: v for k, v in state.items() if k != "active_range"}
            df.state_set(state, trusted=self.trusted if trusted is None else trusted)
            check_state(self.dataframes[df_name], df)
        check_call(df, method, args, kwargs)
        if on_progress is not None:
            return self._call_with_progress(df, method, args, kwargs, on_progress)
        return self._invoke(df, method, args, kwargs)

    def histogram(self, name, expression, shape=64, vmin=None, vmax=None, selection=None):
        """The counts of a served frame's expression in ``shape`` bins over
        [vmin, vmax] (its minmax where either is None), with their centres:
        the REST flavors' 1-d grid."""
        df = self.dataframes[name]
        check_expression(df, expression)
        check_selection(df, selection)
        limits = [float(vmin), float(vmax)] if vmin is not None and vmax is not None else None
        limits = df.limits(expression, limits)
        counts = df.count(binby=[expression], limits=[limits], shape=shape,
                          selection=selection if selection else False)
        return {"dataset_id": name, "expression": expression,
                "values": [int(c) for c in counts], "centers": _centers(limits, shape),
                "limits": [float(limits[0]), float(limits[1])]}

    def heatmap(self, name, ex, ey, shape_x=128, shape_y=128, selection=None):
        """The counts of two expressions in a [shape_x, shape_y] grid over
        their minmax, with the centres of each axis: the REST flavors' 2-d
        grid."""
        df = self.dataframes[name]
        for expression in (ex, ey):
            check_expression(df, expression)
        check_selection(df, selection)
        limits = df.limits([ex, ey], None)
        counts = df.count(binby=[ex, ey], limits=limits, shape=[shape_x, shape_y],
                          selection=selection if selection else False)
        return {"dataset_id": name, "expression_x": ex, "expression_y": ey,
                "values": [[int(c) for c in row] for row in counts],
                "centers_x": _centers(limits[0], shape_x),
                "centers_y": _centers(limits[1], shape_y),
                "limits": [list(map(float, l)) for l in limits]}

    def _call_with_progress(self, df, method, args, kwargs, on_progress):
        """Forward the executor's progress to ``on_progress``, at most about
        10 times a second and always the last fraction; a False return
        cancels the pass (:class:`~vaex_tpu_torch.execution.UserAbort`)."""
        last = [0.0]

        def forward(fraction):
            now = time.monotonic()
            if fraction >= 1.0 or now - last[0] > 0.1:
                last[0] = now
                return on_progress(float(fraction)) is not False
            return True

        df.executor.signal_progress.connect(forward)
        try:
            return self._invoke(df, method, args, kwargs)
        finally:
            df.executor.signal_progress.disconnect(forward)

    def _invoke(self, df, method, args, kwargs):
        if method == "__len__":
            return len(df)
        if method == "groupby_agg":
            by, agg_spec = args[0], args[1]
            gb = df.groupby(by, agg=_decode_agg_spec(agg_spec), sort=kwargs.get("sort", True))
            return {name: gb.evaluate(name, array_type="numpy")
                    for name in gb.get_column_names()}
        result = getattr(df, method)(*args, **kwargs)
        from ..array_types import is_arrow, to_numpy
        if hasattr(result, "internal"):  # DataType
            result = str(result.name)
        elif is_arrow(result) or isinstance(result, torch.Tensor):
            result = to_numpy(result)
        return result


def _centers(limits, shape):
    lo, hi = float(limits[0]), float(limits[1])
    return [lo + (hi - lo) * (i + 0.5) / shape for i in range(shape)]


class DummyTransport:
    """A client wired to a service in the same process."""

    def __init__(self, service: Service):
        self.service = service

    def request(self, msg, on_progress=None):
        try:
            trusted = self.service.check_auth(msg.get("auth"))
            command = msg["command"]
            if command == "list":
                return {"result": encode_result(self.service.list_dataframes())}
            if command == "call":
                value = self.service.call(msg["df"], msg["method"],
                                          decode_result(msg.get("args", {"kind": "list", "items": []})),
                                          decode_result(msg.get("kwargs", {"kind": "dict", "items": {}})),
                                          state=msg.get("state"), trusted=trusted,
                                          on_progress=on_progress)
                return {"result": encode_result(value)}
            raise ValueError(f"unknown command {command!r}")
        except Exception as e:  # noqa: BLE001 - errors cross the wire
            return {"error": str(e), "traceback": traceback.format_exc()}

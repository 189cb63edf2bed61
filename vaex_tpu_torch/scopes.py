"""Expression evaluation over one tile, in the two stages of a pass
(vaex_tpu/scopes.py:1-205).

:class:`HostScope` evaluates an expression on the host, over a tile's host
arrays (arrow arrays of strings, numpy arrays), with the host half of the
registry (``str_*`` through pyarrow, ``dt_*`` / ``td_*`` through pandas,
the rest through numpy); :class:`HostStr` gives arrow string arrays the
operators.  :func:`expression_is_device` decides the stage: an expression
runs in the host stage if and only if it calls a host-only function, reads
a string column that is not staged as codes, or does what the device stage
does not carry for a temporal value or strings (:class:`HostStage`, found
by trying the expression on an empty tile of its columns' types).  The
executor ships each host-stage result to the pass device as a tile input
(:func:`ship`): numbers as tensors, strings as dictionary codes.

:class:`DeviceScope` is the Mapping ``eval`` uses as locals: names resolve
to :class:`~vaex_tpu_torch.ops.nullable.NA` tiles of physical columns, to
virtual columns (evaluated from their expression the first time the tile
reads them, then kept) or to the pass's variables (a
:class:`~vaex_tpu_torch.ops.setops.DeviceSetHandle` for a set, a tensor for
an array; a datetime or timedelta scalar as an NA of its int64 count with
its dtype), and functions come from the registry.  Torch runs eagerly, so
``eval`` runs once per tile, on whichever device the tile's tensors live.
:func:`column_names` finds the physical columns an expression reads,
through its virtual columns.
"""

from __future__ import annotations

import ast
import functools

import numpy as np
import torch

from . import array_types
from .column import ColumnDictionary, ColumnString, tile_of
from .datatype import dtype_of, host_values, rides_logical, torch_dtype
from .ops.nullable import NA, DictNA, HostStage
from .registry import (expression_namespace, expression_namespace_host, has_function,
                       is_device_function)


@functools.lru_cache(maxsize=4096)
def _parsed(expression):
    """(the names, the names called as functions) of an expression string;
    every pass asks for those of each of its expressions."""
    nodes = list(ast.walk(ast.parse(expression, mode="eval")))
    return (frozenset(node.id for node in nodes if isinstance(node, ast.Name)),
            frozenset(node.func.id for node in nodes
                      if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)))


@functools.lru_cache(maxsize=4096)
def compiled(expression):
    """The code ``eval`` runs for an expression string.  An attribute whose
    name starts with ``_`` is refused: through one
    (``x.__init__.__globals__``) an expression would reach Python's
    builtins, which the scopes' empty ``__builtins__`` does not shut out."""
    tree = ast.parse(expression, mode="eval")
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
            raise ValueError(f"attribute {node.attr!r} is not allowed in expression "
                             f"{expression!r}")
    return compile(tree, "<expr>", "eval")


def _leaves(expression, variables, virtual):
    """(physical column names, variable names) an expression reads, through
    the expressions of the virtual columns it names (vaex_tpu/scopes.py:
    168-190).  A virtual column shadows a physical one of its name; each is
    expanded once, so a chain of them costs its length, not more."""
    columns, used, seen = set(), set(), set()
    pending = [str(expression)]
    while pending:
        names, calls = _parsed(pending.pop())
        for name in names - calls:  # a called name is a function: a frame's UDF among them
            if name in seen:
                continue
            seen.add(name)
            if name in virtual:
                pending.append(virtual[name])
            elif name in variables:
                used.add(name)
            elif not has_function(name):
                columns.add(name)
    return columns, used


def classify_leaves(df, expression):
    """(function names, physical column names, variable names) an
    expression reads, through the frame's virtual columns
    (vaex_tpu/scopes.py:167-198); an unknown name counts as a column, so
    that evaluating it raises a good error."""
    funcs, columns, variables, seen = set(), set(), set(), set()
    pending = [str(expression)]
    while pending:
        expr = pending.pop()
        if expr in seen:
            continue
        seen.add(expr)
        names, calls = _parsed(expr)
        funcs |= calls
        for name in names - funcs:
            if name in df.virtual_columns:
                pending.append(df.virtual_columns[name])
            elif name in df.variables:
                variables.add(name)
            elif has_function(name) and name not in df.column_names:
                funcs.add(name)
            else:
                columns.add(name)
    return {f for f in funcs if has_function(f) or f in df.functions}, columns, variables


def column_names(expression, variables=(), virtual=None):
    """The physical columns an expression reads: the names, through the
    ``virtual`` columns (name -> expression), that are neither registered
    functions nor among ``variables``."""
    return _leaves(expression, variables, virtual or {})[0]


def variable_names(expression, variables, virtual=None):
    """The names of ``variables`` an expression reads, through the
    ``virtual`` columns."""
    return _leaves(expression, variables, virtual or {})[1]


def resolve_variables(variables, names, device):
    """The values a pass on ``device`` sees for the named variables: a
    DeviceSetHandle for a SortedSet (its keys move to the device once per
    set), a tensor for an array."""
    from .ops import setops
    out = {}
    for name in names:
        value = variables[name]
        if isinstance(value, setops.SortedSet):
            out[name] = setops.DeviceSetHandle.of(value, device)
        elif np.ndim(value) == 0 and np.asarray(value).dtype.kind in "bif":
            # a number stays a Python scalar: a 0-d tensor on the left of an
            # operator would take the NA on its right as its operand (a
            # uint64 keeps its tensor of bits)
            out[name] = np.asarray(value).item()
        elif np.asarray(value).dtype.kind in "Mm":
            # a datetime or timedelta: its int64 count in its own unit
            value = np.asarray(value)
            out[name] = NA(torch.as_tensor(value.view(np.int64)).to(device), None, value.dtype)
        else:
            out[name] = setops.choices_tensor(value, device)
    return out


class DeviceScope:
    """Mapping used as eval() locals for one tile (``tile``: name -> NA;
    ``variables``: name -> resolved variable; ``virtual``: name ->
    expression of a virtual column, which shadows a tile column of its
    name)."""

    def __init__(self, tile, variables=None, virtual=None):
        self.virtual = virtual or {}
        self.values = {name: v for name, v in tile.items() if name not in self.virtual}
        self.variables = variables or {}

    def evaluate(self, expression) -> NA:
        if expression in self.values:
            return self.values[expression]
        namespace = dict(expression_namespace)
        namespace["__builtins__"] = {}
        result = eval(compiled(expression), namespace, self)
        if not isinstance(result, NA):
            result = NA(torch.as_tensor(result))
        self.values[expression] = result
        return result

    def __getitem__(self, name):
        if name in self.values:
            return self.values[name]
        if name in self.virtual:
            value = self.values[name] = self.evaluate(self.virtual[name])
            return value
        if name in self.variables:
            return self.variables[name]
        raise KeyError(f"column {name!r} is not in this pass")

    def __iter__(self):
        return iter(self.values)

    def __len__(self):
        return len(self.values)

    def keys(self):
        return self.values.keys()

    def __contains__(self, name):
        return name in self.values or name in self.virtual or name in self.variables


# ---------------------------------------------------------------------------
# the host stage (vaex_tpu/scopes.py:38-160)


class HostStr:
    """An arrow string array inside a host ``eval``: its comparisons (a
    bool array, masked where null) and ``+`` (concatenation)."""

    def __init__(self, ar):
        self.ar = ar

    def _compare(self, name, other):
        import pyarrow.compute as pc
        other = other.ar if isinstance(other, HostStr) else other
        if other is None:
            return np.full(len(self.ar), name == "not_equal")
        out = getattr(pc, name)(_decoded(self.ar), _decoded(other))
        values = np.asarray(out.fill_null(False))
        return np.ma.MaskedArray(values, np.asarray(out.is_null())) if out.null_count else values

    def __eq__(self, other):
        return self._compare("equal", other)

    def __ne__(self, other):
        return self._compare("not_equal", other)

    def __lt__(self, other):
        return self._compare("less", other)

    def __le__(self, other):
        return self._compare("less_equal", other)

    def __gt__(self, other):
        return self._compare("greater", other)

    def __ge__(self, other):
        return self._compare("greater_equal", other)

    def __add__(self, other):
        import pyarrow.compute as pc
        other = other.ar if isinstance(other, HostStr) else other
        return HostStr(pc.binary_join_element_wise(_decoded(self.ar), _decoded(other), ""))

    def __radd__(self, other):
        import pyarrow.compute as pc
        return HostStr(pc.binary_join_element_wise(other, _decoded(self.ar), ""))

    def __len__(self):
        return len(self.ar)

    def __hash__(self):
        return id(self)


def _decoded(v):
    """An arrow dictionary array decoded; anything else as it is."""
    if array_types.is_arrow(v) and hasattr(v, "dictionary"):
        return v.dictionary_decode()
    return v


def _host_unwrap(v):
    return v.ar if isinstance(v, HostStr) else v


def _host_wrap(v):
    """A host function's result as the host scope holds it: strings as a
    HostStr, other arrow arrays (numbers, with nulls) as numpy (masked),
    nested arrow types (a ``str_split``) as they are."""
    if array_types.is_arrow(v):
        if array_types.is_string_array(v):
            return HostStr(v)
        import pyarrow as pa
        if pa.types.is_list(v.type) or pa.types.is_large_list(v.type) or (
                pa.types.is_struct(v.type)):
            return v
        return array_types.to_numpy(v)
    if isinstance(v, np.ndarray) and v.dtype.kind in "OUT" and array_types.is_string_array(v):
        return HostStr(array_types.string_arrow(v))
    return v


def _unwrapping(f):
    def wrapped(*args, **kwargs):
        args = [_host_unwrap(a) for a in args]
        kwargs = {k: _host_unwrap(v) for k, v in kwargs.items()}
        return _host_wrap(f(*args, **kwargs))
    wrapped.__name__ = getattr(f, "__name__", "fn")
    return wrapped


_HOST_NAMESPACE = None


def host_eval_namespace():
    """The host stage's globals: every host implementation, wrapped to
    unwrap :class:`HostStr` arguments and wrap string results."""
    global _HOST_NAMESPACE
    if _HOST_NAMESPACE is None or len(_HOST_NAMESPACE) != len(expression_namespace_host) + 1:
        _HOST_NAMESPACE = {name: _unwrapping(f) for name, f in expression_namespace_host.items()}
        _HOST_NAMESPACE["__builtins__"] = {}
    return _HOST_NAMESPACE


class HostScope:
    """Mapping used as eval() locals for one tile on the host: ``chunks``
    maps the physical columns to host arrays (arrow for strings), virtual
    columns are evaluated the first time they are read, variables are the
    frame's own (a SortedSet, an array, a datetime), and ``functions`` the
    host implementations of the frame's UDFs (vaex_tpu/scopes.py:123)."""

    def __init__(self, chunks, variables=None, virtual=None, n_rows=0, functions=None):
        self.values = {name: _host_wrap(value) for name, value in chunks.items()}
        self.variables = variables or {}
        self.virtual = virtual or {}
        self.n_rows = n_rows
        self.functions = {name: _unwrapping(f) for name, f in (functions or {}).items()}

    def evaluate(self, expression):
        if expression in self.values:
            return self.values[expression]
        with np.errstate(all="ignore"):
            result = eval(compiled(expression), host_eval_namespace(), self)
        self.values[expression] = result
        return result

    def evaluate_raw(self, expression):
        """The expression as a plain host array (a scalar broadcast to the
        tile's rows)."""
        value = _host_unwrap(self.evaluate(expression))
        if np.isscalar(value) or isinstance(value, (np.generic, int, float, bool)):
            value = np.full(self.n_rows, value)
        return value

    def __getitem__(self, name):
        if name in self.values:
            return self.values[name]
        if name in self.virtual:
            value = self.values[name] = self.evaluate(self.virtual[name])
            return value
        if name in self.variables:
            return self.variables[name]
        if name in self.functions:
            return self.functions[name]
        raise KeyError(f"column {name!r} is not in this pass")

    def __iter__(self):
        return iter(self.values)

    def __len__(self):
        return len(self.values)

    def keys(self):
        return self.values.keys()

    def __contains__(self, name):
        return (name in self.values or name in self.virtual or name in self.variables
                or name in self.functions)


def host_chunk(dataset, name, i1, i2):
    """Rows [i1, i2) of a column as a host array: strings as arrow (a
    staged string column's codes as a dictionary array), a tensor column's
    rows copied to the host in their logical dtype, masked where missing."""
    col = dataset[name]
    if isinstance(col, (ColumnString, ColumnDictionary)):
        return col[i1:i2]
    if isinstance(col, np.ndarray):
        return col[i1:i2]
    part = tile_of(col, i1, i2)
    data = host_values(array_types.to_numpy(part.data), dataset.logical.get(name))
    if part.mask is None:
        return data
    return np.ma.MaskedArray(data, array_types.to_numpy(part.mask))


def ship(value, device, n_rows) -> NA:
    """A host-stage result as a tile input on ``device``: strings as
    :class:`DictNA` (a dictionary array's indices and labels as they are,
    plain strings dictionary-encoded), numbers and temporal values as
    tensors with their mask."""
    value = _host_unwrap(value)
    if np.isscalar(value) or isinstance(value, np.generic):
        value = np.full(n_rows, value)
    if array_types.is_string_array(value):
        import pyarrow as pa
        import pyarrow.compute as pc
        arrow = array_types.string_arrow(value)
        if not pa.types.is_dictionary(arrow.type):
            arrow = pc.dictionary_encode(arrow)
        null = arrow.is_null() if arrow.null_count else None
        labels = arrow.dictionary
        codes = np.asarray(arrow.indices.fill_null(0)).astype(np.int32, copy=False)
        mask = None if null is None else np.asarray(null)
        if labels.null_count:  # a row whose label is null is a null row
            null_label = np.asarray(labels.is_null())[codes]
            mask = null_label if mask is None else mask | null_label
        return DictNA(array_types.host_tensor(codes).to(device),
                      None if mask is None else torch.from_numpy(mask).to(device), labels)
    if array_types.is_arrow(value):
        value = array_types.to_numpy(value)
    data, mask = array_types.data_and_mask(value)
    if data.dtype == object:
        raise TypeError(f"a host-stage result of {type(data[0]).__name__ if len(data) else 'objects'}"
                        " cannot go to the device")
    logical = data.dtype if rides_logical(data.dtype) else None
    return NA(array_types.to_tensor(data, device),
              None if mask is None else torch.from_numpy(np.ascontiguousarray(mask)).to(device),
              logical)


def expression_is_device(df, expression) -> bool:
    """True where the expression runs in the device stage of a pass
    (vaex_tpu/scopes.py:200-215): it calls no host-only function, reads no
    string column that is not staged as codes, and, where it reads a
    temporal value or staged strings, the device stage carries what it
    does (tried once on an empty tile of its columns' types, remembered
    per dataset node)."""
    expression = str(expression)
    funcs, columns, variables = classify_leaves(df, expression)
    if not all(is_device_function(f) for f in funcs):
        return False
    dataset = df.dataset
    columns = [c for c in columns if c in dataset]
    if any(isinstance(dataset[c], ColumnString) for c in columns):
        return False
    tried = any(isinstance(dataset[c], ColumnDictionary) or rides_logical(
        dataset.logical.get(c)) for c in columns) or any(
        _is_special_variable(df.variables[v]) for v in variables)
    if not tried:
        return True
    key = ("stage", expression, frozenset(df.virtual_columns.items()), tuple(sorted(variables)))
    memo = dataset.remembered
    if key not in memo:
        memo[key] = not _needs_host(df, expression, columns, variables)
    return memo[key]


def _is_special_variable(value):
    from .ops import setops
    if isinstance(value, setops.SortedSet):
        return value.is_string or value.is_temporal
    if array_types.is_arrow(value):
        return True
    return np.asarray(value).dtype.kind in "MmOUST"


def _needs_host(df, expression, columns, variables):
    """True where the device stage raises :class:`HostStage` for the
    expression over an empty tile of its columns' types."""
    from .ops import setops
    dataset = df.dataset
    tile = {}
    for name in columns:
        col = dataset[name]
        if isinstance(col, ColumnDictionary):
            tile[name] = DictNA(torch.empty(0, dtype=torch.int32), None, col.labels)
            continue
        logical = dataset.logical.get(name)
        dtype = logical if logical is not None else dtype_of(col).numpy
        tile[name] = NA(torch.empty(0, dtype=torch_dtype(dtype)), None,
                        logical if rides_logical(logical) else None)
    resolved = {}
    for name in variables:
        value = df.variables[name]
        if isinstance(value, setops.SortedSet) and not value.is_string:
            empty = torch.empty(0, dtype=torch.int64 if value.is_temporal or value.is_unsigned64
                                else torch_dtype(value.dtype))
            resolved[name] = setops.DeviceSetHandle(empty, 0, value.has_nan, value.has_null,
                                                    value.is_temporal, {}, value.is_unsigned64)
        else:
            resolved.update(resolve_variables(df.variables, [name], torch.device("cpu")))
    try:
        DeviceScope(tile, resolved, df.virtual_columns).evaluate(expression)
    except HostStage:
        return True
    except Exception:  # noqa: BLE001 - the pass itself raises it, with its data
        return False
    return False

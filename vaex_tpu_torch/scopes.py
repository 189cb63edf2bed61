"""Expression evaluation over one tile.

:class:`DeviceScope` is the Mapping ``eval`` uses as locals: names resolve
to :class:`~vaex_tpu_torch.ops.nullable.NA` tiles of physical columns, to
virtual columns (evaluated from their expression the first time the tile
reads them, then kept) or to the pass's variables (a
:class:`~vaex_tpu_torch.ops.setops.DeviceSetHandle` for a set, a tensor for
an array; a datetime or timedelta scalar as an NA of its int64 count with
its dtype), and functions come from the registry.  Torch runs eagerly, so
``eval`` runs once per tile, on whichever device the tile's tensors live.
:func:`column_names` finds the physical columns an expression reads,
through its virtual columns.  The host scope of ``vaex_tpu`` (strings,
datetimes) is not ported yet.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from .ops.nullable import NA
from .registry import expression_namespace, has_function


def _names(expression):
    tree = ast.parse(str(expression), mode="eval")
    return {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}


def _leaves(expression, variables, virtual):
    """(physical column names, variable names) an expression reads, through
    the expressions of the virtual columns it names (vaex_tpu/scopes.py:
    168-190).  A virtual column shadows a physical one of its name; each is
    expanded once, so a chain of them costs its length, not more."""
    columns, used, seen = set(), set(), set()
    pending = [str(expression)]
    while pending:
        for name in _names(pending.pop()):
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
        for node in ast.walk(ast.parse(expr, mode="eval")):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                funcs.add(node.func.id)
        for name in _names(expr) - funcs:
            if name in df.virtual_columns:
                pending.append(df.virtual_columns[name])
            elif name in df.variables:
                variables.add(name)
            elif has_function(name) and name not in df.get_column_names(hidden=True):
                funcs.add(name)
            else:
                columns.add(name)
    return {f for f in funcs if has_function(f)}, columns, variables


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
        result = eval(compile(expression, "<expr>", "eval"), namespace, self)
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

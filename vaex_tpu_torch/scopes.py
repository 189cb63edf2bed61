"""Expression evaluation over one tile.

:class:`DeviceScope` is the Mapping ``eval`` uses as locals: names resolve
to :class:`~vaex_tpu_torch.ops.nullable.NA` tiles of physical columns or to
the pass's variables (a :class:`~vaex_tpu_torch.ops.setops.DeviceSetHandle`
for a set, a tensor for an array), and functions come from the registry.
Torch runs eagerly, so ``eval`` runs once per tile, on whichever device the
tile's tensors live.  :func:`column_names` finds the physical columns an
expression reads.  Virtual columns and the host scope of ``vaex_tpu``
(strings, datetimes) are not ported yet.
"""

from __future__ import annotations

import ast

import torch

from .ops.nullable import NA
from .registry import expression_namespace, has_function


def _names(expression):
    tree = ast.parse(str(expression), mode="eval")
    return {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}


def column_names(expression, variables=()):
    """The names an expression reads that are neither registered functions
    nor among ``variables``."""
    return {name for name in _names(expression)
            if not has_function(name) and name not in variables}


def variable_names(expression, variables):
    """The names of ``variables`` an expression reads."""
    return {name for name in _names(expression) if name in variables}


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
        else:
            out[name] = setops.choices_tensor(value, device)
    return out


class DeviceScope:
    """Mapping used as eval() locals for one tile (``tile``: name -> NA;
    ``variables``: name -> resolved variable)."""

    def __init__(self, tile, variables=None):
        self.values = dict(tile)
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
        return name in self.values or name in self.variables

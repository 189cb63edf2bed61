"""Named selections: boolean row subsets kept on a DataFrame under a name.

The counterpart of ``vaex_tpu/selections.py:27-143``.  A selection is a
tree of boolean expressions combined by the modes replace / and / or / xor
/ subtract, an inversion, a drop of NaN and missing values, or a lasso
(``pnpoly``).  Every selection lowers to one boolean expression
(:meth:`Selection.to_expression`), which a statistic's ``selection=``
evaluates per tile like any expression: no separate mask pass.  Unlike
``vaex_tpu``, the port's filter is not a selection (``DataFrame.filter``).
"""

from __future__ import annotations

import numpy as np

# the name under which a state file keeps a frame's filter, vaex_tpu's name
# of its filter selection (vaex_tpu/selections.py:16)
FILTER_SELECTION_NAME = "__filter__"

_combine = {
    "and": lambda a, b: f"({a}) & ({b})",
    "or": lambda a, b: f"({a}) | ({b})",
    "xor": lambda a, b: f"({a}) ^ ({b})",
    "subtract": lambda a, b: f"({a}) & ~({b})",
    "replace": lambda a, b: b,
}


def _combined(previous, mode, expression, df):
    if previous is None or mode == "replace":
        return expression
    if mode not in _combine:
        raise ValueError(f"selection mode must be one of {sorted(_combine)}, got {mode!r}")
    return _combine[mode](previous.to_expression(df), expression)


class Selection:
    def to_expression(self, df) -> str:
        raise NotImplementedError

    def dependencies(self, df):
        """The physical columns the selection reads."""
        from .scopes import column_names
        return column_names(self.to_expression(df), df.variables, df.virtual_columns)

    def fingerprint(self, df):
        from .utils import fingerprint
        return fingerprint("selection", self.to_expression(df))

    def encode(self):
        raise NotImplementedError

    @staticmethod
    def decode(spec):
        """The selection that :meth:`encode` gave ``spec``."""
        previous = Selection.decode(spec["previous"]) if spec.get("previous") else None
        kind = spec["type"]
        if kind == "expression":
            return SelectionExpression(spec["expression"], previous, spec.get("mode", "replace"))
        if kind == "invert":
            return SelectionInvert(Selection.decode(spec["selection"]))
        if kind == "dropna":
            return SelectionDropNa(spec.get("column_names"), spec.get("drop_nan", True),
                                   spec.get("drop_masked", True))
        if kind == "lasso":
            return SelectionLasso(spec["x"], spec["y"], spec["xs"], spec["ys"], previous,
                                  spec.get("mode", "replace"))
        raise ValueError(f"unknown selection type {kind!r}")


class SelectionExpression(Selection):
    """A boolean expression, combined with ``previous_selection`` by
    ``mode``."""

    def __init__(self, expression, previous_selection=None, mode="replace"):
        self.expression = str(expression)
        self.previous_selection = previous_selection
        self.mode = mode

    def to_expression(self, df):
        return _combined(self.previous_selection, self.mode, self.expression, df)

    def encode(self):
        return {"type": "expression", "expression": self.expression, "mode": self.mode,
                "previous": self.previous_selection.encode() if self.previous_selection
                else None}


class SelectionInvert(Selection):
    def __init__(self, selection):
        self.selection = selection

    def to_expression(self, df):
        return f"~({self.selection.to_expression(df)})"

    def encode(self):
        return {"type": "invert", "selection": self.selection.encode()}


class SelectionDropNa(Selection):
    """The rows where none of ``column_names`` (default: every column) is
    NaN (``drop_nan``) or missing (``drop_masked``)."""

    def __init__(self, column_names=None, drop_nan=True, drop_masked=True):
        self.column_names = column_names
        self.drop_nan = drop_nan
        self.drop_masked = drop_masked

    def to_expression(self, df):
        parts = []
        for name in self.column_names or df.get_column_names():
            if self.drop_nan and self.drop_masked:
                parts.append(f"notna({name})")
            elif self.drop_nan:
                parts.append(f"~isnan({name})")
            elif self.drop_masked:
                parts.append(f"~ismissing({name})")
        return " & ".join(f"({p})" for p in parts) if parts else "True"

    def encode(self):
        return {"type": "dropna", "column_names": self.column_names,
                "drop_nan": self.drop_nan, "drop_masked": self.drop_masked}


class SelectionLasso(Selection):
    """The rows whose (x, y) lie inside a polygon: ``pnpoly`` over the
    vertices, which ride as the frame's variables."""

    def __init__(self, x, y, xseq, yseq, previous_selection=None, mode="replace"):
        self.x = str(x)
        self.y = str(y)
        self.xseq = np.asarray(xseq, np.float64)
        self.yseq = np.asarray(yseq, np.float64)
        self.previous_selection = previous_selection
        self.mode = mode

    def to_expression(self, df):
        xs = df.add_variable("lasso_x", self.xseq, unique=True)
        ys = df.add_variable("lasso_y", self.yseq, unique=True)
        return _combined(self.previous_selection, self.mode,
                         f"pnpoly({self.x}, {self.y}, {xs}, {ys})", df)

    def encode(self):
        return {"type": "lasso", "x": self.x, "y": self.y, "xs": self.xseq.tolist(),
                "ys": self.yseq.tolist(), "mode": self.mode,
                "previous": self.previous_selection.encode() if self.previous_selection
                else None}

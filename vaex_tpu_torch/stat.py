"""The statistic expression algebra (the counterpart of ``vaex_tpu/stat.py``).

``stat.mean("x") / stat.std("x")`` builds a tree of statistic nodes;
``.calculate(df, binby=...)`` queues every leaf statistic as a delayed
task, so that all of them ride one pass (one aggregation task per binner
stack and selection), and combines the grids with numpy operators.  The
limits of ``binby`` are read once, before the leaves, so that no leaf
needs a pass of its own.  This module imports only numpy; the frame does
the rest.
"""

from __future__ import annotations

import numpy as np

from .delayed import delayed


class Expression:
    """A node of the algebra; ``calculate`` evaluates the tree on a frame."""

    def calculate(self, df, binby=(), limits=None, shape=128, selection=None, delay=False):
        binby = [str(b) for b in (binby if isinstance(binby, (list, tuple)) else [binby])]
        if binby:
            limits = df._axis_limits(binby, limits)
        args = {"binby": binby, "limits": limits, "shape": shape, "selection": selection}
        return df._delay(delay, self._promise(df, args))

    def _promise(self, df, args):
        """A promise of the node's value, with the leaves queued on ``df``."""
        raise NotImplementedError

    def __add__(self, other):
        return _BinaryOp(self, _lift(other), np.add)

    def __radd__(self, other):
        return _BinaryOp(_lift(other), self, np.add)

    def __sub__(self, other):
        return _BinaryOp(self, _lift(other), np.subtract)

    def __rsub__(self, other):
        return _BinaryOp(_lift(other), self, np.subtract)

    def __mul__(self, other):
        return _BinaryOp(self, _lift(other), np.multiply)

    def __rmul__(self, other):
        return _BinaryOp(_lift(other), self, np.multiply)

    def __truediv__(self, other):
        return _BinaryOp(self, _lift(other), np.divide)

    def __rtruediv__(self, other):
        return _BinaryOp(_lift(other), self, np.divide)

    def __pow__(self, other):
        return _BinaryOp(self, _lift(other), np.power)

    def __neg__(self):
        return _UnaryOp(self, np.negative)


def _lift(value):
    return value if isinstance(value, Expression) else _Constant(value)


class _Constant(Expression):
    def __init__(self, value):
        self.value = value

    def _promise(self, df, args):
        @delayed
        def give():
            return self.value
        return give()


class _UnaryOp(Expression):
    def __init__(self, operand, op):
        self.operand = operand
        self.op = op

    def _promise(self, df, args):
        @delayed
        def apply(value):
            return self.op(np.asarray(value))
        return apply(self.operand._promise(df, args))


class _BinaryOp(Expression):
    def __init__(self, left, right, op):
        self.left = left
        self.right = right
        self.op = op

    def _promise(self, df, args):
        @delayed
        def apply(a, b):
            with np.errstate(divide="ignore", invalid="ignore"):
                return self.op(np.asarray(a), np.asarray(b))
        return apply(self.left._promise(df, args), self.right._promise(df, args))


class _StatisticsCalculation(Expression):
    """A leaf: one of the frame's statistics of one expression (or of two,
    for ``covar`` and ``correlation``)."""

    def __init__(self, name, *expressions):
        self.name = name
        self.expressions = [str(e) for e in expressions]

    def _promise(self, df, args):
        method = getattr(df, self.name)
        if self.name == "count":
            return method(self.expressions[0] if self.expressions else "*", delay=True, **args)
        return method(*self.expressions, delay=True, **args)


def count(expression="*"):
    return _StatisticsCalculation("count", expression)


def sum(expression):  # noqa: A001
    return _StatisticsCalculation("sum", expression)


def mean(expression):
    return _StatisticsCalculation("mean", expression)


def std(expression):
    return _StatisticsCalculation("std", expression)


def var(expression):
    return _StatisticsCalculation("var", expression)


def min(expression):  # noqa: A001
    return _StatisticsCalculation("min", expression)


def max(expression):  # noqa: A001
    return _StatisticsCalculation("max", expression)


def covar(x, y):
    return _StatisticsCalculation("covar", x, y)


def correlation(x, y):
    return _StatisticsCalculation("correlation", x, y)

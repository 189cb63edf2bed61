"""Aggregator descriptors: ``vaex_tpu_torch.agg.count/sum/mean/var/std/
covar/corr/min/max/first``.

A descriptor is a small declarative object; ``add_tasks`` binds it to a
DataFrame and a binner stack by registering an :class:`AggOperation` on the
pass's shared :class:`~vaex_tpu_torch.tasks.TaskAggregations`.  An
operation is one of three kinds, each batched per tile with the others of
its kind:

* ``additive`` (:class:`OpCount`, :class:`OpSum`): one column, or the
  implicit count, for the grid kernels B1-B3 (:mod:`.ops.grid_plan`);
* ``moments`` (:class:`OpMoments`): base columns and the terms formed from
  them, for the moment kernels B4/B5 (:mod:`.ops.grid_moments`);
* ``extreme`` (:class:`OpMin`, :class:`OpMax`): one column, with a validity,
  for the min/max kernel B3x (:func:`.ops.grid_plan.grid_extremes`);
* ``first`` (:class:`OpFirst`): a value column and an order column; the
  pass takes two per-bin mins through the same kernel.

A descriptor's ``selection=`` (a boolean expression) sends its operation to
the aggregation task of that selection, whose bin indices drop the rows the
selection marks False: the kernels need no validity column for it.

Dtype contract (vaex_tpu/agg.py): count -> int64; sum upcasts int/bool ->
int64 and float -> float64; mean, var, std, covar and corr are float64
finishers; min, max and first keep the input dtype.  ``datetime64`` and
``timedelta64`` columns travel as int64 and their min, max and first are
viewed back (:func:`view_logical`); NaT never wins.  Sums of uint columns
need uint64 arithmetic torch barely has, and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .datatype import NAT, DataType
from .delayed import delayed
from .ops.grid_extreme import identity
from .utils import find_valid_name

PENDING = "not ported yet (ROADMAP queue A5)"




def extract_central(grid, ndim):
    """Strip the +3 edges from the leading ndim axes."""
    return grid[tuple(slice(2, -1) for _ in range(ndim))]


def view_logical(grid, dtype):
    """A host int64 grid as the ``datetime64`` / ``timedelta64`` dtype it
    stands for (vaex_tpu/agg.py:519-525); a grid of a widened unsigned column
    cast back to the unsigned ``dtype`` (the wrap turns the signed
    identities of an empty min / max cell into the unsigned ones, and an
    int64 sum into the uint64 sum mod 2^64); any other grid as it is."""
    if dtype is not None and DataType(dtype).is_temporal:
        return np.asarray(grid).view(DataType(dtype).numpy)
    if dtype is not None and DataType(dtype).is_unsigned:
        return np.asarray(grid).astype(DataType(dtype).numpy)
    return grid


class AggOperation:
    """One aggregator bound into a pass."""

    name = "op"
    kind = "additive"

    def __init__(self, expressions, dtype_in=None):
        self.expressions = [str(e) for e in expressions if e is not None]
        self.dtype_in = dtype_in

    def initial_state(self, G, device):
        raise NotImplementedError

    def kernel_input(self, ctx):
        """("count", None) for the implicit count, ("int", int64 tensor) or
        ("float", float tensor); rows that must not count carry 0."""
        raise NotImplementedError

    def apply_kernel(self, state, sums):
        return state + sums

    def get_result(self, state, shape):
        return state.reshape(shape)


class OpCount(AggOperation):
    name = "count"

    def initial_state(self, G, device):
        return torch.zeros(G, dtype=torch.int64, device=device)

    def kernel_input(self, ctx):
        if not self.expressions:
            return ("count", None)
        x = ctx.expr(self.expressions[0])
        valid = None
        if x.data.is_floating_point():
            valid = ~torch.isnan(x.data)
        if x.mask is not None:
            valid = ~x.mask if valid is None else valid & ~x.mask
        if valid is None:  # every row of a bin counts
            return ("count", None)
        return ("int", valid.to(torch.int64))


class OpSum(AggOperation):
    name = "sum"

    def initial_state(self, G, device):
        dt = DataType(self.dtype_in).upcast()
        if dt.is_unsigned:
            if DataType(self.dtype_in).numpy.itemsize == 8:
                raise NotImplementedError(f"sum of a {self.dtype_in} column is {PENDING}")
            # narrower unsigned values are summed as int64: the same bits as
            # the uint64 sum (view_logical)
            return torch.zeros(G, dtype=torch.int64, device=device)
        return torch.zeros(G, dtype=dt.torch, device=device)

    def kernel_input(self, ctx):
        x = ctx.expr(self.expressions[0])
        d = x.data
        if d.is_floating_point():
            kind = "float"  # the kernel widens f32 and skips NaN itself
            if d.dtype not in (torch.float32, torch.float64):
                d = d.to(torch.float64)
        else:
            kind = "int"
            d = d.to(torch.int64)
        if x.mask is not None:
            d = d.masked_fill(x.mask, 0)
        return (kind, d)


class OpMoments(AggOperation):
    """Per-bin sums of moment terms over base expressions, in the contract of
    :mod:`.ops.grid_moments`: ``terms`` index ``expressions``.  One op per
    descriptor, where vaex_tpu schedules one ``OpSumMoment`` per column; the
    pass batches the ops of a tile into as few kernel calls as the kernels'
    ``MAX_BASES`` / ``MAX_TERMS`` allow.  The state and the result are
    (counts [n_count, ...] int64, sums [n_float, ...] float64)."""

    name = "moments"
    kind = "moments"

    def __init__(self, expressions, terms):
        super().__init__(expressions)
        self.terms = [tuple(t) for t in terms]
        self.n_count = len([t for t in self.terms if t[0] < 0])

    def initial_state(self, G, device):
        return (torch.zeros((self.n_count, G), dtype=torch.int64, device=device),
                torch.zeros((len(self.terms) - self.n_count, G), dtype=torch.float64,
                            device=device))

    def apply_kernel(self, state, sums):
        return (state[0] + sums[0], state[1] + sums[1])

    def get_result(self, state, shape):
        return tuple(s.reshape(s.shape[0], *shape) for s in state)


class OpExtreme(AggOperation):
    """Per-bin min or max (``mode``) of one column, in its own dtype; empty
    cells hold the identity (+-inf, or the integer dtype's max / min; True /
    False for a bool min / max), and NaN, NaT and missing values drop
    (vaex_tpu/agg.py:417-516)."""

    kind = "extreme"
    mode = None

    @property
    def name(self):
        return self.mode

    def _state_dtype(self):
        dt = DataType(self.dtype_in)
        if dt.is_temporal:
            return torch.int64
        if dt.numpy.kind not in "biuf":
            raise NotImplementedError(f"{self.mode} of a {dt.name} column is {PENDING}")
        return dt.torch

    def initial_state(self, G, device):
        dtype = self._state_dtype()
        if dtype == torch.bool:
            return torch.full((G,), self.mode == "min", dtype=dtype, device=device)
        return torch.full((G,), identity(dtype, self.mode), dtype=dtype, device=device)

    def extreme_input(self, ctx):
        """(values, valid or None) of one tile, as the min/max kernel takes
        them."""
        return _extreme_input(ctx.expr(self.expressions[0]), self.dtype_in)

    def apply_kernel(self, state, grid):
        if state.dtype == torch.bool:
            # over {0, 1} the widened column's identities are the int64 ones
            grid = grid.clamp(0, 1).to(torch.bool)
            return state & grid if self.mode == "min" else state | grid
        if not state.dtype.is_floating_point and state.dtype != grid.dtype:
            # a narrower integer column was widened: so were its identities
            info = torch.iinfo(state.dtype)
            grid = grid.clamp(info.min, info.max)
        grid = grid.to(state.dtype)
        return torch.minimum(state, grid) if self.mode == "min" else torch.maximum(state, grid)


def _extreme_input(x, dtype_in):
    """(column, valid or None) of an NA for the min/max kernel: int64,
    float64 or float32; the NaT rows of a datetime or timedelta are invalid
    (vaex_tpu/agg.py:56-66)."""
    valid = None if x.mask is None else ~x.mask
    data = x.data
    if data.is_floating_point():  # narrower floats widen to float32
        if data.dtype not in (torch.float32, torch.float64):
            data = data.to(torch.float32)
    else:  # ints and bools widen to int64
        data = data.to(torch.int64)
    data = data.contiguous()
    if dtype_in is not None and DataType(dtype_in).is_temporal:
        not_nat = data != NAT
        valid = not_nat if valid is None else valid & not_nat
    return data, valid


class OpMin(OpExtreme):
    mode = "min"


class OpMax(OpExtreme):
    mode = "max"


class OpFirst(AggOperation):
    """Per bin the value of the row with the smallest order value; among
    equal orders the earliest row wins, across tiles too.  Rows whose value
    or order is NaN or missing take no part; a bin without such a row holds
    0 (vaex_tpu/agg.py:528-566, ops/gridagg.py:84-127).  The order keeps
    its type: int64 for an int, bool or temporal order, so that nanosecond
    timestamps past 2^53 stay apart, float64 for a float order (vaex_tpu
    compares every order as float64).  The state is (values [G] in the
    input dtype, orders [G] int64 or float64 starting at the type's
    maximum, seen [G] bool): ``seen`` lets an order equal to that maximum
    win over an empty cell."""

    name = "first"
    kind = "first"

    def __init__(self, expressions, dtype_in=None, order_float=True):
        super().__init__(expressions, dtype_in)
        self.order_dtype = torch.float64 if order_float else torch.int64

    def initial_state(self, G, device):
        dt = DataType(self.dtype_in)
        dtype = torch.int64 if dt.is_temporal else dt.torch
        return (torch.zeros(G, dtype=dtype, device=device),
                torch.full((G,), identity(self.order_dtype, "min"), dtype=self.order_dtype,
                           device=device),
                torch.zeros(G, dtype=torch.bool, device=device))

    def first_input(self, ctx):
        """(values, order in the state's type, valid or None) of one tile."""
        x = ctx.expr(self.expressions[0])
        order = ctx.expr(self.expressions[1])
        valid = None
        for na in (x, order):
            if na.mask is not None:
                valid = ~na.mask if valid is None else valid & ~na.mask
            if na.data.is_floating_point():
                ok = ~torch.isnan(na.data)
                valid = ok if valid is None else valid & ok
        if DataType(self.dtype_in).is_temporal:
            ok = x.data != NAT
            valid = ok if valid is None else valid & ok
        return x.data, order.data.to(self.order_dtype).contiguous(), valid

    def apply_first(self, state, tile_values, tile_order, found):
        values, orders, seen = state
        take = found & ((tile_order < orders) | ~seen)
        return (torch.where(take, tile_values.to(values.dtype), values),
                torch.where(take, tile_order, orders), seen | found)

    def get_result(self, state, shape):
        return state[0].reshape(shape)


def selection_expression(selection):
    """A ``selection=`` argument as a boolean expression string, or None.
    Only ad-hoc expressions are ported: the rows they mark False drop from
    the aggregation, as the rows a filter drops do."""
    if selection is None or selection is False:
        return None
    if selection is True or isinstance(selection, (list, tuple)):
        raise NotImplementedError(
            f"named selections (selection=True, select()) and lists of selections are {PENDING}")
    return str(selection)


class AggregatorDescriptor:
    def __init__(self, name, expression=None, selection=None, edges=False):
        self.name = name
        self.expression = str(expression) if expression is not None else None
        self.selection = selection_expression(selection)
        self.edges = edges

    @property
    def expressions(self):
        return [self.expression] if self.expression and self.expression != "*" else []

    def __repr__(self):
        return f"vaex_tpu_torch.agg.{self.name}({self.expression!r})"

    def pretty_name(self, name=None):
        return find_valid_name(f"{name or self.expression}_{self.name}")

    def add_tasks(self, df, binners):
        """Schedule on the shared TaskAggregations; returns [promise]."""
        raise NotImplementedError

    def _input_dtype(self, df):
        if self.expression is None or self.expression == "*":
            return DataType(np.dtype("int64"))
        return DataType(df.data_type(self.expression))

    def logical_dtype(self, df):
        """The ``datetime64`` / ``timedelta64`` dtype the result's int64
        stands for (:func:`view_logical`), or None."""
        return None


class AggregatorDescriptorBasic(AggregatorDescriptor):
    def __init__(self, name, expression, op_class, selection=None, edges=False):
        super().__init__(name, expression, selection, edges)
        self.op_class = op_class

    def add_tasks(self, df, binners):
        op = self.op_class(self.expressions, dtype_in=self._input_dtype(df))
        return [df.executor.schedule_aggregation(df, binners, op, self.selection)]

    def logical_dtype(self, df):
        dtype = self._input_dtype(df)
        if self.name in ("min", "max", "first"):
            widened = dtype.is_unsigned and dtype.numpy.itemsize in (2, 4)
            return dtype.numpy if dtype.is_temporal or widened else None
        if self.name == "sum" and dtype.is_unsigned:
            return np.dtype("uint64")
        return None


class AggregatorDescriptorFirst(AggregatorDescriptorBasic):
    """The value at the smallest ``order_expression`` (the expression itself
    when none is given; vaex_tpu/agg.py:1374-1388)."""

    def __init__(self, expression, order_expression=None, selection=None, edges=False):
        super().__init__("first", expression, OpFirst, selection, edges)
        self.order_expression = str(order_expression if order_expression is not None
                                    else expression)

    def add_tasks(self, df, binners):
        order_float = DataType(df.data_type(self.order_expression)).numpy.kind == "f"
        op = OpFirst([self.expression, self.order_expression], dtype_in=self._input_dtype(df),
                     order_float=order_float)
        return [df.executor.schedule_aggregation(df, binners, op, self.selection)]


class AggregatorDescriptorMean(AggregatorDescriptor):
    """mean = sum / count; empty cells are NaN."""

    def __init__(self, expression, selection=None, edges=False):
        super().__init__("mean", expression, selection, edges)

    def add_tasks(self, df, binners):
        [sum_task] = AggregatorDescriptorBasic("sum", self.expression, OpSum,
                                               self.selection).add_tasks(df, binners)
        [count_task] = AggregatorDescriptorBasic("count", self.expression, OpCount,
                                                 self.selection).add_tasks(df, binners)

        @delayed
        def finish(s, c):
            # torch divides int64 by int64 in float32: divide in float64
            mean = s.to(torch.float64) / c.to(torch.float64)
            return torch.where(c > 0, mean, torch.nan)
        return [finish(sum_task, count_task)]


# moment terms over bases [x] and [x, y] (ops/grid_moments.py): every term
# counts only rows where all the bases it names are valid
VAR_TERMS = [(0, -1, -1, -1), (0, 0, -1, -1), (-1, -1, 0, -1)]  # x, x*x, count
# x*y, x and y where both are valid, count of such rows; corr adds x*x, y*y
COVAR_TERMS = [(0, 1, -1, -1), (0, -1, 1, -1), (1, -1, 0, -1), (-1, -1, 0, 1)]
CORR_TERMS = COVAR_TERMS + [(0, 0, 1, -1), (1, 1, 0, -1)]


def _moments(df, binners, expressions, terms, selection=None):
    op = OpMoments(expressions, terms)
    return df.executor.schedule_aggregation(df, binners, op, selection)


class AggregatorDescriptorVar(AggregatorDescriptor):
    """var/std via raw moments E[x^2] - E[x]^2 (vaex_tpu/agg.py:1089-1121)."""

    def __init__(self, expression, std=False, ddof=0, selection=None, edges=False):
        super().__init__("std" if std else "var", expression, selection, edges)
        self.std = std
        self.ddof = ddof

    def add_tasks(self, df, binners):
        moments = _moments(df, binners, [self.expression], VAR_TERMS, self.selection)
        std, ddof = self.std, self.ddof

        @delayed
        def finish(r):
            (n,), (m1, m2) = r
            n = n.to(torch.float64)
            mean = m1 / n
            # E[x^2] >= E[x]^2: clamp the rounding residue (NaN stays NaN)
            var = m2 / n - mean ** 2
            var = torch.maximum(var, torch.zeros_like(var))
            if ddof:
                var = torch.where(n > ddof, var * n / (n - ddof), torch.nan)
            return torch.sqrt(var) if std else var
        return [finish(moments)]


class AggregatorDescriptorCovar(AggregatorDescriptor):
    """Per-cell covariance E[xy] - E[x]E[y] over the rows where both x and y
    are valid (vaex_tpu/agg.py:1124-1164)."""

    def __init__(self, x, y, selection=None, edges=False, ddof=0):
        super().__init__("covar", x, selection, edges)
        self.y = str(y)
        self.ddof = ddof

    def pretty_name(self, name=None):
        return find_valid_name(name or f"{self.expression}_{self.y}_{self.name}")

    def add_tasks(self, df, binners):
        moments = _moments(df, binners, [self.expression, self.y], COVAR_TERMS,
                           self.selection)
        ddof = self.ddof

        @delayed
        def finish(r):
            (c,), (mxy, mx, my) = r
            c = c.to(torch.float64)
            cov = mxy / c - (mx / c) * (my / c)
            if ddof:
                cov = cov * c / (c - ddof)
            return cov
        return [finish(moments)]


class AggregatorDescriptorCorr(AggregatorDescriptorCovar):
    """Per-cell Pearson correlation (H2O q9; vaex_tpu/agg.py:1167-1195)."""

    def __init__(self, x, y, selection=None, edges=False):
        super().__init__(x, y, selection, edges)
        self.name = "corr"

    def add_tasks(self, df, binners):
        moments = _moments(df, binners, [self.expression, self.y], CORR_TERMS,
                           self.selection)

        @delayed
        def finish(r):
            (c,), (mxy, mx, my, mxx, myy) = r
            c = c.to(torch.float64)
            ex, ey = mx / c, my / c
            cov = mxy / c - ex * ey
            vx = mxx / c - ex ** 2
            vy = myy / c - ey ** 2
            r = cov / torch.sqrt(vx * vy)
            # a constant operand has no variance: NaN, not a 0-division's inf
            return torch.where(torch.isfinite(r), r, torch.nan)
        return [finish(moments)]


def count(expression="*", selection=None, edges=False):
    return AggregatorDescriptorBasic("count", expression, OpCount, selection, edges)


def sum(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("sum", expression, OpSum, selection, edges)


def mean(expression, selection=None, edges=False):
    return AggregatorDescriptorMean(expression, selection, edges)


def min(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("min", expression, OpMin, selection, edges)


def max(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("max", expression, OpMax, selection, edges)


def first(expression, order_expression=None, selection=None, edges=False):
    return AggregatorDescriptorFirst(expression, order_expression, selection, edges)


def var(expression, ddof=0, selection=None, edges=False):
    return AggregatorDescriptorVar(expression, std=False, ddof=ddof, selection=selection,
                                   edges=edges)


def std(expression, ddof=0, selection=None, edges=False):
    return AggregatorDescriptorVar(expression, std=True, ddof=ddof, selection=selection,
                                   edges=edges)


def covar(x, y, selection=None, edges=False, ddof=0):
    return AggregatorDescriptorCovar(x, y, selection=selection, edges=edges, ddof=ddof)


def corr(x, y, selection=None, edges=False):
    return AggregatorDescriptorCorr(x, y, selection=selection, edges=edges)


aggregates = {"count": count, "sum": sum, "mean": mean, "min": min, "max": max,
              "first": first, "std": std, "var": var, "corr": corr, "covar": covar}

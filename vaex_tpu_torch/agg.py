"""Aggregator descriptors: ``vaex_tpu_torch.agg.count/sum/mean/var/std/
covar/corr/min/max/first``, the percentiles (``percentile_approx``,
``median_approx``, ``median``) and the top-k (``max_n``, ``min_n``,
``nth_largest``, ``nth_smallest``).

A descriptor is a small declarative object; ``add_tasks`` binds it to a
DataFrame and a binner stack by registering an :class:`AggOperation` on the
pass's shared :class:`~vaex_tpu_torch.tasks.TaskAggregations`.  An
operation is one of six kinds; the first three are batched per tile with
the others of their kind:

* ``additive`` (:class:`OpCount`, :class:`OpSum`): one column, or the
  implicit count, for the grid kernels B1-B3 (:mod:`.ops.grid_plan`);
* ``moments`` (:class:`OpMoments`): base columns and the terms formed from
  them, for the moment kernels B4/B5 (:mod:`.ops.grid_moments`);
* ``extreme`` (:class:`OpMin`, :class:`OpMax`): one column, with a validity,
  for the min/max kernel B3x (:func:`.ops.grid_plan.grid_extremes`);
* ``first`` (:class:`OpFirst`): a value column and an order column; the
  pass takes two per-bin mins through the same kernel;
* ``percentile`` (:class:`OpPercentile`): a count grid of [cell, value bin]
  through the additive plan;
* ``own`` (:class:`OpTopK`, :class:`OpPercentileExact`): each folds a tile
  itself with torch sorts and gathers (XLA sorts in the reference, no
  Pallas kernel).

A descriptor's ``selection=`` (a boolean expression) sends its operation to
the aggregation task of that selection, whose bin indices drop the rows the
selection marks False: the kernels need no validity column for it.

Dtype contract (vaex_tpu/agg.py): count -> int64; sum upcasts int/bool ->
int64 and float -> float64; mean, var, std, covar and corr are float64
finishers; min, max, first and the top-k keep the input dtype;
percentiles are float64.  ``datetime64`` and
``timedelta64`` columns travel as int64 and their min, max and first are
viewed back (:func:`view_logical`); NaT never wins.  Unsigned columns
travel as int64 too: their sums add the bits mod 2^64, which is the uint64
sum; the min / max of a uint64 column compare its order image
(``bits ^ (1 << 63)``, :func:`~.datatype.order_image`) and its mean adds
the unsigned floats of the values.  The nunique ops (:class:`OpNUniquePresence`,
:class:`OpNUniqueSorted`) count distinct set ordinals per cell.
"""

from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

from . import tracing
from .datatype import NAT, UINT64, DataType, order_image
from .delayed import delayed
from .expression import Expression
from .ops.binners import grid_size
from .ops.grid_extreme import identity
from .ops.nullable import unsigned_float
from .utils import find_valid_name, fingerprint

# vaex_tpu/agg.py:891: a presence grid of more (cell, value) pairs than this
# switches nunique to the sorted pairs
NUNIQUE_PRESENCE_MAX = 1 << 26


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
        grid = np.asarray(grid)
        if grid.dtype.kind == "f":  # a mean: truncated as numpy's, NaN (empty) to NaT
            empty = np.isnan(grid)
            grid = np.where(empty, NAT, np.trunc(np.where(empty, 0, grid))).astype(np.int64)
        return grid.view(DataType(dtype).numpy)
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

    def initial_state(self, G, device, rows):
        """The state of ``G`` cells; ``rows`` is the pass's row count."""
        raise NotImplementedError

    def kernel_input(self, ctx):
        """("count", None) for the implicit count, ("int", int64 tensor) or
        ("float", float tensor); rows that must not count carry 0."""
        raise NotImplementedError

    def apply_kernel(self, state, sums):
        return state + sums

    def get_result(self, state, shape):
        return state.reshape(shape)

    def merge(self, parts, mesh):
        """The shards' states of a sharded pass as one, on the mesh's first
        device: a sum (vaex_tpu/agg.py:84-89, ``psum``); an int64 sum wraps
        mod 2^64 as on one device."""
        return _reduced(parts, "sum", mesh)


def _reduced(parts, op, mesh):
    """``collectives.reduce`` of each tensor of the shards' states (a
    tensor or a tuple of them)."""
    from .parallel import collectives
    if isinstance(parts[0], tuple):
        return tuple(collectives.reduce([p[j] for p in parts], op, mesh)
                     for j in range(len(parts[0])))
    return collectives.reduce(parts, op, mesh)


class OpCount(AggOperation):
    """The rows whose value is neither missing nor NaN; a NaT counts, as
    vaex_tpu counts it (vaex_tpu/agg.py:108-113), but not in ``skip_nat``'s
    count, a mean's."""

    name = "count"
    skip_nat = False

    def initial_state(self, G, device, rows):
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
        if self.skip_nat and _is_temporal(x):
            valid = _not_nat(x, valid)
        if valid is None:  # every row of a bin counts
            return ("count", None)
        return ("int", valid.to(torch.int64))


class OpSum(AggOperation):
    name = "sum"

    def initial_state(self, G, device, rows):
        dt = DataType(self.dtype_in).upcast()
        if dt.is_unsigned:
            # unsigned values (uint64: their bits) are summed as int64 mod
            # 2^64: the same bits as the uint64 sum (view_logical)
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
        if _is_temporal(x):  # NaT rows add nothing
            d = d.masked_fill(~_not_nat(x, None), 0)
        if x.mask is not None:
            d = d.masked_fill(x.mask, 0)
        return (kind, d)


class OpCountValid(OpCount):
    """A mean's count: NaT rows do not count."""

    skip_nat = True


class OpSumFloat(OpSum):
    """A float64 sum: a mean's sum of an integer, unsigned, bool or temporal
    column (NaT left out), added in float64 as numpy's mean adds, where an
    int64 sum would wrap mod 2^64; uint64 bits enter as their unsigned
    float."""

    def initial_state(self, G, device, rows):
        return torch.zeros(G, dtype=torch.float64, device=device)

    def kernel_input(self, ctx):
        x = ctx.expr(self.expressions[0])
        if x.logical == UINT64:
            d = unsigned_float(x.data)
            return ("float", d if x.mask is None else d.masked_fill(x.mask, 0.0))
        # an int64 column goes to the kernel as it is: a float channel of
        # int64 kind, converted on load (ops/grid_additive.py)
        return ("float", super().kernel_input(ctx)[1])


def _is_temporal(x):
    return x.logical is not None and np.dtype(x.logical).kind in "mM"


def _not_nat(x, valid):
    """``valid`` (or every row) without the NaT rows of a temporal tile."""
    ok = x.data != NAT
    return ok if valid is None else valid & ok


class OpSumMoment(OpSum):
    """Per-bin float64 sum of ``x ** moment`` over the rows whose x is
    neither missing nor NaN (vaex_tpu/agg.py:308-338), through the additive
    plan as one float column."""

    def __init__(self, expressions, moment, dtype_in=None):
        super().__init__(expressions, dtype_in)
        self.moment = moment
        self.name = f"summoment{moment}"

    def initial_state(self, G, device, rows):
        return torch.zeros(G, dtype=torch.float64, device=device)

    def kernel_input(self, ctx):
        x = ctx.expr(self.expressions[0])
        v = unsigned_float(x.data) if x.logical == UINT64 else x.data.to(torch.float64)
        valid = ~torch.isnan(v)
        if x.mask is not None:
            valid &= ~x.mask
        return ("float", torch.where(valid, v ** self.moment, 0.0))


class OpMoments(AggOperation):
    """Per-bin sums of moment terms over base expressions, in the contract of
    :mod:`.ops.grid_moments`: ``terms`` index ``expressions``.  One op per
    descriptor, where vaex_tpu schedules one ``OpSumMoment`` per column; the
    pass batches the ops of a tile into as few kernel calls as the kernels'
    ``MAX_BASES`` / ``MAX_TERMS`` allow.  The state and the result are
    (counts [n_count, ...] int64, sums [n_float, ...] float64)."""

    name = "moments"
    kind = "moments"

    def __init__(self, expressions, terms, shifts=None):
        super().__init__(expressions)
        self.terms = [tuple(t) for t in terms]
        # per expression the shift its base is read less: a 0-d tensor (a
        # first pass), a [G] table a cell (a second pass) or None
        self.shifts = None if shifts is None else list(shifts)
        self.n_count = len([t for t in self.terms if t[0] < 0])

    def initial_state(self, G, device, rows):
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
            raise TypeError(f"{self.mode} of a {dt.name} column: strings are counted, not "
                            f"ordered")
        return dt.torch

    @property
    def _unsigned64(self):
        return self.dtype_in is not None and DataType(self.dtype_in).numpy == UINT64

    def initial_state(self, G, device, rows):
        dtype = self._state_dtype()
        if dtype == torch.bool:
            return torch.full((G,), self.mode == "min", dtype=dtype, device=device)
        return torch.full((G,), identity(dtype, self.mode), dtype=dtype, device=device)

    def extreme_input(self, ctx):
        """(values, valid or None) of one tile, as the min/max kernel takes
        them."""
        return _extreme_input(ctx.expr(self.expressions[0]), self.dtype_in)

    def get_result(self, state, shape):
        # a uint64 state holds order images: back to the bits
        return (order_image(state) if self._unsigned64 else state).reshape(shape)

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

    def merge(self, parts, mesh):
        """``pmin`` / ``pmax`` (vaex_tpu/agg.py:449-452, 500-503)."""
        return _reduced(parts, self.mode, mesh)


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
    if dtype_in is not None and DataType(dtype_in).numpy == UINT64:
        data = order_image(data)  # the kernel compares int64s
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

    def initial_state(self, G, device, rows):
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
            valid = _not_nat(x, valid)
        if _is_temporal(order):  # a NaT order takes no part
            valid = _not_nat(order, valid)
        order_data = order.data
        if order.logical == UINT64:  # the order of uint64 values is their image's
            order_data = (unsigned_float(order_data) if self.order_dtype == torch.float64
                          else order_image(order_data))
        return x.data, order_data.to(self.order_dtype).contiguous(), valid

    def apply_first(self, state, tile_values, tile_order, found):
        values, orders, seen = state
        take = found & ((tile_order < orders) | ~seen)
        return (torch.where(take, tile_values.to(values.dtype), values),
                torch.where(take, tile_order, orders), seen | found)

    def get_result(self, state, shape):
        return state[0].reshape(shape)

    def merge(self, parts, mesh):
        """The winner by the global row order (vaex_tpu/agg.py:548-566): the
        shards, which hold contiguous rows, fold in order and a later one
        takes a cell only where its order is strictly smaller, so among
        equal orders the earliest row wins."""
        from .parallel import collectives
        values, orders, seen = (collectives.gather([p[j] for p in parts], mesh)
                                for j in range(3))
        state = (values[0], orders[0], seen[0])
        for tile in zip(values[1:], orders[1:], seen[1:]):
            state = self.apply_first(state, *tile)
        return state


def interp_order_stats(sval, starts, nv, pct):
    """The ``pct`` percentile of each segment of a column sorted within its
    segments (vaex_tpu/ops/gridagg.py:454-471): ``starts`` [M] each
    segment's first row, ``nv`` [M] float64 its count of valid values (its
    NaN sort past them), interpolated linearly between the two bracketing
    order statistics as numpy and pandas do; equal brackets give the value
    itself (an all-inf segment stays inf), an empty segment NaN."""
    if not sval.numel():
        return torch.full_like(nv, torch.nan)
    p = torch.minimum(torch.clamp(pct / 100.0 * (nv - 1), min=0.0),
                      torch.clamp(nv - 1, min=0.0))
    lo = torch.floor(p)
    last = sval.shape[0] - 1
    v_lo = sval[torch.clamp(starts + lo.to(torch.int64), 0, last)]
    v_hi = sval[torch.clamp(starts + torch.ceil(p).to(torch.int64), 0, last)]
    value = torch.where(v_lo == v_hi, v_lo, v_lo + (p - lo) * (v_hi - v_lo))
    return torch.where(nv > 0, value, torch.nan)


def sort_pairs(cells, values, descending=False):
    """(cells, values) sorted by (cell, value): a stable sort by value, then
    a stable sort by cell (values ascending, or descending)."""
    values, order = torch.sort(values, descending=descending, stable=True)
    cells, order = torch.sort(cells[order], stable=True)
    return cells, values[order]


def _segments(sorted_cells, G):
    """(first row, row count) of each cell 0 .. G-1 in ascending cells."""
    bins = torch.arange(G, dtype=sorted_cells.dtype, device=sorted_cells.device)
    starts = torch.searchsorted(sorted_cells, bins, side="left")
    return starts, torch.searchsorted(sorted_cells, bins, side="right") - starts


def _as_float(x):
    """An NA's values as float64 (a uint64 one's unsigned values)."""
    return unsigned_float(x.data) if x.logical == UINT64 else x.data.to(torch.float64)


def _counted(x, idx, G, dtype_in):
    """The rows of a tile that count toward a cell: in [0, G), their value
    neither missing nor NaN (nor NaT in a datetime or timedelta)."""
    valid = (idx >= 0) & (idx < G)
    if x.mask is not None:
        valid &= ~x.mask
    if x.data.is_floating_point():
        valid &= ~torch.isnan(x.data)
    if DataType(dtype_in).is_temporal:
        valid &= x.data != NAT
    return valid


class OpTopK(AggOperation):
    """Per cell the k largest (or smallest) values in descending (ascending)
    order (vaex_tpu/agg.py:629-716): per tile one (cell, value) sort puts
    each cell's best values at its segment's start, and the [G, k] state
    merges with a tile's by a row-wise sort of both.  A slot no value fills
    holds the identity: NaN for a float column once finished, the int
    type's min (max) for an int column, as the reference leaves it."""

    name = "topk"
    kind = "own"  # folds each tile itself (``update``)

    def __init__(self, expressions, k, largest=True, dtype_in=None):
        super().__init__(expressions, dtype_in)
        self.k = int(k)
        self.largest = largest

    def _dtype(self):
        return torch.int64 if DataType(self.dtype_in).is_temporal else DataType(self.dtype_in).torch

    def _fill(self):
        return identity(self._dtype(), "max" if self.largest else "min")

    def initial_state(self, G, device, rows):
        return torch.full((G, self.k), self._fill(), dtype=self._dtype(), device=device)

    def update(self, state, idx, G, ctx):
        x = ctx.expr(self.expressions[0])
        valid = _counted(x, idx, G, self.dtype_in)
        with tracing.host_read("nth-rows", 2):
            cells, values = idx[valid], x.data[valid]
        if x.logical == UINT64:  # uint64 values order as their images
            values = order_image(values)
        if not values.numel():
            return state
        cells, values = sort_pairs(cells, values, descending=self.largest)
        starts, counts = _segments(cells, G)
        slots = torch.arange(self.k, device=state.device)
        best = values.to(state.dtype)[(starts[:, None] + slots).clamp(max=values.numel() - 1)]
        tile = torch.where(slots < counts[:, None], best, self._fill())
        both = torch.cat([state, tile], dim=1).sort(dim=1, descending=self.largest).values
        return both[:, :self.k]

    def merge(self, parts, mesh):
        """Every shard's [G, k] best values gathered, then the k best of them
        per cell (vaex_tpu/agg.py:701-706, ``all_gather``)."""
        from .parallel import collectives
        both = torch.cat(collectives.gather(parts, mesh), dim=1)
        return both.sort(dim=1, descending=self.largest).values[:, :self.k]

    def get_result(self, state, shape):
        grid = state
        if grid.is_floating_point():
            grid = torch.where(grid == self._fill(), torch.nan, grid)
        if DataType(self.dtype_in).numpy == UINT64:
            grid = order_image(grid)
        return grid.reshape(tuple(shape) + (self.k,))


def _percentages(percentage):
    return [float(p) for p in (percentage if isinstance(percentage, (list, tuple))
                               else [percentage])]


class OpPercentile(AggOperation):
    """Per cell approximate percentiles from a [G, B] count grid over
    [vmin, vmax] (vaex_tpu/agg.py:727-803): each tile counts its valid rows
    at the flat index ``cell * B + bin`` through the additive plan (B1, B2,
    B3), and the finish places each bracketing order statistic inside its
    bin by its rank there, then interpolates between the two as numpy does.
    An empty cell gives NaN."""

    name = "percentile"
    kind = "percentile"

    def __init__(self, expressions, percentages, vmin, vmax, bins, dtype_in=None):
        super().__init__(expressions, dtype_in)
        self.percentages = _percentages(percentages)
        self.vmin, self.vmax, self.bins = float(vmin), float(vmax), int(bins)

    def initial_state(self, G, device, rows):
        return torch.zeros(G * self.bins, dtype=torch.int64, device=device)

    def count_index(self, ctx, idx, G):
        """Each row's flat index into the [G, B] count grid, -1 where it does
        not count."""
        x = ctx.expr(self.expressions[0])
        valid = _counted(x, idx, G, self.dtype_in)
        v = _as_float(x)
        width = (self.vmax - self.vmin) or 1.0
        b = ((torch.where(valid, v, self.vmin) - self.vmin) / width * self.bins)
        b = b.to(torch.int64).clamp(0, self.bins - 1)
        flat = idx.to(torch.int64) * self.bins + b
        return torch.where(valid, flat, -1).to(torch.int32)

    def get_result(self, state, shape):
        counts = state.reshape(-1, self.bins).to(torch.float64)
        cum = torch.cumsum(counts, dim=1)
        n = cum[:, -1]
        w = ((self.vmax - self.vmin) or 1.0) / self.bins
        rows = torch.arange(counts.shape[0], device=counts.device)

        def value_at_rank(r):
            k = torch.clamp((cum <= r[:, None]).sum(dim=1), 0, self.bins - 1)
            before = torch.where(k > 0, cum[rows, torch.clamp(k - 1, min=0)], 0.0)
            inbin = counts[rows, k]
            frac = torch.where(inbin > 0, (r - before + 0.5) / inbin, 0.5)
            return self.vmin + (k + torch.clamp(frac, 0.0, 1.0)) * w

        outs = []
        for pct in self.percentages:
            p = torch.minimum(torch.clamp(pct / 100.0 * (n - 1), min=0.0),
                              torch.clamp(n - 1, min=0.0))
            lo = torch.floor(p)
            v_lo = value_at_rank(lo)
            value = v_lo + (p - lo) * (value_at_rank(torch.ceil(p)) - v_lo)
            outs.append(torch.where(n > 0, value, torch.nan))
        return _stack_percentiles(outs, shape)


def _stack_percentiles(outs, shape):
    if len(outs) == 1:
        return outs[0].reshape(shape)
    return torch.stack(outs, dim=1).reshape(tuple(shape) + (len(outs),))


class OpPercentileExact(AggOperation):
    """Exact per-cell percentiles (vaex_tpu/agg.py:805-891): every tile
    writes its (cell, value) pairs into a buffer of the pass's rows, and
    the finish sorts them once by (cell, value) and interpolates between
    the two bracketing order statistics of each cell (numpy and pandas).
    Rows that do not count keep the buffer's fill, the cell G and +inf,
    which sorts past every real cell.  The state is (values [rows] float64,
    cells [rows] int32, [rows written])."""

    name = "percentile_exact"
    kind = "own"

    def __init__(self, expressions, percentages, dtype_in=None):
        super().__init__(expressions, dtype_in)
        self.percentages = _percentages(percentages)

    def initial_state(self, G, device, rows):
        self.G = int(G)
        return (torch.full((rows,), torch.inf, dtype=torch.float64, device=device),
                torch.full((rows,), self.G, dtype=torch.int32, device=device), [0])

    def update(self, state, idx, G, ctx):
        values, cells, written = state
        x = ctx.expr(self.expressions[0])
        valid = _counted(x, idx, G, self.dtype_in)
        start, n = written[0], idx.shape[0]
        values[start:start + n] = torch.where(valid, _as_float(x), torch.inf)
        cells[start:start + n] = torch.where(valid, idx, G)
        return values, cells, [start + n]

    def merge(self, parts, mesh):
        raise NotImplementedError("an exact percentile does not merge row shards: under a mesh "
                                  "the descriptor takes the count grid, and a groupby's median "
                                  "rides the fused exchange (vaex_tpu/agg.py:881-885)")

    def get_result(self, state, shape):
        cells, values = sort_pairs(state[1], state[0])
        starts, n = _segments(cells, self.G)
        outs = [interp_order_stats(values, starts, n.to(torch.float64), pct)
                for pct in self.percentages]
        return _stack_percentiles(outs, shape)


class OpNUniquePresence(AggOperation):
    """nunique per cell through a presence grid over (cell, value ordinal)
    (vaex_tpu/agg.py:568-626): each tile counts its rows at the flat index
    ``cell * n_values + ordinal`` into the op's own [G * n_values] count
    grid through the additive plan (B1, B2 or B3 by the grid's size), and a
    value is present in a cell where its count is above 0.  The ordinals
    come from ``_ordinal_values`` (B6) against the set a pre-pass built; NaN
    and missing values have ordinals of their own, which ``dropnan`` /
    ``dropmissing`` subtract."""

    name = "nunique"
    kind = "presence"

    def __init__(self, ordinal_expression, n_values, nan_ordinal=-1, null_ordinal=-1,
                 dropnan=False, dropmissing=False):
        super().__init__([ordinal_expression])
        self.n_values = int(n_values)
        self.bins = builtins.max(self.n_values, 1)  # count cells per grid cell
        self.drop = [o for o, d in ((nan_ordinal, dropnan), (null_ordinal, dropmissing))
                     if d and o >= 0]

    def initial_state(self, G, device, rows):
        return torch.zeros(G * self.bins, dtype=torch.int64, device=device)

    def _pairs(self, ctx, idx, G):
        """(valid, cell, ordinal) of one tile's rows."""
        code = ctx.expr(self.expressions[0]).data.to(torch.int64)
        valid = (idx >= 0) & (idx < G) & (code >= 0) & (code < self.n_values)
        return valid, idx.to(torch.int64), code

    def count_index(self, ctx, idx, G):
        """Each row's flat index into the [G, n_values] grid, -1 where it
        does not count (int32: the grid holds at most 2^26 cells)."""
        valid, cell, code = self._pairs(ctx, idx, G)
        return torch.where(valid, cell * self.bins + code, -1).to(torch.int32)

    def get_result(self, state, shape):
        present = state.reshape(-1, self.bins) > 0
        counts = present.sum(dim=1, dtype=torch.int64)
        for o in self.drop:
            counts -= present[:, o].to(torch.int64)
        return counts.reshape(shape)


class OpNUniqueSorted(OpNUniquePresence):
    """nunique per cell where the presence grid would pass
    ``NUNIQUE_PRESENCE_MAX`` cells (vaex_tpu/agg.py:894-973): the distinct
    (cell, ordinal) pairs as one sorted int64 tensor on the pass device;
    each tile's pairs are sorted and deduplicated (``torch.unique``) and
    merged into it by one more, so memory follows the distinct pairs.  The
    finish counts the pairs per cell (``bincount``).  XLA sorts in the
    reference, no Pallas kernel."""

    kind = "own"

    def initial_state(self, G, device, rows):
        self.G = int(G)
        return torch.empty(0, dtype=torch.int64, device=device)

    def update(self, state, idx, G, ctx):
        valid, cell, code = self._pairs(ctx, idx, G)
        pairs = torch.unique(cell[valid] * self.bins + code[valid])
        return torch.unique(torch.cat([state, pairs])) if state.numel() else pairs

    def merge(self, parts, mesh):
        """The shards' distinct pairs gathered and made unique again
        (vaex_tpu/agg.py:948-953)."""
        from .parallel import collectives
        return torch.unique(torch.cat(collectives.gather(parts, mesh)))

    def get_result(self, state, shape):
        cells = torch.div(state, self.bins, rounding_mode="floor")
        counts = torch.bincount(cells, minlength=self.G)
        for o in self.drop:
            counts -= torch.bincount(cells[state % self.bins == o], minlength=self.G)
        return counts.reshape(shape)


def selection_expression(selection, df):
    """A ``selection=`` argument as a boolean expression string, or None:
    None or False is none, True the selection "default" of ``df``, the name
    of one of its selections that selection's expression, a
    :class:`~vaex_tpu_torch.selections.Selection` its expression, anything
    else an expression (vaex_tpu/dataframe.py:543-557).  The rows it marks
    False drop from the aggregation, as the rows a filter drops do."""
    from .selections import Selection
    if selection is None or selection is False:
        return None
    if isinstance(selection, (list, tuple)):
        raise TypeError("a list of selections is taken by the DataFrame's statistics "
                        "(df.count(..., selection=[...])), not by one aggregator")
    if selection is True:
        if "default" not in df.selections:
            raise ValueError("selection=True but no selection is active")
        selection = "default"
    if isinstance(selection, Selection):
        return selection.to_expression(df)
    name = str(selection)
    if name in df.selections:
        return df.selections[name].to_expression(df)
    return name


def _not_strings(df, expression, name):
    """The DataType of ``expression``; raises TypeError for strings where the
    aggregator ``name`` is not a count."""
    dtype = DataType(df.data_type(expression))
    if dtype.is_text and name not in ("count", "nunique"):
        raise TypeError(f"{name} of strings ({expression!r}): strings are counted, "
                        f"not ordered or added")
    return dtype


class AggregatorDescriptor:
    def __init__(self, name, expression=None, selection=None, edges=False):
        self.name = name
        self.expression = str(expression) if expression is not None else None
        # kept as given (None, True, a name, a Selection or an expression)
        # and resolved against the frame in add_tasks
        self.selection = (selection.expression if isinstance(selection, Expression)
                          else selection or None)
        self.edges = edges

    @property
    def expressions(self):
        return [self.expression] if self.expression and self.expression != "*" else []

    def __repr__(self):
        return f"vaex_tpu_torch.agg.{self.name}({self.expression!r})"

    def fingerprint(self):
        return fingerprint("agg-desc", self.name, self.expression, str(self.selection))

    def pretty_name(self, name=None, df=None):
        return find_valid_name(f"{name or self.expression}_{self.name}")

    def add_tasks(self, df, binners, progress=None):
        """Schedule on the shared TaskAggregations; returns [promise].
        ``progress`` changes nothing, as in vaex_tpu: a pass's progress is
        the executor's."""
        raise NotImplementedError

    def prepare(self, df, binners):
        """Queue the pre-pass statistics the aggregation needs (a count
        grid's limits) as delayed tasks, so that every descriptor's share
        one pass before the aggregations are scheduled."""
        return None

    def _input_dtype(self, df):
        """The input's DataType; strings are counted (``count``,
        ``nunique``) and nothing else: vaex_tpu gives a dictionary code
        for their min or max, which the port does not copy."""
        if self.expression is None or self.expression == "*":
            return DataType(np.dtype("int64"))
        return _not_strings(df, self.expression, self.name)

    def logical_dtype(self, df):
        """The ``datetime64`` / ``timedelta64`` dtype the result's int64
        stands for (:func:`view_logical`), or None."""
        return None


class AggregatorDescriptorBasic(AggregatorDescriptor):
    def __init__(self, name, expression, op_class, selection=None, edges=False, op_kwargs=None):
        super().__init__(name, expression, selection, edges)
        self.op_class = op_class
        self.op_kwargs = op_kwargs or {}

    def add_tasks(self, df, binners, progress=None):
        op = self.op_class(self.expressions, dtype_in=self._input_dtype(df), **self.op_kwargs)
        return [df.executor.schedule_aggregation(df, binners, op,
                                                 selection_expression(self.selection, df))]

    def logical_dtype(self, df):
        dtype = self._input_dtype(df)
        if self.name in ("min", "max", "first"):
            widened = dtype.is_unsigned and dtype.numpy.itemsize in (2, 4, 8)
            return dtype.numpy if dtype.is_temporal or widened else None
        if self.name == "sum" and dtype.is_unsigned:
            return np.dtype("uint64")
        if self.name == "sum" and dtype.is_temporal:  # numpy's: a timedelta64 sum
            if dtype.numpy.kind == "M":
                raise TypeError(f"sum of a {dtype.name} column: numpy adds no datetimes")
            return dtype.numpy
        return None


class AggregatorDescriptorFirst(AggregatorDescriptorBasic):
    """The value at the smallest ``order_expression`` (the expression itself
    when none is given; vaex_tpu/agg.py:1374-1388)."""

    def __init__(self, expression, order_expression=None, selection=None, edges=False):
        super().__init__("first", expression, OpFirst, selection, edges)
        self.order_expression = str(order_expression if order_expression is not None
                                    else expression)

    def add_tasks(self, df, binners, progress=None):
        order_float = DataType(df.data_type(self.order_expression)).numpy.kind == "f"
        op = OpFirst([self.expression, self.order_expression], dtype_in=self._input_dtype(df),
                     order_float=order_float)
        return [df.executor.schedule_aggregation(df, binners, op,
                                                 selection_expression(self.selection, df))]


class AggregatorDescriptorPercentile(AggregatorDescriptor):
    """Per-cell percentile or median (vaex_tpu/agg.py:1198-1268): exact (one
    sort of the collected pairs, :class:`OpPercentileExact`) while the frame
    has at most ``EXACT_MAX_ROWS`` rows of a numeric expression, else from a
    binned count grid over the expression's [min, max]
    (:class:`OpPercentile`, ``percentile_shape`` bins, halved while the
    [G, B] grid is past 2^26 cells).  ``exact=True`` (or
    ``percentile_shape=None``) forces the sort and raises where it cannot
    run; ``exact=False`` forces the count grid.  The count grid needs the
    limits: :meth:`prepare` queues their minmax pass so that several
    descriptors share one."""

    # the collected pairs of one op: 2^27 rows are 1.5 GiB
    EXACT_MAX_ROWS = 1 << 27
    # the most cells of the approximate [G, B] count grid
    APPROX_MAX_CELLS = 1 << 26

    def __init__(self, expression, percentage=50.0, percentile_shape=1024, selection=None,
                 edges=False, exact=None):
        super().__init__("percentile", expression, selection, edges)
        self.percentage = percentage
        self.exact = exact if exact is not None else (True if percentile_shape is None else None)
        self.percentile_shape = int(percentile_shape or 1024)
        self._limits = None

    def _exact_possible(self, df):
        """Sorted pairs cannot merge row shards: a sharded executor takes
        the count grid (vaex_tpu/agg.py:1228-1240)."""
        if getattr(df.executor, "sharded", None) is not None:
            return False
        return (self._input_dtype(df).numpy.kind in "biufmM"
                and df.dataset_for_execution().row_count <= self.EXACT_MAX_ROWS)

    def prepare(self, df, binners):
        """Queue the limits pass of the count grid, where one is needed."""
        if self.exact is not False and self._exact_possible(df):
            return
        if self._limits is None:
            self._limits = df.minmax(self.expression, delay=True)

    def add_tasks(self, df, binners, progress=None):
        exact_ok = self.exact is not False and self._exact_possible(df)
        if self.exact is True and not exact_ok:
            raise ValueError(f"an exact percentile takes a numeric expression over at most "
                             f"{self.EXACT_MAX_ROWS} rows; use exact=False")
        selection = selection_expression(self.selection, df)
        if exact_ok:
            op = OpPercentileExact([self.expression], self.percentage,
                                   dtype_in=self._input_dtype(df))
            return [df.executor.schedule_aggregation(df, binners, op, selection)]
        if self._limits is not None and self._limits.done:
            vmin, vmax = (float(v) for v in self._limits.get())
        else:
            vmin, vmax = (float(v) for v in df.minmax(self.expression))
        G = grid_size(binners)
        bins = self.percentile_shape
        while G * bins > self.APPROX_MAX_CELLS and bins > 64:
            bins //= 2
        op = OpPercentile([self.expression], self.percentage, vmin, vmax, bins,
                          dtype_in=self._input_dtype(df))
        return [df.executor.schedule_aggregation(df, binners, op, selection)]


class AggregatorDescriptorTopK(AggregatorDescriptor):
    """The k largest or smallest values per cell as a [..., k] grid, or the
    ``nth`` of them (vaex_tpu/agg.py:1271-1297)."""

    def __init__(self, expression, k, largest=True, nth=None, selection=None, edges=False):
        super().__init__("max_n" if largest else "min_n", expression, selection, edges)
        self.k = int(k)
        self.largest = largest
        self.nth_index = nth

    def pretty_name(self, name=None, df=None):
        suffix = self.name if self.nth_index is None else f"{self.name}_{self.nth_index}"
        return find_valid_name(f"{name or self.expression}_{suffix}")

    def add_tasks(self, df, binners, progress=None):
        op = OpTopK([self.expression], self.k, largest=self.largest,
                    dtype_in=self._input_dtype(df))
        task = df.executor.schedule_aggregation(df, binners, op,
                                                selection_expression(self.selection, df))
        if self.nth_index is None:
            return [task]
        i = self.nth_index

        @delayed
        def pick(grid):
            return grid[..., i]
        return [pick(task)]

    def logical_dtype(self, df):
        dtype = self._input_dtype(df)
        return dtype.numpy if dtype.is_temporal or dtype.numpy == UINT64 else None


class AggregatorDescriptorMean(AggregatorDescriptor):
    """mean = sum / count; empty cells are NaN.  The sum of any column that
    is not a float one adds in float64 (:class:`OpSumFloat`), as numpy's
    mean does: an int64 sum would wrap.  The mean of a datetime64 or
    timedelta64 column leaves its NaT rows out and is of its dtype, the
    float mean of its counts truncated as numpy's (an empty cell NaT);
    with ``as_float`` it stays that float."""

    def __init__(self, expression, selection=None, edges=False, as_float=False):
        super().__init__("mean", expression, selection, edges)
        self.as_float = as_float

    def logical_dtype(self, df):
        dtype = self._input_dtype(df)
        return dtype.numpy if dtype.is_temporal and not self.as_float else None

    def add_tasks(self, df, binners, progress=None):
        op = OpSum if self._input_dtype(df).numpy.kind == "f" else OpSumFloat
        [sum_task] = AggregatorDescriptorBasic("sum", self.expression, op,
                                               self.selection).add_tasks(df, binners)
        [count_task] = AggregatorDescriptorBasic("count", self.expression, OpCountValid,
                                                 self.selection).add_tasks(df, binners)

        @delayed
        def finish(s, c):
            # a float64 sum over a float64 count (torch divides int64 by
            # int64 in float32)
            mean = s.to(torch.float64) / c.to(torch.float64)
            return torch.where(c > 0, mean, torch.nan)
        return [finish(sum_task, count_task)]


# moment terms over bases [x] and [x, y] (ops/grid_moments.py): every term
# counts only rows where all the bases it names are valid
VAR_TERMS = [(0, -1, -1, -1), (0, 0, -1, -1), (-1, -1, 0, -1)]  # x, x*x, count
# x*y, x and y where both are valid, count of such rows; corr adds x*x, y*y
COVAR_TERMS = [(0, 1, -1, -1), (0, -1, 1, -1), (1, -1, 0, -1), (-1, -1, 0, 1)]
CORR_TERMS = COVAR_TERMS + [(0, 0, 1, -1), (1, 1, 0, -1)]


def _moments(df, binners, expressions, terms, selection, shifts):
    """The moment op of ``expressions``, each base less its shift (a
    constant, or a [G] table: a shift a cell); the finishers below take
    shifted sums."""
    op = OpMoments(expressions, terms, shifts)
    return df.executor.schedule_aggregation(df, binners, op, selection)


# the power of two a float64 base is scaled by where its sum of squares
# overflowed: |u| <= 2^1025 scales to 2^485, whose squares sum over 2^50 rows
# to below 2^1021
RESCUE_SCALE = 2.0 ** -540

# the bits of a cell's centred sum s = m2 - m1^2 / n that its shifted sums
# must keep: a cell whose sums' rounding, about eps sqrt(n) m2, passes 2^-24 s
# lost the rest to the shift (its mean lies far from it, against its spread;
# at n = 2^24 rows this is m2 > 2^16 s, "more than 16 of float64's 53 bits
# cancelled"; fewer rows round less and may lose more), and a second pass
# takes it again less a shift of its own (:func:`cell_shifted`)
CANCEL_BITS = 24


def cancelled(m2, m1, n, integer=False):
    """The cells of more than one row whose shifted sums m1 = sum u, m2 =
    sum u^2 lost more than they keep to the shift: eps sqrt(n) m2 2^24 >= s
    (s = m2 - m1^2 / n; this holds wherever :func:`variance` zeroes s while
    m2 > 0, for n < 2^46: the float sums cannot tell a constant cell away
    from the shift from a lost one).  An int base's sums (``integer``) are
    exact integers while m2 < 2^53 and n m2 < 2^62: there n s = n m2 - m1^2
    is exact in int64, 0 for a constant cell alone, and the cell is flagged
    only where the bound passes that exact s.  A NaN flags nothing; a cell of
    one row has no variance to lose."""
    noise = torch.finfo(torch.float64).eps * torch.sqrt(n) * m2 * 2.0 ** CANCEL_BITS
    lost = (m2 > 0) & (noise >= m2 - m1 * m1 / n)
    if integer:
        exact = (m2 < 2.0 ** 53) & (n * m2 < 2.0 ** 62)
        ni, m1i, m2i = (torch.where(exact, t, 0.0).to(torch.int64) for t in (n, m1, m2))
        ns = ni * m2i - m1i * m1i
        lost = torch.where(exact, (ns > 0) & (n * noise >= ns.to(m2.dtype)), lost)
    return (n > 1) & lost


def _base_rows(terms, j):
    """(row of sum u_j, row of sum u_j^2) among the float rows of
    ``terms``, or None where the terms lack base j's square (COVAR_TERMS)."""
    floats = [tuple(t[:2]) for t in terms if t[0] >= 0]
    if (j, -1) not in floats or (j, j) not in floats:
        return None
    return floats.index((j, -1)), floats.index((j, j))


def cell_shift(a, m1, n, integer):
    """A base's shift a cell for a further pass, flat [G]: each cell's mean
    from a pass's sums, a + m1 / n (a that pass's shift, None: 0).  An int
    base's (a uint64 base's order image's too, :func:`.tasks.moment_data`)
    is that float mean rounded and clamped to int64's range: a shift needs
    only to lie near its cell, and float64's 2^63 is no int64.  A float
    mean is known to about eps sqrt(n) (|a| + |m1 / n|): where 0 lies that
    close to it (a cell near 0 beside a shift far from it) the shift is 0,
    and so it is where the mean is not finite (an empty cell, an infinity,
    or sums past float64, where the frame's shift may be the fault)."""
    mean = (m1 / n).reshape(-1)
    if integer:
        a = 0.0 if a is None else a.to(mean.device, torch.float64)
        b = a + torch.where(torch.isfinite(mean), mean, 0.0)
        return b.round().clamp(-2.0 ** 63, INT64_TOP).to(torch.int64)
    a = 0.0 if a is None else a.to(mean.device)
    b = a + mean
    fuzz = torch.finfo(torch.float64).eps * torch.sqrt(n.reshape(-1)) * (abs(a) + mean.abs())
    return torch.where(torch.isfinite(b) & (b.abs() > fuzz), b, 0.0)


# float64's largest value below 2^63: the largest int64 a float mean rounds to
INT64_TOP = 2.0 ** 63 - 1024

# the order image of a uint64 0 (:func:`.tasks.moment_data`): a uint64
# base's shift is worth its image less this
ORDER_ZERO = -(1 << 63)

# the passes past the first that a flagged statistic takes at most
# (:func:`settle`).  A table's error e, its distance from the cell's mean,
# shrinks each pass to about eps sqrt(n) (e + the cell's spread), plus the
# rounding of the mean itself: 2^-29 e at n = 2^46 (:func:`cancelled`'s
# range), 2^-39 at 1e8 rows.  The second pass starts from the frame's shift,
# e <= |a| + |mean|; a mean within its own rounding of 0 takes a table of 0
# (:func:`cell_shift`), so that e is about |mean| or less after it, and the
# third pass leaves a table at its mean's own rounding (C26: a group at 10,
# spread 1e-7, beside a shift at 1e17 takes 0, then 10, and settles).  Eight
# leave room for sums whose rounding grows as n eps (2^-26 at 1e8 rows)
# rather than as sqrt(n) eps.
MAX_CELL_PASSES = 8


def _mesh(df):
    """The mesh of a pass across processes, or None."""
    mesh = getattr(df.executor, "sharded", None)
    return mesh if mesh is not None and mesh.group is not None else None


def _any_cells(df, *flags):
    """Per flag grid, True where any cell is flagged: one host read of them
    all, and over a mesh of several processes one collective, so that every
    process schedules the same passes."""
    anys = torch.stack([f.any() for f in flags])
    mesh = _mesh(df)
    if mesh is not None:
        from .parallel import collectives
        anys = collectives.reduce([anys], "or", mesh)
    with tracing.host_read("any-cells"):
        return anys.tolist()


def _picked(flag, a, b):
    """``a`` where ``flag``, else ``b``, for a tensor or a tuple of them;
    ``flag`` None: ``a`` where it is finite."""
    if isinstance(a, tuple):
        return tuple(_picked(flag, x, y) for x, y in zip(a, b))
    return torch.where(torch.isfinite(a) if flag is None else flag, a, b)


def _nan_where(flag, a):
    """``a`` with NaN where ``flag``, for a tensor or a tuple of them."""
    if isinstance(a, tuple):
        return tuple(_nan_where(flag, x) for x in a)
    return torch.where(flag, torch.nan, a)


def settle(k, flag, answer, retaken, passes, any_cells):
    """One step of the rule of the passes past the first, which
    :func:`cell_shifted` and each owner of the all-to-all
    (:func:`.parallel.shuffle.owner_variance`) follow.  Pass k past the
    first took the cells ``flag`` again: its answer ``retaken`` there,
    ``answer`` elsewhere.  ``passes`` per base: (its table in pass k, that
    pass's (m1, m2, n), whether its values are integers, the (m1, m2) of
    the pass over x * RESCUE_SCALE less the table scaled, or None).  The
    cells flagged before are flagged again where their sums less pass k's
    tables lost their digits (:func:`cancelled`; from the scaled sums where
    a cell's own are not finite), and they alone take their next table
    from that pass's means (:func:`cell_shift`).  Returns (the answer,
    None) where no such cell's table moved (``any_cells(moved)``, a host
    read); at MAX_CELL_PASSES (the answer with NaN in the cells whose table
    still moved: no finite wrong answer, those cells counted in
    ``settle.unsettled``, None); else (the answer, (the cells still
    flagged, the next tables)) for pass k + 1, counted in
    ``settle.further``."""
    merged = _picked(flag, retaken, answer)
    lost, nexts = None, {}
    for e, (t, (m1, m2, n), integer, scaled) in passes.items():
        f, nexts[e] = cancelled(m2, m1, n, integer), cell_shift(t, m1, n, integer)
        if scaled is not None:
            s1, s2 = scaled
            bad = ~(torch.isfinite(m1) & torch.isfinite(m2))
            f = torch.where(bad, cancelled(s2, s1, n), f)
            tiny = cell_shift(t * RESCUE_SCALE, s1, n, False) / RESCUE_SCALE
            nexts[e] = torch.where(bad.reshape(-1), torch.where(torch.isfinite(tiny), tiny, 0.0),
                                   nexts[e])
        lost = f if lost is None else lost | f
    still = flag & lost
    moved = still & functools.reduce(
        torch.logical_or, [(nexts[e] != t).reshape(still.shape) for e, (t, *_) in passes.items()])
    if not any_cells(moved):
        return merged, None
    if k == MAX_CELL_PASSES:
        with tracing.host_read("settle"):
            settle.unsettled += int(moved.sum())
        return _nan_where(moved, merged), None
    settle.further += 1
    return merged, (still, nexts)


settle.further = 0
settle.unsettled = 0


def cell_shifted(df, binners, specs, selection, finish):
    """A promise of ``finish(results, shifts, scales)``, each cell from the
    pass that kept its digits (C25: one shift a frame loses the variance of
    every cell far from it; C26: one table from the first pass's sums may
    not be near enough either).

    ``specs``: the moment ops, (expressions, terms) each, every term valid
    where all of the op's bases are (VAR_TERMS, COVAR_TERMS, CORR_TERMS).
    ``finish`` takes per op its result ((counts,), sums), per expression the
    shift its sums are less as float64 (a 0-d tensor, a [G] table or None) and
    its scale (1.0, or RESCUE_SCALE), and gives a tensor of the cells'
    shape or a tuple of them.

    The first pass takes every op less one shift a base and frame
    (:func:`.tasks.moment_shift`): the same launches and cost as before.  It
    flags the cells where a base whose square the op holds lost its
    digits (:func:`cancelled`), and, where an op has a float64 base, where
    one of its sums is not finite (u^2 past float64, or an infinity: C24).
    The flags are read once (:func:`_any_cells`); where no cell is flagged,
    that pass is the answer.  Else a second pass takes every op again, each
    base less a shift a cell (:func:`cell_shift`: the cell's mean in the
    first op that holds the base's square), and where a sum was not finite
    also the ops over each float64 base times RESCUE_SCALE, less its table
    scaled (exact: a power of two), in that pass and in every further one.
    A flagged cell takes the pass's answer where ``finish`` gives a finite
    one there (a finisher gives NaN or an infinity where a sum it reads is
    not finite), else the scaled ops'; every other cell keeps the first
    pass.  Further passes follow :func:`settle`, each decision read over
    every process of a mesh (:func:`_any_cells`); over a mesh of processes
    rank 0's tables go to every process, so that each runs the same passes.
    ``cell_shifted.second_passes`` counts the statistics that took a second
    pass."""
    from .delayed import Promise
    from .ops.grid_moments import shifted
    from .tasks import moment_shift
    exprs = list(dict.fromkeys(e for es, _ in specs for e in es))
    dtypes = {e: _not_strings(df, e, "moments") for e in exprs}
    wide = {e: dtypes[e].numpy == np.float64 for e in exprs}
    # the bases whose values are integers (their moment data is int64: a
    # uint64 base's is its order image, the value less 2^63)
    integer = {e: not dtypes[e].is_float for e in exprs}
    unsigned = {e: dtypes[e].numpy == UINT64 for e in exprs}
    frame = {e: moment_shift(df, e) for e in exprs}
    first = [_moments(df, binners, es, terms, selection, [frame[e] for e in es])
             for es, terms in specs]
    ones = {e: 1.0 for e in exprs}
    out = Promise()

    def values(shifts):  # the shifts' values as ``finish`` takes them
        return {e: None if t is None else shifted(t, ORDER_ZERO) if unsigned[e]
                else t.to(torch.float64) for e, t in shifts.items()}

    def sums_of(results, e):
        """(m1, m2, n) of base e in the first op that holds its square."""
        for (es, terms), ((n,), sums) in zip(specs, results):
            if e in es:
                rows = _base_rows(terms, es.index(e))
                if rows is not None:
                    return sums[rows[0]], sums[rows[1]], n.to(torch.float64)
        raise ValueError(f"no op holds the square of {e!r}")

    def first_pass(results):
        answer = finish(results, values(frame), ones)
        flag, over = None, None
        for (es, terms), ((n,), sums) in zip(specs, results):
            n = n.to(torch.float64)
            for j, e in enumerate(es):
                rows = _base_rows(terms, j)
                if rows is not None:
                    f = cancelled(sums[rows[1]], sums[rows[0]], n, integer[e])
                    flag = f if flag is None else flag | f
            if any(wide[e] for e in es):
                f = ~torch.isfinite(sums).all(0)
                over = f if over is None else over | f
        if over is not None:
            flag = flag | over
        anys = _any_cells(df, flag, *([over] if over is not None else []))
        if not anys[0]:
            out.fulfill(answer)
            return
        cell_shifted.second_passes += 1
        tables = {e: cell_shift(frame[e], *sums_of(results, e)[::2], integer[e]) for e in exprs}
        scaled = over is not None and anys[-1]
        again(tables, flag, answer, scaled, 1)

    def again(tables, flag, answer, scaled, k):
        """Pass k past the first: every op less ``tables``, rank 0's."""
        mesh = _mesh(df)
        if mesh is not None:
            from .parallel import collectives
            tables = {e: collectives.broadcast(t, mesh) for e, t in tables.items()}
        scale = {e: RESCUE_SCALE if wide[e] and scaled else 1.0 for e in exprs}
        shift = {e: tables[e] * scale[e] if scale[e] != 1.0 else tables[e] for e in exprs}
        name = {e: f"({e}) * {RESCUE_SCALE!r}" if scale[e] != 1.0 else e for e in exprs}
        plain = [_moments(df, binners, es, terms, selection, [tables[e] for e in es])
                 for es, terms in specs]
        tiny = [_moments(df, binners, [name[e] for e in es], terms, selection,
                         [shift[e] for e in es]) for es, terms in specs] if scaled else []

        def merge(got):
            results, results_tiny = got[:len(specs)], got[len(specs):]
            retaken = finish(results, values(tables), ones)
            if scaled:
                retaken = _picked(None, retaken, finish(results_tiny, values(shift), scale))
            passes = {e: (tables[e], sums_of(results, e), integer[e],
                          sums_of(results_tiny, e)[:2] if scale[e] != 1.0 else None)
                      for e in exprs}
            merged, going_on = settle(k, flag, answer, retaken, passes,
                                      lambda moved: _any_cells(df, moved)[0])
            if going_on is None:
                out.fulfill(merged)
            else:
                still, nexts = going_on
                again(nexts, still, merged, scaled, k + 1)

        def fulfilled(got):
            try:
                merge(got)
            except Exception as e:  # noqa: BLE001 - the statistic's promise takes it
                out.reject(e)
        delayed(lambda *got: got)(*plain, *tiny).then(fulfilled, out.reject)

    def check(results):
        try:
            first_pass(results)
        except Exception as e:  # noqa: BLE001 - the statistic's promise takes it
            out.reject(e)
    delayed(lambda *r: r)(*first).then(check, out.reject)
    return out


cell_shifted.second_passes = 0


def variance(m2, m1, n):
    """var from the shifted sums m1 = sum u, m2 = sum u^2 of n rows: (m2 -
    m1^2 / n) / n, and 0 where that is within the rounding bound of the
    sums (2 n eps m2; a constant cell, whose u need not be 0), so that a
    constant operand has no variance; NaN stays NaN, and a sum of squares
    past float64 gives inf or NaN, never 0."""
    s = m2 - m1 * m1 / n
    zero = (s <= 2 * n * torch.finfo(torch.float64).eps * m2) & torch.isfinite(m2)
    return torch.where(zero, 0.0, s) / n


def central(mxy, mx, my, n):
    """The central moment of shifted sums: (sum uv - sum u sum v / n) / n
    for u = x - a, v = y - b; the same for any shifts a and b."""
    return (mxy - mx * my / n) / n


class AggregatorDescriptorVar(AggregatorDescriptor):
    """var/std from shifted moments: with u = x - a, var = (sum u^2 - (sum
    u)^2 / n) / n, which does not cancel where a is near the cell's values,
    as E[x^2] - E[x]^2 of raw moments does (vaex_tpu/agg.py:1114, a fault of
    the reference).  :func:`cell_shifted` takes a cell far from the frame's
    shift again less its own mean, and a float64 cell whose sum of u^2 is
    not finite (an infinity, or |u| past 1.3e154) over x * RESCUE_SCALE,
    its variance scaled back; a float32 or int base's squares cannot
    overflow, so only an infinity makes them infinite, and inf - inf is
    already the NaN numpy gives."""

    def __init__(self, expression, std=False, ddof=0, selection=None, edges=False):
        super().__init__("std" if std else "var", expression, selection, edges)
        self.std = std
        self.ddof = ddof

    def add_tasks(self, df, binners, progress=None):
        for e in self.expressions:
            _not_strings(df, e, self.name)
        std, ddof = self.std, self.ddof

        def finish(results, shifts, scales):
            [((n,), (m1, m2))] = results
            n = n.to(torch.float64)
            scale = next(iter(scales.values()))
            var = variance(m2, m1, n) / scale / scale  # scale^2 underflows
            if ddof:
                var = torch.where(n > ddof, var * n / (n - ddof), torch.nan)
            return torch.sqrt(var) if std else var
        return [cell_shifted(df, binners, [([self.expression], VAR_TERMS)],
                             selection_expression(self.selection, df), finish)]


class AggregatorDescriptorCovar(AggregatorDescriptor):
    """Per-cell covariance over the rows where both x and y are valid
    (vaex_tpu/agg.py:1124-1164), from shifted moments (:func:`central`).
    Its op holds corr's terms (CORR_TERMS: each base's square too, which
    B4 and B5 have compiled), so that :func:`cell_shifted` can flag a cell
    where either base lost its digits: the rounding of sum uv - sum u sum
    v / n is within 2 eps sqrt(sum u^2 sum v^2), which stays within 2^17 eps
    of the cell's sigma_x sigma_y where neither base is flagged."""

    def __init__(self, x, y, selection=None, edges=False, ddof=0):
        super().__init__("covar", x, selection, edges)
        self.y = str(y)
        self.ddof = ddof

    def pretty_name(self, name=None, df=None):
        return find_valid_name(name or f"{self.expression}_{self.y}_{self.name}")

    def add_tasks(self, df, binners, progress=None):
        for e in (self.expression, self.y):
            _not_strings(df, e, self.name)
        x, y, ddof = self.expression, self.y, self.ddof

        def finish(results, shifts, scales):
            [((c,), (mxy, mx, my, _, _))] = results
            c = c.to(torch.float64)
            cov = central(mxy, mx, my, c) / scales[x] / scales[y]
            if ddof:
                cov = cov * c / (c - ddof)
            return cov
        return [cell_shifted(df, binners, [([x, y], CORR_TERMS)],
                             selection_expression(self.selection, df), finish)]


class AggregatorDescriptorCorr(AggregatorDescriptorCovar):
    """Per-cell Pearson correlation (H2O q9; vaex_tpu/agg.py:1167-1195)."""

    def __init__(self, x, y, selection=None, edges=False):
        super().__init__(x, y, selection, edges)
        self.name = "corr"

    def add_tasks(self, df, binners, progress=None):
        for e in (self.expression, self.y):
            _not_strings(df, e, self.name)

        def finish(results, shifts, scales):
            [((c,), (mxy, mx, my, mxx, myy))] = results
            c = c.to(torch.float64)
            cov = central(mxy, mx, my, c)
            vx = variance(mxx, mx, c)
            vy = variance(myy, my, c)
            r = cov / torch.sqrt(vx) / torch.sqrt(vy)  # the scales cancel
            # a constant operand has no variance: NaN, not a 0-division's
            # inf; and NaN where a sum it reads is not finite
            ok = torch.isfinite(r) & torch.isfinite(vx) & torch.isfinite(vy)
            return torch.where(ok, r, torch.nan)
        return [cell_shifted(df, binners, [([self.expression, self.y], CORR_TERMS)],
                             selection_expression(self.selection, df), finish)]


class AggregatorDescriptorNUnique(AggregatorDescriptor):
    """The number of distinct values per cell (vaex_tpu/agg.py:1403-1436):
    a set-build pass (:meth:`prepare`, which several descriptors share
    with the frame's other pre-passes), then the presence grid while
    G * n_values <= ``NUNIQUE_PRESENCE_MAX`` (:class:`OpNUniquePresence`),
    else the sorted pairs (:class:`OpNUniqueSorted`).  The set holds the
    values of the rows the frame's filter keeps; ``selection`` drops rows
    from the count, as the reference's does."""

    def __init__(self, expression, dropna=False, dropnan=False, dropmissing=False,
                 selection=None, edges=False):
        super().__init__("nunique", expression, selection, edges)
        self.dropnan = dropnan or dropna
        self.dropmissing = dropmissing or dropna
        self._set = None

    def prepare(self, df, binners):
        """Queue the set-build pass over ``df``."""
        if self._set is None or self._set[0] is not df:
            self._set = (df, df._set(self.expression, delay=True))

    def add_tasks(self, df, binners, progress=None):
        self.prepare(df, binners)
        task = self._set[1]
        self._set = None  # a later use builds the set of its own frame
        if not task.done:
            df.execute()
        oset = task.get()
        var = df.add_variable("set_nunique", oset, unique=True)
        ordinal = f"_ordinal_values({self.expression}, {var})"
        op_class = (OpNUniquePresence if grid_size(binners) * oset.count <= NUNIQUE_PRESENCE_MAX
                    else OpNUniqueSorted)
        op = op_class(ordinal, oset.count, oset.nan_ordinal, oset.null_ordinal,
                      self.dropnan, self.dropmissing)
        return [df.executor.schedule_aggregation(df, binners, op,
                                                 selection_expression(self.selection, df))]


def count(expression="*", selection=None, edges=False):
    return AggregatorDescriptorBasic("count", expression, OpCount, selection, edges)


def sum(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("sum", expression, OpSum, selection, edges)


def mean(expression, selection=None, edges=False, as_float=False):
    return AggregatorDescriptorMean(expression, selection, edges, as_float)


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


def percentile_approx(expression, percentage=50.0, percentile_shape=1024, selection=None,
                      edges=False, exact=None):
    return AggregatorDescriptorPercentile(expression, percentage, percentile_shape,
                                          selection=selection, edges=edges, exact=exact)


def median_approx(expression, percentile_shape=1024, selection=None, edges=False, exact=None):
    """Per-cell median: exact where the pass can sort its pairs, else from
    the count grid (see :class:`AggregatorDescriptorPercentile`)."""
    desc = AggregatorDescriptorPercentile(expression, 50.0, percentile_shape,
                                          selection=selection, edges=edges, exact=exact)
    desc.name = "median"
    return desc


median = median_approx


def max_n(expression, k, selection=None, edges=False):
    """The k largest values per cell as a [..., k] grid (H2O q8)."""
    return AggregatorDescriptorTopK(expression, k, largest=True, selection=selection,
                                    edges=edges)


def min_n(expression, k, selection=None, edges=False):
    return AggregatorDescriptorTopK(expression, k, largest=False, selection=selection,
                                    edges=edges)


def nth_largest(expression, n, selection=None, edges=False):
    """The (n + 1)-th largest value per cell (n counts from 0)."""
    return AggregatorDescriptorTopK(expression, n + 1, largest=True, nth=n,
                                    selection=selection, edges=edges)


def nth_smallest(expression, n, selection=None, edges=False):
    return AggregatorDescriptorTopK(expression, n + 1, largest=False, nth=n,
                                    selection=selection, edges=edges)


def nunique(expression, dropna=False, dropnan=False, dropmissing=False, selection=None,
            edges=False):
    """The number of distinct values per cell; NaN and a missing value count
    as one each unless dropped."""
    return AggregatorDescriptorNUnique(expression, dropna, dropnan, dropmissing, selection,
                                       edges)


def _sum_moment(expression, moment, selection=None, edges=False):
    return AggregatorDescriptorBasic(f"summoment{moment}", expression,
                                     functools.partial(OpSumMoment, moment=moment), selection,
                                     edges)


# vaex_tpu/agg.py:1442-1448: every name of the reference's registry
aggregates = {"count": count, "sum": sum, "mean": mean, "min": min, "max": max,
              "first": first, "std": std, "var": var, "nunique": nunique,
              "_sum_moment": _sum_moment, "median": median_approx,
              "median_approx": median_approx, "percentile_approx": percentile_approx,
              "corr": corr, "covar": covar, "max_n": max_n, "min_n": min_n,
              "nth_largest": nth_largest, "nth_smallest": nth_smallest}

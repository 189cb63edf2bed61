"""DataFrame: the lazy API over the PyTorch execution engine.

The slice of ``vaex_tpu/dataframe.py`` on the main path: a DataFrame owns
an immutable Dataset plus category metadata; ``to_device`` stages columns
as tensors on a torch device; the statistics (``count``, ``sum``, ``mean``,
``var``, ``std``, ``min``, ``max``, ``minmax``, ``first``, ``covar``,
``correlation``), ``groupby`` and ``binby`` build aggregation tasks that one
pass of the executor runs.  ``binby=`` takes category axes and continuous
ones, binned over ``limits`` (explicit, ``"minmax"`` or ``"<p>%"``) in
``shape`` bins.  ``filter`` (or ``df[<boolean expression>]``) keeps a
boolean expression every pass evaluates per tile; ``selection=`` does the
same for one statistic.  The set API (``isin``, ``unique``, ``nunique``,
``value_counts``, ``map``) and the groupers of uncategorized keys build
:class:`~vaex_tpu_torch.ops.setops.SortedSet` variables (``_set``), which
expressions name and passes probe on their device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import agg as agg_module
from . import array_types, settings
from .dataset import Dataset, DatasetArrays
from .datatype import DataType, dtype_of, has_torch_dtype
from .delayed import delayed
from .execution import ExecutorLocal, TileContext, _tile, pass_inputs
from .expression import Expression
from .ops.binners import BinnerOrdinal, BinnerScalar
from .scopes import DeviceScope
from .tasks import TaskSetCreate
from .utils import fingerprint, valid_expression_name

FILTERED_PENDING = "of a filtered DataFrame is not ported yet (ROADMAP queue A9)"


class DataFrame:
    def __init__(self, dataset: Dataset, executor=None):
        for name in dataset:
            if not valid_expression_name(name):
                raise NotImplementedError(
                    f"column name {name!r} is not an identifier; renaming columns is "
                    f"not ported yet (ROADMAP queue A9)")
        self.dataset = dataset
        self.executor = executor or ExecutorLocal()
        self.column_names: List[str] = list(dataset)
        self._categories: Dict[str, dict] = {}
        self._tile_rows = None  # rows per tile of a pass (None: settings.TILE_ROWS)
        self.variables: Dict[str, object] = {}  # sets and arrays that expressions name
        self._filter = None  # the boolean expression of a filtered frame
        self._filtered_length = None

    def copy(self, column_names=None):
        df = DataFrame.__new__(DataFrame)
        df.dataset = self.dataset
        df.executor = self.executor
        df.column_names = list(column_names if column_names is not None else self.column_names)
        df._categories = dict(self._categories)
        df._tile_rows = self._tile_rows
        df.variables = dict(self.variables)
        df._filter = self._filter
        df._filtered_length = self._filtered_length
        return df

    # ----------------------------------------------------------- variables
    def add_variable(self, name, value, unique=False):
        """Keep ``value`` (a SortedSet or an array) under a name expressions
        can use; returns the name.  With ``unique`` the name is the value's
        content hash, so the same payload gives the same expression string
        and is kept once."""
        if unique:
            fp = value.fingerprint() if hasattr(value, "fingerprint") else fingerprint(value)
            name = f"__{name}_{str(fp)[:12]}"
            if name in self.variables:
                return name
        self.variables[name] = value
        return name

    def fingerprint(self):
        """Content hash of what a pass over this frame reads: the dataset
        (sampled), the filter and the variables."""
        return fingerprint("dataframe", self.dataset.fingerprint(), self._filter, self.variables)

    # -------------------------------------------------------------- filters
    @property
    def filter_expression(self):
        return self._filter

    @property
    def filtered(self):
        return self._filter is not None

    def filter(self, expression, mode="and"):
        """A frame that keeps the rows where the boolean ``expression`` holds
        (missing counts as False), combined with the frame's filter by
        ``mode``: "and", "or" or "replace"."""
        if mode not in ("and", "or", "replace"):
            raise ValueError(f"filter mode must be 'and', 'or' or 'replace', got {mode!r}")
        df = self.copy()
        expression = str(expression)
        if self._filter is not None and mode != "replace":
            symbol = "&" if mode == "and" else "|"
            expression = f"(({self._filter}) {symbol} ({expression}))"
        df._filter = expression
        df._filtered_length = None
        return df

    # ------------------------------------------------------------- columns
    def get_column_names(self, hidden=False):
        return [n for n in self.column_names if hidden or not n.startswith("__")]

    def __contains__(self, name):
        return name in self.get_column_names(hidden=True)

    def data_type(self, expression) -> DataType:
        """dtype of a column, or of an expression evaluated over one row."""
        expression = str(expression)
        if expression in self.dataset:
            logical = self.dataset.logical.get(expression)
            return DataType(logical) if logical is not None else dtype_of(
                self.dataset[expression])
        rows = min(1, self.dataset.row_count)
        return DataType(self._evaluate_rows(expression, 0, rows, filtered=False).dtype)

    def __len__(self):
        """The number of rows; of a filtered frame the rows its filter keeps
        (one count pass, remembered)."""
        if not self.filtered:
            return self.dataset.row_count
        if self._filtered_length is None:
            self._filtered_length = int(self.count())
        return self._filtered_length

    def dataset_for_execution(self):
        return self.dataset

    def __getitem__(self, item):
        if isinstance(item, str):
            return Expression(self, item)
        if isinstance(item, Expression):
            return self.filter(item.expression)
        if isinstance(item, (list, tuple)):
            return self.copy(column_names=[str(c) for c in item])
        if isinstance(item, slice):
            if self.filtered:
                raise NotImplementedError(f"a slice {FILTERED_PENDING}")
            start, stop, step = item.indices(len(self))
            if step != 1:
                raise ValueError("slices with a step are not supported")
            df = self.copy()
            df.dataset = self.dataset.slice(start, max(start, stop))
            return df
        raise TypeError(f"cannot index with {item!r}")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in object.__getattribute__(self, "column_names"):
            return Expression(self, name)
        raise AttributeError(name)

    # ------------------------------------------------------------ categories
    def categorize(self, column, min_value=0, labels=None, inplace=False):
        """Mark an integer column as categorical with codes
        ``min_value .. min_value + len(labels) - 1``."""
        df = self if inplace else self.copy()
        column = str(column)
        if labels is None:
            vmax = self.max(column)  # one pass on the frame's device
            labels = np.arange(int(min_value), int(vmax) + 1)
            min_value = int(min_value)
        # kept as an array: a groupby reads the labels on every call, and a
        # list of 1e6 labels takes tens of ms to become one
        labels = np.asarray(labels)
        df._categories[column] = {"labels": labels, "N": len(labels), "min_value": min_value}
        return df

    def is_category(self, column):
        return str(column) in self._categories

    def category_labels(self, column, aslist=True):
        labels = self._categories[str(column)]["labels"]
        return labels.tolist() if aslist else labels

    def category_count(self, column):
        return self._categories[str(column)]["N"]

    def category_offset(self, column):
        return self._categories[str(column)]["min_value"]

    # ------------------------------------------------------------ evaluation
    def _evaluate_rows(self, expression, i1, i2, filtered=True):
        """An expression over rows [i1, i2), eagerly, as a host array; of a
        filtered frame the rows the filter keeps, unless ``filtered`` is off."""
        expression = str(expression)
        expressions = [expression]
        if filtered and self.filtered:
            expressions.append(self._filter)
        names, device, variables = pass_inputs(self, self.dataset, expressions)
        tile = {n: _tile(self.dataset[n], i1, i2, device) for n in names}
        ctx = TileContext(DeviceScope(tile, variables), i2 - i1, device)
        value = ctx.expr(expression)
        data, mask = value.data, value.mask
        if data.dim() == 0:  # a constant expression
            data = data.expand(i2 - i1)
        if len(expressions) > 1:
            keep = ctx.boolean(self._filter)
            data, mask = data[keep], None if mask is None else mask[keep]
        data = array_types.to_numpy(data)
        if mask is not None:
            mask = array_types.to_numpy(mask)
            if mask.any():
                return np.ma.MaskedArray(data, mask)
        return data

    def evaluate(self, expression):
        """Values of an expression as a host numpy (masked) array."""
        expression = str(expression)
        logical = self.dataset.logical.get(expression)
        if expression in self.dataset and not self.filtered:
            values = array_types.to_numpy(self.dataset[expression][:])
        else:
            values = self._evaluate_rows(expression, 0, self.dataset.row_count)
        # a datetime or timedelta column comes back from its int64 form
        return values.view(logical) if logical is not None and values.dtype.kind == "i" else values

    # ---------------------------------------------------------- aggregation
    def execute(self):
        self.executor.execute()

    def _create_binners(self, binby, limits=None, shape=128):
        """The binner stack of ``binby``: a category axis bins on its codes,
        any other on ``[vmin, vmax)`` from ``limits`` (see :meth:`limits`) in
        ``shape`` bins (an int, or one per axis)."""
        binby = _ensure_list(binby)
        if not binby:
            return ()
        shapes = list(shape) if isinstance(shape, (list, tuple)) else [shape] * len(binby)
        if len(shapes) != len(binby):
            raise ValueError(f"shape {shape!r} does not match the {len(binby)} binby axes")
        limits = self._axis_limits(binby, limits)
        binners = []
        for expr, (vmin, vmax), bins in zip(binby, limits, shapes):
            if self.is_category(expr):
                binners.append(BinnerOrdinal(expr, self.category_offset(expr),
                                             self.category_count(expr)))
            else:
                binners.append(BinnerScalar(expr, vmin, vmax, bins))
        return tuple(binners)

    def _axis_limits(self, binby, limits):
        """One ``[vmin, vmax]`` per axis of ``binby`` (a list) from a limits
        spec; explicit pairs and category axes take no pass."""
        if len(binby) == 1 and _is_pair(limits):
            limits = [limits]
        return self.limits(binby, limits)

    def _compute_agg(self, name, expression, binby=(), limits=None, shape=128,
                     selection=None, delay=False, edges=False, **agg_kwargs):
        """One statistic of an expression, or of each of a list of them
        (stacked on the first axis), over the grid of ``binby``
        (vaex_tpu/dataframe.py:785-832)."""
        binners = self._create_binners(binby, limits, shape)
        if isinstance(selection, Expression):
            selection = selection.expression
        multi = isinstance(expression, (list, tuple))
        promises, logical = [], []
        for expr in (expression if multi else [expression]):
            if name == "count" and (expr is None or str(expr) == "*"):
                desc = agg_module.count("*", selection=selection)
            else:
                desc = agg_module.aggregates[name](str(expr), selection=selection,
                                                   **agg_kwargs)
            [promise] = desc.add_tasks(self, binners)
            promises.append(promise)
            logical.append(desc.logical_dtype(self))
        ndim = len(binners)

        @delayed
        def finish(*grids):
            out = []
            for grid, dtype in zip(grids, logical):
                grid = agg_module.view_logical(array_types.to_numpy(grid), dtype)
                if ndim and not edges:
                    grid = agg_module.extract_central(grid, ndim)
                out.append(grid if ndim else grid.reshape(())[()])
            if multi:
                return np.stack(out) if ndim else np.array(out)
            return out[0]
        return self._delay(delay, finish(*promises))

    def _delay(self, delay, result):
        if delay:
            return result
        if not result.done:  # a result that needed no pass flushes nothing
            self.execute()
        return result.get()

    def count(self, expression=None, binby=(), limits=None, shape=128, selection=None,
              delay=False, edges=False):
        return self._compute_agg("count", expression, binby, limits, shape, selection, delay,
                                 edges)

    def sum(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False):
        return self._compute_agg("sum", expression, binby, limits, shape, selection, delay,
                                 edges)

    def mean(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
             edges=False):
        return self._compute_agg("mean", expression, binby, limits, shape, selection, delay,
                                 edges)

    def min(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False):
        return self._compute_agg("min", expression, binby, limits, shape, selection, delay,
                                 edges)

    def max(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False):
        return self._compute_agg("max", expression, binby, limits, shape, selection, delay,
                                 edges)

    def var(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False, ddof=0):
        return self._compute_agg("var", expression, binby, limits, shape, selection, delay,
                                 edges, ddof=ddof)

    def std(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False, ddof=0):
        return self._compute_agg("std", expression, binby, limits, shape, selection, delay,
                                 edges, ddof=ddof)

    def first(self, expression, order_expression=None, binby=(), limits=None, shape=128,
              selection=None, delay=False, edges=False):
        """Per cell the value at the smallest ``order_expression`` (the
        expression itself when none is given); ties go to the earliest row."""
        return self._compute_agg(
            "first", expression, binby, limits, shape, selection, delay, edges,
            order_expression=None if order_expression is None else str(order_expression))

    def minmax(self, expression, binby=(), limits=None, shape=128, selection=None,
               delay=False):
        """[min, max] of an expression, or of each of a list of them, stacked
        on the last axis (vaex_tpu/dataframe.py:895-921)."""
        multi = isinstance(expression, (list, tuple))
        binners = self._create_binners(binby, limits, shape)
        if isinstance(selection, Expression):
            selection = selection.expression
        promises, logical = [], []
        for e in (expression if multi else [expression]):
            for make in (agg_module.min, agg_module.max):
                desc = make(str(e), selection=selection)
                promises += desc.add_tasks(self, binners)
            logical.append(desc.logical_dtype(self))
        ndim = len(binners)

        @delayed
        def finish(*grids):
            out = []
            for k, dtype in enumerate(logical):
                pair = [agg_module.view_logical(array_types.to_numpy(g), dtype)
                        for g in grids[2 * k:2 * k + 2]]
                if ndim:
                    pair = [agg_module.extract_central(g, ndim) for g in pair]
                    out.append(np.stack(pair, axis=-1))
                else:
                    out.append(np.array([g.reshape(())[()] for g in pair]))
            return np.stack(out) if multi else out[0]
        return self._delay(delay, finish(*promises))

    def limits(self, expression, value=None, selection=None, delay=False):
        """``[vmin, vmax]`` of an axis from a limits spec: None or "minmax"
        (one minmax pass; a category axis takes its code range), "<p>%" (the
        central p percent, :meth:`limits_percentage`) or an explicit pair.  A
        list of expressions takes one spec for all or one per axis, and its
        minmax axes share one pass (vaex_tpu/dataframe.py:923-945)."""
        if isinstance(expression, (list, tuple)):
            exprs = [str(e) for e in expression]
            if value is None or isinstance(value, str) or _is_pair(value):
                values = [value] * len(exprs)
            else:
                values = list(value)
            if len(values) != len(exprs):
                raise ValueError(f"{len(values)} limits for {len(exprs)} expressions")
            results = [self.limits(e, v, selection, delay=True) for e, v in zip(exprs, values)]

            @delayed
            def gather(*pairs):
                return list(pairs)
            return self._delay(delay, gather(*results))
        expression = str(expression)
        if value is None or (isinstance(value, str) and value == "minmax"):
            if self.is_category(expression):
                offset = self.category_offset(expression)
                return self._delay(delay, _resolved(
                    [offset, offset + self.category_count(expression)]))

            @delayed
            def as_floats(pair):
                return [float(v) for v in pair]
            return self._delay(delay, as_floats(self.minmax(expression, selection=selection,
                                                            delay=True)))
        if isinstance(value, str):
            return self._delay(delay, _resolved(self.limits_percentage(
                expression, float(value.rstrip("%")), selection=selection)))
        value = list(value)
        if len(value) != 2:
            raise ValueError(f"limits of {expression!r} must be a [vmin, vmax] pair, got "
                             f"{value!r}")
        return self._delay(delay, _resolved([float(v) for v in value]))

    def limits_percentage(self, expression, percentage=99.73, selection=None):
        """The limits that hold the central ``percentage`` percent of the
        values: a 1024-bin count grid over [min, max], then interpolation on
        the host (vaex_tpu/dataframe.py:947-966)."""
        vmin, vmax = self.minmax(expression, selection=selection)
        if vmin == vmax:
            return [vmin, vmax]
        shape = 1024
        counts = self.count(binby=[expression], limits=[[vmin, vmax]], shape=shape,
                            selection=selection)
        cumulative = np.cumsum(counts).astype(np.float64)
        total = cumulative[-1]
        if total == 0:
            return [vmin, vmax]
        cumulative /= total
        fraction = (100.0 - percentage) / 100.0 / 2
        edges_x = np.linspace(vmin, vmax, shape + 1)
        lo = np.interp(fraction, np.concatenate([[0], cumulative]), edges_x)
        hi = np.interp(1 - fraction, np.concatenate([[0], cumulative]), edges_x)
        return [float(lo), float(hi)]

    def percentile_approx(self, expression, percentage=50.0, binby=(), limits=None, shape=128,
                          percentile_shape=1024 * 16, percentile_limits="minmax",
                          selection=None):
        """Approximate percentiles from a count grid over the expression's
        range (per cell of ``binby``, with a trailing axis for it), cumulated
        and interpolated on the host (vaex_tpu/dataframe.py:968-1018)."""
        multi = isinstance(expression, (list, tuple))
        many = isinstance(percentage, (list, tuple))
        percentages = list(percentage) if many else [percentage]
        binby = _ensure_list(binby)
        out = []
        for expr in (expression if multi else [expression]):
            expr = str(expr)
            lim = self.limits(expr, percentile_limits, selection=selection)
            vmin, vmax = lim
            if vmin == vmax:
                out.append(vmin)
                continue
            edges_x = np.linspace(vmin, vmax, percentile_shape + 1)
            if binby:
                counts = self.count(binby=binby + [expr],
                                    limits=self._axis_limits(binby, limits) + [lim],
                                    shape=[shape] * len(binby) + [percentile_shape]
                                    if not isinstance(shape, (list, tuple))
                                    else list(shape) + [percentile_shape],
                                    selection=selection)
                cells = np.cumsum(np.asarray(counts, dtype=np.float64), axis=-1)
                grid_shape = cells.shape[:-1]
                cells = cells.reshape(-1, percentile_shape)
                values = np.full((len(percentages), cells.shape[0]), np.nan)
                for ci, cum in enumerate(cells):
                    if cum[-1] == 0:
                        continue
                    cum0 = np.concatenate([[0], cum])
                    for pi, p in enumerate(percentages):
                        values[pi, ci] = np.interp(p / 100.0 * cum[-1], cum0, edges_x)
                values = values.reshape((len(percentages),) + grid_shape)
                out.append(values if many else values[0])
                continue
            counts = self.count(binby=[expr], limits=[lim], shape=percentile_shape,
                                selection=selection)
            cum0 = np.concatenate([[0], np.cumsum(counts).astype(np.float64)])
            values = [float(np.interp(p / 100.0 * cum0[-1], cum0, edges_x))
                      for p in percentages]
            out.append(values if many else values[0])
        return out if multi else out[0]

    def median_approx(self, expression, binby=(), limits=None, shape=128,
                      percentile_shape=1024 * 16, percentile_limits="minmax", selection=None):
        return self.percentile_approx(expression, 50.0, binby=binby, limits=limits,
                                      shape=shape, percentile_shape=percentile_shape,
                                      percentile_limits=percentile_limits, selection=selection)

    def covar(self, x, y, binby=(), limits=None, shape=128, selection=None, delay=False):
        """cov(x, y) = E[xy] - E[x]E[y], each mean over its own valid rows
        (vaex_tpu/dataframe.py:1027-1038)."""
        x, y = str(x), str(y)
        binby = _ensure_list(binby)
        limits = self._axis_limits(binby, limits)  # once for the three means
        mean_xy = self.mean(f"({x}) * ({y})", binby, limits, shape, selection, delay=True)
        mean_x = self.mean(x, binby, limits, shape, selection, delay=True)
        mean_y = self.mean(y, binby, limits, shape, selection, delay=True)

        @delayed
        def finish(mxy, mx, my):
            return np.asarray(mxy) - np.asarray(mx) * np.asarray(my)
        return self._delay(delay, finish(mean_xy, mean_x, mean_y))

    def correlation(self, x, y=None, binby=(), limits=None, shape=128, selection=None,
                    delay=False):
        """Pearson correlation covar(x, y) / (std(x) std(y)), or the matrix
        of a list of expressions when y is None
        (vaex_tpu/dataframe.py:1040-1058)."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of expressions")
            return np.array([[self.correlation(a, b, binby, limits, shape, selection)
                              for b in x] for a in x])
        x, y = str(x), str(y)
        binby = _ensure_list(binby)
        limits = self._axis_limits(binby, limits)  # once for all five passes' tasks
        cov = self.covar(x, y, binby, limits, shape, selection, delay=True)
        std_x = self.std(x, binby, limits, shape, selection, delay=True)
        std_y = self.std(y, binby, limits, shape, selection, delay=True)

        @delayed
        def finish(c, sx, sy):
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.asarray(c) / (np.asarray(sx) * np.asarray(sy))
        return self._delay(delay, finish(cov, std_x, std_y))

    # ---------------------------------------------------------------- order
    def take(self, indices):
        """The rows at ``indices`` (host ints): numpy columns are indexed on
        the host, tensor columns on their device."""
        if self.filtered:
            raise NotImplementedError(f"take {FILTERED_PENDING}")
        indices = np.asarray(indices, dtype=np.int64)
        columns = {}
        for name in self.dataset:
            col = self.dataset[name]
            if isinstance(col, torch.Tensor):
                columns[name] = col[torch.as_tensor(indices, device=col.device)]
            else:
                columns[name] = col[indices]
        df = self.copy()
        df.dataset = DatasetArrays(columns, self.dataset.logical, self.dataset.device)
        return df

    def sort(self, by, ascending=True):
        """The rows ordered by the key column(s): a stable lexicographic
        argsort of the keys on the host, then a take
        (vaex_tpu/dataframe.py:1523-1553)."""
        by = [str(b) for b in (by if isinstance(by, (list, tuple)) else [by])]
        ascending = (list(ascending) if isinstance(ascending, (list, tuple))
                     else [ascending] * len(by))
        keys = []
        for name, asc in zip(by, ascending):
            data = np.ma.getdata(self.evaluate(name))
            if not asc:
                if data.dtype.kind in "OUS":
                    if len(by) > 1:
                        raise NotImplementedError(
                            "a descending string key among several sort keys is not ported "
                            "yet (ROADMAP queue A9)")
                    return self.take(np.argsort(data, kind="stable")[::-1])
                data = _descending(data)
            keys.append(data)
        if len(keys) == 1:
            return self.take(np.argsort(keys[0], kind="stable"))
        return self.take(np.lexsort(keys[::-1]))

    def groupby(self, by=None, agg=None, sort=False, ascending=True, assume_sparse="auto",
                row_limit=None):
        """Group by one or more keys: categories, raw int keys of a narrow
        range (dense), any other numeric key (a set of its values), or, with
        ``assume_sparse`` (True, or "auto" past 1e6 combinations), several keys
        fused into one set of the observed combinations.  ``row_limit`` raises
        RowLimitException when a key's set grows past it."""
        from .groupby import GroupBy
        gb = GroupBy(self, by=by, sort=sort, ascending=ascending, combine=assume_sparse,
                     row_limit=row_limit)
        if agg is None:
            return gb
        return gb.agg(agg)

    def binby(self, by=None, agg=None, limits=None, shape=128, sort=False):
        """Aggregations over the grid of ``by`` as an N-d array with the
        axes' bin centres or labels as coordinates
        (:class:`~vaex_tpu_torch.groupby.BinBy`)."""
        from .groupby import BinBy
        bb = BinBy(self, by=by, limits=limits, shape=shape, sort=sort)
        if agg is None:
            return bb
        return bb.agg(agg)

    # ------------------------------------------------------------- set API
    def _set(self, expression, keep_counts=False, limit=None, limit_raise=True):
        """The SortedSet of an expression's values over the rows the filter
        keeps, built by one pass on the pass device."""
        task = TaskSetCreate(self, str(expression), keep_counts=keep_counts,
                             limit=limit if limit_raise else None)
        self.executor.schedule(task)
        self.execute()
        return task.get()

    def unique(self, expression, return_inverse=False, dropna=False, dropnan=False,
               dropmissing=False, selection=None, limit=None, limit_raise=True,
               array_type="list"):
        """The distinct values in ascending order, then NaN, then None for a
        missing value, unless dropped; with ``return_inverse`` also each
        row's index into them."""
        expression = str(expression)
        df = self if selection is None else self.filter(agg_module.selection_expression(selection))
        oset = df._set(expression, limit=limit, limit_raise=limit_raise)
        keys = oset.key_array(masked=True)
        take = list(range(oset.n_keys))
        if oset.has_nan and not (dropna or dropnan):
            take.append(oset.nan_ordinal)
        if oset.has_null and not (dropna or dropmissing):
            take.append(oset.null_ordinal)
        values = keys[take] if len(take) != len(keys) else keys
        if array_type in ("list", "python"):
            values = values.tolist(None) if isinstance(values, np.ma.MaskedArray) else (
                values.tolist())
        if return_inverse:
            return values, self.evaluate_ordinal(expression, oset)
        return values

    def evaluate_ordinal(self, expression, oset):
        var = self.add_variable("set_inverse", oset, unique=True)
        return self.evaluate(f"_ordinal_values({expression}, {var})")

    def isin(self, values, column_names=None):
        """True where any of the columns holds one of ``values``."""
        exprs = [self[name].isin(values) for name in column_names or self.get_column_names()]
        expr = exprs[0]
        for e in exprs[1:]:
            expr = expr | e
        return expr

    # -------------------------------------------------------------- devices
    def to_device(self, device=None, column_names=None):
        """Stage columns as tensors on ``device`` (default ``settings.DEVICE``).

        Columns whose dtype has a torch tensor type move (a datetime64 or
        timedelta64 column as int64; the dataset remembers its dtype);
        masked columns and the rest stay host-side, and the passes over them run on
        ``device`` too.  Torch raises when the device does not exist: there is no
        silent CPU run."""
        device = torch.device(device or settings.DEVICE)
        names = column_names or self.get_column_names(hidden=True)
        columns = {}
        for name in self.dataset:
            col = self.dataset[name]
            if (name in names and not isinstance(col, np.ma.MaskedArray)
                    and has_torch_dtype(dtype_of(col).numpy)):
                col = array_types.to_tensor(col, device)
            columns[name] = col
        df = self.copy()
        df.dataset = DatasetArrays(columns, self.dataset.logical, device)
        return df

    def __repr__(self):
        return (f"<vaex_tpu_torch.DataFrame rows={len(self)} "
                f"columns={self.get_column_names()}>")


def _ensure_list(x):
    if x is None:
        return []
    return [str(e) for e in x] if isinstance(x, (list, tuple)) else [str(x)]


def _is_pair(limits):
    """True for one explicit ``[vmin, vmax]`` (numbers, not limit specs)."""
    return (isinstance(limits, (list, tuple, np.ndarray)) and len(limits) == 2
            and np.isscalar(limits[0]) and not isinstance(limits[0], str))


def _resolved(value):
    """A promise that already holds ``value``."""
    @delayed
    def give():
        return value
    return give()


def _descending(data):
    """A key whose ascending order is the descending order of ``data``."""
    if data.dtype.kind == "i":
        return ~data  # -x - 1: exact, where -x overflows at the minimum
    if data.dtype.kind == "u":
        return np.iinfo(data.dtype).max - data
    if data.dtype.kind == "b":
        return ~data
    return -data.astype(np.float64)

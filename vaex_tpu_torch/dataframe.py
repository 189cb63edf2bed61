"""DataFrame: the lazy API over the PyTorch execution engine.

The slice of ``vaex_tpu/dataframe.py`` on the main path: a DataFrame owns
an immutable Dataset plus category metadata; ``to_device`` stages columns
as tensors on a torch device; the statistics (``count``, ``sum``, ``mean``,
``var``, ``std``, ``min``, ``max``, ``minmax``, ``covar``,
``correlation``) and ``groupby`` build aggregation tasks that one pass of
the executor runs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import agg as agg_module
from . import array_types, settings
from .column import column_device
from .dataset import Dataset, DatasetArrays
from .datatype import DataType, dtype_of, has_torch_dtype
from .delayed import delayed
from .execution import ExecutorLocal, _tile
from .expression import Expression
from .ops.binners import BinnerOrdinal
from .scopes import DeviceScope, column_names
from .utils import valid_expression_name


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

    def copy(self, column_names=None):
        df = DataFrame.__new__(DataFrame)
        df.dataset = self.dataset
        df.executor = self.executor
        df.column_names = list(column_names if column_names is not None else self.column_names)
        df._categories = dict(self._categories)
        df._tile_rows = self._tile_rows
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
            return dtype_of(self.dataset[expression])
        return DataType(self._evaluate_rows(expression, 0, min(1, len(self))).dtype)

    def __len__(self):
        return self.dataset.row_count

    def dataset_for_execution(self):
        return self.dataset

    def __getitem__(self, item):
        if isinstance(item, (str, Expression)):
            return Expression(self, item)
        if isinstance(item, (list, tuple)):
            return self.copy(column_names=[str(c) for c in item])
        if isinstance(item, slice):
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
            vmax = self._evaluate_rows(column, 0, len(self)).max()
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
    def _evaluate_rows(self, expression, i1, i2):
        """An expression over rows [i1, i2), eagerly, as a host array."""
        names = column_names(expression)
        scope = DeviceScope({n: _tile(self.dataset[n], i1, i2, column_device(self.dataset[n]))
                             for n in names})
        value = scope.evaluate(str(expression))
        data = array_types.to_numpy(value.data)
        if value.mask is not None:
            mask = array_types.to_numpy(value.mask)
            if mask.any():
                return np.ma.MaskedArray(data, mask)
        return data

    def evaluate(self, expression):
        """Values of an expression as a host numpy (masked) array."""
        expression = str(expression)
        if expression in self.dataset:
            return array_types.to_numpy(self.dataset[expression][:])
        return self._evaluate_rows(expression, 0, len(self))

    # ---------------------------------------------------------- aggregation
    def execute(self):
        self.executor.execute()

    def _create_binners(self, binby):
        binby = [str(b) for b in (binby if isinstance(binby, (list, tuple)) else [binby])]
        binners = []
        for expr in binby:
            if not self.is_category(expr):
                raise NotImplementedError(
                    f"binby over the non-category {expr!r} is not ported yet "
                    f"(ROADMAP queue A5)")
            binners.append(BinnerOrdinal(expr, self.category_offset(expr),
                                         self.category_count(expr)))
        return tuple(binners)

    def _compute_agg(self, name, expression, binby=(), selection=None, delay=False,
                     edges=False, **agg_kwargs):
        binners = self._create_binners(binby) if binby else ()
        if name == "count" and (expression is None or str(expression) == "*"):
            desc = agg_module.count("*", selection=selection)
        else:
            desc = agg_module.aggregates[name](str(expression), selection=selection,
                                               **agg_kwargs)
        [promise] = desc.add_tasks(self, binners)
        ndim = len(binners)

        @delayed
        def finish(grid):
            grid = array_types.to_numpy(grid)
            if ndim and not edges:
                return agg_module.extract_central(grid, ndim)
            return grid if ndim else grid.reshape(())[()]
        return self._delay(delay, finish(promise))

    def _delay(self, delay, result):
        if delay:
            return result
        self.execute()
        return result.get()

    def count(self, expression=None, binby=(), selection=None, delay=False, edges=False):
        return self._compute_agg("count", expression, binby, selection, delay, edges)

    def sum(self, expression, binby=(), selection=None, delay=False, edges=False):
        return self._compute_agg("sum", expression, binby, selection, delay, edges)

    def mean(self, expression, binby=(), selection=None, delay=False, edges=False):
        return self._compute_agg("mean", expression, binby, selection, delay, edges)

    def min(self, expression, binby=(), selection=None, delay=False, edges=False):
        return self._compute_agg("min", expression, binby, selection, delay, edges)

    def max(self, expression, binby=(), selection=None, delay=False, edges=False):
        return self._compute_agg("max", expression, binby, selection, delay, edges)

    def var(self, expression, binby=(), selection=None, delay=False, edges=False, ddof=0):
        return self._compute_agg("var", expression, binby, selection, delay, edges, ddof=ddof)

    def std(self, expression, binby=(), selection=None, delay=False, edges=False, ddof=0):
        return self._compute_agg("std", expression, binby, selection, delay, edges, ddof=ddof)

    def minmax(self, expression, binby=(), selection=None, delay=False):
        """[min, max] of an expression, or of each of a list of them, stacked
        on the last axis (vaex_tpu/dataframe.py:895-921)."""
        multi = isinstance(expression, (list, tuple))
        pairs = [(self.min(e, binby, selection, delay=True),
                  self.max(e, binby, selection, delay=True))
                 for e in (expression if multi else [expression])]

        @delayed
        def finish(*grids):
            out = [np.stack([grids[i], grids[i + 1]], axis=-1) for i in range(0, len(grids), 2)]
            return np.stack(out) if multi else out[0]
        return self._delay(delay, finish(*[g for pair in pairs for g in pair]))

    def covar(self, x, y, binby=(), selection=None, delay=False):
        """cov(x, y) = E[xy] - E[x]E[y], each mean over its own valid rows
        (vaex_tpu/dataframe.py:1027-1038)."""
        x, y = str(x), str(y)
        mean_xy = self.mean(f"({x}) * ({y})", binby, selection, delay=True)
        mean_x = self.mean(x, binby, selection, delay=True)
        mean_y = self.mean(y, binby, selection, delay=True)

        @delayed
        def finish(mxy, mx, my):
            return np.asarray(mxy) - np.asarray(mx) * np.asarray(my)
        return self._delay(delay, finish(mean_xy, mean_x, mean_y))

    def correlation(self, x, y=None, binby=(), selection=None, delay=False):
        """Pearson correlation covar(x, y) / (std(x) std(y)), or the matrix
        of a list of expressions when y is None
        (vaex_tpu/dataframe.py:1040-1058)."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of expressions")
            return np.array([[self.correlation(a, b, binby, selection) for b in x]
                             for a in x])
        x, y = str(x), str(y)
        cov = self.covar(x, y, binby, selection, delay=True)
        std_x = self.std(x, binby, selection, delay=True)
        std_y = self.std(y, binby, selection, delay=True)

        @delayed
        def finish(c, sx, sy):
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.asarray(c) / (np.asarray(sx) * np.asarray(sy))
        return self._delay(delay, finish(cov, std_x, std_y))

    # ---------------------------------------------------------------- order
    def take(self, indices):
        """The rows at ``indices`` (host ints): numpy columns are indexed on
        the host, tensor columns on their device."""
        indices = np.asarray(indices, dtype=np.int64)
        columns = {}
        for name in self.dataset:
            col = self.dataset[name]
            if isinstance(col, torch.Tensor):
                columns[name] = col[torch.as_tensor(indices, device=col.device)]
            else:
                columns[name] = col[indices]
        df = self.copy()
        df.dataset = DatasetArrays(columns)
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

    def groupby(self, by=None, agg=None, sort=False, ascending=True):
        from .groupby import GroupBy
        gb = GroupBy(self, by=by, sort=sort, ascending=ascending)
        if agg is None:
            return gb
        return gb.agg(agg)

    # -------------------------------------------------------------- devices
    def to_device(self, device=None, column_names=None):
        """Stage columns as tensors on ``device`` (default ``settings.DEVICE``).

        Columns whose dtype has a torch tensor type move; masked columns and
        the rest stay host-side.  Torch raises when the device does not
        exist: there is no silent CPU run."""
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
        df.dataset = DatasetArrays(columns)
        return df

    def __repr__(self):
        return (f"<vaex_tpu_torch.DataFrame rows={len(self)} "
                f"columns={self.get_column_names()}>")


def _descending(data):
    """A key whose ascending order is the descending order of ``data``."""
    if data.dtype.kind == "i":
        return ~data  # -x - 1: exact, where -x overflows at the minimum
    if data.dtype.kind == "u":
        return np.iinfo(data.dtype).max - data
    if data.dtype.kind == "b":
        return ~data
    return -data.astype(np.float64)

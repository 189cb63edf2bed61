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

Virtual columns (``add_virtual_column``, ``df[name] = expression``) are
expressions under a name, evaluated in the pass that reads them
(:class:`~vaex_tpu_torch.scopes.DeviceScope`); ``rename``, ``drop`` and
``add_column`` follow ``vaex_tpu/dataframe.py:142-282``.  Named selections
(``select``, ``select_box`` ... ``select_lasso``, undo and redo per name,
:mod:`~vaex_tpu_torch.selections`) each lower to one boolean expression,
which a statistic's ``selection=`` (``True`` for ``"default"``, a name, an
expression, or a list of them) resolves to.  The filter stays the port's
own boolean expression; it is not a selection named ``__filter__`` as in
``vaex_tpu``.

The row operations (``take``, slices, ``head``, ``tail``, ``sort``,
``extract``, ``concat``; of a filtered frame the rows its filter keeps) make
lazy dataset nodes whose columns a pass reads tile by tile on their device
(:mod:`.dataset`, :mod:`.column`), and ``join`` probes its left key on the
pass device (:mod:`.join`).  ``evaluate`` reads rows [i1, i2) of the rows
the filter keeps and of those the rows a selection keeps; ``dropna`` and
its kin are filters, ``fillna`` virtual columns, ``sample`` / ``shuffle`` /
``split_random`` lazy takes of numpy's draw, and ``materialize`` leaves a
frame staged on a device a tensor there (vaex_tpu/dataframe.py:117-141,
658-739, 1555-1720, 1776-1826).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List

import numpy as np
import torch

from . import agg as agg_module
from . import array_types, expresso, settings, tracing
from . import selections as selections_module
from .column import (STRINGS, Column, ColumnDictionary, ColumnMasked, ColumnString,
                     ColumnHost, ColumnVirtualConstant, column_to, placed_device, tile_of)
from .column import is_masked as column_is_masked
from .dataset import Dataset, DatasetArrays
from .datatype import DataType, dtype_of, host_values
from .delayed import delayed
from .execution import ExecutorLocal, pass_inputs
from .expression import Expression, _set_of
from .ops.nullable import NA, DictNA
from .ops.binners import BinnerOrdinal, BinnerScalar
from .scopes import HostScope, classify_leaves, expression_is_device, host_chunk
from .selections import FILTER_SELECTION_NAME  # noqa: F401  (vaex_tpu exports it here)
from .tasks import TaskFilterMask, TaskMapIndex, TaskMapReduce, TaskSetCreate
from .utils import Signal, find_valid_name, fingerprint, valid_expression_name

logger = logging.getLogger("vaex_tpu_torch.dataframe")

_main_executor = None


def get_main_executor():
    """One executor for the process, made at the first call
    (vaex_tpu/dataframe.py:42-47); a frame made without an executor gets
    one of its own."""
    global _main_executor
    if _main_executor is None:
        _main_executor = ExecutorLocal()
    return _main_executor


def supported_array_like():
    """The types ``df[name] = value`` adds as a column: host arrays, lists,
    tensors, arrow arrays and columns (vaex_tpu/dataframe.py:2011-2018)."""
    import pyarrow as pa
    return (np.ndarray, torch.Tensor, list, tuple, pa.Array, pa.ChunkedArray, Column)


class DataFrame:
    def __init__(self, dataset: Dataset, executor=None):
        # a name that is not an identifier cannot appear in an expression: it
        # is renamed on entry, "xi % 5" to "xi___5" (vaex_tpu/dataframe.py:50-59)
        renaming = {}
        for name in dataset:
            if not valid_expression_name(name):
                renaming[name] = find_valid_name(name, used=set(dataset) | set(renaming.values()))
        if renaming:
            dataset = dataset.renamed(renaming)
        self.dataset = dataset
        self.executor = executor or ExecutorLocal()
        self.column_names: List[str] = list(dataset)
        self.virtual_columns: Dict[str, str] = {}  # name -> expression
        self.selections: Dict[str, selections_module.Selection] = {}
        self.selection_histories: Dict[str, list] = {}
        self.selection_history_indices: Dict[str, int] = {}
        self._categories: Dict[str, dict] = {}
        self._tile_rows = None  # rows per tile of a pass (None: settings.TILE_ROWS)
        self.variables: Dict[str, object] = {}  # sets and arrays that expressions name
        self._filter = None  # the boolean expression of a filtered frame
        self._filtered_length = None
        self._dtypes = {}  # (expression, virtual columns) -> (dataset, DataType)
        self.functions = {}  # name -> the Python function of a UDF (add_function)
        self._function_impls = {}  # name -> its host implementation over host arrays
        self.units = {}
        # (start, stop, the whole dataset) while an active range is set
        self._active_range = None
        # emitted with (df, name) whenever a selection changes
        self.signal_selection_changed = Signal("selection-changed")

    def copy(self, column_names=None):
        df = DataFrame.__new__(DataFrame)
        df.dataset = self.dataset
        df.executor = self.executor
        df.column_names = list(column_names if column_names is not None else self.column_names)
        df.virtual_columns = dict(self.virtual_columns)
        df.selections = dict(self.selections)
        df.selection_histories = {k: list(v) for k, v in self.selection_histories.items()}
        df.selection_history_indices = dict(self.selection_history_indices)
        df._categories = dict(self._categories)
        df._tile_rows = self._tile_rows
        df.variables = dict(self.variables)
        df._filter = self._filter
        df._filtered_length = self._filtered_length
        df._dtypes = dict(self._dtypes)
        df.functions = dict(self.functions)
        df._function_impls = dict(self._function_impls)
        df.units = dict(self.units)
        df._active_range = self._active_range
        df.signal_selection_changed = Signal("selection-changed")
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
        (sampled), the filter, the virtual columns and the variables."""
        return fingerprint("dataframe", self.dataset.fingerprint(), self._filter,
                           self.virtual_columns, self.variables)

    def _cache_key(self, expressions):
        """(an exact key of what a pass over ``expressions`` reads, whether it
        is a content key), or (None, False) where there is none: the columns
        they and the filter read (:meth:`.dataset.Dataset.cache_key`), the
        filter, the virtual columns, the variables and the functions they
        name.  A CPU tensor counts by all its bytes and a card tensor has no
        key (:func:`.utils.tensor_key`), a set or a function by its identity
        (:func:`.utils.identity`): what the key names can change only as
        the key does."""
        from .column import _arrow_fingerprint
        from .utils import identity, tensor_key
        columns, variables, functions = set(), set(), set()
        for expression in [*expressions, *([self._filter] if self._filter else [])]:
            f, c, v = classify_leaves(self, expression)
            functions |= f
            columns |= c
            variables |= v
        dataset_key, content = self.dataset.cache_key(columns & set(self.dataset))
        if dataset_key is None:
            return None, False
        values = {}
        for name in sorted(variables):
            value = self.variables[name]
            if isinstance(value, torch.Tensor):
                values[name], exact = tensor_key(value)
                if values[name] is None:
                    return None, False
                content = content and exact
            elif isinstance(value, (np.ndarray, str, int, float, np.generic)) or value is None:
                values[name] = fingerprint(value)
            elif array_types.is_arrow(value):  # immutable: all its buffers
                values[name] = _arrow_fingerprint(value)
            else:  # a set, built once and not changed after
                values[name], content = identity(value), False
        udfs = {name: identity(self.functions[name]) for name in sorted(functions)
                if name in self.functions}
        return (dataset_key, self._filter, sorted(self.virtual_columns.items()), values,
                udfs), content and not udfs

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
    def get_column_names(self, virtual=True, strings=True, hidden=False, regex=None):
        """The column names in order; hidden ones (``__`` first) only with
        ``hidden``, virtual ones unless ``virtual`` is off, string ones
        unless ``strings`` is off, and only those ``regex`` matches when one
        is given."""
        names = [n for n in self.column_names if hidden or not n.startswith("__")]
        if not virtual:
            names = [n for n in names if n not in self.virtual_columns]
        if not strings:
            names = [n for n in names if not self.data_type(n).is_text]
        if regex:
            names = [n for n in names if re.match(regex, n)]
        return names

    def get_names(self, hidden=False):
        return self.get_column_names(hidden=hidden)

    def evaluate_variable(self, name):
        """The value kept under a variable's name (a set, an array)."""
        return self.variables[name]

    def byte_size(self, selection=False, virtual=False):
        """The bytes the columns' values take at their dtype's item size over
        the frame's rows, string columns left out (vaex_tpu/dataframe.py:
        1943-1950)."""
        return sum(self.data_type(name).numpy.itemsize * len(self)
                   for name in self.get_column_names(virtual=virtual)
                   if not self.data_type(name).is_text)

    def column_count(self, hidden=False):
        return len(self.get_column_names(hidden=hidden))

    def __contains__(self, name):
        return name in self.get_column_names(hidden=True)

    def _is_physical(self, name):
        return name in self.dataset and name not in self.virtual_columns

    def add_column(self, name, data):
        """Add an array (a numpy array, a masked array or a tensor of the
        frame's length) or a scalar (a :class:`ColumnVirtualConstant`) as
        a column; one of the same name is replaced."""
        if np.isscalar(data):
            data = ColumnVirtualConstant(data, self.dataset.row_count)
        self._put_column(name, data)

    def _put_column(self, name, data, logical=None):
        """Put a column into the dataset under ``name`` (``logical``: the
        numpy datetime / timedelta dtype an int64 tensor stands for)."""
        if len(data) != self.dataset.row_count:
            raise ValueError(f"array of length {len(data)} does not match the frame's length "
                             f"{self.dataset.row_count}")
        new = DatasetArrays({name: data}, None if logical is None else {name: logical})
        if name in self.dataset:
            self.dataset = self.dataset.dropped(name).merged(new)
        else:
            self.dataset = self.dataset.merged(new) if len(self.dataset) else new
        if name not in self.column_names:
            self.column_names.append(name)
        self._filtered_length = None

    def add_virtual_column(self, name, expression):
        """Name an expression (vaex_tpu/dataframe.py:229-258).  An expression
        that names the column itself means its old value: ``x = x * 2`` of a
        virtual x takes x's old definition, and of a physical x hides the
        data as ``__x`` and refers to that."""
        name = find_valid_name(name)
        expression = str(expression)
        refers_self = name in expresso.collect_names(expression)
        if refers_self and name in self.virtual_columns:
            expression = expresso.substitute(expression, {name: f"({self.virtual_columns[name]})"})
        elif refers_self and name in self.dataset:
            hidden = find_valid_name(f"__{name}", used=self.column_names)
            self.dataset = self.dataset.renamed({name: hidden})
            self.column_names.append(hidden)
            expression = expresso.translate(expression, lambda n: hidden if n == name else None)
        self.virtual_columns[name] = expression
        if name not in self.column_names:
            self.column_names.append(name)
        self._filtered_length = None
        return name

    def delete_virtual_column(self, name):
        if name not in self.virtual_columns:
            raise KeyError(f"{name!r} is not a virtual column")
        del self.virtual_columns[name]
        if name in self.column_names:
            self.column_names.remove(name)
        self._filtered_length = None

    def rename(self, name, new_name):
        """Rename a column, physical or virtual, and rewrite the virtual
        columns that refer to it."""
        if name in self.virtual_columns:
            self.virtual_columns[new_name] = self.virtual_columns.pop(name)
        else:
            self.dataset = self.dataset.renamed({name: new_name})
        self.column_names = [new_name if n == name else n for n in self.column_names]
        self.virtual_columns = {
            k: expresso.translate(v, lambda n: new_name if n == name else None)
            for k, v in self.virtual_columns.items()}
        return new_name

    def drop(self, columns, inplace=False, check=True):
        """A frame without the named columns; a physical one stays in the
        dataset, so the virtual columns that read it still work.  ``check``
        changes nothing, as in vaex_tpu (vaex_tpu/dataframe.py:273)."""
        columns = [columns] if isinstance(columns, (str, Expression)) else columns
        df = self if inplace else self.copy()
        for name in map(str, columns):
            df.virtual_columns.pop(name, None)
            df.column_names = [n for n in df.column_names if n != name]
        return df

    def __setitem__(self, name, value):
        if isinstance(value, Expression):
            self.add_virtual_column(name, value.expression)
        elif isinstance(value, supported_array_like()):
            self.add_column(name, np.asarray(value) if isinstance(value, (list, tuple))
                            else value)
        else:
            self.add_virtual_column(name, str(value))

    def __delitem__(self, name):
        self.drop(str(name), inplace=True)

    def data_type(self, expression, array_type=None, internal=False, axis=0,
                  expand=True) -> DataType:
        """dtype of a column, or of an expression evaluated over one row;
        strings have their arrow type (a dictionary type where they are
        codes).  The other arguments change nothing, as in vaex_tpu
        (vaex_tpu/dataframe.py:332-344)."""
        expression = str(expression)
        if self._is_physical(expression):
            logical = self.dataset.logical.get(expression)
            return DataType(logical) if logical is not None else dtype_of(
                self.dataset[expression])
        # remembered per expression and virtual columns while the dataset
        # node stays: every descriptor of a statistic asks, and each asking
        # evaluates the expression over a row
        key = (expression, frozenset(self.virtual_columns.items()))
        known = self._dtypes.get(key)
        if known is None or known[0] is not self.dataset:
            rows = min(1, self.dataset.row_count)
            if expression_is_device(self, expression):
                value = self._evaluate_tile(expression, 0, rows, filtered=False)
                dtype = (_dictionary_type(value.labels) if isinstance(value, DictNA)
                         else value.logical or value.data.dtype)
            else:
                dtype = _host_dtype(self._evaluate_host(expression, 0, rows))
            known = self._dtypes[key] = (self.dataset, DataType(dtype))
        return known[1]

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

    # ------------------------------------------------------------ row nodes
    def _rebind_dataset(self, dataset, keep_filter=True):
        """A copy over another dataset; without ``keep_filter`` also
        without the filter (vaex_tpu/dataframe.py:176-185)."""
        df = self.copy()
        df.dataset = dataset
        df._filtered_length = None
        df._active_range = None
        if not keep_filter:
            df._filter = None
        return df

    def _filter_mask(self):
        """The rows the filter keeps, as a bool tensor on the pass device:
        one pass."""
        task = self.executor.schedule(TaskFilterMask(self))
        self.execute()
        return task.get()

    def extract(self):
        """A frame of the rows the filter keeps, without the filter: a
        ``filtered`` node whose row indices come from ``torch.nonzero`` of
        the filter's mask on the pass device, so the columns are read through
        them and not copied (vaex_tpu/dataframe.py:402-413)."""
        if not self.filtered:
            return self.trim()
        dataset = self.dataset.filtered(self._filter_mask(), origin=(
            self._filter, self.virtual_columns, self.variables))
        return self._rebind_dataset(dataset, keep_filter=False)

    def trim(self, inplace=False):
        """The frame over its own rows only: a slice is a node of its own
        rows already, so this is a copy (vaex_tpu/dataframe.py:415-424)."""
        return self if inplace else self.copy()

    def __getitem__(self, item):
        if isinstance(item, str):
            return Expression(self, item)
        if isinstance(item, Expression):
            return self.filter(item.expression)
        if isinstance(item, (list, tuple)):
            return self.copy(column_names=[str(c) for c in item])
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            if step != 1:
                raise ValueError("slices with a step are not supported")
            df = self.extract()  # of a filtered frame: the rows it keeps
            return df._rebind_dataset(df.dataset.slice(start, max(start, stop)))
        raise TypeError(f"cannot index with {item!r}")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in object.__getattribute__(self, "column_names"):
            return Expression(self, name)
        if name in _df_accessors:
            # built once per frame (vaex_tpu/dataframe.py:1986-1989)
            accessor = _df_accessors[name](self)
            object.__setattr__(self, name, accessor)
            return accessor
        raise AttributeError(name)

    # ----------------------------------------------------------- selections
    def select(self, expression, mode="replace", name="default"):
        """Set the selection ``name`` to a boolean expression, combined with
        the one it replaces by ``mode``: "replace", "and", "or", "xor" or
        "subtract" (vaex_tpu/dataframe.py:442-451)."""
        previous = self.selections.get(name)
        selection = None
        if expression is not None:
            selection = selections_module.SelectionExpression(
                str(expression), previous, mode if previous is not None else "replace")
        self._set_selection(name, selection)

    def select_nothing(self, name="default"):
        self._set_selection(name, None)

    def select_inverse(self, name="default"):
        previous = self.selections.get(name)
        if previous is not None:
            self._set_selection(name, selections_module.SelectionInvert(previous))

    def select_box(self, spaces, limits, mode="replace", name="default"):
        """The rows where each expression of ``spaces`` lies in [lo, hi) of its
        pair of ``limits``."""
        parts = [f"(({space}) >= {lo}) & (({space}) < {hi})"
                 for space, (lo, hi) in zip(spaces, limits)]
        self.select(" & ".join(f"({p})" for p in parts), mode=mode, name=name)

    def select_rectangle(self, x, y, limits, mode="replace", name="default"):
        self.select_box([x, y], limits, mode=mode, name=name)

    def select_circle(self, x, y, xc, yc, r, mode="replace", name="default", inclusive=True):
        op = "<=" if inclusive else "<"
        self.select(f"((({x}) - {xc})**2 + (({y}) - {yc})**2) {op} {r}**2", mode=mode,
                    name=name)

    def select_ellipse(self, x, y, xc, yc, width, height, angle=0, mode="replace",
                       name="default", radians=False):
        """The rows inside the ellipse of centre (xc, yc), axes ``width`` and
        ``height``, turned by ``angle`` (degrees unless ``radians``)."""
        if not radians:
            angle = np.radians(angle)
        xr, yr = width / 2.0, height / 2.0
        ca, sa = np.cos(angle), np.sin(angle)
        self.select(f"(((({x}) - {xc}) * {ca} + (({y}) - {yc}) * {sa})**2 / {xr}**2 + "
                    f"((({x}) - {xc}) * {sa} - (({y}) - {yc}) * {ca})**2 / {yr}**2) <= 1",
                    mode=mode, name=name)

    def select_lasso(self, expression_x, expression_y, xsequence, ysequence, mode="replace",
                     name="default"):
        """The rows inside the polygon of vertices (xsequence, ysequence)
        (``pnpoly``)."""
        previous = self.selections.get(name)
        self._set_selection(name, selections_module.SelectionLasso(
            expression_x, expression_y, xsequence, ysequence, previous,
            mode if previous is not None else "replace"))

    def select_non_missing(self, drop_nan=True, drop_masked=True, column_names=None,
                           mode="replace", name="default"):
        """The rows where no column of ``column_names`` (default: all) is NaN
        (``drop_nan``) or missing (``drop_masked``)."""
        self._set_selection(name, selections_module.SelectionDropNa(
            column_names, drop_nan=drop_nan, drop_masked=drop_masked))

    def _set_selection(self, name, selection):
        if selection is None:
            self.selections.pop(name, None)
        else:
            self.selections[name] = selection
        history = self.selection_histories.setdefault(name, [])
        # a new selection after an undo drops the steps that were undone
        del history[self.selection_history_indices.get(name, -1) + 1:]
        history.append(selection)
        self.selection_history_indices[name] = len(history) - 1
        self.signal_selection_changed.emit(self, name)

    def _select_step(self, name, index):
        self.selection_history_indices[name] = index
        selection = self.selection_histories[name][index] if index >= 0 else None
        if selection is None:
            self.selections.pop(name, None)
        else:
            self.selections[name] = selection

    def selection_undo(self, name="default"):
        if self.selection_can_undo(name):
            self._select_step(name, self.selection_history_indices[name] - 1)
        self.signal_selection_changed.emit(self, name)

    def selection_redo(self, name="default"):
        if self.selection_can_redo(name):
            self._select_step(name, self.selection_history_indices.get(name, -1) + 1)
        self.signal_selection_changed.emit(self, name)

    def selection_can_undo(self, name="default"):
        return self.selection_history_indices.get(name, -1) > -1

    def selection_can_redo(self, name="default"):
        return (self.selection_history_indices.get(name, -1) + 1
                < len(self.selection_histories.get(name, [])))

    def has_selection(self, name="default"):
        return name in self.selections

    def get_selection(self, name="default"):
        return self.selections.get(name)

    # ------------------------------------------------------------ categories
    def categorize(self, column, min_value=0, labels=None, inplace=False):
        """Mark an integer column as categorical with codes
        ``min_value .. min_value + len(labels) - 1``; a string column takes
        the codes of its values among ``labels`` (its sorted distinct
        values by default; a value that is no label is missing)."""
        df = self if inplace else self.copy()
        column = str(column)
        if self.data_type(column).is_text:
            labels = list(labels) if labels is not None else self.unique(column, dropmissing=True)
            oset = _set_of(labels)
            # each set key's place among the labels
            places = np.zeros(oset.count, np.int64)
            places[np.asarray(oset.map_ordinal(labels), np.int64)] = np.arange(len(labels))
            set_var = df.add_variable("category_set", oset, unique=True)
            places_var = df.add_variable("category_places", places, unique=True)
            codes = df.add_virtual_column(
                f"__{column}_codes", f"_choose(_ordinal_values({column}, {set_var}), "
                                     f"{places_var})")
            import pyarrow as pa
            df._categories[column] = {"labels": _labels_array(labels), "N": len(labels),
                                      "min_value": 0, "codes_column": codes,
                                      "arrow": pa.array(labels, type=pa.string())}
            return df
        if labels is None:
            vmax = self.max(column)  # one pass on the frame's device
            labels = np.arange(int(min_value), int(vmax) + 1)
            min_value = int(min_value)
        # kept as an array: a groupby reads the labels on every call, and a
        # list of 1e6 labels takes tens of ms to become one
        labels = np.asarray(labels)
        df._categories[column] = {"labels": labels, "N": len(labels), "min_value": min_value}
        return df

    def ordinal_encode(self, column, values=None, inplace=False, lazy=False):
        """A virtual column ``<column>_ordinal`` of each value's ordinal among
        the sorted distinct values (or ``values``), a category with those
        values as labels (vaex_tpu/dataframe.py:571-592); NaN and missing
        values fall outside the codes."""
        df = self if inplace else self.copy()
        column = str(column)
        if values is None:
            oset = df._set(column)
            values = list(oset.key_array(masked=False)[:oset.n_keys])
        else:
            oset = _set_of(values)
            values = list(values)
        var = df.add_variable("ordinal_set", oset, unique=True)
        name = column if lazy else f"{column}_ordinal"
        df.add_virtual_column(name if name != column else f"__{column}_codes",
                              f"_ordinal_values({column}, {var})")
        df._categories[name] = {"labels": _labels_array(values), "N": len(values),
                                "min_value": 0}
        if oset.is_string:
            import pyarrow as pa
            df._categories[name]["arrow"] = pa.array(values, type=pa.string())
        return df

    def is_category(self, column):
        """True for a categorized column, or a string column held as a
        dictionary (staged, or given as a dictionary array)."""
        return self._category_meta(column) is not None

    def _category_meta(self, column):
        """The category metadata, derived once from the labels of a string
        column held as a dictionary (vaex_tpu/dataframe.py:605-640): its
        dictionary's labels in code order, and a None label for the null
        rows, which take the code after the last label."""
        column = str(column)
        meta = self._categories.get(column)
        derived = meta is not None and "column" in meta
        if meta is not None and not derived or not self._is_physical(column):
            return meta
        col = self.dataset[column]
        if derived and meta["column"] is col:
            return meta
        if isinstance(col, ColumnDictionary):
            labels, has_null = col.labels, col.has_null
        elif isinstance(col, ColumnString) and self.data_type(column).is_encoded:
            labels, has_null = col.array.dictionary, col.null_count > 0
        else:
            return None
        if labels.null_count:
            return None  # a null label: the set grouper names it once
        # remembered with the column it was read from, for as long as the
        # frame holds that column
        meta = dict(_string_category(labels, has_null, f"_codes({column})"), column=col)
        self._categories[column] = meta
        return meta

    def category_labels(self, column, aslist=True):
        labels = self._category_meta(column)["labels"]
        return labels.tolist() if aslist else labels

    def category_count(self, column):
        return self._category_meta(column)["N"]

    def category_offset(self, column):
        return self._category_meta(column)["min_value"]

    # ------------------------------------------------------------ evaluation
    def _evaluate_rows(self, expression, i1, i2, filtered=True):
        """An expression over rows [i1, i2), eagerly, as a host array; of a
        filtered frame the rows the filter keeps, unless ``filtered`` is off.
        Strings come back as an arrow array (a dictionary array where the
        pass held them as codes)."""
        if not expression_is_device(self, expression):
            value = self._evaluate_host(expression, i1, i2)
            if filtered and self.filtered:
                keep = self._evaluate_tile(self._filter, i1, i2, filtered=False)
                keep = array_types.to_numpy(keep.data.to(torch.bool) if keep.mask is None
                                            else keep.data.to(torch.bool) & ~keep.mask)
                value = value.filter(keep) if array_types.is_arrow(value) else value[keep]
            return value
        value = self._evaluate_tile(expression, i1, i2, filtered)
        if isinstance(value, DictNA):
            return _decode(value)
        data, mask = array_types.to_numpy(value.data), value.mask
        logical = value.logical or (self.dataset.logical.get(expression)
                                    if self._is_physical(expression) else None)
        # a datetime, timedelta or unsigned value from its int64 tensor
        data = host_values(data, logical)
        if mask is not None:
            mask = array_types.to_numpy(mask)
            if mask.any():
                return np.ma.MaskedArray(data, mask)
        return data

    def _evaluate_host(self, expression, i1, i2):
        """An expression of the host stage over rows [i1, i2) of the
        dataset, on the host: an arrow array of strings, else a numpy
        (masked) array."""
        _, columns, _ = classify_leaves(self, expression)
        missing = set(columns) - set(self.dataset)
        if missing:
            raise NameError(f"column(s) {sorted(missing)} do not exist")
        scope = HostScope({name: host_chunk(self.dataset, name, i1, i2) for name in columns},
                          self.variables, self.virtual_columns, i2 - i1, self._function_impls)
        value = scope.evaluate_raw(str(expression))
        return value if array_types.is_arrow(value) else array_types.to_numpy(value)

    def _evaluate_tile(self, expression, i1, i2, filtered=True):
        """An expression over rows [i1, i2) as an NA on the pass device
        (a DictNA for strings), without a copy to the host."""
        expression = str(expression)
        expressions = [expression]
        if filtered and self.filtered:
            expressions.append(self._filter)
        inputs = pass_inputs(self, self.dataset, expressions)
        ctx = inputs.context(self, self.dataset, i1, i2)
        value = ctx.expr(expression)
        if len(expressions) > 1:
            keep = ctx.boolean(self._filter)
            mask = None if value.mask is None else value.mask[keep]
            if isinstance(value, DictNA):
                return DictNA(value.data[keep], mask, value.labels)
            return NA(value.data[keep], mask, value.logical)
        return value

    def evaluate(self, expression, i1=None, i2=None, out=None, selection=None, filtered=True,
                 array_type=None, parallel=True, chunk_size=None, progress=None):
        """Values of an expression as a host numpy (masked) array
        (vaex_tpu/dataframe.py:658-727): of rows [i1, i2), counted among the
        rows the filter keeps unless ``filtered`` is off; of those only the
        rows ``selection`` keeps (an expression, True, a name; a list gives a
        list of arrays, one per selection).  ``array_type`` converts them
        ("numpy", "list" / "python", "arrow"); ``out`` takes them in place.
        ``parallel``, ``chunk_size`` and ``progress`` are the reference's
        and change nothing here."""
        expression = str(expression)
        if isinstance(selection, (list, tuple)):
            return [self.evaluate(expression, i1, i2, None, s, filtered, array_type)
                    for s in selection]
        df = self._rows_of(i1, i2, selection, filtered)
        if (df._is_physical(expression) and not df.filtered
                and isinstance(df.dataset[expression], STRINGS)):
            values = df.dataset[expression][:]
        elif (df._is_physical(expression) and not df.filtered
                and isinstance(df.dataset[expression], (np.ndarray, torch.Tensor, ColumnHost))):
            values = array_types.to_numpy(df.dataset[expression][:])
            # a datetime, timedelta or unsigned column comes back from its int64 form
            values = host_values(values, df.dataset.logical.get(expression))
        else:
            values = df._evaluate_rows(expression, 0, df.dataset.row_count)
        if out is not None:
            out[...] = values
            return out
        return _converted(values, array_type)

    def _rows_of(self, i1, i2, selection, filtered=True):
        """The frame whose rows :meth:`evaluate` reads: rows [i1, i2) of the
        rows the filter keeps (of all rows without ``filtered``, the filter
        dropped), filtered by ``selection`` on top."""
        df = self if filtered else self._rebind_dataset(self.dataset, keep_filter=False)
        if i1 is not None or i2 is not None:
            df = df.extract()
            i1, i2 = i1 or 0, df.dataset.row_count if i2 is None else i2
            df = df._rebind_dataset(df.dataset.slice(i1, max(i1, i2)))
        selection = agg_module.selection_expression(selection, self)
        return df if selection is None else df.filter(selection)

    def evaluate_iterator(self, expression, s1=None, s2=None, chunk_size=None, parallel=True,
                          array_type=None, prefetch=True, progress=None):
        """Yield ``(i1, i2, values)`` over rows [s1, s2) in chunks of
        ``chunk_size`` rows (a tile by default), counted among the rows the
        filter keeps, which are found once (vaex_tpu/dataframe.py:729-739,
        whose loop ignores ``s1`` and ``s2``); an empty frame yields one
        empty chunk."""
        df = self.extract()
        chunk_size = chunk_size or self._tile_rows or settings.TILE_ROWS
        n = len(df)
        s1 = s1 or 0
        s2 = n if s2 is None else min(s2, n)
        for i1 in range(s1, max(s2, s1 + 1), chunk_size):
            i2 = min(i1 + chunk_size, s2)
            yield i1, i2, df.evaluate(expression, i1, max(i1, i2), array_type=array_type)

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
            if self.is_category(expr):  # a string category bins on its codes
                binners.append(BinnerOrdinal(self._category_meta(expr).get("codes_column", expr),
                                             self.category_offset(expr),
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
                     selection=None, delay=False, edges=False, progress=None, **agg_kwargs):
        """One statistic of an expression, or of each of a list of them,
        over the grid of ``binby``, for one selection or each of a list of
        them: a list of selections stacks on a leading axis, inside the axis
        of a list of expressions (vaex_tpu/dataframe.py:785-832).  The
        statistics take ``array_type`` and give numpy whatever it says, as
        vaex_tpu's do."""
        binners = self._create_binners(binby, limits, shape)
        multi = isinstance(expression, (list, tuple))
        many = isinstance(selection, (list, tuple))
        selections = list(selection) if many else [selection]
        promises, logical = [], []
        for expr in (expression if multi else [expression]):
            for sel in selections:
                if name == "count" and (expr is None or str(expr) == "*"):
                    desc = agg_module.count("*", selection=sel)
                else:
                    desc = agg_module.aggregates[name](str(expr), selection=sel, **agg_kwargs)
                [promise] = desc.add_tasks(self, binners)
                promises.append(promise)
                logical.append(desc.logical_dtype(self))
        ndim, k = len(binners), len(selections)

        @delayed
        def finish(*grids):
            out = []
            for grid, dtype in zip(grids, logical):
                grid = agg_module.view_logical(array_types.to_numpy(grid), dtype)
                if ndim and not edges:
                    grid = agg_module.extract_central(grid, ndim)
                out.append(grid if ndim else grid.reshape(())[()])
            if many and k > 1:
                out = [np.stack(out[i:i + k]) for i in range(0, len(out), k)]
            return np.stack(out) if multi else out[0]
        return self._delay(delay, finish(*promises), progress)

    def _delay(self, delay, result, progress=None):
        """The result, after the passes it needs (with ``progress``, a
        callable, True or "simple", told of each tile: :mod:`.progress`);
        with ``delay`` the promise."""
        if delay:
            return result
        if not result.done:  # a result that needed no pass flushes nothing
            from .progress import scoped_progress
            with scoped_progress(self.executor, progress):
                self.execute()
        return result.get()

    async def execute_async(self):
        """Run the queued passes (vaex_tpu/dataframe.py:745): they run
        eagerly, so this awaits nothing."""
        self.execute()

    def count(self, expression=None, binby=(), limits=None, shape=128, selection=None,
              delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("count", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress)

    def sum(self, expression, binby=(), limits=None, shape=128, selection=None,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("sum", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress)

    def mean(self, expression, binby=(), limits=None, shape=128, selection=None,
             delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("mean", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress)

    def min(self, expression, binby=(), limits=None, shape=128, selection=None,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("min", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress)

    def max(self, expression, binby=(), limits=None, shape=128, selection=None,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("max", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress)

    def var(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False, progress=None, array_type=None, ddof=0):
        return self._compute_agg("var", expression, binby, limits, shape, selection, delay,
                                 edges, ddof=ddof, progress=progress)

    def std(self, expression, binby=(), limits=None, shape=128, selection=None, delay=False,
            edges=False, progress=None, array_type=None, ddof=0):
        return self._compute_agg("std", expression, binby, limits, shape, selection, delay,
                                 edges, ddof=ddof, progress=progress)

    def first(self, expression, order_expression=None, binby=(), limits=None, shape=128,
              selection=None, delay=False, edges=False, progress=None, array_type=None):
        """Per cell the value at the smallest ``order_expression`` (the
        expression itself when none is given); ties go to the earliest row."""
        return self._compute_agg(
            "first", expression, binby, limits, shape, selection, delay, edges,
            progress=progress,
            order_expression=None if order_expression is None else str(order_expression))

    def nunique(self, expression, dropna=False, dropnan=False, dropmissing=False, binby=(),
                limits=None, shape=128, selection=None, delay=False, edges=False,
                progress=None):
        """The number of distinct values, per cell of ``binby``; NaN and a
        missing value count as one each unless dropped
        (vaex_tpu/dataframe.py:875-893): a set-build pass, then a presence
        grid counted by the additive kernels, or sorted (cell, value) pairs
        past ``agg.NUNIQUE_PRESENCE_MAX`` cells (:mod:`.agg`)."""
        return self._compute_agg("nunique", expression, binby, limits, shape, selection, delay,
                                 edges, progress=progress, dropna=dropna, dropnan=dropnan,
                                 dropmissing=dropmissing)

    def minmax(self, expression, binby=(), limits=None, shape=128, selection=None,
               delay=False, progress=None):
        """[min, max] of an expression, or of each of a list of them, stacked
        on the last axis (vaex_tpu/dataframe.py:895-921)."""
        multi = isinstance(expression, (list, tuple))
        binners = self._create_binners(binby, limits, shape)
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
        return self._delay(delay, finish(*promises), progress)

    def limits(self, expression, value=None, square=False, selection=None, delay=False,
               shape=None, progress=None):
        """``[vmin, vmax]`` of an axis from a limits spec: None or "minmax"
        (one minmax pass; a category axis takes its code range), "<p>%" (the
        central p percent, :meth:`limits_percentage`) or an explicit pair.  A
        list of expressions takes one spec for all or one per axis, and its
        minmax axes share one pass (vaex_tpu/dataframe.py:923-945).
        ``square``, ``shape`` and ``progress`` change nothing, as in
        vaex_tpu."""
        if isinstance(expression, (list, tuple)):
            exprs = [str(e) for e in expression]
            if value is None or isinstance(value, str) or _is_pair(value):
                values = [value] * len(exprs)
            else:
                values = list(value)
            if len(values) != len(exprs):
                raise ValueError(f"{len(values)} limits for {len(exprs)} expressions")
            results = [self.limits(e, v, selection=selection, delay=True)
                       for e, v in zip(exprs, values)]

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

    def limits_percentage(self, expression, percentage=99.73, square=False, selection=None,
                          delay=False, progress=None):
        """The limits that hold the central ``percentage`` percent of the
        values: a 1024-bin count grid over [min, max], then interpolation on
        the host (vaex_tpu/dataframe.py:947-966).  ``square`` and
        ``progress`` change nothing, as in vaex_tpu; with ``delay`` the
        limits come in a fulfilled promise (vaex_tpu returns them as they
        are: ROADMAP, known problems of the reference)."""
        return self._delay(delay, _resolved(self._limits_percentage(expression, percentage,
                                                                    selection)))

    def _limits_percentage(self, expression, percentage, selection):
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
                          selection=None, delay=False, progress=None):
        """Approximate percentiles from a count grid over the expression's
        range (per cell of ``binby``, with a trailing axis for it), cumulated
        and interpolated on the host (vaex_tpu/dataframe.py:968-1018).
        ``progress`` changes nothing, as in vaex_tpu; with ``delay`` the
        values come in a fulfilled promise (vaex_tpu returns them as they
        are: ROADMAP, known problems of the reference)."""
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
        return self._delay(delay, _resolved(out if multi else out[0]))

    def median_approx(self, expression, percentage=50, binby=(), limits=None, shape=128,
                      percentile_shape=1024 * 16, percentile_limits="minmax", selection=None,
                      delay=False):
        """The approximate median: ``percentage`` changes nothing, as in
        vaex_tpu (vaex_tpu/dataframe.py:1020-1024)."""
        return self.percentile_approx(expression, 50.0, binby=binby, limits=limits,
                                      shape=shape, percentile_shape=percentile_shape,
                                      percentile_limits=percentile_limits, selection=selection,
                                      delay=delay)

    def covar(self, x, y, binby=(), limits=None, shape=128, selection=None, delay=False,
              progress=None):
        """cov(x, y) = E[xy] - E[x]E[y], each mean over its own valid rows
        (vaex_tpu/dataframe.py:1027-1038), from shifted moments
        (:meth:`_cov_entries`)."""
        binby = _ensure_list(binby)
        limits = self._axis_limits(binby, limits)  # once for every mean
        [entry] = self._cov_entries([str(x), str(y)], [(0, 1)], binby, limits, shape,
                                    selection).values()
        return self._delay(delay, entry, progress)

    def correlation(self, x, y=None, binby=(), limits=None, shape=128, selection=None,
                    delay=False, progress=None):
        """Pearson correlation covar(x, y) / (std(x) std(y)), or the matrix
        of a list of expressions when y is None
        (vaex_tpu/dataframe.py:1040-1058)."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of expressions")
            return self._delay(delay, _resolved(np.array(
                [[self.correlation(a, b, binby, limits, shape, selection, progress=progress)
                  for b in x] for a in x])))
        x, y = str(x), str(y)
        binby = _ensure_list(binby)
        limits = self._axis_limits(binby, limits)  # once for all five passes' tasks
        cov = self.covar(x, y, binby, limits, shape, selection, delay=True)
        std_x = self.std(x, binby, limits, shape, selection, delay=True)
        std_y = self.std(y, binby, limits, shape, selection, delay=True)

        @delayed
        def finish(c, sx, sy):
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.asarray(c) / np.asarray(sx) / np.asarray(sy)
        return self._delay(delay, finish(cov, std_x, std_y), progress)

    def cov(self, x, y=None, binby=(), limits=None, shape=128, selection=None, delay=False,
            progress=None):
        """The covariance matrix ``[..., n, n]`` of the expressions ``x`` (or
        of the pair x, y), per cell of ``binby``: each entry E[x_i x_j] -
        E[x_i] E[x_j], every mean over the rows where its own expression is
        valid, as the reference takes them (vaex_tpu/dataframe.py:1060-1081),
        from shifted moments (:meth:`_cov_entries`): n var ops and n (n - 1)
        / 2 covar ops, one pass of the moment kernels (B4 / B5 by the grid's
        size) over the n base columns."""
        if y is None:
            exprs = [str(e) for e in (x if isinstance(x, (list, tuple)) else [x])]
        else:
            exprs = [str(x), str(y)]
        n = len(exprs)
        binby = _ensure_list(binby)
        limits = self._axis_limits(binby, limits)  # once for every mean
        entries = self._cov_entries(exprs, [(i, j) for i in range(n) for j in range(i, n)],
                                    binby, limits, shape, selection)
        keys = list(entries)

        @delayed
        def finish(*grids):
            C = np.zeros(np.shape(grids[0]) + (n, n))
            for (i, j), g in zip(keys, grids):
                C[..., i, j] = C[..., j, i] = g
            return C
        return self._delay(delay, finish(*(entries[k] for k in keys)))

    def _cov_entries(self, exprs, pairs, binby, limits, shape, selection):
        """Per pair (i, j) of ``exprs`` a delayed entry E_ij[x_i x_j] -
        E_i[x_i] E_j[x_j], each mean over the rows where its own expression
        is valid (the product's: where both are), as vaex_tpu defines it,
        from shifted moments (u_i = x_i - a_i): the pair's covar op gives the
        sums over its rows of u_i u_j, u_i and u_j (P_i = E_ij[u_i]), each
        expression's var op those over its own (M_i = E_i[u_i]), and the
        entry is cov_ij(u) + P_i P_j - M_i M_j + a_j (P_i - M_i) + a_i (P_j -
        M_j); on the diagonal the var.  Where no value is missing P = M.  All
        the ops go through one :func:`.agg.cell_shifted`: a_i is the frame's
        shift, or, in a cell one of the var ops flags, every base's own mean
        there (its table), and where a float64 sum overflowed the ops over
        x * RESCUE_SCALE, the entry scaled back.  A pair's cells are flagged
        through its bases' var ops: the rounding of its cov_ij(u), within 2
        eps sqrt(sum u_i^2 sum u_j^2) over the pair's rows, stays within 2^17
        eps n / c of sigma_i sigma_j where neither is flagged (c the pair's
        rows, n their own: equal where no value is missing).  The kernels
        form the terms from the base columns (B4 / B5): no product column is
        made."""
        for e in exprs:
            agg_module._not_strings(self, e, "cov")
        binners = self._create_binners(binby, limits, shape)
        ndim = len(binners)
        k = len(exprs)
        off = [(i, j) for i, j in pairs if i != j]
        specs = ([([e], agg_module.VAR_TERMS) for e in exprs]
                 + [([exprs[i], exprs[j]], agg_module.COVAR_TERMS) for i, j in off])

        def shift_of(a, like):  # a base's shift as float64 cells
            if a is None:
                return 0.0
            a = a.to(device=like.device, dtype=torch.float64)
            return a.reshape(like.shape) if a.dim() == 1 else a

        def finish(results, shifts, scales):
            own = [((n.to(torch.float64),), sums) for (n,), sums in results[:k]]
            of_pair = dict(zip(off, results[k:]))
            out = []
            for i, j in pairs:
                (n_i,), (s_i, q_i) = own[i]
                scale = scales[exprs[i]], scales[exprs[j]]
                if i == j:
                    out.append(agg_module.variance(q_i, s_i, n_i) / scale[0] / scale[0])
                    continue
                (n_j,), (s_j, _) = own[j]
                (c,), (sxy, sx, sy) = of_pair[(i, j)]
                c = c.to(torch.float64)
                a_i, a_j = shift_of(shifts[exprs[i]], s_i), shift_of(shifts[exprs[j]], s_j)
                p_i, p_j, m_i, m_j = sx / c, sy / c, s_i / n_i, s_j / n_j
                entry = ((sxy - sx * sy / c) / c + p_i * p_j - m_i * m_j
                         + a_j * (p_i - m_i) + a_i * (p_j - m_j))
                out.append(entry / scale[0] / scale[1])  # the product of scales underflows
            return tuple(out)
        entries = agg_module.cell_shifted(self, binners, specs,
                                          agg_module.selection_expression(selection, self),
                                          finish)

        @delayed
        def cells(grids, at):  # an entry's float64 cells, the edges stripped
            g = array_types.to_numpy(grids[at]).astype(np.float64)
            return agg_module.extract_central(g, ndim) if ndim else g.reshape(())
        return {pair: cells(entries, at) for at, pair in enumerate(pairs)}

    def mode(self, expression, binby=(), limits=None, shape=256, mode_shape=64,
             mode_limits=None, progressbar=False, selection=None):
        """The most frequent value: the centre of the fullest of
        ``mode_shape`` bins over ``mode_limits`` (the expression's minmax by
        default), per cell of ``binby`` (vaex_tpu/dataframe.py:1101-1118):
        the limits pass, then one count grid."""
        expression = str(expression)
        agg_module._not_strings(self, expression, "mode")
        lim = self.limits(expression, mode_limits, selection=selection)
        centers = (np.linspace(lim[0], lim[1], mode_shape + 1)[:-1]
                   + (lim[1] - lim[0]) / mode_shape / 2)
        binby = _ensure_list(binby)
        counts = self.count(binby=binby + [expression],
                            limits=(self.limits(binby, limits) if binby else []) + [lim],
                            shape=[shape] * len(binby) + [mode_shape], selection=selection)
        return centers[np.argmax(np.asarray(counts), axis=-1)]

    def mutual_information(self, x, y=None, dimension=2, mi_limits=None, mi_shape=256,
                           binby=(), limits=None, shape=128, sort=False, selection=None,
                           delay=False):
        """The mutual information of x and y from their 2-D count grid of
        ``mi_shape`` bins a side over ``mi_limits`` (vaex_tpu/dataframe.py:
        1191-1222); of each of a list of pairs (ordered by it, descending,
        with ``sort``, then also the pairs), or the matrix of a list of
        expressions."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of pairs")
            if all(isinstance(e, (list, tuple)) for e in x):
                pairs = [(str(a), str(b)) for a, b in x]
                out = np.array([self.mutual_information(a, b, mi_limits=mi_limits,
                                                        mi_shape=mi_shape, selection=selection)
                                for a, b in pairs])
                if sort:
                    order = np.argsort(out)[::-1]
                    return out[order], [pairs[i] for i in order]
                return out
            exprs = [str(e) for e in x]
            return np.array([[self.mutual_information(a, b, mi_limits=mi_limits,
                                                      mi_shape=mi_shape, selection=selection)
                              for b in exprs] for a in exprs])
        x, y = str(x), str(y)
        lim = self.limits([x, y], mi_limits, selection=selection)
        counts = np.asarray(self.count(binby=[x, y], limits=lim, shape=mi_shape,
                                       selection=selection))
        pxy = counts / counts.sum()
        px = pxy.sum(axis=1, keepdims=True)
        py = pxy.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = pxy * np.log(pxy / (px * py))
        return float(np.nansum(terms))

    def healpix_count(self, expression=None, healpix_expression="source_id/34359738368",
                      healpix_max_level=12, healpix_level=8, binby=None, limits=None,
                      shape=128, **kwargs):
        """Counts per healpix pixel at ``healpix_level`` from a nested index
        at ``healpix_max_level`` (Gaia's ``source_id / 2^35``): a count
        binned over the 12 * 4^level pixels (vaex_tpu/dataframe.py:1083-1099).
        A pixel is the index's integer part floor-divided by
        4^(max_level - level), which bins exactly into [p - 0.5, p + 0.5).
        The reference bins ``index / 4^(max_level - level) + epsilon`` into
        those bins, which moves every index whose fraction is past one half
        into the next pixel (ROADMAP, known problems of the reference)."""
        nmax = 12 * 4 ** healpix_level
        scaling = 4 ** (healpix_max_level - healpix_level)
        expr = f"(astype({healpix_expression}, 'int64') // {scaling})"
        return self.count(expression, binby=[expr] + list(binby or []),
                          limits=[[-0.5, nmax - 0.5]] + list(limits or []),
                          shape=[nmax] + list(shape if isinstance(shape, (list, tuple)) else []),
                          **kwargs)

    def describe(self, strings=True, virtual=True, selection=None):
        """A pandas frame of each column's data type, count, missing count
        (NA), mean, std, min and max, the statistics of all columns in one
        pass; a datetime column has min and max but no mean or std, a
        non-numeric one only its counts (vaex_tpu/dataframe.py:1158-1189)."""
        import pandas as pd
        names = self.get_column_names(strings=strings, virtual=virtual)
        rows = {"data_type": [], "count": [], "NA": [], "mean": [], "std": [], "min": [],
                "max": []}
        types = {name: self.data_type(name) for name in names}
        numeric = [n for n in names if types[n].numpy.kind in "iuf" or types[n].numpy.kind == "M"]
        moments = [n for n in numeric if types[n].numpy.kind != "M"]
        N = len(self)
        counts = {n: self.count(n, selection=selection, delay=True) for n in names}
        means = {n: self._compute_agg("mean", n, selection=selection, delay=True,
                                      as_float=True) for n in moments}
        stds = {n: self.std(n, selection=selection, delay=True) for n in moments}
        minmaxes = {n: self.minmax(n, selection=selection, delay=True) for n in numeric}
        self.execute()
        for name in names:
            count = int(np.asarray(counts[name].get()))
            rows["data_type"].append(types[name].name)
            rows["count"].append(count)
            rows["NA"].append(N - count)
            mm = np.asarray(minmaxes[name].get()) if name in minmaxes else ("--", "--")
            rows["min"].append(mm[0])
            rows["max"].append(mm[1])
            rows["mean"].append(float(np.asarray(means[name].get())) if name in means else "--")
            rows["std"].append(float(np.asarray(stds[name].get())) if name in stds else "--")
        return pd.DataFrame(rows, index=names).T

    def propagate_uncertainties(self, columns, depending_variables=None, cov_matrix="auto",
                                covariance_format="{}_{}_covariance",
                                uncertainty_format="{}_uncertainty"):
        """First-order error propagation (vaex_tpu/dataframe.py:1120-1152):
        for each column a virtual ``<column>_uncertainty`` = sqrt(sum of
        (d column / d v)^2 * v_uncertainty^2) over the variables v it depends
        on whose uncertainty column exists; the derivatives are symbolic
        (:func:`.expresso.derivative`)."""
        from .scopes import classify_leaves
        columns = [c if isinstance(c, Expression) else self[str(c)] for c in columns]
        if depending_variables is None:
            deps = set()
            for col in columns:
                deps |= classify_leaves(self, col.expand().expression)[1]
            depending_variables = sorted(deps)
        depending_variables = [str(v) for v in depending_variables]
        for col in columns:
            expr = col.expand().expression
            terms = []
            for var in depending_variables:
                try:
                    d = expresso.derivative(expr, var)
                except ValueError:
                    continue
                sigma = uncertainty_format.format(var)
                if d.strip() == "0" or sigma not in self:
                    continue
                terms.append(f"(({d}))**2 * ({sigma})**2")
            if terms:
                self.add_virtual_column(uncertainty_format.format(str(col)),
                                        "sqrt(" + " + ".join(terms) + ")")
        return self

    # ---------------------------------------------------------------- order
    def take(self, indices, filtered=True, dropfilter=True):
        """The rows at ``indices`` (of a filtered frame: among the rows it
        keeps; with ``filtered=False`` among all its rows, and the filter
        stays) as a lazy ``take`` node: host ints (a negative one counts from
        the end) or an int tensor of entries in [0, len), which stays on its
        device; each column is read through it, tile by tile, on its own
        device (vaex_tpu/dataframe.py:1510-1514).  ``dropfilter`` changes
        nothing, as in vaex_tpu."""
        df = self.extract() if filtered else self.trim()
        if isinstance(indices, torch.Tensor):
            if indices.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"take needs int32 or int64 indices, got {indices.dtype}")
            n = df.dataset.row_count
            if indices.numel() and not 0 <= int(indices.min()) <= int(indices.max()) < n:
                raise IndexError(f"row indices out of range for {n} rows")
        return df._rebind_dataset(df.dataset.take(indices))

    def head(self, n=10):
        return self[:min(n, len(self))]

    def tail(self, n=10):
        length = len(self)
        return self[max(0, length - n):length]

    def concat(self, *others, resolver="flexible"):
        """This frame's rows, then each other's (each of a filtered frame the
        rows it keeps), over the columns all of them have; the virtual
        columns and variables are this frame's (vaex_tpu/dataframe.py:1594-1602).
        ``resolver`` changes nothing, as in vaex_tpu."""
        dfs = [df.extract() for df in (self,) + others]
        dataset = dfs[0].dataset.concat(*(df.dataset for df in dfs[1:]))
        out = dfs[0]._rebind_dataset(dataset)
        out.column_names = [n for n in out.column_names
                            if n in dataset or n in out.virtual_columns]
        out._categories = _concat_categories(dfs, dataset)
        return out

    def _index(self, expression):
        """The join index of an expression over the frame's rows, built on
        the pass device (vaex_tpu/dataframe.py:1463-1469)."""
        from .ops.setops import SortedIndex
        value = self._evaluate_tile(expression, 0, self.dataset.row_count)
        return SortedIndex(value.data, value.mask)

    def _map_index(self, expression, index, duplicates=False):
        """One pass probing ``expression`` against a join ``index``:
        (lookup, extra left rows, extra right rows), all on the pass device
        (:class:`~vaex_tpu_torch.tasks.TaskMapIndex`)."""
        task = self.executor.schedule(TaskMapIndex(self, str(expression), index, duplicates))
        self.execute()
        return task.get()

    def join(self, other, on=None, left_on=None, right_on=None, lprefix="", rprefix="",
             lsuffix="", rsuffix="", how="left", allow_duplication=False, inplace=False,
             mesh=None):
        """The rows of this frame beside the matching rows of ``other``
        (:func:`vaex_tpu_torch.join.join`); over ``mesh``, by default the
        executor's when its passes run sharded (vaex_tpu/dataframe.py:1767-1773)."""
        from .join import join
        if mesh is None:
            mesh = getattr(self.executor, "sharded", None)
        return join(self, other, on=on, left_on=left_on, right_on=right_on, lprefix=lprefix,
                    rprefix=rprefix, lsuffix=lsuffix, rsuffix=rsuffix, how=how,
                    allow_duplication=allow_duplication, inplace=inplace, mesh=mesh)

    def sort(self, by, ascending=True, kind="quicksort"):
        """The rows ordered by the key column(s) (of a filtered frame the
        rows it keeps): a stable lexicographic argsort of the keys on the
        host, then a take (vaex_tpu/dataframe.py:1523-1553).  A string key
        sorts by its rank, descending too among several keys.  ``kind``
        changes nothing, as in vaex_tpu."""
        if self.filtered:
            return self.extract().sort(by, ascending)
        by = [str(b) for b in (by if isinstance(by, (list, tuple)) else [by])]
        ascending = (list(ascending) if isinstance(ascending, (list, tuple))
                     else [ascending] * len(by))
        keys = []
        for name, asc in zip(by, ascending):
            values = self.evaluate(name)
            if array_types.is_arrow(values):  # strings by their rank, a null as ""
                data = _string_ranks(values)
                if not asc and len(by) == 1:  # the reference's order for ties: reversed
                    return self.take(np.argsort(data, kind="stable")[::-1])
            else:
                data = np.ma.getdata(values)
            if not asc:
                data = _descending(data)
            keys.append(data)
        if len(keys) == 1:
            return self.take(np.argsort(keys[0], kind="stable"))
        return self.take(np.lexsort(keys[::-1]))

    def groupby(self, by=None, agg=None, sort=False, ascending=True, assume_sparse="auto",
                row_limit=None, copy=True, progress=None, delay=False):
        """Group by one or more keys: categories, raw int keys of a narrow
        range (dense), any other numeric key (a set of its values), or, with
        ``assume_sparse`` (True, or "auto" past 1e6 combinations), several keys
        fused into one set of the observed combinations.  ``row_limit`` raises
        RowLimitException when a key's set grows past it.  With ``agg`` the
        one-sort plan (:mod:`.fused_groupby`) runs raw integer keys whose
        set the classic path would build, in one sort, and ``delay`` gives
        the result in a fulfilled promise.  ``copy=False`` groups this frame,
        not a copy; ``progress`` changes nothing, as in vaex_tpu
        (vaex_tpu/dataframe.py:1739-1755)."""
        from .groupby import GroupBy
        with tracing.span("groupby"):
            if agg is not None:
                from .fused_groupby import try_fused_sort_groupby
                result = try_fused_sort_groupby(self, by, agg, sort=sort, ascending=ascending,
                                                row_limit=row_limit, delay=delay)
                if result is not None:
                    return result
            gb = GroupBy(self, by=by, sort=sort, ascending=ascending, combine=assume_sparse,
                         row_limit=row_limit, copy=copy)
            if agg is None:
                return gb
            return gb.agg(agg, delay=delay)

    def binby(self, by=None, agg=None, limits=None, shape=128, sort=False, delay=False,
              progress=None):
        """Aggregations over the grid of ``by`` as an N-d array with the
        axes' bin centres or labels as coordinates
        (:class:`~vaex_tpu_torch.groupby.BinBy`), with ``delay`` in a
        fulfilled promise; ``progress`` changes nothing, as in vaex_tpu."""
        from .groupby import BinBy
        with tracing.span("binby"):
            bb = BinBy(self, by=by, limits=limits, shape=shape, sort=sort)
            if agg is None:
                return bb
            return bb.agg(agg, delay=delay)

    # ------------------------------------------------------------- set API
    def _set(self, expression, keep_counts=False, limit=None, limit_raise=True, delay=False):
        """The SortedSet of an expression's values over the rows the filter
        keeps, built by one pass on the pass device (with ``delay`` the
        queued task, whose promise gives it)."""
        task = TaskSetCreate(self, str(expression), keep_counts=keep_counts,
                             limit=limit if limit_raise else None)
        self.executor.schedule(task)
        if delay:
            return task
        self.execute()
        return task.get()

    def unique(self, expression, return_inverse=False, dropna=False, dropnan=False,
               dropmissing=False, progress=None, selection=None, axis=None, delay=False,
               limit=None, limit_raise=True, array_type="list"):
        """The distinct values in ascending order, then NaN, then None for a
        missing value, unless dropped; with ``return_inverse`` also each
        row's index into them.  ``progress`` and ``axis`` change nothing, as
        in vaex_tpu; with ``delay`` the values come in a fulfilled promise
        (vaex_tpu returns them as they are: ROADMAP, known problems of the
        reference)."""
        expression = str(expression)
        selection = agg_module.selection_expression(selection, self)
        df = self if selection is None else self.filter(selection)
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
            values = values, self.evaluate_ordinal(expression, oset)
        return self._delay(delay, _resolved(values))

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

    # ------------------------------------------------- dropping and filling
    def dropna(self, column_names=None, how="any"):
        """The rows where no column (of ``column_names``) is NaN or missing
        (vaex_tpu/dataframe.py:1604-1634): a filter.  The reference takes
        ``how`` and ignores it; only "any" is what it does."""
        if how != "any":
            raise NotImplementedError(f"dropna(how={how!r}): only how='any' is defined")
        return self._drop_x(column_names, lambda name: f"notna({name})")

    def dropmissing(self, column_names=None):
        """The rows where no column is missing (a masked value)."""
        return self._drop_x(column_names, lambda name: f"~ismissing({name})")

    def dropnan(self, column_names=None):
        """The rows where no float column is NaN."""
        return self._drop_x(column_names, lambda name: f"~isnan({name})", floats_only=True)

    def dropinf(self, column_names=None):
        """The rows where no float column is +-inf."""
        return self._drop_x(column_names, lambda name: f"~isinf({name})", floats_only=True)

    def _drop_x(self, column_names, keep, floats_only=False):
        """A filter of the rows where ``keep(name)`` holds for every column
        (only the float ones with ``floats_only``); a copy when none is left."""
        names = [str(n) for n in (column_names or self.get_column_names())]
        if floats_only:
            names = [n for n in names if self.data_type(n).numpy.kind == "f"]
        if not names:
            return self.copy()
        return self.filter(" & ".join(f"({keep(name)})" for name in names))

    def fillna(self, value, column_names=None, prefix="__original_", inplace=False):
        """Each column (of ``column_names``) with its NaN and missing values
        replaced by ``value``: a virtual column ``fillna(name, value)`` over
        the old one (vaex_tpu/dataframe.py:1636-1646; ``prefix`` is the
        reference's and unused there too)."""
        df = self if inplace else self.copy()
        for name in map(str, column_names or df.get_column_names()):
            if df.data_type(name).is_text:
                continue
            df.add_virtual_column(name, f"fillna({name}, {value!r})")
        return df

    # ----------------------------------------------------------- exporters
    def to_arrays(self, column_names=None, selection=None, strings=True, virtual=True,
                  parallel=True, chunk_size=None, array_type=None):
        """The values of each column (of ``column_names``) as :meth:`evaluate`
        gives them."""
        return [self.evaluate(name, selection=selection, array_type=array_type)
                for name in self._export_names(column_names, strings, virtual)]

    def _export_names(self, column_names, strings=True, virtual=True):
        names = [str(n) for n in (column_names or self.get_column_names(virtual=virtual))]
        if not strings:
            names = [n for n in names if not self.data_type(n).is_text]
        return names

    def to_dict(self, column_names=None, selection=None, strings=True, virtual=True,
                parallel=True, chunk_size=None, array_type=None):
        names = self._export_names(column_names, strings, virtual)
        return dict(zip(names, self.to_arrays(names, selection, array_type=array_type)))

    def to_items(self, column_names=None, selection=None, strings=True, virtual=True,
                 parallel=True, chunk_size=None, array_type=None):
        return list(self.to_dict(column_names, selection, strings, virtual,
                                 array_type=array_type).items())

    def to_records(self, index=None, selection=None):
        """One dict per row (or the one at ``index``) of python values."""
        names = self.get_column_names()
        rows = [dict(zip(names, row)) for row in
                zip(*self.to_arrays(names, selection=selection, array_type="python"))]
        return rows if index is None else rows[index]

    def to_pandas_df(self, column_names=None, selection=None, strings=True, virtual=True,
                     index_name=None, parallel=True, chunk_size=None, array_type=None):
        """A pandas DataFrame of the columns; a missing value is NaN (an int
        column with one turns float64) or None in an object column."""
        import pandas as pd
        data = {}
        for name, values in self.to_items(column_names, selection, strings, virtual):
            if isinstance(values, np.ma.MaskedArray):
                if values.dtype.kind in "iu":
                    values = values.astype(np.float64).filled(np.nan)
                elif values.dtype.kind == "O":
                    values = np.asarray([None if m else v for v, m in
                                         zip(values.data, np.ma.getmaskarray(values))],
                                        dtype=object)
                else:
                    values = values.filled(np.nan)
            data[name] = values
        return pd.DataFrame(data)

    def to_arrow_table(self, column_names=None, selection=None, strings=True, virtual=True,
                       parallel=True, chunk_size=None, reduce_large=False):
        """A pyarrow Table of the columns; a missing value is null."""
        import pyarrow as pa
        return pa.table({name: _converted(values, "arrow") for name, values in
                         self.to_items(column_names, selection, strings, virtual)})

    def to_copy(self, column_names=None, selection=None, strings=True, virtual=True,
                selections=True):
        """A copy of the frame: with ``selection`` a frame of host arrays of
        the rows it keeps, else one over the same columns, without its
        virtual columns unless ``virtual``, without its selections unless
        ``selections`` (vaex_tpu/dataframe.py:117-141)."""
        if selection is not None:
            from . import from_dict
            return from_dict(self.to_dict(column_names, selection, strings, virtual))
        names = column_names
        if names is None and (not strings or not virtual):
            names = self._export_names(None, strings, virtual)
        df = self.copy(column_names=names)
        if not virtual:
            df.virtual_columns = {}
            df.column_names = [n for n in df.column_names if n not in self.virtual_columns]
        if not selections:
            df.selections, df.selection_histories, df.selection_history_indices = {}, {}, {}
        return df

    def materialize(self, column=None, inplace=False):
        """Virtual columns (``column``, or all) evaluated over every row into
        real columns (vaex_tpu/dataframe.py:1710-1720), so that a pass reads
        them instead of evaluating them again.  On a frame whose columns lie
        on a device the values stay there as a tensor (with a mask tensor
        where some are missing), as ``to_device`` would leave them; a frame of
        host arrays gets host arrays."""
        df = self if inplace else self.copy()
        names = [str(column)] if column is not None else list(df.virtual_columns)
        staged = df.dataset.device is not None or any(
            placed_device(c) is not None for c in df.dataset.values())
        for name in names:
            if name not in df.virtual_columns:
                raise KeyError(f"{name!r} is not a virtual column")
            if staged:
                value = df._evaluate_tile(name, 0, df.dataset.row_count, filtered=False)
                data = value.data.contiguous()
                if isinstance(value, DictNA):  # strings: the codes over their labels
                    if value.mask is not None:
                        data = data.masked_fill(value.mask, len(value.labels))
                    values, logical = ColumnDictionary(data.to(torch.int32), value.labels), None
                else:
                    values = data if value.mask is None else ColumnMasked(data, value.mask)
                    logical = value.logical
            else:
                values, logical = df.evaluate(name, filtered=False), None
            del df.virtual_columns[name]
            df._put_column(name, values, logical)
        return df

    # -------------------------------------------------------------- export
    def export(self, path, progress=None, chunk_size=None, parallel=True, fs_options=None,
               fs=None):
        """Write the frame to ``path`` in the format its extension names
        (:mod:`.io.export`): the rows the filter keeps, virtual columns as
        their values, a chunk (a tile by default) at a time, into a
        temporary file renamed onto ``path`` at the end."""
        from .io.export import export
        export(self, path, progress=progress, chunk_size=chunk_size)

    def export_hdf5(self, path, progress=None, chunk_size=None, parallel=True, mode="w"):
        from .io.hdf5 import export_hdf5
        export_hdf5(self, path, progress=progress, chunk_size=chunk_size)

    def export_parquet(self, path, progress=None, chunk_size=None, parallel=True,
                       fs_options=None, fs=None, **kwargs):
        from .io.arrow import export_parquet
        export_parquet(self, path, chunk_size=chunk_size, **kwargs)

    def export_arrow(self, path, progress=None, chunk_size=None, parallel=True,
                     reduce_large=False, fs_options=None, fs=None):
        from .io.arrow import export_arrow
        export_arrow(self, path, chunk_size=chunk_size)

    def export_feather(self, path, parallel=True, reduce_large=False, compression="lz4",
                       chunk_size=None):
        from .io.arrow import export_feather
        export_feather(self, path, compression=compression, chunk_size=chunk_size)

    def export_csv(self, path, progress=None, chunk_size=None, parallel=True, **kwargs):
        from .io.export import export_csv
        export_csv(self, path, chunk_size=chunk_size, **kwargs)

    def export_votable(self, path, progress=None, chunk_size=None):
        from .io.votable import export_votable
        export_votable(self, path, chunk_size=chunk_size)

    def export_fits(self, path, progress=None, chunk_size=None):
        from .io.fits import export_fits
        export_fits(self, path, chunk_size=chunk_size)

    def export_many(self, path, chunk_size=None, max_rows_per_file=None, progress=None):
        """The rows split over several files, ``path`` holding a ``{i}``
        slot (``{i:03d}``...) for the file's number, ``max_rows_per_file``
        (else ``chunk_size``, else an eighth of the rows) a file
        (vaex_tpu/dataframe.py:1856-1870).  Returns the paths."""
        df = self.extract()
        n = len(df)
        per_file = int(max_rows_per_file or chunk_size or max(1, -(-n // 8)))
        paths = []
        for i, offset in enumerate(range(0, max(n, 1), per_file)):
            out = path.format(i=i)
            df[offset:min(offset + per_file, n)].export(out)
            paths.append(out)
        return paths

    def export_partitioned(self, path, by, directory_format="{key}={value}", progress=None):
        """One file per value of the column ``by`` (a hive layout:
        ``<dir of path>/<by>=<value>/<name of path>``), missing values left
        out (vaex_tpu/dataframe.py:1872-1890).  Returns the paths."""
        import os
        by = [str(b) for b in (by if isinstance(by, (list, tuple)) else [by])]
        if len(by) != 1:
            raise ValueError("export_partitioned takes one column to partition by")
        key = by[0]
        paths = []
        for value in self.unique(key, array_type="list"):
            if value is None or value != value:
                continue
            part = self.filter(f"({key} == {value!r})")
            directory = os.path.join(os.path.dirname(path) or ".",
                                     directory_format.format(key=key, value=value))
            os.makedirs(directory, exist_ok=True)
            out = os.path.join(directory, os.path.basename(path))
            part.export(out)
            paths.append(out)
        return paths

    # ------------------------------------------------------- shift, rolling
    def shift(self, periods, column=None, fill_value=None, trim=False, inplace=False):
        """The columns (``column``, or all) shifted by ``periods`` rows as
        lazy views on their device (:func:`.shift.shift`)."""
        from .shift import shift
        return shift(self, periods, column=column, fill_value=fill_value, trim=trim,
                     inplace=inplace)

    def diff(self, periods=1, column=None, fill_value=None, trim=False, inplace=False,
             reverse=False):
        """Each column minus itself shifted by ``periods`` (:func:`.shift.diff`)."""
        from .shift import diff
        return diff(self, periods=periods, column=column, fill_value=fill_value, trim=trim,
                    inplace=inplace, reverse=reverse)

    def rolling(self, window, trim=False, column=None, fill_value=None, edge="right"):
        """Window reductions (``.sum()``, ``.mean()``, ``.min()``, ``.max()``)
        over shifted views (:class:`.shift.Rolling`)."""
        from .shift import Rolling
        columns = [column] if isinstance(column, str) else column
        return Rolling(self, window, trim=trim, fill_value=fill_value, edge=edge,
                       columns=columns)

    # ----------------------------------------------------- random rows, splits
    def shuffle(self, random_state=None):
        """The rows in a random order, drawn as vaex_tpu draws it
        (``np.random.default_rng(random_state).permutation``), then a lazy take."""
        return self.take(np.random.default_rng(random_state).permutation(len(self)))

    def sample(self, n=None, frac=None, replace=False, weights=None, random_state=None):
        """``n`` rows (or ``frac`` of them; all by default) drawn on the host
        as vaex_tpu draws them (``rng.choice``, ``weights`` an expression of
        the rows' weights), so the same ``random_state`` picks the same rows
        in both packages; then a lazy take (vaex_tpu/dataframe.py:1560-1573)."""
        N = len(self)
        if n is None:
            n = int(round((frac if frac is not None else 1.0) * N))
        p = None
        if weights is not None:
            w = np.asarray(self.evaluate(str(weights)), np.float64)
            p = w / w.sum()
        rng = np.random.default_rng(random_state)
        return self.take(rng.choice(N, n, replace=replace, p=p))

    def split(self, into=None):
        """Consecutive frames: ``into`` of them of (nearly) equal length, or
        one per fraction of a list, the last taking the rest."""
        N = len(self)
        if isinstance(into, (int, np.integer)):
            sizes = [N // into + (1 if i < N % into else 0) for i in range(into)]
        else:
            sizes = [int(round(f * N)) for f in into]
            sizes[-1] = N - sum(sizes[:-1])
        starts = np.cumsum([0] + sizes).tolist()
        return [self[a:b] for a, b in zip(starts, starts[1:])]

    def split_random(self, into=None, random_state=None):
        return self.shuffle(random_state=random_state).split(into)

    # ---------------------------------------------------------- accessors
    @property
    def shape(self):
        return (len(self), len(self.get_column_names()))

    @property
    def dtypes(self):
        """Each column's dtype name, as a dict (vaex_tpu gives a pandas
        Series of the same pairs)."""
        return {name: self.data_type(name).name for name in self.get_column_names()}

    def is_masked(self, column):
        """True when the column holds a mask of missing values (a type
        check, not a scan); for a virtual column, when its expression's
        values over the first row carry one."""
        column = str(column)
        if self._is_physical(column):
            return column_is_masked(self.dataset[column])
        if not self.dataset.row_count:
            return False
        return self._evaluate_tile(column, 0, 1, filtered=False).mask is not None

    def length_original(self):
        return (self._active_range[2] if self._active_range else self.dataset).row_count

    def length_unfiltered(self):
        return self.dataset.row_count

    def count_rows(self):
        return len(self)

    # -------------------------------------------------------------- devices
    def to_device(self, device=None, column_names=None):
        """Stage columns as tensors on ``device`` (default ``settings.DEVICE``).

        Columns whose dtype has a torch tensor type move (a datetime64 or
        timedelta64 column as int64; the dataset remembers its dtype); a
        masked one as its data and its mask, two tensors
        (:class:`~vaex_tpu_torch.column.ColumnMasked`); taken, filtered and
        concatenated columns move their tensors.  A string column is
        dictionary-encoded once (vaex_tpu/dataframe.py:1650-1700): its int32
        codes go to ``device`` (:class:`~.column.ColumnDictionary`, and a
        hidden ``__<name>_codes`` tensor the category bins on), its labels
        stay on the host; it becomes a category.  The rest stays host-side,
        and the passes over it run on ``device`` too.  Torch raises when the
        device does not exist: there is no silent CPU run."""
        device = torch.device(device or settings.DEVICE)
        names = column_names or list(self.dataset)
        columns = {name: column_to(col, device) if name in names else col
                   for name, col in self.dataset.items()}
        df = self.copy()
        for name, col in list(columns.items()):
            if isinstance(col, ColumnDictionary) and not isinstance(self.dataset[name],
                                                                    ColumnDictionary):
                codes = f"__{name}_codes"
                columns[codes] = col.codes
                df._categories[name] = _string_category(col.labels, col.has_null, codes)
                if codes not in df.column_names:
                    df.column_names.append(codes)
        df.dataset = DatasetArrays(columns, self.dataset.logical, device)
        return df

    # ---------------------------------------------------------- the API tail
    def set_active_range(self, i1, i2):
        """Work on rows [i1, i2) of the whole dataset only, in place
        (vaex_tpu/dataframe.py:425-433): every pass, ``len`` and ``evaluate``
        see those rows; ``length_original`` counts all."""
        full = self._active_range[2] if self._active_range else self.dataset
        self.dataset = full.slice(i1, i2)
        self._active_range = (int(i1), int(i2), full)
        self._filtered_length = None

    def set_active_fraction(self, fraction):
        self.set_active_range(0, int(fraction * self.length_original()))

    def _active_bounds(self):
        """[start, stop) of the active range in the whole dataset."""
        if self._active_range:
            return self._active_range[:2]
        return 0, self.dataset.row_count

    @property
    def columns(self):
        """The dataset: a mapping of the physical columns."""
        return self.dataset

    @property
    def col(self):
        """``df.col.x`` is ``df["x"]``."""
        return _Columns(self)

    def unit(self, expression):
        return self.units.get(str(expression))

    def __iter__(self):
        return iter(self.get_column_names())

    def close(self):
        self.dataset.close()

    def __repr__(self):
        from .formatting import format_dataframe
        return format_dataframe(self)

    def _repr_html_(self):
        return "<pre>" + self.__repr__() + "</pre>"

    # ----------------------------------------------------- state, pickling
    def state_get(self, skip=None):
        """The frame's state (:mod:`.encoding`), vaex_tpu's format."""
        from .encoding import state_get
        return state_get(self)

    def state_set(self, state, use_active_range=False, keep_columns=None, set_filter=True,
                  trusted=True, warn=True):
        from .encoding import state_set
        return state_set(self, state, set_filter=set_filter, trusted=trusted)

    def state_write(self, file, fs_options=None, fs=None):
        import json
        with open(file, "w") as f:
            json.dump(self.state_get(), f)

    def state_load(self, file, use_active_range=False, keep_columns=None, set_filter=True,
                   trusted=True, fs_options=None, fs=None):
        import json
        with open(file) as f:
            return self.state_set(json.load(f), set_filter=set_filter, trusted=trusted)

    def __reduce__(self):
        """A pickle of the columns as host arrays and the state; the frame
        comes back staged to the kind of device it was staged to (a "cuda"
        frame to ``settings.DEVICE``), or unstaged (vaex_tpu/dataframe.py:
        1922-1932).  A staged string column's codes come back with it."""
        full = self._active_range[2] if self._active_range else self.dataset
        codes = {m.get("codes_column") for m in self._categories.values()}
        columns = {name: _host_column(full, name) for name in full
                   if not (name in codes and isinstance(full[name], torch.Tensor))}
        device = None if full.device is None else full.device.type
        return _unpickle, (columns, dict(full.logical), device, self.state_get())

    # ------------------------------------------------------------- UDFs
    def add_function(self, name, f, vectorize=True, unique=False, multiprocessing=False):
        """Name a Python function in this frame's expressions
        (vaex_tpu/dataframe.py:304-327): it runs on the host over host
        arrays, so an expression that calls it is evaluated in the host
        stage of a pass and its result copied to the pass device; with
        ``vectorize`` it takes whole arrays, else one row at a time; with
        ``multiprocessing`` the rows are split over a pool of processes
        (:func:`.multiprocessing.apply_parallel`).  Returns the name."""
        from .utils import identity
        if unique:
            name = f"__fn_{name}_{identity(f)}"
        name = find_valid_name(name)
        self.functions[name] = f

        def host_impl(*args, _f=f, _vectorize=vectorize, _mp=multiprocessing):
            datas = [a if np.isscalar(a) else array_types.to_numpy(a) for a in args]
            if _mp:
                from .multiprocessing import apply_parallel
                return apply_parallel(_f, datas, vectorize=_vectorize)
            if _vectorize:
                return np.asarray(_f(*datas))
            return np.asarray([_f(*row) for row in zip(*datas)])
        self._function_impls[name] = host_impl
        self._dtypes = {}
        return name

    def apply(self, f, arguments=None, vectorize=True, multiprocessing=False):
        """An expression of ``f`` over ``arguments`` (expressions), a
        Python function on the host (:meth:`add_function`;
        vaex_tpu/dataframe.py:1153-1158)."""
        arguments = [str(a) for a in (arguments or [])]
        name = self.add_function(getattr(f, "__name__", "lambda"), f, vectorize=vectorize,
                                 unique=True, multiprocessing=multiprocessing)
        return Expression(self, f"{name}({', '.join(arguments)})")

    def map_reduce(self, map_fn, reduce_fn, expressions, delay=False, name="map reduce",
                   info=False, to_numpy=True, ignore_filter=False, pre_filter=False,
                   selection=None, progress=None):
        """``reduce_fn`` over ``map_fn`` of each tile's values of
        ``expressions`` as host arrays (with ``info`` ``map_fn(i1, i2,
        *values)``; with ``pre_filter`` only the rows the filter keeps):
        one pass (vaex_tpu/dataframe.py:1455-1461)."""
        task = TaskMapReduce(self, [str(e) for e in expressions], map_fn, reduce_fn, name=name,
                             pre_filter=pre_filter and self.filtered, info=info)
        self.executor.schedule(task)
        return self._delay(delay, task, progress)


_df_accessors = {}  # name -> the class of ``df.<name>``


def register_dataframe_accessor(name, cls=None):
    """Make ``cls(df)`` reachable as ``df.<name>`` (vaex_tpu/dataframe.py:2003)"""
    def wrapper(cls):
        _df_accessors[name] = cls
        return cls
    return wrapper(cls) if cls is not None else wrapper


def _concat_categories(dfs, dataset):
    """The categories of a concatenation of ``dfs`` over ``dataset``: a
    string column staged in every frame keeps one category over the merged
    dictionary of its labels, its codes column the merged codes; another
    category stays where every frame has it alike (integer labels may
    grow: one frame's labels the start of the next's, at one ``min_value``),
    and is dropped otherwise, so that the key is read from its values."""
    out = {}
    for name, meta in dfs[0]._categories.items():
        if "column" in meta:  # derived from a dictionary column: derived again
            continue
        metas = [df._categories.get(name) for df in dfs]
        codes = meta.get("codes_column")
        if any(m is None for m in metas):
            continue
        if codes is not None and isinstance(dataset.get(name), ColumnDictionary) and all(
                m.get("codes_column") == codes and df._is_physical(codes)
                for df, m in zip(dfs, metas)):
            col = dataset[name]
            dataset._columns[codes] = col.codes
            out[name] = _string_category(col.labels, col.has_null, codes)
            continue
        if any(m.get("codes_column") != codes or m["min_value"] != meta["min_value"]
               for m in metas):
            continue
        longest = max(metas, key=lambda m: m["N"])
        labels = list(longest["labels"])
        if all(list(m["labels"]) == labels[:m["N"]] for m in metas):
            out[name] = dict(longest)
    return out


class _Columns:
    def __init__(self, df):
        self._df = df

    def __getattr__(self, name):
        return self._df[name]


def _host_column(dataset, name):
    """A column as host values for a pickle: a tensor or a lazy column as a
    numpy (masked) array of its logical dtype, staged strings as an arrow
    dictionary array, host arrays as they are."""
    col = dataset[name]
    if isinstance(col, (np.ndarray, ColumnString, ColumnVirtualConstant)):
        return col.array if isinstance(col, ColumnString) else col
    if isinstance(col, ColumnDictionary):
        return col[:]
    part = tile_of(col, 0, dataset.row_count)
    data = host_values(array_types.to_numpy(part.data), dataset.logical.get(name))
    return data if part.mask is None else np.ma.MaskedArray(data, array_types.to_numpy(part.mask))


def _unpickle(columns, logical, device, state):
    """The frame ``DataFrame.__reduce__`` pickled: staged again to a device
    of its kind ("cuda": ``settings.DEVICE``), then its state."""
    df = DataFrame(DatasetArrays(columns, logical))
    if device is not None:
        df = df.to_device(settings.DEVICE if device == "cuda" else device)
    return df.state_set(state)


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


def _string_ranks(values):
    """The dense rank of each string among the distinct ones (code-point
    order), a null ranked as "" (vaex_tpu/dataframe.py:1534-1535)."""
    import pyarrow.compute as pc
    values = array_types.string_arrow(values)
    if hasattr(values, "dictionary"):
        values = values.dictionary_decode()
    return np.asarray(pc.rank(values.fill_null(""), tiebreaker="dense")).astype(np.int64)


def _descending(data):
    """A key whose ascending order is the descending order of ``data``."""
    if data.dtype.kind == "i":
        return ~data  # -x - 1: exact, where -x overflows at the minimum
    if data.dtype.kind == "u":
        return np.iinfo(data.dtype).max - data
    if data.dtype.kind == "b":
        return ~data
    return -data.astype(np.float64)


def _string_category(labels, has_null, codes_column):
    """The category metadata of strings held as codes into ``labels`` (an
    arrow array; the null rows the code after the last): the labels also as
    arrow (``"arrow"``), the null label last, so that a groupby reads them
    without a pass over Python strings."""
    import pyarrow as pa
    arrow = labels.cast(pa.string())
    if has_null:
        arrow = pa.concat_arrays([arrow, pa.nulls(1, pa.string())])
    return {"labels": _labels_array(arrow.to_pylist()), "N": len(arrow), "min_value": 0,
            "codes_column": codes_column, "arrow": arrow}


def _labels_array(labels):
    """Category labels as an array: an object array for strings."""
    if any(isinstance(v, str) for v in labels):
        out = np.empty(len(labels), dtype=object)
        out[:] = list(labels)
        return out
    return np.asarray(labels)


def _dictionary_type(labels):
    import pyarrow as pa
    return pa.dictionary(pa.int32(), labels.type)


def _host_dtype(value):
    """The DataType of a host-stage result: arrow's type for strings and
    other arrow values, numpy's dtype else."""
    if array_types.is_arrow(value) and (array_types.is_string_array(value) or (
            value.type.num_fields if hasattr(value.type, "num_fields") else 0)):
        return value.type
    return array_types.to_numpy(value).dtype if array_types.is_arrow(value) else value.dtype


def _decode(value):
    """A DictNA as a host ``pyarrow.DictionaryArray`` (its codes copied)."""
    import pyarrow as pa
    codes = array_types.to_numpy(value.data).astype(np.int32, copy=False)
    mask = None if value.mask is None else array_types.to_numpy(value.mask)
    indices = pa.array(np.where(mask, 0, codes) if mask is not None else codes,
                       mask=mask if mask is not None and mask.any() else None, type=pa.int32())
    return pa.DictionaryArray.from_arrays(indices, value.labels)


def _converted(values, array_type):
    """A host (masked) array as ``array_type`` asks: as it is (None,
    "numpy"), a list of python values ("list", "python"; None where missing)
    or a pyarrow array ("arrow"; null where missing)."""
    if array_type in (None, "numpy"):
        return values
    if array_type in ("list", "python"):
        return values.tolist(None) if isinstance(values, np.ma.MaskedArray) else values.tolist()
    if array_type == "arrow":
        import pyarrow as pa
        if isinstance(values, np.ma.MaskedArray):
            return pa.array(values.data, mask=np.ma.getmaskarray(values))
        return pa.array(values)
    raise ValueError(f"array_type must be None, 'numpy', 'list', 'python' or 'arrow', "
                     f"got {array_type!r}")

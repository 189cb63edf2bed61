"""GroupBy over categorical and raw numeric keys.

The port of the multi-pass plan of ``vaex_tpu/groupby.py``:

* a category key bins with its metadata and needs no pre-pass
  (:class:`GrouperCategory`); it keeps every category, empty ones included;
* a raw integer key without missing values whose range is at most
  ``DENSE_RANGE_MAX`` bins on its values over [lo, hi]
  (:class:`GrouperDense`): one fused min + max + count pre-pass over all
  such keys, remembered per frame, and the cells no row has are dropped
  with a ``count("*")`` grid;
* any other numeric key builds the :class:`~.ops.setops.SortedSet` of its
  values in one pass (:class:`Grouper`) and bins on
  ``_ordinal_values(key, set)``, the probe of kernel B6.  Ordinals are
  positions in sorted order, so ``sort=True`` is the natural order: the keys
  ascending, then the NaN group, then the missing one;
* several keys take the cartesian grid of their bins and drop the
  combinations no row has while the product of the cardinalities is at most
  ``COMBINE_MIN_PRODUCT``; past it (or with ``combine=True``) they fuse into
  one int64 key whose set holds the observed combinations
  (:class:`GrouperCombined`).

One aggregation pass fills the grids and ``_assemble`` builds the result
frame.  :class:`BinBy` (``df.binby``) keeps the grid instead: category axes
and continuous ones binned over limits, returned as an N-d array with
coordinates.  :class:`BinnerTime` groups a datetime key by calendar periods.
String keys are not ported yet (ROADMAP queue A6).
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch

from . import agg as agg_module
from .agg import AggregatorDescriptor
from .expression import Expression
from . import array_types
from .dataset import DatasetArrays
from .ops.binners import BinnerOrdinal, BinnerScalar
from .ops.setops import RowLimitException  # noqa: F401  (vaex_tpu exports it here too)
from .utils import fingerprint, trace

# vaex_tpu/groupby.py:_should_combine: several keys whose cardinalities
# multiply past this take GrouperCombined instead of the cartesian grid
COMBINE_MIN_PRODUCT = 1_000_000
# a raw integer key bins on its values while its range is at most this
DENSE_RANGE_MAX = 1 << 22
# the most facts remembered on one dataset node before they are dropped
REMEMBERED_MAX = 256


def _descending(grouper):
    """Reverse a grouper whose bins are in ascending order."""
    grouper.sort_indices = np.arange(grouper.N)[::-1]
    grouper.bin_values = grouper.bin_values[::-1]


class GrouperCategory:
    """Zero-pass grouper using category metadata."""

    dense = False

    def __init__(self, expression, df, sort=False, ascending=True):
        self.df = df
        self.expression = str(expression)
        self.N = df.category_count(self.expression)
        self.min_value = df.category_offset(self.expression)
        self.bin_values = df.category_labels(self.expression, aslist=False)
        self.bin_values_raw = self.bin_values  # in code order, as the grid
        self.ordinal_expression = (f"(astype({self.expression}, 'int64') - {self.min_value})"
                                   if self.min_value else f"astype({self.expression}, 'int64')")
        self.binner = BinnerOrdinal(self.expression, self.min_value, self.N)
        self.sort_indices = None
        if sort:
            order = np.argsort(self.bin_values, kind="stable")
            if not ascending:
                order = order[::-1]
            if not np.array_equal(order, np.arange(self.N)):
                self.sort_indices = order
                self.bin_values = self.bin_values[order]


class Grouper:
    """One key through the set of its values: a set-build pass, then the
    ordinal of each row's value as the bin."""

    dense = False

    def __init__(self, expression, df, sort=False, ascending=True, row_limit=None):
        self.df = df
        self.expression = str(expression)
        self.set = df._set(self.expression, limit=row_limit)
        self.bin_values = self.set.key_array(masked=True)
        self.bin_values_raw = self.bin_values
        self.N = self.set.count
        var = df.add_variable("grouper_set", self.set, unique=True)
        self.ordinal_expression = f"_ordinal_values({self.expression}, {var})"
        self.binner = BinnerOrdinal(self.ordinal_expression, 0, self.N)
        self.sort_indices = None
        if sort and not ascending:
            _descending(self)


class GrouperDense:
    """A raw integer key whose bins are its values over [lo, hi].  Only valid
    for a key without missing values (the caller checks); the cells no row
    has are dropped at assembly with the count grid."""

    dense = True

    def __init__(self, expression, df, lo, hi, sort=False, ascending=True):
        self.df = df
        self.expression = str(expression)
        self.lo = int(lo)
        self.N = int(hi) - self.lo + 1
        self.bin_values = np.arange(self.lo, int(hi) + 1, dtype=np.int64)
        self.bin_values_raw = self.bin_values
        self.ordinal_expression = (f"(astype({self.expression}, 'int64') - {self.lo})"
                                   if self.lo else f"astype({self.expression}, 'int64')")
        self.binner = BinnerOrdinal(self.expression, self.lo, self.N)
        self.sort_indices = None
        if sort and not ascending:
            _descending(self)


class GrouperCombined:
    """Several groupers fused into one int64 key, ``sum(ordinal_i *
    multiplier_i)``, whose set holds exactly the observed combinations; the
    fused keys are split back into each grouper's bin values on the set's
    device."""

    dense = False

    def __init__(self, groupers, df, row_limit=None):
        self.df = df
        self.groupers = groupers
        if np.prod([max(g.N, 1) for g in groupers], dtype=np.float64) >= 2 ** 62:
            raise ValueError("groupby key cardinality product overflows int64; use fewer or "
                             "lower-cardinality keys")
        multipliers = [1] * len(groupers)
        for i in range(len(groupers) - 2, -1, -1):
            multipliers[i] = multipliers[i + 1] * max(groupers[i + 1].N, 1)
        parts = [f"astype({g.ordinal_expression}, 'int64') * {m}" if m != 1
                 else f"astype({g.ordinal_expression}, 'int64')"
                 for g, m in zip(groupers, multipliers)]
        self.expression = " + ".join(f"({p})" for p in parts)
        # in the set-build pass, count the rows outside each dense member's
        # range: they would fuse into another combination's key
        outside = [df.count(selection=f"(({g.expression}) < {g.lo}) | "
                                      f"(({g.expression}) > {g.lo + g.N - 1})", delay=True)
                   for g in groupers if g.dense]
        with trace("grouper-combined set build"):
            self.set = df._set(self.expression, limit=row_limit)
        if any(int(count.get()) for count in outside):
            raise StaleRange(self.expression)
        self.N = self.set.n_keys
        var = df.add_variable("grouper_set", self.set, unique=True)
        self.ordinal_expression = f"_ordinal_values({self.expression}, {var})"
        self.binner = BinnerOrdinal(self.ordinal_expression, 0, self.N)
        self.sort_indices = None
        with trace("grouper-combined decode"):
            self.bin_values_per_key = self._decode(multipliers)

    def _decode(self, multipliers):
        """Per grouper the bin value of every fused key: one floor-divide
        per key on the device; a dense grouper adds its offset, a numeric
        label table is gathered on the device, any other on the host."""
        rem = self.set.device_keys(self.set.device).to(torch.int64)
        out = []
        for g, m in zip(self.groupers, multipliers):
            ordinals = rem // m if m != 1 else rem
            if m != 1:
                rem = rem - ordinals * m
            values = g.bin_values_raw
            if g.dense:
                out.append(ordinals + g.lo)
            elif isinstance(values, np.ma.MaskedArray) or values.dtype.kind not in "biuf":
                out.append(values[ordinals.cpu().numpy()])
            else:
                out.append(torch.as_tensor(values).to(ordinals.device)[ordinals])
        return out


class BinnerTime:
    """A datetime key grouped by periods of ``every`` x ``resolution`` ("W",
    "D", "h", "m", "s", "M" or "Y"), counted from the period of the earliest
    value; every period up to the latest is a group, rows or not
    (vaex_tpu/groupby.py:298-357).  The period of each row is computed once
    on the host with numpy's datetime arithmetic and rides the passes as a
    hidden int64 column on the frame's device; NaT and missing rows fall
    outside every period."""

    dense = False

    def __init__(self, expression, resolution="W", df=None, every=1):
        if isinstance(expression, Expression):
            df = df or expression.df
            expression = expression.expression
        self.df = df
        self.expression = str(expression)
        self.resolution = resolution
        self.every = every
        self.sort_indices = None
        data, mask = array_types.data_and_mask(df.evaluate(self.expression))
        missing = np.isnat(data) if mask is None else np.isnat(data) | mask
        unit = f"M8[{resolution}]"
        periods = data.astype(unit).view("i8")
        start = data[~missing].min().astype(unit) if not missing.all() else np.datetime64(0, resolution)
        codes = (periods - start.view("i8")) // every
        codes[missing] = -1
        self.N = int(codes.max()) + 1 if not missing.all() else 0
        self.bin_values = start + np.arange(self.N) * np.timedelta64(every, resolution)
        self.bin_values_raw = self.bin_values
        self.codes = codes.astype(np.int64)
        # the name must be the same in every process: a content fingerprint
        self.column = f"__btime_{fingerprint(self.expression, resolution, every)[:16]}"
        self.ordinal_expression = self.column
        self.binner = BinnerOrdinal(self.column, 0, self.N)

    def bind(self, df):
        """Add the period column to ``df`` (a GroupBy's own copy), on the
        device of its tensor columns."""
        if self.column in df.dataset:
            return
        device = next((c.device for c in df.dataset.values() if isinstance(c, torch.Tensor)),
                      None)
        codes = self.codes if device is None else torch.as_tensor(self.codes).to(device)
        df.dataset = DatasetArrays({**dict(df.dataset.items()), self.column: codes},
                                   df.dataset.logical, df.dataset.device)
        df.column_names = df.column_names + [self.column]

    @classmethod
    def per_week(cls, expression, df=None):
        return cls(expression, "W", df)

    @classmethod
    def per_day(cls, expression, df=None):
        return cls(expression, "D", df)

    @classmethod
    def per_month(cls, expression, df=None):
        return cls(expression, "M", df)

    @classmethod
    def per_year(cls, expression, df=None):
        return cls(expression, "Y", df)


def _frame_key(df):
    """What, beside the dataset node itself, decides the rows a pass over
    ``df`` sees."""
    return (df._filter, fingerprint(df.variables) if df.variables else None)


def _sampled_range_too_wide(df, name):
    """True when about 4000 rows of an unfiltered frame's column already
    span more than DENSE_RANGE_MAX: the whole column then does too, and the
    key needs no pre-pass to be sent to the set grouper."""
    if df.filtered or name not in df.dataset:
        return False
    col = df.dataset[name]
    if isinstance(col, np.ma.MaskedArray) or len(col) == 0:
        return False
    sample = col[::max(1, len(col) // 4096)]
    return int(sample.max()) - int(sample.min()) + 1 > DENSE_RANGE_MAX


def _dense_candidates(names, df, row_limit):
    """One fused min + max + count pass over all raw integer keys: {name:
    (lo, hi, n_valid)}.  The same pass counts the rows of a filtered frame.
    Both are remembered on the dataset node per filter and variables, so
    that repeated groupbys over one table skip the pre-pass; the aggregation
    checks a remembered range against the rows it bins (:func:`_forget`)."""
    if row_limit is not None:  # a row limit needs the exact number of groups
        return {}
    memo = df.dataset.remembered
    if len(memo) > REMEMBERED_MAX:
        memo.clear()
    frame = _frame_key(df)
    out, pending = {}, {}
    for name in names:
        key = ("dense", frame, name)
        if key not in memo:
            dtype = df.data_type(name).numpy
            if (dtype.kind in "iu" and dtype != np.uint64
                    and not _sampled_range_too_wide(df, name)):
                pending[name] = (df.minmax(name, delay=True), df.count(name, delay=True))
                continue
            memo[key] = None
        if memo[key] is not None:
            out[name] = memo[key]
    length = None
    if df.filtered and df._filtered_length is None:
        if ("length", frame) in memo:
            df._filtered_length = memo[("length", frame)]
        else:
            length = df.count(delay=True)
    if not pending and length is None:
        return out
    df.execute()
    if length is not None:
        df._filtered_length = memo[("length", frame)] = int(length.get())
    for name, (minmax, count) in pending.items():
        n_valid = int(count.get())
        lo, hi = (int(v) for v in minmax.get()) if n_valid else (0, -1)
        out[name] = memo[("dense", frame, name)] = (lo, hi, n_valid)
    return out


def _forget(df):
    """Drop what is remembered of ``df``'s rows: a pass found rows outside a
    remembered range, so a column changed in place since it was measured."""
    df.dataset.remembered.clear()
    df._filtered_length = None


class StaleRange(Exception):
    """Rows lie outside the range a dense grouper was built on."""


def _make_grouper(name, df, sort, ascending, row_limit, dense_info):
    if isinstance(name, BinnerTime):
        name.bind(df)
        return name
    if df.is_category(name):
        return GrouperCategory(name, df, sort=sort, ascending=ascending)
    info = dense_info.get(name)
    if info is not None:
        lo, hi, n_valid = info
        if 0 < hi - lo + 1 <= DENSE_RANGE_MAX and n_valid == len(df):
            return GrouperDense(name, df, lo, hi, sort=sort, ascending=ascending)
    return Grouper(name, df, sort=sort, ascending=ascending, row_limit=row_limit)


def _should_combine(groupers, combine):
    if combine is True or combine is False:
        return combine
    product = 1.0
    for g in groupers:
        product *= max(g.N, 1)
    return product > COMBINE_MIN_PRODUCT


class GroupBy:
    """df.groupby over one or more keys."""

    def __init__(self, df, by, sort=False, ascending=True, combine="auto", row_limit=None):
        self.df = df.copy()
        self.sort = sort
        by = list(by) if isinstance(by, (list, tuple)) else [by]
        # a key is a name, an Expression or a BinnerTime made beforehand
        self.by_keys = [b if isinstance(b, BinnerTime) else
                        b.expression if isinstance(b, Expression) else str(b) for b in by]
        self.by_names = [b.expression if isinstance(b, BinnerTime) else b for b in self.by_keys]
        self.ascending = (list(ascending) if isinstance(ascending, (list, tuple))
                          else [ascending] * len(by))
        self.combine = combine
        self.row_limit = row_limit
        try:
            self._plan()
        except StaleRange:
            _forget(self.df)
            self._plan()

    def _plan(self):
        """The groupers and binners, from what is remembered of the keys'
        ranges or from a fresh pre-pass."""
        raw = [key for key in self.by_keys
               if not isinstance(key, BinnerTime) and not self.df.is_category(key)]
        with trace("dense-candidates pre-pass"):
            dense_info = _dense_candidates(raw, self.df, self.row_limit)
        self.groupers = [_make_grouper(key, self.df, self.sort, asc, self.row_limit, dense_info)
                         for key, asc in zip(self.by_keys, self.ascending)]
        self.combined = None
        self.by = self.groupers
        if len(self.groupers) > 1 and _should_combine(self.groupers, self.combine):
            self.combined = GrouperCombined(self.groupers, self.df, row_limit=self.row_limit)
            self.by = [self.combined]
        self.binners = tuple(g.binner for g in self.by)

    def _parse_actions(self, actions):
        """(output name, descriptor) pairs, named as vaex_tpu names them."""
        out = []
        if isinstance(actions, collections.abc.Mapping):
            items = list(actions.items())
        elif isinstance(actions, (list, tuple)):
            items = [(None, a) for a in actions]
        else:
            items = [(None, actions)]
        for name, spec in items:
            multiple = isinstance(spec, (list, tuple))
            for s in (spec if multiple else [spec]):
                if isinstance(s, str) and s == "count":
                    out.append((name or "count", agg_module.count("*")))
                    continue
                if isinstance(s, str):
                    if s not in agg_module.aggregates:
                        raise NotImplementedError(
                            f"aggregator {s!r} is {agg_module.PENDING}")
                    s = agg_module.aggregates[s]
                if isinstance(s, AggregatorDescriptor):
                    if name is None or multiple:
                        out.append((s.pretty_name(name if multiple else None), s))
                    else:
                        out.append((name, s))
                elif callable(s):
                    columns = ([name] if name is not None else
                               [c for c in self.df.get_column_names()
                                if c not in self.by_names and not c.startswith("__")])
                    for column in columns:
                        desc = s(column)
                        out.append((desc.pretty_name() if (multiple or name is None)
                                    else name, desc))
                else:
                    raise NotImplementedError(f"aggregator {s!r} is {agg_module.PENDING}")
        return out

    def agg(self, actions):
        try:
            return self._agg(actions)
        except StaleRange:
            _forget(self.df)
            self._plan()
            return self._agg(actions)

    def _agg(self, actions):
        parsed = self._parse_actions(actions)
        ndim = len(self.binners)
        promises = []
        for name, desc in parsed:
            [p] = desc.add_tasks(self.df, self.binners)
            promises.append((name, desc, p))
        # the count grid tells which cells some row has.  A combined
        # grouper's cells are the observed combinations and a set grouper's
        # bins the observed keys, so neither needs it
        counts = None
        if (self.combined is None and ndim > 1) or any(g.dense for g in self.by):
            counts = next((p for _, desc, p in promises if _is_count_star(desc)), None)
            if counts is None:
                [counts] = agg_module.count("*").add_tasks(self.df, self.binners)
        with trace("groupby agg pass (execute)"):
            self.df.execute()
        grids = {name: agg_module.extract_central(p.get(), ndim) for name, _, p in promises}
        self._logical = {name: desc.logical_dtype(self.df) for name, desc, _ in promises}
        if counts is not None:
            counts = counts.get()
            # a row in an edge cell of a dense grouper's axis lies outside
            # the range the grouper was built on
            for axis, g in enumerate(self.by):
                if g.dense:
                    edges = torch.tensor([0, 1, g.N + 2], device=counts.device)
                    if int(counts.index_select(axis, edges).sum()):
                        raise StaleRange(g.expression)
            counts = agg_module.extract_central(counts, ndim)
        with trace("groupby assemble"):
            if self.combined is not None:
                return self._assemble_combined(grids)
            if ndim == 1:
                return self._assemble_one(grids, counts)
            return self._assemble_cartesian(grids, counts)

    def _assemble_one(self, grids, counts):
        """One key: its bins in order; of a dense grouper the bins some row
        has, compacted by a gather on the grids' device."""
        g = self.groupers[0]
        keys, order = g.bin_values, None
        if g.dense:
            order = torch.nonzero(counts > 0).squeeze(1)
            if g.sort_indices is not None:
                order = order.flip(0)
            keys = order + g.lo
        elif g.sort_indices is not None:
            order = torch.as_tensor(np.ascontiguousarray(g.sort_indices))
        columns = {self.by_names[0]: keys}
        for name, grid in grids.items():
            columns[name] = grid if order is None else grid[order.to(grid.device)]
        return self._frame(columns, grids)

    def _assemble_cartesian(self, grids, counts):
        """The observed cells of the cartesian grid, in row-major order of the
        bins, then sorted by the keys when ``sort``
        (vaex_tpu/groupby.py:963-982).  Unlike vaex_tpu, which sorts them
        ascending whatever ``ascending`` says, each key sorts in its own
        direction."""
        keep = torch.nonzero(counts.reshape(-1) > 0).squeeze(1)
        cells = np.unravel_index(keep.cpu().numpy(), tuple(counts.shape))
        columns = {name: g.bin_values_raw[codes]
                   for name, g, codes in zip(self.by_names, self.groupers, cells)}
        for name, grid in grids.items():
            columns[name] = grid.reshape(-1)[keep.to(grid.device)]
        return self._sorted(self._frame(columns, grids))

    def _assemble_combined(self, grids):
        """The cells of a combined grouper are the observed combinations."""
        columns = dict(zip(self.by_names, self.combined.bin_values_per_key))
        columns.update(grids)
        return self._sorted(self._frame(columns, grids))

    def _frame(self, columns, grids):
        """The result frame; it keeps the device of the pass that made
        ``grids``, so that a query on it runs there too."""
        from . import from_dict
        df = from_dict(self._viewed(columns))
        df.dataset.device = next((g.device for g in grids.values()
                                  if isinstance(g, torch.Tensor)), None)
        return df

    def _viewed(self, columns):
        """The result columns, a datetime or timedelta min / max / first back
        in its dtype on the host."""
        for name, dtype in self._logical.items():
            if dtype is not None:
                columns[name] = agg_module.view_logical(array_types.to_numpy(columns[name]),
                                                        dtype)
        return columns

    def _sorted(self, df):
        return df.sort(self.by_names, ascending=self.ascending) if self.sort else df


def _is_count_star(desc):
    return desc.name == "count" and desc.expression in (None, "*") and desc.selection is None


class BinBy(GroupBy):
    """``df.binby``: the aggregations over the whole grid of ``by``, empty
    cells included, as an N-d array (vaex_tpu/groupby.py:1021-1073).  A
    category axis has its labels as coordinates, a continuous one the centres
    of its ``shape`` bins over ``limits`` (as :meth:`DataFrame.limits` reads
    them).  ``agg`` returns an ``xarray.DataArray`` (one aggregation) or
    ``Dataset`` (several) when xarray is installed, else a
    :class:`BinnedArray` or a dict of them."""

    def __init__(self, df, by, limits=None, shape=128, sort=False):
        self.df = df.copy()
        self.sort = sort
        by = list(by) if isinstance(by, (list, tuple)) else [by]
        self.by_names = [b.expression if isinstance(b, Expression) else str(b) for b in by]
        self.binners = self.df._create_binners(self.by_names, limits, shape)
        self.coords = []
        for name, binner in zip(self.by_names, self.binners):
            if isinstance(binner, BinnerScalar):
                width = (binner.vmax - binner.vmin) / binner.bins
                self.coords.append(np.linspace(binner.vmin, binner.vmax, binner.bins + 1)[:-1]
                                   + width / 2)
            else:
                self.coords.append(np.asarray(self.df.category_labels(name, aslist=False)))

    def agg(self, actions):
        parsed = self._parse_actions(actions)
        promises = [(name, desc, desc.add_tasks(self.df, self.binners)[0])
                    for name, desc in parsed]
        self.df.execute()
        ndim = len(self.binners)
        arrays = {}
        for name, desc, p in promises:
            grid = agg_module.view_logical(array_types.to_numpy(p.get()),
                                           desc.logical_dtype(self.df))
            arrays[name] = agg_module.extract_central(grid, ndim)
        return _to_xarray(arrays, self.by_names, self.coords)


def _to_xarray(arrays, dims, coords):
    try:
        import xarray
    except ImportError:
        if len(arrays) == 1:
            [grid] = arrays.values()
            return BinnedArray(grid, dims, coords)
        return {name: BinnedArray(grid, dims, coords) for name, grid in arrays.items()}
    if len(arrays) == 1:
        [grid] = arrays.values()
        return xarray.DataArray(grid, dims=dims, coords=dict(zip(dims, coords)))
    return xarray.Dataset({name: (dims, grid) for name, grid in arrays.items()},
                          coords=dict(zip(dims, coords)))


class BinnedArray:
    """The least of ``xarray.DataArray`` a binby result needs: ``values``,
    ``dims`` and ``coords``."""

    def __init__(self, values, dims, coords):
        self.values = values
        self.dims = tuple(dims)
        self.coords = dict(zip(dims, coords))

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, item):
        return self.values[item]

    @property
    def shape(self):
        return self.values.shape

    def __repr__(self):
        return f"BinnedArray(dims={self.dims}, shape={self.values.shape})"

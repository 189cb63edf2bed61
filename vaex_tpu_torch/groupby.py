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
frame.  String keys, ``BinnerTime`` and BinBy are not ported yet (ROADMAP
queue A6).
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch

from . import agg as agg_module
from .agg import AggregatorDescriptor
from .expression import Expression
from .ops.binners import BinnerOrdinal
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
        self.by_names = [b.expression if isinstance(b, Expression) else str(b) for b in by]
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
        raw = [name for name in self.by_names if not self.df.is_category(name)]
        with trace("dense-candidates pre-pass"):
            dense_info = _dense_candidates(raw, self.df, self.row_limit)
        self.groupers = [_make_grouper(name, self.df, self.sort, asc, self.row_limit, dense_info)
                         for name, asc in zip(self.by_names, self.ascending)]
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
        from . import from_dict
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
        return from_dict(columns)

    def _assemble_cartesian(self, grids, counts):
        """The observed cells of the cartesian grid, in row-major order of the
        bins, then sorted by the keys when ``sort``
        (vaex_tpu/groupby.py:963-982).  Unlike vaex_tpu, which sorts them
        ascending whatever ``ascending`` says, each key sorts in its own
        direction."""
        from . import from_dict
        keep = torch.nonzero(counts.reshape(-1) > 0).squeeze(1)
        cells = np.unravel_index(keep.cpu().numpy(), tuple(counts.shape))
        columns = {name: g.bin_values_raw[codes]
                   for name, g, codes in zip(self.by_names, self.groupers, cells)}
        for name, grid in grids.items():
            columns[name] = grid.reshape(-1)[keep.to(grid.device)]
        return self._sorted(from_dict(columns))

    def _assemble_combined(self, grids):
        """The cells of a combined grouper are the observed combinations."""
        from . import from_dict
        columns = dict(zip(self.by_names, self.combined.bin_values_per_key))
        columns.update(grids)
        return self._sorted(from_dict(columns))

    def _sorted(self, df):
        return df.sort(self.by_names, ascending=self.ascending) if self.sort else df


def _is_count_star(desc):
    return desc.name == "count" and desc.expression in (None, "*") and desc.selection is None

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
``df.groupby(by, agg=...)`` first tries the one-sort plan of
:mod:`.fused_groupby` for raw integer keys and staged string keys.

A string key staged by ``to_device`` (or given as a dictionary array) is a
category: it bins on its dictionary codes, the null rows the last code
(vaex_tpu/groupby.py:95-135), and ``sort`` orders its labels with the null
label last.  Any other string key takes the set grouper: a set of strings,
then the ordinals of the host stage.  The string keys of a result are a
:class:`~.column.ColumnDictionary` (codes on the pass device, the labels on
the host), decoded only when read (vaex_tpu/groupby.py:180-230).
"""

from __future__ import annotations

import collections.abc
import os

import numpy as np
import torch

from . import agg as agg_module
from .agg import AggregatorDescriptor
from .expression import Expression
from . import array_types
from .column import ColumnDictionary, placed_device
from .dataset import DatasetArrays
from .ops.binners import BinnerOrdinal, BinnerScalar
from .ops.setops import RowLimitException  # noqa: F401  (vaex_tpu exports it here too)
from .utils import fingerprint, trace

# a sharded groupby of more groups than this exchanges its rows (the
# all-to-all of :mod:`.parallel.shuffle`) instead of giving every shard the
# whole grid (vaex_tpu/groupby.py:721-725); the cut-off depends on the link
# between the cards and is not measured (ROADMAP)
SHUFFLE_MIN_G = int(os.environ.get("VAEX_TPU_TORCH_SHUFFLE_MIN_G", 65536))

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


def _expression_and_frame(expression, df):
    """A grouper's key as a string and its frame: an Expression brings its
    own frame where none is given (vaex_tpu/groupby.py:41-44)."""
    if isinstance(expression, Expression):
        return expression.expression, df if df is not None else expression.df
    return str(expression), df


class GrouperCategory:
    """Zero-pass grouper using category metadata; a string category bins on
    its codes (the meta's ``codes_column``).  ``row_limit`` changes
    nothing, as in vaex_tpu (vaex_tpu/groupby.py:99)."""

    dense = False

    def __init__(self, expression, df=None, sort=False, ascending=True, row_limit=None):
        self.expression, df = _expression_and_frame(expression, df)
        self.df = df
        self.N = df.category_count(self.expression)
        self.min_value = df.category_offset(self.expression)
        self.bin_values = df.category_labels(self.expression, aslist=False)
        self.bin_values_raw = self.bin_values  # in code order, as the grid
        meta = df._categories[self.expression]
        binby = meta.get("codes_column", self.expression)
        self.binby_expression = binby
        # the labels of strings as an arrow array, the null label last
        self.arrow_labels = meta.get("arrow")
        self.ordinal_expression = (f"(astype({binby}, 'int64') - {self.min_value})"
                                   if self.min_value else f"astype({binby}, 'int64')")
        self.binner = BinnerOrdinal(binby, self.min_value, self.N)
        self.sort_indices = None
        if sort:
            order = (_label_order(self.arrow_labels) if self.arrow_labels is not None
                     else np.argsort(self.bin_values, kind="stable"))
            if not ascending:
                order = order[::-1]
            if not np.array_equal(order, np.arange(self.N)):
                self.sort_indices = order
                self.bin_values = self.bin_values[order]


class Grouper:
    """One key through the set of its values: a set-build pass, then the
    ordinal of each row's value as the bin.  ``materialize_experimental``
    changes nothing, as in vaex_tpu (vaex_tpu/groupby.py:39-48)."""

    dense = False

    def __init__(self, expression, df=None, sort=False, ascending=True, row_limit=None,
                 materialize_experimental=False):
        self.expression, df = _expression_and_frame(expression, df)
        self.df = df
        self.set = df._set(self.expression, limit=row_limit)
        self.bin_values = self.set.key_array(masked=True)
        self.bin_values_raw = self.bin_values
        self.N = self.set.count
        self.arrow_labels = _set_labels(self.set) if self.set.is_string else None
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
    device.  ``sort`` and ``ascending`` change nothing, as in vaex_tpu: the
    combinations come in the order of the members' bins."""

    dense = False

    def __init__(self, groupers, df, sort=False, ascending=True, row_limit=None):
        self.df = df
        self.groupers = groupers
        if np.prod([max(g.N, 1) for g in groupers], dtype=np.float64) >= 2 ** 62:
            raise ValueError("groupby key cardinality product overflows int64: "
                             "df.groupby(by, agg=...) runs such integer keys through the "
                             "one-sort path (fused_groupby); a groupby without agg= over them "
                             "is refused, as vaex_tpu's GrouperCombined refuses it (ROADMAP "
                             "queue A8)")
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
            elif getattr(g, "arrow_labels", None) is not None:
                out.append(ColumnDictionary(ordinals.to(torch.int32), g.arrow_labels))
            elif isinstance(values, np.ma.MaskedArray) or values.dtype.kind not in "biuf":
                out.append(values[ordinals.cpu().numpy()])
            else:
                out.append(torch.as_tensor(values).to(ordinals.device)[ordinals])
        return out


def _set_labels(oset):
    """A set of strings' keys as arrow labels, the null slot a null label."""
    import pyarrow as pa
    return pa.array(oset.keys.tolist() + [None] * oset.has_null, type=pa.string())


def _label_order(labels):
    """The stable ascending order of arrow string labels, the null one last."""
    import pyarrow.compute as pc
    return np.asarray(pc.array_sort_indices(labels, null_placement="at_end")).astype(np.int64)


def _key_column(g, codes):
    """A grouper's bin values at ``codes`` (a tensor): a
    :class:`ColumnDictionary` over string labels, a host gather else."""
    if getattr(g, "arrow_labels", None) is not None:
        return ColumnDictionary(codes.to(torch.int32), g.arrow_labels)
    return g.bin_values_raw[codes.cpu().numpy()]


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
        device = next((d for d in map(placed_device, df.dataset.values()) if d is not None),
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
    ``df`` sees and the values its names stand for: the filter, the
    variables and the virtual columns (a key redefined by ``df[k] = ...``
    names other values under the same name)."""
    return (df._filter, fingerprint(df.variables) if df.variables else None,
            fingerprint(df.virtual_columns) if df.virtual_columns else None)


def _sampled_range_too_wide(df, name):
    """True when about 4000 rows of an unfiltered frame's column already
    span more than DENSE_RANGE_MAX: the whole column then does too, and the
    key needs no pre-pass to be sent to the set grouper."""
    if df.filtered or not df._is_physical(name):
        return False
    col = df.dataset[name]
    if not isinstance(col, (np.ndarray, torch.Tensor)) or isinstance(col, np.ma.MaskedArray):
        return False
    wide = False
    if len(col):
        sample = col[::max(1, len(col) // 4096)]
        wide = int(sample.max()) - int(sample.min()) + 1 > DENSE_RANGE_MAX
    mesh = getattr(df.executor, "sharded", None)
    if mesh is not None and mesh.group is not None:
        # each process samples its own rows: one wide sample makes the
        # union wide, and every process must skip the pre-pass alike
        from .parallel import collectives
        wide = collectives.total([wide], mesh) > 0
    return wide


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


def parse_actions(df, by_names, actions):
    """(output name, descriptor) pairs of a groupby's ``agg``, named as
    vaex_tpu names them."""
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
                    raise KeyError(f"{s!r} is not an aggregator (vaex_tpu_torch.agg.aggregates)")
                s = agg_module.aggregates[s]
            if isinstance(s, AggregatorDescriptor):
                if name is None or multiple:
                    out.append((s.pretty_name(name if multiple else None), s))
                else:
                    out.append((name, s))
            elif callable(s):
                columns = ([name] if name is not None else
                           [c for c in df.get_column_names()
                            if c not in by_names and not c.startswith("__")])
                for column in columns:
                    desc = s(column)
                    out.append((desc.pretty_name() if (multiple or name is None)
                                else name, desc))
            else:
                raise TypeError(f"{s!r} is neither an aggregator nor its name")
    return out


def maybe_delay(result, delay):
    """``result`` as it is, or with ``delay`` in a promise already fulfilled
    with it: the passes ran eagerly (vaex_tpu/groupby.py:912-920)."""
    if not delay:
        return result
    from .delayed import Promise
    return Promise().fulfill(result)


class GroupByBase:
    """The groupers of one or more keys over a frame (a copy, or with
    ``copy=False`` the frame itself) and the parsing of the aggregations
    (vaex_tpu/groupby.py:359-392): what :class:`GroupBy` runs and
    :class:`BinBy` shares."""

    def __init__(self, df, by, sort=False, ascending=True, combine="auto", row_limit=None,
                 copy=True):
        self.df = df.copy() if copy else df
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

    @property
    def groupby_expression(self):
        """The expression of each key."""
        return [g.expression for g in self.groupers]

    def _parse_actions(self, actions):
        return parse_actions(self.df, self.by_names, actions)


class GroupBy(GroupByBase):
    """df.groupby over one or more keys."""

    def __iter__(self):
        """(key, the frame of its rows) per group, through filters
        (vaex_tpu/groupby.py:986-1018)."""
        for key in self._group_keys():
            yield key, self.get_group(key)

    def _group_keys(self):
        if len(self.groupers) == 1:
            values = self.groupers[0].bin_values
            return [values[i] for i in range(len(values))]
        return list(zip(*[g.bin_values for g in self.groupers]))

    @property
    def groups(self):
        for key, _ in self:
            yield key

    def get_group(self, key):
        """The rows of one group (a tuple of keys for several groupers), as
        a filter of the frame: a missing key matches the missing rows, a
        NaN key the NaN rows."""
        conditions = []
        for g, k in zip(self.groupers, key if isinstance(key, tuple) else (key,)):
            if isinstance(k, np.generic):
                k = k.item()
            if k is None or k is np.ma.masked:
                conditions.append(f"ismissing({g.expression})")
            elif isinstance(k, float) and np.isnan(k):
                conditions.append(f"isnan({g.expression})")
            else:
                conditions.append(f"({g.expression} == {k!r})")
        return self.df.filter(" & ".join(conditions))

    def agg(self, actions, delay=False):
        """The result frame, with ``delay`` in a fulfilled promise."""
        try:
            return maybe_delay(self._agg(actions), delay)
        except StaleRange:
            _forget(self.df)
            self._plan()
            return maybe_delay(self._agg(actions), delay)

    def _agg(self, actions):
        parsed = self._parse_actions(actions)
        routed = self._try_shuffle_agg(parsed)
        if routed is not None:
            return routed
        _prepare(self.df, self.binners, parsed)
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

    def _try_shuffle_agg(self, parsed):
        """The result through the all-to-all (:mod:`.parallel.shuffle`), or
        None where the replicated grids run: no sharded executor, at most
        ``SHUFFLE_MIN_G`` groups, an aggregation the exchange does not
        carry, or a skew that the slack retries do not absorb
        (vaex_tpu/groupby.py:733-778).  Over a mesh of several processes
        each process sends its own rows, owners and capacity count every
        process's, and every process ends with the whole result."""
        mesh = getattr(self.df.executor, "sharded", None)
        if mesh is None:
            return None
        if any(not hasattr(g, "ordinal_expression") for g in self.by):
            return None
        shape = [int(g.N) for g in self.by]
        G = int(np.prod(shape, dtype=np.int64))
        if G <= SHUFFLE_MIN_G or G > (1 << 31) - 2:
            return None
        plan = _shuffle_plan(self.df, parsed)
        if plan is None:
            return None
        if len(self.by) == 1:
            ordinal = self.by[0].ordinal_expression
        else:  # the cartesian cells in row-major order, as the grid's
            mult, parts = 1, []
            for g, n in zip(self.by[::-1], shape[::-1]):
                parts.append(f"(astype({g.ordinal_expression}, 'int64') * {mult})")
                mult *= n
            ordinal = " + ".join(parts[::-1])
        with trace("shuffle groupby (all-to-all)"):
            out = _run_shuffle_plan(self.df, ordinal, plan, G, mesh,
                                    dense=[g.expression for g in self.by if g.dense])
        if out is None:
            return None
        grids, counts = out
        self._logical = {name: desc.logical_dtype(self.df) for name, desc in parsed}
        grids = {name: grid.reshape(shape) for name, grid in grids.items()}
        counts = counts.reshape(shape)
        if self.combined is not None:
            return self._assemble_combined(grids)
        if len(self.by) == 1:
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
        if getattr(g, "arrow_labels", None) is not None:
            device = next(iter(grids.values())).device if grids else torch.device("cpu")
            keys = _key_column(g, (order if order is not None else torch.arange(g.N)).to(device))
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
        columns = {name: _key_column(g, torch.as_tensor(codes).to(keep.device))
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
        """The result sorted by its key columns, read by position: the frame
        renames a key that is not a name (an expression) on entry."""
        if not self.sort:
            return df
        return df.sort(list(df.dataset)[:len(self.by_names)], ascending=self.ascending)


def _shuffle_plan(df, parsed):
    """[(output name, kind, descriptor)] of the aggregations the exchange
    carries, or None (vaex_tpu/groupby.py:785-830): count, sum, mean, min,
    max, std, var and nunique of numeric or temporal expressions, with or
    without a selection."""
    plan = []
    for name, desc in parsed:
        kind = desc.name
        if kind == "count" and desc.expression in (None, "*"):
            plan.append((name, "count_star", desc))
            continue
        if kind not in ("count", "sum", "mean", "min", "max", "std", "var", "nunique"):
            return None
        if df.data_type(desc.expression).numpy.kind not in "biufmM":
            return None
        plan.append((name, kind, desc))
    return plan


class _Rows:
    """A shard's evaluated expressions, as a tile's context gives them to
    an op's ``kernel_input``."""

    def __init__(self, values):
        self.values = values

    def expr(self, expression):
        return self.values[str(expression)]


def _shuffle_channels(df, plan, shards):
    """The exchange's channels over each shard's values and, per output,
    how its [G] result is made from the exchange's (``finish(out)``)."""
    from .agg import (OpCount, OpCountValid, OpMax, OpMin, OpSum, OpSumFloat,
                      selection_expression)
    from .datatype import NAT
    from .ops.grid_extreme import identity
    from .parallel.shuffle import NU_NAN, NU_NONE, NU_NULL
    from .tasks import moment_data, moment_shift
    ints, floats, exts, modes, bases, base_shifts, nus = [], [], [], [], [], [], []
    base_valid = []
    finishers = {}

    def channel(target, parts):
        target.append(parts)
        return len(target) - 1

    def selected(desc):
        sel = selection_expression(desc.selection, df)
        if sel is None:
            return [None] * len(shards)
        out = []
        for rows in shards:
            x = rows.expr(sel)
            valid = x.data.to(torch.bool)
            out.append(valid if x.mask is None else valid & ~x.mask)
        return out

    def additive(op, sels):
        """The channel of an additive op: ("count", None) rows all count."""
        kinds, parts = set(), []
        for rows, sel in zip(shards, sels):
            kind, col = op.kernel_input(rows)
            if kind == "count":
                col = None if sel is None else sel.to(torch.int64)
                kind = "int" if sel is not None else "count"
            elif sel is not None:
                col = torch.where(sel, col, torch.zeros((), dtype=col.dtype, device=col.device))
            kinds.add(kind)
            parts.append(col if kind != "float" else col.to(torch.float64))
        if kinds == {"count"}:
            return lambda out: out["count"]
        if "count" in kinds:  # some shard's rows all count, another's not
            parts = [torch.ones(rows.n, dtype=torch.int64, device=rows.device) if p is None
                     else p for p, rows in zip(parts, shards)]
        if kinds <= {"int", "count"}:
            i = channel(ints, parts)
            return lambda out: out["int"][i]
        i = channel(floats, parts)
        return lambda out: out["float"][i]

    def finished(op, grid):
        state = op.initial_state(grid.shape[0], grid.device, 0)
        return op.get_result(op.apply_kernel(state, grid), grid.shape)

    for name, kind, desc in plan:
        sels = selected(desc)
        dtype = None if kind == "count_star" else desc._input_dtype(df)
        if kind == "count_star":
            grid = additive(OpCount([]), sels)
            finishers[name] = lambda out, grid=grid: grid(out).to(torch.int64)
        elif kind == "count":
            op = OpCount([desc.expression], dtype_in=dtype)
            grid = additive(op, sels)
            finishers[name] = lambda out, op=op, grid=grid: finished(op, grid(out))
        elif kind == "sum":
            op = OpSum([desc.expression], dtype_in=dtype)
            grid = additive(op, sels)
            finishers[name] = lambda out, op=op, grid=grid: finished(op, grid(out))
        elif kind == "mean":
            # any but a float column adds in float64 (agg.AggregatorDescriptorMean)
            s = additive((OpSum if dtype.numpy.kind == "f" else OpSumFloat)(
                [desc.expression], dtype_in=dtype), sels)
            c = additive(OpCountValid([desc.expression], dtype_in=dtype), sels)

            def mean(out, s=s, c=c):
                total, n = s(out), c(out)
                return torch.where(n > 0, total.to(torch.float64) / n.to(torch.float64),
                                   torch.nan)
            finishers[name] = mean
        elif kind in ("min", "max"):
            op = (OpMin if kind == "min" else OpMax)([desc.expression], dtype_in=dtype)
            op._state_dtype()  # refuses strings
            parts = []
            for rows, sel in zip(shards, sels):
                values, valid = op.extreme_input(rows)
                if sel is not None:
                    valid = sel if valid is None else valid & sel
                if valid is not None:
                    values = torch.where(valid, values, identity(values.dtype, kind))
                parts.append(values)
            i = channel(exts, parts)
            modes.append(kind)
            finishers[name] = lambda out, op=op, i=i: finished(op, out["ext"][i])
        elif kind in ("std", "var"):
            # the exchange carries a float base as float64 (NaN: a row that
            # does not count), an int, temporal or uint64 base as its 8-byte
            # word (a uint64 base's order image), beside its validity where
            # a row may not count: every owner subtracts the frame's shift
            # and its tables itself (owner_variance)
            shift, parts, valid = moment_shift(df, desc.expression), [], []
            for rows, sel in zip(shards, sels):
                d, missing = moment_data(rows.expr(desc.expression))
                bad = missing if sel is None else (~sel if missing is None else missing | ~sel)
                if d.is_floating_point():
                    d = d.to(torch.float64)
                    parts.append(d if bad is None else d.masked_fill(bad, torch.nan))
                else:
                    parts.append(d)
                    valid.append(None if bad is None else ~bad)
            i = channel(bases, parts)
            base_valid.append(None if all(v is None for v in valid) else
                              [torch.ones_like(p, dtype=torch.bool) if v is None else v
                               for p, v in zip(parts, valid)])
            base_shifts.append(shift)

            def var(out, i=i, std=kind == "std", ddof=desc.ddof):
                counts, v = out["moments"][i]
                n = counts.to(torch.float64)
                if ddof:
                    v = torch.where(n > ddof, v * n / (n - ddof), torch.nan)
                return torch.sqrt(v) if std else v
            finishers[name] = var
        else:  # nunique: the distinct bits, then NaN and missing as values of their own
            bits_parts, aux_parts, nan_parts, null_parts = [], [], [], []
            for rows, sel in zip(shards, sels):
                x = rows.expr(desc.expression)
                data = x.data
                null = (x.mask if x.mask is not None
                        else torch.zeros(data.shape, dtype=torch.bool, device=data.device))
                if data.is_floating_point():
                    d = data.to(torch.float64)
                    nan = torch.isnan(d) & ~null
                    bits = torch.where(d == 0, 0.0, d).view(torch.int64)
                else:
                    nan = torch.zeros_like(null)
                    bits = data.to(torch.int64)
                    if dtype.is_temporal:
                        null = null | (bits == NAT)
                aux = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
                aux = aux.masked_fill(nan, NU_NAN).masked_fill(null, NU_NULL)
                keep = torch.ones_like(null) if sel is None else sel
                aux = aux.masked_fill(~keep, NU_NONE)
                bits_parts.append(bits)
                aux_parts.append(aux)
                nan_parts.append((nan & keep).to(torch.int64))
                null_parts.append((null & keep).to(torch.int64))
            u = channel(nus, (bits_parts, aux_parts))
            extra = ([] if desc.dropnan else [channel(ints, nan_parts)]) + (
                [] if desc.dropmissing else [channel(ints, null_parts)])

            def nunique(out, u=u, extra=tuple(extra)):
                count = out["nu"][u].to(torch.int64)
                for i in extra:
                    count = count + (out["int"][i] > 0).to(torch.int64)
                return count
            finishers[name] = nunique
    return dict(int_cols=ints, float_cols=floats, ext_cols=exts, ext_modes=modes,
                bases=bases, base_shifts=base_shifts, base_valid=base_valid,
                nu_cols=nus), finishers



def _run_shuffle_plan(df, ordinal_expression, plan, G, mesh, slack=4, max_retries=3,
                      dense=()):
    """(the [G] grid of each output, the [G] count of observed rows) through
    :func:`.parallel.shuffle.shuffle_grids`, the values evaluated once per
    shard on its device; a bucket that overflows retries with twice the
    slack, and None after ``max_retries`` doublings: the replicated grids
    take the query (vaex_tpu/groupby.py:466-718).  A row whose key lies
    outside a ``dense`` grouper's range makes the range stale."""
    from .agg import selection_expression
    from .parallel import collectives
    from .parallel.shuffle import shard_values, shuffle_grids
    expressions = [ordinal_expression]
    for _, kind, desc in plan:
        if kind != "count_star":
            expressions.append(str(desc.expression))
        sel = selection_expression(desc.selection, df)
        if sel is not None:
            expressions.append(sel)
    values = shard_values(df, expressions, mesh)
    shards = []
    for v in values:
        rows = _Rows(v)
        first = v[ordinal_expression].data
        rows.n, rows.device = first.shape[0], first.device
        shards.append(rows)
    codes = []
    for v in values:
        x = v[ordinal_expression]
        c = x.data.to(torch.int64)
        codes.append(c if x.mask is None else c.masked_fill(x.mask, -1))
    if dense:
        outside = collectives.total([int(((c < 0) | (c >= G)).sum()) for c in codes], mesh)
        if outside:
            raise StaleRange(dense[0])
    channels, finishers = _shuffle_channels(df, plan, shards)
    for attempt in range(max_retries + 1):
        out, dropped, trace_entry = shuffle_grids(mesh, codes, G, slack, **channels)
        trace_entry["attempt"] = attempt
        df.executor.trace_log.append(trace_entry)
        if out is not None:
            return {name: fin(out) for name, fin in finishers.items()}, out["count"]
        slack *= 2
    df.executor.trace_log.append({"shuffle": "replicated", "G": int(G), "dropped": dropped,
                                  "slack": slack // 2, "world": mesh.world})
    return None


def _prepare(df, binners, parsed):
    """Run the pre-passes the descriptors ask for (a count grid's limits) as
    one pass before their aggregations are scheduled."""
    for _, desc in parsed:
        desc.prepare(df, binners)
    if df.executor.tasks:
        df.execute()


def _is_count_star(desc):
    return desc.name == "count" and desc.expression in (None, "*") and desc.selection is None


class BinBy(GroupByBase):
    """``df.binby``: the aggregations over the whole grid of ``by``, empty
    cells included, as an N-d array (vaex_tpu/groupby.py:1021-1073).  A
    category axis has its labels as coordinates, a continuous one the centres
    of its ``shape`` bins over ``limits`` (as :meth:`DataFrame.limits` reads
    them).  ``agg`` returns an ``xarray.DataArray`` (one aggregation) or
    ``Dataset`` (several) when xarray is installed, else a
    :class:`BinnedArray` or a dict of them."""

    def __init__(self, df, by, limits=None, shape=128, sort=False, copy=True):
        self.df = df.copy() if copy else df
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

    @property
    def groupby_expression(self):
        return self.by_names

    def agg(self, actions, merge=False, delay=False):
        """The grids; ``merge`` changes nothing, as in vaex_tpu, and with
        ``delay`` they come in a fulfilled promise (vaex_tpu returns them as
        they are: ROADMAP, known problems of the reference)."""
        parsed = self._parse_actions(actions)
        _prepare(self.df, self.binners, parsed)
        promises = [(name, desc, desc.add_tasks(self.df, self.binners)[0])
                    for name, desc in parsed]
        self.df.execute()
        ndim = len(self.binners)
        arrays = {}
        for name, desc, p in promises:
            grid = agg_module.view_logical(array_types.to_numpy(p.get()),
                                           desc.logical_dtype(self.df))
            arrays[name] = agg_module.extract_central(grid, ndim)
        return maybe_delay(_to_xarray(arrays, self.by_names, self.coords), delay)


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

"""shift / diff / rolling (the counterpart of ``vaex_tpu/shift.py``).

A shifted column is a lazy :class:`ColumnShifted` view of its source
column: rows ``[i1, i2)`` read the source's ``[i1 - periods, i2 - periods)``
on the source's device and fill (``fill_value``) or mask the rows past
either end there, so a shift copies nothing to the host and nothing at all
where a tile lies wholly inside the source.  A strided read (``col[::k]``,
what a content fingerprint takes) gathers its rows the same way.  A
virtual column is evaluated once into a column first, on the frame's
device (:meth:`~.dataframe.DataFrame.materialize`).

``diff`` puts the source beside its shifted view under a hidden name (the
same column object, no copy) and subtracts; ``Rolling`` names one shifted
view of the source per offset of the window and sums, averages, or takes
the minimum or maximum of them in an expression, which a pass evaluates
per tile on the card.  The reference evaluates each shifted column to a
numpy array first (vaex_tpu/shift.py:74, 108, 153); the port reads the
views in place.
"""

from __future__ import annotations

import torch

from .column import (ColumnDictionary, ColumnString, LazyColumn, column_fingerprint, column_to,
                     gather, placed_device, tile_of)
from .column import is_masked as column_is_masked
from .dataset import DatasetArrays
from .datatype import DataType
from .ops.nullable import NA
from .utils import fingerprint


class ColumnShifted(LazyColumn):
    """Row i is the source's row ``i - periods`` (rows ``[start, start +
    length)`` of that view, for a slice of it), ``fill_value`` or missing
    where that row lies outside the source."""

    def __init__(self, source, periods, fill_value=None, start=0, length=None):
        self.source = source
        self.periods = int(periods)
        self.fill_value = fill_value
        self.start = start
        self.length = len(source) - start if length is None else length

    def __len__(self):
        return self.length

    @property
    def dtype(self):
        return DataType(self.source.dtype).numpy

    @property
    def device(self):
        return placed_device(self.source)

    @property
    def is_masked(self):
        return column_is_masked(self.source) or (self.fill_value is None and self.periods != 0)

    def _fill(self, data, outside):
        """``data`` with the rows ``outside`` the source filled."""
        return data.masked_fill(outside, torch.tensor(self.fill_value).to(data.dtype))

    def _rows(self, i1, i2):
        """Rows [i1, i2) of the view (absolute) as an NA on the source's
        device: the source's rows as they are where all of them exist, else
        placed into a tile whose outside rows are filled or masked."""
        n, N, p = i2 - i1, len(self.source), self.periods
        lo, hi = max(i1 - p, 0), min(i2 - p, N)
        part = tile_of(self.source, lo, max(lo, hi))
        if hi - lo == n:
            return part
        inside = max(hi - lo, 0)
        at = lo + p - i1 if inside else 0  # the tile's first row that the source feeds
        data = torch.zeros(n, dtype=part.data.dtype, device=part.data.device)
        data[at:at + inside] = part.data
        outside = torch.ones(n, dtype=torch.bool, device=data.device)
        outside[at:at + inside] = False
        mask = None
        if part.mask is not None:
            mask = torch.zeros(n, dtype=torch.bool, device=data.device)
            mask[at:at + inside] = part.mask
        if self.fill_value is None:
            return NA(data, outside if mask is None else outside | mask)
        return NA(self._fill(data, outside), mask)

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("a shifted column takes slices")
        start, stop, step = item.indices(len(self))
        if step == 1:
            return self._rows(self.start + start, self.start + max(start, stop))
        device = self.device or torch.device("cpu")
        return self.take(torch.arange(start, stop, step, device=device))

    def take(self, index):
        """The rows at the int tensor ``index``: one gather of the source."""
        N = len(self.source)
        device = self.device or torch.device("cpu")
        src = index.to(device, torch.int64) + (self.start - self.periods)
        outside = (src < 0) | (src >= N)
        value = gather(self.source, src.clamp(0, max(N - 1, 0)))
        mask = value.mask
        if self.fill_value is None:  # the outside rows hold 0, as a slice's do
            return NA(value.data.masked_fill(outside, 0),
                      outside if mask is None else outside | mask)
        return NA(self._fill(value.data, outside),
                  None if mask is None else mask & ~outside)

    def trim(self, i1, i2):
        return ColumnShifted(self.source, self.periods, self.fill_value, self.start + i1,
                             i2 - i1)

    def to(self, device):
        return ColumnShifted(column_to(self.source, device), self.periods, self.fill_value,
                             self.start, self.length)

    def key_parts(self):
        """(the columns, the rest) of an exact key (:func:`.column.column_key`)."""
        return [self.source], (self.periods, repr(self.fill_value), self.start, self.length)

    def fingerprint(self):
        return fingerprint("column-shifted", column_fingerprint(self.source), self.periods,
                           repr(self.fill_value), self.start, self.length)


def _names(df, column):
    if column is None:
        return df.get_column_names()
    return [str(column)] if isinstance(column, str) else [str(c) for c in column]


def _physical(df, names):
    """``df`` with the virtual columns among ``names`` evaluated into
    columns (on its device, when its columns lie on one)."""
    for name in names:
        if name in df.virtual_columns:
            df = df.materialize(name)
    return df


def shift(df, periods, column=None, fill_value=None, trim=False, inplace=False):
    """The frame with the columns (``column``, or all) shifted by
    ``periods`` rows, forward where positive; with ``trim`` without the rows
    the shift emptied (vaex_tpu/shift.py:58-83).  A filtered frame shifts the
    rows its filter keeps."""
    df = df.extract() if df.filtered else df.trim(inplace=inplace)
    from .dataframe import _string_category
    names = _names(df, column)
    out = _physical(df.copy(), names)
    columns = dict(out.dataset.items())
    for name in names:
        col = columns[name]
        if isinstance(col, ColumnDictionary):
            columns[name] = _shifted_codes(col, periods, fill_value)
            codes = out._categories.get(name, {}).get("codes_column")
            if codes in columns:  # a staged string key bins on the shifted codes
                columns[codes] = columns[name].codes
                out._categories[name] = _string_category(
                    columns[name].labels, columns[name].has_null, codes)
        elif isinstance(col, ColumnString):
            columns[name] = _shifted_strings(col, periods, fill_value)
        else:
            columns[name] = ColumnShifted(col, periods, fill_value)
    out = out._rebind_dataset(DatasetArrays(columns, out.dataset.logical, out.dataset.device))
    out.column_names = list(df.column_names)
    if trim:
        n = len(out)
        if periods > 0:
            out = out[periods:n]
        elif periods < 0:
            out = out[0:n + periods]
    return out


def _shifted_codes(col, periods, fill_value):
    """A staged string column shifted: its codes moved on their device, the
    rows past either end the code of ``fill_value`` (added as a label where
    it is none yet) or the null code."""
    import pyarrow as pa
    labels, codes = col.labels, col.codes
    null = len(labels)
    if fill_value is not None:
        found = labels.index(fill_value).as_py()
        if found < 0:
            labels = pa.concat_arrays([labels, pa.array([fill_value], labels.type)])
            codes = codes.masked_fill(codes == null, len(labels))  # the null code moves up
            found = null
        fill = found
    else:
        fill = len(labels)
    n, p = codes.shape[0], max(-codes.shape[0], min(int(periods), codes.shape[0]))
    out = torch.full_like(codes, fill)
    if p >= 0:
        out[p:] = codes[:n - p]
    else:
        out[:n + p] = codes[-p:]
    return ColumnDictionary(out, labels)


def _shifted_strings(col, periods, fill_value):
    """A host string column shifted on the host: the rows past either end
    ``fill_value`` or null; a dictionary column stays one."""
    import pyarrow as pa
    array = col.array
    encoded = pa.types.is_dictionary(array.type)
    if encoded:
        array = array.dictionary_decode()
    n, p = len(array), max(-len(array), min(int(periods), len(array)))
    pad = pa.array([fill_value] * abs(p), pa.string()).cast(array.type)
    parts = [pad, array.slice(0, n - p)] if p >= 0 else [array.slice(-p), pad]
    out = pa.concat_arrays(parts)
    return ColumnString(out.dictionary_encode() if encoded else out)


def diff(df, periods=1, column=None, fill_value=None, trim=False, inplace=False,
         reverse=False):
    """Each column (``column``, or all) minus itself shifted by ``periods``
    (the other way round with ``reverse``; vaex_tpu/shift.py:86-107): the
    source stays beside its shifted view as ``__<name>_original``."""
    base = df.extract() if df.filtered else df.trim()
    names = _names(base, column)
    work = _physical(base.copy(), names)
    originals = {}
    for name in names:
        originals[name] = f"__{name}_original"
        work._put_column(originals[name], work.dataset[name], work.dataset.logical.get(name))
    work = shift(work, periods, names, fill_value=fill_value, trim=trim)
    for name in names:
        if reverse:
            work[name] = work[name] - work[originals[name]]
        else:
            work[name] = work[originals[name]] - work[name]
    hidden = set(originals.values())
    work.column_names = [n for n in work.column_names if n not in hidden]
    return work


class Rolling:
    """Window reductions over ``window`` rows, ending at each row
    (``edge="right"``) or starting there (``"left"``; vaex_tpu/shift.py:
    110-176): per column one shifted view of the source per offset, under
    ``__<name>_shift_<k>``, and a virtual column that combines them."""

    def __init__(self, df, window, trim=False, fill_value=None, edge="right", columns=None):
        self.df = df
        self.window = window
        self.trim = trim
        self.fill_value = fill_value
        self.edge = edge
        self.columns = [str(c) for c in (columns or df.get_column_names())]

    def _offsets(self):
        if self.edge == "right":
            return range(-(self.window - 1), 1)
        if self.edge == "left":
            return range(0, self.window)
        raise ValueError(f'edge must be "right" or "left", not {self.edge!r}')

    def _reduce(self, combine):
        df = self.df.extract() if self.df.filtered else self.df.trim()
        out = _physical(df.copy(), self.columns)
        for name in self.columns:
            source, logical = out.dataset[name], out.dataset.logical.get(name)
            shifted = []
            for k, off in enumerate(self._offsets()):
                view = ColumnShifted(source, -off, self.fill_value) if off else source
                out._put_column(f"__{name}_shift_{k}", view, logical)
                shifted.append(f"__{name}_shift_{k}")
            out[f"__rolling_{name}"] = combine(shifted)
        result = out.copy()
        for name in self.columns:
            result[name] = result[f"__rolling_{name}"]
        result.column_names = [n for n in result.column_names if not n.startswith("__")]
        if self.trim:
            n, w = len(result), self.window - 1
            result = result[w:n] if self.edge == "right" else result[0:n - w]
        return result

    def sum(self):
        return self._reduce(lambda names: " + ".join(f"fillmissing({n}, 0)" for n in names))

    def mean(self):
        df = self.sum()
        for name in self.columns:
            df[name] = df[name] / self.window
        return df

    def min(self):
        return self._reduce(lambda names: _fold("minimum", names))

    def max(self):
        return self._reduce(lambda names: _fold("maximum", names))


def _fold(function, names):
    expr = names[0]
    for name in names[1:]:
        expr = f"{function}({expr}, {name})"
    return expr

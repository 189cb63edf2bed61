"""Columns.

A column is anything sliceable with ``__len__``, ``__getitem__`` and a
``dtype``: numpy arrays, numpy masked arrays and torch tensors (on the CPU
or a CUDA device) qualify, and the column types below, each a
:class:`Column` (vaex_tpu/column.py:23-35).

* :class:`ColumnVirtualConstant`: the scalar column of
  ``DataFrame.add_column`` and ``vconstant``, a host array of one value per
  slice.
* :class:`ColumnVirtualRange`: ``vrange``'s column, which holds no memory: a
  pass's tile of it is an ``arange`` made on the pass device.
* :class:`ColumnMasked`: data and a bool mask (True = missing), two tensors
  on one device: what ``DataFrame.to_device`` makes of a masked array.
* :class:`ColumnIndexed`: the rows of a source column at an index tensor on
  the source's device, with an optional mask of rows that hold no value (a
  take, a filter, the right side of a join); a take of a take is one hop
  (vaex_tpu/column.py:102-168).
* :class:`ColumnConcatenated`: columns one after another
  (vaex_tpu/column.py:171-198).
* :class:`LazyColumn`: the base of the lazy columns of other modules
  (:class:`~.shift.ColumnShifted`).
* :class:`ColumnString`: strings on the host, an arrow array (plain or
  dictionary-encoded, nulls included); a pass reads it in its host stage.
* :class:`ColumnDictionary`: strings staged on a device, int32 dictionary
  codes in a tensor there and the labels on the host (vaex_tpu/column.py:
  201-240); what ``to_device`` makes of a string column, and what a
  groupby's string keys come back as.  A tile is a
  :class:`~.ops.nullable.DictNA`.
* :class:`ColumnHost`: the base of a column read from a file a slice at a
  time (a parquet file's row groups, a FITS record array, an arrow chunked
  array, a remote object's block cache): a slice is a host numpy (masked)
  array.

A column read from a file carries an exact key of its own (:func:`keyed`):
the file's path, device, inode, size and modification time and the
column's place in it, so that the result cache keys it without reading a
byte (:func:`column_key`); a slice of it keeps a key derived from it.

A slice of one of the lazy ones is an :class:`~.ops.nullable.NA` of
tensors on the column's device: data and mask, read with one gather for an
indexed column.  :func:`tile_of` gives rows of any column as an NA on a
device, which is how a pass reads them.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from . import array_types
from .datatype import DataType, dtype_of, has_torch_dtype, host_values
from .ops.nullable import NA, DictNA
from .utils import fingerprint, hash_array_data, identity, tensor_key

CPU = torch.device("cpu")

# id(column) -> (a weak reference to it, its exact key, whether that is a
# content key): the keys of columns read from files (:func:`keyed`)
_KEYED = {}


def keyed(col, key, content=False):
    """``col`` with the exact key ``key`` of its values, which
    :func:`column_key` gives instead of hashing them: a file's identity and
    the column's place in it (no content key: it holds on this machine), or
    the content hashes of :meth:`.dataset.DatasetFile.hashed`.  The entry
    goes with the column object."""
    ident = id(col)
    _KEYED[ident] = (weakref.ref(col, lambda _, ident=ident: _KEYED.pop(ident, None)),
                     key, content)
    return col


def registered_key(col):
    """(the key :func:`keyed` gave ``col``, whether it is a content key), or
    None."""
    entry = _KEYED.get(id(col))
    if entry is None or entry[0]() is not col:
        return None
    return entry[1], entry[2]


def file_identity(path, fd=None):
    """What names a file's bytes on this machine while no one writes into
    it: its absolute path, device, inode, size and modification time, of the
    open file ``fd`` where given (the one a mapping reads).  A rewrite
    through a new file and ``os.replace`` is a new inode; an edit in place
    within one tick of the clock is not seen (as vaex_tpu/dataset.py:457)."""
    st = os.fstat(fd) if fd is not None else os.stat(path)
    return ("file", os.path.abspath(str(path)), st.st_dev, st.st_ino, st.st_size,
            st.st_mtime_ns)


class Column:
    """The base of the column types: ``__len__``, ``__getitem__``,
    ``dtype`` and :meth:`to_numpy`."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise NotImplementedError

    @property
    def dtype(self):
        raise NotImplementedError

    def to_numpy(self):
        """Every row as a host numpy array, masked where missing (strings
        as objects)."""
        value = self[:]
        if isinstance(value, NA):
            data = host_values(value.data.cpu().numpy(), value.logical)
            if value.mask is None:
                return data
            return np.ma.MaskedArray(data, value.mask.cpu().numpy())
        return array_types.to_numpy(value)


class ColumnHost(Column):
    """The base of a column read from a file a slice at a time: ``dtype`` a
    numpy dtype, ``_read(i1, i2)`` rows [i1, i2) as a host numpy (masked)
    array.  A slice reads its rows (all rows where it has a step), a
    ``trim`` is a view of rows that reads nothing, a take reads the span of
    its rows.  ``masked`` says whether a slice can
    hold a mask."""

    dtype = np.dtype("float64")
    masked = False

    def __len__(self):
        raise NotImplementedError

    def _read(self, i1, i2):
        raise NotImplementedError

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            if step != 1:
                return self._read(0, len(self))[item]
            return self._read(start, max(start, stop))
        index = np.asarray(item, dtype=np.int64)
        if index.size == 0:
            return self._read(0, 0)
        lo = int(index.min())
        return self._read(lo, int(index.max()) + 1)[index - lo]

    def trim(self, i1, i2):
        return ColumnHostRows(self, i1, i2)


class ColumnHostRows(ColumnHost):
    """Rows [i1, i2) of a :class:`ColumnHost`."""

    def __init__(self, source, i1, i2):
        if isinstance(source, ColumnHostRows):
            source, i1, i2 = source.source, source.i1 + i1, source.i1 + i2
        self.source, self.i1, self.i2 = source, i1, i2
        self.dtype, self.masked = source.dtype, source.masked

    def __len__(self):
        return self.i2 - self.i1

    def _read(self, i1, i2):
        return self.source._read(self.i1 + i1, self.i1 + i2)


class ColumnVirtualConstant(Column):
    """``length`` rows of one value (vaex_tpu/column.py:72-99): a slice is a
    host array of it, made when a tile needs it."""

    def __init__(self, value, length, dtype=None):
        self.value = value
        self.length = length
        self._dtype = np.dtype(dtype) if dtype is not None else np.asarray(value).dtype

    def __len__(self):
        return self.length

    @property
    def dtype(self):
        return self._dtype

    def trim(self, i1, i2):
        return ColumnVirtualConstant(self.value, i2 - i1, self._dtype)

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            n = len(range(start, stop, step))
        else:
            n = len(np.asarray(item))
        return np.full(n, self.value, dtype=self.dtype)

    def fingerprint(self):
        return f"vconstant-{self.value!r}-{self.length}-{self.dtype}"


class ColumnVirtualRange(Column):
    """The values ``start, start + step, ...`` below ``stop``, in ``dtype``
    (vaex_tpu/column.py:38-70), held as those three numbers: a pass's tile is
    an ``arange`` made on the pass device (:func:`tile_of`), a host slice or
    take a numpy array."""

    def __init__(self, start, stop, step=1, dtype=None):
        if step == 0:
            raise ValueError("a range's step must not be 0")
        self.start, self.stop, self.step = int(start), int(stop), int(step)
        self._dtype = np.dtype(dtype or np.int64)

    def __len__(self):
        return len(range(self.start, self.stop, self.step))

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            rows = np.arange(start, stop, step, dtype=np.int64)
        else:
            rows = np.asarray(item, dtype=np.int64)
        return (self.start + rows * self.step).astype(self.dtype)

    def values_at(self, rows):
        """The values at the int tensor ``rows``, on its device."""
        return (rows.to(torch.int64) * self.step + self.start).to(DataType(self.dtype).torch)

    def tile(self, i1, i2, device):
        """Rows [i1, i2) as a tensor made on ``device``."""
        return self.values_at(torch.arange(i1, i2, dtype=torch.int64, device=device))

    def trim(self, i1, i2):
        return ColumnVirtualRange(self.start + i1 * self.step, self.start + i2 * self.step,
                                  self.step, self.dtype)

    def fingerprint(self):
        return f"vrange-{self.start}-{self.stop}-{self.step}-{self.dtype}"


def _or(a, b):
    """The union of two masks, either of which may be None."""
    if a is None:
        return b
    return a if b is None else a | b


def _sampled(t):
    """A content hash of a tensor from its head, a strided sample and its
    tail: a few small copies, never the whole tensor."""
    n = t.shape[0]
    parts = [t[:1000]]
    if n > 2000:
        parts += [t[::max(1, n // 2048)], t[n - 1000:]]
    return fingerprint("sampled", [p.detach().cpu().numpy() for p in parts], str(t.dtype), n)


class ColumnMasked(Column):
    """Data and a bool mask (True = missing), two tensors on one device."""

    def __init__(self, data, mask):
        if data.shape != mask.shape or data.device != mask.device:
            raise ValueError("data and mask must have one shape and one device")
        self.data = data
        self.mask = mask

    def __len__(self):
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __getitem__(self, item):
        return NA(self.data[item], self.mask[item])

    def take(self, index):
        return NA(self.data.index_select(0, index), self.mask.index_select(0, index))

    def trim(self, i1, i2):
        return ColumnMasked(self.data[i1:i2], self.mask[i1:i2])

    def to(self, device):
        return ColumnMasked(self.data.to(device), self.mask.to(device))

    def fingerprint(self):
        return fingerprint("column-masked", _sampled(self.data), _sampled(self.mask))


def _masked_indices(indices):
    """vaex_tpu's masked index (a numpy masked array whose masked entries
    are missing rows) as (an int64 index tensor, 0 where missing, and the
    bool mask tensor)."""
    data = np.ma.filled(np.ma.asarray(indices), 0).astype(np.int64, copy=False)
    return torch.from_numpy(data), torch.from_numpy(np.ma.getmaskarray(indices).copy())


class ColumnIndexed(Column):
    """Row ``index[i]`` of ``source`` as row i, missing where ``mask`` is
    True (there ``index`` holds 0).  ``index`` lies on the source's device
    (the CPU for a host array).  Build one with :meth:`index_of`, which
    collapses a take of a take into one hop.  With ``masked`` the indices
    are vaex_tpu's form, a numpy masked array whose masked entries are
    missing rows (vaex_tpu/column.py:102-137)."""

    def __init__(self, source, indices, mask=None, masked=False):
        if masked:
            indices, mask = _masked_indices(indices)
        self.source = source
        self.index = indices
        self.mask = mask

    @staticmethod
    def index(source, indices, masked=False):
        """vaex_tpu's spelling of :meth:`index_of` (vaex_tpu/column.py:
        117-131): ``indices`` host ints, an int tensor or, with ``masked``,
        a numpy masked array.  Called on the class: an instance's ``index``
        is its index tensor."""
        if masked:
            indices, mask = _masked_indices(indices)
        else:
            mask = None
            if not isinstance(indices, torch.Tensor):
                indices = torch.from_numpy(np.asarray(indices, dtype=np.int64))
        return ColumnIndexed.index_of(source, indices, mask)

    @staticmethod
    def index_of(source, index, mask=None) -> "ColumnIndexed":
        """``source`` at ``index``, one hop deep: of an indexed column the
        composed index (and the union of both masks)."""
        if isinstance(source, ColumnIndexed):
            index = index.to(source.index.device)
            mask = None if mask is None else mask.to(index.device)
            inner_mask = None if source.mask is None else source.mask.index_select(0, index)
            return ColumnIndexed(source.source, source.index.index_select(0, index),
                                 _or(mask, inner_mask))
        device = column_device(source)
        return ColumnIndexed(source, index.to(device),
                             None if mask is None else mask.to(device))

    def __len__(self):
        return self.index.shape[0]

    @property
    def dtype(self):
        return DataType(self.source.dtype).numpy

    @property
    def device(self):
        return placed_device(self.source)

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("an indexed column takes slices")
        return self._gather(self.index[item], None if self.mask is None else self.mask[item])

    def _gather(self, index, mask):
        value = gather(self.source, index)
        return NA(value.data, _or(value.mask, mask))

    def take(self, index):
        index = index.to(self.index.device)
        return self._gather(self.index.index_select(0, index),
                            None if self.mask is None else self.mask.index_select(0, index))

    def trim(self, i1, i2):
        return ColumnIndexed(self.source, self.index[i1:i2],
                             None if self.mask is None else self.mask[i1:i2])

    def to(self, device):
        source = column_to(self.source, device)
        device = column_device(source)
        return ColumnIndexed(source, self.index.to(device),
                             None if self.mask is None else self.mask.to(device))

    def fingerprint(self):
        return fingerprint("column-indexed", column_fingerprint(self.source),
                           _sampled(self.index), None if self.mask is None else _sampled(self.mask))


class ColumnConcatenated(Column):
    """The rows of ``columns`` one after another; a slice that spans two
    parts reads both and joins them on the device of the first part that
    lies on one (vaex_tpu/column.py:171-198)."""

    def __init__(self, columns):
        self.columns = list(columns)
        self.offsets = np.cumsum([0] + [len(c) for c in self.columns]).tolist()
        self._dtype = np.result_type(*(DataType(c.dtype).numpy for c in self.columns))

    def __len__(self):
        return self.offsets[-1]

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return next((d for d in map(placed_device, self.columns) if d is not None), None)

    def _parts(self, i1, i2):
        """(part, start, stop) of each part that rows [i1, i2) reach."""
        for col, c0, c1 in zip(self.columns, self.offsets, self.offsets[1:]):
            lo, hi = max(i1, c0), min(i2, c1)
            if lo < hi:
                yield col, lo - c0, hi - c0

    def _joined(self, pieces):
        device = self.device or CPU
        dtype = DataType(self._dtype).torch
        data = torch.cat([p.data.to(device, dtype) for p in pieces]) if pieces else (
            torch.empty(0, dtype=dtype, device=device))
        if all(p.mask is None for p in pieces):
            return NA(data)
        return NA(data, torch.cat([
            p.mask.to(device) if p.mask is not None
            else torch.zeros(p.data.shape[0], dtype=torch.bool, device=device) for p in pieces]))

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("a concatenated column takes slices")
        start, stop, step = item.indices(len(self))
        if step != 1:
            raise ValueError("a concatenated column takes slices without a step")
        return self._joined([tile_of(col, lo, hi) for col, lo, hi in self._parts(start, stop)])

    def take(self, index):
        """The rows at ``index``: each part gathers the rows that fall in it."""
        device = self.device or CPU
        index = index.to(device)
        data = torch.empty(index.shape[0], dtype=DataType(self._dtype).torch, device=device)
        mask = None
        for col, c0, c1 in zip(self.columns, self.offsets, self.offsets[1:]):
            at = torch.nonzero((index >= c0) & (index < c1)).squeeze(1)
            part = gather(col, index.index_select(0, at) - c0)
            data[at] = part.data.to(device, data.dtype)
            if part.mask is not None:
                if mask is None:
                    mask = torch.zeros(index.shape[0], dtype=torch.bool, device=device)
                mask[at] = part.mask.to(device)
        return NA(data, mask)

    def trim(self, i1, i2):
        parts = [slice_column(col, lo, hi) for col, lo, hi in self._parts(i1, i2)]
        return ColumnConcatenated(parts or [slice_column(self.columns[0], 0, 0)])

    def to(self, device):
        return ColumnConcatenated([column_to(c, device) for c in self.columns])

    def fingerprint(self):
        return fingerprint("column-concat", [column_fingerprint(c) for c in self.columns])


class LazyColumn(Column):
    """The base of a lazy column defined outside this module (the shifted
    view of :mod:`.shift`): like the three above, a slice of it is an NA on
    its device, and it has ``take``, ``trim``, ``to``, ``device``,
    ``is_masked`` and ``fingerprint``."""


LAZY = (ColumnMasked, ColumnIndexed, ColumnConcatenated, LazyColumn)


class ColumnString(Column):
    """Strings on the host: an arrow string, large string or
    dictionary-of-strings array, nulls included (a numpy array of str or of
    str and None objects, a masked one, is converted once).  A slice is an
    arrow array; a take copies the rows on the host; ``to(device)``
    dictionary-encodes the column once (:class:`ColumnDictionary`).  Its
    fingerprint hashes every buffer of the column, once."""

    def __init__(self, array):
        self.array = array_types.string_arrow(array)
        self._fingerprint = None

    def __len__(self):
        return len(self.array)

    @property
    def type(self):
        return self.array.type

    dtype = type

    @property
    def null_count(self):
        return self.array.null_count

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            if step == 1:
                return self.array.slice(start, max(stop - start, 0))
            item = np.arange(start, stop, step)
        return self.array.take(np.asarray(item))

    def take(self, index, mask=None):
        """The rows at an int tensor, null where ``mask`` is True."""
        import pyarrow as pa
        import pyarrow.compute as pc
        out = self.array.take(index.cpu().numpy())
        if mask is not None:
            mask = mask.cpu().numpy()
            if mask.any():
                out = pc.if_else(pa.array(mask), pa.nulls(len(out), out.type), out)
        return ColumnString(out)

    def trim(self, i1, i2):
        return ColumnString(self.array.slice(i1, i2 - i1))

    def to(self, device):
        return ColumnDictionary.encode(self.array, device)

    def fingerprint(self):
        if self._fingerprint is None:
            self._fingerprint = _arrow_fingerprint(self.array)
        return self._fingerprint


def _arrow_fingerprint(array):
    """A hash of every buffer of an arrow array, its offset and length."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{array.type}-{array.offset}-{len(array)}".encode())
    for buf in array.buffers():
        h.update(b"|" if buf is None else memoryview(buf))
    if hasattr(array, "dictionary"):
        h.update(_arrow_fingerprint(array.dictionary).encode())
    return h.hexdigest()


class ColumnDictionary(Column):
    """Strings as int32 ``codes`` (a tensor on a device) into ``labels`` (an
    arrow string array on the host): a code equal to ``len(labels)``, or of
    a null label, is a null row.  A tile on the pass device is a
    :class:`~.ops.nullable.DictNA`; a host slice a
    ``pyarrow.DictionaryArray``, read from ``host_codes`` (the codes the
    host encoded, or a copy made at the first host read).  Takes and
    slices keep the codes on their device (the counterpart of
    ``ColumnDeviceDictionary``, vaex_tpu/column.py:201-240)."""

    def __init__(self, codes, labels, host_codes=None, has_null=None):
        self.codes = codes
        self.labels = labels
        self._host_codes = host_codes
        self._has_null = has_null  # None: not known yet

    @classmethod
    def encode(cls, array, device):
        """Dictionary-encode strings (any arrow string array) once: the
        labels in the order of first appearance, null rows the code
        ``len(labels)``."""
        import pyarrow as pa
        import pyarrow.compute as pc
        array = array_types.string_arrow(array)
        if pa.types.is_dictionary(array.type):
            if array.dictionary.null_count or len(pc.unique(array.dictionary)) != len(
                    array.dictionary):
                array = array.dictionary_decode()
        if not pa.types.is_dictionary(array.type):
            array = pc.dictionary_encode(array)
        labels = array.dictionary
        indices = array.indices
        if indices.null_count:
            indices = indices.fill_null(len(labels))
        host = np.asarray(indices).astype(np.int32, copy=False)
        return cls(array_types.host_tensor(host).to(device), labels, host,
                   has_null=array.null_count > 0)

    def __len__(self):
        return self.codes.shape[0]

    @property
    def type(self):
        import pyarrow as pa
        return pa.dictionary(pa.int32(), self.labels.type)

    dtype = type

    @property
    def device(self):
        return self.codes.device

    @property
    def host_codes(self):
        if self._host_codes is None:
            self._host_codes = self.codes.cpu().numpy().astype(np.int32, copy=False)
        return self._host_codes

    @property
    def has_null(self):
        """True where a row may be null: a null label, or a code past the
        labels (one scan of the codes, the first time)."""
        if self._has_null is None:
            self._has_null = bool(self.labels.null_count) or bool(
                (self.codes == len(self.labels)).any())
        return self._has_null

    def _null_rows(self, codes):
        """The null rows among ``codes`` (a tensor), None where none can be."""
        if not self.has_null:
            return None
        null = codes == len(self.labels)
        if self.labels.null_count:
            table = torch.as_tensor(np.append(np.asarray(self.labels.is_null()), True))
            null = null | table.to(codes.device).index_select(0, codes)
        return null

    def tile(self, i1, i2, device=None):
        codes = self.codes[i1:i2]
        if device is not None:
            codes = codes.to(device)
        return DictNA(codes, self._null_rows(codes), self.labels)

    def __getitem__(self, item):
        """Rows as a host ``pyarrow.DictionaryArray`` (null rows null)."""
        import pyarrow as pa
        codes = self.host_codes[item]
        null = codes == len(self.labels)
        indices = pa.array(np.where(null, 0, codes), mask=null if null.any() else None,
                           type=pa.int32())
        return pa.DictionaryArray.from_arrays(indices, self.labels)

    def take(self, index, mask=None):
        codes = self.codes.index_select(0, index.to(self.codes.device))
        if mask is not None:
            codes = codes.masked_fill(mask.to(codes.device), len(self.labels))
        return ColumnDictionary(codes, self.labels)

    def trim(self, i1, i2):
        return ColumnDictionary(self.codes[i1:i2], self.labels,
                                None if self._host_codes is None else self._host_codes[i1:i2])

    def to(self, device):
        return ColumnDictionary(self.codes.to(device), self.labels, self._host_codes,
                                self._has_null)

    def fingerprint(self):
        return fingerprint("column-dictionary", _sampled(self.codes),
                           _arrow_fingerprint(self.labels))


STRINGS = (ColumnString, ColumnDictionary)
# vaex_tpu's name of a string column staged on a device
ColumnDeviceDictionary = ColumnDictionary


def take_column(col, index, mask=None):
    """``col`` at ``index`` (missing where ``mask``): a lazy
    :class:`ColumnIndexed`, or for strings a column of the same kind: the
    codes taken on their device, a host column's rows on the host."""
    if isinstance(col, STRINGS):
        return col.take(index, mask)
    return ColumnIndexed.index_of(col, index, mask)


def concat_columns(columns):
    """The rows of ``columns`` one after another: a lazy
    :class:`ColumnConcatenated`; of strings staged on one device a
    :class:`ColumnDictionary` over one sorted dictionary of all their labels
    (:func:`merged_dictionary`), of other strings one host column joined on
    the host."""
    if all(isinstance(c, ColumnDictionary) for c in columns) and len(
            {c.device for c in columns}) == 1:
        return merged_dictionary(columns)
    if any(isinstance(c, STRINGS) for c in columns):
        return ColumnString(array_types.concat(
            [c[:] if isinstance(c, STRINGS) else c for c in columns]))
    return ColumnConcatenated(columns)


def merged_dictionary(columns):
    """Staged string columns one after another over one sorted dictionary of
    their labels: each column's codes re-coded on its device through a
    small table of its labels' places in the merged ones (its null code to
    the merged null code), gathered by code; nothing goes to the host but
    the labels."""
    import pyarrow as pa
    import pyarrow.compute as pc
    labels = pa.concat_arrays([c.labels.cast(pa.string()) for c in columns])
    merged = pc.array_sort_indices(pc.unique(labels.drop_null()))
    merged = pc.take(pc.unique(labels.drop_null()), merged)
    parts = []
    for c in columns:
        places = np.asarray(pc.index_in(c.labels.cast(pa.string()), value_set=merged)
                            .fill_null(len(merged)), np.int32)
        table = torch.from_numpy(np.append(places, np.int32(len(merged)))).to(c.device)
        parts.append(table.index_select(0, c.codes.to(torch.int64)))
    return ColumnDictionary(torch.cat(parts), merged)


def placed_device(col):
    """The device of a column held in tensors; None for host arrays."""
    if isinstance(col, torch.Tensor):
        return col.device
    if isinstance(col, LAZY + (ColumnDictionary,)):
        return col.device
    return None


def column_device(col):
    """The device a column's rows live on (host arrays: the CPU)."""
    return placed_device(col) or CPU


def slice_column(col, i1, i2):
    """Rows [i1, i2) of a column as a column of the same kind (views); of a
    keyed column one keyed by its key and the rows."""
    out = col.trim(i1, i2) if isinstance(col, LAZY + STRINGS + (ColumnVirtualRange, ColumnHost)) \
        else col[i1:i2]
    known = registered_key(col)
    if known is not None and out is not col:
        keyed(out, ("rows", known[0], i1, i2), known[1])
    return out


def tile_of(col, i1, i2, device=None) -> NA:
    """Rows [i1, i2) of any column as an NA of tensors on ``device`` (the
    column's own device when None): a tensor's rows are a view, a host
    array's are copied (a datetime or timedelta as its int64 count)."""
    if isinstance(col, torch.Tensor):
        part = NA(col[i1:i2])
    elif isinstance(col, ColumnDictionary):
        return col.tile(i1, i2, device)
    elif isinstance(col, ColumnString):
        raise TypeError("a column of strings on the host is read in the host stage of a pass")
    elif isinstance(col, LAZY):
        part = col[i1:i2]
    elif isinstance(col, ColumnVirtualRange):
        return NA(col.tile(i1, i2, device or CPU))
    else:
        data, mask = array_types.data_and_mask(col[i1:i2])
        part = NA(array_types.to_tensor(data, CPU),
                  None if mask is None else torch.as_tensor(np.asarray(mask)))
    if device is None:
        return part
    return NA(part.data.to(device), None if part.mask is None else part.mask.to(device))


def gather(col, index) -> NA:
    """The rows of a column at an int tensor ``index`` (no negative
    entries) as an NA on the column's device (the CPU for a host array)."""
    if isinstance(col, torch.Tensor):
        return NA(col.index_select(0, index.to(col.device)))
    if isinstance(col, LAZY):
        return col.take(index)
    if isinstance(col, ColumnDictionary):
        taken = col.take(index)
        return taken.tile(0, len(taken))
    if isinstance(col, ColumnVirtualRange):
        return NA(col.values_at(index))
    data, mask = array_types.data_and_mask(col[index.cpu().numpy()])
    return NA(array_types.to_tensor(data, CPU),
              None if mask is None else torch.as_tensor(np.asarray(mask)))


def column_to(col, device):
    """A column staged on ``device`` where torch can hold its values: a
    tensor moves, an array of a torch dtype becomes a tensor and a masked
    one a :class:`ColumnMasked`; the lazy columns move their tensors; any
    other column (uint16, uint32, a constant) stays on the host."""
    if isinstance(col, torch.Tensor):
        return col.to(device)
    if isinstance(col, LAZY + STRINGS):
        return col.to(device)
    if isinstance(col, ColumnHost) and has_torch_dtype(col.dtype):
        col = col[:]  # read whole, as to_device reads a host array whole
    if not isinstance(col, np.ndarray) or not has_torch_dtype(dtype_of(col).numpy):
        return col
    data, mask = array_types.data_and_mask(col)
    data = array_types.to_tensor(data, device)
    if mask is None:
        return data
    return ColumnMasked(data, torch.as_tensor(np.asarray(mask)).to(device))


def column_fingerprint(col):
    """A content hash of a column: its own for the lazy types, else a hash of
    its head, a strided sample and its tail, so that a device column costs a
    few small copies, not a full read; a keyed column (:func:`keyed`) a
    hash of its key."""
    known = registered_key(col)
    if known is not None:
        return fingerprint("keyed", known[0])
    if isinstance(col, LAZY + STRINGS + (ColumnVirtualConstant, ColumnVirtualRange)):
        return col.fingerprint()
    n = len(col)
    if n == 0:
        return hash_array_data(np.empty(0)) + "-n0"
    parts = [hash_array_data(array_types.to_numpy(col[:min(1000, n)]))]
    if n > 2000:
        step = max(1, n // 2048)
        parts.append(hash_array_data(array_types.to_numpy(col[::step])))
        parts.append(hash_array_data(array_types.to_numpy(col[n - 1000:n])))
    return fingerprint("col-sampled", parts) + f"-n{n}"


def column_key(col):
    """(an exact key of a column's values, whether it is a content key), or
    (None, False) where there is none: a CPU tensor or a host array by a
    hash of all its bytes (:func:`.utils.tensor_key`), a card tensor none,
    an arrow array by all its buffers, a lazy column by its parts (none
    where a part has none).  Unlike :func:`column_fingerprint` it never
    samples.  A column read from a file gives the key :func:`keyed` gave
    it, and reads nothing."""
    known = registered_key(col)
    if known is not None:
        return known
    if isinstance(col, torch.Tensor):
        return tensor_key(col)
    if isinstance(col, (np.ndarray, np.ma.MaskedArray)):
        return ("array", hash_array_data(col)), True
    if isinstance(col, ColumnString):
        return ("strings", col.fingerprint()), True
    if isinstance(col, (ColumnVirtualConstant, ColumnVirtualRange)):
        return col.fingerprint(), True
    fixed = ()  # what besides its parts decides the values
    if isinstance(col, ColumnDictionary):
        parts, fixed = [col.codes], _arrow_fingerprint(col.labels)
    elif isinstance(col, ColumnMasked):
        parts = [col.data, col.mask]
    elif isinstance(col, ColumnIndexed):
        parts = [col.source, col.index, col.mask]
    elif isinstance(col, ColumnConcatenated):
        parts = col.columns
    elif isinstance(col, LazyColumn) and hasattr(col, "key_parts"):
        parts, fixed = col.key_parts()
    else:  # an object no content hash covers: its identity
        return ("object", identity(col)), False
    keys = [("none", True) if p is None else column_key(p) for p in parts]
    if any(k is None for k, _ in keys):
        return None, False
    return (type(col).__name__, fixed, [k for k, _ in keys]), all(c for _, c in keys)


def is_masked(col):
    """True for a column that holds a mask of missing rows: a masked array,
    a :class:`ColumnMasked`, an indexed column with a mask or over a masked
    source, a concatenation with a masked part."""
    if isinstance(col, (np.ma.MaskedArray, ColumnMasked)):
        return True
    if isinstance(col, ColumnIndexed):
        return col.mask is not None or is_masked(col.source)
    if isinstance(col, ColumnConcatenated):
        return any(is_masked(c) for c in col.columns)
    if isinstance(col, LazyColumn):
        return col.is_masked
    if isinstance(col, ColumnString):
        return col.null_count > 0
    if isinstance(col, ColumnDictionary):
        return col.has_null
    if isinstance(col, ColumnHost):
        return col.masked
    return False

"""Columnar storage: an immutable Mapping name -> column with a row count.

The counterpart of ``vaex_tpu/dataset.py`` for in-memory columns: numpy
arrays, numpy masked arrays, torch tensors and the lazy columns of
:mod:`.column`.  Slicing makes a new node of views.  The decorator nodes
``renamed``, ``merged``, ``dropped`` and ``project`` (what
``DataFrame.rename``, ``add_column``, a shadowed column and a join need)
share the columns of their parents and keep their ``device`` and
``logical`` dtypes.  The row nodes ``take`` (rows at an index tensor, some
masked), ``filtered`` (the rows of a bool mask) and ``concat`` (datasets one
after another, their common columns) read their parents' columns through
:class:`~.column.ColumnIndexed` and :class:`~.column.ColumnConcatenated`;
they copy nothing (vaex_tpu/dataset.py:151-175, 342-442).  Each node has a
fingerprint and a ``remembered`` of its own.

``chunk_iterator`` yields a node's rows a chunk at a time, each column's
chunk as the column holds it (a host array's rows for a host column, a
tensor view for a tensor column): what a streamed pass reads
(:mod:`.stream`).  :class:`DatasetFile` is the base of the nodes over a
file (:mod:`.io`): each column is keyed by the file (:func:`.column.keyed`),
and :meth:`DatasetFile.hashed` keys them by their content instead, through
a sidecar ``<path>.d/hashes.yaml`` (vaex_tpu/dataset.py:103-120, 445-521).
"""

from __future__ import annotations

import collections.abc
import copy
import os
from typing import Dict

import numpy as np
import torch

from . import array_types
from .column import (STRINGS, ColumnHost, ColumnString, _masked_indices, column_device,
                     column_fingerprint, column_key, concat_columns, file_identity, keyed,
                     slice_column, take_column)
from .datatype import DataType, dtype_of, needs_logical
from .utils import fingerprint, hash_array_data


class Dataset(collections.abc.Mapping):
    def __init__(self):
        self._columns = {}
        self._row_count = 0
        self._ids = {}
        self._fingerprint = None
        # the numpy dtype of the columns held as int64 tensors of another
        # meaning (datetime64, timedelta64, uint16, uint32, uint64), whether
        # as a numpy array or as the tensor
        self.logical = {}
        # facts derived from the columns' content (a key's range, a filter's
        # row count), kept for the life of the node by whoever derives them
        self.remembered = {}
        # the device the columns were staged to (DataFrame.to_device) or the
        # pass that made them ran on; None for arrays no one placed
        self.device = None

    def __getitem__(self, name):
        return self._columns[name]

    def __iter__(self):
        return iter(self._columns)

    def __len__(self):
        return len(self._columns)

    @property
    def row_count(self) -> int:
        return self._row_count

    def fingerprint(self) -> str:
        """Content fingerprint, computed once: nodes are immutable."""
        if self._fingerprint is None:
            self._fingerprint = self._compute_fingerprint()
        return self._fingerprint

    def _compute_fingerprint(self) -> str:
        raise NotImplementedError

    def _column_fingerprint(self, name) -> str:
        """Sampled content hash (:func:`.column.column_fingerprint`)."""
        if name not in self._ids:
            self._ids[name] = fingerprint("column", column_fingerprint(self._columns[name]),
                                          str(dtype_of(self._columns[name])),
                                          str(self.logical.get(name)))
        return self._ids[name]

    def cache_key(self, names=None):
        """(an exact key of the columns ``names`` (all by default), whether
        it is a content key): :func:`.column.column_key` of each, its
        logical dtype and the row count; (None, False) where a column has
        no exact key (a card tensor)."""
        keys = {name: column_key(self._columns[name])
                for name in sorted(self if names is None else names)}
        if any(k is None for k, _ in keys.values()):
            return None, False
        return (("dataset", self.row_count, {n: k for n, (k, _) in keys.items()},
                 {n: str(self.logical.get(n)) for n in keys}),
                all(content for _, content in keys.values()))

    def close(self):
        """Nothing to release: the columns are in memory (vaex_tpu/dataset.py:178)."""

    def shallow_copy(self):
        """The node itself: nodes are immutable (vaex_tpu/dataset.py:175)."""
        return self

    def dtypes(self):
        """Each column's DataType (vaex_tpu/dataset.py:62), a logical one
        where an int64 tensor stands for another dtype."""
        return {name: DataType(self.logical[name]) if name in self.logical else dtype_of(col)
                for name, col in self._columns.items()}

    def renamed(self, renaming) -> "Dataset":
        return DatasetRenamed(self, renaming)

    def merged(self, other) -> "Dataset":
        return DatasetMerged(self, other)

    def dropped(self, *names) -> "Dataset":
        return DatasetDropped(self, names)

    def project(self, *names) -> "Dataset":
        """Only the columns ``names``."""
        drop = [n for n in self if n not in names]
        return self.dropped(*drop) if drop else self

    def slice(self, start, end) -> "Dataset":
        if start == 0 and end == self.row_count:
            return self
        return DatasetSliced(self, start, end)

    def take(self, indices, mask=None, origin=None, masked=False) -> "Dataset":
        """The rows at ``indices`` (host ints or an int tensor), missing where
        ``mask`` is True; ``origin`` names what made the indices (see
        :class:`DatasetTake`).  With ``masked`` the indices are a numpy
        masked array whose masked entries are missing rows, vaex_tpu's form
        (vaex_tpu/dataset.py:160)."""
        return DatasetTake(self, indices, mask, origin, masked)

    def filtered(self, mask, origin=None) -> "Dataset":
        """The rows where the bool ``mask`` (a tensor or an array) is True."""
        return DatasetFiltered(self, mask, origin)

    def concat(self, *others) -> "Dataset":
        datasets = []
        for ds in (self,) + others:
            datasets.extend(ds.datasets if isinstance(ds, DatasetConcatenated) else [ds])
        return DatasetConcatenated(datasets)

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        """Yield ``(i1, i2, {name: rows [i1, i2) of the column})`` over the
        rows in chunks of ``chunk_size`` (1 << 20 by default), last first
        with ``reverse``; each chunk as :func:`.column.slice_column` gives it
        (a host array's rows, a tensor view, a lazy column's trim).  An
        empty node yields one empty chunk (vaex_tpu/dataset.py:103-120)."""
        chunk_size = chunk_size or 1 << 20
        n = self.row_count
        starts = range(0, max(n, 1), chunk_size)
        for i1 in (reversed(starts) if reverse else starts):
            i2 = min(i1 + chunk_size, n)
            yield i1, i2, {name: slice_column(self._columns[name], i1, i2) for name in columns}


def index_tensor(indices, n):
    """Row indices as an int tensor: a tensor as it is; host ints (a
    negative one counts from the end, as numpy's) as int64 on the CPU,
    checked against the ``n`` rows."""
    if isinstance(indices, torch.Tensor):
        return indices
    indices = np.array(indices, dtype=np.int64).reshape(-1)  # a copy the caller cannot change
    low = indices.min() if len(indices) else 0
    if len(indices) and (low < -n or indices.max() >= n):
        raise IndexError(f"row indices out of range for {n} rows")
    return torch.from_numpy(np.where(indices < 0, indices + n, indices) if low < 0 else indices)


class DatasetArrays(Dataset):
    """In-memory dict of columns."""

    def __init__(self, columns: Dict[str, object], logical=None, device=None):
        super().__init__()
        # strings (arrow arrays, numpy arrays of str) are host string columns
        self._columns = {name: ColumnString(col) if not isinstance(col, STRINGS) and (
            array_types.is_arrow(col) or array_types.is_string_array(col)) else col
            for name, col in columns.items()}
        self.device = None if device is None else torch.device(device)
        self.logical = {name: np.dtype(dt) for name, dt in (logical or {}).items()
                        if name in self._columns}
        for name, col in self._columns.items():
            if isinstance(col, (np.ndarray, ColumnHost)) and needs_logical(col.dtype):
                self.logical[name] = col.dtype
        lengths = {name: len(col) for name, col in self._columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"columns have unequal lengths: {lengths}")
        self._row_count = next(iter(lengths.values()), 0)

    def _compute_fingerprint(self) -> str:
        return fingerprint("dataset-arrays",
                           {name: self._column_fingerprint(name) for name in self._columns})


class DatasetSliced(DatasetArrays):
    """Rows [start, end) of ``original``: each column's slice, a view
    where the column has one (vaex_tpu/dataset.py:280-316)."""

    def __init__(self, original, start, end):
        super().__init__({name: slice_column(col, start, end)
                          for name, col in original._columns.items()},
                         original.logical, original.device)
        self.original, self.start, self.end = original, start, end


class _Decorator(Dataset):
    """A node over the columns of ``original``."""

    def __init__(self, original, columns):
        super().__init__()
        self.original = original
        self._columns = columns
        self._row_count = original.row_count
        self.device = original.device


class DatasetRenamed(_Decorator):
    def __init__(self, original, renaming):
        self.renaming = dict(renaming)
        super().__init__(original, {self.renaming.get(name, name): col
                                    for name, col in original._columns.items()})
        self.logical = {self.renaming.get(name, name): dt
                        for name, dt in original.logical.items()}

    def _compute_fingerprint(self):
        return fingerprint("dataset-renamed", self.original.fingerprint(), self.renaming)

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        back = {new: old for old, new in self.renaming.items()}
        for i1, i2, chunks in self.original.chunk_iterator([back.get(n, n) for n in columns],
                                                           chunk_size, reverse):
            yield i1, i2, {name: chunks[back.get(name, name)] for name in columns}


class DatasetDropped(_Decorator):
    def __init__(self, original, names):
        self.names = tuple(names)
        super().__init__(original, {name: col for name, col in original._columns.items()
                                    if name not in self.names})
        self.logical = {name: dt for name, dt in original.logical.items()
                        if name not in self.names}

    def _compute_fingerprint(self):
        return fingerprint("dataset-dropped", self.original.fingerprint(), self.names)

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        missing = [n for n in columns if n not in self._columns]
        if missing:
            raise KeyError(f"column(s) {missing} are not in the dataset")
        return self.original.chunk_iterator(columns, chunk_size, reverse)


class DatasetMerged(Dataset):
    """The columns of two datasets of one length side by side."""

    def __init__(self, left, right):
        super().__init__()
        if left.row_count != right.row_count:
            raise ValueError(f"row counts differ: {left.row_count} vs {right.row_count}")
        overlap = set(left) & set(right)
        if overlap:
            raise NameError(f"duplicate columns: {sorted(overlap)}")
        self.left, self.right = left, right
        self._columns = {**left._columns, **right._columns}
        self._row_count = left.row_count
        self.logical = {**left.logical, **right.logical}
        self.device = left.device if left.device is not None else right.device

    def _compute_fingerprint(self):
        return fingerprint("dataset-merged", self.left.fingerprint(), self.right.fingerprint())

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        """The chunks of both sides, side by side: each side chunks its rows
        alike."""
        left = [n for n in columns if n in self.left]
        right = [n for n in columns if n not in self.left]
        sides = zip(self.left.chunk_iterator(left, chunk_size, reverse),
                    self.right.chunk_iterator(right, chunk_size, reverse))
        for (i1, i2, a), (j1, j2, b) in sides:
            if (i1, i2) != (j1, j2):
                raise ValueError(f"the sides of a merge chunk apart: {(i1, i2)} vs {(j1, j2)}")
            yield i1, i2, {**a, **b}


def _content(t):
    """A hash of a host tensor's values, of a sample of a device tensor's."""
    return hash_array_data(t.numpy()) if t.device.type == "cpu" else column_fingerprint(t)


class DatasetTake(_Decorator):
    """The rows of ``original`` at ``indices``, missing where ``mask`` is
    True, each column a :class:`~.column.ColumnIndexed` whose index lies on
    the column's device (a take of a take is one hop).  The fingerprint never
    reads a device index: it hashes ``origin``, what made the indices (the
    parents of a join and its arguments, a frame's filter), or else the host
    indices a caller gave, or a sample of a tensor's."""

    def __init__(self, original, indices, mask=None, origin=None, masked=False):
        if masked:
            indices, mask = _masked_indices(indices)
        indices = index_tensor(indices, original.row_count)
        mask = None if mask is None else torch.as_tensor(mask)
        super().__init__(original, {})
        self.masked = mask is not None
        self.origin = origin if origin is not None else (
            _content(indices), None if mask is None else _content(mask))
        on = {}  # the index (and mask) moved once per device
        for name, col in original._columns.items():
            device = column_device(col)
            if device not in on:
                on[device] = (indices.to(device), None if mask is None else mask.to(device))
            self._columns[name] = take_column(col, *on[device])
        self._row_count = indices.shape[0]
        self.logical = dict(original.logical)

    def _compute_fingerprint(self):
        return fingerprint("dataset-take", self.original.fingerprint(), self.origin,
                           self.masked)


class DatasetFiltered(DatasetTake):
    """The rows of ``original`` where the bool ``mask`` is True: a take of
    the mask's ``torch.nonzero``, on the mask's device."""

    def __init__(self, original, mask, origin=None):
        mask = torch.as_tensor(mask)
        if mask.shape != (original.row_count,):
            raise ValueError(f"a filter of {tuple(mask.shape)} rows over {original.row_count}")
        indices = torch.nonzero(mask).squeeze(1)
        if original.row_count < 2 ** 31:
            indices = indices.to(torch.int32)
        super().__init__(original, indices, origin=("filtered", origin if origin is not None
                                                    else _content(mask)))


class DatasetConcatenated(Dataset):
    """The rows of ``datasets`` one after another, over the columns that
    all of them have, in the first one's order (vaex_tpu/dataset.py:384-442)."""

    def __init__(self, datasets):
        super().__init__()
        self.datasets = list(datasets)
        names = [n for n in self.datasets[0] if all(n in ds for ds in self.datasets[1:])]
        self._columns = {name: concat_columns([ds._columns[name] for ds in self.datasets])
                         for name in names}
        self._row_count = sum(ds.row_count for ds in self.datasets)
        self.logical = {n: dt for n, dt in self.datasets[0].logical.items() if n in self._columns}
        self.device = self.datasets[0].device

    def _compute_fingerprint(self):
        return fingerprint("dataset-concat", [ds.fingerprint() for ds in self.datasets])

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        """The parts' chunks one after another, joined across a part's end
        so that every chunk but the last has ``chunk_size`` rows: each part
        streams its own way (a parquet file by its row groups)."""
        chunk_size = chunk_size or 1 << 20
        if reverse or self.row_count == 0 or not columns:
            yield from Dataset.chunk_iterator(self, columns, chunk_size, reverse)
            return
        pending, held, offset = [], 0, 0
        for ds in self.datasets:
            for _, _, chunks in ds.chunk_iterator(columns, chunk_size):
                pending.append(chunks)
                held += _rows(chunks, columns)
                while held >= chunk_size:
                    chunks, pending, held = _split(pending, columns, chunk_size, held)
                    yield offset, offset + chunk_size, chunks
                    offset += chunk_size
        if held:
            chunks, _, _ = _split(pending, columns, held, held)
            yield offset, offset + held, chunks


def _rows(chunks, columns):
    return len(chunks[columns[0]])


def _split(pending, columns, n, held):
    """(the first ``n`` rows of the pending chunks as one chunk, the chunks
    of the rest, their rows)."""
    first, rest, taken = [], [], 0
    for chunks in pending:
        size = _rows(chunks, columns)
        if taken >= n:
            rest.append(chunks)
        elif taken + size <= n:
            first.append(chunks)
        else:
            cut = n - taken
            first.append({c: slice_column(v, 0, cut) for c, v in chunks.items()})
            rest.append({c: slice_column(v, cut, size) for c, v in chunks.items()})
        taken += size
    joined = first[0] if len(first) == 1 else {
        c: concat_columns([ch[c] for ch in first]) for c in columns}
    return joined, rest, held - n


def _alias(col):
    """A new column object over the same values (so that it can carry a key
    of its own): a view of an array, a new wrapper of the rest."""
    if isinstance(col, np.ndarray):
        return col.view()
    if isinstance(col, ColumnString):
        return ColumnString(col.array)
    if isinstance(col, ColumnHost):
        return col.trim(0, len(col))
    raise TypeError(f"cannot alias a column of {type(col).__name__}")


class DatasetFile(DatasetArrays):
    """The columns of one file (vaex_tpu/dataset.py:445-521): host arrays
    (a memory map of the file where the format allows), arrow strings, or
    :class:`~.column.ColumnHost` columns that read the file a slice at a
    time.  ``identity`` (:func:`.column.file_identity`, taken from the file
    the columns were read or mapped from) keys every column
    (:func:`.column.keyed`): the result cache never hashes a file's bytes,
    and a file replaced under its name (a new inode, a new size or time) is
    a new key."""

    def __init__(self, path, identity=None):
        super().__init__({})
        self.path = str(path)
        self.identity = identity if identity is not None else file_identity(path)

    def add_column(self, name, column):
        """Add ``column`` under ``name``, keyed by the file and the name."""
        column = DatasetArrays({name: column})._columns[name]
        if len(self._columns) and len(column) != self._row_count:
            raise ValueError(f"column {name!r} has {len(column)} rows, not {self._row_count}")
        keyed(column, self.identity + (name, str(dtype_of(column).internal), len(column)))
        self._columns[name] = column
        self._row_count = len(column)
        if isinstance(column, (np.ndarray, ColumnHost)) and needs_logical(column.dtype):
            self.logical[name] = np.dtype(column.dtype)

    def _compute_fingerprint(self):
        return fingerprint("dataset-file", self.identity, sorted(self._columns))

    # the content hashes and their sidecar (vaex_tpu/dataset.py:467-521)
    def _sidecar(self):
        return os.path.join(f"{self.path}.d", "hashes.yaml")

    def _stamp(self):
        """What the sidecar must match: the file's size, modification time
        and inode as this node opened it."""
        return {"size": self.identity[4], "mtime_ns": self.identity[5], "inode": self.identity[3]}

    def _read_hashes(self):
        import yaml
        try:
            with open(self._sidecar()) as f:
                data = yaml.safe_load(f) or {}
        except FileNotFoundError:
            return {}
        if any(data.get(k) != v for k, v in self._stamp().items()):
            return {}  # another file under the name: every hash is stale
        return dict(data.get("columns") or {})

    def _write_hashes(self, hashes):
        import yaml
        os.makedirs(f"{self.path}.d", exist_ok=True)
        tmp = f"{self._sidecar()}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            yaml.safe_dump({**self._stamp(), "columns": dict(hashes)}, f)
        os.replace(tmp, self._sidecar())

    def hashed(self):
        """A copy whose columns are keyed by a hash of all their values, a
        content key, which the disk level of the result cache keeps and
        which survives a reopen: each hash is computed once per file and
        kept in ``<path>.d/hashes.yaml`` (written only where the directory
        can be; the hashes serve this process all the same)."""
        hashes = self._read_hashes()
        missing = [name for name in self._columns if name not in hashes]
        for name in missing:
            col = self._columns[name]
            if isinstance(col, ColumnString):
                hashes[name] = col.fingerprint()
            else:
                hashes[name] = hash_array_data(col[:] if isinstance(col, ColumnHost) else col)
        if missing:
            try:
                self._write_hashes(hashes)
            except OSError:
                pass
        ds = copy.copy(self)
        ds._columns = {name: keyed(_alias(col), ("hash", hashes[name]), True)
                       for name, col in self._columns.items()}
        ds.logical = dict(self.logical)
        ds.remembered, ds._ids = {}, {}
        ds._fingerprint = fingerprint("dataset-file-hashed", sorted(hashes.items()))
        return ds

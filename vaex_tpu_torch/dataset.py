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
fingerprint and a ``remembered`` of its own.  File nodes are not ported yet.
"""

from __future__ import annotations

import collections.abc
from typing import Dict

import numpy as np
import torch

from . import array_types
from .column import (STRINGS, ColumnString, column_device, column_fingerprint, column_key,
                     concat_columns, slice_column, take_column)
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
        logical dtype and the row count."""
        keys = {name: column_key(self._columns[name])
                for name in sorted(self if names is None else names)}
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
        return DatasetArrays({name: slice_column(col, start, end)
                              for name, col in self._columns.items()}, self.logical, self.device)

    def take(self, indices, mask=None, origin=None) -> "Dataset":
        """The rows at ``indices`` (host ints or an int tensor), missing where
        ``mask`` is True; ``origin`` names what made the indices (see
        :class:`DatasetTake`)."""
        return DatasetTake(self, indices, mask, origin)

    def filtered(self, mask, origin=None) -> "Dataset":
        """The rows where the bool ``mask`` (a tensor or an array) is True."""
        return DatasetFiltered(self, mask, origin)

    def concat(self, *others) -> "Dataset":
        datasets = []
        for ds in (self,) + others:
            datasets.extend(ds.datasets if isinstance(ds, DatasetConcatenated) else [ds])
        return DatasetConcatenated(datasets)


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
            if isinstance(col, np.ndarray) and needs_logical(col.dtype):
                self.logical[name] = col.dtype
        lengths = {name: len(col) for name, col in self._columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"columns have unequal lengths: {lengths}")
        self._row_count = next(iter(lengths.values()), 0)

    def _compute_fingerprint(self) -> str:
        return fingerprint("dataset-arrays",
                           {name: self._column_fingerprint(name) for name in self._columns})


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


class DatasetDropped(_Decorator):
    def __init__(self, original, names):
        self.names = tuple(names)
        super().__init__(original, {name: col for name, col in original._columns.items()
                                    if name not in self.names})
        self.logical = {name: dt for name, dt in original.logical.items()
                        if name not in self.names}

    def _compute_fingerprint(self):
        return fingerprint("dataset-dropped", self.original.fingerprint(), self.names)


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

    def __init__(self, original, indices, mask=None, origin=None):
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

"""Columnar storage: an immutable Mapping name -> column with a row count.

The counterpart of ``vaex_tpu/dataset.py`` for in-memory columns: numpy
arrays, numpy masked arrays and torch tensors.  Slicing makes a new node of
views; the decorator nodes of the reference (renamed, merged, take, concat,
filtered, files) are not ported yet.
"""

from __future__ import annotations

import collections.abc
from typing import Dict

import numpy as np
import torch

from . import array_types
from .datatype import dtype_of
from .utils import fingerprint, hash_array_data


class Dataset(collections.abc.Mapping):
    def __init__(self):
        self._columns = {}
        self._row_count = 0
        self._ids = {}
        self._fingerprint = None
        # the numpy datetime64 / timedelta64 dtype of the columns that hold
        # one, whether as a numpy array or as an int64 tensor
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
        """Sampled content hash: head + strided middle + tail + length, so
        that a device column costs a few small copies, not a full read."""
        if name in self._ids:
            return self._ids[name]
        col = self._columns[name]
        n = len(col)
        if n == 0:
            fp = hash_array_data(np.empty(0)) + "-n0"
        else:
            parts = [hash_array_data(array_types.to_numpy(col[:min(1000, n)]))]
            if n > 2000:
                step = max(1, n // 2048)
                parts.append(hash_array_data(array_types.to_numpy(col[::step])))
                parts.append(hash_array_data(array_types.to_numpy(col[n - 1000:n])))
            fp = fingerprint("col-sampled", parts, str(dtype_of(col)),
                             str(self.logical.get(name))) + f"-n{n}"
        self._ids[name] = fp
        return fp

    def slice(self, start, end) -> "Dataset":
        if start == 0 and end == self.row_count:
            return self
        return DatasetArrays({name: col[start:end]
                              for name, col in self._columns.items()}, self.logical, self.device)


class DatasetArrays(Dataset):
    """In-memory dict of columns."""

    def __init__(self, columns: Dict[str, object], logical=None, device=None):
        super().__init__()
        self._columns = dict(columns)
        self.device = None if device is None else torch.device(device)
        self.logical = {name: np.dtype(dt) for name, dt in (logical or {}).items()
                        if name in self._columns}
        for name, col in self._columns.items():
            if isinstance(col, np.ndarray) and col.dtype.kind in "Mm":
                self.logical[name] = col.dtype
        lengths = {name: len(col) for name, col in self._columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"columns have unequal lengths: {lengths}")
        self._row_count = next(iter(lengths.values()), 0)

    def _compute_fingerprint(self) -> str:
        return fingerprint("dataset-arrays",
                           {name: self._column_fingerprint(name) for name in self._columns})

"""Columns.

A column is anything sliceable with ``__len__``, ``__getitem__`` (slice ->
array) and a ``dtype``: numpy arrays, numpy masked arrays and torch tensors
(on the CPU or a CUDA device) qualify, and :class:`ColumnVirtualConstant`,
the scalar column of ``DataFrame.add_column``.  The other lazy column types
of ``vaex_tpu/column.py`` (virtual ranges, takes, concatenations) are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def column_device(col):
    """The device a column's rows live on (host arrays: the CPU)."""
    return col.device if isinstance(col, torch.Tensor) else torch.device("cpu")


class ColumnVirtualConstant:
    """``length`` rows of one value (vaex_tpu/column.py:72-99): a slice is a
    host array of it, made when a tile needs it."""

    def __init__(self, value, length, dtype=None):
        self.value = value
        self.length = length
        self.dtype = np.dtype(dtype) if dtype is not None else np.asarray(value).dtype

    def __len__(self):
        return self.length

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            n = len(range(start, stop, step))
        else:
            n = len(np.asarray(item))
        return np.full(n, self.value, dtype=self.dtype)

    def fingerprint(self):
        return f"vconstant-{self.value!r}-{self.length}-{self.dtype}"

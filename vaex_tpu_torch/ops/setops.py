"""Sorted sets of observed values, and their probes inside a pass.

The counterpart of ``vaex_tpu/ops/setops.py`` for numeric keys: a "set" is a
sorted array of the unique keys without NaN and null, which take the
trailing ordinals ``[0, n_keys)`` = keys, then NaN (if any), then null (if
any).  Ordinals are positions in the sorted order, so ``sort=True`` is the
natural order of every set-based grouper.

A set built by a pass (:class:`vaex_tpu_torch.tasks.TaskSetCreate`) keeps its
keys as a tensor on the pass device; the host copy is made when ``keys`` is
first read.  Inside a pass :func:`device_map_ordinal` and :func:`device_isin`
probe a :class:`DeviceSetHandle` through kernel B6 (:mod:`.probe`), which
walks a search tree built once per set: wholly in shared memory while it
fits (``b6``), its top levels there and the rest in global memory past that
(``b6-wide``).

String, arrow and dictionary keys wait for the host scope (ROADMAP queue A3)
and raise; ``SortedIndex`` waits for ``join.py`` (queue A8).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import array_types
from ..datatype import NAT, torch_dtype
from ..utils import fingerprint
from . import probe as probe_module
from .nullable import NA

STRINGS_PENDING = ("sets of string keys are not ported yet: they wait for the host scope "
                   "(ROADMAP queue A3)")


class RowLimitException(Exception):
    """Raised when a set grows past its row limit."""


def _is_float(dtype):
    return np.dtype(dtype).kind == "f"


def _sorted_unique(data, return_counts):
    """The sorted distinct values of a NaN-free array and, when asked, their
    counts: one sort and one compare of neighbours (``np.unique`` of numpy
    2.3 hashes every value first, which for a list of ids costs many times
    the sort)."""
    data = np.sort(data, axis=None)
    if len(data) == 0:
        return data, (np.empty(0, np.int64) if return_counts else None)
    first = np.concatenate([[True], data[1:] != data[:-1]])
    if not return_counts:
        return data[first], None
    starts = np.flatnonzero(first)
    return data[first], np.diff(np.append(starts, len(data))).astype(np.int64)


def _merge(keys, counts, other_keys, other_counts):
    """Two sorted unique key arrays (and their counts, or None) merged."""
    if len(keys) == 0:
        return other_keys, other_counts
    if len(other_keys) == 0:
        return keys, counts
    merged = np.concatenate([keys, other_keys])
    if counts is None:
        return np.unique(merged), None
    uniq, inverse = np.unique(merged, return_inverse=True)
    out = np.zeros(len(uniq), np.int64)
    np.add.at(out, inverse, np.concatenate([counts, other_counts]))
    return uniq, out


class SortedSet:
    """Sorted unique keys plus NaN and null slots; with ``keep_counts`` also
    the number of rows of each."""

    def __init__(self, dtype, keep_counts=False, limit=None):
        if dtype == "string" or np.dtype(dtype).kind in "OUS":
            raise NotImplementedError(STRINGS_PENDING)
        self.dtype = np.dtype(dtype)
        self.keep_counts = keep_counts
        self.limit = limit
        self.nan_count = 0
        self.null_count = 0
        self._keys = np.empty(0, self.dtype)  # host copy; None until first read
        self._counts = np.empty(0, np.int64) if keep_counts else None
        self._device_keys = None  # the keys as a tensor, where a pass left or needs them
        self._device_counts = None
        self.trees = {}  # device -> {compare dtype: B6's search tree}
        self._n_keys = 0
        self._fingerprint = None

    @classmethod
    def from_device(cls, dtype, keys, counts=None, nan_count=0, null_count=0, limit=None):
        """A set over keys a pass built (a sorted unique tensor on its
        device, NaN-free) and, for a counter, their counts."""
        oset = cls(dtype, keep_counts=counts is not None, limit=limit)
        oset._keys, oset._device_keys, oset._n_keys = None, keys, int(keys.shape[0])
        if counts is not None:
            oset._counts, oset._device_counts = None, counts
        oset.nan_count, oset.null_count = int(nan_count), int(null_count)
        oset._check_limit()
        return oset

    # -- construction -------------------------------------------------------
    def _check_limit(self):
        if self.limit is not None and self.count > self.limit:
            raise RowLimitException(f"set grew to {self.count} unique values, which exceeds "
                                    f"the limit of {self.limit}")

    def _set_host(self, keys, counts):
        self._keys, self._counts, self._n_keys = keys, counts, len(keys)
        self._device_keys = self._device_counts = self._fingerprint = None
        self.trees = {}
        self._check_limit()

    def update(self, values):
        """Merge one chunk of host values into the set."""
        data, mask = array_types.data_and_mask(values)
        if data.dtype.kind in "OUS":
            raise NotImplementedError(STRINGS_PENDING)
        if mask is not None:
            self.null_count += int(mask.sum())
            data = data[~mask]
        if _is_float(data.dtype):
            nan = np.isnan(data)
            self.nan_count += int(nan.sum())
            data = data[~nan]
        if data.dtype.kind in "Mm":  # NaT is the missing value
            nat = np.isnat(data)
            self.null_count += int(nat.sum())
            data = data[~nat]
        data = data.astype(self.dtype, copy=False)
        uniq, cnt = _sorted_unique(data, self.keep_counts)
        self._set_host(*_merge(self.keys, self.counts, uniq, cnt))

    def merge(self, other: "SortedSet"):
        self.nan_count += other.nan_count
        self.null_count += other.null_count
        self._set_host(*_merge(self.keys, self.counts, other.keys, other.counts))

    # -- introspection ------------------------------------------------------
    @property
    def keys(self):
        """The keys as a host array (copied from the device on first read)."""
        if self._keys is None:
            keys = array_types.to_numpy(self._device_keys)
            # a datetime or timedelta set holds its epoch counts on the device
            self._keys = (keys.view(self.dtype) if self.is_temporal
                          else keys.astype(self.dtype, copy=False))
        return self._keys

    @property
    def counts(self):
        if self._counts is None and self._device_counts is not None:
            self._counts = array_types.to_numpy(self._device_counts).astype(np.int64)
        return self._counts

    def device_keys(self, device):
        """The keys as a tensor on ``device``, moved there once."""
        device = torch.device(device)
        if self._device_keys is None or self._device_keys.device != device:
            source = self._device_keys if self._device_keys is not None else self.keys
            self._device_keys = array_types.to_tensor(source, device)
        return self._device_keys

    @property
    def device(self):
        """Where the keys' tensor lies; the CPU for a set built on the host."""
        return self._device_keys.device if self._device_keys is not None else torch.device("cpu")

    @property
    def n_keys(self):
        return self._n_keys

    @property
    def is_temporal(self):
        """datetime64 or timedelta64 keys: NaT rows are the missing value."""
        return self.dtype.kind in "Mm"

    @property
    def has_nan(self):
        return self.nan_count > 0

    @property
    def has_null(self):
        return self.null_count > 0

    @property
    def count(self):
        """The number of distinct values, the NaN and null slots included."""
        return self.n_keys + int(self.has_nan) + int(self.has_null)

    @property
    def nan_ordinal(self):
        return self.n_keys if self.has_nan else -1

    @property
    def null_ordinal(self):
        return self.n_keys + int(self.has_nan) if self.has_null else -1

    def key_array(self, masked=True):
        """All keys in ordinal order, NaN and null slots included; a masked
        array when there is a null slot (and ``masked``)."""
        out = np.zeros(self.count, self.dtype)
        out[:self.n_keys] = self.keys
        if self.has_nan:
            out[self.nan_ordinal] = np.nan
        if self.has_null and masked:
            mask = np.zeros(self.count, bool)
            mask[self.null_ordinal] = True
            return np.ma.MaskedArray(out, mask)
        return out

    def fingerprint(self):
        """A content hash; of a set still on the device the head, the tail,
        the sizes and a wrapping sum of the keys' bit patterns, so that
        naming a variable after it copies a few hundred keys and not the
        set."""
        if self._fingerprint is None:
            if self._keys is None:
                keys, n = self._device_keys, self.n_keys
                wide = keys.to(torch.float64 if keys.is_floating_point() else torch.int64)
                self._fingerprint = fingerprint(
                    "sorted-set-device", keys[:256], keys[max(n - 256, 0):], n,
                    int(wide.view(torch.int64).sum()), self.nan_count, self.null_count,
                    self.dtype)
            else:
                self._fingerprint = fingerprint("sorted-set", self._keys, self.nan_count,
                                                self.null_count)
        return self._fingerprint

    # -- host probes --------------------------------------------------------
    def _host_ordinals(self, data):
        if not self.n_keys:
            return np.full(len(data), -1, np.int64)
        idx = np.clip(np.searchsorted(self.keys, data), 0, self.n_keys - 1)
        return np.where(self.keys[idx] == data, idx, -1).astype(np.int64)

    def map_ordinal(self, values):
        """values -> ordinal codes on the host; unknown keys get -1."""
        data, mask = array_types.data_and_mask(values)
        codes = self._host_ordinals(data)
        if _is_float(data.dtype):
            codes = np.where(np.isnan(data), self.nan_ordinal, codes)
        if mask is not None:
            codes = np.where(mask, self.null_ordinal, codes)
        return _shrink_codes(codes, self.count)

    def isin(self, values):
        data, mask = array_types.data_and_mask(values)
        out = self._host_ordinals(data) >= 0
        if _is_float(data.dtype) and self.has_nan:
            out |= np.isnan(data)
        if mask is not None:
            out = np.where(mask, self.has_null, out)
        return out


def _shrink_codes(codes, count):
    """The narrowest signed dtype that holds ``count`` ordinals."""
    for dt in (np.int8, np.int16, np.int32):
        if count < np.iinfo(dt).max:
            return codes.astype(dt)
    return codes


# ---------------------------------------------------------------------------
# probes inside a pass


class DeviceSetHandle:
    """What a pass sees of a SortedSet: the key tensor on the pass device and
    the set's metadata.  ``route`` is the probe route taken last (``b6`` or
    ``b6-wide``), which the executor writes into ``trace_log``.  ``trees``
    keeps the search layout of B6 (:func:`.probe.build_tree`) per compare
    dtype, built at the first probe on the card: a handle made by :meth:`of`
    shares the set's, so every tile of a pass and every later pass reuse one
    build."""

    def __init__(self, keys, n_keys, has_nan, has_null, temporal=False, trees=None):
        self.keys = keys
        self.n_keys = n_keys
        self.has_nan = has_nan
        self.has_null = has_null
        self.temporal = temporal  # rows that hold NaT are missing
        self.route = None
        self.trees = {} if trees is None else trees

    @classmethod
    def of(cls, oset, device):
        keys = oset.device_keys(device)
        return cls(keys, oset.n_keys, oset.has_nan, oset.has_null, oset.is_temporal,
                   oset.trees.setdefault(keys.device, {}))

    def tree(self, dtype):
        """The search layout of the keys compared in ``dtype``."""
        if dtype not in self.trees:
            self.trees[dtype] = probe_module.build_tree(self.keys, dtype)
        return self.trees[dtype]

    @property
    def nan_ordinal(self):
        return self.n_keys if self.has_nan else -1

    @property
    def null_ordinal(self):
        return self.n_keys + int(self.has_nan) if self.has_null else -1

    @property
    def count(self):
        return self.n_keys + int(self.has_nan) + int(self.has_null)


def device_probe(handle, data):
    """Sorted keys x data -> int32 ordinals, -1 where unmatched.  CUDA
    tensors go through the kernel on the handle's tree, CPU tensors through
    its plain version, with no tree; the route recorded is the one the card
    takes."""
    dtype = probe_module.compare_dtype(handle.keys, data)
    if data.device.type == "cuda":
        tree = handle.tree(dtype)
        handle.route = tree.route
        return probe_module.probe(handle.keys, data, tree)
    handle.route = probe_module.probe_route(
        handle.n_keys, probe_module.key_bytes(handle.keys, dtype))
    return probe_module.probe(handle.keys, data)


def _missing(handle, x):
    """The rows of ``x`` that hold the missing value: masked rows and, for a
    datetime or timedelta set, NaT rows; None when there can be none."""
    if not (handle.temporal and x.data.dtype == torch.int64):
        return x.mask
    nat = x.data == NAT
    return nat if x.mask is None else nat | x.mask


def device_map_ordinal(handle: DeviceSetHandle, x: NA):
    """NA values -> int32 ordinals: NaN rows take ``nan_ordinal``, masked
    rows ``null_ordinal``, the rest the probe's ordinal or -1."""
    data = x.data
    if handle.n_keys:
        codes = device_probe(handle, data)
    else:
        codes = torch.full(data.shape, -1, dtype=torch.int32, device=data.device)
    if data.is_floating_point() and handle.has_nan:
        codes = torch.where(torch.isnan(data), handle.nan_ordinal, codes)
    missing = _missing(handle, x)
    if missing is not None:
        codes = torch.where(missing, handle.null_ordinal, codes)
    return codes.to(torch.int32)


def device_isin(handle: DeviceSetHandle, x: NA):
    data = x.data
    if handle.n_keys:
        out = device_probe(handle, data) >= 0
    else:
        out = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    if data.is_floating_point() and handle.has_nan:
        out = out | torch.isnan(data)
    missing = _missing(handle, x)
    if missing is not None:
        out = torch.where(missing, handle.has_null, out)
    return out


def choices_tensor(values, device):
    """An array variable (``map``'s choices) as a tensor on ``device``."""
    values = np.asarray(values)
    if values.dtype.kind in "OUS":
        raise NotImplementedError("mapping to string values is not ported yet: it waits for "
                                  "the host scope (ROADMAP queue A3)")
    return torch.as_tensor(values, dtype=torch_dtype(values.dtype)).to(device)

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

A set of strings (``SortedSet("string")``) keeps its keys on the host, an
object array in sorted order (code points, as arrow and pandas sort).  It is
built from arrow arrays through arrow's hash kernels, a dictionary array's
labels once per dictionary (vaex_tpu/ops/setops.py:122-205, 497-575), and
from the per-tile label counts of a pass (:meth:`SortedSet.update_counts`).
A pass probes strings as dictionary codes (:class:`.nullable.DictNA`): each
label is looked up once on the host (:meth:`SortedSet.label_ordinals`) and
the answer gathered by code on the device; the host stage probes arrow
arrays with ``pyarrow.compute.index_in``.  The caches of both are keyed by
the labels array itself, held in the cache, never by a buffer address.

:class:`SortedIndex` is the join's index of a right key, on the key's
device; its probe is B6 too.  A string key joins through the ordinals of
the right key's string set (:func:`vaex_tpu_torch.join.join`).

A set of uint64 keys holds them on the device as their order image
``bits ^ (1 << 63)`` (int64, sorted), and on the host as uint64; a probe
maps its rows into that image (:func:`_probe_domain`), so B6 compares
int64s on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import array_types
from ..datatype import NAT, UINT64, order_image, torch_dtype
from ..utils import fingerprint
from . import probe as probe_module
from .nullable import NA, DictNA, HostStage, unsigned_float

# the most labels arrays whose ordinals a string set keeps
LABEL_CACHE_MAX = 16


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
        self.is_string = isinstance(dtype, str) and dtype == "string" or (
            np.dtype(dtype).kind in "OUST")
        self.dtype = np.dtype(object) if self.is_string else np.dtype(dtype)
        self._labels = {}  # id(labels) -> (labels, their ordinals): pinned by the reference
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
        self._labels = {}
        self._check_limit()

    def update(self, values, return_inverse=False):
        """Merge one chunk of host values into the set; ``return_inverse``
        changes nothing, as in vaex_tpu."""
        if self.is_string:
            return self._update_strings(values)
        data, mask = array_types.data_and_mask(values)
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

    def _update_strings(self, values):
        """Merge strings (an arrow array, plain or dictionary, or a numpy
        one) through arrow's hash kernels: only the distinct values become
        Python strings."""
        import pyarrow as pa
        import pyarrow.compute as pc
        arrow = array_types.string_arrow(values)
        if pa.types.is_dictionary(arrow.type):
            counts = np.bincount(np.asarray(arrow.indices.drop_null()),
                                 minlength=len(arrow.dictionary))
            return self.update_counts(arrow.dictionary, counts, arrow.null_count)
        self.null_count += arrow.null_count
        arrow = arrow.drop_null()
        if self.keep_counts:
            vc = pc.value_counts(arrow)
            uniq = _objects(vc.field("values"))
            cnt = np.asarray(vc.field("counts")).astype(np.int64)
        else:
            uniq, cnt = _objects(pc.unique(arrow)), None
        self._merge_strings(uniq, cnt)

    def update_counts(self, labels, counts, null_count=0):
        """Merge the labels (an arrow string array, repeats and nulls
        allowed) that have a count above 0, and the rows counted null."""
        counts = np.asarray(counts, np.int64)[:len(labels)]
        present = counts > 0
        values = _objects(labels)
        null = np.asarray(labels.is_null()) if labels.null_count else None
        if null is not None:
            null_count += int(counts[null].sum())
            present &= ~null
        self.null_count += int(null_count)
        self._merge_strings(values[present], counts[present] if self.keep_counts else None)

    def _merge_strings(self, values, counts):
        """Merge strings (repeats allowed) and their counts, or None."""
        if counts is None:
            uniq, cnt = np.unique(values), None
        else:
            uniq, inverse = np.unique(values, return_inverse=True)
            cnt = np.zeros(len(uniq), np.int64)
            np.add.at(cnt, inverse.reshape(-1), counts)
        self._set_host(*_merge(self.keys, self.counts, uniq, cnt))

    def label_ordinals(self, labels):
        """The ordinal of each of ``labels`` (an arrow string array) in the
        set, -1 for one that is not in it, the null ordinal (or -1) for a
        null label; computed once per labels array, which the cache holds."""
        hit = self._labels.get(id(labels))
        if hit is not None and hit[0] is labels:
            return hit[1]
        ords = _string_index_in(labels, self.keys).astype(np.int32)
        if labels.null_count:
            ords[np.asarray(labels.is_null())] = self.null_ordinal
        if len(self._labels) >= LABEL_CACHE_MAX:
            self._labels.clear()
        self._labels[id(labels)] = (labels, ords)
        return ords

    def merge(self, other: "SortedSet"):
        self.nan_count += other.nan_count
        self.null_count += other.null_count
        self._set_host(*_merge(self.keys, self.counts, other.keys, other.counts))

    # -- introspection ------------------------------------------------------
    @property
    def keys(self):
        """The keys as a host array (copied from the device on first read)."""
        if self._keys is None:
            keys = self._device_keys
            if self.is_unsigned64:  # the order image back to the bits
                keys = order_image(keys)
            keys = array_types.to_numpy(keys)
            # a datetime, timedelta or uint64 set holds int64s on the device
            self._keys = (keys.view(self.dtype) if self.is_temporal or self.is_unsigned64
                          else keys.astype(self.dtype, copy=False))
        return self._keys

    @property
    def counts(self):
        if self._counts is None and self._device_counts is not None:
            self._counts = array_types.to_numpy(self._device_counts).astype(np.int64)
        return self._counts

    def device_keys(self, device):
        """The keys as a tensor on ``device``, moved there once; a string set
        keeps its keys on the host."""
        if self.is_string:
            raise TypeError("a set of strings keeps its keys on the host")
        device = torch.device(device)
        if self._device_keys is None or self._device_keys.device != device:
            if self._device_keys is not None:
                self._device_keys = self._device_keys.to(device)
            else:
                keys = array_types.to_tensor(self.keys, device)
                self._device_keys = order_image(keys) if self.is_unsigned64 else keys
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
    def is_unsigned64(self):
        """uint64 keys: on the device as their order image."""
        return self.dtype == UINT64

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
        array when there is a null slot (and ``masked``); of strings an
        object array whose null slot holds None."""
        if self.is_string:
            out = np.empty(self.count, dtype=object)
            out[:self.n_keys] = self.keys
            if self.has_null and masked:
                mask = np.zeros(self.count, bool)
                mask[self.null_ordinal] = True
                return np.ma.MaskedArray(out, mask)
            return out
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
                self._fingerprint = fingerprint(
                    "sorted-set", tuple(self._keys) if self.is_string else self._keys,
                    self.nan_count, self.null_count)
        return self._fingerprint

    # -- host probes --------------------------------------------------------
    def _host_ordinals(self, data):
        if not self.n_keys:
            return np.full(len(data), -1, np.int64)
        idx = np.clip(np.searchsorted(self.keys, data), 0, self.n_keys - 1)
        return np.where(self.keys[idx] == data, idx, -1).astype(np.int64)

    def _string_probe(self, values):
        """(ordinals, null rows or None) of strings on the host: a dictionary
        array's labels once, then a gather by its indices."""
        import pyarrow as pa
        arrow = array_types.string_arrow(values)
        if pa.types.is_dictionary(arrow.type):
            ords = self.label_ordinals(arrow.dictionary)
            codes = ords[np.asarray(arrow.indices.fill_null(0))] if len(ords) else np.full(
                len(arrow), -1, np.int32)
        else:
            codes = _string_index_in(arrow, self.keys)
        null = np.asarray(arrow.is_null()) if arrow.null_count else None
        return codes, null

    def map_ordinal(self, values):
        """values -> ordinal codes on the host; unknown keys get -1."""
        if self.is_string:
            codes, null = self._string_probe(values)
            if null is not None:
                codes = np.where(null, self.null_ordinal, codes)
            return _shrink_codes(codes, self.count)
        data, mask = array_types.data_and_mask(values)
        codes = self._host_ordinals(data)
        if _is_float(data.dtype):
            codes = np.where(np.isnan(data), self.nan_ordinal, codes)
        if mask is not None:
            codes = np.where(mask, self.null_ordinal, codes)
        return _shrink_codes(codes, self.count)

    def isin(self, values):
        if self.is_string:
            codes, null = self._string_probe(values)
            out = codes >= 0
            return out if null is None else np.where(null, self.has_null, out)
        data, mask = array_types.data_and_mask(values)
        out = self._host_ordinals(data) >= 0
        if _is_float(data.dtype) and self.has_nan:
            out |= np.isnan(data)
        if mask is not None:
            out = np.where(mask, self.has_null, out)
        return out


def _objects(arrow):
    """An arrow string array as an object array of str (None where null)."""
    out = np.empty(len(arrow), dtype=object)
    out[:] = arrow.to_pylist()
    return out


def _string_index_in(data, keys):
    """The position of each string of ``data`` (arrow or numpy) among the
    sorted ``keys`` (an object array of str), -1 where absent: arrow's hash
    kernel (vaex_tpu/ops/setops.py:497-545)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    arrow = array_types.string_arrow(data)
    if len(arrow) == 0 or len(keys) == 0:
        return np.full(len(arrow), -1, np.int64)
    value_set = pa.array(list(keys), type=arrow.type if not pa.types.is_dictionary(
        arrow.type) else arrow.type.value_type)
    return np.asarray(pc.index_in(arrow, value_set=value_set).fill_null(-1)).astype(np.int64)


def host_map_ordinal(oset, values):
    """The host stage's ``_ordinal_values``."""
    return oset.map_ordinal(values)


def host_isin(oset, values):
    """The host stage's ``isin_set``."""
    return oset.isin(values)


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

    def __init__(self, keys, n_keys, has_nan, has_null, temporal=False, trees=None,
                 unsigned=False, host_set=None):
        self.keys = keys
        self.n_keys = n_keys
        self.has_nan = has_nan
        self.has_null = has_null
        self.temporal = temporal  # rows that hold NaT are missing
        self.unsigned = unsigned  # uint64 keys, held as their order image
        self.route = None
        self.trees = {} if trees is None else trees
        self.host_set = host_set  # the SortedSet of a string set
        self._floats = None  # a uint64 set's keys as floats (_float_view)

    @classmethod
    def of(cls, oset, device):
        if oset.is_string:  # probed through labels on the host
            handle = cls(None, oset.n_keys, False, oset.has_null)
            handle.host_set = oset
            return handle
        keys = oset.device_keys(device)
        return cls(keys, oset.n_keys, oset.has_nan, oset.has_null, oset.is_temporal,
                   oset.trees.setdefault(keys.device, {}), oset.is_unsigned64)

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


def _probe_domain(handle, x):
    """(rows as the keys are held, rows that can match no key or None): a
    uint64 set compares order images, so uint64 rows map to theirs and a
    signed int row to its value's, a negative one matching nothing; uint64
    rows against a signed set match where their value fits int64 (against
    a float set by their float value)."""
    data, unsigned = x.data, x.logical == UINT64
    if handle.unsigned:
        data = data.to(torch.int64)
        return order_image(data), None if unsigned else data < 0
    if not unsigned:
        return data, None
    if handle.keys.is_floating_point():
        return unsigned_float(data), None
    return data, data < 0


def _float_view(handle):
    """A uint64 set's keys as float64 values (ascending, ties where two keys
    round alike), probed as a float set: numpy compares float rows with
    uint64 values in float64."""
    if handle._floats is None:
        handle._floats = DeviceSetHandle(unsigned_float(order_image(handle.keys)),
                                         handle.n_keys, False, False)
    return handle._floats


def _probe(handle, x):
    """int32 ordinals of ``x``'s values among the keys, -1 where none (float
    rows against a uint64 set: the first key equal in float64)."""
    if handle.unsigned and x.data.is_floating_point() and handle.n_keys:
        floats = _float_view(handle)
        codes = device_probe(floats, x.data.to(torch.float64))
        handle.route = floats.route
        return codes
    data, never = _probe_domain(handle, x)
    if not handle.n_keys:
        return torch.full(data.shape, -1, dtype=torch.int32, device=data.device)
    codes = device_probe(handle, data)
    return codes if never is None else codes.masked_fill(never, -1)


def _missing(handle, x):
    """The rows of ``x`` that hold the missing value: masked rows and, for a
    datetime or timedelta set, NaT rows; None when there can be none."""
    if not (handle.temporal and x.data.dtype == torch.int64):
        return x.mask
    nat = x.data == NAT
    return nat if x.mask is None else nat | x.mask


def _strings(handle, x):
    """True where strings meet a string set; raises where only one side
    holds strings (the host stage compares them as numpy would)."""
    strings = isinstance(x, DictNA)
    if strings != (handle.host_set is not None):
        raise HostStage("a probe of strings in a set of numbers, or of numbers in a set of "
                        "strings, runs in the host stage")
    return strings


def _label_probe(handle, x):
    """int32 ordinals of a DictNA's rows: each label looked up once on the
    host, gathered by code on the device; a null row takes the null
    ordinal."""
    codes = x.gather(handle.host_set.label_ordinals(x.labels))
    out = codes.data
    if codes.mask is not None:
        out = out.masked_fill(codes.mask, handle.null_ordinal)
    return out.to(torch.int32)


def device_map_ordinal(handle: DeviceSetHandle, x: NA):
    """NA values -> int32 ordinals: NaN rows take ``nan_ordinal``, masked
    rows ``null_ordinal``, the rest the probe's ordinal or -1."""
    if _strings(handle, x):
        return _label_probe(handle, x)
    data = x.data
    codes = _probe(handle, x)
    if data.is_floating_point() and handle.has_nan:
        codes = torch.where(torch.isnan(data), handle.nan_ordinal, codes)
    missing = _missing(handle, x)
    if missing is not None:
        codes = torch.where(missing, handle.null_ordinal, codes)
    return codes.to(torch.int32)


def device_isin(handle: DeviceSetHandle, x: NA):
    if _strings(handle, x):
        ords = _label_probe(handle, x)
        return (ords >= 0) & (ords != handle.null_ordinal) | (
            (ords == handle.null_ordinal) & handle.has_null)
    data = x.data
    out = _probe(handle, x) >= 0
    if data.is_floating_point() and handle.has_nan:
        out = out | torch.isnan(data)
    missing = _missing(handle, x)
    if missing is not None:
        out = torch.where(missing, handle.has_null, out)
    return out


def choices_tensor(values, device):
    """An array variable (``map``'s choices) as a tensor on ``device``; an
    array of strings as an arrow array, the labels of ``_choose``'s
    dictionary codes."""
    if array_types.is_arrow(values) or array_types.is_string_array(np.asarray(values)):
        return array_types.string_arrow(np.asarray(values) if not array_types.is_arrow(values)
                                        else values)
    values = np.asarray(values)
    return torch.as_tensor(values, dtype=torch_dtype(values.dtype)).to(device)


# ---------------------------------------------------------------------------
# the join index


def _as_na(values, mask):
    """An NA of ``values`` (an NA, a tensor or a host array) and ``mask``."""
    if isinstance(values, NA):
        return values
    return NA(torch.as_tensor(values), None if mask is None else torch.as_tensor(mask))


class SortedIndex:
    """The join index of a right key column, on the key's device
    (vaex_tpu/ops/setops.py:690-798): the rows that hold a key (neither
    masked nor NaN) sorted stably by it, then the unique runs: each key,
    its first row and its range ``[starts, ends)`` among the sorted rows.

    :meth:`map_index` probes the unique keys with B6
    (:func:`device_probe`, on a tree built once per index and device) and
    gathers each match's first row; :meth:`map_index_duplicates` gives the
    further rows of a key that has several, vectorised, in the reference's
    order: left rows ascending and, within one, the right rows in
    stable-sort order.  The reference's lookup table for dense integer keys
    is a host shortcut and is not ported (ROADMAP, redesign queue)."""

    def __init__(self, keys, mask=None, offset=0):
        if keys.dtype == torch.bool or keys.is_complex():
            raise TypeError(f"a join key takes int and float values, got {keys.dtype}")
        n = keys.shape[0]
        valid = None if mask is None else ~mask
        if keys.is_floating_point():
            valid = ~torch.isnan(keys) if valid is None else valid & ~torch.isnan(keys)
        row_dtype = torch.int32 if n + offset < 2 ** 31 else torch.int64
        if valid is None:
            sorted_keys, rows = torch.sort(keys, stable=True)
        else:
            rows = torch.nonzero(valid).squeeze(1)
            sorted_keys, order = torch.sort(keys.index_select(0, rows), stable=True)
            rows = rows.index_select(0, order)
        self.sorted_rows = (rows + offset if offset else rows).to(row_dtype)
        first = torch.ones(sorted_keys.shape, dtype=torch.bool, device=keys.device)
        first[1:] = sorted_keys[1:] != sorted_keys[:-1]
        self.starts = torch.nonzero(first).squeeze(1)
        self.ends = torch.cat([self.starts[1:], self.starts.new_tensor([sorted_keys.shape[0]])])
        self.keys = sorted_keys.index_select(0, self.starts)
        self.first_rows = self.sorted_rows.index_select(0, self.starts)
        self.n_keys = int(self.keys.shape[0])
        self.has_duplicates = self.n_keys < sorted_keys.shape[0]
        self.row_dtype = row_dtype
        self._handles = {}  # device -> (DeviceSetHandle, the index's tensors there)

    def _on(self, device):
        """The unique keys' handle (its B6 trees) and the row tensors on
        ``device``, moved there once."""
        if device not in self._handles:
            keys = self.keys.to(device)
            self._handles[device] = (
                DeviceSetHandle(keys, self.n_keys, False, False),
                *(t.to(device) for t in (self.first_rows, self.starts, self.ends,
                                         self.sorted_rows)))
        return self._handles[device]

    def route(self, device):
        """The B6 route the last probe on ``device`` took."""
        return self._on(device)[0].route

    def ordinals(self, x: NA):
        """int32 ordinals of ``x``'s values among the unique keys, -1 for a
        value that is no key, NaN or masked."""
        data = x.data
        if not self.n_keys:
            return torch.full(data.shape, -1, dtype=torch.int32, device=data.device)
        out = device_probe(self._on(data.device)[0], data)
        return out if x.mask is None else out.masked_fill(x.mask, -1)

    def rows_of(self, ordinals):
        """The first right row of each ordinal, -1 where it is -1."""
        first_rows = self._on(ordinals.device)[1]
        if not self.n_keys:
            return torch.full(ordinals.shape, -1, dtype=self.row_dtype, device=ordinals.device)
        rows = first_rows.index_select(0, ordinals.clamp(min=0))
        return rows.masked_fill_(ordinals < 0, -1)

    def duplicates_of(self, ordinals, left_offset=0):
        """(left rows, right rows) of the matches past each row's first:
        a row whose key has k right rows gives k - 1 pairs."""
        _, _, starts, ends, sorted_rows = self._on(ordinals.device)
        device = ordinals.device
        hit = ordinals >= 0
        at = ordinals.clamp(min=0).to(torch.int64)
        extra = torch.where(hit, (ends - starts).index_select(0, at) - 1, 0)
        total = int(extra.sum())
        if total == 0:
            empty = torch.empty(0, dtype=torch.int64, device=device)
            return empty, empty.to(self.row_dtype)
        rows = torch.nonzero(extra).squeeze(1)
        extra = extra.index_select(0, rows)
        left = torch.repeat_interleave(rows + left_offset, extra)
        # each pair's place among its row's pairs: 0 .. k - 2
        before = torch.cumsum(extra, 0) - extra
        within = torch.arange(total, device=device) - torch.repeat_interleave(before, extra)
        first = torch.repeat_interleave(starts.index_select(0, at.index_select(0, rows)) + 1,
                                        extra)
        return left, sorted_rows.index_select(0, first + within)

    def map_index(self, values, mask=None):
        """The first right row of each value (an NA, or a tensor and its
        ``mask``), -1 where it has none."""
        return self.rows_of(self.ordinals(_as_na(values, mask)))

    def map_index_duplicates(self, values, left_offset=0, mask=None):
        """(left rows + ``left_offset``, right rows) past each first match."""
        return self.duplicates_of(self.ordinals(_as_na(values, mask)), left_offset)

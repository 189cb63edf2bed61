"""HDF5 in vaex's layout (vaex_tpu/io/hdf5.py): ``/table/columns/<name>/data``
with an optional ``mask`` beside it (True where a value is present) and, for
a datetime or timedelta column, int64 data with the numpy dtype in the
``dtype`` attribute; strings as variable-length UTF-8.

A contiguous, uncompressed dataset is memory-mapped by its offset in the
file, through the same open file that h5py parsed, so opening reads no row
and the file's identity is the one the mapping reads; a mask is mapped and
inverted at open (one byte a row, as the reference does); a compressed or
chunked dataset and strings are read whole.  h5py is imported here only:
``import vaex_tpu_torch`` does not need it.

Strings: the reference writes a null string as "" and keeps no mask for it
(vaex_tpu/io/hdf5.py:165-176), so its nulls do not survive an HDF5 round
trip; the port writes the same "" and a ``mask`` beside it, which the port
reads back as null and the reference ignores.
"""

from __future__ import annotations

import numpy as np

from ..column import file_identity
from ..dataset import DatasetFile
from . import export_rows, replacing


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing an HDF5 file needs h5py") from e
    return h5py


class Hdf5Dataset(DatasetFile):
    """The columns of a vaex-layout HDF5 file, memory-mapped.  With
    ``cached`` (a :class:`~.remote.CachedFile`) the file is a remote object
    behind a block cache: h5py parses it through the cache, and a column
    becomes a :class:`~.remote.ColumnBlockedRemote` that fetches only the
    blocks a slice reaches."""

    def __init__(self, path, cached=None):
        h5py = _h5py()
        self._cached = cached
        if cached is not None:
            super().__init__(path, cached.identity)
            with h5py.File(cached, "r") as f:
                self._load(f, None)
            return
        with open(path, "rb") as fh:
            super().__init__(path, file_identity(path, fh.fileno()))
            with h5py.File(fh, "r") as f:
                self._load(f, fh)

    def _load(self, f, fh):
        h5py = _h5py()
        root = next((c for c in ("table/columns", "columns", "data") if c in f), None)
        if root is None:
            raise IOError(f"{self.path}: no vaex column layout found")
        for name in f[root]:
            node = f[root][name]
            if isinstance(node, h5py.Dataset):
                data, mask = node, None
            elif "data" in node:
                data, mask = node["data"], node.get("mask")
            else:
                continue
            self.add_column(name, self._map(data, mask, fh))

    def _map(self, ds, mask_ds, fh):
        """A dataset (and its mask) as a column (vaex_tpu/io/hdf5.py:72-112)."""
        h5py = _h5py()
        remote = self._cached is not None
        valid = None if mask_ds is None else np.asarray(
            mask_ds[:] if remote else self._array(mask_ds, fh)).astype(bool)
        if h5py.check_string_dtype(ds.dtype):
            import pyarrow as pa
            values = ds.asstr()[:]
            nulls = None if valid is None else ~np.asarray(valid)
            return pa.array(list(values), type=pa.string(),
                            mask=nulls if nulls is not None and nulls.any() else None)
        logical = ds.attrs.get("dtype")
        if logical is not None:
            logical = np.dtype(logical.decode() if isinstance(logical, bytes) else logical)
        temporal = logical is not None and logical.kind in "Mm"
        # through the block cache a masked or temporal column is read whole
        # (only its own blocks), as the reference does
        data = ds[:] if remote and (temporal or valid is not None) else self._array(ds, fh)
        if temporal:
            data = data.view(logical)
        if valid is not None:
            return np.ma.MaskedArray(data, ~valid)
        return data

    def _array(self, ds, fh):
        """A dataset's values: a read-only memory map by its offset where it
        is contiguous and uncompressed, else read whole."""
        offset = ds.id.get_offset()
        if offset is None or ds.compression is not None or ds.chunks is not None or (
                ds.shape[0] == 0):
            return ds[:]
        if self._cached is not None:
            from .remote import ColumnBlockedRemote
            return ColumnBlockedRemote(self._cached, offset, ds.dtype, ds.shape[0])
        return np.memmap(fh, dtype=ds.dtype, shape=ds.shape, offset=offset, mode="r")


def open_hdf5(path):
    from .. import from_dataset
    return from_dataset(Hdf5Dataset(path))


def export_hdf5(df, path, progress=None, chunk_size=None, byteorder="="):
    """Write the frame's columns (virtual ones as their values, the rows the
    filter keeps) in vaex's layout, a chunk at a time
    (vaex_tpu/io/hdf5.py:116-148)."""
    h5py = _h5py()
    names = df.get_column_names()
    n = len(df)
    with replacing(path) as tmp, h5py.File(tmp, "w") as f:
        table = f.create_group("table")
        table.attrs["type"] = "table"
        columns = table.create_group("columns")
        writers = {name: _Writer(columns.create_group(name), df.data_type(name), n)
                   for name in names}
        for i1, i2, part in export_rows(df, chunk_size):
            for name in names:
                writers[name].write(i1, i2, part.evaluate(name))
    return path


class _Writer:
    """One column's datasets: ``data`` of its dtype (int64 with a ``dtype``
    attribute for a datetime or timedelta, variable-length UTF-8 for
    strings), and ``mask`` once a chunk has a missing value."""

    def __init__(self, group, dtype, n):
        h5py = _h5py()
        self.group, self.n, self.mask = group, n, None
        self.text = dtype.is_text
        if self.text:
            self.data = group.create_dataset("data", (n,), dtype=h5py.string_dtype())
        else:
            npdt = dtype.numpy
            self.temporal = npdt.kind in "Mm"
            self.data = group.create_dataset("data", (n,),
                                             dtype=np.int64 if self.temporal else npdt)
            if self.temporal:
                self.data.attrs["dtype"] = str(npdt)

    def write(self, i1, i2, values):
        from .. import array_types
        if i2 == i1:
            return
        if self.text:
            values = array_types.string_arrow(values).to_pylist()
            missing = np.asarray([v is None for v in values])
            self.data[i1:i2] = np.asarray(["" if v is None else v for v in values], dtype=object)
        else:
            data, missing = array_types.data_and_mask(values)
            self.data[i1:i2] = data.view(np.int64) if self.temporal else data
        if missing is not None and missing.any():
            if self.mask is None:
                self.mask = self.group.create_dataset("mask", (self.n,), dtype=bool)
                self.mask[:] = True
            self.mask[i1:i2] = ~missing

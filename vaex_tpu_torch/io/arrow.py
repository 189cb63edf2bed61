"""Arrow IPC, Feather, CSV and Parquet (vaex_tpu/io/arrow.py).

An IPC file is memory-mapped and its columns stay the arrow chunks over the
mapping (:class:`ColumnArrow`): a slice inside one chunk is a numpy view of
the file's bytes, one across chunks copies only its rows.  A Parquet file is
read lazily: a slice reads the row groups it reaches (:class:`ColumnParquet`)
and a streamed pass reads the row groups in order
(:meth:`ParquetDataset.chunk_iterator`).  Strings are read at open into a
host string column.  The exporters write a record batch (a row group for
Parquet) a chunk at a time.  pyarrow is imported by the functions here.
"""

from __future__ import annotations

import numpy as np

from .. import array_types
from ..column import ColumnHost, file_identity
from ..dataset import DatasetFile
from ..datatype import DataType
from . import export_rows, replacing


def _numpy_dtype(arrow_type):
    return DataType(arrow_type).numpy


class ColumnArrow(ColumnHost):
    """A column of an arrow ``ChunkedArray`` of numbers, bools or times: a
    slice as numpy, masked where null."""

    def __init__(self, chunked):
        self.chunked = chunked
        self.dtype = _numpy_dtype(chunked.type)
        self.masked = chunked.null_count > 0

    def __len__(self):
        return len(self.chunked)

    def _read(self, i1, i2):
        import pyarrow as pa
        part = self.chunked.slice(i1, i2 - i1)
        chunks = [c for c in part.chunks if len(c)]
        if not chunks:
            return np.empty(0, self.dtype)
        return array_types.to_numpy(chunks[0] if len(chunks) == 1 else pa.concat_arrays(chunks))


def _column(chunked):
    """An arrow column as the port holds it: strings as an arrow array,
    anything else as a :class:`ColumnArrow`."""
    if array_types.is_string_array(chunked):
        return chunked.combine_chunks()
    return ColumnArrow(chunked)


class ArrowTableDataset(DatasetFile):
    """The columns of a pyarrow Table read from ``path``."""

    def __init__(self, table, path, identity=None):
        super().__init__(path, identity)
        self.table = table
        for name in table.column_names:
            self.add_column(name, _column(table.column(name)))
        self._row_count = table.num_rows


def open_arrow(path):
    """An Arrow IPC file (or stream), memory-mapped."""
    import pyarrow as pa
    from .. import from_dataset
    identity = file_identity(path)
    try:
        table = pa.ipc.open_file(pa.memory_map(str(path))).read_all()
    except pa.ArrowInvalid:
        table = pa.ipc.open_stream(pa.memory_map(str(path))).read_all()
    return from_dataset(ArrowTableDataset(table, path, identity))


def open_feather(path):
    """A Feather (version 2) file: Arrow IPC, its compressed buffers
    decompressed at open."""
    return open_arrow(path)


def open_csv(path, **kwargs):
    import pyarrow.csv as pacsv
    from .. import from_dataset
    identity = file_identity(path)
    return from_dataset(ArrowTableDataset(pacsv.read_csv(str(path)), path, identity))


class ColumnParquet(ColumnHost):
    """A column of a Parquet file: a slice reads the row groups it reaches
    (vaex_tpu/io/arrow.py:133-175)."""

    def __init__(self, dataset, name):
        self.dataset, self.name = dataset, name
        field = dataset.schema.field(name)
        self.dtype = _numpy_dtype(field.type)
        self.masked = dataset.may_hold_nulls(name)

    def __len__(self):
        return self.dataset.row_count

    def _read(self, i1, i2):
        import pyarrow as pa
        f, parts, row = self.dataset.file, [], 0
        for rg in range(f.num_row_groups):
            n = f.metadata.row_group(rg).num_rows
            if row + n > i1 and row < i2:
                col = f.read_row_group(rg, columns=[self.name]).column(0)
                lo = max(i1 - row, 0)
                parts.extend(col.slice(lo, min(i2 - row, n) - lo).chunks)
            row += n
            if row >= i2:
                break
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.empty(0, self.dtype)
        return array_types.to_numpy(parts[0] if len(parts) == 1 else pa.concat_arrays(parts))


class ParquetDataset(DatasetFile):
    """A Parquet file read lazily: numeric columns are
    :class:`ColumnParquet`, strings are read at open.  With ``filesystem``
    (fsspec) the file is remote and pyarrow reads its row groups by ranges."""

    def __init__(self, path, filesystem=None, identity=None):
        import pyarrow.parquet as pq
        if filesystem is not None:
            handle = filesystem.open(str(path).split("://", 1)[-1], "rb")
            super().__init__(path, identity)
            self.file = pq.ParquetFile(handle)
        else:
            with open(path, "rb") as fh:
                super().__init__(path, identity or file_identity(path, fh.fileno()))
            self.file = pq.ParquetFile(str(path))
        self.schema = self.file.schema_arrow
        self._row_count = self.file.metadata.num_rows
        for name in self.schema.names:
            if array_types.is_string_array(_empty(self.schema.field(name).type)):
                self.add_column(name, self.file.read(columns=[name]).column(0).combine_chunks())
            else:
                self.add_column(name, ColumnParquet(self, name))

    def may_hold_nulls(self, name):
        """True unless every row group's statistics count no null in it."""
        meta = self.file.metadata
        at = self.schema.get_field_index(name)
        for rg in range(meta.num_row_groups):
            stats = meta.row_group(rg).column(at).statistics
            if stats is None or not stats.has_null_count or stats.null_count:
                return True
        return False

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        """The row groups in order, cut and joined into chunks of
        ``chunk_size`` rows (vaex_tpu/io/arrow.py:69-130); strings from the
        column read at open."""
        import pyarrow as pa
        chunk_size = chunk_size or 1 << 20
        lazy = [n for n in columns if isinstance(self._columns[n], ColumnParquet)]
        if reverse or not lazy or self.row_count == 0:
            yield from DatasetFile.chunk_iterator(self, columns, chunk_size, reverse)
            return
        pending, held, offset = {n: [] for n in lazy}, 0, 0

        def take(n_rows):
            nonlocal held, offset
            out = {}
            for name in lazy:
                joined = pa.concat_arrays([c for c in pending[name] if len(c)] or
                                          [pa.array([], self.schema.field(name).type)])
                out[name] = array_types.to_numpy(joined.slice(0, n_rows))
                pending[name] = [joined.slice(n_rows)] if held > n_rows else []
            for name in columns:
                if name not in out:
                    out[name] = self._columns[name][offset:offset + n_rows]
            held -= n_rows
            offset += n_rows
            return offset - n_rows, offset, out

        for batch in self.file.iter_batches(batch_size=min(chunk_size, 1 << 20), columns=lazy):
            for name in lazy:
                pending[name].extend(batch.column(name).chunks if isinstance(
                    batch.column(name), pa.ChunkedArray) else [batch.column(name)])
            held += batch.num_rows
            while held >= chunk_size:
                yield take(chunk_size)
        if held:
            yield take(held)


def _empty(arrow_type):
    import pyarrow as pa
    return pa.array([], arrow_type)


def open_parquet(path):
    from .. import from_dataset
    return from_dataset(ParquetDataset(path))


def arrow_tables(df, chunk_size=None):
    """The frame's rows as pyarrow Tables of one schema, a chunk at a time
    (strings as plain strings, so that the chunks' dictionaries need not
    agree)."""
    import pyarrow as pa
    schema = None
    for _, _, part in export_rows(df, chunk_size):
        table = part.to_arrow_table()
        table = pa.table({name: _plain(col) for name, col in zip(table.column_names,
                                                                  table.columns)})
        if schema is None:
            schema = table.schema
        yield table.cast(schema)


def _plain(col):
    import pyarrow as pa
    if pa.types.is_dictionary(col.type):
        col = col.cast(col.type.value_type)
    return col


def export_parquet(df, path, chunk_size=None, **kwargs):
    """Row groups of at most 1Mi rows (pyarrow's default), written a chunk
    at a time."""
    import pyarrow.parquet as pq
    with replacing(path) as tmp:
        writer = None
        try:
            for table in arrow_tables(df, chunk_size):
                if writer is None:
                    writer = pq.ParquetWriter(tmp, table.schema, **kwargs)
                writer.write_table(table)
        finally:
            if writer is not None:
                writer.close()
    return path


def _export_ipc(df, path, chunk_size, options=None):
    import pyarrow as pa
    with replacing(path) as tmp:
        writer = None
        with pa.OSFile(tmp, "wb") as sink:
            try:
                for table in arrow_tables(df, chunk_size):
                    if writer is None:
                        writer = pa.ipc.new_file(sink, table.schema, options=options)
                    writer.write_table(table)
            finally:
                if writer is not None:
                    writer.close()
    return path


def export_arrow(df, path, chunk_size=None):
    """An Arrow IPC file, a record batch a chunk."""
    return _export_ipc(df, path, chunk_size)


def export_feather(df, path, compression="lz4", chunk_size=None):
    """A Feather (version 2) file: Arrow IPC with its buffers compressed."""
    import pyarrow as pa
    codec = None if compression in (None, "uncompressed") else compression
    return _export_ipc(df, path, chunk_size, pa.ipc.IpcWriteOptions(compression=codec))

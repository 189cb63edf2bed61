"""Files: open and export every format of vaex_tpu (vaex_tpu/io/).

Each reader returns a :class:`~vaex_tpu_torch.dataset.DatasetFile` whose
columns are keyed by the file (:func:`~vaex_tpu_torch.column.keyed`):
HDF5 (:mod:`.hdf5`, memory-mapped), Arrow IPC, Feather, CSV and Parquet
(:mod:`.arrow`; Parquet row groups read lazily), FITS (:mod:`.fits`,
memory-mapped), VOTable (:mod:`.votable`), Gadget (:mod:`.gadget`) and remote
objects through fsspec (:mod:`.remote`).  :mod:`.export` dispatches by
extension.  Every exporter writes tile by tile (no column is on the host
whole) into a temporary file beside the target and renames it into place
(:func:`replacing`), so a file replaced under its name is a new inode, and a
mapping of the old one keeps reading the old bytes.  h5py, pyarrow, fsspec
and PyYAML are imported by the functions that need them.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def replacing(path):
    """A temporary name beside ``path`` to write to, renamed onto ``path``
    when the block ends without an error, removed when it raises."""
    path = str(path)
    tmp = os.path.join(os.path.dirname(os.path.abspath(path)),
                       f".{os.path.basename(path)}.tmp{os.getpid()}")
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def export_rows(df, chunk_size=None):
    """Yield ``(i1, i2, frame of those rows)`` over the rows ``df`` keeps,
    ``chunk_size`` (a tile by default) at a time; an empty frame yields one
    empty chunk.  The filter is applied once (:meth:`DataFrame.extract`)."""
    from .. import settings
    df = df.extract()
    chunk_size = int(chunk_size or df._tile_rows or settings.TILE_ROWS)
    n = len(df)
    for i1 in range(0, max(n, 1), chunk_size):
        i2 = min(i1 + chunk_size, n)
        yield i1, i2, df if (i1, i2) == (0, n) else df._rebind_dataset(df.dataset.slice(i1, i2))

"""Remote objects (s3://, gs://, http://, memory://, ...) through fsspec
(vaex_tpu/io/remote.py).

An HDF5 object is read through a block cache (:class:`CachedFile`): a sparse
local mirror of the object and a byte per 1 MiB block that says whether it
is there, so that a query fetches only the blocks of the columns and rows it
reads (:class:`ColumnBlockedRemote`).  A Parquet object is read by pyarrow
in ranges.  Any other object is fetched whole once into the local cache
(``VAEX_TPU_TORCH_FILE_CACHE``, by default ``~/.vaex_tpu_torch/file-cache``)
and opened from there.  Cache entries are named by the url, the object's
size and its modification time, which also key its columns.
"""

from __future__ import annotations

import hashlib
import os
import shutil

import numpy as np

from ..column import ColumnHost

BLOCK = 1 << 20  # the fetch granularity (vaex/file/cache.py:19-50)


def cache_dir():
    path = os.environ.get("VAEX_TPU_TORCH_FILE_CACHE",
                          os.path.join(os.path.expanduser("~"), ".vaex_tpu_torch", "file-cache"))
    os.makedirs(path, exist_ok=True)
    return path


def is_remote(path) -> bool:
    return "://" in str(path) and not str(path).startswith("file://")


def _filesystem(path, fs_options=None):
    import fsspec
    return fsspec.filesystem(str(path).split("://", 1)[0], **(fs_options or {}))


def _stamp(fs, path):
    """(size, modification time) of the object, as fsspec reports them."""
    info = fs.info(path)
    return int(info.get("size") or 0), str(info.get("mtime", info.get("LastModified",
                                                                      info.get("created", ""))))


def _local_name(path, size, mtime):
    key = hashlib.sha256(f"{path}-{size}-{mtime}".encode()).hexdigest()[:24]
    return os.path.join(cache_dir(), f"{key}-{os.path.basename(str(path).rstrip('/')) or 'data'}")


def fetch(path, fs_options=None) -> str:
    """A local copy of a remote object, fetched once into the cache."""
    fs = _filesystem(path, fs_options)
    local = _local_name(path, *_stamp(fs, path))
    if not os.path.exists(local):
        tmp = f"{local}.tmp{os.getpid()}"
        with fs.open(path, "rb") as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst, length=BLOCK)
        os.replace(tmp, local)
    return local


class CachedFile:
    """A remote object behind a block cache (vaex/file/cache.py:19-50): reads
    fetch the missing 1 MiB blocks with ranged reads; file-like, so that h5py
    parses it.  ``identity`` keys the columns read through it."""

    def __init__(self, fs, path, size, mtime=None, local_base=None):
        self.fs, self.path, self.size = fs, path, int(size)
        self.identity = ("remote", str(path), self.size, mtime)
        # the mirror's files: ``local_base`` + ".blocks" / ".present", by
        # default named after the object in the file cache
        base = local_base if local_base is not None else _local_name(path, size, mtime)
        self.data_path, mask_path = f"{base}.blocks", f"{base}.present"
        n_blocks = max(-(-self.size // BLOCK), 1)
        if not (os.path.exists(self.data_path) and os.path.exists(mask_path)):
            with open(self.data_path, "wb") as f:
                f.truncate(self.size)  # sparse
            with open(mask_path, "wb") as f:
                f.truncate(n_blocks)
        self.present = np.memmap(mask_path, dtype=np.uint8, mode="r+", shape=(n_blocks,))
        self._data = np.memmap(self.data_path, dtype=np.uint8, mode="r+",
                               shape=(self.size,)) if self.size else np.empty(0, np.uint8)
        self._pos = 0

    def ensure(self, start, end):
        """Fetch the missing blocks of bytes [start, end)."""
        end = min(end, self.size)
        if end <= start:
            return
        b, last = start // BLOCK, (end - 1) // BLOCK
        while b <= last:
            if self.present[b]:
                b += 1
                continue
            first = b
            while b <= last and not self.present[b]:
                b += 1
            lo, hi = first * BLOCK, min(b * BLOCK, self.size)
            data = self.fs.cat_file(self.path, start=lo, end=hi)
            self._data[lo:lo + len(data)] = np.frombuffer(data, np.uint8)
            self.present[first:b] = 1

    def read_range(self, start, end):
        self.ensure(start, end)
        return self._data[start:min(end, self.size)]

    @property
    def blocks_fetched(self):
        return int(np.asarray(self.present).sum())

    # file-like, for h5py
    def read(self, n=-1):
        if n is None or n < 0:
            n = self.size - self._pos
        out = bytes(self.read_range(self._pos, self._pos + n))
        self._pos += len(out)
        return out

    def readinto(self, buffer):
        data = self.read(len(buffer))
        memoryview(buffer)[:len(data)] = data
        return len(data)

    def seek(self, offset, whence=0):
        self._pos = offset if whence == 0 else (self._pos + offset if whence == 1
                                                else self.size + offset)
        return self._pos

    def tell(self):
        return self._pos

    def readable(self):
        return True

    def seekable(self):
        return True

    def flush(self):
        pass

    def close(self):
        pass


class ColumnBlockedRemote(ColumnHost):
    """A column of a :class:`CachedFile`: a slice fetches the blocks its rows
    reach, then reads the local mirror (vaex/file/column.py)."""

    def __init__(self, cached, offset, dtype, length):
        self.cached, self.offset = cached, int(offset)
        self.dtype, self.length = np.dtype(dtype), int(length)
        self._view = np.memmap(cached.data_path, dtype=self.dtype, mode="r",
                               offset=self.offset, shape=(self.length,))

    def __len__(self):
        return self.length

    def _read(self, i1, i2):
        size = self.dtype.itemsize
        self.cached.ensure(self.offset + i1 * size, self.offset + i2 * size)
        return np.array(self._view[i1:i2])


def open_cached(path, fs_options=None) -> CachedFile:
    """A block-cached handle on a remote object: nothing is fetched yet."""
    fs = _filesystem(path, fs_options)
    return CachedFile(fs, path, *_stamp(fs, path))


def open_remote(path, fs_options=None):
    """A remote object as a frame: HDF5 through the block cache, Parquet by
    ranges, anything else fetched whole and opened locally."""
    from .. import from_dataset
    from .. import open as open_local
    base = str(path).split("?", 1)[0].lower()
    if base.endswith((".hdf5", ".h5")):
        from .hdf5 import Hdf5Dataset
        return from_dataset(Hdf5Dataset(path, cached=open_cached(path, fs_options)))
    if base.endswith((".parquet", ".pq")):
        from .arrow import ParquetDataset
        fs = _filesystem(path, fs_options)
        return from_dataset(ParquetDataset(path, filesystem=fs,
                                           identity=("remote", str(path), *_stamp(fs, path))))
    return open_local(fetch(path, fs_options))

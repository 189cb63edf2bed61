"""The result cache (the counterpart of ``vaex_tpu/cache.py``).

A pass looks each of its tasks up by ``task fingerprint + frame key``
before it reads a row (:meth:`.execution.ExecutorLocal._execute_pass`), and
stores what it computed; an aggregation is never served from here, a set
build, a filter's mask and a join's probe are; the one-sort groupby keeps
its result frames here too (:mod:`.fused_groupby`).

The frame key is exact, never a sample (:meth:`.dataframe.DataFrame._cache_key`):
a host array and a CPU tensor are named by a hash of all their bytes
(:func:`.column.column_key`, :func:`.utils.tensor_key`), a file's column by
the file's identity.  A tensor's identity and version counter are no exact
key: a write through ``.numpy()``, ``.data``, a numpy array that shares its
memory or a DLPack peer (CuPy, JAX) changes its values and bumps no version.
A card tensor has no exact key, and a frame that reads one is left out of
the cache: its set builds, filter masks, join probes and one-sort results
are computed again on every query.  Hashing its bytes on the card would
cost one read of every column the query reads; leaving it out costs the
whole pass, and nothing can serve a stale answer.  On an NVIDIA H100 80GB
HBM3 at 700 W (``chip_smoke.py`` phase 22, under the old identity key) a
hit served the H2O table's q10 at 1e8 rows in 0.342 ms against its pass's
59.09 ms, and a 1e6-key set grouper in 8.611 ms against 32.19 ms; phase 27
times a repeated ``unique`` over config 1's table at 1e8 rows, which now
runs its pass.  A key that
names an object by its identity (a set, a function) means nothing in
another process, so it is no ``content`` key (:class:`Key`), and the disk
and redis levels never hold one.

Backends (vaex_tpu/cache.py:155-269): an unbounded dict (``"memory"``, the
default, ``settings.CACHE``), a byte-bounded LRU (``"memory_lru"``), pickle
files on disk (``"disk"``), redis where its client is installed, and a
stack of them (``"memory,disk"``).  Results that hold tensors go to a
byte-bounded LRU of their own (``settings.CACHE_DEVICE_SIZE_LIMIT``), whose
eviction and :func:`clear` free the card's memory.  :func:`off`,
:func:`memory`, :func:`memory_infinite` and :func:`disk` swap the backend
for a block; ``hits`` and ``misses`` count the lookups.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import threading

import numpy as np
import torch

from . import settings
from .utils import fingerprint

_lock = threading.Lock()
hits = 0
misses = 0


class Key(str):
    """A cache key; ``content`` is False where it names a tensor by its
    identity, which holds in this process only."""

    content = True


def key(*parts, content=True) -> Key:
    """The key of ``parts`` (strings, numbers, nested tuples)."""
    out = Key(fingerprint(*parts))
    out.content = content
    return out


def sizeof(value) -> int:
    """The bytes a result holds: its tensors' and arrays' (of a set its
    keys, counts and search trees), 64 for anything else."""
    if isinstance(value, torch.Tensor):
        return value.element_size() * value.numel()
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, dict):
        return sum(sizeof(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(sizeof(v) for v in value)
    if hasattr(value, "_device_keys"):  # a SortedSet
        return sum(sizeof(v) for v in (value._device_keys, value._device_counts, value._keys,
                                       value._counts, value.trees)) or 64
    return 64


def holds_tensors(value) -> bool:
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        return any(holds_tensors(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(holds_tensors(v) for v in value)
    return getattr(value, "_device_keys", None) is not None


class MemoryCache:
    """An unbounded dict."""

    def __init__(self):
        self._data = {}

    def get(self, key):
        return self._data.get(key)

    def set(self, key, value):
        self._data[key] = value

    def clear(self):
        self._data.clear()

    def __len__(self):
        return len(self._data)


class MemoryCacheLRU(MemoryCache):
    """A dict bounded by the bytes of its values (:func:`sizeof`): the least
    recently used go first; ``nbytes`` is what it holds."""

    def __init__(self, size_limit=1 << 30):
        super().__init__()
        self.size_limit = size_limit
        self._sizes = {}
        self.nbytes = 0

    def get(self, key):
        value = self._data.get(key)
        if value is not None:  # the most recently used goes last
            self._data[key] = self._data.pop(key)
        return value

    def set(self, key, value):
        size = sizeof(value)
        if key in self._data:
            self.nbytes -= self._sizes.pop(key)
            del self._data[key]
        if size > self.size_limit:
            return
        self._data[key] = value
        self._sizes[key] = size
        self.nbytes += size
        while self.nbytes > self.size_limit:
            old = next(iter(self._data))
            del self._data[old]
            self.nbytes -= self._sizes.pop(old)

    def clear(self):
        super().clear()
        self._sizes.clear()
        self.nbytes = 0


class DiskCache:
    """Pickle files ``<sha256(key)>.pkl`` under ``path``, the least recently
    read removed past ``size_limit`` bytes; only content keys."""

    def __init__(self, path=None, size_limit=None):
        self.path = os.path.expanduser(path or settings.CACHE_DISK_PATH)
        self.size_limit = size_limit or settings.CACHE_DISK_SIZE_LIMIT
        os.makedirs(self.path, exist_ok=True)

    def _file(self, key):
        return os.path.join(self.path, hashlib.sha256(str(key).encode()).hexdigest() + ".pkl")

    def get(self, key):
        if not getattr(key, "content", True):
            return None
        path = self._file(key)
        try:
            with open(path, "rb") as f:
                value = pickle.load(f)
        except (OSError, pickle.PickleError, EOFError, AttributeError):
            return None
        os.utime(path)
        return value

    def set(self, key, value):
        if not getattr(key, "content", True):
            return
        path = self._file(key)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)  # a reader never sees half a file
        except (OSError, pickle.PickleError, TypeError, AttributeError):
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            return
        self._evict()

    def _entries(self):
        with os.scandir(self.path) as it:
            return [(e.stat().st_atime, e.stat().st_size, e.path) for e in it
                    if e.name.endswith(".pkl")]

    def _evict(self):
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        for _, size, path in sorted(entries):
            if total <= self.size_limit:
                break
            with contextlib.suppress(OSError):
                os.unlink(path)
            total -= size

    def clear(self):
        for _, _, path in self._entries():
            with contextlib.suppress(OSError):
                os.unlink(path)

    def __len__(self):
        return len(self._entries())


class RedisCache:
    """Pickles in redis (vaex_tpu/cache.py:227-249); needs the ``redis``
    client, which it imports when made; only content keys."""

    def __init__(self, client=None):
        if client is None:
            import redis  # not a dependency: only this backend needs it
            client = redis.Redis()
        self.client = client

    def get(self, key):
        if not getattr(key, "content", True):
            return None
        raw = self.client.get(str(key))
        return None if raw is None else pickle.loads(raw)

    def set(self, key, value):
        if not getattr(key, "content", True):
            return
        with contextlib.suppress(TypeError, pickle.PickleError, AttributeError):
            self.client.set(str(key), pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))

    def clear(self):
        self.client.flushdb()


class MultilevelCache:
    """Levels, the fastest first: a miss falls through, a hit fills the
    faster levels."""

    def __init__(self, *levels):
        self.levels = list(levels)

    def get(self, key):
        for i, level in enumerate(self.levels):
            value = level.get(key)
            if value is not None:
                for upper in self.levels[:i]:
                    upper.set(key, value)
                return value
        return None

    def set(self, key, value):
        for level in self.levels:
            level.set(key, value)

    def clear(self):
        for level in self.levels:
            level.clear()


def _make_backend(spec):
    levels = []
    for part in (p.strip() for p in str(spec).split(",") if p.strip()):
        if part in ("memory", "memory_infinite"):
            levels.append(MemoryCache())
        elif part == "memory_lru":
            levels.append(MemoryCacheLRU(settings.CACHE_MEMORY_SIZE_LIMIT))
        elif part == "disk":
            levels.append(DiskCache())
        elif part == "redis":
            levels.append(RedisCache())
        elif part == "disabled":
            return None
        else:
            raise ValueError(f"unknown cache backend {part!r}; expected memory, memory_lru, "
                             "disk, redis or disabled")
    if not levels:
        return None
    return levels[0] if len(levels) == 1 else MultilevelCache(*levels)


_backend = _make_backend(settings.CACHE)
_enabled = _backend is not None
# results that hold tensors: bounded by their bytes, so that eviction frees
# the card's memory; never on disk
device_backend = MemoryCacheLRU(settings.CACHE_DEVICE_SIZE_LIMIT)


def configure(spec):
    """Set the backend from a spec (``"memory"``, ``"memory,disk"``, ...)."""
    global _backend, _enabled
    with _lock:
        _backend = _make_backend(spec)
        _enabled = _backend is not None


def is_on():
    return _enabled


def lookup(key):
    """The value stored under ``key``, or None (counted in ``hits`` /
    ``misses``)."""
    global hits, misses
    if not _enabled:
        return None
    with _lock:
        value = device_backend.get(key)
        if value is None:
            value = _backend.get(key)
    if value is None:
        misses += 1
    else:
        hits += 1
    return value


def store(key, value, device=False):
    """Keep ``value`` under ``key``: in the device LRU where it holds
    tensors, else in the backend, whatever ``device`` says (vaex_tpu's
    caller names the level, vaex_tpu/cache.py:281-289)."""
    if not _enabled:
        return
    with _lock:
        (device_backend if holds_tensors(value) else _backend).set(key, value)


def clear():
    """Empty every level; returns the bytes the device LRU held."""
    with _lock:
        freed = device_backend.nbytes
        if _backend is not None:
            _backend.clear()
        device_backend.clear()
    return freed


@contextlib.contextmanager
def _swap(backend):
    global _backend, _enabled
    old = _backend, _enabled
    _backend, _enabled = backend, backend is not None
    try:
        yield backend
    finally:
        _backend, _enabled = old


@contextlib.contextmanager
def off():
    """No lookup and no store inside the block."""
    with _swap(None):
        yield


@contextlib.contextmanager
def memory_infinite(clear_on_exit=False):
    with _swap(MemoryCache()) as backend:
        yield
    if clear_on_exit:
        backend.clear()


@contextlib.contextmanager
def memory(size_limit=None, clear_on_exit=False):
    with _swap(MemoryCacheLRU(size_limit or settings.CACHE_MEMORY_SIZE_LIMIT)) as backend:
        yield
    if clear_on_exit:
        backend.clear()


@contextlib.contextmanager
def disk(path=None, size_limit=None, clear_on_exit=False):
    with _swap(DiskCache(path=path, size_limit=size_limit)) as backend:
        yield
    if clear_on_exit:
        backend.clear()

"""Runtime configuration for vaex_tpu_torch.

Env vars (optional):
  VAEX_TPU_TORCH_DEVICE     device that ``DataFrame.to_device()`` stages to
                            when none is given, and that a pass over a frame
                            of host arrays no one staged runs on (default
                            'cuda': without a card such a pass raises)
  VAEX_TPU_TORCH_CACHE      the result cache's backend (:mod:`.cache`):
                            'memory' (default), 'memory_lru', 'disk',
                            'memory,disk', 'redis' or 'disabled'
  VAEX_TPU_TORCH_CACHE_DISK_PATH, VAEX_TPU_TORCH_CACHE_DISK_SIZE_LIMIT,
  VAEX_TPU_TORCH_CACHE_MEMORY_SIZE_LIMIT, VAEX_TPU_TORCH_CACHE_DEVICE_SIZE_LIMIT
                            the disk level's directory and bytes, the LRU's
                            bytes, the bytes of results that hold tensors
  VAEX_TPU_TORCH_NUM_PROCESSES  the processes of ``multiprocessing=True``
                            (default: the CPU count, at most 16)
  VAEX_TPU_TORCH_PREFETCH   chunks a thread reads ahead of a pass over host
                            columns when TRANSFER_AHEAD is 0 (default 2)
  VAEX_TPU_TORCH_TRANSFER_AHEAD  tiles of host columns copied to the pass
                            device ahead of its compute, through page-locked
                            slots and a copy stream (default 2; 0 and
                            PREFETCH 0: the synchronous copy, :mod:`.stream`)
  VAEX_TPU_TORCH_NUM_THREADS_IO  threads of a streamed tile's host copy
                            (default 8)
  VAEX_TPU_TORCH_STREAM_RING_BYTES  the most bytes of host memory the
                            page-locked slots of one streamed pass hold: its
                            tile is clamped to fit (default 4 GiB)

Dotted-key settings (``get`` / ``store``) are read at import from
``~/.vaex_tpu_torch/main.yml`` where ``yaml`` imports; a missing or bad file
leaves them empty and never breaks the import.

A pass runs eagerly, tile by tile; every tile costs a few kernel launches
and one fold of the kernel's per-CTA partials, so tiles are large.  On an
NVIDIA H100 80GB HBM3 (power limit 700.00 W) a 1e8-row groupby(sum, count)
took 3.43 / 2.86 / 2.70 / 2.67 ms with tiles of 2^22 / 2^24 / 2^26 / all
rows; 2^26 rows keep the per-tile temporaries near 1 GB.
"""

from __future__ import annotations

import os

TILE_ROWS = 1 << 26  # rows per tile of a pass
DEVICE = os.environ.get("VAEX_TPU_TORCH_DEVICE", "cuda")


def _int_env(name, default):
    value = os.environ.get(name)
    return int(value) if value else default


CACHE = os.environ.get("VAEX_TPU_TORCH_CACHE", "memory")
CACHE_DISK_PATH = os.environ.get("VAEX_TPU_TORCH_CACHE_DISK_PATH",
                                 os.path.join(os.path.expanduser("~"), ".vaex_tpu_torch", "cache"))
CACHE_DISK_SIZE_LIMIT = _int_env("VAEX_TPU_TORCH_CACHE_DISK_SIZE_LIMIT", 10 << 30)
CACHE_MEMORY_SIZE_LIMIT = _int_env("VAEX_TPU_TORCH_CACHE_MEMORY_SIZE_LIMIT", 1 << 30)
# a one-sort groupby of 1e8 groups holds about 6.4 GB of result columns
CACHE_DEVICE_SIZE_LIMIT = _int_env("VAEX_TPU_TORCH_CACHE_DEVICE_SIZE_LIMIT", 8 << 30)
NUM_PROCESSES = _int_env("VAEX_TPU_TORCH_NUM_PROCESSES", 0)
# the streamed pass over host columns (vaex_tpu/settings.py:45-48)
PREFETCH = _int_env("VAEX_TPU_TORCH_PREFETCH", 2)
TRANSFER_AHEAD = _int_env("VAEX_TPU_TORCH_TRANSFER_AHEAD", 2)
NUM_THREADS_IO = _int_env("VAEX_TPU_TORCH_NUM_THREADS_IO", 8)
# config 1's two columns keep TILE_ROWS' tiles (3 slots of 2^26 rows at 18 B
# a row: 3.6 GB); a 30-column float64 pass streams 2^22-row tiles
STREAM_RING_BYTES = _int_env("VAEX_TPU_TORCH_STREAM_RING_BYTES", 4 << 30)

_main = {}


def _load_yaml():
    """The dotted keys of ``~/.vaex_tpu_torch/main.yml`` (nested mappings
    joined by dots) into the settings (vaex_tpu/settings.py:50-84)."""
    path = os.path.join(os.path.expanduser("~"), ".vaex_tpu_torch", "main.yml")
    if not os.path.exists(path):
        return
    try:
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}

        def flatten(prefix, d):
            for k, v in d.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    flatten(key, v)
                else:
                    _main[key] = v
        flatten("", data)
    except Exception:  # a bad file never breaks the import
        pass


_load_yaml()


def get(key: str, default=None):
    """The setting of a dotted key, or ``default``."""
    return _main.get(key, default)


def store(key: str, value):
    """Set a dotted key for this process (the file is not written)."""
    _main[key] = value

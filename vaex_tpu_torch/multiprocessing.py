"""Python UDFs over a pool of processes (the counterpart of
``vaex_tpu/multiprocessing.py``): ``add_function(...,
multiprocessing=True)`` splits each host-stage chunk over the pool.

The pool is made from a ``"forkserver"`` context: a fork of a process in
which CUDA has started is unsafe, and a pass on the card has started it
(vaex_tpu forks).  The workers get numpy chunks only, never a tensor, and
the function must pickle (a module-level function).  As with any
``"forkserver"`` or ``"spawn"`` pool, the script that runs it keeps its work
under ``if __name__ == "__main__":``: the server imports the main module.
Its size is
``settings.NUM_PROCESSES`` (``VAEX_TPU_TORCH_NUM_PROCESSES``), else the CPU
count, at most 16.
"""

from __future__ import annotations

import os

import numpy as np

from . import settings

_pool = None
# fewer rows than this run in the calling process: not worth the copies
MIN_ROWS = 10_000


def _get_pool():
    global _pool
    if _pool is None:
        import multiprocessing as mp
        n = settings.NUM_PROCESSES or os.cpu_count() or 4
        _pool = mp.get_context("forkserver").Pool(min(n, 16))
    return _pool


def close_pool():
    """Stop the pool's processes (a later call makes a new pool)."""
    global _pool
    if _pool is not None:
        _pool.terminate()
        _pool.join()
        _pool = None


def _run_chunk(payload):
    f, vectorize, chunks = payload
    if vectorize:
        return np.asarray(f(*chunks))
    return np.asarray([f(*row) for row in zip(*chunks)])


def apply_parallel(f, arrays, vectorize=True, chunks=None):
    """``f`` over numpy ``arrays`` split into ``chunks`` parts (twice the
    pool's processes by default), one part a task of the pool; the results
    joined in order."""
    n = len(arrays[0]) if arrays else 0
    if n < MIN_ROWS:
        return _run_chunk((f, vectorize, arrays))
    pool = _get_pool()
    bounds = np.linspace(0, n, (chunks or pool._processes * 2) + 1).astype(int)
    payloads = [(f, vectorize, [a[i1:i2] for a in arrays])
                for i1, i2 in zip(bounds[:-1], bounds[1:]) if i2 > i1]
    return np.concatenate(pool.map(_run_chunk, payloads))

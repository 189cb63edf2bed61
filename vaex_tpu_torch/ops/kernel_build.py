"""Building the CUDA kernel libraries of ``vaex_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``vaex_tpu_torch/_build/<name>-<key>.so``,
where the key hashes the source, every header of ``csrc`` (``*.cuh``) and
the flags.  A library is built at first use; :func:`build` starts one
``nvcc`` per source, all at once, so that a caller that needs several
kernels waits for the slowest build only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def source(name):
    return os.path.join(CSRC, f"{name}.cu")


def headers():
    """Every header of csrc, in name order: a source may include any of them."""
    return sorted(os.path.join(CSRC, x) for x in os.listdir(CSRC) if x.endswith(".cuh"))


def _target(name):
    h = hashlib.sha256()
    for path in (source(name), *headers()):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(*names):
    """Compile the named libraries that are not built yet, all nvcc runs at
    once; returns {name: (path, seconds, compiler log)} (0 s and no log for
    a library that was already built)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    results, running = {}, []
    t0 = time.perf_counter()
    for name in names:
        path = _target(name)
        if os.path.exists(path):
            results[name] = (path, 0.0, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, source(name)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed to build {source(name)}:\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
        results[name] = (path, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


@functools.lru_cache(maxsize=None)
def library(name, smem_budget, max_cols):
    """The loaded library of ``csrc/<name>.cu``, built if needed; checks that
    its SMEM_BUDGET and MAX_COLS agree with the wrapper's."""
    path = build(name)[name][0]
    lib = ctypes.CDLL(path)
    for suffix, want in (("smem_budget", smem_budget), ("max_cols", max_cols)):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}_{suffix} of {path} disagrees with its wrapper")
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


def raise_on_error(lib, name, code):
    if code != 0:
        message = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: {message}")


def column_args(int_cols, float_cols):
    """HOST arrays of device pointers and float32 flags, as the kernels'
    C interfaces take them."""
    int_ptrs = (ctypes.c_void_p * max(1, len(int_cols)))(*[c.data_ptr() for c in int_cols])
    float_ptrs = (ctypes.c_void_p * max(1, len(float_cols)))(
        *[c.data_ptr() for c in float_cols])
    float_f32 = (ctypes.c_int * max(1, len(float_cols)))(
        *[int(c.dtype.itemsize == 4) for c in float_cols])
    return int_ptrs, float_ptrs, float_f32

"""The set probe: for each row the ordinal of the equal key among M sorted,
unique, NaN-free keys, else -1.  The hand-written CUDA kernel, its plain
version, its wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_probe.py:_probe_kernel`` (through
``probe_ordinals``): ``keys`` [M] and ``x`` [N] of any int or float dtype up
to 64 bits give ``out`` [N] int32.  Values compare as numbers: ``-0.0``
finds the key ``0.0`` and a NaN row gives -1.  The kernel source is
``vaex_tpu_torch/csrc/probe.cu``; it is compiled with ``nvcc`` at first use
(:mod:`vaex_tpu_torch.ops.kernel_build`).  A set of up to ``MAX_KEYS`` keys
is searched in shared memory; a wider one stays in global memory and shared
memory holds every S-th key, the top levels of the search (the source's
second kernel).  So a CUDA tensor always goes through hand-written code, and
the plain version serves CPU tensors only.

Integer rows against integer keys compare in int64, everything else in
float64 (an int64 beyond 2^53 against a float key rounds, as in numpy).
uint64 has no signed 64-bit image with the same order, and raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build

# mirrors SMEM_BUDGET / UNROLL in csrc/probe.cu (the first is checked at load)
SMEM_BUDGET = 227 * 1024
UNROLL = 4
# the widest set whose 8-byte keys fit one CTA's shared memory
MAX_KEYS = SMEM_BUDGET // 8
# the most samples of a wider set that the second kernel keeps in shared
# memory: 64 KiB, so that three CTAs of 512 threads share an SM
TOP_KEYS = 8192
# an H100 SM holds 228 KiB of shared memory (1 KiB per CTA is the system's)
# and 2048 threads
SM_SMEM = 228 << 10
SM_THREADS = 2048
UINT64 = getattr(torch, "uint64", None)


def compare_dtype(keys, x):
    """The dtype both sides widen to: int64 when both are integral (bool
    included), else float64."""
    for t in (keys, x):
        if t.dtype == UINT64:
            raise NotImplementedError(
                "a set probe of uint64 values is not ported yet (ROADMAP queue A5): their "
                "order differs from int64's")
    if keys.is_floating_point() or x.is_floating_point():
        return torch.float64
    return torch.int64


def probe_reference(keys, x):
    """The plain PyTorch version: ``searchsorted``, gather, compare."""
    dtype = compare_dtype(keys, x)
    keys, x = keys.to(dtype), x.to(dtype)
    M = keys.shape[0]
    if M == 0:
        return torch.full(x.shape, -1, dtype=torch.int32, device=x.device)
    # NaN rows sort past the last key: the clamp brings them back in range
    # and the compare rejects them
    idx = torch.searchsorted(keys, x).clamp_(max=M - 1)
    return torch.where(keys[idx] == x, idx, -1).to(torch.int32)


def plan(n, M, sm_count):
    """(n_ctas, threads) of one launch: as many CTAs as an SM's shared memory
    and threads hold, each walking at least one step of its UNROLL rows per
    thread; one CTA of 1024 threads per SM once the keys take most of it."""
    smem = M * 8 + 1024
    threads = 1024 if smem > SM_SMEM // 2 else 512
    ctas_per_sm = max(1, min(SM_THREADS // threads, SM_SMEM // smem))
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // (threads * UNROLL))))
    return n_ctas, threads


def plan_wide(n, M, sm_count):
    """(n_ctas, threads, S) of one launch on a set past MAX_KEYS: S is the
    least power of two whose ceil(M / S) samples number at most TOP_KEYS."""
    S = 2
    while -(-M // S) > TOP_KEYS:
        S *= 2
    smem = -(-M // S) * 8 + 1024
    threads = 512
    ctas_per_sm = max(1, min(SM_THREADS // threads, SM_SMEM // smem))
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // (threads * UNROLL))))
    return n_ctas, threads, S


def _library():
    lib = kernel_build.library("probe", SMEM_BUDGET)
    lib.probe_run.restype = ctypes.c_int
    lib.probe_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_wide_run.restype = ctypes.c_int
    lib.probe_wide_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def check_inputs(keys, x):
    if keys.dim() != 1 or x.dim() != 1:
        raise ValueError(f"keys and x must be 1-d, got {tuple(keys.shape)} and {tuple(x.shape)}")
    if keys.device != x.device:
        raise ValueError(f"keys on {keys.device}, x on {x.device}")
    for t in (keys, x):
        if t.is_complex():
            raise TypeError(f"a set probe takes int and float values, got {t.dtype}")


def probe(keys, x):
    """int32 ordinals of ``x`` among ``keys``; see the module docstring.  CPU
    tensors take the plain version; CUDA tensors launch the kernel of their
    set's size (``probe.launches`` counts both, ``probe.wide_launches`` the
    second kernel's), or raise."""
    check_inputs(keys, x)
    if x.device.type == "cpu":
        return probe_reference(keys, x)
    if x.device.type != "cuda":
        raise ValueError(f"probe runs on CPU or CUDA tensors, not {x.device}")
    M, n = keys.shape[0], x.shape[0]
    if not 1 <= M < 2 ** 31:
        raise ValueError(f"probe: a set of {M} keys does not fit the kernel "
                         f"(1 to {2 ** 31 - 1} keys)")
    dtype = compare_dtype(keys, x)
    keys = keys.to(dtype).contiguous()
    # 4-byte rows of the keys' kind widen in the kernel's load, the rest here
    narrow = torch.float32 if dtype == torch.float64 else torch.int32
    if x.dtype != narrow:
        x = x.to(dtype)
    x = x.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = _library()
    wide = M > MAX_KEYS
    args = (keys.data_ptr(), M, int(dtype == torch.float64), x.data_ptr(), x.element_size(), n,
            out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wide:
            n_ctas, threads, S = plan_wide(n, M, sm_count)
            err = lib.probe_wide_run(*args, S, n_ctas, threads, stream)
        else:
            n_ctas, threads = plan(n, M, sm_count)
            err = lib.probe_run(*args, n_ctas, threads, stream)
    kernel_build.raise_on_error(lib, "probe", err)
    probe.launches += 1
    probe.wide_launches += int(wide)
    return out


probe.launches = 0
probe.wide_launches = 0

"""Per-bin additive sums over bin windows (kernel B2): the hand-written CUDA
kernel, its plain version, its wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_gridagg.py:_channels2_kernel`` (through
``fused_additive_two_level_channels``), with B1's contract
(:mod:`.grid_additive`): ``idx`` [N] int32, rows outside [0, G) drop; int64
columns summed mod 2^64; f32/f64 columns summed in f64 with NaN adding
nothing; an implicit count.  Returns ``(int_sums [count + k, G] int64,
float_sums [m, G] float64)``.

The grid is cut into windows of ``W`` bins; a CTA keeps one [C, W] window
grid in shared memory, shared by its warps and updated with 64-bit
shared-memory atomics, and the CTAs of a window all walk the rows and keep
those that fall in it.  Integer sums are exact; float sums are not
reproducible run to run (the order of the atomic adds varies).  The plain
version adds the same windows one after the other, so the window
arithmetic runs on the CPU too.  Source:
``vaex_tpu_torch/csrc/grid_window.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .grid_additive import (MAX_COLS, MIN_STEPS_PER_WARP, SM_SMEM, SM_THREADS, SMEM_BUDGET,
                            STAGE_ROWS, check_cuda, check_inputs, grid_additive_reference,
                            n_channels)

WARPS = 32  # warps per CTA, all sharing its window grid


def window_width(C):
    """Bins per window: a CTA's [C, W] words fill the budget."""
    return SMEM_BUDGET // (8 * C)


def n_windows(G, C):
    return -(-G // window_width(C))


def plan(n, G, C, sm_count):
    """(W, n_win, n_slices) of one launch: the CTAs of all windows together
    fill the card once."""
    W = window_width(C)
    n_win = -(-G // W)
    smem = C * W * 8
    resident = sm_count * max(1, min(SM_THREADS // (WARPS * 32), SM_SMEM // smem))
    rows_per_cta = WARPS * STAGE_ROWS * MIN_STEPS_PER_WARP
    n_slices = max(1, min(resident // n_win, -(-n // rows_per_cta), 65535))
    return W, n_win, n_slices


def grid_window_reference(idx, int_cols, float_cols, G, count):
    """The plain PyTorch version: the windows of the kernel one after the
    other, each an ``index_add_`` of the rows that fall in it."""
    G = int(G)
    W = window_width(n_channels(len(int_cols), len(float_cols), count))
    int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                           device=idx.device)
    float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=idx.device)
    for w0 in range(0, G, W):
        Wc = min(W, G - w0)
        # rows outside the window land outside [0, Wc) and drop
        window = torch.where(idx >= w0, idx - w0, -1).to(torch.int32)
        int_w, float_w = grid_additive_reference(window, int_cols, float_cols, Wc, count)
        int_sums[:, w0:w0 + Wc] = int_w
        float_sums[:, w0:w0 + Wc] = float_w
    return int_sums, float_sums


def _library():
    lib = kernel_build.library("grid_window", SMEM_BUDGET, MAX_COLS)
    lib.grid_window_run.restype = ctypes.c_int
    lib.grid_window_run.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def grid_window(idx, int_cols, float_cols, G, count):
    """Per-bin sums; see the module docstring.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise when it cannot take them."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_window_reference(idx, int_cols, float_cols, G, count)
    check_cuda("grid_window", idx, int_cols, float_cols)
    C = n_channels(len(int_cols), len(float_cols), count)
    if len(int_cols) + len(float_cols) > MAX_COLS or C * G >= 2 ** 31:
        raise ValueError(f"grid_window: G={G} with {C} channels does not fit the kernel")
    n = idx.shape[0]
    device = idx.device
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    W, _, n_slices = plan(n, G, C, sm_count)
    int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                           device=device)
    float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=device)
    scratch = torch.empty(n_slices * C * G, dtype=torch.int64, device=device)
    int_ptrs, float_ptrs, float_f32 = kernel_build.column_args(int_cols, float_cols)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.grid_window_run(
            idx.data_ptr(), n, G, W, int(bool(count)),
            ctypes.addressof(int_ptrs), len(int_cols),
            ctypes.addressof(float_ptrs), ctypes.addressof(float_f32), len(float_cols),
            n_slices, WARPS, scratch.data_ptr(),
            int_sums.data_ptr(), float_sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_window", err)
    grid_window.launches += 1
    return int_sums, float_sums


grid_window.launches = 0

"""Per-bin additive sums over bin windows (kernel B2): the hand-written CUDA
kernel, its plain version, its wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_gridagg.py:_channels2_kernel`` (through
``fused_additive_two_level_channels``), with B1's contract
(:mod:`.grid_additive`): ``idx`` [N] int32, rows outside [0, G) drop; int64
columns summed mod 2^64; f32/f64 columns summed in f64 with NaN adding
nothing; an implicit count.  Returns ``(int_sums [count + k, G] int64,
float_sums [m, G] float64)``.

The grid is cut into ``n_win`` windows of ``W`` bins, at most
``MAX_CLUSTER``, and a thread-block cluster of ``n_win`` CTAs holds them
all in its distributed shared memory, one window per CTA: each CTA walks
its own rows once and adds each into the window that owns its bin, its own
or a neighbour's; a grid of one window is a plain launch, no cluster, which
measured faster (PERF.md, section 6).  A window holds a 32-bit count and an
8-byte word per value column for each bin (:func:`cluster_width`); a call
takes fewer than 2^32 rows.  Integer sums are exact; float sums are not reproducible
run to run (the order of the atomic adds varies).  The plain version adds
the same windows one after the other, so the window arithmetic runs on the
CPU too.  Source: ``vaex_tpu_torch/csrc/grid_window.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernel_build
from .grid_additive import (CLUSTER_SMEM, MAX_COLS, MIN_STEPS_PER_WARP, STAGE_ROWS, check_cuda,
                            check_inputs, grid_additive_reference, n_channels)

WARPS = 32  # warps per CTA, all sharing its window
MAX_CLUSTER = 8  # the portable cluster size; mirrors csrc/grid_window.cu (checked at load)


def window_bytes(W, C, count):
    """Shared memory of one CTA's window of W bins: a 32-bit count (where
    ``count``) and an 8-byte word per value column for each bin."""
    count = int(bool(count))
    return W * (4 * count + 8 * (C - count))


def cluster_width(C, count):
    """The widest window of one B2 CTA within ``CLUSTER_SMEM``; even, so the
    value planes stay 8-byte aligned."""
    return (CLUSTER_SMEM // window_bytes(1, C, count)) & ~1


def cluster_windows(G, C, count):
    """B2's cluster size for a grid of G bins: windows of at most
    ``cluster_width`` bins."""
    return -(-G // cluster_width(C, count))


def fits(G, C, count):
    """True when one cluster holds the grid."""
    return 1 <= C and cluster_windows(G, C, count) <= MAX_CLUSTER


def cluster_window(G, C, count):
    """(W, n_win): the fewest windows that hold the grid, of equal even
    width."""
    n_win = cluster_windows(G, C, count)
    W = -(-G // n_win)
    return W + (W & 1), n_win


def plan(n, G, C, count, max_clusters):
    """(W, n_win, n_clusters) of one launch: as many clusters as the card
    holds at once (``max_clusters``, from the occupancy query), fewer when
    the rows would give a CTA less than its share of work."""
    W, n_win = cluster_window(G, C, count)
    rows_per_cta = WARPS * STAGE_ROWS * MIN_STEPS_PER_WARP
    n_clusters = max(1, min(max_clusters, -(-n // (rows_per_cta * n_win))))
    return W, n_win, n_clusters


def grid_window_reference(idx, int_cols, float_cols, G, count, W=None):
    """The plain PyTorch version: the windows of the kernel (of W bins; B2's
    cluster windows by default) one after the other, each an ``index_add_``
    of the rows that fall in it."""
    G = int(G)
    if W is None:
        W, _ = cluster_window(G, n_channels(len(int_cols), len(float_cols), count), count)
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
    lib = kernel_build.library("grid_window", CLUSTER_SMEM, MAX_COLS)
    fn = lib.grid_window_max_cluster
    fn.restype = ctypes.c_int
    if fn() != MAX_CLUSTER:
        raise RuntimeError("grid_window_max_cluster disagrees with its wrapper")
    lib.grid_window_clusters.restype = ctypes.c_int
    lib.grid_window_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.grid_window_run.restype = ctypes.c_int
    lib.grid_window_run.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def max_clusters(device_index, n_win, smem):
    """The clusters of ``n_win`` CTAs of ``smem`` bytes of window each that
    the card holds at once (``cudaOccupancyMaxActiveClusters``; one window:
    the plain launch's resident CTAs)."""
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.grid_window_clusters(n_win, smem, WARPS, ctypes.byref(out))
    kernel_build.raise_on_error(lib, "grid_window", err)
    if out.value < 1:
        raise RuntimeError(f"grid_window: no cluster of {n_win} CTAs of {smem} bytes of window "
                           f"fits the card")
    return out.value


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
    if len(int_cols) + len(float_cols) > MAX_COLS or not fits(G, C, count):
        raise ValueError(f"grid_window: G={G} with {C} channels does not fit the kernel "
                         f"(at most {MAX_CLUSTER} windows of {cluster_width(C, count)} bins)")
    n = idx.shape[0]
    if n >= 2 ** 32:
        raise ValueError(f"grid_window: {n} rows in one call; its 32-bit counts take fewer "
                         f"than 2^32")
    device = idx.device
    W, n_win = cluster_window(G, C, count)
    W, n_win, n_clusters = plan(n, G, C, count,
                                max_clusters(device.index, n_win, window_bytes(W, C, count)))
    int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                           device=device)
    float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=device)
    scratch = torch.empty(n_clusters * C * G, dtype=torch.int64, device=device)
    int_ptrs, float_ptrs, float_f32 = kernel_build.column_args(int_cols, float_cols)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.grid_window_run(
            idx.data_ptr(), n, G, W, n_win, int(bool(count)),
            ctypes.addressof(int_ptrs), len(int_cols),
            ctypes.addressof(float_ptrs), ctypes.addressof(float_f32), len(float_cols),
            n_clusters, WARPS, scratch.data_ptr(),
            int_sums.data_ptr(), float_sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_window", err)
    grid_window.launches += 1
    return int_sums, float_sums


grid_window.launches = 0

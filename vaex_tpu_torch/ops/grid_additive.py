"""Per-bin additive sums: the hand-written CUDA kernel, its plain version,
its wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_gridagg.py:_channels_kernel`` (through
``fused_additive_channels``).  One pass over ``idx`` [N] int32 adds up to
``MAX_COLS`` int64 and float columns, and optionally an implicit count, into
per-bin sums:

* ``int_sums`` [count + k, G] int64: row 0 is the count when ``count`` is
  set, then one row per int column; exact mod 2^64.
* ``float_sums`` [m, G] float64: f32 columns are widened; NaN adds nothing.

Rows whose ``idx`` lies outside [0, G) add nothing.  The kernel source is
``vaex_tpu_torch/csrc/grid_additive.cu``; it is compiled with ``nvcc`` at
first use (:mod:`vaex_tpu_torch.ops.kernel_build`).  It takes the grids
whose warp-private grid fits shared memory (:func:`fits`); wider grids go
to B2 (:mod:`.grid_window`) or B3 (:mod:`.grid_partition`), as
:mod:`.grid_plan` picks.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build

# mirrors SMEM_BUDGET / MAX_COLS / STAGE_ROWS in csrc/grid_common.cuh
# (the first two are checked at load)
SMEM_BUDGET = 192 * 1024
# the most dynamic shared memory a CTA may take on an H100 (227 KiB): the
# kernels that keep one CTA per SM take all of it; mirrors CLUSTER_SMEM in
# csrc/grid_common.cuh
CLUSTER_SMEM = 227 * 1024
MAX_COLS = 32
STAGE_ROWS = 4 * 32  # UNROLL rows per lane of a warp step, at most
MAX_WARPS = 8
# the routes of B1 (csrc/grid_additive.cu): lane-private grids, or the
# warp-private grids of the ordered scheme
LANE, WARP = "lane", "warp"
LANE_UNROLL = 32  # rows a lane takes per step of the lane route (checked at load)
# the lane route while one CTA keeps this many warps of lane grids
LANE_MIN_WARPS = 4
# each warp should walk at least this many 32-row steps, so zeroing and
# folding its private grid stays small against the rows it adds
MIN_STEPS_PER_WARP = 32
# an H100 SM holds 228 KiB of shared memory and 2048 threads
SM_SMEM = 228 << 10
SM_THREADS = 2048


def grid_additive_reference(idx, int_cols, float_cols, G, count):
    """The plain PyTorch version: ``index_add_`` in int64 / float64."""
    G = int(G)
    device = idx.device
    keep = (idx >= 0) & (idx < G)
    bins = idx[keep].to(torch.int64)
    int_sums = torch.zeros((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                           device=device)
    float_sums = torch.zeros((len(float_cols), G), dtype=torch.float64, device=device)
    row = 0
    if count:
        int_sums[0].index_add_(0, bins, torch.ones_like(bins))
        row = 1
    for k, col in enumerate(int_cols):
        int_sums[row + k].index_add_(0, bins, col[keep].to(torch.int64))
    for k, col in enumerate(float_cols):
        v = col[keep].to(torch.float64)
        float_sums[k].index_add_(0, bins, torch.where(torch.isnan(v), 0.0, v))
    return int_sums, float_sums


def n_channels(n_int, n_float, count):
    return int(bool(count)) + n_int + n_float


def warp_bytes(C, W):
    """Shared memory of one warp: its private [C, W] grid and its staging
    words, [C, STAGE_ROWS] (csrc/grid_common.cuh)."""
    return C * (W + STAGE_ROWS) * 8


def fits(G, n_int, n_float, count):
    """True when one warp's [C, G] grid fits the kernel's shared memory."""
    C = n_channels(n_int, n_float, count)
    return 1 <= C and n_int + n_float <= MAX_COLS and warp_bytes(C, G) <= SMEM_BUDGET


def unroll(C):
    """Rows per lane of the warp route's step (csrc/grid_common.cuh
    warp_add): one for up to two channels, four from three on.  On an NVIDIA
    H100 80GB HBM3 (700 W) at G = 103 and 1e8 rows: 0.958 against 1.150 ms
    at C = 2, 1.331 against 1.064 ms at C = 3, 2.640 against 1.570 ms at
    C = 4."""
    return 1 if C <= 2 else 4


def plan(n, G, C, sm_count):
    """(n_ctas, warps) of one launch of the warp route; fixed by its
    arguments, so the order of every addition, and with it every float
    result, is reproducible."""
    warps = min(MAX_WARPS, SMEM_BUDGET // warp_bytes(C, G))
    rows_per_cta = warps * 32 * MIN_STEPS_PER_WARP
    smem = warps * warp_bytes(C, G)
    ctas_per_sm = max(1, min(SM_THREADS // (warps * 32), SM_SMEM // smem))
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // rows_per_cta)))
    return n_ctas, warps


def lane_warp_bytes(G, n_int, n_float, count):
    """Shared memory of one warp's lane grids on the lane route: per lane and
    bin a 32-bit count (where ``count``) and an 8-byte word per column."""
    return 32 * G * (4 * int(bool(count)) + 8 * (n_int + n_float))


def route(G, n_int, n_float, count):
    """``lane`` or ``warp``: the lane route while a CTA of 227 KiB holds
    ``LANE_MIN_WARPS`` warps of its lane grids, else the warp route."""
    if LANE_MIN_WARPS * lane_warp_bytes(G, n_int, n_float, count) <= CLUSTER_SMEM:
        return LANE
    return WARP


def lane_plan(n, G, n_int, n_float, count, sm_count):
    """(n_ctas, warps) of one launch of the lane route: as many warps a CTA
    as its lane grids fit (at most ``MAX_WARPS``), the CTAs the card holds
    at once, fewer where the rows would give a warp less than its share."""
    wb = lane_warp_bytes(G, n_int, n_float, count)
    warps = max(1, min(MAX_WARPS, CLUSTER_SMEM // wb))
    ctas_per_sm = max(1, min(SM_THREADS // (warps * 32), SM_SMEM // (warps * wb)))
    rows_per_cta = warps * 32 * LANE_UNROLL * MIN_STEPS_PER_WARP
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // rows_per_cta)))
    return n_ctas, warps


def _library():
    lib = kernel_build.library("grid_additive", SMEM_BUDGET, MAX_COLS)
    if lib.grid_additive_lane_unroll() != LANE_UNROLL:
        raise RuntimeError("grid_additive_lane_unroll disagrees with its wrapper")
    lib.grid_additive_run.restype = ctypes.c_int
    lib.grid_additive_run.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def check_inputs(idx, int_cols, float_cols, G, count):
    """The checks every grid kernel's wrapper makes before it dispatches."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-d int32, got {idx.dtype} with shape {tuple(idx.shape)}")
    n = idx.shape[0]
    for col in int_cols:
        if col.dtype != torch.int64:
            raise TypeError(f"int columns must be int64, got {col.dtype}")
    for col in float_cols:
        if col.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"float columns must be float32 or float64, got {col.dtype}")
    for col in (*int_cols, *float_cols):
        if col.shape != (n,):
            raise ValueError(f"column shape {tuple(col.shape)} does not match idx ({n},)")
        if col.device != idx.device:
            raise ValueError(f"column on {col.device}, idx on {idx.device}")
    if G < 1 or n_channels(len(int_cols), len(float_cols), count) < 1:
        raise ValueError(f"nothing to add: G={G}, no columns and no count")


def check_cuda(name, idx, int_cols, float_cols):
    if idx.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {idx.device}")
    for t in (idx, *int_cols, *float_cols):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def grid_additive(idx, int_cols, float_cols, G, count):
    """Per-bin sums; see the module docstring.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise when it cannot take them."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_additive_reference(idx, int_cols, float_cols, G, count)
    check_cuda("grid_additive", idx, int_cols, float_cols)
    if not fits(G, len(int_cols), len(float_cols), count):
        raise ValueError(f"grid_additive: G={G} with {len(int_cols)} int and "
                         f"{len(float_cols)} float columns does not fit the kernel")
    n = idx.shape[0]
    C = n_channels(len(int_cols), len(float_cols), count)
    sm_count = torch.cuda.get_device_properties(idx.device).multi_processor_count
    how = route(G, len(int_cols), len(float_cols), count)
    if how == LANE and n >= 2 ** 32:
        raise ValueError(f"grid_additive: {n} rows in one call; the lane route's 32-bit "
                         f"counts take fewer than 2^32")
    if how == LANE:
        n_ctas, warps = lane_plan(n, G, len(int_cols), len(float_cols), count, sm_count)
        rows = 0
    else:
        n_ctas, warps = plan(n, G, C, sm_count)
        rows = unroll(C)
    device = idx.device
    int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                           device=device)
    float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=device)
    scratch = torch.empty(n_ctas * C * G, dtype=torch.int64, device=device)
    int_ptrs, float_ptrs, float_f32 = kernel_build.column_args(int_cols, float_cols)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.grid_additive_run(
            idx.data_ptr(), n, G, int(bool(count)),
            ctypes.addressof(int_ptrs), len(int_cols),
            ctypes.addressof(float_ptrs), ctypes.addressof(float_f32), len(float_cols),
            n_ctas, warps, int(how == LANE), rows, scratch.data_ptr(),
            int_sums.data_ptr(), float_sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_additive", err)
    grid_additive.launches += 1
    grid_additive.last_route = how
    return int_sums, float_sums


grid_additive.launches = 0
grid_additive.last_route = None

"""Per-bin additive sums through a partition of the rows by key range
(kernel B3): the hand-written CUDA kernels, their plain version, the
wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_partition.py:_phase1_kernel`` and
``_phase2_kernel`` (through ``partitioned_additive_channels``), with B1's
contract (:mod:`.grid_additive`): ``idx`` [N] int32, rows outside [0, G)
drop; int64 columns summed mod 2^64; f32/f64 columns summed in f64 with NaN
adding nothing; an implicit count.  Returns ``(int_sums [count + k, G]
int64, float_sums [m, G] float64)``.

The grid is cut into P buckets of S = 2^shift bins; a row's bucket is
``idx >> shift``.  Phase 1 counts the rows of every (bucket, segment of
``seg_rows`` rows; one CTA per segment), turns the counts into exclusive
offsets in bucket-major order (:func:`bucket_offsets`, a cumsum of that
small array) and scatters the low bits of ``idx`` and the values, stably,
into bucketed buffers, each tile of rows counting-sorted by bucket in
shared memory first so the writes go out in runs.  The segments are few
enough that the n_seg * P write frontiers of the scatter stay in L2.  Phase 2 adds every bucket's rows into an S-wide sub-grid in
shared memory and folds in order.  Source:
``vaex_tpu_torch/csrc/grid_partition.cu``.

The counts size every bucket exactly, so phase 1 cannot overflow: none of
the TPU kernel's run capacity (F = 128), its P <= 126 lanes, its headroom
rule or its rerun on the sort path when a run overflowed carries over.
Pre-sorted or fully clustered keys, which forced that rerun, run on the
kernel like any others.  The legacy masked min/max mode of the TPU kernel
(``extreme_cols``) is not ported here (ROADMAP queue A5).

Limits: N < 2^31 rows per call (int32 offsets; a pass hands it tiles of
``settings.TILE_ROWS``) and P <= ``P_MAX`` buckets (phase 1 keeps a running
offset per bucket, and a count per bucket and warp, in shared memory);
:func:`shape` is None past them.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import kernel_build
from .grid_additive import (MAX_COLS, MAX_WARPS, MIN_STEPS_PER_WARP, SM_SMEM, SM_THREADS,
                            SMEM_BUDGET, STAGE_ROWS, check_cuda, check_inputs, n_channels,
                            warp_bytes)

# phase 1: warps per CTA, at most; a tile of warps1 * STAGE_ROWS rows
# should give every bucket a few rows
WARPS1 = 32
MIN_WARPS1 = 4


def scatter_bytes(warps1, P):
    """Shared memory of the scatter (scatter_smem in grid_partition.cu):
    three int32 words per bucket and warp or so, and 6 bytes per tile row."""
    return (warps1 + 2) * P * 4 + warps1 * STAGE_ROWS * 6 + 32 * 4


P_MAX = 7168  # scatter_bytes(MIN_WARPS1, P_MAX) fits SMEM_BUDGET
# phase 1b writes to n_seg * P frontiers per array (the columns and the low
# bits); their partly written 32-byte sectors should stay in the H100's
# 50 MB of L2 until they fill
FRONTIER_BYTES = 24 << 20
# phase 2: the sub-grid width S is the largest power of two with which this
# many warps keep private [C, S] grids (more warps when S is capped by G)
WARPS2 = 4
MAX_SHIFT = 15  # S <= 2^15: the low bits travel as uint16
MIN_SEG_ROWS = 4096

Shape = collections.namedtuple("Shape", "shift S P seg_rows n_seg warps1 warps2")


def shape(n, G, C):
    """The partition of an n-row call over G bins with C channels, or None
    when it is past the kernel's limits."""
    if n >= 2 ** 31:
        return None
    shift = 0
    while (shift < MAX_SHIFT and (1 << shift) < G
           and WARPS2 * warp_bytes(C, 2 << shift) <= SMEM_BUDGET):
        shift += 1
    S = 1 << shift
    P = -(-G // S)
    if P > P_MAX:
        return None
    warps1 = WARPS1
    while scatter_bytes(warps1, P) > SMEM_BUDGET:
        warps1 //= 2
    warps2 = min(MAX_WARPS, SMEM_BUDGET // warp_bytes(C, S))
    max_seg = max(1, FRONTIER_BYTES // (P * (C + 1) * 32))
    tile = warps1 * STAGE_ROWS  # rows of one step of a phase-1 CTA
    seg_rows = max(MIN_SEG_ROWS, -(-(-(-n // max_seg)) // tile) * tile)
    n_seg = max(1, -(-n // seg_rows))
    return Shape(shift, S, P, seg_rows, n_seg, warps1, warps2)


def chunks(n, C, sh, sm_count):
    """Phase-2 CTAs per bucket: enough to fill the card twice, but no fewer
    than MIN_STEPS_PER_WARP warp steps of rows each on average."""
    smem = sh.warps2 * warp_bytes(C, sh.S)
    resident = sm_count * max(1, min(SM_THREADS // (sh.warps2 * 32), SM_SMEM // smem))
    rows_min = sh.warps2 * 32 * MIN_STEPS_PER_WARP
    return max(1, min(-(-2 * resident // sh.P), n // (sh.P * rows_min), 65535))


def bucket_offsets(counts):
    """counts [P, n_seg] -> (offsets [P, n_seg] int32, the exclusive prefix
    in bucket-major order, i.e. where each segment's rows of each bucket
    start; bucket_start [P + 1] int32)."""
    flat = counts.reshape(-1).to(torch.int64)
    ends = torch.cumsum(flat, 0)
    offsets = (ends - flat).to(torch.int32).reshape(counts.shape)
    bucket_start = torch.cat([offsets[:, 0], ends[-1:].to(torch.int32)])
    return offsets, bucket_start


def grid_partition_reference(idx, int_cols, float_cols, G, count):
    """The plain PyTorch version of both phases: the counts and offsets of
    phase 1, a stable partition by bucket, then per-bucket sub-grid sums
    (``index_add_``) laid back out to [C, G]."""
    G = int(G)
    n = idx.shape[0]
    device = idx.device
    sh = shape(n, G, n_channels(len(int_cols), len(float_cols), count))
    if sh is None:
        raise ValueError(f"grid_partition: G={G} at N={n} is past the kernel's limits")
    keep = (idx >= 0) & (idx < G)
    rows = torch.nonzero(keep).squeeze(1)
    bucket = (idx[rows] >> sh.shift).to(torch.int64)
    key = bucket * sh.n_seg + rows // sh.seg_rows
    counts = torch.bincount(key, minlength=sh.P * sh.n_seg).reshape(sh.P, sh.n_seg)
    _, bucket_start = bucket_offsets(counts)
    # phase 1: the stable scatter into bucket order
    order = rows[torch.argsort(bucket, stable=True)]
    lo = (idx[order] & (sh.S - 1)).to(torch.int64)
    # phase 2: bucket p holds slots [bucket_start[p], bucket_start[p + 1])
    sizes = (bucket_start[1:] - bucket_start[:-1]).to(torch.int64)
    bins = torch.repeat_interleave(torch.arange(sh.P, device=device), sizes) * sh.S + lo
    width = sh.P * sh.S
    int_sums = torch.zeros((int(bool(count)) + len(int_cols), width), dtype=torch.int64,
                           device=device)
    float_sums = torch.zeros((len(float_cols), width), dtype=torch.float64, device=device)
    row = 0
    if count:
        int_sums[0].index_add_(0, bins, torch.ones_like(bins))
        row = 1
    for k, col in enumerate(int_cols):
        int_sums[row + k].index_add_(0, bins, col[order].to(torch.int64))
    for k, col in enumerate(float_cols):
        v = col[order].to(torch.float64)
        float_sums[k].index_add_(0, bins, torch.where(torch.isnan(v), 0.0, v))
    return int_sums[:, :G].contiguous(), float_sums[:, :G].contiguous()


def _library():
    lib = kernel_build.library("grid_partition", SMEM_BUDGET, MAX_COLS)
    lib.grid_partition_count.restype = ctypes.c_int
    lib.grid_partition_count.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_finish.restype = ctypes.c_int
    lib.grid_partition_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    return lib


def grid_partition(idx, int_cols, float_cols, G, count):
    """Per-bin sums; see the module docstring.  CPU tensors take the plain
    version; CUDA tensors launch the kernels, or raise when they cannot take
    them."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_partition_reference(idx, int_cols, float_cols, G, count)
    check_cuda("grid_partition", idx, int_cols, float_cols)
    n = idx.shape[0]
    C = n_channels(len(int_cols), len(float_cols), count)
    sh = shape(n, G, C)
    if sh is None or len(int_cols) + len(float_cols) > MAX_COLS or C * G >= 2 ** 31:
        raise ValueError(f"grid_partition: G={G} with {C} channels at N={n} does not fit "
                         f"the kernel")
    device = idx.device
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    n_chunks = chunks(n, C, sh, sm_count)
    lib = _library()
    counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.grid_partition_count(idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows,
                                       sh.n_seg, sh.warps1, counts.data_ptr(), stream)
        kernel_build.raise_on_error(lib, "grid_partition", err)
        offsets, bucket_start = bucket_offsets(counts)
        # sized for all n rows, so no host sync reads the kept count first
        lo = torch.empty(n, dtype=torch.int16, device=device)
        bucketed_int = [torch.empty_like(c) for c in int_cols]
        bucketed_float = [torch.empty_like(c) for c in float_cols]
        int_ptrs, float_ptrs, float_f32 = kernel_build.column_args(int_cols, float_cols)
        b_int, b_float, _ = kernel_build.column_args(bucketed_int, bucketed_float)
        int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                               device=device)
        float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=device)
        scratch = torch.empty(n_chunks * C * G, dtype=torch.int64, device=device)
        err = lib.grid_partition_finish(
            idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, sh.warps1,
            offsets.data_ptr(), bucket_start.data_ptr(), int(bool(count)),
            ctypes.addressof(int_ptrs), len(int_cols),
            ctypes.addressof(float_ptrs), ctypes.addressof(float_f32), len(float_cols),
            ctypes.addressof(b_int), ctypes.addressof(b_float),
            lo.data_ptr(), n_chunks, sh.warps2,
            scratch.data_ptr(), int_sums.data_ptr(), float_sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    grid_partition.launches += 1
    return int_sums, float_sums


grid_partition.launches = 0

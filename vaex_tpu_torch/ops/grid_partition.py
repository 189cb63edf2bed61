"""Per-bin additive sums through a partition of the rows by key range
(kernel B3) and per-bin min/max over the same partition (kernel B3x): the
hand-written CUDA kernels, their plain versions, the wrappers and their
launch counters.

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
kernel like any others.

The TPU kernel's masked min/max mode (``extreme_cols``) is
:func:`grid_partition_extreme`, B3x: E columns, each int64, float64 or
float32 in its own type, each a min or a max, each with an optional validity;
NaN rows, invalid rows and rows outside [0, G) reach no cell, empty cells
hold :func:`.grid_extreme.identity`.  The extreme columns ride the scatter
like any value column and a second phase 2 keeps one [E, S] grid of 64-bit
order-preserving keys per CTA; additive columns may come along, and then
sums and extremes pay one scatter (the TPU function's contract).  A grid
whose E * G * 8 bytes fit one CTA's shared memory takes the same phase 2
over the raw rows with no partition (:func:`extreme_direct_fits`).  The
kernel orders -0.0 below 0.0, so a cell that holds both keeps -0.0 as min
and 0.0 as max; by value that is what ``amin`` / ``amax`` keep.

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
from .grid_extreme import check_extreme_inputs, fold_validity, grid_extreme_batch
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

# the min/max mode: columns per call, at most (MAX_EXT in grid_partition.cu),
# and the threads of a phase-2 CTA
MAX_EXT = 8
EXT_THREADS = 512
# the widest [E, S] grid of keys of a CTA when no sums ride along
EXT_GRID_BYTES = 64 << 10
EXT_TYPES = {torch.int64: 0, torch.float64: 1, torch.float32: 2}

Shape = collections.namedtuple("Shape", "shift S P seg_rows n_seg warps1 warps2")


def shape(n, G, C):
    """The partition of an n-row call over G bins with C channels, or None
    when it is past the kernel's limits."""
    shift = 0
    while (shift < MAX_SHIFT and (1 << shift) < G
           and WARPS2 * warp_bytes(C, 2 << shift) <= SMEM_BUDGET):
        shift += 1
    return _partition(n, G, C, shift)


def extreme_shape(n, G, E, C=0):
    """The partition of a call of the min/max mode with E extreme columns and
    C additive channels (:func:`shape`'s, with the extreme columns counted,
    when sums ride along): alone, the sub-grid is the widest whose [E, S] keys
    take at most ``EXT_GRID_BYTES``.  On an NVIDIA H100 80GB HBM3 (700 W),
    1e8 rows at G = 1 000 003, E = 1: 6.641 ms at S = 1024, 3.746 at 4096,
    3.600 at 8192, 4.077 at 16 384; E = 4: 19.596 at 1024, 13.729 at 2048,
    12.556 at 4096; at G = 67 081, E = 4: 7.549, 6.804 and 8.812 ms."""
    if C:
        return shape(n, G, C + E)
    shift = 0
    while (shift < MAX_SHIFT and (1 << shift) < G
           and E * (2 << shift) * 8 <= EXT_GRID_BYTES):
        shift += 1
    return _partition(n, G, E, shift)


def _partition(n, G, C, shift):
    """The Shape of an n-row call over G bins in buckets of 2^shift bins that
    moves C columns, or None past the kernel's limits."""
    if n >= 2 ** 31:
        return None
    S = 1 << shift
    P = -(-G // S)
    if P > P_MAX:
        return None
    warps1 = WARPS1
    while scatter_bytes(warps1, P) > SMEM_BUDGET:
        warps1 //= 2
    warps2 = max(1, min(MAX_WARPS, SMEM_BUDGET // warp_bytes(C, S)))
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


def extreme_direct_fits(G, E):
    """True when one CTA's [E, G] grid of keys fits shared memory: the
    min/max mode then reads the raw rows and needs no partition."""
    return E * G * 8 <= SMEM_BUDGET


def extreme_chunks(n, smem, P, sm_count):
    """Phase-2 CTAs per bucket of the min/max mode: enough to fill the card
    twice, but no fewer than 8 rows per thread on average."""
    resident = sm_count * max(1, min(SM_THREADS // EXT_THREADS, SM_SMEM // max(smem, 1)))
    return max(1, min(-(-2 * resident // P), n // (P * EXT_THREADS * 8), 65535))


def _library():
    lib = kernel_build.library("grid_partition", SMEM_BUDGET, MAX_COLS)
    lib.grid_partition_max_ext.restype = ctypes.c_int
    if lib.grid_partition_max_ext() != MAX_EXT:
        raise RuntimeError("grid_partition_max_ext disagrees with its wrapper")
    lib.grid_partition_scatter.restype = ctypes.c_int
    lib.grid_partition_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_sums.restype = ctypes.c_int
    lib.grid_partition_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_extremes.restype = ctypes.c_int
    lib.grid_partition_extremes.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
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


def _pointers(tensors):
    """A HOST array of device pointers (null for None)."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * max(1, len(values)))(*[int(v) for v in values])


def grid_partition_extreme_reference(idx, cols, modes, valids, G, int_cols=(), float_cols=(),
                                     count=False):
    """The plain PyTorch version of :func:`grid_partition_extreme`: a
    ``scatter_reduce_`` per extreme column
    (:func:`.grid_extreme.grid_extreme_batch`) and, for the additive columns,
    B3's plain version."""
    grids = grid_extreme_batch(idx, cols, modes, valids, G)
    if not (count or int_cols or float_cols):
        return grids, None, None
    return (grids, *grid_partition_reference(idx, list(int_cols), list(float_cols), G, count))


def extreme_call_fits(n, G, E, n_int=0, n_float=0, count=False):
    """True when one call of :func:`grid_partition_extreme` takes E extreme
    columns and these additive ones (scatter columns counted as if none were
    shared)."""
    C = n_channels(n_int, n_float, count)
    if not 1 <= E <= MAX_EXT or E * G >= 2 ** 31:
        return False
    if not C and extreme_direct_fits(G, E):
        return True
    return (n_int + n_float + E <= MAX_COLS and C * G < 2 ** 31
            and extreme_shape(n, G, E, C) is not None)


def grid_partition_extreme(idx, cols, modes, valids, G, int_cols=(), float_cols=(),
                           count=False):
    """Per-bin min/max of ``cols`` (``modes[e]`` "min" or "max", ``valids[e]``
    a bool tensor or None) and, from the same partition, B3's sums of the
    additive columns when any are given; see the module docstring.  Returns
    ``(grids, int_sums, float_sums)``: a [G] tensor per extreme column in its
    dtype, and the sums as :func:`grid_partition` returns them (None, None
    without additive columns).  CPU tensors take the plain version; CUDA
    tensors launch the kernels, or raise when they cannot take them."""
    G = int(G)
    cols, modes, valids = list(cols), list(modes), list(valids)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_extreme_inputs(idx, cols, modes, valids, G)
    additive = bool(count or int_cols or float_cols)
    if additive:
        check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_partition_extreme_reference(idx, cols, modes, valids, G, int_cols,
                                                float_cols, count)
    check_cuda("grid_partition_extreme", idx, int_cols, float_cols)
    check_cuda("grid_partition_extreme", idx, cols, [v for v in valids if v is not None])
    n, E, device = idx.shape[0], len(cols), idx.device
    if not extreme_call_fits(n, G, E, len(int_cols), len(float_cols), count):
        raise ValueError(f"grid_partition_extreme: G={G} with {E} extreme columns and "
                         f"{n_channels(len(int_cols), len(float_cols), count)} additive "
                         f"channels at N={n} does not fit the kernel")
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    lib = _library()
    grids = [torch.empty(G, dtype=c.dtype, device=device) for c in cols]
    types, is_max = _ints([EXT_TYPES[c.dtype] for c in cols]), _ints([m == "max" for m in modes])
    int_sums = float_sums = None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if not additive and extreme_direct_fits(G, E):
            shift = max(0, (G - 1).bit_length())
            n_chunks = extreme_chunks(n, E * G * 8, 1, sm_count)
            scratch = torch.empty(n_chunks * E * G, dtype=torch.int64, device=device)
            masks = [None if v is None else v.view(torch.uint8) for v in valids]
            err = lib.grid_partition_extremes(
                1, None, idx.data_ptr(), n, None, G, shift, 1,
                _pointers(cols), _pointers(masks),
                _pointers(grids), types,
                is_max, E, n_chunks, EXT_THREADS, scratch.data_ptr(), stream)
            kernel_build.raise_on_error(lib, "grid_partition", err)
            grid_partition_extreme.launches += 1
            return grids, None, None
        C = n_channels(len(int_cols), len(float_cols), count)
        sh = extreme_shape(n, G, E, C)
        # an invalid row travels as a value that reaches no cell
        ext = [fold_validity(c, m, v) for c, m, v in zip(cols, modes, valids)]
        # every distinct column is scattered once, however many phase 2s read it
        unique = {}
        for c in (*int_cols, *float_cols, *ext):
            unique.setdefault((c.data_ptr(), c.dtype), c)
        sources = list(unique.values())
        bucketed = {key: torch.empty_like(c) for key, c in unique.items()}

        def moved(columns):
            return [bucketed[(c.data_ptr(), c.dtype)] for c in columns]
        counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device=device)
        err = lib.grid_partition_count(idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows,
                                       sh.n_seg, sh.warps1, counts.data_ptr(), stream)
        kernel_build.raise_on_error(lib, "grid_partition", err)
        offsets, bucket_start = bucket_offsets(counts)
        lo = torch.empty(n, dtype=torch.int16, device=device)
        err = lib.grid_partition_scatter(
            idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, sh.warps1,
            offsets.data_ptr(), _pointers(sources),
            _pointers(list(bucketed.values())),
            _ints([c.dtype.itemsize == 4 for c in sources]), len(sources),
            lo.data_ptr(), stream)
        kernel_build.raise_on_error(lib, "grid_partition", err)
        if additive:
            # the partition counted the extreme columns too: the sums' own warps
            warps2 = min(MAX_WARPS, SMEM_BUDGET // warp_bytes(C, sh.S))
            n_chunks = chunks(n, C, sh._replace(warps2=warps2), sm_count)
            b_int, b_float, float_f32 = kernel_build.column_args(moved(int_cols),
                                                                 moved(float_cols))
            int_sums = torch.empty((int(bool(count)) + len(int_cols), G), dtype=torch.int64,
                                   device=device)
            float_sums = torch.empty((len(float_cols), G), dtype=torch.float64, device=device)
            scratch = torch.empty(n_chunks * C * G, dtype=torch.int64, device=device)
            err = lib.grid_partition_sums(
                lo.data_ptr(), bucket_start.data_ptr(), G, sh.shift, sh.P, int(bool(count)),
                ctypes.addressof(b_int), len(int_cols), ctypes.addressof(b_float),
                ctypes.addressof(float_f32), len(float_cols), n_chunks, warps2,
                scratch.data_ptr(), int_sums.data_ptr(), float_sums.data_ptr(), stream)
            kernel_build.raise_on_error(lib, "grid_partition", err)
        n_chunks = extreme_chunks(n, E * min(sh.S, G) * 8, sh.P, sm_count)
        scratch = torch.empty(n_chunks * E * G, dtype=torch.int64, device=device)
        err = lib.grid_partition_extremes(
            0, lo.data_ptr(), None, n, bucket_start.data_ptr(), G, sh.shift, sh.P,
            _pointers(moved(ext)), _pointers([None] * E),
            _pointers(grids), types,
            is_max, E, n_chunks, EXT_THREADS, scratch.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    grid_partition_extreme.launches += 1
    return grids, int_sums, float_sums


grid_partition_extreme.launches = 0

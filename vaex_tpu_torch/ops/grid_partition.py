"""Per-bin additive sums for wide grids (kernel B3, two routes) and per-bin
min/max over B3's partition (kernel B3x): the hand-written CUDA kernels,
their plain versions, the wrappers and their launch counters.

The port of ``vaex_tpu/ops/pallas_partition.py:_phase1_kernel`` and
``_phase2_kernel`` (through ``partitioned_additive_channels``), with B1's
contract (:mod:`.grid_additive`): ``idx`` [N] int32, rows outside [0, G)
drop; int64 columns summed mod 2^64; f32/f64 columns summed in f64 with NaN
adding nothing; an implicit count.  Returns ``(int_sums [count + k, G]
int64, float_sums [m, G] float64)``.  Source:
``vaex_tpu_torch/csrc/grid_partition.cu``.

:func:`grid_resident` (``b3-l2``) is the route for a grid that stays in the
card's L2 cache (:func:`resident_fits`): one pass adds every row into the
zeroed [C, G] grid in device memory with 64-bit global reductions.

:func:`grid_partition` (``b3``) is the route for every wider grid.  The grid
is cut into P buckets of S = 2^shift bins; a row's bucket is ``idx >>
shift``.  Phase 1 counts the rows of every (bucket, segment of ``seg_rows``
rows; one CTA per segment, one wave of the card's SMs), turns the counts
into exclusive offsets in bucket-major order (:func:`bucket_offsets`, a
cumsum of that small array) and scatters the low bits of ``idx`` and the
values into bucketed buffers, each tile of 8192 rows ordered by bucket in
shared memory first so a bucket's rows go out as one run.  Phase 2 cuts the
bucketed rows into equal chunks, one per CTA, and adds each bucket's rows
into an S-wide sub-grid in shared memory that the whole CTA shares, then
the sub-grid into the result.  S is as wide as ``SUB_GRID_BYTES`` of shared
memory allow (8192 bins at three channels), so P stays small.

Both routes add with atomics after combining the lanes of a warp that share
a bin, so ints and counts are exact and sorted, clustered or piled-up keys
need no other path; float sums are NOT reproducible from run to run in
their last bits (as with B2 and B5).

The counts size every bucket exactly, so phase 1 cannot overflow: none of
the TPU kernel's run capacity (F = 128), its P <= 126 lanes, its headroom
rule or its rerun on the sort path when a run overflowed carries over.

The TPU kernel's masked min/max mode (``extreme_cols``) is
:func:`grid_partition_extreme`, B3x: E columns, each int64, float64 or
float32 in its own type, each a min or a max, each with an optional validity;
NaN rows, invalid rows and rows outside [0, G) reach no cell, empty cells
hold :func:`.grid_extreme.identity`.  The extreme columns ride the scatter
like any value column and a second phase 2 keeps one [E, S] grid of 64-bit
order-preserving keys per CTA; additive columns may come along, and then
sums and extremes pay one scatter (the TPU function's contract).  A grid
whose E * G * 8 bytes fit one CTA's shared memory takes the same phase 2
over the raw rows with no partition (:func:`extreme_direct_fits`;
``grid_partition_extreme.direct_launches`` counts those launches).  A grid
of keys that stays in L2 takes :func:`grid_resident_extreme` (``b3x-l2``,
:func:`extreme_resident_fits`): one pass over the raw rows and their
validities into one [G, stride] grid of keys in device memory, a cell's
keys side by side (:func:`resident_stride`), a 64-bit ``atomicMin`` only
where a row's key beats the cell's.  The kernels order -0.0 below 0.0, so a
cell that holds both keeps -0.0 as min and 0.0 as max; by value that is what
``amin`` / ``amax`` keep.

Limits of the partition: N < 2^31 rows per call (int32 offsets; a pass hands
it tiles of ``settings.TILE_ROWS``) and P <= ``P_MAX`` buckets (phase 1
keeps a running offset and a count per bucket in shared memory and walks
them once per tile); :func:`shape` is None past them.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import kernel_build
from .grid_extreme import check_extreme_inputs, fold_validity, grid_extreme_batch
from .grid_additive import (MAX_COLS, SM_SMEM, SM_THREADS, SMEM_BUDGET, STAGE_ROWS, check_cuda,
                            check_inputs, n_channels)

# the default SM count (an H100's) for callers that have no device: the
# plain version on the CPU mirrors the kernels' arithmetic with it
SM_COUNT = 132
UNROLL = STAGE_ROWS // 32  # rows per lane of a warp step (csrc/grid_common.cuh)

# phase 1: a CTA of the scatter takes tiles of SCATTER_THREADS *
# SCATTER_ROWS rows (SCATTER_ROWS in grid_partition.cu, checked at load).  On
# an NVIDIA H100 80GB HBM3 (700 W), 1e8 rows, count + int64 + f64: offsets and
# scatter 2.123 ms with 1024 threads against 2.502 with 512 at G = 1 000 003,
# 3.517 against 5.044 at G = 4 000 037
SCATTER_ROWS = 8
SCATTER_THREADS = 1024
COUNT_THREADS = 1024


def scatter_bytes(threads, P):
    """Shared memory of the scatter (scatter_smem in grid_partition.cu): a
    running offset and a count per bucket, and 12 bytes per tile row (its
    destination and one staged value)."""
    return (2 * P + 32) * 4 + threads * SCATTER_ROWS * 12


P_MAX = 8192  # the scatter walks its P counters once per tile of 8192 rows
# phase 2: the sub-grid width S is the largest power of two whose CTA-wide
# [C, S] grid of 8-byte words takes at most this much shared memory.  On the
# same card, count + int64 + f64 at G = 1 000 003: 5.589 ms at 48 KiB
# (S = 2048), 4.625 at 96 KiB, 4.098 at 192 KiB (S = 8192); at G = 16 000 057:
# 17.669, 13.309 and 9.608 ms
SUB_GRID_BYTES = SMEM_BUDGET
SUMS_THREADS = 1024
# phase-2 CTAs, in waves of the CTAs the card holds at once: each CTA adds
# its sub-grids into the result with global reductions, so more waves even
# out the CTAs' work and cost more reductions.  It matters little: phase 2
# at G = 1 000 003 on that card took 1.766 / 1.821 / 1.884 ms at 1 / 2 / 4
# waves on uniform keys and 2.671 / 2.681 / 2.611 on a Zipf(1.1) draw
SUMS_WAVES = 2
MIN_CHUNK_ROWS = 1 << 14
MAX_SHIFT = 15  # S <= 2^15: the low bits travel as uint16

# the resident route: a [C, G] grid of at most this many bytes stays in the
# card's 50 MB L2 while the rows stream past it
RESIDENT_BYTES = 28 << 20
# below this many bins the rows of one bin queue at its address in L2
RESIDENT_MIN_G = 1 << 17
RESIDENT_THREADS = 256

# the min/max mode: columns per call, at most (MAX_EXT in grid_partition.cu),
# and the threads of a phase-2 CTA
MAX_EXT = 8
EXT_THREADS = 512
# the widest [E, S] grid of keys of a CTA when no sums ride along
EXT_GRID_BYTES = 64 << 10
EXT_TYPES = {torch.int64: 0, torch.float64: 1, torch.float32: 2}

Shape = collections.namedtuple("Shape", "shift S P seg_rows n_seg threads")


def shape(n, G, C, sm_count=SM_COUNT):
    """The partition of an n-row call over G bins with C channels on a card
    of ``sm_count`` SMs, or None when it is past the kernel's limits."""
    shift = 0
    while (shift < MAX_SHIFT and (1 << shift) < G
           and C * (2 << shift) * 8 <= SUB_GRID_BYTES):
        shift += 1
    return _partition(n, G, shift, sm_count)


def extreme_shape(n, G, E, C=0, sm_count=SM_COUNT):
    """The partition of a call of the min/max mode with E extreme columns and
    C additive channels (:func:`shape`'s, with the extreme columns counted,
    when sums ride along): alone, the sub-grid is the widest whose [E, S] keys
    take at most ``EXT_GRID_BYTES``.  On an NVIDIA H100 80GB HBM3 (700 W),
    1e8 rows at G = 1 000 003, E = 1: 2.365 ms at S = 4096, 2.046 at 8192,
    2.657 at 16 384; E = 4: 10.871 at 1024, 8.176 at 2048, 8.950 at 4096; at
    G = 67 081, E = 4: 5.214, 4.852 and 7.055 ms."""
    if C:
        return shape(n, G, C + E, sm_count)
    shift = 0
    while (shift < MAX_SHIFT and (1 << shift) < G
           and E * (2 << shift) * 8 <= EXT_GRID_BYTES):
        shift += 1
    return _partition(n, G, shift, sm_count)


def _partition(n, G, shift, sm_count):
    """The Shape of an n-row call over G bins in buckets of 2^shift bins, or
    None past the kernel's limits.  The segments of phase 1 are one wave of
    the CTAs the card holds at once, in whole tiles."""
    if n >= 2 ** 31:
        return None
    S = 1 << shift
    P = -(-G // S)
    if P > P_MAX:
        return None
    threads = SCATTER_THREADS
    tile = threads * SCATTER_ROWS
    wave = sm_count * max(1, min(SM_THREADS // threads, SM_SMEM // scatter_bytes(threads, P)))
    seg_rows = max(tile, -(-(-(-n // wave)) // tile) * tile)
    n_seg = max(1, -(-n // seg_rows))
    return Shape(shift, S, P, seg_rows, n_seg, threads)


def sums_ctas(n, C, sh, sm_count=SM_COUNT):
    """Phase-2 CTAs, each with an equal chunk of the bucketed rows:
    ``SUMS_WAVES`` waves of the card, but no fewer than ``MIN_CHUNK_ROWS``
    rows each."""
    smem = max(1, C * sh.S * 8)
    resident = sm_count * max(1, min(SM_THREADS // SUMS_THREADS, SM_SMEM // smem))
    return max(1, min(SUMS_WAVES * resident, n // MIN_CHUNK_ROWS))


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


def resident_fits(G, C):
    """True when the [C, G] grid of 8-byte words is small enough to stay in
    L2 under the streaming rows: the resident route's range."""
    return G >= RESIDENT_MIN_G and C * G * 8 <= RESIDENT_BYTES


def grid_resident_reference(idx, int_cols, float_cols, G, count):
    """The plain PyTorch version of the resident route: every kept row added
    into one zeroed [C, G] buffer of 8-byte words with ``index_add_``, the
    integer rows first, the float rows viewed as float64."""
    G = int(G)
    C_int = int(bool(count)) + len(int_cols)
    out = torch.zeros((C_int + len(float_cols), G), dtype=torch.int64, device=idx.device)
    int_sums, float_sums = out[:C_int], out[C_int:].view(torch.float64)
    keep = (idx >= 0) & (idx < G)
    bins = idx[keep].to(torch.int64)
    if count:
        int_sums[0].index_add_(0, bins, torch.ones_like(bins))
    for k, col in enumerate(int_cols):
        int_sums[int(bool(count)) + k].index_add_(0, bins, col[keep])
    for k, col in enumerate(float_cols):
        v = col[keep].to(torch.float64)
        float_sums[k].index_add_(0, bins, torch.where(torch.isnan(v), 0.0, v))
    return int_sums, float_sums


def extreme_direct_fits(G, E):
    """True when one CTA's [E, G] grid of keys fits shared memory: the
    min/max mode then reads the raw rows and needs no partition."""
    return E * G * 8 <= SMEM_BUDGET


def resident_stride(E):
    """The keys of a cell on the min/max mode's resident route
    (resident_stride in grid_partition.cu, checked at load): E rounded up to
    even past one column, so a row reads two keys with one 16-byte load."""
    return 1 if E == 1 else (E + 1) & ~1


def extreme_resident_fits(G, E):
    """True when the [G, stride] grid of 8-byte keys stays in L2 under the
    streaming rows: the range of the min/max mode's resident route."""
    return 1 <= E <= MAX_EXT and resident_stride(E) * G * 8 <= RESIDENT_BYTES


def extreme_ctas(n, smem, sm_count=SM_COUNT):
    """Phase-2 CTAs of the min/max mode, each with an equal chunk of the rows:
    enough to fill the card twice, but no fewer than 8 rows per thread on
    average."""
    resident = sm_count * max(1, min(SM_THREADS // EXT_THREADS, SM_SMEM // max(smem, 1)))
    return max(1, min(2 * resident, n // (EXT_THREADS * 8), 65535))


def _library():
    lib = kernel_build.library("grid_partition", SMEM_BUDGET, MAX_COLS)
    for name, want in (("max_ext", MAX_EXT), ("scatter_rows", SCATTER_ROWS)):
        fn = getattr(lib, f"grid_partition_{name}")
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"grid_partition_{name} disagrees with its wrapper")
    lib.grid_partition_resident_stride.restype = ctypes.c_int
    if any(lib.grid_partition_resident_stride(E) != resident_stride(E)
           for E in range(1, MAX_EXT + 1)):
        raise RuntimeError("grid_partition_resident_stride disagrees with its wrapper")
    lib.grid_partition_resident.restype = ctypes.c_int
    lib.grid_partition_resident.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_count.restype = ctypes.c_int
    lib.grid_partition_count.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_scatter.restype = ctypes.c_int
    lib.grid_partition_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_sums.restype = ctypes.c_int
    lib.grid_partition_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_resident_extremes.restype = ctypes.c_int
    lib.grid_partition_resident_extremes.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_partition_extremes.restype = ctypes.c_int
    lib.grid_partition_extremes.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    return lib


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _zeroed_sums(n_int_rows, n_float, G, device):
    """(buffer, int_sums, float_sums): one zeroed [C, G] buffer of 8-byte
    words that the kernels add into, and its integer and float rows."""
    out = torch.zeros((n_int_rows + n_float, G), dtype=torch.int64, device=device)
    return out, out[:n_int_rows], out[n_int_rows:].view(torch.float64)


def _partition_rows(lib, idx, G, sh, sources, stream):
    """Phases 1a and 1b: (lo, bucket_start, bucketed copies of ``sources``)."""
    n, device = idx.shape[0], idx.device
    counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device=device)
    err = lib.grid_partition_count(idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows,
                                   sh.n_seg, COUNT_THREADS, counts.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    offsets, bucket_start = bucket_offsets(counts)
    # sized for all n rows, so no host sync reads the kept count first
    lo = torch.empty(n, dtype=torch.int16, device=device)
    bucketed = [torch.empty_like(c) for c in sources]
    err = lib.grid_partition_scatter(
        idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, sh.threads,
        offsets.data_ptr(), _pointers(sources), _pointers(bucketed),
        _ints([c.dtype.itemsize == 4 for c in sources]), len(sources), lo.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    return lo, bucket_start, bucketed


def _bucket_sums(lib, lo, bucket_start, n, G, sh, bucketed_int, bucketed_float, count, stream):
    """Phase 2 of the sums over bucketed columns: (int_sums, float_sums)."""
    C = n_channels(len(bucketed_int), len(bucketed_float), count)
    out, int_sums, float_sums = _zeroed_sums(int(bool(count)) + len(bucketed_int),
                                             len(bucketed_float), G, lo.device)
    b_int, b_float, float_f32 = kernel_build.column_args(bucketed_int, bucketed_float)
    err = lib.grid_partition_sums(
        lo.data_ptr(), bucket_start.data_ptr(), n, G, sh.shift, sh.P, int(bool(count)),
        ctypes.addressof(b_int), len(bucketed_int), ctypes.addressof(b_float),
        ctypes.addressof(float_f32), len(bucketed_float),
        sums_ctas(n, C, sh, _sm_count(lo.device)), SUMS_THREADS, out.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    # B3's kernels have run, whether the call was grid_partition's own or
    # one of grid_partition_extreme with sums riding its partition
    grid_partition.launches += 1
    return int_sums, float_sums


def grid_partition(idx, int_cols, float_cols, G, count):
    """Per-bin sums through the partition; see the module docstring.  CPU
    tensors take the plain version; CUDA tensors launch the kernels, or raise
    when they cannot take them."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_partition_reference(idx, int_cols, float_cols, G, count)
    check_cuda("grid_partition", idx, int_cols, float_cols)
    n, device = idx.shape[0], idx.device
    C = n_channels(len(int_cols), len(float_cols), count)
    sh = shape(n, G, C, _sm_count(device))
    if sh is None or len(int_cols) + len(float_cols) > MAX_COLS or C * G >= 2 ** 31:
        raise ValueError(f"grid_partition: G={G} with {C} channels at N={n} does not fit "
                         f"the kernel")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lo, bucket_start, bucketed = _partition_rows(lib, idx, G, sh, int_cols + float_cols,
                                                     stream)
        sums = _bucket_sums(lib, lo, bucket_start, n, G, sh, bucketed[:len(int_cols)],
                            bucketed[len(int_cols):], count, stream)
    return sums


grid_partition.launches = 0


def grid_resident(idx, int_cols, float_cols, G, count):
    """Per-bin sums by the resident route: one pass that adds every row into
    the [C, G] grid in device memory, for grids that stay in L2
    (:func:`resident_fits`; wider ones work and are slow); see the module
    docstring.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, or raise when it cannot take them."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    if idx.device.type == "cpu":
        return grid_resident_reference(idx, int_cols, float_cols, G, count)
    check_cuda("grid_resident", idx, int_cols, float_cols)
    n, device = idx.shape[0], idx.device
    C = n_channels(len(int_cols), len(float_cols), count)
    if len(int_cols) + len(float_cols) > MAX_COLS or C * G >= 2 ** 31:
        raise ValueError(f"grid_resident: G={G} with {C} channels does not fit the kernel")
    per_sm = SM_THREADS // RESIDENT_THREADS
    n_ctas = max(1, min(_sm_count(device) * per_sm, -(-n // (RESIDENT_THREADS * UNROLL))))
    lib = _library()
    int_ptrs, float_ptrs, float_f32 = kernel_build.column_args(int_cols, float_cols)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out, int_sums, float_sums = _zeroed_sums(int(bool(count)) + len(int_cols),
                                                 len(float_cols), G, device)
        err = lib.grid_partition_resident(
            idx.data_ptr(), n, G, int(bool(count)), ctypes.addressof(int_ptrs), len(int_cols),
            ctypes.addressof(float_ptrs), ctypes.addressof(float_f32), len(float_cols),
            n_ctas, RESIDENT_THREADS, out.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    grid_resident.launches += 1
    return int_sums, float_sums


grid_resident.launches = 0


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
    sm_count = _sm_count(device)
    lib = _library()
    grids = [torch.empty(G, dtype=c.dtype, device=device) for c in cols]
    types, is_max = _ints([EXT_TYPES[c.dtype] for c in cols]), _ints([m == "max" for m in modes])
    int_sums = float_sums = None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if not additive and extreme_direct_fits(G, E):
            shift = max(0, (G - 1).bit_length())
            n_chunks = extreme_ctas(n, E * G * 8, sm_count)
            scratch = torch.empty(n_chunks * E * G, dtype=torch.int64, device=device)
            masks = [None if v is None else v.view(torch.uint8) for v in valids]
            err = lib.grid_partition_extremes(
                1, None, idx.data_ptr(), n, None, G, shift, 1,
                _pointers(cols), _pointers(masks),
                _pointers(grids), types,
                is_max, E, n_chunks, EXT_THREADS, scratch.data_ptr(), stream)
            kernel_build.raise_on_error(lib, "grid_partition", err)
            grid_partition_extreme.launches += 1
            grid_partition_extreme.direct_launches += 1
            return grids, None, None
        C = n_channels(len(int_cols), len(float_cols), count)
        sh = extreme_shape(n, G, E, C, sm_count)
        # an invalid row travels as a value that reaches no cell
        ext = [fold_validity(c, m, v) for c, m, v in zip(cols, modes, valids)]
        # every distinct column is scattered once, however many phase 2s read it
        unique = {}
        for c in (*int_cols, *float_cols, *ext):
            unique.setdefault((c.data_ptr(), c.dtype), c)
        lo, bucket_start, copies = _partition_rows(lib, idx, G, sh, list(unique.values()),
                                                   stream)
        bucketed = dict(zip(unique, copies))

        def moved(columns):
            return [bucketed[(c.data_ptr(), c.dtype)] for c in columns]
        if additive:
            int_sums, float_sums = _bucket_sums(lib, lo, bucket_start, n, G, sh,
                                                moved(int_cols), moved(float_cols), count,
                                                stream)
        # every cell starts as the empty key (all ones); the CTAs take their
        # keys' minimum into it
        keys = torch.full((E * G,), -1, dtype=torch.int64, device=device)
        err = lib.grid_partition_extremes(
            0, lo.data_ptr(), None, n, bucket_start.data_ptr(), G, sh.shift, sh.P,
            _pointers(moved(ext)), _pointers([None] * E),
            _pointers(grids), types,
            is_max, E, extreme_ctas(n, E * min(sh.S, G) * 8, sm_count), EXT_THREADS,
            keys.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    grid_partition_extreme.launches += 1
    return grids, int_sums, float_sums


grid_partition_extreme.launches = 0  # both routes
grid_partition_extreme.direct_launches = 0  # b3x-direct alone


def grid_resident_extreme(idx, cols, modes, valids, G):
    """Per-bin min/max of ``cols`` by the resident route (``b3x-l2``): one
    pass over the raw rows and their validities that takes every row's keys
    into one [G, stride] grid of keys in device memory (a cell's keys side
    by side, :func:`resident_stride`), for grids that stay in L2
    (:func:`extreme_resident_fits`; wider ones work and are slow).  The
    contract of :func:`grid_partition_extreme` without additive columns;
    returns a [G] tensor per column.  CPU tensors take the plain version
    (:func:`.grid_extreme.grid_extreme_batch`); CUDA tensors launch the
    kernel, or raise when it cannot take them."""
    G = int(G)
    cols, modes, valids = list(cols), list(modes), list(valids)
    check_extreme_inputs(idx, cols, modes, valids, G)
    if idx.device.type == "cpu":
        return grid_extreme_batch(idx, cols, modes, valids, G)
    check_cuda("grid_resident_extreme", idx, cols, [v for v in valids if v is not None])
    n, E, device = idx.shape[0], len(cols), idx.device
    if E > MAX_EXT or resident_stride(E) * G >= 2 ** 31:
        raise ValueError(f"grid_resident_extreme: G={G} with {E} extreme columns does not fit "
                         f"the kernel")
    per_sm = SM_THREADS // RESIDENT_THREADS
    n_ctas = max(1, min(_sm_count(device) * per_sm, -(-n // (RESIDENT_THREADS * UNROLL))))
    lib = _library()
    grids = [torch.empty(G, dtype=c.dtype, device=device) for c in cols]
    masks = [None if v is None else v.view(torch.uint8) for v in valids]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # every cell starts as the empty key (all ones); torch's allocations
        # are aligned past the 16 bytes the kernel's loads need
        keys = torch.full((G * resident_stride(E),), -1, dtype=torch.int64, device=device)
        err = lib.grid_partition_resident_extremes(
            idx.data_ptr(), n, G, _pointers(cols), _pointers(masks), _pointers(grids),
            _ints([EXT_TYPES[c.dtype] for c in cols]), _ints([m == "max" for m in modes]), E,
            n_ctas, RESIDENT_THREADS, keys.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_partition", err)
    grid_resident_extreme.launches += 1
    return grids


grid_resident_extreme.launches = 0

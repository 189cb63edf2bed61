"""Per-cell top-k of small k on the resident route (``b3x-l2-topk``): the
hand-written CUDA kernel, its plain version, the wrapper and its launch
counter.  Source: ``vaex_tpu_torch/csrc/grid_topk.cu``, which holds the
design.

Contract: ``idx`` [N] int32, rows outside [0, G) drop; ``values`` [N]
int64, float64 or float32; ``mask`` [N] bool, True where a row is missing,
or None; NaN rows, and with ``nat`` the int64 min (NaT), drop too.
``state`` [G, k] in the values' dtype holds each cell's k best values of the
earlier tiles, best first (the k largest, descending, or the k smallest,
ascending), a slot no value fills holding :func:`fill`; the call overwrites
it in place with the k best of its values and the tile's, ties included: a
cell whose best value appears twice gives it twice.  By value the result is
what a sort of the rows by (cell, value) keeps (``agg.OpTopK``'s sort), the
order of -0.0 and 0.0 aside.

The kernel takes k rounds over the rows into a [G, 2] grid of 8-byte key
pairs and a [G] count, which stay in the card's L2 while :func:`resident_fits`
(past it they are read from device memory, and a round costs more), then
one thread a cell merges the tile's k slots into the state.
"""

from __future__ import annotations

import ctypes

import torch

from . import grid_partition, kernel_build
from .. import tracing
from .grid_additive import SM_THREADS, STAGE_ROWS, check_cuda
from .grid_extreme import identity

ROUTE = "b3x-l2-topk"
# the most slots a cell takes on the kernel, MAX_K of grid_topk.cu: on an
# NVIDIA H100 80GB HBM3 (700 W), 1e8 rows over 1e6 cells, the rounds took
# 1.188 ms at k = 1, 2.256 at 2, 8.728 at 8 and 17.58 at 16 against 28.72,
# 28.78, 29.33 and 29.87 for the sort (PERF.md, section 6)
K_MAX = 16
# the most slots a cell takes where a round's grids are past L2 (not
# :func:`resident_fits`): there a round costs more as G grows, and at k = 16
# the sort won from 4e6 cells; 1e8 rows, k = 8 and k = 16, ms of the rounds /
# the sort:
# 2e6 cells 13.29 / 30.81, 26.86 / 31.99; 4e6 26.15 / 33.71, 52.67 / 36.11;
# 1e7 42.73 / 42.34, 78.43 / 48.09; 3e7 56.01 / 70.57, 99.85 / 88.43; 1e8
# 73.35 / 168.4, 156.1 / out of memory (PERF.md, section 6)
K_PAST_L2 = 8
TYPES = {torch.int64: 0, torch.float64: 1, torch.float32: 2}
THREADS = 256
UNROLL = STAGE_ROWS // 32  # rows per lane of a warp step (csrc/grid_common.cuh)
EMPTY = torch.iinfo(torch.int64).max  # the kernel's all-ones key, as an order image
LOW_BITS = EMPTY  # the bits a negative float's image flips


def resident_fits(G):
    """True when the grids of a round, the [G, 2] 8-byte key pairs and the
    [G] 4-byte counts, stay in L2 under the streaming rows."""
    return 20 * G <= grid_partition.RESIDENT_BYTES


def fill(dtype, largest):
    """The value of a slot no value fills: -inf (+inf) for floats, the
    int64 min (max), for the largest (smallest)."""
    return identity(dtype, "max" if largest else "min")


def check_inputs(idx, values, mask, G, k, state):
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-d int32, got {idx.dtype} with shape {tuple(idx.shape)}")
    if values.dtype not in TYPES:
        raise TypeError(f"values must be int64, float64 or float32, got {values.dtype}")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    for t in (values, mask):
        if t is not None and (t.shape != idx.shape or t.device != idx.device):
            raise ValueError(f"a column of shape {tuple(t.shape)} on {t.device} does not match "
                             f"idx {tuple(idx.shape)} on {idx.device}")
    if not (G >= 1 and 1 <= k <= K_MAX):
        raise ValueError(f"G={G}, k={k}: the route takes G >= 1 and 1 <= k <= {K_MAX}")
    if state.shape != (G, k) or state.dtype != values.dtype or state.device != idx.device:
        raise ValueError(f"state must be [{G}, {k}] {values.dtype} on {idx.device}, got "
                         f"{tuple(state.shape)} {state.dtype} on {state.device}")


def order_keys(values, largest):
    """The kernel's keys as int64 order images (the key less 2^63): int64
    values themselves, a float's bits with a negative one's low bits
    flipped, complemented for the largest values, so the best is the
    smallest."""
    if values.dtype == torch.int64:
        keys = values
    else:
        bits = values.to(torch.float64).view(torch.int64)
        keys = torch.where(bits < 0, bits ^ LOW_BITS, bits)
    return ~keys if largest else keys


def key_values(keys, dtype, largest):
    """:func:`order_keys`'s inverse; the empty key gives :func:`fill`."""
    image = ~keys if largest else keys
    if dtype == torch.int64:
        values = image
    else:
        values = torch.where(image < 0, image ^ LOW_BITS, image).view(torch.float64).to(dtype)
    return torch.where(keys == EMPTY, fill(dtype, largest), values)


def grid_topk_reference(idx, values, mask, G, k, largest, state, nat=False):
    """The plain PyTorch version of the kernel's rounds: per round a
    ``scatter_reduce_`` of the keys above the last round's best into each
    cell's best, and an ``index_add_`` of the rows equal to it; the tile's
    slots from those levels and counts; a row-wise sort of them beside the
    state's."""
    keep = (idx >= 0) & (idx < G)
    if mask is not None:
        keep &= ~mask
    if values.is_floating_point():
        keep &= ~torch.isnan(values)
    elif nat:
        keep &= values != torch.iinfo(torch.int64).min
    cells = torch.where(keep, idx, 0).to(torch.int64)
    keys = torch.where(keep, order_keys(values, largest), EMPTY)

    def best(round_keys):
        return torch.full((G,), EMPTY, dtype=torch.int64, device=idx.device).scatter_reduce_(
            0, cells, round_keys, "amin")
    levels, ends = [best(keys)], []
    for _ in range(1, k):
        threshold = levels[-1][cells]
        ties = torch.zeros(G, dtype=torch.int64, device=idx.device).index_add_(
            0, cells, ((keys == threshold) & (keys != EMPTY)).to(torch.int64))
        ends.append(ties.clamp_(max=k) + (ends[-1] if ends else 0))
        levels.append(best(torch.where(keys > threshold, keys, EMPTY)))
    # slot s holds the first level whose running count passes s; the last
    # level takes what the others leave
    slots = torch.arange(k, device=idx.device)
    level = (torch.zeros((G, k), dtype=torch.int64, device=idx.device) if k == 1 else
             (torch.stack(ends, 1)[:, None, :] <= slots[None, :, None]).sum(2))
    tile = torch.stack(levels, 1).gather(1, level)
    both = torch.cat([order_keys(state, largest), tile], 1).sort(1).values[:, :k]
    return state.copy_(key_values(both, state.dtype, largest))


def _library():
    lib = kernel_build.library("grid_topk", None)
    lib.grid_topk_max_k.restype = ctypes.c_int
    if lib.grid_topk_max_k() != K_MAX:
        raise RuntimeError("grid_topk_max_k disagrees with its wrapper's K_MAX")
    lib.grid_topk.restype = ctypes.c_int
    lib.grid_topk.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@tracing.launched
def grid_topk(idx, values, mask, G, k, largest, state, nat=False):
    """(route, state): the k best values of each cell of the tile merged
    into ``state`` in place; see the module docstring.  CPU tensors take the
    plain version (route ``"plain"``); CUDA tensors launch the kernel, or
    raise when it cannot take them."""
    G, k = int(G), int(k)
    check_inputs(idx, values, mask, G, k, state)
    if idx.device.type == "cpu":
        return "plain", grid_topk_reference(idx, values, mask, G, k, largest, state, nat)
    check_cuda("grid_topk", idx, [values, state], [] if mask is None else [mask])
    n, device = idx.shape[0], idx.device
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    n_ctas = max(1, min(sm_count * (SM_THREADS // THREADS), -(-n // (THREADS * UNROLL))))
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # scratch the kernel sets itself; torch's allocations are aligned past
        # the 16 bytes the pairs' loads need
        pair = torch.empty(2 * G, dtype=torch.int64, device=device)
        levels = torch.empty((k - 1) * G, dtype=torch.int64, device=device)
        counts = torch.empty((k - 1) * G, dtype=torch.int32, device=device)
        err = lib.grid_topk(
            idx.data_ptr(), n, G, values.data_ptr(), TYPES[values.dtype],
            None if mask is None else mask.data_ptr(), int(nat), int(largest), k, n_ctas,
            THREADS, state.data_ptr(), pair.data_ptr(), levels.data_ptr() if k > 1 else None,
            counts.data_ptr() if k > 1 else None, stream)
    kernel_build.raise_on_error(lib, "grid_topk", err)
    grid_topk.launches += 1
    return ROUTE, state


grid_topk.launches = 0

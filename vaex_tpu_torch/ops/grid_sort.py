"""Per-bin sums and per-bin min/max past B3's limits: the route ``"sort"``.

The counterpart of the reference's route for grids past its kernels
(``vaex_tpu/ops/gridagg.py:238-591``; ``vaex_tpu/tasks.py:134-146,
397-457``): up to ``SORT_MAX_G`` = 2^24 bins it sorts the bin index carrying
the columns (``sort_carry`` + ``sorted_additive``; ``extreme_fast`` for the
extremes), past it every op scatters into its grid (``op.update``).  None of
it is a Pallas kernel: XLA sorts, scans and scatters.  The route keeps the
name the reference's plan gives it, ``"sort"``, and on this card it is the
scatter at every G: ``index_add_`` of every row into an int64 and a float64
row per channel, ``scatter_reduce_`` ("amin" / "amax", ``include_self``)
into a row that starts at the identity.  A grid this route sees holds at
least 16.8M cells (B3's partition takes every narrower one, split into calls
of fewer channels where needed: ``grid_plan``), so rows per cell are few --
1e8 rows over 144M cells is under one a cell -- and the atomics seldom meet
on one address.  The sort of the bin index carrying the columns, then sums
per run of equal bins, was timed against it at ``chip_smoke.py`` phase 19's
shapes and lost (``scripts/sweep_grid_sort.py``; PERF.md, section 6).

The contracts are B3's (:func:`.grid_partition.grid_partition`: ``idx`` [N]
int32, rows outside [0, G) drop; int64 columns summed mod 2^64; f32 / f64
columns summed in f64 with NaN adding nothing; an optional count) and B3x's
(:func:`.grid_partition.grid_partition_extreme` without additive columns:
per column a min or a max in its dtype, an optional validity, NaN and
invalid rows reaching no cell, empty cells at :func:`.grid_extreme.identity`),
for any G and any N, N >= 2^31 too.  A row outside [0, G) adds the identity
(0, or the extreme's identity) to a cell picked by its row number, so the
rows a filter or a selection drops queue on no one address and no host sync
compacts them.  Float sums are added in no fixed order (as on B2, B3, B5).

``out`` hands the route the rows to add into: a pass passes each
aggregation's running state, so the grid is allocated once per pass and
every tile scatters straight into it, with no tile grid beside it (144M
cells of three f64 channels are 3.5 GB).

There is no kernel under this route, so no launch counter: the same torch
calls run on CUDA tensors on the card and on CPU tensors, where they are the
plain version.  A kernel written for it is ROADMAP R14.
"""

from __future__ import annotations

import torch

from .grid_additive import check_inputs
from .grid_extreme import MODES, check_extreme_inputs, identity

SORT = "sort"


def _cells(idx, G):
    """(cells [N] int64, keep [N] bool): each row's bin, and for a row
    outside [0, G) a cell picked by its row number (the row number's low
    bits under the largest power of two <= G), where it adds the identity."""
    keep = (idx >= 0) & (idx < G)
    spread = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    spread &= (1 << (G.bit_length() - 1)) - 1
    return torch.where(keep, idx.to(torch.int64), spread), keep


def _rows(given, n, dtype, G, device, fill=0):
    """The rows a call adds into: ``given``'s where it holds one (checked),
    fresh ones at ``fill`` elsewhere; all fresh in one [n, G] tensor when
    nothing is given."""
    if given is None:
        return torch.full((n, G), fill, dtype=dtype, device=device)
    if len(given) != n:
        raise ValueError(f"{len(given)} rows given for {n} channels")
    rows = []
    for row in given:
        if row is None:
            row = torch.full((G,), fill, dtype=dtype, device=device)
        elif row.shape != (G,) or row.dtype != dtype or row.device != device:
            raise ValueError(f"a row to add into must be [{G}] {dtype} on {device}, got "
                             f"{tuple(row.shape)} {row.dtype} on {row.device}")
        rows.append(row)
    return rows


def grid_sort(idx, int_cols, float_cols, G, count, out=None):
    """Per-bin sums in B3's contract (see the module docstring).  Without
    ``out`` returns ``(int_sums [count + k, G] int64, float_sums [m, G]
    float64)``; ``out`` is (int rows, float rows): per channel (the count
    first) a [G] int64 or float64 tensor to add into in place, or None for a
    fresh one, and the two lists of rows come back."""
    G = int(G)
    int_cols, float_cols = list(int_cols), list(float_cols)
    check_inputs(idx, int_cols, float_cols, G, count)
    n_int = int(bool(count)) + len(int_cols)
    int_out = _rows(None if out is None else out[0], n_int, torch.int64, G, idx.device)
    float_out = _rows(None if out is None else out[1], len(float_cols), torch.float64, G,
                      idx.device)
    cells, keep = _cells(idx, G)
    if count:
        int_out[0].index_add_(0, cells, keep.to(torch.int64))
    for row, col in zip(int_out[n_int - len(int_cols):], int_cols):
        row.index_add_(0, cells, torch.where(keep, col, 0))
    for row, col in zip(float_out, float_cols):
        v = col.to(torch.float64)
        row.index_add_(0, cells, torch.where(keep & ~torch.isnan(v), v, 0.0))
    return int_out, float_out


def grid_sort_extreme(idx, cols, modes, valids, G, out=None):
    """Per-bin min / max in B3x's contract (see the module docstring): a
    list of [G] grids, each in its column's dtype.  ``out`` holds per column
    a [G] tensor of its dtype to take the extremes into in place, or None
    for a fresh one at the identity."""
    G = int(G)
    cols, modes, valids = list(cols), list(modes), list(valids)
    check_extreme_inputs(idx, cols, modes, valids, G)
    if out is not None and len(out) != len(cols):
        raise ValueError(f"{len(out)} grids given for {len(cols)} columns")
    cells, keep = _cells(idx, G)
    grids = []
    for k, (col, mode, valid) in enumerate(zip(cols, modes, valids)):
        fill = identity(col.dtype, mode)
        (grid,) = _rows(None if out is None else [out[k]], 1, col.dtype, G, idx.device, fill)
        ok = keep if valid is None else keep & valid
        if col.is_floating_point():
            ok = ok & ~torch.isnan(col)
        grid.scatter_reduce_(0, cells, torch.where(ok, col, fill), MODES[mode],
                             include_self=True)
        grids.append(grid)
    return grids

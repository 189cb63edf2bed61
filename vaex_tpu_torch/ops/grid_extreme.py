"""Per-bin min and max in plain PyTorch: the plain version of kernel B3x
(:func:`.grid_partition.grid_partition_extreme`) and the library call it is
timed against.

vaex_tpu computes its per-bin extremes in XLA (``gridagg.fused_extreme``,
``extreme_fast`` / ``extreme_lex``; ``vaex_tpu/ops/gridagg.py:195-227,
400-452``) or in the masked min/max mode of its partitioned Pallas kernel
(``pallas_partition.py``, ``extreme_cols``).  The port runs them on the
hand-written kernel; what stays here runs on CPU tensors and in checks.

The contract the kernel and :func:`grid_extreme_batch` share: ``idx`` [N]
int32, rows outside [0, G) drop; E columns, each int64, float64 or float32,
each with a mode ("min" or "max") and an optional bool validity; NaN rows
and invalid rows reach no cell; an empty cell holds :func:`identity`: +-inf
for floats, the integer dtype's max (min) or min (max), as vaex_tpu's
``min_identity`` and ``max_identity`` (``gridagg.py:474-487``).  Each result
is [G] in its column's dtype: int64 extremes never pass through a double.

``grid_extreme`` reduces one column into a grid of G + 1 bins whose last
bin takes the rows that drop and is cut off: ``amin``/``amax`` would carry a
NaN into any bin it reached, so a NaN row must only ever reach that one.
:func:`extreme_bins` computes the int64 bins of a call once for all its
columns.  A statistic without binby has one cell and takes
:func:`extreme_of_rows`, a plain reduction.
"""

from __future__ import annotations

import torch

MODES = {"min": "amin", "max": "amax"}


def identity(dtype, mode):
    """The value an empty bin holds."""
    if dtype.is_floating_point:
        return float("inf") if mode == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if mode == "min" else info.min


def extreme_bins(idx, G):
    """The int64 bin of every row of ``idx``, G for a row outside [0, G)."""
    return torch.where((idx >= 0) & (idx < G), idx, G).to(torch.int64)


def grid_extreme(bins, col, G, mode, valid=None):
    """Per-bin ``mode`` ("min" or "max") of ``col`` [N] over ``bins`` [N]
    (:func:`extreme_bins`); NaN rows and rows where ``valid`` is False drop.
    Returns [G] in the dtype of ``col``."""
    G = int(G)
    if mode not in MODES:
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if bins.dtype != torch.int64 or col.shape != bins.shape:
        raise ValueError(f"bins must be int64 and as long as the column, got {bins.dtype} "
                         f"{tuple(bins.shape)} and {tuple(col.shape)}")
    drop = torch.isnan(col) if col.is_floating_point() else None
    if valid is not None:
        drop = ~valid if drop is None else drop | ~valid
    if drop is not None:
        bins = bins.masked_fill(drop, G)
    out = torch.full((G + 1,), identity(col.dtype, mode), dtype=col.dtype, device=col.device)
    out.scatter_reduce_(0, bins, col, MODES[mode], include_self=True)
    return out[:G]


def extreme_of_rows(col, mode, valid=None, n_rows=None):
    """``mode`` of ``col`` [N] over the rows where ``valid`` holds (every row
    when it is None), NaN rows left out, as a [1] tensor: the one-cell grid
    of a statistic without binby.  A reduction, where :func:`grid_extreme`
    would run N atomics on one address.  ``col`` and ``valid`` must hold
    one value per row: ``n_rows`` of them when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    n = col.shape[0] if n_rows is None and col.dim() == 1 else n_rows
    for t, what in ((col, "column"), (valid, "validity")):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{what} shape {tuple(t.shape)} does not match the rows ({n},)")
    drop = torch.isnan(col) if col.is_floating_point() else None
    if valid is not None:
        drop = ~valid if drop is None else drop | ~valid
    if drop is not None:  # one pass, where masked_fill would copy first
        col = torch.where(drop, identity(col.dtype, mode), col)
    if not col.numel():
        return torch.full((1,), identity(col.dtype, mode), dtype=col.dtype, device=col.device)
    return (col.amin() if mode == "min" else col.amax()).reshape(1)


def check_extreme_inputs(idx, cols, modes, valids, G):
    """The checks of the batched contract (see the module docstring)."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-d int32, got {idx.dtype} with shape {tuple(idx.shape)}")
    if not cols or not len(cols) == len(modes) == len(valids) or G < 1:
        raise ValueError(f"G={G} with {len(cols)} columns, {len(modes)} modes and "
                         f"{len(valids)} validities: need one mode and one validity (or None) "
                         f"per column, at least one column and G >= 1")
    for col, mode, valid in zip(cols, modes, valids):
        if mode not in MODES:
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if col.dtype not in (torch.int64, torch.float64, torch.float32):
            raise TypeError(f"extreme columns must be int64, float64 or float32, got "
                            f"{col.dtype}")
        for t, what in ((col, "column"), (valid, "validity")):
            if t is None:
                continue
            if t.shape != idx.shape or t.device != idx.device:
                raise ValueError(f"{what} of shape {tuple(t.shape)} on {t.device} does not "
                                 f"match idx {tuple(idx.shape)} on {idx.device}")
        if valid is not None and valid.dtype != torch.bool:
            raise TypeError(f"a validity must be bool, got {valid.dtype}")


def fold_validity(col, mode, valid):
    """``col`` with its invalid rows replaced by a value that changes no
    cell: NaN for floats, the identity for int64."""
    if valid is None:
        return col
    fill = torch.nan if col.is_floating_point() else identity(col.dtype, mode)
    return torch.where(valid, col, fill)


def grid_extreme_batch(idx, cols, modes, valids, G):
    """The batched contract in plain PyTorch: one :func:`grid_extreme`
    (``scatter_reduce_`` with the drop bin) per column over shared bins.
    Returns a list of [G] tensors."""
    G = int(G)
    cols, modes, valids = list(cols), list(modes), list(valids)
    check_extreme_inputs(idx, cols, modes, valids, G)
    bins = extreme_bins(idx, G)
    return [grid_extreme(bins, col, G, mode, valid)
            for col, mode, valid in zip(cols, modes, valids)]

"""Per-bin min and max, in plain PyTorch.

vaex_tpu computes these in XLA, outside any Pallas kernel:
``gridagg.fused_extreme`` (a scan of masked block reductions) for G <= 512
and the sort paths ``extreme_fast`` / ``extreme_lex`` above
(``vaex_tpu/ops/gridagg.py:195-227, 400-452``; ``vaex_tpu/tasks.py:426-451``).  The
one TPU kernel with a min/max mode, B3's masked extreme mode
(``pallas_partition.py``, ``extreme_cols``), is reachable from no path:
``vaex_tpu/tasks.py:260-264`` leaves its candidate list empty.  So no hand-written
kernel replaces anything here; a ``scatter_reduce_`` is the port of XLA's
scatter-min.

``grid_extreme`` reduces one column into a grid of G + 1 bins whose last
bin takes the rows that drop (outside [0, G), NaN or missing) and is cut
off: ``amin``/``amax`` would carry a NaN into any bin it reached, so a NaN
row must only ever reach that one.  :func:`extreme_bins` computes the int64
bins of a tile once for all its extreme columns.  Empty bins keep the
identity: +-inf for floats, the integer dtype's max (min) or min (max), as
vaex_tpu's ``min_identity`` and ``max_identity`` (``gridagg.py:474-487``).
The result keeps the column's dtype: int64 extremes never pass through a
double.
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

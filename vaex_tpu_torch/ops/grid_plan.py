"""Which grid kernel an additive pass takes, from the grid size G and the
channel count C (count + int columns + float columns):

* ``b1`` (:mod:`.grid_additive`) while G <= ``B1_MAX_G`` and one warp's
  [C, G] grid fits shared memory;
* ``b2`` (:mod:`.grid_window`) while the grid takes at most
  ``B2_MAX_WINDOWS`` bin windows;
* ``b3`` (:mod:`.grid_partition`) up to its limits (N < 2^31 rows per call,
  at most ``grid_partition.P_MAX`` buckets);
* past those, None: the sort strategies are not ported yet (ROADMAP A6).

The cut-offs were measured on an NVIDIA H100 80GB HBM3 at its 700 W limit,
1e8 uniform keys, C = 2, 3 and 4 channels (``scripts/sweep_grid_kernels.py``;
PERF.md, section 6): at G = 103 B1 beat B2 at every C (0.958 / 1.064 /
1.570 against 1.159 / 1.541 / 1.908 ms), at G = 256 B2 beat B1 at C = 2
and 4 (0.985 / 1.716 against 1.078 / 2.031 ms); B2 beat B3 at up to 9
windows (C = 2 at G = 100 003: 5.04 against 7.14 ms), tied at 13 (C = 3,
G = 100 003: 7.86 against 7.83 ms) and lost from 17 on.  The CPU runs
the plain version of the kernel the plan picks, so the plan and each
kernel's bucket and window arithmetic run in the CPU tests too.
"""

from __future__ import annotations

from . import grid_additive, grid_partition, grid_window
from .grid_additive import n_channels

B1, B2, B3 = "b1", "b2", "b3"
B1_MAX_G = 128
B2_MAX_WINDOWS = 12

KERNELS = {B1: grid_additive.grid_additive, B2: grid_window.grid_window,
           B3: grid_partition.grid_partition}
PLAIN = {B1: grid_additive.grid_additive_reference,
         B2: grid_window.grid_window_reference,
         B3: grid_partition.grid_partition_reference}


def strategy(n, G, n_int, n_float, count):
    """``b1``, ``b2``, ``b3`` or None for an n-row call over G bins."""
    C = n_channels(n_int, n_float, count)
    if C < 1 or G < 1:
        raise ValueError(f"nothing to add: G={G}, no columns and no count")
    if G <= B1_MAX_G and grid_additive.fits(G, n_int, n_float, count):
        return B1
    if grid_window.n_windows(G, C) <= B2_MAX_WINDOWS:
        return B2
    if grid_partition.shape(n, G, C) is not None:
        return B3
    return None


def grid_sums(idx, int_cols, float_cols, G, count):
    """(strategy, int_sums, float_sums) through the kernel the plan picks;
    raises NotImplementedError past B3's limits."""
    name = strategy(idx.shape[0], int(G), len(int_cols), len(float_cols), count)
    if name is None:
        raise NotImplementedError(
            f"a grid of G={G} bins over {idx.shape[0]} rows is past the partitioned "
            f"kernel's limits (at most {grid_partition.P_MAX} buckets, fewer than 2^31 "
            f"rows per call); the sort strategies are not ported yet (ROADMAP queue A6)")
    return (name, *KERNELS[name](idx, int_cols, float_cols, G, count))

"""Which grid kernel a pass takes.  Its additive aggregators take one by the
grid size G and the channel count C (count + int columns + float columns):

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

A pass's moment terms (var, std, covar, corr) take
:func:`moment_strategy`'s kernel: ``b4`` (B4, ordered), ``b5`` (B5, bin
windows) or ``b3`` over the formed term columns, with C the number of
terms. Its cut-offs were measured the same way on that card (1e8 uniform
keys; C = 3: var of an f64 column, C = 6: corr of two int64 columns;
PERF.md, section 6): B4 beat B5 to G = 128 at C = 3 (1.423 against 1.502
ms) and lost at 256 (1.666 against 1.405), beat it to G = 32 at C = 6
(3.131 against 3.347) and lost at 64 (2.930 against 2.872); both crossings
sit near one warp's grid of 8 KiB (:func:`b4_max_g`: G <= 213 at C = 3, 42
at C = 6). B5 beat B3 at 13 windows (C = 3: 8.984 against 13.480 ms) and
lost at 25 (13.951 against 13.212); at C = 6 it still won at 25 windows
(24.475 against 30.920) and lost at 49 (41.926 against 36.227): one cut-off
of 24 windows serves both.
"""

from __future__ import annotations

from . import grid_additive, grid_moments, grid_partition, grid_window
from .grid_additive import n_channels

B1, B2, B3, B4, B5 = "b1", "b2", "b3", "b4", "b5"
B1_MAX_G = 128
B2_MAX_WINDOWS = 12
# B4 while one warp's ordered grid (grid_additive.warp_bytes) takes at most
# this many bytes, i.e. while 3 or more CTAs of 8 warps fit an SM
B4_MAX_WARP_BYTES = 8 << 10
B5_MAX_WINDOWS = 24

KERNELS = {B1: grid_additive.grid_additive, B2: grid_window.grid_window,
           B3: grid_partition.grid_partition}
PLAIN = {B1: grid_additive.grid_additive_reference,
         B2: grid_window.grid_window_reference,
         B3: grid_partition.grid_partition_reference}
MOMENT_KERNELS = {B4: grid_moments.grid_moments, B5: grid_moments.grid_moments_window}
MOMENT_PLAIN = {B4: grid_moments.grid_moments_reference,
                B5: grid_moments.grid_moments_window_reference}


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


def _past_b3(n, G):
    return NotImplementedError(
        f"a grid of G={G} bins over {n} rows is past the partitioned kernel's limits "
        f"(at most {grid_partition.P_MAX} buckets, fewer than 2^31 rows per call); the "
        f"sort strategies are not ported yet (ROADMAP queue A6)")


def grid_sums(idx, int_cols, float_cols, G, count):
    """(strategy, int_sums, float_sums) through the kernel the plan picks;
    raises NotImplementedError past B3's limits."""
    name = strategy(idx.shape[0], int(G), len(int_cols), len(float_cols), count)
    if name is None:
        raise _past_b3(idx.shape[0], G)
    return (name, *KERNELS[name](idx, int_cols, float_cols, G, count))


def b4_max_g(C):
    """The widest grid B4 takes at C terms: one warp's grid within
    ``B4_MAX_WARP_BYTES``, and G = 1 always (B5's atomics would all hit one
    word)."""
    return max(1, B4_MAX_WARP_BYTES // (8 * C) - grid_additive.STAGE_ROWS)


def moment_strategy(n, G, C):
    """``b4``, ``b5``, ``b3`` or None for an n-row call of C moment terms
    over G bins: B4 (:func:`.grid_moments.grid_moments`) up to
    :func:`b4_max_g`, B5
    (:func:`.grid_moments.grid_moments_window`) up to ``B5_MAX_WINDOWS``
    bin windows, then B3 over the formed term columns."""
    if not 1 <= C <= grid_moments.MAX_TERMS or G < 1:
        raise ValueError(f"G={G} with {C} terms: the moment kernels take 1 to "
                         f"{grid_moments.MAX_TERMS} terms")
    if G <= b4_max_g(C) and grid_moments.fits(G, C):
        return B4
    if grid_window.n_windows(G, C) <= B5_MAX_WINDOWS:
        return B5
    if grid_partition.shape(n, G, C) is not None:
        return B3
    return None


def moment_sums(idx, bases, terms, G):
    """(strategy, counts, sums) of the moment terms (the contract of
    :mod:`.grid_moments`) through the kernel the plan picks.  On ``b3`` the
    terms are formed as columns in torch and B3 adds them; past B3's limits
    this raises NotImplementedError."""
    G = int(G)
    name = moment_strategy(idx.shape[0], G, len(terms))
    if name is None:
        raise _past_b3(idx.shape[0], G)
    if name == B3:
        grid_moments.check_inputs(idx, bases, terms, G)
        count_cols, float_cols = grid_moments.form_terms(idx, bases, terms)
        return (name, *grid_partition.grid_partition(idx, count_cols, float_cols, G, False))
    return (name, *MOMENT_KERNELS[name](idx, bases, terms, G))

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

A pass's per-bin extremes (min, max, the two mins of ``first``) take
:func:`extreme_strategy`'s route, always kernel B3x
(:func:`.grid_partition.grid_partition_extreme`): ``b3x-direct`` while the
[E, G] grid of keys fits one CTA's shared memory (no partition), ``b3x``
over a partition past that, in calls of at most ``grid_partition.MAX_EXT``
columns.  Where the additive batch of the same task is on ``b3``, the first
call of extremes shares its partition (:func:`grid_sums_and_extremes`): one
scatter serves the sums and the extremes.  Measured on the same card and
limit (``scripts/sweep_grid_kernels.py --extremes``; 1e8 uniform keys, f64
columns with NaN; PERF.md, section 6): the direct route beat the partition
wherever it fits (E = 1: 0.889 against 2.181 ms at G = 103, 1.719 against
2.224 at G = 24 576; E = 4: 4.471 against 5.570 at G = 4096), and B3x beat
``scatter_reduce_`` per column at every G (E = 1: 64.27 ms at G = 103, 6.609
at 10 609, 6.919 at 1 000 003 against 0.889, 0.951 and 3.599), so no range of
G goes to it.  Over a partition the time per column rises with the columns
of a call (G = 1 000 003: 3.599 ms at E = 1, 5.825 at 2, 13.718 at 4; 8
columns took 33.6 ms at their best bucket width): ``B3X_BATCH`` = 4.  Count +
f64 sum on B3 and one max on B3x took 11.637 ms as two calls and 8.850
sharing the scatter at G = 1 000 003 (8.305 against 5.449 at 67 081).
"""

from __future__ import annotations

from . import grid_additive, grid_moments, grid_partition, grid_window
from .grid_additive import n_channels

B1, B2, B3, B4, B5 = "b1", "b2", "b3", "b4", "b5"
B3X, B3X_DIRECT = "b3x", "b3x-direct"
# extreme columns per call over a partition (the kernel takes MAX_EXT): the
# sub-grid narrows as columns are added, and past four a second call is faster
B3X_BATCH = 4
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


def extreme_strategy(n, G, n_cols, n_int=0, n_float=0, count=False):
    """``b3x-direct``, ``b3x`` or None for one n-row call of ``n_cols``
    extreme columns (at most ``grid_partition.MAX_EXT``) over G bins that
    also carries the given additive columns: B3x over the raw rows while the
    keys of the grid fit one CTA's shared memory and nothing additive comes
    along, B3x over a partition up to B3's limits."""
    if not 1 <= n_cols <= grid_partition.MAX_EXT or G < 1:
        raise ValueError(f"G={G} with {n_cols} extreme columns: a call takes 1 to "
                         f"{grid_partition.MAX_EXT}")
    additive = n_channels(n_int, n_float, count) > 0
    if not additive and grid_partition.extreme_direct_fits(G, n_cols):
        return B3X_DIRECT
    if grid_partition.extreme_call_fits(n, G, n_cols, n_int, n_float, count):
        return B3X
    return None


def grid_extremes(idx, cols, modes, valids, G):
    """(strategy, grids): the per-bin extremes of any number of columns
    through B3x: ``grid_partition.MAX_EXT`` columns a call while they take
    the direct route, ``B3X_BATCH`` a call over a partition; raises
    NotImplementedError past B3's limits."""
    G, n = int(G), idx.shape[0]
    names, grids = [], []
    k = 0
    while k < len(cols):
        size = min(len(cols) - k, grid_partition.MAX_EXT)
        if extreme_strategy(n, G, size) != B3X_DIRECT:
            size = min(size, B3X_BATCH)
        batch = slice(k, k + size)
        name = extreme_strategy(n, G, size)
        if name is None:
            raise _past_b3(n, G)
        names.append(name)
        grids += grid_partition.grid_partition_extreme(idx, cols[batch], modes[batch],
                                                       valids[batch], G)[0]
        k += size
    return "+".join(dict.fromkeys(names)), grids


def grid_sums_and_extremes(idx, int_cols, float_cols, G, count, cols, modes, valids):
    """(additive strategy, extreme strategy, shared, int_sums, float_sums,
    grids) of a task's additive batch and its extreme columns.  When the
    plan sends the sums to ``b3`` and one call takes them with the first
    ``B3X_BATCH`` extreme columns, that call computes both from
    one partition (``shared``); the other extreme columns, and all of them
    otherwise, take :func:`grid_extremes`."""
    G, n = int(G), idx.shape[0]
    name = strategy(n, G, len(int_cols), len(float_cols), count)
    if name is None:
        raise _past_b3(n, G)
    head = min(len(cols), B3X_BATCH)
    shared = (name == B3 and head > 0
              and extreme_strategy(n, G, head, len(int_cols), len(float_cols), count) == B3X)
    if not shared:
        _, int_sums, float_sums = grid_sums(idx, int_cols, float_cols, G, count)
        ext_name, grids = grid_extremes(idx, cols, modes, valids, G) if cols else (None, [])
        return name, ext_name, False, int_sums, float_sums, grids
    grids, int_sums, float_sums = grid_partition.grid_partition_extreme(
        idx, cols[:head], modes[:head], valids[:head], G, int_cols, float_cols, count)
    ext_name = B3X
    if len(cols) > head:
        rest_name, rest = grid_extremes(idx, cols[head:], modes[head:], valids[head:], G)
        grids += rest
        ext_name = "+".join(dict.fromkeys([B3X, *rest_name.split("+")]))
    return name, ext_name, True, int_sums, float_sums, grids

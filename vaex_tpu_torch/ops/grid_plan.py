"""Which grid kernel a pass takes.  Its additive aggregators take one by the
grid size G and the channel count C (count + int columns + float columns):

* ``b1`` (:mod:`.grid_additive` on its lane route) while G <= ``B1_MAX_G``
  and a CTA holds four warps of its lane grids
  (:func:`.grid_additive.route`); B1's warp route, which the wrapper takes
  where the lane grids do not fit, is slower than B2 at every such grid
  measured, so the plan gives those grids to B2;
* ``b2`` (:mod:`.grid_window`) while its thread-block cluster takes at
  most :func:`b2_max_windows` bin windows;
* ``b3-l2`` (:func:`.grid_partition.grid_resident`, B3's resident route)
  while the [C, G] grid stays in the card's L2
  (:func:`.grid_partition.resident_fits`: G >= 131 072 and C * G * 8 bytes
  <= 28 MiB);
* ``b3`` (:func:`.grid_partition.grid_partition`, B3's partition route) up
  to its limits (N < 2^31 rows per call, at most ``grid_partition.P_MAX``
  buckets of a sub-grid that narrows as the channels grow);
* ``b3×k`` past them where calls of fewer channels fit: the batch split into
  k calls of B3's partition, each of as many channels as fit, the count with
  the first (:func:`_split_width`);
* ``sort`` past that (:mod:`.grid_sort`: a scatter of every row straight into
  the grid, any G, any N).  So the plan names a route for every (N, G, C).

Every kernel takes at most ``MAX_COLS`` (32) columns a call: a batch of more
(a PCA's covariance over eight features is 52 means, each a sum and a
count) goes as calls of at most ``MAX_COLS`` columns, the count with the
first, each through the plan, its strategy their routes joined by "+"
(``"b1+b1+b1+b1"``).

The cut-offs were measured on an NVIDIA H100 80GB HBM3 at its 700 W limit,
1e8 uniform keys (``scripts/sweep_grid_kernels.py``; PERF.md, section 6).
B1 against B2 (``--b1``; count + f64, + int64 +
f64, + two int64 + f64, + four int64 + f64): B1's lane route beat B2
wherever it is taken with a column (0.553 against 0.862 ms at G = 103,
C = 2; 0.648 against 0.825 at G = 128; 1.134 against 1.182 at G = 64,
C = 4); its warp route lost to B2 at every grid where the lane route does
not fit, from C = 3 at G = 103 (1.065 against 1.028) and C = 4 (1.558
against 1.095) to the narrowest ones (C = 6 at G = 42: 2.427 against 1.452;
C = 9 at G = 27: 5.127 against 1.899; C = 32 at G = 8: 71.42 against
5.472).  The count alone takes the lane route to G = 128 although B2 beat
it from G = 8 on (0.196 against 0.173 ms at G = 103; at G = 1 the lane
route's register sums won, 0.155 against 0.194; ROADMAP R3).  B2's cluster
(``--b2``: G = k windows of the widest window, count + int64 columns + one
f64 from C = 3) beat both routes of B3 to 4 windows at C = 1 and 2 (C = 1:
1.160 against 1.208 ms for ``b3-l2``; C = 2: 2.272 against 2.473) and lost
at 5 (1.334 against 1.195; 2.620 against 2.500); at C = 3 and 4 it beat
them at 2 windows (2.536 against 3.632 for ``b3``; 3.147 against 4.620) and
lost at 3 (4.270 against 3.644; 5.346 against 4.626): every row that lands
in another CTA's window is an atomic through distributed shared memory,
and those grow with the channels.  ``b3-l2`` against
``b3``: 2.423 against 2.769 ms at G = 200 003 and 2.434 against 2.952 at
1 000 003 for C = 2; 3.664 against 3.728 and 3.710 against 4.098 for C = 3
(a tie at 100 003: 3.681 against 3.670); 4.846 against 5.276 at 500 003 for
C = 4.  Past L2 it falls off: C = 4 at G = 1 000 003 (32 MB) 6.921 against
6.016, C = 3 at 4 000 037 (96 MB) 16.241 against 5.597.  Keys that pile on
few bins favour ``b3`` (a Zipf(1.1) draw at G = 1 000 003: 4.942 against
10.124 ms; one key: 3.114 against 5.997), sorted keys ``b3-l2`` (1.122
against 3.123); the plan cannot see the keys' order and goes by G alone.
The CPU runs the plain version of the kernel the plan picks, so the plan
and each kernel's bucket and window arithmetic run in the CPU tests too.

A pass's moment terms (var, std, covar, corr) take
:func:`moment_strategy`'s kernel: ``b4`` (B4: lane-private grids, or its
ordered warp grids), ``b5`` (B5, parts of 227 KiB) or, over the formed term
columns, ``b3-l2`` / ``b3`` / ``b3×k`` / ``sort``, with C the number of terms.  Its cut-offs were
measured the same way on that card (``--moments``; 1e8 uniform keys; C = 3:
var of an f64 column; C = 6: corr of two int64 columns; each through its
compiled set and, x and x*x swapped, through the run-time tables; runs W6,
W9 and W10 of PERF.md, section 6, PR 8's B4 and B5 timed in turns).  On
var's compiled set B4's lane route beat its warp route and B5 while a CTA
held two warps of lane grids (G = 103, three warps: 0.707 ms against 1.207
and 1.320; G = 128, two: 1.037 against 1.260 and 1.266) and lost at one (G
= 256: 2.108 against 1.394 and 1.171): ``grid_moments.LANE_MIN_WARPS[1]`` =
2, so var takes B4 to G = 181.  On corr's it won at three warps (G = 55:
2.210 against 2.754 and 2.810) and lost at two (G = 64: 3.156 against 2.777
and 2.710): ``LANE_MIN_WARPS[2]`` = 3, G <= 55.  Through the run-time tables
the lane route lost to the compiled sets at every G (var 2.002 against
0.390 ms at G = 1, 4.999 against 0.707 at 103, 7.414 against 1.037 at 128;
corr 1.536 against 0.877 at G = 1, 2.431 against 0.989 at 16; W9), beat the
warp route at eight warps (corr at G = 16: 2.581 against 2.755) and lost at
five (G = 32: 3.797 against 2.828; W10): ``LANE_MIN_WARPS[0]`` = 8.  B4's
warp route beat B5 to G = 103 at C = 3 (1.207 against 1.318 ms), tied it at
128 (1.257 against 1.266) and lost at 256 (1.392 against 1.170); at C = 6
it beat it at G = 64 (2.377 against 2.723) and lost at 103 (3.030 against
2.511): the warp route while G * C <= ``B4_MAX_GC`` (:func:`b4_max_g`: G <=
128 at C = 3, 64 at C = 6), and at G = 1 always.  B5's parts beat B3 over formed terms to 12
parts at C = 3 (G = 100 003: 6.993 against 7.278 ms for ``b3-l2``; PR 8)
and lost at 21 (G = 200 003: 12.221 against 7.256), beat it at 10 parts at
C = 6 (G = 32 768: 10.811 against 17.929) and lost at 18 (G = 65 536:
18.738 against 17.771): ``B5_MAX_PARTS`` = 12.

A pass's per-bin extremes (min, max, the two mins of ``first``) take
:func:`extreme_strategy`'s route, kernel B3x or past it ``sort``: ``b3x-direct``
(:func:`.grid_partition.grid_partition_extreme` over the raw rows, one grid
of keys a CTA) while the [E, G] keys fit one CTA's shared memory,
``b3x-l2`` (:func:`.grid_partition.grid_resident_extreme`, one grid of keys
that stays in L2) while the [G, stride] keys take at most
``grid_partition.RESIDENT_BYTES``, ``b3x`` over a partition past that,
``sort`` (:func:`.grid_sort.grid_sort_extreme`) where not even one column
fits the partition; in calls of ``grid_partition.MAX_EXT`` columns at most
on the direct route, as many as keep the keys in L2 on the resident route
and at most ``B3X_BATCH`` over a partition, fewer where the partition takes
fewer (:func:`_extreme_batch`).  Where the additive batch of the same
task is past B1 and the extremes alone take ``b3x``, or ``b3x-l2`` where
:func:`_apart` does not hold, the first call of extremes computes the sums
from its partition too (:func:`grid_sums_and_extremes`; the additive
strategy is then ``b3``): one scatter serves both.  Measured on the same
card and limit (``scripts/sweep_grid_kernels.py --extremes``; 1e8 uniform
keys, f64 columns with NaN; run W3 of PERF.md, section 6): ``b3x-l2`` beat
the partition at every G past the direct route (E = 1: 1.184 against 1.796
ms at G = 24 577, 1.145 against 2.037 at 1 054 729; E = 2: 1.306 against
3.635 at 1 000 003; E = 4: 2.047 against 4.525 at 6145, 1.440 against
5.049 at 131 072) up to its budget (28 MiB: E = 1 1.566 against 2.786 at G
= 3 670 016) and past it, so no lower edge of G is needed past the direct
route.  The upper edge is B3's resident budget, set by ``b3-l2``'s
measurement above, not by B3x's: past it the plan keeps the partition for
now, though ``b3x-l2`` beat it at every size measured
(W8, E = 1: 1.705 against 2.820 ms at G = 4 012 009, 3.352 against 3.843 at
2^23, 4.981 against 5.631 at 2^24, 128 MiB of keys; E = 4: 8.808 against
28.151 at 2^24); ROADMAP R3 moves that edge next.  The
direct route (W5, its keys taken a column at a time) beat ``b3x-l2``
wherever it fits, or tied it (E = 1: 0.547 against 1.268 ms at G = 10 609,
0.803 against 1.167 at 24 576; E = 2: 0.858 against 1.225 at 6144, 1.209
against 1.208 at 8192, 1.241 against 1.361 at 10 609; E = 4: 2.053 against
2.100 at 4096, 2.124 against 2.048 at 6144), so it keeps its whole range.
B3x beat ``scatter_reduce_`` per column at every G (E = 1: 64.30 ms at G =
103, 6.602 at 10 609, 6.935 at 1 054 729 against 0.507, 0.548 and 1.145;
W3, W5), so no range of G goes to it.  Over a partition the
time per column rises with the columns of a call (G = 1 000 003: 2.056 ms
at E = 1, 3.678 at 2, 8.233 at 4, 19.979 at 8; PR 8): ``B3X_BATCH`` = 4.
Count + f64 sum beside E extreme columns, one shared scatter against the
sums on their own route and ``b3x-l2`` apart (W5): at 32 768 (sums on B2 in
two windows) 3.140 against 3.079 ms (E = 1) and 4.054 against 3.018 (E =
2); at 67 081 (B2, four windows) 3.200 against 4.513 and 4.102 against
4.492; at 131 072 (``b3-l2``) 3.203 against 3.515 and 4.145 against 3.596;
at 1 000 003 3.437 against 3.577 and 5.043 against 3.748: ``_apart``
beside B2 in at most ``B3X_APART_B2_WINDOWS`` = 2 windows, or beside
``b3-l2`` from ``B3X_APART_MIN_COLS`` = 2 extreme columns.

Every function that adds a tile takes ``out``: the rows (grids) of the
pass's running state, which every route leaves holding their old value plus
the tile's (the min / max of both for the extremes), in place; ``sort``
scatters straight into them (:mod:`.grid_sort`), the kernels' tile grids
are added into them.

While :mod:`..tracing` records, each of :func:`grid_sums`,
:func:`moment_sums`, :func:`grid_extremes` and
:func:`grid_sums_and_extremes` is a ``launch:<route>`` span, from its entry
to the return of its kernel's enqueue.
"""

from __future__ import annotations

import torch

from . import grid_additive, grid_moments, grid_partition, grid_sort, grid_window
from .. import tracing
from .grid_additive import MAX_COLS, n_channels

B1, B2, B3, B4, B5 = "b1", "b2", "b3", "b4", "b5"
B3_L2 = "b3-l2"
B3X, B3X_DIRECT, B3X_L2 = "b3x", "b3x-direct", "b3x-l2"
SORT = grid_sort.SORT
SPLIT = "×"  # "b3×2": B3's partition in two calls
# extreme columns per call over a partition (the kernel takes MAX_EXT): the
# sub-grid narrows as columns are added, and past four a second call is faster
B3X_BATCH = 4
# where the extremes take b3x-l2, they go apart from the sums when the sums
# take b2 in at most B3X_APART_B2_WINDOWS windows, or b3-l2 beside at least
# B3X_APART_MIN_COLS extreme columns; elsewhere both share b3's scatter
B3X_APART_B2_WINDOWS = 2
B3X_APART_MIN_COLS = 2
B1_MAX_G = 128
# B2's cluster size while it beat B3: at most B2_MAX_WINDOWS[0] windows up
# to B2_FEW_CHANNELS channels, B2_MAX_WINDOWS[1] past them
B2_FEW_CHANNELS = 2
B2_MAX_WINDOWS = (4, 2)
# B4 on its lane route wherever that takes the grid, on its warp route while
# G * C is at most this; B5's parts past it
B4_MAX_GC = 384
B5_MAX_PARTS = 12

KERNELS = {B1: grid_additive.grid_additive,
           B2: grid_window.grid_window,
           B3_L2: grid_partition.grid_resident, B3: grid_partition.grid_partition}
PLAIN = {B1: grid_additive.grid_additive_reference,
         B2: grid_window.grid_window_reference,
         B3_L2: grid_partition.grid_resident_reference,
         B3: grid_partition.grid_partition_reference}
MOMENT_KERNELS = {B4: grid_moments.grid_moments, B5: grid_moments.grid_moments_window}
MOMENT_PLAIN = {B4: grid_moments.grid_moments_reference,
                B5: grid_moments.grid_moments_window_reference}


def _split_width(n, G, C):
    """The most channels one call of B3's partition takes at G over n rows,
    at most C; 0 where not even one does."""
    while C and grid_partition.shape(n, G, C) is None:
        C -= 1
    return C


def _wide(n, G, C):
    """``b3-l2``, ``b3``, ``b3×k`` or ``sort`` for a grid past the windowed
    kernels."""
    if grid_partition.resident_fits(G, C):
        return B3_L2
    width = _split_width(n, G, C)
    if width == C:
        return B3
    return f"{B3}{SPLIT}{-(-C // width)}" if width else SORT


def _column_parts(n_int, n_float, count):
    """A batch of more than ``MAX_COLS`` columns (every kernel's limit) as
    calls of at most ``MAX_COLS`` columns, ints first, the count with the
    first call: [((int from, to), (float from, to), count)]."""
    parts = []
    for k in range(0, n_int + n_float, MAX_COLS):
        end = min(k + MAX_COLS, n_int + n_float)
        parts.append(((min(k, n_int), min(end, n_int)),
                      (max(k - n_int, 0), max(end - n_int, 0)), bool(count) and k == 0))
    return parts


def strategy(n, G, n_int, n_float, count):
    """``b1``, ``b2``, ``b3-l2``, ``b3``, ``b3×k`` or ``sort`` for an n-row
    call over G bins; past ``MAX_COLS`` columns the routes of its calls of
    at most ``MAX_COLS`` columns, joined by "+" (:func:`_column_parts`)."""
    if n_int + n_float > MAX_COLS:
        return "+".join(strategy(n, G, i1 - i0, f1 - f0, c)
                        for (i0, i1), (f0, f1), c in _column_parts(n_int, n_float, count))
    C = n_channels(n_int, n_float, count)
    if C < 1 or G < 1:
        raise ValueError(f"nothing to add: G={G}, no columns and no count")
    if (G <= B1_MAX_G and grid_additive.fits(G, n_int, n_float, count)
            and grid_additive.route(G, n_int, n_float, count) == grid_additive.LANE):
        return B1
    if grid_window.cluster_windows(G, C, count) <= b2_max_windows(C):
        return B2
    return _wide(n, G, C)


def b2_max_windows(C):
    """The most windows of B2's cluster the plan gives a grid of C channels."""
    return B2_MAX_WINDOWS[C > B2_FEW_CHANNELS]


def _added(out, sums):
    """Each row of ``out`` (None: none given) plus the tile's row of
    ``sums`` in place; the tile's own row where no row is given."""
    if out is None:
        return sums
    return [s if row is None else row.add_(s) for row, s in zip(out, sums)]


def _split_sums(idx, int_cols, float_cols, G, count):
    """B3's partition in calls of :func:`_split_width` channels, the count
    with the first: (int rows, float rows)."""
    n = idx.shape[0]
    channels = ([("count", None)] if count else []) + [("int", c) for c in int_cols] + [
        ("float", c) for c in float_cols]
    width = _split_width(n, G, len(channels))
    int_rows, float_rows = [], []
    for k in range(0, len(channels), width):
        part = channels[k:k + width]
        i, f = grid_partition.grid_partition(
            idx, [c for kind, c in part if kind == "int"],
            [c for kind, c in part if kind == "float"], G, part[0][0] == "count")
        int_rows += list(i)
        float_rows += list(f)
    return int_rows, float_rows


def _wide_sums(name, idx, int_cols, float_cols, G, count, out):
    """(int_sums, float_sums) of a call on the wide route ``name``."""
    if name == SORT:
        return grid_sort.grid_sort(idx, int_cols, float_cols, G, count, out)
    if SPLIT in name:
        int_sums, float_sums = _split_sums(idx, int_cols, float_cols, G, count)
        if out is None:  # one tensor each, as every other route returns
            return (torch.stack(int_sums) if int_sums else _empty(idx, G, torch.int64),
                    torch.stack(float_sums) if float_sums else _empty(idx, G, torch.float64))
    else:
        int_sums, float_sums = KERNELS[name](idx, int_cols, float_cols, G, count)
    return (_added(None if out is None else out[0], int_sums),
            _added(None if out is None else out[1], float_sums))


def _empty(idx, G, dtype):
    return torch.zeros((0, G), dtype=dtype, device=idx.device)


def _column_sums(idx, int_cols, float_cols, G, count, out):
    """(int sums, float sums) of a batch past ``MAX_COLS`` columns, a call
    through the plan for each of :func:`_column_parts`."""
    int_rows, float_rows = [], []
    first = int(bool(count))  # the count's row, before the int columns'
    for (i0, i1), (f0, f1), c in _column_parts(len(int_cols), len(float_cols), count):
        rows = None if out is None else (
            (list(out[0][:first]) if c else []) + list(out[0][first + i0:first + i1]),
            list(out[1][f0:f1]))
        _, ints, floats = grid_sums(idx, int_cols[i0:i1], float_cols[f0:f1], G, c, rows)
        int_rows += list(ints)
        float_rows += list(floats)
    if out is not None:
        return int_rows, float_rows
    return (torch.stack(int_rows) if int_rows else _empty(idx, G, torch.int64),
            torch.stack(float_rows) if float_rows else _empty(idx, G, torch.float64))


@tracing.launched
def grid_sums(idx, int_cols, float_cols, G, count, out=None):
    """(strategy, int_sums, float_sums) through the route the plan picks;
    ``out`` (int rows, float rows: per channel, the count first, a [G] int64
    or float64 tensor or None) takes the tile's sums in place, and then the
    sums come back as lists of those rows (the tile's own where None)."""
    G = int(G)
    name = strategy(idx.shape[0], G, len(int_cols), len(float_cols), count)
    if len(int_cols) + len(float_cols) > MAX_COLS:
        return (name, *_column_sums(idx, int_cols, float_cols, G, count, out))
    if name in (B1, B2):
        int_sums, float_sums = KERNELS[name](idx, int_cols, float_cols, G, count)
        return (name, _added(None if out is None else out[0], int_sums),
                _added(None if out is None else out[1], float_sums))
    return (name, *_wide_sums(name, idx, int_cols, float_cols, G, count, out))


def b4_max_g(C):
    """The widest grid B4's warp route takes at C terms: G * C within
    ``B4_MAX_GC``, and G = 1 always (B5's atomics would all hit one word)."""
    return max(1, B4_MAX_GC // C)


def moment_strategy(n, G, C, n_count=1, compiled=0, nb_table=0):
    """``b4``, ``b5``, ``b3-l2``, ``b3``, ``b3×k`` or ``sort`` for an n-row
    call of C moment terms over G bins, ``compiled`` the batch's compiled
    term set, 0 for none (:func:`.grid_moments.compiled`), ``nb_table`` the
    bases whose shift tables a kernel keeps in shared memory (a shift a
    cell: :func:`.grid_moments.table_bases`): B4
    (:func:`.grid_moments.grid_moments`) wherever its lane route takes the
    grid beside them (:func:`.grid_moments.route`) and on its warp route up
    to :func:`b4_max_g`, B5 (:func:`.grid_moments.grid_moments_window`) up to
    ``B5_MAX_PARTS`` parts (:func:`.grid_moments.part_plan`), then the wide
    routes over the formed term columns (:func:`_wide`)."""
    if not 1 <= C <= grid_moments.MAX_TERMS or G < 1:
        raise ValueError(f"G={G} with {C} terms: the moment kernels take 1 to "
                         f"{grid_moments.MAX_TERMS} terms")
    if grid_moments.route(G, n_count, C - n_count, compiled, nb_table) == grid_moments.LANE or (
            G <= b4_max_g(C) and grid_moments.fits(G, C, nb_table)):
        return B4
    if grid_moments.n_parts(G, C, n_count, nb_table) <= B5_MAX_PARTS:
        return B5
    return _wide(n, G, C)


@tracing.launched
def moment_sums(idx, bases, terms, G, out=None, shift=None):
    """(strategy, counts, sums) of the moment terms (the contract of
    :mod:`.grid_moments`, each base less its ``shift``: a constant or a [G]
    table a base) through the route the plan picks.  On the wide routes the
    terms are formed as columns in torch, shifted as the kernels shift them
    (a table read at each row's bin), and B3 (or ``sort``) adds them.
    ``out`` holds per term a [G] row (int64 for a count term, float64 else)
    or None, taken in place as in :func:`grid_sums`.  idx None: every row in
    bin 0, G = 1, which B4 takes without an index."""
    G = int(G)
    n = (idx if idx is not None else bases[0]).shape[0]
    n_count = sum(int(t[0]) < 0 for t in terms)
    shift = grid_moments.shift_values(bases, shift, G)  # once: the kernels' host path is short
    name = moment_strategy(n, G, len(terms), n_count, grid_moments.compiled(len(bases), terms),
                           grid_moments.table_bases(shift))
    rows = None if out is None else (  # the kernels' count rows, then their float rows
        [row for row, t in zip(out, terms) if int(t[0]) < 0],
        [row for row, t in zip(out, terms) if int(t[0]) >= 0])
    if name in (B4, B5):
        counts, sums = MOMENT_KERNELS[name](idx, bases, terms, G, shift)
        if out is None:
            return name, counts, sums
        return name, _added(rows[0], counts), _added(rows[1], sums)
    grid_moments.check_inputs(idx, bases, terms, G, shift=shift)
    count_cols, float_cols = grid_moments.form_terms(idx, bases, terms, shift, G)
    return (name, *_wide_sums(name, idx, count_cols, float_cols, G, False, rows))


def extreme_strategy(n, G, n_cols, n_int=0, n_float=0, count=False):
    """``b3x-direct``, ``b3x-l2``, ``b3x`` or ``sort`` for one n-row call of
    ``n_cols`` extreme columns (at most ``grid_partition.MAX_EXT``) over G
    bins that also carries the given additive columns: B3x over the raw rows
    while the keys of the grid fit one CTA's shared memory, its resident
    route while they stay in L2 (both when nothing additive comes along),
    B3x over a partition up to B3's limits, :mod:`.grid_sort` past them."""
    if not 1 <= n_cols <= grid_partition.MAX_EXT or G < 1:
        raise ValueError(f"G={G} with {n_cols} extreme columns: a call takes 1 to "
                         f"{grid_partition.MAX_EXT}")
    additive = n_channels(n_int, n_float, count) > 0
    if not additive and grid_partition.extreme_direct_fits(G, n_cols):
        return B3X_DIRECT
    if not additive and grid_partition.extreme_resident_fits(G, n_cols):
        return B3X_L2
    if grid_partition.extreme_call_fits(n, G, n_cols, n_int, n_float, count):
        return B3X
    return SORT


def _extreme_batch(n, G, left):
    """The columns of the next call of :func:`grid_extremes`, ``left`` still
    to go: ``grid_partition.MAX_EXT`` at most on the direct route, as many as
    keep the grid of keys in L2 on the resident route, ``B3X_BATCH`` over a
    partition, or fewer where the partition takes fewer (one where it takes
    none: that call goes to ``sort``)."""
    size = min(left, grid_partition.MAX_EXT)
    if extreme_strategy(n, G, size) == B3X_DIRECT:
        return size
    resident = size
    while resident and not grid_partition.extreme_resident_fits(G, resident):
        resident -= 1
    if resident and extreme_strategy(n, G, resident) == B3X_L2:
        return resident
    size = min(size, B3X_BATCH)
    while size > 1 and extreme_strategy(n, G, size) == SORT:
        size -= 1
    return size


def _taken(out, grids, modes):
    """Each grid of ``out`` (None: none given) with the tile's grid taken
    into it in place by its mode; the tile's own grid where none is given."""
    if out is None:
        return grids
    return [g if row is None else (torch.minimum if mode == "min" else torch.maximum)(
        row, g, out=row) for row, g, mode in zip(out, grids, modes)]


@tracing.launched
def grid_extremes(idx, cols, modes, valids, G, out=None):
    """(strategy, grids): the per-bin extremes of any number of columns
    through B3x, in calls of :func:`_extreme_batch` columns, or all of them
    through ``sort`` where not one column fits B3x's partition.  ``out``
    holds per column a [G] grid of its dtype (or None) that takes the tile's
    extremes in place."""
    G, n = int(G), idx.shape[0]
    outs = [None] * len(cols) if out is None else list(out)
    if extreme_strategy(n, G, 1) == SORT:
        return SORT, grid_sort.grid_sort_extreme(idx, cols, modes, valids, G, outs)
    names, grids = [], []
    k = 0
    while k < len(cols):
        size = _extreme_batch(n, G, len(cols) - k)
        batch = slice(k, k + size)
        name = extreme_strategy(n, G, size)
        names.append(name)
        if name == B3X_L2:
            tile = grid_partition.grid_resident_extreme(idx, cols[batch], modes[batch],
                                                        valids[batch], G)
        else:
            tile = grid_partition.grid_partition_extreme(idx, cols[batch], modes[batch],
                                                         valids[batch], G)[0]
        grids += _taken(outs[batch], tile, modes[batch])
        k += size
    return "+".join(dict.fromkeys(names)), grids


def _apart(G, name, C, count, n_cols):
    """True where extremes on ``b3x-l2`` beside sums on ``name`` (C channels)
    take less apart than sharing one scatter: where the sums' own call is
    cheap (B2 in few windows) or the extremes are several (beside
    ``b3-l2``)."""
    if name == B2:
        return grid_window.cluster_windows(G, C, count) <= B3X_APART_B2_WINDOWS
    return name == B3_L2 and n_cols >= B3X_APART_MIN_COLS


@tracing.launched
def grid_sums_and_extremes(idx, int_cols, float_cols, G, count, cols, modes, valids,
                           out=None, ext_out=None):
    """(additive strategy, extreme strategy, shared, int_sums, float_sums,
    grids) of a task's additive batch and its extreme columns.  When the
    extremes alone take ``b3x`` (past L2), or ``b3x-l2`` where :func:`_apart`
    does not hold, the sums are past ``b1`` and one call of B3x's partition
    takes the sums with the first ``B3X_BATCH`` extreme columns, that call
    computes both from one partition (``shared``; the additive strategy is
    then ``b3``); the other extreme columns, and all of them otherwise, take
    :func:`grid_extremes`, and the sums :func:`grid_sums`.  ``out`` and
    ``ext_out`` are those functions' ``out``."""
    G, n = int(G), idx.shape[0]
    name = strategy(n, G, len(int_cols), len(float_cols), count)
    head = min(len(cols), B3X_BATCH)
    alone = extreme_strategy(n, G, _extreme_batch(n, G, len(cols))) if cols else None
    C = n_channels(len(int_cols), len(float_cols), count)
    shared = (name in (B2, B3_L2, B3) and (alone == B3X or alone == B3X_L2
                                           and not _apart(G, name, C, count, len(cols)))
              and extreme_strategy(n, G, head, len(int_cols), len(float_cols), count) == B3X)
    ext_out = [None] * len(cols) if ext_out is None else list(ext_out)
    if not shared:
        _, int_sums, float_sums = grid_sums(idx, int_cols, float_cols, G, count, out)
        ext_name, grids = (grid_extremes(idx, cols, modes, valids, G, ext_out) if cols
                           else (None, []))
        return name, ext_name, False, int_sums, float_sums, grids
    grids, int_sums, float_sums = grid_partition.grid_partition_extreme(
        idx, cols[:head], modes[:head], valids[:head], G, int_cols, float_cols, count)
    grids = _taken(ext_out[:head], grids, modes[:head])
    if out is not None:
        int_sums, float_sums = _added(out[0], int_sums), _added(out[1], float_sums)
    name, ext_name = B3, B3X
    if len(cols) > head:
        rest_name, rest = grid_extremes(idx, cols[head:], modes[head:], valids[head:], G,
                                        ext_out[head:])
        grids += rest
        ext_name = "+".join(dict.fromkeys([B3X, *rest_name.split("+")]))
    return name, ext_name, True, int_sums, float_sums, grids

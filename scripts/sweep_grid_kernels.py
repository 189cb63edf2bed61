#!/usr/bin/env python3
"""Times the grid kernels against each other across G, on one GPU, to set
the cut-offs of vaex_tpu_torch/ops/grid_plan.py.

    python3 scripts/sweep_grid_kernels.py [N]              (default N = 1e8)
    python3 scripts/sweep_grid_kernels.py [N] --moments
    python3 scripts/sweep_grid_kernels.py [N] --extremes
    python3 scripts/sweep_grid_kernels.py [N] --b1
    python3 scripts/sweep_grid_kernels.py [N] --b2

    python3 scripts/sweep_grid_kernels.py ... --baseline DIR

Builds every kernel (one nvcc per source, all at once), checks each
against the plain index_add_ version at N = 1_000_003 on uniform, sorted,
single-key and Zipf(1.1) keys (ints exact, floats to rtol 1e-9), then
times, with CUDA events, B1 (where its grid fits, at 1 and 4 rows per lane
and warp step), B2 (up to its cluster limit), B3's partition route at three
sub-grid budgets, its resident route (b3-l2) and bincount + index_add_ (the
library calls), at N rows of uniform keys, for C = 2 (count + f64), 3
(count + int64 + f64) and 4 (count + 2 int64 + f64) channels, with the
partition's phases at three G; then the partition's phases at other launch
constants and both routes on the skewed keys at G = 1 000 003.  Prints one line per (C, G) and exits non-zero on a
mismatch.  ``--baseline DIR`` times beside them the B2, B3 and B3x of
another checkout of this repository unpacked under DIR (its own build
directory), in the same process, in turns; with ``--b1`` and ``--moments``
its B1 and B4/B5 too.

``--b2`` sweeps B2's cluster kernel, the source of ``B2_MAX_WINDOWS``: it
prints the atomic instructions of B2's SASS (``cuobjdump -sass``; of the
baseline's too), checks the kernel against the plain version at
N = 1_000_003, then times, for C = 1 (count), 2, 3 and 4 at
G = k windows of the widest window (k = 1..8, the cluster size): B2 as
planned, the baseline's B2, both routes of B3 and the library calls, with
the clusters the occupancy query allows; and at the query shapes (q2: count
+ an int64 column of values 1..5; count + int64 + f64 at G = 10 609 and
32 768; the 2-D count at G = 67 081; the count at G = 10 609; the set
grouper of 2000 keys; the 99.7% histogram) B2 and the baseline's B2 in
turns, on small and on large int64 values.

``--b1`` sweeps B1's two routes, the source of ``LANE_MIN_WARPS``,
``B1_MAX_G`` and the plan's B2 past the lane route: it prints the atomics
of B1's SASS, checks both routes against the plain version at
N = 1_000_003 (G = 1, 103, 128, 512; the count alone, + f64, + int64 +
f64, + two int64 + f64; an f32 column beside;
columns starting at row 0 and at an odd row; floats bit-equal run to run),
then times the lane route, the warp route, the baseline's B1 and B2, in
turns, at G = 1 .. 256 for C = 1 to 4 and 6, the warp route against B2 at
the narrowest grids of the warp route for C = 6 to 32, and B1 against the
baseline at the shapes of the main path, the isin count, df.sum and
chip_smoke.py's phase 3.

``--moments`` sweeps the moment kernels instead, the source of
``moment_strategy``'s cut-offs and of B4's ``LANE_MIN_WARPS``: it prints the
atomics of B4's and B5's SASS (and the baseline's), checks both routes of B4
(bit-equal run to run) and B5 against their plain versions at N = 1_000_003
(counts exact, floats to rtol 1e-9; it stops there on a mismatch), breaks
B5 down at G = 10 609 and 3000 (the walk with a count, then the base loads
and the terms added one at a time through the run-time tables, then var's
and corr's terms through the tables beside their compiled sets) and, with
``--baseline``, times B5 against the baseline's at q6-sd's and q9's shapes
in turns; then times B4's lane and warp routes and the baseline's B4 in
turns (where each takes the grid; also the lane route through the run-time
tables, x and x*x swapped so that the compiled set does not apply; at G = 1
also without an index, and ``torch.var_mean``),
B5 (up to 64 parts) and the baseline's B5, both routes of B3 over the
formed term columns and, at a few G, the plain version, for C = 3 (var of
an f64 column: x, x*x, count) and C = 6 (corr of two int64 columns, as
H2O's q9: x*y, x, y, x*x, y*y, count), with a NaN in every 97th f64 value;
and B5 against the baseline at G = 10 609 on sorted keys, one key and a
Zipf(1.1) draw.

``--extremes`` sweeps the min/max kernel B3x, the source of
``extreme_strategy``'s routes: it checks its three routes against the plain
version (``scatter_reduce_`` with a drop bin) at N = 1_000_003 for int64,
f64 (NaN, +-inf, -0.0), f32, a validity and sums riding along, by value, on
uniform, sorted, single-key and Zipf(1.1) keys; then times, for E = 1, 2
and 4 f64 columns (min, max alternating; a NaN in every 97th value), in
turns: the resident route ``b3x-l2`` against the partition ``b3x`` and the
baseline's B3x across G up to the resident budget and past it (to 2^24
cells, 128 MiB of keys a column); the direct
route against ``b3x-l2`` where both take the grid; both on the 2-D max's and
q7's G on uniform, sorted, single-key and Zipf keys; the partition's phases
(count, offsets + scatter, phase 2, fill + fold) at E = 1, 2 and 4; count +
f64 sum beside E = 1 and 2 extreme columns as one shared scatter against
the plan's sums and ``b3x-l2`` apart; the partition at three bucket widths
(the source of ``EXT_GRID_BYTES`` and ``B3X_BATCH``); and every G as the
plan routes it against ``scatter_reduce_``.
"""

import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import SKEWS, library_additive_ms, partition_phases, skewed_keys  # noqa: E402
GS = (103, 256, 512, 1024, 4096, 10609, 32768, 67081, 100003, 200003, 300003, 500003, 1000003,
      4000037, 16000057)
# B3's sub-grid budgets (KiB of shared memory per phase-2 CTA) the sweep tries
SUB_GRIDS = (48, 96, 192)


def cuda_ms(fn, reps=3):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def columns(n, C, gen):
    ints = [torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen, device="cuda",
                          dtype=torch.int64) for _ in range(C - 2)]
    floats = [torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100]
    return ints, floats


MOMENT_GS = (1, 8, 16, 32, 41, 55, 64, 103, 128, 256, 512, 1024, 3968, 10609, 32768, 65536, 100003,
             200003, 1000003)


def table_terms(terms):
    """var's or corr's terms with x and x*x swapped, and the row of each of
    the given float terms among them: the same work, which B4 then takes
    through the run-time tables, not the compiled set."""
    at = {tuple(t[:2]): k for k, t in enumerate(terms)}
    i, j = at[(0, -1)], at[(0, 0)]
    swapped = list(terms)
    swapped[i], swapped[j] = terms[j], terms[i]
    floats = [t for t in terms if t[0] >= 0]
    given = [t for t in swapped if t[0] >= 0]
    return swapped, [given.index(t) for t in floats]


def moment_inputs(n, C, gen):
    """(bases, terms) of var (C = 3) or corr (C = 6)."""
    from vaex_tpu_torch import agg
    if C == 3:
        x = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        x[::97] = float("nan")
        return [x], agg.VAR_TERMS
    v = [torch.randint(1, 6, (n,), generator=gen, device="cuda", dtype=torch.int64)
         for _ in range(2)]
    return v, agg.CORR_TERMS


# B5's breakdown at q6-sd / q9's G: terms added one at a time through the
# run-time tables (SET_ANY in csrc/moments_common.cuh), then var's and corr's
# terms through the tables beside their compiled sets.  There the count needs
# fewer bases than the compiled set's (var: every row; corr: x alone, and its
# int64 bases cannot be NaN), which keeps the batch off the compiled set with
# the same loads and, for corr, the same sums
B5_STEPS = (("walk + count", 0, [(-1, -1, -1, -1)]),
            ("+ x loads (the count needs x)", 1, [(-1, -1, 0, -1)]),
            ("+ x", 1, [(-1, -1, 0, -1), (0, -1, -1, -1)]),
            ("+ x*x, a count of every row (var's terms from the tables)", 1,
             [(-1, -1, -1, -1), (0, -1, -1, -1), (0, 0, -1, -1)]),
            ("var, compiled", 1, None),
            ("corr's count (x and y int64: nothing to load)", 2, [(-1, -1, 0, 1)]),
            ("+ x*y, x, y", 2, [(-1, -1, 0, 1), (0, 1, 0, 1), (0, -1, 0, 1), (1, -1, 0, 1)]),
            ("+ x*x, y*y, the count needing x alone (corr's terms from the tables)", 2,
             [(-1, -1, 0, -1), (0, 1, 0, 1), (0, -1, 0, 1), (1, -1, 0, 1), (0, 0, 0, 1),
              (1, 1, 0, 1)]),
            ("corr, compiled", 2, None))


def sweep_moments(n, gen, old):
    from vaex_tpu_torch import agg
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import kernel_build
    for name in ("grid_moments", "grid_moments_window"):
        print_sass(name, kernel_build.build(name)[name][0], ("ATOM", "RED"))
        if old is not None:
            print_sass(f"{name} baseline", old.kernel_build.build(name)[name][0], ("ATOM", "RED"))
    for C in (3, 6):
        for G in (1, 2, 41, 42, 103, 121, 122, 3968, 10609, 11623, 29057, 100003):
            idx = torch.randint(-1, G + G // 8 + 1, (1_000_003,), generator=gen, device="cuda",
                                dtype=torch.int32)
            bases, terms = moment_inputs(1_000_003, C, gen)
            # (label, kernel, idx, terms, the float rows in the order of terms)
            kerns = [(f"b4 {how}", b4_route(gm, how), idx, terms, None)
                     for how in (gm.LANE, gm.WARP) if b4_takes(gm, how, G, C)]
            if b4_takes(gm, gm.LANE, G, C):
                kerns.append(("b4 lane tables", b4_route(gm, gm.LANE), idx,
                              *table_terms(terms)))
            if G > 1:
                kerns.append(("b5", gm.grid_moments_window, idx, terms, None))
            else:  # no index: every row in bin 0
                kerns.append(("b4 no idx", gm.grid_moments, None, terms, None))
            for label, kern, rows, order, floats in kerns:
                want = gm.grid_moments_reference(rows, bases, terms, G)
                got, again = kern(rows, bases, order, G), kern(rows, bases, order, G)
                if floats is not None:
                    got, again = (got[0], got[1][floats]), (again[0], again[1][floats])
                torch.cuda.synchronize()
                ok = torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1],
                                                                     rtol=1e-9, atol=1e-9)
                same = torch.equal(got[1], again[1])
                print(f"check C={C} G={G} {label}: {'ok' if ok else 'MISMATCH'}"
                      f"{', floats bit-equal run to run' if same else ''}", flush=True)
                if not ok:
                    return 1
    x = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
    x[::97] = float("nan")
    v = [torch.randint(1, 6, (n,), generator=gen, device="cuda") for _ in range(2)]
    for G in (10609, 3000):
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for label, nb, terms in B5_STEPS:
            bases = [x] if nb == 1 else v[:nb]
            if terms is None:
                terms = agg.VAR_TERMS if nb == 1 else agg.CORR_TERMS
            parts = gm.n_parts(G, len(terms), sum(t[0] < 0 for t in terms))
            ms = cuda_ms(lambda: gm.grid_moments_window(idx, bases, terms, G))
            print(f"b5 breakdown G={G} N={n} {label} (parts {parts}): {ms:.3f} ms", flush=True)
        del idx
    if old is not None:  # q6-sd's and q9's shapes, in turns
        idx = torch.randint(0, 10609, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for C in (3, 6):
            bases, terms = moment_inputs(n, C, gen)
            row = {}
            for turn in range(3):
                row[f"b5.{turn}"] = cuda_ms(
                    lambda: gm.grid_moments_window(idx, bases, terms, 10609), 5)
                row[f"baseline.{turn}"] = cuda_ms(
                    lambda: old.grid_moments.grid_moments_window(idx, bases, terms, 10609), 5)
            print(f"b5 against the baseline C={C} G=10609 N={n}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
        del idx
    for C in (3, 6):
        bases, terms = moment_inputs(n, C, gen)
        for G in MOMENT_GS:
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            row = {}
            for turn in range(2):
                for how in (gm.LANE, gm.WARP):
                    if b4_takes(gm, how, G, C):
                        row[f"b4 {how}.{turn}"] = cuda_ms(
                            lambda: b4_route(gm, how)(idx, bases, terms, G))
                if b4_takes(gm, gm.LANE, G, C):
                    row[f"b4 lane tables.{turn}"] = cuda_ms(
                        lambda: b4_route(gm, gm.LANE)(idx, bases, table_terms(terms)[0], G))
                if G == 1:
                    row[f"b4 no idx.{turn}"] = cuda_ms(
                        lambda: gm.grid_moments(None, bases, terms, G))
                if old is not None and gm.fits(G, C):
                    row[f"b4 baseline.{turn}"] = cuda_ms(
                        lambda: old.grid_moments.grid_moments(idx, bases, terms, G))
            if G == 1 and bases[0].is_floating_point():
                row["torch.var_mean"] = cuda_ms(lambda: torch.var_mean(bases[0]))
            if G > 1 and gm.n_parts(G, C) <= 64:
                row["b5"] = cuda_ms(lambda: gm.grid_moments_window(idx, bases, terms, G))
                if old is not None and baseline_parts(old, G, C) <= 64:
                    row["b5 baseline"] = cuda_ms(
                        lambda: old.grid_moments.grid_moments_window(idx, bases, terms, G))

            def b3():
                counts, floats = gm.form_terms(idx, bases, terms)
                return gp.grid_partition(idx, counts, floats, G, False)
            row["b3"] = cuda_ms(b3)

            def b3_l2():
                counts, floats = gm.form_terms(idx, bases, terms)
                return gp.grid_resident(idx, counts, floats, G, False)
            if G >= 4096:
                row["b3-l2"] = cuda_ms(b3_l2)
            if G in (1, 103, 10609, 1000003):
                row["plain"] = cuda_ms(lambda: gm.grid_moments_reference(idx, bases, terms, G), 1)
            warps = gm.CLUSTER_SMEM // gm.lane_warp_bytes(G, 1, C - 1)  # before MAX_WARPS
            print(f"moments C={C} G={G} N={n} parts={gm.n_parts(G, C)} lane warps {warps} "
                  f"planned {grid_plan_moments(G, C)}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
    # skewed keys at q9's G
    G = 10609
    for C in (3, 6):
        bases, terms = moment_inputs(n, C, gen)
        for kind in SKEWS:
            idx = keys(kind, n, G, gen)
            row = {"b5": cuda_ms(lambda: gm.grid_moments_window(idx, bases, terms, G), 1)}
            if old is not None:
                row["baseline"] = cuda_ms(
                    lambda: old.grid_moments.grid_moments_window(idx, bases, terms, G), 1)
            print(f"moments C={C} G={G} N={n} {kind} keys: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
    return 0


def b4_route(gm, how):
    """B4 with its route forced to ``how``."""
    def run(idx, bases, terms, G):
        planned, gm.route = gm.route, lambda *a: how
        try:
            return gm.grid_moments(idx, bases, terms, G)
        finally:
            gm.route = planned
    return run


def b4_takes(gm, how, G, C):
    """True where B4's route ``how`` takes C terms (one count) over G bins."""
    if how == gm.LANE:
        return gm.lane_warp_bytes(G, 1, C - 1) <= gm.CLUSTER_SMEM
    return gm.fits(G, C)


def grid_plan_moments(G, C):
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import grid_plan
    compiled = 1 if C == 3 else 2  # moment_inputs: var's compiled set at C = 3, corr's at 6
    name = grid_plan.moment_strategy(100_000_000, G, C, 1, compiled)
    return f"{name} ({gm.route(G, 1, C - 1, compiled)})" if name == grid_plan.B4 else name


def baseline_parts(old, G, C):
    """The CTAs a row is walked by in the baseline's B5: its parts, or its
    windows where it cuts windows only."""
    gm = old.grid_moments
    return gm.n_parts(G, C) if hasattr(gm, "n_parts") else gm.n_windows(G, C)


EXTREME_GS = (1, 8, 103, 1024, 4096, 10609, 24576, 32768, 67081, 262144, 1000003, 1054729)


def extreme_inputs(n, E, gen):
    cols = []
    for _ in range(E):
        x = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        x[::97] = float("nan")
        cols.append(x)
    return cols, ["min" if e % 2 else "max" for e in range(E)], [None] * E


def same_by_value(got, want):
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


def forced_partition(gp):
    """grid_partition_extreme with the direct route switched off."""
    def run(*args):
        planned, gp.extreme_direct_fits = gp.extreme_direct_fits, lambda G, E: False
        try:
            return gp.grid_partition_extreme(*args)[0]
        finally:
            gp.extreme_direct_fits = planned
    return run


def extreme_phases(gp, idx, cols, modes, G, label):
    """ms of the partition route's count, offsets + scatter, phase 2 and fold
    (the fold alone: the same launch over no rows)."""
    lib = gp._library()
    n, E = idx.shape[0], len(cols)
    sh = gp.extreme_shape(n, G, E, 0, gp._sm_count(idx.device))
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device="cuda")
    count_ms = cuda_ms(lambda: lib.grid_partition_count(
        idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, gp.COUNT_THREADS,
        counts.data_ptr(), stream), 5)
    rows_ms = cuda_ms(lambda: gp._partition_rows(lib, idx, G, sh, cols, stream), 5)
    lo, bucket_start, moved = gp._partition_rows(lib, idx, G, sh, cols, stream)
    grids = [torch.empty(G, dtype=c.dtype, device="cuda") for c in cols]
    keys = torch.full((E * G,), -1, dtype=torch.int64, device="cuda")
    ctas = gp.extreme_ctas(n, E * min(sh.S, G) * 8, gp._sm_count(idx.device))

    def phase2(rows):
        keys.fill_(-1)
        err = lib.grid_partition_extremes(
            0, lo.data_ptr(), None, rows, bucket_start.data_ptr(), G, sh.shift, sh.P,
            gp._pointers(moved), gp._pointers([None] * E), gp._pointers(grids),
            gp._ints([gp.EXT_TYPES[c.dtype] for c in cols]),
            gp._ints([m == "max" for m in modes]), E, ctas, gp.EXT_THREADS, keys.data_ptr(),
            stream)
        assert err == 0, err
    phase2_ms = cuda_ms(lambda: phase2(n), 5)
    fold_ms = cuda_ms(lambda: phase2(0), 5)
    print(f"{label}: b3x partition E={E} G={G} N={n} S={sh.S} P={sh.P}: count {count_ms:.3f} "
          f"ms, offsets + scatter {rows_ms - count_ms:.3f}, phase 2 {phase2_ms - fold_ms:.3f}, "
          f"fill + fold {fold_ms:.3f}, in all {rows_ms + phase2_ms:.3f}", flush=True)


def sweep_extremes(n, gen, old=None):
    from vaex_tpu_torch.ops import grid_extreme as ge
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan
    m = 1_000_003
    ints = torch.randint(-(2 ** 62), 2 ** 62, (m,), generator=gen, device="cuda",
                         dtype=torch.int64)
    f64 = torch.randn(m, generator=gen, device="cuda", dtype=torch.float64)
    f64[::7] = float("nan")
    f64[1::11] = float("inf")
    f64[2::11] = float("-inf")
    f64[3::5] = 0.0
    f64[4::5] = -0.0
    f32 = torch.randn(m, generator=gen, device="cuda", dtype=torch.float32)
    valid = torch.rand(m, generator=gen, device="cuda") < 0.8
    summed = torch.randn(m, generator=gen, device="cuda", dtype=torch.float64)
    cols, modes = [ints, f64, f32, f64, ints], ["min", "max", "min", "min", "max"]
    valids = [None, None, None, valid, valid]
    checks = [(G, "uniform") for G in (1, 103, 10609, 67081, 1000003)]
    checks += [(1000003, kind) for kind in SKEWS]
    for G, kind in checks:
        if kind == "uniform":
            idx = torch.randint(-2, G + G // 8 + 1, (m,), generator=gen, device="cuda",
                                dtype=torch.int32)
        else:
            idx = skewed_keys(kind, gen, m, G)
        want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
        routes = {"planned": gp.extreme_direct_fits}
        if gp.extreme_direct_fits(G, len(cols)):
            routes["partition"] = lambda G, E: False
        for route, fits in routes.items():
            planned, gp.extreme_direct_fits = gp.extreme_direct_fits, fits
            got = gp.grid_partition_extreme(idx, cols, modes, valids, G)[0]
            shared = gp.grid_partition_extreme(idx, cols, modes, valids, G, [ints], [summed],
                                               True)
            gp.extreme_direct_fits = planned
            sums = gp.grid_partition_reference(idx, [ints], [summed], G, True)
            torch.cuda.synchronize()
            parts = {"alone": same_by_value(got, want),
                     "beside sums": same_by_value(shared[0], want),
                     "int sums": torch.equal(shared[1], sums[0]),
                     "float sums": torch.allclose(shared[2], sums[1], rtol=1e-9, atol=1e-9)}
            bad = [name for name, ok in parts.items() if not ok]
            print(f"check G={G} {kind} keys b3x {route}: "
                  f"{'MISMATCH in ' + ', '.join(bad) if bad else 'ok'}", flush=True)
            if bad:
                return 1
        ok = same_by_value(gp.grid_resident_extreme(idx, cols, modes, valids, G), want)
        print(f"check G={G} {kind} keys b3x-l2: {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            return 1
    del ints, f64, f32, valid, summed, cols
    # the resident route against the partition, in turns, across G (G =
    # 24 577: past the direct route at E = 1) and E, up to the resident
    # budget and past it
    for E in (1, 2, 4):
        cols, modes, valids = extreme_inputs(n, E, gen)
        for G in (6145, 24577, 32768, 131072, 1000003, 1054729,
                  gp.RESIDENT_BYTES // (8 * E), gp.RESIDENT_BYTES // (8 * E) + 1, 4012009,
                  2 ** 23, 2 ** 24):
            if gp.extreme_direct_fits(G, E):
                continue
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            args = (idx, cols, modes, valids, G)
            row = {}
            for turn in range(2):
                row[f"b3x-l2.{turn}"] = cuda_ms(lambda: gp.grid_resident_extreme(*args))
                row[f"b3x.{turn}"] = cuda_ms(lambda: forced_partition(gp)(*args))
                if old is not None:
                    row[f"b3x baseline.{turn}"] = cuda_ms(
                        lambda: old.grid_partition_extreme(*args))
            if E == 1 and G in (131072, 1054729):
                row["scatter_reduce_"] = cuda_ms(lambda: ge.grid_extreme_batch(*args), 1)
            print(f"extremes resident E={E} G={G} N={n} ({E * G * 8 / 2 ** 20:.2f} MiB of keys, "
                  f"planned {grid_plan.extreme_strategy(n, G, E)}): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
        del cols
    # the direct route against the resident one where both take the grid
    for E in (1, 2, 4):
        cols, modes, valids = extreme_inputs(n, E, gen)
        for G in (1024, 4096, 6144, 8192, 10609, 16384, 24576):
            if not gp.extreme_direct_fits(G, E):
                continue
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            args = (idx, cols, modes, valids, G)
            row = {}
            for turn in range(2):
                row[f"b3x-direct.{turn}"] = cuda_ms(lambda: gp.grid_partition_extreme(*args))
                row[f"b3x-l2.{turn}"] = cuda_ms(lambda: gp.grid_resident_extreme(*args))
            print(f"extremes direct E={E} G={G} N={n} ({E * G * 8 / 1024:.1f} KiB of keys, "
                  f"planned {grid_plan.extreme_strategy(n, G, E)}): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
        del cols
    # keys that pile on few bins: the 2-D max's G and q7's
    for E, G in ((1, 1054729), (2, 1000003)):
        cols, modes, valids = extreme_inputs(n, E, gen)
        for kind in ("uniform", *SKEWS):
            idx = keys(kind, n, G, gen)
            args = (idx, cols, modes, valids, G)
            row = {}
            for turn in range(2):
                row[f"b3x-l2.{turn}"] = cuda_ms(lambda: gp.grid_resident_extreme(*args))
            row["b3x"] = cuda_ms(lambda: forced_partition(gp)(*args))
            if old is not None:
                row["b3x baseline"] = cuda_ms(lambda: old.grid_partition_extreme(*args), 1)
            print(f"extremes E={E} G={G} N={n} {kind} keys: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
        del cols
    # the partition route's phases at E = 1, 2 and 4: where its cost per
    # column grows faster than the columns
    for G in (1000003, 4012009):
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for E in (1, 2, 4):
            cols, modes, _ = extreme_inputs(n, E, gen)
            extreme_phases(gp, idx, cols, modes, G, "phases")
            del cols
        del idx
    # sums beside the extremes: one shared scatter against the sums on the
    # plan's route and the extremes on the resident route apart
    for G in (10609, 32768, 67081, 131072, 1000003):
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for E in (1, 2):
            cols, modes, valids = extreme_inputs(n, E, gen)
            sums_name = grid_plan.strategy(n, G, 0, 1, True)
            row = {}
            for turn in range(2):
                row[f"b3 + b3x shared.{turn}"] = cuda_ms(lambda: gp.grid_partition_extreme(
                    idx, cols, modes, valids, G, [], cols[:1], True))

                def apart():
                    grid_plan.grid_sums(idx, [], cols[:1], G, True)
                    gp.grid_resident_extreme(idx, cols, modes, valids, G)
                row[f"{sums_name} + b3x-l2 apart.{turn}"] = cuda_ms(apart)
                if old is not None:
                    row[f"shared, baseline.{turn}"] = cuda_ms(lambda: old.grid_partition_extreme(
                        idx, cols, modes, valids, G, [], cols[:1], True))
            print(f"extremes E={E} beside count + f64 sum G={G} N={n}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del cols
        del idx
    # the bucket width of a call without sums, and how many columns a call
    # should take: E columns in one call against E / 2 in each of two
    planned = gp.extreme_direct_fits, gp.EXT_GRID_BYTES
    gp.extreme_direct_fits = lambda G, E: False
    for G in (1000003, 4012009):
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for E in (1, 2, 4):
            cols, modes, valids = extreme_inputs(n, E, gen)
            row = {}
            for kib in (32, 64, 128):
                gp.EXT_GRID_BYTES = kib << 10
                row[f"{kib}K S={gp.extreme_shape(n, G, E).S}"] = cuda_ms(
                    lambda: gp.grid_partition_extreme(idx, cols, modes, valids, G))
            print(f"extremes widths E={E} G={G} N={n}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del cols
        del idx
    gp.extreme_direct_fits, gp.EXT_GRID_BYTES = planned
    # every route as the plan takes it, across G
    for E in (1, 2, 4):
        cols, modes, valids = extreme_inputs(n, E, gen)
        for G in EXTREME_GS:
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            name = grid_plan.extreme_strategy(n, G, E)
            row = {name: cuda_ms(lambda: grid_plan.grid_extremes(idx, cols, modes, valids, G))}
            if G > 1:  # at G = 1 it is 1e8 atomics on one address: minutes
                row["scatter_reduce_"] = cuda_ms(
                    lambda: ge.grid_extreme_batch(idx, cols, modes, valids, G), 1)
            print(f"extremes E={E} G={G} N={n}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
        del cols
    return 0


def sass_ops(path, prefixes):
    """{kernel: {opcode: count}} of the instructions whose opcode starts with
    one of ``prefixes`` in the SASS of the library at ``path``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True).stdout
    found, kernel = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            continue
        for token in line.replace(";", " ").split():
            if token.startswith(prefixes):
                ops = found.setdefault(kernel, {})
                ops[token] = ops.get(token, 0) + 1
    return found


def print_sass(label, path, prefixes):
    found = sass_ops(path, prefixes)
    for kernel, ops in found.items():
        print(f"sass {label} {kernel}: " + ", ".join(f"{op} x{c}" for op, c in sorted(ops.items())),
              flush=True)
    if not found:
        print(f"sass {label}: no instruction starting with {', '.join(prefixes)}", flush=True)


# the shapes the query paths send to B2, and G = 32 768 at C = 3
B2_SHAPES = ((10609, 2, "q2 shape: count + int64 1..5"), (10609, 3, "count + int64 + f64"),
             (32768, 3, "count + int64 + f64"), (67081, 1, "2-D count, shape 256"),
             (10609, 1, "count(binby=[id4, id5]), the count beside B5"),
             (2003, 2, "set grouper of 2000 keys: count + int64"),
             (1027, 1, "limits 99.7%: the percentile's histogram"))


def b2_columns(n, C, gen, small):
    """C - 1 value columns beside the count: int64 (1..5 when ``small``,
    else +-2^62) and, from C = 3 on, one f64 column last."""
    n_float = 1 if C >= 3 else 0
    high = (6, 1) if small else (2 ** 62, -(2 ** 62))
    ints = [torch.randint(high[1], high[0], (n,), generator=gen, device="cuda",
                          dtype=torch.int64) for _ in range(C - 1 - n_float)]
    floats = [torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100
              for _ in range(n_float)]
    return ints, floats


def sweep_b2(n, gen, old):
    """``--b2``: B2's cluster sizes against the baseline and B3."""
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build
    print_sass("b2", kernel_build.build("grid_window")["grid_window"][0], ("ATOM", "RED"))
    if old is not None:
        print_sass("b2 baseline", old.kernel_build.build("grid_window")["grid_window"][0],
                   ("ATOM", "RED"))
    bad = 0
    m = 1_000_003
    for C in (1, 2, 3, 4):
        ints, floats = b2_columns(m, C, gen, small=False)
        if floats:
            floats[0][::13] = float("nan")
        W = gw.cluster_width(C, True)
        for G in (129, 10609, W, W + 1, 3 * W + 1, gw.MAX_CLUSTER * W):
            idx = torch.randint(-3, G + G // 8, (m,), generator=gen, device="cuda",
                                dtype=torch.int32)
            want = ga.grid_additive_reference(idx, ints, floats, G, True)
            ok = close(gw.grid_window(idx, ints, floats, G, True), want)
            bad += not ok
            print(f"check b2 C={C} G={G}: {'ok' if ok else 'MISMATCH'}", flush=True)
    if bad:
        return 1
    for C in (1, 2, 3, 4):
        ints, floats = b2_columns(n, C, gen, small=False)
        W = gw.cluster_width(C, True)
        for k in range(1, gw.MAX_CLUSTER + 1):
            G = k * W
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            Wk, n_win = gw.cluster_window(G, C, True)
            row = {"b2": cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))}
            if old is not None:
                row["b2 baseline"] = cuda_ms(lambda: old.grid_window(idx, ints, floats, G, True))
            row["b2 again"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
            if G >= 4096:
                if gp.shape(n, G, C) is not None:
                    row["b3"] = cuda_ms(lambda: gp.grid_partition(idx, ints, floats, G, True))
                row["b3-l2"] = cuda_ms(lambda: gp.grid_resident(idx, ints, floats, G, True))
            row["library"] = library_additive_ms(idx, ints, floats, G, 1)
            clusters = gw.max_clusters(idx.device.index, n_win, gw.window_bytes(Wk, C, True))
            print(f"b2 C={C} G={G} N={n} windows={n_win} W={Wk} clusters={clusters}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
        del ints, floats
    for G, C, what in B2_SHAPES:
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for small in (True, False):
            if C < 2 and not small:
                continue
            ints, floats = b2_columns(n, C, gen, small)
            row = {}
            for turn in range(2):
                row[f"b2.{turn}"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
                if old is not None:
                    row[f"baseline.{turn}"] = cuda_ms(
                        lambda: old.grid_window(idx, ints, floats, G, True))
            print(f"b2 shape G={G} C={C} ({what}; {'small' if small else 'large'} ints) N={n} "
                  f"windows={gw.cluster_windows(G, C, True)}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del ints, floats
        del idx
    return 0


# B1's shapes: (G, int64 columns, f64 columns, what); the count is always on
B1_SHAPES = ((103, 0, 1, "main path: count + f64"), (1, 0, 0, "the isin count"),
             (1, 0, 1, "df.sum: count + f64"), (103, 1, 1, "phase 3: count + int64 + f64"),
             (1, 1, 1, "phase 3 at G = 1"), (512, 1, 1, "phase 3 at G = 512"),
             (8064, 1, 1, "phase 3 at the widest G"), (103, 0, 0, "count by id4"),
             (103, 1, 0, "count + int64"))
B1_GS = (1, 8, 32, 64, 72, 96, 103, 128)
# (int64 columns beside the count and one f64, G): the narrowest grids on
# which B1 takes its warp route, and a few bins past them: the plan gives
# such grids to B2
B1_WARP_EDGES = ((4, 42), (4, 48), (7, 27), (7, 32), (11, 19), (11, 24), (15, 14), (15, 16),
                 (30, 8), (30, 16))


def sweep_b1(n, gen, old):
    """``--b1``: B1's two routes against the baseline's B1 and against B2,
    the source of ``LANE_MIN_WARPS`` and ``B1_MAX_G``."""
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build
    print_sass("b1", kernel_build.build("grid_additive")["grid_additive"][0], ("ATOM", "RED"))
    m = 1_000_003
    planned = ga.route
    bad = 0
    for G in (1, 103, 128, 512):
        for n_int, n_float in ((0, 0), (0, 1), (1, 1), (2, 1)):
            for how in (ga.LANE, ga.WARP):
                if how == ga.LANE and lane_too_wide(ga, G, n_int, n_float):
                    continue
                for off in (0, 1):  # a call whose first row is at an odd offset
                    idx = torch.randint(-2, G + G // 8 + 1, (m + 1,), generator=gen,
                                        device="cuda", dtype=torch.int32)[off:]
                    ints = [torch.randint(-(2 ** 63), 2 ** 63 - 1, (m + 1,), generator=gen,
                                          device="cuda")[off:] for _ in range(n_int)]
                    floats = [torch.randn(m + 1, generator=gen, device="cuda",
                                          dtype=torch.float64 if k == 0 else torch.float32)[off:]
                              for k in range(n_float)]
                    for f in floats:
                        f[::13] = float("nan")
                    ga.route = lambda *a, how=how: how
                    got = ga.grid_additive(idx, ints, floats, G, True)
                    again = ga.grid_additive(idx, ints, floats, G, True)
                    ga.route = planned
                    want = ga.grid_additive_reference(idx, ints, floats, G, True)
                    ok = close(got, want) and torch.equal(got[1], again[1])
                    bad += not ok
                    print(f"check b1 {how} G={G} ints={n_int} floats={n_float} offset={off}: "
                          f"{'ok, floats bit-equal run to run' if ok else 'MISMATCH'}", flush=True)
    if bad:
        return 1
    x = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100
    v = torch.randint(1, 6, (n,), generator=gen, device="cuda")
    for G in B1_GS + (256,):
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for n_int, n_float in ((0, 0), (0, 1), (1, 1), (2, 1), (4, 1)):
            ints, floats = [v] * n_int, [x] * n_float
            row = {}
            for turn in range(2):
                for how in (ga.LANE, ga.WARP):
                    if how == ga.LANE and lane_too_wide(ga, G, n_int, n_float):
                        continue
                    if how == ga.WARP and not ga.fits(G, n_int, n_float, True):
                        continue
                    ga.route = lambda *a, how=how: how
                    row[f"{how}.{turn}"] = cuda_ms(
                        lambda: ga.grid_additive(idx, ints, floats, G, True))
                    ga.route = planned
                if old is not None and ga.fits(G, n_int, n_float, True):
                    row[f"baseline.{turn}"] = cuda_ms(
                        lambda: old.grid_additive(idx, ints, floats, G, True))
            row["b2"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
            C = 1 + n_int + n_float
            print(f"b1 G={G} C={C} (count + {n_int} int64 + {n_float} f64) N={n} planned "
                  f"{planned(G, n_int, n_float, True)} lane warps "
                  f"{ga.CLUSTER_SMEM // ga.lane_warp_bytes(G, n_int, n_float, True)}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
        del idx
    for n_int, G in B1_WARP_EDGES:
        idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
        ints, floats = [v] * n_int, [x]
        row = {}
        for turn in range(2):
            row[f"warp.{turn}"] = cuda_ms(lambda: ga.grid_additive(idx, ints, floats, G, True))
            row[f"b2.{turn}"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
        print(f"b1 warp edge G={G} C={n_int + 2} (count + {n_int} int64 + 1 f64) N={n} planned "
              f"{planned(G, n_int, 1, True)}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
        del idx
    for G, n_int, n_float, what in B1_SHAPES:
        idx = torch.randint(0, G + 3, (n,), generator=gen, device="cuda", dtype=torch.int32)
        ints, floats = [v] * n_int, [x] * n_float
        row = {}
        for turn in range(2):
            row[f"b1.{turn}"] = cuda_ms(lambda: ga.grid_additive(idx, ints, floats, G, True))
            if old is not None:
                row[f"baseline.{turn}"] = cuda_ms(
                    lambda: old.grid_additive(idx, ints, floats, G, True))
        print(f"b1 shape G={G} ({what}) N={n} route {planned(G, n_int, n_float, True)}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
        del idx
    return 0


def lane_too_wide(ga, G, n_int, n_float):
    """True where no warp of lane grids fits one CTA."""
    return ga.lane_warp_bytes(G, n_int, n_float, True) > ga.CLUSTER_SMEM


def load_baseline(path):
    """The kernel modules of another checkout of this repository
    (``--baseline DIR``), loaded beside this one to time the two in turns:
    its ``grid_partition`` (with ``grid_window``, ``grid_additive``, the
    module ``grid_moments``, ``probe`` and ``kernel_build`` as
    attributes)."""
    own = {k: sys.modules.pop(k) for k in list(sys.modules) if k.startswith("vaex_tpu_torch")}
    sys.path.insert(0, path)
    try:
        import vaex_tpu_torch.ops.grid_additive as old_additive
        import vaex_tpu_torch.ops.grid_moments as old_moments
        import vaex_tpu_torch.ops.grid_partition as old
        import vaex_tpu_torch.ops.grid_window as old_window
        import vaex_tpu_torch.ops.kernel_build as old_build
        import vaex_tpu_torch.ops.probe as old_probe
    finally:
        sys.path.remove(path)
        for k in [k for k in sys.modules if k.startswith("vaex_tpu_torch")]:
            del sys.modules[k]
        sys.modules.update(own)
    old.grid_window, old.probe, old.kernel_build = (old_window.grid_window, old_probe,
                                                    old_build)
    old.grid_additive, old.grid_moments = old_additive.grid_additive, old_moments
    return old


def close(got, want):
    return torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1], rtol=1e-9,
                                                           atol=1e-9)


def keys(kind, n, G, gen):
    """idx [n] int32 over [0, G): uniform, or chip_smoke's skewed draws."""
    if kind == "uniform":
        return torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
    return skewed_keys(kind, gen, n, G, drop_every=0)


def main():
    if not torch.cuda.is_available():
        print("sweep_grid_kernels: no CUDA device", file=sys.stderr)
        return 1
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build
    moments = "--moments" in sys.argv
    extremes = "--extremes" in sys.argv
    b1 = "--b1" in sys.argv
    b2 = "--b2" in sys.argv
    args = [a for a in sys.argv[1:] if a not in ("--moments", "--extremes", "--b1", "--b2")]
    old = None
    if "--baseline" in args:
        at = args.index("--baseline")
        old = load_baseline(os.path.abspath(args[at + 1]))
        del args[at:at + 2]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = (("grid_moments", "grid_moments_window", "grid_partition") if moments else
               ("grid_partition",) if extremes else
               ("grid_additive", "grid_window") if b1 else
               ("grid_window", "grid_partition") if b2 else
               ("grid_additive", "grid_window", "grid_partition"))
    for name, (path, seconds, log) in kernel_build.build(*sources).items():
        print(f"built {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}")
    n = int(float(args[0])) if args else 100_000_000
    gen = torch.Generator(device="cuda").manual_seed(42)
    if moments:
        return sweep_moments(n, gen, old)
    if extremes:
        return sweep_extremes(n, gen, old)
    if b1:
        return sweep_b1(n, gen, old)
    if b2:
        return sweep_b2(n, gen, old)
    bad = 0
    m = 1_000_003
    ints, floats = columns(m, 3, gen)
    floats[0][::13] = float("nan")
    floats.append(torch.randn(m, generator=gen, device="cuda", dtype=torch.float32))
    for G in (8182, 10609, 100003, 1000003, 4000037):  # correctness, small N
        for kind in ("uniform", *SKEWS):
            idx = keys(kind, m, G + G // 8 + 1, gen)
            idx[::17] = -1
            want = ga.grid_additive_reference(idx, ints, floats, G, True)
            for kern in ((ga.grid_additive,) if ga.fits(G, 1, 2, True) else ()) + (
                    gw.grid_window, gp.grid_partition, gp.grid_resident):
                if kern is gw.grid_window and not gw.fits(G, 4, True):
                    continue
                got = kern(idx, ints, floats, G, True)
                torch.cuda.synchronize()
                ok = close(got, want)
                bad += not ok
                print(f"check G={G} {kind} {kern.__name__}: {'ok' if ok else 'MISMATCH'}",
                      flush=True)
    for rows in (0, 1, 31, 4097):
        idx = torch.randint(-1, 70_000, (rows,), generator=gen, device="cuda", dtype=torch.int32)
        cols = [ints[0][:rows].contiguous()], [floats[0][:rows].contiguous()]
        want = ga.grid_additive_reference(idx, *cols, 67_081, True)
        for kern in (gp.grid_partition, gp.grid_resident):
            ok = close(kern(idx, *cols, 67_081, True), want)
            bad += not ok
            print(f"check N={rows} {kern.__name__}: {'ok' if ok else 'MISMATCH'}", flush=True)
    if bad:
        return 1
    del ints, floats
    for C in (2, 3, 4):
        ints, floats = columns(n, C, gen)
        for G in GS:
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            row = {}
            if ga.fits(G, len(ints), len(floats), True):
                planned = ga.unroll
                for u in (1, 4):
                    ga.unroll = lambda C: u
                    row[f"b1u{u}"] = cuda_ms(
                        lambda: ga.grid_additive(idx, ints, floats, G, True))
                ga.unroll = planned
            if gw.fits(G, C, True):
                row["b2"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
            if G >= 4096:
                for sub in SUB_GRIDS:
                    planned, gp.SUB_GRID_BYTES = gp.SUB_GRID_BYTES, sub << 10
                    if gp.shape(n, G, C) is not None:
                        row[f"b3 {sub}K S={gp.shape(n, G, C).S}"] = cuda_ms(
                            lambda: gp.grid_partition(idx, ints, floats, G, True))
                    gp.SUB_GRID_BYTES = planned
                row["b3-l2"] = cuda_ms(lambda: gp.grid_resident(idx, ints, floats, G, True))
                if old is not None and old.shape(n, G, C) is not None:
                    row["b3 baseline"] = cuda_ms(
                        lambda: old.grid_partition(idx, ints, floats, G, True))
                row["library"] = library_additive_ms(idx, ints, floats, G)
            if G in (10609, 1000003):
                row["plain"] = cuda_ms(
                    lambda: ga.grid_additive_reference(idx, ints, floats, G, True), 1)
            print(f"C={C} G={G} N={n} windows={gw.cluster_windows(G, C, True)}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            if C == 3 and G in (67081, 1000003, 16000057):
                partition_phases(idx, ints, floats, G, "phases")
            del idx
        if C != 3:
            continue
        # the partition's launch constants: threads of a scatter CTA (a tile
        # is 8 rows a thread) and waves of phase-2 CTAs
        planned = gp.SCATTER_THREADS, gp.SUMS_WAVES
        for G, kind in ((1_000_003, "uniform"), (1_000_003, "zipf"), (4_000_037, "uniform")):
            idx = keys(kind, n, G, gen)
            for threads, waves in ((1024, 2), (512, 2), (1024, 1), (1024, 4)):
                gp.SCATTER_THREADS, gp.SUMS_WAVES = threads, waves
                partition_phases(idx, ints, floats, G, f"{kind} keys, scatter threads {threads}, "
                                                       f"phase-2 waves {waves}")
            del idx
        gp.SCATTER_THREADS, gp.SUMS_WAVES = planned
        G = 1_000_003
        for kind in SKEWS:
            idx = keys(kind, n, G, gen)
            row = {"b3": cuda_ms(lambda: gp.grid_partition(idx, ints, floats, G, True)),
                   "b3-l2": cuda_ms(lambda: gp.grid_resident(idx, ints, floats, G, True))}
            if old is not None:
                row["b3 baseline"] = cuda_ms(
                    lambda: old.grid_partition(idx, ints, floats, G, True), 1)
            row["library"] = library_additive_ms(idx, ints, floats, G, 1)
            print(f"C={C} G={G} N={n} {kind} keys: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            partition_phases(idx, ints, floats, G, f"phases, {kind} keys")
            del idx
    return 0


if __name__ == "__main__":
    sys.exit(main())

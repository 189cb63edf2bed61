#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vaex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds the seven kernels (five grid kernels, the min/max mode B3x that
   shares grid_partition.cu with B3, and the set probe) from
   vaex_tpu_torch/csrc with nvcc, one nvcc per source, all at once;
3. holds B1 (grid_additive) against its plain PyTorch version on the card,
   at G in {1, 103, 512, largest that fits} and N in {0, 1, 1_000_003, 1e8}:
   int64 values from +-2^62 (sums wrap) and the count exact, float64 from
   N(0, 100) to rtol 1e-9 and atol 1e-9; then both of its routes (the
   lane-private grids and the warp-private ones) at the lane route's edges,
   G in {1, 2, 103, 128} with the count alone, f64, f32 with NaN, int64 +
   f64 and two int64 + f64, columns starting at row 0 and at an odd row,
   the planned route asserted;
4. holds the wide-grid kernels B2 (grid_window) and B3 (grid_partition:
   its partition route b3 and its resident route b3-l2) against their
   plain versions the same way, with some NaN among the floats, at G in
   {B1 limit + 1, 10 609, B2 limit, B2 limit + 1, 100 003, 1 000 003,
   4 000 037} through the kernel the plan picks (printed) and, past B2's
   limit, through both routes of B3, plus both routes on pre-sorted keys,
   on one key and on a Zipf(1.1) draw at G = 1 000 003; then B2 at the
   edges of its thread-block cluster, G = k * W and k * W + 1 for k = 1 ..
   8 windows of the widest window W, at C = 1 (count), 2 (+ int64), 3
   (+ f64 with NaN) and 4 (+ f32), N = 1_000_003 (past 8 windows the
   wrapper must refuse);
5. holds the moment kernels B4 (grid_moments) and B5 (grid_moments_window)
   against their plain versions, through the kernel the plan picks
   (printed), for the terms of var (an f64 column) and of corr (two f64
   columns), with NaN among both, at G in {1, 103, B4's limit at C = 6,
   that + 1, 10 609, B5's limit} and N in {0, 1, 1_000_003, 1e8}: counts
   exact, float sums to rtol 1e-9 and atol 1e-9; then B5 where its parts
   change (a term group or a window one bin past full) on columns starting
   at an odd row, and at G = 10 609 on f32 and int64 bases, on one key and
   on a Zipf(1.1) draw, its parts asserted; then B4's lane route at G = 1
   (also without an index), 103 and its last G for var and corr (both
   compiled sets) on f64, f32 and int64 bases starting at an odd row, the
   route asserted, floats bit-equal run to run;
6. drives the main path through the public API: a device-resident table
   of N = 1e8 and 4e8 rows (int64 key with K = 100 categories, float64
   value, made on the card from seed 42), categorize, then
   groupby(sum, count, sort=True) and df.sum, checked against
   torch.bincount / index_add_, with B1's launch count and its lane route
   asserted;
7. drives the wide-grid path through the public API: an H2O-groupby-shaped
   table of N = 1e8 rows made on the card from seed 42 (id4, id5 int64 in
   1..100, id6 int64 in 1..1e6, v1, v2 int64 in 1..5, v3 float64 in
   [0, 100)), the keys categorized, then q2 groupby(["id4", "id5"],
   {"v1": sum}, sort=True), count(binby=["id4", "id5"]), q3
   groupby("id6", {"v1": sum, "v3": mean}), q5 groupby("id6",
   {"v1", "v2", "v3": sum}) (both b3-l2: three channels of 1e6 bins stay in
   L2) and q5 with a count beside its sums (four channels: b3), each checked
   against torch.bincount / index_add_, with each kernel's launch count and
   the strategy each pass recorded, both asserted per query;
8. drives the statistics path through the public API on the same table:
   q6's sd part groupby(["id4", "id5"], {"sd_v3": std("v3", ddof=1)},
   sort=True), q9 groupby(["id4", "id5"], {"r2": corr("v1", "v2")}), q7
   groupby("id6", {"max_v1": max("v1"), "min_v2": min("v2")}),
   df.std("v3") and df.std("v3", binby=["id4"]), each checked against
   plain torch (index_add_ of the formed moments, then the same formula;
   scatter_reduce for q7), with B4's and B5's launch counts, the
   strategies, B4's lane route and B5's parts asserted per query (q6-sd one
   part, q9 three);
9. times the main-path groupby, the five wide queries and the five
   statistics against plain PyTorch (5 repetitions, medians), and every
   kernel against its plain version and against its HBM floor at the copy
   bandwidth measured in the same run (B1 also on its warp route and at
   the isin count's G = 1, B4 also at df.std's G = 1, without an index as
   df.std calls it, against torch.var_mean, B5 also at q6-sd's shape);
10. holds both routes of B6 (probe: a static search tree, wholly in
    shared memory on b6, its top levels there and the rest in global memory
    on b6-wide) against its plain version (searchsorted, gather, compare):
    int64 and float64 keys, M in {1, 15, 16, 17, 64, 500, 2048, MAX_KEYS,
    MAX_KEYS + 1, 50 000, b6's limit on 4-byte keys and that + 1,
    1 000 003} (an int set of 16 384 keys or more whose range is below
    2^32 on 4-byte keys, and the same sets spread past 2^32 on 8-byte
    keys), N in {0, 1, 1_000_003, 1e8}, rows that hit, miss, lie below the
    first and above the last key, and -0.0 and NaN among the floats; a set
    holding INT64_MIN and INT64_MAX, one holding +-inf, 0.0 and the largest
    float, and int sets spanning exactly 2^32 - 1 (4-byte keys) and 2^32
    (8-byte keys); exact, with the route and its launches asserted;
11. drives the set-based path through the public API on the H2O-shaped
    table WITHOUT categorize: df.count(selection=df.id6.isin(v)) and
    df[df.id6.isin(v)].groupby("id4", {"v1": sum, "v3": mean}) with v = 500
    ids drawn from seed 42, the same count with 50 000 ids (b6 on 4-byte
    keys), groupby over the raw id4 (dense
    grouper, B1) and
    the raw id6 (dense grouper, B3), groupby over k = id4 * 1_000_003 and
    k = (id6 % 2000) * 1_000_003 (set grouper: set build, then the ordinals
    through B6 at M = 100 and 2000, then B1 and B2) and k = id6 * 1_000_003
    (M = 1e6: b6-wide, then B3), df.id6.nunique() and df.id4.unique(),
    each checked against plain torch (isin, unique, bincount, index_add_),
    with B6's launch count and the probe route each pass recorded;
12. times those queries against plain PyTorch (the dense pre-pass included
    and, beside it, remembered), and B6 at the isin shapes (500 and 50 000
    ids: b6) and at the set grouper of k1e6 (b6-wide) against its plain
    version and torch.isin, on a tree built before the timing;
13. holds B3x (the min/max mode of the partitioned kernel: its direct and
    partition routes, grid_partition_extreme, and its resident route b3x-l2,
    grid_resident_extreme) against its plain version (scatter_reduce_ with a
    drop bin) at G in {1, 103, 10 609, 67 081, 1 000 003, 1 054 729} and N in
    {0, 1, 1_000_003, 1e8}: an int64 min, an f64 max with NaN, +-inf and
    -0.0, an f32 min, an f64 min and an int64 max under a validity mask, on
    each route and with count + int64 + f64 sums riding the same partition,
    and again at G = 1 000 003 on pre-sorted keys, on one key and on a
    Zipf(1.1) draw; extremes exact by value, int sums exact, float sums to
    rtol 1e-9;
14. drives the binned-statistics path through the public API: beside the
    H2O-shaped columns (id4 and id6 categorized) x, y float64 normal, v
    float64 uniform in [0, 100) with 1% NaN and t int64, made on the card
    from seed 42, 1e8 rows: limits(["x", "y"], "minmax"), limits("x",
    "99.7%"), count(binby=[x, y], shape=256), mean(v, binby=[x, y],
    shape=1024), max(v, binby=[x, y], shape=1024) (G = 1 054 729, b3x-l2)
    and shape=2000 (G = 4 012 009: 32 MB of keys, past L2: b3x), minmax(v,
    binby=x, shape=128) (b3x-direct), q7 on id6, groupby(id6, {sum v1, max
    v1, min v2}) (sums on b3-l2, extremes on b3x-l2), first(v, t, binby=id4)
    and first(v, t53, binby=id4) with int64 orders past 2^53 (compared as
    int64: the float64 answer differs), each checked against plain torch on
    the same tensors, with the route each pass recorded and each route of
    B3x launched; and first on a small card frame where a cell's only order
    is INT64_MAX;
15. times those queries against plain PyTorch, and each route of B3x at its
    query's shape against its plain version and scatter_reduce_: b3x-l2 at
    the 2-D max of shape 1024 and at q7's, b3x at the 2-D max of shape 2000,
    b3x-direct at minmax by x.

It exits non-zero on any failure.  The line before the last is a JSON
object with every kernel's (and each of B3x's routes') launches, error,
times, bound (the larger of the
bytes it must move over the card's published memory rate and its operations
over the published peak) and, where one exists, the time of the PyTorch
library call that computes the same function; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
K = 100
SEED = 42
MAIN_SIZES = (100_000_000, 400_000_000)
KERNEL_SIZES = (0, 1, 1_000_003, 100_000_000)
H2O_ROWS = 100_000_000
H2O_K = 100  # id4, id5 cardinality
H2O_K6 = H2O_ROWS // 100  # id6 cardinality
REPS = 5
RTOL = ATOL = 1e-9
ISIN_VALUES = 500
ISIN_WIDE_VALUES = 50_000  # past the probe's shared-memory kernel
WIDE_FACTOR = 1_000_003  # spreads a key's values over a range past 2^22
# set-grouper keys and their set sizes
SET_KEYS = {"k100": 100, "k2000": 2000, "k1e6": H2O_K6}
# NVIDIA's H100 SXM data sheet: HBM bytes/s; float32 operations/s outside the
# tensor cores.  Integer adds and compares are counted at the float32 rate,
# float64 operations at half of it.
# beside the keys every kernel has: the index_add_ alone for B4 and B5, B4
# at df.std's shape (G = 1) and B5 at q6-sd's (var, one window); for B1 the
# isin count's shape
# (G = 1, count alone) and the main path's shape on the warp route; for
# B6 torch.isin, its b6-wide route at the 1e6-key set grouper and b6 at the
# 50 000 ids; for B3 its resident route at the same shape and the
# partition's phases; for B3x's resident route q7's shape
EXTRA_KEYS = ("library_add_ms", "isin_ms", "wide_launches", "wide_ms", "wide_plain_ms",
              "wide_library_ms", "wide_isin_ms", "wide_bound_ms", "wide_max_abs_err",
              "l2_launches", "l2_ms", "l2_plain_ms", "l2_max_abs_err", "count_ms",
              "scatter_ms", "sums_ms", "q7_ms", "q7_plain_ms", "q7_library_ms",
              "q7_bound_ms", "isin_wide_ms", "var_ms", "var_plain_ms", "var_bound_ms",
              "var_library_ms", "var_max_abs_err", "g1_ms", "g1_plain_ms", "g1_bound_ms",
              "g1_library_ms", "g1_max_abs_err", "warp_ms")
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int": 67e12, "f64": 33.5e12}


def check(ok, message):
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_s(fn):
    """Median host-clock seconds of fn() ended by a synchronize, REPS runs."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def random_inputs(gen, n, G, nan=False):
    """idx with about 1/8 of the rows at idx >= G (they drop), int64 values
    from +-2^62 (sums wrap), float64 from N(0, 100)."""
    dev = torch.device("cuda")
    idx = torch.randint(0, G + G // 8 + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen, device=dev,
                         dtype=torch.int64)
    floats = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 100
    if nan:
        floats[::97] = float("nan")
    return idx, ints, floats


def same_sums(kernel, plain, idx, ints, floats, G, what):
    """Kernel against plain on one input; returns the float max abs error."""
    got_i, got_f = kernel(idx, [ints], [floats], G, count=True)
    want_i, want_f = plain(idx, [ints], [floats], G, count=True)
    torch.cuda.synchronize()
    check(torch.equal(got_i, want_i), f"int64 sums and count, {what}")
    check(torch.allclose(got_f, want_f, rtol=RTOL, atol=ATOL), f"f64 sums, {what}")
    return (got_f - want_f).abs().max().item() if idx.numel() else 0.0


def kernel_vs_plain(ga):
    """Phase 3; returns the largest G that fits and the worst float error."""
    g_max = ga.SMEM_BUDGET // (8 * 3) - ga.STAGE_ROWS  # count + one int + one float column
    check(ga.fits(g_max, 1, 1, True) and not ga.fits(g_max + 1, 1, 1, True), "G max")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for G in (1, 103, 512, g_max):
        for n in KERNEL_SIZES:
            err = same_sums(ga.grid_additive, ga.grid_additive_reference,
                            *random_inputs(gen, n, G), G, f"B1 G={G} N={n}")
            worst = max(worst, err)
            print(f"kernel vs plain G={G} N={n} ({ga.grid_additive.last_route} route): ints "
                  f"exact, f64 max abs err {err!r}", flush=True)
    return g_max, max(worst, route_edges_vs_plain(ga, gen))


def route_edges_vs_plain(ga, gen, n=1_000_003):
    """B1 at the edges of its two routes (G = 1: sums in registers; 2; the
    main path's 103; B1's last bin, 128; the count alone, f64, f32 with NaN,
    int64 + f64, two int64 + f64), on columns that start at row 0 and at an
    odd row of their storage; both routes where both fit, the planned one
    asserted.  Returns the worst float error."""
    worst = 0.0
    planned = ga.route
    for G in (1, 2, 103, 128):
        idx, ints, f64 = random_inputs(gen, n + 1, G, nan=True)
        f32 = torch.randn(n + 1, generator=gen, device="cuda", dtype=torch.float32)
        f32[::89] = float("nan")
        for name, int_cols, float_cols in (("count", [], []), ("count + f64", [], [f64]),
                                           ("count + f32", [], [f32]),
                                           ("count + int64 + f64", [ints], [f64]),
                                           ("count + 2 int64 + f64", [ints, ints], [f64])):
            for offset in (0, 1):
                args = (idx[offset:offset + n], [c[offset:offset + n] for c in int_cols],
                        [c[offset:offset + n] for c in float_cols], G)
                want = planned(G, len(int_cols), len(float_cols), True)
                for how in (ga.LANE, ga.WARP):
                    if how == ga.LANE and ga.lane_warp_bytes(
                            G, len(int_cols), len(float_cols), True) > ga.CLUSTER_SMEM:
                        continue
                    ga.route = lambda *a, how=how: how
                    try:
                        got_i, got_f = ga.grid_additive(*args, count=True)
                    finally:
                        ga.route = planned
                    want_i, want_f = ga.grid_additive_reference(*args, count=True)
                    torch.cuda.synchronize()
                    what = f"B1 {how} G={G} {name} offset {offset}"
                    check(torch.equal(got_i, want_i), f"ints and count, {what}")
                    check(torch.allclose(got_f, want_f, rtol=RTOL, atol=ATOL), f"floats, {what}")
                    err = (got_f - want_f).abs().max().item() if got_f.numel() else 0.0
                    worst = max(worst, err)
                    print(f"{what} N={n}{' (planned)' if how == want else ''} vs plain: ints "
                          f"exact, float max abs err {err!r}", flush=True)
                ga.grid_additive(*args, count=True)
                check(ga.grid_additive.last_route == want, f"B1's planned route at G={G}, {name}")
    return worst


def skewed_keys(kind, gen, n, G, drop_every=17):
    """idx [n] int32 over [0, G): ``sorted`` (uniform, ascending), ``single``
    (every row on one key) or ``zipf`` (rank k drawn with weight k^-1.1, the
    ranks spread over the grid by a permutation); every ``drop_every``-th row
    dropped."""
    if kind == "single":
        idx = torch.full((n,), G // 3, device="cuda", dtype=torch.int32)
    elif kind == "zipf":
        cdf = torch.cumsum(torch.arange(1, G + 1, device="cuda", dtype=torch.float64) ** -1.1, 0)
        u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp_(max=G - 1)
        idx = torch.randperm(G, generator=gen, device="cuda")[rank].to(torch.int32)
    else:
        idx = torch.sort(torch.randint(0, G, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)).values
    if drop_every:
        idx[::drop_every] = -1
    return idx


SKEWS = ("sorted", "single", "zipf")


def wide_kernels_vs_plain(plan, gw):
    """Phase 4: B2 and both routes of B3 against their plain versions;
    returns the worst float error of each."""
    C = 3  # count + one int + one float column
    b2_limit = plan.b2_max_windows(C) * gw.cluster_width(C, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {plan.B2: 0.0, plan.B3: 0.0, plan.B3_L2: 0.0}
    for G in (plan.B1_MAX_G + 1, 10_609, b2_limit, b2_limit + 1, 100_003, 1_000_003,
              4_000_037):
        name = plan.strategy(max(KERNEL_SIZES), G, 1, 1, True)
        print(f"plan at G={G} (count + int64 + f64): {name}", flush=True)
        check(name in worst, f"a wide kernel at G={G}")
        routes = (name,) if name == plan.B2 else (plan.B3, plan.B3_L2)
        for n in KERNEL_SIZES:
            inputs = random_inputs(gen, n, G, nan=True)
            for route in routes:
                err = same_sums(plan.KERNELS[route], plan.PLAIN[route], *inputs, G,
                                f"{route} G={G} N={n}")
                worst[route] = max(worst[route], err)
                print(f"{route} vs plain G={G} N={n}: ints exact, f64 max abs err {err!r}",
                      flush=True)
    G = 1_000_003
    check(plan.strategy(max(KERNEL_SIZES), G, 1, 1, True) == plan.B3_L2, "the plan at 1e6 bins")
    check(plan.strategy(max(KERNEL_SIZES), G, 2, 1, True) == plan.B3, "the plan past L2")
    _, ints, floats = random_inputs(gen, max(KERNEL_SIZES), G, nan=True)
    for kind in SKEWS:
        idx = skewed_keys(kind, gen, max(KERNEL_SIZES), G)
        for route in (plan.B3, plan.B3_L2):
            err = same_sums(plan.KERNELS[route], plan.PLAIN[route], idx, ints, floats, G,
                            f"{route} {kind} keys G={G}")
            worst[route] = max(worst[route], err)
            print(f"{route} vs plain on {kind} keys G={G} N={idx.numel()}: ints exact, no "
                  f"other path, f64 max abs err {err!r}", flush=True)
        del idx
    worst[plan.B2] = max(worst[plan.B2], cluster_edges_vs_plain(gw, gen))
    return worst


def cluster_edges_vs_plain(gw, gen, n=1_000_003):
    """B2 against its plain version at the edges of its cluster: G = k * W
    and k * W + 1 for k = 1 .. MAX_CLUSTER windows of the widest window W,
    at C = 1 (count), 2 (+ int64), 3 (+ f64 with NaN) and 4 (+ f32); one
    window past the cluster the wrapper refuses.  Returns the worst float
    error."""
    worst = 0.0
    for C in (1, 2, 3, 4):
        idx0, ints, floats = random_inputs(gen, n, 1, nan=True)
        ints, floats = [ints] if C >= 2 else [], [floats] if C >= 3 else []
        if C == 4:
            floats.append(torch.randn(n, generator=gen, device="cuda", dtype=torch.float32))
        W = gw.cluster_width(C, True)
        for k in range(1, gw.MAX_CLUSTER + 1):
            for G in (k * W, k * W + 1):
                idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                idx[:4] = torch.tensor([0, W - 1, W, G - 1], dtype=torch.int32)
                if not gw.fits(G, C, True):
                    try:
                        gw.grid_window(idx, ints, floats, G, True)
                    except ValueError:
                        print(f"b2 C={C} G={G}: past the cluster, refused", flush=True)
                        continue
                    check(False, f"b2 takes G={G} at C={C}, past its cluster")
                got_i, got_f = gw.grid_window(idx, ints, floats, G, True)
                want_i, want_f = gw.grid_window_reference(idx, ints, floats, G, True)
                torch.cuda.synchronize()
                what = f"b2 C={C} G={G} windows={gw.cluster_windows(G, C, True)}"
                check(torch.equal(got_i, want_i), f"int64 sums and count, {what}")
                check(torch.allclose(got_f, want_f, rtol=RTOL, atol=ATOL), f"floats, {what}")
                err = (got_f - want_f).abs().max().item() if got_f.numel() else 0.0
                worst = max(worst, err)
                print(f"{what} N={n} vs plain: ints exact, float max abs err {err!r}",
                      flush=True)
    return worst


# (kind, G) where B5's parts change: a group of terms one bin past what
# fits splits, one window one bin past a float plane of 227 KiB
B5_EDGES = (("var", 11_622), ("var", 11_623), ("var", 29_056), ("var", 29_057),
            ("corr", 5_282), ("corr", 5_283), ("corr", 9_686), ("corr", 19_370),
            ("corr", 19_371), ("corr", 29_056), ("corr", 29_057), ("corr", 60_000))


def window_edges_vs_plain(gm, agg, gen, n=1_000_003):
    """B5 where its parts change (B5_EDGES), on columns that start at an odd
    row of their storage; at q9's G = 10 609 on f32 and int64 bases, on one
    key and on a Zipf(1.1) draw; the parts asserted.  Returns the worst
    float error."""
    worst = 0.0
    cases = [(label, G, "uniform", 1, (torch.float64, torch.int64)) for label, G in B5_EDGES]
    cases += [(label, 10_609, keys, 0, dtypes) for label in ("var", "corr")
              for keys in ("single", "zipf")
              for dtypes in ((torch.float64, torch.int64), (torch.float32, torch.float32))]
    for label, G, keys, offset, dtypes in cases:
        terms = agg.VAR_TERMS if label == "var" else agg.CORR_TERMS
        if keys == "uniform":
            idx = torch.randint(-2, G + G // 8 + 1, (n + offset,), generator=gen, device="cuda",
                                dtype=torch.int32)[offset:]
        else:
            idx = skewed_keys(keys, gen, n, G)
        bases = []
        for j, dtype in enumerate(dtypes[:len(terms) // 3]):
            if dtype == torch.int64:
                b = torch.randint(-1000, 1000, (n + offset,), generator=gen, device="cuda")
            else:
                b = torch.randn(n + offset, generator=gen, device="cuda", dtype=dtype) * 100
                b[j::97 - 8 * j] = float("nan")
            bases.append(b[offset:])
        got = gm.grid_moments_window(idx, bases, terms, G)
        want = gm.grid_moments_window_reference(idx, bases, terms, G)
        torch.cuda.synchronize()
        W, n_win, bounds = gm.part_plan(G, len(terms))
        what = (f"b5 {label} G={G} {keys} keys, bases {[str(b.dtype) for b in bases]}, offset "
                f"{offset}, {n_win} windows of {W} bins x term groups {bounds}")
        check(gm.grid_moments_window.last_parts == n_win * (len(bounds) - 1), f"parts, {what}")
        check(torch.equal(got[0], want[0]), f"counts, {what}")
        check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"sums, {what}")
        err = (got[1] - want[1]).abs().max().item()
        worst = max(worst, err)
        print(f"{what} N={n} vs plain: counts exact, f64 max abs err {err!r}", flush=True)
    return worst


def moment_kernels_vs_plain(plan, gm, agg):
    """Phase 5: B4 and B5 against their plain versions; returns the worst
    float error of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {plan.B4: 0.0, plan.B5: 0.0}
    b4_limit = plan.b4_max_g(6)
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        C = len(terms)
        b5_limit = max(G for G in range(b4_limit + 1, 400_000, 97)
                       if gm.n_parts(G, C) <= plan.B5_MAX_PARTS)
        for G in (1, 103, b4_limit, b4_limit + 1, 10_609, b5_limit):
            name = plan.moment_strategy(max(KERNEL_SIZES), G, C, 1,
                                        gm.compiled(len(terms) // 3, terms))
            print(f"plan at G={G} ({label}, {C} terms): {name}", flush=True)
            check(name in (plan.B4, plan.B5), f"a moment kernel at G={G}")
            for n in KERNEL_SIZES:
                idx = torch.randint(0, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                x, y = (torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
                        for _ in range(2))
                x[::97] = float("nan")
                y[::89] = float("nan")
                bases = [x] if label == "var" else [x, y]
                got = plan.MOMENT_KERNELS[name](idx, bases, terms, G)
                want = plan.MOMENT_PLAIN[name](idx, bases, terms, G)
                torch.cuda.synchronize()
                what = f"{name} {label} G={G} N={n}"
                check(torch.equal(got[0], want[0]), f"counts, {what}")
                check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"sums, {what}")
                err = (got[1] - want[1]).abs().max().item() if n else 0.0
                worst[name] = max(worst[name], err)
                print(f"{what} vs plain: counts exact, f64 max abs err {err!r}", flush=True)
                del idx, x, y, bases
    worst[plan.B5] = max(worst[plan.B5], window_edges_vs_plain(gm, agg, gen))
    worst[plan.B4] = max(worst[plan.B4], b4_routes_vs_plain(gm, agg, gen))
    return worst


def b4_routes_vs_plain(gm, agg, gen, n=1_000_003):
    """B4's lane route at G = 1 (terms held in registers), 103 (three warps
    of lane grids a CTA for var) and the last G where LANE_MIN_WARPS warps
    fit, on f64, f32 and int64 bases with NaN among the floats, on columns
    that start at an odd row; the route asserted and the floats bit-equal
    run to run.  Returns the worst float error."""
    worst = 0.0
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        n_float = sum(a >= 0 for a, *_ in terms)
        compiled = gm.compiled(len(terms) // 3, terms)
        warps = gm.LANE_MIN_WARPS[compiled]
        edge = gm.CLUSTER_SMEM // (warps * gm.lane_warp_bytes(1, 1, n_float))
        for G in (1, 103, edge):
            if not gm.route(G, 1, n_float, compiled) == gm.LANE:
                continue
            for dtype in (torch.float64, torch.float32, torch.int64):
                idx = torch.randint(-2, G + G // 8 + 1, (n + 1,), generator=gen, device="cuda",
                                    dtype=torch.int32)[1:]
                bases = []
                for j in range(len(terms) // 3):
                    if dtype == torch.int64:
                        b = torch.randint(-1000, 1000, (n + 1,), generator=gen, device="cuda")
                    else:
                        b = torch.randn(n + 1, generator=gen, device="cuda", dtype=dtype) * 100
                        b[j::97 - 8 * j] = float("nan")
                    bases.append(b[1:])
                # at G = 1 also without an index (every row in bin 0), as
                # a statistic without binby or selection calls it
                for rows in (idx, None) if G == 1 else (idx,):
                    got = gm.grid_moments(rows, bases, terms, G)
                    check(gm.grid_moments.last_route == gm.LANE, f"B4's lane route at G={G}")
                    again = gm.grid_moments(rows, bases, terms, G)
                    want = gm.grid_moments_reference(rows, bases, terms, G)
                    torch.cuda.synchronize()
                    what = (f"b4 lane route {label} G={G} {dtype} bases at an odd row"
                            f"{', no idx' if rows is None else ''}")
                    check(torch.equal(got[0], want[0]), f"counts, {what}")
                    check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"sums, {what}")
                    check(torch.equal(got[1], again[1]), f"floats bit-equal run to run, {what}")
                    err = (got[1] - want[1]).abs().max().item()
                    worst = max(worst, err)
                    print(f"{what} N={n} vs plain: counts exact, floats bit-equal run to run, "
                          f"f64 max abs err {err!r}", flush=True)
    return worst


def make_table(n, vt):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i1 = torch.randint(0, K, (n,), generator=gen, device="cuda", dtype=torch.int64)
    x = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    df = vt.from_dataset(vt.DatasetArrays({"i1": i1, "x": x}))
    return df.categorize("i1", labels=range(K)), i1, x


def run_query(df, vt):
    return df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)


def plain_query(i1, x):
    counts = torch.bincount(i1, minlength=K)
    sums = torch.zeros(K, dtype=torch.float64, device=i1.device).index_add_(0, i1, x)
    return counts, sums


def main_path(n, vt):
    """Phase 6 at one size: the query through the public API, checked."""
    from vaex_tpu_torch.ops import grid_additive as ga
    df, i1, x = make_table(n, vt)
    out = run_query(df, vt)
    torch.cuda.synchronize()
    routes = [(df.executor.trace_log[-1]["strategies"], ga.grid_additive.last_route)]
    want_c, want_s = plain_query(i1, x)
    got_c = torch.as_tensor(out["c"].tolist())
    got_s = torch.as_tensor(out["s"].tolist(), dtype=torch.float64)
    check(out.get_column_names() == ["i1", "s", "c"], f"columns {out.get_column_names()}")
    check(out["i1"].tolist() == list(range(K)), "group keys")
    check(torch.equal(got_c, want_c.cpu()), f"counts equal bincount at N={n}")
    check(int(got_c.sum()) == n, f"counts total N={n}")
    check(torch.allclose(got_s, want_s.cpu(), rtol=RTOL, atol=ATOL), f"sums at N={n}")
    total = float(df.sum("x"))
    check(abs(total - x.sum().item()) <= RTOL * abs(total), f"df.sum at N={n}")
    log = df.executor.trace_log[-1]
    routes.append((log["strategies"], ga.grid_additive.last_route))
    # the groupby (G = 103) and df.sum (G = 1) on B1's lane route
    check(routes == [([{"additive": "b1"}], ga.LANE)] * 2, f"B1's routes at N={n}: {routes}")
    print(f"main path N={n}: counts exact, sums and df.sum within rtol {RTOL}; "
          f"last pass: {log['tiles']} tiles of {log['tile_rows']} rows on {log['device']}, "
          f"strategies {log['strategies']}", flush=True)
    return df, i1, x


def copy_bandwidth(x):
    """Bytes/s of a device-to-device copy of x (read + write)."""
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), 10)
    return 2 * x.numel() * x.element_size() / (copy_ms * 1e-3), copy_ms


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` (every input read once, every output written once) over
    PEAK_BYTES and the operations ``ops`` ({kind: count}) over PEAK_OPS."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = sum(count / PEAK_OPS[kind] for kind, count in ops.items()) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def additive_bound(n, G, n_int, n_float, count=True):
    """The bound of one additive grid call: int32 idx and 8-byte columns in,
    [C, G] 8-byte sums out; one add per row and column."""
    C = int(count) + n_int + n_float
    return bound(n * (4 + 8 * (n_int + n_float)) + 8 * C * G,
                 {"int": n * (int(count) + n_int), "f64": n * n_float})


def library_additive_ms(idx, int_cols, float_cols, G, reps=2):
    """The PyTorch library calls for an additive grid call: ``bincount`` for
    the count and one ``index_add_`` per column (idx within [0, G))."""
    idx = idx.to(torch.int64)

    def run():
        torch.bincount(idx, minlength=G)
        for col in (*int_cols, *float_cols):
            torch.zeros(G, dtype=col.dtype, device=col.device).index_add_(0, idx, col)
    return cuda_ms(run, reps)


def timings(n, df, i1, x, vt, ga, label):
    """Phase 9 at one main-path size: end-to-end query and B1 times, in turns."""
    port_s, plain_s = [], []
    for _ in range(REPS):
        for fn, times in ((lambda: plain_query(i1, x), plain_s),
                          (lambda: run_query(df, vt), port_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    idx = (i1 + 2).to(torch.int32)  # the main path's bin layout, G = K + 3
    G = K + 3
    kernel_ms = cuda_ms(lambda: ga.grid_additive(idx, [], [x], G, count=True), 10)
    plain_ms = cuda_ms(lambda: ga.grid_additive_reference(idx, [], [x], G, count=True), 10)
    from vaex_tpu_torch.ops.binners import BinnerOrdinal
    from vaex_tpu_torch.ops.nullable import NA
    binner = BinnerOrdinal("i1", 0, K)
    prolog_ms = cuda_ms(lambda: binner.to_bins(NA(i1)), 10)
    # the kernel's HBM floor: 12 bytes/row (int32 bin + float64 value) at the
    # bandwidth of a device-to-device copy of x measured here
    copy_bw, copy_ms = copy_bandwidth(x)
    floor_ms = n * 12 / copy_bw * 1e3
    got = ga.grid_additive(idx, [], [x], G, count=True)[1]
    want = ga.grid_additive_reference(idx, [], [x], G, count=True)[1]
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL), f"kernel at N={n}")
    port_rate = n / statistics.median(port_s)
    plain_rate = n / statistics.median(plain_s)
    print(f"[{label}] N={n} K={K}: groupby median {port_rate!r} rows/s (port) vs "
          f"{plain_rate!r} rows/s (plain torch bincount+index_add_), reps {REPS}; "
          f"port s {port_s}; plain s {plain_s}", flush=True)
    print(f"[{label}] N={n} G={G}: grid_additive kernel {kernel_ms!r} ms vs plain "
          f"{plain_ms!r} ms; binning prolog {prolog_ms!r} ms; kernel max abs err {err!r}",
          flush=True)
    print(f"[{label}] N={n}: copy bandwidth {copy_bw / 1e12!r} TB/s (read + write, "
          f"{copy_ms!r} ms); kernel HBM floor at 12 B/row {floor_ms!r} ms, kernel at "
          f"{floor_ms / kernel_ms!r} of it", flush=True)
    library_ms = library_additive_ms(idx, [], [x], G)
    bound_ms, bound_by = additive_bound(n, G, 0, 1)
    print(f"[{label}] N={n} G={G}: bincount + index_add_ (the library calls) {library_ms!r} "
          f"ms; bound {bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s", flush=True)
    # the same shape on B1's warp route, beside the planned lane route
    planned = ga.route
    ga.route = lambda *a: ga.WARP
    try:
        warp_ms = cuda_ms(lambda: ga.grid_additive(idx, [], [x], G, count=True), 10)
    finally:
        ga.route = planned
    # the isin count's shape: G = 1, the count alone, the rows outside it at -1
    g1 = (i1 < K // 2).to(torch.int32) - 1
    g1_ms = cuda_ms(lambda: ga.grid_additive(g1, [], [], 1, count=True), 10)
    check(ga.grid_additive.last_route == ga.LANE, "the isin count's shape on the lane route")
    g1_plain_ms = cuda_ms(lambda: ga.grid_additive_reference(g1, [], [], 1, count=True), 10)
    got1 = ga.grid_additive(g1, [], [], 1, count=True)[0]
    want1 = ga.grid_additive_reference(g1, [], [], 1, count=True)[0]
    check(torch.equal(got1, want1), f"the count at G = 1, N={n}")
    g1_err = float((got1 - want1).abs().max())
    g1_library_ms = cuda_ms(lambda: torch.count_nonzero(g1 + 1), 10)
    g1_bound_ms, _ = additive_bound(n, 1, 0, 0)
    print(f"[{label}] N={n} G={G}: B1 warp route {warp_ms!r} ms (planned {planned(G, 0, 1, True)} "
          f"{kernel_ms!r}); the isin count's shape (G = 1, count alone): kernel {g1_ms!r} ms vs "
          f"plain {g1_plain_ms!r} ms, count_nonzero {g1_library_ms!r} ms, bound {g1_bound_ms!r} "
          f"ms", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "warp_ms": warp_ms, "g1_ms": g1_ms,
            "g1_plain_ms": g1_plain_ms, "g1_bound_ms": g1_bound_ms,
            "g1_library_ms": g1_library_ms, "g1_max_abs_err": g1_err}


# ------------------------------------------------------- the H2O-shaped path
def make_h2o(vt):
    """The H2O groupby generator's shapes at H2O_ROWS rows, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def ints(low, high):
        return torch.randint(low, high + 1, (H2O_ROWS,), generator=gen, device="cuda",
                             dtype=torch.int64)
    cols = {"id4": ints(1, H2O_K), "id5": ints(1, H2O_K), "id6": ints(1, H2O_K6),
            "v1": ints(1, 5), "v2": ints(1, 5),
            "v3": torch.rand(H2O_ROWS, generator=gen, device="cuda",
                             dtype=torch.float64) * 100}
    df = vt.from_dataset(vt.DatasetArrays(cols))
    df = df.categorize("id4", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id5", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id6", min_value=1, labels=range(1, H2O_K6 + 1))
    return df, cols


def h2o_queries(vt):
    return {
        "q2": lambda df: df.groupby(["id4", "id5"], agg={"v1": "sum"}, sort=True),
        "binby": lambda df: df.count(binby=["id4", "id5"]),
        "q3": lambda df: df.groupby("id6", agg={"v1": "sum", "v3": "mean"}),
        "q5": lambda df: df.groupby("id6", agg={"v1": "sum", "v2": "sum", "v3": "sum"}),
        "q5 + count": lambda df: df.groupby("id6", agg={"v1": "sum", "v2": "sum", "v3": "sum",
                                                        "n": "count"}),
    }


# the kernel the last pass of each query must record and launch
H2O_EXPECT = {"q2": "b2", "binby": "b2", "q3": "b3-l2", "q5": "b3-l2", "q5 + count": "b3"}


def h2o_plain(cols):
    """The same five answers in plain torch: bincount and index_add_."""
    pair = (cols["id4"] - 1) * H2O_K + (cols["id5"] - 1)
    id6 = cols["id6"] - 1

    def per(keys, size, v):
        out = torch.zeros(size, dtype=v.dtype, device=v.device)
        return out.index_add_(0, keys, v)
    return {
        "q2": lambda: (torch.bincount(pair, minlength=H2O_K ** 2),
                       per(pair, H2O_K ** 2, cols["v1"])),
        "binby": lambda: torch.bincount(pair, minlength=H2O_K ** 2),
        "q3": lambda: (torch.bincount(id6, minlength=H2O_K6), per(id6, H2O_K6, cols["v1"]),
                       per(id6, H2O_K6, cols["v3"])),
        "q5": lambda: (per(id6, H2O_K6, cols["v1"]), per(id6, H2O_K6, cols["v2"]),
                       per(id6, H2O_K6, cols["v3"])),
        "q5 + count": lambda: (per(id6, H2O_K6, cols["v1"]), per(id6, H2O_K6, cols["v2"]),
                               per(id6, H2O_K6, cols["v3"]),
                               torch.bincount(id6, minlength=H2O_K6)),
    }


def h2o_check(name, out, want):
    """One query's result against its plain torch answer."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if name == "q2":
        counts, v1 = want
        keep = (counts > 0).cpu()
        check(out.get_column_names() == ["id4", "id5", "v1"], "q2 columns")
        cells = torch.nonzero(keep).squeeze(1)
        check(out["id4"].tolist() == (cells // H2O_K + 1).tolist(), "q2 id4 keys in order")
        check(out["id5"].tolist() == (cells % H2O_K + 1).tolist(), "q2 id5 keys in order")
        check(out["v1"].tolist() == host(v1)[keep.numpy()].tolist(), "q2 v1 sums exact")
    elif name == "binby":
        check((out == host(want).reshape(H2O_K, H2O_K)).all(), "binby counts exact")
    else:
        check(torch.equal(torch.as_tensor(out.evaluate("id6")),
                          torch.arange(1, H2O_K6 + 1)), f"{name} id6 keys in order")
        if name == "q3":
            counts, v1, v3 = want
            check((out.evaluate("v1") == host(v1)).all(), "q3 v1 sums exact")
            mean = torch.where(counts > 0, v3 / counts, torch.nan)
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), mean.cpu(), rtol=RTOL,
                                 atol=ATOL, equal_nan=True), "q3 v3 means")
        else:
            v1, v2, v3 = want[:3]
            check((out.evaluate("v1") == host(v1)).all(), f"{name} v1 sums exact")
            check((out.evaluate("v2") == host(v2)).all(), f"{name} v2 sums exact")
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), v3.cpu(), rtol=RTOL,
                                 atol=ATOL), f"{name} v3 sums")
            if len(want) > 3:
                check((out.evaluate("n") == host(want[3])).all(), f"{name} counts exact")


def h2o_path(vt, plan):
    """Phase 7: the five queries once, checked; returns the table and the
    launches of each kernel during them."""
    df, cols = make_h2o(vt)
    plain = h2o_plain(cols)
    for kernel in plan.KERNELS.values():
        kernel.launches = 0
    outs = {}
    for name, query in h2o_queries(vt).items():
        before = plan.KERNELS[H2O_EXPECT[name]].launches
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        print(f"H2O {name} N={H2O_ROWS}: pass strategies {strategies}", flush=True)
        check(strategies == [{"additive": H2O_EXPECT[name]}],
              f"{name}: strategies {strategies}, expected {H2O_EXPECT[name]}")
        check(plan.KERNELS[H2O_EXPECT[name]].launches > before,
              f"{name}: launches of {H2O_EXPECT[name]}")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    for name, out in outs.items():
        h2o_check(name, out, plain[name]())
        print(f"H2O {name}: checked against plain torch (ints exact, floats rtol {RTOL})",
              flush=True)
    print(f"launches during the H2O path: {launches}", flush=True)
    return df, cols, launches


def stats_queries(vt):
    a = vt.agg
    return {
        "q6-sd": lambda df: df.groupby(["id4", "id5"], agg={"sd_v3": a.std("v3", ddof=1)},
                                       sort=True),
        "q9": lambda df: df.groupby(["id4", "id5"], agg={"r2": a.corr("v1", "v2")}),
        "q7": lambda df: df.groupby("id6", agg={"max_v1": a.max("v1"), "min_v2": a.min("v2")}),
        "df.std": lambda df: df.std("v3"),
        "std by id4": lambda df: df.std("v3", binby=["id4"]),
    }


def stats_plain(cols):
    """The five statistics in plain torch: index_add_ of the formed moments
    and the same formulas, scatter_reduce for q7."""
    f64 = torch.float64
    pair = (cols["id4"] - 1) * H2O_K + (cols["id5"] - 1)
    id4, id6 = cols["id4"] - 1, cols["id6"] - 1
    v1, v2, v3 = cols["v1"].to(f64), cols["v2"].to(f64), cols["v3"]

    def per(keys, size, v):
        return torch.zeros(size, dtype=f64, device=v.device).index_add_(0, keys, v)

    def std(keys, size, ddof):
        n = per(keys, size, torch.ones_like(v3))
        mean = per(keys, size, v3) / n
        var = torch.clamp(per(keys, size, v3 * v3) / n - mean ** 2, min=0.0)
        return n, torch.sqrt(var * n / (n - ddof))

    def corr():
        n = per(pair, H2O_K ** 2, torch.ones_like(v3))
        ex, ey = per(pair, H2O_K ** 2, v1) / n, per(pair, H2O_K ** 2, v2) / n
        cov = per(pair, H2O_K ** 2, v1 * v2) / n - ex * ey
        vx = per(pair, H2O_K ** 2, v1 * v1) / n - ex ** 2
        vy = per(pair, H2O_K ** 2, v2 * v2) / n - ey ** 2
        return n, cov / torch.sqrt(vx * vy)

    def extremes():
        out = []
        for v, mode, fill in ((cols["v1"], "amax", -(2 ** 63)), (cols["v2"], "amin", 2 ** 63 - 1)):
            grid = torch.full((H2O_K6,), fill, dtype=torch.int64, device=v.device)
            out.append(grid.scatter_reduce_(0, id6, v, mode, include_self=True))
        return out
    return {
        "q6-sd": lambda: std(pair, H2O_K ** 2, 1),
        "q9": corr,
        "q7": extremes,
        "df.std": lambda: torch.std(v3, correction=0),
        "std by id4": lambda: std(id4, H2O_K, 0)[1],
    }


def stats_check(name, out, want):
    """One statistic against its plain torch answer."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    close = lambda got, w, what: check(torch.allclose(  # noqa: E731
        torch.as_tensor(got, dtype=torch.float64), w.cpu(), rtol=RTOL, atol=ATOL), what)
    if name in ("q6-sd", "q9"):
        n, value = want
        keep = (n > 0).cpu()
        cells = torch.nonzero(keep).squeeze(1)
        check(out["id4"].tolist() == (cells // H2O_K + 1).tolist(), f"{name} id4 keys")
        check(out["id5"].tolist() == (cells % H2O_K + 1).tolist(), f"{name} id5 keys")
        column = "sd_v3" if name == "q6-sd" else "r2"
        close(out.evaluate(column), value.cpu()[keep], f"{name} {column}")
    elif name == "q7":
        vmax, vmin = want
        check((out.evaluate("max_v1") == host(vmax)).all(), "q7 max_v1 exact")
        check((out.evaluate("min_v2") == host(vmin)).all(), "q7 min_v2 exact")
        check(out.evaluate("max_v1").dtype.name == "int64", "q7 keeps int64")
    else:
        close(out, want, name)


# the moment kernel of each statistic's last pass and, for B5, its parts
# (q6-sd: var at G = 10 609, one part; q9: corr, one window of three term
# groups)
STATS_EXPECT = {"q6-sd": ("b5", 1), "q9": ("b5", 3), "q7": (None, None),
                "df.std": ("b4", None), "std by id4": ("b4", None)}


def stats_path(vt, plan, df, cols):
    """Phase 8: the statistics once, checked; returns the launches of each
    kernel during them."""
    plain = stats_plain(cols)
    kernels = {**plan.KERNELS, **plan.MOMENT_KERNELS}
    for kernel in kernels.values():
        kernel.launches = 0
    window = plan.MOMENT_KERNELS[plan.B5]
    outs = {}
    for name, query in stats_queries(vt).items():
        window.last_parts = None
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        print(f"stats {name} N={H2O_ROWS}: pass strategies {strategies}, B5 parts "
              f"{window.last_parts}", flush=True)
        kernel, parts = STATS_EXPECT[name]
        moments = [s.get("moments") for s in strategies]
        check(moments == [kernel], f"{name}: moment kernels {moments}, expected {kernel}")
        check(window.last_parts == parts, f"{name}: B5's parts {window.last_parts}, expected "
                                          f"{parts}")
        if kernel == plan.B4:
            route = plan.MOMENT_KERNELS[plan.B4].last_route
            check(route == "lane", f"{name}: B4's route {route}, expected its lane route")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    for name, out in outs.items():
        stats_check(name, out, plain[name]())
        print(f"stats {name}: checked against plain torch (ints exact, floats rtol {RTOL})",
              flush=True)
    print(f"launches during the statistics path: {launches}", flush=True)
    return launches


def library_moments_ms(idx, bases, terms, G, gm):
    """The PyTorch library call for a moment kernel: the terms formed as an
    [N, A] float64 matrix (what the TPU kernels are handed), then one
    ``index_add_``.  Returns the time of both and of the ``index_add_``
    alone."""
    idx = idx.to(torch.int64)

    def formed():
        count_cols, float_cols = gm.form_terms(idx, bases, terms)
        return torch.stack([c.to(torch.float64) for c in count_cols] + float_cols, dim=1)

    def add(matrix):
        out = torch.zeros(G, len(terms), dtype=torch.float64, device=idx.device)
        return out.index_add_(0, idx, matrix)
    matrix = formed()
    add_ms = cuda_ms(lambda: add(matrix), 2)
    del matrix
    return cuda_ms(lambda: add(formed()), 2), add_ms


def stats_timings(df, cols, vt, plan, agg, gm, label):
    """Phase 9 for the statistics: query medians and B4/B5 kernel times at
    the shapes of std by id4 (G = 103, v3) and q9 (G = 10 609, v1 and v2)."""
    plain = stats_plain(cols)
    for name, query in stats_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] stats {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    copy_bw, _ = copy_bandwidth(cols["v3"])
    G2 = (H2O_K + 3) ** 2
    shapes = {
        plan.B4: ((cols["id4"] + 1).to(torch.int32), H2O_K + 3, [cols["v3"]], agg.VAR_TERMS,
                  12, "idx 4 + v3 8"),
        plan.B5: (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                  [cols["v1"], cols["v2"]], agg.CORR_TERMS, 20, "idx 4 + v1 8 + v2 8"),
        # q6-sd's shape: var of v3 over the same grid, one window
        "b5 var": (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                   [cols["v3"]], agg.VAR_TERMS, 12, "idx 4 + v3 8"),
        # df.std's shape: var of v3 over one cell, no index (every row in bin 0)
        "b4 g1": (None, 1, [cols["v3"]], agg.VAR_TERMS, 8, "v3 8"),
    }
    results = {}
    for label, (idx, G, bases, terms, bytes_per_row, bytes_note) in shapes.items():
        name = label.split()[0]
        check(plan.moment_strategy(H2O_ROWS, G, len(terms), 1, gm.compiled(len(bases), terms))
              == name, f"{name} at G={G}")
        args = (idx, bases, terms, G)
        kernel_ms = cuda_ms(lambda: plan.MOMENT_KERNELS[name](*args), 5)
        plain_ms = cuda_ms(lambda: plan.MOMENT_PLAIN[name](*args), 2)
        got = plan.MOMENT_KERNELS[name](*args)
        want = plan.MOMENT_PLAIN[name](*args)
        check(torch.equal(got[0], want[0]), f"{name} counts at the query shape")
        check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"{name} sums")
        err = (got[1] - want[1]).abs().max().item()
        floor_ms = H2O_ROWS * bytes_per_row / copy_bw * 1e3
        form = f", {gm.grid_moments_window.last_parts} parts" if name == plan.B5 else ""
        print(f"[{label}] {name} N={H2O_ROWS} G={G} ({len(terms)} terms{form}): kernel "
              f"{kernel_ms!r} ms vs plain {plain_ms!r} ms; HBM floor at {bytes_per_row} B/row "
              f"({bytes_note}) {floor_ms!r} ms, kernel at {floor_ms / kernel_ms!r} of it; max "
              f"abs err {err!r}", flush=True)
        # in: idx and the base columns; out: one 8-byte row of G per term;
        # a multiply and an add per float term, an add per count term
        n_float = sum(a >= 0 for a, *_ in terms)
        bound_ms, bound_by = bound(
            H2O_ROWS * bytes_per_row + 8 * len(terms) * G,
            {"f64": 2 * H2O_ROWS * n_float, "int": H2O_ROWS * (len(terms) - n_float)})
        if G == 1:  # one call computes the same function over one cell
            library_ms, add_ms = cuda_ms(lambda: torch.var_mean(bases[0]), 5), None
            print(f"[{label}] {name} at G = 1: bound {bound_ms!r} ms by {bound_by}; "
                  f"torch.var_mean (the library call) {library_ms!r} ms", flush=True)
        else:
            library_ms, add_ms = library_moments_ms(idx, bases, terms, G, gm)
            print(f"[{label}] {name}: bound {bound_ms!r} ms by {bound_by} at "
                  f"{PEAK_BYTES / 1e12} TB/s; formed terms + one index_add_ of the [N, "
                  f"{len(terms)}] float64 matrix (the library call) {library_ms!r} ms, the "
                  f"index_add_ alone {add_ms!r} ms", flush=True)
        results[label] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                          "library_add_ms": add_ms}
        del idx
    # one entry of the kernels line for B5: q9's shape, q6-sd's beside it;
    # for B4 std by id4's, df.std's beside it
    var = results.pop("b5 var")
    results[plan.B5].update(var_ms=var["ms"], var_plain_ms=var["plain_ms"],
                            var_bound_ms=var["bound_ms"], var_library_ms=var["library_ms"],
                            var_max_abs_err=var["err"])
    g1 = results.pop("b4 g1")
    results[plan.B4].update(g1_ms=g1["ms"], g1_plain_ms=g1["plain_ms"],
                            g1_bound_ms=g1["bound_ms"], g1_library_ms=g1["library_ms"],
                            g1_max_abs_err=g1["err"])
    return results


def h2o_timings(df, cols, vt, plan, label):
    """Phase 9 for the wide path: query medians and the times of B2 and of
    both routes of B3 at the shape of q3."""
    plain = h2o_plain(cols)
    for name, query in h2o_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] H2O {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    copy_bw, copy_ms = copy_bandwidth(cols["v3"])
    print(f"[{label}] copy bandwidth {copy_bw / 1e12!r} TB/s (read + write, {copy_ms!r} ms)",
          flush=True)
    # kernel shapes of the queries, count + v1 (int64) + v3 (f64): the
    # fused bin layout of BinnerOrdinal (code + 2, +3 edges per key)
    G2, G3 = (H2O_K + 3) ** 2, H2O_K6 + 3
    shapes = {
        plan.B2: (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                  20, "idx 4 + v1 8 + v3 8, read once from HBM"),
        plan.B3: ((cols["id6"] + 1).to(torch.int32), G3, 12 + 3 * 16,
                  "phase 1a idx 4; 1b idx 4 + values 16 + low bits 2 + values 16; "
                  "2 low bits 2 + values 16"),
        plan.B3_L2: ((cols["id6"] + 1).to(torch.int32), G3, 20,
                     "idx 4 + v1 8 + v3 8, read once from HBM; the grid stays in L2"),
    }
    results = {}
    for name, (idx, G, bytes_per_row, bytes_note) in shapes.items():
        args = (idx, [cols["v1"]], [cols["v3"]], G)
        kernel_ms = cuda_ms(lambda: plan.KERNELS[name](*args, count=True), 5)
        plain_ms = cuda_ms(lambda: plan.PLAIN[name](*args, count=True), 2)
        got = plan.KERNELS[name](*args, count=True)
        want = plan.PLAIN[name](*args, count=True)
        check(torch.equal(got[0], want[0]), f"{name} ints at the query shape")
        check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"{name} floats")
        err = (got[1] - want[1]).abs().max().item()
        floor_ms = H2O_ROWS * bytes_per_row / copy_bw * 1e3
        print(f"[{label}] {name} N={H2O_ROWS} G={G} (count + v1 + v3): kernel {kernel_ms!r} "
              f"ms vs plain {plain_ms!r} ms; HBM floor at {bytes_per_row} B/row "
              f"({bytes_note}) {floor_ms!r} ms, kernel at {floor_ms / kernel_ms!r} of it; "
              f"max abs err {err!r}", flush=True)
        library_ms = library_additive_ms(idx, [cols["v1"]], [cols["v3"]], G)
        bound_ms, bound_by = additive_bound(H2O_ROWS, G, 1, 1)
        print(f"[{label}] {name}: bincount + 2 index_add_ (the library calls) {library_ms!r} "
              f"ms; bound {bound_ms!r} ms by {bound_by} (idx 4 + v1 8 + v3 8 B/row in, "
              f"3 x G x 8 B out) at {PEAK_BYTES / 1e12} TB/s", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if name == plan.B3:
            results[name].update(partition_phases(idx, [cols["v1"]], [cols["v3"]], G, label))
        del idx
    # one entry of the kernels line for B3: the partition route, the
    # resident route at the same shape beside it
    resident = results.pop(plan.B3_L2)
    results[plan.B3].update(l2_ms=resident["ms"], l2_plain_ms=resident["plain_ms"],
                            l2_max_abs_err=resident["err"])
    return results


def partition_phases(idx, ints, floats, G, label):
    """ms of B3's count, of its offsets and scatter, and of its phase 2."""
    from vaex_tpu_torch.ops import grid_partition as gp
    lib = gp._library()
    n = idx.shape[0]
    sh = gp.shape(n, G, 1 + len(ints) + len(floats), gp._sm_count(idx.device))
    stream = torch.cuda.current_stream().cuda_stream
    rows_ms = cuda_ms(lambda: gp._partition_rows(lib, idx, G, sh, ints + floats, stream), 5)
    counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device="cuda")
    count_ms = cuda_ms(lambda: lib.grid_partition_count(
        idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, gp.COUNT_THREADS,
        counts.data_ptr(), stream), 5)
    lo, bucket_start, moved = gp._partition_rows(lib, idx, G, sh, ints + floats, stream)
    launches = gp.grid_partition.launches
    sums_ms = cuda_ms(lambda: gp._bucket_sums(lib, lo, bucket_start, n, G, sh,
                                              moved[:len(ints)], moved[len(ints):], True,
                                              stream), 5)
    gp.grid_partition.launches = launches  # timing the phase alone is not a call of B3
    print(f"[{label}] b3 N={n} G={G} shape {tuple(sh)}: count {count_ms!r} ms, offsets + "
          f"scatter {rows_ms - count_ms!r} ms, phase 2 {sums_ms!r} ms", flush=True)
    return {"count_ms": count_ms, "scatter_ms": rows_ms - count_ms, "sums_ms": sums_ms}

# ------------------------------------------------------- the set-based path
def probe_inputs(gen, n, M, float_keys, spread=1):
    """M sorted unique keys (over a range of about 4M, times ``spread``) and
    n rows: hits, misses, rows below the first and above the last key and,
    for floats, -0.0 and NaN."""
    keys = (torch.randperm(4 * M, generator=gen, device="cuda")[:M].sort().values - M) * spread
    x = torch.randint(-M - 5, 3 * M + 6, (n,), generator=gen, device="cuda",
                      dtype=torch.int64) * spread
    if float_keys:
        keys, x = keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5
        x[::7] = -0.0
        x[3::11] = float("nan")
    return keys, x


I64 = torch.iinfo(torch.int64)


def probe_edge_sets(gen, n):
    """(label, keys, rows): a set holding the int64 extremes, one holding
    +-inf, 0.0 and the largest finite float (rows with -0.0 and NaN), and
    int sets spanning exactly 2^32 - 1 (4-byte keys) and 2^32 (8-byte)."""
    ints = torch.tensor([I64.min, I64.min + 1, -5, 0, 7, I64.max - 1, I64.max], device="cuda")
    floats = torch.tensor([-float("inf"), -1.5, 0.0, 2.0, torch.finfo(torch.float64).max,
                           float("inf")], device="cuda", dtype=torch.float64)
    pick = lambda cands: cands[torch.randint(0, cands.numel(), (n,), generator=gen,  # noqa
                                             device="cuda")]
    int_rows = pick(torch.cat([ints, torch.tensor([I64.min + 2, 3, I64.max - 2],
                                                  device="cuda")]))
    float_rows = pick(torch.cat([floats, torch.tensor([-0.0, float("nan"), 1.0],
                                                      dtype=torch.float64, device="cuda")]))
    out = [("int64 extremes", ints, int_rows), ("float extremes", floats, float_rows)]
    lo = -(2 ** 40)
    for span in (2 ** 32 - 1, 2 ** 32):
        inner = torch.randperm(2 ** 20, generator=gen, device="cuda")[:60_000] * 4093 + 1
        keys = torch.cat([torch.tensor([0, span], device="cuda"), inner]).unique() + lo
        rows = torch.cat([keys, keys + 1, keys - 1, torch.tensor(
            [lo + 2 ** 32, lo - 2 ** 32, lo + 2 ** 33], device="cuda")])
        out.append((f"int64 span {span}", keys, pick(rows)))
    return out


def probe_vs_plain(probe):
    """Phase 10: both routes of B6 against the plain version, exact; returns
    the largest difference of any ordinal (0 when every check passed)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0

    def one(keys, x, what, narrow=None):
        nonlocal worst
        tree = probe.build_tree(keys, probe.compare_dtype(keys, x))
        check(tree.route == probe.probe_route(keys.numel(), tree.key_bytes),
              f"the route of the set's size, {what}")
        if narrow is not None:
            check((tree.kind == probe.KIND_NARROW) == narrow, f"4-byte keys {narrow}, {what}")
        before = probe.probe.wide_launches
        got = probe.probe(keys, x, tree)
        want = probe.probe_reference(keys, x)
        torch.cuda.synchronize()
        what = f"{tree.route} kind {tree.kind} {keys.dtype} {what}"
        check(probe.probe.wide_launches - before == int(tree.route == probe.B6_WIDE),
              f"launches of the route, {what}")
        worst = max(worst, int((got - want).abs().max()) if x.numel() else 0)
        check(got.dtype == torch.int32 and torch.equal(got, want), f"ordinals, {what}")
        if keys.is_floating_point() and x.numel() > 11:
            check(bool((got[torch.isnan(x)] == -1).all()), f"NaN rows give -1, {what}")
            zero = torch.nonzero(keys == 0)
            if zero.numel():
                check(bool((got[torch.signbit(x) & (x == 0)] == int(zero[0])).all()),
                      f"-0.0 rows find the key 0.0, {what}")
        print(f"{what} vs plain: exact, {int((got >= 0).sum())} rows hit", flush=True)
        return tree

    sizes = (1, 15, 16, 17, 64, 500, 2048, probe.MAX_KEYS, probe.MAX_KEYS + 1, 50_000,
             probe.NARROW_MAX_KEYS, probe.NARROW_MAX_KEYS + 1, 1_000_003)
    for float_keys in (False, True):
        for M in sizes:
            for n in KERNEL_SIZES:
                keys, x = probe_inputs(gen, n, M, float_keys)
                one(keys, x, f"M={M} N={n}")
                if not float_keys and M > probe.MAX_KEYS and n in (1, 1_000_003):
                    # the same set spread past 2^32: 8-byte keys
                    keys, x = probe_inputs(gen, n, M, False, spread=WIDE_FACTOR)
                    one(keys, x, f"spread M={M} N={n}", narrow=False)
                del keys, x
    for label, keys, x in probe_edge_sets(gen, 1_000_003):
        narrow = {"int64 span 4294967295": True, "int64 span 4294967296": False}.get(label)
        tree = one(keys, x, f"{label} M={keys.numel()}", narrow)
        if narrow is not None:  # the same sets forced onto 4-byte keys, where allowed
            forced = probe.build_tree(keys, narrow=True)
            check((forced.kind == probe.KIND_NARROW) == narrow, f"forced narrow, {label}")
            check(torch.equal(probe.probe(keys, x, forced), probe.probe_reference(keys, x)),
                  f"ordinals, {label} forced narrow")
    return worst


def make_sets_table(vt, cols):
    """The H2O-shaped columns WITHOUT categorize, plus two keys whose range
    is past 2^22 (so they take the set grouper), and the isin values."""
    cols = dict(cols)
    cols["k100"] = cols["id4"] * WIDE_FACTOR
    cols["k2000"] = (cols["id6"] % SET_KEYS["k2000"]) * WIDE_FACTOR
    cols["k1e6"] = cols["id6"] * WIDE_FACTOR
    ids = torch.randperm(H2O_K6, generator=torch.Generator().manual_seed(SEED)) + 1
    values = {"isin": ids[:ISIN_VALUES].numpy(), "isin wide": ids[:ISIN_WIDE_VALUES].numpy()}
    return vt.from_dataset(vt.DatasetArrays(cols)), cols, values


def sets_queries(vt, values):
    agg = {"v1": "sum", "v3": "mean"}
    return {
        "isin count": lambda df: df.count(selection=df.id6.isin(values["isin"])),
        "isin wide count": lambda df: df.count(selection=df.id6.isin(values["isin wide"])),
        "isin groupby": lambda df: df[df.id6.isin(values["isin"])].groupby("id4", agg=agg),
        "raw id4": lambda df: df.groupby("id4", agg=agg),
        "raw id6": lambda df: df.groupby("id6", agg=agg),
        "set k100": lambda df: df.groupby("k100", agg={"v1": "sum"}),
        "set k2000": lambda df: df.groupby("k2000", agg={"v1": "sum"}),
        "set k1e6": lambda df: df.groupby("k1e6", agg={"v1": "sum"}),
        "nunique id6": lambda df: df.id6.nunique(),
        "unique id4": lambda df: df.id4.unique(),
    }


# what each query's last pass must record: the probe route, and the kernel
# of its additive aggregation (None: the last pass is a set build)
SETS_EXPECT = {"isin count": ("b6", "b1"), "isin wide count": ("b6", "b1"),
               "isin groupby": ("b6", "b2"), "raw id4": (None, "b2"),
               "raw id6": (None, "b3"),
               "set k100": ("b6", "b1"), "set k2000": ("b6", "b2"),
               "set k1e6": ("b6-wide", "b3-l2"),
               "nunique id6": (None, None), "unique id4": (None, None)}


def sets_plain(cols, values):
    """The same answers in plain torch: isin, unique, aminmax, bincount and
    index_add_.  A groupby gives (keys, counts, v1 sums[, v3 sums])."""
    values = {name: torch.as_tensor(v, device="cuda") for name, v in values.items()}

    def grouped(key, keep=None, v3=True):
        k, v1 = cols[key], cols["v1"]
        if keep is not None:
            k, v1 = k[keep], v1[keep]
        lo, hi = (int(v) for v in torch.aminmax(k))
        size, k = hi - lo + 1, k - lo
        out = [torch.arange(lo, hi + 1, device="cuda"), torch.bincount(k, minlength=size),
               torch.zeros(size, dtype=torch.int64, device="cuda").index_add_(0, k, v1)]
        if v3:
            w = cols["v3"] if keep is None else cols["v3"][keep]
            out.append(torch.zeros(size, dtype=torch.float64, device="cuda").index_add_(0, k, w))
        return out

    def by_set(key):
        keys, inverse, counts = torch.unique(cols[key], return_inverse=True, return_counts=True)
        sums = torch.zeros(keys.numel(), dtype=torch.int64, device="cuda")
        return keys, counts, sums.index_add_(0, inverse, cols["v1"])
    return {
        "isin count": lambda: torch.isin(cols["id6"], values["isin"]).sum(),
        "isin wide count": lambda: torch.isin(cols["id6"], values["isin wide"]).sum(),
        "isin groupby": lambda: grouped("id4", torch.isin(cols["id6"], values["isin"])),
        "raw id4": lambda: grouped("id4"),
        "raw id6": lambda: grouped("id6"),
        "set k100": lambda: by_set("k100"),
        "set k2000": lambda: by_set("k2000"),
        "set k1e6": lambda: by_set("k1e6"),
        "nunique id6": lambda: torch.unique(cols["id6"]).numel(),
        "unique id4": lambda: torch.unique(cols["id4"]),
    }


def sets_check(name, out, want):
    """One set-based query's result against its plain torch answer."""
    if name in ("isin count", "isin wide count"):
        check(int(out) == int(want), f"{name} {int(out)} equals torch.isin's {int(want)}")
    elif name == "nunique id6":
        check(out == want, f"nunique {out} equals torch.unique's {want}")
    elif name == "unique id4":
        check(out == want.tolist(), "unique id4 in order")
    else:
        key = out.get_column_names()[0]
        keys, counts, v1, *v3 = (t.cpu() for t in want)
        keep = counts > 0
        check(out.get_column_names() == [key, "v1"] + ["v3"] * len(v3), f"{name} columns")
        check(torch.equal(torch.as_tensor(out.evaluate(key)), keys[keep]),
              f"{name} keys in order")
        check(torch.equal(torch.as_tensor(out.evaluate("v1")), v1[keep]), f"{name} v1 sums exact")
        if v3:
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), (v3[0] / counts)[keep],
                                 rtol=RTOL, atol=ATOL), f"{name} v3 means")


def sets_path(vt, plan, probe, cols):
    """Phase 11: the set-based queries once, checked; returns the table, the
    isin values and the launches of each kernel during them."""
    df, cols, values = make_sets_table(vt, cols)
    plain = sets_plain(cols, values)
    kernels = {**plan.KERNELS, "b6": probe.probe}
    for kernel in kernels.values():
        kernel.launches = 0
    probe.probe.wide_launches = 0
    outs = {}
    for name, query in sets_queries(vt, values).items():
        before, before_wide = probe.probe.launches, probe.probe.wide_launches
        route, kernel = SETS_EXPECT[name]
        before_additive = plan.KERNELS[kernel].launches if kernel else 0
        outs[name] = query(df)
        log = df.executor.trace_log[-1]
        additive = [s.get("additive") for s in log["strategies"]]
        print(f"sets {name} N={H2O_ROWS}: last pass probe {log['probe']}, strategies "
              f"{log['strategies']}, B6 launches {probe.probe.launches - before}", flush=True)
        check(log["probe"] == route, f"{name}: probe route {log['probe']}, expected {route}")
        check(additive == ([kernel] if kernel else []), f"{name}: additive kernels {additive}")
        check(not kernel or plan.KERNELS[kernel].launches > before_additive,
              f"{name}: launches of {kernel}")
        check((probe.probe.launches > before) == (route is not None), f"{name}: B6 launches")
        check((probe.probe.wide_launches > before_wide) == (route == "b6-wide"),
              f"{name}: launches of B6's b6-wide route")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    launches["b6-wide"] = probe.probe.wide_launches
    for name, out in outs.items():
        sets_check(name, out, plain[name]())
        print(f"sets {name}: checked against plain torch (ints and keys exact, floats rtol "
              f"{RTOL})", flush=True)
    print(f"launches during the set-based path: {launches}", flush=True)
    return df, cols, values, launches


def sets_timings(df, cols, values, vt, probe, label):
    """Phase 12: query medians (a groupby over a raw key with its pre-pass,
    and with the pre-pass remembered) and B6 at the isin shape."""
    plain = sets_plain(cols, values)

    def fresh(query):
        def run():
            df.dataset.remembered.clear()
            return query(df)
        return run
    for name, query in sets_queries(vt, values).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(fresh(query))
        again_med, _ = median_s(lambda: query(df))
        print(f"[{label}] sets {name} N={H2O_ROWS}: median {port_med!r} s (port; {again_med!r} "
              f"s with the dense pre-pass remembered) vs {plain_med!r} s (plain torch), reps "
              f"{REPS}; port s {port_s}; plain s {plain_s}", flush=True)
    copy_bw, _ = copy_bandwidth(cols["v3"])
    x = cols["id6"]

    def library_probe(keys, x):
        # the PyTorch calls that compute the kernel's function
        idx = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
        return torch.where(keys[idx] == x, idx, -1).to(torch.int32)
    results = {}
    shapes = {name: (torch.as_tensor(ids, device="cuda").sort().values, x)
              for name, ids in values.items()}
    shapes["set k1e6"] = (torch.unique(cols["k1e6"]), cols["k1e6"])
    for name, (keys, x) in shapes.items():
        M = keys.numel()
        tree = probe.build_tree(keys)
        kernel_ms = cuda_ms(lambda: probe.probe(keys, x, tree), 5)
        plain_ms = cuda_ms(lambda: probe.probe_reference(keys, x), 2)
        library_ms = cuda_ms(lambda: library_probe(keys, x), 2)
        isin_ms = cuda_ms(lambda: torch.isin(x, keys), 2)
        got, want = probe.probe(keys, x, tree), probe.probe_reference(keys, x)
        check(torch.equal(got, want), f"b6 at the {name} shape")
        check(torch.equal(got, library_probe(keys, x)), f"b6 equals the library calls, {name}")
        check(torch.equal(got >= 0, torch.isin(x, keys)), "b6 membership equals torch.isin")
        err = float((got - want).abs().max())
        # in: the rows and the keys; out: an int32 per row; a compare per level
        # of a binary search and one for equality
        bound_ms, bound_by = bound(H2O_ROWS * 12 + 8 * M,
                                   {"int": H2O_ROWS * (M.bit_length() + 1)})
        floor_ms = H2O_ROWS * 12 / copy_bw * 1e3
        print(f"[{label}] {tree.route} N={H2O_ROWS} M={M} ({name}; {tree.key_bytes}-byte keys, "
              f"levels {tree.counts}): kernel {kernel_ms!r} ms vs plain (searchsorted + "
              f"gather + compare) {plain_ms!r} ms, the same as library calls {library_ms!r} ms, "
              f"torch.isin (membership only) {isin_ms!r} ms; HBM floor at 12 B/row (x 8 + out "
              f"4) {floor_ms!r} ms at the copy bandwidth, kernel at {floor_ms / kernel_ms!r} of "
              f"it; bound {bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s; max abs "
              f"err {err!r}", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "isin_ms": isin_ms, "route": tree.route}
        del keys, got, want, tree
    for key, M_set in SET_KEYS.items():
        set_keys = torch.unique(cols[key])
        check(set_keys.numel() == M_set, f"{key} has {M_set} distinct values")
        tree = probe.build_tree(set_keys)
        ms = cuda_ms(lambda: probe.probe(set_keys, cols[key], tree), 5)
        p_ms = cuda_ms(lambda: probe.probe_reference(set_keys, cols[key]), 2)
        print(f"[{label}] {tree.route} N={H2O_ROWS} M={M_set} (the set grouper of {key}): "
              f"kernel {ms!r} ms vs plain {p_ms!r} ms", flush=True)
    # the entry of the kernels line: b6 at the isin shape, b6-wide at the
    # set grouper of k1e6 beside it (the 50 000 ids take b6 on 4-byte keys)
    check(results["isin"]["route"] == probe.B6 and results["isin wide"]["route"] == probe.B6
          and results["set k1e6"]["route"] == probe.B6_WIDE, "the routes of the timed sets")
    wide = results["set k1e6"]
    return {**results["isin"], "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
            "wide_library_ms": wide["library_ms"], "wide_isin_ms": wide["isin_ms"],
            "wide_bound_ms": wide["bound_ms"], "wide_max_abs_err": wide["err"],
            "isin_wide_ms": results["isin wide"]["ms"]}


# ------------------------------------------------- the binned-statistics path
EXTREME_GS = (1, 103, 10_609, 67_081, 1_000_003, 1_054_729)
BINBY_EXPECT = {  # what the last pass of each query must record
    "mean 2-D 1024": {"additive": "b3-l2"},
    "max 2-D 1024": {"extremes": "b3x-l2"},
    "max 2-D 2000": {"extremes": "b3x"},  # 32 MB of keys: past the resident route
    "minmax by x 128": {"extremes": "b3x-direct"},
    "q7": {"extremes": "b3x-l2"},
    "sum max min by id6": {"additive": "b3-l2", "extremes": "b3x-l2"},
    "first by id4": {"first": "b3x-direct"},
    "first by id4 past 2^53": {"first": "b3x-direct"},
}


def extreme_kernel_vs_plain(gp, ge):
    """Phase 13: B3x against its plain version, alone and with sums riding
    the partition; returns the worst float error of the sums (the extremes
    are exact or the phase fails)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    modes = ["min", "max", "min", "min", "max"]
    worst = 0.0
    for n in KERNEL_SIZES:
        ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen, device="cuda",
                             dtype=torch.int64)
        f64 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        f64[::7] = float("nan")
        f64[1::11] = float("inf")
        f64[2::11] = float("-inf")
        f64[3::5] = 0.0
        f64[4::5] = -0.0
        f32 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float32)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.8
        summed = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        cols = [ints, f64, f32, f64, ints]
        valids = [None, None, None, valid, valid]
        keys = [(G, "uniform") for G in EXTREME_GS]
        if n == max(KERNEL_SIZES):
            keys += [(1_000_003, kind) for kind in SKEWS]
        for G, kind in keys:
            if kind == "uniform":
                idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
            else:
                idx = skewed_keys(kind, gen, n, G)
            want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
            got, _, _ = gp.grid_partition_extreme(idx, cols, modes, valids, G)
            resident = gp.grid_resident_extreme(idx, cols, modes, valids, G)
            both, int_sums, float_sums = gp.grid_partition_extreme(
                idx, cols, modes, valids, G, [ints], [summed], True)
            want_i, want_f = gp.grid_partition_reference(idx, [ints], [summed], G, True)
            torch.cuda.synchronize()
            what = f"b3x G={G} N={n} {kind} keys"
            for k, (a, r, b, w) in enumerate(zip(got, resident, both, want)):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"{modes[k]} of {w.dtype} column {k} alone, {what}")
                check(r.dtype == w.dtype and torch.equal(r, w),
                      f"{modes[k]} of {w.dtype} column {k} on b3x-l2, {what}")
                check(b.dtype == w.dtype and torch.equal(b, w),
                      f"{modes[k]} of {w.dtype} column {k} beside sums, {what}")
            check(torch.equal(int_sums, want_i), f"int sums beside extremes, {what}")
            check(torch.allclose(float_sums, want_f, rtol=RTOL, atol=ATOL),
                  f"f64 sums beside extremes, {what}")
            err = (float_sums - want_f).abs().max().item() if n else 0.0
            worst = max(worst, err)
            route = "b3x-direct" if gp.extreme_direct_fits(G, len(cols)) else "b3x"
            print(f"{what} vs plain: five extremes exact alone ({route}), on b3x-l2 and "
                  f"beside sums (b3x), int sums exact, f64 sums max abs err {err!r}", flush=True)
            del idx, want, got, resident, both
    return worst


def make_binby(vt, cols):
    """The H2O-shaped columns (id4, id6 categorized) beside continuous axes
    x, y, a value v with 1% NaN and an order column t, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = H2O_ROWS
    new = {"x": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "y": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "v": torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100,
           "t": torch.randint(0, 2 ** 62, (n,), generator=gen, device="cuda", dtype=torch.int64),
           # nanosecond-like orders past 2^53, where float64 ties neighbours
           "t53": 2 ** 60 + torch.randint(0, 2 ** 28, (n,), generator=gen, device="cuda",
                                          dtype=torch.int64)}
    new["v"][torch.rand(n, generator=gen, device="cuda") < 0.01] = float("nan")
    cols = {**{k: cols[k] for k in ("id4", "id6", "v1", "v2")}, **new}
    df = vt.from_dataset(vt.DatasetArrays(cols))
    df = df.categorize("id4", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id6", min_value=1, labels=range(1, H2O_K6 + 1))
    return df, cols


def binby_queries(vt):
    a = vt.agg
    return {
        "limits minmax": lambda df: df.limits(["x", "y"], "minmax"),
        "limits 99.7%": lambda df: df.limits("x", "99.7%"),
        "count 2-D 256": lambda df: df.count(binby=["x", "y"], shape=256),
        "mean 2-D 1024": lambda df: df.mean("v", binby=["x", "y"], shape=1024),
        "max 2-D 1024": lambda df: df.max("v", binby=["x", "y"], shape=1024),
        "max 2-D 2000": lambda df: df.max("v", binby=["x", "y"], shape=2000),
        "minmax by x 128": lambda df: df.minmax("v", binby="x", shape=128),
        "q7": lambda df: df.groupby("id6", agg={"max_v1": a.max("v1"), "min_v2": a.min("v2")}),
        "sum max min by id6": lambda df: df.groupby(
            "id6", agg={"s": a.sum("v1"), "hi": a.max("v1"), "lo": a.min("v2")}),
        "first by id4": lambda df: df.first("v", "t", binby="id4"),
        "first by id4 past 2^53": lambda df: df.first("v", "t53", binby="id4"),
    }


def binby_plain(cols):
    """The same answers in plain torch: aminmax, bincount, index_add_ and
    scatter_reduce_ over bins computed with the binner's formula."""
    x, y, v, t = cols["x"], cols["y"], cols["v"], cols["t"]
    id4, id6 = cols["id4"] - 1, cols["id6"] - 1
    f64 = torch.float64

    def limits(c):
        lo, hi = torch.aminmax(c)
        return float(lo), float(hi)

    def axis(c, bins):
        """(bin, inside) of a continuous axis over its own min and max."""
        lo, hi = limits(c)
        b = torch.floor((c - lo) / (hi - lo) * bins).to(torch.int64)
        return b, (c >= lo) & (c < hi) & (b < bins)

    def cells(bins):
        bx, inx = axis(x, bins)
        by, iny = axis(y, bins)
        keep = inx & iny
        return (bx * bins + by)[keep], keep

    def percent():
        lo, hi = limits(x)
        b, inside = axis(x, 1024)
        counts = torch.bincount(b[inside], minlength=1024).cpu().numpy()
        return lo, hi, counts

    def mean(bins):
        cell, keep = cells(bins)
        w = v[keep]
        ok = ~torch.isnan(w)
        n = torch.bincount(cell[ok], minlength=bins * bins)
        s = torch.zeros(bins * bins, dtype=f64, device="cuda").index_add_(0, cell[ok], w[ok])
        return torch.where(n > 0, s / n, torch.nan).reshape(bins, bins)

    def extreme(cell, w, size, mode):
        ok = ~torch.isnan(w) if w.is_floating_point() else torch.ones_like(w, dtype=torch.bool)
        if w.is_floating_point():
            fill = float("-inf") if mode == "amax" else float("inf")
        else:
            fill = -(2 ** 63) if mode == "amax" else 2 ** 63 - 1
        out = torch.full((size,), fill, dtype=w.dtype, device="cuda")
        return out.scatter_reduce_(0, cell[ok], w[ok], mode, include_self=True)

    def max2d(bins):
        cell, keep = cells(bins)
        return extreme(cell, v[keep], bins * bins, "amax").reshape(bins, bins)

    def minmax1d(bins):
        b, inside = axis(x, bins)
        return torch.stack([extreme(b[inside], v[inside], bins, "amin"),
                            extreme(b[inside], v[inside], bins, "amax")], dim=-1)

    def first(order):
        """The value of the row with the smallest order per id4, the earliest
        among equal orders; an int64 order compares as int64 (a float64
        one as float64)."""
        ok = ~torch.isnan(v)
        top = I64.max if order.dtype == torch.int64 else float("inf")
        best = torch.full((H2O_K,), top, dtype=order.dtype, device="cuda")
        best.scatter_reduce_(0, id4[ok], order[ok], "amin", include_self=True)
        winner = ok & (order == best[id4])
        rows = torch.arange(v.numel(), device="cuda")
        row = torch.full((H2O_K,), v.numel(), dtype=torch.int64, device="cuda")
        row.scatter_reduce_(0, id4[winner], rows[winner], "amin", include_self=True)
        return v[row]
    return {
        "limits minmax": lambda: [limits(x), limits(y)],
        "limits 99.7%": percent,
        "count 2-D 256": lambda: torch.bincount(cells(256)[0], minlength=256 * 256),
        "mean 2-D 1024": lambda: mean(1024),
        "max 2-D 1024": lambda: max2d(1024),
        "max 2-D 2000": lambda: max2d(2000),
        "minmax by x 128": lambda: minmax1d(128),
        "q7": lambda: (extreme(id6, cols["v1"], H2O_K6, "amax"),
                       extreme(id6, cols["v2"], H2O_K6, "amin")),
        "sum max min by id6": lambda: (
            torch.zeros(H2O_K6, dtype=torch.int64, device="cuda").index_add_(0, id6, cols["v1"]),
            extreme(id6, cols["v1"], H2O_K6, "amax"), extreme(id6, cols["v2"], H2O_K6, "amin")),
        "first by id4": lambda: first(t),
        "first by id4 past 2^53": lambda: first(cols["t53"]),
        "first by id4 past 2^53 as float64": lambda: first(cols["t53"].to(f64)),
    }


def binby_check(name, out, want):
    """One binned statistic against its plain torch answer."""
    import numpy as np
    same = lambda got, w, what: check(  # noqa: E731
        torch.equal(torch.as_tensor(np.asarray(got)), w.cpu()), what)
    if name == "limits minmax":
        check([tuple(pair) for pair in out] == want, f"limits {out} equal aminmax's {want}")
    elif name == "limits 99.7%":
        lo, hi, counts = want
        cumulative = np.concatenate([[0], np.cumsum(counts) / counts.sum()])
        edges = np.linspace(lo, hi, 1025)
        expect = [np.interp(q, cumulative, edges) for q in (0.0015, 0.9985)]
        check(np.allclose(out, expect, rtol=RTOL, atol=ATOL), f"limits {out} against {expect}")
    elif name == "count 2-D 256":
        same(out, want.reshape(256, 256), "2-D counts exact")
    elif name == "mean 2-D 1024":
        check(torch.allclose(torch.as_tensor(out), want.cpu(), rtol=RTOL, atol=ATOL,
                             equal_nan=True), "2-D means")
    elif name in ("max 2-D 1024", "max 2-D 2000", "minmax by x 128", "first by id4",
                  "first by id4 past 2^53"):
        same(out, want, f"{name} exact")
    else:
        names = ["max_v1", "min_v2"] if name == "q7" else ["s", "hi", "lo"]
        for column, w in zip(names, want):
            same(out.evaluate(column), w, f"{name} {column} exact")
        check(out.evaluate(names[0]).dtype.name == "int64", f"{name} keeps int64")


def launch_counts(plan, gp):
    """The launches of every grid kernel, B3x by route."""
    counts = {name: kernel.launches
              for name, kernel in {**plan.KERNELS, **plan.MOMENT_KERNELS}.items()}
    direct = gp.grid_partition_extreme.direct_launches
    counts.update({plan.B3X: gp.grid_partition_extreme.launches - direct,
                   plan.B3X_DIRECT: direct, plan.B3X_L2: gp.grid_resident_extreme.launches})
    return counts


def zero_launches(plan, gp):
    for kernel in (*plan.KERNELS.values(), *plan.MOMENT_KERNELS.values(),
                   gp.grid_partition_extreme, gp.grid_resident_extreme):
        kernel.launches = 0
    gp.grid_partition_extreme.direct_launches = 0


def binby_path(vt, plan, gp, cols):
    """Phase 14: the binned statistics once, checked; returns the table and
    the launches of each kernel during them."""
    df, cols = make_binby(vt, cols)
    plain = binby_plain(cols)
    zero_launches(plan, gp)
    outs = {}
    for name, query in binby_queries(vt).items():
        before = launch_counts(plan, gp)
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        after = launch_counts(plan, gp)
        print(f"binby {name} N={H2O_ROWS}: pass strategies {strategies}, B3x launches "
              f"{ {r: after[r] - before[r] for r in (plan.B3X_DIRECT, plan.B3X_L2, plan.B3X)} }",
              flush=True)
        if name in BINBY_EXPECT:
            check(strategies == [BINBY_EXPECT[name]],
                  f"{name}: strategies {strategies}, expected {BINBY_EXPECT[name]}")
            # every route the pass names launched its kernel
            for route in BINBY_EXPECT[name].values():
                check(route not in after or after[route] > before[route],
                      f"{name}: launches of {route}")
    outs["first of an int64 max order"] = first_at_int64_max(vt)
    torch.cuda.synchronize()
    launches = launch_counts(plan, gp)
    for name, out in outs.items():
        if name == "first of an int64 max order":
            continue  # checked where it ran
        binby_check(name, out, plain[name]())
        print(f"binby {name}: checked against plain torch (counts, extremes and first exact, "
              f"floats rtol {RTOL})", flush=True)
    as_float = plain["first by id4 past 2^53 as float64"]().cpu()
    check(not torch.equal(torch.as_tensor(outs["first by id4 past 2^53"]), as_float),
          "orders past 2^53 compared as float64 give another first")
    print(f"launches during the binned-statistics path: {launches}", flush=True)
    return df, cols, launches


def first_at_int64_max(vt):
    """``first`` on the card where a cell's only order is the int64 maximum
    (B3x's image of it is its empty-cell mark) and two orders past 2^53
    differ by 1: numpy's argmin-based answer."""
    import numpy as np
    k = np.array([0, 0, 1, 1, 2, 3, 3], np.int64)
    o = np.array([2 ** 60 + 1, 2 ** 60, 5, 4, I64.max, I64.max, I64.max - 1], np.int64)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    df = vt.from_arrays(k=k, o=o, v=v).to_device("cuda")
    df = df.categorize("k", labels=list(range(5)))
    out = df.first("v", "o", binby="k")
    want = [2.0, 4.0, 5.0, 7.0, 0.0]
    check(np.asarray(out).tolist() == want, f"first at the int64 max order: {out}, want {want}")
    route = df.executor.trace_log[-1]["strategies"]
    check(route == [{"first": "b3x-direct"}], f"first at the int64 max order took {route}")
    print(f"binby first of an int64 max order on the card: {want}, route {route}", flush=True)
    return out


def extreme_timing(kernel, args, label, what, ge):
    """One B3x route at one shape: its time against its plain version and
    scatter_reduce_ alone (the library call; the NaN rows sent to a drop
    bin), checked exactly, and its bound."""
    idx, cols, modes, valids, G = args
    kernel_ms = cuda_ms(lambda: kernel(*args), 5)
    plain_ms = cuda_ms(lambda: ge.grid_extreme_batch(*args), 2)
    got, want = kernel(*args), ge.grid_extreme_batch(*args)
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"{what} at the query shape")
    bins = ge.extreme_bins(idx, G)
    dropped = [bins.masked_fill(torch.isnan(c), G) if c.is_floating_point() else bins
               for c in cols]

    def library():
        outs = []
        for c, m, b in zip(cols, modes, dropped):
            out = torch.full((G + 1,), ge.identity(c.dtype, m), dtype=c.dtype, device="cuda")
            outs.append(out.scatter_reduce_(0, b, c, ge.MODES[m], include_self=True)[:G])
        return outs
    library_ms = cuda_ms(library, 2)
    for g, w in zip(library(), want):
        check(torch.equal(g, w), f"{what} equals scatter_reduce_")
    # in: idx 4 B and 8 B a column per row; out: the grids; a compare per
    # row and column
    n, E = idx.shape[0], len(cols)
    bound_ms, bound_by = bound(n * (4 + 8 * E) + 8 * E * G, {"f64": n * E})
    print(f"[{label}] {what} N={n} G={G} E={E}: kernel {kernel_ms!r} ms vs plain {plain_ms!r} "
          f"ms, scatter_reduce_ alone (the library call) {library_ms!r} ms; bound "
          f"{bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s", flush=True)
    err = max(float((g.double() - w.double()).masked_fill(g == w, 0.0).abs().max())
              for g, w in zip(got, want))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def binby_timings(df, cols, vt, gp, ge, plan, label):
    """Phase 15: query medians, and each route of B3x at its query's shape
    against its plain version and scatter_reduce_ alone: b3x-l2 at the 2-D
    max (G = 1 054 729, one f64 column with NaN) and at q7's (two int64
    columns over id6), b3x over a partition at the 2-D max of shape 2000 (G =
    4 012 009) and b3x-direct at minmax by x."""
    from vaex_tpu_torch.ops.binners import BinnerScalar, fuse_bins
    from vaex_tpu_torch.ops.nullable import NA
    plain = binby_plain(cols)
    for name, query in binby_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] binby {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    results = {}
    for shape, route, kernel in ((1024, plan.B3X_L2, gp.grid_resident_extreme),
                                 (2000, plan.B3X, lambda *a: gp.grid_partition_extreme(*a)[0])):
        binners = [BinnerScalar(c, *(float(m) for m in torch.aminmax(cols[c])), shape)
                   for c in ("x", "y")]
        idx = fuse_bins(binners, [b.to_bins(NA(cols[b.expression])) for b in binners])
        G = binners[0].shape * binners[1].shape
        check(plan.extreme_strategy(H2O_ROWS, G, 1) == route, f"{route} at G={G}")
        if shape == 1024:
            prolog_ms = cuda_ms(lambda: fuse_bins(binners, [b.to_bins(NA(cols[b.expression]))
                                                            for b in binners]), 3)
            print(f"[{label}] the two scalar binners and the fuse (eager torch) at shape 1024: "
                  f"{prolog_ms!r} ms", flush=True)
        results[route] = extreme_timing(kernel, (idx, [cols["v"]], ["max"], [None], G), label,
                                        f"{route} (max of v over the 2-D grid of shape {shape})",
                                        ge)
        del idx
    # b3x-l2 at q7's shape: max of v1 and min of v2 over id6's fused bins
    G7 = H2O_K6 + 3
    q7 = ((cols["id6"] + 1).to(torch.int32), [cols["v1"], cols["v2"]], ["max", "min"],
          [None, None], G7)
    check(plan.extreme_strategy(H2O_ROWS, G7, 2) == plan.B3X_L2, "q7's shape takes b3x-l2")
    at_q7 = extreme_timing(gp.grid_resident_extreme, q7, label, "b3x-l2 (q7)", ge)
    results[plan.B3X_L2].update({f"q7_{k}": at_q7[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                 "library_ms")})
    del q7
    # the route over the raw rows at the shape of minmax(v, binby=x, shape=128)
    axis = BinnerScalar("x", *(float(m) for m in torch.aminmax(cols["x"])), 128)
    direct = (axis.to_bins(NA(cols["x"])), [cols["v"]], ["max"], [None], axis.shape)
    check(gp.extreme_direct_fits(axis.shape, 1), "the 1-D grid takes the direct route")
    results[plan.B3X_DIRECT] = extreme_timing(lambda *a: gp.grid_partition_extreme(*a)[0],
                                              direct, label, "b3x-direct (max of v by x)", ge)
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "vaex_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import vaex_tpu_torch as vt
    from vaex_tpu_torch import agg
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_extreme as ge
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import kernel_build, probe

    label = card()
    print(label)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # B3x is the min/max mode of B3's source, b3-l2 its resident route
    sources = {plan.B1: "grid_additive", plan.B2: "grid_window", plan.B3: "grid_partition",
               plan.B4: "grid_moments", plan.B5: "grid_moments_window", "b6": "probe",
               plan.B3X: "grid_partition", plan.B3X_L2: "grid_partition",
               plan.B3X_DIRECT: "grid_partition", plan.B3_L2: "grid_partition"}
    for name, (path, seconds, log) in kernel_build.build(*dict.fromkeys(
            sources.values())).items():
        print(f"built {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    g_max, _ = kernel_vs_plain(ga)
    print(f"kernel vs plain passed; largest G that fits B1: {g_max}", flush=True)
    wide_kernels_vs_plain(plan, gw)
    print("wide kernels vs plain passed", flush=True)
    moment_kernels_vs_plain(plan, gm, agg)
    print("moment kernels vs plain passed", flush=True)
    probe_vs_plain(probe)
    print("probe kernel vs plain passed", flush=True)
    extreme_kernel_vs_plain(gp, ge)
    print("min/max kernel vs plain passed", flush=True)

    zero_launches(plan, gp)
    probe.probe.launches = 0
    tables = {n: main_path(n, vt) for n in MAIN_SIZES}
    main_launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    check(main_launches[plan.B1] > 0, "grid_additive was not launched during the main path")
    print(f"launches during the main path: {main_launches}", flush=True)
    results = {n: timings(n, *tables[n], vt, ga, label) for n in MAIN_SIZES}
    del tables

    h2o_df, h2o_cols, h2o_launches = h2o_path(vt, plan)
    for name in (plan.B2, plan.B3, plan.B3_L2):
        check(h2o_launches[name] > 0,
              f"{sources[name]} ({name}) was not launched during the H2O path")
    stats_launches = stats_path(vt, plan, h2o_df, h2o_cols)
    for name in (plan.B4, plan.B5):
        check(stats_launches[name] > 0,
              f"{sources[name]} was not launched during the statistics path")
    wide = h2o_timings(h2o_df, h2o_cols, vt, plan, label)
    moments = stats_timings(h2o_df, h2o_cols, vt, plan, agg, gm, label)
    del h2o_df

    sets_df, sets_cols, values, sets_launches = sets_path(vt, plan, probe, h2o_cols)
    check(sets_launches["b6"] > 0, "probe was not launched during the set-based path")
    check(sets_launches["b6-wide"] > 0,
          "the probe's b6-wide route was not launched during the set-based path")
    sets = sets_timings(sets_df, sets_cols, values, vt, probe, label)
    sets["wide_launches"] = sets_launches["b6-wide"]
    del sets_df, sets_cols

    binby_df, binby_cols, binby_launches = binby_path(vt, plan, gp, h2o_cols)
    for route in (plan.B3X_DIRECT, plan.B3X_L2, plan.B3X):
        check(binby_launches[route] > 0,
              f"B3x's route {route} was not launched during the binned-statistics path")
    check(binby_launches[plan.B3_L2] > 0,
          "b3-l2 was not launched during the binned-statistics path")
    extremes = binby_timings(binby_df, binby_cols, vt, gp, ge, plan, label)
    wide[plan.B3]["l2_launches"] = h2o_launches[plan.B3_L2]

    measured = {plan.B1: (main_launches[plan.B1], results[MAIN_SIZES[0]]),
                plan.B2: (h2o_launches[plan.B2], wide[plan.B2]),
                plan.B3: (h2o_launches[plan.B3], wide[plan.B3]),
                plan.B4: (stats_launches[plan.B4], moments[plan.B4]),
                plan.B5: (stats_launches[plan.B5], moments[plan.B5]),
                "b6": (sets_launches["b6"], sets),
                **{route: (binby_launches[route], extremes[route])
                   for route in (plan.B3X_L2, plan.B3X, plan.B3X_DIRECT)}}
    replaces = {plan.B1: "vaex_tpu/ops/pallas_gridagg.py:474",
                plan.B2: "vaex_tpu/ops/pallas_gridagg.py:239",
                plan.B3: "vaex_tpu/ops/pallas_partition.py:72",
                plan.B4: "vaex_tpu/ops/pallas_gridagg.py:45",
                plan.B5: "vaex_tpu/ops/pallas_gridagg.py:126",
                "b6": "vaex_tpu/ops/pallas_probe.py:37",
                **dict.fromkeys((plan.B3X_L2, plan.B3X, plan.B3X_DIRECT),
                                "vaex_tpu/ops/pallas_partition.py:287")}
    names = {plan.B3X_L2: "grid_resident_extreme (b3x-l2)",
             plan.B3X: "grid_partition_extreme (b3x)",
             plan.B3X_DIRECT: "grid_partition_extreme (b3x-direct)"}
    print(label)
    print(json.dumps({"kernels": [{
        "name": names.get(name, sources[name]),
        "route": "cuda",
        "source": f"vaex_tpu_torch/csrc/{sources[name]}.cu",
        "replaces": replaces[name],
        "launches": launches,
        "max_abs_err": m["err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
        **{key: value for key, value in m.items() if key in EXTRA_KEYS},
    } for name, (launches, m) in measured.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

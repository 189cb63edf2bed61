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
   N(0, 100) to rtol 1e-9 and atol 1e-9;
4. holds the wide-grid kernels B2 (grid_window) and B3 (grid_partition)
   against their plain versions the same way, with some NaN among the
   floats, at G in {B1 limit + 1, 10 609, B2 limit, B2 limit + 1, 100 003,
   1 000 003} through the kernel the plan picks (printed), plus B3 on
   pre-sorted keys at G = 1 000 003;
5. holds the moment kernels B4 (grid_moments) and B5 (grid_moments_window)
   against their plain versions, through the kernel the plan picks
   (printed), for the terms of var (an f64 column) and of corr (two f64
   columns), with NaN among both, at G in {1, 103, B4's limit at C = 6,
   that + 1, 10 609, B5's limit} and N in {0, 1, 1_000_003, 1e8}: counts
   exact, float sums to rtol 1e-9 and atol 1e-9;
6. drives the main path through the public API: a device-resident table
   of N = 1e8 and 4e8 rows (int64 key with K = 100 categories, float64
   value, made on the card from seed 42), categorize, then
   groupby(sum, count, sort=True) and df.sum, checked against
   torch.bincount / index_add_, with B1's launch count;
7. drives the wide-grid path through the public API: an H2O-groupby-shaped
   table of N = 1e8 rows made on the card from seed 42 (id4, id5 int64 in
   1..100, id6 int64 in 1..1e6, v1, v2 int64 in 1..5, v3 float64 in
   [0, 100)), the keys categorized, then q2 groupby(["id4", "id5"],
   {"v1": sum}, sort=True), count(binby=["id4", "id5"]), q3
   groupby("id6", {"v1": sum, "v3": mean}) and q5 groupby("id6",
   {"v1", "v2", "v3": sum}), each checked against torch.bincount /
   index_add_, with each kernel's launch count and the strategy each pass
   recorded;
8. drives the statistics path through the public API on the same table:
   q6's sd part groupby(["id4", "id5"], {"sd_v3": std("v3", ddof=1)},
   sort=True), q9 groupby(["id4", "id5"], {"r2": corr("v1", "v2")}), q7
   groupby("id6", {"max_v1": max("v1"), "min_v2": min("v2")}),
   df.std("v3") and df.std("v3", binby=["id4"]), each checked against
   plain torch (index_add_ of the formed moments, then the same formula;
   scatter_reduce for q7), with B4's and B5's launch counts and the
   strategies;
9. times the main-path groupby, the four wide queries and the five
   statistics against plain PyTorch (5 repetitions, medians), and every
   kernel against its plain version and against its HBM floor at the copy
   bandwidth measured in the same run;
10. holds B6 (probe) against its plain version (searchsorted, gather,
    compare): int64 and float64 keys, M in {1, 64, 500, 2048, the limit of
    its shared-memory kernel} and, through its two-level kernel for wider
    sets, M in {that limit + 1, 50 000, 1 000 003}, N in {0, 1, 1_000_003,
    1e8}, rows that hit, miss, lie below the first and above the last key,
    and -0.0 and NaN among the floats; exact;
11. drives the set-based path through the public API on the H2O-shaped
    table WITHOUT categorize: df.count(selection=df.id6.isin(v)) and
    df[df.id6.isin(v)].groupby("id4", {"v1": sum, "v3": mean}) with v = 500
    ids drawn from seed 42, the same count with 50 000 ids (a set past the
    shared-memory kernel: the two-level one), groupby over the raw id4 (dense
    grouper, B1) and
    the raw id6 (dense grouper, B3), groupby over k = id4 * 1_000_003 and
    k = (id6 % 2000) * 1_000_003 (set grouper: set build, then the ordinals
    through B6 at M = 100 and 2000) and k = id6 * 1_000_003 (M = 1e6: the
    two-level kernel, then B3), df.id6.nunique() and df.id4.unique(),
    each checked against plain torch (isin, unique, bincount, index_add_),
    with B6's launch count and the probe route each pass recorded;
12. times those queries against plain PyTorch (the dense pre-pass included
    and, beside it, remembered), and B6 at the isin shapes (500 and 50 000
    ids) against its plain version and torch.isin;
13. holds B3x (grid_partition_extreme, the min/max mode of the partitioned
    kernel) against its plain version (scatter_reduce_ with a drop bin) at G
    in {1, 103, 10 609, 67 081, 1 000 003, 1 054 729} and N in {0, 1,
    1_000_003, 1e8}: an int64 min, an f64 max with NaN, +-inf and -0.0, an
    f32 min, an f64 min and an int64 max under a validity mask, alone and
    with count + int64 + f64 sums riding the same partition; extremes exact
    by value, int sums exact, float sums to rtol 1e-9;
14. drives the binned-statistics path through the public API: beside the
    H2O-shaped columns (id4 and id6 categorized) x, y float64 normal, v
    float64 uniform in [0, 100) with 1% NaN and t int64, made on the card
    from seed 42, 1e8 rows: limits(["x", "y"], "minmax"), limits("x",
    "99.7%"), count(binby=[x, y], shape=256), mean(v, binby=[x, y],
    shape=1024), max(v, binby=[x, y], shape=1024) (G = 1 054 729),
    minmax(v, binby=x, shape=128), q7 on id6, groupby(id6, {sum v1, max v1,
    min v2}) (sums and extremes from one scatter) and first(v, t,
    binby=id4), each checked against plain torch on the same tensors, with
    the route each pass recorded and B3x's launch count;
15. times those queries against plain PyTorch, and B3x at the shape of the
    2-D max against its plain version and scatter_reduce_.

It exits non-zero on any failure.  The line before the last is a JSON
object with every kernel's launches, error, times, bound (the larger of the
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
# beside the keys every kernel has: the index_add_ alone for B4 and B5; for
# B6 torch.isin and its two-level kernel at the wide isin shape
EXTRA_KEYS = ("library_add_ms", "isin_ms", "wide_launches", "wide_ms", "wide_plain_ms",
              "wide_library_ms", "wide_isin_ms", "wide_bound_ms", "wide_max_abs_err")
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
            print(f"kernel vs plain G={G} N={n}: ints exact, f64 max abs err {err!r}",
                  flush=True)
    return g_max, worst


def wide_kernels_vs_plain(plan, gw):
    """Phase 4: B2 and B3 against their plain versions; returns the worst
    float error of each."""
    C = 3  # count + one int + one float column
    b2_limit = plan.B2_MAX_WINDOWS * gw.window_width(C)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {plan.B2: 0.0, plan.B3: 0.0}
    for G in (plan.B1_MAX_G + 1, 10_609, b2_limit, b2_limit + 1, 100_003, 1_000_003):
        name = plan.strategy(max(KERNEL_SIZES), G, 1, 1, True)
        print(f"plan at G={G} (count + int64 + f64): {name}", flush=True)
        check(name in (plan.B2, plan.B3), f"a wide kernel at G={G}")
        for n in KERNEL_SIZES:
            err = same_sums(plan.KERNELS[name], plan.PLAIN[name],
                            *random_inputs(gen, n, G, nan=True), G, f"{name} G={G} N={n}")
            worst[name] = max(worst[name], err)
            print(f"{name} vs plain G={G} N={n}: ints exact, f64 max abs err {err!r}",
                  flush=True)
    G = 1_000_003
    idx, ints, floats = random_inputs(gen, max(KERNEL_SIZES), G, nan=True)
    idx = torch.sort(idx).values
    check(plan.strategy(idx.numel(), G, 1, 1, True) == plan.B3, "sorted keys plan")
    err = same_sums(plan.KERNELS[plan.B3], plan.PLAIN[plan.B3], idx, ints, floats, G,
                    f"b3 sorted keys G={G}")
    worst[plan.B3] = max(worst[plan.B3], err)
    print(f"b3 vs plain on pre-sorted keys G={G} N={idx.numel()}: ints exact, no "
          f"demotion, f64 max abs err {err!r}", flush=True)
    return worst


def moment_kernels_vs_plain(plan, gw, agg):
    """Phase 5: B4 and B5 against their plain versions; returns the worst
    float error of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {plan.B4: 0.0, plan.B5: 0.0}
    b4_limit = plan.b4_max_g(6)
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        C = len(terms)
        b5_limit = plan.B5_MAX_WINDOWS * gw.window_width(C)
        for G in (1, 103, b4_limit, b4_limit + 1, 10_609, b5_limit):
            name = plan.moment_strategy(max(KERNEL_SIZES), G, C)
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
    df, i1, x = make_table(n, vt)
    out = run_query(df, vt)
    torch.cuda.synchronize()
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
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    }


def h2o_plain(cols):
    """The same four answers in plain torch: bincount and index_add_."""
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
            v1, v2, v3 = want
            check((out.evaluate("v1") == host(v1)).all(), "q5 v1 sums exact")
            check((out.evaluate("v2") == host(v2)).all(), "q5 v2 sums exact")
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), v3.cpu(), rtol=RTOL,
                                 atol=ATOL), "q5 v3 sums")


def h2o_path(vt, plan):
    """Phase 7: the four queries once, checked; returns the table and the
    launches of each kernel during them."""
    df, cols = make_h2o(vt)
    plain = h2o_plain(cols)
    for kernel in plan.KERNELS.values():
        kernel.launches = 0
    outs = {}
    for name, query in h2o_queries(vt).items():
        outs[name] = query(df)
        print(f"H2O {name} N={H2O_ROWS}: pass strategies "
              f"{df.executor.trace_log[-1]['strategies']}", flush=True)
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


def stats_path(vt, plan, df, cols):
    """Phase 8: the statistics once, checked; returns the launches of each
    kernel during them."""
    plain = stats_plain(cols)
    kernels = {**plan.KERNELS, **plan.MOMENT_KERNELS}
    for kernel in kernels.values():
        kernel.launches = 0
    outs = {}
    for name, query in stats_queries(vt).items():
        outs[name] = query(df)
        print(f"stats {name} N={H2O_ROWS}: pass strategies "
              f"{df.executor.trace_log[-1]['strategies']}", flush=True)
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
    }
    results = {}
    for name, (idx, G, bases, terms, bytes_per_row, bytes_note) in shapes.items():
        check(plan.moment_strategy(H2O_ROWS, G, len(terms)) == name, f"{name} at G={G}")
        args = (idx, bases, terms, G)
        kernel_ms = cuda_ms(lambda: plan.MOMENT_KERNELS[name](*args), 5)
        plain_ms = cuda_ms(lambda: plan.MOMENT_PLAIN[name](*args), 2)
        got = plan.MOMENT_KERNELS[name](*args)
        want = plan.MOMENT_PLAIN[name](*args)
        check(torch.equal(got[0], want[0]), f"{name} counts at the query shape")
        check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"{name} sums")
        err = (got[1] - want[1]).abs().max().item()
        floor_ms = H2O_ROWS * bytes_per_row / copy_bw * 1e3
        print(f"[{label}] {name} N={H2O_ROWS} G={G} ({len(terms)} terms): kernel {kernel_ms!r} "
              f"ms vs plain {plain_ms!r} ms; HBM floor at {bytes_per_row} B/row ({bytes_note}) "
              f"{floor_ms!r} ms, kernel at {floor_ms / kernel_ms!r} of it; max abs err {err!r}",
              flush=True)
        # in: idx and the base columns; out: one 8-byte row of G per term;
        # a multiply and an add per float term, an add per count term
        n_float = sum(a >= 0 for a, *_ in terms)
        bound_ms, bound_by = bound(
            H2O_ROWS * bytes_per_row + 8 * len(terms) * G,
            {"f64": 2 * H2O_ROWS * n_float, "int": H2O_ROWS * (len(terms) - n_float)})
        library_ms, add_ms = library_moments_ms(idx, bases, terms, G, gm)
        print(f"[{label}] {name}: bound {bound_ms!r} ms by {bound_by} at "
              f"{PEAK_BYTES / 1e12} TB/s; formed terms + one index_add_ of the [N, "
              f"{len(terms)}] float64 matrix (the library call) {library_ms!r} ms, the "
              f"index_add_ alone {add_ms!r} ms", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "library_add_ms": add_ms}
        del idx
    return results


def h2o_timings(df, cols, vt, plan, label):
    """Phase 9 for the wide path: query medians and B2/B3 kernel times."""
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
        del idx
    return results

# ------------------------------------------------------- the set-based path
def probe_inputs(gen, n, M, float_keys):
    """M sorted unique keys and n rows: hits, misses, rows below the first
    and above the last key and, for floats, -0.0 and NaN."""
    keys = torch.randperm(4 * M, generator=gen, device="cuda")[:M].sort().values - M
    x = torch.randint(-M - 5, 3 * M + 6, (n,), generator=gen, device="cuda", dtype=torch.int64)
    if float_keys:
        keys, x = keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5
        x[::7] = -0.0
        x[3::11] = float("nan")
    return keys, x


def probe_vs_plain(probe):
    """Phase 10: B6 against its plain version, exact; returns the largest
    difference of any ordinal (0 when every check passed)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0
    for float_keys in (False, True):
        for M in (1, 64, 500, 2048, probe.MAX_KEYS, probe.MAX_KEYS + 1, 50_000, 1_000_003):
            for n in KERNEL_SIZES:
                keys, x = probe_inputs(gen, n, M, float_keys)
                before = probe.probe.wide_launches
                got = probe.probe(keys, x)
                want = probe.probe_reference(keys, x)
                torch.cuda.synchronize()
                wide = M > probe.MAX_KEYS
                what = f"b6{'-wide' if wide else ''} {keys.dtype} M={M} N={n}"
                check(probe.probe.wide_launches - before == int(wide),
                      f"the kernel of the set's size, {what}")
                diff = int((got - want).abs().max()) if n else 0
                worst = max(worst, diff)
                check(got.dtype == torch.int32 and torch.equal(got, want), f"ordinals, {what}")
                hits = int((got >= 0).sum())
                if float_keys and n > 11:
                    check(bool((got[torch.isnan(x)] == -1).all()), f"NaN rows give -1, {what}")
                    zero = torch.nonzero(keys == 0)
                    if zero.numel():
                        check(bool((got[torch.signbit(x) & (x == 0)] == int(zero[0])).all()),
                              f"-0.0 rows find the key 0.0, {what}")
                print(f"{what} vs plain: exact, {hits} rows hit", flush=True)
                del keys, x, got, want
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
SETS_EXPECT = {"isin count": ("b6", "b1"), "isin wide count": ("b6-wide", "b1"),
               "isin groupby": ("b6", "b1"), "raw id4": (None, "b1"), "raw id6": (None, "b3"),
               "set k100": ("b6", "b1"), "set k2000": ("b6", "b2"),
               "set k1e6": ("b6-wide", "b3"),
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
        outs[name] = query(df)
        log = df.executor.trace_log[-1]
        route, kernel = SETS_EXPECT[name]
        additive = [s.get("additive") for s in log["strategies"]]
        print(f"sets {name} N={H2O_ROWS}: last pass probe {log['probe']}, strategies "
              f"{log['strategies']}, B6 launches {probe.probe.launches - before}", flush=True)
        check(log["probe"] == route, f"{name}: probe route {log['probe']}, expected {route}")
        check(additive == ([kernel] if kernel else []), f"{name}: additive kernels {additive}")
        check((probe.probe.launches > before) == (route is not None), f"{name}: B6 launches")
        check((probe.probe.wide_launches > before_wide) == (route == "b6-wide"),
              f"{name}: launches of B6's two-level kernel")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    launches["b6-wide"] = probe.probe.wide_launches
    for name, out in outs.items():
        sets_check(name, out, plain[name]())
        print(f"sets {name}: checked against plain torch (ints and keys exact, floats rtol "
              f"{RTOL})", flush=True)
    print(f"launches during the set-based path: {launches}", flush=True)
    return df, cols, values, launches


def sets_timings(df, cols, values, vt, probe, setops, label):
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

    def library_probe(keys):
        # the PyTorch calls that compute the kernel's function
        idx = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
        return torch.where(keys[idx] == x, idx, -1).to(torch.int32)
    results = {}
    for name, ids in values.items():
        keys = torch.as_tensor(ids, device="cuda").sort().values
        M = keys.numel()
        kernel_ms = cuda_ms(lambda: probe.probe(keys, x), 5)
        plain_ms = cuda_ms(lambda: probe.probe_reference(keys, x), 2)
        library_ms = cuda_ms(lambda: library_probe(keys), 2)
        isin_ms = cuda_ms(lambda: torch.isin(x, keys), 2)
        got, want = probe.probe(keys, x), probe.probe_reference(keys, x)
        check(torch.equal(got, want), f"b6 at the {name} shape")
        check(torch.equal(got, library_probe(keys)), f"b6 equals the library calls, {name}")
        check(torch.equal(got >= 0, torch.isin(x, keys)), "b6 membership equals torch.isin")
        err = float((got - want).abs().max())
        # in: the rows and the keys; out: an int32 per row; a compare per level
        # of the search and one for equality
        bound_ms, bound_by = bound(H2O_ROWS * 12 + 8 * M,
                                   {"int": H2O_ROWS * (M.bit_length() + 1)})
        floor_ms = H2O_ROWS * 12 / copy_bw * 1e3
        print(f"[{label}] {setops.probe_route(M)} N={H2O_ROWS} M={M} (int64 id6 among the "
              f"{name} values): kernel {kernel_ms!r} ms vs plain (searchsorted + gather + "
              f"compare) {plain_ms!r} ms, the same as library calls {library_ms!r} ms, "
              f"torch.isin (membership only) {isin_ms!r} ms; HBM floor at 12 B/row (x 8 + out "
              f"4) {floor_ms!r} ms at the copy bandwidth, kernel at {floor_ms / kernel_ms!r} of "
              f"it; bound {bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s; max abs "
              f"err {err!r}", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "isin_ms": isin_ms}
        del keys, got, want
    for key, M_set in SET_KEYS.items():
        set_keys = torch.unique(cols[key])
        check(set_keys.numel() == M_set, f"{key} has {M_set} distinct values")
        ms = cuda_ms(lambda: probe.probe(set_keys, cols[key]), 5)
        p_ms = cuda_ms(lambda: probe.probe_reference(set_keys, cols[key]), 2)
        print(f"[{label}] {setops.probe_route(M_set)} N={H2O_ROWS} M={M_set} (the set grouper "
              f"of {key}): kernel {ms!r} ms vs plain {p_ms!r} ms", flush=True)
    # the entry of the kernels line: the shared-memory kernel at the isin
    # shape, the two-level kernel at the wide isin shape beside it
    wide = results["isin wide"]
    return {**results["isin"], "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
            "wide_library_ms": wide["library_ms"], "wide_isin_ms": wide["isin_ms"],
            "wide_bound_ms": wide["bound_ms"], "wide_max_abs_err": wide["err"]}


# ------------------------------------------------- the binned-statistics path
EXTREME_GS = (1, 103, 10_609, 67_081, 1_000_003, 1_054_729)
BINBY_EXPECT = {  # what the last pass of each query must record
    "max 2-D 1024": {"extremes": "b3x"},
    "minmax by x 128": {"extremes": "b3x-direct"},
    "q7": {"extremes": "b3x"},
    "sum max min by id6": {"additive": "b3", "extremes": "b3x", "scatter": "shared"},
    "first by id4": {"first": "b3x-direct"},
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
        for G in EXTREME_GS:
            idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
            got, _, _ = gp.grid_partition_extreme(idx, cols, modes, valids, G)
            both, int_sums, float_sums = gp.grid_partition_extreme(
                idx, cols, modes, valids, G, [ints], [summed], True)
            want_i, want_f = gp.grid_partition_reference(idx, [ints], [summed], G, True)
            torch.cuda.synchronize()
            what = f"b3x G={G} N={n}"
            for k, (a, b, w) in enumerate(zip(got, both, want)):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"{modes[k]} of {w.dtype} column {k} alone, {what}")
                check(b.dtype == w.dtype and torch.equal(b, w),
                      f"{modes[k]} of {w.dtype} column {k} beside sums, {what}")
            check(torch.equal(int_sums, want_i), f"int sums beside extremes, {what}")
            check(torch.allclose(float_sums, want_f, rtol=RTOL, atol=ATOL),
                  f"f64 sums beside extremes, {what}")
            err = (float_sums - want_f).abs().max().item() if n else 0.0
            worst = max(worst, err)
            route = "b3x-direct" if gp.extreme_direct_fits(G, len(cols)) else "b3x"
            print(f"{what} vs plain: five extremes exact alone ({route}) and beside sums "
                  f"(b3x), int sums exact, f64 sums max abs err {err!r}", flush=True)
            del idx, want, got, both
    return worst


def make_binby(vt, cols):
    """The H2O-shaped columns (id4, id6 categorized) beside continuous axes
    x, y, a value v with 1% NaN and an order column t, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = H2O_ROWS
    new = {"x": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "y": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "v": torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100,
           "t": torch.randint(0, 2 ** 62, (n,), generator=gen, device="cuda", dtype=torch.int64)}
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
        "minmax by x 128": lambda df: df.minmax("v", binby="x", shape=128),
        "q7": lambda df: df.groupby("id6", agg={"max_v1": a.max("v1"), "min_v2": a.min("v2")}),
        "sum max min by id6": lambda df: df.groupby(
            "id6", agg={"s": a.sum("v1"), "hi": a.max("v1"), "lo": a.min("v2")}),
        "first by id4": lambda df: df.first("v", "t", binby="id4"),
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

    def first():
        ok = ~torch.isnan(v)
        order = t.to(f64)  # the order is compared as float64
        best = torch.full((H2O_K,), float("inf"), dtype=f64, device="cuda")
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
        "minmax by x 128": lambda: minmax1d(128),
        "q7": lambda: (extreme(id6, cols["v1"], H2O_K6, "amax"),
                       extreme(id6, cols["v2"], H2O_K6, "amin")),
        "sum max min by id6": lambda: (
            torch.zeros(H2O_K6, dtype=torch.int64, device="cuda").index_add_(0, id6, cols["v1"]),
            extreme(id6, cols["v1"], H2O_K6, "amax"), extreme(id6, cols["v2"], H2O_K6, "amin")),
        "first by id4": first,
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
    elif name in ("max 2-D 1024", "minmax by x 128", "first by id4"):
        same(out, want, f"{name} exact")
    else:
        names = ["max_v1", "min_v2"] if name == "q7" else ["s", "hi", "lo"]
        for column, w in zip(names, want):
            same(out.evaluate(column), w, f"{name} {column} exact")
        check(out.evaluate(names[0]).dtype.name == "int64", f"{name} keeps int64")


def binby_path(vt, plan, gp, cols):
    """Phase 14: the binned statistics once, checked; returns the table and
    the launches of each kernel during them."""
    df, cols = make_binby(vt, cols)
    plain = binby_plain(cols)
    kernels = {**plan.KERNELS, **plan.MOMENT_KERNELS, plan.B3X: gp.grid_partition_extreme}
    for kernel in kernels.values():
        kernel.launches = 0
    outs = {}
    for name, query in binby_queries(vt).items():
        before = gp.grid_partition_extreme.launches
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        print(f"binby {name} N={H2O_ROWS}: pass strategies {strategies}, B3x launches "
              f"{gp.grid_partition_extreme.launches - before}", flush=True)
        if name in BINBY_EXPECT:
            check(strategies == [BINBY_EXPECT[name]],
                  f"{name}: strategies {strategies}, expected {BINBY_EXPECT[name]}")
            check(gp.grid_partition_extreme.launches > before, f"{name}: B3x launches")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    for name, out in outs.items():
        binby_check(name, out, plain[name]())
        print(f"binby {name}: checked against plain torch (counts, extremes and first exact, "
              f"floats rtol {RTOL})", flush=True)
    print(f"launches during the binned-statistics path: {launches}", flush=True)
    return df, cols, launches


def binby_timings(df, cols, vt, gp, ge, label):
    """Phase 15: query medians, and B3x at the shape of the 2-D max (G =
    1 054 729, one f64 column with NaN) against its plain version and
    scatter_reduce_ alone."""
    from vaex_tpu_torch.ops.binners import BinnerScalar, fuse_bins
    from vaex_tpu_torch.ops.nullable import NA
    plain = binby_plain(cols)
    for name, query in binby_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] binby {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    binners = [BinnerScalar(c, *(float(m) for m in torch.aminmax(cols[c])), 1024)
               for c in ("x", "y")]
    prolog_ms = cuda_ms(lambda: fuse_bins(binners, [b.to_bins(NA(cols[b.expression]))
                                                    for b in binners]), 3)
    idx = fuse_bins(binners, [b.to_bins(NA(cols[b.expression])) for b in binners])
    G = binners[0].shape * binners[1].shape
    args = (idx, [cols["v"]], ["max"], [None], G)
    kernel_ms = cuda_ms(lambda: gp.grid_partition_extreme(*args), 5)
    plain_ms = cuda_ms(lambda: ge.grid_extreme_batch(*args), 2)
    got = gp.grid_partition_extreme(*args)[0][0]
    want = ge.grid_extreme_batch(*args)[0]
    check(torch.equal(got, want), "b3x at the query shape")
    # the library call alone: the bins as int64, the NaN rows sent to a drop bin
    bins = ge.extreme_bins(idx, G).masked_fill(torch.isnan(cols["v"]), G)

    def library():
        out = torch.full((G + 1,), float("-inf"), dtype=torch.float64, device="cuda")
        return out.scatter_reduce_(0, bins, cols["v"], "amax", include_self=True)
    library_ms = cuda_ms(library, 2)
    check(torch.equal(library()[:G], want), "b3x equals scatter_reduce_")
    # in: idx 4 B and the column 8 B per row; out: the grid; a compare per row
    bound_ms, bound_by = bound(H2O_ROWS * 12 + 8 * G, {"f64": H2O_ROWS})
    copy_bw, _ = copy_bandwidth(cols["v"])
    floor_ms = H2O_ROWS * 12 / copy_bw * 1e3
    print(f"[{label}] b3x N={H2O_ROWS} G={G} (max of v over the 2-D grid): kernel {kernel_ms!r} "
          f"ms vs plain {plain_ms!r} ms, scatter_reduce_ alone (the library call) "
          f"{library_ms!r} ms; HBM floor at 12 B/row {floor_ms!r} ms at the copy bandwidth, "
          f"kernel at {floor_ms / kernel_ms!r} of it; bound {bound_ms!r} ms by {bound_by} at "
          f"{PEAK_BYTES / 1e12} TB/s; the two scalar binners and the fuse (eager torch) "
          f"{prolog_ms!r} ms", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": 0.0, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    from vaex_tpu_torch.ops import kernel_build, probe, setops

    label = card()
    print(label)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    sources = {plan.B1: "grid_additive", plan.B2: "grid_window", plan.B3: "grid_partition",
               plan.B4: "grid_moments", plan.B5: "grid_moments_window", "b6": "probe",
               plan.B3X: "grid_partition"}  # B3x is the min/max mode of B3's source
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
    moment_kernels_vs_plain(plan, gw, agg)
    print("moment kernels vs plain passed", flush=True)
    probe_vs_plain(probe)
    print("probe kernel vs plain passed", flush=True)
    extreme_kernel_vs_plain(gp, ge)
    print("min/max kernel vs plain passed", flush=True)

    for kernel in (*plan.KERNELS.values(), *plan.MOMENT_KERNELS.values(), probe.probe,
                   gp.grid_partition_extreme):
        kernel.launches = 0
    tables = {n: main_path(n, vt) for n in MAIN_SIZES}
    main_launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    check(main_launches[plan.B1] > 0, "grid_additive was not launched during the main path")
    print(f"launches during the main path: {main_launches}", flush=True)
    results = {n: timings(n, *tables[n], vt, ga, label) for n in MAIN_SIZES}
    del tables

    h2o_df, h2o_cols, h2o_launches = h2o_path(vt, plan)
    for name in (plan.B2, plan.B3):
        check(h2o_launches[name] > 0, f"{sources[name]} was not launched during the H2O path")
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
          "the probe's two-level kernel was not launched during the set-based path")
    sets = sets_timings(sets_df, sets_cols, values, vt, probe, setops, label)
    sets["wide_launches"] = sets_launches["b6-wide"]
    del sets_df, sets_cols

    binby_df, binby_cols, binby_launches = binby_path(vt, plan, gp, h2o_cols)
    check(binby_launches[plan.B3X] > 0,
          "grid_partition_extreme was not launched during the binned-statistics path")
    extremes = binby_timings(binby_df, binby_cols, vt, gp, ge, label)

    measured = {plan.B1: (main_launches[plan.B1], results[MAIN_SIZES[0]]),
                plan.B2: (h2o_launches[plan.B2], wide[plan.B2]),
                plan.B3: (h2o_launches[plan.B3], wide[plan.B3]),
                plan.B4: (stats_launches[plan.B4], moments[plan.B4]),
                plan.B5: (stats_launches[plan.B5], moments[plan.B5]),
                "b6": (sets_launches["b6"], sets),
                plan.B3X: (binby_launches[plan.B3X], extremes)}
    replaces = {plan.B1: "vaex_tpu/ops/pallas_gridagg.py:474",
                plan.B2: "vaex_tpu/ops/pallas_gridagg.py:239",
                plan.B3: "vaex_tpu/ops/pallas_partition.py:72",
                plan.B4: "vaex_tpu/ops/pallas_gridagg.py:45",
                plan.B5: "vaex_tpu/ops/pallas_gridagg.py:126",
                "b6": "vaex_tpu/ops/pallas_probe.py:37",
                plan.B3X: "vaex_tpu/ops/pallas_partition.py:287"}
    print(label)
    print(json.dumps({"kernels": [{
        "name": "grid_partition_extreme" if name == plan.B3X else sources[name],
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vaex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds the five grid kernels from vaex_tpu_torch/csrc with nvcc, one
   nvcc per source, all at once;
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
   bandwidth measured in the same run.

It exits non-zero on any failure.  The line before the last is a JSON
object with every kernel's launches, error and times; the last line is
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
    return kernel_ms, plain_ms, err


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


def stats_timings(df, cols, vt, plan, agg, label):
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
        results[name] = (kernel_ms, plain_ms, err)
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
        results[name] = (kernel_ms, plain_ms, err)
        del idx
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
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build

    label = card()
    print(label)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    sources = {plan.B1: "grid_additive", plan.B2: "grid_window", plan.B3: "grid_partition",
               plan.B4: "grid_moments", plan.B5: "grid_moments_window"}
    for name, (path, seconds, log) in kernel_build.build(*sources.values()).items():
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

    for kernel in (*plan.KERNELS.values(), *plan.MOMENT_KERNELS.values()):
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
    moments = stats_timings(h2o_df, h2o_cols, vt, plan, agg, label)

    kernel_ms, plain_ms, err = results[MAIN_SIZES[0]]
    measured = {plan.B1: (main_launches[plan.B1], err, kernel_ms, plain_ms),
                plan.B2: (h2o_launches[plan.B2], *wide[plan.B2][2:], *wide[plan.B2][:2]),
                plan.B3: (h2o_launches[plan.B3], *wide[plan.B3][2:], *wide[plan.B3][:2]),
                plan.B4: (stats_launches[plan.B4], *moments[plan.B4][2:],
                          *moments[plan.B4][:2]),
                plan.B5: (stats_launches[plan.B5], *moments[plan.B5][2:],
                          *moments[plan.B5][:2])}
    replaces = {plan.B1: "vaex_tpu/ops/pallas_gridagg.py:474",
                plan.B2: "vaex_tpu/ops/pallas_gridagg.py:239",
                plan.B3: "vaex_tpu/ops/pallas_partition.py:72",
                plan.B4: "vaex_tpu/ops/pallas_gridagg.py:45",
                plan.B5: "vaex_tpu/ops/pallas_gridagg.py:126"}
    print(json.dumps({"kernels": [{
        "name": sources[name],
        "route": "cuda",
        "source": f"vaex_tpu_torch/csrc/{sources[name]}.cu",
        "replaces": replaces[name],
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": p_ms,
    } for name, (launches, err, ms, p_ms) in measured.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

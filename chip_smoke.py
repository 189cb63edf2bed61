#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vaex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds the three grid kernels from vaex_tpu_torch/csrc with nvcc, one
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
5. drives the main path through the public API: a device-resident table
   of N = 1e8 and 4e8 rows (int64 key with K = 100 categories, float64
   value, made on the card from seed 42), categorize, then
   groupby(sum, count, sort=True) and df.sum, checked against
   torch.bincount / index_add_, with B1's launch count;
6. drives the wide-grid path through the public API: an H2O-groupby-shaped
   table of N = 1e8 rows made on the card from seed 42 (id4, id5 int64 in
   1..100, id6 int64 in 1..1e6, v1, v2 int64 in 1..5, v3 float64 in
   [0, 100)), the keys categorized, then q2 groupby(["id4", "id5"],
   {"v1": sum}, sort=True), count(binby=["id4", "id5"]), q3
   groupby("id6", {"v1": sum, "v3": mean}) and q5 groupby("id6",
   {"v1", "v2", "v3": sum}), each checked against torch.bincount /
   index_add_, with each kernel's launch count and the strategy each pass
   recorded;
7. times the main-path groupby and the four wide queries against plain
   PyTorch (5 repetitions, medians), and every kernel against its plain
   version and against its HBM floor at the copy bandwidth measured in
   the same run.

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
    """Phase 5 at one size: the query through the public API, checked."""
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
    """Phase 7 at one main-path size: end-to-end query and B1 times, in turns."""
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
    """Phase 6: the four queries once, checked; returns the table and the
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


def h2o_timings(df, cols, vt, plan, label):
    """Phase 7 for the wide path: query medians and B2/B3 kernel times."""
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
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build

    label = card()
    print(label)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    sources = {plan.B1: "grid_additive", plan.B2: "grid_window", plan.B3: "grid_partition"}
    for name, (path, seconds, log) in kernel_build.build(*sources.values()).items():
        print(f"built {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    g_max, _ = kernel_vs_plain(ga)
    print(f"kernel vs plain passed; largest G that fits B1: {g_max}", flush=True)
    wide_kernels_vs_plain(plan, gw)
    print("wide kernels vs plain passed", flush=True)

    for kernel in plan.KERNELS.values():
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
    wide = h2o_timings(h2o_df, h2o_cols, vt, plan, label)

    kernel_ms, plain_ms, err = results[MAIN_SIZES[0]]
    measured = {plan.B1: (main_launches[plan.B1], err, kernel_ms, plain_ms),
                plan.B2: (h2o_launches[plan.B2], *wide[plan.B2][2:], *wide[plan.B2][:2]),
                plan.B3: (h2o_launches[plan.B3], *wide[plan.B3][2:], *wide[plan.B3][:2])}
    replaces = {plan.B1: "vaex_tpu/ops/pallas_gridagg.py:474",
                plan.B2: "vaex_tpu/ops/pallas_gridagg.py:239",
                plan.B3: "vaex_tpu/ops/pallas_partition.py:72"}
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

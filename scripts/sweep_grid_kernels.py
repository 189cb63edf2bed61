#!/usr/bin/env python3
"""Times the grid kernels against each other across G, on one GPU, to set
the cut-offs of vaex_tpu_torch/ops/grid_plan.py.

    python3 scripts/sweep_grid_kernels.py [N]              (default N = 1e8)
    python3 scripts/sweep_grid_kernels.py [N] --moments
    python3 scripts/sweep_grid_kernels.py [N] --extremes

Builds every kernel (one nvcc per source, all at once), checks each
against the plain index_add_ version at N = 1_000_003 (ints exact, floats
to rtol 1e-9), then times, with CUDA events, B1 (where its grid fits, at
1 and 4 rows per lane and warp step), B2
(up to 256 windows) and B3, at N rows of uniform keys, for C = 2 (count + f64), 3 (count + int64 + f64) and 4
(count + 2 int64 + f64) channels.  Prints one line per (C, G) and exits
non-zero on a mismatch.

``--moments`` sweeps the moment kernels instead, the source of
``moment_strategy``'s cut-offs: it checks B4 and B5 against their plain
versions at N = 1_000_003 (counts exact, floats to rtol 1e-9; it stops
there on a mismatch), then times B4 (where its grid fits), B5 (up to 64
windows), B3 over the formed term columns and, at a few G, the plain
version, for C = 3 (var of an f64 column: x, x*x, count) and C = 6 (corr of
two int64 columns, as H2O's q9: x*y, x, y, x*x, y*y, count), with a NaN
in every 97th f64 value.

``--extremes`` sweeps the min/max kernel B3x, the source of
``extreme_strategy``'s routes: it checks B3x against its plain version
(``scatter_reduce_`` with a drop bin) at N = 1_000_003 for int64, f64 (NaN,
+-inf, -0.0), f32, a validity and sums riding along, by value; then times,
for E = 1, 2 and 4 f64 columns (min, max alternating; a NaN in every 97th
value) across G: B3x as the plan routes it, B3x forced through the
partition where the direct route would fit, and ``scatter_reduce_`` per
column; and, from G = 32 768 on, count + f64 sum on B3 and one max on B3x
as two calls against one call that shares the scatter.
"""

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GS = (103, 256, 512, 1024, 4096, 10609, 32768, 100003, 200003, 300003, 500003, 1000003)


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


MOMENT_GS = (1, 8, 16, 32, 64, 103, 128, 256, 512, 1024, 3968, 10609, 32768, 65536, 100003,
             200003, 1000003)


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


def sweep_moments(n, gen):
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_window as gw
    for C in (3, 6):
        for G in (103, 3968, 10609, 100003):
            idx = torch.randint(0, G + G // 8 + 1, (1_000_003,), generator=gen, device="cuda",
                                dtype=torch.int32)
            bases, terms = moment_inputs(1_000_003, C, gen)
            want = gm.grid_moments_reference(idx, bases, terms, G)
            for kern in ((gm.grid_moments,) if gm.fits(G, C) else ()) + (
                    gm.grid_moments_window,):
                got = kern(idx, bases, terms, G)
                torch.cuda.synchronize()
                ok = torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1],
                                                                     rtol=1e-9, atol=1e-9)
                print(f"check C={C} G={G} {kern.__name__}: {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                if not ok:
                    return 1
    for C in (3, 6):
        bases, terms = moment_inputs(n, C, gen)
        for G in MOMENT_GS:
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            row = {}
            if gm.fits(G, C):
                row["b4"] = cuda_ms(lambda: gm.grid_moments(idx, bases, terms, G))
            if gw.n_windows(G, C) <= 64:
                row["b5"] = cuda_ms(lambda: gm.grid_moments_window(idx, bases, terms, G))

            def b3():
                counts, floats = gm.form_terms(idx, bases, terms)
                return gp.grid_partition(idx, counts, floats, G, False)
            row["b3"] = cuda_ms(b3)
            if G in (1, 103, 10609, 1000003):
                row["plain"] = cuda_ms(lambda: gm.grid_moments_reference(idx, bases, terms, G), 1)
            print(f"moments C={C} G={G} N={n} windows={gw.n_windows(G, C)}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
    return 0


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


def sweep_extremes(n, gen):
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
    for G in (1, 103, 10609, 67081, 1000003):
        idx = torch.randint(-2, G + G // 8 + 1, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
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
            print(f"check G={G} b3x {route}: {'MISMATCH in ' + ', '.join(bad) if bad else 'ok'}",
                  flush=True)
            if bad:
                return 1
    del ints, f64, f32, valid, summed, cols
    for E in (1, 2, 4):
        cols, modes, valids = extreme_inputs(n, E, gen)
        for G in EXTREME_GS:
            idx = torch.randint(0, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
            row = {grid_plan.extreme_strategy(n, G, E): cuda_ms(
                lambda: gp.grid_partition_extreme(idx, cols, modes, valids, G))}
            if gp.extreme_direct_fits(G, E):
                planned, gp.extreme_direct_fits = gp.extreme_direct_fits, lambda G, E: False
                row["b3x forced"] = cuda_ms(
                    lambda: gp.grid_partition_extreme(idx, cols, modes, valids, G))
                gp.extreme_direct_fits = planned
            if G > 1:  # at G = 1 it is 1e8 atomics on one address: minutes
                row["scatter_reduce_"] = cuda_ms(
                    lambda: ge.grid_extreme_batch(idx, cols, modes, valids, G), 1)
            if E == 1 and G >= 32768:
                def apart():
                    gp.grid_partition(idx, [], cols, G, True)
                    gp.grid_partition_extreme(idx, cols, modes, valids, G)
                row["b3 + b3x apart"] = cuda_ms(apart)
                row["b3 + b3x shared"] = cuda_ms(lambda: gp.grid_partition_extreme(
                    idx, cols, modes, valids, G, [], cols, True))
            print(f"extremes E={E} G={G} N={n}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
    return 0


def main():
    if not torch.cuda.is_available():
        print("sweep_grid_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build
    moments = "--moments" in sys.argv
    extremes = "--extremes" in sys.argv
    args = [a for a in sys.argv[1:] if a not in ("--moments", "--extremes")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = (("grid_moments", "grid_moments_window", "grid_partition") if moments else
               ("grid_partition",) if extremes else
               ("grid_additive", "grid_window", "grid_partition"))
    for name, (path, seconds, log) in kernel_build.build(*sources).items():
        print(f"built {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}")
    n = int(float(args[0])) if args else 100_000_000
    gen = torch.Generator(device="cuda").manual_seed(42)
    if moments:
        return sweep_moments(n, gen)
    if extremes:
        return sweep_extremes(n, gen)
    bad = 0
    for G in (8182, 10609, 100003, 1000003):  # correctness, small N
        idx = torch.randint(0, G + G // 8 + 1, (1_000_003,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ints, floats = columns(1_000_003, 3, gen)
        want = ga.grid_additive_reference(idx, ints, floats, G, True)
        for kern in ((ga.grid_additive,) if ga.fits(G, 1, 1, True) else ()) + (
                gw.grid_window, gp.grid_partition):
            got = kern(idx, ints, floats, G, True)
            torch.cuda.synchronize()
            ok = torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1], rtol=1e-9,
                                                                 atol=1e-9)
            bad += not ok
            print(f"check G={G} {kern.__name__}: {'ok' if ok else 'MISMATCH'}", flush=True)
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
            if gw.n_windows(G, C) <= 256:
                row["b2"] = cuda_ms(lambda: gw.grid_window(idx, ints, floats, G, True))
            row["b3"] = cuda_ms(lambda: gp.grid_partition(idx, ints, floats, G, True))
            if G in (10609, 1000003):
                row["plain"] = cuda_ms(
                    lambda: ga.grid_additive_reference(idx, ints, floats, G, True), 1)
            print(f"C={C} G={G} N={n} windows={gw.n_windows(G, C)} "
                  f"b3 shape={tuple(gp.shape(n, G, C))}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del idx
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

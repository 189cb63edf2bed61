#!/usr/bin/env python3
"""Times the three grid kernels against each other across G, on one GPU, to
set the cut-offs of vaex_tpu_torch/ops/grid_plan.py.

    python3 scripts/sweep_grid_kernels.py [N]        (default N = 1e8)

Builds every kernel (one nvcc per source, all at once), checks each
against the plain index_add_ version at N = 1_000_003 (ints exact, floats
to rtol 1e-9), then times, with CUDA events, B1 (where its grid fits, at
1 and 4 rows per lane and warp step), B2
(up to 256 windows) and B3, at N rows of uniform keys, for C = 2 (count + f64), 3 (count + int64 + f64) and 4
(count + 2 int64 + f64) channels.  Prints one line per (C, G) and exits
non-zero on a mismatch.
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


def main():
    if not torch.cuda.is_available():
        print("sweep_grid_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import kernel_build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, (path, seconds, log) in kernel_build.build(
            "grid_additive", "grid_window", "grid_partition").items():
        print(f"built {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}")
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
    gen = torch.Generator(device="cuda").manual_seed(42)
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

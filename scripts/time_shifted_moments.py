"""Time the moment kernels B4 and B5 with a shift per base (as a pass calls
them since shifted moments), with a shift table a cell (as a statistic's
second pass calls them: each cell's mean, 8 bytes a base and bin in shared
memory), without one (the kernel's null pointer) and, with ``--baseline
DIR``, the kernels of another checkout unpacked under DIR (e.g. ``git
archive <commit> vaex_tpu_torch | tar -x -C DIR``) with a shift per base,
in turns, on the card, at the shapes of PERF.md's rows of B4 and B5:

* B4, var of an f64 column with NaN every 17th row, G = 103 and G = 1 (no
  index: df.std);
* B5, corr of two int64 columns in 1..5, and var of the f64 column, G =
  10 609 (H2O q9 and q6-sd).

    python3 scripts/time_shifted_moments.py [--baseline DIR] [N]

Every kernel is checked against its plain version first (counts exact,
floats within chip_smoke's ``within_sum_bound``).  Prints the card's name and power limit,
then a line per shape with the median of each version's times.
"""

from __future__ import annotations

import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))


def main(argv):
    from chip_smoke import _phase31_table, card, cuda_ms, first_valid, moment_sums_ok
    from vaex_tpu_torch import agg
    from vaex_tpu_torch.ops import grid_moments as gm
    old = None
    if "--baseline" in argv:
        at = argv.index("--baseline")
        from sweep_grid_kernels import load_baseline
        old = load_baseline(os.path.abspath(argv[at + 1])).grid_moments
        argv = argv[:at] + argv[at + 2:]
    n = int(float(argv[0])) if argv else 100_000_000
    label = card()
    print(label, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(42)
    v3 = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100
    v3[::17] = float("nan")
    v1, v2 = (torch.randint(1, 6, (n,), generator=gen, device="cuda") for _ in range(2))
    idx103 = torch.randint(0, 103, (n,), generator=gen, device="cuda", dtype=torch.int32)
    idx2 = torch.randint(0, 10_609, (n,), generator=gen, device="cuda", dtype=torch.int32)
    shapes = {"b4 var G=103": ("grid_moments", idx103, [v3], agg.VAR_TERMS, 103),
              "b4 var G=1 no idx": ("grid_moments", None, [v3], agg.VAR_TERMS, 1),
              "b5 corr G=10609": ("grid_moments_window", idx2, [v1, v2], agg.CORR_TERMS, 10_609),
              "b5 var G=10609": ("grid_moments_window", idx2, [v3], agg.VAR_TERMS, 10_609)}
    for shape, (kernel, idx, bases, terms, G) in shapes.items():
        shift = first_valid(bases)
        table = None if idx is None else [_phase31_table(idx, G, b) for b in bases]
        plain = (gm.grid_moments_reference if kernel == "grid_moments"
                 else gm.grid_moments_window_reference)
        versions = {"shifted": lambda: getattr(gm, kernel)(idx, bases, terms, G, shift),
                    "unshifted": lambda: getattr(gm, kernel)(idx, bases, terms, G)}
        if table is not None:
            versions["table"] = lambda: getattr(gm, kernel)(idx, bases, terms, G, table)
        if old is not None:
            versions["baseline"] = lambda: getattr(old, kernel)(idx, bases, terms, G, shift)
        given = {"shifted": shift, "table": table, "baseline": shift}
        for name, run in versions.items():
            got = run()
            want = plain(idx, bases, terms, G, given.get(name))
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and moment_sums_ok(plain, idx, bases, terms, G, got, want,
                                       given.get(name))):
                print(f"{shape} {name}: MISMATCH against the plain version", flush=True)
                return 1
        times = {name: [] for name in versions}
        order = list(versions)
        for name in order + order[::-1] + order:
            times[name].append(cuda_ms(versions[name], 5))
        print(f"[{label}] {shape} N={n}: "
              + ", ".join(f"{name} {statistics.median(t)!r} ms" for name, t in times.items())
              + " (medians of 3 turns of 5 launches)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

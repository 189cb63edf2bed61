#!/usr/bin/env python3
"""Where the device time of the port's groupbys goes, on one GPU.

    python3 scripts/profile_torch_groupby.py [N ...]    (default: 1e8 4e8)
    python3 scripts/profile_torch_groupby.py --h2o
    python3 scripts/profile_torch_groupby.py --sets
    python3 scripts/profile_torch_groupby.py --binby

The first form builds the chip_smoke.py main-path table on the card (int64
key with K = 100 categories, float64 value, seed 42) and profiles
``groupby("i1", agg={sum, count}, sort=True)``.  ``--h2o`` builds
chip_smoke.py's H2O-groupby-shaped table (1e8 rows) and profiles its q2,
2-D binby, q3 and q5 queries and the statistics q6-sd, q7, q9, df.std and
std by id4.
``--sets`` profiles chip_smoke.py's set-based queries on the same table
without categorize (isin as a selection and a filter, groupby over raw keys
through the dense and the set grouper, nunique, unique), each with its
pre-passes.  ``--binby`` profiles chip_smoke.py's binned statistics over
continuous axes on that table plus x, y, v and t (limits, 2-D count, mean
and max, minmax by x, q7, sums and extremes by id6, first).
Each query is warmed up, then run REPS times under
torch.profiler, each call ended by ``torch.cuda.synchronize()``.

Device time counts only the activities that ran on the card (kernels,
memcpy, memset), never the host-side aten operators that launched them:
the busy time is the union of those activities' intervals, and the busy
share is that union over the host wall time of the profiled calls.  Also
prints the device time per kernel name, per query, and splits it into the
port's kernels (B1-B5 with their folds, the min/max mode B3x and the probe
B6) and everything else torch ran (the binning prolog, offsets, state adds,
a set build's sorts).  Exits non-zero when the profiler saw
no device activity.
"""

import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 100
SEED = 42
REPS = 5


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


# kernel names of csrc/*.cu
GRID_KERNELS = ("grid_partials", "lane_partials", "window_cluster", "partition_count",
                "partition_scatter", "partition_sums", "resident_add", "fold_partials",
                "moment_partials", "moment_lanes", "moment_window_walk", "probe_tree",
                "partition_extremes", "resident_extremes", "fold_extremes")


def profile(label, query):
    for _ in range(2):
        query()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            query()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device])
    per_name = {}
    for e in device:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    grid = sum(us for name, us in per_name.items() if any(k in name for k in GRID_KERNELS))
    print(f"{label}: wall {wall_us / REPS / 1e3!r} ms per query (host clock), device busy "
          f"{busy / REPS / 1e3!r} ms per query, busy share {busy / wall_us!r}, "
          f"idle share {1 - busy / wall_us!r}; the port's kernels {grid / REPS / 1e3!r} ms, "
          f"other device work {(sum(per_name.values()) - grid) / REPS / 1e3!r} ms",
          flush=True)
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / REPS / 1e3:10.4f} ms  {name[:100]}")


def main_path(n, vt):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i1 = torch.randint(0, K, (n,), generator=gen, device="cuda", dtype=torch.int64)
    x = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    df = vt.from_dataset(vt.DatasetArrays({"i1": i1, "x": x})).categorize("i1", labels=range(K))
    profile(f"N={n}", lambda: df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"},
                                         sort=True))


def h2o(vt):
    import chip_smoke
    df, _ = chip_smoke.make_h2o(vt)
    stats = chip_smoke.stats_queries(vt)
    queries = {**chip_smoke.h2o_queries(vt),
               **{q: stats[q] for q in ("q6-sd", "q7", "q9", "df.std", "std by id4")}}
    for name, query in queries.items():
        profile(f"H2O {name} N={chip_smoke.H2O_ROWS}", lambda: query(df))


def sets(vt):
    import chip_smoke
    _, cols = chip_smoke.make_h2o(vt)
    df, _, values = chip_smoke.make_sets_table(vt, cols)

    def fresh(query):  # every call runs its dense pre-pass again
        df.dataset.remembered.clear()
        return query(df)
    for name, query in chip_smoke.sets_queries(vt, values).items():
        profile(f"sets {name} N={chip_smoke.H2O_ROWS}", lambda: fresh(query))


def binby(vt):
    import chip_smoke
    _, cols = chip_smoke.make_h2o(vt)
    df, _ = chip_smoke.make_binby(vt, cols)
    del cols
    for name, query in chip_smoke.binby_queries(vt).items():
        profile(f"binby {name} N={chip_smoke.H2O_ROWS}", lambda: query(df))


def main():
    if not torch.cuda.is_available():
        print("profile_torch_groupby: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import vaex_tpu_torch as vt
    if sys.argv[1:] == ["--h2o"]:
        h2o(vt)
        return 0
    if sys.argv[1:] == ["--sets"]:
        sets(vt)
        return 0
    if sys.argv[1:] == ["--binby"]:
        binby(vt)
        return 0
    for n in [int(float(a)) for a in sys.argv[1:]] or [100_000_000, 400_000_000]:
        main_path(n, vt)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time a set of queries of the checkout in the current directory on the
card, so that two checkouts (a parent and a change) run the same queries.

    cd <checkout> && python <repo>/scripts/time_queries.py --set one-sort [--reps 7]

Each set makes its tables with the checkout's own ``chip_smoke.py``:

- ``one-sort``: the one-sort groupby (``vaex_tpu_torch/fused_groupby.py``):
  config 3's q10 at 1e8 rows (six keys, the unpacked mode) and
  ``groupby(k, agg={"v1": "sum"})`` over the H2O table's wide keys k100,
  k2000, k1e6 (one word each);
- ``pass``: the single-device pass over config 1 (i1 categorized, x): the
  groupby, ``std(x)``, the 2-D count and the isin count of phase 23 on the
  staged table at 4e8 rows, and the groupby and std streamed from its first
  1e8 rows written as Arrow IPC;
- ``moments``: std at 1e8 rows where no cell is far from the frame's
  shift: a nanosecond clock (1.7e18 + [0, 100)) as uint64 and its int64
  copy, whole and binned by k in {0, 1}; H2O's q6-sd (classic B5); and
  std of v3 (float64) and of v1 (int64) by the raw key id4 * 2^23 + id5
  (the one-sort plan).

The result cache is off; each query runs once to warm up, then ``--reps``
times on the host clock to a synchronize.  Prints one JSON line: the card's
name and power limit, and per query its median ms and every run's ms.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time


def timed(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(runs), "ms": runs}


def one_sort(cs, vt, reps):
    out = {}
    df3 = vt.from_dataset(vt.DatasetArrays(cs.config3_columns(cs.CONFIG3_ROWS, "cuda")))
    q10 = cs.config3_questions(vt)["q10"]
    out["config 3 q10"] = timed(lambda: q10(df3), reps)
    cs.check(df3.executor.trace_log[-1].get("groupby") == "one-sort", "q10's route")
    del df3
    h2o_df, h2o_cols = cs.make_h2o(vt)
    del h2o_df
    sets_df, _, _ = cs.make_sets_table(vt, h2o_cols)
    for key, query in cs.sort_forms().items():
        out[f"one-sort {key}"] = timed(lambda: query(sets_df), reps)
        cs.check(sets_df.executor.trace_log[-1].get("groupby") == "one-sort", f"{key}'s route")
    return out


def single_pass(cs, vt, reps):
    out = {}
    queries = cs.phase23_queries(vt, cs.phase23_values())
    staged, _, _ = cs.make_table(cs.PHASE23_ROWS, vt)
    for name, query in queries.items():
        out[f"staged {name}"] = timed(lambda: query(staged), reps)
    del staged
    tmp = tempfile.mkdtemp(prefix="time-queries-")
    try:
        path = os.path.join(tmp, "config1.arrow")
        small, _, _ = cs.make_table(cs.PHASE23_FORMAT_ROWS, vt)
        small.export(path)
        del small
        fdf = vt.open(path).categorize("i1", labels=range(cs.K))
        for name in ("groupby", "std"):
            out[f"streamed {name}"] = timed(lambda: queries[name](fdf), reps)
        del fdf
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def moments(cs, vt, reps):
    import numpy as np
    import torch
    out = {}
    n = 100_000_000
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    k = torch.randint(0, 2, (n,), generator=gen, device="cuda", dtype=torch.int64)
    x = 1_700_000_000_000_000_000 + torch.randint(0, 100, (n,), generator=gen, device="cuda",
                                                  dtype=torch.int64)
    clock = vt.from_dataset(vt.DatasetArrays({"k": k, "x": x, "xi": x},
                                             logical={"x": np.dtype("uint64")}))
    for col, label in (("x", "uint64"), ("xi", "int64")):
        out[f"clock {label} std"] = timed(lambda: clock.std(col), reps)
        out[f"clock {label} std binned"] = timed(
            lambda: clock.std(col, binby="k", limits=[-0.5, 1.5], shape=2), reps)
    del clock, k, x
    h2o, cols = cs.make_h2o(vt)
    a = vt.agg
    out["h2o q6-sd"] = timed(lambda: h2o.groupby(["id4", "id5"],
                                                 agg={"sd_v3": a.std("v3", ddof=1)}), reps)
    del h2o
    wide = vt.from_dataset(vt.DatasetArrays({"kw": (cols["id4"] << 23) + cols["id5"],
                                             "v1": cols["v1"], "v3": cols["v3"]}))
    for col in ("v3", "v1"):
        out[f"one-sort std {col}"] = timed(
            lambda: wide.groupby("kw", agg={"sd": a.std(col, ddof=1)}), reps)
        cs.check(wide.executor.trace_log[-1].get("groupby") == "one-sort", f"{col}'s route")
    return out


SETS = {"one-sort": one_sort, "pass": single_pass, "moments": moments}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=sorted(SETS), required=True)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import vaex_tpu_torch as vt
    out = {"card": cs.card(), "checkout": os.getcwd(), "set": args.set}
    with vt.cache.off():
        out["queries"] = SETS[args.set](cs, vt, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

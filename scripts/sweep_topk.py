#!/usr/bin/env python3
"""Times the per-cell top-k's rounds kernel (``b3x-l2-topk``,
vaex_tpu_torch/csrc/grid_topk.cu) against the sort it replaces
(``agg.topk_sort``, the op's sort route) and against the per-cell max of
``b3x-l2``, on one GPU: the source of ``grid_topk.K_MAX`` and of
``grid_plan.topk_strategy``'s range.

    python3 scripts/sweep_topk.py [N]      (default N = 1e8)

First checks the kernel against the sort at q8's shape, k = 1, 2 and 8,
largest and smallest, float64 and ties-heavy int64 values: exact by value;
exits non-zero on a mismatch.  Then times, with CUDA events, one call over N
rows each (idx uniform over G cells, as H2O's id6; float64 values U[0, 100),
as v3):

* q8's shape (G = 1e6): the kernel at k = 1 .. K_MAX (16), its plain
  version at k = 1 and 2, the sort at k = 1, 2, 8 and 16, ``b3x-l2``'s
  per-cell max alone;
* int64 values 1..5 (H2O's v1: every cell's best value tied many times),
  k = 1, 2, 8;
* G from below B3x's direct route to 1e8 cells, k = 1, 2, 4, 8, 16: the
  kernel against the sort, whatever the plan would take there (``plan``
  names it); a call the card has no memory for reads "oom".

Prints the card's name and power limit, then one JSON line per time.
"""

import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from vaex_tpu_torch.agg import topk_sort  # noqa: E402
from vaex_tpu_torch.ops import grid_partition as gp  # noqa: E402
from vaex_tpu_torch.ops import grid_plan  # noqa: E402
from vaex_tpu_torch.ops import grid_topk as gt  # noqa: E402

Q8_G = 1_000_000
GS = (1_000, 24_576, 24_577, 262_144, 1_000_003, 1_468_006, 2_000_003, 4_000_037, 10_000_019,
      30_000_001, 100_000_007)
KS = (1, 2, 4, 8, 16)


def cuda_ms(fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def empty_state(G, k, dtype, largest):
    return torch.full((G, k), gt.fill(dtype, largest), dtype=dtype, device="cuda")


def sort_update(idx, values, G, largest, state):
    """The op's sort route for one tile, its blocking compaction included."""
    valid = (idx >= 0) & (idx < G)
    if values.is_floating_point():
        valid &= ~torch.isnan(values)
    return topk_sort(state, idx, values, valid, G, largest)


def guarded_ms(fn, reps):
    """cuda_ms, or "oom" when the card has no memory for the call."""
    try:
        return cuda_ms(fn, reps)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return "oom"


def rows(n, G, kind, gen):
    idx = torch.randint(1, G, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "v1":
        return idx, torch.randint(1, 6, (n,), generator=gen, device="cuda", dtype=torch.int64)
    return idx, torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100


def check(n, gen):
    ok = True
    for kind in ("v3", "v1"):
        idx, v = rows(n, Q8_G, kind, gen)
        for k in (1, 2, 8):
            for largest in (True, False):
                got = empty_state(Q8_G, k, v.dtype, largest)
                gt.grid_topk(idx, v, None, Q8_G, k, largest, got)
                want = sort_update(idx, v, Q8_G, largest, empty_state(Q8_G, k, v.dtype, largest))
                same = bool((got == want).all())
                ok &= same
                print(json.dumps({"check": kind, "k": k, "largest": largest, "same": same}),
                      flush=True)
    return ok


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(30)
    if not check(n, gen):
        print("MISMATCH", flush=True)
        sys.exit(1)

    def line(**kw):
        print(json.dumps(kw), flush=True)
    idx, v = rows(n, Q8_G, "v3", gen)
    line(at="q8", route="b3x-l2 max", ms=cuda_ms(
        lambda: gp.grid_resident_extreme(idx, [v], ["max"], [None], Q8_G)))
    for k in range(1, gt.K_MAX + 1):
        state = empty_state(Q8_G, k, v.dtype, True)
        line(at="q8", route="rounds", k=k,
             ms=cuda_ms(lambda: gt.grid_topk(idx, v, None, Q8_G, k, True, state)))
    for k in (1, 2):
        state = empty_state(Q8_G, k, v.dtype, True)
        line(at="q8", route="plain", k=k, ms=cuda_ms(
            lambda: gt.grid_topk_reference(idx, v, None, Q8_G, k, True, state), reps=2))
    for k in (1, 2, 8, 16):
        state = empty_state(Q8_G, k, v.dtype, True)
        line(at="q8", route="sort", k=k,
             ms=cuda_ms(lambda: sort_update(idx, v, Q8_G, True, state), reps=2))
    idx1, v1 = rows(n, Q8_G, "v1", gen)
    for k in (1, 2, 8):
        state = empty_state(Q8_G, k, v1.dtype, True)
        line(at="v1 ties", route="rounds", k=k,
             ms=cuda_ms(lambda: gt.grid_topk(idx1, v1, None, Q8_G, k, True, state)))
    del idx1, v1
    for G in GS:
        idx, v = rows(n, G, "v3", gen)
        for k in KS:
            state = empty_state(G, k, v.dtype, True)
            line(at="G", G=G, k=k, plan=grid_plan.topk_strategy(G, k, v.dtype, "cuda"),
                 route="rounds",
                 ms=guarded_ms(lambda: gt.grid_topk(idx, v, None, G, k, True, state), 3))
            line(at="G", G=G, k=k, route="sort",
                 ms=guarded_ms(lambda: sort_update(idx, v, G, True, state), 2))
            del state
            torch.cuda.empty_cache()
        del idx, v


if __name__ == "__main__":
    main()

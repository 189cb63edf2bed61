"""The control of ``correct``: the plain reference put in the program's
place, computed in float32, the precision below the configuration's
float64, and judged exactly as the program's answers are.  Every seed has
to come out not correct.

    python3 portbench/control.py --workload <name> --seeds 1 2 3

Prints, for each seed, each compared number beside its limit and the
verdict, then one JSON line {seed: {number: value}}.  Runs at the cell's
own size on the GPU (``--device cpu`` for a rehearsal); the benchmark's own
runs do not run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control(cell, seed, device, config=None):
    """The numbers of the float32 reference judged against the float64
    one, every question once, at ``config``'s sizes."""
    import torch
    from portbench import judge, tables
    made = tables.make(config or cell.config, seed, device, cell.root)
    numbers = {}
    for q in cell.traffic["questions"]:
        reference = cell.reference(q)
        want = reference.answer(q, made, torch.float64)
        low = reference.answer(q, made, torch.float32)
        got = {name: value for name, (kind, value, scale) in low.items()}
        judge.judge(got, want, cell.call(q).keys(q), numbers)
    return numbers


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from portbench import harness, judge
    cell = harness.Cell(args.workload, ROOT)
    out = {}
    for seed in args.seeds:
        numbers = control(cell, seed, args.device)
        checks, within = judge.verdict(numbers, cell.limits)
        out[seed] = {name: value for name, (value, _) in checks.items()}
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{n} {v!r} (limit {lim!r})" for n, (v, lim) in checks.items())
              + f"; {'PASSES: the comparison is too weak' if within else 'fails, as it must'}",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

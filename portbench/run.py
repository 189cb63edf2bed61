"""Runs one cell of the benchmark once on this machine's GPU.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints per-question lines, then one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, also the last lines of standard error).
Exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when jax, jaxlib, flax or vaex_tpu was
loaded.  A summary of the run goes to ``portbench/out/<workload>.json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from portbench import harness

    cell = harness.Cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    build = os.path.join(ROOT, "vaex_tpu_torch", "_build")
    built = len([f for f in os.listdir(build) if f.endswith(".so")]) if os.path.isdir(build) else 0
    result, summary = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_START, root=ROOT)
    summary["libraries_built_before"] = built
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules of the JAX package or JAX were loaded: {loaded}",
              file=sys.stderr)
        return 3
    out = os.path.join(ROOT, "portbench", "out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{args.workload}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for name, q in summary["questions"].items():
        print(f"portbench {args.workload} {name}: n {q['n']} median {q['median_ms']!r} ms "
              f"max {q['max_ms']!r} ms")
    print(f"portbench {args.workload}: seed {args.seed}, rounds {summary['rounds']}, window "
          f"{summary['window_s']!r} s, setup {summary['setup_s']!r} s, libraries built before "
          f"the run {built}, the statistics' second and further passes in the window "
          f"{summary['moment_passes']}, errors {summary['errors']}")
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

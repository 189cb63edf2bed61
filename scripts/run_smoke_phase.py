"""Run some of chip_smoke.py's later phases alone, from the checkout in the
current directory, on the card.

    cd <checkout> && python <repo>/scripts/run_smoke_phase.py 22 23 [24]

Builds the kernels, then runs each phase named (19, 20, 22-31: the
phases whose ``phase<N>_path`` takes no other phase's results) through the
checkout's own ``chip_smoke.py``, checks included, and prints its JSON line
as the whole script does (``{"phase23": ...}``), so that
``scripts/compare_smoke_logs.py`` reads the output of two checkouts run in
turns.
"""

from __future__ import annotations

import json
import os
import sys
import time

PHASES = (19, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)


def main(argv=None):
    phases = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    if not phases or any(p not in PHASES for p in phases):
        print(f"usage: run_smoke_phase.py PHASE... (of {PHASES})", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import vaex_tpu_torch as vt
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import kernel_build, probe
    t0 = time.perf_counter()
    kernel_build.build("grid_additive", "grid_window", "grid_partition", "grid_moments",
                       "grid_moments_window", "probe")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    label = cs.card()
    print(label, flush=True)
    for phase in phases:
        _, record = getattr(cs, f"phase{phase}_path")(vt, plan, gp, probe, label)
        print(json.dumps({f"phase{phase}": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

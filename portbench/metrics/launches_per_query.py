"""Launches of the port's hand-written kernels a query: the delta of the
``launches`` counters of the ``vaex_tpu_torch.ops`` wrappers, over the
queries."""

import importlib

COUNTERS = (("grid_additive", "grid_additive"), ("grid_window", "grid_window"),
            ("grid_partition", "grid_partition"), ("grid_partition", "grid_resident"),
            ("grid_partition", "grid_partition_extreme"),
            ("grid_partition", "grid_resident_extreme"), ("grid_moments", "grid_moments"),
            ("grid_moments", "grid_moments_window"), ("probe", "probe"))


def snapshot(ctx):
    total = 0
    for module, fn in COUNTERS:
        mod = importlib.import_module(f"vaex_tpu_torch.ops.{module}")
        total += getattr(mod, fn).launches
    return total


def read(rec):
    before, after = rec["snapshots"]["launches_per_query"]
    return (after - before) / len(rec["queries"])

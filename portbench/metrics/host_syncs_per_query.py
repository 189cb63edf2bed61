"""Blocking host reads a query: the delta of the program's
``vaex_tpu_torch.tracing.host_read.count`` (each read of a device value that
stops the host until the device drains) over the window's queries."""

import importlib


def snapshot(ctx):
    try:
        return importlib.import_module("vaex_tpu_torch.tracing").host_read.count
    except ImportError:  # a program without the counter
        return None


def read(rec):
    before, after = rec["snapshots"]["host_syncs_per_query"]
    if before is None or after is None or not rec["queries"]:
        return None
    return (after - before) / len(rec["queries"])

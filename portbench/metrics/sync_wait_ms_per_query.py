"""The host's waits for the device a query: the summed time of the
program's ``sync:<site>`` spans (``vaex_tpu_torch.tracing.host_read``: a
blocking read of a device value), in ms, over the window's queries."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "sync_wait_ms_per_query"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.ms_per_query(rec, NAME, lambda name: name.startswith("sync:"))

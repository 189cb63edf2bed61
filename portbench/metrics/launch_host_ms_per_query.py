"""The host's own time in the kernel wrappers a query: the self time of
the program's ``launch:<route>`` spans (a wrapper of the strategy plan or
the probe, from its entry to the return of its kernel's enqueue), in ms,
over the window's queries."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "launch_host_ms_per_query"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.ms_per_query(rec, NAME, lambda name: name.startswith("launch"))

"""The host's own time in the entry a query: the self time (children,
``sync:`` waits among them, taken out) of the program's ``groupby``,
``binby``, ``plan``, ``assemble`` and ``one-sort`` spans, in ms, over the
window's queries."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "entry_host_ms_per_query"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.ms_per_query(rec, NAME, spans.ENTRY.__contains__)

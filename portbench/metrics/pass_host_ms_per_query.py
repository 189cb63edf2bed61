"""The host's own time in the passes a query: the self time (``launch:``
and ``sync:`` spans taken out) of the program's ``pass``, ``tile``,
``prolog`` and ``finalize`` spans, in ms, over the window's queries."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "pass_host_ms_per_query"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.ms_per_query(rec, NAME, spans.PASS.__contains__)

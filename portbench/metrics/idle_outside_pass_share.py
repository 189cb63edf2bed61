"""The device's idle time under a root span (``groupby``, ``binby``) but
outside any pass (planning, assembly, the one-sort plan, the waits there),
in % of the traced window; with ``idle_in_pass_share`` and the idle time
outside the roots (between questions) it makes ``device_idle_share``."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "idle_outside_pass_share"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.idle_share(rec, NAME, "entry")

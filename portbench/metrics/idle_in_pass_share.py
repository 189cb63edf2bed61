"""The device's idle time under a pass, in % of the traced window: each
idle gap put down by its middle to the innermost program span holding it
(after the program's spans are aligned with the questions' ``q:`` spans),
summed over the gaps whose span is a ``pass`` or lies inside one."""

import os

from portbench import byname

spans = byname.module("metrics", "program_spans",
                      os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
NAME = "idle_in_pass_share"


def snapshot(ctx):
    return spans.snapshot(ctx, NAME)


def read(rec):
    return spans.idle_share(rec, NAME, "pass")

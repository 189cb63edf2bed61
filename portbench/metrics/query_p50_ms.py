"""The median latency over all of the window's queries, from the call to a
synchronize after it returns (host clock)."""

import statistics


def read(rec):
    return statistics.median((q[2] - q[1]) * 1e3 for q in rec["queries"])

"""The 95th percentile of the latency over all of the window's queries
(linear between the two nearest ranks; host clock)."""

import statistics


def read(rec):
    ms = [(q[2] - q[1]) * 1e3 for q in rec["queries"]]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]

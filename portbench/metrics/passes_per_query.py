"""Passes over the rows a query: the delta of ``ExecutorLocal.passes``
over every executor of the window's frames, over the queries."""


def snapshot(ctx):
    return sum(e.passes for e in ctx["executors"].values())


def read(rec):
    before, after = rec["snapshots"]["passes_per_query"]
    return (after - before) / len(rec["queries"])

"""Table rows scanned by all the window's queries over the window's wall
time (host clock; each query ends in a synchronize)."""


def read(rec):
    return sum(q[3] for q in rec["queries"]) / rec["window_s"]

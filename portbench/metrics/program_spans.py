"""The program's own spans in a traced run, shared by the readers of the
host's stages (``*_host_ms_per_query``, ``sync_wait_ms_per_query``,
``idle_*_pass_share``); not a metric of its own.

``vaex_tpu_torch.tracing`` records ``(seq, name, start_ns, end_ns, parent)``
a span while recording is on, on ``time.time_ns()``, the clock of
``torch.profiler``'s events.  A reader's first ``snapshot`` (after the warm
round) turns recording on and keeps the sequence number; its second (after
the window) takes the spans recorded since and turns recording off, once
for all the readers of a run.  A program without the recorder gives
``None`` and the metric is left out.

The trace's times (``rec["spans"]``, the benchmark's ``q:`` spans, and
``rec["device_ops"]``) are microseconds from the profiler's first event.
The i-th root span (``groupby`` or ``binby`` with no parent: the cells ask
one public call a question) is matched with the i-th ``q:`` span, the base
is the least ``root start - q start``, and the program's spans are moved
onto the trace's microseconds by it; where the counts differ, or a root
then lies outside its question by more than ``SLACK_US``, nothing is
aligned and the idle metrics are left out.
"""

import importlib

from portbench import trace

ROOTS = ("groupby", "binby")
ENTRY = ROOTS + ("plan", "assemble", "one-sort")
PASS = ("pass", "tile", "prolog", "finalize")
SLACK_US = 20.0


def program():
    """The program's recorder, or None where it has none."""
    try:
        return importlib.import_module("vaex_tpu_torch.tracing")
    except ImportError:
        return None


def snapshot(ctx, name):
    """The sequence number at the first call of metric ``name``, the spans
    recorded since at its second; None without the recorder."""
    tracing = program()
    if tracing is None:
        return None
    key = ("program_spans", name)
    if key not in ctx:
        ctx[key] = tracing.start()
        return ctx[key]
    taken = ("program_spans", "since", ctx[key])
    if taken not in ctx:
        ctx[taken] = tracing.since(ctx[key])
        tracing.stop()
    return ctx[taken]


def spans(rec, name):
    """The spans metric ``name`` took over the window, or None."""
    before, after = rec["snapshots"].get(name, (None, None))
    return None if before is None or after is None else after


def self_ns(spans):
    """{seq: the span's time less its children's}."""
    own = {s[0]: s[3] - s[2] for s in spans}
    for s in spans:
        if s[4] in own:
            own[s[4]] -= s[3] - s[2]
    return own


def ms_per_query(rec, name, picked):
    """The self time of the spans whose name ``picked`` takes, in ms a
    query; None without spans."""
    got = spans(rec, name)
    if got is None or not rec["queries"]:
        return None
    own = self_ns(got)
    total = sum(own[s[0]] for s in got if picked(s[1]))
    return total * 1e-6 / len(rec["queries"])


def aligned(rec, got):
    """The spans as (seq, name, start us, end us, parent) on the trace's
    clock, or None (see the module's docstring)."""
    questions = sorted(rec.get("spans") or [])
    roots = sorted((s for s in got if s[4] is None and s[1] in ROOTS), key=lambda s: s[2])
    if not questions or len(roots) != len(questions):
        return None
    base = min(r[2] - round(q[0] * 1e3) for r, q in zip(roots, questions))
    for r, q in zip(roots, questions):
        if (r[2] - base) * 1e-3 < q[0] - SLACK_US or (r[3] - base) * 1e-3 > q[1] + SLACK_US:
            return None
    return [(s[0], s[1], (s[2] - base) * 1e-3, (s[3] - base) * 1e-3, s[4]) for s in got]


def gaps(device, t0, t1):
    """The device's idle intervals in [t0, t1] (as :func:`trace.idle_gaps`
    cuts them)."""
    busy = [(max(s, t0), min(e, t1)) for s, e, _ in device if e > t0 and s < t1]
    out, at = [], t0
    for s, e in trace.union(busy):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def innermost(spans, points):
    """For each of the sorted ``points`` the innermost span holding it, or
    None; the spans nest (one thread's)."""
    order = sorted(spans, key=lambda s: (s[2], -s[3]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i][2] <= p:
            while stack and stack[-1][3] < order[i][2]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][3] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_by_stage(rec, name):
    """{"pass", "entry", "other"}: the device's idle us over the traced
    window, each gap put down by its middle to the innermost program span
    holding it: under a ``pass`` span; under a root but outside any pass;
    neither (between questions, before the root opens).  None without
    spans, a device trace or an alignment."""
    got = spans(rec, name)
    if got is None or not rec.get("busy_s") or not rec.get("spans"):
        return None
    placed = aligned(rec, got)
    if placed is None:
        return None
    stage = {}  # seq: "pass", "entry" or "other", from the span's ancestry
    for s in sorted(placed):
        up = stage.get(s[4])
        if s[1] == "pass" or up == "pass":
            stage[s[0]] = "pass"
        else:
            stage[s[0]] = up or ("entry" if s[1] in ROOTS else "other")
    t0 = min(q[0] for q in rec["spans"])
    t1 = max(q[1] for q in rec["spans"])
    idle = gaps(rec["device_ops"], t0, t1)
    holders = innermost(placed, [(s + e) / 2 for s, e in idle])  # the gaps come in order
    out = {"pass": 0.0, "entry": 0.0, "other": 0.0}
    for (s, e), holder in zip(idle, holders):
        out["other" if holder is None else stage[holder[0]]] += e - s
    return out


def idle_share(rec, name, which):
    """The idle time put down to stage ``which``, in % of the window."""
    by = idle_by_stage(rec, name)
    return None if by is None else 100.0 * by[which] * 1e-6 / rec["trace_window_s"]


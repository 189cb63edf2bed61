"""The readers of the program's spans and host reads on synthetic records:
self times a query by stage, the alignment of the program's spans with the
questions' ``q:`` spans, the cases left out, and the device's idle gaps put
down to the innermost span, summing with the rest to ``device_idle_share``.
On the card, a small traced run of each cell reports all seven metrics."""

import pytest

from conftest import small
from portbench import byname, harness
from portbench import trace as tracing

SPAN_METRICS = ("sync_wait_ms_per_query", "entry_host_ms_per_query", "pass_host_ms_per_query",
                "launch_host_ms_per_query", "idle_in_pass_share", "idle_outside_pass_share")
NEW = ("host_syncs_per_query",) + SPAN_METRICS
BASE_NS = 1_760_000_000_123_456_789  # time.time_ns() of the profiler's first event
LAG_US = 5  # from a question's q: span to its root span


def metric(name):
    return byname.module("metrics", name)


def question(q0, seq0, shift_ns=0):
    """The program's spans of one question whose q: span starts at q0 us:
    (seq, name, start ns, end ns, parent), times in us from q0 + LAG_US."""
    shape = [  # name, start us, end us, parent index
        ("groupby", 0, 980, None),
        ("plan", 5, 95, 0),
        ("pass", 100, 800, 0),
        ("tile", 110, 700, 2),
        ("prolog", 120, 200, 3),
        ("launch:b3-l2", 200, 300, 3),
        ("finalize", 700, 790, 2),
        ("sync:any-cells", 720, 760, 6),
        ("assemble", 800, 975, 0),
        ("sync:compact", 850, 950, 8),
    ]
    out = []
    for k, (name, s, e, parent) in enumerate(shape):
        t = BASE_NS + (q0 + LAG_US) * 1000 + shift_ns
        out.append((seq0 + k, name, t + s * 1000, t + e * 1000,
                    None if parent is None else seq0 + parent))
    return out


def record(shift_ns=0, questions=2):
    """Questions of 1000 us each, back to back, the device busy at [q0 +
    300, q0 + 650], [q0 + 770, q0 + 900], [q0 + 940, q0 + 990] and [q0 +
    995, q0 + 1000] of each."""
    qs, spans, ops = [], [], []
    for i in range(questions):
        q0 = 1000 * i
        qs.append((q0, q0 + 1000, f"q{i}"))
        spans += question(q0, 100 * i + 1, shift_ns)
        ops += [(q0 + 300, q0 + 650, "k"), (q0 + 770, q0 + 900, "k"), (q0 + 940, q0 + 990, "k"),
                (q0 + 995, q0 + 1000, "k")]
    window = questions * 1000
    busy = tracing.length([(s, e) for s, e, _ in ops])
    snaps = {name: (0, spans) for name in SPAN_METRICS}
    snaps["host_syncs_per_query"] = (10, 10 + 2 * questions)
    return {"queries": [(q[2], 0.0, 1e-3, 1, 1) for q in qs], "spans": qs, "device_ops": ops,
            "busy_s": busy * 1e-6, "trace_window_s": window * 1e-6, "snapshots": snaps}


def test_self_times_a_query_by_stage():
    rec = record()
    # entry: groupby 980 - (90 + 700 + 175) = 15, plan 90, assemble 175 - 100 = 75
    assert metric("entry_host_ms_per_query").read(rec) == pytest.approx(0.180)
    # pass 700 - 590 - 90 = 20, tile 590 - 80 - 100 = 410, prolog 80, finalize 90 - 40 = 50
    assert metric("pass_host_ms_per_query").read(rec) == pytest.approx(0.560)
    assert metric("launch_host_ms_per_query").read(rec) == pytest.approx(0.100)
    assert metric("sync_wait_ms_per_query").read(rec) == pytest.approx(0.140)
    assert metric("host_syncs_per_query").read(rec) == 2.0
    # the stages and the waits make up the root's time
    total = sum(metric(n).read(rec) for n in SPAN_METRICS[:4])
    assert total == pytest.approx(0.980)


@pytest.mark.parametrize("shift_ns", [0, 7_300_000_000, -2_000_123],
                         ids=["same clock", "seconds apart", "behind"])
def test_idle_gaps_go_to_the_innermost_span_and_sum_to_the_idle_share(shift_ns):
    """Per question: idle [0, 300] (middle 150, under the prolog: pass),
    [650, 770] (middle 710, finalize: pass), [900, 940] (middle 920, the
    sync under assemble: entry), [990, 995] (after the root: neither).
    The base takes up any offset of the program's clock."""
    rec = record(shift_ns)
    share = byname.module("metrics", "device_idle_share").read(rec)
    inside = metric("idle_in_pass_share").read(rec)
    outside = metric("idle_outside_pass_share").read(rec)
    assert inside == pytest.approx(100 * (300 + 120) / 1000)
    assert outside == pytest.approx(100 * 40 / 1000)
    rest = 100 * 5 / 1000
    assert inside + outside + rest == pytest.approx(share)
    by = byname.module("metrics", "program_spans").idle_by_stage(rec, "idle_in_pass_share")
    assert sum(by.values()) == pytest.approx(sum(us for _, us in tracing.idle_gaps(
        rec["device_ops"], rec["spans"])))


def test_the_alignment_matches_each_root_with_its_question():
    spans = byname.module("metrics", "program_spans")
    rec = record(shift_ns=123_456)
    placed = spans.aligned(rec, rec["snapshots"]["idle_in_pass_share"][1])
    roots = [s for s in placed if s[4] is None]
    assert [round(s[2], 3) for s in roots] == [0.0, 1000.0]  # the least lag taken out
    assert [round(s[3], 3) for s in roots] == [980.0, 1980.0]


def _late_root(rec):
    spans = list(rec["snapshots"]["idle_in_pass_share"][1])
    k = next(i for i, s in enumerate(spans) if s[1] == "groupby" and s[0] > 1)
    seq, name, t0, t1, parent = spans[k]
    spans[k] = (seq, name, t0, t1 + 50_000, parent)  # past its q: span by 45 us
    return spans


@pytest.mark.parametrize("change", ["a root too few", "a root past its question",
                                    "no recorder", "no device trace"])
def test_the_cases_left_out(change):
    rec = record()
    if change == "a root too few":
        rec["spans"].append((2000, 3000, "q2"))
        rec["trace_window_s"] = 3000e-6
    elif change == "a root past its question":
        late = _late_root(rec)
        rec["snapshots"].update({n: (0, late) for n in SPAN_METRICS})
    elif change == "no recorder":
        rec["snapshots"] = {n: (None, None) for n in NEW}
    else:
        rec["busy_s"] = None
    assert metric("idle_in_pass_share").read(rec) is None
    assert metric("idle_outside_pass_share").read(rec) is None
    left = [metric(n).read(rec) for n in NEW[:5]]
    assert all(v is None for v in left) == (change == "no recorder")


def test_a_root_within_the_slack_is_kept():
    rec = record()
    spans = list(rec["snapshots"]["idle_in_pass_share"][1])
    k = next(i for i, s in enumerate(spans) if s[1] == "groupby" and s[0] > 1)
    seq, name, t0, t1, parent = spans[k]
    spans[k] = (seq, name, t0, t1 + 30_000, parent)  # 15 us past: inside the 20 us
    rec["snapshots"].update({n: (0, spans) for n in SPAN_METRICS})
    assert metric("idle_in_pass_share").read(rec) is not None


def test_the_snapshots_record_the_window_once_for_all_readers():
    from vaex_tpu_torch import tracing as program
    ctx = {}
    first = {n: metric(n).snapshot(ctx) for n in SPAN_METRICS}
    assert program._on and len(set(first.values())) == 1
    with program.span("groupby"):
        pass
    second = {n: metric(n).snapshot(ctx) for n in SPAN_METRICS}
    assert not program._on
    taken = second[SPAN_METRICS[0]]
    assert [s[1] for s in taken] == ["groupby"]
    assert all(v is taken for v in second.values())
    count = metric("host_syncs_per_query").snapshot(ctx)
    assert count == program.host_read.count


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ("h2o_1e8_k100.grid", "h2o_1e8_k100.sort"))
def test_a_small_traced_run_reports_the_host_stages(cuda_device, workload):
    cell = harness.Cell(workload)
    result, summary = harness.run(workload, 2 ** 31 + 17, 0.5, True, cuda_device,
                                  config=small(cell.config))
    assert result["correct"], (result["checks"], summary["errors"])
    got = {n: result["metrics"].get(n, {}).get("value") for n in NEW}
    assert all(v is not None for v in got.values()), got
    idle = result["metrics"]["device_idle_share"]["value"]
    assert got["idle_in_pass_share"] + got["idle_outside_pass_share"] <= idle + 1e-9

"""The metric arithmetic from a run's records: rows over the window,
percentiles over all queries, the union of intervals, the work-defined
bytes."""

import json
import os
import pytest

from conftest import ROOT
from portbench import byname, harness, tables
from portbench import trace as tracing

METRICS = os.path.join(ROOT, "portbench", "metrics")


def metric(name):
    return byname.module("metrics", name)


def records(latencies_ms, rows=100, nbytes=1000):
    t, out = 0.0, []
    for ms in latencies_ms:
        out.append(("q", t, t + ms * 1e-3, rows, nbytes))
        t += ms * 1e-3
    return out


def test_rows_over_the_window():
    rec = {"queries": records([10.0] * 50, rows=1000), "window_s": 0.5}
    assert metric("rows_per_s").read(rec) == pytest.approx(50 * 1000 / 0.5)


def test_percentiles_over_all_queries():
    lat = [float(i) for i in range(1, 201)]  # 1..200 ms
    rec = {"queries": records(lat)}
    assert metric("query_p50_ms").read(rec) == pytest.approx(100.5)
    # linear between the ranks around 0.95 * 199 = 189.05
    assert metric("query_p95_ms").read(rec) == pytest.approx(190.05)
    assert metric("query_p95_ms").read({"queries": records([5.0])}) is None


def test_union_of_intervals():
    assert tracing.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [(0, 4), (5, 7)]
    assert tracing.length([(0, 2), (1, 3), (10, 11)]) == 4
    assert tracing.length([]) == 0


def test_device_shares():
    ops = [(0.0, 400.0, "void lane_partials<true>(int const*)"), (300.0, 500.0, "at::native::sort"),
           (700.0, 800.0, "Memcpy DtoD")]
    busy = tracing.length([(s, e) for s, e, _ in ops]) * 1e-6
    rec = {"busy_s": busy, "trace_window_s": 1000e-6, "device_ops": ops,
           "kernels": ["lane_partials", "probe_tree"], "queries": records([1.0], nbytes=335_000_000),
           "peaks": {"hbm_bytes_per_s": 3.35e12}}
    assert busy == pytest.approx(600e-6)
    assert metric("device_idle_share").read(rec) == pytest.approx(40.0)
    assert metric("port_kernel_share").read(rec) == pytest.approx(100 * 400 / 600)
    # 335 MB at 3.35 TB/s is 100 us of the 600 us busy
    assert metric("scan_roofline").read(rec) == pytest.approx(100 * 100 / 600)
    for name in ("device_idle_share", "port_kernel_share", "scan_roofline"):
        assert metric(name).read({"busy_s": None}) is None


def test_counters_per_query():
    rec = {"queries": records([1.0] * 4), "snapshots": {"passes_per_query": (10, 15),
                                                       "launches_per_query": (3, 11)}}
    assert metric("passes_per_query").read(rec) == 1.25
    assert metric("launches_per_query").read(rec) == 2.0
    assert metric("launches_per_query").snapshot({}) >= 0


def test_idle_gaps_by_question():
    spans = [(0.0, 10.0, "q1"), (10.0, 30.0, "q2")]
    device = [(1.0, 9.0, "k"), (12.0, 20.0, "k"), (25.0, 29.0, "k")]
    gaps = dict(tracing.idle_gaps(device, spans))
    # [0, 1] in q1; [9, 12] (middle 10.5), [20, 25] and [29, 30] in q2
    assert gaps == {"q1": pytest.approx(1.0), "q2": pytest.approx(3.0 + 5.0 + 1.0)}
    top = tracing.top_ops([(0, 3, "a"), (5, 6, "b"), (7, 9, "a")])
    assert top == [("a", 5), ("b", 1)]


def test_work_defined_bytes():
    with open(os.path.join(ROOT, "portbench", "configs", "h2o_g1_1e8_k100.json")) as f:
        rows = tables.rows(json.load(f))
    grid = byname.data("traffic", "h2o_grid")["questions"]
    assert harness.work(grid[3], rows) == (10 ** 8, 4 * 8 * 10 ** 8)  # q4: id4, v1, v2, v3
    per_round = sum(harness.work(q, {"x": 1})[1] for q in grid)
    assert per_round == 184  # bytes a row a round: 23 columns of 8 bytes


def test_port_kernels_are_every_global_of_csrc():
    """The names come from the sources each run, so a kernel added there
    is counted without an edit here."""
    names = tracing.port_kernels(ROOT)
    assert {"fold_partials", "fold_partials_seq", "lane_partials", "probe_tree",
            "partition_scatter", "moment_window_walk"} <= set(names)
    import glob
    text = "".join(open(p).read() for p in glob.glob(os.path.join(ROOT, "vaex_tpu_torch", "csrc",
                                                                   "*.cu*")))
    assert len(names) == text.count("__global__")


def test_the_peak_leaves_out_the_answers_kept_for_the_check():
    """Each question's reading of the device's peak, less what the kept
    answers hold: 100 bytes of tables plus a query's 50 of work, whatever
    the check holds."""
    import torch
    cell = harness.Cell("h2o_1e8_k100.grid")
    cell.traffic = {"loop": "closed", "clients": 1, "questions": cell.traffic["questions"][:2]}
    held = []

    class Call:
        def ask(self, vt, q, frames):
            return torch.ones(8, dtype=torch.float64)  # 64 bytes

        def got(self, answer, q):
            return {"a": answer, "b": answer[:4]}  # one storage

    def reading():
        return 100 + 50 + 64 * len(held)

    window = harness.Window(None, cell, {}, "cpu", 0.0, False, (lambda: None, reading))
    window.calls = [Call(), Call()]
    window.open(0.0)
    for i in range(2):
        window.ask(i, keep=True)
        held.append(i)
    assert window.held == 128 and window.card_peak == 150 + 64
    assert window.peak == 150
    assert harness.card_bytes([torch.ones(3, dtype=torch.float64), torch.ones(2, device="meta")],
                              "cpu") == 24

"""The port's span recorder and its count of blocking host reads
(``vaex_tpu_torch/tracing.py``), on the CPU.

* Off, nothing is recorded and every span is one shared no-op context.
* On, a groupby over two tiles gives the tree ``groupby -> plan, pass ->
  tile -> prolog, launch:*; finalize; assemble -> sync:*``, whose self times
  are never negative and sum to the root's time; the ring keeps its last
  spans.
* ``host_read.count`` grows by the reads of each site a groupby reaches,
  and a pass's ``trace_log`` entry splits its host time and counts them.
* A ``torch.profiler`` marker opened inside a span lies inside it on the
  profiler's own timestamps: the spans are on the profiler's clock.
"""

import collections
import time

import numpy as np
import pytest
import torch

import vaex_tpu_torch as vt
from vaex_tpu_torch import tracing

ROWS = 5000
TILE = 2500  # two tiles a pass


@pytest.fixture(autouse=True)
def stopped():
    """Recording off around each test, and no result served from the
    cache, so that each query runs its pass."""
    tracing.stop()
    with vt.cache.off():
        yield
    tracing.stop()


def _frame(seed=3):
    rng = np.random.default_rng(seed)
    df = vt.from_arrays(k=rng.integers(0, 40, ROWS), j=rng.integers(0, 25, ROWS),
                        w=rng.integers(0, 2 ** 23 + 10, ROWS), v=rng.random(ROWS) * 10)
    df = df.to_device("cpu")
    df._tile_rows = TILE
    return df


def _recorded(fn):
    """(fn's result, the spans it recorded)."""
    seq = tracing.start()
    try:
        out = fn()
    finally:
        tracing.stop()
    return out, tracing.since(seq)


def _children(spans):
    kids = collections.defaultdict(list)
    for s in sorted(spans):
        kids[s[4]].append(s)
    return kids


def _self_ns(spans):
    own = {s[0]: s[3] - s[2] for s in spans}
    for s in spans:
        if s[4] in own:
            own[s[4]] -= s[3] - s[2]
    return own


AGG = {"s": vt.agg.sum("v"), "c": "count"}


def test_off_records_nothing_and_spans_are_one_object():
    df = _frame()
    before = len(tracing.since(0))
    df.groupby("k", agg=AGG)
    assert len(tracing.since(0)) == before
    assert tracing.span("a") is tracing.span("b") is tracing.host_read("c") is tracing.OFF
    with tracing.span("d"), tracing.host_read("e"):
        pass
    assert len(tracing.since(0)) == before


@pytest.mark.parametrize("by", [["k"], ["k", "j"]], ids=["one key", "cartesian"])
def test_a_groupby_over_two_tiles_gives_the_span_tree(by):
    df = _frame()
    df.groupby(by, agg=AGG)  # the key ranges remembered
    _, spans = _recorded(lambda: df.groupby(by, agg=AGG))
    kids = _children(spans)
    [root] = kids[None]
    assert root[1] == "groupby"
    top = [s[1] for s in kids[root[0]]]
    assert "plan" in top and top.count("pass") == 1 and top[-1] == "assemble"
    assert top.index("plan") < top.index("pass") < top.index("assemble")
    [pas] = [s for s in kids[root[0]] if s[1] == "pass"]
    assert [s[1] for s in kids[pas[0]]] == ["tile", "tile", "finalize"]
    for tile in kids[pas[0]][:2]:
        names = [s[1] for s in kids[tile[0]]]
        assert "prolog" in names and any(n.startswith("launch:b") for n in names)
        assert names.index("prolog") < min(i for i, n in enumerate(names)
                                           if n.startswith("launch:"))
    [assemble] = [s for s in kids[root[0]] if s[1] == "assemble"]
    assert all(s[1].startswith("sync:") for s in kids[assemble[0]])
    for s in spans:  # each span lies inside its parent
        if s[4] is not None:
            parent = next(p for p in spans if p[0] == s[4])
            assert parent[2] <= s[2] <= s[3] <= parent[3]


@pytest.mark.parametrize("by", [["k"], ["k", "j"], ["w"]], ids=["one key", "cartesian",
                                                                "one-sort"])
def test_self_times_are_never_negative_and_sum_to_the_root(by):
    df = _frame()
    _, spans = _recorded(lambda: df.groupby(by, agg=AGG))
    own = _self_ns(spans)
    assert min(own.values()) >= 0
    [root] = [s for s in spans if s[4] is None]
    assert sum(own.values()) == root[3] - root[2]


def test_the_ring_drops_the_oldest_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=8))
    seq = tracing.start()
    for i in range(20):
        with tracing.span(f"s{i}"):
            pass
    tracing.stop()
    kept = tracing.since(seq)
    assert [s[1] for s in kept] == [f"s{i}" for i in range(12, 20)]
    assert [s[0] for s in kept] == list(range(seq + 13, seq + 21))
    assert tracing.since(kept[-1][0]) == []


# the reads a groupby of a remembered dense key reaches (assemble: the
# stale-range check of each axis, the compaction, the cartesian cells), as
# {site: its spans}, and their reads
SITES = {
    "one key": (["k"], {"edge-index": 1, "edge-check": 1, "compact": 1}, 3),
    # one span holds the copies of both keys' cell codes
    "cartesian": (["k", "j"], {"edge-index": 2, "edge-check": 2, "compact": 1, "cells": 1,
                               "cell-codes": 1, "key-codes": 2}, 10),
    # the one-sort plan: its keys' bounds, the segment starts and their end
    "one-sort": (["w"], {"key-bounds": 1, "segment-start": 1, "segments": 1,
                         "segment-end": 1}, 4),
}


@pytest.mark.parametrize("case", list(SITES))
def test_host_read_counts_each_site(case):
    by, want, reads = SITES[case]
    df = _frame()
    df.groupby(by, agg=AGG)
    before = tracing.host_read.count
    df.groupby(by, agg=AGG)  # recording off: counted all the same
    assert tracing.host_read.count - before == reads
    before = tracing.host_read.count
    _, spans = _recorded(lambda: df.groupby(by, agg=AGG))
    assert tracing.host_read.count - before == reads
    got = collections.Counter(s[1][len("sync:"):] for s in spans if s[1].startswith("sync:"))
    assert got == want


def test_the_first_groupby_also_counts_its_pre_pass():
    """The key's sampled range (two reads in one span) and the pre-pass's
    min, max and count brought to the host."""
    df = _frame()
    before = tracing.host_read.count
    _, spans = _recorded(lambda: df.groupby("k", agg=AGG))
    sites = collections.Counter(s[1] for s in spans if s[1].startswith("sync:"))
    assert sites["sync:sample-range"] == 1 and sites["sync:to-numpy"] == 3
    assert tracing.host_read.count - before == sum(sites.values()) + 1


PASSES = {
    # two nth_largest ops read their rows and values by a mask in each of
    # two tiles (two reads a span); (query, its span, reads, sync spans)
    "grid": (lambda df: df.groupby("k", agg={"a": vt.agg.nth_largest("v", 0),
                                             "b": vt.agg.nth_largest("v", 1)}), "pass", 8, 4),
    "one-sort": (lambda df: df.groupby("w", agg=AGG), "one-sort", 4, 4),
}


@pytest.mark.parametrize("case", list(PASSES))
def test_trace_log_splits_the_pass_and_counts_its_reads(case):
    query, name, syncs, waits = PASSES[case]
    df = _frame()
    query(df)
    _, spans = _recorded(lambda: query(df))
    entry = df.executor.trace_log[-1]
    assert entry["enqueue_s"] > 0 and entry["finalize_s"] >= 0
    assert entry["enqueue_s"] + entry["finalize_s"] <= entry["wall_s"]
    assert entry["syncs"] == syncs
    # the reads it counts are those under the pass's span
    [held] = [s for s in spans if s[1] == name]
    byseq = {s[0]: s for s in spans}

    def under(s):
        while s[4] is not None:
            s = byseq[s[4]]
            if s is held:
                return True
        return False
    assert sum(1 for s in spans if s[1].startswith("sync:") and under(s)) == waits


def test_spans_lie_on_the_profiler_clock():
    """A marker of torch.profiler opened inside a span lies inside it on the
    profiler's own timestamps, within 50 us: the two share one clock."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        seq = tracing.start()
        with tracing.span("outer"):
            time.sleep(0.001)
            with torch.profiler.record_function("tracing-marker"):
                time.sleep(0.002)
            time.sleep(0.001)
        tracing.stop()
    [outer] = tracing.since(seq)
    [marker] = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "tracing-marker"]
    start, end = marker.start_ns(), marker.start_ns() + marker.duration_ns()
    assert outer[2] - 50_000 <= start and end <= outer[3] + 50_000
    assert start - outer[2] >= 1_000_000 - 50_000 and outer[3] - end >= 1_000_000 - 50_000


def test_launch_spans_name_the_route():
    df = _frame()
    df.groupby("k", agg=AGG)
    _, spans = _recorded(lambda: df.groupby("k", agg={"m": vt.agg.max("v"), **AGG}))
    launches = {s[1] for s in spans if s[1].startswith("launch:")}
    assert launches and all(n.split(":", 1)[1] for n in launches)
    assert df.executor.trace_log[-1]["strategies"][0]["additive"] in {
        n.split(":", 1)[1] for n in launches}

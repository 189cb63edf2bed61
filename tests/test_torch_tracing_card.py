"""The port's count of blocking host reads and its launch spans on the card,
over the H2O groupby questions of the benchmark's two cells, on a table of
the H2O generator's shapes at 1e7 rows (raw int64 keys, float64 v3).

* Under ``torch.cuda.set_sync_debug_mode("warn")`` torch warns once for each
  operation that blocks the host until the device drains; their number
  equals the delta of ``tracing.host_read.count`` over each question, in
  the round that measures the key ranges and in the next, so that no
  blocking read of these questions is left uncounted.
* In a ``torch.profiler`` trace every kernel launched inside a
  ``launch:<route>`` span starts on the device after that span starts:
  the spans and the profiler's events share one clock.

Imports neither JAX nor vaex_tpu.  Marked ``cuda``, skipped without a GPU;
on a machine with one, from the root of the repository:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing_card.py -q
"""

import traceback
import warnings

import pytest
import torch

import vaex_tpu_torch as vt
from vaex_tpu_torch import tracing

pytestmark = pytest.mark.cuda

ROWS = 10 ** 7
K = 100  # db-benchmark's G1_1e8_1e2_0_0: id1, id2, id4, id5 in [1, K], id3, id6 in [1, 1e6]
COLUMNS = {"id1": K, "id2": K, "id3": 10 ** 6, "id4": K, "id5": K, "id6": 10 ** 6, "v1": 5,
           "v2": 15}

# the grid cell's questions, then the sort cell's
QUESTIONS = {
    "q1": lambda df: df.groupby(["id1"], agg={"v1": "sum"}),
    "q2": lambda df: df.groupby(["id1", "id2"], agg={"v1": "sum"}),
    "q3": lambda df: df.groupby(["id3"], agg={"v1": "sum", "v3": vt.agg.mean("v3")}),
    "q4": lambda df: df.groupby(["id4"], agg={c: vt.agg.mean(c) for c in ("v1", "v2", "v3")}),
    "q5": lambda df: df.groupby(["id6"], agg={"v1": "sum", "v2": "sum", "v3": "sum"}),
    "q7": lambda df: df.groupby(["id3"], agg={"max_v1": vt.agg.max("v1"),
                                              "min_v2": vt.agg.min("v2")}),
    "q9": lambda df: df.groupby(["id2", "id4"], agg={"r2": vt.agg.corr("v1", "v2")}),
    "q6": lambda df: df.groupby(["id4", "id5"], agg={"median_v3": vt.agg.median_approx("v3"),
                                                     "sd_v3": vt.agg.std("v3", ddof=1)}),
    "q8": lambda df: df.groupby(["id6"], agg={"largest1_v3": vt.agg.nth_largest("v3", 0),
                                              "largest2_v3": vt.agg.nth_largest("v3", 1)}),
    "q10": lambda df: df.groupby(["id1", "id2", "id3", "id4", "id5", "id6"],
                                 agg={"v3": "sum", "v1": "count"}),
}
GRID = ("q1", "q2", "q3", "q4", "q5", "q7", "q9")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _frame(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cols = {name: torch.randint(1, hi + 1, (ROWS,), generator=gen, device="cuda",
                                dtype=torch.int64) for name, hi in COLUMNS.items()}
    cols["v3"] = torch.rand(ROWS, generator=gen, device="cuda", dtype=torch.float64) * 100
    return vt.from_dataset(vt.DatasetArrays(cols))


def _syncs(fn):
    """(the sync debug mode's warnings over ``fn()``, the delta of
    ``host_read.count``, the innermost frames that warned)."""
    torch.cuda.synchronize()
    before = tracing.host_read.count
    where = []

    def show(message, category, filename, lineno, file=None, line=None):
        # not the mode's own notice that it is a prototype, given once a process
        if "called a synchronizing CUDA operation" in str(message):
            where.append(" < ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                                    for f in traceback.extract_stack()[-4:-1][::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return len(where), tracing.host_read.count - before, where


@pytest.mark.parametrize("cell", ["grid", "sort"])
def test_every_blocking_read_is_counted(cuda, cell):
    names = GRID if cell == "grid" else [q for q in QUESTIONS if q not in GRID]
    got = {}
    df = _frame(2 ** 31 + 29)
    with vt.cache.off():
        for rnd in ("first", "next"):
            for q in names:
                got[rnd, q] = _syncs(lambda: QUESTIONS[q](df))
    assert all(warned == counted for warned, counted, _ in got.values()), got
    assert all(counted > 0 for _, counted, _ in got.values()), got


def test_kernels_start_after_their_launch_span(cuda):
    df = _frame(2 ** 31 + 31)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with vt.cache.off():
        for q in GRID:
            QUESTIONS[q](df)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            seq = tracing.start()
            try:
                for q in GRID:
                    QUESTIONS[q](df)
                torch.cuda.synchronize()
            finally:
                tracing.stop()
    launches = [s for s in tracing.since(seq) if s[1].startswith("launch:")]
    events = prof.profiler.kineto_results.events()
    calls = {e.correlation_id(): e for e in events
             if e.device_type() == torch.autograd.DeviceType.CPU and "Launch" in e.name()}
    checked = 0
    for k in events:
        if k.device_type() != torch.autograd.DeviceType.CUDA or k.is_user_annotation():
            continue
        call = calls.get(k.correlation_id()) or calls.get(k.linked_correlation_id())
        if call is None:
            continue
        held = [s for s in launches if s[2] <= call.start_ns() <= s[3]]
        if held:
            assert k.start_ns() >= max(s[2] for s in held), (k.name(), held)
            checked += 1
    assert checked >= len(GRID), (checked, len(launches), len(calls))

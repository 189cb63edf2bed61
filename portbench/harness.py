"""One run of one cell of the benchmark, found by name in BENCHMARK.json.

A cell names a configuration (``configs/<config>.json``: its tables, drawn
by :mod:`tables`) and a traffic mix (``traffic/<mix>.json``: its loop and
its questions, each a call of ``calls/`` with its plain version in
``reference/``); its limits are ``limits/<workload>.json`` and each of its
metrics is read by ``metrics/<metric>.py``.  A run:

1. makes the configuration's tables on the device from the seed and a
   frame of vaex_tpu_torch over each;
2. asks each question of the mix once, untimed (set-up ends here);
3. runs the mix's loop until ``seconds`` have passed (the window; under
   ``--trace 1`` inside ``torch.profiler``), under
   ``vaex_tpu_torch.cache.off()``; the loop keeps the answers of one round,
   drawn from the seed by the time it starts, for the check;
4. frees the program's state, works out the plain reference's answers from
   the same input tensors and compares (:mod:`judge`), then reads the
   metrics.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import random
import statistics
import sys
import time

import torch

from portbench import byname, judge, tables
from portbench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "vaex_tpu")


def forbidden_modules(names=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, whole: ``vaex_tpu_torch`` is not ``vaex_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Cell:
    """A workload of BENCHMARK.json and the files it is found by."""

    def __init__(self, workload, root=byname.ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(entries)}")
        self.workload = entries[workload]
        self.name = workload
        config = {c["name"]: c for c in self.bench["configs"]}[self.workload["config"]]
        with open(os.path.join(root, config["file"])) as f:
            self.config = json.load(f)
        self.traffic = byname.data("traffic", self.workload["traffic"], root)
        self.limits = byname.data("limits", workload, root)
        self.peaks = byname.data("", "peaks", root)
        self.kernels = tracing.port_kernels(root)

    def metrics(self, trace):
        """[(name, unit, reader module)] of this cell: its end-to-end
        metrics untraced, its per-layer metrics traced."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [(m["name"], m["unit"], byname.module("metrics", m["name"], self.root))
                for m in group if "workloads" not in m or self.name in m["workloads"]]

    def call(self, question):
        return byname.module("calls", question["call"], self.root)

    def reference(self, question):
        return byname.module("reference", question["call"], self.root)


def work(question, table_rows):
    """(rows scanned, bytes read) of one question: the work that defines
    it, whatever implements it.  ``scans`` names the table whose rows it
    scans; ``reads`` lists ``[table, column, bytes a row]``, every input it
    reads once, at its stored width, counted over that table's rows."""
    rows = table_rows[question["scans"]]
    nbytes = sum(table_rows[table] * int(width) for table, _, width in question["reads"])
    return rows, nbytes


def card_bytes(tensors, device_type):
    """The bytes of the distinct storages of ``tensors`` on the device."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if t.device.type == device_type}
    return sum(storages.values())


class Window:
    """What a loop (``loops/<loop>.py``) drives: the clock, and ``ask``,
    which asks one question, times it and records it.

    Around each question ``memory`` resets the device's peak statistic
    and reads it; the window's ``peak`` is the largest reading less the
    bytes that the answers kept for the check hold (``held``), so that it
    is the program's peak, not the harness's."""

    def __init__(self, vt, cell, frames, device, check_at, traced, memory=None):
        self.vt, self.mix, self.frames = vt, cell.traffic, frames
        self.questions = self.mix["questions"]
        self.calls = [cell.call(q) for q in self.questions]
        rows = tables.rows(cell.config)
        self.work = [work(q, rows) for q in self.questions]
        self.device_type = torch.device(device).type
        self.sync = torch.cuda.synchronize if self.device_type == "cuda" else (lambda: None)
        self.check_at, self.traced, self.memory = check_at, traced, memory
        self.records = []  # (question, start s, end s, rows, bytes)
        self.failed = 0
        self.errors = []
        self.checked = {}  # question: the columns of its answer in the kept round
        self.kept = False
        self.held = self.peak = self.card_peak = 0
        self.rounds = 0
        self.executors = {id(df.executor): df.executor for df in frames.values()}

    def now(self):
        return time.perf_counter()

    def open(self, seconds):
        self.start = self.now()
        self.deadline = self.start + seconds
        self.check_time = self.start + self.check_at * seconds
        self.records, self.failed, self.peak, self.card_peak = [], 0, 0, 0

    def over(self):
        return self.now() >= self.deadline

    def ask(self, i, keep=False):
        q = self.questions[i]
        span = (torch.profiler.record_function(f"{tracing.SPAN}{q['name']}") if self.traced
                else contextlib.nullcontext())
        if self.memory:
            self.memory[0]()
        t0 = self.now()
        try:
            with span:
                out = self.calls[i].ask(self.vt, q, self.frames)
                self.sync()
        except Exception as e:  # an answer that never comes: counted, and the run is not correct
            out = None
            self.failed += 1
            if len(self.errors) < 10:
                self.errors.append(f"{q['name']}: {type(e).__name__}: {e}")
        t1 = self.now()
        if self.memory:
            top = self.memory[1]()
            self.card_peak = max(self.card_peak, top)
            self.peak = max(self.peak, top - self.held)
        self.records.append((q["name"], t0, t1, *self.work[i]))
        if keep and out is not None:
            cols = self.calls[i].got(out, q)
            self.checked[q["name"]] = cols
            self.held += card_bytes(cols.values(), self.device_type)
        return out

    def warm(self):
        for i in range(len(self.questions)):
            self.ask(i)
            if self.failed:
                raise RuntimeError(f"the warm round failed: {self.errors}")


def drive(cell, made, seed, seconds, trace, device, metrics, t_start):
    """The program's part of a run: frames over the tables, the warm round,
    the window, and the kept answers' columns.  The program's frames and
    what it remembers on them are gone when this returns."""
    import vaex_tpu_torch as vt

    on_card = torch.device(device).type == "cuda"
    frames = {name: vt.from_dataset(vt.DatasetArrays(dict(cols))) for name, cols in made.items()}
    memory = ((torch.cuda.reset_peak_memory_stats, torch.cuda.max_memory_allocated) if on_card
              else None)
    check_at = random.Random(f"{cell.name}:{seed}:check").random()
    window = Window(vt, cell, frames, device, check_at, trace, memory)
    loop = byname.module("loops", cell.traffic["loop"], cell.root)
    counted = [(name, mod) for name, _, mod in metrics if hasattr(mod, "snapshot")]
    ctx = {"executors": window.executors}
    prof = None
    with vt.cache.off():
        window.warm()
        window.sync()
        before = {name: mod.snapshot(ctx) for name, mod in counted}
        shifted = moment_passes(vt)
        setup_s = time.perf_counter() - t_start
        if trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        try:
            window.open(seconds)
            loop.run(window)
            w1 = time.perf_counter()
        finally:
            if prof is not None:
                prof.stop()
        snapshots = {name: (before[name], mod.snapshot(ctx)) for name, mod in counted}
        shifted = {k: v - shifted[k] for k, v in moment_passes(vt).items()}
    device_ops, spans = tracing.events(prof) if prof is not None else (None, None)
    return {"records": window.records, "failed": window.failed, "errors": window.errors,
            "rounds": window.rounds, "window": (window.start, w1), "peak": window.peak,
            "card_peak": window.card_peak, "held": window.held, "snapshots": snapshots,
            "setup_s": setup_s, "checked": window.checked, "device_ops": device_ops,
            "spans": spans, "moment_passes": shifted}


def moment_passes(vt):
    """The program's counts of the statistics' second and further passes
    (a shift a cell), for an earlier line of the run."""
    return {"second_passes": vt.agg.cell_shifted.second_passes,
            "further_passes": vt.agg.settle.further}


def run(workload, seed, seconds, trace=False, device="cuda", t_start=None, config=None,
        root=byname.ROOT):
    """One run; returns the result's dict (the last line's object) and a
    summary of the run (rounds, per-question medians, errors)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(workload, root)
    if config is not None:
        cell.config = config
    metrics = cell.metrics(trace)
    on_card = torch.device(device).type == "cuda"
    made = tables.make(cell.config, seed, device, root)
    d = drive(cell, made, seed, seconds, trace, device, metrics, t_start)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, after the window and with the program's state freed
    numbers = {}
    every = set(d["checked"]) == {q["name"] for q in cell.traffic["questions"]}
    for q in cell.traffic["questions"]:
        if q["name"] in d["checked"]:
            want = cell.reference(q).answer(q, made, torch.float64)
            judge.judge(d["checked"].pop(q["name"]), want, cell.call(q).keys(q), numbers)
            del want
    checks, within = judge.verdict(numbers, cell.limits)
    records = d["records"]
    correct = within and every and d["failed"] == 0 and len(records) > 0

    w0, w1 = d["window"]
    device_ops, spans = d["device_ops"], d["spans"]
    rec = {"queries": records, "window_s": w1 - w0, "setup_s": d["setup_s"],
           "peak_bytes": d["peak"], "snapshots": d["snapshots"], "peaks": cell.peaks,
           "kernels": cell.kernels, "device_ops": device_ops, "spans": spans}
    if device_ops and spans:  # the device's ops clipped to the window the spans cover
        t0, t1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
        device_ops = [(max(s, t0), min(e, t1), n) for s, e, n in device_ops if e > t0 and s < t1]
        rec["device_ops"] = device_ops
        rec["trace_window_s"] = (t1 - t0) * 1e-6
        rec["busy_s"] = tracing.length([(s, e) for s, e, _ in device_ops]) * 1e-6
    values = {}
    for name, unit, mod in metrics:
        v = mod.read(rec)
        if v is not None:
            values[name] = {"value": v, "unit": unit}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(d["card_peak"])}
    result = {"correct": bool(correct), "attempted": len(records), "failed": d["failed"],
              "metrics": values, "device": dev}
    if "busy_s" in rec:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["trace_window_s"]
        result["breakdown"] = {
            "device_ops": [[n, us * 1e-6] for n, us in tracing.top_ops(device_ops)],
            "idle_gaps": [[n, us * 1e-6] for n, us in tracing.idle_gaps(device_ops, spans)[:10]]}
    result["checks"] = checks
    summary = {"workload": workload, "seed": int(seed), "trace": bool(trace),
               "rounds": d["rounds"], "window_s": w1 - w0, "setup_s": d["setup_s"],
               "errors": d["errors"], "moment_passes": d["moment_passes"],
               "check_bytes_held": d["held"], "questions": per_question(records)}
    return result, summary


def per_question(records):
    """{question: {n, median_ms, max_ms}} over the window."""
    by = {}
    for name, t0, t1, _, _ in records:
        by.setdefault(name, []).append((t1 - t0) * 1e3)
    return {name: {"n": len(ms), "median_ms": statistics.median(ms), "max_ms": max(ms)}
            for name, ms in by.items()}

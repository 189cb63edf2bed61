"""A later change adds a configuration with a new kind of column, a traffic
mix with a new call and a new loop, and a metric, as new files and
BENCHMARK.json entries, editing no file: the harness finds them by name."""

import json
import os
import shutil

import pytest

from conftest import ROOT, small
from portbench import harness

KIND = '''
import torch


def make(spec, rows, gen, device, made):
    """Each row's key is its place modulo ``period``: every key as often."""
    return torch.arange(rows, device=device, dtype=getattr(torch, spec["dtype"])) % spec["period"]
'''

CALL = '''
import numpy as np
import torch


def ask(vt, question, frames):
    return frames[question["frame"]].sum(question["expression"])


def keys(question):
    return []


def got(answer, question):
    return {"value": torch.as_tensor(np.asarray(answer))}
'''

PLAIN = '''
import torch


def answer(question, tables, dtype):
    col = tables[question["frame"]][question["expression"]]
    return {"value": ("total_err", col.to(dtype).sum(), col.to(torch.float64).abs().sum())}
'''

LOOP = '''
def run(window):
    """Each question twice in a row, round after round."""
    while not (window.over() and window.kept):
        keep = not window.kept
        for i in range(len(window.questions)):
            window.ask(i)
            window.ask(i, keep)
        window.kept = True
        window.rounds += 1
'''


@pytest.fixture
def checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    os.symlink(os.path.join(ROOT, "vaex_tpu_torch"), root / "vaex_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    with open(pb / "configs" / "h2o_g1_1e8_k100.json") as f:
        config = small(json.load(f), {"x": 5000}, k=5)
    config["tables"]["x"]["columns"]["id4"] = {"kind": "cycle", "dtype": "int64", "period": 7}
    (pb / "configs" / "tiny_h2o.json").write_text(json.dumps(config))
    (pb / "columns" / "cycle.py").write_text(KIND)
    (pb / "calls" / "total.py").write_text(CALL)
    (pb / "reference" / "total.py").write_text(PLAIN)
    (pb / "loops" / "twice.py").write_text(LOOP)
    mix = {"loop": "twice", "clients": 1, "why": "two questions",
           "questions": [{"name": "by_id4", "frame": "x", "call": "groupby", "by": ["id4"],
                          "agg": {"n": "count", "s": ["sum", "v3"]}, "scans": "x",
                          "reads": [["x", "id4", 8], ["x", "v3", 8]]},
                         {"name": "total_v3", "frame": "x", "call": "total", "expression": "v3",
                          "scans": "x", "reads": [["x", "v3", 8]]}]}
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny.mix.json").write_text(
        json.dumps({"mismatches": 0, "sum_err": 1e-9, "total_err": 1e-9}))
    (pb / "metrics" / "queries_per_s.py").write_text(
        "def read(rec):\n    return len(rec['queries']) / rec['window_s']\n")
    bench["configs"].append({"name": "tiny_h2o", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tiny_h2o.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.mix", "config": "tiny_h2o", "traffic": "tiny_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "queries_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["tiny.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_kind_call_loop_and_metric_are_found_by_name(checkout):
    result, summary = harness.run("tiny.mix", 3, 0.2, False, "cpu", root=str(checkout))
    assert result["correct"], (result["checks"], summary["errors"])
    assert result["metrics"]["queries_per_s"]["value"] > 0
    assert set(summary["questions"]) == {"by_id4", "total_v3"}
    assert summary["questions"]["by_id4"]["n"] % 2 == 0  # the new loop asks each twice
    assert list(result["checks"]) == ["mismatches", "sum_err", "total_err"]
    # the new metric belongs to the new cell alone
    other = harness.Cell("h2o_1e8_k100.grid", str(checkout))
    assert "queries_per_s" not in [name for name, _, _ in other.metrics(False)]


def test_a_broken_new_call_is_not_correct(checkout):
    pb = checkout / "portbench"
    (pb / "calls" / "total.py").write_text(CALL.replace("question[\"expression\"])",
                                                        "question[\"expression\"]) * 1.001"))
    result, _ = harness.run("tiny.mix", 3, 0.2, False, "cpu", root=str(checkout))
    assert not result["correct"] and result["checks"]["total_err"][0] > 1e-4


@pytest.mark.parametrize("change", [{"loop": "open"}, {"loop": "closed", "clients": 4}],
                         ids=["unknown loop", "clients the loop does not run"])
def test_a_loop_it_cannot_run_is_refused(checkout, change):
    path = checkout / "portbench" / "traffic" / "tiny_mix.json"
    mix = json.loads(path.read_text())
    mix.update(change)
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="loops/open.py|one client"):
        harness.run("tiny.mix", 3, 0.2, False, "cpu", root=str(checkout))

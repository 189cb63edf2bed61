"""BENCHMARK.json against its format: keys, names, units, and every file
a cell is found by."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[group]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
                 + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_find_their_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    here = os.path.join(ROOT, "portbench")
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert os.path.isfile(os.path.join(here, "limits", f"{w['name']}.json"))
        with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
            mix = json.load(f)
        assert os.path.isfile(os.path.join(here, "loops", f"{mix['loop']}.py"))
        for q in mix["questions"]:
            for folder in ("calls", "reference"):
                assert os.path.isfile(os.path.join(here, folder, f"{q['call']}.py"))
        with open(os.path.join(ROOT, configs[w["config"]]["file"])) as f:
            config = json.load(f)
        for table in config["tables"].values():
            for spec in table["columns"].values():
                assert os.path.isfile(os.path.join(here, "columns", f"{spec['kind']}.py"))
    for c in configs.values():
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics", f"{m['name']}.py"))


def test_run_seconds_within_limits(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]

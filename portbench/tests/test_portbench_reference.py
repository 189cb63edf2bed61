"""Each question's plain reference against NumPy and pandas at a small
size, in float64."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import ROOT, small
from portbench import byname, tables

h2o_ref = byname.module("reference", "groupby")


def load(kind, name):
    with open(os.path.join(ROOT, "portbench", kind, f"{name}.json")) as f:
        return json.load(f)


H2O_QUESTIONS = (load("traffic", "h2o_grid")["questions"]
                 + load("traffic", "h2o_sort")["questions"])


@pytest.fixture(scope="module")
def h2o():
    made = tables.make(small(load("configs", "h2o_g1_1e8_k100")), 11, "cpu")
    frame = pd.DataFrame({k: v.numpy() for k, v in made["x"].items()})
    return made, frame


def pandas_answer(g, name, spec):
    fn, *args = [spec, name] if isinstance(spec, str) else spec
    if fn == "count":
        return g.size()
    if fn in ("sum", "mean", "max", "min", "median_approx"):
        return getattr(g[args[0]], "median" if fn == "median_approx" else fn)()
    if fn == "std":
        return g[args[0]].std(ddof=args[1]["ddof"])
    if fn == "nth_largest":
        k = args[1]
        return g[args[0]].apply(lambda s: s.nlargest(k + 1).iloc[k] if len(s) > k else np.nan)
    if fn == "corr":
        return g.apply(lambda d: d[args[0]].corr(d[args[1]]), include_groups=False)
    raise AssertionError(fn)


@pytest.mark.parametrize("question", H2O_QUESTIONS, ids=[q["name"] for q in H2O_QUESTIONS])
def test_h2o_question_against_pandas(h2o, question):
    made, frame = h2o
    want = h2o_ref.answer(question, made, torch.float64)
    g = frame.groupby(question["by"], sort=True)
    keys = g.size().index.to_frame(index=False)
    assert list(want) == question["by"] + list(question["agg"])
    for k in question["by"]:
        assert np.array_equal(want[k][1].numpy(), keys[k].to_numpy())
    for name, spec in question["agg"].items():
        kind, value, _ = want[name]
        expect = pandas_answer(g, name, spec).to_numpy()
        np.testing.assert_allclose(value.numpy(), expect, rtol=1e-12, atol=1e-12,
                                   equal_nan=True, err_msg=f"{question['name']} {name}")


def test_h2o_exact_kinds_and_scales(h2o):
    made, _ = h2o
    q3 = next(q for q in H2O_QUESTIONS if q["name"] == "q3")
    want = h2o_ref.answer(q3, made, torch.float64)
    assert want["v1"][0] == "exact" and want["v1"][1].dtype == torch.int64
    kind, mean, scale = want["v3"]
    assert kind == "sum_err" and torch.allclose(scale, mean)  # v3 >= 0: mean of |v3| is the mean
    q6 = next(q for q in H2O_QUESTIONS if q["name"] == "q6")
    kind, sd, scale = h2o_ref.answer(q6, made, torch.float64)["sd_v3"]
    assert kind == "sd_err" and torch.equal(scale, sd.abs())  # compared relatively

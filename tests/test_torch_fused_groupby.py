"""The one-sort groupby and the ten H2O questions, the port against
vaex_tpu on the same seeded arrays.

* All ten questions of ``benchmarks/groupbyh2o.py`` on a small H2O-shaped
  frame (2e4 rows, k = 10; raw keys, as the benchmark runs them).
* The one-sort plan in its packed mode (two keys whose span product passes
  1e6; one key whose span passes 2^22; ``sort=True`` and a descending
  single key) and in its unpacked mode (six keys in 1..2048: a span
  product past 2^62, which the classic path refuses), with the route each
  pass records.

Where the packages order rows differently, both frames are sorted by
their keys first.  Ints exact; floats to 1e-6 relative and 1e-7 absolute.
"""

import numpy as np
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, same_frames
from vaex_tpu_torch import fused_groupby


def _h2o(seed, n=20_000, k=10):
    """benchmarks/fixtures.py:28-40 at n rows and k groups, v3 with NaN."""
    rng = np.random.default_rng(seed)
    cols = {name: rng.integers(1, k + 1, n) for name in ("id1", "id2", "id4", "id5")}
    cols["id3"] = rng.integers(1, n // k + 1, n)
    cols["id6"] = rng.integers(1, n // k + 1, n)
    cols["v1"], cols["v2"] = rng.integers(1, 6, n), rng.integers(1, 16, n)
    cols["v3"] = rng.random(n) * 100
    cols["v3"][::29] = np.nan
    return {name: cols[name] for name in ("id1", "id2", "id3", "id4", "id5", "id6", "v1",
                                          "v2", "v3")}


def _questions(vt):
    """benchmarks/groupbyh2o.py:25-45."""
    a = vt.agg
    return {
        "q1": lambda df: df.groupby(["id1"], agg={"v1": "sum"}),
        "q2": lambda df: df.groupby(["id1", "id2"], agg={"v1": "sum"}),
        "q3": lambda df: df.groupby(["id3"], agg={"v1": "sum", "v3": a.mean("v3")}),
        "q4": lambda df: df.groupby(["id4"], agg={"v1": a.mean("v1"), "v2": a.mean("v2"),
                                                  "v3": a.mean("v3")}),
        "q5": lambda df: df.groupby(["id6"], agg={"v1": "sum", "v2": "sum", "v3": "sum"}),
        "q6": lambda df: df.groupby(["id4", "id5"],
                                    agg={"median_v3": a.median_approx("v3"),
                                         "sd_v3": a.std("v3", ddof=1)}),
        "q7": lambda df: df.groupby(["id3"], agg={"max_v1": a.max("v1"),
                                                  "min_v2": a.min("v2")}),
        "q8": lambda df: df.groupby(["id6"],
                                    agg={"largest1_v3": a.nth_largest("v3", 0),
                                         "largest2_v3": a.nth_largest("v3", 1)}),
        "q9": lambda df: df.groupby(["id2", "id4"], agg={"r2": a.corr("v1", "v2")}),
        "q10": lambda df: df.groupby(["id1", "id2", "id3", "id4", "id5", "id6"],
                                     agg={"v3": "sum", "v1": "count"}),
    }


KEYS = {"q1": ["id1"], "q2": ["id1", "id2"], "q3": ["id3"], "q4": ["id4"], "q5": ["id6"],
        "q6": ["id4", "id5"], "q7": ["id3"], "q8": ["id6"], "q9": ["id2", "id4"],
        "q10": ["id1", "id2", "id3", "id4", "id5", "id6"]}


@pytest.fixture(scope="module")
def h2o_frames():
    return same_frames(_h2o(1))


def _last(df):
    return df.executor.trace_log[-1]


@pytest.mark.parametrize("question", list(KEYS))
def test_h2o_question_matches_vaex_tpu(h2o_frames, question):
    ref, port = h2o_frames
    want = _questions(vaex_tpu)[question](ref)
    got = _questions(vaex_tpu_torch)[question](port)
    keys = KEYS[question]
    assert_same_frame(want.sort(keys), got.sort(keys))
    if question == "q10":  # 1e8 rows would be unpacked; 2e4 rows pack in one word
        assert {k: _last(port)[k] for k in ("groupby", "mode", "words")} == {
            "groupby": "one-sort", "mode": "packed", "words": 1}
    else:
        assert "groupby" not in _last(port)


def _wide_arrays(seed, n=4000):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, n)
    x[::23] = np.nan
    return {"a": rng.integers(0, 5000, n), "b": rng.integers(-300, 400, n),
            "w": rng.integers(-2 ** 40, 2 ** 40, n) // 1000 * 1000,
            "i8": rng.integers(-100, 100, n).astype(np.int8),
            "x": x, "iv": rng.integers(-2 ** 62, 2 ** 62, n), "f": rng.normal(0, 1, n),
            "bo": rng.random(n) < 0.5}


@pytest.fixture(scope="module")
def wide_frames():
    arrays = _wide_arrays(2)
    # 4000 rows over 1000 values of w: groups of several rows
    arrays["w"] = np.random.default_rng(3).choice(arrays["w"][:1000], len(arrays["w"]))
    return same_frames(arrays)


def _aggs(pkg):
    a = pkg.agg
    return {"c": "count", "cx": a.count("x"), "s": a.sum("x"), "si": a.sum("iv"),
            "s8": a.sum("i8"), "m": a.mean("x"), "lo": a.min("x"), "hi": a.max("iv"),
            "hi8": a.max("i8"), "v": a.var("f"), "sd": a.std("x", ddof=1),
            "med": a.median("x"), "sb": a.sum("bo")}


@pytest.mark.parametrize("keys", [["a", "b"], ["w"], ["b", "a", "i8"]])
def test_packed_mode_matches_vaex_tpu(wide_frames, keys):
    """Two keys whose span product passes 1e6, one whose span passes 2^22,
    three keys: one packed word each (int32 for the first two)."""
    ref, port = wide_frames
    want = ref.groupby(keys, agg=_aggs(vaex_tpu))
    got = port.groupby(keys, agg=_aggs(vaex_tpu_torch))
    assert_same_frame(want.sort(keys), got.sort(keys))
    assert {k: _last(port)[k] for k in ("groupby", "mode", "words")} == {
        "groupby": "one-sort", "mode": "packed", "words": 1}
    got_keys = np.stack([np.asarray(got.evaluate(k)) for k in keys])
    assert (np.lexsort(got_keys[::-1]) == np.arange(len(got))).all()  # sorted by the keys


@pytest.mark.parametrize("ascending", [True, False])
def test_a_single_wide_key_sorts_either_way(wide_frames, ascending):
    ref, port = wide_frames
    def aggs(pkg):
        return {"c": "count", "s": pkg.agg.sum("x"), "med": pkg.agg.median("f")}
    want = ref.groupby("w", agg=aggs(vaex_tpu), sort=True, ascending=ascending)
    got = port.groupby("w", agg=aggs(vaex_tpu_torch), sort=True, ascending=ascending)
    assert_same_frame(want, got)
    assert _last(port)["groupby"] == "one-sort"


def _six_keys(seed, n=3000):
    rng = np.random.default_rng(seed)
    arrays = {f"k{i}": rng.integers(1, 2049, n) for i in range(6)}
    arrays["k2"][:n // 2] = arrays["k2"][n // 2:]  # repeated combinations
    for i in (0, 1, 3, 4, 5):
        arrays[f"k{i}"][:n // 2] = arrays[f"k{i}"][n // 2:]
    arrays["k5"][:300] += 1  # and some that differ in the last key alone
    x = rng.normal(0, 1, n)
    x[::17] = np.nan
    arrays.update(x=x, iv=rng.integers(-1000, 1000, n), v3=rng.random(n) * 100)
    return arrays


SIX = [f"k{i}" for i in range(6)]


def test_unpacked_mode_six_keys_past_2_62(monkeypatch):
    """Six keys in 1..2048 span 2^66: the classic path raises, the one-sort
    plan sorts two words (five keys, then one) and answers as vaex_tpu."""
    ref, port = same_frames(_six_keys(4))
    aggs = lambda pkg: {"v3": "sum", "n": "count", "c": pkg.agg.count("x"),  # noqa: E731
                        "m": pkg.agg.mean("x"), "hi": pkg.agg.max("iv"),
                        "sd": pkg.agg.std("x"), "med": pkg.agg.median("x")}
    want = ref.groupby(SIX, agg=aggs(vaex_tpu))
    got = port.groupby(SIX, agg=aggs(vaex_tpu_torch))
    assert_same_frame(want.sort(SIX), got.sort(SIX))
    assert 1500 <= len(got) < 3000
    record = _last(port)
    assert (record["groupby"], record["mode"], record["words"], record["groups"]) == (
        "one-sort", "unpacked", 2, len(got))
    with pytest.raises(ValueError, match="one-sort path.*ROADMAP queue A8"):
        port.groupby(SIX).agg({"n": "count"})  # without agg=: the classic GrouperCombined
    # the plan sorts once per word: two sorts, then its reductions
    calls = []
    real = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: calls.append(1) or real(*a, **k))
    port.groupby(SIX, agg={"n": "count"})
    assert len(calls) == 2


@pytest.mark.parametrize("keys", [["w"], ["a", "b"], SIX])
def test_a_key_changed_in_place_is_measured_again(keys):
    """The words pack the keys over the ranges of the rows the sort loads:
    after a key column changed in place past what an earlier groupby
    measured (a wide key, two keys packed, six keys unpacked), no group
    merges and every key comes back as it is."""
    arrays = _six_keys(6) if keys == SIX else _wide_arrays(7)
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    first = port.groupby(keys, agg={"c": "count"})
    assert _last(port)["groupby"] == "one-sort"
    assert sum(first["c"].tolist()) == len(arrays[keys[0]])
    past = {"w": 2 ** 41, "a": 9000, "b": -1000, "k0": 5000, "k3": -3}
    for i, name in enumerate(k for k in keys if k in past):
        column = port.dataset[name]
        column[100 * i:100 * i + 100] = past[name]  # outside the measured range
        arrays[name] = np.asarray(column).copy()
    ref, _ = same_frames(arrays)
    aggs = lambda pkg: {"c": "count", "s": pkg.agg.sum("x")}  # noqa: E731
    got = port.groupby(keys, agg=aggs(vaex_tpu_torch))
    assert _last(port)["groupby"] == "one-sort"
    assert sum(got["c"].tolist()) == len(arrays[keys[0]])
    assert_same_frame(ref.groupby(keys, agg=aggs(vaex_tpu)).sort(keys), got.sort(keys))


def test_words_pack_greedily_below_2_62():
    spans = [(1, 100), (1, 100), (1, 10 ** 6), (1, 100), (1, 100), (1, 10 ** 6)]  # q10 at 1e8
    assert fused_groupby._words(spans) == [(0, 5), (5, 6)]
    assert fused_groupby._words([(0, 2 ** 31)] * 3) == [(0, 1), (1, 2), (2, 3)]
    assert fused_groupby._words([(0, 2 ** 30)] * 3) == [(0, 2), (2, 3)]
    assert fused_groupby._words([(0, 7)]) == [(0, 1)]
    keys = [torch.tensor([3, 1, 2]), torch.tensor([-5, 9, 0])]
    word = fused_groupby._pack(keys, [(1, 3), (-5, 15)], 0, 2)
    assert word.dtype == torch.int32
    back = fused_groupby._unpack(word.to(torch.int64), [(1, 3), (-5, 15)], 0, 2)
    assert all(torch.equal(k, b) for k, b in zip(keys, back))


@pytest.mark.parametrize("case", ["narrow key", "few combinations", "category", "filtered",
                                  "row limit", "selection", "virtual value", "masked key",
                                  "two percentages", "first", "descending pair",
                                  "key past 2^62"])
def test_the_plan_leaves_to_the_classic_path(wide_frames, case):
    """The shapes the one-sort plan does not take run the classic path and
    still answer as vaex_tpu."""
    ref, port = wide_frames
    if case == "masked key":
        arrays = _wide_arrays(5, n=2000)
        arrays["w"] = np.ma.MaskedArray(arrays["w"], np.arange(2000) % 9 == 0)
        ref, port = same_frames(arrays)
    keys, agg, kw = ["w"], {"c": "count", "s": "sum"}, {}
    aggs = {"c": lambda a: "count", "s": lambda a: a.sum("x")}
    if case == "narrow key":
        keys = ["b"]
    elif case == "few combinations":
        keys = ["b", "i8"]
    elif case == "category":
        ref, port = (df.categorize("b", min_value=-300, labels=list(range(-300, 400)))
                     for df in (ref, port))
        keys = ["b", "a"]
    elif case == "filtered":
        ref, port = ref[ref.x > 0], port[port.x > 0]
    elif case == "row limit":
        kw = {"row_limit": 10 ** 6}
    elif case == "selection":
        aggs["s"] = lambda a: a.sum("x", selection="f > 0")
    elif case == "virtual value":
        ref["y"], port["y"] = ref.x * 2, port.x * 2
        aggs["s"] = lambda a: a.sum("y")
    elif case == "two percentages":
        aggs["s"] = lambda a: a.percentile_approx("x", [10, 90])
    elif case == "first":
        aggs["s"] = lambda a: a.first("x", "f")
    elif case == "descending pair":
        keys, kw = ["a", "b"], {"sort": True, "ascending": [True, False]}
    elif case == "key past 2^62":
        keys = ["iv"]
    passes = port.executor.passes
    want = ref.groupby(keys, agg={n: f(vaex_tpu.agg) for n, f in aggs.items()}, **kw)
    got = port.groupby(keys, agg={n: f(vaex_tpu_torch.agg) for n, f in aggs.items()}, **kw)
    assert all("groupby" not in entry for entry in port.executor.trace_log[passes:])
    # (vaex_tpu sorts a descending key among several ascending: compare sorted)
    assert_same_frame(want.sort(keys), got.sort(keys))

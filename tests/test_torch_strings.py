"""String keys through every entry point of the port, against vaex_tpu on
the same seeded columns (``torch_port_helpers.string_arrays``: labels with
empty, non-ASCII and padded strings, nulls) in the three forms (plain,
dictionary, staged): groupby over one and several keys (``sort`` both
ways, ``agg=`` and ``.agg``), ``value_counts``, ``unique``, ``nunique``,
``isin``, ``map`` to and from strings, ``ordinal_encode``, ``categorize``,
``count``, selections and filters on string expressions, ``sort``, ``join``
(every ``how``, duplicates) and virtual columns of ``str_*``; the H2O
questions on string keys at a small size.

Where vaex_tpu is at fault the port is held to pandas or to vaex_tpu's
other form, and the test says so (ROADMAP, known problems of the
reference): a groupby of an unstaged frame over a string key of about 1000
distinct values or more (NameError), a comparison of strings with nulls as
a selection, a key made by ``str_*`` on a staged frame, the min / max of
strings."""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import (ATOL, RTOL, STRING_FORMS, assert_same_list, host_list,
                                string_arrays, string_frames)
from vaex_tpu_torch import settings

N = 3000


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


@pytest.fixture(scope="module", params=STRING_FORMS)
def frames(request):
    """(vaex_tpu frame, port frame, the vaex_tpu frame a grouping is held
    to): vaex_tpu drops the null rows of a dictionary column from its
    groups (its plain and staged forms keep them as a group), so a grouping
    of that form is held to its plain form."""
    arrays = string_arrays(11, N)
    ref, port = string_frames(arrays, request.param)
    group_ref = string_frames(arrays, "plain")[0] if request.param == "dictionary" else ref
    return ref, port, group_ref


def _rows(df, names):
    """A result frame's rows as a list of tuples (None where missing)."""
    return list(zip(*(host_list(df.evaluate(n)) for n in names)))


def _same_groups(ref_out, port_out, keys, values, ordered=True):
    assert port_out.get_column_names() == ref_out.get_column_names()
    want, got = _rows(ref_out, keys), _rows(port_out, keys)
    if not ordered:
        order_w = sorted(range(len(want)), key=lambda i: str(want[i]))
        order_g = sorted(range(len(got)), key=lambda i: str(got[i]))
        want, got = [want[i] for i in order_w], [got[i] for i in order_g]
    assert got == want
    for name in values:
        w, g = (np.asarray(host_list(df.evaluate(name)), dtype=np.float64)
                for df in (ref_out, port_out))
        if not ordered:
            w, g = w[order_w], g[order_g]
        npt.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("sort", [False, True])
def test_groupby_one_string_key(frames, sort):
    _, port, ref = frames
    agg = {"x": "sum", "c": "count", "m": vaex_tpu.agg.mean("iv")}
    pagg = {"x": "sum", "c": "count", "m": vaex_tpu_torch.agg.mean("iv")}
    _same_groups(ref.groupby("s", agg=agg, sort=sort), port.groupby("s", agg=pagg, sort=sort),
                 ["s"], ["x", "c", "m"], ordered=sort)


def test_groupby_then_agg(frames):
    _, port, ref = frames
    _same_groups(ref.groupby("s").agg({"x": "sum"}), port.groupby("s").agg({"x": "sum"}),
                 ["s"], ["x"], ordered=False)


@pytest.mark.parametrize("ascending", [True, False])
def test_groupby_one_string_key_sorted_both_ways(frames, ascending):
    """``sort=True`` orders the labels with the missing one last; descending
    reverses the order, the missing label first, as vaex_tpu does; the
    counts are pandas'."""
    _, port, ref = frames
    out = port.groupby("s", agg={"c": "count"}, sort=True, ascending=ascending)
    _same_groups(ref.groupby("s", agg={"c": "count"}, sort=True, ascending=ascending), out,
                 ["s"], ["c"])
    labels = host_list(out.evaluate("s"))
    present = sorted(v for v in labels if v is not None)
    assert [v for v in labels if v is not None] == (present if ascending else present[::-1])
    counts = pd.Series(string_arrays(11, N)["s"]).value_counts(dropna=False)
    got = dict(zip(labels, host_list(out.evaluate("c"))))
    assert got == {(None if not isinstance(k, str) else k): v for k, v in counts.items()}


@pytest.mark.parametrize("sort", [False, True])
def test_groupby_string_and_int_keys(frames, sort):
    _, port, ref = frames
    _same_groups(ref.groupby(["s", "g"], agg={"x": "sum"}, sort=sort),
                 port.groupby(["s", "g"], agg={"x": "sum"}, sort=sort), ["s", "g"], ["x"],
                 ordered=sort)


def test_groupby_two_string_keys_combined(frames):
    _, port, ref = frames
    _same_groups(ref.groupby(["s", "t"], agg={"x": "sum"}, assume_sparse=True),
                 port.groupby(["s", "t"], agg={"x": "sum"}, assume_sparse=True), ["s", "t"],
                 ["x"], ordered=False)


def test_value_counts_unique_nunique(frames):
    ref, port, _ = frames
    want, got = ref.s.value_counts(), port.s.value_counts()
    assert dict(got) == dict(want)
    assert list(got.to_numpy()) == list(want.to_numpy())
    for kw in ({}, {"dropna": True}):
        assert port.unique("s", **kw) == ref.unique("s", **kw)
        assert port.s.nunique(**kw) == ref.s.nunique(**kw)
    assert dict(port.s.value_counts(dropna=True)) == dict(ref.s.value_counts(dropna=True))


@pytest.mark.parametrize("values", [["a", "é", "zz"], ["", "日本語"], []])
def test_isin(frames, values):
    ref, port, _ = frames
    assert int(port.count(selection=port.s.isin(values))) == int(
        ref.count(selection=ref.s.isin(values)))
    assert host_list(port.s.isin(values).evaluate()) == host_list(ref.s.isin(values).evaluate())


def test_map_strings_to_numbers_and_back(frames):
    ref, port, _ = frames
    mapper = {"a": 1, "ab": 2, "é": 3, "": 4}
    assert host_list(port.s.map(mapper).evaluate()) == host_list(ref.s.map(mapper).evaluate())
    # numbers to strings: vaex_tpu cannot (its device _choose takes no str
    # array); pandas' map is the answer
    back = {0: "zero", 1: "one", 2: "二"}
    g = string_arrays(11, N)["g"]
    want = [back.get(v) for v in g.tolist()]
    assert host_list(port.g.map(back).evaluate()) == want


def test_ordinal_encode_and_categorize(frames):
    ref, port, _ = frames
    r, p = ref.ordinal_encode("s"), port.ordinal_encode("s")
    assert p.category_labels("s_ordinal") == r.category_labels("s_ordinal")
    assert host_list(p.evaluate("s_ordinal")) == host_list(r.evaluate("s_ordinal"))
    labels = ["ab", "a", "é"]
    c = port.categorize("s", labels=labels)
    out = c.groupby("s", agg={"n": "count"})
    assert host_list(out.evaluate("s")) == labels
    arr = string_arrays(11, N)["s"]
    assert host_list(out.evaluate("n")) == [int(sum(v == lab for v in arr)) for lab in labels]


def test_count_selections_and_filters(frames):
    """count of a string column (its nulls left out); selections and
    filters on string comparisons and functions, held to numpy over the
    Python values (vaex_tpu raises on a comparison of strings with nulls as
    a selection)."""
    ref, port, _ = frames
    assert int(port.count("s")) == int(ref.count("s"))
    s = string_arrays(11, N)["s"]
    for expression, want in (
            ("s == 'ab'", sum(v == "ab" for v in s)),
            ("s != 'ab'", sum(v is not None and v != "ab" for v in s)),
            ("s > 'b'", sum(v is not None and v > "b" for v in s)),
            ("str_len(s) > 2", sum(v is not None and len(v) > 2 for v in s)),
            ("str_contains(s, 'a') & (x > 0)", None)):
        if want is None:
            x = string_arrays(11, N)["x"]
            want = sum(v is not None and "a" in v and xv > 0 for v, xv in zip(s, x))
        assert int(port.count(selection=expression)) == want, expression
        assert len(port.filter(expression)) == want, expression


@pytest.mark.parametrize("by,ascending", [("s", True), ("s", False), (["s", "x"], True),
                                          (["s", "x"], [False, True]), (["g", "s"], [True, False])])
def test_sort(frames, by, ascending):
    """Strings sort by code point with a missing value as "" (vaex_tpu's
    rule); a descending string key among several is held to pandas (vaex_tpu
    sorts it ascending)."""
    ref, port, _ = frames
    got = host_list(port.sort(by, ascending=ascending).evaluate("x"))
    keys = [by] if isinstance(by, str) else by
    asc = ascending if isinstance(ascending, list) else [ascending] * len(keys)
    if len(keys) == 1 or all(asc):
        assert got == host_list(ref.sort(by, ascending=ascending).evaluate("x"))
        return
    arrays = string_arrays(11, N)
    pdf = pd.DataFrame({k: [("" if v is None else v) for v in arrays[k]] if k in ("s", "t")
                        else arrays[k] for k in set(keys) | {"x"}})
    want = pdf.sort_values(keys, ascending=asc, kind="stable")["x"].tolist()
    assert got == want


@pytest.mark.parametrize("how", ["left", "inner", "right"])
def test_join_on_a_string_key(how):
    rng = np.random.default_rng(4)
    labels = np.asarray(["a", "b", "é", "", "zz", "q"], dtype=object)
    left = {"k": labels[rng.integers(0, 6, 200)], "x": rng.normal(size=200)}
    left["k"][::17] = None
    right = {"k": labels[[0, 1, 2, 2, 3, 4]].astype(object), "y": np.arange(6.0)}
    for form in STRING_FORMS:
        (ref_l, port_l), (ref_r, port_r) = (string_frames(a, form) for a in (left, right))
        if form == "staged":  # vaex_tpu's staged frames clash on their hidden codes
            (ref_l, _), (ref_r, _) = (string_frames(a, "plain") for a in (left, right))
        ref = ref_l.join(ref_r, on="k", how=how, allow_duplication=True)
        port = port_l.join(port_r, on="k", how=how, allow_duplication=True)
        assert len(port) == len(ref), form
        for name in ("x", "y"):
            assert_same_list(host_list(port.evaluate(name)), host_list(ref.evaluate(name)))
    with pytest.raises(ValueError, match="allow_duplication"):
        port_l.join(port_r, on="k")


def test_virtual_columns_of_string_functions(frames):
    """A virtual column of ``str_upper`` as a key; against vaex_tpu's plain
    frame (vaex_tpu raises KeyError for it on a staged frame)."""
    _, port, _ = frames
    ref = string_frames(string_arrays(11, N), "plain")[0]
    for df in (ref, port):
        df["u"] = df.s.str.upper()
        df["n"] = df.s.str.len() * 2
    _same_groups(ref.groupby("u", agg={"x": "sum", "c": "count"}, sort=True),
                 port.groupby("u", agg={"x": "sum", "c": "count"}, sort=True), ["u"],
                 ["x", "c"])
    assert int(port.sum("n")) == int(ref.sum("n"))


def test_min_max_mode_of_strings_raise(frames):
    """vaex_tpu gives a dictionary code for the min of a staged column and
    raises on a plain one; the port raises TypeError in every form."""
    _, port, _ = frames
    for call in (lambda: port.min("s"), lambda: port.max("s"), lambda: port.mode("s"),
                 lambda: port.sum("s"), lambda: port.first("s", "x"),
                 lambda: port.groupby("g", agg={"m": vaex_tpu_torch.agg.max("s")})):
        with pytest.raises(TypeError, match="strings"):
            call()


@pytest.mark.parametrize("n_keys", [1000, 2500])
def test_many_string_keys_on_a_host_frame(n_keys):
    """vaex_tpu raises NameError for a groupby of an unstaged frame over a
    string key of about 1000 distinct values or more (its dense_rank route
    reads the raw key in the device scope); the port is held to vaex_tpu's
    staged frame, and to pandas."""
    rng = np.random.default_rng(n_keys)
    labels = np.asarray([f"key{i:05d}" for i in range(n_keys)], dtype=object)
    arrays = {"s": labels[rng.integers(0, n_keys, 20000)], "x": rng.normal(size=20000)}
    with pytest.raises(NameError):
        vaex_tpu.from_arrays(**arrays).groupby("s", agg={"x": "sum"})
    ref = vaex_tpu.from_arrays(**arrays).to_device().groupby("s", agg={"x": "sum"}, sort=True)
    port = vaex_tpu_torch.from_arrays(**arrays).groupby("s", agg={"x": "sum"}, sort=True)
    _same_groups(ref, port, ["s"], ["x"])
    want = pd.DataFrame(arrays).groupby("s")["x"].sum()
    assert host_list(port.evaluate("s")) == list(want.index)


H2O_LABELS = [f"id{i:03d}" for i in range(1, 11)]


@pytest.fixture(scope="module")
def h2o_frames():
    """H2O's table at 2e4 rows with string id1-id3 (10 labels each)."""
    rng = np.random.default_rng(42)
    n = 20000
    lab = np.asarray(H2O_LABELS, dtype=object)
    arrays = {"id1": lab[rng.integers(0, 10, n)], "id2": lab[rng.integers(0, 10, n)],
              "id3": lab[rng.integers(0, 10, n)],
              "id4": rng.integers(1, 11, n).astype(np.int64),
              "id5": rng.integers(1, 11, n).astype(np.int64),
              "id6": rng.integers(1, 201, n).astype(np.int64),
              "v1": rng.integers(1, 6, n).astype(np.int64),
              "v2": rng.integers(1, 16, n).astype(np.int64), "v3": rng.random(n) * 100}
    return (vaex_tpu.from_arrays(**arrays).to_device(),
            vaex_tpu_torch.from_arrays(**arrays).to_device("cpu"))


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 11)])
def test_h2o_questions_on_string_keys(h2o_frames, q):
    from benchmarks.groupbyh2o import questions
    ref, port = h2o_frames
    want = questions(vaex_tpu)[q](ref)
    got = questions(vaex_tpu_torch)[q](port)
    names = want.get_column_names()
    keys = [n for n in names if n.startswith("id")]
    _same_groups(want, got, keys, [n for n in names if n not in keys], ordered=False)


def test_count_binned_by_a_string_category(frames):
    """``binby`` over a string category counts each label's rows, the null
    rows in the last bin, as its groupby does; plain strings are made a
    category by ``ordinal_encode`` first."""
    _, port, group_ref = frames
    key = "s"
    if not port.is_category("s"):
        port, key = port.ordinal_encode("s"), "s_ordinal"
    counts = port.count(binby=key)
    assert counts.tolist() == host_list(port.groupby(key, agg={"c": "count"}).evaluate("c"))
    want = host_list(group_ref.groupby("s", agg={"c": "count"}).evaluate("c"))
    if key == "s_ordinal":  # the null rows fall outside the ordinals' labels
        want = host_list(group_ref.groupby("s", agg={"c": "count"}, sort=True).evaluate("c"))[:-1]
    assert sorted(counts.tolist()) == sorted(want)


# ------------------------------------- faults of the reference, pinned (ROADMAP)


def test_fillna_skips_strings_in_every_form():
    """vaex_tpu's ``fillna`` skips a plain string column but fills a
    dictionary or staged one (vaex_tpu/dataframe.py:1641-1643); the port
    skips a string column in every form, as vaex_tpu's plain form does."""
    arrays = string_arrays(5, 60)
    want = list(arrays["s"])
    for form in STRING_FORMS:
        ref, port = string_frames(arrays, form)
        assert host_list(port.fillna("zz").evaluate("s")) == want
        filled = host_list(ref.fillna("zz").evaluate("s"))
        assert (filled == want) == (form == "plain")


@pytest.mark.parametrize("rows", ["slice", "sample", "concat"])
def test_groupby_over_rows_of_a_dictionary_frame(rows):
    """vaex_tpu raises ``KeyError`` for a groupby over a slice, a sample or a
    concat of a frame of dictionary arrays; the port is held to Python."""
    import collections
    arrays = string_arrays(5, 60)
    ref, port = string_frames(arrays, "dictionary")
    take = {"slice": lambda d: d[5:40], "sample": lambda d: d.sample(n=30, random_state=3),
            "concat": lambda d: d.concat(d)}[rows]
    values = host_list(take(port).evaluate("s"))
    out = take(port).groupby("s", agg="count")
    got = {k: c for k, c in zip(host_list(out["s"].values), out["count"].tolist()) if c}
    assert got == dict(collections.Counter(values))
    with pytest.raises(KeyError):
        take(ref).groupby("s", agg="count")


@pytest.mark.parametrize("form", STRING_FORMS)
@pytest.mark.parametrize("expression", ["t < 'b'", "t >= 'b'", "s == t"])
def test_string_order_comparisons_and_two_columns(form, expression):
    """vaex_tpu raises ``TypeError`` for the order comparisons of strings and
    for ``s == t``; the port is held to Python."""
    arrays = string_arrays(5, 60)
    ref, port = string_frames(arrays, form)
    s, t = list(arrays["s"]), list(arrays["t"])
    want = {"t < 'b'": sum(v < "b" for v in t), "t >= 'b'": sum(v >= "b" for v in t),
            "s == t": sum(a is not None and a == b for a, b in zip(s, t))}[expression]
    assert port.count(selection=expression) == want
    with pytest.raises(TypeError):
        ref.count(selection=expression)

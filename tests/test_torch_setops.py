"""The port's set API against vaex_tpu on the same arrays (the port on
device="cpu"): ``_set``, ``unique``, ``nunique``, ``value_counts``, ``isin``,
``map``, filters and ``selection=``.  The numeric cases of
tests/test_setops.py, plus NaN, -0.0, both infinities and masked keys.

Keys, ordinals, counts and int sums are exact; float statistics hold to 1e-6
relative and 1e-7 absolute.
"""

import numpy as np
import numpy.testing as npt
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, key_arrays, same_frames, same_set
from vaex_tpu_torch.ops.setops import RowLimitException, SortedSet

KEYS = ["k", "w", "f", "m", "fm", "b"]
N = 4_000


@pytest.fixture(scope="module")
def frames():
    return same_frames(key_arrays(21, N), tile_rows=777)


def _same_values(got, want):
    """Two lists of distinct values: equal, NaN and None included."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or g is None:
            assert g is None and w is None
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g)
        else:
            assert g == w and np.signbit(g) == np.signbit(w)


@pytest.mark.parametrize("keep_counts", [False, True])
@pytest.mark.parametrize("key", KEYS + ["k * 3 + b", "x"])
def test_set_matches_vaex_tpu(frames, key, keep_counts):
    ref, port = frames
    same_set(ref._set(key, keep_counts=keep_counts), port._set(key, keep_counts=keep_counts))


def test_set_sees_only_the_rows_the_filter_keeps(frames):
    ref, port = frames
    same_set(ref[ref.k > 5]._set("fm", keep_counts=True),
             port[port.k > 5]._set("fm", keep_counts=True))


def test_set_of_infinite_keys():
    """A float key with both infinities builds on the pass device (the
    reference leaves its device build for the host path on them)."""
    x = np.array([np.inf, 1.0, -np.inf, np.nan, 1.0, np.inf])
    oset = vaex_tpu_torch.from_arrays(x=x).to_device("cpu")._set("x", keep_counts=True)
    assert oset.keys.tolist() == [-np.inf, 1.0, np.inf]
    assert oset.counts.tolist() == [1, 2, 2] and oset.nan_count == 1


@pytest.mark.parametrize("drop", [{}, {"dropna": True}, {"dropnan": True},
                                  {"dropmissing": True}])
@pytest.mark.parametrize("key", KEYS)
def test_unique_and_nunique(frames, key, drop):
    ref, port = frames
    # vaex_tpu gives the values in ordinal order too: ascending, NaN, None
    _same_values(port.unique(key, **drop), ref.unique(key, **drop))
    _same_values(port[key].unique(**drop), ref[key].unique(**drop))
    assert port[key].nunique(**drop) == ref[key].nunique(**drop)


@pytest.mark.parametrize("key", ["k", "f", "fm"])
def test_unique_return_inverse(frames, key):
    ref, port = frames
    want_values, want_inverse = ref.unique(key, return_inverse=True)
    got_values, got_inverse = port.unique(key, return_inverse=True)
    _same_values(got_values, want_values)
    npt.assert_array_equal(np.asarray(got_inverse), np.asarray(want_inverse))
    assert np.asarray(got_inverse).min() >= 0  # every row finds its value


def test_unique_of_a_selection(frames):
    ref, port = frames
    _same_values(port.unique("w", selection="k < 2"), ref.unique("w", selection="k < 2"))


@pytest.mark.parametrize("limit_raise", [True, False])
def test_unique_limit(frames, limit_raise):
    _, port = frames
    if limit_raise:
        with pytest.raises(RowLimitException):
            port.unique("x", limit=3)
        with pytest.raises(vaex_tpu_torch.RowLimitException):
            port.x.unique(limit=3)
    else:
        assert len(port.unique("w", limit=3, limit_raise=False)) == 50
    assert len(port.unique("b", limit=7)) == 7  # at the limit, not past it


@pytest.mark.parametrize("drop", [{}, {"dropna": True}, {"dropmissing": True},
                                  {"ascending": True}])
@pytest.mark.parametrize("key", ["k", "m", "fm"])
def test_value_counts(frames, key, drop):
    ref, port = frames
    want, got = ref[key].value_counts(**drop), port[key].value_counts(**drop)
    npt.assert_array_equal(got.to_numpy(), want.to_numpy())  # the counts, in order
    as_dict = lambda s: {("nan" if isinstance(k, float) and np.isnan(k) else k): v  # noqa: E731
                         for k, v in s.items()}
    assert as_dict(got) == as_dict(want)


VALUES = {
    "k": [0, 2, 39, 1000],
    "w": [0, 7 * 1_000_003, 5, 49 * 1_000_003],
    "f": [1.5, 0.0, np.inf, 3.0],
    "f_nan": [np.nan, -2.0],
    "m": [1, 8, 22],
    "fm": [2.0, np.nan],
    "b": np.array([6, 0], dtype=np.int64),
}


@pytest.mark.parametrize("case", sorted(VALUES))
def test_isin(frames, case):
    ref, port = frames
    key = case.split("_")[0]
    want = ref[key].isin(VALUES[case])
    got = port[key].isin(VALUES[case])
    npt.assert_array_equal(np.asarray(got.evaluate(), bool),
                           np.asarray(want.evaluate(array_type="numpy"), bool))
    assert int(port.count(selection=got)) == int(ref.count(selection=str(want)))
    assert port.executor.trace_log[-1]["probe"] == "b6"
    assert len(port[got]) == len(ref[want])


def test_isin_of_several_columns(frames):
    ref, port = frames
    want = ref.isin([3, 5], column_names=["k", "b"])
    got = port.isin([3, 5], column_names=["k", "b"])
    npt.assert_array_equal(np.asarray(got.evaluate(), bool),
                           np.asarray(want.evaluate(array_type="numpy"), bool))


@settings(max_examples=25, deadline=None)
@given(keys=st.lists(st.integers(-50, 50), min_size=0, max_size=30),
       rows=st.lists(st.integers(-60, 60), min_size=1, max_size=60))
def test_isin_drawn_keys(keys, rows):
    rows = np.asarray(rows, dtype=np.int64)
    port = vaex_tpu_torch.from_arrays(r=rows).to_device("cpu")
    got = port.r.isin(np.asarray(keys, dtype=np.int64)).evaluate()
    npt.assert_array_equal(np.asarray(got, bool), np.isin(rows, keys))
    assert int(port.count(selection=port.r.isin(np.asarray(keys, dtype=np.int64)))) == int(
        np.isin(rows, keys).sum())


def test_map(frames):
    ref, port = frames
    mapper = {0: 10, 1: 20, 5: -7, 39: 1}
    want = ref.k.map(mapper).tolist()
    got = port.k.map(mapper).tolist()
    assert got == want and None in got and 10 in got
    mapper = {1.5: 0.25, np.inf: 9.0, np.nan: -1.0}
    assert port.f.map(mapper).tolist() == ref.f.map(mapper).tolist()
    npt.assert_allclose(float(port.sum(port.k.map({0: 1.5, 2: 2.5}))),
                        float(ref.sum(ref.k.map({0: 1.5, 2: 2.5}))), rtol=RTOL, atol=ATOL)


def test_string_keys_raise_naming_their_roadmap_item():
    """String sets, string isin and a map to strings, which waited for
    ROADMAP A9, now agree with vaex_tpu: a SortedSet of strings built from
    the same chunks, an isin of string values, a map of numbers to strings
    (held to Python's dict lookup: vaex_tpu's map cannot make strings)."""
    from vaex_tpu.ops.setops import SortedSet as RefSet
    values = np.asarray(["b", "a", "é", "", "a", "zz"], dtype=object)
    ref, port = RefSet("string", keep_counts=True), SortedSet("string", keep_counts=True)
    for chunk in (values[:3], values[3:]):
        ref.update(chunk)
        port.update(chunk)
    same_set(ref, port)
    npt.assert_array_equal(port.map_ordinal(values), ref.map_ordinal(values))
    arrays = {"s": values[np.random.default_rng(3).integers(0, 6, 500)], "k": np.arange(500) % 4}
    ref_df = vaex_tpu.from_arrays(**arrays)
    port_df = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    assert int(port_df.count(selection=port_df.s.isin(["a", "é"]))) == int(
        ref_df.count(selection=ref_df.s.isin(["a", "é"])))
    mapped = port_df.k.map({1: "one", 2: "two"}).tolist()
    assert mapped == [{1: "one", 2: "two"}.get(k) for k in arrays["k"].tolist()]


def test_sorted_set_on_the_host():
    """update / merge / map_ordinal / isin of a host-built set against
    vaex_tpu's."""
    from vaex_tpu.ops.setops import SortedSet as RefSet
    rng = np.random.default_rng(5)
    chunks = [np.ma.MaskedArray(rng.choice([1.0, 2.5, np.nan, -0.0, 8.0], 50),
                                rng.random(50) < 0.2) for _ in range(3)]
    ref, port = RefSet(np.float64, keep_counts=True), SortedSet(np.float64, keep_counts=True)
    for chunk in chunks[:2]:
        ref.update(chunk)
        port.update(chunk)
    other_ref, other = RefSet(np.float64, keep_counts=True), SortedSet(np.float64,
                                                                     keep_counts=True)
    other_ref.update(chunks[2])
    other.update(chunks[2])
    ref.merge(other_ref)
    port.merge(other)
    same_set(ref, port)
    probe = np.ma.MaskedArray([1.0, 3.0, np.nan, 0.0, 8.0], [False, False, False, False, True])
    got, want = port.map_ordinal(probe), ref.map_ordinal(probe)
    npt.assert_array_equal(got, want)
    assert got.dtype == np.asarray(want).dtype == np.int8
    npt.assert_array_equal(port.isin(probe), ref.isin(probe))
    assert port.fingerprint() == port.fingerprint() != other.fingerprint()
    with pytest.raises(RowLimitException):
        SortedSet(np.int64, limit=2).update(np.arange(3))


def test_variables_are_named_by_content(frames):
    _, port = frames
    a, b = port.k.isin([1, 2, 3]), port.k.isin([3, 2, 1, 1])
    assert a.expression == b.expression  # the same set, the same name, kept once
    assert a.expression != port.k.isin([1, 2]).expression
    name = a.expression.split(", ")[1].rstrip(")")
    assert name in port.variables and name in port.copy().variables
    from vaex_tpu_torch.scopes import column_names, variable_names
    assert column_names(a.expression, port.variables) == {"k"}
    assert variable_names(a.expression, port.variables) == {name}


# ------------------------------------------------------ filters and selections
STATS = ["count", "sum", "mean", "std", "min", "max"]


def _stat(df, stat, **kwargs):
    if stat == "count":
        return df.count(**kwargs)
    return getattr(df, stat)("x", **kwargs)


def _close(got, want):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                        rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def categorized():
    ref, port = same_frames(key_arrays(22, N), "b", labels=list(range(7)), tile_rows=999)
    return ref, port


@pytest.mark.parametrize("binby", [False, True])
@pytest.mark.parametrize("stat", STATS)
def test_selection_on_a_statistic(categorized, stat, binby):
    ref, port = categorized
    kwargs = {"binby": "b"} if binby else {}
    for selection in ("k > 5", "(f > 0) & (m < 4)"):  # the second is missing on some rows
        _close(_stat(port, stat, selection=selection, **kwargs),
               _stat(ref, stat, selection=selection, **kwargs))
    _close(_stat(port, stat, selection=port.k.isin([1, 2, 30]), **kwargs),
           _stat(ref, stat, selection=str(ref.k.isin([1, 2, 30])), **kwargs))


@pytest.mark.parametrize("binby", [False, True])
@pytest.mark.parametrize("stat", STATS)
def test_statistic_of_a_filtered_frame(categorized, stat, binby):
    ref, port = categorized
    kwargs = {"binby": "b"} if binby else {}
    rf, pf = ref[ref.k > 5], port[port.k > 5]
    _close(_stat(pf, stat, **kwargs), _stat(rf, stat, **kwargs))
    # a selection on top of the filter
    _close(_stat(pf, stat, selection="iv < 0", **kwargs),
           _stat(rf, stat, selection="iv < 0", **kwargs))


def test_selections_share_a_pass_but_not_a_task(categorized):
    _, port = categorized
    a = port.sum("x", selection="k > 5", delay=True)
    b = port.sum("x", delay=True)
    c = port.count(selection="k > 5", delay=True)
    passes = port.executor.passes
    port.execute()
    assert port.executor.passes == passes + 1
    assert len(port.executor.trace_log[-1]["strategies"]) == 2
    arrays = key_arrays(22, N)
    keep = arrays["k"] > 5
    _close(a.get(), arrays["x"][keep].sum())
    _close(b.get(), arrays["x"].sum())
    assert int(c.get()) == int(keep.sum())


def test_agg_descriptors_take_a_selection(categorized):
    ref, port = categorized
    aggs = lambda pkg: {  # noqa: E731
        "c": pkg.agg.count(selection="k > 5"), "s": pkg.agg.sum("x", selection="k > 5"),
        "sd": pkg.agg.std("x", selection="iv < 0"), "lo": pkg.agg.min("x", selection="k > 5"),
        "hi": pkg.agg.max("iv", selection="iv < 0"), "all": pkg.agg.sum("iv")}
    want = ref.groupby("b", agg=aggs(vaex_tpu), sort=True)
    got = port.groupby("b", agg=aggs(vaex_tpu_torch), sort=True)
    for name in want.get_column_names():
        _close(got[name].tolist(), want[name].tolist())


@pytest.mark.parametrize("mode", ["and", "or", "replace"])
def test_filter_modes_len_and_evaluate(categorized, mode):
    ref, port = categorized
    rf = ref.filter("k > 5").filter("iv < 0", mode=mode)
    pf = port.filter("k > 5").filter(port.iv < 0, mode=mode)
    assert pf.filtered and not port.filtered
    assert len(pf) == len(rf) == int(pf.count())
    npt.assert_array_equal(pf.evaluate("iv"), np.asarray(rf.evaluate("iv")))
    npt.assert_allclose(pf.evaluate("x * 2"), np.asarray(rf.evaluate("x * 2")))
    assert len(pf.copy()) == len(rf) and pf.copy().filtered
    got, want = pf.evaluate("m"), rf.evaluate("m")
    npt.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
    npt.assert_array_equal(np.ma.getdata(got)[~np.ma.getmaskarray(got)],
                           np.ma.getdata(want)[~np.ma.getmaskarray(want)])


def test_filtered_frame_refuses_what_is_not_ported(categorized):
    """A filtered frame's sort, take and slice, ported since, give vaex_tpu's
    rows (among the rows the filter keeps), masked values included.  Named
    selections and lists of selections give vaex_tpu's results beside a
    filter, and selection=True without a selection raises as in vaex_tpu."""
    ref, port = categorized
    rf, pf = ref[ref.k > 5], port[port.k > 5]
    for run in (lambda df: df.sort("k"), lambda df: df.take([0, 1, -1, 7]),
                lambda df: df[2:5], lambda df: df.sort(["b", "iv"], ascending=[False, True])):
        got, want = run(pf), run(rf)
        assert not got.filtered and len(got) == len(want)
        for name in ("k", "iv", "m", "fm", "x"):
            npt.assert_equal(got[name].tolist(), want[name].tolist(), err_msg=name)
    ref, port = ref.copy(), port.copy()
    for df in (ref, port):
        with pytest.raises(ValueError, match="no selection is active"):
            df.sum("x", selection=True)
        df.select("k > 5")
    _close(port.sum("x", selection=True), ref.sum("x", selection=True))
    _close(port.sum("x", selection=["k > 5", "iv < 0"]),
           ref.sum("x", selection=["k > 5", "iv < 0"]))
    _close(port.filter("iv < 0").mean("x", selection=[None, True]),
           ref.filter("iv < 0").mean("x", selection=[None, True]))
    with pytest.raises(ValueError, match="filter mode"):
        port.filter("k > 5", mode="xor")

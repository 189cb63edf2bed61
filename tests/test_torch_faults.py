"""The port's faults C6-C8 (found against the reference), each held to
vaex_tpu or numpy on the same seeded arrays:

* C6: temporal arithmetic in an expression carries numpy's datetime64 /
  timedelta64 dtype (units aligned, NaT in gives NaT out), in ``data_type``,
  ``evaluate``, ``min`` and ``max``; a datetime64 variable is its count in
  its own unit; an operation the port does not carry raises, never a number;
* C7: ``x.astype('float32')`` inside an expression string;
* C8: a min or max without binby over an expression that is not one value
  per row raises, as ``sum`` and the reference do;
* C9: a continuous axis bins each value where vaex_tpu's jitted pass does,
  also at the bin edges: 29 of limits [0, 50] at 50 bins lands in bin 29;
* C12: a shifted or materialized string column keeps its labels, in each
  of the three string forms (held to vaex_tpu);
* C13: NaT rows take no part in sums, means, moments and ``first``'s
  order, and sums and means keep numpy's temporal dtype (held to numpy:
  vaex_tpu raises on the sums and counts NaT as 0 in ``std``);
* C14: ``concat`` merges the labels of staged string columns, and keeps a
  category only where every frame has it alike (held to the concatenation
  of the plain forms; vaex_tpu loses rows there).
"""

import collections

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu_torch
from torch_port_helpers import (ATOL, RTOL, STRING_FORMS, binby_arrays, host_list, same_frames,
                                string_arrays, string_frames)
from vaex_tpu_torch import settings

# the cases of ROADMAP queue C6: d datetime64[ns] with NaT, td timedelta64[s]
TEMPORAL = ["d + td", "d - d", "td * 2", "td + td", "-td", "abs(td)", "td // 2", "td / 2",
            "d - td", "2 * td"]


@pytest.fixture(scope="module")
def temporal_frames():
    return same_frames(binby_arrays(5, 4000))


def _same_values(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    npt.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("expression", TEMPORAL)
def test_temporal_arithmetic_carries_numpys_dtype(temporal_frames, expression):
    ref, port = temporal_frames
    want_dtype = ref.data_type(expression)
    assert want_dtype.numpy.kind in "Mm"
    assert port.data_type(expression).numpy == want_dtype.numpy
    _same_values(port.evaluate(expression), ref.evaluate(expression))
    for stat in ("min", "max"):
        got, want = getattr(port, stat)(expression), getattr(ref, stat)(expression)
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert got == want, stat


# numpy's own answers where the reference takes no part: negative values,
# division by zero, float factors and the quotients of two timedeltas
NUMPY_CASES = ["td * 2.5", "td / 2.5", "td // -3", "td / 0", "td // td", "td % td", "td / td",
               "td > 0", "d == d", "d != d", "d < d + td", "1 + td", "td - 7", "+td"]


@pytest.mark.parametrize("expression", NUMPY_CASES)
def test_temporal_values_match_numpy(expression):
    arrays = binby_arrays(6, 500)
    td = arrays["td"].copy()
    td[::7] = np.timedelta64("NaT")
    td[::11] = np.timedelta64(0, "s")
    arrays["td"] = td
    port = vaex_tpu_torch.from_arrays(d=arrays["d"], td=td).to_device("cpu")
    with np.errstate(all="ignore"):
        want = eval(expression, {}, {"d": arrays["d"], "td": td})
    got = port.evaluate(expression)
    assert got.dtype == want.dtype
    if want.dtype.kind == "f":
        npt.assert_array_equal(got, want)
    else:
        npt.assert_array_equal(np.asarray(got).view(np.int64) if want.dtype.kind in "Mm"
                               else got, want.view(np.int64) if want.dtype.kind in "Mm"
                               else want)


def test_a_datetime_variable_is_its_count_in_its_unit(temporal_frames):
    ref, port = (df.copy() for df in temporal_frames)
    t0 = np.datetime64("2021-01-01")
    for df in (ref, port):
        df.add_variable("t0", t0)
    assert int(port.count(selection="d > t0")) == int(ref.count(selection="d > t0"))
    assert port.data_type("d - t0").numpy == ref.data_type("d - t0").numpy
    assert port.min("d - t0") == ref.min("d - t0")
    assert port.max("td + (d - t0)") == ref.max("td + (d - t0)")


@pytest.mark.parametrize("expression,error", [
    ("td % 7", TypeError),            # numpy has no such loop
    ("d + d", TypeError),
    ("-d", TypeError),
    ("sqrt(td)", TypeError),  # the host stage: numpy refuses, as in vaex_tpu
    ("td ** 2", TypeError),
    ("round(td)", TypeError),
    ("where(td > 0, td, 0)", None),  # the host stage answers, as vaex_tpu does
    ("astype(td, 'timedelta64[ms]')", None),
])
def test_an_uncarried_temporal_operation_raises(temporal_frames, expression, error):
    """What the device stage does not carry for a temporal value runs in the
    host stage with numpy (ROADMAP A9): where numpy refuses it raises
    TypeError as vaex_tpu does, else its values and dtype are vaex_tpu's."""
    ref, port = temporal_frames
    if error is not None:
        if expression not in ("td % 7", "d + d", "-d"):  # vaex_tpu gives KeyError for those
            with pytest.raises(error):
                ref.evaluate(expression)
        with pytest.raises(error):
            port.evaluate(expression)
        return
    _same_values(port.evaluate(expression), ref.evaluate(expression))
    assert port.data_type(expression).numpy == ref.data_type(expression).numpy
    assert port.min(expression) == ref.min(expression)


def test_where_and_astype_keep_a_temporal_dtype(temporal_frames):
    """``where`` against the reference; ``astype`` to a temporal dtype
    against numpy (the reference's device half refuses it)."""
    ref, port = temporal_frames
    _same_values(port.evaluate("where(td > 0, td, -td)"), ref.evaluate("where(td > 0, td, -td)"))
    d, td, xi = (ref.evaluate(name) for name in ("d", "td", "xi"))
    for expression, want in (("astype(td, 'timedelta64[s]')", td),
                             ("astype(xi, 'timedelta64[s]')", xi.astype("m8[s]")),
                             ("astype(d, 'int64')", d.astype(np.int64))):
        _same_values(port.evaluate(expression), want)


@pytest.mark.parametrize("staged", [True, False])
def test_astype_method_in_an_expression_string(monkeypatch, staged):
    arrays = binby_arrays(7, 3000)
    ref, port = same_frames(arrays)
    if not staged:  # a host frame: its passes run on settings.DEVICE
        monkeypatch.setattr(settings, "DEVICE", "cpu")
        port = vaex_tpu_torch.from_arrays(**arrays)
    for expression in ("x.astype('float32')", "iv.astype('float64')", "xi.astype('int8') * 2"):
        want = ref.evaluate(expression)
        got = port.evaluate(expression)
        assert got.dtype == np.asarray(want).dtype
        npt.assert_array_equal(got, want)
        assert port.data_type(expression).numpy == ref.data_type(expression).numpy
    method = port.sum("x.astype('float32')")
    assert method == port.sum("astype(x, 'float32')") == port.x.astype("float32").sum()
    assert method == ref.sum("x.astype('float32')")


@pytest.mark.parametrize("stat", ["min", "max", "sum"])
def test_a_statistic_of_an_expression_of_another_length_raises(stat):
    ref, port = same_frames(binby_arrays(8, 3000))
    expression = "searchsorted([-1, 0, 1], x)"  # three values, not one per row
    with pytest.raises(ValueError):
        getattr(ref, stat)(expression)
    with pytest.raises(ValueError, match="does not match"):
        getattr(port, stat)(expression)


@pytest.fixture(scope="module")
def edge_frames():
    """An int64 key in 0..49 (every value an edge of [0, 50] at 50 and 100
    bins), its float32 copy, an int32 and a float32 value (seed 3)."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 50, 5000).astype(np.int64)
    return same_frames({"k": k, "kf": k.astype(np.float32),
                        "i": rng.integers(-1000, 1000, 5000).astype(np.int32),
                        "y": rng.normal(0, 1, 5000).astype(np.float32)})


@pytest.mark.parametrize("shape", [50, 100])
@pytest.mark.parametrize("axis", ["k", "kf"])
@pytest.mark.parametrize("stat,column", [("count", None), ("sum", "i"), ("sum", "y"),
                                         ("min", "y"), ("max", "y"), ("min", "i"),
                                         ("max", "i")])
def test_bins_at_the_edges_match_vaex_tpu(edge_frames, shape, axis, stat, column):
    ref, port = edge_frames
    got = getattr(port, stat)(column, binby=axis, limits=[0, 50], shape=shape)
    want = np.asarray(getattr(ref, stat)(column, binby=axis, limits=[0, 50], shape=shape))
    assert got.dtype == want.dtype
    if stat == "sum" and column == "y":
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        npt.assert_array_equal(got, want)
    if stat == "count":  # every row of key 29 in the bin that holds 29
        k = ref.evaluate("k")
        assert got[29 * shape // 50] == (k == 29).sum()


def test_a_datetime_scalar_in_an_expression_is_a_variable(temporal_frames):
    """C11: ``df.d - df.d.min()`` wrote the datetime64 scalar into the
    expression as its integer count (``d - 1577...``), so the port computed
    a datetime minus nanoseconds, a datetime64, where vaex_tpu (which names
    the scalar as a variable) gives the timedelta64 from the earliest value."""
    ref, port = (df.copy() for df in temporal_frames)
    for name in ("d", "td"):
        want_expr = getattr(ref, name) - getattr(ref, name).min()
        got_expr = getattr(port, name) - getattr(port, name).min()
        _same_values(got_expr.evaluate(), want_expr.evaluate())
        assert got_expr.dtype.numpy == want_expr.dtype.numpy
    got = (port.d - port.d.min()).td.days.sum()
    want = (ref.d - ref.d.min()).td.days.sum()
    assert got == want


# --------------------------------------------------------------------- C12


@pytest.fixture
def host_device(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


@pytest.mark.parametrize("form", STRING_FORMS)
@pytest.mark.parametrize("periods", [2, -3])
@pytest.mark.parametrize("fill_value", [None, "q", "a"])
def test_a_shifted_string_column_keeps_its_labels(host_device, form, periods, fill_value):
    ref, port = string_frames(string_arrays(7, 30), form)
    want = host_list(ref.shift(periods, "s", fill_value=fill_value).evaluate("s"))
    shifted = port.shift(periods, "s", fill_value=fill_value)
    assert host_list(shifted.evaluate("s")) == want
    counts = shifted.groupby("s", agg="count").to_pandas_df()
    got = {k if isinstance(k, str) else None: c for k, c in zip(counts["s"], counts["count"])
           if c}
    assert got == dict(collections.Counter(want))


@pytest.mark.parametrize("form", STRING_FORMS)
def test_a_materialized_string_column_keeps_its_labels(host_device, form):
    ref, port = string_frames(string_arrays(7, 30), form)
    for df in (ref, port):
        df["U"] = df.t.str.upper()
    want = host_list(ref.materialize("U").evaluate("U"))
    done = port.materialize("U")
    assert "U" not in done.virtual_columns
    assert host_list(done.evaluate("U")) == want
    assert host_list(done[done.x > 0].evaluate("U")) == [
        u for u, x in zip(want, string_arrays(7, 30)["x"]) if x > 0]


# --------------------------------------------------------------------- C13


def _td_frame():
    td = np.array([10, 20, -5, "NaT", 7], "m8[s]")
    return vaex_tpu_torch.from_arrays(td=td, k=np.array([0, 1, 0, 0, 1])).to_device("cpu"), td


def test_temporal_sums_and_means_leave_nat_out():
    port, td = _td_frame()
    valid = td[~np.isnat(td)]
    assert port.sum("td") == valid.sum() and port.sum("td").dtype == td.dtype
    assert port.mean("td") == valid.mean() and port.mean("td").dtype == td.dtype
    npt.assert_allclose(port.std("td"), np.std(valid.astype(np.float64)), rtol=RTOL)
    npt.assert_allclose(port.var("td"), np.var(valid.astype(np.float64)), rtol=RTOL)
    assert port.count("td") == 5  # count(expr) counts NaT, as the reference does
    npt.assert_array_equal(port.sum("td", binby="k", limits=[0, 2], shape=2),
                           np.array([5, 27], "m8[s]"))
    with pytest.raises(TypeError, match="datetime"):
        vaex_tpu_torch.from_arrays(d=np.array(["2021-01-01"], "M8[ns]")).to_device(
            "cpu").sum("d")


def test_binned_and_grouped_temporal_moments_leave_nat_out(temporal_frames):
    arrays = binby_arrays(5, 4000)
    _, port = temporal_frames
    d, k = arrays["d"], arrays["k"]
    ok = ~np.isnat(d)
    ns = d.view(np.int64)
    npt.assert_allclose(port.std("d"), np.std(ns[ok].astype(np.float64)), rtol=RTOL)
    out = port.groupby("k", agg={"d": "mean"}, sort=True)
    got = out.evaluate("d")
    assert got.dtype == d.dtype
    want = [ns[ok & (k == g)].astype(np.float64).mean() for g in out.evaluate("k")]
    npt.assert_allclose(got.view(np.int64).astype(np.float64), want, rtol=RTOL)
    npt.assert_allclose(port.mean("d").view(np.int64), ns[ok].astype(np.float64).mean(),
                        rtol=RTOL)


def test_first_skips_a_nat_order(temporal_frames):
    arrays = binby_arrays(5, 4000)
    _, port = temporal_frames
    d, v = arrays["d"], arrays["v"]
    ok = ~np.isnat(d) & ~np.isnan(v)
    want = v[ok][np.argmin(d.view(np.int64)[ok])]
    assert port.first("v", order_expression="d") == want


# --------------------------------------------------------------------- C14


def _counts(df, key="s"):
    out = df.groupby(key, agg="count").to_pandas_df()
    return {None if k is None or k != k else k: int(c)
            for k, c in zip(out[key].tolist(), out["count"]) if c}


@pytest.mark.parametrize("forms", [("staged", "staged"), ("staged", "plain"),
                                   ("plain", "staged"), ("dictionary", "staged")])
def test_concat_merges_string_categories(host_device, forms):
    a, b = string_arrays(21, 1500, k=6), string_arrays(22, 1200, k=16)
    want = dict(collections.Counter(list(a["s"]) + list(b["s"])))
    left, right = (string_frames(arrays, form)[1] for arrays, form in zip((a, b), forms))
    both = left.concat(right)
    assert _counts(both) == want
    assert host_list(both.evaluate("s")) == list(a["s"]) + list(b["s"])
    assert both.count(selection=both.s == "ab") == want["ab"]


def test_concat_of_int_categories_that_grow(host_device):
    k1, k2 = np.array([0, 1, 2, 2, 1]), np.array([3, 4, 0, 4])
    left = vaex_tpu_torch.from_arrays(k=k1).categorize("k", labels=list("abc"))
    right = vaex_tpu_torch.from_arrays(k=k2).categorize("k", labels=list("abcde"))
    plain = vaex_tpu_torch.from_arrays(k=np.concatenate([k1, k2]))
    want = {"abcde"[k]: c for k, c in _counts(plain, "k").items()}
    assert _counts(left.concat(right), "k") == want
    # labels that do not agree: the key is read from its values
    other = vaex_tpu_torch.from_arrays(k=k2).categorize("k", labels=list("edcba"))
    assert not left.concat(other).is_category("k")
    assert _counts(left.concat(other), "k") == _counts(plain, "k")


def test_vaex_tpu_loses_rows_of_categories_that_grow():
    """Known problem of the reference (ROADMAP): the first frame's labels
    a-c bin the second frame's codes, so its d / e rows vanish."""
    import vaex_tpu
    k1, k2 = np.array([0, 1, 2, 2, 1]), np.array([3, 4, 0, 4])
    left = vaex_tpu.from_arrays(k=k1).categorize("k", labels=list("abc"))
    right = vaex_tpu.from_arrays(k=k2).categorize("k", labels=list("abcde"))
    out = left.concat(right).groupby("k", agg="count")
    assert int(np.sum(out["count"].values)) == 6 < len(k1) + len(k2)

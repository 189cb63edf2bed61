"""uint64 columns (and uint16 / uint32 ones, now staged as tensors): the port
(vaex_tpu_torch, on the CPU device) against vaex_tpu on the same seeded
frames.

A uint64 column is an int64 tensor of the same bits with its dtype in
``dataset.logical``; its sum adds the bits mod 2^64, its min / max and its
sets compare the order image ``bits ^ (1 << 63)``, its mean adds the
unsigned floats of the values in float64, as numpy's does.  Values past
2^63 and the largest uint64 are in every frame.  Every result is exact, a
mean to 1e-6 relative of numpy's: vaex_tpu divides the unsigned float of
its wrapped int64 sum (vaex_tpu/agg.py:1077-1085; ROADMAP, known problems
of the reference), which the tests pin where the sum wraps.
"""

import functools

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import RTOL, assert_same_frame, same_frames, with_uint64
from vaex_tpu_torch.column import ColumnMasked

N = 3000


@functools.lru_cache(maxsize=None)
def _arrays():
    rng = np.random.default_rng(41)
    arrays = {"k": rng.integers(0, 12, N).astype(np.int64), "x": rng.normal(0, 1, N),
              "u16": rng.integers(0, 2 ** 16, N).astype(np.uint16),
              "u32": rng.integers(0, 2 ** 32, N).astype(np.uint32)}
    arrays = with_uint64(arrays, 42, "u")
    arrays["w"] = rng.integers(0, 2 ** 64, N, dtype=np.uint64)  # wide: sums wrap
    arrays["um"] = np.ma.MaskedArray(rng.integers(0, 2 ** 64, N, dtype=np.uint64),
                                     rng.random(N) < 0.1)
    return arrays


@functools.lru_cache(maxsize=None)
def _frames():
    return same_frames(_arrays())


COLUMNS = ["u", "w", "um", "u16", "u32"]
WRAPS = {"u", "w", "um"}  # uint64 columns whose int64 sum wraps


def _numpy_mean(values):
    """numpy's mean of a (masked) unsigned column: float64 additions."""
    values = np.ma.asarray(values)
    return np.mean(values.compressed().astype(np.float64)) if values.size else np.nan


@pytest.mark.parametrize("stat", ["sum", "min", "max", "count", "mean", "minmax"])
@pytest.mark.parametrize("column", COLUMNS)
def test_statistic(column, stat):
    ref, port = _frames()
    want, got = getattr(ref, stat)(column), getattr(port, stat)(column)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    if stat == "mean":
        mean = _numpy_mean(_arrays()[column])
        npt.assert_allclose(got, mean, rtol=RTOL)
        assert (abs(float(want) / mean - 1) > 1e-3) == (column in WRAPS)
    else:
        npt.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sum_wraps_mod_2_64():
    """1 + (2^63 + 5) + (2^64 - 1) is 9223372036854775813 mod 2^64, and the
    mean adds the values in float64 (vaex_tpu divides the wrapped sum)."""
    values = np.array([1, 2 ** 63 + 5, 2 ** 64 - 1], dtype=np.uint64)
    ref, port = same_frames({"u": values})
    assert int(port.sum("u")) == int(ref.sum("u")) == 9223372036854775813
    npt.assert_allclose(port.mean("u"), np.mean(values), rtol=1e-15)
    npt.assert_allclose(ref.mean("u"), 9223372036854775813 / 3, rtol=1e-15)


@pytest.mark.parametrize("stat", ["sum", "min", "max", "mean", "count"])
@pytest.mark.parametrize("column", ["u", "um", "u32"])
def test_binned_statistic(column, stat):
    ref, port = _frames()
    kwargs = {"binby": "k", "limits": [-0.5, 11.5], "shape": 12}
    want, got = getattr(ref, stat)(column, **kwargs), getattr(port, stat)(column, **kwargs)
    assert got.dtype == np.asarray(want).dtype
    if stat == "mean":
        values, k = np.ma.asarray(_arrays()[column]), _arrays()["k"]
        npt.assert_allclose(got, [_numpy_mean(values[k == b]) for b in range(12)], rtol=RTOL)
    else:
        npt.assert_array_equal(got, np.asarray(want))


def test_binned_minmax_holds_the_unsigned_identities():
    """Empty cells hold uint64's identities: max 0 and min 2^64 - 1."""
    ref, port = _frames()
    kwargs = {"binby": "k", "limits": [-0.5, 14.5], "shape": 15}
    for stat in ("minmax", "min", "max"):
        want, got = getattr(ref, stat)("u", **kwargs), getattr(port, stat)("u", **kwargs)
        npt.assert_array_equal(got, np.asarray(want))
    assert int(port.max("u", **kwargs)[-1]) == 0
    assert int(port.min("u", **kwargs)[-1]) == 2 ** 64 - 1


@pytest.mark.parametrize("key", ["u", "um", "w"])
def test_groupby_over_a_uint64_key(key):
    ref, port = _frames()
    want = ref.groupby(key, agg={"n": "count", "x": vaex_tpu.agg.sum("x")}, sort=True)
    got = port.groupby(key, agg={"n": "count", "x": vaex_tpu_torch.agg.sum("x")}, sort=True)
    assert_same_frame(want, got)
    assert got.evaluate(key).dtype == np.uint64


def test_groupby_aggregates_of_uint64_values():
    ref, port = _frames()

    def spec(pkg):
        return {"s": pkg.agg.sum("w"), "mx": pkg.agg.max("u"), "mn": pkg.agg.min("um"),
                "me": pkg.agg.mean("w"), "nu": pkg.agg.nunique("u")}
    want = ref.groupby("k", agg=spec(vaex_tpu), sort=True)
    got = port.groupby("k", agg=spec(vaex_tpu_torch), sort=True)
    names = ["k", "s", "mx", "mn", "nu"]  # the mean of w: numpy's, per group
    assert_same_frame(want[names], got[names])
    w, k = _arrays()["w"], _arrays()["k"]
    npt.assert_allclose(got["me"].values, [_numpy_mean(w[k == g]) for g in range(12)],
                        rtol=RTOL)
    for name in ("s", "mx", "mn"):
        assert got.evaluate(name).dtype == np.uint64


def test_two_keys_one_of_them_uint64():
    ref, port = _frames()
    want = ref.groupby(["k", "u"], agg="count", sort=True)
    got = port.groupby(["k", "u"], agg="count", sort=True)
    assert_same_frame(want, got)


@pytest.mark.parametrize("values", [[0, 1, 2, 2 ** 64 - 1], [7, 9], [2 ** 63 + 1],
                                    np.array([2 ** 63 + 5, 3], dtype=np.uint64),
                                    np.array([3, 6, -1]), [-5, 4]])
def test_isin(values):
    """uint64 values against a uint64 set and against an int64 one (small
    ids): the order images on both sides."""
    ref, port = _frames()
    for column in ("u", "um"):
        want = ref[column].isin(values)
        got = port[column].isin(values)
        npt.assert_array_equal(np.asarray(got.evaluate()), np.asarray(want.evaluate()))
        assert int(got.sum()) == int(want.sum())


@pytest.mark.parametrize("values", [[2 ** 63 + 5, 3], [2 ** 63 + 1, 2 ** 64 - 1, 0]])
def test_isin_of_python_ints_past_2_63_beside_small_ones(values):
    """numpy makes such a list float64, and vaex_tpu's set with it, so that
    every value within float64's rounding of 2^63 + 5 matches (ROADMAP,
    known problems of the reference); the port makes a uint64 set and is
    held to numpy's isin over uint64."""
    ref, port = _frames()
    u = _arrays()["u"]
    want = np.isin(u, np.array(values, dtype=np.uint64))
    got = port["u"].isin(values)
    npt.assert_array_equal(np.asarray(got.evaluate()), want)
    assert int(got.sum()) == int(want.sum())
    assert int(ref["u"].isin(values).sum()) > int(want.sum())


def test_unique_value_counts_and_nunique():
    ref, port = _frames()
    for column in ("u", "um"):
        assert port.unique(column) == ref.unique(column)
        assert port[column].nunique() == ref[column].nunique()
        assert port[column].nunique(dropmissing=True) == ref[column].nunique(dropmissing=True)
        want, got = ref[column].value_counts(), port[column].value_counts()
        assert list(got.index) == list(want.index)
        npt.assert_array_equal(got.to_numpy(), want.to_numpy())
    values, inverse = port.unique("u", return_inverse=True)
    npt.assert_array_equal(np.asarray(values, dtype=np.uint64)[inverse], port.evaluate("u"))


def test_set_keys_convert_back_on_the_host():
    _, port = _frames()
    oset = port._set("u")
    assert oset.keys.dtype == np.uint64
    npt.assert_array_equal(oset.keys, np.unique(_arrays()["u"]))
    # on the device the keys are the order images, sorted as int64
    device_keys = oset.device_keys("cpu")
    assert device_keys.dtype == torch.int64
    assert bool((device_keys[1:] > device_keys[:-1]).all())


@pytest.mark.parametrize("column", COLUMNS)
def test_evaluate_and_round_trip(column):
    ref, port = _frames()
    want, got = ref.evaluate(column), port.evaluate(column)
    assert got.dtype == np.asarray(want).dtype
    npt.assert_array_equal(np.ma.getdata(got), np.ma.getdata(want))
    npt.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
    npt.assert_array_equal(port.evaluate(column, 10, 20), ref.evaluate(column, 10, 20))
    npt.assert_array_equal(port[port.x > 0].evaluate(column), ref[ref.x > 0].evaluate(column))
    again = vaex_tpu_torch.from_dict(port.to_dict([column])).to_device("cpu")
    npt.assert_array_equal(again.evaluate(column), got)
    assert port.data_type(column) == np.dtype(_arrays()[column].dtype)
    assert port.to_pandas_df([column])[column].dtype == ref.to_pandas_df([column])[column].dtype


def test_unsigned_columns_are_staged_as_int64_tensors():
    """uint16 / uint32 / uint64 columns move to the device once, as int64
    tensors, with their dtype in ``dataset.logical``."""
    _, port = _frames()
    for column in ("u16", "u32", "u"):
        assert isinstance(port.dataset[column], torch.Tensor)
        assert port.dataset[column].dtype == torch.int64
        assert port.dataset.logical[column] == np.dtype(_arrays()[column].dtype)
    assert isinstance(port.dataset["um"], ColumnMasked)
    assert port.dataset["um"].data.dtype == torch.int64


@pytest.mark.parametrize("expression", ["u > 7", "u >= 9223372036854775813", "u == w",
                                        "u < w", "u != 3", "u > 0.5", "(u + 1) > 5",
                                        "u * 3 - w", "u / 2", "-u", "~u", "abs(u)",
                                        "astype(u, 'float64')", "astype(k, 'uint64') + u"])
def test_uint64_expressions(expression):
    """Comparisons, + - * (mod 2^64), / (float64) and the unary operators
    give numpy's values and dtypes (vaex_tpu's; against a Python int past
    2^63 numpy's, where JAX raises OverflowError)."""
    ref, port = _frames()
    got = port.evaluate(expression)
    if "9223372036854775813" in expression:
        want = _arrays()["u"] >= np.uint64(9223372036854775813)
    else:
        want = ref.evaluate(expression)
    assert got.dtype == np.asarray(want).dtype
    if got.dtype.kind == "f":
        npt.assert_allclose(got, want, rtol=1e-15)
    else:
        npt.assert_array_equal(got, np.asarray(want))


def _numpy(expression, arrays):
    """An expression over the host arrays, numpy's way."""
    def fillmissing(v, fill):
        return np.ma.filled(v, fill) if np.ma.isMaskedArray(v) else v
    names = {"sqrt": np.sqrt, "maximum": np.maximum, "minimum": np.minimum, "where": np.where,
             "clip": np.clip, "fillmissing": fillmissing, "log": np.log, "fmod": np.fmod,
             "power": np.power, "sign": np.sign}
    with np.errstate(all="ignore"):
        return np.asarray(eval(expression, names, dict(arrays)))


def _same_values(got, want):
    assert got.dtype == want.dtype
    if want.dtype.kind == "f":
        npt.assert_allclose(got, want, rtol=1e-15)
    else:
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("expression", ["u // 2", "u % 3", "u ** 2", "u & 1", "sqrt(u)",
                                        "u + x", "u + k", "u > -1"])
def test_uint64_expressions_outside_the_port_raise_by_name(expression):
    """Once refused by name (ROADMAP A14), now numpy's values and dtypes, and
    vaex_tpu's, but for ``u > -1``, where vaex_tpu is wrong (ROADMAP, known
    problems of the reference)."""
    ref, port = _frames()
    want = _numpy(expression, _arrays())
    got = port.evaluate(expression)
    _same_values(got, want)
    if expression != "u > -1":
        _same_values(got, np.asarray(ref.evaluate(expression)))


# uint64 inside expressions (ROADMAP A14): each held to numpy, and to vaex_tpu
# where it answers (every case here)
A14 = ["u // w", "u % w", "w // 7", "u | w", "u ^ w", "u & w", "u >> 60", "u << 3",
       "u >> w", "3 - u", "7 // u", "u ** 3", "u * x", "u - k", "k * u", "u // 2.5",
       "u % 2.5", "u > k", "k >= u", "u == k", "u < 2.5", "fillmissing(um, 0)",
       "maximum(u, w)", "minimum(u, 3)", "clip(u, 3, 2 ** 63)", "where(u > 3, u, 0)",
       "where(u > 3, u, k)", "log(u)", "fmod(u, 7)", "sign(u)", "power(u, 2)"]


@pytest.mark.parametrize("expression", A14)
def test_uint64_inside_expressions(expression):
    ref, port = _frames()
    arrays = _arrays()
    got = port.evaluate(expression)
    _same_values(np.asarray(got), _numpy(expression, arrays))


@pytest.mark.parametrize("expression", ["u // 3", "u % 7", "u & 65535", "u >> 60", "u + k",
                                        "sqrt(u)"])
def test_uint64_expressions_in_statistics(expression):
    """A sum, a mean, a groupby key and a set of a uint64 expression."""
    ref, port = _frames()
    values = _numpy(expression, _arrays())
    got, want = port.sum(expression), values.sum()
    if values.dtype.kind == "f":
        npt.assert_allclose(got, want, rtol=RTOL)
        npt.assert_allclose(port.mean(expression), values.mean(), rtol=RTOL)
    else:
        assert got == want and np.asarray(got).dtype == want.dtype
        npt.assert_array_equal(port.unique(expression, array_type="numpy"), np.unique(values))
        port2 = port.copy()
        port2["key"] = expression
        out = port2.groupby("key", agg="count", sort=True)
        keys, counts = np.unique(values, return_counts=True)
        npt.assert_array_equal(out["key"].values, keys)
        npt.assert_array_equal(out["count"].values, counts)


def test_float_rows_in_a_uint64_set():
    """numpy compares float rows with uint64 values in float64."""
    f = np.array([7.0, 2.0 ** 64, 0.5, 2.0 ** 63, np.nan, 3.0])
    values = [7, 2 ** 64 - 1, 2 ** 63, 4]
    port = vaex_tpu_torch.from_arrays(f=f).to_device("cpu")
    want = np.isin(f, np.array(values, dtype=np.uint64))
    npt.assert_array_equal(port.f.isin(values).values, want)
    assert port.count(selection=port.f.isin(values)) == want.sum()


def test_astype_to_and_from_uint64():
    _, port = _frames()
    arrays = _arrays()
    _same_values(port.evaluate("astype(u, 'int32')"), arrays["u"].astype(np.int32))
    _same_values(port.evaluate("astype(u, 'bool')"), arrays["u"].astype(bool))
    x = np.abs(arrays["x"]) * 1e18
    port2 = vaex_tpu_torch.from_arrays(x=x).to_device("cpu")
    _same_values(port2.evaluate("astype(x, 'uint64')"), x.astype(np.uint64))


def test_a_uint64_map():
    _, port = _frames()
    u = _arrays()["u"]
    mapping = {int(v): i for i, v in enumerate(np.unique(u))}
    got = port.u.map(mapping).values
    npt.assert_array_equal(got, [mapping[int(v)] for v in u])


def test_binby_a_uint64_axis_and_first():
    """A uint64 axis bins by the unsigned value; ``first`` ordered by a
    uint64 column takes the exact order (vaex_tpu compares orders as float64,
    where 2^63 + 1 and 2^63 + 2 tie), so it is held to numpy: per group the
    value at the smallest order, the earliest row among equal ones."""
    ref, port = _frames()
    kwargs = {"binby": "u", "limits": [0, 2.0 ** 64], "shape": 4}
    npt.assert_array_equal(port.count(**kwargs), np.asarray(ref.count(**kwargs)))
    arrays = _arrays()
    got = port.groupby("k", agg={"f": vaex_tpu_torch.agg.first("x", "u")}, sort=True)
    want = [arrays["x"][arrays["k"] == g][np.argmin(arrays["u"][arrays["k"] == g])]
            for g in range(12)]
    npt.assert_array_equal(got.evaluate("f"), want)


def test_top_k_and_percentiles_of_uint64_values():
    """The two largest and smallest uint64 values per group and its median
    order by the unsigned value (held to numpy)."""
    _, port = _frames()
    arrays = _arrays()
    got = port.groupby("k", agg={"top": vaex_tpu_torch.agg.max_n("w", 2),
                                 "low": vaex_tpu_torch.agg.min_n("w", 2),
                                 "med": vaex_tpu_torch.agg.median_approx("w")}, sort=True)
    top, low, med = (np.asarray(got.evaluate(n)) for n in ("top", "low", "med"))
    for g in range(12):
        values = np.sort(arrays["w"][arrays["k"] == g])
        npt.assert_array_equal(top[g], values[::-1][:2])
        npt.assert_array_equal(low[g], values[:2])
        npt.assert_allclose(med[g], np.median(values.astype(np.float64)), rtol=1e-12)


def test_a_descending_sort_of_uint64_values():
    """vaex_tpu's ``_negate_for_sort`` casts uint64 to int64 before it
    negates (vaex_tpu/dataframe.py:2028-2033; ROADMAP, known problems of the
    reference), so its descending sort starts at 2^63; the port is held to
    numpy."""
    arrays = with_uint64(_arrays(), 3)
    ref, port = same_frames(arrays)
    want = np.sort(arrays["u"])[::-1]
    npt.assert_array_equal(port.sort("u", ascending=False).evaluate("u"), want)
    assert ref.sort("u", ascending=False).evaluate("u")[0] == np.uint64(2 ** 63)

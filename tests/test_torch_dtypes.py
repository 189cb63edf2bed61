"""Column dtypes at the edges, the port against vaex_tpu on the same seeded
numpy arrays: ``astype`` of floats that no integer holds (NaN, the
infinities, 1e30), datetime64 / timedelta64 keys with NaT in the set-based
paths, uint16 / uint32 columns, and ``categorize`` without labels.

Ints exact; floats to the reference's contract (1e-6 relative, 1e-7
absolute).  Where the reference itself is wrong the test pins the correct
value and says so.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, assert_same_frame, same_frames
from vaex_tpu_torch.functions import _float_to_int

EDGES = [np.nan, np.inf, -np.inf, 1e30, -1e30, 300.7, -300.7, 127.9, -128.9, 2147483647.0,
         2147483648.0, -2147483649.0, 9.3e18, -9.3e18, 0.0, -0.0, 1.5, -1.5]


def _edge_frames(float_dtype):
    rng = np.random.default_rng(11)
    x = np.concatenate([EDGES, rng.normal(0, 1e5, 200)]).astype(float_dtype)
    return same_frames({"x": x, "k": rng.integers(0, 5, len(x)).astype(np.int64)})


@pytest.mark.parametrize("float_dtype", ["float64", "float32"])
@pytest.mark.parametrize("target", ["int8", "int16", "int32", "int64", "uint8"])
def test_astype_float_to_int_saturates_and_sends_nan_to_zero(float_dtype, target):
    ref, port = _edge_frames(float_dtype)
    want = np.asarray(ref.evaluate(f"astype(x, '{target}')"))
    got = port.evaluate(f"astype(x, '{target}')")
    assert got.dtype == want.dtype == np.dtype(target)
    npt.assert_array_equal(got, want)
    info = np.iinfo(target)
    assert got[0] == 0 and got[1] == info.max and got[2] == info.min and got[3] == info.max


def test_sum_of_astype_int64_over_nan_matches_the_reference():
    rng = np.random.default_rng(12)
    x = rng.integers(-50, 50, 500).astype(np.float64)
    x[::9] = np.nan
    ref, port = same_frames({"x": x})
    want = int(ref.sum("astype(x, 'int64')"))
    assert want == int(np.nansum(x))
    assert int(port.sum("astype(x, 'int64')")) == want


def test_groupby_ordinals_of_a_float_key_with_nan_do_not_wrap():
    """The category grouper bins on ``astype(key, 'int64')``: a NaN key lands
    in code 0's edge handling, not at the integer minimum."""
    rng = np.random.default_rng(13)
    k = rng.integers(0, 4, 300).astype(np.float64)
    k[::17] = np.nan
    ref, port = same_frames({"k": k, "x": rng.normal(0, 1, 300)}, category="k",
                            labels=[0, 1, 2, 3])
    agg_ref = {"n": vaex_tpu.agg.count(), "s": vaex_tpu.agg.sum("x")}
    agg_port = {"n": vaex_tpu_torch.agg.count(), "s": vaex_tpu_torch.agg.sum("x")}
    assert_same_frame(ref.groupby("k", agg=agg_ref, sort=True),
                      port.groupby("k", agg=agg_port, sort=True))


def test_float_to_int_is_the_same_on_every_int_width():
    x = torch.tensor(EDGES, dtype=torch.float64)
    for target in (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8):
        info = torch.iinfo(target)
        got = _float_to_int(x, target)
        want = np.nan_to_num(np.trunc(np.asarray(EDGES)), nan=0.0).clip(info.min, info.max)
        # the float nearest the int64 ends is outside the type: compare there by saturation
        inside = np.abs(want) < 2.0 ** 62
        npt.assert_array_equal(got.numpy()[inside], want[inside].astype(np.int64))
        assert got[1] == info.max and got[2] == info.min and got[0] == 0


def _temporal_arrays(n=2000):
    rng = np.random.default_rng(5)
    d = (np.datetime64("2020-01-01") + rng.integers(0, 6, n).astype("m8[D]")).astype("M8[ns]")
    d[::41] = np.datetime64("NaT")
    td = rng.integers(0, 4, n).astype("m8[s]")
    td[::37] = np.timedelta64("NaT")
    return {"d": d, "td": td, "x": rng.normal(0, 1, n), "k": rng.integers(0, 3, n)}


@pytest.mark.parametrize("column", ["d", "td"])
def test_unique_of_a_temporal_column_keeps_its_type_and_puts_nat_last(column):
    arrays = _temporal_arrays()
    ref, port = same_frames(arrays)
    want, got = ref.unique(column), port.unique(column)
    assert got == want and got[-1] is None
    oset = port._set(column)
    assert oset.keys.dtype == arrays[column].dtype and oset.has_null
    assert oset.null_count == int(np.isnat(arrays[column]).sum())
    assert not np.isnat(oset.keys).any()
    assert port[column].nunique() == ref[column].nunique() == len(want)
    assert port[column].nunique(dropmissing=True) == len(want) - 1


@pytest.mark.parametrize("column", ["d", "td"])
def test_value_counts_of_a_temporal_column_counts_nat_as_missing(column):
    arrays = _temporal_arrays()
    ref, port = same_frames(arrays)
    want, got = ref[column].value_counts(), port[column].value_counts()
    assert got.index.dtype == want.index.dtype == arrays[column].dtype
    npt.assert_array_equal(np.sort(got.values), np.sort(want.values))
    lookup = {k.astype("i8").item(): c for k, c in zip(np.asarray(want.index.values),
                                                       want.values)}
    for key, count in zip(np.asarray(got.index.values), got.values):
        assert lookup[key.astype("i8").item()] == count
    assert got[np.isnat(got.index.values)].item() == int(np.isnat(arrays[column]).sum())


@pytest.mark.parametrize("column", ["d", "td"])
def test_groupby_over_a_temporal_key_counts_the_nat_rows(column):
    """Keys in the column's dtype, NaT as the missing value, last.  vaex_tpu
    returns that group with count 0 and no sum; its rows are counted here."""
    arrays = _temporal_arrays()
    ref, port = same_frames(arrays)
    want = ref.groupby(column, agg={"n": vaex_tpu.agg.count(), "s": vaex_tpu.agg.sum("x")},
                       sort=True)
    got = port.groupby(column, agg={"n": vaex_tpu_torch.agg.count(),
                                    "s": vaex_tpu_torch.agg.sum("x")}, sort=True)
    assert got.get_column_names() == want.get_column_names()
    keys = got.evaluate(column)
    assert keys.dtype == arrays[column].dtype
    assert got[column].tolist() == want[column].tolist() and got[column].tolist()[-1] is None
    nat = np.isnat(arrays[column])
    npt.assert_array_equal(got["n"].tolist()[:-1], want["n"].tolist()[:-1])
    npt.assert_allclose(got["s"].tolist()[:-1], want["s"].tolist()[:-1], rtol=RTOL, atol=ATOL)
    assert got["n"].tolist()[-1] == int(nat.sum())
    npt.assert_allclose(got["s"].tolist()[-1], arrays["x"][nat].sum(), rtol=RTOL, atol=ATOL)


def test_groupby_over_a_temporal_and_a_plain_key():
    arrays = _temporal_arrays()
    arrays["d"] = arrays["d"].copy()
    arrays["d"][np.isnat(arrays["d"])] = arrays["d"][1]  # the reference drops NaT groups
    ref, port = same_frames(arrays)
    assert_same_frame(
        ref.groupby(["d", "k"], agg={"n": vaex_tpu.agg.count()}, sort=True),
        port.groupby(["d", "k"], agg={"n": vaex_tpu_torch.agg.count()}, sort=True))


def _unsigned_arrays(n=3000):
    rng = np.random.default_rng(3)
    return {"u2": rng.integers(0, 60000, n).astype(np.uint16),
            "u4": rng.integers(0, 4_000_000_000, n).astype(np.uint32),
            "ku2": rng.integers(0, 7, n).astype(np.uint16),
            "ku4": rng.integers(3_000_000_000, 3_000_000_005, n).astype(np.uint32),
            "x": rng.normal(0, 1, n)}


@pytest.mark.parametrize("column", ["u2", "u4"])
@pytest.mark.parametrize("stat", ["count", "min", "max", "sum", "mean"])
def test_statistics_of_unsigned_columns(column, stat):
    ref, port = same_frames(_unsigned_arrays(), tile_rows=1000)
    want, got = getattr(ref, stat)(column), getattr(port, stat)(column)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    if stat == "mean":
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert int(got) == int(want)


@pytest.mark.parametrize("column", ["u2", "u4"])
def test_binned_min_max_of_unsigned_columns_hold_the_unsigned_identities(column):
    arrays = _unsigned_arrays()
    ref, port = same_frames(arrays)
    for stat in ("min", "max", "sum"):
        want = getattr(ref, stat)(column, binby="ku2", limits=[0, 10], shape=10)
        got = getattr(port, stat)(column, binby="ku2", limits=[0, 10], shape=10)
        assert got.dtype == np.asarray(want).dtype
        npt.assert_array_equal(got, np.asarray(want))  # bins 7..9 are empty


@pytest.mark.parametrize("key", ["ku2", "ku4"])
def test_groupby_over_an_unsigned_key(key):
    ref, port = same_frames(_unsigned_arrays())
    agg_ref = {"n": vaex_tpu.agg.count(), "s": vaex_tpu.agg.sum("u2"),
               "m": vaex_tpu.agg.max("u4"), "f": vaex_tpu.agg.sum("x")}
    agg_port = {"n": vaex_tpu_torch.agg.count(), "s": vaex_tpu_torch.agg.sum("u2"),
                "m": vaex_tpu_torch.agg.max("u4"), "f": vaex_tpu_torch.agg.sum("x")}
    want, got = ref.groupby(key, agg=agg_ref, sort=True), port.groupby(key, agg=agg_port,
                                                                       sort=True)
    assert_same_frame(want, got)
    for name in ("s", "m"):
        assert got.evaluate(name).dtype == np.asarray(want.evaluate(name)).dtype
    assert port.unique(key) == ref.unique(key)


def test_uint64_columns_still_raise_by_name():
    """uint64 columns are ported: their sum (mod 2^64) and max, values past
    2^63 included, equal vaex_tpu's, in uint64."""
    u8 = np.array([0, 1, 2 ** 63 + 5, 2 ** 64 - 1, 4], dtype=np.uint64)
    ref, port = same_frames({"u8": u8})
    for stat in ("sum", "max"):
        want, got = getattr(ref, stat)("u8"), getattr(port, stat)("u8")
        assert np.asarray(got).dtype == np.uint64 and int(got) == int(want)


def test_categorize_without_labels_takes_one_pass_and_copies_no_column(monkeypatch):
    rng = np.random.default_rng(17)
    n = 5000
    arrays = {"k": rng.integers(2, 40, n).astype(np.int64), "x": rng.normal(0, 1, n)}
    ref, port = same_frames(arrays)
    passes = port.executor.passes

    def no_host_copy(*args, **kwargs):
        raise AssertionError("categorize copied a column to the host")
    monkeypatch.setattr(vaex_tpu_torch.DataFrame, "_evaluate_rows", no_host_copy)
    port = port.categorize("k", min_value=2)
    assert port.executor.passes == passes + 1
    log = port.executor.trace_log[-1]
    assert log["rows"] == n and log["tiles"] == 1 and log["strategies"] == [
        {"extremes": "reduce"}]
    ref = ref.categorize("k", min_value=2)
    assert port.category_labels("k") == ref.category_labels("k")
    assert port.category_count("k") == ref.category_count("k")
    assert_same_frame(ref.groupby("k", agg={"s": vaex_tpu.agg.sum("x")}, sort=True),
                      port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x")}, sort=True))

"""Binned statistics over continuous axes: the port against vaex_tpu.

The same seeded numpy columns (``torch_port_helpers.binby_arrays``) go
through ``vaex_tpu`` and through ``vaex_tpu_torch`` on the CPU device, where
every kernel wrapper takes its plain version.  Counts, int sums, min / max,
``first`` and the limits from ``minmax`` must match exactly; float sums,
means, std and percent limits to rtol 1e-6 / atol 1e-7.
``BinnerScalar.to_bins`` is held to vaex_tpu's on hypothesis-drawn floats,
exactly.
"""

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from torch_port_helpers import ATOL, RTOL, assert_same_frame, binby_arrays, same_frames
from vaex_tpu.ops import binners as ref_binners
from vaex_tpu.ops.nullable import NA as RefNA
from vaex_tpu_torch.groupby import BinnedArray
from vaex_tpu_torch.ops import binners
from vaex_tpu_torch.ops.nullable import NA

N = 30_000


@pytest.fixture(scope="module")
def frames():
    return same_frames(binby_arrays(1, N), "k", labels=list(range(20)), tile_rows=8_000)


def _strategies(df):
    return df.executor.trace_log[-1]["strategies"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if want.dtype.kind == "f":
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        npt.assert_array_equal(got, want)


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    npt.assert_array_equal(got, want)


# ------------------------------------------------------------ BinnerScalar
# no subnormals: XLA's CPU code flushes them to zero, torch's does not, and a
# subnormal span is no use case
finite = st.floats(allow_nan=False, allow_infinity=False, allow_subnormal=False, width=64)
values = st.lists(st.floats(allow_nan=True, allow_infinity=True, allow_subnormal=False,
                            width=64), min_size=1, max_size=40)


def _both_bins(data, mask, vmin, vmax, bins):
    want = ref_binners.BinnerScalar("x", vmin, vmax, bins).to_bins(
        RefNA(jnp.asarray(data), None if mask is None else jnp.asarray(mask)))
    got = binners.BinnerScalar("x", vmin, vmax, bins).to_bins(
        NA(torch.from_numpy(data), None if mask is None else torch.from_numpy(mask)))
    assert got.dtype == torch.int32
    npt.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@hypothesis.settings(max_examples=150, deadline=None, derandomize=True, database=None)
@hypothesis.given(values=values, vmin=finite, vmax=finite, bins=st.integers(1, 2000))
def test_scalar_binner_matches_vaex_tpu_on_float64(values, vmin, vmax, bins):
    """Any limits, span == 0 and reversed ones included; the limits
    themselves among the values (v == vmax overflows)."""
    with np.errstate(over="ignore"):
        span = np.float64(vmax) - np.float64(vmin)
    hypothesis.assume(np.isfinite(span) and (span == 0 or abs(span) >= np.finfo(np.float64).tiny))
    data = np.asarray(values + [vmin, vmax], dtype=np.float64)
    idx = _both_bins(data, None, vmin, vmax, bins)
    assert ((idx >= 0) & (idx <= bins + 2)).all()
    if vmin < vmax:
        assert idx[-1] == bins + 2 and idx[-2] == 2
    assert (idx[np.isnan(data)] == 0).all()


@hypothesis.settings(max_examples=100, deadline=None, derandomize=True, database=None)
@hypothesis.given(values=st.lists(st.floats(allow_nan=True, allow_infinity=True,
                                            allow_subnormal=False, width=32),
                                  min_size=1, max_size=40),
                  vmin=st.floats(-2.0 ** 100, 2.0 ** 100, allow_subnormal=False, width=32),
                  vmax=st.floats(-2.0 ** 100, 2.0 ** 100, allow_subnormal=False, width=32),
                  bins=st.integers(1, 500))
def test_scalar_binner_matches_vaex_tpu_on_float32(values, vmin, vmax, bins):
    """A float32 column is binned in float32 arithmetic, limits included."""
    span = np.float32(vmax) - np.float32(vmin)
    hypothesis.assume(span == 0 or abs(span) >= np.finfo(np.float32).tiny)
    data = np.asarray(values + [vmin, vmax], dtype=np.float32)
    _both_bins(data, None, vmin, vmax, bins)


@hypothesis.settings(max_examples=100, deadline=None, derandomize=True, database=None)
@hypothesis.given(values=st.lists(st.integers(-(2 ** 40), 2 ** 40), min_size=1, max_size=40),
                  vmin=st.integers(-1000, 1000), span=st.integers(0, 5000),
                  bins=st.integers(1, 300), dtype=st.sampled_from(["int64", "int32", "int8"]))
def test_scalar_binner_matches_vaex_tpu_on_ints_and_masks(values, vmin, span, bins, dtype):
    info = np.iinfo(dtype)
    data = np.clip(np.asarray(values + [vmin, vmin + span]), info.min, info.max).astype(dtype)
    mask = np.arange(len(data)) % 3 == 0
    idx = _both_bins(data, mask, float(vmin), float(vmin + span), bins)
    assert (idx[mask] == 0).all()
    _both_bins(data, None, float(vmin), float(vmin + span), bins)


def test_scalar_binner_layout_and_identity():
    b = binners.BinnerScalar("x", 0.0, 10.0, 5)
    x = torch.tensor([float("nan"), -0.1, 0.0, 1.99, 2.0, 9.99, 10.0, float("inf"),
                      float("-inf")], dtype=torch.float64)
    assert b.to_bins(NA(x)).tolist() == [0, 1, 2, 2, 3, 6, 7, 7, 1]
    assert b.shape == 8 and b.bins == 5
    same = binners.BinnerScalar("x", 0.0, 10.0, 5)
    assert b == same and hash(b) == hash(same) and b.fingerprint() == same.fingerprint()
    for other in (binners.BinnerScalar("y", 0.0, 10.0, 5), binners.BinnerScalar("x", 0.0, 9.0, 5),
                  binners.BinnerScalar("x", 0.0, 10.0, 6), binners.BinnerOrdinal("x", 0, 5)):
        assert b != other
    assert b.fingerprint() == ref_binners.BinnerScalar("x", 0.0, 10.0, 5).fingerprint()
    # span == 0: everything lands on the edges
    flat = binners.BinnerScalar("x", 3.0, 3.0, 4)
    assert flat.to_bins(NA(torch.tensor([2.0, 3.0, 4.0], dtype=torch.float64))).tolist() == [
        1, 6, 6]
    # a grid mixes scalar and ordinal binners
    stack = (b, binners.BinnerOrdinal("k", 0, 3))
    assert binners.grid_shape(stack) == (8, 6) and binners.grid_size(stack) == 48
    fused = binners.fuse_bins(stack, [torch.tensor([2, 7], dtype=torch.int32),
                                      torch.tensor([5, 0], dtype=torch.int32)])
    assert fused.tolist() == [17, 42] and fused.dtype == torch.int32


# ------------------------------------------ the calls of the slice, vs vaex_tpu
def _minmax_shared(df):
    return df.count(binby=["x", "y"], limits="minmax", shape=64)


CALLS = {
    # name: (call, exact, the strategies of the port's last pass or None)
    "minmax": (lambda df, a: df.minmax("x"), True, [{"extremes": "reduce"}]),
    "minmax_list": (lambda df, a: df.minmax(["x", "iv", "w"]), False, None),
    "limits_minmax": (lambda df, a: df.limits(["x", "y"], "minmax"), True, None),
    "limits_default": (lambda df, a: df.limits("y"), True, None),
    "limits_category": (lambda df, a: df.limits(["k", "x"], [None, [-1, 1]]), True, None),
    "limits_percent": (lambda df, a: df.limits("x", "99.7%"), False, None),
    "limits_percent_list": (lambda df, a: df.limits(["x", "y", "xf"], ["90%", "minmax", [-1, 1]]),
                            False, None),
    "limits_percentage": (lambda df, a: df.limits_percentage("y", 80.0), False, None),
    "count_2d_minmax": (lambda df, a: df.count(binby=["x", "y"], limits="minmax", shape=64),
                        True, [{"additive": "b2"}]),
    "count_expr_2d": (lambda df, a: df.count("v", binby=["x", "y"], shape=[16, 8]), True, None),
    "mean_2d_edges": (lambda df, a: df.mean("v", binby=["x", "y"],
                                            limits=[[-3, 3], [-3, 3]], shape=[128, 64],
                                            edges=True), False, [{"additive": "b2"}]),
    "sum_int_1d": (lambda df, a: df.sum("iv", binby="x", limits=[-2, 2], shape=50), True,
                   [{"additive": "b1"}]),
    "sum_float_masked_axis": (lambda df, a: df.sum("v", binby="xm", shape=32), False, None),
    "sum_f32_axis": (lambda df, a: df.sum("iv", binby="xf", shape=32), True, None),
    "sum_int_axis": (lambda df, a: df.sum("iv", binby=["xi", "k"], limits=[[-50, 50], None],
                                          shape=25), True, None),
    "max_2d_wide": (lambda df, a: df.max("v", binby=["x", "y"], limits="minmax", shape=400),
                    True, [{"extremes": "b3x-l2"}]),
    "min_int_2d_wide": (lambda df, a: df.min("iv", binby=["x", "y"], limits=[[-3, 3], [-3, 3]],
                                             shape=[300, 200]), True, [{"extremes": "b3x-l2"}]),
    "minmax_list_binby": (lambda df, a: df.minmax(["v", "w"], binby="x", shape=128), True,
                          [{"extremes": "b3x-direct"}]),
    "minmax_masked": (lambda df, a: df.minmax("vm", binby=["k", "y"], shape=16), True, None),
    "max_list": (lambda df, a: df.max(["v", "x"], binby="y", shape=8, edges=True), True, None),
    "mean_list_no_binby": (lambda df, a: df.mean(["v", "x"]), False, None),
    "std_limits": (lambda df, a: df.std("v", binby="x", limits=[-2, 2], shape=20), False,
                   [{"moments": "b4"}]),
    "var_2d": (lambda df, a: df.var("v", binby=["x", "y"], limits="99%", shape=40, ddof=1),
               False, [{"moments": "b5"}]),
    "covar_limits": (lambda df, a: df.covar("v", "y", binby="x", limits=[-2, 2], shape=12),
                     False, None),
    "correlation_limits": (lambda df, a: df.correlation("v", "y", binby="x", limits=[-2, 2],
                                                        shape=12), False, None),
    "first": (lambda df, a: df.first("v", "t", binby="k"), True, [{"first": "b3x-direct"}]),
    "first_int_2d": (lambda df, a: df.first("iv", "t", binby=["x", "y"], limits=[[-3, 3], [-3, 3]],
                                            shape=200), True, [{"first": "b3x-l2"}]),
    "first_no_binby": (lambda df, a: df.first("iv", "t"), True, None),
    "first_selection": (lambda df, a: df.first("v", "t", binby="k", selection="y > 0"), True,
                        None),
    "first_masked_edges": (lambda df, a: df.first("vm", "t", binby="x", shape=16, edges=True),
                           True, None),
    "datetime_minmax": (lambda df, a: df.minmax("d"), True, None),
    "datetime_minmax_binby": (lambda df, a: df.minmax("d", binby="k"), True, None),
    "timedelta_max_2d": (lambda df, a: df.max("td", binby=["k", "x"], shape=8), True, None),
    "datetime_first": (lambda df, a: df.first("d", "t", binby="k"), True, None),
    "percentile_approx": (lambda df, a: np.asarray(df.percentile_approx("v", [25, 50, 75])),
                          False, None),
    "percentile_binby": (lambda df, a: df.percentile_approx("v", 50.0, binby="k",
                                                            percentile_shape=256), False, None),
    "percentile_binby_scalar_axis": (
        lambda df, a: df.percentile_approx("v", [10, 90], binby="x", limits=[-2, 2], shape=6,
                                           percentile_shape=128), False, None),
    "median_approx": (lambda df, a: np.asarray(df.median_approx("y")), False, None),
}


@pytest.mark.parametrize("name", CALLS)
def test_call_matches_vaex_tpu(frames, name):
    ref, port = frames
    call, exact, strategies = CALLS[name]
    want = call(ref, vaex_tpu.agg)
    got = call(port, vaex_tpu_torch.agg)
    (_exact if exact else _close)(got, want)
    if strategies is not None:
        assert _strategies(port) == strategies


def test_limits_share_one_minmax_pass(frames):
    """The minmax of every axis of a binby rides one pass; vaex_tpu takes one
    per axis."""
    _, port = frames
    before = port.executor.passes
    port.limits(["x", "y", "xf"], "minmax")
    assert port.executor.passes == before + 1
    before = port.executor.passes
    _minmax_shared(port)
    assert port.executor.passes == before + 2  # the limits, then the grid
    # limits that need no pass flush nothing: delayed statistics over category
    # axes or explicit limits still share one pass
    before = port.executor.passes
    promises = [port.sum("iv", binby="k", delay=True),
                port.max("v", binby="x", limits=[-1, 1], shape=4, delay=True),
                port.count(binby="k", delay=True)]
    assert port.executor.passes == before
    port.execute()
    assert port.executor.passes == before + 1 and all(p.done for p in promises)
    before = port.executor.passes
    port.correlation("v", "y", binby="k")
    assert port.executor.passes == before + 1
    before = port.executor.passes
    port.covar("v", "y", binby="x", shape=8)  # one minmax pass, then the three means
    assert port.executor.passes == before + 2


def test_limits_refuse_a_wrong_shape(frames):
    _, port = frames
    with pytest.raises(ValueError, match="does not match"):
        port.count(binby=["x", "y"], shape=[4, 4, 4])
    with pytest.raises(ValueError, match="limits for"):
        port.limits(["x", "y"], [[0, 1], [0, 1], [0, 1]])
    with pytest.raises(ValueError, match="pair"):
        port.limits("x", [0, 1, 2])


# --------------------------------------------------------------- groupby / binby
def _aggs(pkg, which):
    a = pkg.agg
    return {
        "extremes": {"hi": a.max("iv"), "lo": a.min("v")},
        "shared": {"s": a.sum("iv"), "hi": a.max("iv"), "lo": a.min("v"), "n": "count"},
        "first": {"f": a.first("v", "t"), "fi": a.first("iv", "t"), "own": a.first("w")},
        "datetime": {"d0": a.min("d"), "d1": a.max("d"), "df": a.first("d", "t"),
                     "td": a.min("td")},
    }[which]


@pytest.mark.parametrize("which,strategy", [
    ("extremes", {"extremes": "b3x-direct"}),
    ("shared", {"additive": "b1", "extremes": "b3x-direct"}),
    ("first", {"first": "b3x-direct"}),
    ("datetime", {"extremes": "b3x-direct", "first": "b3x-direct"}),
])
def test_groupby_category(frames, which, strategy):
    ref, port = frames
    want = ref.groupby("k", agg=_aggs(vaex_tpu, which))
    got = port.groupby("k", agg=_aggs(vaex_tpu_torch, which))
    assert _strategies(port) == [strategy]
    if which == "datetime":
        for name in want.get_column_names():
            _exact(got.evaluate(name), np.asarray(want.evaluate(name)))
    else:
        assert_same_frame(want, got)


def test_groupby_wide_key_shares_one_scatter():
    """id6 past B2's windows (K = 250 000), over several tiles, int64 kept:
    beside sums on b3-l2 one extreme column rides b3 and b3x from one
    partition; two take b3x-l2 apart from the sums."""
    K = 250_000
    arrays = binby_arrays(2, 60_000)
    arrays["id6"] = np.random.default_rng(2).integers(0, K, 60_000)
    ref, port = same_frames(arrays, "id6", labels=np.arange(K), tile_rows=25_000)
    for extra, strategy in (({}, {"additive": "b3", "extremes": "b3x", "scatter": "shared"}),
                            ({"lo": ("min", "v")}, {"additive": "b3-l2", "extremes": "b3x-l2"})):
        aggs = lambda pkg: {"s": pkg.agg.sum("iv"), "hi": pkg.agg.max("iv"),  # noqa: E731
                            "n": "count", **{k: getattr(pkg.agg, f)(c)
                                             for k, (f, c) in extra.items()}}
        want = ref.groupby("id6", agg=aggs(vaex_tpu))
        got = port.groupby("id6", agg=aggs(vaex_tpu_torch))
        log = port.executor.trace_log[-1]
        assert log["tiles"] == 3
        assert log["strategies"] == [strategy]
        assert got.evaluate("hi").dtype == np.int64
        assert_same_frame(want, got)


@pytest.mark.parametrize("grouper", ["dense", "set", "combined"])
def test_groupby_raw_keys_with_extremes_and_first(grouper):
    """The extremes and first inside GroupBy.agg on the dense, the set and
    the combined grouper."""
    arrays = binby_arrays(3, 20_000)
    arrays["wide"] = arrays["k"] * 1_000_003  # a range past 2^22: the set grouper
    ref, port = same_frames(arrays, tile_rows=6_000)
    by, kwargs = {"dense": ("k", {}), "set": ("wide", {}),
                  "combined": (["k", "xi"], {"assume_sparse": True})}[grouper]
    aggs = lambda pkg: {"hi": pkg.agg.max("iv"), "lo": pkg.agg.min("v"),  # noqa: E731
                        "f": pkg.agg.first("iv", "t"), "s": pkg.agg.sum("iv")}
    want = ref.groupby(by, agg=aggs(vaex_tpu), sort=True, **kwargs)
    got = port.groupby(by, agg=aggs(vaex_tpu_torch), sort=True, **kwargs)
    assert_same_frame(want, got)


def test_bool_min_max_match_numpy():
    """min and max of a bool column stay bool (vaex_tpu raises on its
    identity of a bool; pandas and numpy give these)."""
    arrays = binby_arrays(4, 5_000)
    arrays["b"][arrays["k"] == 3] = True
    arrays["b"][arrays["k"] == 4] = False
    _, port = same_frames(arrays, "k", labels=list(range(22)))
    out = port.groupby("k", agg={"b": ["min"], "hi": vaex_tpu_torch.agg.max("b")})
    b, k = arrays["b"], arrays["k"]
    want_lo = [bool(b[k == g].min()) if (k == g).any() else True for g in range(22)]
    want_hi = [bool(b[k == g].max()) if (k == g).any() else False for g in range(22)]
    assert out.evaluate("b_min").dtype == np.bool_
    assert out["b_min"].tolist() == want_lo and out["hi"].tolist() == want_hi
    assert port.min("b") == b.min() and port.max("b") == b.max()
    assert port.minmax("b", binby="k").dtype == np.bool_


def test_narrow_int_extremes_keep_their_dtype_and_identity():
    arrays = {"k": np.array([0, 0, 2], dtype=np.int64),
              "i": np.array([5, -7, 9], dtype=np.int32), "u": np.array([5, 7, 9], dtype=np.uint8)}
    ref, port = same_frames(arrays, "k", labels=[0, 1, 2])
    for column in ("i", "u"):
        got, want = port.minmax(column, binby="k"), ref.minmax(column, binby="k")
        _exact(got, want)
    assert port.min("i", binby="k")[1] == np.iinfo(np.int32).max


def test_first_breaks_ties_by_the_earliest_row():
    """Equal orders within a tile and across tiles: the earliest row of the
    whole pass wins; rows whose value or order is NaN or missing take no
    part; a cell without any holds 0."""
    k = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 3] * 3, dtype=np.int64)
    order = np.array([5, 2, 2, 7, 7, 7, 1, np.nan, 3, np.nan] * 3)
    value = np.arange(30, dtype=np.float64) + 100
    value[6] = np.nan  # the smallest order of cell 1 has no value
    df = vaex_tpu_torch.from_arrays(k=k, o=order, v=value).to_device("cpu")
    df = df.categorize("k", labels=[0, 1, 2, 3, 4])
    for tile_rows in (None, 4, 7, 10):
        df._tile_rows = tile_rows
        got = df.first("v", "o", binby="k")
        npt.assert_array_equal(got, [101.0, 116.0, 108.0, 0.0, 0.0])
    edges = df.first("v", "o", binby="k", edges=True)
    assert edges.shape == (8,) and edges[0] == edges[1] == edges[-1] == 0.0


def test_binby_returns_the_grid_with_coordinates(frames):
    ref, port = frames
    spec = lambda pkg: {"n": "count", "top": pkg.agg.max("v")}  # noqa: E731
    want = ref.binby(["x", "y"], agg=spec(vaex_tpu), shape=128)
    got = port.binby(["x", "y"], agg=spec(vaex_tpu_torch), shape=128)
    assert set(got) == {"n", "top"}
    for name in got:
        assert isinstance(got[name], BinnedArray) and got[name].dims == ("x", "y")
        assert got[name].shape == (128, 128)
        _exact(np.asarray(got[name]), np.asarray(want[name]))
        for dim in ("x", "y"):
            npt.assert_allclose(got[name].coords[dim], want[name].coords[dim], rtol=1e-12)
    one = port.binby(["k", "x"], agg=vaex_tpu_torch.agg.mean("v"), limits=[None, [-2, 2]],
                     shape=[1, 10])
    ref_one = ref.binby(["k", "x"], agg=vaex_tpu.agg.mean("v"), limits=[None, [-2, 2]],
                        shape=[1, 10])
    assert one.dims == ("k", "x") and one.shape == (20, 10) and "BinnedArray" in repr(one)
    _close(np.asarray(one), np.asarray(ref_one))
    npt.assert_array_equal(one.coords["k"], np.arange(20))
    npt.assert_allclose(one.coords["x"], ref_one.coords["x"])
    npt.assert_array_equal(one[3], np.asarray(one)[3])
    assert port.binby("x", shape=4).binners[0].bins == 4  # without agg: the BinBy itself


def test_datetime_columns_cross_as_int64_and_come_back(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")  # the host frame's passes
    arrays = binby_arrays(5, 2_000)
    host = vaex_tpu_torch.from_arrays(**arrays)
    port = host.to_device("cpu")
    for name, kind in (("d", "M"), ("td", "m")):
        col = port.dataset[name]
        assert isinstance(col, torch.Tensor) and col.dtype == torch.int64
        assert port.data_type(name).numpy == arrays[name].dtype and port.data_type(
            name).is_temporal
        npt.assert_array_equal(port.evaluate(name), arrays[name])
        assert port.evaluate(name).dtype.kind == kind
        npt.assert_array_equal(port[10:20].evaluate(name), arrays[name][10:20])
    # NaT never wins a min; on the host frame too (tiles copied per pass)
    want = arrays["d"][~np.isnat(arrays["d"])].min()
    assert port.min("d") == want and host.min("d") == want
    # a count of a datetime column stays a count (of every row, as vaex_tpu's)
    assert port.count("d") == vaex_tpu.from_arrays(d=arrays["d"]).count("d") == 2_000
    assert port.count("d", binby="k", shape=4).dtype == np.int64
    assert port.sort("td").evaluate("td")[0] == arrays["td"].min()
    assert port.dataset.fingerprint() == host.to_device("cpu").dataset.fingerprint()


def test_extremes_over_several_tiles_merge(frames):
    """The per-tile grids of the wide 2-D max merge with a maximum, as the
    tiles of the reference do."""
    ref, port = frames
    assert port._tile_rows == 8_000
    got = port.max("v", binby=["x", "y"], limits=[[-4, 4], [-4, 4]], shape=400)
    assert port.executor.trace_log[-1]["tiles"] == 4
    arrays = binby_arrays(1, N)
    x, y, v = arrays["x"], arrays["y"], arrays["v"]
    keep = (x >= -4) & (x < 4) & (y >= -4) & (y < 4) & ~np.isnan(v)
    cell = (np.floor((x[keep] + 4) / 8 * 400) * 400 + np.floor((y[keep] + 4) / 8 * 400))
    want = np.full(400 * 400, -np.inf)
    np.maximum.at(want, cell.astype(np.int64), v[keep])
    npt.assert_array_equal(got, want.reshape(400, 400))


@pytest.mark.parametrize("resolution,every", [("W", 1), ("D", 2), ("M", 1), ("Y", 1), ("h", 12)])
def test_binner_time_matches_vaex_tpu(resolution, every):
    """A datetime key grouped by calendar periods, alone and beside a
    category key; empty periods are groups too."""
    rng = np.random.default_rng(7)
    n = 4_000
    t = (np.datetime64("2015-01-01T00") + rng.integers(0, 24 * 800, n).astype("m8[h]")).astype(
        "M8[ns]")
    arrays = {"t": t, "y": rng.normal(0, 1, n), "iv": rng.integers(-9, 9, n),
              "k": rng.integers(0, 3, n)}
    ref, port = same_frames(arrays, "k", labels=[0, 1, 2], tile_rows=1_500)
    aggs = lambda pkg: {"s": pkg.agg.sum("iv"), "m": pkg.agg.mean("y"),  # noqa: E731
                        "hi": pkg.agg.max("y"), "n": "count"}
    want = ref.groupby(vaex_tpu.BinnerTime(ref.t, resolution, every=every), agg=aggs(vaex_tpu))
    by = vaex_tpu_torch.BinnerTime(port.t, resolution, every=every)
    got = port.groupby(by, agg=aggs(vaex_tpu_torch))
    assert got.get_column_names() == want.get_column_names() == ["t", "s", "m", "hi", "n"]
    npt.assert_array_equal(got.evaluate("t"), np.asarray(want.evaluate("t")))
    for name in ("s", "n"):
        npt.assert_array_equal(got.evaluate(name), np.asarray(want.evaluate(name)))
    for name in ("m", "hi"):
        npt.assert_allclose(got.evaluate(name), np.asarray(want.evaluate(name)), rtol=RTOL,
                            atol=ATOL)
    assert by.column.startswith("__btime_") and by.column not in port.dataset
    both = port.groupby([by, "k"], agg={"n": "count"}, sort=True)
    ref_both = ref.groupby([vaex_tpu.BinnerTime(ref.t, resolution, every=every), "k"],
                           agg={"n": "count"}, sort=True)
    npt.assert_array_equal(both.evaluate("t"), np.asarray(ref_both.evaluate("t")))
    npt.assert_array_equal(both.evaluate("k"), np.asarray(ref_both.evaluate("k")))
    npt.assert_array_equal(both.evaluate("n"), np.asarray(ref_both.evaluate("n")))


def test_binner_time_leaves_nat_and_missing_rows_out(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")  # a masked column stays a host array
    t = np.array(["2020-01-01", "NaT", "2020-01-02", "2020-01-09", "2020-01-03"], dtype="M8[ns]")
    df = vaex_tpu_torch.from_arrays(t=np.ma.MaskedArray(t, [False, False, False, False, True]),
                                    y=np.arange(5.0))
    out = df.groupby(vaex_tpu_torch.BinnerTime.per_week(df.t), agg={"y": "sum", "n": "count"})
    npt.assert_array_equal(out.evaluate("t"),
                           np.array(["2019-12-26", "2020-01-02", "2020-01-09"], dtype="M8[W]"))
    assert out["y"].tolist() == [0.0, 2.0, 3.0] and out["n"].tolist() == [1, 1, 1]
    for make in (vaex_tpu_torch.BinnerTime.per_day, vaex_tpu_torch.BinnerTime.per_month,
                 vaex_tpu_torch.BinnerTime.per_year):
        assert make(df.t).N >= 1


@pytest.mark.parametrize("kind", ["int64", "datetime64[ns]"])
def test_first_keeps_int64_orders_apart_past_2_53(kind):
    """Orders that differ by 1 above 2^53 tie as float64 (vaex_tpu compares
    them so); the port keeps an int or temporal order int64 and gives
    numpy's argmin-based answer, tile by tile too.  A cell whose only order
    is the int64 maximum takes its value, not the empty cell's 0."""
    rng = np.random.default_rng(21)
    n = 3_000
    k = rng.integers(0, 6, n)
    order = 1_700_000_000_000_000_000 + rng.permutation(n)  # ns since 1970, past 2^53
    value = rng.normal(0, 1, n)
    k = np.append(k, 6)  # cell 6: one row at the largest order
    order = np.append(order, np.iinfo(np.int64).max)
    value = np.append(value, 42.0)
    assert np.unique(order.astype(np.float64)).size < order.size  # float64 ties them
    want = [value[k == g][np.argmin(order[k == g])] for g in range(7)] + [0.0]
    o = order if kind == "int64" else order.view("M8[ns]")
    df = vaex_tpu_torch.from_arrays(k=k, o=o, v=value).to_device("cpu")
    df = df.categorize("k", labels=list(range(8)))
    for tile_rows in (None, 700):
        df._tile_rows = tile_rows
        npt.assert_array_equal(df.first("v", "o", binby="k"), want)
    got = df.groupby("k", agg={"f": vaex_tpu_torch.agg.first("v", "o")})
    npt.assert_array_equal(got["f"].tolist(), want)


def test_first_int_and_infinite_orders_match_vaex_tpu():
    """Where float64 holds the orders exactly, the port's int64 compare and
    vaex_tpu's float64 compare agree; an order of +inf wins over an empty
    cell in both (among the tied rows vaex_tpu takes the backend's scatter
    order, the port the earliest row)."""
    rng = np.random.default_rng(22)
    n = 4_000
    arrays = {"k": rng.integers(0, 9, n), "t": rng.integers(-2 ** 40, 2 ** 40, n),
              "f": rng.normal(0, 1, n), "v": rng.normal(0, 1, n)}
    arrays["f"][arrays["k"] == 8] = np.inf  # cell 8: every order +inf
    ref, port = same_frames(arrays, "k", labels=list(range(9)))
    for order in ("t", "f"):
        want = ref.first("v", order, binby="k")
        got = port.first("v", order, binby="k")
        npt.assert_array_equal(got[:8], np.asarray(want)[:8])
    assert np.asarray(want)[8] in arrays["v"][arrays["k"] == 8]
    assert got[8] == arrays["v"][arrays["k"] == 8][0]

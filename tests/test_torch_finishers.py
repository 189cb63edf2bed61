"""The frame's finishing statistics: the port (vaex_tpu_torch, on the CPU
device) against vaex_tpu on the same seeded frames.

``cov`` (a pair, a list, binby, a selection), ``mode``,
``mutual_information`` (a pair, a list of pairs, a list of expressions,
``sort``), ``describe``, ``healpix_count``, ``propagate_uncertainties``, the
statistic algebra ``stat``, a groupby's ``get_group`` / ``groups``, and the
small accessors ``data_type``, ``derivative``, ``get_names``, ``byte_size``,
``evaluate_variable``.  Counts, mode centres and healpix counts are exact;
floats agree to 1e-6 relative and 1e-7 absolute.
"""

import functools

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import (ATOL, RTOL, assert_same_frame, binby_arrays, same_frames,
                                with_source_id, with_uint64)

N = 4000


@functools.lru_cache(maxsize=None)
def _frames():
    """x, y (x with NaN), v, w, iv, vm (masked), b, d (datetime with NaT),
    td, k (an int key in [0, 20)), id6, u (uint64), source_id."""
    arrays = with_source_id(with_uint64(binby_arrays(31, N), 32), 33)
    arrays["z"] = arrays["y"] * 0.5 + np.random.default_rng(34).normal(0, 1, N)
    return same_frames(arrays)


def _close(got, want):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                        rtol=RTOL, atol=ATOL)


COV_CASES = {
    "pair": (("y", "z"), {}),
    "pair with NaN": (("x", "z"), {}),
    "list": ((["y", "z", "v", "iv"],), {}),
    "list masked": ((["vm", "w", "x"],), {}),
    "binby": ((["y", "z"],), {"binby": "k", "limits": [-0.5, 19.5], "shape": 20}),
    "binby 2-D": (("y", "v"), {"binby": ["k", "xi"], "limits": [[-0.5, 19.5], [-50, 50]],
                               "shape": [20, 5]}),
    "selection": ((["y", "z"],), {"selection": "v > 30"}),
    "one": (("y",), {}),
}


@pytest.mark.parametrize("case", list(COV_CASES))
def test_cov(case):
    ref, port = _frames()
    args, kwargs = COV_CASES[case]
    want, got = ref.cov(*args, **kwargs), port.cov(*args, **kwargs)
    assert got.shape == np.shape(want)
    if case == "list":
        # iv's variance (values near 2^40): numpy's, where vaex_tpu's raw
        # means cancel to a negative variance (vaex_tpu/dataframe.py:1060-1081;
        # ROADMAP, known problems of the reference)
        var_iv = np.var(ref.evaluate("iv").astype(np.float64))
        assert want[3, 3] < 0
        _close(got[3, 3], var_iv)
        want = np.array(want)
        want[3, 3] = got[3, 3]
    _close(got, want)


def test_cov_is_one_pass_of_the_additive_kernels():
    """One pass; since shifted moments, of the moment kernels alone: the
    var and covar ops of the three bases, no product column and no
    additive channel."""
    _, port = _frames()
    passes = port.executor.passes
    port.cov(["y", "z", "v"], binby="k", limits=[-0.5, 19.5], shape=20)
    assert port.executor.passes == passes + 1
    [strategy] = port.executor.trace_log[-1]["strategies"]
    assert set(strategy) == {"moments"}


MODE_CASES = {
    "float": (("v",), {}),
    "int": (("xi",), {"mode_shape": 100}),
    "mode limits": (("y",), {"mode_limits": [-3, 3], "mode_shape": 30}),
    "binby": (("v",), {"binby": "k", "limits": [-0.5, 19.5], "shape": 20, "mode_shape": 16}),
    "binby 2-D": (("y",), {"binby": ["k", "xi"], "limits": [[-0.5, 19.5], [-50, 50]],
                           "shape": 5, "mode_shape": 8}),
    "selection": (("w",), {"selection": "y > 0", "mode_shape": 12}),
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_mode(case):
    ref, port = _frames()
    args, kwargs = MODE_CASES[case]
    want, got = ref.mode(*args, **kwargs), port.mode(*args, **kwargs)
    npt.assert_array_equal(got, np.asarray(want))


MI_CASES = {
    "pair": (("y", "z"), {}),
    "pair shape": (("y", "v"), {"mi_shape": 32}),
    "limits": (("y", "z"), {"mi_limits": [[-2, 2], [-3, 3]], "mi_shape": 20}),
    "selection": (("x", "z"), {"selection": "k < 10", "mi_shape": 64}),
    "pairs": (([("y", "z"), ("y", "v"), ("w", "iv")],), {"mi_shape": 16}),
    "matrix": ((["y", "z", "w"],), {"mi_shape": 16}),
}


@pytest.mark.parametrize("case", list(MI_CASES))
def test_mutual_information(case):
    ref, port = _frames()
    args, kwargs = MI_CASES[case]
    _close(port.mutual_information(*args, **kwargs), ref.mutual_information(*args, **kwargs))


def test_mutual_information_sorted_pairs():
    ref, port = _frames()
    pairs = [("y", "v"), ("y", "z"), ("w", "iv")]
    want, want_pairs = ref.mutual_information(pairs, mi_shape=16, sort=True)
    got, got_pairs = port.mutual_information(pairs, mi_shape=16, sort=True)
    _close(got, want)
    assert got_pairs == want_pairs and got_pairs[0] == ("y", "z")


DESCRIBE_COLUMNS = ["x", "y", "xf", "xi", "vm", "iv", "d", "td", "b", "u"]


@pytest.mark.parametrize("selection", [None, "y > 0"])
def test_describe(selection):
    """Every statistic of every column: type names, counts and missing
    counts exact, means and stds to the float contract, min / max exact;
    the datetime column has min / max but no mean or std."""
    ref, port = _frames()
    ref, port = ref[DESCRIBE_COLUMNS], port[DESCRIBE_COLUMNS]
    want, got = ref.describe(selection=selection), port.describe(selection=selection)
    assert list(got.columns) == list(want.columns) == DESCRIBE_COLUMNS
    assert list(got.index) == list(want.index)
    # the uint64 column's mean: numpy's, where vaex_tpu divides a wrapped
    # int64 sum (vaex_tpu/agg.py:1077-1085; ROADMAP, known problems)
    u = ref.evaluate("u", selection=selection)
    assert abs(float(want["u"]["mean"]) - np.mean(u)) > 1e15
    _close(got["u"]["mean"], np.mean(u))
    want.loc["mean", "u"] = got["u"]["mean"]
    for name in DESCRIBE_COLUMNS:
        for row in ("data_type", "count", "NA", "min", "max"):
            assert got[name][row] == want[name][row], (name, row)
        for row in ("mean", "std"):
            if isinstance(want[name][row], str):
                assert got[name][row] == want[name][row], (name, row)
            else:
                _close(got[name][row], want[name][row])
    assert got["d"]["mean"] == got["d"]["std"] == "--"


def test_describe_of_virtual_and_string_options():
    ref, port = _frames()
    for df in (ref, port):
        df["s2"] = "y * 2 + 1"
    want = ref[["y", "s2"]].describe(virtual=False)
    got = port[["y", "s2"]].describe(virtual=False)
    assert list(got.columns) == list(want.columns) == ["y"]
    want = ref[["y", "s2"]].describe(strings=False)
    got = port[["y", "s2"]].describe(strings=False)
    assert list(got.columns) == ["y", "s2"]
    _close(got["s2"]["mean"], want["s2"]["mean"])


def _pixels(level, rows=slice(None)):
    """numpy's healpix pixel of each row at ``level``: the integer part of
    source_id / 2^35 (a nested index at level 12) floor-divided by
    4^(12 - level)."""
    ref, _ = _frames()
    index = (ref.evaluate("source_id")[rows] / 2 ** 35).astype(np.int64)
    return np.bincount(index // 4 ** (12 - level), minlength=12 * 4 ** level)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 5])
def test_healpix_count(level):
    """Every row counts in its pixel.  vaex_tpu's bins shift each index past
    half a pixel into the next one (ROADMAP, known problems of the
    reference): its first pixel holds about half, and its last pixel's upper
    half falls out; the port is held to numpy."""
    ref, port = _frames()
    got = port.healpix_count(healpix_level=level)
    assert got.shape == (12 * 4 ** level,) and int(got.sum()) == N
    npt.assert_array_equal(got, _pixels(level))
    if level == 0:
        want = np.asarray(ref.healpix_count(healpix_level=level))
        assert int(want.sum()) < N and want[0] < got[0] // 2 + got[0] // 4


def test_healpix_count_of_an_expression_with_a_selection():
    ref, port = _frames()
    y, vm = ref.evaluate("y"), ref.evaluate("vm")
    rows = (y > 0) & ~np.ma.getmaskarray(vm)
    got = port.healpix_count("vm", healpix_level=2, selection="y > 0")
    npt.assert_array_equal(got, _pixels(2, rows))


@pytest.mark.parametrize("expression", ["y * z + sin(y)", "sqrt(v) / (1 + y**2)", "z"])
def test_propagate_uncertainties(expression):
    ref, port = _frames()
    ref, port = ref.copy(), port.copy()
    for df in (ref, port):
        df["y_uncertainty"] = "abs(y) * 0 + 0.1"
        df["z_uncertainty"] = "abs(z) * 0.05"
        df["v_uncertainty"] = "abs(v) * 0 + 2"
        df["f"] = expression
        df.propagate_uncertainties([df.f])
    assert port.virtual_columns["f_uncertainty"] == ref.virtual_columns["f_uncertainty"]
    _close(port.mean("f_uncertainty"), ref.mean("f_uncertainty"))


def test_propagate_uncertainties_with_depending_variables():
    ref, port = _frames()
    ref, port = ref.copy(), port.copy()
    for df in (ref, port):
        df["y_uncertainty"] = "abs(y) * 0 + 0.1"
        df["z_uncertainty"] = "abs(z) * 0 + 0.3"
        df["f"] = "y * z"
        df.propagate_uncertainties(["f"], depending_variables=["z"])
    assert port.virtual_columns["f_uncertainty"] == ref.virtual_columns["f_uncertainty"]


STATS = {
    "ratio": lambda s: s.mean("v") / s.std("v"),
    "arithmetic": lambda s: 2 * s.sum("y") - s.count() + s.max("w") ** 2 - 1,
    "moments": lambda s: -s.covar("y", "z") + s.correlation("y", "z") * s.var("v"),
    "extremes": lambda s: s.min("xi") + s.max("iv") / 3,
    "counts": lambda s: s.count("x") / s.count(),
}
STAT_BINBY = {
    "none": {},
    "1-D": {"binby": "k", "limits": [-0.5, 19.5], "shape": 20},
    "2-D": {"binby": ["k", "y"], "limits": [[-0.5, 19.5], [-2, 2]], "shape": [20, 4]},
    "selection": {"binby": "k", "limits": [-0.5, 19.5], "shape": 20, "selection": "v > 50"},
}


@pytest.mark.parametrize("binby", list(STAT_BINBY))
@pytest.mark.parametrize("stat", list(STATS))
def test_stat_calculates_its_leaves_in_one_pass(stat, binby):
    ref, port = _frames()
    want = STATS[stat](vaex_tpu.stat).calculate(ref, **STAT_BINBY[binby])
    passes = port.executor.passes
    got = STATS[stat](vaex_tpu_torch.stat).calculate(port, **STAT_BINBY[binby])
    assert port.executor.passes == passes + 1
    assert np.shape(got) == np.shape(want)
    npt.assert_allclose(got, want, rtol=1e-9, atol=ATOL)


def test_stat_limits_from_minmax_take_one_pass_more():
    ref, port = _frames()
    want = (vaex_tpu.stat.mean("v") / vaex_tpu.stat.std("v")).calculate(ref, binby="y", shape=8)
    passes = port.executor.passes
    got = (vaex_tpu_torch.stat.mean("v") / vaex_tpu_torch.stat.std("v")).calculate(
        port, binby="y", shape=8)
    assert port.executor.passes == passes + 2
    npt.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("key", ["b", "k", "id6"])
def test_groupby_get_group_and_groups(key):
    """A dense key, and one grouped by its set; each group's rows."""
    ref, port = _frames()
    gr, gp = ref.groupby(key), port.groupby(key)
    want, got = list(gr.groups), list(gp.groups)
    assert [np.asarray(k).item() for k in got] == [np.asarray(k).item() for k in want]
    for k in want[:3] + want[-2:]:
        assert len(gp.get_group(k)) == len(gr.get_group(k))
        _close(gp.get_group(k).sum("y"), gr.get_group(k).sum("y"))
    pairs = dict(iter(gp))
    assert len(pairs[got[0]]) == len(gr.get_group(want[0]))


def test_groupby_get_group_of_two_keys_and_a_missing_key():
    arrays = {"a": np.arange(12) % 3, "c": np.ma.MaskedArray(np.arange(12) % 2,
                                                                np.arange(12) % 5 == 0),
              "x": np.arange(12, dtype=np.float64)}
    ref, port = same_frames(arrays)
    gr, gp = ref.groupby(["a", "c"]), port.groupby(["a", "c"])
    assert len(gp.get_group((1, 0))) == len(gr.get_group((1, 0)))
    gr, gp = ref.groupby("c"), port.groupby("c")
    assert len(gp.get_group(None)) == len(gr.get_group(None)) == 3
    assert list(gp.groups)[:2] == [0, 1]


def test_uint64_group_key_and_its_group():
    """The groups of a uint64 key equal vaex_tpu's; the rows of a group
    past 2^63 are held to numpy (vaex_tpu's filter cannot take such a key:
    JAX raises OverflowError on the Python int)."""
    ref, port = _frames()
    gr, gp = ref.groupby("u"), port.groupby("u")
    want, got = list(gr.groups), list(gp.groups)
    assert [int(k) for k in got] == [int(k) for k in want]
    u = ref.evaluate("u")
    for key in (got[0], got[-1]):
        assert len(gp.get_group(key)) == int((u == key).sum())
    assert int(got[-1]) == 2 ** 64 - 1 and len(gp.get_group(got[0])) == len(
        gr.get_group(want[0]))


@pytest.mark.parametrize("expression", ["y", "y * 2", "xi + 1", "u", "d", "sqrt(v)", "b"])
def test_data_type(expression):
    ref, port = _frames()
    got, want = port[expression].data_type(), ref[expression].data_type()
    assert got.numpy == want.numpy and repr(got) == repr(want)


@pytest.mark.parametrize("expression,var", [("y * z", "y"), ("sin(y) + y**2", "y"),
                                            ("v / z", "z"), ("exp(2 * y)", "y"), ("z", "y")])
def test_derivative(expression, var):
    ref, port = _frames()
    want = ref[expression].derivative(var)
    got = port[expression].derivative(port[var])
    assert got.expression == want.expression
    _close(port.mean(got.expression), ref.mean(want.expression))


def test_names_sizes_and_variables():
    ref, port = _frames()
    assert port.get_names() == ref.get_names()
    assert port.get_names(hidden=True) == ref.get_names(hidden=True)
    assert port.byte_size() == ref.byte_size()
    sub_ref, sub_port = ref[ref.y > 0], port[port.y > 0]
    assert sub_port.byte_size() == sub_ref.byte_size()
    name = port.add_variable("limit", np.arange(3))
    npt.assert_array_equal(port.evaluate_variable(name), np.arange(3))


def test_sum_moment_aggregator():
    ref, port = _frames()
    want = ref.groupby("k", agg={"m2": vaex_tpu.agg.aggregates["_sum_moment"]("x", 2),
                                 "m3": vaex_tpu.agg.aggregates["_sum_moment"]("vm", 3)},
                       sort=True)
    got = port.groupby("k", agg={"m2": vaex_tpu_torch.agg.aggregates["_sum_moment"]("x", 2),
                                 "m3": vaex_tpu_torch.agg.aggregates["_sum_moment"]("vm", 3)},
                       sort=True)
    assert_same_frame(want, got)


def test_every_aggregator_name_of_the_reference():
    assert set(vaex_tpu_torch.agg.aggregates) == set(vaex_tpu.agg.aggregates)
    ref, port = _frames()
    for name in ("median", "nunique", "percentile_approx", "median_approx"):
        assert_same_frame(ref.groupby("b", agg={"v": name}, sort=True),
                          port.groupby("b", agg={"v": name}, sort=True))
    with pytest.raises(KeyError):
        port.groupby("b", agg={"v": "no_such_aggregator"})

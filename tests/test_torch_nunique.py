"""nunique per cell and per group: the port (vaex_tpu_torch, on the CPU
device) against vaex_tpu on the same seeded frames.

Both routes of the port run at a small size: the presence grid (a count
over ``cell * n_values + ordinal`` through the additive plan) and the
sorted (cell, ordinal) pairs, which a test reaches by lowering
``agg.NUNIQUE_PRESENCE_MAX`` with a monkeypatch.  Every count is an integer
and compared exactly, over int, float (NaN, -0.0, +-inf) and masked
columns, with each ``drop*`` option, binby over one and two axes, a
selection, a filter, and a groupby's ``agg=``.
"""

import functools

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, key_arrays, same_frames, with_uint64
from vaex_tpu_torch import agg as port_agg

N = 3000
COLUMNS = ["k", "w", "f", "m", "fm"]
DROPS = [{}, {"dropna": True}, {"dropnan": True}, {"dropmissing": True}]
BINBY = {"binby": "b", "limits": [-0.5, 6.5], "shape": 7}


@functools.lru_cache(maxsize=None)
def _frames():
    return same_frames(with_uint64(key_arrays(21, N), 22))


@functools.lru_cache(maxsize=None)
def _reference(column, drop_index, binned):
    ref, _ = _frames()
    kwargs = dict(DROPS[drop_index], **(BINBY if binned else {}))
    return np.asarray(ref.nunique(column, **kwargs))


@pytest.fixture(params=["presence", "sorted"])
def route(request, monkeypatch):
    """The route the port takes: the sorted pairs where the presence grid
    may hold no more than 4 cells."""
    if request.param == "sorted":
        monkeypatch.setattr(port_agg, "NUNIQUE_PRESENCE_MAX", 4)
    return request.param


def _strategy(port):
    return port.executor.trace_log[-1]["strategies"][0]


def _assert_route(port, route):
    strategy = _strategy(port)
    if route == "presence":
        assert "presence" in strategy and "nunique" not in strategy, strategy
    else:
        assert strategy.get("nunique") == "sort" and "presence" not in strategy, strategy


@pytest.mark.parametrize("drop_index", range(len(DROPS)))
@pytest.mark.parametrize("column", COLUMNS)
def test_nunique_per_cell(route, column, drop_index):
    _, port = _frames()
    got = port.nunique(column, **DROPS[drop_index], **BINBY)
    _assert_route(port, route)
    assert got.dtype == np.int64 and got.shape == (7,)
    npt.assert_array_equal(got, _reference(column, drop_index, True))


@pytest.mark.parametrize("column", COLUMNS + ["u"])
def test_nunique_without_binby(route, column):
    _, port = _frames()
    for drop_index in range(len(DROPS)):
        got = port.nunique(column, **DROPS[drop_index])
        _assert_route(port, route)
        assert int(got) == int(_reference(column, drop_index, False)), DROPS[drop_index]
        # the expression's own nunique (one set build) agrees
        assert port[column].nunique(**DROPS[drop_index]) == int(got)


@pytest.mark.parametrize("column", ["k", "fm"])
def test_nunique_over_two_axes_with_edges(route, column):
    ref, port = _frames()
    kwargs = {"binby": ["b", "x"], "limits": [[-0.5, 6.5], [-10, 10]], "shape": [7, 4]}
    want = ref.nunique(column, dropnan=True, edges=True, **kwargs)
    got = port.nunique(column, dropnan=True, edges=True, **kwargs)
    assert got.shape == (10, 7)
    npt.assert_array_equal(got, np.asarray(want))
    npt.assert_array_equal(port.nunique(column, **kwargs), np.asarray(ref.nunique(column,
                                                                                  **kwargs)))


@pytest.mark.parametrize("selection", ["x > 0", "iv < 20"])
def test_nunique_with_a_selection(route, selection):
    ref, port = _frames()
    for column in ("k", "f"):
        want = ref.nunique(column, selection=selection, **BINBY)
        got = port.nunique(column, selection=selection, **BINBY)
        npt.assert_array_equal(got, np.asarray(want))


def test_nunique_of_a_filtered_frame(route):
    ref, port = _frames()
    ref, port = ref[ref.iv > -30], port[port.iv > -30]
    for column in ("w", "m"):
        npt.assert_array_equal(port.nunique(column, **BINBY),
                               np.asarray(ref.nunique(column, **BINBY)))


@pytest.mark.parametrize("key", ["b", "k", "w"])
def test_nunique_in_a_groupby(route, key):
    """A dense key (b, k) and a set key (w); the string name and the
    descriptor with its options in one ``agg=``."""
    ref, port = _frames()

    def spec(pkg):
        return {"f": "nunique", "fm": pkg.agg.nunique("fm", dropna=True), "n": "count",
                "s": pkg.agg.nunique("m", dropmissing=True)}
    want = ref.groupby(key, agg=spec(vaex_tpu), sort=True)
    got = port.groupby(key, agg=spec(vaex_tpu_torch), sort=True)
    assert_same_frame(want, got)
    _assert_route(port, route)


def test_nunique_by_a_category():
    arrays = key_arrays(23, N)
    ref, port = same_frames(arrays, "b", labels=list(range(7)))
    want = ref.groupby("b", agg={"k": "nunique", "x": vaex_tpu.agg.count()})
    got = port.groupby("b", agg={"k": "nunique", "x": vaex_tpu_torch.agg.count()})
    assert_same_frame(want, got)


def test_presence_grid_is_counted_by_the_additive_plan(monkeypatch):
    """The presence route hands its flat [G * n_values] index to the
    additive plan (B1 at 7 x 7 cells, B2 past 128) and fills no boolean grid
    by index_fill_."""
    from vaex_tpu_torch.ops import grid_plan
    _, port = _frames()
    seen = []
    original = grid_plan.grid_sums

    def spy(idx, int_cols, float_cols, G, count, out=None):
        seen.append((G, count, len(int_cols), len(float_cols)))
        return original(idx, int_cols, float_cols, G, count, out=out)
    monkeypatch.setattr("vaex_tpu_torch.tasks.grid_sums", spy)
    assert int(port.nunique("b")) == 7
    assert seen[-1] == (7, True, 0, 0) and _strategy(port)["presence"] == "b1"
    n_values = port._set("k").count
    port.nunique("k", **BINBY)
    assert seen[-1] == (10 * n_values, True, 0, 0)
    assert _strategy(port)["presence"] == grid_plan.strategy(N, 10 * n_values, 0, 0, True)


def test_sorted_route_past_the_cap(monkeypatch):
    """Past the cap the pairs are kept sorted and distinct; several tiles
    merge into one state."""
    ref, port = _frames()
    port = port.copy()
    port._tile_rows = 700
    monkeypatch.setattr(port_agg, "NUNIQUE_PRESENCE_MAX", 50)
    got = port.nunique("w", binby="k", limits=[-3.5, 39.5], shape=43)
    assert _strategy(port).get("nunique") == "sort"
    npt.assert_array_equal(got, np.asarray(ref.nunique("w", binby="k", limits=[-3.5, 39.5],
                                                       shape=43)))
    assert port.executor.trace_log[-1]["tiles"] == -(-N // 700)

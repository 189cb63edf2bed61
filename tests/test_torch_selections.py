"""Named selections of the port against vaex_tpu on the same arrays (the
port on device="cpu"): ``select`` with its modes, ``select_nothing``,
``select_inverse``, the shapes (box, rectangle, circle, ellipse, lasso),
``select_non_missing``, undo and redo per name, ``selection=True`` / a name
/ a list of selections in the statistics (with and without ``binby``,
beside a filter) and in a groupby's aggregators, ``encode`` / ``decode``.
The cases of tests/test_dataframe.py (undo and redo, box and circle, lasso)
and tests/test_cornercases.py (modes, inverse, non-missing, a selection
beside a filter, a list of selections over a binby).

Counts exact; floats to the repo's contract (1e-6 relative, 1e-7 absolute;
``torch_port_helpers.RTOL, ATOL``).
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, assert_same_frame, binby_arrays, same_frames
from vaex_tpu_torch.selections import (Selection, SelectionDropNa, SelectionExpression,
                                       SelectionInvert, SelectionLasso)

X = np.arange(10, dtype="f8")


def base_arrays():
    """tests/conftest.py's base frame without its string column."""
    return dict(x=X.copy(), y=X ** 2, g=np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2], dtype="i8"),
                m=np.ma.MaskedArray(X.copy(), X < 2), f=np.where(X == 9, np.nan, X),
                i=np.arange(10, dtype="i4"))


@pytest.fixture(params=[None, 3], ids=["one tile", "tiles of 3"])
def frames(request):
    return same_frames(base_arrays(), tile_rows=request.param)


def _both(frames, action):
    for df in frames:
        action(df)


def _same_count(frames, **kwargs):
    ref, port = frames
    got, want = port.count(**kwargs), ref.count(**kwargs)
    npt.assert_array_equal(np.asarray(got), np.asarray(want))
    return got


def _close(got, want):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                        rtol=RTOL, atol=ATOL)


def test_selection_undo_redo(frames):
    _both(frames, lambda df: df.select("x > 4"))
    assert _same_count(frames, selection=True) == 5
    _both(frames, lambda df: df.select("x > 6", mode="and"))
    assert _same_count(frames, selection=True) == 3
    _both(frames, lambda df: df.selection_undo())
    assert _same_count(frames, selection=True) == 5
    _both(frames, lambda df: df.selection_redo())
    assert _same_count(frames, selection=True) == 3
    ref, port = frames
    for df in frames:
        df.selection_undo()
        df.selection_undo()
    assert not port.has_selection() and not ref.has_selection()
    assert not port.selection_can_undo() and port.selection_can_redo()
    with pytest.raises(ValueError, match="no selection is active"):
        port.count(selection=True)


def test_undo_history_per_name_and_a_new_step_after_undo():
    """Each name keeps its own history; a selection made after an undo drops
    the steps that were undone, so undo goes back to the step before it (in
    vaex_tpu the undone step comes back: ROADMAP, "Known problems of the
    reference itself")."""
    port = vaex_tpu_torch.from_arrays(**base_arrays()).to_device("cpu")
    port.select("x > 2")
    port.select("x > 6", name="other")
    port.select("x > 4")
    assert port.count(selection=True) == 5 and port.count(selection="other") == 3
    port.selection_undo()
    assert port.count(selection=True) == 7 and port.count(selection="other") == 3
    port.select("x > 8")
    assert not port.selection_can_redo()
    port.selection_undo()
    assert port.count(selection=True) == 7  # not the undone "x > 4"
    port.selection_undo(name="other")
    assert not port.has_selection("other") and port.has_selection()


def test_select_box_circle(frames):
    _both(frames, lambda df: df.select_box(["x", "y"], [[0, 5], [0, 20]]))
    assert _same_count(frames, selection=True) == 5
    _both(frames, lambda df: df.select_circle("x", "y", 0, 0, 2.5))
    assert _same_count(frames, selection=True) == 2
    _both(frames, lambda df: df.select_circle("x", "y", 0, 0, 2.0, inclusive=False))
    _same_count(frames, selection=True)
    _both(frames, lambda df: df.select_rectangle("x", "y", [[1, 6], [2, 30]], name="r"))
    assert _same_count(frames, selection="r") == 4


@pytest.mark.parametrize("angle", [0, 30, 90])
def test_select_ellipse(frames, angle):
    _both(frames, lambda df: df.select_ellipse("x", "y", 4, 16, 6, 30, angle=angle))
    _same_count(frames, selection=True)
    _both(frames, lambda df: df.select_ellipse("x", "y", 4, 16, 6, 30, angle=np.radians(angle),
                                               radians=True, name="rad"))
    _same_count(frames, selection="rad")


def test_select_lasso(frames):
    _both(frames, lambda df: df.select_lasso("x", "y", [-1, 5, 5, -1], [-1, -1, 30, 30]))
    assert _same_count(frames, selection=True) == 5
    # a horizontal edge, a concave polygon, combined with a previous selection
    _both(frames, lambda df: df.select_lasso("x", "y", [-1, 9.5, 9.5, 4, -1],
                                             [10, 10, 90, 20, 90], mode="or"))
    _same_count(frames, selection=True)


def test_lasso_on_a_masked_column():
    ref, port = same_frames(base_arrays())
    _both((ref, port), lambda df: df.select_lasso("m", "y", [-1, 8, 8, -1], [-1, -1, 90, 90]))
    assert _same_count((ref, port), selection=True) == 6  # x in 2..7: rows 0, 1 missing


def test_selection_modes(frames):
    _both(frames, lambda df: df.select("x > 2"))
    _both(frames, lambda df: df.select("x < 7", mode="and"))
    assert _same_count(frames, selection=True) == 4
    _both(frames, lambda df: df.select("x > 8", mode="or"))
    assert _same_count(frames, selection=True) == 5
    _both(frames, lambda df: df.select("x > 5", mode="subtract"))
    assert _same_count(frames, selection=True) == 3
    _both(frames, lambda df: df.select("x > 3", mode="xor"))
    assert _same_count(frames, selection=True) == 5
    _both(frames, lambda df: df.select_nothing())
    assert not frames[1].has_selection() and not frames[0].has_selection()


def test_selection_inverse(frames):
    _both(frames, lambda df: df.select("x > 6"))
    _both(frames, lambda df: df.select_inverse())
    assert _same_count(frames, selection=True) == 7
    assert isinstance(frames[1].get_selection(), SelectionInvert)


@pytest.mark.parametrize("drop_nan,drop_masked", [(True, True), (True, False), (False, True)])
def test_select_non_missing(frames, drop_nan, drop_masked):
    _both(frames, lambda df: df.select_non_missing(drop_nan=drop_nan, drop_masked=drop_masked,
                                                   column_names=["m", "f"]))
    _same_count(frames, selection=True)
    _both(frames, lambda df: df.select_non_missing(name="all"))
    assert _same_count(frames, selection="all") == 7  # 2 masked in m, 1 nan in f


def test_count_selection_and_filter(frames):
    ref, port = frames
    rf, pf = ref.filter("x > 2"), port.filter("x > 2")
    assert pf.count(selection="x < 8") == rf.count(selection="x < 8") == 5
    _both((rf, pf), lambda df: df.select("x < 6"))
    assert _same_count((rf, pf), selection=True) == 3
    _close(pf.mean("y", selection=[None, True, "g == 1"]),
           rf.mean("y", selection=[None, True, "g == 1"]))


def test_binby_selection_list_2d(frames):
    grids = _same_count(frames, binby=["x"], limits=[[0, 10]], shape=2,
                        selection=["x < 5", "x >= 5", None])
    assert np.asarray(grids).shape == (3, 2)
    npt.assert_array_equal(grids[0], [5, 0])
    npt.assert_array_equal(grids[1], [0, 5])
    npt.assert_array_equal(grids[2], [5, 5])


@pytest.mark.parametrize("stat", ["count", "sum", "mean", "std", "min", "max"])
@pytest.mark.parametrize("binby", [False, True])
def test_lists_of_selections_and_expressions(stat, binby):
    """Results stack expressions outer, selections inner, as vaex_tpu's do;
    a list of one selection adds no axis."""
    arrays = binby_arrays(13, 3000)
    arrays = {k: arrays[k] for k in ("x", "y", "v", "vm", "k")}
    ref, port = same_frames(arrays, tile_rows=1000)
    _both((ref, port), lambda df: df.select("(x > 0) & (y < 1)"))
    _both((ref, port), lambda df: df.select("k < 7", name="low"))
    kwargs = {"binby": ["k"], "limits": [0, 20], "shape": 20} if binby else {}
    for expression in ("v", ["v", "vm", "x"]):
        for selection in ([None, True, "low"], [True], ["low", "v > 50"], True, "low", None):
            got = getattr(port, stat)(expression, selection=selection, **kwargs)
            want = getattr(ref, stat)(expression, selection=selection, **kwargs)
            assert np.shape(got) == np.shape(want), (expression, selection)
            _close(got, want)


def test_acceptance_examples():
    """``df.mean("sqrt(x)")``, ``df["r"] = "sqrt(x**2 + y**2)"``,
    ``select_circle`` then ``count(selection=True)`` and ``mean(["r", "w"],
    selection=[None, True])``: vaex_tpu's results and dtypes."""
    rng = np.random.default_rng(4)
    x, y = rng.normal(0, 1, 5000), rng.normal(0, 1, 5000)
    x[::97] = np.nan
    arrays = {"x": x, "y": y, "z": rng.uniform(0, 100, 5000),
              "i": rng.integers(0, 1000, 5000).astype(np.int64)}
    ref, port = same_frames(arrays, tile_rows=2048)
    _close(port.mean("sqrt(abs(x))"), ref.mean("sqrt(abs(x))"))
    for df in (ref, port):
        df["r"] = "sqrt(x**2 + y**2)"
        df["phi"] = "arctan2(y, x)"
        df["w"] = "log1p(z) * exp(-r)"
        df["zc"] = "clip(z, 10, 90)"
        df.select_circle("x", "y", 0.5, 0, 1)
    assert _same_count((ref, port), selection=True) > 0
    got = port.mean(["r", "w"], selection=[None, True])
    want = ref.mean(["r", "w"], selection=[None, True])
    assert got.shape == want.shape == (2, 2) and got.dtype == want.dtype == np.float64
    _close(got, want)
    rf, pf = ref.filter("r < 2"), port.filter("r < 2")
    for stat in ("mean", "std", "min", "max"):
        _close(getattr(pf, stat)(["r", "phi", "w", "zc"]),
               getattr(rf, stat)(["r", "phi", "w", "zc"]))
    npt.assert_array_equal(
        pf.count(binby="phi", limits=[-np.pi, np.pi], shape=64, selection=True),
        rf.count(binby="phi", limits=[-np.pi, np.pi], shape=64, selection=True))


def test_selections_in_a_groupby():
    """A groupby's aggregators resolve a selection's name and True against
    the frame, as the statistics do."""
    arrays = binby_arrays(14, 2000)
    arrays = {k: arrays[k] for k in ("x", "v", "k")}
    ref, port = same_frames(arrays, "k", labels=list(range(20)))
    _both((ref, port), lambda df: df.select("x > 0", name="pos"))
    _both((ref, port), lambda df: df.select("v < 50"))
    got = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("v", selection="pos"),
                                 "m": vaex_tpu_torch.agg.mean("v", selection=True),
                                 "c": vaex_tpu_torch.agg.count(selection="pos")}, sort=True)
    # vaex_tpu's aggregators read a name (and True) as an expression: they
    # get the selections' expressions (ROADMAP, "Known problems of the
    # reference itself")
    want = ref.groupby("k", agg={"s": vaex_tpu.agg.sum("v", selection="x > 0"),
                                 "m": vaex_tpu.agg.mean("v", selection="v < 50"),
                                 "c": vaex_tpu.agg.count(selection="x > 0")}, sort=True)
    assert_same_frame(want, got)
    with pytest.raises(TypeError, match="list of selections"):
        port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("v", selection=["pos", None])})


def test_unique_and_minmax_take_a_named_selection(frames):
    ref, port = frames
    _both(frames, lambda df: df.select("x > 5", name="hi"))
    assert port.unique("g", selection="hi") == ref.unique("g", selection="hi")
    _close(port.minmax("y", selection="hi"), ref.minmax("y", selection="hi"))


def test_encode_decode_roundtrip(frames):
    ref, port = frames
    port.select("x > 2")
    port.select("x < 8", mode="and")
    port.select_inverse()
    port.select_lasso("x", "y", [0, 6, 6], [0, 0, 40], mode="or", name="l")
    port.select_non_missing(column_names=["m"], drop_nan=False, name="n")
    for name in ("default", "l", "n"):
        selection = port.get_selection(name)
        again = Selection.decode(selection.encode())
        assert type(again) is type(selection)
        assert again.encode() == selection.encode()
        assert again.to_expression(port) == selection.to_expression(port)
        assert port.count(selection=again) == port.count(selection=name)
    assert isinstance(port.get_selection("l"), SelectionLasso)
    assert isinstance(port.get_selection("n"), SelectionDropNa)
    assert port.get_selection("l").dependencies(port) == {"x", "y"}
    with pytest.raises(ValueError, match="unknown selection type"):
        Selection.decode({"type": "nope"})
    with pytest.raises(ValueError, match="selection mode"):
        SelectionExpression("x > 1", SelectionExpression("x < 5"), "nand").to_expression(port)

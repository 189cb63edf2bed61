"""The linked-view models and views of the port (vaex_tpu_torch.jupyter,
vaex_tpu_torch.jupyter_view) against vaex_tpu's: vaex_tpu's own cases
through both packages on the same frame, grids compared, and the contract
of the dispatcher: one pass per flush, whatever the number of linked
views.  Also the frame's hooks they stand on: the accessor registry and
``signal_selection_changed``."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu import jupyter as ref_jupyter
from vaex_tpu import jupyter_view as ref_view
from vaex_tpu_torch import jupyter, jupyter_view, settings
from torch_port_helpers import ATOL, RTOL


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


def arrays():
    rng = np.random.default_rng(4)
    return dict(x=rng.random(10_000) * 10, y=rng.random(10_000) * 4 - 2,
                k=rng.integers(0, 5, 10_000).astype(np.int64))


PACKAGES = [(vaex_tpu, ref_jupyter, ref_view), (vaex_tpu_torch, jupyter, jupyter_view)]


def frame(package):
    df = package.from_arrays(**arrays())
    return df.to_device("cpu") if package is vaex_tpu_torch else df


@pytest.fixture
def both():
    """[(frame, jupyter module, jupyter_view module)] for vaex_tpu, then the
    port."""
    return [(frame(p), j, v) for p, j, v in PACKAGES]


def test_axis_limits(both):
    axes = []
    for df, j, _ in both:
        ax = j.Axis(df, "x", shape=32)
        assert ax.status == "no_limits"
        ax.ensure_limits()
        assert ax.status == "ready"
        axes.append(ax)
    ref, port = axes
    assert (port.min, port.max) == (ref.min, ref.max)
    npt.assert_array_equal(port.bin_centers, ref.bin_centers)


def test_axis_expression_change(both):
    for df, j, _ in both:
        ax = j.Axis(df, "x", shape=16, min=0, max=10)
        events = []
        ax.observe(lambda c: events.append(c["name"]))
        ax.expression = "y"
        assert ax.status == "no_limits" and ax.min is None and events == ["expression"]
        ax.ensure_limits()
        assert ax.status == "ready" and ax.max <= 2.01 and events[-1] == "limits"


def test_axis_categorical_takes_no_pass(both):
    for df, j, _ in both:
        df = df.categorize("k", labels=list("abcde"))
        passes = df.executor.passes
        ax = j.Axis(df, "k")
        assert ax.status == "ready" and ax.shape == 5 and (ax.min, ax.max) == (-0.5, 4.5)
        assert df.executor.passes == passes


@pytest.mark.parametrize("agg,selection", [(None, None), (("mean", "y"), None),
                                           (("sum", "y"), True), (None, [None, True]),
                                           (("max", "x"), [None, True])])
def test_grid_model(both, agg, selection):
    grids = []
    for df, _, _ in both:
        df.select("y > 0")
        grids.append(df.widget.data_array(["x", "y"], agg=agg, selection=selection))
    ref, port = grids
    assert port.status == "ready" and port.grid.shape == ref.grid.shape
    npt.assert_allclose(port.grid, ref.grid, rtol=RTOL, atol=ATOL, equal_nan=True)
    df = both[1][0]
    limits = [[a.min, a.max] for a in port.axes]
    if agg is None and selection is None:
        npt.assert_array_equal(port.grid, df.count(binby=["x", "y"], limits=limits, shape=64))


def test_selection_change_one_pass_two_views(both):
    """One selection change regrids both linked models in one pass."""
    for df, j, _ in both:
        hist = j.GridModel(df, [j.Axis(df, "x", shape=16, min=0, max=10)], selection=True)
        heat = j.GridModel(df, [j.Axis(df, "x", shape=16, min=0, max=10),
                                j.Axis(df, "y", shape=8, min=-2, max=2)], selection=True)
        df.select("x > 5")
        j.get_dispatcher(df).flush()
        passes = df.executor.passes
        df.select("x > 3")
        assert df.executor.passes == passes + 1
        x = arrays()["x"]
        assert hist.grid.sum() == heat.grid.sum() == (x > 3).sum()
        df.select("x > 8")
        assert hist.grid.sum() == heat.grid.sum() == (x > 8).sum()


@pytest.mark.parametrize("views", [2, 3, 5])
def test_one_pass_per_flush(views):
    """A flush stages every dirty model's delayed tasks and runs ONE pass of
    the port's executor, for any number of linked models, statistics and
    selections (vaex_tpu/jupyter.py:269-279)."""
    df = frame(vaex_tpu_torch)
    specs = [(["x"], None), (["x", "y"], None), (["y"], ("mean", "x")), (["k"], ("sum", "y")),
             (["x", "k"], ("max", "y"))][:views]
    models = [jupyter.GridModel(df, [jupyter.Axis(df, e, shape=12, min=0, max=5) for e in axes],
                                agg=agg, selection=[None, True]) for axes, agg in specs]
    df.select("y > 0")
    for expression in ("x > 2", "(x > 1) & (y < 1)", "k == 3"):
        passes = df.executor.passes
        df.select(expression)
        assert df.executor.passes == passes + 1
        assert all(m.status == "ready" for m in models)
        assert models[0].grid[1].sum() == df.count(selection=expression,
                                                   binby=["x"], limits=[0, 5], shape=12).sum()
    passes = df.executor.passes
    jupyter.get_dispatcher(df).flush()  # nothing dirty: no pass
    assert df.executor.passes == passes


def test_flush_of_new_axes_takes_two_passes():
    """Models whose axes have no limits yet: one pass for every minmax,
    one for every grid."""
    df = frame(vaex_tpu_torch)
    d = jupyter.get_dispatcher(df)
    d._auto = False
    models = [jupyter.GridModel(df, [jupyter.Axis(df, "x", shape=8)], dispatcher=d),
              jupyter.GridModel(df, [jupyter.Axis(df, "x"), jupyter.Axis(df, "y")],
                                dispatcher=d)]
    passes = df.executor.passes
    d.flush()
    assert df.executor.passes == passes + 2
    assert all(m.status == "ready" for m in models)


def test_observer_fires(both):
    for df, _, _ in both:
        events = []
        model = df.widget.data_array(["x"], selection=True)
        model.observe(lambda change: events.append(change["name"]), "grid")
        df.select("x < 2")
        assert events == ["grid"]


def test_grid_model_refuses_a_bare_name(both):
    for df, j, _ in both:
        with pytest.raises(ValueError):
            j.GridModel(df, ["x"], agg="mean")


def test_linked_views_brush_one_pass(both):
    """Brushing the histogram view regrids the heatmap view in one pass, the
    whole view -> select -> dispatch -> regrid -> redraw loop, headless."""
    selected = []
    for df, _, v in both:
        hist = v.HistogramView(df, "x", shape=16, backend=v.HeadlessBackend())
        heat = v.HeatmapView(df, "x", "y", shape=8, backend=v.HeadlessBackend())
        hist.brush(3.0, 10.0)
        passes, draws = df.executor.passes, heat.draw_count
        hist.brush(5.0, 10.0)
        assert df.executor.passes == passes + 1 and heat.draw_count == draws + 1
        x = arrays()["x"]
        # the row at the axis's max lands in the overflow edge, which is stripped
        assert 0 <= ((x >= 5) & (x <= 10)).sum() - hist._grids()[1].sum() <= 1
        selected.append((hist._grids(), heat._grids()))
        hist.unbrush()
        assert not df.has_selection()
    for a, b in zip(selected[0], selected[1]):
        npt.assert_array_equal(a[0], b[0])
        npt.assert_array_equal(a[1], b[1])


def test_heatmap_view_brush2d(both):
    draws = []
    for df, _, v in both:
        heat = v.HeatmapView(df, "x", "y", shape=8, backend=v.HeadlessBackend())
        heat.brush2d(2.0, 8.0, -1.0, 1.0)
        a = arrays()
        want = ((a["x"] >= 2) & (a["x"] <= 8) & (a["y"] >= -1) & (a["y"] <= 1)).sum()
        assert heat._grids()[1].sum() == want
        kinds = [d[0] for d in heat.backend.draws]
        assert kinds.count("heatmap") == heat.draw_count
        draws.append(heat.backend.draws[-1])
    assert draws[0][1] == draws[1][1]  # the extent
    npt.assert_array_equal(draws[0][3], draws[1][3])


def test_view_backends(both):
    df = both[1][0]
    assert isinstance(jupyter_view.pick_backend("headless"), jupyter_view.HeadlessBackend)
    backend = jupyter_view.pick_backend()
    assert hasattr(backend, "draw_histogram")
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    mpl = jupyter_view.pick_backend("matplotlib")
    view = jupyter_view.HistogramView(df, "x", shape=8, backend=mpl)
    view.brush(1.0, 2.0)
    assert [d[0] for d in mpl.draws] == ["histogram", "histogram"]
    heat = df.widget.heatmap_view("x", "y", shape=4, backend=mpl)
    assert mpl.draws[-1][0] == "heatmap" and heat.draw_count == 1


def test_widget_accessor_views(both):
    df = both[1][0]
    hist = df.widget.histogram_view(backend=jupyter_view.HeadlessBackend())
    heat = df.widget.heatmap_view(backend=jupyter_view.HeadlessBackend())
    assert hist.model.axes[0].expression == "x"
    assert [a.expression for a in heat.model.axes] == ["x", "y"]
    ax = df.widget.axis_model("y", shape=4, min=-2, max=2)
    npt.assert_allclose(ax.bin_centers, [-1.5, -0.5, 0.5, 1.5])


def test_widgets(both):
    pytest.importorskip("ipywidgets")
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    df = both[1][0]
    box = df.widget.histogram("x", shape=16)
    assert len(box.children) == 2
    box = df.widget.heatmap("x", "y", shape=8)
    assert len(box.children) == 2


# ------------------------------------------------------ the frame's hooks


def test_signal_selection_changed():
    """select, select_nothing, the select_* helpers, undo and redo emit
    (frame, name), as vaex_tpu's frame does."""
    for package in (vaex_tpu, vaex_tpu_torch):
        df = frame(package)
        seen = []
        df.signal_selection_changed.connect(lambda d, name: seen.append((d is df, name)))
        df.select("x > 1")
        df.select("y > 0", name="other")
        df.select_nothing()
        df.selection_undo()
        df.selection_redo()
        df.select_box(["x", "y"], [[0, 1], [0, 1]], name="box")
        assert seen == [(True, "default"), (True, "other"), (True, "default"),
                        (True, "default"), (True, "default"), (True, "box")], package
        copied = df.copy()
        copied.select("x > 2")
        assert len(seen) == 6  # a copy has its own signal


def test_accessor_registry():
    calls = []

    @vaex_tpu_torch.register_dataframe_accessor("probe_accessor")
    class Probe:
        def __init__(self, df):
            calls.append(df)
            self.df = df

    try:
        df = frame(vaex_tpu_torch)
        assert df.probe_accessor.df is df and df.probe_accessor is df.probe_accessor
        assert len(calls) == 1
        assert df.copy().probe_accessor is not df.probe_accessor and len(calls) == 2
        with pytest.raises(AttributeError):
            df.no_such_accessor
    finally:
        del vaex_tpu_torch.dataframe._df_accessors["probe_accessor"]
    for name in ("geo", "astro", "viz", "graphql", "widget", "ml"):
        assert name in vaex_tpu_torch.dataframe._df_accessors

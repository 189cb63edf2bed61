"""Reactive grid models for linked views, and the ``df.widget`` accessor
(vaex_tpu/jupyter.py).

The models need no widget library, so they run headless:

* :class:`Axis`: an observable (expression, shape, min, max,
  bin_centers), ``no_limits`` until a minmax gives its limits; the
  minmaxes of several axes share one pass (``delay=True``).
* :class:`GridModel`: axes, a statistic and selections -> an N-d grid,
  recomputed by the executor.
* :class:`ModelDispatcher`: one per frame; it listens to the frame's
  ``signal_selection_changed``, marks the models that use the selection
  dirty, stages every dirty model's delayed tasks and runs ONE pass
  (``executor.passes`` grows by one per brush, whatever the number of
  linked views).

``df.widget`` builds ipywidgets dashboards on these models where ipywidgets
and matplotlib are installed.
"""

from __future__ import annotations

import numpy as np

from .dataframe import register_dataframe_accessor


class _Observable:
    """Minimal observer mixin (vaex-jupyter uses traitlets)."""

    def __init__(self):
        self._observers = []

    def observe(self, callback, names=None):
        names = ([names] if isinstance(names, str) else
                 list(names) if names else None)
        self._observers.append((callback, names))

    def _notify(self, name, value):
        for callback, names in self._observers:
            if names is None or name in names:
                callback({"owner": self, "name": name, "new": value})


class Axis(_Observable):
    """One binning axis (vaex-jupyter's model.py:86).

    Status machine compressed to the two observable states that matter for
    views: ``"no_limits"`` (a minmax pass is needed) and ``"ready"``.
    Categorical expressions take their limits from category metadata with
    no pass at all.
    """

    def __init__(self, df, expression, shape=64, min=None, max=None):
        super().__init__()
        self.df = df
        self._expression = str(expression)
        self.shape = int(shape)
        self.min = min
        self.max = max
        self.bin_centers = None
        self.exception = None
        self._limits_promise = None
        if df.is_category(self._expression):
            n = df.category_count(self._expression)
            self.min, self.max = -0.5, n - 0.5
            self.shape = n
        self.status = "ready" if self._has_limits else "no_limits"
        if self.status == "ready":
            self._calculate_centers()

    # -- observable properties ------------------------------------------------
    @property
    def expression(self):
        return self._expression

    @expression.setter
    def expression(self, value):
        value = str(value)
        if value == self._expression:
            return
        self._expression = value
        self.min = self.max = None
        self.status = "no_limits"
        self._limits_promise = None
        self._notify("expression", value)

    @property
    def _has_limits(self):
        return self.min is not None and self.max is not None

    def set_limits(self, vmin, vmax):
        self.min, self.max = float(vmin), float(vmax)
        self.status = "ready"
        self._calculate_centers()
        self._notify("limits", (self.min, self.max))

    # -- limit computation (fused across axes via delay=True) ----------------
    def stage_limits(self):
        """Queue the minmax pass (no execution) — the dispatcher executes
        once for every staged axis together."""
        if self._has_limits or self._limits_promise is not None:
            return False
        self._limits_promise = self.df.minmax(self.expression, delay=True)
        return True

    def finish_limits(self):
        if self._limits_promise is not None:
            vmin, vmax = np.asarray(self._limits_promise.get())
            self._limits_promise = None
            self.set_limits(vmin, vmax)

    def ensure_limits(self):
        if self.stage_limits():
            self.df.execute()
        self.finish_limits()

    def _calculate_centers(self):
        if self.df.is_category(self.expression):
            self.bin_centers = np.arange(self.shape)
            return
        edges = np.linspace(self.min, self.max, self.shape + 1)
        self.bin_centers = (edges[:-1] + edges[1:]) / 2

    def __repr__(self):
        return (f"Axis(expression={self.expression!r}, shape={self.shape}, "
                f"min={self.min}, max={self.max}, status={self.status!r})")


class GridModel(_Observable):
    """Axes + aggregation + selection -> an observable N-d grid (vaex-jupyter's
    DataArray model, model.py:249).

    ``grid`` holds the latest result (numpy, selections stacked on a
    leading axis when ``selection`` is a list, mirroring the stats API).
    Recomputation is two-phase and fuseable: ``stage()`` queues delayed
    tasks, ``finish()`` reads them — the dispatcher stages every dirty
    model then runs ONE executor pass.
    """

    def __init__(self, df, axes, agg=None, selection=None, dispatcher=None):
        super().__init__()
        self.df = df
        self.axes = [a if isinstance(a, Axis) else Axis(df, a) for a in axes]
        # agg spec: None/'count' -> row counts; ('mean', 'x')-style tuples
        # route through the generic stats entry point
        if agg is None or agg == "count":
            agg = ("count", "*")
        elif isinstance(agg, str):
            raise ValueError("pass agg as ('name', 'expression'), e.g. ('mean', 'x')")
        self.agg = (str(agg[0]), str(agg[1]))
        self.selection = selection
        self.grid = None
        self.status = "dirty"
        self._promises = None
        for ax in self.axes:
            ax.observe(self._on_axis_change, ["expression", "limits"])
        self._dispatcher = dispatcher or get_dispatcher(df)
        self._dispatcher.register(self)

    # -- reactive hooks -------------------------------------------------------
    def _on_axis_change(self, change):
        if change["name"] == "expression":
            self.status = "dirty"
            self._dispatcher.schedule()
        elif change["name"] == "limits" and self.status != "computing":
            self.status = "dirty"
            self._dispatcher.schedule()

    def uses_selection(self, name):
        sels = self.selection if isinstance(self.selection, (list, tuple)) else [self.selection]
        for sel in sels:
            if sel is None or sel is False:
                continue
            if sel is True and name == "default":
                return True
            if str(sel) == name:
                return True
        return False

    # -- two-phase recompute ----------------------------------------------------
    def stage(self):
        """Queue the axis minmaxes (phase 1) or the grid aggregation
        (phase 2) as delayed tasks; returns True when anything was queued."""
        staged = False
        for ax in self.axes:
            staged |= ax.stage_limits()
        if staged:
            return True
        if any(not ax._has_limits for ax in self.axes):
            # an axis minmax promise is still in flight (a reentrant flush
            # can land here from the FIRST axis's set_limits notification
            # while the second axis is unresolved) — the owning finish()
            # completes it and re-schedules
            return False
        if self.status != "dirty":
            return False
        self.status = "computing"
        binby = [ax.expression for ax in self.axes]
        limits = [[ax.min, ax.max] for ax in self.axes]
        shape = [ax.shape for ax in self.axes]
        selections = (self.selection if isinstance(self.selection, (list, tuple))
                      else [self.selection])
        # selection=True before any selection exists = all rows (views are
        # built linked-but-unbrushed)
        selections = [None if (s is True and self.df.get_selection("default") is None)
                      else s for s in selections]
        name, expr = self.agg
        self._promises = [
            self.df._compute_agg(name, expr, binby=binby, limits=limits,
                                 shape=shape, selection=sel, delay=True)
            for sel in selections
        ]
        return True

    def finish(self):
        for ax in self.axes:
            ax.finish_limits()
        if self._promises is None:
            return
        grids = [np.asarray(p.get()) for p in self._promises]
        self._promises = None
        self.grid = grids[0] if not isinstance(self.selection, (list, tuple)) else np.stack(grids)
        self.status = "ready"
        self._notify("grid", self.grid)

    def compute(self):
        """Synchronous standalone recompute (one or two fused passes)."""
        self.status = "dirty"
        while self.stage():
            self.df.execute()
            self.finish()
        self.finish()
        return self.grid


class ModelDispatcher:
    """One per DataFrame: routes selection changes to the models using that
    selection and flushes ALL dirty models in one fused pass — the
    linked-views contract (brush in a histogram re-grids the heatmap and
    every other linked view with a single pass)."""

    def __init__(self, df):
        self.df = df
        self.models = []
        self._auto = True
        df.signal_selection_changed.connect(self._on_selection_changed)

    def register(self, model):
        self.models.append(model)

    def _on_selection_changed(self, df, name):
        touched = False
        for model in self.models:
            if model.uses_selection(name):
                model.status = "dirty"
                touched = True
        if touched and self._auto:
            self.flush()

    def schedule(self):
        if self._auto:
            self.flush()

    def flush(self):
        """Stage every dirty model, run fused passes until settled."""
        for _ in range(3):  # phase 1: limits; phase 2: grids; settle
            staged = False
            for model in self.models:
                staged |= model.stage()
            if not staged:
                break
            self.df.execute()
            for model in self.models:
                model.finish()


def get_dispatcher(df):
    """One dispatcher per DataFrame instance, stored on the frame itself
    (an id()-keyed registry would leak and could mis-route after CPython
    reuses a freed id)."""
    d = getattr(df, "_widget_dispatcher", None)
    if d is None:
        d = df._widget_dispatcher = ModelDispatcher(df)
    return d


@register_dataframe_accessor("widget")
class DataFrameAccessorWidget:
    def __init__(self, df):
        self.df = df

    # -- reactive models (headless-usable) ------------------------------------
    def axis_model(self, expression, shape=64, min=None, max=None):
        """An observable binning axis (vaex-jupyter's model.py:86)."""
        return Axis(self.df, expression, shape=shape, min=min, max=max)

    def data_array(self, axes, agg=None, selection=None):
        """An observable grid model re-aggregating through the executor on
        axis/selection change (vaex-jupyter's DataArray)."""
        model = GridModel(self.df, axes, agg=agg, selection=selection)
        model.compute()
        return model

    # -- linked views on the GridModel layer (jupyter_view.py) ----------------
    def histogram_view(self, x=None, shape=64, backend=None):
        """A brushable histogram bound to a GridModel: brushing selects the
        interval on the frame and every linked view re-grids in ONE fused
        pass (vaex-jupyter's view.py / bqplot.py)."""
        from .jupyter_view import HistogramView
        if x is None:
            cols = self._numeric_columns()
            if not cols:
                raise ValueError("no numeric columns to plot")
            x = cols[0]
        return HistogramView(self.df, x, shape=shape, backend=backend)

    def heatmap_view(self, x=None, y=None, shape=128, backend=None):
        """A brushable 2-d count view bound to a GridModel."""
        from .jupyter_view import HeatmapView
        if x is None or y is None:
            cols = self._numeric_columns()
            if len(cols) < 2:
                raise ValueError("need two numeric columns for a heatmap "
                                 "(pass x= and y= explicitly)")
            x = x or cols[0]
            y = y or cols[1]
        return HeatmapView(self.df, x, y, shape=shape, backend=backend)

    def _numeric_columns(self):
        from .datatype import DataType
        return [c for c in self.df.get_column_names()
                if DataType(self.df.data_type(c)).numpy.kind in "biuf"]

    def histogram(self, x=None, shape=64, selection_box=True):
        import ipywidgets as widgets
        import matplotlib.pyplot as plt
        from IPython.display import clear_output

        df = self.df
        columns = self._numeric_columns()
        x = x or columns[0]
        dd_x = widgets.Dropdown(options=columns, value=str(x), description="x")
        sl_shape = widgets.IntSlider(value=shape, min=8, max=512, description="bins")
        txt_sel = widgets.Text(value="", description="selection")
        out = widgets.Output()

        def update(*_):
            with out:
                clear_output(wait=True)
                sel = txt_sel.value.strip() or False
                limits = df.limits(dd_x.value, None, selection=sel)
                counts = df.count(binby=[dd_x.value], limits=[limits],
                                  shape=sl_shape.value, selection=sel)
                centers = np.linspace(limits[0], limits[1], sl_shape.value + 1)[:-1]
                plt.figure(figsize=(7, 3))
                plt.plot(centers, counts, drawstyle="steps-mid")
                plt.xlabel(dd_x.value)
                plt.ylabel("count")
                plt.show()

        for w in (dd_x, sl_shape, txt_sel):
            w.observe(update, "value")
        update()
        controls = [dd_x, sl_shape] + ([txt_sel] if selection_box else [])
        return widgets.VBox([widgets.HBox(controls), out])

    def heatmap(self, x=None, y=None, shape=128):
        import ipywidgets as widgets
        import matplotlib.pyplot as plt
        from IPython.display import clear_output

        df = self.df
        columns = self._numeric_columns()
        x = x or columns[0]
        y = y or (columns[1] if len(columns) > 1 else columns[0])
        dd_x = widgets.Dropdown(options=columns, value=str(x), description="x")
        dd_y = widgets.Dropdown(options=columns, value=str(y), description="y")
        txt_sel = widgets.Text(value="", description="selection")
        out = widgets.Output()

        def update(*_):
            with out:
                clear_output(wait=True)
                sel = txt_sel.value.strip() or False
                limits = df.limits([dd_x.value, dd_y.value], None, selection=sel)
                grid = df.count(binby=[dd_x.value, dd_y.value], limits=limits,
                                shape=shape, selection=sel)
                values = np.log1p(np.asarray(grid, dtype="f8"))
                plt.figure(figsize=(6, 5))
                plt.imshow(values.T, origin="lower", aspect="auto",
                           extent=[limits[0][0], limits[0][1], limits[1][0], limits[1][1]])
                plt.xlabel(dd_x.value)
                plt.ylabel(dd_y.value)
                plt.show()

        for w in (dd_x, dd_y, txt_sel):
            w.observe(update, "value")
        update()
        return widgets.VBox([widgets.HBox([dd_x, dd_y, txt_sel]), out])

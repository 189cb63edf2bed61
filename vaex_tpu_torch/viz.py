"""Matplotlib plots of binned grids: ``df.viz`` (vaex_tpu/viz.py).

``histogram`` and ``heatmap`` compute their grid first, as one pass of
binned statistics on the frame's device (:meth:`_what_grid`), and import
matplotlib only to draw it, so the grids need no plotting library.
"""

from __future__ import annotations

import numpy as np

from .dataframe import register_dataframe_accessor


@register_dataframe_accessor("viz")
class DataFrameAccessorViz:
    def __init__(self, df):
        self.df = df

    def histogram(self, x, what="count(*)", grid=None, shape=64, limits=None,
                  selection=None, n=None, figsize=None, xlabel=None, ylabel=None,
                  label=None, show=False, **kwargs):
        """1-d histogram from a binby count grid (vaex-viz's mpl.py)."""
        df = self.df
        x = str(x)
        limits = df.limits(x, limits, selection=selection)
        if grid is None:
            grid = self._what_grid(what, [x], [limits], shape, selection)
        edges = np.linspace(limits[0], limits[1], (np.shape(grid)[0]) + 1)
        centers = (edges[:-1] + edges[1:]) / 2
        import matplotlib.pyplot as plt
        if figsize:
            plt.figure(figsize=figsize)
        plt.plot(centers, grid, drawstyle="steps-mid", label=label, **kwargs)
        plt.xlabel(xlabel or x)
        plt.ylabel(ylabel or str(what))
        if show:
            plt.show()
        return grid

    def heatmap(self, x, y, what="count(*)", shape=128, limits=None, selection=None,
                logscale=False, figsize=None, show=False, **kwargs):
        """2-d density map (vaex-viz's mpl.py)."""
        df = self.df
        x, y = str(x), str(y)
        limits2 = df.limits([x, y], limits, selection=selection)
        grid = self._what_grid(what, [x, y], limits2, shape, selection)
        values = np.asarray(grid, dtype="f8")
        if logscale:
            with np.errstate(divide="ignore"):
                values = np.log10(values)
        import matplotlib.pyplot as plt
        if figsize:
            plt.figure(figsize=figsize)
        plt.imshow(values.T, origin="lower", aspect="auto",
                   extent=[limits2[0][0], limits2[0][1], limits2[1][0], limits2[1][1]],
                   **kwargs)
        plt.xlabel(x)
        plt.ylabel(y)
        if show:
            plt.show()
        return grid

    def scatter(self, x, y, s=None, c=None, selection=None, length_limit=50000,
                length_check=True, figsize=None, show=False, **kwargs):
        """Scatter for small (filtered) frames (vaex-viz's mpl.py)."""
        df = self.df
        if length_check and len(df) > length_limit:
            raise ValueError(f"too many rows ({len(df)}) for scatter; filter or "
                             f"raise length_limit")
        xv = np.asarray(df.evaluate(str(x), selection=selection, array_type="numpy"))
        yv = np.asarray(df.evaluate(str(y), selection=selection, array_type="numpy"))
        import matplotlib.pyplot as plt
        if figsize:
            plt.figure(figsize=figsize)
        plt.scatter(xv, yv, s=s, c=c, **kwargs)
        plt.xlabel(str(x))
        plt.ylabel(str(y))
        if show:
            plt.show()

    def _what_grid(self, what, binby, limits, shape, selection):
        """Parse 'count(*)' / 'mean(x)' style what-specs (vaex-viz's mpl.py)."""
        what = str(what)
        if "(" in what:
            name, rest = what.split("(", 1)
            arg = rest.rstrip(")").strip()
        else:
            name, arg = what, "*"
        name = name.strip()
        df = self.df
        if name == "count":
            return df.count(None if arg == "*" else arg, binby=binby, limits=limits,
                            shape=shape, selection=selection or False)
        method = getattr(df, name)
        return method(arg, binby=binby, limits=limits, shape=shape,
                      selection=selection or False)

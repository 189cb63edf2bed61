"""vaex_tpu_torch — the PyTorch/CUDA port of vaex_tpu.

A lazy, expression-driven DataFrame engine whose aggregation passes run on
torch tensors: on an NVIDIA GPU through hand-written CUDA kernels
(``vaex_tpu_torch/csrc``), on the CPU through their plain PyTorch versions.
This package imports neither JAX nor ``vaex_tpu``; the API mirrors
``vaex_tpu`` for the slice ported so far (see ROADMAP.md):

    df = vaex_tpu_torch.from_arrays(k=keys, x=values).to_device("cuda")
    df = df.categorize("k", labels=range(100))
    df.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"}, sort=True)
    df.nunique("x", binby="k"); df.cov(["x", "y"]); df.rolling(5, column="x").sum()
    (vaex_tpu_torch.stat.mean("x") / vaex_tpu_torch.stat.std("x")).calculate(df, binby="k")
    df["y"] = df.apply(f, ["x", "k"]); df.state_write("state.json"); pickle.dumps(df)
    with vaex_tpu_torch.cache.off(): df.sum("x", progress=True)
"""

from __future__ import annotations

import numpy as _np

from . import agg  # noqa: F401
from . import cache  # noqa: F401
from . import functions as _functions  # noqa: F401  (populates the namespace)
from . import settings  # noqa: F401
from . import stat  # noqa: F401
from .column import ColumnVirtualConstant, ColumnVirtualRange
from .dataframe import DataFrame
from .dataset import Dataset, DatasetArrays  # noqa: F401
from .delayed import delayed  # noqa: F401
from .expression import Expression  # noqa: F401
from .groupby import BinnerTime  # noqa: F401
from .ops.setops import RowLimitException  # noqa: F401
from .registry import register_function  # noqa: F401

__version__ = "0.1.0"


def from_dataset(dataset) -> DataFrame:
    return DataFrame(dataset)


def from_arrays(**arrays) -> DataFrame:
    """A DataFrame over numpy arrays, numpy masked arrays or torch tensors."""
    columns = {}
    for name, ar in arrays.items():
        if isinstance(ar, (list, tuple)):
            ar = _np.asarray(ar)
        columns[name] = ar
    return from_dataset(DatasetArrays(columns))


def from_dict(data) -> DataFrame:
    return from_arrays(**data)


def from_items(*items) -> DataFrame:
    return from_arrays(**dict(items))


def from_pandas(df, name="pandas", copy_index=False, index_name="index") -> DataFrame:
    """A DataFrame over the columns of a pandas DataFrame (and its index
    with ``copy_index``); an object column with missing values becomes a
    masked array (vaex_tpu/__init__.py:107-121)."""
    columns = {}
    for key in df.columns:
        series = df[key]
        values = series.to_numpy()
        if values.dtype == object and series.isna().any():
            values = _np.ma.MaskedArray(values, series.isna().to_numpy())
        columns[str(key)] = values
    if copy_index:
        columns[index_name] = df.index.to_numpy()
    return from_arrays(**columns)


def from_arrow_table(table) -> DataFrame:
    """A DataFrame over the columns of a pyarrow Table: strings stay arrow
    (a host string column), other columns become numpy arrays, masked where
    null (vaex_tpu/__init__.py:98)."""
    from . import array_types
    columns = {}
    for name, column in zip(table.column_names, table.columns):
        column = column.combine_chunks() if hasattr(column, "combine_chunks") else column
        columns[str(name)] = column if array_types.is_string_array(column) else (
            array_types.to_numpy(column))
    return from_arrays(**columns)


def vrange(start, stop=None, step=1, dtype="i8") -> DataFrame:
    """A frame of one column ``x``: ``start, start + step, ...`` below
    ``stop``, which holds no memory (a tile is an ``arange`` made on the
    pass device): ``vrange(0, 10**9)`` costs nothing until a pass reads it."""
    if stop is None:
        start, stop = 0, start
    return from_dataset(DatasetArrays({"x": ColumnVirtualRange(start, stop, step, dtype)}))


def vconstant(value, length, dtype=None) -> ColumnVirtualConstant:
    """A column of ``length`` rows of ``value``, for ``add_column``."""
    return ColumnVirtualConstant(value, int(length), dtype)


def concat(dfs) -> DataFrame:
    """The rows of the frames one after another, over the columns all of
    them have (vaex_tpu/__init__.py:200)."""
    dfs = list(dfs)
    if len(dfs) == 1:
        return dfs[0]
    return dfs[0].concat(*dfs[1:])

"""vaex_tpu_torch — the PyTorch/CUDA port of vaex_tpu.

A lazy, expression-driven DataFrame engine whose aggregation passes run on
torch tensors: on an NVIDIA GPU through hand-written CUDA kernels
(``vaex_tpu_torch/csrc``), on the CPU through their plain PyTorch versions.
This package imports neither JAX nor ``vaex_tpu``; the API mirrors
``vaex_tpu`` for the slice ported so far (see ROADMAP.md):

    df = vaex_tpu_torch.from_arrays(k=keys, x=values).to_device("cuda")
    df = df.categorize("k", labels=range(100))
    df.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"}, sort=True)
    df.export_hdf5("t.hdf5"); vaex_tpu_torch.open("t.hdf5").sum("x")  # streamed from the file
    df.nunique("x", binby="k"); df.cov(["x", "y"]); df.rolling(5, column="x").sum()
    (vaex_tpu_torch.stat.mean("x") / vaex_tpu_torch.stat.std("x")).calculate(df, binby="k")
    df["y"] = df.apply(f, ["x", "k"]); df.state_write("state.json"); pickle.dumps(df)
    with vaex_tpu_torch.cache.off(): df.sum("x", progress=True)
    df.astro.eq2gal(); df.graphql.execute("{ df { count } }")
    vaex_tpu_torch.ml.KMeans(features=["x", "y"], n_clusters=16).fit(df); df.ml.metrics
    vaex_tpu_torch.server.asgi.create_app(Service({"sky": df}))  # python -m vaex_tpu_torch webserver
"""

from __future__ import annotations

import glob as _glob
import os as _os

import numpy as _np

from . import agg  # noqa: F401
from . import cache  # noqa: F401
from . import progress  # noqa: F401
from . import parallel  # noqa: F401  (vaex_tpu_torch.parallel.data_mesh, ...)
from . import functions as _functions  # noqa: F401  (populates the namespace)
from . import settings  # noqa: F401
from . import stat  # noqa: F401
from .column import ColumnVirtualConstant, ColumnVirtualRange
from .dataframe import DataFrame, register_dataframe_accessor  # noqa: F401
from .dataset import Dataset, DatasetArrays  # noqa: F401
from .delayed import delayed  # noqa: F401
from .expression import Expression  # noqa: F401
from .groupby import BinnerTime, Grouper, GrouperCategory  # noqa: F401
from .ops.setops import RowLimitException  # noqa: F401
from .registry import register_function  # noqa: F401
# the accessors df.geo, df.astro, df.viz, df.graphql, df.widget and expr.struct
from . import astro, geo, graphql, jupyter, struct, viz  # noqa: F401
from . import ml  # noqa: F401  (df.ml: the transformers, KMeans, the metrics)

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


def concat(dfs, resolver="flexible") -> DataFrame:
    """The rows of the frames one after another, over the columns all of
    them have (vaex_tpu/__init__.py:200); ``resolver`` changes nothing, as in
    vaex_tpu."""
    dfs = list(dfs)
    if len(dfs) == 1:
        return dfs[0]
    return dfs[0].concat(*dfs[1:], resolver=resolver)


def from_arrow_dataset(ds) -> DataFrame:
    """A frame over a ``pyarrow.dataset`` read whole (vaex_tpu/__init__.py:101)."""
    return from_arrow_table(ds.to_table())


def from_csv(path, convert=False, chunk_size=None, **kwargs) -> DataFrame:
    """A CSV file read by pyarrow; with ``convert`` written once to HDF5
    beside it (or to the path ``convert`` names) and opened from there."""
    from .io.arrow import open_csv
    df = open_csv(path, **kwargs)
    if convert:
        out = str(path) + ".hdf5" if convert is True else str(convert)
        if not _os.path.exists(out):
            df.export_hdf5(out, chunk_size=chunk_size)
        return open(out)
    return df


def from_json(path_or_buffer, orient=None, copy_index=False) -> DataFrame:
    import pandas as pd
    return from_pandas(pd.read_json(path_or_buffer, orient=orient), copy_index=copy_index)


def from_ascii(path, seperator=None, names=True, **kwargs) -> DataFrame:
    """A whitespace- (or ``seperator``-) separated text table through pandas."""
    import pandas as pd
    return from_pandas(pd.read_csv(path, sep=seperator or r"\s+"))


def open(path, convert=False, shuffle=False, fs_options=None, fs=None, *args, **kwargs):
    """A frame over a file, by its extension (vaex_tpu/__init__.py:136-190):
    HDF5 and Arrow IPC memory-mapped, Parquet read lazily by row groups,
    Feather, FITS, VOTable, CSV, JSON, and Gadget snapshots by their record
    structure; a remote url through :mod:`.io.remote`; a glob pattern as
    the files one after another.  With ``convert`` the
    frame is written once to HDF5 (``path + ".hdf5"``, or the path
    ``convert`` names) and opened from there."""
    path = str(path)
    from .io.remote import is_remote, open_remote
    if is_remote(path):
        return open_remote(path, fs_options)
    if any(c in path for c in "*?["):
        return open_many(sorted(_glob.glob(path)))
    ext = _os.path.splitext(path)[1].lower()
    if ext in (".hdf5", ".h5"):
        from .io.hdf5 import open_hdf5 as opener
    elif ext == ".parquet":
        from .io.arrow import open_parquet as opener
    elif ext == ".arrow":
        from .io.arrow import open_arrow as opener
    elif ext == ".feather":
        from .io.arrow import open_feather as opener
    elif ext == ".fits":
        from .io.fits import open_fits as opener
    elif ext in (".vot", ".votable", ".xml"):
        from .io.votable import open_votable as opener
    elif ext == ".csv":
        return from_csv(path, convert=convert)
    elif ext == ".json":
        opener = from_json
    else:
        from .io.gadget import is_gadget, open_gadget as opener
        if not is_gadget(path):
            raise IOError(f"cannot open {path!r}: unknown extension {ext!r}")
    df = opener(path)
    if convert:
        out = path + ".hdf5" if convert is True else str(convert)
        if _os.path.abspath(out) == _os.path.abspath(path):
            return df
        if not _os.path.exists(out):
            df.export_hdf5(out)
        return open(out)
    return df


def open_many(filenames) -> DataFrame:
    """The files one after another (vaex_tpu/__init__.py:193)."""
    filenames = list(filenames)
    if not filenames:
        raise IOError("no files to open")
    return concat([open(f) for f in filenames])


def example() -> DataFrame:
    """A generated frame of 10 000 rows (id, x, y, z, vx, vy, vz, E), drawn
    from seed 42 as vaex_tpu.example() draws it; nothing is downloaded."""
    rng = _np.random.default_rng(42)
    n = 10000
    return from_arrays(id=_np.arange(n), x=rng.normal(0, 1, n), y=rng.normal(0, 1, n),
                       z=rng.normal(0, 1, n), vx=rng.normal(0, 10, n), vy=rng.normal(0, 10, n),
                       vz=rng.normal(0, 10, n), E=rng.uniform(0, 100, n))

"""The export dispatch by extension, CSV and JSON (vaex_tpu/io/export.py)."""

from __future__ import annotations

import json
import os

from . import export_rows, replacing


def export(df, path, progress=None, chunk_size=None):
    """Write ``df`` to ``path`` in the format its extension names."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".hdf5", ".h5"):
        from .hdf5 import export_hdf5
        return export_hdf5(df, path, chunk_size=chunk_size)
    if ext == ".parquet":
        from .arrow import export_parquet
        return export_parquet(df, path, chunk_size=chunk_size)
    if ext == ".arrow":
        from .arrow import export_arrow
        return export_arrow(df, path, chunk_size=chunk_size)
    if ext == ".feather":
        from .arrow import export_feather
        return export_feather(df, path, chunk_size=chunk_size)
    if ext == ".fits":
        from .fits import export_fits
        return export_fits(df, path, chunk_size=chunk_size)
    if ext in (".vot", ".votable"):
        from .votable import export_votable
        return export_votable(df, path, chunk_size=chunk_size)
    if ext == ".csv":
        return export_csv(df, path, chunk_size=chunk_size)
    if ext == ".json":
        return export_json(df, path, chunk_size=chunk_size)
    raise ValueError(f"unsupported export format: {ext}")


def export_csv(df, path, chunk_size=None, **kwargs):
    """CSV through pandas, a chunk at a time, the header once."""
    names = df.get_column_names()
    with replacing(path) as tmp:
        for i1, _, part in export_rows(df, chunk_size):
            part.to_pandas_df(names).to_csv(tmp, index=False, header=i1 == 0,
                                            mode="w" if i1 == 0 else "a", **kwargs)
    return path


def export_json(df, path, chunk_size=None):
    """A JSON list of one object per row (``to_records``), a chunk of rows
    at a time; a value JSON has no form for is written as its ``str``."""
    with replacing(path) as tmp, open(tmp, "w") as f:
        f.write("[")
        first = True
        for _, _, part in export_rows(df, chunk_size):
            for record in part.to_records():
                f.write(("" if first else ", ") + json.dumps(record, default=str))
                first = False
        f.write("]")
    return path

"""The text of a frame and of an expression (the counterpart of
``vaex_tpu/formatting.py``): the first rows of each column, missing values
as ``--``, with the same text as vaex_tpu for the same values."""

from __future__ import annotations

import numpy as np

from . import array_types

MAX_PREVIEW_ROWS = 10


def _format_value(value):
    if value is None or isinstance(value, np.ma.core.MaskedConstant):
        return "--"
    if isinstance(value, float) and np.isnan(value):
        return "nan"
    if isinstance(value, bytes):
        return value.decode("utf8", "replace")
    return str(value)


def _formatted(values, k):
    """The first ``k`` of host values as strings."""
    values = array_types.to_numpy(values)
    if isinstance(values, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(values)
        return [_format_value(None) if mask[i] else _format_value(values.data[i])
                for i in range(k)]
    return [_format_value(v) for v in values[:k]]


def format_expression_preview(expr, n=5):
    count = len(expr.df)
    k = min(n, count)
    try:
        items = _formatted(expr.evaluate(0, k), k) if k else []
    except Exception as e:  # noqa: BLE001 - a preview never raises
        items = [f"<error: {e}>"]
    suffix = ", ..." if count > k else ""
    return (f"Expression = {expr.expression}\nLength: {count:,} dtype: {expr.dtype}\n"
            f"[{', '.join(items)}{suffix}]")


def format_dataframe(df, n=MAX_PREVIEW_ROWS):
    count = len(df)
    k = min(n, count)
    names = df.get_column_names()
    columns = {}
    for name in names:
        try:
            columns[name] = _formatted(df.evaluate(name, 0, k), k) if k else []
        except Exception as e:  # noqa: BLE001 - a preview never raises
            columns[name] = [f"<error: {e}>"] * k
    widths = {name: max([len(name)] + [len(v) for v in columns[name]]) for name in names}
    lines = ["#  " + "  ".join(name.ljust(widths[name]) for name in names),
             "   " + "  ".join("-" * widths[name] for name in names)]
    for i in range(k):
        lines.append(f"{i}  " + "  ".join(columns[name][i].ljust(widths[name]) for name in names))
    if count > k:
        lines.append(f"... {count:,} rows total")
    return "\n".join(lines)

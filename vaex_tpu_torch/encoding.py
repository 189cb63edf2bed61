"""A frame's state: ``DataFrame.state_get`` / ``state_set`` (the
counterpart of ``vaex_tpu/encoding.py``).

The state is what a frame holds beside its columns: the column names, the
virtual columns, the variables (arrays and sets included), the functions
of its UDFs, the named selections and the filter, the categories (a
staged string column's labels and codes column among them) and the active
range.  It is vaex_tpu's format: the filter is the selection named
``__filter__``, arrays are ``np.save`` bytes in base64, so a state without
functions is plain JSON that either package loads.  Functions go through
cloudpickle where it is installed, else pickle, base64 again.
"""

from __future__ import annotations

import base64
import io
import logging

import numpy as np
import torch

from .ops.setops import SortedSet
from .selections import FILTER_SELECTION_NAME, Selection, SelectionExpression


def _encode_array(ar):
    if isinstance(ar, torch.Tensor):
        ar = ar.cpu().numpy()
    if isinstance(ar, np.ma.MaskedArray):
        return {"type": "masked-ndarray", "data": _encode_array(np.asarray(ar.data)),
                "mask": _encode_array(np.ma.getmaskarray(ar))}
    ar = np.asarray(ar)
    if ar.dtype == object:
        return {"type": "object-list", "values": ar.tolist()}
    buf = io.BytesIO()
    np.save(buf, ar, allow_pickle=False)
    return {"type": "ndarray", "b64": base64.b64encode(buf.getvalue()).decode()}


def _decode_array(spec):
    kind = spec["type"]
    if kind == "masked-ndarray":
        return np.ma.MaskedArray(_decode_array(spec["data"]), _decode_array(spec["mask"]))
    if kind == "object-list":
        return np.asarray(spec["values"], dtype=object)
    return np.load(io.BytesIO(base64.b64decode(spec["b64"])), allow_pickle=False)


def _encode_variable(value):
    if isinstance(value, SortedSet):
        keys = value.keys[:value.n_keys]
        return {"type": "sorted-set", "dtype": "string" if value.is_string else str(value.dtype),
                "keys": _encode_array(keys),
                "counts": None if value.counts is None else _encode_array(value.counts),
                "nan_count": value.nan_count, "null_count": value.null_count}
    if isinstance(value, (np.ndarray, torch.Tensor)) or (
            isinstance(value, np.generic) and value.dtype.kind in "Mm"):
        return {"type": "array", "value": _encode_array(value)}
    if isinstance(value, np.generic):
        return {"type": "scalar", "dtype": str(value.dtype), "value": value.item()}
    return {"type": "json", "value": value}


def _decode_variable(spec):
    kind = spec["type"]
    if kind == "sorted-set":
        string = spec["dtype"] == "string"
        oset = SortedSet("string" if string else np.dtype(spec["dtype"]),
                         keep_counts=spec["counts"] is not None)
        keys = _decode_array(spec["keys"])
        oset._set_host(keys.astype(object) if string else keys,
                       None if spec["counts"] is None else _decode_array(spec["counts"]))
        oset.nan_count, oset.null_count = spec["nan_count"], spec["null_count"]
        return oset
    if kind == "array":
        return _decode_array(spec["value"])
    if kind == "scalar":
        return np.dtype(spec["dtype"]).type(spec["value"])
    return spec["value"]


def _pickler():
    try:
        import cloudpickle
        return cloudpickle
    except ImportError:  # lambdas and closures then do not pickle
        import pickle
        return pickle


def _encode_category(meta):
    out = {"labels": np.asarray(meta["labels"]).tolist(), "N": int(meta["N"]),
           "min_value": int(meta["min_value"])}
    if meta.get("codes_column") is not None:
        out["codes_column"] = meta["codes_column"]
    return out


def _decode_category(df, spec):
    """A category as the frame keeps it: labels as an array, strings also as
    arrow; None where its codes column is not in the frame."""
    from .dataframe import _labels_array
    codes = spec.get("codes_column")
    if codes is not None and codes not in df.dataset and codes not in df.virtual_columns:
        return None
    meta = {"labels": _labels_array(spec["labels"]), "N": spec["N"],
            "min_value": spec["min_value"]}
    if codes is not None:
        meta["codes_column"] = codes
    if any(isinstance(v, str) for v in spec["labels"]):
        import pyarrow as pa
        meta["arrow"] = pa.array(spec["labels"], type=pa.string())
    return meta


def state_get(df, skip=None):
    """The frame's state as a dict of JSON values and base64 strings;
    ``skip`` changes nothing, as in vaex_tpu (vaex_tpu/encoding.py:88)."""
    pickler = _pickler()
    functions = {}
    for name, f in df.functions.items():
        try:
            functions[name] = base64.b64encode(pickler.dumps(f)).decode()
        except Exception:  # noqa: BLE001 - any pickling failure drops the function loudly
            logging.getLogger("vaex_tpu_torch.encoding").warning(
                "function %r does not pickle and is not in the state; expressions that "
                "call it fail after state_set", name)
    selections = {name: sel.encode() for name, sel in df.selections.items() if sel is not None}
    if df.filtered:
        selections[FILTER_SELECTION_NAME] = SelectionExpression(df.filter_expression).encode()
    start, stop = df._active_bounds()
    return {
        "version": 1,
        "column_names": list(df.column_names),
        "virtual_columns": dict(df.virtual_columns),
        "variables": {name: _encode_variable(v) for name, v in df.variables.items()},
        "functions": functions,
        "selections": selections,
        "categories": {name: _encode_category(meta) for name, meta in df._categories.items()
                       if "column" not in meta},  # one derived from a column derives again
        "active_range": [int(start), int(stop)],
    }


def state_set(df, state, set_filter=True, trusted=True):
    """Put ``state`` onto ``df`` in place: its virtual columns, variables,
    functions (only where ``trusted``: unpickling runs code), selections,
    filter (with ``set_filter``), categories and active range."""
    start, stop = state.get("active_range") or (0, None)
    full = df._active_range[2] if df._active_range else df.dataset
    if stop is not None and (start, stop) != (0, full.row_count):
        df.set_active_range(start, stop)
    df.virtual_columns = dict(state.get("virtual_columns", {}))
    df.variables = {name: _decode_variable(spec)
                    for name, spec in state.get("variables", {}).items()}
    if trusted:
        pickler = _pickler()
        for name, blob in state.get("functions", {}).items():
            df.add_function(name, pickler.loads(base64.b64decode(blob)))
    for name in state.get("column_names", []):
        if name not in df.column_names:
            df.column_names.append(name)
    selections = {name: Selection.decode(spec)
                  for name, spec in state.get("selections", {}).items() if spec is not None}
    condition = selections.pop(FILTER_SELECTION_NAME, None)
    df.selections = selections
    if set_filter:
        df._filter = None if condition is None else condition.to_expression(df)
        df._filtered_length = None
    for name, spec in state.get("categories", {}).items():
        meta = _decode_category(df, spec)
        if meta is not None:
            df._categories[name] = meta
    df._dtypes = {}
    return df

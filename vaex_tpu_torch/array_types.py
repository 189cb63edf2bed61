"""Array conversions: numpy <-> numpy.ma <-> torch tensors (CPU or CUDA)
<-> pyarrow.

The in-engine host representation is "numpy data + optional boolean null
mask" (mask True == missing, numpy.ma convention), which maps onto the
tile representation :class:`vaex_tpu_torch.ops.nullable.NA`.  Strings are
arrow arrays (plain or dictionary-encoded, with nulls) on the host
(vaex_tpu/array_types.py:38-120); pyarrow is imported by the functions
that meet them.
"""

from __future__ import annotations

import numpy as np
import torch

from .datatype import torch_dtype

# the numpy kinds of string arrays (vaex_tpu/array_types.py:25)
string_kinds = "US"


def __getattr__(name):
    """``supported_array_types``: the host and device array types a column
    may be (vaex_tpu/array_types.py:23), arrow's among them, imported when
    first asked for."""
    if name == "supported_array_types":
        import pyarrow as pa
        return (np.ndarray, torch.Tensor, pa.Array, pa.ChunkedArray)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_arrow(x) -> bool:
    return type(x).__module__.startswith("pyarrow") and hasattr(x, "type")


def is_string_array(x) -> bool:
    """An arrow array of strings (plain or dictionary-encoded), or a numpy
    array of str / StringDType, or of objects that are all str where they
    are not missing (None, NaN as pandas writes it, or masked), at least one
    of them."""
    if is_arrow(x):
        import pyarrow as pa
        t = x.type.value_type if pa.types.is_dictionary(x.type) else x.type
        return pa.types.is_string(t) or pa.types.is_large_string(t)
    if not isinstance(x, np.ndarray):
        return False
    if x.dtype.kind in "UT":
        return True
    if x.dtype != object or len(x) == 0:
        return False
    data = x.compressed() if isinstance(x, np.ma.MaskedArray) else x
    kinds = {type(v) for v in data.tolist() if v is not None and v == v}
    return kinds == {str}


def string_arrow(x):
    """A string array as an arrow array: an arrow array as it is (chunks
    combined), a numpy one converted, None and masked rows null."""
    import pyarrow as pa
    if is_arrow(x):
        return x.combine_chunks() if isinstance(x, pa.ChunkedArray) else x
    mask = np.ma.getmaskarray(x) if isinstance(x, np.ma.MaskedArray) else None
    data = np.ma.getdata(x)
    if data.dtype.kind == "T":
        data = data.astype(object)
    return pa.array(data, type=pa.string(), from_pandas=True,
                    mask=mask if mask is not None and mask.any() else None)


def to_numpy(x, strict=False):
    """Host numpy view or copy of x (a masked array if it carries nulls);
    an arrow string array as an object array of str, masked where null.
    ``strict`` changes nothing, as in vaex_tpu."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):  # includes np.ma.MaskedArray
        return x
    if is_arrow(x):
        import pyarrow as pa
        if isinstance(x, pa.ChunkedArray):
            x = x.combine_chunks()
        if pa.types.is_dictionary(x.type):
            x = x.dictionary_decode()
        if is_string_array(x) or not x.null_count:
            values = x.to_numpy(zero_copy_only=False)
            values = values.astype(object) if values.dtype.kind in "UT" else values
        else:  # the nulls filled, so that an int or bool column keeps its dtype
            fill = False if pa.types.is_boolean(x.type) else 0
            values = x.fill_null(pa.scalar(fill, x.type)).to_numpy(zero_copy_only=False)
        if x.null_count:
            return np.ma.MaskedArray(values, np.asarray(x.is_null()))
        return values
    return np.asarray(x)


def to_arrow(x):
    """An arrow array of host values (a numpy or masked array; an arrow
    array as it is)."""
    import pyarrow as pa
    if is_arrow(x):
        return x
    if is_string_array(x):
        return string_arrow(x)
    if isinstance(x, np.ma.MaskedArray):
        return pa.array(x.data, mask=np.ma.getmaskarray(x))
    return pa.array(to_numpy(x))


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor over a host array without a copy, read-only ones (an
    arrow buffer's) too: the engine never writes into it."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(x))


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``; a datetime64,
    timedelta64 or uint64 array as its int64 view, a uint16 or uint32 array
    widened to int64; raises for dtypes torch has no tensor type for."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype.kind in "Mm" or x.dtype == np.uint64:
        x = x.view(np.int64)
    dtype = torch_dtype(x.dtype)
    if x.dtype.kind == "u" and x.dtype.itemsize > 1:
        x = x.astype(np.int64)
    return host_tensor(x).to(device=device, dtype=dtype)


def data_and_mask(x):
    """Split a host array into (plain ndarray data, bool null mask or None)."""
    x = to_numpy(x)
    if isinstance(x, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(x)
        return np.asarray(x.data), (mask if mask.any() else None)
    return x, None


def concat(arrays):
    """Host arrays one after another: arrow string arrays (plain and
    dictionary alike, as one plain array when their types differ) or
    numpy (masked) arrays."""
    arrays = list(arrays)
    if any(is_arrow(a) for a in arrays):
        import pyarrow as pa
        parts = [string_arrow(a) for a in arrays]
        if len({p.type for p in parts}) > 1:
            parts = [(p.dictionary_decode() if pa.types.is_dictionary(p.type) else p)
                     .cast(pa.large_string()) for p in parts]
        return pa.concat_arrays(parts)
    if any(isinstance(a, np.ma.MaskedArray) for a in arrays):
        return np.ma.concatenate(arrays)
    return np.concatenate(arrays)


def slice_array(x, i1, i2):
    """Rows [i1, i2) of an arrow array, a numpy array or a tensor (a view
    where the type has one)."""
    if is_arrow(x):
        return x.slice(i1, i2 - i1)
    return x[i1:i2]


def take(x, indices):
    """The rows of an arrow array, a numpy array or a tensor at
    ``indices`` (host ints, or an int tensor for a tensor)."""
    if is_arrow(x):
        import pyarrow as pa
        return x.take(pa.array(to_numpy(indices)))
    if isinstance(x, torch.Tensor):
        return x.index_select(0, torch.as_tensor(indices, dtype=torch.int64, device=x.device))
    return x[to_numpy(indices)]


def length(x) -> int:
    return len(x)


def full(n, value, dtype):
    """``n`` rows of ``value`` as a host array of ``dtype``."""
    return np.full(n, value, dtype=dtype)


def required_dtype_for_max(n: int, signed=True) -> np.dtype:
    """The smallest integer dtype that holds values up to ``n``
    (vaex_tpu/array_types.py:149-158)."""
    kinds = ("int8", "int16", "int32", "int64") if signed else (
        "uint8", "uint16", "uint32", "uint64")
    for name in kinds:
        if n <= np.iinfo(name).max:
            return np.dtype(name)
    raise ValueError(f"no integer dtype holds {n}")

"""DataType: one logical type for numpy arrays and torch tensors.

The counterpart of ``vaex_tpu/datatype.py`` (its lines 55-75, 125-160 for
arrow): a DataType wraps a numpy dtype or a pyarrow type.  A string column
is an arrow string, large string or dictionary-of-strings type
(``is_string``, ``is_encoded``, ``is_arrow``); its numpy dtype is object and
torch has no tensor of it (:func:`has_torch_dtype` answers False).  pyarrow
is imported where an arrow type is met, never at import.  A ``datetime64`` or ``timedelta64``
column is an int64 tensor on a device (its epoch count; NaT is the int64
minimum) and keeps its numpy dtype as the logical one.  A ``uint16`` or
``uint32`` column is an int64 tensor of its values, which int64 holds
exactly; a ``uint64`` column an int64 tensor of the same bits.  Each keeps
its dtype as the logical one (``Dataset.logical``), and results come back
in it (:func:`vaex_tpu_torch.agg.view_logical`).  Where the order of uint64
values matters (min / max, sets and their probes) they travel as the
order-preserving image ``bits ^ (1 << 63)`` (:func:`order_image`), and
their float value is :func:`.ops.nullable.unsigned_float`.  ``upcast`` follows the dtype
contract of the aggregators: int/bool -> int64, uint -> uint64,
float -> float64.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_TO_NUMPY = {
    torch.bool: np.dtype("bool"),
    torch.uint8: np.dtype("uint8"),
    torch.int8: np.dtype("int8"),
    torch.int16: np.dtype("int16"),
    torch.int32: np.dtype("int32"),
    torch.int64: np.dtype("int64"),
    torch.float16: np.dtype("float16"),
    torch.float32: np.dtype("float32"),
    torch.float64: np.dtype("float64"),
}
_NUMPY_TO_TORCH = {v: k for k, v in _TORCH_TO_NUMPY.items()}
# unsigned columns as the signed tensor type that holds them: their values
# (uint16, uint32) or their bits (uint64)
_WIDENED = {np.dtype("uint16"): torch.int64, np.dtype("uint32"): torch.int64,
            np.dtype("uint64"): torch.int64}
NAT = np.iinfo(np.int64).min  # NaT in the int64 view of a datetime or timedelta
UINT64 = np.dtype("uint64")
# the top bit of an int64: x ^ TOP maps uint64 bits to int64s of the same order
TOP = -(1 << 63)


def needs_logical(dtype) -> bool:
    """True for a dtype whose column is held as an int64 tensor of another
    meaning: datetime64, timedelta64, uint16, uint32, uint64."""
    dtype = np.dtype(dtype)
    return dtype.kind in "Mm" or dtype in _WIDENED


def rides_logical(dtype) -> bool:
    """True for the logical dtypes an NA carries through a pass (temporal
    and uint64: their int64 data is not their value); a uint16 or uint32
    tile is its values and carries none."""
    return dtype is not None and (np.dtype(dtype).kind in "Mm" or np.dtype(dtype) == UINT64)


def order_image(t):
    """uint64 bits (an int64 tensor, or torch's uint64) as int64s of the
    same order: ``bits ^ (1 << 63)``; its own inverse."""
    if t.dtype != torch.int64:
        t = t.view(torch.int64)
    return t ^ TOP


def host_values(values, logical):
    """A host array of a column's int64 tensor as its logical dtype: a
    temporal or uint64 column's bits viewed, a uint16 / uint32 column's
    values narrowed; any other array as it is."""
    if logical is None or values.dtype != np.int64:
        return values
    logical = np.dtype(logical)
    if logical.itemsize == 8:
        return values.view(logical)
    return values.astype(logical)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype, dtype name or DataType."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, DataType):
        dtype = dtype.numpy
    npdt = np.dtype(dtype)
    if npdt.kind in "Mm":
        return torch.int64
    if npdt in _WIDENED:
        return _WIDENED[npdt]
    if npdt not in _NUMPY_TO_TORCH:
        raise TypeError(f"no torch dtype for {npdt}")
    return _NUMPY_TO_TORCH[npdt]


def has_torch_dtype(dtype) -> bool:
    """True for a column that moves to a device: a dtype torch has, or one
    held as an int64 tensor (:func:`needs_logical`); False for strings and
    any other arrow or object type."""
    if isinstance(dtype, DataType):
        if dtype.is_arrow:
            return False
        dtype = dtype.internal
    if _is_arrow_type(dtype):
        return False
    dtype = np.dtype(dtype)
    return dtype in _NUMPY_TO_TORCH or needs_logical(dtype)


def _is_arrow_type(t):
    return type(t).__module__.startswith("pyarrow")


def _arrow_is_string(t):
    import pyarrow as pa
    return pa.types.is_string(t) or pa.types.is_large_string(t)


def _arrow_is_binary(t):
    import pyarrow as pa
    return pa.types.is_binary(t) or pa.types.is_large_binary(t)


class DataType:
    def __init__(self, internal):
        if isinstance(internal, DataType):
            internal = internal.internal
        if isinstance(internal, torch.dtype):
            internal = _TORCH_TO_NUMPY[internal]
        self.internal = internal if _is_arrow_type(internal) else np.dtype(internal)

    # -- arrow (vaex_tpu/datatype.py:55-75) ----------------------------------
    @property
    def is_arrow(self):
        return _is_arrow_type(self.internal)

    @property
    def is_numpy(self):
        return isinstance(self.internal, np.dtype)

    @property
    def is_string(self):
        """An arrow string, large string, binary or large binary type, or
        numpy's str / bytes; a dictionary of strings is ``is_encoded``
        instead, as in vaex_tpu (vaex_tpu/datatype.py:58-66)."""
        if self.is_arrow:
            return _arrow_is_string(self.internal) or _arrow_is_binary(self.internal)
        return self.internal.kind in "US" or self.internal.kind == "T"

    @property
    def is_encoded(self):
        """An arrow dictionary type."""
        import pyarrow as pa
        return self.is_arrow and pa.types.is_dictionary(self.internal)

    @property
    def is_text(self):
        """Values that are strings: ``is_string`` or a dictionary of them."""
        if self.is_encoded:
            return _arrow_is_string(self.internal.value_type)
        return self.is_string and not (self.is_arrow and _arrow_is_binary(self.internal))

    @property
    def numpy(self) -> np.dtype:
        """The numpy dtype; object for strings and any other arrow type
        numpy has none of."""
        if self.is_arrow:
            try:
                return np.dtype(self.internal.to_pandas_dtype())
            except (NotImplementedError, TypeError):
                return np.dtype(object)
        return self.internal

    @property
    def torch(self) -> torch.dtype:
        return torch_dtype(self.numpy)

    @property
    def is_temporal(self):
        """datetime64 or timedelta64: int64 on a device."""
        return not self.is_arrow and self.internal.kind in "Mm"

    # -- vaex_tpu's predicates (vaex_tpu/datatype.py:68-112) -----------------
    @property
    def is_primitive(self):
        """A bool, int, uint or float type, numpy's or arrow's."""
        if self.is_arrow:
            import pyarrow as pa
            t = self.internal
            return (pa.types.is_boolean(t) or pa.types.is_integer(t)
                    or pa.types.is_floating(t))
        return self.internal.kind in "biuf"

    @property
    def is_datetime(self):
        """numpy's datetime64, arrow's timestamp and date types."""
        if self.is_arrow:
            import pyarrow as pa
            return pa.types.is_timestamp(self.internal) or pa.types.is_date(self.internal)
        return self.internal.kind == "M"

    @property
    def is_timedelta(self):
        """numpy's timedelta64, arrow's duration type."""
        if self.is_arrow:
            import pyarrow as pa
            return pa.types.is_duration(self.internal)
        return self.internal.kind == "m"

    @property
    def is_float(self):
        return self._kind == "f"

    @property
    def is_integer(self):
        return self._kind in "iu"

    @property
    def is_signed(self):
        return self._kind == "i"

    @property
    def is_unsigned(self):
        return self._kind == "u"

    @property
    def is_bool(self):
        return self._kind == "b"

    @property
    def _kind(self):
        """The numpy kind of the values: of a dictionary its values'; "O"
        for a list, a struct or any other arrow type numpy has none of (where
        vaex_tpu raises: ROADMAP, known problems of the reference)."""
        if self.is_encoded:
            return DataType(self.internal.value_type)._kind
        return self.numpy.kind

    @property
    def is_list(self):
        """An arrow list or large list type."""
        if not self.is_arrow:
            return False
        import pyarrow as pa
        return pa.types.is_list(self.internal) or pa.types.is_large_list(self.internal)

    @property
    def is_struct(self):
        """An arrow struct type."""
        if not self.is_arrow:
            return False
        import pyarrow as pa
        return pa.types.is_struct(self.internal)

    # -- vaex_tpu's conversions (vaex_tpu/datatype.py:114-160) ----------------
    @property
    def arrow(self):
        """The arrow type: itself, or numpy's converted."""
        if self.is_arrow:
            return self.internal
        import pyarrow as pa
        return pa.from_numpy_dtype(self.internal)

    @property
    def device(self) -> np.dtype:
        """The dtype of the column's tensor on a device as vaex_tpu names
        it: int32 for strings and dictionaries (their codes), int64 for
        datetimes and timedeltas, else the numpy dtype."""
        if self.is_string or self.is_encoded:
            return np.dtype("int32")
        if self.is_datetime or self.is_timedelta:
            return np.dtype("int64")
        return self.numpy

    @property
    def index_type(self):
        return self

    def upcast(self) -> "DataType":
        """Sum-accumulator dtype: ints/bool -> int64, uints -> uint64,
        floats -> float64 (reference vaex_tpu/datatype.py upcast)."""
        kind = self.numpy.kind
        if kind in "ib":
            return DataType(np.dtype("int64"))
        if kind == "u":
            return DataType(np.dtype("uint64"))
        if kind == "f":
            return DataType(np.dtype("float64"))
        return self

    @property
    def name(self):
        return str(self.internal) if self.is_arrow else self.internal.name

    def __eq__(self, other):
        if other is None:
            return False
        try:
            other = DataType(other)
        except TypeError:
            return self.name == other
        if self.is_arrow != other.is_arrow:
            return False
        return self.internal == other.internal

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DataType<{self.name}>"


def dtype_of(array) -> DataType:
    """DataType of a numpy array, masked array, torch tensor, arrow array
    or column."""
    if isinstance(array, torch.Tensor):
        return DataType(array.dtype)
    if _is_arrow_type(getattr(array, "type", None)):
        return DataType(array.type)
    return DataType(array.dtype if hasattr(array, "dtype") else np.asarray(array).dtype)

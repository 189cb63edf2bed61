"""DataType: one logical type for numpy arrays and torch tensors.

The counterpart of ``vaex_tpu/datatype.py`` for the numeric slice of the
port; arrow types are not ported yet.  A ``datetime64`` or ``timedelta64``
column is an int64 tensor on a device (its epoch count; NaT is the int64
minimum) and keeps its numpy dtype as the logical one.  ``upcast`` follows the dtype
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


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype, dtype name or DataType."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, DataType):
        dtype = dtype.numpy
    npdt = np.dtype(dtype)
    if npdt.kind in "Mm":
        return torch.int64
    if npdt not in _NUMPY_TO_TORCH:
        raise TypeError(f"no torch dtype for {npdt}")
    return _NUMPY_TO_TORCH[npdt]


def has_torch_dtype(dtype) -> bool:
    return np.dtype(dtype) in _NUMPY_TO_TORCH or np.dtype(dtype).kind in "Mm"


class DataType:
    def __init__(self, internal):
        if isinstance(internal, DataType):
            internal = internal.internal
        if isinstance(internal, torch.dtype):
            internal = _TORCH_TO_NUMPY[internal]
        self.internal = np.dtype(internal)

    @property
    def numpy(self) -> np.dtype:
        return self.internal

    @property
    def torch(self) -> torch.dtype:
        return torch_dtype(self.internal)

    @property
    def is_temporal(self):
        """datetime64 or timedelta64: int64 on a device."""
        return self.internal.kind in "Mm"

    @property
    def is_unsigned(self):
        return self.internal.kind == "u"

    def upcast(self) -> "DataType":
        """Sum-accumulator dtype: ints/bool -> int64, uints -> uint64,
        floats -> float64 (reference vaex_tpu/datatype.py upcast)."""
        kind = self.internal.kind
        if kind in "ib":
            return DataType(np.dtype("int64"))
        if kind == "u":
            return DataType(np.dtype("uint64"))
        if kind == "f":
            return DataType(np.dtype("float64"))
        return self

    @property
    def name(self):
        return self.internal.name

    def __eq__(self, other):
        if other is None:
            return False
        try:
            return self.internal == DataType(other).internal
        except TypeError:
            return False

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DataType<{self.name}>"


def dtype_of(array) -> DataType:
    """DataType of a numpy array, masked array or torch tensor."""
    if isinstance(array, torch.Tensor):
        return DataType(array.dtype)
    return DataType(array.dtype if hasattr(array, "dtype") else np.asarray(array).dtype)

"""Array conversions: numpy <-> numpy.ma <-> torch tensors (CPU or CUDA).

The in-engine host representation is "numpy data + optional boolean null
mask" (mask True == missing, numpy.ma convention), which maps onto the
tile representation :class:`vaex_tpu_torch.ops.nullable.NA`.
"""

from __future__ import annotations

import numpy as np
import torch

from .datatype import torch_dtype


def to_numpy(x):
    """Host numpy view or copy of x (a masked array if it carries nulls)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):  # includes np.ma.MaskedArray
        return x
    return np.asarray(x)


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
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)


def data_and_mask(x):
    """Split a host array into (plain ndarray data, bool null mask or None)."""
    x = to_numpy(x)
    if isinstance(x, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(x)
        return np.asarray(x.data), (mask if mask.any() else None)
    return x, None

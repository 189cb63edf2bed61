"""Bin indices with the reference's +3-edge layout.

Every grid dimension has ``bins + 3`` cells: index 0 = NaN/missing, 1 =
underflow, ``[2, bins + 2)`` = data, ``bins + 2`` = overflow
(vaex_tpu/ops/binners.py).  Here ``to_bins`` runs eagerly on one tile's
tensors.  :class:`BinnerScalar` bins a continuous axis over ``[vmin, vmax)``,
:class:`BinnerOrdinal` an integer or categorical one; a grid may mix them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import fingerprint
from .nullable import NA, UINT64, unsigned_float


class BinnerScalar:
    """Range binner: ``index = floor((v - vmin) * ((1 / (vmax - vmin)) * bins)) + 2``;
    ``v < vmin`` underflows (1), ``v >= vmax`` overflows (``bins + 2``), NaN
    and missing values land in 0.  A float32 column is binned in float32,
    every other dtype in float64 (vaex_tpu/ops/binners.py:23-65)."""

    def __init__(self, expression, vmin, vmax, bins):
        self.expression = str(expression)
        self.vmin = vmin
        self.vmax = vmax
        self.bins = int(bins)

    @property
    def shape(self):
        return self.bins + 3

    def to_bins(self, x: NA):
        data = x.data
        if x.logical == UINT64:  # uint64 bits: their float value
            data = unsigned_float(data)
        fdata = data if data.dtype == torch.float32 else data.to(torch.float64)
        # the limits and their span in the binning dtype, on the host
        scalar = np.float32 if fdata.dtype == torch.float32 else np.float64
        vmin, vmax = float(scalar(self.vmin)), float(scalar(self.vmax))
        span = scalar(vmax) - scalar(vmin)
        if span != 0:
            # (1 / span) * bins once, in the binning dtype: the reference runs
            # its (x - vmin) / span * bins inside a jitted pass with the
            # limits as constants, where XLA turns the division into a
            # product with the reciprocal and folds the two constants; the
            # division puts 29 of limits [0, 50] at 50 bins in bin 28
            with np.errstate(over="ignore", divide="ignore"):
                scale = float(scalar(1) / span * scalar(self.bins))
            scaled = (fdata - vmin).mul_(scale)
        else:  # everything lands on the underflow / overflow edges
            scaled = torch.zeros_like(fdata)
        # NaN and values far outside are set below; they must not wrap in the cast
        idx = scaled.floor_().nan_to_num_(0).clamp_(-1, self.bins)
        idx = idx.to(torch.int32).add_(2)
        # in place: idx is this call's own tensor
        idx.masked_fill_(fdata < vmin, 1).masked_fill_(fdata >= vmax, self.bins + 2)
        if data.is_floating_point():
            idx.masked_fill_(torch.isnan(data), 0)
        if x.mask is not None:
            idx.masked_fill_(x.mask, 0)
        return idx

    def __repr__(self):
        return f"BinnerScalar({self.expression!r}, {self.vmin}, {self.vmax}, {self.bins})"

    def fingerprint(self):
        return fingerprint("binner-scalar", self.expression, float(self.vmin),
                           float(self.vmax), self.bins)

    def __eq__(self, other):
        return (isinstance(other, BinnerScalar) and self.expression == other.expression
                and self.vmin == other.vmin and self.vmax == other.vmax
                and self.bins == other.bins)

    def __hash__(self):
        return hash(self.fingerprint())


class BinnerOrdinal:
    """Integer/categorical binner: ``index = value - min_value + 2``."""

    def __init__(self, expression, min_value, count):
        self.expression = str(expression)
        self.min_value = int(min_value)
        self.count = int(count)

    @property
    def bins(self):
        return self.count

    @property
    def shape(self):
        return self.count + 3

    def to_bins(self, x: NA):
        """int32 bin indices of one tile.  Integer keys are compared in
        int64, so keys beyond the int32 range land in the edge bins."""
        data = x.data
        if data.is_floating_point():
            # truncation, like the reference's integer cast of the key
            rel = torch.trunc(data.to(torch.float64)) - self.min_value
            # clamp before the int cast: NaN and huge values must not wrap
            idx = (rel.clamp(-1, self.count) + 2).nan_to_num(0).to(torch.int32)
        else:
            rel = data.to(torch.int64)
            if x.logical == UINT64:  # values past 2^63 overflow
                rel = torch.where(rel < 0, self.count + self.min_value, rel)
            if self.min_value:
                rel = rel - self.min_value
            # [1, count + 2]: underflow -> 1, data -> rel + 2, overflow -> count + 2;
            # the +2 runs after the narrowing cast, on 4-byte words
            idx = rel.clamp(-1, self.count).to(torch.int32).add_(2)
        if x.mask is not None:
            idx = idx.masked_fill(x.mask, 0)
        return idx

    def __repr__(self):
        return f"BinnerOrdinal({self.expression!r}, {self.min_value}, {self.count})"

    def __eq__(self, other):
        return (isinstance(other, BinnerOrdinal) and self.expression == other.expression
                and self.min_value == other.min_value and self.count == other.count)

    def fingerprint(self):
        return fingerprint("binner-ordinal", self.expression, self.min_value, self.count)

    def __hash__(self):
        return hash((self.expression, self.min_value, self.count))


def fuse_bins(binners, bin_indices):
    """Per-dimension bin indices -> flat row-major grid indices (int32)."""
    flat = bin_indices[0]
    for binner, idx in zip(binners[1:], bin_indices[1:]):
        flat = flat * binner.shape + idx
    return flat


def grid_shape(binners):
    return tuple(b.shape for b in binners) if binners else (1,)


def grid_size(binners):
    return int(np.prod(grid_shape(binners)))

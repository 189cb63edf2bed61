"""A plain groupby engine in PyTorch, the reference's common part.

Every answer is computed from the generated input tensors alone, in the
float type ``dtype`` (float64 for the reference, float32 for its control);
integer answers stay exact in int64.  An answer is a dict of output columns
in the order the question names them, each ``(kind, value, scale)``:

- ``exact``: keys, counts, integer sums, extremes, medians and top-k values,
  compared exactly (NaN equal to NaN);
- ``sum_err``: a float sum or mean, compared as |got - want| / scale, where
  scale is the cell's sum of |term| (of a mean: that sum over the count),
  since a sum rounded in any order lies within a few ulps of it;
- ``sd_err``: a standard deviation, compared relatively (its scale is
  |want|);
- ``r_err``: a correlation coefficient, compared absolutely (no scale).

Groups come out in the lexicographic order of their keys.  The scales are
always float64: they belong to the judge, not to the answer.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
DENSE_CELLS = 1 << 27  # past this many cells of the keys' ranges, torch.unique


def cells(keys):
    """(each row's cell, the observed cells, their row counts, the key
    values of the observed cells): dense over the keys' ranges (the first
    key most significant) when they span at most DENSE_CELLS cells, else
    the rows' distinct key tuples."""
    los = [int(k.min()) for k in keys]
    spans = [int(k.max()) - lo + 1 for k, lo in zip(keys, los)]
    if math.prod(spans) <= DENSE_CELLS:
        cell = None
        for k, lo, span in zip(keys, los, spans):
            cell = k - lo if cell is None else cell * span + (k - lo)
        counts = torch.bincount(cell, minlength=math.prod(spans))
        observed = torch.nonzero(counts).squeeze(1)
        values, rem = [], observed
        for lo, span in zip(los[::-1], spans[::-1]):
            values.append(rem % span + lo)
            rem = rem // span
        return cell, observed, counts[observed], values[::-1]
    unique, cell = torch.unique(torch.stack(keys, dim=1), dim=0, return_inverse=True)
    counts = torch.bincount(cell)
    observed = torch.arange(unique.shape[0], device=cell.device)
    return cell, observed, counts, [unique[:, i].contiguous() for i in range(len(keys))]


def per_cell(cell, observed, v):
    size = int(observed[-1]) + 1 if observed.numel() else 0
    return torch.zeros(size, dtype=v.dtype, device=v.device).index_add_(0, cell, v)[observed]


def sorted_in_cells(cell, v, descending=False):
    """The values sorted by (cell, value): two stable sorts."""
    order = torch.argsort(v, descending=descending, stable=True)
    order = order[torch.argsort(cell[order], stable=True)]
    return v[order]


def aggregate(cols, spec, name, cell, observed, counts, dtype):
    """One aggregator's (kind, value, scale) over the cells."""
    if isinstance(spec, str):
        fn, args, kwargs = spec, [name], {}
    else:
        fn, *args = spec
        kwargs = args.pop() if args and isinstance(args[-1], dict) else {}
    if fn == "count":
        return "exact", counts, None
    v = cols[args[0]]
    c = counts.to(dtype)
    if fn == "sum":
        if not v.is_floating_point():
            return "exact", per_cell(cell, observed, v.to(torch.int64)), None
        return "sum_err", per_cell(cell, observed, v.to(dtype)), \
            per_cell(cell, observed, v.to(F64).abs())
    if fn == "mean":
        s = per_cell(cell, observed, v.to(dtype))
        return "sum_err", s / c, per_cell(cell, observed, v.to(F64).abs()) / counts
    if fn in ("max", "min"):
        size = int(observed[-1]) + 1
        x = v if not v.is_floating_point() else v.to(dtype)
        fill = (torch.iinfo(x.dtype) if not x.is_floating_point() else torch.finfo(x.dtype))
        grid = torch.full((size,), fill.min if fn == "max" else fill.max, dtype=x.dtype,
                          device=x.device)
        mode = "amax" if fn == "max" else "amin"
        return "exact", grid.scatter_reduce_(0, cell, x, mode)[observed], None
    starts = torch.cumsum(counts, 0) - counts
    if fn == "median_approx":  # the exact median, interpolated between the middle two
        sv = sorted_in_cells(cell, v.to(dtype))
        p = 0.5 * (c - 1)
        lo, hi = torch.floor(p), torch.ceil(p)
        a, b = sv[starts + lo.to(torch.int64)], sv[starts + hi.to(torch.int64)]
        return "exact", torch.where(a == b, a, a + (p - lo) * (b - a)), None
    if fn == "nth_largest":
        k = int(args[1])
        sv = sorted_in_cells(cell, v.to(dtype), descending=True)
        at = torch.clamp(starts + k, max=max(sv.numel() - 1, 0))
        return "exact", torch.where(counts > k, sv[at], torch.nan), None
    if fn == "std":  # two passes: the cell's mean, then the squares about it
        ddof = int(kwargs.get("ddof", 0))
        x = v.to(dtype)
        mean = per_cell(cell, observed, x) / c
        full = torch.zeros(int(observed[-1]) + 1, dtype=dtype, device=x.device)
        full[observed] = mean
        d = x - full[cell]
        var = per_cell(cell, observed, d * d) / (c - ddof)
        sd = torch.where(counts > ddof, torch.sqrt(var), torch.nan)
        return "sd_err", sd, sd.to(F64).abs()
    if fn == "corr":  # two passes: the means, then the centred products
        full = torch.zeros(int(observed[-1]) + 1, dtype=dtype, device=v.device)
        centred = []
        for col in args[:2]:
            x = cols[col].to(dtype)
            full[observed] = per_cell(cell, observed, x) / c
            centred.append(x - full[cell])
        dx, dy = centred
        sxy, sxx, syy = (per_cell(cell, observed, t) for t in (dx * dy, dx * dx, dy * dy))
        r = sxy / torch.sqrt(sxx * syy)
        return "r_err", torch.where(torch.isfinite(r), r, torch.nan), None
    raise ValueError(f"no plain version of the aggregator {fn!r}")


def groupby(cols, by, agg, dtype):
    by = [by] if isinstance(by, str) else list(by)
    cell, observed, counts, values = cells([cols[k] for k in by])
    out = {k: ("exact", v, None) for k, v in zip(by, values)}
    for name, spec in agg.items():
        out[name] = aggregate(cols, spec, name, cell, observed, counts, dtype)
    return out

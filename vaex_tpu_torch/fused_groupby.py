"""The one-sort groupby for integer keys (vaex_tpu/fused_groupby.py).

``df.groupby(by, agg=...)`` over raw keys normally takes two passes and a
set build: the dense pre-pass, then a set of the observed keys (or of the
observed combinations of several keys) and its probe.  When the
aggregations are known up front and every key is an integer column without
missing values, one sort of the rows by their keys does it all: the sorted
keys' segments are the groups, their lengths the counts, and each
aggregation is a reduction over the segments.  Only observed keys and
combinations appear, as the classic path drops its empty cells.

The plan engages (:func:`try_fused_sort_groupby`) for physical integer
keys that are not categories and hold no missing value, and for string
keys staged as dictionary codes (their codes tensor is the key; the result
holds a :class:`~.column.ColumnDictionary` over them), on an unfiltered
frame of at most ``DENSE_RANK_MAX_ROWS`` rows with no ``row_limit``, for
count, sum, mean, min, max, std, var and one median or percentile
expression without a selection, and only where the classic path would build
a set, as the dense pre-pass (or its sample) tells: one key whose span is
past ``DENSE_RANGE_MAX``, or several whose span product is past
``COMBINE_MIN_PRODUCT``.  The words are packed over the ranges of the keys
the sort loads, not over what the pre-pass remembered.

Two modes (:func:`_run`):

* packed: one int64 word ``sum((key_i - lo_i) * mult_i)`` while the span
  product stays below 2^62, decoded back by div and mod;
* unpacked: past that (H2O q10 at 1e8 rows: 1e20), the keys packed greedily
  into the fewest words whose span products stay below 2^62, one stable
  sort per word, the least significant first (q10: two words, not six
  sorts).

A word whose span product fits int32 sorts as int32.  A median or
percentile adds its value column as the least significant sort key, so each
segment's values come out sorted and the order statistics are gathers.
Float sums reduce per segment with ``index_add_`` (each segment's error
bounded by its own terms, not by a running prefix), int sums with int64
``index_add_`` (exact mod 2^64).  The sorts, gathers and reductions are
torch calls: the reference's are XLA sorts and segment sums, not Pallas
kernels.  The result is sorted by the keys (reversed for a descending
single key).  The pass records ``{"groupby": "one-sort", "mode": ...}`` in
``trace_log``.

The result's columns are kept in the result cache (:mod:`.cache`, the
byte-bounded LRU of results that hold tensors) under the frame's exact key
and the plan, as vaex_tpu/fused_groupby.py:175-198 keeps them: the same
query over the same tensors, unwritten, sorts nothing again.

Not ported: the mesh half (ROADMAP A12).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import cache
from .agg import interp_order_stats
from .column import ColumnDictionary, tile_of
from .datatype import DataType
from .execution import _pass_device
from .expression import Expression
from .utils import trace

# the most rows the one sort takes (vaex_tpu/tasks.py:146)
DENSE_RANK_MAX_ROWS = 1 << 27
# a word of packed keys stays below this span product
WORD_MAX_SPAN = 1 << 62
_KINDS = ("count", "sum", "mean", "min", "max", "std", "var", "median", "percentile")


def _agg_plan(df, parsed):
    """[(output name, kind, payload)] of the aggregations, or None when one
    cannot ride the sort (vaex_tpu/fused_groupby.py:46-93)."""
    plan = []
    for name, desc in parsed:
        if desc.selection is not None:
            return None
        e, kind = desc.expression, desc.name
        if kind == "count" and e in (None, "*"):
            plan.append((name, "count_star", None))
            continue
        if kind not in _KINDS or not df._is_physical(e):
            return None
        dt = DataType(df.data_type(e))
        if dt.numpy.kind not in "if" and not (dt.numpy.kind == "b" and kind not in ("min", "max")):
            return None
        if kind in ("median", "percentile"):
            if desc.exact is False or isinstance(desc.percentage, (list, tuple, np.ndarray)):
                return None  # the count grid or several percentages: classic path
            plan.append((name, "pct", (e, float(desc.percentage))))
        elif kind in ("std", "var"):
            plan.append((name, kind, (e, int(desc.ddof or 0))))
        else:
            plan.append((name, kind, (e,)))
    if len({p[0] for _, kind, p in plan if kind == "pct"}) > 1:
        return None  # one value column rides the sort as its last key
    return plan


def try_fused_sort_groupby(df, by, actions, ascending=True, row_limit=None):
    """The result frame of the one-sort plan, or None where the query does
    not qualify (vaex_tpu/fused_groupby.py:96-200)."""
    from .groupby import COMBINE_MIN_PRODUCT, DENSE_RANGE_MAX, _dense_candidates, parse_actions
    if row_limit is not None or df.filtered:
        return None
    key_names, labels = [], {}
    for b in by if isinstance(by, (list, tuple)) else [by]:
        name = b.expression if isinstance(b, Expression) else b
        if not isinstance(name, str) or not df._is_physical(name):
            return None
        codes = _staged_codes(df, name)
        if codes is not None:  # a staged string key: its codes
            labels[codes] = (name, df.dataset[name].labels)
            name = codes
        elif df.is_category(name):
            return None
        dtype = df.data_type(name).numpy
        if dtype.kind not in "iu" or dtype == np.uint64:
            return None
        key_names.append(name)
    if not key_names:
        return None
    ascending = (list(ascending) if isinstance(ascending, (list, tuple))
                 else [ascending] * len(key_names))
    if len(key_names) > 1 and not all(a is True for a in ascending):
        return None  # a descending key among several: classic path
    n = len(df)
    if n == 0 or n > DENSE_RANK_MAX_ROWS:
        return None
    plan = _agg_plan(df, parse_actions(df, key_names, actions))
    if plan is None:
        return None
    with trace("one-sort candidates pre-pass"):
        info = _dense_candidates(key_names, df, row_limit)
    if any(info[name][2] != n for name in key_names if name in info):
        return None  # a key with missing values
    # the pre-pass leaves out a key whose sample already spans past
    # DENSE_RANGE_MAX; engage only where the classic path builds a set
    spans = [info[name][1] - info[name][0] + 1 if name in info else None for name in key_names]
    if None not in spans:
        if len(spans) == 1 and spans[0] <= DENSE_RANGE_MAX:
            return None
        if len(spans) > 1 and np.prod(spans, dtype=np.float64) <= COMBINE_MIN_PRODUCT:
            return None
    names = sorted(set(key_names) | {p[0] for _, kind, p in plan if p is not None})
    frame, content = df._cache_key(names)
    cache_key = cache.key("one-sort groupby", frame, key_names, ascending[0], plan,
                          content=content)
    columns = cache.lookup(cache_key)
    if columns is not None:  # the result columns, on the device the sort ran on
        from . import from_dict
        result = from_dict(dict(columns))
        result.dataset.device = next(iter(columns.values())).device
    else:
        with trace("one-sort groupby"):
            result = _run(df, key_names, plan, ascending[0], info)
        if result is None:
            return None
        cache.store(cache_key, {n: result.dataset[n] for n in result.get_column_names(hidden=True)})
    if not labels:
        return result
    # the codes of each string key back under its name, as its labels' codes
    columns = {labels[n][0] if n in labels else n: (
        ColumnDictionary(result.dataset[n].to(torch.int32), labels[n][1]) if n in labels
        else result.dataset[n]) for n in result.get_column_names(hidden=True)}
    from . import from_dict
    out = from_dict(columns)
    out.dataset.device = result.dataset.device
    return out


def _staged_codes(df, name):
    """The codes tensor of a string column staged as a dictionary, or None."""
    meta = df._categories.get(name)
    codes = meta.get("codes_column") if meta else None
    if codes is None or not isinstance(df.dataset[name], ColumnDictionary) or (
            codes not in df.dataset):
        return None
    return codes


def _words(spans):
    """The keys packed greedily, in order, into words: [(first key, last key
    + 1)], each word's span product below WORD_MAX_SPAN."""
    words, start, product = [], 0, 1
    for i, (_, span) in enumerate(spans):
        if product * span >= WORD_MAX_SPAN:
            words.append((start, i))
            start, product = i, 1
        product *= span
    words.append((start, len(spans)))
    return words


def _pack(keys, spans, first, last):
    """One word: ``sum((key_i - lo_i) * mult_i)``, the first key leading;
    int32 where the span product fits it."""
    word, mult = None, 1
    for key, (lo, span) in zip(keys[first:last][::-1], spans[first:last][::-1]):
        part = (key - lo) * mult if mult != 1 else key - lo
        word = part if word is None else word + part
        mult *= span
    return word.to(torch.int32) if mult <= 2 ** 31 else word


def _unpack(word, spans, first, last):
    """The keys of a packed word, back in their values."""
    out, mult = [], 1
    for lo, span in spans[first:last][::-1]:
        out.append((word // mult) % span + lo if mult != 1 else word % span + lo)
        mult *= span
    return out[::-1]


def _column(dataset, name, device):
    """A physical column as a tensor on ``device``, None where it has
    missing values."""
    col = tile_of(dataset[name], 0, dataset.row_count, device)
    return None if col.mask is not None and bool(col.mask.any()) else col.data


def _run(df, key_names, plan, ascending, remembered):
    """One sort of the rows by their keys, then per-segment reductions
    (vaex_tpu/fused_groupby.py:229-452, single device); None where a key
    has missing values or spans too far for a word (the classic set path
    takes it).  The words pack the keys over the ranges of the rows loaded
    here, never over ``remembered`` ones; where rows fall outside a
    remembered range (a column changed in place), the frame forgets it."""
    from .groupby import _forget
    t_start = time.perf_counter()
    dataset = df.dataset_for_execution()
    names = sorted(set(key_names) | {p[0] for _, kind, p in plan if p is not None})
    device = _pass_device(dataset, names)
    columns = {name: _column(dataset, name, device) for name in names}
    if any(c is None for c in columns.values()):
        return None
    keys = [columns[name].to(torch.int64) for name in key_names]
    bounds = torch.stack([torch.stack(torch.aminmax(key)) for key in keys]).tolist()
    if any(name in remembered and not remembered[name][0] <= lo <= hi <= remembered[name][1]
           for name, (lo, hi) in zip(key_names, bounds)):
        _forget(df)
    spans = [(lo, hi - lo + 1) for lo, hi in bounds]
    if any(span >= WORD_MAX_SPAN for _, span in spans):
        return None
    words = _words(spans)
    packed = [_pack(keys, spans, first, last) for first, last in words]
    pct_exprs = {p[0] for _, kind, p in plan if kind == "pct"}
    order = None
    if pct_exprs:
        pct_values = columns[pct_exprs.pop()].to(torch.float64)
        # NaN sorts past every value of its segment; the valid count keeps
        # the ranks below them
        order = torch.argsort(torch.nan_to_num(pct_values, nan=torch.inf), stable=True)
    for word in packed[::-1]:
        sorted_word, step = torch.sort(word if order is None else word[order], stable=True)
        order = step if order is None else order[step]
    # the last sort's values are the leading word in order
    sorted_words = [sorted_word] + [w[order] for w in packed[1:]]
    start = torch.zeros(order.shape[0], dtype=torch.bool, device=device)
    start[0] = True
    for w in sorted_words:
        start[1:] |= w[1:] != w[:-1]
    starts = torch.nonzero(start).squeeze(1)
    G = starts.shape[0]
    seg = torch.cumsum(start, 0) - 1
    counts = torch.diff(starts, append=starts.new_tensor([order.shape[0]]))

    def seg_sum(values, dtype):
        out = torch.zeros(G, dtype=dtype, device=device)
        return out.index_add_(0, seg, values[order].to(dtype))

    def valid_count(col):
        return seg_sum(~torch.isnan(col), torch.int64) if col.is_floating_point() else counts

    out = {}
    for (first, last), word in zip(words, sorted_words):
        for name, key in zip(key_names[first:last], _unpack(word[starts].to(torch.int64),
                                                             spans, first, last)):
            out[name] = key
    for name, kind, payload in plan:
        if kind == "count_star":
            out[name] = counts
            continue
        col = columns[payload[0]]
        clean = torch.nan_to_num(col, nan=0.0) if col.is_floating_point() else col
        if kind == "count":
            out[name] = valid_count(col)
        elif kind == "sum":
            out[name] = seg_sum(clean, torch.float64 if col.is_floating_point() else torch.int64)
        elif kind == "mean":
            c = valid_count(col).to(torch.float64)
            out[name] = torch.where(c > 0, seg_sum(clean, torch.float64) / c, torch.nan)
        elif kind in ("min", "max"):
            values = col.to(torch.float64) if col.is_floating_point() else col
            fill = (torch.inf if kind == "min" else -torch.inf) if values.is_floating_point() \
                else (torch.iinfo(values.dtype).max if kind == "min"
                      else torch.iinfo(values.dtype).min)
            if values.is_floating_point():
                values = torch.where(torch.isnan(values), fill, values)
            out[name] = torch.full((G,), fill, dtype=values.dtype, device=device).scatter_reduce_(
                0, seg, values[order], "amin" if kind == "min" else "amax")
        elif kind in ("std", "var"):
            c = valid_count(col).to(torch.float64)
            x = clean.to(torch.float64)
            mean = seg_sum(x, torch.float64) / c
            var = torch.clamp(seg_sum(x * x, torch.float64) / c - mean ** 2, min=0.0)
            ddof = payload[1]
            if ddof:
                var = torch.where(c > ddof, var * c / (c - ddof), torch.nan)
            var = torch.where(c > 0, var, torch.nan)
            out[name] = torch.sqrt(var) if kind == "std" else var
        else:  # pct: the value column was the least significant sort key
            nv = valid_count(col).to(torch.float64)
            out[name] = interp_order_stats(pct_values[order], starts, nv, payload[1])
    if not ascending:
        out = {name: v.flip(0) for name, v in out.items()}
    df.executor.passes += 1
    df.executor.trace_log.append({
        "pass": df.executor.passes,
        "wall_s": time.perf_counter() - t_start,
        "rows": order.shape[0],
        "device": str(device),
        "groupby": "one-sort",
        "mode": "packed" if len(words) == 1 else "unpacked",
        "words": len(words),
        "groups": G,
    })
    from . import from_dict
    result = from_dict(out)
    result.dataset.device = device
    return result

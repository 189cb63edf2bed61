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
``index_add_`` (exact mod 2^64), means in float64, a std or var in two
passes a segment (its mean, then the squared deviations).  A float column
reduces as numpy's nan-functions do: a NaN row adds nothing and is not
counted, an infinity stays one, so a segment's sum is inf, -inf or (both
held) NaN and its mean that over the count; its std and var are NaN where
it holds an infinity (inf - inf) and inf where its deviations' squares
overflow.  The two passes subtract no shift from a float column (an int
one's first row, exactly in int64).  The sorts, gathers and reductions are
torch calls: the reference's are XLA sorts and segment sums, not Pallas
kernels.  The result is sorted by the keys (reversed for a descending
single key).  The pass records ``{"groupby": "one-sort", "mode": ...}`` in
``trace_log``.

The result's columns are kept in the result cache (:mod:`.cache`, the
byte-bounded LRU of results that hold tensors) under the frame's exact key
and the plan, as vaex_tpu/fused_groupby.py:175-198 keeps them: the same
query over the same host arrays or CPU tensors, unwritten, sorts nothing
again; a frame of card tensors has no exact key, and sorts each time.

On a sharded executor (:mod:`.parallel`) the plan runs over the mesh
(vaex_tpu/fused_groupby.py:453-693, :func:`_run_mesh`): each shard sorts
its rows by their words (the percentile's values the least significant
key), one all-to-all sends each row to the shard that owns its range of the
leading word, and each owner sorts what it received and reduces its
segments as above, so that the owners' groups, taken in shard order, come
out sorted.  No set is built.  A bucket past its capacity retries with
twice the slack, and gives the query to the classic path after
``MESH_RETRIES`` doublings.  On a mesh a median or percentile always takes
this plan, whatever the keys' spans: the classic path's exact percentile
cannot merge row shards.  Over a mesh of several processes every decision
that leads to an exchange is taken over every process's rows (the row
count, the keys' ranges, a missing value, a cached result), each process
sends its own rows, and the owners' segments are gathered to every
process; a string key's codes differ from process to process, so such a
key takes the classic path there.
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
from .ops.grid_moments import shifted
from .utils import trace

# the most rows the one sort takes (vaex_tpu/tasks.py:146)
DENSE_RANK_MAX_ROWS = 1 << 27
# a word of packed keys stays below this span product
WORD_MAX_SPAN = 1 << 62
_KINDS = ("count", "sum", "mean", "min", "max", "std", "var", "median", "percentile")
# the mesh plan's first slack and its doublings (vaex_tpu/fused_groupby.py:456-473)
MESH_SLACK = 2
MESH_RETRIES = 4


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


def try_fused_sort_groupby(df, by, actions, sort=False, ascending=True, row_limit=None,
                           delay=False):
    """The result frame of the one-sort plan (with ``delay`` in a fulfilled
    promise), or None where the query does not qualify
    (vaex_tpu/fused_groupby.py:96-200).  ``sort`` changes nothing: the
    plan's groups come in key order."""
    from .groupby import maybe_delay
    result = _fused_sort_groupby(df, by, actions, ascending, row_limit)
    return None if result is None else maybe_delay(result, delay)


def _fused_sort_groupby(df, by, actions, ascending, row_limit):
    from .groupby import COMBINE_MIN_PRODUCT, DENSE_RANGE_MAX, _dense_candidates, parse_actions
    if row_limit is not None or df.filtered:
        return None
    mesh = getattr(df.executor, "sharded", None)
    across = mesh is not None and mesh.world > 1
    key_names, labels = [], {}
    for b in by if isinstance(by, (list, tuple)) else [by]:
        name = b.expression if isinstance(b, Expression) else b
        if not isinstance(name, str) or not df._is_physical(name):
            return None
        codes = _staged_codes(df, name)
        if codes is not None and across:
            return None  # each process's codes index its own labels
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
    if across:
        from .parallel import collectives
        n = collectives.total([n], mesh)
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
    if None not in spans and not (mesh is not None and any(k == "pct" for _, k, _ in plan)):
        if len(spans) == 1 and spans[0] <= DENSE_RANGE_MAX:
            return None
        if len(spans) > 1 and np.prod(spans, dtype=np.float64) <= COMBINE_MIN_PRODUCT:
            return None
    names = sorted(set(key_names) | {p[0] for _, kind, p in plan if p is not None})
    frame, content = df._cache_key(names)
    parts = ("one-sort groupby", frame, key_names, ascending[0], plan)
    cache_key = cache.key(*parts, *(() if mesh is None else (mesh.key(),)), content=content)
    columns = None if frame is None else cache.lookup(cache_key)
    if across and collectives.total([columns is None], mesh):
        columns = None  # a process that must sort: every process sorts
    if columns is not None:  # the result columns, on the device the sort ran on
        from . import from_dict
        result = from_dict(dict(columns))
        result.dataset.device = next(iter(columns.values())).device
    else:
        with trace("one-sort groupby"):
            result = _run(df, key_names, plan, ascending[0], info, mesh)
        if result is None:
            return None
        if frame is not None:  # a card tensor's frame has no exact key: nothing kept
            cache.store(cache_key,
                        {n: result.dataset[n] for n in result.get_column_names(hidden=True)})
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


def _run(df, key_names, plan, ascending, remembered, mesh=None):
    """One sort of the rows by their keys, then per-segment reductions
    (vaex_tpu/fused_groupby.py:229-452; over ``mesh`` :func:`_run_mesh`);
    None where a key has missing values or spans too far for a word (the
    classic set path takes it).  The words pack the keys over the ranges of
    the rows loaded here, never over ``remembered`` ones; where rows fall
    outside a remembered range (a column changed in place), the frame
    forgets it."""
    from .groupby import _forget
    t_start = time.perf_counter()
    dataset = df.dataset_for_execution()
    names = sorted(set(key_names) | {p[0] for _, kind, p in plan if p is not None})
    if mesh is None:
        device = _pass_device(dataset, names)
        shards = [{name: _column(dataset, name, device) for name in names}]
    else:
        from .parallel import collectives
        device = mesh.first
        shards = _mesh_columns(df, names, mesh)
    missing = any(c is None for shard in shards for c in shard.values())
    if mesh is not None:  # a missing value in any process
        missing = collectives.total([missing], mesh) > 0
    if missing:
        return None
    keys = [[shard[name].to(torch.int64) for name in key_names] for shard in shards]
    # per shard one read of every key's (min, max); an empty shard bounds nothing
    bounds = [torch.stack([torch.stack(torch.aminmax(k)) for k in ks]).tolist()
              if ks[0].numel() else [(2 ** 63 - 1, -2 ** 63)] * len(ks) for ks in keys]
    if mesh is None:
        bounds = [(min(b[i][0] for b in bounds), max(b[i][1] for b in bounds))
                  for i in range(len(key_names))]
    else:  # over every shard of every process
        bounds = [(collectives.extreme([b[i][0] for b in bounds], "min", mesh),
                   collectives.extreme([b[i][1] for b in bounds], "max", mesh))
                  for i in range(len(key_names))]
    if any(name in remembered and not remembered[name][0] <= lo <= hi <= remembered[name][1]
           for name, (lo, hi) in zip(key_names, bounds)):
        _forget(df)
    spans = [(lo, hi - lo + 1) for lo, hi in bounds]
    if any(span >= WORD_MAX_SPAN for _, span in spans):
        return None
    words = _words(spans)
    pct_exprs = {p[0] for _, kind, p in plan if kind == "pct"}
    pct_name = pct_exprs.pop() if pct_exprs else None
    packed = [[_pack(ks, spans, first, last) for first, last in words] for ks in keys]
    record = {}
    if mesh is None:
        out, G, n_rows = _reduce(packed[0], shards[0], key_names, plan, spans, words, pct_name)
    else:
        done = _run_mesh(mesh, packed, shards, key_names, plan, spans, words, pct_name, record)
        if done is None:
            df.executor.trace_log.append(record)
            return None
        out, G, n_rows = done
    if not ascending:
        out = {name: v.flip(0) for name, v in out.items()}
    df.executor.passes += 1
    df.executor.trace_log.append({
        "pass": df.executor.passes,
        "wall_s": time.perf_counter() - t_start,
        "rows": n_rows,
        "device": str(device),
        "groupby": "one-sort",
        "mode": "packed" if len(words) == 1 else "unpacked",
        "words": len(words),
        "groups": G,
        **record,
    })
    from . import from_dict
    result = from_dict(out)
    result.dataset.device = device
    return result


def _mesh_columns(df, names, mesh):
    """Per shard of the mesh each physical column's rows on the shard's
    device, None where they hold a missing value."""
    from .parallel.shuffle import shard_values
    out = []
    for shard in shard_values(df, names, mesh):
        out.append({name: None if x.mask is not None and bool(x.mask.any()) else x.data
                    for name, x in shard.items()})
    return out


def _order(words, pct_values):
    """(the rows' order by their words, the most significant first, then
    by the percentile's values (NaN last): stable sorts from the least
    significant key; the leading word in that order, the last sort's
    values, which no gather need make again)."""
    order = None
    if pct_values is not None:
        order = torch.argsort(torch.nan_to_num(pct_values.to(torch.float64), nan=torch.inf),
                              stable=True)
    for word in words[::-1]:
        lead, step = torch.sort(word if order is None else word[order], stable=True)
        order = step if order is None else order[step]
    return order, lead


def _run_mesh(mesh, packed, shards, key_names, plan, spans, words, pct_name, record):
    """The one-sort plan over the mesh: each shard's rows sorted by their
    words, sent by one all-to-all to the owner of their range of the leading
    word, sorted there and reduced by :func:`_reduce`
    (vaex_tpu/fused_groupby.py:453-693).  Returns what :func:`_reduce`
    does for all owners in order, or None (``record`` says why) when the
    slack retries run out."""
    from .parallel import collectives
    from .parallel.shuffle import Packing, capacity
    S = mesh.size
    values = [n for n in shards[0] if n not in key_names]
    # per shard one read of the leading word's (min, max)
    bounds = [torch.stack(torch.aminmax(w[0])).tolist() if w[0].numel() else (2 ** 62, -1)
              for w in packed]
    kmin = collectives.extreme([lo for lo, _ in bounds], "min", mesh)
    kmax = collectives.extreme([hi for _, hi in bounds], "max", mesh)
    width = max((kmax - kmin) // S + 1, 1)
    # the shard-local carried sort: each shard's rows in key order
    orders = [_order(w, shard[pct_name] if pct_name else None) for w, shard in zip(packed, shards)]
    packed = [[lead] + [word[o] for word in w[1:]] for w, (o, lead) in zip(packed, orders)]
    shards = [{name: shard[name][o] for name in values} for shard, (o, _) in zip(shards, orders)]
    n_rows = collectives.total([w[0].shape[0] for w in packed], mesh)
    row_bytes = sum(w.element_size() for w in packed[0]) + sum(
        shards[0][n].element_size() for n in values)
    slack = MESH_SLACK
    for attempt in range(MESH_RETRIES + 1):
        n_local, cap = capacity(mesh, n_rows, slack)
        packings = [Packing(((w[0].to(torch.int64) - kmin) // width).clamp(0, S - 1), S, cap)
                    for w in packed]
        dropped = collectives.total([p.overflow for p in packings], mesh)
        record.update({"fused_mesh_groupby": True, "devices": S, "world": mesh.world,
                       "exchanges": 1,
                       "set_build_passes": 0, "slack": slack, "attempt": attempt,
                       "rows_per_device": n_local, "capacity_rows_per_device": S * cap,
                       "row_bytes": row_bytes, "alltoall_bytes_per_device": S * cap * row_bytes,
                       "dropped": dropped})
        if not dropped:
            break
        slack *= 2
    else:
        record["fused_mesh_groupby"] = "classic"
        return None
    channels = [([w[j] for w in packed], -1 if j == 0 else 0) for j in range(len(words))]
    channels += [([shard[n] for shard in shards], 0) for n in values]
    from .parallel.shuffle import exchange
    t0 = time.perf_counter()  # host clock: the exchange's and the gather's walls
    received = exchange(mesh, packings, channels)
    record["exchange_s"] = time.perf_counter() - t0
    outs = []
    for d in range(len(mesh.devices)):
        real = torch.nonzero(received[0][d] >= 0).squeeze(1)
        mine = [r[d].index_select(0, real) for r in received]
        columns = dict(zip(values, mine[len(words):]))
        for w, (first, last) in enumerate(words):  # a key column's values from its word
            for name, key in zip(key_names[first:last],
                                 _unpack(mine[w].to(torch.int64), spans, first, last)):
                columns.setdefault(name, key)
        out, _, _ = _reduce(mine[:len(words)], columns, key_names, plan, spans, words, pct_name)
        outs.append(out)
    t0 = time.perf_counter()
    parts = {name: torch.cat(collectives.gather([o[name] for o in outs], mesh))
             for name in outs[0]}
    record["gather_s"] = time.perf_counter() - t0
    return parts, next(iter(parts.values())).shape[0], n_rows


def _reduce(packed, columns, key_names, plan, spans, words, pct_name):
    """(the result columns, the groups, the rows) of one device's rows:
    ``packed`` their words, ``columns`` the physical columns the plan
    reads; one sort (:func:`_order`), then per-segment reductions."""
    device = packed[0].device
    pct_values = columns[pct_name].to(torch.float64) if pct_name else None
    n_rows = packed[0].shape[0]
    if n_rows == 0:
        return _empty_result(columns, key_names, plan, device), 0, 0
    order, lead = _order(packed, pct_values)
    sorted_words = [lead] + [w[order] for w in packed[1:]]
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
        # a NaN row adds nothing; an infinity stays one (nan_to_num would
        # make it the dtype's largest finite value)
        clean = col.masked_fill(torch.isnan(col), 0) if col.is_floating_point() else col
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
            # two passes a segment over the sorted rows: the segment's mean,
            # then the squares of the deviations from it; nothing cancels.
            # An int column less its segment's first row, exact in int64 (a
            # segment 2^53 or more from another keeps its digits); a float
            # column as it is: a shift of its own (an infinity, the largest
            # float) would swallow the digits of every segment far from it
            c = valid_count(col).to(torch.float64)
            v = col[order]
            ok = ~torch.isnan(v) if v.is_floating_point() else None
            u = shifted(v, v[starts][seg] if ok is None else None)
            if ok is not None:  # a NaN row adds nothing
                u = u.masked_fill(~ok, 0.0)
            mean = torch.zeros(G, dtype=torch.float64, device=device).index_add_(0, seg, u) / c
            dev = u - mean[seg]
            if ok is not None:
                dev = dev.masked_fill(~ok, 0.0)
            var = torch.zeros(G, dtype=torch.float64, device=device).index_add_(
                0, seg, dev * dev) / c
            ddof = payload[1]
            if ddof:
                var = torch.where(c > ddof, var * c / (c - ddof), torch.nan)
            var = torch.where(c > 0, var, torch.nan)
            out[name] = torch.sqrt(var) if kind == "std" else var
        else:  # pct: the value column was the least significant sort key
            nv = valid_count(col).to(torch.float64)
            out[name] = interp_order_stats(pct_values[order], starts, nv, payload[1])
    return out, G, n_rows


def _empty_result(columns, key_names, plan, device):
    """The result columns of an owner that received no row: empty, of the
    dtypes :func:`_reduce` gives."""
    out = {name: torch.empty(0, dtype=torch.int64, device=device) for name in key_names}
    for name, kind, payload in plan:
        if kind in ("count_star", "count"):
            dtype = torch.int64
        elif kind == "sum":
            dtype = torch.float64 if columns[payload[0]].is_floating_point() else torch.int64
        elif kind in ("min", "max"):
            col = columns[payload[0]]
            dtype = torch.float64 if col.is_floating_point() else col.dtype
        else:
            dtype = torch.float64
        out[name] = torch.empty(0, dtype=dtype, device=device)
    return out

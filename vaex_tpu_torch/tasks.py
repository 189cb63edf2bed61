"""Tasks: units of work executed in one pass over the data.

A task has an ``initial_state`` (given the pass's device and row count),
an ``update`` that folds one tile into the state, and a ``finalize`` that
fulfills its promise.  Torch runs eagerly, so ``update`` is a plain Python
function called once per tile.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import tracing
from .datatype import NAT, UINT64, DataType, host_values, order_image
from .delayed import Promise
from .ops.binners import fuse_bins, grid_shape, grid_size
from .ops.grid_extreme import extreme_of_rows
from .ops.grid_moments import MAX_BASES, MAX_TERMS, row_shift, shifted
from .ops.nullable import NA, DictNA
from .ops.grid_plan import grid_extremes, grid_sums, grid_sums_and_extremes, moment_sums
from .ops.setops import RowLimitException, SortedSet
from .utils import fingerprint, identity


class Task(Promise):
    # served from the result cache (:mod:`.cache`) by its fingerprint and
    # the frame's key; an aggregation and a map-reduce never are
    cacheable = False

    def __init__(self, df, expressions, name="task"):
        super().__init__()
        self.df = df
        self.expressions = [str(e) for e in expressions]
        self.name = name

    def fingerprint(self):
        """What, beside the frame's key, decides the task's result."""
        return fingerprint(type(self).__name__, self.expressions, self._fingerprint_extra())

    def _fingerprint_extra(self):
        return None

    def initial_state(self, device, rows):
        raise NotImplementedError

    def update(self, state, ctx):
        """Fold one tile (a TileContext) into ``state``; returns the new state."""
        raise NotImplementedError

    def finalize(self, state):
        raise NotImplementedError

    def merge(self, states, mesh):
        """One state from the states of a sharded pass's shards, given in
        shard order (:mod:`.parallel.collectives`)."""
        raise NotImplementedError(f"{type(self).__name__} does not run over a mesh")


class TaskAggregations(Task):
    """All aggregations of one pass that share a binner stack and a
    selection (a boolean expression, or None).  The rows the frame's filter
    or the selection drops get the bin index -1, which every grid kernel
    and ``grid_extreme`` leave out.

    ``subtasks`` holds the AggOperations the descriptors of
    :mod:`vaex_tpu_torch.agg` registered.  Per tile, each kind rides its own
    batch: the additive ops one call of the grid kernel that
    :mod:`.ops.grid_plan` picks for the grid size (B1, B2 or B3; past B3's
    limits B3 in several calls of fewer channels, ``"b3×k"``, or the route
    ``"sort"``, :mod:`.ops.grid_sort`), the moment ops as few calls of the
    moment kernel it picks (B4, B5, or those wide routes over formed terms)
    as ``MAX_BASES`` / ``MAX_TERMS`` allow, all the extremes one batch of the
    min/max kernel B3x or ``"sort"`` (:func:`.ops.grid_plan.grid_extremes`),
    which shares the partition of the additive batch where the extremes need
    one (``"scatter": "shared"``).  Each call adds the tile into the ops'
    running states in place, so a pass holds one grid per state.
    A ``first`` is two per-bin mins through the same route, of the order
    values and then of the row numbers among the rows that hold the winning
    order.  An approximate percentile counts its [cell, value bin] grid
    through the additive plan (``"percentile"``: the kernel), and so does a
    nunique's presence grid of [cell, value ordinal] (``"presence"``); a
    top-k, an exact percentile and a nunique of sorted pairs fold each tile
    themselves (``"topk"``, ``"percentile_exact"``, ``"nunique"``:
    ``"sort"``; a top-k of few slots over many cells on the card
    ``"b3x-l2-topk"``, ``agg.OpTopK``).  Without binners the grid is one
    cell and an extreme is a plain reduction over the rows (``"reduce"``).
    ``strategy`` maps each kind of the last tile to its kernel, e.g.
    ``{"additive": "b1", "moments": "b5", "extremes": "b3x-direct"}``, and
    ``"moment_shift": "cell"`` where a moment op takes a shift a cell (a
    statistic's second pass); the executor writes it into the pass's
    ``trace_log`` entry.
    """

    def __init__(self, df, binners, selection=None):
        super().__init__(df, [b.expression for b in binners], name="aggregations")
        self.binners = tuple(binners)
        self.selection = None if selection is None else str(selection)
        if self.selection is not None:
            self.expressions.append(self.selection)
        self.subtasks = []
        self.subtask_promises = []
        self.strategy = None

    def add_subtask(self, operation):
        self.subtasks.append(operation)
        sub = Task(self.df, operation.expressions, name=f"agg-{operation.name}")
        self.subtask_promises.append(sub)
        for e in operation.expressions:
            if e not in self.expressions:
                self.expressions.append(e)
        return sub

    def reject(self, exception):
        super().reject(exception)
        for sub in self.subtask_promises:
            if not sub.done:
                sub.reject(exception)
        return self

    def initial_state(self, device, rows):
        G = grid_size(self.binners)
        return [op.initial_state(G, device, rows) for op in self.subtasks]

    def update(self, state, ctx):
        G = grid_size(self.binners)
        new_state = list(state)
        self.strategy = {}
        kinds = {}
        for i, op in enumerate(self.subtasks):
            kinds.setdefault(op.kind, []).append(i)
        # without binners the extremes reduce the valid rows and need no index
        with tracing.span("prolog"):
            idx = (self._flat_indices(ctx, kinds.keys())
                   if self.binners or kinds.keys() - {"extreme"} else None)
        # the extremes of a binned task ride the additive batch's call
        riders = kinds.get("extreme", []) if self.binners else []
        if "additive" in kinds or riders:
            self._update_additive(kinds.get("additive", []), riders, new_state, idx, G, ctx)
        if "moments" in kinds:
            batches = _moment_batches(self.subtasks, kinds["moments"])
            names = [self._update_moments(batch, new_state, idx, G, ctx) for batch in batches]
            self.strategy["moments"] = "+".join(dict.fromkeys(names))
            if any(s is not None and s.dim() == 1 for b in batches for s in b.shifts):
                self.strategy["moment_shift"] = "cell"  # a second pass (agg.cell_shifted)
        if "extreme" in kinds and not self.binners:
            rows = ctx.selection_valid(self.selection)
            for i in kinds["extreme"]:
                op = self.subtasks[i]
                values, valid = op.extreme_input(ctx)
                if rows is not None:
                    valid = rows if valid is None else valid & rows
                grid = extreme_of_rows(values, op.mode, valid, ctx.n_rows)
                new_state[i] = op.apply_kernel(new_state[i], grid)
            self.strategy["extremes"] = "reduce"
        if "first" in kinds:
            names = [self._update_first(i, new_state, idx, G, ctx) for i in kinds["first"]]
            self.strategy["first"] = "+".join(dict.fromkeys(names))
        for kind in ("percentile", "presence"):
            names = []
            for i in kinds.get(kind, []):
                op = self.subtasks[i]
                name, _, _ = grid_sums(op.count_index(ctx, idx, G), [], [], G * op.bins, True,
                                       out=([new_state[i]], []))
                names.append(name)
            if names:
                self.strategy[kind] = "+".join(dict.fromkeys(names))
        for i in kinds.get("own", []):
            op = self.subtasks[i]
            new_state[i] = op.update(new_state[i], idx, G, ctx)
            self.strategy[op.name] = getattr(op, "strategy", "sort")
        return new_state

    def _update_additive(self, members, riders, new_state, idx, G, ctx):
        """One tile's additive batch (``members``) and its binned extremes
        (``riders``): one call each, or one for both.  Each channel's first
        member hands its state to the call, which adds the tile into it in
        place (``grid_plan``'s ``out``); a later count member copies the
        first's, and a state the call cannot take (a narrower extreme) takes
        the tile's grid through ``apply_kernel``."""
        def target(i, dtype):
            s = new_state[i]
            return s if s.dtype == dtype and s.shape == (G,) else None
        int_cols, float_cols, slots, int_out, float_out = [], [], [], [], []
        count_owner = None
        for i in members:
            kind, col = self.subtasks[i].kernel_input(ctx)
            if kind == "count":
                count_owner = i if count_owner is None else count_owner
                slots.append(("count", 0))
            elif kind == "int":
                slots.append(("int", len(int_cols)))
                int_cols.append(col)
                int_out.append(target(i, torch.int64))
            else:
                slots.append(("float", len(float_cols)))
                float_cols.append(col)
                float_out.append(target(i, torch.float64))
        count = count_owner is not None
        out = ([target(count_owner, torch.int64)] if count else []) + int_out, float_out
        cols, valids = [], []
        for i in riders:
            values, valid = self.subtasks[i].extreme_input(ctx)
            cols.append(values)
            valids.append(valid)
        modes = [self.subtasks[i].mode for i in riders]
        ext_out = [target(i, col.dtype) if new_state[i].dtype != torch.bool else None
                   for i, col in zip(riders, cols)]
        if members:
            name, ext_name, shared, int_sums, float_sums, grids = grid_sums_and_extremes(
                idx, int_cols, float_cols, G, count, cols, modes, valids, out, ext_out)
            self.strategy["additive"] = name
            if shared:
                self.strategy["scatter"] = "shared"
        else:
            ext_name, grids = grid_extremes(idx, cols, modes, valids, G, ext_out)
        if riders:
            self.strategy["extremes"] = ext_name
        targets = out[0] + out[1]
        for i, (kind, k) in zip(members, slots):
            if kind == "count":
                row, sums = 0, int_sums[0]
            elif kind == "int":
                row, sums = int(count) + k, int_sums[int(count) + k]
            else:
                row, sums = len(out[0]) + k, float_sums[k]
            if targets[row] is None:
                new_state[i] = self.subtasks[i].apply_kernel(new_state[i], sums)
            elif targets[row] is not new_state[i]:  # a later count member
                new_state[i].copy_(targets[row])
        for i, grid, given in zip(riders, grids, ext_out):
            if given is None:
                new_state[i] = self.subtasks[i].apply_kernel(new_state[i], grid)

    def _update_first(self, i, new_state, idx, G, ctx):
        """One tile of a ``first``: per bin the smallest order value, then the
        earliest of the rows that hold it, then that row's value; a bin's
        state changes only where the tile's order is strictly smaller, so
        among equal orders the earliest row of the whole pass wins."""
        op = self.subtasks[i]
        values, order, valid = op.first_input(ctx)
        name, (tile_order,) = grid_extremes(idx, [order], ["min"], [valid], G)
        # a row wins where it is valid and holds its bin's smallest order
        inside = (idx >= 0) & (idx < G)
        winner = inside & (order == tile_order[idx.clamp(0, G - 1).to(torch.int64)])
        if valid is not None:
            winner &= valid
        rows = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
        _, (first_row,) = grid_extremes(idx, [rows], ["min"], [winner], G)
        n = idx.shape[0]
        found = first_row < n  # an empty bin holds the int64 max
        tile_values = values[first_row.clamp(max=max(n - 1, 0))] if n else values.new_zeros(G)
        new_state[i] = op.apply_first(new_state[i], tile_values, tile_order, found)
        return name

    def _update_moments(self, batch, new_state, idx, G, ctx):
        """One kernel call of a moment batch: each batch term's first member
        hands the call its state's row of that term to add the tile into in
        place; the other members holding the term copy that row."""
        inputs = [moment_input(ctx.expr(e), s, idx) for e, s in zip(batch.bases, batch.shifts)]
        bases = [b for b, _ in inputs]
        out, copies = [None] * len(batch.terms), []
        for i, slots in batch.members:
            counts, sums = new_state[i]
            n_count = n_float = 0
            for k in slots:
                if batch.terms[k][0] < 0:
                    row, n_count = counts[n_count], n_count + 1
                else:
                    row, n_float = sums[n_float], n_float + 1
                if out[k] is None:
                    out[k] = row
                else:
                    copies.append((row, k))
        name, _, _ = moment_sums(idx, bases, batch.terms, G, out=out,
                                 shift=[s for _, s in inputs])
        for row, k in copies:
            row.copy_(out[k])
        return name

    def _flat_indices(self, ctx, kinds):
        """Each row's flat bin, -1 where the selection drops it; None without
        binners or a selection where only moments need it (every row in bin
        0: B4 reads no index)."""
        valid = ctx.selection_valid(self.selection)
        if self.binners:
            indices = [b.to_bins(ctx.expr(b.expression)) for b in self.binners]
            idx = fuse_bins(self.binners, indices)
            return idx if valid is None else idx.masked_fill(~valid, -1)
        if valid is not None:
            return valid.to(torch.int32) - 1
        if kinds - {"extreme", "moments"}:
            return torch.zeros(ctx.n_rows, dtype=torch.int32, device=ctx.device)
        return None

    def merge(self, states, mesh):
        """Each op's states merged by the op's collective
        (vaex_tpu/tasks.py:458-476)."""
        return [op.merge([s[i] for s in states], mesh) for i, op in enumerate(self.subtasks)]

    def finalize(self, state):
        shape = grid_shape(self.binners)
        results = [op.get_result(s, shape) for op, s in zip(self.subtasks, state)]
        self.fulfill(results)
        for sub, r in zip(self.subtask_promises, results):
            sub.fulfill(r)
        return results


class TaskSetCreate(Task):
    """The sorted set of an expression's values over the rows the frame's
    filter keeps: per tile a ``torch.unique`` of the rows that are neither
    NaN nor missing, merged into the running set on the pass device; NaN and
    missing rows are counted apart, and the NaT rows of a datetime or
    timedelta expression count as missing (the keys keep its dtype).
    ``limit`` is checked as the set grows.
    Fulfilled with a :class:`~vaex_tpu_torch.ops.setops.SortedSet` whose keys
    stay on the pass device.

    Strings (vaex_tpu/tasks.py:596-650) come as dictionary codes
    (:class:`~.ops.nullable.DictNA`): the rows of each code are counted on
    the pass device through the grid plan (B1 / B2 / B3 over the codes),
    across the tiles that share one labels array (a staged column's), and
    the labels that have rows go into a set of strings on the host."""

    cacheable = True

    def __init__(self, df, expression, keep_counts=False, limit=None):
        super().__init__(df, [expression], name="set-create")
        self.keep_counts = keep_counts
        self.limit = limit
        dtype = df.data_type(expression)
        self.strings = dtype.is_text
        self.temporal = dtype.numpy if dtype.is_temporal else None
        # uint64 keys are kept as their order image, so that they sort as numbers
        self.unsigned = dtype.numpy == UINT64

    def _fingerprint_extra(self):
        return self.keep_counts, self.limit

    def initial_state(self, device, rows):
        if self.strings:
            return {"set": SortedSet("string", self.keep_counts, self.limit), "labels": None,
                    "counts": None, "null": 0}
        return {"keys": None, "counts": None, "nan": 0, "null": 0}

    def _update_strings(self, state, x, keep):
        """Count the rows of each code of one tile into the running counts of
        its labels (flushed into the set when the labels change)."""
        if not isinstance(x, DictNA):
            raise TypeError(f"a set of strings over {x!r}")
        drop = None if keep is None else ~keep
        if x.mask is not None:
            null = x.mask if keep is None else x.mask & keep
            with tracing.host_read("null-count"):
                state["null"] += int(null.sum())
            drop = x.mask if drop is None else drop | x.mask
        if state["labels"] is not x.labels:
            _flush_strings(state)
            state["labels"] = x.labels
        idx = x.data.to(torch.int32)
        if drop is not None:
            idx = idx.masked_fill(drop, -1)
        out = None if state["counts"] is None else ([state["counts"]], [])
        _, ints, _ = grid_sums(idx.contiguous(), [], [], len(x.labels) + 1, True, out=out)
        state["counts"] = ints[0]
        if self.limit is not None:
            _flush_strings(state)
        return state

    def update(self, state, ctx):
        x = ctx.expr(self.expressions[0])
        if self.strings:
            return self._update_strings(state, x, ctx.row_valid)
        data, keep = x.data, ctx.row_valid
        missing = x.mask
        if self.temporal is not None:
            nat = data == NAT
            missing = nat if missing is None else missing | nat
        if missing is not None:
            null = missing if keep is None else missing & keep
            with tracing.host_read("null-count"):
                state["null"] += int(null.sum())
            keep = ~missing if keep is None else keep & ~missing
        if data.is_floating_point():
            nan = torch.isnan(data) if keep is None else torch.isnan(data) & keep
            with tracing.host_read("nan-count"):
                n_nan = int(nan.sum())
            if n_nan:
                state["nan"] += n_nan
                keep = ~nan if keep is None else keep & ~nan
        if keep is not None:
            data = data[keep]
        if self.unsigned:
            data = order_image(data)
        if self.keep_counts:
            keys, counts = torch.unique(data, sorted=True, return_counts=True)
            if state["keys"] is not None:
                keys, inverse = torch.unique(torch.cat([state["keys"], keys]), sorted=True,
                                             return_inverse=True)
                counts = torch.zeros_like(keys, dtype=torch.int64).index_add_(
                    0, inverse, torch.cat([state["counts"], counts]))
            state["counts"] = counts
        else:
            keys = torch.unique(data, sorted=True)
            if state["keys"] is not None:
                keys = torch.unique(torch.cat([state["keys"], keys]), sorted=True)
        state["keys"] = keys
        count = keys.shape[0] + (state["nan"] > 0) + (state["null"] > 0)
        if self.limit is not None and count > self.limit:
            raise RowLimitException(f"set grew to {count} unique values, which exceeds the "
                                    f"limit of {self.limit}")
        return state

    def merge(self, states, mesh):
        """The union of the shards' sets: their keys gathered and made
        unique again (the counts added), the NaN and missing rows added; a
        set of strings merges the host sets, across processes too."""
        from .parallel import collectives
        if self.strings:
            for state in states:
                _flush_strings(state)
            merged = states[0]["set"]
            for state in states[1:]:
                merged.merge(state["set"])
            parts = collectives.objects(merged, mesh)
            merged = parts[0]
            for other in parts[1:]:
                merged.merge(other)
            return {"set": merged, "labels": None, "counts": None, "null": 0}
        keys = torch.cat(collectives.gather([s["keys"] for s in states], mesh))
        counts = None
        if self.keep_counts:
            counts = torch.cat(collectives.gather([s["counts"] for s in states], mesh))
            keys, inverse = torch.unique(keys, sorted=True, return_inverse=True)
            counts = torch.zeros_like(keys, dtype=torch.int64).index_add_(0, inverse, counts)
        else:
            keys = torch.unique(keys, sorted=True)
        nan = collectives.total([s["nan"] for s in states], mesh)
        null = collectives.total([s["null"] for s in states], mesh)
        count = keys.shape[0] + (nan > 0) + (null > 0)
        if self.limit is not None and count > self.limit:
            raise RowLimitException(f"set grew to {count} unique values, which exceeds the "
                                    f"limit of {self.limit}")
        return {"keys": keys, "counts": counts, "nan": nan, "null": null}

    def finalize(self, state):
        if self.strings:
            _flush_strings(state)
            self.fulfill(state["set"])
            return state["set"]
        dtype = self.temporal or (UINT64 if self.unsigned else DataType(state["keys"].dtype).numpy)
        oset = SortedSet.from_device(dtype, state["keys"],
                                     state["counts"], state["nan"], state["null"], self.limit)
        self.fulfill(oset)
        return oset


def _flush_strings(state):
    """The counted labels, and the null rows, into the set of strings."""
    if state["counts"] is not None:
        state["set"].update_counts(state["labels"], state["counts"].cpu().numpy(), state["null"])
        state["null"] = 0
    elif state["null"]:
        state["set"].null_count += state["null"]
        state["null"] = 0
        state["set"]._check_limit()
    state["labels"] = state["counts"] = None


# the rows at the head of a frame that :func:`moment_shift` reads
SHIFT_ROWS = 1024


def moment_data(x):
    """(values, missing rows or None) of one tile's NA: int64 for integer,
    bool and temporal values (NaT missing), float32 or float64 for floats;
    for uint64 values their order image (:func:`.datatype.order_image`,
    the value less 2^63 as an int64), so that a uint64 base and its shifts
    subtract exactly in int64 as an int64 base's do: (x - 2^63) - (s - 2^63)
    is x - s.  Only a shift's own value differs, by 2^63."""
    d, missing = x.data, x.mask
    if x.logical is not None and x.logical.kind in "mM":
        nat = d == NAT
        missing = nat if missing is None else missing | nat
    if x.logical == UINT64:
        d = order_image(d)
    elif d.is_floating_point():
        if d.dtype not in (torch.float32, torch.float64):
            d = d.to(torch.float64)
    else:
        d = d.to(torch.int64)
    return d, missing


def moment_input(x, shift=None, idx=None):
    """(a base column of the moment kernels from one tile's NA, the shift
    the kernel subtracts from it): int64, float32 or float64, with NaN in
    the masked rows and the NaT rows of a datetime or timedelta (as
    float64).  :func:`moment_prolog` of :func:`moment_data`."""
    return moment_prolog(*moment_data(x), shift, idx)


def moment_prolog(d, missing, shift=None, idx=None):
    """The base and the kernel's shift of values ``d`` (int64, float32 or
    float64) and their ``missing`` rows.  An int64 column that becomes
    float64 so (a masked int, a datetime) is shifted here, in int64 before
    the cast (:func:`.ops.grid_moments.shifted`: a table at each row's bin
    in ``idx``, the tile's flat bins), and hands the kernel no shift.

    Shifted moments: ``shift`` is the same on every tile and shard, so that
    the shifted sums still merge by addition; var(x) = var(x - a) for any
    a, cell by cell.  On a statistic's first pass it is one constant a base
    (:func:`moment_shift`), a guess near the data; a cell far from it loses
    digits, and the finisher takes such cells again in a second pass less a
    shift a cell, a [G] table of the cells' means (:mod:`.agg`,
    ``cell_shifted``)."""
    shift = None if shift is None else shift.to(d.device)
    if missing is not None:
        if d.dtype == torch.int64 and shift is not None:
            d, shift = shifted(d, row_shift(shift, idx, d.shape[0])), None
        d = d.to(torch.float64).masked_fill(missing, torch.nan)
    return d.contiguous(), shift


def _shift_key(df, expression):
    """What a remembered shift of ``expression`` is kept under: the
    expression, the virtual columns, and each column it reads by its
    ``id`` (a tensor also by its version): a write that bumps the version
    takes a new shift, one that does not keeps a stale one."""
    from .scopes import classify_leaves
    _, columns, _ = classify_leaves(df, expression)
    cols = []
    for name in sorted(c for c in columns if c in df.dataset):
        col = df.dataset[name]  # held by the node that holds the memo: its id stays its own
        cols.append((name, id(col), getattr(col, "_version", None)))
    return ("moment shift", expression, frozenset(df.virtual_columns.items()), tuple(cols))


def moment_shift(df, expression):
    """The shift of ``expression``'s moment base (:func:`moment_input`): its
    first valid value among the frame's first ``SHIFT_ROWS`` rows (filter
    or not), 0 where none is valid, NaN or infinite; an int64 0-d tensor for
    integer and temporal values (their counts) and for uint64 values (their
    order image), float64 else, on the device the rows are read on, never read by
    the host.  Evaluated once and remembered on the dataset node
    (:func:`_shift_key`); over a mesh of several processes rank 0's shift,
    broadcast, so that every shard shifts alike."""
    mesh = getattr(df.executor, "sharded", None)
    group = mesh is not None and mesh.group is not None
    memo = df.dataset.remembered
    key = _shift_key(df, expression)
    if key in memo and not group:
        return memo[key]
    n = min(SHIFT_ROWS, df.dataset.row_count)
    d, missing = moment_data(df._evaluate_tile(expression, 0, n, filtered=False))
    valid = torch.ones_like(d, dtype=torch.bool) if missing is None else ~missing
    if d.is_floating_point():
        d = d.to(torch.float64)
        valid &= torch.isfinite(d)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    shift = zero
    if n:  # the first valid row's value (indexed by a device scalar: a host read)
        with tracing.host_read("shift-row"):
            shift = torch.where(valid.any(), d[valid.to(torch.uint8).argmax()], zero)
    if group:
        from .parallel import collectives
        shift = collectives.broadcast(shift, mesh)
    else:
        memo[key] = shift
    return shift


def _base_key(expression, shift):
    """What a batch shares a base under: the expression and, for a shift a
    cell (a [G] table: a second pass), the table itself, so that a
    second-pass op never shares a base with a first-pass op or another
    table's; every constant shift of one expression in a pass is the
    frame's (:func:`moment_shift`)."""
    return expression, id(shift) if shift is not None and shift.dim() == 1 else None


class _MomentBatch:
    """The OpMoments of one kernel call: their bases (an expression and its
    shift, :func:`_base_key`) and terms, both deduplicated, and per op the
    batch term of each of its terms."""

    def __init__(self):
        self.bases, self.shifts, self.terms, self.keys, self.members = [], [], [], [], []
        self.base_keys = []

    def add(self, i, op):
        """Take op i if the batch stays within the kernels' limits; ops share
        a base where they name one expression with one shift (a constant:
        the frame's; a table: the same table)."""
        shifts = op.shifts or [None] * len(op.expressions)
        named = [_base_key(e, s) for e, s in zip(op.expressions, shifts)]
        new = [k for k in dict.fromkeys(named) if k not in self.base_keys]
        base_keys = self.base_keys + new
        if len(base_keys) > MAX_BASES:
            return False
        where = [base_keys.index(k) for k in named]
        terms, keys, slots = list(self.terms), list(self.keys), []
        for term in op.terms:
            a, b, v0, v1 = (where[j] if j >= 0 else -1 for j in term)
            if b >= 0 and b < a:
                a, b = b, a
            # a term is its factors and the bases it needs valid
            key = (a, b, frozenset(j for j in (a, b, v0, v1) if j >= 0))
            if key not in keys:
                keys.append(key)
                terms.append((a, b, v0, v1))
            slots.append(keys.index(key))
        if len(terms) > MAX_TERMS:
            return False
        of_key = dict(zip(named, shifts))
        self.shifts = self.shifts + [of_key[k] for k in new]
        self.bases = self.bases + [e for e, _ in new]
        self.base_keys, self.terms, self.keys = base_keys, terms, keys
        self.members.append((i, slots))
        return True


def _moment_batches(subtasks, members):
    """The moment ops of a pass, packed in order into kernel calls (one op
    alone always fits: at most 2 bases and 6 terms)."""
    batches = [_MomentBatch()]
    for i in members:
        if not batches[-1].add(i, subtasks[i]):
            batches.append(_MomentBatch())
            batches[-1].add(i, subtasks[i])
    return batches


class TaskFilterMask(Task):
    """The rows the frame's filter keeps, as one bool tensor on the pass
    device (written tile by tile)."""

    cacheable = True

    def __init__(self, df):
        super().__init__(df, [], name="filter-mask")

    def initial_state(self, device, rows):
        return torch.ones(rows, dtype=torch.bool, device=device)

    def update(self, state, ctx):
        if ctx.row_valid is not None:
            at = ctx.i1 - ctx.base
            state[at:at + ctx.n_rows] = ctx.row_valid
        return state

    def merge(self, states, mesh):
        """The shards' row ranges, in order, on the mesh's first device."""
        return torch.cat([s.to(mesh.first) for s in states])

    def finalize(self, state):
        self.fulfill(state)
        return state


class TaskMapIndex(Task):
    """The join's probe of a left key against a right
    :class:`~.ops.setops.SortedIndex`, tile by tile on the pass device: per
    row the first right row (-1 where none), written into one lookup tensor,
    and with ``duplicates`` the (left row, right row) pairs past each first
    match.  ``route`` is the B6 route of the last tile."""

    cacheable = True

    def __init__(self, df, expression, index, duplicates=False):
        super().__init__(df, [expression], name="map-index")
        self.index = index
        self.duplicates = duplicates
        self.route = None

    def _fingerprint_extra(self):
        return identity(self.index), self.duplicates

    def initial_state(self, device, rows):
        return {"lookup": torch.empty(rows, dtype=self.index.row_dtype, device=device),
                "left": [], "right": []}

    def update(self, state, ctx):
        if ctx.row_valid is not None:
            raise ValueError("a join probes the rows of an extracted frame, not a filtered one")
        ordinals = self.index.ordinals(ctx.expr(self.expressions[0]))
        self.route = self.index.route(ordinals.device)
        at = ctx.i1 - ctx.base
        state["lookup"][at:at + ctx.n_rows] = self.index.rows_of(ordinals)
        if self.duplicates:
            left, right = self.index.duplicates_of(ordinals, ctx.i1)
            state["left"].append(left)
            state["right"].append(right)
        return state

    def merge(self, states, mesh):
        """The shards' lookups, in row order, and their duplicate pairs on
        the mesh's first device."""
        return {"lookup": torch.cat([s["lookup"].to(mesh.first) for s in states]),
                "left": [t.to(mesh.first) for s in states for t in s["left"]],
                "right": [t.to(mesh.first) for s in states for t in s["right"]]}

    def finalize(self, state):
        lookup = state["lookup"]
        empty = lookup.new_empty(0, dtype=torch.int64)
        out = (lookup, torch.cat(state["left"]) if state["left"] else empty,
               torch.cat(state["right"]) if state["right"] else empty.to(lookup.dtype))
        self.fulfill(out)
        return out


class TaskMapReduce(Task):
    """``map_fn`` of each tile's values of the expressions as host arrays
    (with ``info``, ``map_fn(i1, i2, *values)``; with ``pre_filter``, only
    the rows the filter keeps), folded by ``reduce_fn`` at the end, or the
    list of the parts without one (vaex_tpu/tasks.py:748-779).  Its functions
    are named by ``id`` in the reference's fingerprint, which a collected
    function's successor may reuse: it is never cached."""

    def __init__(self, df, expressions, map_fn, reduce_fn=None, name="map-reduce",
                 pre_filter=False, info=False):
        super().__init__(df, expressions, name=name)
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn
        self.pre_filter = pre_filter
        self.info = info

    def initial_state(self, device, rows):
        return []

    def update(self, state, ctx):
        values = [_host_values(ctx.expr(e)) for e in self.expressions]
        if self.pre_filter and ctx.row_valid is not None:
            keep = ctx.row_valid.cpu().numpy()
            values = [v.filter(keep) if hasattr(v, "filter") else v[keep] for v in values]
        i2 = ctx.i1 + ctx.n_rows
        state.append(self.map_fn(ctx.i1, i2, *values) if self.info else self.map_fn(*values))
        return state

    def merge(self, states, mesh):
        """The shards' parts in row order; across processes in rank order."""
        from .parallel import collectives
        return [part for parts in collectives.objects([p for s in states for p in s], mesh)
                for part in parts]

    def finalize(self, state):
        result = state
        if self.reduce_fn is not None:
            result = functools.reduce(self.reduce_fn, state) if state else None
        self.fulfill(result)
        return result


def _host_values(x):
    """One tile's NA as host values: numpy (masked where missing) in its
    logical dtype, strings as an arrow dictionary array."""
    if isinstance(x, DictNA):
        from .dataframe import _decode
        return _decode(x)
    data = host_values(x.data.cpu().numpy(), x.logical)
    return data if x.mask is None else np.ma.MaskedArray(data, x.mask.cpu().numpy())

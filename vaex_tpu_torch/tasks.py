"""Tasks: units of work executed in one pass over the data.

A task has an ``initial_state``, an ``update`` that folds one tile into
the state, and a ``finalize`` that fulfills its promise.  Torch runs
eagerly, so ``update`` is a plain Python function called once per tile.
"""

from __future__ import annotations

import torch

from .datatype import NAT, DataType
from .delayed import Promise
from .ops.binners import fuse_bins, grid_shape, grid_size
from .ops.grid_extreme import extreme_of_rows
from .ops.grid_moments import MAX_BASES, MAX_TERMS
from .ops.grid_plan import grid_extremes, grid_sums_and_extremes, moment_sums
from .ops.setops import RowLimitException, SortedSet


class Task(Promise):
    def __init__(self, df, expressions, name="task"):
        super().__init__()
        self.df = df
        self.expressions = [str(e) for e in expressions]
        self.name = name

    def initial_state(self, device):
        raise NotImplementedError

    def update(self, state, ctx):
        """Fold one tile (a TileContext) into ``state``; returns the new state."""
        raise NotImplementedError

    def finalize(self, state):
        raise NotImplementedError


class TaskAggregations(Task):
    """All aggregations of one pass that share a binner stack and a
    selection (a boolean expression, or None).  The rows the frame's filter
    or the selection drops get the bin index -1, which every grid kernel
    and ``grid_extreme`` leave out.

    ``subtasks`` holds the AggOperations the descriptors of
    :mod:`vaex_tpu_torch.agg` registered.  Per tile, each kind rides its own
    batch: the additive ops one call of the grid kernel that
    :mod:`.ops.grid_plan` picks for the grid size (B1, B2 or B3), the moment
    ops as few calls of the moment kernel it picks (B4, B5, or B3 over
    formed terms) as ``MAX_BASES`` / ``MAX_TERMS`` allow, all the extremes
    one batch of the min/max kernel B3x
    (:func:`.ops.grid_plan.grid_extremes`), which shares the partition of
    the additive batch where the extremes need one (``"scatter": "shared"``).
    A ``first`` is two per-bin mins through the same route, of the order
    values and then of the row numbers among the rows that hold the winning
    order.  Without binners the grid is one cell and an extreme is a plain
    reduction over the rows (``"reduce"``).  ``strategy`` maps each kind of
    the last tile to its kernel, e.g. ``{"additive": "b1", "moments": "b5",
    "extremes": "b3x-direct"}``; the executor writes it into the pass's
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

    def initial_state(self, device):
        G = grid_size(self.binners)
        return [op.initial_state(G, device) for op in self.subtasks]

    def update(self, state, ctx):
        G = grid_size(self.binners)
        new_state = list(state)
        self.strategy = {}
        kinds = {}
        for i, op in enumerate(self.subtasks):
            kinds.setdefault(op.kind, []).append(i)
        # without binners the extremes reduce the valid rows and need no index
        idx = (self._flat_indices(ctx, kinds.keys()) if self.binners or kinds.keys() - {"extreme"}
               else None)
        # the extremes of a binned task ride the additive batch's call
        riders = kinds.get("extreme", []) if self.binners else []
        if "additive" in kinds or riders:
            self._update_additive(kinds.get("additive", []), riders, new_state, idx, G, ctx)
        if "moments" in kinds:
            names = [self._update_moments(batch, new_state, idx, G, ctx)
                     for batch in _moment_batches(self.subtasks, kinds["moments"])]
            self.strategy["moments"] = "+".join(dict.fromkeys(names))
        if "extreme" in kinds and not self.binners:
            rows = ctx.selection_valid(self.selection)
            for i in kinds["extreme"]:
                op = self.subtasks[i]
                values, valid = op.extreme_input(ctx)
                if rows is not None:
                    valid = rows if valid is None else valid & rows
                grid = extreme_of_rows(values, op.mode, valid)
                new_state[i] = op.apply_kernel(new_state[i], grid)
            self.strategy["extremes"] = "reduce"
        if "first" in kinds:
            names = [self._update_first(i, new_state, idx, G, ctx) for i in kinds["first"]]
            self.strategy["first"] = "+".join(dict.fromkeys(names))
        return new_state

    def _update_additive(self, members, riders, new_state, idx, G, ctx):
        """One tile's additive batch (``members``) and its binned extremes
        (``riders``): one call each, or one for both."""
        int_cols, float_cols, slots = [], [], []
        count = False
        for i in members:
            kind, col = self.subtasks[i].kernel_input(ctx)
            if kind == "count":
                count = True
                slots.append(("count", 0))
            elif kind == "int":
                slots.append(("int", len(int_cols)))
                int_cols.append(col)
            else:
                slots.append(("float", len(float_cols)))
                float_cols.append(col)
        cols, valids = [], []
        for i in riders:
            values, valid = self.subtasks[i].extreme_input(ctx)
            cols.append(values)
            valids.append(valid)
        modes = [self.subtasks[i].mode for i in riders]
        if members:
            name, ext_name, shared, int_sums, float_sums, grids = grid_sums_and_extremes(
                idx, int_cols, float_cols, G, count, cols, modes, valids)
            self.strategy["additive"] = name
            if shared:
                self.strategy["scatter"] = "shared"
        else:
            ext_name, grids = grid_extremes(idx, cols, modes, valids, G)
        if riders:
            self.strategy["extremes"] = ext_name
        for i, (kind, k) in zip(members, slots):
            if kind == "count":
                sums = int_sums[0]
            elif kind == "int":
                sums = int_sums[int(count) + k]
            else:
                sums = float_sums[k]
            new_state[i] = self.subtasks[i].apply_kernel(new_state[i], sums)
        for i, grid in zip(riders, grids):
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
        bases = [moment_base(ctx.expr(e)) for e in batch.bases]
        name, counts, sums = moment_sums(idx, bases, batch.terms, G)
        # each term's row among the kernel's count rows or float rows
        rows, n_count, n_float = [], 0, 0
        for a, *_ in batch.terms:
            rows.append(n_count if a < 0 else n_float)
            n_count, n_float = n_count + (a < 0), n_float + (a >= 0)
        for i, slots in batch.members:
            op = self.subtasks[i]
            c = [rows[k] for k in slots if batch.terms[k][0] < 0]
            f = [rows[k] for k in slots if batch.terms[k][0] >= 0]
            new_state[i] = op.apply_kernel(new_state[i], (counts[c], sums[f]))
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
    stay on the pass device."""

    def __init__(self, df, expression, keep_counts=False, limit=None):
        super().__init__(df, [expression], name="set-create")
        self.keep_counts = keep_counts
        self.limit = limit
        dtype = df.data_type(expression)
        self.temporal = dtype.numpy if dtype.is_temporal else None

    def initial_state(self, device):
        return {"keys": None, "counts": None, "nan": 0, "null": 0}

    def update(self, state, ctx):
        x = ctx.expr(self.expressions[0])
        data, keep = x.data, ctx.row_valid
        missing = x.mask
        if self.temporal is not None:
            nat = data == NAT
            missing = nat if missing is None else missing | nat
        if missing is not None:
            null = missing if keep is None else missing & keep
            state["null"] += int(null.sum())
            keep = ~missing if keep is None else keep & ~missing
        if data.is_floating_point():
            nan = torch.isnan(data) if keep is None else torch.isnan(data) & keep
            n_nan = int(nan.sum())
            if n_nan:
                state["nan"] += n_nan
                keep = ~nan if keep is None else keep & ~nan
        if keep is not None:
            data = data[keep]
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

    def finalize(self, state):
        dtype = self.temporal or DataType(state["keys"].dtype).numpy
        oset = SortedSet.from_device(dtype, state["keys"],
                                     state["counts"], state["nan"], state["null"], self.limit)
        self.fulfill(oset)
        return oset


def moment_base(x):
    """A base column of the moment kernels from one tile's NA: int64,
    float32 or float64, with NaN in the masked rows (as float64)."""
    d = x.data
    if d.is_floating_point():
        if d.dtype not in (torch.float32, torch.float64):
            d = d.to(torch.float64)
    else:
        d = d.to(torch.int64)
    if x.mask is not None:
        d = d.to(torch.float64).masked_fill(x.mask, torch.nan)
    return d.contiguous()


class _MomentBatch:
    """The OpMoments of one kernel call: their base expressions and terms,
    both deduplicated, and per op the batch term of each of its terms."""

    def __init__(self):
        self.bases, self.terms, self.keys, self.members = [], [], [], []

    def add(self, i, op):
        """Take op i if the batch stays within the kernels' limits."""
        bases = self.bases + [e for e in dict.fromkeys(op.expressions) if e not in self.bases]
        if len(bases) > MAX_BASES:
            return False
        where = [bases.index(e) for e in op.expressions]
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
        self.bases, self.terms, self.keys = bases, terms, keys
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

"""Tasks: units of work executed in one pass over the data.

A task has an ``initial_state``, an ``update`` that folds one tile into
the state, and a ``finalize`` that fulfills its promise.  Torch runs
eagerly, so ``update`` is a plain Python function called once per tile.
"""

from __future__ import annotations

import torch

from .delayed import Promise
from .ops.binners import fuse_bins, grid_shape, grid_size
from .ops.grid_extreme import extreme_bins, grid_extreme
from .ops.grid_moments import MAX_BASES, MAX_TERMS
from .ops.grid_plan import grid_sums, moment_sums


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
    """All aggregations of one pass that share a binner stack.

    ``subtasks`` holds the AggOperations the descriptors of
    :mod:`vaex_tpu_torch.agg` registered.  Per tile, each kind rides its own
    batch: the additive ops one call of the grid kernel that
    :mod:`.ops.grid_plan` picks for the grid size (B1, B2 or B3), the moment
    ops as few calls of the moment kernel it picks (B4, B5, or B3 over
    formed terms) as ``MAX_BASES`` / ``MAX_TERMS`` allow, the extremes one
    :func:`.ops.grid_extreme.grid_extreme` each.  ``strategy`` maps each
    kind of the last tile to its kernel, e.g. ``{"additive": "b1",
    "moments": "b5", "extremes": "torch"}``; the executor writes it into
    the pass's ``trace_log`` entry.
    """

    def __init__(self, df, binners):
        super().__init__(df, [b.expression for b in binners], name="aggregations")
        self.binners = tuple(binners)
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
        idx = self._flat_indices(ctx)
        new_state = list(state)
        self.strategy = {}
        kinds = {}
        for i, op in enumerate(self.subtasks):
            kinds.setdefault(op.kind, []).append(i)
        if "additive" in kinds:
            self.strategy["additive"] = self._update_additive(kinds["additive"], new_state,
                                                              idx, G, ctx)
        if "moments" in kinds:
            names = [self._update_moments(batch, new_state, idx, G, ctx)
                     for batch in _moment_batches(self.subtasks, kinds["moments"])]
            self.strategy["moments"] = "+".join(dict.fromkeys(names))
        if "extreme" in kinds:
            bins = extreme_bins(idx, G)
            for i in kinds["extreme"]:
                op = self.subtasks[i]
                values, valid = op.extreme_input(ctx)
                new_state[i] = op.apply_kernel(new_state[i],
                                               grid_extreme(bins, values, G, op.mode, valid))
            self.strategy["extremes"] = "torch"
        return new_state

    def _update_additive(self, members, new_state, idx, G, ctx):
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
        name, int_sums, float_sums = grid_sums(idx, int_cols, float_cols, G, count)
        for i, (kind, k) in zip(members, slots):
            if kind == "count":
                sums = int_sums[0]
            elif kind == "int":
                sums = int_sums[int(count) + k]
            else:
                sums = float_sums[k]
            new_state[i] = self.subtasks[i].apply_kernel(new_state[i], sums)
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

    def _flat_indices(self, ctx):
        if self.binners:
            indices = [b.to_bins(ctx.expr(b.expression)) for b in self.binners]
            return fuse_bins(self.binners, indices)
        return torch.zeros(ctx.n_rows, dtype=torch.int32, device=ctx.device)

    def finalize(self, state):
        shape = grid_shape(self.binners)
        results = [op.get_result(s, shape) for op, s in zip(self.subtasks, state)]
        self.fulfill(results)
        for sub, r in zip(self.subtask_promises, results):
            sub.fulfill(r)
        return results


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

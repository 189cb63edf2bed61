"""Tasks: units of work executed in one pass over the data.

A task has an ``initial_state``, an ``update`` that folds one tile into
the state, and a ``finalize`` that fulfills its promise.  Torch runs
eagerly, so ``update`` is a plain Python function called once per tile.
"""

from __future__ import annotations

import torch

from .delayed import Promise
from .ops.binners import fuse_bins, grid_shape, grid_size
from .ops.grid_plan import grid_sums


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
    :mod:`vaex_tpu_torch.agg` registered; every one is additive and rides
    one call of a grid kernel per tile, the one :mod:`.ops.grid_plan` picks
    for the grid size (B1, B2 or B3).  ``strategy`` names the kernel of the
    last tile; the executor writes it into the pass's ``trace_log`` entry.
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
        int_cols, float_cols, slots = [], [], []
        count = False
        for op in self.subtasks:
            kind, col = op.kernel_input(ctx)
            if kind == "count":
                count = True
                slots.append(("count", 0))
            elif kind == "int":
                slots.append(("int", len(int_cols)))
                int_cols.append(col)
            else:
                slots.append(("float", len(float_cols)))
                float_cols.append(col)
        self.strategy, int_sums, float_sums = grid_sums(idx, int_cols, float_cols, G, count)
        new_state = []
        for op, s, (kind, k) in zip(self.subtasks, state, slots):
            if kind == "count":
                sums = int_sums[0]
            elif kind == "int":
                sums = int_sums[int(count) + k]
            else:
                sums = float_sums[k]
            new_state.append(op.apply_kernel(s, sums))
        return new_state

    def _flat_indices(self, ctx):
        if self.binners:
            indices = [b.to_bins(ctx.expr(b.expression)) for b in self.binners]
            return fuse_bins(self.binners, indices)
        return torch.zeros(ctx.n_rows, dtype=torch.int32, device=ctx.device)

    def finalize(self, state):
        shape = grid_shape(self.binners)
        results = [s.reshape(shape) for s in state]
        self.fulfill(results)
        for sub, r in zip(self.subtask_promises, results):
            sub.fulfill(r)
        return results
